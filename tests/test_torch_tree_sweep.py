"""Tree sweep port: the plain version against the JAX sweep, interpret
Pallas and the numpy closed form, and kernel dispatch on the CPU.  The
CUDA kernel's own tests are in tests/test_torch_cuda.py, which imports
no JAX so that it runs on a machine with a card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.engine import bank_for_stable, delivery_times, stable_plans
from repro.kernels import ops as jops
from repro.kernels.tree_sweep import fwd_at_parent as jfwd_at_parent
from repro.kernels.tree_sweep import level_sweep_xla
from repro_torch.core import engine as port_engine
from repro_torch.core.convert import plan_from_arrays, planes_from_numpy
from repro_torch.kernels import _build, ops
from repro_torch.kernels.tree_sweep import (fwd_at_parent, level_sweep,
                                            tree_sweep_cuda)

PLAN_IDS = ["snow", "primary", "secondary"]


def ref_plan(which, n):
    plans = stable_plans("snow" if which == "snow" else "coloring",
                         np.arange(n), 0, 4)
    return plans[1] if which == "secondary" else plans[0]


def to_port(p):
    return plan_from_arrays(p.members, p.root, p.parent, p.depth,
                            p.region_start, p.region_len, p.slot, p.k,
                            p.tree, device="cpu")


def f32_planes(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.01, 0.2, (m, n)).astype(np.float32),
            rng.lognormal(np.log(4e-4), 0.35, (m, n)).astype(np.float32))


def jax_sweep(p, fwd, link, t0):
    parent = jnp.asarray(np.asarray(p.parent, dtype=np.int32))
    depth = jnp.asarray(np.asarray(p.depth, dtype=np.int32))
    fp = jfwd_at_parent(parent, jnp.asarray(fwd), p.root)
    return parent, depth, fp


@pytest.mark.parametrize("which", PLAN_IDS)
@pytest.mark.parametrize("n", [7, 300])
def test_fwd_at_parent_bit_equal_jax_root_included(which, n):
    p = ref_plan(which, n)
    fwd, _ = f32_planes(n, 3, 1)
    want = np.asarray(jfwd_at_parent(jnp.asarray(np.asarray(p.parent)),
                                     jnp.asarray(fwd), p.root))
    got = fwd_at_parent(torch.as_tensor(np.asarray(p.parent)),
                        torch.from_numpy(fwd), p.root).numpy()
    assert np.array_equal(got, want)
    # parent[root] = -1 wraps to the last column, as jnp.take does
    assert got[0, p.root] == fwd[0, n - 1]


@pytest.mark.parametrize("which", PLAN_IDS)
@pytest.mark.parametrize("n", [7, 300, 2001])
def test_level_sweep_bit_equal_xla_and_pallas_interpret(which, n):
    p = ref_plan(which, n)
    q = to_port(p)
    fwd, link = f32_planes(n, 8, n)
    t0 = np.arange(8, dtype=np.float32)
    parent, depth, fp = jax_sweep(p, fwd, link, t0)
    xla = np.asarray(level_sweep_xla(parent, depth, fp, jnp.asarray(link),
                                     jnp.asarray(t0), root=p.root,
                                     height=p.height))
    pal = np.asarray(jops.tree_sweep(parent, depth, fp, jnp.asarray(link),
                                     jnp.asarray(t0), root=p.root,
                                     height=p.height,
                                     impl="pallas_interpret"))
    fwd_t, link_t = planes_from_numpy(fwd, link, device="cpu")
    got = level_sweep(q.parent, q.depth, fwd_at_parent(q.parent, fwd_t,
                                                       q.root),
                      link_t, torch.from_numpy(t0), root=q.root,
                      height=q.height).numpy()
    assert np.array_equal(got, xla, equal_nan=True)
    assert np.array_equal(got, pal, equal_nan=True)
    assert not np.isnan(got).any()


@pytest.mark.parametrize("protocol", ["snow", "coloring"])
def test_level_sweep_f64_bit_equal_numpy_delivery_times(protocol):
    n, m = 3000, 5
    bank = bank_for_stable(3, n, protocol, m)
    t0 = np.arange(m, dtype=np.float64) * 1.0
    for p in stable_plans(protocol, np.arange(n), 0, 4):
        slot = 1 if p.tree == 1 else 0
        fwd, link = bank.fwd_plane(slot, m), bank.link_plane(slot, m)
        want = delivery_times(p, fwd, link, t0=t0, backend="numpy")
        q = to_port(p)
        fwd_t, link_t = torch.from_numpy(fwd), torch.from_numpy(link)
        got = level_sweep(q.parent, q.depth,
                          fwd_at_parent(q.parent, fwd_t, q.root), link_t,
                          torch.from_numpy(t0), root=q.root,
                          height=q.height)
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), want, equal_nan=True)


def test_nan_links_darken_whole_subtrees():
    n = 500
    p = ref_plan("snow", n)
    q = to_port(p)
    fwd, link = f32_planes(n, 2, 9)
    parent = np.asarray(p.parent)
    cut = [int(np.flatnonzero(np.asarray(p.depth) == 2)[0]), 77]
    link[0, cut] = np.nan
    t = level_sweep(q.parent, q.depth,
                    fwd_at_parent(q.parent, torch.from_numpy(fwd), q.root),
                    torch.from_numpy(link), torch.zeros(2), root=q.root,
                    height=q.height).numpy()
    # a node is dark iff a cut node lies on its path to the root
    dark = np.zeros(n, dtype=bool)
    for v in range(n):
        u = v
        while u != p.root:
            if u in cut:
                dark[v] = True
                break
            u = parent[u]
    assert dark.sum() > len(cut)
    assert np.array_equal(np.isnan(t[0]), dark)
    assert not np.isnan(t[1]).any()
    _, depth, fp = jax_sweep(p, fwd, link, None)
    xla = np.asarray(level_sweep_xla(jnp.asarray(parent.astype(np.int32)),
                                     depth, fp, jnp.asarray(link),
                                     jnp.zeros(2, jnp.float32),
                                     root=p.root, height=p.height))
    assert np.array_equal(t, xla, equal_nan=True)


def test_ops_dispatch_on_cpu_tensors():
    p = port_engine.stable_plans("coloring", np.arange(200), 0, 4,
                                 device="cpu")[1]
    fwd, link = (torch.from_numpy(a) for a in f32_planes(200, 3, 4))
    fp = fwd_at_parent(p.parent, fwd, p.root)
    t0 = torch.arange(3, dtype=torch.float32)
    kw = dict(root=p.root, height=p.height)
    plain = level_sweep(p.parent, p.depth, fp, link, t0, **kw)
    kw["levels"] = p.level_csr
    auto = ops.tree_sweep(p.parent, p.depth, fp, link, t0, **kw)
    assert torch.equal(auto, plain)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.tree_sweep(p.parent, p.depth, fp, link, t0, impl="cuda", **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tree_sweep_cuda(p.parent, p.depth, fp, link, t0, **kw)
    with pytest.raises(ValueError, match="impl"):
        ops.tree_sweep(p.parent, p.depth, fp, link, t0, impl="xla", **kw)


def test_build_is_keyed_on_sources_and_raises_without_nvcc(monkeypatch,
                                                          tmp_path):
    path = _build.library_path("tree_sweep")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "repro_torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert (_build.SRC_DIR / "tree_sweep.cu").exists()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
