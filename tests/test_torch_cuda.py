"""The hand-written CUDA kernels against their plain PyTorch versions, on
a card.  This file imports no JAX, so it runs on a machine with a GPU:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without CUDA every test skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as port_engine
from repro_torch.core.planner import level_csr
from repro_torch.kernels import ops
from repro_torch.kernels.tree_sweep import (fwd_at_parent, level_sweep,
                                            tree_sweep_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def planes(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    fwd = rng.uniform(0.01, 0.2, (m, n)).astype(np.float32)
    link = rng.lognormal(np.log(4e-4), 0.35, (m, n)).astype(np.float32)
    return torch.from_numpy(fwd).to(dev), torch.from_numpy(link).to(dev)


def assert_nan_equal(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


@pytest.mark.parametrize("protocol", ["snow", "coloring"])
@pytest.mark.parametrize("n", [1, 2, 5, 4097, 100_003])
def test_cuda_kernel_bit_equal_plain(dev, protocol, n):
    for p in port_engine.stable_plans(protocol, np.arange(n), 0, 4,
                                      device=dev):
        fwd, link = planes(n, 6, n, dev)
        link[0, n // 2] = float("nan")
        fp = fwd_at_parent(p.parent, fwd, p.root)
        t0 = torch.arange(6, dtype=torch.float32, device=dev)
        kw = dict(root=p.root, height=p.height)
        before = tree_sweep_cuda.launches
        got = ops.tree_sweep(p.parent, p.depth, fp, link, t0,
                             levels=level_csr(p.parent, p.depth), **kw)
        torch.cuda.synchronize()
        assert tree_sweep_cuda.launches == before + 1
        assert_nan_equal(got, level_sweep(p.parent, p.depth, fp, link, t0,
                                          **kw))


def test_cuda_kernel_batch_dims_and_ring(dev):
    n = 3001
    ring = torch.randperm(n, generator=torch.Generator().manual_seed(3))
    p = port_engine.stable_plans("coloring", np.arange(n), int(ring[7]), 2,
                                 ring=ring, device=dev)[1]
    fwd, link = planes(n, 12, 1, dev)
    fp = fwd_at_parent(p.parent, fwd, p.root).view(3, 4, n)
    t0 = torch.arange(12, dtype=torch.float32, device=dev).view(3, 4)
    kw = dict(root=p.root, height=p.height)
    got = tree_sweep_cuda(p.parent, p.depth, fp, link.view(3, 4, n), t0,
                          levels=level_csr(p.parent, p.depth), **kw)
    assert_nan_equal(got, level_sweep(p.parent, p.depth, fp,
                                      link.view(3, 4, n), t0, **kw))


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(dev):
    p = port_engine.stable_plans("snow", np.arange(64), 0, 4, device=dev)[0]
    fwd, link = planes(64, 2, 0, dev)
    fp = fwd_at_parent(p.parent, fwd, p.root)
    t0 = torch.zeros(2, device=dev)
    kw = dict(root=p.root, height=p.height, levels=p.level_csr)
    with pytest.raises(TypeError):
        tree_sweep_cuda(p.parent, p.depth, fp.double(), link.double(),
                        t0.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tree_sweep_cuda(p.parent, p.depth, fp.t().contiguous().t(), link,
                        t0, **kw)
    with pytest.raises(ValueError, match="t0"):
        tree_sweep_cuda(p.parent, p.depth, fp, link, t0.cpu(), **kw)
    with pytest.raises(ValueError, match="t0"):
        tree_sweep_cuda(p.parent, p.depth, fp, link, t0[:1], **kw)


def test_stable_sweep_on_the_card_runs_through_the_kernel(dev):
    before = tree_sweep_cuda.launches
    rows = port_engine.stable_sweep("coloring", 20_000, 4, [0, 1], 4)
    assert tree_sweep_cuda.launches == before + 2
    assert all(r["reliability"] == 1.0 and r["rmr"] == 244.0 for r in rows)
    assert rows[0]["device_name"] == torch.cuda.get_device_name(dev)
