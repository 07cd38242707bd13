"""Device sweep port on the CPU: bit-equal to the JAX sweep on the same
numpy planes, reductions against the numpy closed form, its own RNG
statistically pinned against the numpy DelayBank oracle (the bands of
tests/test_device_sweep.py), reproducible rows, and the loss arm
against the host numpy loss arm."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.engine import (DelayBank, bank_for_stable, broadcast_times,
                               stable_plans, stable_sweep)
from repro.core.faults import LossModel as RefLoss
from repro.core.specs import NetworkSpec, RunSpec
from repro.kernels.tree_sweep import fwd_at_parent as jfwd_at_parent
from repro.kernels.tree_sweep import level_sweep_xla
from repro_torch.core import device_sweep as ds
from repro_torch.core import engine as port_engine
from repro_torch.core.convert import plan_from_arrays, planes_from_numpy
from repro_torch.core.faults import LossModel

SEEDS = tuple(range(8))


def port_plans(protocol, n):
    return port_engine.stable_plans(protocol, np.arange(n), 0, 4,
                                    device="cpu")


def to_port(p):
    return plan_from_arrays(p.members, p.root, p.parent, p.depth,
                            p.region_start, p.region_len, p.slot, p.k,
                            p.tree, device="cpu")


# ------------------------------------------------------------------ #
# (a) same numpy planes: bit-equal to JAX, reductions vs numpy        #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("protocol", ["snow", "coloring"])
def test_sweep_planes_bit_equal_jax_on_numpy_planes(protocol):
    n, m = 600, 4
    bank = bank_for_stable(2, n, protocol, m)
    plans = stable_plans(protocol, np.arange(n), 0, 4)
    t0 = np.arange(m, dtype=np.float32)
    planes = {s: tuple(a.astype(np.float32) for a in
                       (bank.fwd_plane(s, m), bank.link_plane(s, m)))
              for s in range(len(plans))}
    want = None
    for p in plans:
        fwd, link = planes[1 if p.tree == 1 else 0]
        parent = jnp.asarray(np.asarray(p.parent, dtype=np.int32))
        depth = jnp.asarray(np.asarray(p.depth, dtype=np.int32))
        t = level_sweep_xla(parent, depth,
                            jfwd_at_parent(parent, jnp.asarray(fwd), p.root),
                            jnp.asarray(link), jnp.asarray(t0),
                            root=p.root, height=p.height)
        want = t if want is None else jnp.fmin(want, t)
    tplanes = {s: planes_from_numpy(*v, device="cpu")
               for s, v in planes.items()}
    got = ds.sweep_planes([to_port(p) for p in plans], tplanes.__getitem__,
                          torch.from_numpy(t0))
    assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)

    # reductions: f32 rows against the f64 numpy closed form
    host = broadcast_times(plans, bank, m, 1.0, backend="numpy")
    h_ldt = np.nanmax(host[:, 1:] - np.arange(m)[:, None], axis=1)
    h_rel = np.count_nonzero(~np.isnan(host[:, 1:]), axis=1) / (n - 1)
    ldt, rel, got_any = ds.reduce_rows(got, torch.from_numpy(t0), 0)
    np.testing.assert_allclose(ldt.numpy(), h_ldt, rtol=1e-6)
    np.testing.assert_allclose(rel.numpy(), h_rel, rtol=1e-6)
    assert got_any.all()


# ------------------------------------------------------------------ #
# (b) the port's own RNG, statistically pinned vs DelayBank           #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n,tol_mean,tol_p99", [
    (500, 0.08, 0.05), (5000, 0.10, 0.08),
])
def test_delivery_distribution_pinned(n, tol_mean, tol_p99):
    """Straggler-free per-node delivery times: mean and p99 against the
    numpy DelayBank oracle."""
    plans = stable_plans("snow", np.arange(n), 0, 4)
    tplans = port_plans("snow", n)
    t0 = np.arange(2, dtype=float)[:, None]
    host = np.concatenate([
        (broadcast_times(plans, DelayBank.sample(s, np.arange(n), set(), 2),
                         2, backend="numpy") - t0)[:, 1:].ravel()
        for s in range(4)])
    dev = np.concatenate([
        (ds.stable_times_device(tplans, s, 2, straggler_frac=0.0).numpy()
         - t0)[:, 1:].ravel() for s in range(4)])
    assert abs(dev.mean() - host.mean()) / host.mean() < tol_mean
    hp, dp = np.percentile(host, 99), np.percentile(dev, 99)
    assert abs(dp - hp) / hp < tol_p99


@pytest.mark.parametrize("n,n_seeds,tol_mean,tol_p99", [
    # at n = 500 each seed's LDT is set by whether two of its ~25
    # stragglers chain on one path (about 1.5 s or 3 s), so the mean
    # over 8 seeds moves by ±15 % with the seed set alone; 256 seeds
    # hold the sampling noise well inside the band
    (500, 256, 0.08, 0.40), (5000, 8, 0.10, 0.12),
])
def test_ldt_pinned_vs_host(n, n_seeds, tol_mean, tol_p99):
    """Mean/p99 LDT with stragglers on, against the DelayBank oracle,
    over seeds × messages."""
    M = 20
    seeds = list(range(n_seeds))
    plans = stable_plans("snow", np.arange(n), 0, 4)
    t0 = np.arange(float(M))[:, None]
    h = np.concatenate([
        np.nanmax((broadcast_times(plans, bank_for_stable(s, n, "snow", M),
                                   M, backend="numpy") - t0)[:, 1:], axis=1)
        for s in seeds])
    tplans = port_plans("snow", n)
    t0t = ds.message_starts(M, 1.0, len(seeds), "cpu")
    total = ds.sweep_planes(tplans, ds.rng_planes(tplans, seeds, M), t0t)
    d = ds.reduce_rows(total, t0t, 0)[0].numpy().astype(np.float64)
    assert abs(d.mean() - h.mean()) / h.mean() < tol_mean
    hp, dp = np.percentile(h, 99), np.percentile(d, 99)
    assert abs(dp - hp) / hp < tol_p99


# ------------------------------------------------------------------ #
# (c) reproducibility and internal consistency                        #
# ------------------------------------------------------------------ #
def test_rows_reproducible_across_calls():
    plans = port_plans("coloring", 600)
    a = ds.stable_stats_device(plans, SEEDS, 3)
    b = ds.stable_stats_device(plans, SEEDS, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    t1 = ds.stable_times_device(plans, 7, 2)
    t2 = ds.stable_times_device(plans, 7, 2)
    assert torch.equal(torch.isnan(t1), torch.isnan(t2))
    assert torch.equal(t1[~torch.isnan(t1)], t2[~torch.isnan(t2)])


@pytest.mark.parametrize("protocol", ["snow", "coloring"])
def test_stats_match_single_seed_times(protocol):
    """stable_stats_device is the seed-batched view of
    stable_times_device: same draws, same reductions."""
    plans = port_plans(protocol, 400)
    ldt, rel = ds.stable_stats_device(plans, [3, 9], 4)
    for i, s in enumerate((3, 9)):
        t = ds.stable_times_device(plans, s, 4)
        t0 = ds.message_starts(4, 1.0, 1, "cpu")
        l1, r1, _ = ds.reduce_rows(t, t0, 0)
        assert ldt[i] == l1.mean().item() and rel[i] == r1.mean().item()
    assert np.all(rel == 1.0)


def test_straggler_mask_and_planes_follow_the_distributions():
    n = 20000
    strag = ds._straggler_mask([0, 1], torch.ones(n, dtype=torch.bool))
    assert strag.shape == (2, n) and not torch.equal(strag[0], strag[1])
    assert abs(strag.float().mean().item() - ds.STRAGGLER_FRAC) < 0.01
    fwd, link = ds._fwd_link_planes([0, 1], 0, 3, n, strag)
    assert fwd.dtype == link.dtype == torch.float32
    assert torch.all(fwd[strag[:, None, :].expand_as(fwd)] == 1.0)
    free = fwd[~strag[:, None, :].expand_as(fwd)]
    assert free.min() >= ds.FWD_LO and free.max() < ds.FWD_HI
    med = link.median().item()
    assert abs(med - 0.0004) / 0.0004 < 0.02
    assert abs(torch.log(link).std().item() - 0.35) < 0.01
    # slots draw independent planes
    fwd1, _ = ds._fwd_link_planes([0, 1], 1, 3, n, strag)
    assert not torch.equal(fwd, fwd1)


def test_loss_planes_follow_the_retransmit_model():
    loss = LossModel(rate=0.5, timeout_s=0.25, max_attempts=3)
    extra, lost = ds._loss_planes([4], 0, 50, 2000, loss, torch.device("cpu"))
    fails = torch.round(extra / 0.25)
    assert torch.all(fails[lost] == 3)
    frac = [(fails[~lost] == a).float().sum().item() / extra.numel()
            for a in range(3)]
    # P(first success at attempt a) = 0.5^(a+1); P(lost) = 0.5^3
    np.testing.assert_allclose(frac, [0.5, 0.25, 0.125], atol=0.01)
    assert abs(lost.float().mean().item() - 0.125) < 0.01


# ------------------------------------------------------------------ #
# (d) the loss arm against the host numpy loss arm                    #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("rate,attempts,tol_ldt,tol_rel", [
    # rate 0.05: dead edges are rare (0.05^4 per edge); LDT carries the
    # retransmit timeouts.  rate 0.5 with 2 attempts kills a quarter of
    # the edges: reliability collapses and subtree darkening dominates
    (0.05, 4, 0.10, 1e-3), (0.5, 2, 0.15, 0.05),
])
def test_loss_arm_within_band_of_host(rate, attempts, tol_ldt, tol_rel):
    n = 3000
    host = stable_sweep("snow", n, 4, SEEDS, 10,
                        net=NetworkSpec(loss=RefLoss(rate=rate,
                                                     max_attempts=attempts)),
                        run=RunSpec(engine="host", backend="numpy"))
    rows = port_engine.stable_sweep(
        "snow", n, 4, SEEDS, 10,
        loss=LossModel(rate=rate, max_attempts=attempts), device="cpu")
    h_ldt = np.mean([r["ldt"] for r in host])
    d_ldt = np.mean([r["ldt"] for r in rows])
    h_rel = np.mean([r["reliability"] for r in host])
    d_rel = np.mean([r["reliability"] for r in rows])
    assert abs(d_ldt - h_ldt) / h_ldt < tol_ldt
    assert abs(d_rel - h_rel) < tol_rel
    # rmr counts the frames actually received: one per delivered node
    for r in rows:
        assert r["rmr"] == pytest.approx(122.0 * r["reliability"], rel=1e-5)
