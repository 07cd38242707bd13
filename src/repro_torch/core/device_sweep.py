"""Device-resident sweep engine (port of ``repro.core.device_sweep``:
the stable and loss entries).

No delay bank is built on the host.  Every delay plane is drawn on the
plans' device from one explicit ``torch.Generator`` per
``(seed, slot, tag)``, seeded through a splitmix64 mix of the three (the
counterpart of the reference's threefry ``fold_in`` chain): element
``(row, node)`` of a plane is a pure function of
``(seed, slot, tag, row, node)`` on a given device.  Seeds are a leading
batch dimension (the reference ``vmap``s over them), flattened with the
messages into the rows of the sweep, and every sweep goes through
:func:`repro_torch.kernels.ops.tree_sweep`: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

The DESIGN §10 departures from the numpy ``DelayBank`` oracle stay:
per-node Bernoulli stragglers, f32 planes, uniform 10–200 ms forwarding,
lognormal links.  So rows pin statistically against the host oracle
(``tests/test_torch_device_sweep.py``), never bit-equal; and the CUDA
generator gives other numbers than the CPU one, so CPU and card rows
differ by the same statistical margin.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ops import tree_sweep
from ..kernels.tree_sweep import fwd_at_parent
from .faults import LossModel
from .planner import SECONDARY, TreePlan
from .sim import LatencyModel

# draw tags — the last component of the generator key picks the variate
_TAG_FWD, _TAG_LINK, _TAG_STRAGGLER, _TAG_LOSS = 0, 1, 2, 3

# §5.2 distribution parameters, identical to DelayBank.sample defaults
_LAT = LatencyModel()
FWD_LO, FWD_HI = 0.010, 0.200
STRAGGLER_FRAC = 0.05
STRAGGLER_DELAY = 1.0

_MASK64 = 0xFFFFFFFFFFFFFFFF

#: ``planes(slot) -> (fwd, link)``, each ``(rows, n)``
Planes = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _generator(seed: int, slot: int, tag: int,
               device: torch.device) -> torch.Generator:
    """The generator of one ``(seed, slot, tag)`` plane."""
    key = _splitmix64(_splitmix64(_splitmix64(int(seed) & _MASK64) ^ slot)
                      ^ tag)
    g = torch.Generator(device=device)
    g.manual_seed(key)
    return g


def _plan_slot(plan: TreePlan) -> int:
    return 1 if plan.tree == SECONDARY else 0


# ------------------------------------------------------------------ #
# Counter-keyed delay generation                                      #
# ------------------------------------------------------------------ #
def _straggler_mask(seeds: Sequence[int], fixed_mask: torch.Tensor,
                    frac: float = STRAGGLER_FRAC) -> torch.Tensor:
    """(S, n) bool — per-node Bernoulli(``frac``) over the fixed ids."""
    dev = fixed_mask.device
    u = torch.stack([torch.rand(fixed_mask.shape, device=dev,
                                generator=_generator(s, 0, _TAG_STRAGGLER,
                                                     dev))
                     for s in seeds])
    return (u < frac) & fixed_mask


def _fwd_link_planes(seeds: Sequence[int], slot: int, m: int, n: int,
                     strag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S, m, n)`` forwarding/link planes of one tree slot; ``strag``
    pins straggler columns at :data:`STRAGGLER_DELAY`."""
    dev = strag.device
    fwd = torch.empty((len(seeds), m, n), dtype=torch.float32, device=dev)
    link = torch.empty_like(fwd)
    for i, s in enumerate(seeds):
        fwd[i].uniform_(FWD_LO, FWD_HI,
                        generator=_generator(s, slot, _TAG_FWD, dev))
        link[i].normal_(generator=_generator(s, slot, _TAG_LINK, dev))
    fwd.masked_fill_(strag[:, None, :], STRAGGLER_DELAY)
    link.mul_(_LAT.sigma).exp_().mul_(_LAT.median_s)
    return fwd, link


def _loss_planes(seeds: Sequence[int], slot: int, m: int, n: int,
                 loss: LossModel, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S, m, n)`` retransmit-extra delays and lost masks — Bernoulli
    per attempt, ``extra = failures × timeout``, dead after
    ``max_attempts`` (the device twin of ``LossModel.edge_faults``)."""
    a = int(loss.max_attempts)
    extra = torch.empty((len(seeds), m, n), dtype=torch.float32,
                        device=device)
    lost = torch.empty((len(seeds), m, n), dtype=torch.bool, device=device)
    for i, s in enumerate(seeds):
        u = torch.rand((a, m, n), device=device,
                       generator=_generator(s, slot, _TAG_LOSS, device))
        ok = u >= loss.rate
        lost[i] = ~ok.any(dim=0)
        first_ok = torch.argmax(ok.to(torch.int32), dim=0)
        failures = torch.where(lost[i], a, first_ok)
        extra[i] = loss.timeout_s * failures.to(torch.float32)
    return extra, lost


# ------------------------------------------------------------------ #
# Sweep and reductions                                                #
# ------------------------------------------------------------------ #
def message_starts(n_messages: int, rate_s: float, n_seeds: int,
                   device) -> torch.Tensor:
    """(S·M,) f32 origination time of every row (seed-major)."""
    t0 = torch.arange(n_messages, device=device) * float(rate_s)
    return t0.to(torch.float32).repeat(n_seeds)


def sweep_planes(plans: Sequence[TreePlan], planes: Planes,
                 t0: torch.Tensor, *, with_receipts: bool = False):
    """(rows, n) first-delivery times: the elementwise ``fmin`` over the
    plan set of one sweep per plan on the plan's slot planes.  With
    ``with_receipts`` also the (rows, n) int32 per-tree receipt count
    (a tree charges only the nodes it reaches)."""
    total = receipts = None
    for plan in plans:
        fwd, link = planes(_plan_slot(plan))
        fp = fwd_at_parent(plan.parent, fwd, plan.root)
        t = tree_sweep(plan.parent, plan.depth, fp, link, t0,
                       root=plan.root, height=plan.height,
                       levels=plan.level_csr)
        if with_receipts:
            r = (~torch.isnan(t)) & (plan.depth >= 1)[None, :]
            receipts = r.to(torch.int32) if receipts is None \
                else receipts + r
        total = t if total is None else torch.fmin(total, t)
    return (total, receipts) if with_receipts else total


def reduce_rows(total: torch.Tensor, t0: torch.Tensor, root: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row ``(ldt, reliability, got)`` of a (rows, n) time plane:
    LDT is the latest delivery after ``t0`` over non-root nodes (-inf
    for a row nothing reached), reliability the delivered share of the
    n - 1 receivers, ``got`` whether anything was delivered."""
    n = total.shape[-1]
    ids = torch.arange(n, device=total.device)
    valid = (ids != root)[None, :] & ~torch.isnan(total)
    sub = total - t0[:, None]
    ldt = torch.amax(torch.where(valid, sub, float("-inf")), dim=-1)
    rel = valid.sum(dim=-1) / (n - 1)
    return ldt, rel, valid.any(dim=-1)


def rng_planes(plans, seeds, n_messages, straggler_frac=STRAGGLER_FRAC,
               loss: Optional[LossModel] = None) -> Planes:
    """The generated planes of a seed batch, as :data:`Planes`: rows
    are seed-major ``(seed, message)``; one straggler draw per seed is
    shared by every slot, and ``loss`` folds the retransmit delays and
    dead edges (NaN) into the link plane."""
    n = plans[0].n
    dev = plans[0].device
    strag = _straggler_mask(seeds, torch.ones(n, dtype=torch.bool,
                                              device=dev), straggler_frac)

    def planes(slot):
        fwd, link = _fwd_link_planes(seeds, slot, n_messages, n, strag)
        if loss is not None:
            extra, lost = _loss_planes(seeds, slot, n_messages, n, loss, dev)
            link = torch.where(lost, float("nan"), link + extra)
            del extra, lost
        return fwd.view(-1, n), link.view(-1, n)

    return planes


# ------------------------------------------------------------------ #
# Stable scenario: all seeds × messages batched into the sweep rows   #
# ------------------------------------------------------------------ #
def _stable_stats(plans, seeds, n_messages, rate_s, straggler_frac):
    s, m = len(seeds), int(n_messages)
    t0 = message_starts(m, rate_s, s, plans[0].device)
    total = sweep_planes(plans, rng_planes(plans, seeds, m, straggler_frac),
                         t0)
    ldt, rel, _ = reduce_rows(total, t0, plans[0].root)
    return ldt.view(s, m).mean(dim=1), rel.view(s, m).mean(dim=1)


def stable_stats_device(plans: Sequence[TreePlan], seeds: Sequence[int],
                        n_messages: int, rate_s: float = 1.0,
                        straggler_frac: float = STRAGGLER_FRAC
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-seed ``(mean LDT, mean reliability)`` of a stable multi-seed
    sweep on the plans' device: all seeds × messages in one sweep per
    tree."""
    ldt, rel = _stable_stats(plans, list(seeds), n_messages, rate_s,
                             straggler_frac)
    return ldt.cpu().numpy(), rel.cpu().numpy()


def _stable_stats_loss(plans, seeds, n_messages, rate_s, straggler_frac,
                       loss):
    s, m = len(seeds), int(n_messages)
    t0 = message_starts(m, rate_s, s, plans[0].device)
    total, receipts = sweep_planes(
        plans, rng_planes(plans, seeds, m, straggler_frac, loss), t0,
        with_receipts=True)
    ldt, rel, got = reduce_rows(total, t0, plans[0].root)
    ldt, got = ldt.view(s, m), got.view(s, m)
    ldt_mean = (torch.where(got, ldt, 0.0).sum(dim=1)
                / torch.clamp(got.sum(dim=1), min=1))
    rec = receipts.sum(dim=-1).view(s, m).to(torch.float32).mean(dim=1)
    return ldt_mean, rel.view(s, m).mean(dim=1), rec


def stable_stats_device_loss(plans: Sequence[TreePlan],
                             seeds: Sequence[int], n_messages: int,
                             rate_s: float = 1.0, *, loss: LossModel,
                             straggler_frac: float = STRAGGLER_FRAC
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-seed ``(mean LDT, mean reliability, mean DATA receipts per
    message)`` of a stable sweep under flat edge loss: failed attempts
    add their timeouts to the link plane, dead edges go NaN and darken
    their subtree through the sweep's adds."""
    out = _stable_stats_loss(plans, list(seeds), n_messages, rate_s,
                             straggler_frac, loss)
    return tuple(x.cpu().numpy() for x in out)


def stable_times_device(plans: Sequence[TreePlan], seed: int,
                        n_messages: int, rate_s: float = 1.0,
                        straggler_frac: float = STRAGGLER_FRAC
                        ) -> torch.Tensor:
    """(M, n) absolute first-delivery times of one seed — the
    single-seed view of :func:`stable_stats_device` (identical draws)."""
    t0 = message_starts(n_messages, rate_s, 1, plans[0].device)
    return sweep_planes(plans, rng_planes(plans, [seed], n_messages,
                                           straggler_frac), t0)
