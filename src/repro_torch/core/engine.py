"""Closed-form stable sweep on the device (port of the device branches of
``repro.core.engine.stable_sweep``: lossless and flat edge loss).

``stable_sweep`` plans the tree set once on the device, runs every seed
× message through :mod:`.device_sweep` (one kernel sweep per tree), and
returns the reference's row schema with ``"engine": "device"``.  The
host engines, hierarchical latency, repair, control-plane accounting and
locality rings are later slices of the port and raise here.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from .. import device_name, resolve_device
from .device_sweep import stable_stats_device, stable_stats_device_loss
from .faults import LossModel
from .ids import NodeId
from .messages import Data
from .planner import PRIMARY, SECONDARY, TreePlan, plan_broadcast, plan_colored

#: options of the reference ``stable_sweep`` that later slices of the port
#: bring, each with the reference code it waits for
_LATER = {
    "hier": "the hierarchical fabric (device_sweep._stable_stats_hier, "
            "core/topology.py)",
    "repair": "pull repair (engine._repair_fill, a host-engine slice)",
    "control": "control-plane accounting (core/control.py, a host-engine "
               "slice)",
    "locality": "locality rings (core/topology.py locality_order)",
}


def stable_plans(protocol: str, members, root: NodeId, k: int,
                 ring=None, device=None) -> Tuple[TreePlan, ...]:
    """One standard tree for snow, the primary/secondary double tree for
    coloring (the primary alone for views of two or fewer)."""
    n = int(members.shape[0]) if ring is None else int(ring.shape[0])
    if protocol == "coloring":
        plans = (plan_colored(members, root, k, PRIMARY, ring=ring,
                              device=device),)
        if n > 2:
            plans += (plan_colored(members, root, k, SECONDARY, ring=ring,
                                   device=device),)
        return plans
    return (plan_broadcast(members, root, k, ring=ring, device=device),)


def plan_bytes(plans: Sequence[TreePlan], payload: int) -> int:
    """Total DATA bytes one broadcast moves: one frame per delivery, one
    delivery per node reached per tree."""
    size = Data(payload).size
    return size * sum(int((p.depth >= 1).sum()) for p in plans)


def stable_sweep(protocol: str, n: int, k: int, seeds: Sequence[int],
                 n_messages: int = 2, rate_s: float = 1.0, *,
                 loss: Optional[LossModel] = None,
                 plans: Optional[Tuple[TreePlan, ...]] = None,
                 payload: int = 64, hier=None, repair=None, control=None,
                 locality: Optional[str] = None,
                 device=None) -> List[dict]:
    """Multi-seed stable-scenario sweep on the device.

    Rows: ``ldt`` (s), ``rmr`` / ``rmr_redundant`` (bytes/node per
    message), ``reliability``, ``n_messages``, ``wall_s`` (the sweep's
    wall time split evenly over the seeds) and ``plan_s`` (the one-time
    plan build, on the first row only), ``engine`` = ``"device"``, plus
    ``device_name``.  Under active ``loss`` rows also carry
    ``n_repaired`` = 0 and ``rmr`` counts the frames actually received.
    ``device=None`` runs on CUDA and raises without it."""
    if protocol not in ("snow", "coloring"):
        raise ValueError(f"closed-form engine models snow/coloring, "
                         f"not {protocol!r}")
    for name, val in (("hier", hier), ("repair", repair),
                      ("control", control), ("locality", locality)):
        if val is not None:
            raise NotImplementedError(
                f"stable_sweep({name}=...) is not ported yet: it comes with "
                f"the later slice that ports {_LATER[name]}")
    dev = resolve_device(device)
    seeds = [int(s) for s in seeds]
    plan_s = 0.0
    if plans is None:
        tp = time.perf_counter()
        plans = stable_plans(protocol, torch.arange(n, device=dev), 0, k,
                             device=dev)
        for p in plans:
            p.level_csr                     # build the kernel schedule here
        plan_s = time.perf_counter() - tp
    nbytes = plan_bytes(plans, payload)
    frame = Data(payload).size
    lossy = loss is not None and loss.active
    tw = time.perf_counter()
    if lossy:
        ldt, rel, rec = stable_stats_device_loss(plans, seeds, n_messages,
                                                 rate_s, loss=loss)
    else:
        ldt, rel = stable_stats_device(plans, seeds, n_messages, rate_s)
    wall = (time.perf_counter() - tw) / max(1, len(seeds))
    dname = device_name(plans[0].device)
    rows = []
    for i, seed in enumerate(seeds):
        row = {
            "seed": seed, "n": n, "k": k,
            "ldt": float(ldt[i]),
            "rmr": nbytes / (n - 1),
            "rmr_redundant": float(frame * (len(plans) - 1)),
            "reliability": float(rel[i]),
            "n_messages": n_messages,
            "wall_s": wall,
            "plan_s": plan_s if i == 0 else 0.0,
            "engine": "device",
            "device_name": dname,
        }
        if lossy:
            delivered = float(rel[i]) * (n - 1)
            row["rmr"] = frame * float(rec[i]) / (n - 1)
            row["rmr_redundant"] = frame * (float(rec[i]) - delivered) / (n - 1)
            row["n_repaired"] = 0
        rows.append(row)
    return rows
