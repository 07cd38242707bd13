"""Whole-tree dissemination planner on tensors (port of
``repro.core.planner``: ``_plan`` and its helpers, without ``plan_delta``).

For a frozen view the dissemination tree is a pure function of
``(members, root, k)``; sibling regions are disjoint ``(start, length)``
index ranges, so each level of the tree expands in one batched tensor
operation.  The loop over levels stays on the host; each level's math
runs on the entry point's device.  Every plan array equals the numpy
planner's bit for bit (``tests/test_torch_planner.py``), which takes
three care points over numpy:

* ``J * length / denom`` divides in float64 (an int64 tensor division
  would give float32 and move ``round`` ties);
* ``torch.round`` is round-half-even, as ``numpy.rint`` is;
* integer ``%`` and ``//`` on tensors follow Python's floor semantics,
  as numpy's do.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from .ids import NodeId

PRIMARY = 0
SECONDARY = 1

_MAX_LEVELS = 128          # >> any real height (Eq. 8: ~log_k n + 1)


class LevelCSR(NamedTuple):
    """Nodes of depth 1..height in level order with their parents (int32,
    on the plan's device), and the host offsets ``ptr`` of each level
    (``ptr[h-1]:ptr[h]`` is level h): the sweep kernel's schedule."""

    nodes: torch.Tensor
    parents: torch.Tensor
    ptr: np.ndarray


def _level_order(depth: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """Ring indices of depth 1..height in level order, via one stable
    argsort, and the host offsets of each level within them (unreached
    nodes, depth -1, and the root, depth 0, sort first and are cut)."""
    height = int(depth.max()) if depth.numel() else 0
    order = torch.argsort(depth, stable=True)
    bounds = torch.searchsorted(
        depth[order], torch.arange(1, height + 2, device=depth.device))
    b = bounds.cpu().numpy().astype(np.int64)
    return order[int(b[0]):int(b[-1])], np.ascontiguousarray(b - b[0])


def _split(nodes: torch.Tensor, ptr: np.ndarray) -> Tuple[torch.Tensor, ...]:
    return tuple(nodes[ptr[h]:ptr[h + 1]] for h in range(len(ptr) - 1))


def depth_levels(depth: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Ring-index groups per depth 1..height — the iteration order of
    every level-synchronous sweep."""
    return _split(*_level_order(depth))


def level_csr(parent: torch.Tensor, depth: torch.Tensor) -> LevelCSR:
    """:class:`LevelCSR` of one plan, from the grouping of
    :func:`depth_levels`."""
    n = int(depth.shape[0])
    if n >= 2 ** 31:
        raise ValueError(f"level_csr: n = {n} does not fit int32 indices")
    sel, ptr = _level_order(depth)
    return LevelCSR(sel.to(torch.int32).contiguous(),
                    parent[sel].to(torch.int32).contiguous(), ptr)


@dataclass(frozen=True)
class TreePlan:
    """The complete dissemination tree of one broadcast over a frozen view.

    Per-node tensors are indexed by ring index (position in ``members``)
    and lie on one device.  ``parent[root] == -1``; ``depth`` is -1 for
    nodes the tree does not reach; ``region_len == 1`` marks a leaf;
    ``slot`` is the emission order among siblings."""

    members: torch.Tensor        #: (n,) node ids in ring order
    root: int                    #: ring index of the tree root
    parent: torch.Tensor         #: (n,) int64 ring index of parent; -1 root
    depth: torch.Tensor          #: (n,) int64 hop count from the root
    region_start: torch.Tensor   #: (n,) int64 ring index of the region
    region_len: torch.Tensor     #: (n,) int64 region length (1 ⇒ leaf)
    slot: torch.Tensor           #: (n,) int64 emission order among siblings
    k: int
    tree: Optional[int] = None   #: None=standard, 0=primary, 1=secondary

    def __len__(self) -> int:
        return int(self.members.shape[0])

    @property
    def n(self) -> int:
        return len(self)

    @property
    def device(self) -> torch.device:
        return self.parent.device

    @cached_property
    def height(self) -> int:
        """Deepest level (cached: reading it synchronises the device)."""
        return int(self.depth.max()) if self.depth.numel() else 0

    @cached_property
    def levels(self) -> Tuple[torch.Tensor, ...]:
        """Cached :func:`depth_levels` of this plan (int64 splits of
        :attr:`level_csr`, so the plan sorts ``depth`` once)."""
        csr = self.level_csr
        return _split(csr.nodes.to(torch.int64), csr.ptr)

    @cached_property
    def level_csr(self) -> LevelCSR:
        """Cached :func:`level_csr` of this plan: the sweep kernel's
        schedule."""
        return level_csr(self.parent, self.depth)


@dataclass
class _Records:
    """Per-level child emissions, concatenated at the end of planning."""

    idx: List[torch.Tensor] = field(default_factory=list)
    parent: List[torch.Tensor] = field(default_factory=list)
    depth: List[torch.Tensor] = field(default_factory=list)
    start: List[torch.Tensor] = field(default_factory=list)
    length: List[torch.Tensor] = field(default_factory=list)
    slot: List[torch.Tensor] = field(default_factory=list)

    def add(self, idx, parent, depth, start, length, slot):
        self.idx.append(idx)
        self.parent.append(parent)
        self.depth.append(torch.full_like(idx, depth))
        self.start.append(start)
        self.length.append(length)
        self.slot.append(slot)


def _round_div(num: torch.Tensor, denom: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``rint(num / denom)`` with numpy's int64 → float64 true division."""
    q = num.to(torch.float64) / denom.to(torch.float64)
    return torch.round(q).to(dtype)


def _split_sides_plain(start, length, kprime, slot_base):
    """Balanced split of one side for a whole frontier at once: ``(R,)``
    side tensors → ``(R, k')`` child regions + validity mask."""
    parts = torch.clamp(length, max=kprime)
    J = torch.arange(kprime, device=start.device)[None, :]
    valid = J < parts[:, None]
    denom = torch.clamp(parts, min=1)[:, None]
    lo = _round_div(J * length[:, None], denom, start.dtype)
    hi = _round_div((J + 1) * length[:, None], denom, start.dtype) - 1
    mid = (lo + hi + 1) // 2          # midpoint_offset: right-of-centre
    cstart = start[:, None] + lo
    clen = hi - lo + 1
    selfoff = mid - lo
    slot = slot_base + J
    return cstart, clen, selfoff, slot, valid


def _split_sides_colored(n, start, length, kprime, want, i0, slot_base):
    """Colored side split: on-color side offsets form two stride-2
    arithmetic progressions, one before the ring-wrap seam at
    ``t_w = n - d0`` and one after.  Also returns the row mask of sides
    with no on-color member (emitted by the caller as direct leaves)."""
    d0 = (start - i0) % n
    tw = n - d0
    len_a = torch.minimum(length, tw)
    a0 = (want - d0) % 2
    cnt_a = torch.clamp((len_a - a0 + 1) // 2, min=0)
    b_par = (want - d0 + n) % 2
    b0 = tw + ((b_par - tw) % 2)
    cnt_b = torch.clamp((length - b0 + 1) // 2, min=0)
    cnt = cnt_a + cnt_b

    def at(q):
        return torch.where(q < cnt_a[:, None], a0[:, None] + 2 * q,
                           b0[:, None] + 2 * (q - cnt_a[:, None]))

    parts = torch.clamp(cnt, max=kprime)
    J = torch.arange(kprime, device=start.device)[None, :]
    valid = (J < parts[:, None]) & (length[:, None] > 0)
    denom = torch.clamp(parts, min=1)[:, None]
    lo = _round_div(J * cnt[:, None], denom, start.dtype)
    hi = _round_div((J + 1) * cnt[:, None], denom, start.dtype) - 1
    mid_off = at((lo + hi + 1) // 2)
    # group spans tile the side: cut halfway between the last on-color
    # member of one group and the first of the next
    at_hi = at(hi)
    at_next_lo = at(torch.roll(lo, -1, dims=1))
    is_last = (J + 1) >= parts[:, None]
    end = torch.where(is_last, length[:, None] - 1, (at_hi + at_next_lo) // 2)
    prev_end = torch.roll(end, 1, dims=1)
    sstart = torch.where(J == 0, torch.zeros_like(end), prev_end + 1)

    cstart = start[:, None] + sstart
    clen = end - sstart + 1
    selfoff = mid_off - sstart
    slot = slot_base + J
    allleaf = (cnt == 0) & (length > 0)
    return cstart, clen, selfoff, slot, valid, allleaf


def _emit_leaf_run(rec, n, depth, node, start, length, slot0):
    """Record every member of ``(start, length)`` runs as leaf children
    of ``node`` — the ≤ k direct-delivery rows and the no-on-color sides."""
    if int(length.shape[0]) == 0:
        return
    cap = int(length.max())
    if cap <= 0:
        return
    T = torch.arange(cap, device=length.device)[None, :]
    valid = T < length[:, None]
    idx = (start[:, None] + T)[valid] % n
    rec.add(idx, node[:, None].expand(-1, cap)[valid],
            depth, idx, torch.ones_like(idx), (slot0[:, None] + T)[valid])


def _expand(n, k, frontier, depth, rec, want=None, i0=None):
    """One synchronous level: expand every frontier region at once.
    ``frontier`` is ``(node, Ls, Ll, Rs, Rl)``; returns the next one."""
    node, Ls, Ll, Rs, Rl = frontier
    kprime = k // 2
    m = Ll + Rl

    # -- direct delivery rows (Alg. 1 lines 4-12): whole region ≤ k ------
    dmask = (m <= k) & (m > 0)
    if bool(dmask.any()):
        dnode, dLs, dLl, dRs, dRl = (a[dmask] for a in (node, Ls, Ll, Rs, Rl))
        _emit_leaf_run(rec, n, depth + 1,
                       torch.cat((dnode, dnode)),
                       torch.cat((dLs, dRs)),
                       torch.cat((dLl, dRl)),
                       torch.cat((torch.zeros_like(dLl), dLl)))

    # -- split rows: balanced (or colored) side splitting -----------------
    smask = m > k
    if not bool(smask.any()):
        empty = node[:0]
        return (empty, empty, empty, empty, empty)
    snode, sLs, sLl, sRs, sRl = (a[smask] for a in (node, Ls, Ll, Rs, Rl))
    # right rows fan out with slot base 0, left rows with base k
    pnode = torch.cat((snode, snode))
    side_start = torch.cat((sRs, sLs))
    side_len = torch.cat((sRl, sLl))
    slot_base = torch.cat(
        (torch.zeros_like(sRl), torch.full_like(sLl, k)))[:, None]
    if want is None:
        cstart, clen, selfoff, slot, valid = _split_sides_plain(
            side_start, side_len, kprime, slot_base)
    else:
        cstart, clen, selfoff, slot, valid, allleaf = _split_sides_colored(
            n, side_start, side_len, kprime, want, i0, slot_base)
        if bool(allleaf.any()):
            _emit_leaf_run(rec, n, depth + 1, pnode[allleaf],
                           side_start[allleaf], side_len[allleaf],
                           slot_base[allleaf, 0])
    cidx = (cstart + selfoff)[valid] % n
    cstart_v, clen_v, selfoff_v = cstart[valid], clen[valid], selfoff[valid]
    rec.add(cidx, pnode[:, None].expand_as(valid)[valid],
            depth + 1, cstart_v % n, clen_v, slot[valid])
    recurse = clen_v > 1
    node2 = cidx[recurse]
    start2 = cstart_v[recurse] % n
    off2 = selfoff_v[recurse]
    len2 = clen_v[recurse]
    return (node2, start2, off2, start2 + off2 + 1, len2 - off2 - 1)


def _plan(members: torch.Tensor, root_idx: int, k: int,
          tree: Optional[int]) -> TreePlan:
    if k < 2 or k % 2 != 0:
        raise ValueError(f"fan-out k must be a positive multiple of 2, got {k}")
    dev = members.device
    n = int(members.shape[0])
    i0 = root_idx
    rec = _Records()

    def one(v):
        return torch.tensor([v], dtype=torch.int64, device=dev)

    # Bootstrap: the tree root's region is everyone else, centre-split
    # (Eq. 1-3); the secondary root owns the same region from its edge.
    if tree == SECONDARY:
        if n < 2:
            frontier = None
        else:
            sroot = (i0 - 1) % n
            rec.add(one(sroot), one(i0), 1, one((i0 + 1) % n),
                    one(n - 1), one(0))
            frontier = (one(sroot), one((i0 + 1) % n), one(n - 2),
                        one(i0), one(0))
            depth = 1
    if tree != SECONDARY:
        arclen = n - 1
        nprime = arclen // 2
        frontier = (one(i0), one((i0 + 1 + nprime) % n), one(arclen - nprime),
                    one((i0 + 1) % n), one(nprime))
        depth = 0
    want = None if tree is None else (0 if tree == PRIMARY else 1)

    if frontier is not None:
        for _ in range(_MAX_LEVELS):
            if int(frontier[0].shape[0]) == 0:
                break
            frontier = _expand(n, k, frontier, depth, rec, want=want, i0=i0)
            depth += 1
        else:  # pragma: no cover - structurally impossible
            raise RuntimeError("planner did not converge")

    def full(v):
        return torch.full((n,), v, dtype=torch.int64, device=dev)

    parent, depths, rstart, rlen, slots = full(-1), full(-1), full(0), \
        full(0), full(0)
    # the root owns the full ring
    parent[i0] = -1
    depths[i0] = 0
    rstart[i0] = i0
    rlen[i0] = n
    if rec.idx:
        idx = torch.cat(rec.idx)
        parent[idx] = torch.cat(rec.parent)
        depths[idx] = torch.cat(rec.depth)
        rstart[idx] = torch.cat(rec.start)
        rlen[idx] = torch.cat(rec.length)
        slots[idx] = torch.cat(rec.slot)
    return TreePlan(members=members, root=root_idx, parent=parent,
                    depth=depths, region_start=rstart, region_len=rlen,
                    slot=slots, k=k, tree=tree)


def _resolve(view: Union[torch.Tensor, np.ndarray, Sequence[NodeId]],
             root: NodeId, ring=None, device=None
             ) -> Tuple[torch.Tensor, int]:
    """``(members, root ring index)`` on the entry point's device.

    ``ring`` is an explicit duplicate-free permutation of the view (not
    necessarily sorted): the root is found by scan.  Otherwise a tensor
    or numpy array is trusted sorted and duplicate-free, and any other
    sequence is sorted and deduplicated."""
    dev = resolve_device(device)
    if ring is not None:
        members = torch.as_tensor(ring, dtype=torch.int64, device=dev)
        hits = torch.nonzero(members == root).flatten()
        if hits.numel() == 0:
            raise KeyError(root)
        return members, int(hits[0])
    if not isinstance(view, (torch.Tensor, np.ndarray)):
        view = sorted(set(view))
    members = torch.as_tensor(view, dtype=torch.int64, device=dev)
    key = torch.tensor([root], dtype=torch.int64, device=dev)
    i = int(torch.searchsorted(members, key))
    if i >= members.shape[0] or int(members[i]) != root:
        raise KeyError(root)
    return members, i


def plan_broadcast(view, root: NodeId, k: int, ring=None,
                   device=None) -> TreePlan:
    """Whole-tree plan of a standard Snow broadcast over a frozen view;
    ``ring`` plans over an explicit permutation of the members."""
    members, root_idx = _resolve(view, root, ring, device)
    return _plan(members, root_idx, k, tree=None)


def plan_colored(view, root: NodeId, k: int, tree: int, ring=None,
                 device=None) -> TreePlan:
    """Whole-tree plan of one Coloring tree (§4.6)."""
    members, root_idx = _resolve(view, root, ring, device)
    return _plan(members, root_idx, k, tree=tree)


def plan_two_trees(view, root: NodeId, k: int, ring=None,
                   device=None) -> Tuple[TreePlan, TreePlan]:
    """(primary, secondary) plans of the Coloring double tree."""
    return (plan_colored(view, root, k, PRIMARY, ring=ring, device=device),
            plan_colored(view, root, k, SECONDARY, ring=ring, device=device))
