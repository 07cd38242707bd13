"""Carry state across from the JAX package as numpy arrays.

Both functions take plain numpy arrays (e.g. the fields of a
``repro.core.planner.TreePlan`` or ``DelayBank.fwd_plane``) and never a
``repro`` object, so this package stays free of ``repro`` imports.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .planner import TreePlan


def plan_from_arrays(members, root: int, parent, depth, region_start,
                     region_len, slot, k: int, tree: Optional[int],
                     device=None) -> TreePlan:
    """A port :class:`TreePlan` from the numpy fields of a plan."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    return TreePlan(members=t(members), root=int(root), parent=t(parent),
                    depth=t(depth), region_start=t(region_start),
                    region_len=t(region_len), slot=t(slot), k=int(k),
                    tree=None if tree is None else int(tree))


def planes_from_numpy(fwd, link, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(M, n)`` forwarding/link planes as contiguous float32 tensors on
    the device, the type the sweep kernel takes."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    return t(fwd), t(link)
