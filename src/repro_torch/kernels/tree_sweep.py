"""Level-synchronous tree sweep: plain PyTorch version + CUDA kernel
(port of ``repro.kernels.tree_sweep``).

Snow's closed-form delivery model reduces every first-delivery time to
``t[v] = (t[parent] + fwd[parent]) + link[v]`` applied level by level
down a plan.  Two versions compute the identical float program:

* :func:`level_sweep` — the plain version, twin of ``level_sweep_xla``:
  NaN init, ``t[..., root] = t0``, then per level one gather-add-where
  over all n nodes.  It runs wherever PyTorch runs and is the version
  the CPU tests and ``chip_smoke.py`` hold the kernel against.
* :func:`tree_sweep_cuda` — the hand-written Hopper kernel
  (``csrc/tree_sweep.cu``): one launch per level over only that level's
  nodes, taken from the plan's ``level_csr``.  Bit-equal to
  :func:`level_sweep` on the same planes.

``fp`` is the forwarding delay pre-gathered at the parent with the
root's contribution zeroed (:func:`fwd_at_parent`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.planner import LevelCSR
from . import _cuda


def fwd_at_parent(parent: torch.Tensor, fwd: torch.Tensor,
                  root: int) -> torch.Tensor:
    """``fwd`` gathered at each node's parent, zero where the parent is
    the root.  ``parent[root] = -1`` gathers ``fwd[..., n-1]`` through
    negative indexing, as ``jnp.take`` wraps it in the reference."""
    return torch.where(parent == root, 0.0, fwd[..., parent])


def level_sweep(parent: torch.Tensor, depth: torch.Tensor, fp: torch.Tensor,
                link: torch.Tensor, t0: torch.Tensor, *, root: int,
                height: int) -> torch.Tensor:
    """(..., n) absolute first-delivery times, plain version.

    ``fp``/``link`` are ``(..., n)``; ``t0`` fills the leading dims.
    NaN marks unreached nodes (``depth`` outside ``1..height``)."""
    t = torch.full(torch.broadcast_shapes(fp.shape, link.shape), float("nan"),
                   dtype=fp.dtype, device=fp.device)
    t[..., root] = t0
    for h in range(1, height + 1):
        cand = (t[..., parent] + fp) + link
        t = torch.where(depth == h, cand, t)
    return t


_I64, _P = ctypes.c_longlong, ctypes.c_void_p
_SIGNATURES = {"repro_tree_sweep_f32": [_P, _P, _P, _P, _P, _P, _P,
                                        ctypes.c_int, _I64, _I64, _I64, _P]}


def tree_sweep_cuda(parent: torch.Tensor, depth: torch.Tensor,
                    fp: torch.Tensor, link: torch.Tensor, t0: torch.Tensor,
                    *, root: int, height: int,
                    levels: LevelCSR) -> torch.Tensor:
    """The CUDA sweep over one plan: ``fp``/``link`` ``(..., n)`` f32
    contiguous CUDA tensors of one shape, ``t0`` f32 of the leading
    shape, ``levels`` the plan's cached ``level_csr``.  Raises on any
    other input and on a failed build or launch.
    ``tree_sweep_cuda.launches`` counts the calls that launched the
    kernel."""
    fn = "tree_sweep_cuda"
    dev = _cuda.require_cuda(fn, fp)
    if link.shape != fp.shape or fp.dim() < 1:
        raise ValueError(f"tree_sweep_cuda: fp {tuple(fp.shape)} and link "
                         f"{tuple(link.shape)} must have one shape (..., n)")
    if tuple(t0.shape) != tuple(fp.shape[:-1]):
        raise ValueError(f"tree_sweep_cuda: t0 {tuple(t0.shape)} must be "
                         f"{tuple(fp.shape[:-1])}")
    for name, x in (("fp", fp), ("link", link), ("t0", t0)):
        _cuda.check_tensor(fn, name, x, dev, (torch.float32,))
    n = int(fp.shape[-1])
    if int(parent.shape[0]) != n:
        raise ValueError(f"tree_sweep_cuda: plan has {parent.shape[0]} "
                         f"nodes, planes have {n}")
    _cuda.check_tensor(fn, "levels.nodes", levels.nodes, dev, (torch.int32,))
    _cuda.check_tensor(fn, "levels.parents", levels.parents, dev,
                       (torch.int32,))
    ptr = np.ascontiguousarray(levels.ptr, dtype=np.int64)
    count = int(levels.nodes.numel())
    if (int(levels.parents.numel()) != count or count >= max(n, 1)
            or len(ptr) < 1 or ptr[0] != 0 or int(ptr[-1]) != count
            or np.any(np.diff(ptr) < 0)):
        raise ValueError("tree_sweep_cuda: levels is not the level "
                         f"schedule of a plan of {n} nodes")
    n_levels = min(int(height), len(ptr) - 1)
    rows = fp.numel() // n if n else 0
    out = torch.empty_like(fp)
    lib = _cuda.library("tree_sweep", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.repro_tree_sweep_f32(
            out.data_ptr(), fp.data_ptr(), link.data_ptr(), t0.data_ptr(),
            levels.nodes.data_ptr(), levels.parents.data_ptr(),
            ptr.ctypes.data, n_levels, rows, n, int(root), _cuda.stream(dev))
    _cuda.raise_on(err, lib, fn)
    tree_sweep_cuda.launches += 1
    return out


tree_sweep_cuda.launches = 0
