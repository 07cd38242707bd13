"""Dispatch wrappers for the hand-written kernels (port of
``repro.kernels.ops``; only ``tree_sweep`` so far).

``impl`` resolution: ``"auto"`` launches the CUDA kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors; ``"cuda"``
forces the kernel and raises on CPU tensors.  A CUDA tensor never takes
the plain version here, and a failed build or launch raises: nothing
falls back.
"""
from __future__ import annotations

import torch

from ..core.planner import LevelCSR
from .tree_sweep import level_sweep, tree_sweep_cuda

IMPLS = ("auto", "cuda")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto" and not x.is_cuda:
        return "plain"
    return "cuda"


def tree_sweep(parent, depth, fp, link, t0, *, root: int, height: int,
               levels: LevelCSR, impl: str = "auto"):
    """Level-synchronous closed-form delivery sweep over one plan (see
    :mod:`repro_torch.kernels.tree_sweep`); ``levels`` is the plan's
    ``level_csr``, which only the kernel reads.  Both versions compute
    the identical float program, so they are bit-equal."""
    if _resolve(impl, fp) == "plain":
        return level_sweep(parent, depth, fp, link, t0, root=root,
                           height=height)
    return tree_sweep_cuda(parent, depth, fp, link, t0, root=root,
                           height=height, levels=levels)
