"""Dispatch wrappers for the hand-written kernels (port of
``repro.kernels.ops``): ``flash_attention``, ``decode_attention``,
``wkv6``, ``rglru_scan`` and ``tree_sweep``, with the JAX package's
signatures.

``impl`` resolution: ``"auto"`` launches the CUDA kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors; ``"cuda"``
forces the kernel and raises on CPU tensors.  A CUDA tensor never takes
the plain version here, and a failed build or launch raises: nothing
falls back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.planner import LevelCSR
from . import ref
from .decode_attention import decode_attention_cuda
from .flash_attention import flash_attention_cuda
from .rglru_scan import rglru_scan_cuda
from .tree_sweep import level_sweep, tree_sweep_cuda
from .wkv6 import wkv6_cuda

IMPLS = ("auto", "cuda")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto" and not x.is_cuda:
        return "plain"
    return "cuda"


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, impl: str = "auto"):
    """Causal GQA attention, q (B, H, S, hd) over k, v (B, Hkv, S, hd),
    with an optional sliding window (see
    :mod:`repro_torch.kernels.flash_attention`)."""
    if _resolve(impl, q) == "plain":
        return ref.mha_reference(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, length: Union[int, torch.Tensor],
                     *, window: Optional[int] = None, impl: str = "auto"):
    """One new token per row, q (B, H, hd) over caches (B, S, Hkv, hd),
    positions ``< length`` (and ``>= length - window``); ``length`` is an
    int or a 0-d integer tensor (see
    :mod:`repro_torch.kernels.decode_attention`)."""
    if _resolve(impl, q) == "plain":
        return ref.decode_attention_reference(q, k_cache, v_cache, length,
                                              window=window)
    return decode_attention_cuda(q, k_cache, v_cache, length, window=window)


def wkv6(r, k, v, logw, u, s0, *, chunk: int = 64, impl: str = "auto"):
    """RWKV-6 WKV recurrence → ``(y, s_final)`` (see
    :mod:`repro_torch.kernels.wkv6`).  ``chunk`` is the Pallas kernel's
    tile length over T; the step-by-step kernel and the plain version do
    not need it."""
    if _resolve(impl, r) == "plain":
        return ref.wkv6_reference(r, k, v, logw, u, s0)
    return wkv6_cuda(r, k, v, logw, u, s0)


def rglru_scan(a, b, h0, *, chunk: int = 256, impl: str = "auto"):
    """``h_t = a_t · h_{t-1} + b_t`` → ``(h, h_last)`` (see
    :mod:`repro_torch.kernels.rglru_scan`).  ``chunk`` is the Pallas
    kernel's tile length over T; the sequential kernel and the plain
    version do not need it."""
    if _resolve(impl, a) == "plain":
        return ref.rglru_scan_reference(a, b, h0)
    return rglru_scan_cuda(a, b, h0)


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
