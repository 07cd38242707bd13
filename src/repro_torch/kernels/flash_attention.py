"""Causal GQA flash attention with an optional sliding window: the wrapper
of the CUDA kernel ``csrc/flash_attention.cu`` (port of
``repro.kernels.flash_attention.flash_attention_pallas``).

Plain version: :func:`repro_torch.kernels.ref.mha_reference`.  The work
is bound by operations.  bfloat16 inputs run a warp-specialised
tensor-core kernel: TMA fills a ring of K and V tiles, two consumer
warpgroups run S = Q.K^T and O += P.V as ``wgmma``, with P carried into
the second product as two bf16 terms (hi + lo, about 16 bits; the plain
version keeps it in float32, and one bf16 rounding alone errs past the
bf16 tolerance on rows that see few keys).  float32 inputs run the
first port's CUDA-core kernel: dispatch by dtype, since a float32 check
at 1e-4 cannot go through bf16 tensor cores.  Both visit only the KV
tiles each query tile can see (the source note says more).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _cuda

HEAD_DIMS = (32, 64, 128, 256)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"repro_flash_attention": [
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """``q``: (B, H, S, hd); ``k``, ``v``: (B, Hkv, S, hd); one dtype
    (float32 or bfloat16), contiguous CUDA tensors, ``hd`` in
    :data:`HEAD_DIMS`, ``H`` a multiple of ``Hkv``.  Returns (B, H, S, hd)
    in q's dtype.  bfloat16 launches the tensor-core kernel, float32 the
    CUDA-core one (by dtype; neither stands in for the other).  Raises on
    any other input and on a failed build or launch;
    ``flash_attention_cuda.launches`` counts the calls that launched the
    kernel."""
    fn = "flash_attention_cuda"
    dev = _cuda.require_cuda(fn, q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{fn}: q must be (B, H, S, hd) and k, v "
                         f"(B, Hkv, S, hd), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    _cuda.check_tensor(fn, "q", q, dev, _cuda.DTYPE_CODES, aligned=True)
    for name, x in (("k", k), ("v", v)):
        _cuda.check_tensor(fn, name, x, dev, (q.dtype,), (b, hkv, s, hd),
                           aligned=True)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {hd} not in {HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{fn}: {h} query heads are not a multiple of "
                         f"{hkv} KV heads")
    if b > 65535 or h > 65535 or s >= 2 ** 31 - 64 or (
            q.dtype == torch.bfloat16 and s > 65535 * 128):
        raise ValueError(f"{fn}: shape {tuple(q.shape)} is past the "
                         "kernel's grid")
    if window is not None and window < 1:
        raise ValueError(f"{fn}: window must be at least 1, got {window}")
    win = -1 if window is None else min(int(window), 2 ** 31 - 1)
    out = torch.empty_like(q)
    lib = _cuda.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.repro_flash_attention(
            out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            b, h, hkv, s, hd, int(bool(causal)), win, 1.0 / math.sqrt(hd),
            _cuda.DTYPE_CODES[q.dtype], _cuda.stream(dev))
    _cuda.raise_on(err, lib, fn)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
