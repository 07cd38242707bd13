"""Decode attention, one new token per batch row over a KV cache: the
wrapper of the CUDA kernel ``csrc/decode_attention.cu`` (port of
``repro.kernels.decode_attention.decode_attention_pallas``).

Plain version:
:func:`repro_torch.kernels.ref.decode_attention_reference`.  The kernel
is memory-bound: one block per (batch row, KV head) streams that head's
valid cache rows once for all its query heads; the source note says
more.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from . import _cuda

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 64
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"repro_decode_attention": [
    _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]}


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          length: Union[int, torch.Tensor], *,
                          window: Optional[int] = None) -> torch.Tensor:
    """``q``: (B, H, hd); caches: (B, S, Hkv, hd); one dtype (float32 or
    bfloat16), contiguous CUDA tensors, ``hd`` in :data:`HEAD_DIMS`,
    ``H = G · Hkv`` with ``G <= 64``.  ``length`` is an int or a 0-d
    integer tensor; a CUDA one is read by the kernel on the device, so
    the host does not wait for it.  Returns (B, H, hd) in q's dtype.
    Raises on any other input and on a failed build or launch;
    ``decode_attention_cuda.launches`` counts the calls that launched
    the kernel."""
    fn = "decode_attention_cuda"
    dev = _cuda.require_cuda(fn, q)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"{fn}: q must be (B, H, hd) and the caches "
                         f"(B, S, Hkv, hd), got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    _cuda.check_tensor(fn, "q", q, dev, _cuda.DTYPE_CODES, aligned=True)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _cuda.check_tensor(fn, name, x, dev, (q.dtype,), (b, s, hkv, hd),
                           aligned=True)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {hd} not in {HEAD_DIMS}")
    if hkv < 1 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"{fn}: {h} query heads over {hkv} KV heads "
                         f"(need a whole group of at most {MAX_GROUP})")
    if b > 65535 or s >= 2 ** 31:
        raise ValueError(f"{fn}: batch {b} or cache length {s} is past "
                         "the kernel's grid")
    if window is not None and window < 1:
        raise ValueError(f"{fn}: window must be at least 1, got {window}")
    length_dev, length_host = None, 0
    if isinstance(length, torch.Tensor):
        if length.dim() != 0 or length.dtype.is_floating_point \
                or length.dtype == torch.bool:
            raise ValueError(f"{fn}: length must be a 0-d integer tensor")
        if length.device == dev:
            length_dev = length.to(torch.int64)
        elif length.device.type == "cpu":
            length_host = int(length)
        else:
            raise ValueError(f"{fn}: length is on {length.device}, "
                             f"expected {dev} or the CPU")
    else:
        length_host = int(length)
    win = -1 if window is None else min(int(window), 2 ** 31 - 1)
    out = torch.empty_like(q)
    lib = _cuda.library("decode_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.repro_decode_attention(
            out.data_ptr(), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(),
            None if length_dev is None else length_dev.data_ptr(),
            length_host, b, s, hkv, h // hkv, hd,
            win, 1.0 / math.sqrt(hd),
            _cuda.DTYPE_CODES[q.dtype], _cuda.stream(dev))
    _cuda.raise_on(err, lib, fn)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
