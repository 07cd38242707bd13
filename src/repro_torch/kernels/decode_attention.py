"""Decode attention, one new token per batch row over a KV cache: the
wrapper of the CUDA kernel ``csrc/decode_attention.cu`` (port of
``repro.kernels.decode_attention.decode_attention_pallas``).

Plain version:
:func:`repro_torch.kernels.ref.decode_attention_reference`. The work is
memory-bound: every valid cache row has to be read once. In bfloat16 the
valid range is split over :func:`split_count` blocks per (batch row, KV
head) (flash-decoding), each streaming its rows through a ring of
``cp.async`` stages into ``mma.sync`` tensor-core products, P carried as
two bf16 terms (hi + lo); a second kernel merges the float32 partials.
float32 inputs run the first port's one-kernel CUDA-core design:
dispatch by dtype, so a float32 check at 1e-4 never meets bf16 rounding.
The source note says more.
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
    _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
    ctypes.c_float, _I, _P]}
#: cache rows a split of the bf16 kernel is a multiple of; the kernel
#: takes it as an argument and refuses one that is not a multiple of its
#: own tile (``kTile`` in ``csrc/decode_attention.cu``)
SPLIT_ALIGN = 64
#: query heads per block of the bf16 kernel (the mma's 16 rows)
ROWS = 16


def split_count(b: int, hkv: int, g: int, s: int, sms: int) -> int:
    """Blocks per (batch row, KV head, 16 query heads) for a cache of
    ``s`` rows: enough that the grid covers the ``sms`` SMs eight times,
    no split shorter than two :data:`SPLIT_ALIGN` parts, and the count
    trimmed to what aligned splits of ``s`` rows use."""
    pairs = b * hkv * _cdiv(g, ROWS)
    want = max(1, min(_cdiv(8 * sms, pairs), _cdiv(s, 2 * SPLIT_ALIGN)))
    chunk = _cdiv(_cdiv(s, want), SPLIT_ALIGN) * SPLIT_ALIGN
    return _cdiv(s, chunk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          length: Union[int, torch.Tensor], *,
                          window: Optional[int] = None) -> torch.Tensor:
    """``q``: (B, H, hd); caches: (B, S, Hkv, hd); one dtype (float32 or
    bfloat16), contiguous CUDA tensors, ``hd`` in :data:`HEAD_DIMS`,
    ``H = G · Hkv`` with ``G <= 64``.  ``length`` is an int or a 0-d
    integer tensor; a CUDA one is read by the kernel on the device, so
    the host does not wait for it.  Returns (B, H, hd) in q's dtype.
    bfloat16 launches the split kernel and its merge over
    :func:`split_count` splits, with float32 scratch from
    ``torch.empty``; float32 launches the one-kernel CUDA-core design.
    Raises on any other input and on a failed build or launch;
    ``decode_attention_cuda.launches`` counts the calls that launched
    the kernel (one per call, though bf16 launches a split kernel and a
    combine kernel)."""
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
    g = h // hkv
    nsplit, part = 1, None
    if q.dtype == torch.bfloat16:
        nsplit = split_count(b, hkv, g, s, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        part = torch.empty(b * hkv * nsplit * g * (hd + 2),
                           dtype=torch.float32, device=dev)
    lib = _cuda.library("decode_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.repro_decode_attention(
            out.data_ptr(), None if part is None else part.data_ptr(),
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            None if length_dev is None else length_dev.data_ptr(),
            length_host, b, s, hkv, g, hd, nsplit, SPLIT_ALIGN,
            win, 1.0 / math.sqrt(hd),
            _cuda.DTYPE_CODES[q.dtype], _cuda.stream(dev))
    _cuda.raise_on(err, lib, fn)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
