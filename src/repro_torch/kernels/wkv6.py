"""RWKV-6 WKV recurrence: the wrapper of the CUDA kernel ``csrc/wkv6.cu``
(port of ``repro.kernels.wkv6.wkv6_pallas``).

Plain version: :func:`repro_torch.kernels.ref.wkv6_reference`.  The
kernel runs the recurrence step by step, one block per (batch row,
head) with the float32 ``hd × hd`` state in registers; its work is
float32 operations on the CUDA cores (the source note says more).
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

HEAD_DIMS = (16, 32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"repro_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P]}


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """``r``, ``k``, ``v``, ``logw``: (B, T, H, hd) and ``u``: (H, hd), one
    dtype (float32 or bfloat16); ``s0``: (B, H, hd, hd) float32; all
    contiguous CUDA tensors, ``hd`` in :data:`HEAD_DIMS`.  Returns ``(y
    (B, T, H, hd) in r's dtype, s_final (B, H, hd, hd) float32)``.
    Raises on any other input and on a failed build or launch;
    ``wkv6_cuda.launches`` counts the calls that launched the kernel."""
    fn = "wkv6_cuda"
    dev = _cuda.require_cuda(fn, r)
    if r.dim() != 4:
        raise ValueError(f"{fn}: r must be (B, T, H, hd), got "
                         f"{tuple(r.shape)}")
    b, t, h, hd = r.shape
    _cuda.check_tensor(fn, "r", r, dev, _cuda.DTYPE_CODES)
    for name, x in (("k", k), ("v", v), ("logw", logw)):
        _cuda.check_tensor(fn, name, x, dev, (r.dtype,), r.shape)
    _cuda.check_tensor(fn, "u", u, dev, (r.dtype,), (h, hd))
    _cuda.check_tensor(fn, "s0", s0, dev, (torch.float32,), (b, h, hd, hd))
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {hd} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535 or t >= 2 ** 31:
        raise ValueError(f"{fn}: shape {tuple(r.shape)} is past the "
                         "kernel's grid")
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    lib = _cuda.library("wkv6", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.repro_wkv6(
            y.data_ptr(), s_final.data_ptr(), r.data_ptr(), k.data_ptr(),
            v.data_ptr(), logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
            b, t, h, hd, _cuda.DTYPE_CODES[r.dtype], _cuda.stream(dev))
    _cuda.raise_on(err, lib, fn)
    wkv6_cuda.launches += 1
    return y, s_final


wkv6_cuda.launches = 0
