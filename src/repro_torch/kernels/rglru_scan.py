"""RG-LRU linear recurrence ``h_t = a_t · h_{t-1} + b_t``: the wrapper of
the CUDA kernel ``csrc/rglru_scan.cu`` (port of
``repro.kernels.rglru_scan.rglru_scan_pallas``).

Plain version: :func:`repro_torch.kernels.ref.rglru_scan_reference`.
The kernel runs the recurrence in order over T with a float32 carry,
one thread per ``(b, w)`` channel; it is memory-bound (6 B moved per
element in bfloat16 for one multiply-add), and the source note says how
its design meets that.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"repro_rglru_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """``a``, ``b``: (B, T, W) float32 or bfloat16, one dtype, contiguous
    CUDA tensors; ``h0``: (B, W) float32.  Returns ``(h (B, T, W) in a's
    dtype, h_last (B, W) float32)``.  Raises on any other input and on a
    failed build or launch; ``rglru_scan_cuda.launches`` counts the calls
    that launched the kernel."""
    fn = "rglru_scan_cuda"
    dev = _cuda.require_cuda(fn, a)
    if a.dim() != 3:
        raise ValueError(f"{fn}: a must be (B, T, W), got {tuple(a.shape)}")
    bsz, t, w = a.shape
    _cuda.check_tensor(fn, "a", a, dev, _cuda.DTYPE_CODES)
    _cuda.check_tensor(fn, "b", b, dev, (a.dtype,), a.shape)
    _cuda.check_tensor(fn, "h0", h0, dev, (torch.float32,), (bsz, w))
    if bsz > 65535:
        raise ValueError(f"{fn}: batch {bsz} is past the kernel's grid")
    h = torch.empty_like(a)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=dev)
    lib = _cuda.library("rglru_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.repro_rglru_scan(
            h.data_ptr(), h_last.data_ptr(), a.data_ptr(), b.data_ptr(),
            h0.data_ptr(), bsz, t, w, _cuda.DTYPE_CODES[a.dtype],
            _cuda.stream(dev))
    _cuda.raise_on(err, lib, fn)
    rglru_scan_cuda.launches += 1
    return h, h_last


rglru_scan_cuda.launches = 0
