"""Argument checks and launch plumbing shared by the kernel wrappers.
Nothing here touches CUDA at import time; a wrapper calls
:func:`library` when it launches."""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

#: dtype codes of the kernels' C interface (``csrc/common.cuh``)
DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}


def check_tensor(fn: str, name: str, x: torch.Tensor, device: torch.device,
                 dtypes: Sequence[torch.dtype], shape=None,
                 aligned: bool = False) -> None:
    """Raise unless ``x`` lies on ``device`` with one of ``dtypes``, is
    contiguous, has ``shape`` (when given) and, with ``aligned``, starts
    on a 16-byte boundary (the kernels load rows 16 bytes at a time)."""
    if x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} is {x.dtype}, expected one of "
                        f"{tuple(dtypes)}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")


def require_cuda(fn: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {x.device}")
    return x.device


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The built library of kernel ``name``, its C entries bound once
    (every entry returns a CUDA error code as ``int``)."""
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_repro_bound", False):
        for fname, argtypes in signatures.items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, lib: ctypes.CDLL, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
