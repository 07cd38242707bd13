"""PyTorch/CUDA port of the Snow reproduction (``src/repro``).

The package mirrors ``repro``'s sub-package layout module for module, so
each ported file has one counterpart to be read against.  It imports
``torch`` and numpy only — never ``jax`` and never ``repro``: the few
constants and classes it needs from ``repro``'s numpy-only modules are
copied here, not imported.

Entry points take ``device=None``, which means ``"cuda"``; without a
card they raise unless the caller asks for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA, and a
    missing CUDA runtime raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


def device_name(device: torch.device) -> str:
    """Human-readable name of the device a result was computed on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
