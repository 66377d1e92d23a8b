"""Explicit device resolution (counterpart of paramugsy_tpu.utils.platform).

The reference falls back to the CPU when it finds no accelerator.  The
port does not: CUDA is the default, the CPU runs only when the caller
names it, and asking for CUDA without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' (CLI: -device cpu) to run on the CPU"
        )
    return dev
