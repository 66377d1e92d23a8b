"""DP engine selection and usage accounting (counterpart of
paramugsy_tpu.ops.engines).

`record()` counts which engine ran, in real pairs or segments (never
padded rows).  The backend label and the long-segment policy come from
the device of the tensors at hand, not from a global backend.

Env knob PARAMUGSY_DEVICE_DP: on the CPU, =1 sends long segments to the
wavefront engine (the plain versions of its kernels) and =0 or unset to
the native host banded engine.  On CUDA long segments always take the
wavefront kernels; =0 there raises rather than move the work to the host.
"""
from __future__ import annotations

import logging
import os
import threading

import torch

log = logging.getLogger("paramugsy.engines")

# engine name -> number of pairs/segments it handled in this process
COUNTS: dict[str, int] = {}
_logged: set[str] = set()
# The executor's worker threads record concurrently.
_lock = threading.Lock()


def record(engine: str, n: int = 1) -> None:
    with _lock:
        COUNTS[engine] = COUNTS.get(engine, 0) + n
        first = engine not in _logged
        _logged.add(engine)
    if first:
        log.info("DP engine in use: %s", engine)


def count_launch(wrapper, n: int = 1) -> None:
    """Add `n` to a kernel wrapper's ``launches`` attribute (under the
    lock: worker threads launch concurrently)."""
    with _lock:
        wrapper.launches += n


def reset_counts() -> None:
    with _lock:
        COUNTS.clear()


def record_seedcluster(device: torch.device, n: int = 1) -> None:
    """Count seeding/clustering dispatches by device type
    (``seedcluster-cuda`` or ``seedcluster-cpu``)."""
    record(f"seedcluster-{device.type}", n)


def record_repeatcluster(device: torch.device, n: int = 1) -> None:
    """Count self-repeat seeding/clustering dispatches by device type
    (``repeatcluster-cuda`` or ``repeatcluster-cpu``)."""
    record(f"repeatcluster-{device.type}", n)


def device_dp_enabled(device: torch.device) -> bool:
    """Should long-segment extension run on the wavefront engine?"""
    v = os.environ.get("PARAMUGSY_DEVICE_DP")
    if device.type == "cuda":
        if v == "0":
            raise ValueError(
                "PARAMUGSY_DEVICE_DP=0 would send long segments to the host; "
                "on a CUDA device they run on the wavefront kernels"
            )
        return True
    return v == "1"
