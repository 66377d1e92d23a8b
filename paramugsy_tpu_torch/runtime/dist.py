"""Multi-process runtime initialization (counterpart of
paramugsy_tpu.runtime.dist; the SGE-backend replacement).

The reference scales across machines via qsub + rsync-over-ssh staging
(lib/base/sge_interface.ml, scripts/sync_to.sh), and the JAX package joins
its hosts through ``jax.distributed``.  The port joins a
``torch.distributed`` world configured by torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  The group is gloo: no tensor crosses it.  The ranks
exchange their pairwise and merge artifacts through the shared
``-tmp_dir`` store (`runtime.artifacts`), and the group only rendezvouses
them and holds them at one barrier before exit (`shutdown_distributed`,
the counterpart of ``jax.distributed``'s shutdown barrier).  NCCL, and
tensors across ranks, come with the sharded data plane (ROADMAP A9b);
NCCL also refuses two ranks on one GPU.

Single-process runs (no ``MASTER_ADDR``) skip initialization entirely,
the same seam the reference's ``local`` backend provides.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch

# How long a rank waits for the others, at the rendezvous and at the exit
# barrier (torch.distributed's own default for gloo).
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclass
class DistContext:
    initialized: bool
    process_index: int
    process_count: int
    n_devices: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def init_distributed(timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> DistContext:
    """Join the multi-process world if configured; no-op for one process.

    The world is configured by torchrun's environment variables: with
    ``MASTER_ADDR`` set, this joins the gloo group of ``WORLD_SIZE`` ranks
    as rank ``RANK`` and raises (``torch.distributed.DistError``) when the
    world does not form within `timeout`; it never goes on as one process.
    Returns the process topology.
    """
    import torch.distributed as dist

    initialized = bool(os.environ.get("MASTER_ADDR"))
    if initialized:
        dist.init_process_group(backend="gloo", init_method="env://", timeout=timeout)
    return DistContext(
        initialized=initialized,
        process_index=dist.get_rank() if initialized else 0,
        process_count=dist.get_world_size() if initialized else 1,
        n_devices=torch.cuda.device_count(),
    )


def shutdown_distributed(ctx: DistContext) -> None:
    """Wait at the exit barrier for every rank, then leave the world."""
    import torch.distributed as dist

    if ctx.initialized:
        dist.barrier()
        dist.destroy_process_group()


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    `device` (on one card every rank shares ``cuda:0``); a CPU device
    stays the CPU."""
    if device.type != "cuda":
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def local_pair_slice(n_pairs: int, ctx: DistContext) -> slice:
    """The contiguous slice of a global pair list this process owns."""
    per = (n_pairs + ctx.process_count - 1) // ctx.process_count
    start = ctx.process_index * per
    return slice(start, min(start + per, n_pairs))
