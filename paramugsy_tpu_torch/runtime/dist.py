"""Multi-process runtime initialization (counterpart of
paramugsy_tpu.runtime.dist; the SGE-backend replacement).

The reference scales across machines via qsub + rsync-over-ssh staging
(lib/base/sge_interface.ml, scripts/sync_to.sh), and the JAX package joins
its hosts through ``jax.distributed``.  The port joins a
``torch.distributed`` world configured by torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).

Two kinds of world:

* ``align -distributed`` / ``sge`` (`init_distributed()` with no device):
  a gloo group across which no tensor goes.  The ranks exchange their
  pairwise and merge artifacts through the shared ``-tmp_dir`` store
  (`runtime.artifacts`), and the group only rendezvouses them and holds
  them at one barrier before exit (`shutdown_distributed`, the
  counterpart of ``jax.distributed``'s shutdown barrier).  Their ranks may
  share one GPU, which NCCL refuses.
* the sharded data plane (`parallel.collective`; `init_distributed(device=
  ...)`): a rank on a CUDA device joins an NCCL group, across which the
  device all-gathers and all-reduces of `parallel.pair_shard` go, plus a
  gloo side group for host blobs and the liveness barrier; a CPU rank
  joins one gloo group for both.  A CUDA rank whose NCCL group does not
  form raises; it never falls back to gloo or to the CPU.

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

# The gloo group of host blobs and barriers (the world's own group, or the
# side group of an NCCL world) and the device the world's collectives take.
_host_group = None
_world_device: torch.device | None = None


@dataclass
class DistContext:
    initialized: bool
    process_index: int
    process_count: int
    n_devices: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def init_distributed(
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
    device: str | torch.device | None = None,
) -> DistContext:
    """Join the multi-process world if configured; no-op for one process.

    The world is configured by torchrun's environment variables: with
    ``MASTER_ADDR`` set, this joins the group of ``WORLD_SIZE`` ranks as
    rank ``RANK`` and raises (``torch.distributed.DistError``) when the
    world does not form within `timeout`; it never goes on as one process.
    The group is gloo unless `device` is a CUDA device: then it is NCCL on
    this rank's card (`rank_device`) with a gloo side group, and it raises
    when CUDA or NCCL is missing or the NCCL group does not form.
    Returns the process topology.
    """
    import torch.distributed as dist

    global _host_group, _world_device
    initialized = bool(os.environ.get("MASTER_ADDR"))
    if initialized:
        dev = torch.device("cpu" if device is None else device)
        if dev.type == "cuda":
            from paramugsy_tpu_torch.utils.platform import resolve_device

            dev = rank_device(resolve_device(dev))
            if not dist.is_nccl_available():
                raise RuntimeError("a CUDA rank needs NCCL, which this torch lacks")
            torch.cuda.set_device(dev)
            dist.init_process_group(
                backend="nccl", init_method="env://", timeout=timeout, device_id=dev
            )
            try:
                # Form the communicator now: a world that cannot form fails
                # here, not at its first collective.
                probe = torch.ones(1, device=dev)
                dist.all_reduce(probe)
                torch.cuda.synchronize(dev)
                _host_group = dist.new_group(backend="gloo", timeout=timeout)
            except BaseException:
                dist.destroy_process_group()
                raise
        else:
            dist.init_process_group(backend="gloo", init_method="env://", timeout=timeout)
            _host_group = dist.group.WORLD
            dev = torch.device("cpu")
        _world_device = dev
    return DistContext(
        initialized=initialized,
        process_index=dist.get_rank() if initialized else 0,
        process_count=dist.get_world_size() if initialized else 1,
        n_devices=torch.cuda.device_count(),
    )


def shutdown_distributed(ctx: DistContext) -> None:
    """Wait at the exit barrier for every rank, then leave the world."""
    import torch.distributed as dist

    global _host_group, _world_device
    if ctx.initialized:
        dist.barrier(group=_host_group)
        dist.destroy_process_group()
        _host_group = _world_device = None


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


# --------------------------------------------------------------------------
# Collectives of the sharded data plane
# --------------------------------------------------------------------------


def is_active() -> bool:
    """Is this process a rank of a formed world?"""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_active() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_active() else 1


def host_group():
    """The gloo group of host blobs and barriers (the world's own group
    when the world is gloo)."""
    return _host_group


def barrier_timeout_s() -> float:
    """The liveness barrier's bound: ``PARAMUGSY_BARRIER_TIMEOUT`` seconds,
    600 unless set (the reference's knob and default)."""
    return float(os.environ.get("PARAMUGSY_BARRIER_TIMEOUT", "600"))


def monitored_barrier(timeout_s: float) -> None:
    """Every rank meets here within `timeout_s` seconds, or each one that
    came raises naming the ranks that did not
    (``torch.distributed.monitored_barrier`` on the gloo group)."""
    import torch.distributed as dist

    dist.monitored_barrier(
        group=_host_group, timeout=datetime.timedelta(seconds=timeout_s),
        wait_all_ranks=True,
    )


def all_gather_bytes(blob: bytes) -> list[bytes]:
    """One byte blob per rank, in rank order, over the gloo group: the
    lengths first, then every payload padded to the longest."""
    import torch.distributed as dist

    n = dist.get_world_size()
    length = torch.tensor([len(blob)], dtype=torch.int64)
    lengths = [torch.zeros_like(length) for _ in range(n)]
    dist.all_gather(lengths, length, group=_host_group)
    lens = [int(t) for t in lengths]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    if blob:
        buf[: len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    bufs = [torch.zeros_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf, group=_host_group)
    return [bytes(b[:ln].numpy()) for b, ln in zip(bufs, lens)]


def all_gather_tensor(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's tensor of `t`'s shape and type, in rank order, over
    the world's group (NCCL on the card); returned on `t`'s device."""
    import torch.distributed as dist

    x = t.to(_world_device)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return [p.to(t.device) for p in parts]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's `t` over the world's group, on `t`'s
    device."""
    import torch.distributed as dist

    x = t.to(_world_device, copy=True)
    dist.all_reduce(x)
    return x.to(t.device)
