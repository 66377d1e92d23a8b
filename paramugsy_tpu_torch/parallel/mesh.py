"""Device mesh for the sharded data plane (counterpart of
paramugsy_tpu.parallel.mesh).

The reference's mesh is a ``jax.sharding.Mesh`` over every process's
devices, with the axes

* ``pairs`` — data parallelism over genome pairs (the P1 strategy:
  all-pairs nucmer fan-out);
* ``kdim``  — sharding of the k-mer sketch dimension for the guide-tree
  distance matmul (a psum over the sharded axis).

Here the mesh is a plain grid of slots: a ``[n_pairs, n_kdim]`` array of
``torch.device`` s and, beside it, the rank that owns each slot.  One
device may fill several slots (eight ``cpu`` slots stand in for the
reference's eight forced host devices; the card gives one slot,
``cuda:0``).  Across the ranks of a world the grid is every rank's local
slots in rank order, as ``jax.devices()`` orders devices by process.

A tensor's placement on the mesh is a `Sharding`: `pair_sharding` splits a
leading pairs axis into one contiguous block per row of the grid, and
`replicated` puts the whole tensor on every slot.  A block is computed
by the slot in its grid row's first column (``kdim`` replicas do not
repeat it), so each row of a batch has one owner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from paramugsy_tpu_torch.runtime import dist


@dataclass(frozen=True, eq=False)
class Mesh:
    """Slots ``devices[i, j]`` (object array of ``torch.device``), owned by
    rank ``owners[i, j]``, over the axes ``("pairs", "kdim")``."""

    devices: np.ndarray
    owners: np.ndarray
    axis_names: tuple = ("pairs", "kdim")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def local_slots(self) -> list[tuple[int, int]]:
        """(pairs, kdim) indices of this process's slots, row-major."""
        me = dist.process_index()
        return [tuple(int(x) for x in ij) for ij in np.argwhere(self.owners == me)]

    @property
    def local_devices(self) -> list[torch.device]:
        return [self.devices[ij] for ij in self.local_slots()]


def make_mesh(n_pairs: int | None = None, n_kdim: int = 1, devices=None) -> Mesh:
    """A ``[n_pairs, n_kdim]`` mesh over `devices`, this process's slots
    (``None``: this rank's CUDA device, which raises without a card).  In
    a world of several ranks every rank calls it with its own slots, and
    the grid holds them all in rank order."""
    from paramugsy_tpu_torch.utils.platform import resolve_device

    if devices is None:
        devices = [dist.rank_device(resolve_device(None))]
    local = [torch.device(d) for d in devices]
    if dist.is_active():
        import torch.distributed as tdist

        per_rank = [None] * tdist.get_world_size()
        tdist.all_gather_object(per_rank, [str(d) for d in local], group=dist.host_group())
        slots = [(torch.device(d), r) for r, ds in enumerate(per_rank) for d in ds]
    else:
        slots = [(d, 0) for d in local]
    n = len(slots)
    if n_pairs is None:
        n_pairs = n // n_kdim
    if n_pairs * n_kdim != n:
        raise ValueError(f"mesh {n_pairs}x{n_kdim} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [d for d, _ in slots]
    owners = np.array([r for _, r in slots], dtype=np.int64)
    return Mesh(arr.reshape(n_pairs, n_kdim), owners.reshape(n_pairs, n_kdim))


class Shard(NamedTuple):
    """One block of a sharded tensor: its first row, its slot and data."""

    row0: int
    slot: tuple
    data: torch.Tensor


@dataclass(frozen=True, eq=False)
class Sharding:
    """Placement of a tensor on `mesh`: split over axis ``"pairs"`` along
    dim 0, or replicated (`axis` ``None``)."""

    mesh: Mesh
    axis: str | None

    def blocks(self, n_rows: int) -> list[tuple[int, int, tuple]]:
        """(row0, row1, slot) of every block of an ``n_rows`` pairs axis,
        in row order, each on its grid row's first slot."""
        n = self.mesh.devices.shape[0]
        if n_rows % n:
            raise ValueError(f"{n_rows} rows do not split over {n} mesh rows")
        per = n_rows // n
        return [(i * per, (i + 1) * per, (i, 0)) for i in range(n)]

    def shard(self, x: torch.Tensor) -> list[Shard]:
        """This process's blocks of `x`, each copied to its slot's device."""
        me = dist.process_index()
        if self.axis is None:
            return [
                Shard(0, ij, x.to(self.mesh.devices[ij]))
                for ij in self.mesh.local_slots()
            ]
        return [
            Shard(r0, ij, x[r0:r1].to(self.mesh.devices[ij]))
            for r0, r1, ij in self.blocks(x.shape[0])
            if self.mesh.owners[ij] == me
        ]


def pair_sharding(mesh: Mesh) -> Sharding:
    """Sharding for a leading pairs axis."""
    return Sharding(mesh, "pairs")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
