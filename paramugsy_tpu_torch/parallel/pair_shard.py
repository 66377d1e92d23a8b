"""Sharded multi-pair alignment step (counterpart of
paramugsy_tpu.parallel.pair_shard, the distributed data path).

The reference distributes pairwise nucmer jobs over a cluster with shell
scripts and rsync manifests (lib/base/job_processor.ml:128-154 +
scripts/sync_to.sh).  Here a *batch of genome pairs* is split over the
``pairs`` axis of a `parallel.mesh.Mesh`: each slot runs the seeding +
clustering ops on its block of rows on its own device, and the per-pair
results are all-gathered over the world's group (NCCL on the card, gloo
on the CPU) when a step asks for every row.  The guide-tree distance
matrix splits the sketch dimension over the ``kdim`` axis: each slot
multiplies its columns, and the partial products are summed over the
slots and all-reduced across the ranks (the reference's psum).

`make_sharded_packed_pair_step` is the production data plane: the same
packed rows as `ops.seeding.seed_cluster_both_packed_batch`, consumed by
`parallel.collective.sharded_genome_pair_deltas`.
"""
from __future__ import annotations

import torch

from paramugsy_tpu_torch.ops.chaining import cluster_seeds
from paramugsy_tpu_torch.ops.seeding import (
    find_seeds_both,
    seed_cluster_both_packed_batch,
)
from paramugsy_tpu_torch.parallel.mesh import Mesh, Shard, pair_sharding
from paramugsy_tpu_torch.runtime import dist


def gather_rows(mesh: Mesh, shards: list[Shard], n_rows: int) -> torch.Tensor:
    """Every block of a pairs-sharded result, this process's `shards` and
    the other ranks', as one ``[n_rows, ...]`` tensor on this process's
    first slot.  Across ranks it is one all-gather over the world's
    group (each rank's blocks, padded to the most any rank holds)."""
    device = mesh.local_devices[0]
    blocks = pair_sharding(mesh).blocks(n_rows)
    if not dist.is_active():
        return torch.cat([s.data.to(device) for s in sorted(shards, key=lambda s: s.row0)])
    per = n_rows // len(blocks)
    owner_of = [int(mesh.owners[ij]) for _, _, ij in blocks]
    if set(owner_of) != set(range(dist.process_count())):
        # Every rank sees the same mesh, so every rank raises here.
        raise ValueError("every rank of the world needs a block of the pairs axis")
    most = max(owner_of.count(r) for r in set(owner_of))
    mine = sorted(shards, key=lambda s: s.row0)
    tail = mine[0].data.shape[1:]
    buf = torch.zeros((most * per, *tail), dtype=mine[0].data.dtype, device=device)
    for t, s in enumerate(mine):
        buf[t * per : (t + 1) * per] = s.data.to(device)
    parts = dist.all_gather_tensor(buf)
    out = []
    taken = [0] * len(parts)
    for r in owner_of:
        out.append(parts[r][taken[r] * per : (taken[r] + 1) * per])
        taken[r] += 1
    return torch.cat(out)


def make_sharded_packed_pair_step(
    mesh: Mesh,
    *,
    k: int = 15,
    max_seeds: int = 1 << 15,
    unique_in_query: bool = False,
    min_match: int = 20,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
    sample_shift: int = 0,
    m_out: int | None = None,
    c_out: int | None = None,
    compact_slice: bool | None = None,
    gather: bool = False,
):
    """Step: ``[B, N]`` pair batches split over ``pairs`` -> packed int32
    ``[B, L]``.

    The default returns this process's blocks (`Shard` s: first row, slot,
    rows on the slot's device), so each process finishes only its own
    rows; with ``gather`` every row comes back on every process, one
    tensor on its first slot.  Each block's rows are the single-device
    `seed_cluster_both_packed_batch`'s, so the host tail is shared with
    the one-device path.  ``compact_slice`` changes no output; it is
    accepted and ignored, as the batch function does."""
    del compact_slice
    sharding = pair_sharding(mesh)

    def step(refs: torch.Tensor, queries: torch.Tensor, q_lens: torch.Tensor):
        out = [
            Shard(
                r.row0, r.slot,
                seed_cluster_both_packed_batch(
                    r.data, q.data, ql.data,
                    k=k, max_seeds=max_seeds, unique_in_query=unique_in_query,
                    min_match=min_match, band=band, max_gap=max_gap,
                    max_clusters=max_clusters, sample_shift=sample_shift,
                    m_out=m_out, c_out=c_out,
                ),
            )
            for r, q, ql in zip(
                sharding.shard(refs), sharding.shard(queries), sharding.shard(q_lens)
            )
        ]
        return gather_rows(mesh, out, refs.shape[0]) if gather else out

    return step


PAIR_FIELDS = (
    "c_rstart", "c_rend", "c_qstart", "c_qend", "c_weight", "c_mask",
    "n_clusters", "n_seeds",
)


def _pair_step(
    ref_codes, query_codes, q_len, *, k, max_seeds, max_clusters, min_match=20
) -> dict:
    """Single-pair device work: both-strand seeds -> per-strand clusters.

    ``q_len`` is the pair's unpadded query length (rows may be N-padded to
    the batch width).  Each field has a leading strand axis [2, ...] (0 =
    forward, 1 = reverse), int32 as the reference's (``c_mask`` bool).
    """
    seeds = find_seeds_both(ref_codes, query_codes, q_len, k=k, max_seeds=max_seeds)
    base_keep = seeds.mask & (seeds.length >= min_match)
    per_strand = []
    for reverse in (False, True):
        cl = cluster_seeds(
            seeds.rpos, seeds.qpos, seeds.length,
            base_keep & (seeds.reverse == reverse),
            max_clusters=max_clusters,
        )
        per_strand.append(
            {
                "c_rstart": cl.c_rstart, "c_rend": cl.c_rend,
                "c_qstart": cl.c_qstart, "c_qend": cl.c_qend,
                "c_weight": cl.c_weight, "c_mask": cl.c_mask,
                "n_clusters": cl.n_clusters, "n_seeds": seeds.n_runs,
            }
        )
    return {
        f: torch.stack([per_strand[0][f], per_strand[1][f]]).to(
            torch.bool if f == "c_mask" else torch.int32
        )
        for f in PAIR_FIELDS
    }


def make_sharded_pair_step(
    mesh: Mesh, *, k: int = 15, max_seeds: int = 1 << 14, max_clusters: int = 1024
):
    """Step: pair batch ``[P, N]`` x2 (and the query lengths ``[P]``,
    default the full width) -> every pair's cluster summaries, a dict of
    ``[P, 2, ...]`` tensors gathered onto every process (the reference's
    rsync-back of delta files, as one all-gather)."""
    sharding = pair_sharding(mesh)

    def call(ref_batch, query_batch, qlen_batch=None):
        if qlen_batch is None:
            qlen_batch = torch.full(
                (query_batch.shape[0],), query_batch.shape[1], dtype=torch.int32
            )
        blocks = {f: [] for f in PAIR_FIELDS}
        for r, q, ql in zip(
            sharding.shard(ref_batch), sharding.shard(query_batch), sharding.shard(qlen_batch)
        ):
            rows = [
                _pair_step(
                    r.data[i], q.data[i], ql.data[i],
                    k=k, max_seeds=max_seeds, max_clusters=max_clusters,
                )
                for i in range(r.data.shape[0])
            ]
            for f in PAIR_FIELDS:
                # The mask crosses the group as int32.
                data = torch.stack([row[f] for row in rows]).to(torch.int32)
                blocks[f].append(Shard(r.row0, r.slot, data))
        n = ref_batch.shape[0]
        return {
            f: gather_rows(mesh, blocks[f], n).to(torch.bool if f == "c_mask" else torch.int32)
            for f in PAIR_FIELDS
        }

    return call


def make_sharded_distance_step(mesh: Mesh):
    """Jaccard matrix with the sketch dimension split over ``kdim``.

    sketches ``[G, D]``: each slot of the grid's first row multiplies its
    ``D / n_kdim`` columns (``torch.matmul`` in float32), the partial
    products are summed over the slots and all-reduced across the ranks,
    and the matrix comes back on this process's first slot."""

    def step(sketches: torch.Tensor) -> torch.Tensor:
        n_kdim = mesh.devices.shape[1]
        per, rem = divmod(sketches.shape[1], n_kdim)
        if rem:
            raise ValueError(f"{sketches.shape[1]} columns do not split over {n_kdim}")
        device = mesh.local_devices[0]
        me = dist.process_index()
        g = sketches.shape[0]
        inter = torch.zeros((g, g), dtype=torch.float32, device=device)
        for j in range(n_kdim):
            if mesh.owners[0, j] != me:
                continue
            s = sketches[:, j * per : (j + 1) * per].to(mesh.devices[0, j], torch.float32)
            inter += torch.matmul(s, s.T).to(device)
        if dist.is_active():
            inter = dist.all_reduce_sum(inter)
        sizes = torch.diagonal(inter)
        union = sizes[:, None] + sizes[None, :] - inter
        return inter / torch.clamp(union, min=1.0)

    return step
