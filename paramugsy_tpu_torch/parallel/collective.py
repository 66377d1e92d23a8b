"""Collectives-based distributed pairwise phase (counterpart of
paramugsy_tpu.parallel.collective; SURVEY P6 data plane).

Replaces the reference's rsync-manifest data staging
(lib/base/script_task.ml:63-93, scripts/sync_to.sh) with collectives of a
``torch.distributed`` world (`runtime.dist`): the pair batch is split over
the mesh's ``pairs`` axis, each slot runs the seeding/clustering ops on
its rows, each process finishes only its own rows on the host, and one
all-gather of the finished entries (`parallel.wire` blobs) hands every
process every pair's deltas.  The host tail (unpack -> chain ->
gap-extend -> delta entries) is the code the single-device path runs;
the filesystem `ArtifactStore` is demoted to resume and the merge phase.

`align_fastas_sharded` is the multi-process entry point: genomes -> guide/job
tree -> ONE sharded pairwise phase -> tree merges fed from the gathered
delta pool -> final MAF.

Failure semantics (the two modes have different contracts):

* **Collective (sharded) phase: FAIL-FAST.**  Every rank must reach each
  collective; a rank that dies or stalls aborts the phase on all
  survivors promptly — via this module's liveness barrier
  (``DeadHostError`` after ``PARAMUGSY_BARRIER_TIMEOUT``, default 600 s,
  naming the missing rank) or, when it fires first, the transport's own
  error on a closed peer connection — never a deadlocked all-gather.
  This mirrors the reference's disappeared-job => Failed rule
  (lib/base/queue_server.ml:48-54).
* **Store-backed merge phase (``tmp_dir``): FAULT-TOLERANT.**  Owners
  publish per-pair/per-node artifacts; survivors re-own work from a dead
  or stalled owner via claim heartbeats (runtime/artifacts.py), so the
  run completes without the dead host.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from paramugsy_tpu_torch.formats.delta import DeltaEntry
from paramugsy_tpu_torch.formats.maf import MAF_HEADER, write_maf
from paramugsy_tpu_torch.ops import engines
from paramugsy_tpu_torch.ops.align_pair import (
    AlignConfig,
    _chains_of_strands,
    _finish_pair,
    align_pair,
    assemble_windowed,
    effective_break,
    initial_max_seeds,
    resolve_sample_shift,
    transfer_slice,
    window_pair_jobs,
    windowed_sub_config,
)
from paramugsy_tpu_torch.ops.encode import bucket_size, encode
from paramugsy_tpu_torch.ops.seeding import unpack_seed_clusters
from paramugsy_tpu_torch.parallel.mesh import Mesh, make_mesh
from paramugsy_tpu_torch.parallel.pair_shard import make_sharded_packed_pair_step
from paramugsy_tpu_torch.parallel.wire import decode_results, encode_results
from paramugsy_tpu_torch.pipeline import Aligner, PipelineConfig, finalize_blocks, load_genome
from paramugsy_tpu_torch.runtime import dist
from paramugsy_tpu_torch.runtime.artifacts import ArtifactStore, PairOwnership
from paramugsy_tpu_torch.runtime.executor import JobExecutor
from paramugsy_tpu_torch.utils.obs import METRICS


def tree_pairs(tree) -> list[tuple[str, str]]:
    """All (left, right) genome-name pairs any tree node needs, deduped
    (pm_job.ml:83-91 enumeration via JobTree.all_pairwise)."""
    seen = set()
    out: list[tuple[str, str]] = []
    for p in tree.all_pairwise():
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


class DeadHostError(RuntimeError):
    """A peer process died or stalled during a collective phase."""


# What gloo, NCCL and the rendezvous store say when a peer is gone.
_DEAD_HOST_MARKERS = (
    "monitoredBarrier",
    "Connection closed by peer",
    "Connection reset by peer",
    "Broken pipe",
    "Timed out",
    "timed out",
    "NCCL communicator was aborted",
    "remote process exited",
    "DistNetworkError",
    "DistStoreError",
)


@contextlib.contextmanager
def fail_fast_contract(phase: str = "sharded"):
    """Normalize peer-death failures to the documented contract.

    A dead peer can surface two ways: this module's liveness barrier
    (bounded, explicit) or a transport-level collective failure.  Both
    become ``DeadHostError``, so callers observe ONE fail-fast contract
    regardless of which detector fired first."""
    try:
        yield
    except DeadHostError:
        raise
    except Exception as e:
        s = f"{type(e).__name__}: {e}"
        if any(m in s for m in _DEAD_HOST_MARKERS):
            raise DeadHostError(
                f"collective phase '{phase}': a peer process died "
                f"({s.splitlines()[0][:200]}).  The sharded phase is "
                "fail-fast by contract — restart the job; the "
                "store-backed merge mode (tmp_dir) is the fault-tolerant "
                "path."
            ) from e
        raise


def _phase_barrier(tag: str, timeout_s: float | None = None) -> None:
    """Fail-fast liveness barrier guarding each collective phase.

    A gloo or NCCL all-gather with a stalled peer waits out the group's
    timeout (30 min); this barrier on the gloo group (bounded by
    ``PARAMUGSY_BARRIER_TIMEOUT``, default 600 s) turns that into a
    prompt ``DeadHostError`` naming the missing rank on every survivor.
    No-op in one process."""
    if dist.process_count() == 1:
        return
    if timeout_s is None:
        timeout_s = dist.barrier_timeout_s()
    try:
        dist.monitored_barrier(timeout_s)
    except Exception as e:
        raise DeadHostError(
            f"collective phase '{tag}': a peer process died or stalled past "
            f"{timeout_s:.0f}s at the liveness barrier ({str(e).splitlines()[0][:200]}).  "
            "The sharded phase is fail-fast by contract — restart the job; "
            "the store-backed merge mode (tmp_dir) is the fault-tolerant path."
        ) from e


def _exchange_blobs(blob: bytes) -> list[bytes]:
    """All-gather one byte blob per process over the host (gloo) group.

    The control-plane exchange for finished (tiny) results: lengths first,
    then the max-length-padded payloads (every process holds n_proc x
    max_blob transiently — acceptable for delta-entry payloads, which are
    orders of magnitude smaller than the packed seed tensors).  Entered
    through a `_phase_barrier`, so a dead peer raises `DeadHostError`
    instead of deadlocking the gather.  Without a world this returns
    ``[blob]``; a world of one rank still gathers through its group."""
    if not dist.is_active():
        return [blob]
    _phase_barrier("exchange")
    return dist.all_gather_bytes(blob)


def sharded_genome_pair_deltas(
    genome_pairs: list,
    cfg: AlignConfig,
    mesh: Mesh,
    device_cache: dict | None = None,
) -> list[list[DeltaEntry]]:
    """Pairwise deltas for genome pairs with the mesh as the data plane.

    Contig-level jobs are padded to ONE shared bucket shape and the batch
    is split over the ``pairs`` mesh axis.  The packed results stay on
    their slots: each process unpacks/chains/gap-extends only the rows of
    its own slots (the host tail scales 1/hosts), then the finished delta
    entries — two orders of magnitude smaller than the packed seeds — are
    exchanged with one host all-gather.

    Contigs beyond the windowing limit decompose into window-pair
    sub-jobs that ride the SAME batch: every process receives all pieces
    in the entry exchange and deterministically midpoint-dedups +
    junction-fuses them back into single entries (`assemble_windowed`).
    Jobs that overflow the seed bucket fall back to the local single-pair
    path on the process that owns their row, on the row's slot.
    """
    jobs: list[tuple] = []
    owners: list[int] = []
    for t, (a, b) in enumerate(genome_pairs):
        for ra_name, ra in a.seqs.items():
            for rb_name, rb in b.seqs.items():
                jobs.append((ra, rb, ra_name, rb_name))
                owners.append(t)

    enc = []
    batched: list[int] = []
    long_jobs: list[int] = []
    for idx, (ref_seq, query_seq, rn, qn) in enumerate(jobs):
        ref_np = ref_seq if isinstance(ref_seq, np.ndarray) else encode(ref_seq)
        query_np = (
            query_seq if isinstance(query_seq, np.ndarray) else encode(query_seq)
        )
        enc.append((ref_np, query_np, rn, qn))
        if max(len(ref_np), len(query_np)) > cfg.window:
            long_jobs.append(idx)
        else:
            batched.append(idx)

    # Long contigs: expand into window-pair sub-jobs placed like any other
    # row.  Sub-rows index past len(jobs) in the result/exchange space;
    # win_meta maps each long job to its sub-row span.
    sub_cfg = windowed_sub_config(cfg)
    sub_enc: list[tuple] = []
    win_meta: dict[int, tuple[list[tuple], int, int]] = {}
    for idx in long_jobs:
        ref_np, query_np, rn, qn = enc[idx]
        wjobs, wmeta = window_pair_jobs(ref_np, query_np, rn, qn, cfg)
        base = len(jobs) + len(sub_enc)
        sub_enc.extend(wjobs)
        win_meta[idx] = (wmeta, base, len(wjobs))

    def row_data(row_idx: int) -> tuple:
        """(ref_np, query_np, rn, qn, finish_cfg) for a batch row."""
        if row_idx < len(jobs):
            return (*enc[row_idx], cfg)
        return (*sub_enc[row_idx - len(jobs)], sub_cfg)

    all_rows = batched + list(range(len(jobs), len(jobs) + len(sub_enc)))
    local_results: dict[int, list[DeltaEntry]] = {}
    if all_rows:
        # One shared bucket across the whole phase, as the reference's one
        # static shape: sizes below come from it, not from each row.
        rb = max(bucket_size(len(row_data(i)[0])) for i in all_rows)
        qb = max(bucket_size(len(row_data(i)[1])) for i in all_rows)
        n_dev = mesh.devices.size
        B = -(-len(all_rows) // n_dev) * n_dev
        refs = np.full((B, rb), 4, dtype=np.int8)
        queries = np.full((B, qb), 4, dtype=np.int8)
        q_lens = np.zeros(B, dtype=np.int32)
        for row, i in enumerate(all_rows):
            ref_np, query_np, _, _, _ = row_data(i)
            refs[row, : len(ref_np)] = ref_np
            queries[row, : len(query_np)] = query_np
            q_lens[row] = len(query_np)

        max_seeds = initial_max_seeds(cfg, rb, qb)
        shift = resolve_sample_shift(cfg, rb, qb)
        m_out, c_out = transfer_slice(cfg, shift, max_seeds)
        step = make_sharded_packed_pair_step(
            mesh,
            k=cfg.k, max_seeds=max_seeds,
            unique_in_query=cfg.unique_in_query,
            min_match=cfg.min_match, band=cfg.band,
            max_gap=cfg.max_gap, max_clusters=cfg.max_clusters,
            sample_shift=shift, m_out=m_out, c_out=c_out,
        )
        _phase_barrier("pair-dispatch")
        shards = step(
            torch.from_numpy(refs), torch.from_numpy(queries), torch.from_numpy(q_lens)
        )
        # Only this process's rows come home.
        for shard in shards:
            device = mesh.devices[shard.slot]
            packed_local = shard.data.cpu().numpy()
            n_real = max(0, min(len(all_rows) - shard.row0, packed_local.shape[0]))
            engines.record_seedcluster(device, n_real)
            for r in range(n_real):
                i = all_rows[shard.row0 + r]
                _, n_runs, samp_over, m_compute, strands = unpack_seed_clusters(
                    packed_local[r], max_seeds, cfg.max_clusters
                )
                ref_np, query_np, rn, qn, fin_cfg = row_data(i)
                if samp_over or n_runs > m_compute or any(
                    s.truncated for s in strands
                ):
                    # overflow: local retry path (owner's host)
                    local_results[i] = align_pair(
                        ref_np, query_np, rn, qn, fin_cfg, device_cache, device
                    )
                    continue
                chains = _chains_of_strands(
                    strands, fin_cfg, effective_break(fin_cfg, shift)
                )
                local_results[i] = _finish_pair(
                    chains, ref_np, query_np, rn, qn, fin_cfg, device
                )

    # Exchange finished entries (row idx -> entries) over the host group,
    # in the versioned flat-array framing of `parallel.wire`, not pickle.
    n_total = len(jobs) + len(sub_enc)
    results: list = [None] * n_total
    if dist.is_active():
        blob = encode_results(local_results)
        METRICS.add("exchange.blob_bytes", 0.0, items=len(blob))
        for other in _exchange_blobs(blob):
            for i, entries in decode_results(other).items():
                results[i] = entries
    else:
        for i, entries in local_results.items():
            results[i] = entries

    # Assemble long jobs from their sub-rows — every process holds every
    # piece after the exchange, so assembly is replicated and deterministic.
    assemble_device = mesh.local_devices[0]
    for idx, (wmeta, base, n_sub) in win_meta.items():
        pieces = results[base : base + n_sub]
        missing_sub = [base + t for t, p in enumerate(pieces) if p is None]
        if missing_sub:
            # RuntimeError, not assert: this cross-process completeness
            # check must survive python -O.
            raise RuntimeError(
                f"window sub-jobs never finished on any host: {missing_sub[:5]}"
            )
        ref_np, query_np, rn, qn = enc[idx]
        results[idx] = assemble_windowed(
            pieces, wmeta, ref_np, query_np, rn, qn, cfg, device=assemble_device
        )
    missing = [i for i, r in enumerate(results[: len(jobs)]) if r is None]
    if missing:
        raise RuntimeError(
            f"pair jobs never finished on any host: {missing[:5]}"
        )

    out: list[list[DeltaEntry]] = [[] for _ in genome_pairs]
    for t, entries in zip(owners, results[: len(jobs)]):
        out[t].extend(entries)
    return out


def align_fastas_sharded(
    fasta_paths: list[str],
    out_maf: str,
    cfg=None,
    mesh: Mesh | None = None,
    devices=None,
    tmp_dir: str | None = None,
):
    """Multi-device end-to-end alignment with collectives as the data plane.

    The whole pairwise phase runs as one sharded batch (each process
    finishes only its own rows, then finished entries are exchanged).
    The tree-merge phase is distributed too when a shared ``tmp_dir`` is
    given and more than one process is running: every pair's deltas are
    published to the store by their owner, then the concurrent executor
    assigns each merge node to one deterministic owner (others block on
    the node artifact) — the reference distributed merge tasks across the
    cluster the same way (lib/base/job_processor.ml:247-285).
    Single-process runs merge locally with the sequential Aligner.

    ``devices`` are this process's mesh slots (``None``: this rank's CUDA
    device, which raises without a card); the guide tree and the merges
    run on the first.
    """
    with fail_fast_contract("align_fastas_sharded"):
        return _align_fastas_sharded(
            fasta_paths, out_maf, cfg, mesh, devices, tmp_dir
        )


def _align_fastas_sharded(fasta_paths, out_maf, cfg, mesh, devices, tmp_dir):
    cfg = cfg or PipelineConfig()
    genomes = [load_genome(p) for p in fasta_paths]
    if mesh is None:
        # Forming the mesh gathers every rank's slots: guard it as a phase.
        _phase_barrier("mesh")
        mesh = make_mesh(n_kdim=1, devices=devices)
    device = mesh.local_devices[0]
    planner = Aligner(genomes, cfg, device=device)
    tree = planner.job_tree()
    by_name = {g.name: g for g in genomes}
    pairs = tree_pairs(tree)
    deltas = sharded_genome_pair_deltas(
        [(by_name[a], by_name[b]) for a, b in pairs], cfg.align, mesh
    )
    n_proc = dist.process_count()
    if tmp_dir and n_proc > 1:
        # Distributed merge phase: publish pair artifacts (owners only,
        # all processes hold all entries after the exchange), then run the
        # executor with node-level ownership over the shared store.
        store = ArtifactStore(tmp_dir)
        ownership = PairOwnership(dist.process_index(), n_proc)
        for (a, b), entries in zip(pairs, deltas):
            if ownership.owns(a, b) and not store.has_pair(a, b):
                store.save_pair(a, b, entries)
        ex = JobExecutor(
            genomes, cfg, store=store, ownership=ownership, device=device,
        )
        blocks = finalize_blocks(ex.execute(tree))
    else:
        pool: list[DeltaEntry] = [e for entries in deltas for e in entries]
        runner = Aligner(genomes, cfg, delta_pool=pool, device=device)
        # finalize here too: labels + SP scores must not depend on which
        # merge plane (in-process vs store-backed) produced the blocks.
        blocks = finalize_blocks(runner.run())
    if out_maf:
        write_maf(out_maf, blocks, header=MAF_HEADER)
    return blocks
