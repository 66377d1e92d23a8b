"""Artifact store: per-node checkpointing + resume + multi-host exchange.

The reference writes every tree node's intermediates into its own numbered
``tmp_dir/<node>/`` directory but has **no resume logic** (SURVEY aux #4);
cross-machine data moves by rsync manifests over a shared filesystem.
This store keeps that inspectable layout and adds what was missing:

* deterministic keys (pair names / subtree genome sets), so a re-run
  reuses every completed pairwise alignment and merge;
* atomic completion markers (write tmp + rename), so partially written
  artifacts are never trusted;
* ``wait()`` polling, which doubles as the multi-host exchange: hosts
  share the store through the filesystem, each computes its owned share,
  and readers block on the ``done`` marker (the reference's 10 s
  queue_server poll, reborn).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterable

from paramugsy_tpu_torch.formats.delta import DeltaEntry, DeltaWriter, read_delta
from paramugsy_tpu_torch.formats.maf import MAF_HEADER, MafBlock, read_maf, write_maf


class _Heartbeat:
    """Touches registered claim files every ``interval`` seconds.

    Lets waiters distinguish a slow-but-alive owner (claim mtime fresh)
    from a dead one (claim stale/missing), so failover never duplicates a
    large pair's compute just because it takes longer than the failover
    window.
    """

    def __init__(self, interval: float = 5.0):
        self.interval = interval
        self._paths: set[str] = set()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def add(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(str(os.getpid()))
        with self._lock:
            self._paths.add(path)
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="artifact-heartbeat", daemon=True
                )
                self._thread.start()

    def remove(self, path: str) -> None:
        with self._lock:
            self._paths.discard(path)
        with contextlib.suppress(OSError):
            os.unlink(path)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            with self._lock:
                paths = list(self._paths)
                if not paths:
                    return  # thread exits; restarted on next add()
            for p in paths:
                with contextlib.suppress(OSError):
                    os.utime(p)


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "pairs"), exist_ok=True)
        os.makedirs(os.path.join(root, "nodes"), exist_ok=True)
        self._heartbeat = _Heartbeat()

    # -- keys ----------------------------------------------------------
    @staticmethod
    def pair_key(a: str, b: str) -> str:
        return f"{a}~{b}"

    @staticmethod
    def node_key(genomes: Iterable[str]) -> str:
        return "+".join(genomes)

    # -- paths ---------------------------------------------------------
    def _pair_path(self, key: str) -> str:
        return os.path.join(self.root, "pairs", key + ".delta")

    def _node_path(self, key: str) -> str:
        return os.path.join(self.root, "nodes", key + ".maf")

    # -- pairwise deltas ------------------------------------------------
    def has_pair(self, a: str, b: str) -> bool:
        return os.path.exists(self._pair_path(self.pair_key(a, b)))

    @staticmethod
    def _tmp_name(path: str) -> str:
        # Unique per writer: two hosts/threads may legitimately produce the
        # same artifact concurrently (e.g. every host computes every merge
        # node); sharing one tmp path would make the loser's os.replace
        # raise FileNotFoundError after the winner renamed it away.
        import threading

        return f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"

    def save_pair(self, a: str, b: str, entries: list[DeltaEntry]) -> None:
        path = self._pair_path(self.pair_key(a, b))
        tmp = self._tmp_name(path)
        with open(tmp, "w") as f:
            w = DeltaWriter(f, a, b)
            for e in entries:
                w.write(e)
        os.replace(tmp, path)  # atomic completion marker

    def load_pair(self, a: str, b: str) -> list[DeltaEntry]:
        return list(read_delta(self._pair_path(self.pair_key(a, b))))

    @contextlib.contextmanager
    def _claim(self, artifact_path: str):
        """Advertise live ownership of an artifact while computing it.

        Creates a ``.claim`` heartbeat file next to the (future) artifact,
        refreshed every few seconds by a daemon thread; waiters treat a
        fresh claim as proof of life and keep waiting instead of firing
        failover on a merely-slow owner (ADVICE r2: a fixed 300 s failover
        made every non-owner recompute any pair slower than 5 min).
        """
        path = artifact_path + ".claim"
        self._heartbeat.add(path)
        try:
            yield
        finally:
            self._heartbeat.remove(path)

    def claim_pair(self, a: str, b: str):
        return self._claim(self._pair_path(self.pair_key(a, b)))

    def claim_node(self, genomes: Iterable[str]):
        return self._claim(self._node_path(self.node_key(genomes)))

    @staticmethod
    def _claim_age(artifact_path: str) -> float | None:
        """Seconds since the owner's claim heartbeat, or None if unclaimed."""
        try:
            return max(0.0, time.time() - os.stat(artifact_path + ".claim").st_mtime)
        except OSError:
            return None

    def _wait_artifact(
        self,
        path: str,
        load,
        save,
        what: str,
        timeout: float,
        poll: float,
        failover,
        failover_after: float,
        claim_stale: float,
    ):
        """Generic publish-wait with claim-aware failover (see wait_pair)."""
        deadline = time.time() + timeout
        fail_at = (time.time() + failover_after) if failover is not None else None
        while not os.path.exists(path):
            if fail_at is not None and time.time() > fail_at:
                age = self._claim_age(path)
                if age is not None and age < claim_stale:
                    fail_at = time.time() + claim_stale  # owner alive: re-check
                else:
                    import logging

                    logging.getLogger("paramugsy.artifacts").warning(
                        "owner silent for %.0fs (claim %s); re-owning %s",
                        failover_after,
                        "missing" if age is None else f"stale {age:.0f}s",
                        what,
                    )
                    result = failover()
                    save(result)
                    return result
            if time.time() > deadline:
                raise TimeoutError(f"timed out waiting for artifact {path}")
            time.sleep(poll)
        return load()

    def wait_pair(
        self,
        a: str,
        b: str,
        timeout: float = 3600,
        poll: float = 0.2,
        failover=None,
        failover_after: float = 300.0,
        claim_stale: float = 30.0,
    ):
        """Block until another host publishes this pair's artifact.

        With a ``failover`` callback, a pair whose owner stays silent for
        ``failover_after`` seconds is RE-OWNED: this host computes it,
        publishes the result, and continues (the reference only retried
        locally, local_interface.ml:8-35 — a dead owner stalled the run).
        An owner holding a *fresh* claim heartbeat (see `claim_pair`) is
        alive regardless of elapsed time, so slow pairs never fail over;
        a claim older than ``claim_stale`` counts as dead.  Duplicate
        publication is benign: writers use unique tmp names and an atomic
        rename, so the winner's artifact is always complete.
        """
        return self._wait_artifact(
            self._pair_path(self.pair_key(a, b)),
            load=lambda: self.load_pair(a, b),
            save=lambda entries: self.save_pair(a, b, entries),
            what=f"pair {a}~{b}",
            timeout=timeout, poll=poll,
            failover=failover, failover_after=failover_after,
            claim_stale=claim_stale,
        )

    # -- node (merge) outputs -------------------------------------------
    def has_node(self, genomes: Iterable[str]) -> bool:
        return os.path.exists(self._node_path(self.node_key(genomes)))

    def save_node(self, genomes: Iterable[str], blocks: list[MafBlock]) -> None:
        path = self._node_path(self.node_key(genomes))
        tmp = self._tmp_name(path)
        write_maf(tmp, blocks, header=MAF_HEADER)
        os.replace(tmp, path)

    def load_node(self, genomes: Iterable[str]) -> list[MafBlock]:
        return list(read_maf(self._node_path(self.node_key(genomes))))

    def wait_node(
        self,
        genomes: Iterable[str],
        timeout: float = 3600,
        poll: float = 0.2,
        failover=None,
        failover_after: float = 300.0,
        claim_stale: float = 30.0,
    ) -> list[MafBlock]:
        """Block until the owning host publishes this merge node's MAF.

        Same claim-aware failover semantics as `wait_pair`; this is what
        distributes the tree-merge phase across hosts (the reference
        distributed merge *tasks* over the cluster too,
        lib/base/job_processor.ml:247-285)."""
        genomes = list(genomes)
        return self._wait_artifact(
            self._node_path(self.node_key(genomes)),
            load=lambda: self.load_node(genomes),
            save=lambda blocks: self.save_node(genomes, blocks),
            what=f"node {self.node_key(genomes)}",
            timeout=timeout, poll=poll,
            failover=failover, failover_after=failover_after,
            claim_stale=claim_stale,
        )


class PairOwnership:
    """Deterministic work -> process assignment for multi-host runs.

    Every host enumerates the same global pair list and job tree; a
    stable hash picks one owner per pair and per merge node (the
    reference's qsub job placement, made deterministic).  Non-owners wait
    on the shared store.
    """

    def __init__(self, process_index: int = 0, process_count: int = 1):
        self.process_index = process_index
        self.process_count = process_count

    def _owner_of(self, key: str) -> int:
        import zlib  # stable digest (hash() is salted per process)

        return zlib.crc32(key.encode()) % self.process_count

    def owns(self, a: str, b: str) -> bool:
        if self.process_count <= 1:
            return True
        return self._owner_of(f"{a}~{b}") == self.process_index

    def owns_node(self, genomes: Iterable[str]) -> bool:
        """Merge-node ownership (tree merges are distributed too)."""
        if self.process_count <= 1:
            return True
        return self._owner_of("+".join(genomes)) == self.process_index
