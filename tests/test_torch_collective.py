"""The port's sharded data plane across real processes: ranks of one
torch.distributed world (gloo on the CPU) that each run
``align_fastas_sharded`` on four ``cpu`` slots, as tests/test_dist.py runs
the reference's two jax.distributed processes of four host devices.

Both ranks' MAFs must be byte-identical and equal to the reference's for
the same number of processes: one process (no world, or a world of one
rank) against the reference's one-process run, and two ranks sharing a
``tmp_dir`` against the reference's own two-process run
(tests/dist_worker.py's ``e2e`` mode, unchanged).  A rank that dies or
stalls before a collective phase ends the survivor with DeadHostError
within ``PARAMUGSY_BARRIER_TIMEOUT``, never a hang; a world asked to form
on CUDA without a card raises and forms nothing.  Each process has its
own timeout, so a hang fails its test instead of the suite.
"""
import os
import subprocess
import sys
import time

import jax
import pytest
import torch

import chip_smoke
from paramugsy_tpu.parallel import collective as ref_collective
from paramugsy_tpu.parallel import mesh as ref_mesh
from paramugsy_tpu_torch.parallel import collective
from tests.test_dist import WORKER as REF_WORKER
from tests.test_dist import _clean_env, _write_genomes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORLD_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "PARAMUGSY_BARRIER_TIMEOUT")

# One rank: joins the world of its environment on the CPU, then runs
# align_fastas_sharded on four cpu slots over g0..g3.fa of the work
# directory.  Modes: plain, store (a shared tmp_dir), die (rank 1 exits
# hard after joining), stall (rank 1 sleeps after joining).
_RANK = r"""
import os, sys, time
mode, work, out = sys.argv[1:4]
import torch
torch.set_num_threads(1)
from paramugsy_tpu_torch.runtime import dist
from paramugsy_tpu_torch.parallel.collective import DeadHostError, align_fastas_sharded
ctx = dist.init_distributed(device="cpu")
if ctx.process_index == 1 and mode == "die":
    os._exit(3)  # a dead host runs no exit hooks
if ctx.process_index == 1 and mode == "stall":
    time.sleep(120)
    os._exit(4)
paths = [os.path.join(work, f"g{i}.fa") for i in range(4)]
store = os.path.join(work, "store") if mode == "store" else None
try:
    blocks = align_fastas_sharded(paths, out, devices=["cpu"] * 4, tmp_dir=store)
except DeadHostError as e:
    print(f"DEADHOST: {e}", flush=True)
    sys.exit(9)
assert "jax" not in sys.modules and "paramugsy_tpu" not in sys.modules
print(f"BLOCKS {len(blocks)}", flush=True)
dist.shutdown_distributed(ctx)
"""


@pytest.fixture(autouse=True)
def _no_world(monkeypatch):
    for name in _WORLD_ENV:
        monkeypatch.delenv(name, raising=False)


def _run_world(n_ranks: int, mode: str, work: str, timeout: float = 120,
               barrier_timeout: int = 30, wait_all: bool = True):
    """Start `n_ranks` rank processes (`_RANK`), rank i writing
    ``out<i>.maf``; returns [(returncode, output, seconds)] per rank.
    Ranks still running at the end are killed."""
    port = chip_smoke._free_port()
    procs = []
    for rank in range(n_ranks):
        env = {k: v for k, v in os.environ.items() if k not in _WORLD_ENV}
        env.update(
            PYTHONPATH=ROOT, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n_ranks),
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
            PARAMUGSY_BARRIER_TIMEOUT=str(barrier_timeout),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, mode, work, os.path.join(work, f"out{rank}.maf")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    t0 = time.perf_counter()
    results = []
    try:
        for p in procs if wait_all else procs[:1]:
            out = p.communicate(timeout=timeout)[0]
            results.append((p.returncode, out, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _ref_one_process(work: str) -> bytes:
    out = os.path.join(work, "ref.maf")
    ref_collective.align_fastas_sharded(
        [os.path.join(work, f"g{i}.fa") for i in range(4)], out,
        mesh=ref_mesh.make_mesh(n_pairs=8, n_kdim=1, devices=jax.devices("cpu")[:8]),
    )
    with open(out, "rb") as f:
        return f.read()


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _store_tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(dirpath, f), root)] = _read(os.path.join(dirpath, f))
    return out


@pytest.mark.parametrize("n_ranks", [1, 2], ids=["one_rank_world", "two_ranks"])
def test_ranks_without_store_equal_one_process_reference(tmp_path, n_ranks):
    """tests/test_dist.py's four 12 kb genomes without ``tmp_dir``: every
    rank merges the gathered deltas itself, so each writes the reference's
    one-process MAF (a world of one rank still gathers through its
    group)."""
    work = str(tmp_path)
    _write_genomes(work)
    want = _ref_one_process(work)
    for rc, out, _ in _run_world(n_ranks, "plain", work):
        assert rc == 0 and "BLOCKS" in out, out[-3000:]
    for rank in range(n_ranks):
        assert _read(os.path.join(work, f"out{rank}.maf")) == want
    assert want.count(b"\na ") >= 3


def test_two_ranks_with_store_equal_reference_two_processes(tmp_path):
    """The same genomes with a shared ``tmp_dir``: both ranks' MAFs are
    byte-identical, the owners published ``pairs/`` and ``nodes/``, and
    MAFs and store equal those of the reference's two processes
    (tests/dist_worker.py in its ``e2e`` mode)."""
    ref_work = str(tmp_path / "ref")
    work = str(tmp_path / "port")
    for d in (ref_work, work):
        os.makedirs(d)
        _write_genomes(d)
    port = chip_smoke._free_port()
    ref_procs = [
        subprocess.Popen(
            [sys.executable, REF_WORKER, str(i), str(port), "e2e", ref_work],
            cwd=ROOT, env=_clean_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    try:
        ref_outs = [p.communicate(timeout=300)[0] for p in ref_procs]
    finally:
        for p in ref_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(ref_procs, ref_outs):
        assert p.returncode == 0, out[-3000:]
    for rc, out, _ in _run_world(2, "store", work):
        assert rc == 0 and "BLOCKS" in out, out[-3000:]
    got = [_read(os.path.join(work, f"out{r}.maf")) for r in (0, 1)]
    assert got[0] == got[1] == _read(os.path.join(ref_work, "out0.maf"))
    store = _store_tree(os.path.join(work, "store"))
    assert any(k.startswith("pairs") for k in store)
    assert any(k.startswith("nodes") for k in store)
    assert store == _store_tree(os.path.join(ref_work, "store"))


def test_dead_peer_fails_fast_with_contract_error(tmp_path):
    """Rank 1 exits hard right after joining the world; rank 0 must end
    with DeadHostError (exit 9) well within PARAMUGSY_BARRIER_TIMEOUT=15,
    never hang in a gloo collective."""
    work = str(tmp_path)
    _write_genomes(work, n=4000)
    (rc0, out0, secs0), (rc1, out1, _) = _run_world(2, "die", work, barrier_timeout=15)
    assert rc1 == 3, out1[-2000:]
    assert rc0 == 9, out0[-3000:]
    assert "DEADHOST" in out0 and "fail-fast" in out0
    assert secs0 < 60


def test_stalled_peer_fails_at_the_barrier(tmp_path):
    """Rank 1 joins and then stalls: rank 0's liveness barrier gives up
    after PARAMUGSY_BARRIER_TIMEOUT=5 s with DeadHostError naming the
    barrier and the missing rank (rank 1 is killed afterwards)."""
    work = str(tmp_path)
    _write_genomes(work, n=4000)
    [(rc0, out0, secs0)] = _run_world(2, "stall", work, barrier_timeout=5, wait_all=False)
    assert rc0 == 9, out0[-3000:]
    assert "DEADHOST" in out0 and "stalled past 5s at the liveness barrier" in out0
    assert "Ranks 1 failed to pass monitoredBarrier" in out0  # the missing rank
    assert secs0 < 60


def test_cuda_world_without_a_card_raises(tmp_path, monkeypatch):
    """Asked to form on CUDA where there is no card, the world raises and
    forms nothing (no gloo or CPU fallback); without a device the sharded
    entry point raises the same way, not as a dead peer."""
    from paramugsy_tpu_torch.parallel import mesh
    from paramugsy_tpu_torch.runtime import dist

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(chip_smoke._free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.init_distributed(device="cuda")
    assert not torch.distributed.is_initialized()
    assert dist.host_group() is None
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    _write_genomes(str(tmp_path), n=2000)
    paths = [str(tmp_path / f"g{i}.fa") for i in range(4)]
    with pytest.raises(RuntimeError, match="CUDA") as err:
        collective.align_fastas_sharded(paths, str(tmp_path / "o.maf"))
    assert not isinstance(err.value, collective.DeadHostError)
