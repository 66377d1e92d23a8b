"""paramugsy_tpu_torch.ops.align_pair against paramugsy_tpu.ops.align_pair.

The same numpy inputs go through both packages on the CPU; the DeltaEntry
lists must be equal.  The reference on the CPU aligns long segments on
the native banded engine; the port is driven through its wavefront
engine (plain K1 + K2) there, so the two engines meet in one comparison.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paramugsy_tpu.ops.align_pair as ref_ap
from bench import build_pair
from paramugsy_tpu.ops import engines as ref_engines
from paramugsy_tpu_torch import convert
from paramugsy_tpu_torch.ops import align_pair as port_ap
from paramugsy_tpu_torch.ops import engines as port_engines

torch.set_num_threads(1)
N = 200_000


def _key(entries):
    return [
        (e.ref_name, e.query_name, e.ref_len, e.query_len, e.ref_range,
         e.query_range, e.ref_gaps, e.query_gaps)
        for e in entries
    ]


def _both(ref, q, cfg, **kw):
    want = ref_ap.align_pair(ref, q, "r.c", "q.c", cfg)
    got = port_ap.align_pair(
        ref, q, "r.c", "q.c", convert.align_config(cfg), device="cpu", **kw
    )
    return want, got


def _island_pair(seed: int, n: int, n_islands: int = 4, length: int = 5000):
    rng = np.random.default_rng(seed)
    ref, q = build_pair(rng, n)
    q = q.copy()
    for s in np.linspace(n // 10, n - n // 10, n_islands).astype(int):
        q[s : s + length] = rng.integers(0, 4, length)
    return ref, q


@pytest.mark.parametrize("post_filter", [None, "one_to_one", "colinear"])
def test_bench_pair_equals_reference(post_filter):
    ref, q = build_pair(np.random.default_rng(12345), N)
    port_engines.reset_counts()
    want, got = _both(ref, q, ref_ap.AlignConfig(post_filter=post_filter))
    assert want and _key(got) == _key(want)
    assert port_engines.COUNTS["seedcluster-cpu"] == 1


def test_island_pair_wavefront_meets_native_banded(monkeypatch):
    ref, q = _island_pair(7, 60_000, n_islands=2)
    cfg = ref_ap.AlignConfig(break_len=8192)
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "0")
    ref_engines.reset_counts()
    want = ref_ap.align_pair(ref, q, "r.c", "q.c", cfg)
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "1")
    port_engines.reset_counts()
    got = port_ap.align_pair(ref, q, "r.c", "q.c", convert.align_config(cfg), device="cpu")
    assert _key(got) == _key(want)
    assert ref_engines.COUNTS["native-banded"] == 2
    assert port_engines.COUNTS["device-wavefront"] == 2
    assert "native-banded" not in port_engines.COUNTS


def test_device_dp_knob_keeps_cuda_long_segments_on_the_kernels(monkeypatch):
    """On CUDA long segments always take the wavefront kernels: =0 raises
    instead of moving them to the host.  On the CPU the knob picks."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("PARAMUGSY_DEVICE_DP", raising=False)
    assert port_engines.device_dp_enabled(cuda)
    assert not port_engines.device_dp_enabled(cpu)
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "1")
    assert port_engines.device_dp_enabled(cuda) and port_engines.device_dp_enabled(cpu)
    monkeypatch.setenv("PARAMUGSY_DEVICE_DP", "0")
    assert not port_engines.device_dp_enabled(cpu)
    with pytest.raises(ValueError, match="PARAMUGSY_DEVICE_DP=0"):
        port_engines.device_dp_enabled(cuda)


def test_island_pair_host_banded_by_default_on_cpu(monkeypatch):
    monkeypatch.delenv("PARAMUGSY_DEVICE_DP", raising=False)
    ref, q = _island_pair(9, 60_000, n_islands=2)
    port_engines.reset_counts()
    want, got = _both(ref, q, ref_ap.AlignConfig(break_len=8192))
    assert _key(got) == _key(want)
    assert port_engines.COUNTS["native-banded"] == 2


def test_tiny_seed_bucket_retry_equals_reference():
    """The overflow ladder doubles the seed bucket to the same result
    (tests/test_ops.py::TestSeedOverflowRetry)."""
    rng = np.random.default_rng(8)
    n = 50000
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    q = ref.copy()
    m = rng.random(n) < 0.02
    q[m] = ((q[m] + 1) % 4).astype(np.int8)
    port_engines.reset_counts()
    want, got = _both(ref, q, ref_ap.AlignConfig(max_seeds=1 << 8))
    assert _key(got) == _key(want)
    assert port_engines.COUNTS["seedcluster-cpu"] > 1
    want, got = _both(ref, q, ref_ap.AlignConfig(max_seeds=1 << 6, max_seeds_cap=1 << 7))
    assert got and _key(got) == _key(want)


def test_sample_overflow_redo_and_slice_refetch_equal_reference(monkeypatch):
    # A tiled query overflows the sampled match slice: redo unsampled.
    ref = np.random.default_rng(3).integers(0, 4, 3000).astype(np.int8)
    want, got = _both(ref, np.tile(ref, 20), ref_ap.AlignConfig(seed_sample_shift=2))
    assert _key(got) == _key(want)
    # A too-small output slice refetches full-size.
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, size=60_000).astype(np.int8)
    q = ref.copy()
    m = rng.random(len(q)) < 0.01
    q[m] = ((q[m] + 1) % 4).astype(np.int8)
    cfg = ref_ap.AlignConfig(seed_sample_shift=2, seed_merge_gap=4)
    monkeypatch.setattr(ref_ap, "transfer_slice", lambda *a: (16, 8))
    monkeypatch.setattr(port_ap, "transfer_slice", lambda *a: (16, 8))
    want, got = _both(ref, q, cfg)
    assert want and _key(got) == _key(want)


def test_device_cache_converted_from_reference():
    ref, q = build_pair(np.random.default_rng(1), 30_000)
    ref_cache: dict = {}
    want = ref_ap.align_pair(ref, q, "r.c", "q.c", ref_ap.AlignConfig(), ref_cache)
    cache = convert.device_cache(ref_cache, "cpu")
    assert sorted(cache) == sorted(ref_cache)
    got = port_ap.align_pair(ref, q, "r.c", "q.c", port_ap.AlignConfig(), cache, "cpu")
    assert _key(got) == _key(want)
    assert cache[("r.c", len(ref))].dtype == torch.int8


def test_config_conversion_and_windowed_path_equals_reference():
    """A converted config with a shrunk window takes the windowed path in
    both packages (3 x 3 window pairs) and gives the same entries."""
    cfg = ref_ap.AlignConfig(
        break_len=777, post_filter="colinear", window=1 << 14, window_overlap=1 << 12
    )
    port_cfg = convert.align_config(cfg)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(port_ap.AlignConfig()) == dataclasses.asdict(ref_ap.AlignConfig())
    ref, q = build_pair(np.random.default_rng(6), 30_000)
    port_engines.reset_counts()
    want, got = _both(ref, q, cfg)
    assert want and _key(got) == _key(want)
    assert port_engines.COUNTS["seedcluster-cpu"] == 9
