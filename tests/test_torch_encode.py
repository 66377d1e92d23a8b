"""paramugsy_tpu_torch.ops.encode against paramugsy_tpu.ops.encode.

Integer code: arrays must be bit-identical (the reference's uint32 k-mer
codes compare as int64 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paramugsy_tpu.ops import encode as ref_encode
from paramugsy_tpu_torch.ops import encode as port_encode

torch.set_num_threads(1)


def _codes_with_n_runs(seed: int, n: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[100:130] = 4
    codes[1000:1001] = 4
    codes[n - 7 :] = 4
    return codes


@pytest.mark.parametrize("k", range(1, 17))
def test_kmer_codes_and_canonical_equal_reference(k):
    codes = _codes_with_n_runs(k)
    want = ref_encode.kmer_codes(jnp.asarray(codes), k)
    got = port_encode.kmer_codes(torch.from_numpy(codes), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())
    want = ref_encode.kmer_canonical(jnp.asarray(codes), k)
    got = port_encode.kmer_canonical(torch.from_numpy(codes), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())


def test_host_helpers_equal_reference():
    text = "ACGTNacgtnRYK" * 50
    np.testing.assert_array_equal(port_encode.encode(text), ref_encode.encode(text))
    codes = ref_encode.encode(text)
    np.testing.assert_array_equal(
        port_encode.revcomp_codes_np(codes), ref_encode.revcomp_codes_np(codes)
    )
    for n in (0, 1, 4096, 4097, 70000):
        assert port_encode.bucket_size(n) == ref_encode.bucket_size(n)
    up = port_encode.upload_codes(codes, torch.device("cpu"))
    assert up.dtype == torch.int8
    np.testing.assert_array_equal(
        up.numpy(), ref_encode.pad_to(codes, ref_encode.bucket_size(len(codes)))
    )


def test_kmer_k_out_of_range_raises():
    with pytest.raises(ValueError):
        port_encode.kmer_codes(torch.zeros(8, dtype=torch.int8), 17)
    with pytest.raises(ValueError):
        port_encode.kmer_canonical(torch.zeros(8, dtype=torch.int8), 0)
