"""The port's plain PyTorch SHA-256d search vs the JAX package.

Mirrors ``tests/test_jax_backend.py::TestJaxSha256``: the same inputs, made
from a numpy seed, go through ``p1_tpu.hashx.jax_sha256`` (unroll=1 on the
CPU), ``p1_tpu.hashx.numpy_backend.sha256d_lanes`` and
``p1_tpu_torch.hashx.torch_sha256``.  The math is integer, so the tolerance
is exact: every digest word of every lane and every step offset is equal.
"""

import struct

import numpy as np
import pytest
import torch

from p1_tpu.core import BlockHeader, target_from_difficulty, target_to_words
from p1_tpu.hashx import get_backend, numpy_backend, sha256_ref
from p1_tpu_torch.hashx import torch_sha256
from p1_tpu_torch.hashx.torch_backend import search_arrays

jax = pytest.importorskip("jax")
jnp = jax.numpy

from p1_tpu.hashx import jax_sha256  # noqa: E402

BATCH = 4096
_digest_jit = jax.jit(lambda m, t, n: jax_sha256.sha256d_words(m, t, n, unroll=1))


def _prefix(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return BlockHeader(
        1, rng.bytes(32), rng.bytes(32), 1735689700, 8, 0
    ).mining_prefix()


def _words(prefix: bytes, difficulty: int):
    """The three numpy uint32 arrays both packages are fed from."""
    return (
        np.array(sha256_ref.header_midstate(prefix), dtype=np.uint32),
        np.array(sha256_ref.header_tail_words(prefix), dtype=np.uint32),
        np.array(target_to_words(target_from_difficulty(difficulty)), dtype=np.uint32),
    )


def _torch_digest(mid, tail, nonces: np.ndarray) -> np.ndarray:
    arrays = search_arrays(mid, tail, np.zeros(8, np.uint32), "cpu")
    words = torch_sha256.sha256d_words(
        arrays.midstate, arrays.tail, torch.from_numpy(nonces.astype(np.int64))
    )
    return np.stack([w.numpy() for w in words]).astype(np.uint32)


class TestTorchSha256:
    @pytest.mark.parametrize("seed", [10, 11])
    def test_digest_words_match_jax_and_numpy(self, seed):
        mid, tail, _ = _words(_prefix(seed), 8)
        nonces = np.random.default_rng(seed).integers(0, 1 << 32, BATCH, dtype=np.uint64).astype(np.uint32)
        nonces[:3] = [0, 1, 0xFFFFFFFF]
        got = _torch_digest(mid, tail, nonces)
        want_jax = np.stack([np.asarray(w) for w in _digest_jit(mid, tail, nonces)])
        want_np = np.stack(numpy_backend.sha256d_lanes(mid, tail, nonces))
        np.testing.assert_array_equal(got, want_jax)
        np.testing.assert_array_equal(got, want_np)

    def test_digest_words_match_reference_bytes(self):
        prefix = _prefix(12)
        mid, tail, _ = _words(prefix, 8)
        nonces = np.array([0, 1, 99999, 0xFFFFFFFF], dtype=np.uint32)
        got = _torch_digest(mid, tail, nonces)
        for lane, nonce in enumerate(nonces):
            expect = sha256_ref.sha256d(prefix + struct.pack(">I", int(nonce)))
            assert struct.pack(">8I", *(int(w) for w in got[:, lane])) == expect

    @pytest.mark.parametrize(
        "seed,difficulty,base",
        [
            (13, 8, 0),  # earliest hit
            (14, 10, 0x1000),
            (15, 0, 0),  # every lane hits: the tie-break picks lane 0
            (16, 255, 0),  # miss -> batch
            (17, 8, 0xFFFFFFFF - 2000),  # nonce_base wraps past 2**32
        ],
    )
    def test_search_step_matches_jax(self, seed, difficulty, base):
        prefix = _prefix(seed)
        mid, tail, target = _words(prefix, difficulty)
        arrays = search_arrays(mid, tail, target, "cpu")
        got = int(torch_sha256.search_step(arrays.midstate, arrays.tail, arrays.target, base, BATCH))
        step = jax_sha256.jit_search_step(BATCH)
        want = int(step(jnp.asarray(mid), jnp.asarray(tail), jnp.asarray(target), jnp.uint32(base)))
        assert got == want
        if base + BATCH <= 1 << 32:
            truth = get_backend("cpu").search(prefix, base, BATCH, difficulty)
            assert got == (BATCH if truth.nonce is None else truth.nonce - base)

    def test_below_target_is_unsigned(self):
        # Words >= 2**31 are negative as int32: the compare must still order
        # them as uint32 (0xFFFFFFFF is the LARGEST word, not -1).
        digest = [torch.tensor([0x7FFFFFFF, 0xFFFFFFFF, 0x80000000], dtype=torch.int64)]
        digest += [torch.zeros(3, dtype=torch.int64)] * 7
        target = torch.tensor([0x80000000] + [0] * 7, dtype=torch.int64)
        hits = torch_sha256.below_target(digest, target)
        assert hits.tolist() == [True, False, False]

    def test_first_hit_index_miss_is_batch(self):
        hits = torch.zeros(64, dtype=torch.bool)
        assert int(torch_sha256.first_hit_index(hits, 64)) == 64
        hits[[5, 9]] = True
        assert int(torch_sha256.first_hit_index(hits, 64)) == 5
