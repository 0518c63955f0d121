"""The port's ``cuda`` backend on the CPU vs the JAX package's ``tpu`` backend.

Mirrors ``tests/test_pallas_backend.py`` in full, and the opening-ramp
cases of ``tests/test_jax_backend.py``.  Here there is no card, so the
backend is built with ``device="cpu"`` and its steps run the plain PyTorch
version; the reference runs its Pallas kernel in interpret mode.  Offsets,
nonces and hash counts are integers: the tolerance is exact.
"""

import random

import numpy as np
import pytest
import torch

import p1_tpu.hashx as ref_hashx
from p1_tpu.core import BlockHeader as RefHeader
from p1_tpu.core import target_from_difficulty, target_to_words
from p1_tpu.hashx import sha256_ref
from p1_tpu_torch.core import BlockHeader, meets_target
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.hashx.backend import HashBackend
from p1_tpu_torch.hashx.torch_backend import PipelinedSearchMixin, search_arrays

jax = pytest.importorskip("jax")
jnp = jax.numpy
pytest.importorskip("jax.experimental.pallas")

from p1_tpu.hashx import jax_backend as ref_jax_backend  # noqa: E402
from p1_tpu.hashx.pallas_backend import jit_pallas_search_step  # noqa: E402

DIFF = 8
BATCH = 1 << 12  # small steps: the Pallas interpreter is slow


def _prefix(seed: int) -> bytes:
    rng = random.Random(seed)
    return BlockHeader(
        1, rng.randbytes(32), rng.randbytes(32), 1735689700, DIFF, 0
    ).mining_prefix()


@pytest.fixture(scope="module")
def cuda_backend():
    return get_backend("cuda", device="cpu", batch=BATCH, sub=8)


@pytest.fixture(scope="module")
def tpu_backend():
    be = ref_hashx.get_backend("tpu", batch=BATCH, sub=8)
    assert be.interpret
    return be


class TestCudaBackendParity:
    def test_registered_as_cuda(self, cuda_backend):
        assert cuda_backend.name == "cuda"
        assert cuda_backend.device.type == "cpu"

    @pytest.mark.parametrize(
        "seed,difficulty,base",
        [(20, 8, 0), (21, 0, 0x1000), (22, 10, 0xFFFFF000), (23, 255, 0)],
    )
    def test_raw_step_matches_interpreted_pallas(self, cuda_backend, seed, difficulty, base):
        prefix = _prefix(seed)
        mid = np.array(sha256_ref.header_midstate(prefix), dtype=np.uint32)
        tail = np.array(sha256_ref.header_tail_words(prefix), dtype=np.uint32)
        target = np.array(target_to_words(target_from_difficulty(difficulty)), dtype=np.uint32)
        got = cuda_backend._make_step(BATCH)(search_arrays(mid, tail, target, "cpu"), base)
        assert got.dtype == torch.int32 and got.shape == (1,)
        step = jit_pallas_search_step(BATCH, 8, interpret=True)
        want = step(jnp.asarray(mid), jnp.asarray(tail), jnp.asarray(target), jnp.uint32(base))
        assert int(got[0]) == int(want)

    @pytest.mark.parametrize("seed", [0, 7])
    def test_first_hit_matches_tpu_and_cpu(self, cuda_backend, tpu_backend, seed):
        prefix = _prefix(seed)
        got = cuda_backend.search(prefix, 0, BATCH, DIFF)
        want_tpu = tpu_backend.search(prefix, 0, BATCH, DIFF)
        want_cpu = ref_hashx.get_backend("cpu").search(prefix, 0, BATCH, DIFF)
        assert (got.nonce, got.hashes_done) == (want_tpu.nonce, want_tpu.hashes_done)
        assert (got.nonce, got.hashes_done) == (want_cpu.nonce, want_cpu.hashes_done)
        if got.nonce is not None:
            sealed = prefix + int(got.nonce).to_bytes(4, "big")
            assert meets_target(sha256_ref.sha256d(sealed), DIFF)

    def test_every_nonce_hits_at_difficulty_zero(self, cuda_backend):
        res = cuda_backend.search(_prefix(1), 0, BATCH, 0)
        assert res.nonce == 0 and res.hashes_done == 1

    def test_nonce_start_offset(self, cuda_backend):
        res = cuda_backend.search(_prefix(2), 0x1000, BATCH, 0)
        assert res.nonce == 0x1000

    def test_partial_final_step_masked(self, cuda_backend):
        # count smaller than the step batch: a hit reported beyond the valid
        # range must be discarded by the host-side mask.
        prefix = _prefix(3)
        full = ref_hashx.get_backend("cpu").search(prefix, 0, BATCH, DIFF)
        assert full.nonce is not None, "seed must produce a hit in the batch"
        assert cuda_backend.search(prefix, 0, full.nonce, DIFF).nonce is None
        exact = cuda_backend.search(prefix, 0, full.nonce + 1, DIFF)
        assert (exact.nonce, exact.hashes_done) == (full.nonce, full.hashes_done)

    def test_multi_step_scan_matches_cpu(self, cuda_backend):
        # Several pipelined steps, a partial last one, a nonzero start.
        prefix = _prefix(5)
        got = cuda_backend.search(prefix, 5000, 3 * BATCH + 123, 12)
        want = ref_hashx.get_backend("cpu").search(prefix, 5000, 3 * BATCH + 123, 12)
        assert (got.nonce, got.hashes_done) == (want.nonce, want.hashes_done)

    def test_batch_must_tile(self):
        with pytest.raises(ValueError, match="multiple"):
            get_backend("cuda", device="cpu", batch=1000, sub=8)

    def test_batch_int32_bound(self):
        with pytest.raises(ValueError, match="2\\*\\*31"):
            get_backend("cuda", device="cpu", batch=1 << 31, sub=8)

    def test_step_guards_match(self):
        from p1_tpu_torch.hashx.cuda_backend import cuda_search_fn

        with pytest.raises(ValueError, match="multiple"):
            cuda_search_fn(1000, 8, 128)
        with pytest.raises(ValueError, match="2\\*\\*31"):
            cuda_search_fn(1 << 31, 8, 128)

    def test_odd_tile_disables_ramp(self):
        # sub=20 -> tile 2560 doesn't divide the 2^22 ramp floor; the backend
        # must opt out of the opening ramp rather than crash.
        be = get_backend("cuda", device="cpu", batch=2560 * 4, sub=20)
        assert be.ramp_floor is None
        assert be.search(_prefix(4), 0, 2560, 0).nonce == 0

    def test_no_card_raises(self, monkeypatch):
        # Without device="cpu" the backend runs on the card or not at all.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_backend("cuda", batch=BATCH, sub=8)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_backend("cuda")

    def test_kernel_wrapper_refuses_cpu_cell(self):
        from p1_tpu_torch.hashx.cuda_backend import sha256d_search

        before = sha256d_search.launches
        with pytest.raises(ValueError, match="CUDA"):
            sha256d_search((0,) * 19, 0, BATCH, 8, 128, torch.zeros(1, dtype=torch.int32))
        assert sha256d_search.launches == before


class _PortSpy(PipelinedSearchMixin, HashBackend):
    """Records the span of every step instead of hashing (port mixin)."""

    def __init__(self, step_span, hit_offset=None):
        self.step_span = step_span
        self.device = torch.device("cpu")
        self.hit_offset = hit_offset
        self.spans = []

    def _make_step(self, span):
        self.spans.append(span)
        off = self.hit_offset
        value = off if off is not None and off < span else span
        return lambda arrays, base: torch.tensor([value], dtype=torch.int32)


class _RefSpy(ref_jax_backend.PipelinedSearchMixin, ref_hashx.HashBackend):
    """The same spy on the reference mixin."""

    def __init__(self, step_span, hit_offset=None):
        self.step_span = step_span
        self.hit_offset = hit_offset
        self.spans = []

    def _make_step(self, span):
        self.spans.append(span)
        off = self.hit_offset
        value = off if off is not None and off < span else span
        return lambda midstate, tail, target, base: jnp.uint32(value)


class TestOpeningRamp:
    """The port ramps exactly where the reference does: the same span
    sequence, the same result, for every scan shape."""

    @pytest.mark.parametrize(
        "step_span,count,difficulty,nonce_start,hit",
        [
            (1 << 27, 1 << 28, 20, 0, None),  # fresh easy scan ramps
            (1 << 27, 1 << 28, 20, 0, 1234),  # hit inside the opening step
            (1 << 27, 1 << 28, 255, 0, None),  # high difficulty: no ramp
            (1 << 27, 1 << 27, 20, 1 << 27, None),  # resumed range: no ramp
            ((1 << 22) // 2, 1 << 22, 20, 0, None),  # small backend never ramps
        ],
    )
    def test_span_sequence_matches_reference(self, step_span, count, difficulty, nonce_start, hit):
        prefix = RefHeader(1, bytes(32), bytes(32), 1735689700, 8, 0).mining_prefix()
        port, ref = _PortSpy(step_span, hit), _RefSpy(step_span, hit)
        got = port.search(prefix, nonce_start, count, difficulty)
        want = ref.search(prefix, nonce_start, count, difficulty)
        assert port.spans == ref.spans
        assert (got.nonce, got.hashes_done) == (want.nonce, want.hashes_done)

    def test_fresh_easy_scan_ramps_geometrically(self):
        from p1_tpu_torch.hashx.torch_backend import _RAMP_FACTOR, _RAMP_FLOOR

        spy = _PortSpy(1 << 27)
        spy.search(_prefix(0), 0, 1 << 28, 20)
        assert spy.spans[0] == _RAMP_FLOOR
        assert spy.spans[1] == _RAMP_FLOOR * _RAMP_FACTOR
        assert max(spy.spans) == 1 << 27
        assert spy.spans == sorted(spy.spans)
