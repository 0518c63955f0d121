"""The port's host hash layer against the JAX package's, on the CPU.

Mirrors tests/test_hash_backends.py on ``p1_tpu_torch.hashx``: FIPS 180-4
vectors and hashlib cross-checks of ``sha256_ref``, the port's own registry
(``cpu``, ``numpy``, lazily ``cuda`` and ``native``), the numpy backend's
lanes against ``p1_tpu.hashx.numpy_backend``'s, and earliest-hit search
parity over ``cpu``, ``numpy`` and ``native`` against the JAX package's
``cpu``.  Inputs come from a numpy seed; comparisons are exact.
"""

import hashlib
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from p1_tpu.hashx import get_backend as ref_get_backend
from p1_tpu.hashx import numpy_backend as ref_numpy
from p1_tpu_torch.core import BlockHeader, meets_target
from p1_tpu_torch.hashx import available_backends, get_backend, sha256_ref
from p1_tpu_torch.hashx.numpy_backend import lanes_below_target, sha256d_lanes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIPS_VECTORS = [
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
    ),
    (b"a" * 1_000_000, "cdc76e5c9914fb9281a1c7e284d73e67f1809a48a497200e046d39ccc7112cd0"),
]


class TestSha256Ref:
    @pytest.mark.parametrize("msg,hexdigest", FIPS_VECTORS)
    def test_fips_vectors(self, msg, hexdigest):
        assert sha256_ref.sha256(msg).hex() == hexdigest

    def test_random_lengths_match_hashlib(self):
        rng = np.random.default_rng(0)
        for n in [1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 200, 1000]:
            data = rng.bytes(n)
            assert sha256_ref.sha256(data) == hashlib.sha256(data).digest()
            assert sha256_ref.sha256d(data) == hashlib.sha256(hashlib.sha256(data).digest()).digest()

    def test_midstate_reconstructs_header_hash(self):
        rng = np.random.default_rng(1)
        header = BlockHeader(2, rng.bytes(32), rng.bytes(32), 123456, 20, 0)
        prefix = header.mining_prefix()
        midstate = sha256_ref.header_midstate(prefix)
        tail = sha256_ref.header_tail_words(prefix)
        nonce = 0xCAFEBABE
        chunk2 = struct.pack(">4I", *tail, nonce) + sha256_ref.padding(80)[0:48]
        state1 = sha256_ref.compress(midstate, chunk2)
        assert struct.pack(">8I", *state1) == hashlib.sha256(header.with_nonce(nonce).serialize()).digest()


class TestRegistry:
    def test_known_backends_present(self):
        names = list(available_backends())
        assert {"cpu", "numpy", "cuda", "native"} <= set(names)
        assert len(names) == len(set(names))

    def test_get_backend_memoizes(self):
        assert get_backend("cpu") is get_backend("cpu")
        assert get_backend("numpy") is get_backend("numpy")

    def test_unknown_backend_raises(self):
        with pytest.raises(KeyError):
            get_backend("definitely-not-a-backend")

    @pytest.mark.parametrize("name", ["cpu", "numpy", "native"])
    def test_host_backends_refuse_the_card(self, name):
        with pytest.raises(ValueError, match="host only"):
            get_backend(name, device="cuda")

    def test_lazy_resolve_in_fresh_process(self):
        # The lazy loader (not a direct import) registers ``native``, and
        # nothing of the JAX package is imported on the way.
        code = (
            "import sys\n"
            "from p1_tpu_torch.hashx import available_backends, get_backend\n"
            "get_backend('native')\n"
            "names = list(available_backends())\n"
            "assert names.count('native') == 1, names\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'p1_tpu')]\n"
            "print('resolved')\n"
        )
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "resolved" in out.stdout

    def test_direct_import_does_not_double_list(self):
        import p1_tpu_torch.hashx.native_backend  # noqa: F401

        names = list(available_backends())
        assert names.count("native") == 1
        assert len(names) == len(set(names))


def _random_prefix(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return BlockHeader(1, rng.bytes(32), rng.bytes(32), 1735689700, 8, 0).mining_prefix()


class TestNumpyLanes:
    def test_lanes_match_reference_digests(self):
        prefix = _random_prefix(2)
        midstate = np.array(sha256_ref.header_midstate(prefix), dtype=np.uint32)
        tail = np.array(sha256_ref.header_tail_words(prefix), dtype=np.uint32)
        nonces = np.array([0, 1, 12345, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)
        words = sha256d_lanes(midstate, tail, nonces)
        ref_words = ref_numpy.sha256d_lanes(midstate, tail, nonces)
        for w, r in zip(words, ref_words):
            np.testing.assert_array_equal(w, r)
        for lane, nonce in enumerate(nonces):
            expect = sha256_ref.sha256d(prefix + struct.pack(">I", int(nonce)))
            assert struct.pack(">8I", *(int(w[lane]) for w in words)) == expect, f"lane {lane}"

    @pytest.mark.parametrize("difficulty", [4, 8, 12])
    def test_target_mask_matches_host_check(self, difficulty):
        prefix = _random_prefix(3)
        midstate = np.array(sha256_ref.header_midstate(prefix), dtype=np.uint32)
        tail = np.array(sha256_ref.header_tail_words(prefix), dtype=np.uint32)
        nonces = np.arange(4096, dtype=np.uint32)
        words = sha256d_lanes(midstate, tail, nonces)
        mask = lanes_below_target(words, difficulty)
        np.testing.assert_array_equal(mask, ref_numpy.lanes_below_target(words, difficulty))
        for lane in [*np.flatnonzero(mask)[:4], *np.flatnonzero(~mask)[:4]]:
            header80 = prefix + struct.pack(">I", int(nonces[lane]))
            assert meets_target(sha256_ref.sha256d(header80), difficulty) == bool(mask[lane])


SEARCH_BACKENDS = ["cpu", "numpy", "native"]


class TestSearchParity:
    """Every host backend agrees with the JAX package's on earliest hits."""

    @pytest.mark.parametrize("name", SEARCH_BACKENDS)
    def test_finds_known_hit(self, name):
        prefix = _random_prefix(4)
        truth = ref_get_backend("cpu").search(prefix, 0, 4096, 8)
        assert truth.nonce is not None
        got = get_backend(name).search(prefix, 0, 4096, 8)
        assert (got.nonce, got.hashes_done) == (truth.nonce, truth.hashes_done)

    @pytest.mark.parametrize("name", SEARCH_BACKENDS)
    def test_no_hit_returns_none(self, name):
        res = get_backend(name).search(_random_prefix(5), 0, 64, 255)
        assert res.nonce is None
        assert res.hashes_done == 64

    @pytest.mark.parametrize("name", SEARCH_BACKENDS)
    def test_respects_nonce_start(self, name):
        prefix = _random_prefix(6)
        truth = ref_get_backend("cpu").search(prefix, 0, 1 << 14, 10)
        assert truth.nonce is not None
        later = get_backend(name).search(prefix, truth.nonce + 1, 1 << 14, 10)
        want = ref_get_backend("cpu").search(prefix, truth.nonce + 1, 1 << 14, 10)
        assert later.nonce == want.nonce and (later.nonce is None or later.nonce > truth.nonce)

    @pytest.mark.parametrize("name", SEARCH_BACKENDS)
    def test_search_hit_meets_target(self, name):
        prefix = _random_prefix(7)
        res = get_backend(name).search(prefix, 0, 1 << 14, 10)
        if res.nonce is not None:
            assert meets_target(sha256_ref.sha256d(prefix + struct.pack(">I", res.nonce)), 10)

    @pytest.mark.parametrize("name", SEARCH_BACKENDS)
    def test_arg_validation(self, name):
        backend = get_backend(name)
        with pytest.raises(ValueError):
            backend.search(b"x" * 75, 0, 10, 8)
        with pytest.raises(ValueError):
            backend.search(b"x" * 76, 0xFFFFFFFF, 2, 8)

    @pytest.mark.parametrize("name", SEARCH_BACKENDS)
    def test_sha256d(self, name):
        data = np.random.default_rng(8).bytes(80)
        assert get_backend(name).sha256d(data) == hashlib.sha256(hashlib.sha256(data).digest()).digest()
