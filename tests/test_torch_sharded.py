"""The port's sharded search (``p1_tpu_torch/hashx/sharded.py``) vs the JAX package.

Mirrors tests/test_sharded.py.  The port's mesh here is 8 slots on the
CPU (``make_mesh(device="cpu", slots_per_device=8)``), the counterpart of
the 8 virtual CPU devices tests/conftest.py gives the JAX side.  Every
step offset and nonce is held to the host ``cpu`` scan of both packages
and to ``p1_tpu.hashx.sharded``'s ``jit_sharded_step`` / ``ShardedBackend``
on those 8 devices, at the same batch and difficulty.  The ``cuda`` slot
body (``sha256d_search.cu`` on each slot's stream) runs only on the card,
where chip_smoke.py's ``multichip`` phase holds it to these results; here
``TestKernelRoute`` pins its selection and its constructor guards.
"""

import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p1_tpu.core as ref_core
from p1_tpu.hashx import get_backend as ref_get_backend
from p1_tpu.hashx import sha256_ref as ref_sha256
from p1_tpu.hashx import sharded as ref_sharded
from p1_tpu_torch.core import BlockHeader, meets_target, target_from_difficulty, target_to_words
from p1_tpu_torch.hashx import get_backend, sha256_ref
from p1_tpu_torch.hashx import sharded
from p1_tpu_torch.hashx.torch_backend import search_arrays

BATCH = 256


def _prefix(seed: int) -> bytes:
    rng = random.Random(seed)
    return BlockHeader(1, rng.randbytes(32), rng.randbytes(32), 1735689700, 8, 0).mining_prefix()


def _arrays(prefix: bytes, difficulty: int):
    words = [
        np.array(sha256_ref.header_midstate(prefix), dtype=np.uint32),
        np.array(sha256_ref.header_tail_words(prefix), dtype=np.uint32),
        np.array(target_to_words(target_from_difficulty(difficulty)), dtype=np.uint32),
    ]
    return words, search_arrays(*words, "cpu")


def _ref_step(n_devices: int, words, base: int = 0) -> int:
    step = ref_sharded.jit_sharded_step(ref_sharded.make_mesh(n_devices), BATCH)
    return int(step(*(jnp.asarray(w) for w in words), jnp.uint32(base)))


def _mesh(n: int | None = 8) -> sharded.Mesh:
    return sharded.make_mesh(n, device="cpu", slots_per_device=8)


def _backend(**kwargs):
    return get_backend("sharded", batch=BATCH, device="cpu", slots_per_device=8, **kwargs)


class TestMesh:
    def test_make_mesh_all_devices(self):
        mesh = _mesh(None)
        assert mesh.size == len(mesh.devices) == ref_sharded.make_mesh().devices.size == 8
        assert mesh.group is None and mesh.first == 0 and mesh.streams == (None,) * 8

    def test_make_mesh_subset(self):
        assert _mesh(4).size == 4
        with pytest.raises(ValueError, match="requested 64 devices, only 8 available"):
            _mesh(64)

    def test_real_devices_only_unless_asked(self):
        # The CPU is one device: without slots_per_device nothing is invented.
        assert sharded.make_mesh(device="cpu").size == 1
        with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
            sharded.make_mesh(2, device="cpu")
        with pytest.raises(ValueError):
            sharded.make_mesh(device="meta")

    def test_cuda_mesh_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            sharded.make_mesh(device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            sharded.ShardedBackend(batch=BATCH)


class TestShardedStep:
    def test_parity_with_cpu_scan(self):
        # The sharded step over 8x256 lanes reports the same first hit as a
        # host scan of the same 2048-nonce range, and as the JAX step.
        prefix = _prefix(30)
        difficulty = 8
        words, arrays = _arrays(prefix, difficulty)
        got = int(sharded.jit_sharded_step(_mesh(), BATCH, "plain")(arrays, 0)[0])
        truth = ref_get_backend("cpu").search(prefix, 0, 2048, difficulty)
        assert got == (2048 if truth.nonce is None else truth.nonce)
        assert got == _ref_step(8, words)

    def test_hit_on_non_first_device(self):
        # A seed whose earliest hit lands past slot 0's block, so the min
        # really crosses slots.
        difficulty = 10
        for seed in range(40, 60):
            prefix = _prefix(seed)
            truth = ref_get_backend("cpu").search(prefix, 0, 2048, difficulty)
            if truth.nonce is not None and truth.nonce >= BATCH:
                break
        else:
            pytest.fail("no seed with a hit past slot 0's block")
        words, arrays = _arrays(prefix, difficulty)
        got = int(sharded.jit_sharded_step(_mesh(), BATCH, "plain")(arrays, 0)[0])
        assert got == truth.nonce == _ref_step(8, words)

    @pytest.mark.parametrize("base", [0, 0x1000, 0xFFFFF800])
    def test_no_hit_returns_span(self, base):
        words, arrays = _arrays(_prefix(31), 255)
        out = sharded.jit_sharded_step(_mesh(), BATCH, "plain")(arrays, base)
        assert out.dtype == torch.int64 and out.shape == (1,)
        assert int(out[0]) == 2048 == _ref_step(8, words, base)

    def test_wrapping_base(self):
        # Slots past 2**32 wrap their nonces, as the JAX step's uint32 does.
        words, arrays = _arrays(_prefix(36), 8)
        base = (1 << 32) - 3 * BATCH
        got = int(sharded.jit_sharded_step(_mesh(), BATCH, "plain")(arrays, base)[0])
        assert got == _ref_step(8, words, base)

    def test_span_overflow_rejected(self):
        with pytest.raises(ValueError, match="uint32 nonce space"):
            sharded.jit_sharded_step(_mesh(), 1 << 29)
        with pytest.raises(ValueError, match="unknown sharded kernel"):
            sharded.jit_sharded_step(_mesh(), BATCH, "xla")


class TestShardedBackend:
    def test_registry(self):
        backend = _backend()
        assert backend.name == "sharded" and type(backend) is sharded.ShardedBackend
        assert backend.n_devices == 8
        assert backend.step_span == 8 * BATCH
        assert backend.ramp_floor is None
        ref = ref_get_backend("sharded", batch=BATCH)
        assert (ref.name, ref.n_devices, ref.step_span) == ("sharded", 8, backend.step_span)

    @pytest.mark.parametrize("difficulty", [8, 9, 10])
    def test_search_parity_with_cpu(self, difficulty):
        prefix = _prefix(32)
        truth = ref_get_backend("cpu").search(prefix, 0, 1 << 13, difficulty)
        got = _backend().search(prefix, 0, 1 << 13, difficulty)
        ref = ref_get_backend("sharded", batch=BATCH).search(prefix, 0, 1 << 13, difficulty)
        assert got.nonce == truth.nonce == ref.nonce
        assert got.hashes_done == truth.hashes_done == ref.hashes_done
        assert get_backend("cpu").search(prefix, 0, 1 << 13, difficulty) == got

    def test_partial_final_step_masked(self):
        backend = _backend()
        prefix = _prefix(33)
        truth = ref_get_backend("cpu").search(prefix, 0, 1 << 12, 8)
        assert truth.nonce is not None, "seed must hit within 4096"
        res = backend.search(prefix, 0, truth.nonce, 8)  # exclusive of the hit
        assert res.nonce is None and res.hashes_done == truth.nonce
        res2 = backend.search(prefix, 0, truth.nonce + 1, 8)
        assert res2.nonce == truth.nonce
        ref = ref_get_backend("sharded", batch=BATCH)
        assert ref.search(prefix, 0, truth.nonce, 8).nonce is None
        assert ref.search(prefix, 0, truth.nonce + 1, 8).nonce == truth.nonce

    def test_single_device_mesh_degrades(self):
        # One slot: the cuda backend's search, step for step (at one tile
        # of the kernel, the smallest batch the cuda backend takes).
        backend = get_backend("sharded", batch=1024, n_devices=1, device="cpu", slots_per_device=8)
        assert backend.n_devices == 1 and backend.step_span == 1024
        single = get_backend("cuda", batch=1024, device="cpu")
        _, arrays = _arrays(_prefix(34), 8)
        for base in (0, 1024, 5 * 1024):
            one = int(backend._make_step(1024)(arrays, base)[0])
            assert one == int(single._make_step(1024)(arrays, base)[0])
        prefix = _prefix(34)
        truth = ref_get_backend("cpu").search(prefix, 0, 4096, 8)
        got = backend.search(prefix, 0, 4096, 8)
        ref = ref_get_backend("sharded", batch=BATCH, n_devices=1).search(prefix, 0, 4096, 8)
        assert got.nonce == truth.nonce == ref.nonce == single.search(prefix, 0, 4096, 8).nonce

    def test_mines_valid_header(self):
        from p1_tpu_torch.miner import Miner

        miner = Miner(backend=_backend(), chunk=1 << 13)
        header = BlockHeader(1, bytes(32), bytes(32), 1735689700, 10, 0)
        sealed = miner.search_nonce(header)
        assert sealed is not None
        assert meets_target(sealed.block_hash(), 10)
        digest = sha256_ref.sha256d(sealed.mining_prefix() + struct.pack(">I", sealed.nonce))
        assert digest == sealed.block_hash()
        ref_header = ref_core.BlockHeader.deserialize(header.serialize())
        ref = ref_get_backend("sharded", batch=BATCH)
        from p1_tpu.miner import Miner as RefMiner

        ref_sealed = RefMiner(backend=ref, chunk=1 << 13).search_nonce(ref_header)
        assert ref_sealed.serialize() == sealed.serialize()
        assert ref_sha256.sha256d(ref_sealed.serialize()) == sealed.block_hash()


class TestKernelRoute:
    """``kernel=`` picks the slot body: ``cuda`` (the search kernel's
    step; its plain version on CPU tensors) or ``plain``; the default
    follows the mesh's device, as the JAX package's pallas/xla choice."""

    def test_cpu_mesh_defaults_to_plain(self):
        assert _backend(n_devices=2).kernel == "plain"

    def test_cuda_route_on_cpu_slots_matches(self):
        # The kernel's wrapper on CPU tensors is its plain version, so the
        # cuda route's results here equal the plain route's, slot for slot.
        backend = get_backend("sharded", batch=1024, n_devices=8, device="cpu", slots_per_device=8, kernel="cuda")
        assert backend.kernel == "cuda" and backend.step_span == 8 * 1024
        difficulty = 11
        for seed in range(60, 90):
            prefix = _prefix(seed)
            truth = ref_get_backend("cpu").search(prefix, 0, backend.step_span, difficulty)
            if truth.nonce is not None and truth.nonce >= 1024:
                break
        else:
            pytest.fail("no seed with a hit past slot 0's block")
        got = backend.search(prefix, 0, backend.step_span, difficulty)
        assert got.nonce == truth.nonce and got.hashes_done == truth.hashes_done

    def test_cuda_kernel_constructor_guards(self):
        with pytest.raises(ValueError, match="multiple"):
            get_backend("sharded", batch=512, n_devices=1, device="cpu", kernel="cuda")
        with pytest.raises(ValueError, match="2\\*\\*31"):
            get_backend("sharded", batch=1 << 31, n_devices=1, device="cpu", kernel="cuda")
        with pytest.raises(ValueError, match="power of two"):
            get_backend("sharded", batch=768, device="cpu")
        with pytest.raises(ValueError, match="uint32 nonce space"):
            get_backend("sharded", batch=1 << 30, device="cpu", slots_per_device=4)
        with pytest.raises(ValueError, match="unknown sharded kernel"):
            get_backend("sharded", batch=BATCH, device="cpu", kernel="pallas")
