"""The port's miner, genesis and ``mine`` command vs the JAX package.

Mirrors ``tests/test_miner.py`` and ``p1_tpu``'s ``_mine_chain``: the port's
``Miner(device="cpu")`` (the ``cuda`` backend's plain version) seals the
byte-identical chain that the reference miner seals with its ``cpu``
backend, and each package reads the other's 80-byte headers.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

import p1_tpu.core as ref_core
import p1_tpu.miner as ref_miner
from p1_tpu_torch.cli import mine_chain
from p1_tpu_torch.core import BlockHeader, genesis_header, meets_target
from p1_tpu_torch.hashx.backend import HashBackend, SearchResult
from p1_tpu_torch.miner import Miner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_chain(difficulty: int, blocks: int) -> list:
    """The headers ``p1_tpu.cli._mine_chain`` seals with the ``cpu`` backend
    (its loop, with each sealed header kept)."""
    miner = ref_miner.Miner(backend="cpu", chunk=1 << 12)
    tip = ref_core.make_genesis(difficulty).header
    chain = []
    for _ in range(blocks):
        draft = ref_core.BlockHeader(1, tip.block_hash(), bytes(32), tip.timestamp + 1, difficulty, 0)
        tip = miner.search_nonce(draft)
        chain.append(tip)
    return chain


def _candidate(difficulty: int, seed: int = 0) -> BlockHeader:
    return BlockHeader(
        version=1,
        prev_hash=genesis_header(difficulty).block_hash(),
        merkle_root=bytes(32),
        timestamp=1735689700 + seed,
        difficulty=difficulty,
        nonce=0,
    )


@pytest.mark.parametrize("difficulty", [0, 8, 16, 255])
def test_genesis_header_matches_reference(difficulty):
    ref = ref_core.make_genesis(difficulty).header
    assert genesis_header(difficulty).serialize() == ref.serialize()
    assert genesis_header(difficulty).block_hash() == ref.block_hash()


def test_headers_cross_deserialize():
    ref = ref_core.BlockHeader(7, bytes(range(32)), bytes(range(32, 64)), 1735689701, 20, 0xDEADBEEF)
    port = BlockHeader.deserialize(ref.serialize())
    assert (port.version, port.prev_hash, port.merkle_root) == (ref.version, ref.prev_hash, ref.merkle_root)
    assert (port.timestamp, port.difficulty, port.nonce) == (ref.timestamp, ref.difficulty, ref.nonce)
    assert port.serialize() == ref.serialize()
    assert port.mining_prefix() == ref.mining_prefix()
    assert port.block_hash() == ref.block_hash()
    assert ref_core.BlockHeader.deserialize(port.serialize()) == ref


def test_mines_same_chain_as_reference():
    headers, times, hashes = mine_chain(Miner(device="cpu"), 8, 3)
    want = _reference_chain(8, 3)
    assert [h.serialize() for h in headers] == [h.serialize() for h in want]
    prev = genesis_header(8).block_hash()
    for h in headers:
        ref = ref_core.BlockHeader.deserialize(h.serialize())
        assert ref.prev_hash == prev and ref_core.meets_target(ref.block_hash(), 8)
        prev = h.block_hash()
    assert len(times) == 3 and hashes == sum(h.nonce + 1 for h in headers)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_mines_valid_header(backend):
    miner = Miner(backend=backend, device="cpu", chunk=1 << 12)
    sealed = miner.search_nonce(_candidate(8))
    assert sealed is not None
    assert meets_target(sealed.block_hash(), 8)
    assert miner.last_stats.hashes_done >= 1
    assert miner.last_stats.hashes_per_sec > 0


def test_deterministic_across_backends():
    sealed = [
        Miner(backend=b, device="cpu", chunk=1 << 12).search_nonce(_candidate(10, seed=3))
        for b in ("cpu", "cuda")
    ]
    ref = ref_miner.Miner(backend="cpu", chunk=1 << 12).search_nonce(
        ref_core.BlockHeader.deserialize(_candidate(10, seed=3).serialize())
    )
    assert {s.nonce for s in sealed} == {ref.nonce}


def test_cpu_backend_refuses_the_card():
    with pytest.raises(ValueError, match="host only"):
        Miner(backend="cpu", device="cuda")


def test_abort_before_start():
    abort = threading.Event()
    abort.set()
    miner = Miner(backend="cpu", chunk=256)
    assert miner.search_nonce(_candidate(30), abort=abort) is None
    assert miner.last_stats.aborted


def test_abort_mid_search():
    abort = threading.Event()

    class SlowBackend(HashBackend):
        """Never finds anything; sets abort after a few chunks."""

        calls = 0

        def sha256d(self, data):
            raise NotImplementedError

        def search(self, prefix, start, count, difficulty):
            SlowBackend.calls += 1
            if SlowBackend.calls >= 3:
                abort.set()
            return SearchResult(None, count)

    miner = Miner(backend=SlowBackend(), chunk=1024)
    assert miner.search_nonce(_candidate(30), abort=abort) is None
    assert miner.last_stats.aborted
    assert miner.last_stats.hashes_done == SlowBackend.calls * 1024


class _Counting(HashBackend):
    """Never hits; records each chunk it is asked to scan."""

    def __init__(self):
        self.calls = []

    def sha256d(self, data):
        raise NotImplementedError

    def search(self, prefix, start, count, difficulty):
        self.calls.append(start)
        return SearchResult(None, count)


def test_chunk_sync_runs_once_per_chunk():
    # The lockstep hook (the reference's ``Miner._chunk_sync``): called
    # once before every backend call, with the search's abort event.
    abort = threading.Event()
    seen = []

    class Hooked(Miner):
        def _chunk_sync(self, ev):
            seen.append(ev)
            return len(seen) > 5

    backend = _Counting()
    miner = Hooked(backend=backend, chunk=1 << 20)
    assert miner.search_nonce(_candidate(30), abort=abort) is None
    assert miner.last_stats.aborted
    assert len(backend.calls) == 5 and len(seen) == 6
    assert backend.calls == [i << 20 for i in range(5)]
    assert all(ev is abort for ev in seen)


def test_chunk_sync_override_stops_at_that_chunk():
    # An override's decision wins over the local event (a pod follower
    # has none; the leader's byte decides), and the default is the event.
    backend = _Counting()

    class StopAtThird(Miner):
        def _chunk_sync(self, ev):
            return len(backend.calls) == 2

    assert StopAtThird(backend=backend, chunk=1024).search_nonce(_candidate(30)) is None
    assert backend.calls == [0, 1024]
    ev = threading.Event()
    assert Miner(backend=backend, chunk=1024)._chunk_sync(ev) is False
    ev.set()
    assert Miner(backend=backend, chunk=1024)._chunk_sync(ev) is True
    assert Miner(backend=backend, chunk=1024)._chunk_sync(None) is False


def test_timestamp_roll_on_exhaustion():
    class NeverHit(HashBackend):
        def sha256d(self, data):
            raise NotImplementedError

        def search(self, prefix, start, count, difficulty):
            return SearchResult(None, count)

    miner = Miner(backend=NeverHit(), chunk=1 << 31, max_timestamp_rolls=2)
    assert miner.search_nonce(_candidate(30)) is None
    assert miner.last_stats.timestamp_rolls == 2
    # 3 full sweeps of nonce space (initial + 2 rolls)
    assert miner.last_stats.hashes_done == 3 * (1 << 32)


def test_timestamp_roll_produces_valid_header():
    from p1_tpu_torch.hashx import get_backend

    class HitAfterRoll(HashBackend):
        """Refuses the original timestamp's space; hits once rolled."""

        def __init__(self, real):
            self.real = real
            self.sweeps = 0

        def sha256d(self, data):
            return self.real.sha256d(data)

        def search(self, prefix, start, count, difficulty):
            sweeps_before = self.sweeps
            if start + count >= 1 << 32:
                self.sweeps += 1
            if sweeps_before < 1:
                return SearchResult(None, count)
            return self.real.search(prefix, start, count, difficulty)

    miner = Miner(backend=HitAfterRoll(get_backend("cuda", device="cpu")), chunk=1 << 31)
    header = _candidate(8)
    sealed = miner.search_nonce(header)
    # The first full sweep is swallowed; the hit comes at timestamp+1.
    assert sealed is not None
    assert sealed.timestamp == header.timestamp + 1
    assert meets_target(sealed.block_hash(), 8)


def _run_cli(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch", *args],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, **env},
    )


def test_cli_mine_prints_reference_keys():
    proc = _run_cli("mine", "--device", "cpu", "--backend", "cuda", "--difficulty", "8", "--blocks", "2")
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {
        "config", "backend", "difficulty", "blocks",
        "hashes_per_sec", "time_to_block_s", "total_s",
    }  # fmt: skip
    assert (line["config"], line["backend"], line["difficulty"], line["blocks"]) == ("mine", "cuda", 8, 2)


def test_cli_mine_without_card_fails():
    # No --device cpu and no visible card: the command must not run on the CPU.
    proc = _run_cli("mine", "--difficulty", "8", "--blocks", "1", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr
