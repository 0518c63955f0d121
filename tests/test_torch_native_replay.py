"""The port's native chain replay against the JAX package's, on the CPU.

Takes the native cases of tests/test_chain.py (``replay_native`` against
the host oracle), tests/test_headers.py (``replay_fast`` prefers native,
degrades to ``replay_host`` on ``NativeBuildError``, crashes on a wrapper
bug; ``replay_packed`` in one call) and tests/test_retarget.py
(``p1_verify_chain_retarget``: position × field parity, the forward cap and
a backdate, the height-1 anchor).  Every first-invalid index of the port's
``replay_native`` is held against ``p1_tpu.chain.replay_native`` on the
same bytes and against the port's ``replay_host``, exactly.  Chains are
mined by the port's hashlib backend; corruptions are drawn from a numpy
seed.
"""

import dataclasses

import numpy as np
import pytest

from p1_tpu.chain import parse_headers as ref_parse
from p1_tpu.chain import replay_native as ref_replay_native
from p1_tpu.core.retarget import RetargetRule as RefRule
from p1_tpu_torch.chain import (
    generate_headers,
    pack_headers,
    replay_fast,
    replay_host,
    replay_native,
    replay_packed,
)
from p1_tpu_torch.chain import replay as replay_mod
from p1_tpu_torch.core import BlockHeader, RetargetRule, make_genesis
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.hashx.native_build import NativeBuildError
from p1_tpu_torch.miner import Miner

DIFF = 8
RULE = RetargetRule(window=4, spacing=100)
FAST = RetargetRule(window=4, spacing=100)
_MINER = Miner(backend=get_backend("cpu"))


def _ref_rule(rule):
    return None if rule is None else RefRule(**dataclasses.asdict(rule))


def _first_invalid(headers, rule=None) -> int | None:
    """The port's native first invalid, held against the JAX package's
    native engine on the same bytes and the port's host oracle."""
    native = replay_native(headers, retarget=rule)
    ref = ref_replay_native(ref_parse(pack_headers(headers)), retarget=_ref_rule(rule))
    host = replay_host(headers, retarget=rule)
    assert native.method == "native" and native.n_headers == len(headers)
    assert native.first_invalid == ref.first_invalid == host.first_invalid, (native, ref, host)
    assert native.valid == (native.first_invalid is None)
    return native.first_invalid


@pytest.fixture(scope="module")
def headers():
    return generate_headers(64, DIFF, backend=get_backend("cpu"))


@pytest.fixture(scope="module")
def retarget_headers():
    return generate_headers(12, DIFF, backend=get_backend("cpu"), retarget=FAST)


def _child(parent, difficulty: int, ts: int):
    header = BlockHeader(1, parent.block_hash(), bytes(32), ts, difficulty, 0)
    sealed = _MINER.search_nonce(header)
    assert sealed is not None
    return sealed


class TestNativeReplay:
    """tests/test_chain.py's native case, widened."""

    def test_native_replay_matches_host(self, headers):
        assert _first_invalid(headers) is None
        bad = list(headers)
        bad[37] = bad[37].with_nonce(bad[37].nonce ^ 1)
        assert _first_invalid(bad) == 37
        bad2 = list(headers)
        bad2[30] = dataclasses.replace(bad2[30], difficulty=DIFF + 1)
        assert _first_invalid(bad2) == 30

    @pytest.mark.parametrize("seed", range(4))
    def test_random_byte_flips(self, headers, seed):
        rng = np.random.default_rng(seed)
        raw = bytearray(pack_headers(headers))
        for _ in range(int(rng.integers(1, 4))):
            raw[int(rng.integers(len(raw)))] ^= 1 << int(rng.integers(8))
        flipped = [BlockHeader.deserialize(bytes(raw[i : i + 80])) for i in range(0, len(raw), 80)]
        _first_invalid(flipped)

    def test_genesis_link_and_single_header(self, headers):
        assert _first_invalid(headers[:1]) is None
        bad = [dataclasses.replace(headers[0], prev_hash=b"\x01" + bytes(31)), *headers[1:8]]
        assert _first_invalid(bad) == 0

    def test_length_mismatch_refused(self):
        from p1_tpu_torch.hashx.native_backend import verify_header_chain

        with pytest.raises(ValueError, match="expected 160 header bytes"):
            verify_header_chain(bytes(80), 2, DIFF)


class TestReplayFastFallback:
    """tests/test_headers.py's ``TestReplayFastFallback``."""

    def test_falls_back_to_host_without_toolchain(self, monkeypatch, headers):
        def no_native():
            raise NativeBuildError("no compiler on this host")

        monkeypatch.setattr(replay_mod, "_probe_native", no_native)
        report = replay_fast(headers[:8])
        assert report.valid and report.method == "host"

    def test_wrapper_bug_surfaces_instead_of_degrading(self, monkeypatch, headers):
        def buggy_native(*a, **k):
            raise AttributeError("wrapper typo: no such attribute")

        monkeypatch.setattr(replay_mod, "replay_native", buggy_native)
        with pytest.raises(AttributeError):
            replay_fast(headers[:8])

    def test_prefers_native_when_available(self, headers):
        report = replay_fast(headers[:8])
        assert report.valid and report.method == "native"

    def test_packed_buffer_in_one_call(self, headers, monkeypatch):
        raw = pack_headers(headers)
        report = replay_packed(raw)
        assert report.valid and report.method == "native" and report.n_headers == len(headers)
        bad = bytearray(raw)
        bad[20 * 80 + 77] ^= 1  # header 20's nonce: header 21's link breaks
        assert replay_packed(bytes(bad)).first_invalid == replay_host(
            [BlockHeader.deserialize(bytes(bad[i : i + 80])) for i in range(0, len(bad), 80)]
        ).first_invalid

        def no_toolchain(*a, **k):
            raise NativeBuildError("no compiler on this host")

        from p1_tpu_torch.hashx import native_backend

        monkeypatch.setattr(native_backend, "verify_header_chain", no_toolchain)
        fallback = replay_packed(raw)
        assert fallback.valid and fallback.method == "host"


class TestNativeRetargetReplay:
    """tests/test_retarget.py's ``TestNativeRetargetReplay``."""

    def test_clean_chain(self, retarget_headers):
        assert _first_invalid(retarget_headers, FAST) is None

    @pytest.mark.parametrize("field", ["nonce", "difficulty", "timestamp"])
    def test_parity_with_host_oracle(self, retarget_headers, field):
        mutate = {
            "nonce": lambda h: dataclasses.replace(h, nonce=h.nonce ^ 1),
            "difficulty": lambda h: dataclasses.replace(h, difficulty=h.difficulty + 1),
            "timestamp": lambda h: dataclasses.replace(h, timestamp=h.timestamp + 7),
        }[field]
        for i in range(1, len(retarget_headers)):
            mutated = [*retarget_headers]
            mutated[i] = mutate(mutated[i])
            assert _first_invalid(mutated, FAST) is not None, (field, i)

    def test_native_enforces_forward_cap_and_backdate(self):
        g = make_genesis(DIFF, RULE)
        b1 = _child(g, DIFF, g.header.timestamp + 1)
        over = _child(b1, DIFF, b1.timestamp + RULE.max_increment + 1)
        assert _first_invalid([g.header, b1, over], RULE) == 2
        stale = _child(b1, DIFF, b1.timestamp)
        assert _first_invalid([g.header, b1, stale], RULE) == 2
        # The height-1 anchor exemption holds natively too.
        far = _child(g, DIFF, g.header.timestamp + 50_000_000)
        assert _first_invalid([g.header, far], RULE) is None

    def test_native_retarget_at_length(self):
        fast = RetargetRule(window=64, spacing=1)
        chain = generate_headers(400, DIFF, backend=get_backend("cpu"), retarget=fast)
        assert _first_invalid(chain, fast) is None
        bad = list(chain)
        bad[300] = dataclasses.replace(bad[300], timestamp=bad[299].timestamp)
        assert _first_invalid(bad, fast) == 300
