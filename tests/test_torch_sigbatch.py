"""The port's signature validation against the JAX package, on the CPU.

Mirrors the relevant classes of tests/test_sigbatch.py and
tests/test_keys.py: ``p1_tpu_torch.core.keys`` (the ladder, ``STATS``,
``verify_batch``, ``first_invalid``, the negative memo), ``core/sigcache.py``,
``core/tx.py`` and ``core/block.py`` (the same bytes), and
``chain/validate.py`` (``check_block`` and ``preverify_signatures``: the
same verdicts and the same error text as ``p1_tpu``'s on blocks built
from a seed, torsion crafts included), and the untrusted store load that
streams its signature windows into them (``TestRevalidateEquivalence``);
``TestNoDoubleVerify`` and ``TestNodeValidationStatus`` run the
reference's cases on the port's pool, chain and node: a transfer verified
at admission is a cache hit when its block connects.  The port's default rung,
``device``, runs here through ``set_sig_backend("device", device="cpu")``
(the plain PyTorch version), which every test pins unless it asks for
another rung; asked for the card on a host without one, it raises.
``each_rung`` runs the equivalence cases on every batch rung: pure
Python, the native C++ engine (``g++`` builds it on the test hosts) and
the device rung's plain version; serial work takes the native rung unless
``native_absent`` makes its build fail, as on a host without ``g++``.

Fixtures are signed with the JAX package's keys (the ``cryptography``
wheel where it is installed) and carried into the port by their bytes:
RFC 8032 signatures are deterministic, so the port would sign the same.
"""

import dataclasses
import logging
import random
import re
import struct
import zlib

import pytest
import torch

from txutil import account, key_for, stx

from p1_tpu.chain import ValidationError as RefValidationError
from p1_tpu.chain import check_block as ref_check_block
from p1_tpu.chain.validate import preverify_signatures as ref_preverify
from p1_tpu.core import Block as RefBlock
from p1_tpu.core import BlockHeader as RefHeader
from p1_tpu.core import Transaction as RefTransaction
from p1_tpu.core import _ed25519 as ref_ed
from p1_tpu.core import block as ref_block
from p1_tpu.core import keys as ref_keys
from p1_tpu.core.genesis import genesis_hash as ref_genesis_hash
from p1_tpu.core.genesis import make_genesis as ref_make_genesis
from p1_tpu.chain import ChainStore as RefStore
from p1_tpu.chain import save_chain as ref_save_chain
from p1_tpu.chain.chain import Chain as RefChain
from p1_tpu.core.sigcache import SignatureCache as RefCache
from p1_tpu.hashx import get_backend as ref_get_backend
from p1_tpu.miner import Miner as RefMiner
from p1_tpu_torch.benchmarks import sig_verify as sv
from p1_tpu_torch.chain import ValidationError, check_block, preverify_signatures
from p1_tpu_torch.core import Block, Transaction, keys, make_genesis, sigcache
from p1_tpu_torch.core import block as port_block
from p1_tpu_torch.core.genesis import genesis_hash
from p1_tpu_torch.core.sigcache import SignatureCache
from p1_tpu_torch.chain import ChainStore
from p1_tpu_torch.chain import store as store_mod
from p1_tpu_torch.chain import validate as validate_mod
from p1_tpu_torch.hashx import cuda_ed25519, ed25519_msm

DIFF = 8
TAG = ref_genesis_hash(DIFF)
_MINER = RefMiner(backend=ref_get_backend("cpu"))


@pytest.fixture(autouse=True)
def _ladder_reset():
    keys.set_sig_backend("device", device="cpu")
    yield
    keys.set_sig_backend(None)


def _triples(n, salt="t"):
    out = []
    for i in range(n):
        kp = key_for(f"sigbatch-{salt}-{i % 5}")
        msg = b"sigbatch-%d-%s" % (i, salt.encode())
        out.append((kp.pubkey, kp.sign(msg), msg))
    return out


def _corrupt(triple):
    pub, sig, msg = triple
    return pub, sig[:20] + bytes([sig[20] ^ 1]) + sig[21:], msg


def _bad_sig(sig: bytes) -> bytes:
    return _corrupt((b"", sig, b""))[1]


def _torsion_tx(tag: bytes, *, cancel: bool) -> RefTransaction:
    """A transfer whose ownership proof is a torsion craft (the fixture of
    tests/test_sigbatch.py): serially valid for cancel=True, invalid for
    cancel=False, gate-rejected by every batch either way."""
    a, prefix = ref_ed._secret_expand(bytes(32))
    t = ref_ed._pt_decompress(sv.T2_ENC if cancel else sv.T4_ENC)
    a_pt = ref_ed._pt_mul(a, ref_ed._B)
    pub = ref_ed._pt_compress(ref_ed._pt_add(a_pt, t) if cancel else a_pt)
    for seq in range(200):
        tx = RefTransaction(ref_keys.account_id(pub), account("bob"), 1, 1, seq, pub, b"", tag)
        msg = tx.signing_bytes()
        r = int.from_bytes(ref_ed._sha512(prefix + msg), "little") % ref_ed._Q
        r_enc = ref_ed._pt_compress(ref_ed._pt_add(ref_ed._pt_mul(r, ref_ed._B), t))
        k = int.from_bytes(ref_ed._sha512(r_enc + pub + msg), "little") % ref_ed._Q
        if cancel and k % 2 == 0:
            continue
        sig = r_enc + ((r + k * a) % ref_ed._Q).to_bytes(32, "little")
        return dataclasses.replace(tx, sig=sig)
    raise AssertionError("no usable k")


def _transfers(n, start_seq=0):
    return [stx("alice", account("bob"), 1, 1, start_seq + i, difficulty=DIFF) for i in range(n)]


def _ref_block(txs) -> RefBlock:
    """A block of ``txs`` on the difficulty-8 genesis, mined by the JAX
    package's cpu backend."""
    parent = ref_make_genesis(DIFF)
    header = RefHeader(1, parent.block_hash(), ref_block.merkle_root([t.txid() for t in txs]),
                       parent.header.timestamp + 60, DIFF, 0)  # fmt: skip
    return RefBlock(_MINER.search_nonce(header), tuple(txs))


def _outcomes(txs) -> tuple[str | None, str | None]:
    """(p1_tpu's check_block outcome, the port's) on the same block."""
    block = _ref_block(txs)
    try:
        ref_check_block(block, DIFF, sig_cache=RefCache())
        want = None
    except RefValidationError as exc:
        want = str(exc)
    try:
        check_block(Block.deserialize(block.serialize()), DIFF, sig_cache=SignatureCache())
        got = None
    except ValidationError as exc:
        got = str(exc)
    return want, got


@pytest.fixture(params=["pure-python", "native", "device-cpu"])
def each_rung(request):
    """The port's three batch rungs: pure-Python, the native C++ engine and
    the device rung on the plain version."""
    if request.param == "device-cpu":
        keys.set_sig_backend("device", device="cpu")
    elif request.param == "native":
        keys.set_sig_backend("native")
        assert keys.backend() == "native", "the native engine did not build (g++)"
    else:
        keys.set_sig_backend("fallback")
    yield request.param


@pytest.fixture
def native_absent(monkeypatch):
    """The native engine as on a host without a toolchain: its build
    raises ``NativeBuildError`` and the load is remembered as failed."""
    from p1_tpu_torch.core import _ed25519_native
    from p1_tpu_torch.hashx import native_build

    def no_toolchain(force=False):
        raise native_build.NativeBuildError("no toolchain (test)")

    monkeypatch.setattr(native_build, "build_lib", no_toolchain)
    monkeypatch.setattr(_ed25519_native, "_LIB", None)
    monkeypatch.setattr(_ed25519_native, "_LOAD_FAILED", False)
    yield
    keys.set_sig_backend(None)


class TestCopies:
    """tx, block, genesis and sigcache: the JAX package's bytes."""

    def test_transactions_round_trip_byte_for_byte(self):
        for ref_tx in [*_transfers(3), RefTransaction.coinbase("miner", 7), _torsion_tx(TAG, cancel=False)]:
            tx = Transaction.deserialize(ref_tx.serialize())
            assert tx.serialize() == ref_tx.serialize()
            assert tx.txid() == ref_tx.txid()
            assert tx.signing_bytes() == ref_tx.signing_bytes()
            assert tx.is_coinbase == ref_tx.is_coinbase
            rebuilt = Transaction(tx.sender, tx.recipient, tx.amount, tx.fee, tx.seq, tx.pubkey, tx.sig, tx.chain)
            assert rebuilt.serialize() == ref_tx.serialize()

    def test_transfer_signs_the_same_bytes(self):
        ref_kp = key_for("port-transfer")
        kp = keys.Keypair(ref_kp._seed)
        tx = Transaction.transfer(kp, "r", 5, 1, 3, chain=genesis_hash(DIFF))
        ref_tx = RefTransaction.transfer(ref_kp, "r", 5, 1, 3, chain=TAG)
        assert tx.serialize() == ref_tx.serialize()
        assert tx.verify_signature(cache=SignatureCache())

    @pytest.mark.parametrize("n", [1, 2, 3, 7, 8])
    def test_merkle_functions_equal(self, n):
        txids = [bytes([i]) * 32 for i in range(n)]
        assert port_block.merkle_root(txids) == ref_block.merkle_root(txids)
        assert port_block.merkle_levels(txids) == ref_block.merkle_levels(txids)
        for i in range(n):
            branch = port_block.merkle_branch(txids, i)
            assert branch == ref_block.merkle_branch(txids, i)
            assert port_block.verify_merkle_branch(txids[i], i, branch, port_block.merkle_root(txids))

    def test_blocks_and_genesis_equal(self):
        block = _ref_block([RefTransaction.coinbase("m", 1), *_transfers(2)])
        ours = Block.deserialize(block.serialize())
        assert ours.serialize() == block.serialize()
        assert ours.block_hash() == block.block_hash() and ours.merkle_ok()
        for d in (8, 16):
            assert make_genesis(d).serialize() == ref_make_genesis(d).serialize()
            assert genesis_hash(d) == ref_genesis_hash(d)


class TestKeypair:
    """Mirrors tests/test_keys.py on the port's keys."""

    def test_deterministic_from_seed_text_and_equal_to_reference(self):
        a = keys.Keypair.from_seed_text("alice")
        assert a.pubkey == keys.Keypair.from_seed_text("alice").pubkey
        ref = ref_keys.Keypair.from_seed_text("alice")
        assert (a.pubkey, a.account) == (ref.pubkey, ref.account)
        assert a.account.startswith(keys.ACCOUNT_PREFIX)

    def test_sign_verify_round_trip(self):
        kp = keys.Keypair.from_seed_text("signer")
        sig = kp.sign(b"hello")
        assert sig == ref_keys.Keypair.from_seed_text("signer").sign(b"hello")
        assert keys.verify(kp.pubkey, sig, b"hello")
        assert not keys.verify(kp.pubkey, sig, b"hellO")
        assert not keys.verify(kp.pubkey[:31], sig, b"hello")

    def test_account_id_or_none(self):
        assert keys.account_id_or_none(b"x" * 31) is None
        assert keys.account_id_or_none(b"x" * 32) == ref_keys.account_id(b"x" * 32)
        with pytest.raises(ValueError):
            keys.account_id(b"short")

    def test_save_load_refuse_and_tamper(self, tmp_path):
        kp = keys.Keypair.from_seed_text("persist")
        path = tmp_path / "k.json"
        kp.save(str(path))
        assert keys.Keypair.load(str(path)).pubkey == kp.pubkey
        assert ref_keys.Keypair.load(str(path)).pubkey == kp.pubkey
        with pytest.raises(FileExistsError):
            kp.save(str(path))
        kp.save(str(path), overwrite=True)
        path.write_text(path.read_text().replace(kp.account, "p1" + "0" * 16))
        with pytest.raises(ValueError, match="claims account"):
            keys.Keypair.load(str(path))


class TestLadder:
    def test_auto_resolves_pure_python(self, monkeypatch, native_absent):
        # Serial verifies resolve to the native rung where it builds, to
        # the pure-Python rung where it does not (here: no toolchain);
        # batches to the card (the port's entry points run on the card by
        # default).
        monkeypatch.delenv("P1_SIG_BACKEND", raising=False)
        keys.set_sig_backend(None)
        assert keys.backend_label() == "auto"
        assert keys._serial_backend() == "pure-python"
        assert keys.backend() == keys.backend_label() == "device" and keys._sig_device == "cuda"
        assert keys.HAVE_CRYPTOGRAPHY is False

    def test_auto_serial_rung_is_native(self, monkeypatch):
        monkeypatch.delenv("P1_SIG_BACKEND", raising=False)
        keys.set_sig_backend(None)
        assert keys._serial_backend() == "native"
        assert keys.backend() == "device"
        keys.set_sig_backend("native")
        assert keys.backend() == keys._serial_backend() == keys.backend_label() == "native"

    def test_label_does_not_probe_the_native_engine(self, monkeypatch):
        # A status request must never be the call that runs g++.
        from p1_tpu_torch.core import _ed25519_native

        def probe():
            raise AssertionError("backend_label() probed the native engine")

        monkeypatch.setattr(_ed25519_native, "load", probe)
        for name in (None, "native", "device"):
            keys.set_sig_backend(name)
            assert keys.backend_label() == (name or "auto")

    @pytest.mark.parametrize("name", ["cryptography", "native"])
    def test_missing_rungs_warn_and_resolve_the_ladder(self, name, caplog, native_absent):
        # The wheel is never in the port; the native engine is missing
        # where it does not build (``native_absent``).
        keys.set_sig_backend(name)
        assert keys.backend_label() == name
        with caplog.at_level("WARNING", logger="p1_tpu_torch.core.keys"):
            assert keys.backend() == "device"
        assert any(name in r.getMessage() for r in caplog.records)

    def test_forced_pure_python(self, monkeypatch):
        keys.set_sig_backend("fallback")
        assert keys.backend() == keys._serial_backend() == "pure-python"
        keys.set_sig_backend(None)
        monkeypatch.setenv("P1_SIG_BACKEND", "fallback")
        assert keys.backend() == "pure-python"

    def test_device_rung_and_its_device(self):
        keys.set_sig_backend("device")
        assert keys.backend() == "device" and keys._sig_device == "cuda"
        assert keys._serial_backend() == "native"
        keys.set_sig_backend("device", device="cpu")
        assert keys._sig_device == "cpu"
        keys.set_sig_backend(None)
        assert keys._sig_device == "cuda"
        keys.set_sig_backend("auto", device="cpu")
        assert keys.backend() == "device" and keys._sig_device == "cpu"

    def test_refusals(self):
        with pytest.raises(ValueError, match="unknown signature backend"):
            keys.set_sig_backend("wheel")
        with pytest.raises(ValueError, match="device= applies"):
            keys.set_sig_backend("fallback", device="cpu")
        with pytest.raises(ValueError, match="cuda' or 'cpu"):
            keys.set_sig_backend("device", device="tpu")

    def test_env_request(self, monkeypatch):
        monkeypatch.setenv("P1_SIG_BACKEND", "device")
        keys.set_sig_backend(None)
        assert keys.backend_label() == "device" and keys.backend() == "device"
        monkeypatch.setenv("P1_SIG_BACKEND", "bogus")
        keys.set_sig_backend(None)
        assert keys.backend() == "device"

    def test_stats_key_set_is_the_reference_one(self):
        assert keys.SIG_BACKENDS == ref_keys.SIG_BACKENDS
        assert set(keys.VerifyStats().backends) == set(ref_keys.VerifyStats().backends)
        assert (keys.BATCH_MIN, keys.BATCH_CHUNK) == (ref_keys.BATCH_MIN, ref_keys.BATCH_CHUNK)


class TestDeviceWithoutCard:
    """The device rung raises on a host without a card: no degrade."""

    def test_batch_raises_and_the_rung_stays(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        keys.set_sig_backend("device")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            keys.verify_batch(_triples(keys.BATCH_MIN, salt="nocard"))
        assert keys.backend() == "device"
        # Serial work keeps the ladder beneath, on any host.
        assert keys.verify(*_triples(1, salt="nocard")[0])

    def test_check_block_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        keys.set_sig_backend("device")
        block = Block.deserialize(_ref_block([RefTransaction.coinbase("m", 1), *_transfers(9)]).serialize())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check_block(block, DIFF, sig_cache=SignatureCache())

    def test_auto_raises_too(self, monkeypatch):
        # The default rung is the card's: a batch on a host without one
        # raises rather than running on the host.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.delenv("P1_SIG_BACKEND", raising=False)
        keys.set_sig_backend(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            keys.verify_batch(_triples(keys.BATCH_MIN, salt="nocard-auto"))
        assert keys.verify_batch(_triples(keys.BATCH_MIN - 1, salt="nocard-auto"))  # serial


class TestStats:
    """Mirrors TestVerifyBatchDispatch."""

    def test_small_batches_run_serial(self):
        tr = _triples(keys.BATCH_MIN - 1, salt="small")
        keys.STATS.reset()
        assert keys.verify_batch(tr)
        assert keys.STATS.serial == len(tr) and keys.STATS.batched == 0

    def test_large_batches_count_batched(self, each_rung):
        tr = _triples(keys.BATCH_MIN, salt="large")
        keys.STATS.reset()
        assert keys.verify_batch(tr)
        assert keys.STATS.batched == len(tr) and keys.STATS.serial == 0
        rung = "device" if each_rung == "device-cpu" else each_rung
        assert keys.STATS.backends == {**{k: 0 for k in keys.SIG_BACKENDS}, rung: len(tr)}

    def test_auto_batches_on_device_serial_on_native(self):
        # Under auto a batch of BATCH_MIN or more goes to the device rung
        # (here its plain version), a serial verify to the native rung.
        keys.set_sig_backend("auto", device="cpu")
        tr = _triples(keys.BATCH_MIN, salt="auto-split")
        keys.STATS.reset()
        assert keys.verify_batch(tr)
        keys._neg_cache.clear()
        assert keys.verify(*tr[0])
        assert not keys.verify(*_corrupt(tr[1]))
        assert keys.STATS.backends == {**{k: 0 for k in keys.SIG_BACKENDS}, "device": len(tr), "native": 2}
        assert (keys.STATS.batched, keys.STATS.serial) == (len(tr), 2)

    def test_native_chunks_go_to_the_pool(self, monkeypatch):
        # A pinned native batch of several chunks runs them on the verify
        # pool when more than one worker is set; one worker keeps them in
        # the calling thread.
        monkeypatch.setattr(keys, "BATCH_CHUNK", 8)
        keys.set_sig_backend("native")
        tr = _triples(20, salt="pool")
        try:
            keys.set_verify_workers(3)
            keys.STATS.reset()
            assert keys.verify_batch(tr)
            assert keys.STATS.pool_dispatches == 1 and keys.STATS.backends["native"] == 20
            bad = list(tr)
            bad[13] = _corrupt(bad[13])
            assert not keys.verify_batch(bad)
            assert keys.first_invalid(bad) == 13
            keys.shutdown_verify_pool()
            assert keys.verify_batch(tr)  # a new pool after the shutdown
            keys.set_verify_workers(1)
            keys.STATS.reset()
            assert keys.verify_batch(tr) and keys.STATS.pool_dispatches == 0
        finally:
            keys.set_verify_workers(None)
            keys.shutdown_verify_pool()

    def test_device_chunks_are_launch_units(self, monkeypatch):
        calls = []
        real = cuda_ed25519.decode_gate_msm
        monkeypatch.setattr(cuda_ed25519, "decode_gate_msm", lambda p, s: calls.append(len(p)) or real(p, s))
        monkeypatch.setattr(keys, "BATCH_CHUNK", 8)
        keys.set_sig_backend("device", device="cpu")
        tr = _triples(20, salt="chunks")
        assert keys.verify_batch(tr)
        assert len(calls) == 3  # chunks of 8, 8, 4
        assert keys.STATS.pool_dispatches == 0

    def test_fallback_warning_fires_once(self, caplog):
        keys._fallback_warned = False
        try:
            keys.set_sig_backend("fallback")
            with caplog.at_level(logging.WARNING, logger="p1_tpu_torch.core.keys"):
                keys.verify_batch(_triples(keys.BATCH_MIN, salt="warn"))
                keys.verify_batch(_triples(keys.BATCH_MIN, salt="warn2"))
        finally:
            keys._fallback_warned = False
        hits = [r for r in caplog.records if "pure-Python Ed25519" in r.getMessage()]
        assert len(hits) == 1
        msg = hits[0].getMessage()
        assert "FORCED" in msg and "device" in msg and "native" in msg
        assert "ms" in msg and re.search(r"\d\s*ms", msg)  # names the measured slowdown


class TestFirstInvalid:
    """``first_invalid`` against the JAX package's on the same triples."""

    @pytest.mark.parametrize("positions", [[4], [3, 17], [0, 1, 29], [29], []])
    def test_matches_reference(self, positions):
        base = _triples(30, salt="first")
        bad = list(base)
        for p in positions:
            bad[p] = _corrupt(bad[p])
        want = ref_keys.first_invalid(bad)
        assert keys.first_invalid(bad) == want == (min(positions) if positions else None)

    def test_not_steered_by_torsion_reject(self, each_rung):
        base = _triples(24, salt="steer")
        mixed = list(base)
        mixed[2] = sv.torsion_triple(cancel=True)  # serially VALID, gate-rejected
        mixed[20] = _corrupt(mixed[20])
        assert not keys.verify_batch(mixed)
        assert keys.first_invalid(mixed) == ref_keys.first_invalid(mixed) == 20
        mixed[20] = base[20]
        assert not keys.verify_batch(mixed)
        assert keys.first_invalid(mixed) is ref_keys.first_invalid(mixed) is None


class TestCheckBlockEquivalence:
    """``check_block``: the port's verdict and error text are p1_tpu's."""

    def test_valid_block(self, each_rung):
        want, got = _outcomes([RefTransaction.coinbase(account("m"), 1), *_transfers(10)])
        assert got == want is None

    @pytest.mark.parametrize("pos", [0, 5, 9])
    def test_corrupted_sig(self, pos, each_rung):
        txs = _transfers(10)
        txs[pos] = dataclasses.replace(txs[pos], sig=_bad_sig(txs[pos].sig))
        want, got = _outcomes([RefTransaction.coinbase(account("m"), 1), *txs])
        assert got == want == "bad transaction signature"

    def test_structural_vs_signature_precedence(self):
        good = _transfers(9)
        foreign = dataclasses.replace(stx("alice", account("bob"), 1, 1, 50, difficulty=DIFF),
                                      chain=ref_genesis_hash(DIFF + 1))  # fmt: skip
        bad_sig = dataclasses.replace(good[2], sig=_bad_sig(good[2].sig))
        signed_coinbase = dataclasses.replace(RefTransaction.coinbase(account("m"), 1), sig=b"x" * 64)
        cases = [
            ([*good[:2], bad_sig, *good[3:], foreign], "bad transaction signature"),
            ([*good[:5], foreign, *good[5:]], "transaction signed for a different chain"),
            ([signed_coinbase, *good[:3]], "coinbase must be unsigned"),
            ([RefTransaction.coinbase(account("m"), 1, reward=51), *good[:3]], "coinbase mints 51, subsidy is 50"),
            ([*good[:3], RefTransaction.coinbase(account("m"), 1)], "coinbase transaction must be first and unique"),
            ([*good[:3], good[1]], "duplicate txid in block"),
        ]
        for txs, expected in cases:
            want, got = _outcomes(txs)
            assert got == want == expected

    @pytest.mark.parametrize("cancel", [True, False])
    def test_torsion_tx(self, cancel, each_rung):
        crafted = _torsion_tx(TAG, cancel=cancel)
        want, got = _outcomes([*_transfers(keys.BATCH_MIN), crafted])
        assert got == want == (None if cancel else "bad transaction signature")

    def test_fingerprint_mismatch(self):
        victim = _transfers(9)
        forged = dataclasses.replace(victim[4], pubkey=key_for("sigbatch-thief").pubkey)
        want, got = _outcomes([*victim[:4], forged, *victim[5:]])
        assert got == want == "bad transaction signature"

    def test_header_checks(self):
        block = _ref_block([RefTransaction.coinbase("m", 1)])
        ours = Block.deserialize(block.serialize())
        with pytest.raises(ValidationError, match="difficulty 8 != chain difficulty 9"):
            check_block(ours, DIFF + 1)
        mangled = Block(ours.header, (Transaction.coinbase("n", 1),))
        with pytest.raises(ValidationError, match="merkle root mismatch"):
            check_block(mangled, DIFF)


class TestPreverify:
    def test_warms_only_valid_sigs(self, each_rung):
        txs = _transfers(12)
        bad = dataclasses.replace(txs[5], sig=_bad_sig(txs[5].sig))
        foreign = dataclasses.replace(txs[7], chain=b"\x00" * 32)
        mixed = [*txs[:5], bad, txs[6], foreign, *txs[8:], RefTransaction.coinbase("m", 1)]
        ours = [Transaction.deserialize(t.serialize()) for t in mixed]
        cache = SignatureCache()
        proven = preverify_signatures(ours, TAG, cache)
        assert proven == ref_preverify(mixed, TAG, RefCache()) == 10
        assert cache.hit(ours[0].txid(), ours[0].pubkey, ours[0].sig)
        assert not cache.hit(ours[5].txid(), ours[5].pubkey, ours[5].sig)
        assert not cache.hit(ours[7].txid(), ours[7].pubkey, ours[7].sig)

    def test_warm_cache_skips_the_backend(self):
        block = Block.deserialize(
            _ref_block([RefTransaction.coinbase(account("m"), 1), *_transfers(10)]).serialize()
        )
        warm = SignatureCache()
        assert preverify_signatures(block.txs, TAG, warm) == 10
        keys.STATS.reset()
        check_block(block, DIFF, sig_cache=warm)
        assert keys.STATS.serial == keys.STATS.batched == 0


class TestSignatureCache:
    def test_lru_bound_and_counters(self):
        cache = sigcache.SignatureCache(max_entries=2)
        for i in range(3):
            cache.add(bytes([i]) * 32, b"p", b"s")
        assert len(cache) == 2 and cache.bytes_used == 2 * sigcache.ENTRY_COST
        assert not cache.hit(bytes([0]) * 32, b"p", b"s")
        assert cache.hit(bytes([2]) * 32, b"p", b"s")
        assert cache.snapshot() == {"hits": 1, "misses": 1, "entries": 2, "bytes": 2 * sigcache.ENTRY_COST}

    def test_salted_keys_differ_across_instances(self):
        a, b = sigcache.SignatureCache(), sigcache.SignatureCache()
        assert a._key(b"t", b"p", b"s") != b._key(b"t", b"p", b"s")

    def test_failures_never_cached(self):
        tx = Transaction.deserialize(_transfers(1)[0].serialize())
        bad = dataclasses.replace(tx, sig=_bad_sig(tx.sig))
        cache = sigcache.SignatureCache()
        assert not bad.verify_signature(cache=cache)
        assert len(cache) == 0
        assert tx.verify_signature(cache=cache) and len(cache) == 1


class TestNegativeMemo:
    def test_replayed_invalid_costs_one_backend_call(self, monkeypatch):
        calls = []
        real = keys._backend_verify
        monkeypatch.setattr(keys, "_backend_verify", lambda *t: calls.append(1) or real(*t))
        bad = _corrupt(_triples(1, salt="neg")[0])
        assert not keys.verify(*bad)
        assert not keys.verify(*bad)
        assert len(calls) == 1

    def test_memo_is_bounded(self, monkeypatch):
        monkeypatch.setattr(keys, "_NEG_CACHE_MAX", 2)
        monkeypatch.setattr(keys, "_neg_cache", type(keys._neg_cache)())
        pub, sig, _ = _triples(1, salt="bound")[0]
        for i in range(4):
            keys.verify(pub, sig, b"other-%d" % i)
        assert len(keys._neg_cache) == 2


def test_rng_free_batches_agree_with_reference():
    # Coefficients drawn by ``secrets`` (the default): the verdicts of
    # random mixes match the reference's pure-Python batch.
    rng = random.Random(8)
    base = _triples(16, salt="mix")
    keys.set_sig_backend("device", device="cpu")
    for _ in range(2):
        batch = [_corrupt(t) if rng.random() < 0.2 else t for t in base]
        assert keys.verify_batch(batch) == ref_ed.verify_batch(batch) == all(ref_ed.verify(*t) for t in batch)


class TestRevalidateEquivalence:
    """Mirrors tests/test_sigbatch.py's class: an untrusted load of a
    store (``ChainStore.load_chain(trusted=False)``) through the
    pre-verification windows gives the built chain's state, the serial
    lane's, and the JAX package's load's; a tampered record stops both
    packages' loads at the same height; a trusted resume verifies
    nothing."""

    @staticmethod
    def _build_store(tmp_path, n_blocks=24):
        """A store written by the JAX package: three funding blocks, then
        ``n_blocks`` blocks of a coinbase and three signed transfers."""
        chain = RefChain(DIFF)
        seq = 0
        for h in range(1, 4 + n_blocks):
            txs = [RefTransaction.coinbase(account("alice"), h)]
            if h >= 4:
                txs += _transfers(3, seq)
                seq += 3
            parent = chain.tip
            header = RefHeader(1, parent.block_hash(), ref_block.merkle_root([t.txid() for t in txs]),
                               parent.header.timestamp + 1, DIFF, 0)  # fmt: skip
            assert chain.add_block(RefBlock(_MINER.search_nonce(header), tuple(txs))).status.value == "accepted"
        path = tmp_path / "reval.chain"
        ref_save_chain(chain, path)
        return chain, path

    @staticmethod
    def _state(chain):
        accounts = (account("alice"), account("bob"))
        return (chain.tip_hash, chain.height, chain.balances_snapshot(), {a: chain.nonce(a) for a in accounts})

    @staticmethod
    def _serial_lane(m):
        """The pre-batching cost model: per-tx verifies, no windows."""
        m.setattr(keys, "BATCH_MIN", 1 << 30)
        m.setattr(store_mod, "_preverify_stream", lambda blocks, tag, cache: blocks)

    def test_batch_equals_serial_revalidation(self, tmp_path, monkeypatch):
        built, path = self._build_store(tmp_path)
        keys.STATS.reset()
        batch = ChainStore(path).load_chain(DIFF, trusted=False, sig_cache=SignatureCache())
        assert keys.STATS.backends["device"] == 72  # one window, on the device rung
        with monkeypatch.context() as m:
            self._serial_lane(m)
            serial = ChainStore(path).load_chain(DIFF, trusted=False, sig_cache=SignatureCache())
        ref = RefStore(path).load_chain(DIFF, trusted=False, sig_cache=RefCache())
        assert self._state(batch) == self._state(serial) == self._state(built) == self._state(ref)

    def test_windows_stream_by_signature_count(self, tmp_path, monkeypatch):
        _, path = self._build_store(tmp_path, n_blocks=12)
        calls = []
        real = ed25519_msm.verify_batch_device
        monkeypatch.setattr(ed25519_msm, "verify_batch_device", lambda t, **k: calls.append(len(t)) or real(t, **k))
        monkeypatch.setattr(validate_mod, "PREVERIFY_WINDOW", 16)
        ChainStore(path).load_chain(DIFF, trusted=False, sig_cache=SignatureCache())
        # Windows close at >= 16 pending signatures: six blocks of three.
        assert calls == [18, 18]

    def test_corrupt_record_same_rejection_both_lanes(self, tmp_path, monkeypatch):
        built, path = self._build_store(tmp_path, n_blocks=12)
        # One signature flipped inside the record at height 8, its CRC
        # fixed so the storage layer hands it through and VALIDATION must
        # catch it (store.py's "hostile editor, not a disk" case).
        raw = bytearray(path.read_bytes())
        target = built.get(built._main_hashes[8])
        off = raw.find(target.serialize())
        assert off > 0
        raw[raw.find(target.txs[1].sig, off)] ^= 1
        rec_off = off - 4
        (length,) = struct.unpack_from(">I", raw, rec_off)
        struct.pack_into(">I", raw, rec_off + 4 + length, zlib.crc32(raw[rec_off : rec_off + 4 + length]))
        path.write_bytes(bytes(raw))

        def load():
            return ChainStore(path).load_chain(DIFF, trusted=False, sig_cache=SignatureCache())

        batch_chain = load()
        with monkeypatch.context() as m:
            self._serial_lane(m)
            serial_chain = load()
        ref_chain = RefStore(path).load_chain(DIFF, trusted=False, sig_cache=RefCache())
        assert batch_chain.height == serial_chain.height == ref_chain.height == 8 - 1
        assert batch_chain.tip_hash == ref_chain.tip_hash

    def test_trusted_resume_is_signature_free_and_unchanged(self, tmp_path):
        built, path = self._build_store(tmp_path, n_blocks=12)
        keys.STATS.reset()
        resumed = ChainStore(path).load_chain(DIFF, trusted=True)
        assert keys.STATS.serial == keys.STATS.batched == 0
        assert self._state(resumed) == self._state(built)

    def test_untrusted_load_without_a_card_raises(self, tmp_path, monkeypatch):
        # 8 blocks of three transfers: one 24-signature window, which the
        # default rung sends to the card.  Without one the load raises; it
        # never degrades to the pure-Python rung or the plain version.
        _, path = self._build_store(tmp_path, n_blocks=8)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        keys.set_sig_backend(None)
        keys.STATS.reset()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ChainStore(path).load_chain(DIFF, trusted=False, sig_cache=SignatureCache())
        assert keys.STATS.backends["pure-python"] == 0
        assert keys.backend() == "device"


def _port_chain_block(parent, txs, ts=1) -> Block:
    """A port block of ``txs`` on ``parent``, sealed by the port's hashlib
    backend."""
    from p1_tpu_torch.core import BlockHeader, merkle_root
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    header = BlockHeader(1, parent.block_hash(), merkle_root([t.txid() for t in txs]),
                         parent.header.timestamp + ts, DIFF, 0)  # fmt: skip
    sealed = Miner(backend=get_backend("cpu", device="cpu")).search_nonce(header)
    assert sealed is not None
    return Block(sealed, tuple(txs))


def _port_funded_chain():
    """A port chain whose 'alice' can afford many transfers (mined
    rewards), as tests/test_sigbatch.py's ``_funded_chain``."""
    from p1_tpu_torch.chain import AddStatus, Chain

    chain = Chain(DIFF)
    for h in range(1, 4):
        blk = _port_chain_block(chain.tip, [Transaction.coinbase(account("alice"), h)])
        assert chain.add_block(blk).status is AddStatus.ACCEPTED
    return chain


class TestNoDoubleVerify:
    """The mempool-admission → block-connect double-verify fix, on the
    port's pool and chain."""

    def test_mempool_then_block_connect_zero_backend_calls(self):
        from p1_tpu_torch.chain import AddStatus
        from p1_tpu_torch.mempool import Mempool

        chain = _port_funded_chain()
        cache = SignatureCache()
        chain.sig_cache = cache
        pool = Mempool(
            balance_of=chain.balance,
            nonce_of=chain.nonce,
            chain_tag=chain.genesis.block_hash(),
            sig_cache=cache,
        )
        txs = [Transaction.deserialize(t.serialize()) for t in _transfers(10)]
        keys.STATS.reset()
        for tx in txs:
            assert pool.add(tx)
        admitted = keys.STATS.serial + keys.STATS.batched
        assert admitted == len(txs)  # admission paid the backend once each
        # Mine-time assembly + connect: all signatures cache-hit.
        block = _port_chain_block(
            chain.tip,
            [Transaction.coinbase(account("m"), 4), *pool.select(100)],
        )
        keys.STATS.reset()
        assert chain.add_block(block).status is AddStatus.ACCEPTED
        assert keys.STATS.serial == 0
        assert keys.STATS.batched == 0
        assert cache.hits >= len(txs)


class TestNodeValidationStatus:
    """Node-level acceptance on the port's node: a fully mempool-resident
    block connects with ZERO backend Ed25519 verifies, and status()
    exposes the counters."""

    def test_mempool_resident_block_connects_backend_free(self):
        import asyncio

        from torch_testutil import NodeConfig
        from torch_testutil import stx as port_stx

        from p1_tpu_torch.chain import AddStatus
        from p1_tpu_torch.hashx import get_backend
        from p1_tpu_torch.miner import Miner
        from p1_tpu_torch.node import Node

        miner = Miner(backend=get_backend("cpu", device="cpu"))

        async def scenario():
            node = Node(
                NodeConfig(difficulty=DIFF, mine=False, chunk=1 << 14)
            )
            await node.start()
            try:
                # Fund alice so her spends are admissible.
                import time as _time

                node.miner_id = account("alice")
                node.start_mining()
                deadline = _time.monotonic() + 20
                while node.chain.height < 3:
                    assert _time.monotonic() < deadline
                    await asyncio.sleep(0.02)
                await node.stop_mining()
                for i in range(10):
                    await node.submit_tx(
                        port_stx("alice", account("bob"), 1, 1, i, difficulty=DIFF)
                    )
                assert len(node.mempool) == 10
                block = node._assemble()
                sealed = miner.search_nonce(block.header)
                block = Block(sealed, block.txs)
                keys.STATS.reset()
                hits_before = node.sig_cache.hits
                res = await node._handle_block(block)
                assert res.status is AddStatus.ACCEPTED
                assert keys.STATS.serial == 0  # zero backend verifies
                assert keys.STATS.batched == 0
                assert node.sig_cache.hits - hits_before >= 10
                validation = node.status()["validation"]
                assert validation["hits"] >= 10
                assert validation["entries"] >= 10
                assert {"misses", "batched", "serial", "backend", "workers"} <= set(
                    validation
                )
            finally:
                await node.stop()

        asyncio.run(asyncio.wait_for(scenario(), timeout=60))
