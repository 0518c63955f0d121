"""The port's native C++ Ed25519 engine against the JAX package's, on the CPU.

Mirrors tests/test_native_ed25519.py on ``p1_tpu_torch.core._ed25519_native``
(``p1_tpu_torch/native/ed25519.cpp``, built by the port's
``hashx/native_build.py`` into ``build/p1_tpu_torch/``): the RFC 8032
vector, the corruption matrix at every position and kind, torsion crafts,
random mixes, the pinned q constant, every-position batch rejection, the
exact gate against the Python oracle, pubkey dedup, the backend ladder,
the build-absent degradation and a clean skip without a toolchain.  Every
verdict is also held against ``p1_tpu.core._ed25519_native`` (the JAX
package's engine) and the port's pure-Python rung; all comparisons are
exact.  Fixtures come from a numpy seed; keys sign with the JAX package's
``Keypair`` (RFC 8032 is deterministic, so any signer gives these bytes).
"""

import numpy as np
import pytest

from p1_tpu.core import _ed25519 as ref_py
from p1_tpu.core import _ed25519_native as ref_native
from p1_tpu.core import keys as ref_keys
from p1_tpu_torch.core import _ed25519 as py_ed
from p1_tpu_torch.core import _ed25519_native as native
from p1_tpu_torch.core import keys

KINDS = ("sig", "msg", "key", "s_range", "bad_y", "short")


@pytest.fixture
def needs_native():
    """Skip without a toolchain: decided when a test runs (the first call
    may run g++), never while the module is imported."""
    if not native.available():
        pytest.skip("no C++ toolchain / native build unavailable")


@pytest.fixture(autouse=True)
def _ladder_reset():
    keys.set_sig_backend(None)
    yield
    keys.set_sig_backend(None)


def _triples(n, salt="n"):
    """``n`` triples over five keys (seeds from a numpy seed per salt)."""
    rng = np.random.default_rng(sum(salt.encode()))
    seeds = [rng.bytes(32) for _ in range(5)]
    out = []
    for i in range(n):
        kp = ref_keys.Keypair(seeds[i % 5])
        msg = b"native-%d-%s" % (i, salt.encode())
        out.append((kp.pubkey, kp.sign(msg), msg))
    return out


def _corrupt(triple, how):
    pubkey, sig, msg = triple
    if how == "sig":
        return (pubkey, sig[:20] + bytes([sig[20] ^ 1]) + sig[21:], msg)
    if how == "msg":
        return (pubkey, sig, msg + b"!")
    if how == "key":
        return (py_ed.public_key(b"\x07" * 32), sig, msg)
    if how == "s_range":  # scalar >= group order: rejected pre-math
        return (pubkey, sig[:32] + py_ed._Q.to_bytes(32, "little"), msg)
    if how == "bad_y":  # non-canonical y >= p: decompression rejects
        return (py_ed._P.to_bytes(32, "little"), sig, msg)
    if how == "short":
        return (pubkey[:31], sig, msg)
    raise AssertionError(how)


def _torsion_triple(*, cancel: bool):
    """A signature carrying small-order torsion: cancel=True is serially
    VALID (torsion cancels), cancel=False is the craft serial rejects."""
    t_enc = ((py_ed._P - 1) if cancel else 0).to_bytes(32, "little")
    a, prefix = py_ed._secret_expand(bytes(32))
    torsion = py_ed._pt_decompress(t_enc)
    a_pt = py_ed._pt_mul(a, py_ed._B)
    pub = py_ed._pt_compress(py_ed._pt_add(a_pt, torsion) if cancel else a_pt)
    for i in range(200):
        msg = b"native-torsion-%d" % i
        r = int.from_bytes(py_ed._sha512(prefix + msg), "little") % py_ed._Q
        r_enc = py_ed._pt_compress(py_ed._pt_add(py_ed._pt_mul(r, py_ed._B), torsion))
        k = int.from_bytes(py_ed._sha512(r_enc + pub + msg), "little") % py_ed._Q
        if cancel and k % 2 == 0:
            continue
        return pub, r_enc + ((r + k * a) % py_ed._Q).to_bytes(32, "little"), msg
    raise AssertionError("no usable k in 200 tries")


def _serial(triple) -> bool:
    """The port's native verdict, held against the JAX package's native
    engine and both packages' pure-Python verifies."""
    got = native.verify(*triple)
    assert got == ref_native.verify(*triple) == py_ed.verify(*triple) == ref_py.verify(*triple), triple
    return got


def _batch(triples) -> bool:
    """The port's native batch verdict, held against the JAX package's
    native batch and the port's pure-Python batch."""
    got = native.verify_batch(triples)
    assert got == ref_native.verify_batch(triples) == py_ed.verify_batch(triples)
    return got


@pytest.mark.usefixtures("needs_native")
class TestNativeSerialParity:
    """native.verify == _ed25519.verify, input for input."""

    def test_rfc8032_vector(self):
        seed = bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
        pub = py_ed.public_key(seed)
        assert pub.hex() == "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
        sig = py_ed.sign(seed, b"")
        assert _serial((pub, sig, b""))
        assert not _serial((pub, sig, b"x"))

    @pytest.mark.parametrize("pos", range(6))
    def test_corruption_matrix_matches_serial(self, pos):
        triple = _triples(6, salt="ser")[pos]
        assert _serial(triple)
        for how in KINDS:
            assert _serial(_corrupt(triple, how)) is False, (pos, how)

    def test_torsion_crafts_identical_verdicts(self):
        # The serial rule TOLERATES cancelling torsion: the native serial
        # path must accept exactly what pure Python accepts.
        assert _serial(_torsion_triple(cancel=True))
        assert not _serial(_torsion_triple(cancel=False))

    def test_random_mixes_match(self):
        rng = np.random.default_rng(15)
        base = _triples(12, salt="mix")
        for _ in range(8):
            for t in base:
                if rng.random() < 0.3:
                    t = _corrupt(t, ("sig", "msg")[int(rng.integers(2))])
                _serial(t)


@pytest.mark.usefixtures("needs_native")
class TestNativeBatch:
    """native.verify_batch: the subgroup-gated batch contract."""

    def test_q_constant_pinned(self):
        # B has exact order q, so gate(B) is True iff the C engine's
        # transcribed scalar is exactly q; order-2 torsion gates False.
        b_enc = py_ed._pt_compress(py_ed._B)
        assert native.in_subgroup(b_enc) is True is ref_native.in_subgroup(b_enc)
        t2 = (py_ed._P - 1).to_bytes(32, "little")
        assert native.in_subgroup(t2) is False is ref_native.in_subgroup(t2)

    @pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 9, 33])
    def test_all_valid_accepts(self, n):
        assert _batch(_triples(n))

    @pytest.mark.parametrize("pos", range(10))
    def test_corruption_at_every_position_rejects(self, pos):
        base = _triples(10, salt="pos")
        for how in KINDS:
            bad = list(base)
            bad[pos] = _corrupt(bad[pos], how)
            assert not _batch(bad), (pos, how)

    def test_batch_verdicts_match_fallback(self):
        rng = np.random.default_rng(16)
        base = _triples(16, salt="eq")
        for _ in range(6):
            batch = [_corrupt(t, ("sig", "msg")[int(rng.integers(2))]) if rng.random() < 0.2 else t for t in base]
            assert _batch(batch) == all(py_ed.verify(*t) for t in batch)

    def test_torsion_gate_rejects_what_serial_tolerates(self):
        # Batch acceptance implies serial acceptance, so the batch must not
        # accept the cancelling craft serial tolerates.
        acc = _torsion_triple(cancel=True)
        assert py_ed.verify(*acc)
        assert not _batch([acc] * 8)
        assert not _batch([_torsion_triple(cancel=False)] * 8)

    def test_gate_is_exact_vs_python_oracle(self):
        rng = np.random.default_rng(25519)
        t2 = (py_ed._P - 1).to_bytes(32, "little")
        t4 = (0).to_bytes(32, "little")
        cases = [t2, t4, py_ed._pt_compress(py_ed._B)]
        for _ in range(6):
            scalar = int.from_bytes(rng.bytes(32), "little") % (py_ed._Q - 1) + 1
            honest = py_ed._pt_mul(scalar, py_ed._B)
            cases.append(py_ed._pt_compress(honest))
            for enc in (t2, t4):
                cases.append(py_ed._pt_compress(py_ed._pt_add(honest, py_ed._pt_decompress(enc))))
        for enc in cases:
            want = py_ed._in_prime_subgroup(py_ed._pt_decompress(enc))
            assert native.in_subgroup(enc) == ref_native.in_subgroup(enc) == want
        assert native.in_subgroup(py_ed._P.to_bytes(32, "little")) is None

    def test_duplicate_pubkeys_dedup_safely(self):
        tr = _triples(12, salt="dup")  # 5 unique keys by construction
        assert _batch(tr)
        bad = list(tr)
        bad[11] = _corrupt(bad[11], "sig")
        assert not _batch(bad)


class TestBackendLadder:
    """keys.py resolution with the native rung: per-backend accounting and
    the degradation when the build is absent."""

    @pytest.mark.usefixtures("needs_native")
    def test_auto_resolves_native_for_serial_work(self, monkeypatch):
        monkeypatch.delenv("P1_SIG_BACKEND", raising=False)
        assert keys.backend() == "device"  # batches stay on the card
        assert keys._serial_backend() == "native"
        keys.set_sig_backend("native")
        assert keys.backend() == "native"

    @pytest.mark.usefixtures("needs_native")
    def test_native_work_counted_per_backend(self):
        keys.set_sig_backend("native")
        tr = _triples(keys.BATCH_MIN, salt="count")
        keys.STATS.reset()
        assert keys.verify_batch(tr)
        assert keys.STATS.backends["native"] == len(tr)
        keys._neg_cache.clear()
        assert keys.verify(*tr[0])
        assert keys.STATS.backends["native"] == len(tr) + 1
        assert keys.STATS.backends["pure-python"] == 0

    @pytest.mark.usefixtures("needs_native")
    def test_first_invalid_serial_contract_on_native(self):
        keys.set_sig_backend("native")
        base = _triples(24, salt="fi")
        mixed = list(base)
        mixed[2] = _torsion_triple(cancel=True)  # gate-rejected, serially valid
        mixed[20] = _corrupt(mixed[20], "sig")
        assert not keys.verify_batch(mixed)
        assert keys.first_invalid(mixed) == ref_keys.first_invalid(mixed) == 20
        mixed[20] = base[20]
        assert keys.first_invalid(mixed) is ref_keys.first_invalid(mixed) is None

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError):
            keys.set_sig_backend("sandybridge")

    def test_build_absent_degrades_to_pure_python(self, monkeypatch, caplog):
        # With the native object unbuildable, serial work lands on the
        # pure-Python rung, a native pin warns and resolves auto, and no
        # exception escapes the seam.
        from p1_tpu_torch.hashx import native_build

        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_LOAD_FAILED", False)

        def boom(force=False):
            raise native_build.NativeBuildError("no toolchain (test)")

        monkeypatch.setattr(native_build, "build_lib", boom)
        assert native.available() is False
        assert native.load() is None  # memoized failure, no retry
        assert native.impl() is None
        with pytest.raises(RuntimeError, match="not loaded"):
            native.verify(*_triples(1, salt="absent")[0])
        assert keys._serial_backend() == "pure-python"
        with caplog.at_level("WARNING", logger="p1_tpu_torch.core.keys"):
            keys.set_sig_backend("native")
            assert keys.backend() == "device"
        assert any("'native' requested" in r.getMessage() for r in caplog.records)
        keys.set_sig_backend("native", device=None)
        keys.STATS.reset()
        tr = _triples(keys.BATCH_MIN - 1, salt="absent")
        assert keys.verify_batch(tr)  # under BATCH_MIN: serial, pure Python
        assert keys.STATS.backends["pure-python"] == len(tr)

    @pytest.mark.usefixtures("needs_native")
    def test_concurrent_first_use_loads_once(self, monkeypatch):
        # More threads than cores reach an unloaded engine together, with
        # a short switch interval: one build call, one library, and every
        # verdict right.
        import sys
        import threading

        from p1_tpu_torch.hashx import native_build

        calls = []
        real = native_build.build_lib

        def counting_build(force=False):
            calls.append(threading.get_ident())
            return real(force)

        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_LOAD_FAILED", False)
        monkeypatch.setattr(native_build, "build_lib", counting_build)
        tr = _triples(4, salt="threads")
        bad = _corrupt(tr[0], "sig")
        results = []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            cases = [bad if i % 3 == 0 else tr[i % 4] for i in range(24)]
            threads = [threading.Thread(target=lambda t=t: results.append(native.verify(*t))) for t in cases]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert len(calls) == 1
        assert sorted(results) == sorted(i % 3 != 0 for i in range(24))

    def test_build_smoke_or_clean_skip(self):
        # On a toolchain host the port's build makes a loadable object
        # carrying both engines; without one NativeBuildError surfaces
        # and the test skips.
        import ctypes

        from p1_tpu_torch.hashx import native_build

        try:
            path = native_build.build_lib()
        except native_build.NativeBuildError as exc:
            pytest.skip(f"no C++ toolchain: {exc}")
        lib = ctypes.CDLL(str(path))
        lib.p1_ed25519_impl.restype = ctypes.c_char_p
        assert lib.p1_ed25519_impl() == b"u128-radix51"
        assert lib.p1_has_shani() in (0, 1)
