"""The port's Ed25519 device path on the CPU against the JAX package.

Mirrors tests/test_ed25519_device.py.  The port's plain PyTorch version
(``p1_tpu_torch/hashx/ed25519_msm.py``: fe25519 in ten 25.5-bit limbs,
the batched point formulas, the gate and the MSM) is held, exactly, to
``p1_tpu/hashx/ed25519_msm.py``'s eager JAX functions (20 × 13-bit limbs,
``_msm_tree`` with jit disabled) and to the big-integer oracle
``p1_tpu/core/_ed25519.py`` on the same seeded inputs; the batched
decompression to both packages' ``_pt_decompress``;
``verify_batch_device(device="cpu")`` to ``p1_tpu.core._ed25519.verify_batch``
on valid, corrupt, torsion and undecodable batches.  The kernel itself (``csrc/ed25519_msm.cu``) runs only on the
card, where ``chip_smoke.py`` holds it to this plain version.  The
comparison with the JAX ``verify_batch_device`` pays a multi-minute XLA
compile and is ``slow``, as the reference's own is.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p1_tpu.core import _ed25519 as ref_ed
from p1_tpu.core import keys as ref_keys
from p1_tpu.hashx import ed25519_msm as ref_dev
from p1_tpu_torch.benchmarks import sig_verify as sv
from p1_tpu_torch.core import _ed25519 as py_ed
from p1_tpu_torch.hashx import cuda_ed25519
from p1_tpu_torch.hashx import ed25519_msm as dev

P = ref_ed._P
Q = ref_ed._Q
rng = random.Random(25519)

T2 = ref_ed._pt_decompress(sv.T2_ENC)
T4 = ref_ed._pt_decompress(sv.T4_ENC)
T8 = ref_ed._pt_decompress(sv.T8_ENC)


def _rand_fe() -> int:
    return rng.randrange(P)


def _rand_pt():
    return ref_ed._pt_mul(rng.randrange(1, Q), ref_ed._B)


def _fe(x: int) -> torch.Tensor:
    return torch.from_numpy(dev.fe_from_int(x))


def _limbs_of_value(x: int) -> torch.Tensor:
    """Non-canonical limbs of 0 ≤ x < 2^256: the top limb keeps x's bits
    above 2^255."""
    limbs = [(x >> o) & ((1 << b) - 1) for o, b in zip(dev.LIMB_OFFSETS, dev.LIMB_BITS)]
    limbs[9] += (x >> 255) << 25
    return torch.tensor(limbs, dtype=torch.int64)


def _pt_tensor(points) -> torch.Tensor:
    """Points fed to the port through the JAX package's own encoding."""
    ref = np.stack([ref_dev._encode_point(p) for p in points])
    return torch.from_numpy(dev.from_reference_point(ref))


def _triples(n, salt=b"d"):
    """Signed with the JAX package's keys (the wheel where installed);
    RFC 8032 signatures are deterministic, so the port signs the same."""
    out = []
    for i in range(n):
        kp = ref_keys.Keypair(bytes([i % 5]) * 31 + bytes([len(salt) % 256]))
        msg = b"dev-%d-" % i + salt
        out.append((kp.pubkey, kp.sign(msg), msg))
    return out


def _corrupt(triple):
    pub, sig, msg = triple
    return pub, sig[:20] + bytes([sig[20] ^ 1]) + sig[21:], msg


class TestOracleCopy:
    """``p1_tpu_torch.core._ed25519`` is the reference's, byte for byte."""

    @pytest.mark.parametrize("seed", [bytes(32), bytes(range(32)), b"\xff" * 32])
    def test_keys_and_signatures_equal(self, seed):
        assert py_ed.public_key(seed) == ref_ed.public_key(seed)
        for msg in (b"", b"x", b"p1" * 40):
            sig = py_ed.sign(seed, msg)
            assert sig == ref_ed.sign(seed, msg)
            assert py_ed.verify(py_ed.public_key(seed), sig, msg)
            assert not py_ed.verify(py_ed.public_key(seed), sig, msg + b"!")

    def test_constants_equal(self):
        assert (py_ed._P, py_ed._Q, py_ed._D, py_ed._B) == (ref_ed._P, ref_ed._Q, ref_ed._D, ref_ed._B)
        # The recorded pure-Python costs are the port's own (the card's
        # host's, named by keys.py's fallback warning), never the reference's.
        mine = (py_ed.RECORDED_SERIAL_MS, py_ed.RECORDED_BATCH_MS)
        assert min(mine) > 0 and mine != (ref_ed.RECORDED_SERIAL_MS, ref_ed.RECORDED_BATCH_MS)

    def test_small_order_points(self):
        for pt, order in ((T2, 2), (T4, 4), (T8, 8)):
            assert py_ed._pt_equal(py_ed._pt_mul(order, pt), py_ed._IDENT)
            assert not py_ed._pt_equal(py_ed._pt_mul(order // 2, pt), py_ed._IDENT)
            assert not py_ed._in_prime_subgroup(pt)


class TestFieldArithmetic:
    """fe25519 limbs vs the JAX limbs and the big-int oracle, exactly."""

    @pytest.mark.parametrize("x", [0, 1, 19, P - 1, (1 << 255) - 20, P + 5])
    def test_roundtrip(self, x):
        assert dev.fe_to_int(dev.fe_from_int(x)) == x % P

    @pytest.mark.parametrize("trial", range(8))
    def test_ops_match_jax_and_oracle(self, trial):
        a, b = _rand_fe(), _rand_fe()
        ja, jb = jnp.asarray(ref_dev.fe_from_int(a)), jnp.asarray(ref_dev.fe_from_int(b))
        fa, fb = _fe(a), _fe(b)
        for ours, theirs, want in (
            (dev.fe_mul(fa, fb), ref_dev.fe_mul(ja, jb), a * b),
            (dev.fe_sq(fa), ref_dev.fe_sq(ja), a * a),
            (dev.fe_add(fa, fb), ref_dev.fe_add(ja, jb), a + b),
            (dev.fe_sub(fa, fb), ref_dev.fe_sub(ja, jb), a - b),
        ):
            assert dev.fe_to_int(ours) == ref_dev.fe_to_int(np.asarray(theirs)) == want % P

    @pytest.mark.parametrize("trial", range(4))
    def test_composed_ops(self, trial):
        a, b, c = _rand_fe(), _rand_fe(), _rand_fe()
        fa, fb, fc = _fe(a), _fe(b), _fe(c)
        got = dev.fe_sub(dev.fe_mul(fa, fb), dev.fe_sq(fc))
        assert dev.fe_to_int(got) == (a * b - c * c) % P
        got2 = dev.fe_mul(dev.fe_sub(dev.fe_add(fa, fb), fc), fb)
        assert dev.fe_to_int(got2) == (a + b - c) * b % P

    @pytest.mark.parametrize(
        "x", [0, 1, 18, 19, P - 1, P, P + 1, 2 * P - 1, (1 << 255) - 1, 1 << 255, (1 << 255) + 18]
    )
    def test_canon_edges(self, x):
        got = dev.fe_canon(_limbs_of_value(x))
        assert got.tolist() == dev.fe_from_int(x).tolist()
        want = ref_dev.fe_canon(jnp.asarray(ref_dev.fe_from_int(x % P)))
        assert dev.fe_to_int(got) == ref_dev.fe_to_int(np.asarray(want)) == x % P

    @pytest.mark.parametrize("x", [1, 19, P - 1, P >> 1])
    def test_canon_of_negative_values(self, x):
        got = dev.fe_canon(-_fe(x))
        assert got.tolist() == dev.fe_from_int(-x).tolist()
        assert bool(dev.fe_is_zero(dev.fe_add(_fe(x), -_fe(x))))

    @pytest.mark.parametrize("terms", [(4, 4), (3, 4), (2, 2), (2, 1)])
    @pytest.mark.parametrize("sign", [1, -1])
    def test_widest_operands(self, sign, terms):
        # Carried values summed, at their extreme limbs: four a side is the
        # widest operand the point formulas give fe_mul (the column bound
        # of the module docstring).  The kernel's shapes: a doubling's
        # f = 2zz + aa − bb by e = h − ss (4 by 3); an addition's
        # (Y1 ± X1)·(Y2 ± X2) and Z1·2Z2 (2 by 2); a table row's T1·2dT2
        # and the cached 2Z by a carried value (2 by 1).
        def widest(n):
            return torch.tensor([sign * (n << (b - 1)) for b in dev.LIMB_BITS], dtype=torch.int64)

        f, g = widest(terms[0]), widest(terms[1])
        prod = dev.fe_mul(f, g)
        assert dev.fe_to_int(prod) == dev.fe_to_int(f) * dev.fe_to_int(g) % P
        assert all(abs(int(x)) <= (1 << (b - 1)) + (1 << 16) for x, b in zip(prod, dev.LIMB_BITS))
        assert dev.fe_canon(f).tolist() == dev.fe_from_int(dev.fe_to_int(f)).tolist()

    def test_batched_axes(self):
        ints = [_rand_fe() for _ in range(4)]
        batch = torch.stack([_fe(x) for x in ints])
        prod = dev.fe_mul(batch, batch)
        for i, x in enumerate(ints):
            assert dev.fe_to_int(prod[i]) == x * x % P

    @pytest.mark.parametrize("trial", range(3))
    def test_reference_point_limbs_roundtrip(self, trial):
        pt = _rand_pt()
        ref = ref_dev._encode_point(pt)
        ours = dev.from_reference_point(ref)
        assert dev.decode_point(ours) == pt
        assert np.array_equal(dev.to_reference_point(ours), ref)
        assert np.array_equal(ours, dev.encode_points([pt])[0])


class TestPointArithmetic:
    @pytest.mark.parametrize("trial", range(5))
    def test_add_double_parity(self, trial):
        p1, p2 = _rand_pt(), _rand_pt()
        jp = jnp.asarray(ref_dev._encode_point(p1)[None])
        jq = jnp.asarray(ref_dev._encode_point(p2)[None])
        ours = dev.ge_add(_pt_tensor([p1]), _pt_tensor([p2]))[0]
        theirs = ref_dev._decode_point(np.asarray(ref_dev.ge_add(jp, jq))[0])
        assert ref_ed._pt_equal(dev.decode_point(ours), theirs)
        assert ref_ed._pt_equal(theirs, ref_ed._pt_add(p1, p2))
        ours_d = dev.ge_double(_pt_tensor([p1]))[0]
        theirs_d = ref_dev._decode_point(np.asarray(ref_dev.ge_double(jp))[0])
        assert ref_ed._pt_equal(dev.decode_point(ours_d), theirs_d)
        assert ref_ed._pt_equal(theirs_d, ref_ed._pt_double(p1))

    def test_identity_and_torsion_points(self):
        pts = [ref_ed._B, T2, T4, T8, ref_ed._IDENT]
        ident = dev.ge_identity((len(pts),))
        got = dev.ge_add(_pt_tensor(pts), ident)
        for i, pt in enumerate(pts):
            assert ref_ed._pt_equal(dev.decode_point(got[i]), pt)
        assert dev.ge_is_identity(ident).all()
        flags = dev.ge_is_identity(_pt_tensor(pts)).tolist()
        jflags = [bool(ref_dev.ge_is_identity(jnp.asarray(ref_dev._encode_point(p)[None]))[0]) for p in pts]
        assert flags == jflags == [False, False, False, False, True]


def _decode_gate_msm(points, scalars):
    """The plain version on the encodings of ``points``."""
    encodings = dev.encode_encodings([ref_ed._pt_compress(p) for p in points])
    return dev.plain_decode_gate_msm(
        torch.from_numpy(encodings.view(np.int32)),
        torch.from_numpy(dev.encode_scalars(scalars).view(np.int32)),
    )


def _words(encodings) -> torch.Tensor:
    return torch.from_numpy(dev.encode_encodings(encodings).astype(np.int64))


class TestGateAndMsm:
    """The plain gate and MSM against ``_in_prime_subgroup`` and
    ``_pt_mul`` sums, torsion points included."""

    def test_gate_is_exact_on_torsion(self):
        honest = _rand_pt()
        pts = [honest, ref_ed._IDENT, T2, T4, T8,
               ref_ed._pt_add(honest, T2), ref_ed._pt_add(honest, T4), ref_ed._pt_add(honest, T8)]  # fmt: skip
        out = _decode_gate_msm(pts, [1] * len(pts))
        want = [ref_ed._in_prime_subgroup(p) for p in pts]
        assert out.flags.tolist() == [1 | 2 * w for w in want] == [3, 3, 1, 1, 1, 1, 1, 1]
        assert int(out.result[0]) == 0

    def test_msm_matches_pt_mul_sums(self):
        pts = [_rand_pt(), _rand_pt(), T8, ref_ed._IDENT, _rand_pt()]
        scalars = [0, 1, Q - 1, rng.getrandbits(128), rng.getrandbits(253)]
        out = _decode_gate_msm(pts, scalars)
        want = ref_ed._IDENT
        for s, p in zip(scalars, pts):
            want = ref_ed._pt_add(want, ref_ed._pt_mul(s, p))
        assert ref_ed._pt_equal(dev.decode_point(out.result[1:]), want)
        assert out.flags.tolist() == [3, 3, 1, 3, 3]

    def test_all_ok_flag(self):
        out = _decode_gate_msm([_rand_pt(), ref_ed._IDENT], [3, 5])
        assert int(out.result[0]) == 1

    @pytest.mark.parametrize("n", [1, 2, 3, 5])
    def test_tree_sum_any_count(self, n):
        pts = [_rand_pt() for _ in range(n)]
        want = ref_ed._IDENT
        for p in pts:
            want = ref_ed._pt_add(want, p)
        assert ref_ed._pt_equal(dev.decode_point(dev.tree_sum(_pt_tensor(pts))), want)

    def test_digits_match_reference(self):
        scalars = [0, 1, Q - 1, Q, rng.getrandbits(256)]
        words = torch.from_numpy(dev.encode_scalars(scalars).astype(np.int64))
        got = dev.digits_of_words(words)
        for row, s in zip(got.tolist(), scalars):
            assert row == ref_dev._digits_of(s).tolist()
        assert dev.digits_of_words(torch.tensor([dev.Q_WORDS]))[0].tolist() == ref_dev._Q_DIGITS.tolist()

    def test_msm_horner_matches_jax_msm_tree(self):
        # The JAX package's _msm_tree on CPU JAX (jit off: its scan runs as
        # a Python loop), on three points padded to a power of two as its
        # callers pad (an identity point, a zero scalar); 4-bit windows of
        # 16-bit scalars as its own test keeps the run short.  Compared in
        # canonical value, through the JAX package's limbs.
        pts = [_rand_pt(), _rand_pt(), T8]
        scalars = [rng.randrange(1, 16**4) for _ in pts]
        rows = np.array([[(s >> (4 * w)) & 15 for s in scalars + [0]] for w in reversed(range(4))],
                        dtype=np.uint32)  # fmt: skip
        jpts = np.stack([ref_dev._encode_point(p) for p in pts + [ref_ed._IDENT]])
        with jax.disable_jit():
            theirs = np.asarray(ref_dev._msm_tree(jnp.asarray(jpts), jnp.asarray(rows)))
        table = dev.point_table(torch.from_numpy(dev.from_reference_point(jpts[:3])))
        ours = dev.msm_horner(table, torch.from_numpy(rows.T[:3].astype(np.int64)))
        want = ref_ed._IDENT
        for s, p in zip(scalars, pts):
            want = ref_ed._pt_add(want, ref_ed._pt_mul(s, p))
        assert ref_ed._pt_equal(ref_dev._decode_point(theirs), want)
        ours_ref = dev.to_reference_point(ours.numpy())
        assert ref_ed._pt_equal(ref_dev._decode_point(ours_ref), want)
        assert np.array_equal(dev.from_reference_point(ours_ref), dev.fe_canon(ours).numpy())

    @pytest.mark.parametrize("scalar", [0, 1, Q - 1, Q])
    def test_windows_on_the_shared_table(self, scalar):
        # One table serves the gate (q's windows) and the MSM (each
        # scalar's): scalar_mul_windows on it is the oracle's [s]P.
        pts = [_rand_pt(), T4, ref_ed._pt_add(_rand_pt(), T2)]
        table = dev.point_table(_pt_tensor(pts))
        words = torch.from_numpy(dev.encode_scalars([scalar] * len(pts)).astype(np.int64))
        got = dev.scalar_mul_windows(table, dev.digits_of_words(words))
        for i, p in enumerate(pts):
            assert ref_ed._pt_equal(dev.decode_point(got[i]), ref_ed._pt_mul(scalar, p))


#: Crafted encodings: y = 0, 1 and p − 1 with and without the sign, a y
#: that is no square's (undecodable), the small-order points, y = p and
#: y = 2^255 − 1 (≥ p), and x = 0 with the sign set.
CRAFTED = {
    "y=0": bytes(32),
    "y=0 sign": (1 << 255).to_bytes(32, "little"),
    "y=1": (1).to_bytes(32, "little"),
    "y=1 sign": (1 | 1 << 255).to_bytes(32, "little"),
    "y=p-1": (P - 1).to_bytes(32, "little"),
    "y=p-1 sign": (P - 1 | 1 << 255).to_bytes(32, "little"),
    "non-square y=2": (2).to_bytes(32, "little"),
    "order 2": sv.T2_ENC,
    "order 4": sv.T4_ENC,
    "order 8": sv.T8_ENC,
    "y=p": P.to_bytes(32, "little"),
    "y=2^255-1": ((1 << 255) - 1).to_bytes(32, "little"),
}


class TestDecompression:
    """The batched plain decompression against both packages'
    ``_pt_decompress``: limbs equal, undecodable where they return None."""

    @staticmethod
    def _check(encodings):
        points, decodes = dev.decompress(_words(encodings))
        for i, enc in enumerate(encodings):
            want = py_ed._pt_decompress(enc)
            assert want == ref_ed._pt_decompress(enc)
            assert bool(decodes[i]) is (want is not None), enc.hex()
            expect = dev.encode_points([want if want is not None else ref_ed._IDENT])[0]
            assert points[i].tolist() == expect.tolist(), enc.hex()

    @pytest.mark.parametrize("name", list(CRAFTED))
    def test_crafted(self, name):
        self._check([CRAFTED[name]])

    @pytest.mark.parametrize("trial", range(3))
    def test_random_points_and_bytes(self, trial):
        r = random.Random(trial)
        pts = [ref_ed._pt_mul(r.randrange(1, Q), ref_ed._B) for _ in range(4)]
        encs = [ref_ed._pt_compress(p) for p in pts] + [r.randbytes(32) for _ in range(4)]
        self._check(encs + [ref_ed._pt_compress(ref_ed._pt_add(pts[0], T8))])

    def test_pow22523(self):
        zs = [1, 2, P - 1, _rand_fe(), _rand_fe()]
        got = dev.fe_pow22523(torch.stack([_fe(z) for z in zs]))
        assert [dev.fe_to_int(row) for row in got] == [pow(z, (P - 5) // 8, P) for z in zs]

    def test_limbs_of_words_drop_the_sign(self):
        y = rng.randrange(P)
        got = dev.limbs_of_words(_words([(y | 1 << 255).to_bytes(32, "little")]))[0]
        assert got.tolist() == dev.fe_from_int(y).tolist()


class TestHostSideRejects:
    """Malformed inputs settle on the host: no device stage, no launch."""

    @pytest.fixture
    def no_device_stage(self, monkeypatch):
        def fail(*args):
            raise AssertionError("a host reject reached the device stage")

        monkeypatch.setattr(cuda_ed25519, "decode_gate_msm", fail)

    @pytest.mark.parametrize("case", ["short key", "short sig", "s = q", "bad A", "bad R"])
    def test_early_falses(self, case, no_device_stage):
        pub, sig, msg = _triples(2)[0]
        bad = {
            "short key": (pub[:31], sig, msg),
            "short sig": (pub, sig[:63], msg),
            "s = q": (pub, sig[:32] + Q.to_bytes(32, "little"), msg),
            "bad A": (P.to_bytes(32, "little"), sig, msg),
            "bad R": (pub, P.to_bytes(32, "little") + sig[32:], msg),
        }[case]
        launches = cuda_ed25519.ed25519_msm.launches
        assert dev.verify_batch_device([_triples(2)[1], bad], device="cpu") is False
        assert ref_dev.verify_batch_device([bad]) is False
        assert cuda_ed25519.ed25519_msm.launches == launches

    def test_empty_batch_is_true(self, no_device_stage):
        assert dev.verify_batch_device([]) is True

    def test_no_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dev.verify_batch_device(_triples(2))
        with pytest.raises(ValueError):
            dev.verify_batch_device(_triples(2), device="meta")

    def test_seeded_coefficients_reproduce(self):
        tr = _triples(6)
        a = dev.prepare(tr, random.Random(7))
        b = dev.prepare(tr, random.Random(7))
        assert np.array_equal(a.scalars, b.scalars) and np.array_equal(a.encodings, b.encodings)
        assert a.encodings.shape == (5 + 6 + 1, 8)  # 5 unique keys + 6 R + B
        assert not np.array_equal(a.scalars, dev.prepare(tr).scalars)


class TestBasePointInTheBatch:
    """The base point rides in the batch: ``prepare`` decompresses
    nothing, ``close`` multiplies nothing."""

    def test_prepare_appends_b_with_its_coefficient(self):
        tr = _triples(5, salt=b"base")
        r = random.Random(11)
        prep = dev.prepare(tr, random.Random(11))
        s_total = 0
        for _, sig, _ in tr:
            s_total = (s_total + (r.getrandbits(128) | 1) * int.from_bytes(sig[32:], "little")) % Q
        assert prep.encodings[-1].tobytes() == ref_ed._pt_compress(ref_ed._B) == dev.B_ENC
        assert int.from_bytes(prep.scalars[-1].tobytes(), "little") == (Q - s_total) % Q
        for i, (pub, sig, _) in enumerate(tr):  # unique keys, then each R after its key
            assert sig[:32] in {row.tobytes() for row in prep.encodings}
            assert pub in {row.tobytes() for row in prep.encodings}

    def test_no_host_decompression_or_scalar_multiplication(self, monkeypatch):
        from p1_tpu_torch.core import _ed25519 as port_ed

        def fail(*args):
            raise AssertionError("host big-integer point work in the device path")

        tr = _triples(6, salt=b"nohost")
        bad = list(tr)
        bad[2] = _corrupt(bad[2])
        monkeypatch.setattr(port_ed, "_pt_decompress", fail)
        monkeypatch.setattr(port_ed, "_pt_mul", fail)
        assert dev.verify_batch_device(tr, device="cpu") is True
        assert dev.verify_batch_device(bad, device="cpu") is False

    @pytest.mark.parametrize("ok,point", [(1, "identity"), (1, "base"), (0, "identity")])
    def test_close_is_the_flag_and_the_identity(self, ok, point):
        pt = {"identity": ref_ed._IDENT, "base": ref_ed._B}[point]
        scaled = tuple(c * 7 % P for c in pt)  # another representative
        result = np.concatenate([[ok], dev.encode_points([scaled]).reshape(-1)])
        assert dev.close(result) is (ok == 1 and point == "identity")

    def test_undecodable_r_reaches_the_device_and_fails(self, monkeypatch):
        # An R with y < p that is no point: the host passes it on, the
        # device stage's decompression clears its flag.
        tr = _triples(4, salt=b"undecodable")
        pub, sig, msg = tr[1]
        y = next(y for y in range(2, 100) if py_ed._recover_x(y, 0) is None)
        tr[1] = (pub, y.to_bytes(32, "little") + sig[32:], msg)
        calls = []
        real = cuda_ed25519.decode_gate_msm
        monkeypatch.setattr(cuda_ed25519, "decode_gate_msm", lambda e, s: calls.append(len(e)) or real(e, s))
        assert dev.verify_batch_device(tr, device="cpu") is ref_ed.verify_batch(tr) is False
        assert calls == [4 + 4 + 1]


class TestVerdictParity:
    """``verify_batch_device(device="cpu")`` against the pure-Python batch
    of the JAX package on the same triples."""

    N = 12

    def test_valid(self):
        tr = _triples(self.N, salt=b"e2e")
        assert dev.verify_batch_device(tr, device="cpu") is ref_ed.verify_batch(tr) is True

    @pytest.mark.parametrize("pos", [0, N // 2, N - 1])
    def test_corrupt_first_middle_last(self, pos):
        tr = _triples(self.N, salt=b"e2e")
        tr[pos] = _corrupt(tr[pos])
        assert dev.verify_batch_device(tr, device="cpu") is ref_ed.verify_batch(tr) is False

    @pytest.mark.parametrize("cancel", [True, False])
    def test_torsion_fixtures(self, cancel):
        crafted = sv.torsion_triple(cancel=cancel)
        assert ref_ed.verify(*crafted) is cancel
        tr = _triples(self.N - 1, salt=b"tors") + [crafted]
        assert dev.verify_batch_device(tr, device="cpu") is ref_ed.verify_batch(tr) is False

    @pytest.mark.slow
    def test_against_jax_verify_batch_device(self):
        tr = _triples(self.N, salt=b"jax")
        bad = list(tr)
        bad[3] = _corrupt(bad[3])
        tors = _triples(self.N - 1, salt=b"jt") + [sv.torsion_triple(cancel=True)]
        for batch in (tr, bad, tors):
            assert dev.verify_batch_device(batch, device="cpu") is ref_dev.verify_batch_device(batch)
