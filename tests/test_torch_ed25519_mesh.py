"""The port's sharded signature MSM vs the JAX package's.

Mirrors tests/test_ed25519_device.py's ``TestDeviceVerifyEndToEnd``.  The
port's ``verify_batch_device`` cuts a batch into one contiguous slice per
mesh slot (``ed25519_msm.split``/``run_mesh``), runs each slice on its
slot and adds the partial sums on the host.  Here the slots lie on the
CPU (the plain version; 1 slot, and 8 as the 8 virtual CPU devices that
tests/conftest.py gives the JAX side), and every verdict is held to
``p1_tpu.hashx.ed25519_msm.verify_batch_device(tr, n_devices=8)`` and
``n_devices=1`` and to ``p1_tpu.core._ed25519.verify_batch`` on the same
triples: valid, a bad signature in each slot, the torsion crafts.  The
JAX side pays one XLA compile per mesh size (~35-45 s each on an 8-CPU
host, hardly less at smaller batches); every fixture has one shape per
mesh size, so it pays them once.  The kernels'
split runs on the card in chip_smoke.py's ``multichip`` phase.
"""

import numpy as np
import pytest

from p1_tpu.core import _ed25519 as ref_ed
from p1_tpu.core import keys as ref_keys
from p1_tpu.hashx import ed25519_msm as ref_dev
from p1_tpu_torch.benchmarks import sig_verify as sv
from p1_tpu_torch.core import keys
from p1_tpu_torch.hashx import cuda_ed25519
from p1_tpu_torch.hashx import ed25519_msm as dev
from p1_tpu_torch.hashx.sharded import make_mesh

#: 17 triples of 5 keys: 5 + 17 + 1 = 23 points, slices of 3 on 8 slots,
#: so every slot holds an R (slot 7: one R, B and one padding point).  The
#: JAX side pads 22 points to 4 a device on 8 devices and 32 on one; the
#: torsion batch (a sixth key) keeps those shapes.
N = 17
SLOTS = (1, 8)


def _triples(n, salt=b"mesh"):
    """Signed with the JAX package's keys, carried into the port by bytes."""
    out = []
    for i in range(n):
        kp = ref_keys.Keypair(bytes([i % 5]) * 31 + bytes([len(salt) % 256]))
        msg = b"mesh-%d-" % i + salt
        out.append((kp.pubkey, kp.sign(msg), msg))
    return out


def _mesh(slots: int):
    return make_mesh(slots, device="cpu", slots_per_device=slots, across_processes=False)


def _slot_of_r(tr, i: int, slots: int) -> int:
    """The slot that holds triple ``i``'s R once ``prepare`` has laid the
    batch out (each key before its first R, then that R; B last)."""
    prep = dev.prepare(tr)
    row = i + len({pub for pub, _, _ in tr[: i + 1]})
    assert prep.encodings[row].tobytes() == tr[i][1][:32]
    return row // -(-len(prep.encodings) // slots)


def _verdicts(batch) -> dict:
    out = {f"port{s}": dev.verify_batch_device(batch, mesh=_mesh(s)) for s in SLOTS}
    out.update({f"jax{s}": ref_dev.verify_batch_device(batch, n_devices=s) for s in SLOTS})
    out["serial_batch"] = ref_ed.verify_batch(batch)
    return out


class TestSplit:
    def test_slices_padding_and_base_point(self):
        prep = dev.prepare(_triples(N))
        assert len(prep.encodings) == 23
        parts = dev.split(prep, 8)
        assert [len(p.encodings) for p in parts] == [3] * 8
        flat = np.concatenate([p.encodings for p in parts])
        assert np.array_equal(flat[:23], prep.encodings)
        assert all(row.tobytes() == dev.IDENTITY_ENC for row in flat[23:])
        assert not np.concatenate([p.scalars for p in parts])[23:].any()
        # B, the last real point, lies in exactly one slice.
        assert sum(row.tobytes() == dev.B_ENC for p in parts for row in p.encodings) == 1
        assert dev.split(prep, 1)[0].encodings.shape == prep.encodings.shape

    def test_slices_without_a_real_point_are_not_launched(self, monkeypatch):
        calls = []
        real = cuda_ed25519.decode_gate_msm
        monkeypatch.setattr(cuda_ed25519, "decode_gate_msm", lambda e, s: calls.append(len(e)) or real(e, s))
        one = _triples(1, salt=b"one")  # A, R and B: three points on 8 slots
        assert dev.verify_batch_device(one, mesh=_mesh(8)) is True
        assert calls == [1, 1, 1]
        calls.clear()
        assert [len(p.encodings) for p in dev.split(dev.prepare(one), 64)] == [1, 1, 1]
        assert dev.verify_batch_device(one, device="cpu") is True
        assert calls == [3]  # the default mesh: one launch

    def test_identity_padding_adds_nothing(self):
        # A slice of padding alone decodes, passes the gate, sums to O.
        pad = dev.Prepared(dev.encode_encodings([dev.IDENTITY_ENC] * 3), dev.encode_scalars([0, 1, 5]))
        out = cuda_ed25519.decode_gate_msm(*dev.to_device(pad, "cpu"))
        assert dev.close(out.result.numpy()) is True
        assert out.flags.tolist() == [dev.FLAGS_OK] * 3

    def test_the_msm_mesh_is_local(self):
        mesh = _mesh(2)
        mesh.group = object()  # as a mesh across processes would carry
        with pytest.raises(ValueError, match="one process"):
            dev.run_mesh(dev.prepare(_triples(2)), mesh)


class TestDeviceVerifyEndToEnd:
    """Verdict parity at 1 and 8 slots with the JAX package's device
    verify at 1 and 8 devices and its pure-Python batch."""

    def test_valid(self):
        assert set(_verdicts(_triples(N)).values()) == {True}

    @pytest.mark.parametrize("slot", range(8))
    def test_bad_signature_in_each_slot(self, slot):
        tr = _triples(N)
        i = next(i for i in range(N) if _slot_of_r(tr, i, 8) == slot)
        pub, sig, msg = tr[i]
        # Another signature's R: a valid point, so the slot's gate and
        # flags pass and only the sum of the partials can catch it.
        other = tr[(i + 1) % N][1][:32]
        tr[i] = (pub, other + sig[32:], msg)
        assert _slot_of_r(tr, i, 8) == slot
        assert set(_verdicts(tr).values()) == {False}

    def test_wrong_message(self):
        tr = _triples(N)
        pub, sig, msg = tr[3]
        tr[3] = (pub, sig, msg + b"!")
        assert set(_verdicts(tr).values()) == {False}

    @pytest.mark.parametrize("cancel", [True, False])
    def test_torsion_fixture_parity(self, cancel):
        crafted = sv.torsion_triple(cancel=cancel)
        assert ref_ed.verify(*crafted) is cancel
        batch = _triples(N - 1, salt=b"tors") + [crafted]
        # Gate-rejected even where serially valid, exactly the fallback.
        assert set(_verdicts(batch).values()) == {False}

    def test_keys_device_backend_routing(self):
        try:
            keys.set_sig_backend("device", device="cpu")
            assert keys.backend() == "device"
            tr = _triples(12, salt=b"route")
            keys.STATS.reset()
            assert keys.verify_batch(tr)
            assert keys.STATS.backends["device"] == len(tr)
            # serial work under a device override keeps the host ladder
            keys._neg_cache.clear()
            assert keys.verify(*tr[0])
            assert keys.STATS.backends["device"] == len(tr)
            # first_invalid settles serially: the reference's contract
            bad = list(tr)
            pub, sig, msg = bad[7]
            bad[7] = (pub, sig[:20] + bytes([sig[20] ^ 1]) + sig[21:], msg)
            assert not keys.verify_batch(bad)
            assert keys.first_invalid(bad) == 7 == ref_keys.first_invalid(bad)
        finally:
            keys.set_sig_backend(None)
