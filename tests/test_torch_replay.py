"""The port's chain replay vs the JAX package.

Mirrors ``tests/test_chain.py::TestReplay`` (``DIFF = 8``): the port mines
the chain with its ``cuda`` backend on the CPU (the kernel's plain
version) and must seal the reference's chain byte for byte; its
``replay_host`` and ``replay_device(device="cpu")`` must report the
reference's ``first_invalid`` on every corruption fixture; its plain
``verify_header_chain_segments`` must equal ``jax_sha256``'s on the same
numpy words.  Everything compared is an integer: the tolerance is exact.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import p1_tpu.chain as ref_chain
import p1_tpu.core as ref_core
from p1_tpu.core.genesis import genesis_hash as ref_genesis_hash
from p1_tpu.core.hashutil import sha256d
from p1_tpu.core.retarget import RetargetRule as RefRule
from p1_tpu.miner import Miner as RefMiner
from p1_tpu_torch.chain import (
    generate_headers,
    headers_to_words,
    pack_headers,
    pad_to_segments,
    parse_headers,
    replay_device,
    replay_host,
)
from p1_tpu_torch.core import BlockHeader, RetargetRule, genesis_hash, genesis_header
from p1_tpu_torch.hashx import get_backend, torch_sha256
from p1_tpu_torch.hashx.cuda_verify import first_invalid, verify_chain

jax = pytest.importorskip("jax")
jnp = jax.numpy

from p1_tpu.hashx import jax_sha256  # noqa: E402

DIFF = 8
N = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(headers) -> list[BlockHeader]:
    return [BlockHeader.deserialize(h.serialize()) for h in headers]


def _ref(headers) -> list:
    return [ref_core.BlockHeader.deserialize(h.serialize()) for h in headers]


@pytest.fixture(scope="module")
def backend():
    return get_backend("cuda", device="cpu")


@pytest.fixture(scope="module")
def headers(backend):
    return generate_headers(N, DIFF, backend=backend)


@pytest.fixture(scope="module")
def ref_headers():
    return ref_chain.generate_headers(N, DIFF)


def _remine(headers, i: int, parent: int) -> list:
    """Header ``i`` re-mined onto header ``parent``'s hash (reference miner)."""
    bad = _ref(headers)
    draft = dataclasses.replace(bad[i].with_nonce(0), prev_hash=bad[parent].block_hash())
    bad[i] = RefMiner(backend="cpu").search_nonce(draft)
    return _port(bad)


def _corrupt(headers, kind: str) -> list:
    bad = list(headers)
    if kind == "valid":
        pass
    elif kind.startswith("nonce"):
        i = int(kind[5:])
        bad[i] = bad[i].with_nonce(bad[i].nonce ^ 1)
    elif kind == "difficulty0":
        bad[41] = dataclasses.replace(bad[41], difficulty=0)
    elif kind == "difficulty+1":
        bad[30] = dataclasses.replace(bad[30], difficulty=DIFF + 1)
    elif kind == "reparent":
        bad = _remine(bad, 21, 19)
    elif kind == "genesis_prev":
        bad[0] = dataclasses.replace(bad[0], prev_hash=b"\x01" + bytes(31))
    elif kind == "last":
        bad[-1] = bad[-1].with_nonce(bad[-1].nonce ^ 1)
    else:
        raise KeyError(kind)
    return bad


KINDS = [
    "valid", "nonce37", "nonce15", "nonce16", "nonce23", "nonce24", "difficulty0",
    "difficulty+1", "reparent", "genesis_prev", "last",
]  # fmt: skip


def test_generate_headers_matches_reference(headers, ref_headers):
    assert [h.serialize() for h in headers] == [h.serialize() for h in ref_headers]
    assert headers[0].serialize() == ref_core.make_genesis(DIFF).header.serialize()


def test_headers_to_words_and_packing_match_reference(headers, ref_headers):
    np.testing.assert_array_equal(
        headers_to_words(headers), ref_chain.replay.headers_to_words(ref_headers)
    )
    raw = pack_headers(headers)
    assert raw == ref_chain.pack_headers(ref_headers)
    assert [h.serialize() for h in parse_headers(raw)] == [h.serialize() for h in headers]
    with pytest.raises(ValueError, match="multiple of 80"):
        parse_headers(raw[:-1])


def test_sha256d_headers_matches_hashlib():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, size=(17, 20), dtype=np.uint64).astype(np.uint32)
    digests = torch_sha256.sha256d_headers(torch.from_numpy(words.astype(np.int64)))
    for i in range(words.shape[0]):
        got = b"".join(int(d[i]).to_bytes(4, "big") for d in digests)
        assert got == sha256d(words[i].astype(">u4").tobytes())


def _words3(headers, segment: int) -> np.ndarray:
    return pad_to_segments(headers_to_words(headers), segment)


@pytest.mark.parametrize("segment", [16, 24])
@pytest.mark.parametrize("kind", ["valid", "nonce37", "nonce16", "difficulty0", "genesis_prev"])
def test_verify_segments_matches_jax(headers, segment, kind):
    words3 = _words3(_corrupt(headers, kind), segment)
    target = ref_core.target_to_words(ref_core.target_from_difficulty(DIFF))
    step = jax_sha256.jit_verify_chain_scan(words3.shape[0], segment, "cpu")
    want = np.asarray(step(jnp.asarray(words3), jnp.asarray(target, jnp.uint32), jnp.uint32(DIFF)))
    got = torch_sha256.verify_header_chain_segments(
        torch.from_numpy(words3.astype(np.int64)), torch.tensor(target), DIFF
    )
    assert got.tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("kind", KINDS)
def test_replay_matches_reference(headers, kind):
    bad = _corrupt(headers, kind)
    want_host = ref_chain.replay_host(_ref(bad))
    want_device = ref_chain.replay_device(_ref(bad), segment=16)
    assert want_host.first_invalid == want_device.first_invalid
    host = replay_host(bad)
    device = replay_device(bad, segment=16, device="cpu")
    assert host.first_invalid == device.first_invalid == want_host.first_invalid
    assert host.valid == device.valid == (kind == "valid")
    assert (host.method, device.method, device.n_headers) == ("host", "device", N)


@pytest.mark.parametrize("segment", [24, 64, 100])
def test_partial_segment_padding(headers, segment):
    # 64 headers with segment 24 -> 16 real + 8 pad; 100 -> 36 pad lanes.
    assert replay_device(headers, segment=segment, device="cpu").valid
    bad = _corrupt(headers, "last")
    assert replay_device(bad, segment=segment, device="cpu").first_invalid == N - 1


def test_first_invalid_is_the_flat_minimum(headers):
    # The kernel's contract (one flat chain, smallest failing index) equals
    # the segment scan's on the CPU, pad lanes included.
    words3 = torch.from_numpy(_words3(_corrupt(headers, "nonce37"), 24).astype(np.int64))
    target = ref_core.target_to_words(ref_core.target_from_difficulty(DIFF))
    assert first_invalid(words3, target, DIFF) == 37
    assert first_invalid(torch.from_numpy(_words3(headers, 24).astype(np.int64)), target, DIFF) == N


def test_replay_device_empty_chain_raises():
    with pytest.raises(ValueError, match="empty chain"):
        replay_device([], device="cpu")


def test_replay_device_without_card_raises(headers):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        replay_device(headers)


def test_verify_kernel_wrapper_guards():
    out = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        verify_chain(torch.zeros((4, 20), dtype=torch.int32), (0,) * 8, DIFF, out)
    with pytest.raises(ValueError, match="0 < N"):  # the empty chain
        verify_chain(torch.zeros((0, 20), dtype=torch.int32), (0,) * 8, DIFF, out)
    huge = torch.zeros((1, 20), dtype=torch.int32).expand(1 << 31, 20)  # no storage
    with pytest.raises(ValueError, match="2\\*\\*31"):
        verify_chain(huge, (0,) * 8, DIFF, out)
    assert verify_chain.launches == 0


RULE = (8, 2)  # window, spacing


def test_genesis_with_retarget_matches_reference():
    for d in (8, 16):
        for rule in (None, RULE):
            port_rule = RetargetRule(*rule) if rule else None
            ref_rule = RefRule(*rule) if rule else None
            assert (
                genesis_header(d, port_rule).serialize()
                == ref_core.make_genesis(d, ref_rule).header.serialize()
            )
            assert genesis_hash(d, port_rule) == ref_genesis_hash(d, ref_rule)


def test_retarget_rule_matches_reference():
    port_rule, ref_rule = RetargetRule(*RULE), RefRule(*RULE)
    for parent in (1, 8, 200, 255):
        for span in (0, 1, 3, 7, 14, 15, 28, 56, 1000):
            assert port_rule.adjusted(parent, span) == ref_rule.adjusted(parent, span)
    for h, p, t in ((0, 10, 10), (0, 10, 100), (1, 10, 19), (1, 10, 18), (2, 10, 11)):
        assert port_rule.timestamp_violation(h, p, t) == ref_rule.timestamp_violation(h, p, t)
    assert RetargetRule.from_params(0, 0) is None
    with pytest.raises(ValueError, match="set together"):
        RetargetRule.from_params(8, 0)


@pytest.fixture(scope="module")
def retarget_chains(backend):
    port = generate_headers(40, DIFF, backend=backend, retarget=RetargetRule(*RULE))
    ref = ref_chain.generate_headers(40, DIFF, retarget=RefRule(*RULE))
    return port, ref


def test_retargeting_chain_matches_reference(retarget_chains):
    port, ref = retarget_chains
    assert [h.serialize() for h in port] == [h.serialize() for h in ref]
    assert len({h.difficulty for h in port}) > 1  # the rule moved the difficulty


@pytest.mark.parametrize("kind", ["valid", "timestamp", "difficulty"])
def test_retargeting_replay_host_matches_reference(retarget_chains, kind):
    port = list(retarget_chains[0])
    if kind == "timestamp":
        port[20] = port[20].with_timestamp(port[19].timestamp)
    elif kind == "difficulty":
        port[16] = dataclasses.replace(port[16], difficulty=DIFF)
    want = ref_chain.replay_host(_ref(port), retarget=RefRule(*RULE))
    got = replay_host(port, retarget=RetargetRule(*RULE))
    assert (got.valid, got.first_invalid) == (want.valid, want.first_invalid)
    assert got.valid == (kind == "valid")


def _cli(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch", "replay", *args],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
        env={**os.environ, **env},
    )


def test_cli_replay_prints_reference_keys(tmp_path):
    out = tmp_path / "h.bin"
    proc = _cli("--n", "32", "--difficulty", "8", "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {"config", "n_headers", "valid", "first_invalid", "results"}
    assert (line["config"], line["n_headers"], line["valid"], line["first_invalid"]) == (
        "replay", 32, True, None,
    )  # fmt: skip
    assert [r["method"] for r in line["results"]] == ["host", "device", "device"]
    assert all(set(r) == {"method", "headers_per_sec", "elapsed_s"} for r in line["results"])
    # The written file is the reference's chain and verifies against the
    # genesis pin; the wrong difficulty pins another genesis.
    raw = out.read_bytes()
    assert raw == b"".join(h.serialize() for h in ref_chain.generate_headers(32, 8))
    ok = _cli("--verify", str(out), "--difficulty", "8", "--method", "host")
    assert ok.returncode == 0 and json.loads(ok.stdout)["valid"], ok.stderr
    wrong = _cli("--verify", str(out), "--difficulty", "9", "--method", "host")
    assert wrong.returncode == 2 and "genesis" in wrong.stderr


def test_cli_replay_refuses_what_waits_for_later_slices():
    # The native engine is in: --method native and all run (every report
    # valid); the device engine on a retargeting chain is still refused,
    # and --method all covers host + native there, as the reference does.
    for method, methods in (("native", ["native"]), ("all", ["host", "native", "device", "device"])):
        proc = _cli("--n", "4", "--method", method, "--device", "cpu")
        assert proc.returncode == 0, proc.stderr
        line = json.loads(proc.stdout)
        assert line["valid"] and [r["method"] for r in line["results"]] == methods
    proc = _cli("--n", "4", "--retarget-window", "8", "--target-spacing", "2", "--device", "cpu")
    assert proc.returncode == 2 and "fixed-difficulty" in proc.stderr
    proc = _cli("--n", "4", "--retarget-window", "8", "--target-spacing", "2", "--device", "cpu",
                "--method", "all")  # fmt: skip
    assert proc.returncode == 0, proc.stderr
    assert [r["method"] for r in json.loads(proc.stdout)["results"]] == ["host", "native"]


def test_cli_replay_without_card_fails():
    # No --device cpu and no visible card: the command must not run on the CPU.
    proc = _cli("--n", "8", "--difficulty", "8", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr
