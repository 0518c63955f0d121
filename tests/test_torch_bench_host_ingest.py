"""``p1_tpu_torch/benchmarks/host_ingest.py`` against ``benchmarks/host_ingest.py``.

The same arguments build byte-identical blocks in both packages; every
measurement of the reference runs on the port at a toy size with the
reference's keys (``bench_replay`` adds ``replay_device_hps``: one
launch of ``verify_chain.cu``, its plain version here).  Rates are held
to presence and sign only.
"""

import json

import pytest

from benchmarks import host_ingest as ref
from p1_tpu_torch.benchmarks import host_ingest as port
from p1_tpu_torch.core import keys


@pytest.fixture
def plain_rung():
    keys.set_sig_backend("device", device="cpu")
    yield
    keys.set_sig_backend(None)


def test_blocks_are_the_references():
    assert port.build_blocks(6, 2, difficulty=1)[1] == ref.build_blocks(6, 2, difficulty=1)[1]


def test_ingest_resume_and_staged_rates(tmp_path, plain_rung):
    chain, raws = port.build_blocks(10, 2, difficulty=1)
    for block in chain.main_chain():
        for tx in block.txs:
            assert tx.verify_signature()
    assert port.bench_ingest(raws, 1, repeats=1) > 0
    assert port.bench_resume(raws, 1, repeats=1, tmpdir=str(tmp_path)) > 0
    rungs = port.bench_staged_ingest(raws, 1, [1, 2], repeats=1, tmpdir=str(tmp_path))
    assert sorted(rungs) == [0, 1, 2] and min(rungs.values()) > 0


def test_replay_rows_are_the_references_and_the_device():
    got = port.bench_replay(64, repeats=1, device="cpu")
    want = ref.bench_replay(64, repeats=1)
    assert set(got) == set(want) | {"replay_device_hps"}
    assert got["replay_n"] == 64 and got["replay_method"] == want["replay_method"]
    assert min(v for k, v in got.items() if k.endswith("_hps")) > 0


def test_main_prints_the_references_line(capsys):
    args = ["--blocks", "6", "--replay-n", "32", "--repeats", "1", "--cores", "1"]
    try:
        assert port.main([*args, "--device", "cpu"]) == 0
    finally:
        keys.set_sig_backend(None)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) | {"replay_device_hps"}
    assert got["metric"] == want["metric"] and got["n_blocks"] == 6 and got["sig_backend"] == "device"
