"""``p1_tpu_torch/benchmarks/archive_scale.py`` against the reference's.

The crafted archive is byte-identical to the JAX package's; the boot
runs in a fresh ``python -m p1_tpu_torch.benchmarks.archive_scale``
process that imports no torch (its peak resident set is the figure
measured), reaching the reference's height; both packages' archives
answer the same proof bytes.  The 1M-block run is ``slow``, as the
reference's is.
"""

import hashlib
import pathlib
import time

import pytest

from benchmarks import archive_scale as ref
from p1_tpu.chain.headerplane import ArchiveChain as RefArchiveChain
from p1_tpu.node import protocol as ref_protocol
from p1_tpu_torch.benchmarks import archive_scale as port
from p1_tpu_torch.benchmarks import rss
from p1_tpu_torch.chain.headerplane import ArchiveChain
from p1_tpu_torch.node import protocol

BLOCKS = 5_000
SEGMENT = 1 << 18


def _files(store: pathlib.Path) -> dict[str, bytes]:
    d = store.with_name(store.name + ".d")
    out = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    out["archsnap"] = store.with_name(store.name + ".archsnap").read_bytes()
    return out


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    root = tmp_path_factory.mktemp("archives")
    mine, theirs = root / "port" / "archive.dat", root / "ref" / "archive.dat"
    mine.parent.mkdir()
    theirs.parent.mkdir()
    got = port.build_archive(mine, BLOCKS, SEGMENT)
    want = ref.build_archive(theirs, BLOCKS, SEGMENT)
    return mine, theirs, got, want


def test_archive_bytes_are_the_references(archives):
    mine, theirs, got, want = archives
    assert set(got) == set(want)
    for key in ("segments", "snapshot_base", "store_bytes"):
        assert got[key] == want[key], key
    assert _files(mine) == _files(theirs)


def test_boot_child_imports_no_torch(archives):
    mine, theirs = archives[:2]
    got = port.measure_boot(mine, 1, 200)
    want = ref.measure_boot(theirs, 1, 200)
    assert got.pop("torch_imported") is False
    assert set(got) == set(want) and got["height"] == want["height"] == BLOCKS - 1
    assert got["archive_boot_rss_mb"] > 0 and got["archive_query_qps"] > 0 and got["archive_proof_qps"] > 0


def test_proofs_are_the_references(archives):
    mine, theirs = archives[:2]
    a = ArchiveChain(str(mine), str(mine) + ".archsnap", 1)
    b = RefArchiveChain(str(theirs), str(theirs) + ".archsnap", 1)
    try:
        for height in (1, 2_500, BLOCKS - 1):
            txid = _coinbase_txid(height)
            got, want = a.tx_proof(txid), b.tx_proof(txid)
            assert got is not None and got.height == height
            assert protocol.encode_proof(got) == ref_protocol.encode_proof(want)
    finally:
        a.close()
        b.close()


def _coinbase_txid(height: int) -> bytes:
    """The crafted coinbase's txid at ``height`` (its seq field patched)."""
    tx, seq_off = port._tx_template(port._MINER)
    tx[seq_off : seq_off + 8] = height.to_bytes(8, "big")
    return hashlib.sha256(hashlib.sha256(bytes(tx)).digest()).digest()


def test_resume_rate(archives):
    out = port.measure_resume(archives[0])
    assert out["resume_records"] == BLOCKS and out["archive_resume_bps"] > 0


def test_peak_sampler_without_vm_hwm(monkeypatch):
    monkeypatch.setattr(rss, "vm_hwm_kb", lambda: None)
    with rss.PeakSampler() as sampler:
        block = bytearray(64 << 20)
        block[:: 1 << 12] = b"\x01" * len(block[:: 1 << 12])
        time.sleep(0.05)
        del block
    assert sampler.peak_kb() >= 60 << 10


@pytest.mark.slow
def test_archive_scale_acceptance_1m(tmp_path):
    """The reference's 1M-block acceptance shape on the port: the boot in
    a fresh process serves header/balance/proof queries far under 1 GB."""
    out = port.bench_archive(1_000_000, keep=str(tmp_path / "arch"))
    assert out["height"] == 999_999 and out["torch_imported"] is False
    assert out["archive_boot_rss_mb"] < 1024, out
    assert out["archive_query_qps"] > 1_000
    assert out["archive_proof_qps"] > 100
    assert out["archive_resume_bps"] > 10_000
