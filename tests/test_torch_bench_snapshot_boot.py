"""``p1_tpu_torch/benchmarks/snapshot_boot.py`` against the reference's.

The mined store is byte-identical to the JAX package's; the three boots
(untrusted on the ``device`` rung's plain version, trusted, snapshot)
report the reference's keys and its height and snapshot figures.
"""

import pytest

from benchmarks import snapshot_boot as ref
from p1_tpu_torch.benchmarks import snapshot_boot as port
from p1_tpu_torch.core import keys


@pytest.fixture
def plain_rung():
    keys.set_sig_backend("device", device="cpu")
    yield
    keys.set_sig_backend(None)


def test_store_and_boots_are_the_references(tmp_path, plain_rung):
    mine, theirs = tmp_path / "port.dat", tmp_path / "ref.dat"
    port.build_store(mine, 300, accounts=40, tx_every=20)
    ref.build_store(theirs, 300, accounts=40, tx_every=20)
    assert mine.read_bytes() == theirs.read_bytes()
    got, want = port.bench_store(mine), ref.bench_store(theirs)
    assert set(got) == set(want)
    for key in ("height", "snapshot_height", "snapshot_accounts", "snapshot_bytes"):
        assert got[key] == want[key], key
    assert got["snapshot_boot_s"] > 0 and got["revalidate_boot_s"] > 0


def test_quick_probe(plain_rung):
    out = port.bench_quick(blocks=300, repeats=1)
    assert out["height"] == 300 and out["snapshot_boot_s"] > 0
