"""``p1_tpu_torch/benchmarks/maintenance_cadence.py`` against the reference's.

The probe's shape decides the rebase's dropped blocks and freed bytes and
the incremental build's chunk reuse: both packages give the same; the
rates are held to sign (``tests/test_torch_maintenance.py``'s
``TestCadenceBench`` holds the probe to the port's pins).
"""

from benchmarks import maintenance_cadence as ref
from p1_tpu_torch.benchmarks import maintenance_cadence as port

SHAPE = {"accounts": 3_000, "delta": 16, "blocks": 64}


def test_quick_probe_is_the_references():
    got, want = port.bench_quick(**SHAPE), ref.bench_quick(**SHAPE)
    assert set(got) == set(want)
    for key in ("accounts", "delta_accounts", "snapshot_chunks_reused", "snapshot_chunks_total",
                "rebase_blocks", "rebase_dropped_blocks", "rebase_freed_bytes"):  # fmt: skip
        assert got[key] == want[key], key
    assert got["snapshot_incr_builds_per_sec"] > 0 and got["rebase_ms"] > 0


def test_main_prints_one_line(capsys):
    assert port.main(["--accounts", "2000", "--repeats", "1", "--blocks", "48"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"rebase_dropped_blocks"' in lines[0]
