"""``p1_tpu_torch/benchmarks/telemetry_overhead.py`` against the reference's.

The same block stream through two port nodes (telemetry off and on, the
nodes' ``device`` on the host): the reference's keys, the same stage
histograms with the same span counts, positive rates.
"""

from benchmarks import telemetry_overhead as ref
from p1_tpu_torch.benchmarks import telemetry_overhead as port
from p1_tpu_torch.core import keys


def test_quick_probe_is_the_references():
    try:
        got = port.bench_quick(blocks=8, repeats=1, device="cpu")
    finally:
        keys.set_sig_backend(None)
    want = ref.bench_quick(blocks=8, repeats=1)
    assert set(got) == set(want)
    assert {k: v["count"] for k, v in got["stages"].items()} == {k: v["count"] for k, v in want["stages"].items()}
    assert got["ingest_plain_bps"] > 0 and got["ingest_telemetry_bps"] > 0
    assert len(got["pair_ratios"]) == 1
