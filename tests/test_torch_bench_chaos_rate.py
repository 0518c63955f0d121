"""``p1_tpu_torch/benchmarks/chaos_rate.py`` against the reference's.

Two schedules sealed by the ``cuda`` backend's plain version: every
schedule's trace digest is the JAX package's ``run_chaos`` digest on the
same seed, with the same verdict and virtual seconds.
"""

from benchmarks import chaos_rate as ref
from p1_tpu.node.chaos import run_chaos
from p1_tpu_torch.benchmarks import chaos_rate as port


def test_schedules_are_the_references():
    got = port.bench_chaos(schedules=2, device="cpu")
    want = ref.bench_chaos(schedules=2)
    assert set(got) == set(want) | {"trace_digests"}
    for key in ("schedules", "nodes", "events", "ok", "virtual_s"):
        assert got[key] == want[key], key
    assert got["trace_digests"] == [run_chaos(s, nodes=5, n_events=10)["trace_digest"] for s in (0, 1)]
    assert got["ok"] and got["chaos_schedules_per_sec"] > 0
