"""The port's ``bench`` (``p1_tpu_torch/bench.py``) against the root ``bench.py``.

The reference's output keys are read from its source by ``ast`` (the
dict literal it prints and every ``extra["..."]`` subscript), so the set
follows the reference without a copy here.  The port's line must carry
the same keys but the one rename (``xla_hps`` is ``torch_hps``: the
plain PyTorch search beside the kernel), every key but the card's own
(``bench.CARD_ONLY_KEYS``) on the CPU.  ``measure`` runs here with
``--device cpu`` and the planes cut to toy shapes; every pin is pushed
past its guard so each ``*_degraded`` flag shows.  The whole command at
its real shapes is the ``slow`` test.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from p1_tpu_torch import bench
from p1_tpu_torch import cli as torch_cli
from p1_tpu_torch.benchmarks import (
    archive_scale,
    chaos_rate,
    host_ingest,
    maintenance_cadence,
    netsim_scale,
    query_plane,
    sig_verify,
    snapshot_boot,
    telemetry_overhead,
    wallet_plane,
)
from p1_tpu_torch.core import keys
from p1_tpu_torch.hashx import perf_record

REPO = pathlib.Path(__file__).resolve().parent.parent
RENAMES = {"xla_hps": "torch_hps"}


def reference_keys() -> set[str]:
    """Every key the root bench.py can print."""
    tree = ast.parse((REPO / "bench.py").read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and node.value.id == "extra":
            if isinstance(node.slice, ast.Constant):
                found.add(node.slice.value)
        if isinstance(node, ast.Dict) and any(
            isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys
        ):
            found |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
    return found


def expected_keys() -> set[str]:
    return {RENAMES.get(k, k) for k in reference_keys()}


#: Pins a toy run must fall short of (rates: pinned far above) or exceed
#: (latencies, RSS: pinned far below), so every degraded flag is raised.
_RATE_PINS = (
    "RECORDED_HOST_INGEST_BPS", "RECORDED_STAGED_INGEST_BPS", "RECORDED_REVALIDATE_BPS",
    "RECORDED_QUERY_QPS", "RECORDED_SIM_RATE", "RECORDED_SIM_SHARDED_RATE", "RECORDED_CHAOS_RATE",
    "RECORDED_ARCHIVE_RESUME_BPS", "RECORDED_SNAPSHOT_CADENCE_BPS", "RECORDED_WALLET_SUBS",
)  # fmt: skip
_LATENCY_PINS = (
    "RECORDED_SIG_NATIVE_MS", "RECORDED_NOTIFY_P95_MS", "RECORDED_FLEET_COLD_START_S",
    "RECORDED_FLEET_NOTIFY_P95_MS", "RECORDED_RELAY_BYTES_PER_TX", "RECORDED_TX_PROP_P95_MS",
    "RECORDED_SNAPSHOT_BOOT_S", "RECORDED_ARCHIVE_BOOT_RSS_MB", "RECORDED_REBASE_MS",
)  # fmt: skip


@pytest.fixture
def toy_shapes(monkeypatch):
    """The bench's scans and every plane's call cut to toy shapes (the
    planes' own code paths, smaller)."""
    monkeypatch.setattr(bench, "HEADLINE_COUNT", {"cuda": 1 << 12, "cpu": 1 << 12})
    monkeypatch.setattr(bench, "CPU_BASELINE_COUNT", 1 << 12)
    monkeypatch.setattr(bench, "NATIVE_COUNT", 1 << 12)
    monkeypatch.setattr(bench, "TTB_DIFFICULTY", 8)
    monkeypatch.setattr(bench, "TTB_BLOCKS", 1)
    monkeypatch.setattr(bench, "SIG_BATCH", 16)

    def cut(module, name, **shape):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **kw: real(**{**kw, **shape}))

    real_build = host_ingest.build_blocks
    monkeypatch.setattr(host_ingest, "build_blocks", lambda n, txs, difficulty: real_build(12, txs, difficulty))
    cut(telemetry_overhead, "bench_quick", blocks=10, repeats=1)
    real_reval = sig_verify.bench_revalidate
    monkeypatch.setattr(sig_verify, "bench_revalidate", lambda n, repeats: real_reval(10, repeats=1))
    cut(query_plane, "bench_quick", blocks=4, txs=4, repeats=1)
    cut(wallet_plane, "bench_quick", subs=200, measure_blocks=2)
    cut(wallet_plane, "bench_fleet_quick", sessions=6)
    cut(netsim_scale, "bench_sim", nodes=20)
    cut(netsim_scale, "bench_far_field", nodes=200)
    cut(chaos_rate, "bench_chaos", schedules=1)
    cut(snapshot_boot, "bench_quick", blocks=300, repeats=1)
    real_archive = archive_scale.bench_archive
    monkeypatch.setattr(
        archive_scale, "bench_quick", lambda blocks: real_archive(5000, segment_bytes=1 << 18, queries=200)
    )
    cut(maintenance_cadence, "bench_quick", accounts=2000, delta=16, blocks=48)
    yield
    keys.set_sig_backend(None)


@pytest.fixture
def all_degraded(monkeypatch):
    for name in _RATE_PINS:
        monkeypatch.setattr(perf_record, name, 1e18)
    for name in _LATENCY_PINS:
        monkeypatch.setattr(perf_record, name, 1e-12)


def test_reference_key_set_is_read():
    ref = reference_keys()
    assert {"metric", "value", "unit", "vs_baseline", "xla_hps", "lint_findings", "fleet_missed"} <= ref
    assert set(bench.CARD_ONLY_KEYS) <= expected_keys()


def test_line_carries_the_reference_keys_on_the_cpu(toy_shapes, all_degraded):
    line = bench.measure("cpu")
    json.dumps(line)  # one JSON object
    assert set(line) == expected_keys() - set(bench.CARD_ONLY_KEYS)
    assert line["metric"] == "sha256d_hashes_per_sec_per_chip" and line["unit"] == "H/s"
    assert line["platform"] == "cpu" and line["backend"] == "torch"
    assert line["value"] > 0 and line["vs_baseline"] > 0 and line["cpu_baseline_hps"] > 0
    assert line["sig_backend"] == "device"
    assert line["lint_findings"] == 0 and line["fleet_missed"] == 0
    assert line["sim_ok"] and line["sim_sharded_ok"] and line["chaos_ok"]
    assert all(line[k] is True for k in line if k.endswith("_degraded"))
    ratios = [k for k in line if k.endswith("_vs_recorded")]
    assert len(ratios) >= 15 and all(line[k] >= 0 for k in ratios)


def test_healthy_pins_raise_no_flag_on_deterministic_planes(toy_shapes):
    """With the real pins the virtual-time relay figures of a toy mesh
    (fewer bytes, not more) and the lint raise no flag."""
    line = bench.measure("cpu")
    assert line["backend"] == "torch" and line["batch"] == 1 << 12
    assert "relay_degraded" not in line and line["lint_findings"] == 0


def test_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.measure("cuda")


def test_no_import_error_is_swallowed():
    """A missing plane is a fault: bench's source catches no ImportError."""
    tree = ast.parse(pathlib.Path(bench.__file__).read_text())
    caught = [
        ast.unparse(h.type) for h in ast.walk(tree) if isinstance(h, ast.ExceptHandler) and h.type is not None
    ]
    assert not [c for c in caught if "ImportError" in c or c in ("Exception", "BaseException")], caught


def test_cli_bench_calls_the_module(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(bench, "measure", lambda device: seen.append(device) or {"metric": "m"})
    assert torch_cli.main(["bench", "--device", "cpu"]) == 0
    assert seen == ["cpu"]
    out = capsys.readouterr()
    assert out.out.strip().splitlines() == ['{"metric": "m"}']
    assert "kernel launches: " in out.err


@pytest.mark.slow
def test_full_bench_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch", "bench", "--device", "cpu"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=3600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) - {k for k in line if k.endswith("_degraded")} == (
        expected_keys() - set(bench.CARD_ONLY_KEYS) - {k for k in expected_keys() if k.endswith("_degraded")}
    )
    assert line["platform"] == "cpu" and line["lint_findings"] == 0 and line["fleet_missed"] == 0
