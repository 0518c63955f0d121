"""The port's simulated meshes against the JAX package's, digest for digest.

The same scenario with the same seed runs through ``p1_tpu`` and through
``p1_tpu_torch`` (``device="cpu"``: hashlib sealing, the ``device``
signature rung's plain version).  The simulator hashes every network event
into its trace digest, so equal digests mean the two meshes exchanged the
same bytes at the same virtual instants: the same blocks, the same reorgs,
the same bans.  Every scenario family runs at a test size, the chaos plane
at seeds 0 and 1, and one case seals through the port's ``cuda`` backend's
plain version (``backend="cuda", device="cpu"``), whose earliest hit is
hashlib's.  A repro artifact written by either package replays in the
other with its recorded digest.
"""

import inspect

import pytest

from p1_tpu.node import chaos as ref_chaos
from p1_tpu.node import scenarios as ref_scenarios
from p1_tpu_torch.node import chaos, scenarios
from p1_tpu_torch.node.netsim import SimNet

pytestmark = pytest.mark.sim

#: Every entry of ``SCENARIOS`` at a size that runs in seconds.
SCENARIO_ARGS = {
    "partition-heal": dict(nodes=200),
    "flash-crowd": dict(joiners=10),
    "churn": dict(nodes=12),
    "eclipse": dict(),
    "wan": dict(region_nodes=3, blocks=2),
    "snapshot-join": dict(nodes=6),
    "far-field": dict(nodes=400),
    "selfish-mining": dict(),
    "fee-spam": dict(),
    "retarget-shock": dict(nodes=5),
    "snapshot-cartel": dict(),
    "version-activation": dict(),
    "fleet-failover": dict(),
    "relay-budget": dict(nodes=6, senders=2, txs_per_sender=8, storm_vs=5.0),
    "recon-fallback": dict(),
    "recon-poison": dict(),
    "recon-mixed": dict(),
    "soak": dict(days=0.25),
}


def test_every_scenario_has_a_parity_case():
    assert set(SCENARIO_ARGS) == set(ref_scenarios.SCENARIOS)
    assert set(scenarios.SCENARIOS) == set(ref_scenarios.SCENARIOS)
    for name, fn in scenarios.SCENARIOS.items():
        if name != "soak":  # forwards its keywords to chaos.longevity_soak
            assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(chaos.longevity_soak).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(SCENARIO_ARGS))
def test_scenario_digest_equals_the_reference(name):
    kwargs = SCENARIO_ARGS[name]
    ref = ref_scenarios.run_scenario(name, seed=0, **kwargs)
    port = scenarios.run_scenario(name, seed=0, device="cpu", **kwargs)
    assert port["trace_digest"] == ref["trace_digest"]
    assert port["ok"] == ref["ok"]
    assert port["events"] == ref["events"]


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_digest_equals_the_reference(seed):
    ref = ref_chaos.run_chaos(seed)
    port = chaos.run_chaos(seed, device="cpu")
    assert ref["ok"] and port["ok"]
    assert port["trace_digest"] == ref["trace_digest"]
    assert port["violations"] == ref["violations"]


def test_cuda_backend_plain_version_seals_the_same_mesh(monkeypatch):
    """The search kernel's plain version returns hashlib's earliest hit,
    so a mesh sealed through it traces the reference's digest."""
    built = []
    init = SimNet.__init__

    def cuda_plain(self, *args, **kwargs):
        kwargs["backend"] = "cuda"
        init(self, *args, **kwargs)
        built.append(type(self._miner.backend).__name__)

    monkeypatch.setattr(SimNet, "__init__", cuda_plain)
    ref = ref_scenarios.partition_heal(nodes=200, seed=0)
    port = scenarios.partition_heal(nodes=200, seed=0, device="cpu")
    assert built == ["CudaBackend"]
    assert port["ok"] and port["trace_digest"] == ref["trace_digest"]


def test_simnet_device_defaults():
    net = SimNet(device="cpu")
    assert (net.device, net.backend) == ("cpu", "cpu")
    assert type(net._miner.backend).__name__ == "CpuBackend"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_repro_artifact_replays_across_packages(tmp_path, writer):
    """A violation's artifact keeps the reference's format: written by
    either package, it replays in the other with its recorded digest."""
    seed, nodes = 0, 5
    events = ref_chaos.generate_schedule(seed, nodes, 10)
    assert events == chaos.generate_schedule(seed, nodes, 10)
    path = tmp_path / "repro.json"
    if writer == "reference":
        report = ref_chaos.run_chaos(
            seed, nodes=nodes, events=events, inject_bug="relapse-disk"
        )
        ref_chaos.write_repro(
            path, report, events, seed=seed, nodes=nodes, difficulty=8,
            inject_bug="relapse-disk",
        )
        replayed, artifact = chaos.run_repro(path, device="cpu")
    else:
        report = chaos.run_chaos(
            seed, nodes=nodes, events=events, inject_bug="relapse-disk",
            device="cpu",
        )
        chaos.write_repro(
            path, report, events, seed=seed, nodes=nodes, difficulty=8,
            inject_bug="relapse-disk",
        )
        replayed, artifact = ref_chaos.run_repro(path)
    assert report["violations"], "the injected bug must be caught"
    assert replayed["trace_digest"] == artifact["expected_trace_digest"]
    assert sorted({v["invariant"] for v in replayed["violations"]}) == (
        artifact["expected_violations"]
    )
