"""The port's relay-budget and reconciliation scenarios against the JAX package's.

The second half of the mirror of tests/test_scenarios.py
(``TestRelayBudget``, ``TestReconProtocol``), split from
tests/test_torch_scenarios.py so the two halves run on two workers.  Every
scenario runs with ``device="cpu"`` (hashlib sealing, the ``device``
signature rung's plain version); the slow case is the reference's.
"""

import pytest

from p1_tpu_torch.node.scenarios import run_scenario

pytestmark = pytest.mark.sim


class TestRelayBudget:
    """The flood-vs-reconciliation A/B over shaped uplinks.
    Tier-1 runs the 10-node quick shape (the same one bench.py pins);
    the slow set carries the 16-node acceptance run with its ≥5x
    budget at full storm scale."""

    def test_recon_beats_flood_on_bytes_and_latency(self):
        r = run_scenario(
            "relay-budget",
            nodes=10, senders=4, txs_per_sender=24, storm_vs=10.0,
            min_reduction=3.0, seed=0,
            device="cpu",
        )
        assert r["ok"], r
        # Both arms delivered the whole storm to every node.
        assert r["flood"]["delivered"] and r["recon"]["delivered"]
        # The headline pair: fewer bytes AND equal-or-better p95 —
        # efficiency was not bought with latency.
        assert r["reduction"] >= 3.0
        assert (
            r["recon"]["propagation"]["p95_ms"]
            <= r["flood"]["propagation"]["p95_ms"]
        )
        # The histograms are populated on both arms (telemetry is the
        # acceptance instrument, not a side channel).
        for arm in ("flood", "recon"):
            assert r[arm]["propagation"]["count"] == (
                r["total_txs"] * (r["nodes"] - 1)
            )
        # Reconciliation actually carried the recon arm: rounds ran,
        # succeeded, and the flood arm ran zero.
        assert r["recon"]["recon"]["success"] > 0
        assert r["flood"]["recon"]["rounds"] == 0

    def test_impossible_bound_control_fails(self):
        # The A/B must be falsifiable: an absurd reduction floor turns
        # the same healthy run into ok=False.
        r = run_scenario(
            "relay-budget",
            nodes=10, senders=4, txs_per_sender=24, storm_vs=10.0,
            min_reduction=1e9, seed=0,
            device="cpu",
        )
        assert not r["ok"]
        assert r["flood"]["delivered"] and r["recon"]["delivered"]

    @pytest.mark.slow
    def test_16_node_acceptance_run_holds_the_5x_budget(self):
        r = run_scenario("relay-budget", seed=0, device="cpu")
        assert r["ok"], r
        assert r["reduction"] >= 5.0
        assert (
            r["recon"]["propagation"]["p95_ms"]
            <= r["flood"]["propagation"]["p95_ms"]
        )


class TestReconProtocol:
    def test_over_capacity_burst_falls_back_to_flood(self):
        r = run_scenario("recon-fallback", seed=0, device="cpu")
        assert r["ok"], r
        # The burst overflowed at least one sketch, the fallback
        # flooded it, nobody was demoted for an honest overflow, and
        # the mesh still converged with the ledger conserved.
        assert r["recon_fallbacks"] >= 1
        assert r["recon_demotions"] == 0
        assert r["converged"] and r["ledger_conserved"]

    def test_sketch_poisoner_cannot_stall_honest_relay(self):
        r = run_scenario("recon-poison", seed=0, device="cpu")
        assert r["ok"], r
        # The poisoner got its shots in AND got demoted off the recon
        # plane; honest reconciliation kept succeeding throughout.
        assert r["poisoner_attacks"]["garbage_sketch"] >= 1
        assert r["victim_demotions"] >= 1
        assert r["honest_recon_success"] > 0
        assert r["converged"] and r["ledger_conserved"]

    def test_mixed_version_mesh_floods_until_activation(self):
        r = run_scenario("recon-mixed", seed=0, device="cpu")
        assert r["ok"], r
        # Phase A (pre-activation): flood was the dialect — zero
        # rounds.  Phase B (post-activation): rounds ran and the
        # deployment-less straggler still received everything.
        assert r["recon_rounds_pre_activation"] == 0
        assert r["recon_success_post_activation"] > 0
        assert r["activation_state"] == "active"
