"""The port's scenario corpus (``node/scenarios.py``) against the JAX package's.

Mirrors tests/test_scenarios.py up to ``TestVersionActivation`` and its
``TestRegistry``; the relay-budget and reconciliation cases are in
tests/test_torch_scenarios_relay.py, so the two halves run on two
workers.  Every scenario runs with ``device="cpu"`` (hashlib sealing, the
``device`` signature rung's plain version); the slow set is the
reference's.

The scenario corpus (p1_tpu/node/scenarios.py) as a test suite.

Tier-1 (``sim`` marker) runs every scenario family at a mesh size real
sockets could never reach on this host — the flagship is a 200-node
partition-heal inside the ordinary timeout budget.  The ``slow`` set
carries the acceptance-scale runs: the 1000-node 600/400 partition-heal
(the headline criterion) and the 500-joiner flash crowd.

Every scenario's ``ok`` already folds in its own invariants
(convergence, exact ledger conservation, containment metrics); the
tests re-assert the load-bearing ones explicitly so a failure names
what broke instead of just "ok was False".
"""

import pytest

from p1_tpu_torch.node.scenarios import (
    churn_storm,
    eclipse,
    far_field,
    fee_spam,
    flash_crowd,
    partition_heal,
    retarget_shock,
    run_scenario,
    selfish_mining,
    snapshot_cartel,
    wan,
)

pytestmark = pytest.mark.sim


class TestPartitionHeal:
    def test_200_node_mesh_splits_heals_and_converges(self):
        """The tier-1 flagship: a 200-node mesh (≈28x the real-socket
        ceiling) splits 120/80, both sides mine their own chains, the
        cut heals, and every node converges on the majority tip with
        the ledger-sum invariant intact — in bounded VIRTUAL time."""
        r = partition_heal(nodes=200, seed=0, device="cpu")
        assert r["ok"], r
        assert r["tips_diverged"], "partition never actually diverged"
        assert r["converged"] and r["ledger_conserved"]
        assert r["heights"]["min"] == r["final_height"]
        # Every minority node lived on the minority chain and was
        # reorged back — mass fork-choice, not a lucky no-op.
        assert r["minority_nodes_reorged"] >= 0.9 * r["split"][1]
        assert r["heal_virtual_s"] <= 120.0

    @pytest.mark.slow
    def test_1000_node_acceptance_run(self):
        """Acceptance: 1000 nodes, 600/400 split, heal,
        one tip + conserved ledgers in bounded virtual time, tier-1
        minutes of wall time (measured ~25 s here; the wall guard
        below is the regression tripwire, with wide CI margin)."""
        r = partition_heal(nodes=1000, seed=0, device="cpu")
        assert r["ok"], r
        assert r["split"] == [600, 400]
        assert r["minority_nodes_reorged"] == 400
        assert r["heal_virtual_s"] <= 120.0
        assert r["wall_s"] < 300.0


class TestFlashCrowd:
    def test_80_joiners_storm_one_seed(self):
        # 80 > MAX_PEERS(64): the cap regime, not a comfortable mesh.
        r = flash_crowd(joiners=80, chain_height=12, seed=0, device="cpu")
        assert r["ok"], r
        # The herd exceeded the seed's open slots and synced anyway —
        # through each other, which is the scenario's point.
        assert r["seed_capped"]
        assert r["heights"]["min"] == 12

    @pytest.mark.slow
    def test_500_joiners_acceptance_scale(self):
        r = flash_crowd(joiners=500, chain_height=20, seed=0, device="cpu")
        assert r["ok"], r
        assert r["seed_peer_count"] <= 64  # MAX_PEERS held under the herd
        assert r["heights"]["min"] == 20


class TestChurnStorm:
    def test_waves_of_restarts_still_converge(self):
        r = churn_storm(nodes=30, cycles=4, seed=0, device="cpu")
        assert r["ok"], r
        assert r["restarts"] > 0
        assert r["heights"]["min"] == r["final_height"]


class TestEclipse:
    def test_addr_flood_cannot_eclipse_the_victim(self):
        r = eclipse(honest=16, attackers=6, spam_rounds=20, seed=0, device="cpu")
        assert r["ok"], r
        # The defenses, named: gossip never reached the tried
        # bucket, the per-host budget clipped the flood to a trickle,
        # the book stayed bounded, and the victim kept following the
        # honest chain.
        assert r["tried_bucket_attacker_entries"] == 0
        assert r["new_bucket_attacker_entries"] < r["spam_addrs_sent"] / 10
        assert r["address_book_bounded"]
        assert r["victim_honest_links"] >= 1
        assert r["victim_followed_honest_tip"]


class TestWan:
    def test_asymmetric_geography_converges_and_is_visible(self):
        r = wan(region_nodes=6, blocks=6, seed=0, device="cpu")
        assert r["ok"], r
        # The latency model is load-bearing: measured propagation shows
        # at least one inter-region one-way latency.
        assert r["propagation_max_p95_ms"] >= r["min_inter_region_latency_ms"]


class TestWanSLOScope:
    """The propagation SLO is never vacuously
    true.  Telemetry off + no bound ⇒ explicitly UNEVALUATED (and
    excluded from ok); telemetry off + an explicit bound ⇒ a loud
    error, because an unmeasurable bound must not pass."""

    def test_no_telemetry_marks_the_slo_unevaluated(self):
        r = wan(region_nodes=3, blocks=2, seed=1, telemetry=False, device="cpu")
        assert r["ok"], r
        assert r["propagation_slo"] == "unevaluated"
        assert r["propagation_bounded"] is None
        assert r["propagation_p95_bound_ms"] is None

    def test_explicit_bound_without_telemetry_fails_loudly(self):
        with pytest.raises(ValueError, match="unmeasurable"):
            wan(
                region_nodes=3,
                blocks=2,
                seed=1,
                telemetry=False,
                propagation_p95_bound_ms=1500.0,
                device="cpu",
            )

    def test_evaluated_run_names_its_state(self):
        r = wan(region_nodes=3, blocks=2, seed=1, device="cpu")
        assert r["ok"] and r["propagation_slo"] == "evaluated"
        assert r["propagation_bounded"] is True


class TestFarField:
    """The sharded 10k-node plane.  Tier-1
    carries the digest-invariance pairs at a few hundred nodes; the
    slow set carries the 10k acceptance run."""

    def test_shard_split_keeps_the_merged_digest(self):
        one = far_field(nodes=400, full_nodes=8, blocks=4, seed=0, shards=1, device="cpu")
        two = far_field(
            nodes=400, full_nodes=8, blocks=4, seed=0, shards=2,
            processes=False,
            device="cpu",
        )
        assert one["ok"], one
        assert one["far_converged_nodes"] == 392
        # THE invariance: the merged trace digest does not move with
        # the shard layout — and neither does anything else but wall_s.
        assert one["trace_digest"] == two["trace_digest"]
        for k in one:
            if k not in ("wall_s", "shards", "shard_processes", "repro"):
                assert one[k] == two[k], k

    def test_cross_process_shards_keep_the_merged_digest(self):
        one = far_field(nodes=400, full_nodes=8, blocks=4, seed=3, shards=1, device="cpu")
        procs = far_field(
            nodes=400, full_nodes=8, blocks=4, seed=3, shards=2,
            processes=True,
            device="cpu",
        )
        assert procs["shard_processes"]
        assert one["trace_digest"] == procs["trace_digest"]

    def test_settle_bound_is_load_bearing(self):
        r = far_field(
            nodes=400, full_nodes=8, blocks=4, seed=0,
            far_settle_bound_ms=0.001,
            device="cpu",
        )
        assert not r["ok"] and r["far_converged"]

    @pytest.mark.slow
    def test_10k_node_acceptance_run(self):
        """Acceptance: the 10,000-node scenario completes in
        tier-1-adjacent wall time, and the merged trace digest is
        byte-identical at 1 shard vs N process shards (the in-process
        ×2 pair runs tier-1 above; the cross-process CLI pair under
        PYTHONHASHSEED lives in tests/test_cli.py)."""
        one = far_field(seed=0, shards=1, device="cpu")
        assert one["ok"], {k: one[k] for k in ("ok", "far_converged")}
        assert one["nodes"] == 10_000
        assert one["wall_s"] < 120.0
        sharded = far_field(seed=0, shards=4, device="cpu")
        assert sharded["ok"]
        assert sharded["trace_digest"] == one["trace_digest"]


class TestSelfishMining:
    def test_gamma0_mesh_contains_selfish_revenue(self):
        r = selfish_mining(honest=12, alpha=0.3, finds=80, seed=0, device="cpu")
        assert r["ok"], r
        # The attack really ran: blocks were withheld, overrides
        # reorged honest nodes.
        assert r["withheld_blocks"] > 0 and r["overrides"] >= 1
        assert r["honest_mesh_reorgs"] >= 1
        # Containment: at γ≈0 and α<1/3, selfish mining must not
        # amplify revenue beyond the bound...
        assert r["attacker_revenue_share"] <= r["revenue_share_bound"]
        # ...and on this seed it in fact UNDER-performs honest mining
        # (the Eyal–Sirer sub-threshold loss, realized in the mesh).
        assert r["attacker_revenue_share"] < r["actual_alpha"]

    def test_containment_bound_is_load_bearing(self):
        r = selfish_mining(
            honest=12, alpha=0.3, finds=80, seed=0, margin=-1.0, device="cpu"
        )
        assert not r["ok"] and r["withheld_blocks"] > 0


class TestFeeSpam:
    def test_honest_traffic_never_starves_under_spam(self):
        r = fee_spam(nodes=8, spammers=3, honest_txs=12, seed=0, storm_vs=30.0, device="cpu")
        assert r["ok"], r
        # Every honest tx confirmed, inside the bound.
        assert r["honest_confirmed"] == r["honest_submitted"]
        assert r["honest_confirm_blocks_max"] <= r["confirm_bound_blocks"]
        # The flood was real and the layers each did their job: the
        # governor dropped frames at the door and scored the hosts,
        # and the spend limit capped what spam could ever mine.
        assert r["admission_tx_drops"] > 0
        assert r["spammers_scored"] >= 1
        assert r["spam_frames_sent"] > r["spam_budget_txs"]
        assert r["spam_txs_mined"] <= r["spam_budget_txs"]

    def test_confirm_bound_is_load_bearing(self):
        r = fee_spam(
            nodes=8, spammers=3, honest_txs=12, seed=0, storm_vs=30.0,
            confirm_bound_blocks=0,
            device="cpu",
        )
        assert not r["ok"] and r["honest_confirmed"] > 0


class TestRetargetShock:
    def test_hashrate_step_is_absorbed_within_the_clamp(self):
        r = retarget_shock(nodes=6, seed=0, device="cpu")
        assert r["ok"], r
        # The rule saw the shock and moved...
        assert r["responded"] and r["peak_difficulty"] >= r["base_difficulty"] + 2
        # ...every retarget stayed inside the clamp, at mesh level...
        assert r["retarget_clamp_held"]
        # ...overshoot and undershoot both clamp-bounded...
        assert r["overshoot_bits"] <= r["overshoot_bound_bits"]
        assert r["undershoot_bits"] <= r["max_adjust"]
        # ...and the difficulty returned to base once the shock passed.
        assert r["recovered"]

    def test_overshoot_bound_is_load_bearing(self):
        r = retarget_shock(nodes=6, seed=0, overshoot_bound_bits=-3, device="cpu")
        assert not r["ok"] and r["responded"]


class TestSnapshotCartel:
    def test_cartel_of_lying_servers_is_contained(self):
        r = snapshot_cartel(nodes=10, cartel=3, joiners=2, seed=0, device="cpu")
        assert r["ok"], r
        # Every joiner: lied to, diverged, never flipped, not fooled.
        assert r["divergences"] >= r["joiners"] and r["flips"] == 0
        assert r["fooled"] == 0
        assert r["cartel_servers_scored"] >= 1
        # And the honest mesh never lost its own history.
        assert r["honest_history_kept"]

    def test_capture_detector_is_load_bearing(self):
        # Hand the cartel a HEAVIER fork (majority work, which no
        # snapshot machinery can overrule) and drop the honest
        # response: the mesh is captured and the assertion says so.
        r = snapshot_cartel(
            nodes=10, cartel=3, joiners=2, seed=0,
            liar_height=16, honest_extra_blocks=0,
            device="cpu",
        )
        assert not r["ok"] and not r["honest_history_kept"]


class TestVersionActivation:
    def test_mixed_version_mesh_activates_without_forking(self):
        from p1_tpu_torch.node.scenarios import version_activation

        r = version_activation(nodes=8, seed=0, device="cpu")
        assert r["ok"], r
        # The ladder walked on schedule: STARTED at the first full
        # window, LOCKED_IN one window later, ACTIVE one after that.
        assert r["ladder_ok"] and r["activation_height"] == 24
        assert r["ladder"]["8"] == "started"
        assert r["ladder"]["16"] == "locked_in"
        assert r["ladder"]["24"] == "active"
        # The mix was real: the straggler mined on BOTH sides of
        # activation with literal version=1 and everyone accepted it —
        # version is not consensus, so zero forks is the bound.
        assert r["straggler_blocks_pre_activation"] > 0
        assert r["straggler_blocks_post_activation"] > 0
        assert r["straggler_versions"] == ["0x00000001"]
        assert r["forks_observed"] == 0 and r["containment_held"]
        # Lock-in was earned, not gifted: the judged window carried
        # exactly threshold signaling headers (the straggler's legacy
        # headers in that window do NOT count — top-bits convention).
        assert r["signal_bit_in_started_window"] == r["vb_threshold"]
        # Post-ACTIVE the signal bit clears but top-bits stay.
        assert "0x20000000" in r["signaling_versions"]
        assert "0x20000001" in r["signaling_versions"]
        # Every signaling node reports active; the straggler has no
        # deployment table at all and agrees on the chain anyway.
        assert r["states_agree"]

    def test_no_fork_bound_is_load_bearing(self):
        from p1_tpu_torch.node.scenarios import version_activation

        r = version_activation(nodes=8, seed=0, margin=-1, device="cpu")
        assert not r["ok"] and not r["containment_held"]
        # The control fails ONLY on the impossible bound — the mesh
        # itself still activated and converged.
        assert r["ladder_ok"] and r["converged"]


class TestRegistry:
    def test_run_scenario_dispatches_and_rejects_unknown(self):
        r = run_scenario("wan", region_nodes=3, blocks=2, seed=1, device="cpu")
        assert r["scenario"] == "wan"
        with pytest.raises(ValueError, match="unknown scenario"):
            run_scenario("nope", device="cpu")

    def test_every_report_is_stamped_for_repro(self):
        # Seed + trace digest + the exact repro
        # command, in EVERY scenario report.
        r = run_scenario("retarget-shock", nodes=5, seed=11, device="cpu")
        assert r["seed"] == 11
        assert r["trace_digest"]
        assert r["repro"] == "p1 sim retarget-shock --seed 11"
