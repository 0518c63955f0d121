"""The scenario corpus: consensus emergent behavior at simulated scale.

The north star asks for "as many scenarios as you can imagine"; this
module is the library that opens — each scenario a deterministic
discrete-event run (node/netsim.py) of REAL ``Node`` instances
(consensus, mempool, governor, supervision, address book — nothing
mocked) that asserts a convergence or containment metric in bounded
*virtual* time.  The Bitcoin-Core lineage names the families:

- **partition-heal** — the mesh splits (600/400 at the flagship scale),
  both sides keep mining, the cut heals, and every node must converge
  to the one heaviest tip with the ledger-sum invariant intact.  This
  scenario found a real propagation gap on its first 1000-node run:
  batch-synced blocks were never re-announced, so regions with no
  direct link across the old cut never converged (node.py
  ``_announce_tip``).
- **flash-crowd** — hundreds of fresh nodes join at once against one
  seed (the thundering-herd IBD); everyone must reach the seed's tip
  even though the seed's MAX_PEERS/MAX_HANDSHAKING caps refuse most of
  the crowd, which must sync through each other instead.
- **churn** — waves of nodes stop and restart (same identity, same
  address) while mining continues; the survivors and the returners must
  converge and conserve.
- **eclipse** — attackers flood a victim's address book from many
  hosts and camp its inbound slots; the tried/new bucket split and the
  per-host ADDR budgets must keep the victim attached to the honest
  mesh and its book bounded.
- **wan** — regions with asymmetric inter-region latency/bandwidth;
  convergence must hold and measured propagation delay must reflect
  the configured geography (the sanity proof that the latency model is
  real, and the rig for propagation studies).

Every report carries ``trace_digest`` — two runs with the same seed
are byte-identical (tests/test_netsim.py asserts it), so any scenario
failure is replayable by seed alone.  `p1 sim` runs these from the
command line and prints the report as one JSON line.

The port's copy of ``p1_tpu/node/scenarios.py``: every scenario takes
``device`` (``"cuda"`` by default) and gives it to its ``SimNet``, so
its blocks are sealed by the ``sha256d_search.cu`` kernel on the card,
or by hashlib under ``device="cpu"``; the digest is the same.
"""

from __future__ import annotations

import asyncio
import random
import time

from p1_tpu_torch.node.netsim import NODE_PORT, LinkProfile, SimNet

__all__ = ["SCENARIOS", "run_scenario"]


def _topology_peers(rng: random.Random, i: int, degree: int) -> list[int]:
    """Backbone + random small-world out-edges for node ``i``: always
    dial ``i-1`` (so any CONTIGUOUS index split leaves both sides
    internally connected — the partition scenario's well-posedness),
    plus ``degree-1`` random earlier nodes for short gossip paths."""
    if i == 0:
        return []
    extra = rng.sample(range(i - 1), min(i - 1, degree - 1))
    return [i - 1, *extra]


def _report(
    net: SimNet, scenario: str, t0: float, repro_flags: str = "", **extra
) -> dict:
    from p1_tpu_torch.node.telemetry import propagation_summary_ms

    report = {
        "scenario": scenario,
        "seed": net.seed,
        # One-flag deterministic repro: every report names the exact
        # command whose re-run must reproduce ``trace_digest`` byte for
        # byte (tests/test_cli.py asserts exactly that).
        "repro": f"p1 sim {scenario} --seed {net.seed}"
        + (f" {repro_flags}" if repro_flags else ""),
        "nodes": len(net.nodes),
        "virtual_s": round(net.clock.now, 3),
        "wall_s": round(time.monotonic() - t0, 3),
        "events": net.net.events,
        "converged": net.converged(),
        "ledger_conserved": net.ledger_conserved(),
        "heights": {
            "min": min(net.heights()),
            "max": max(net.heights()),
        },
        "reorgs_total": sum(
            n.metrics.reorgs for n in net.nodes.values()
        ),
        # Telemetry timeline: the nodes' propagation
        # histograms merged, in VIRTUAL milliseconds — what lets a
        # scenario assert a p95 propagation bound instead of bare
        # convergence.  None when telemetry is disabled.
        "telemetry": {
            "propagation": propagation_summary_ms(
                n.telemetry for n in net.nodes.values()
            )
        },
        **extra,
    }
    report["trace_digest"] = net.trace_digest()
    return report


# -- partition-heal ------------------------------------------------------


def partition_heal(
    nodes: int = 1000,
    seed: int = 0,
    split: float = 0.6,
    blocks_major: int = 4,
    blocks_minor: int = 2,
    degree: int = 4,
    difficulty: int = 8,
    heal_timeout_vs: float = 180.0,
    wall_limit_s: float | None = 420.0,
    telemetry: bool = True,
    pipeline_workers: int = 0,
    device: str = "cuda",
) -> dict:
    """The flagship: mesh splits ``split``/1-``split``, both sides mine,
    the cut heals, one tip wins everywhere.  ok = global convergence at
    the majority chain's height, mass reorgs on the minority side, and
    exact ledger conservation, all inside ``heal_timeout_vs`` virtual
    seconds of the heal.  ``telemetry=False`` disables the nodes'
    latency recording — the trace digest must not move (the
    observer contract; tests/test_telemetry.py runs this scenario both
    ways and compares).  ``pipeline_workers`` stages every node's
    validate/store pipeline (node/pipeline.py) — the same digest
    contract holds: lane jobs are synchronous under the virtual loop,
    so staging on/off must not move the trace (tests/test_pipeline.py
    runs this scenario both ways at 200 nodes and compares)."""
    net = SimNet(
        seed=seed,
        device=device,
        difficulty=difficulty,
        telemetry=telemetry,
        pipeline_workers=pipeline_workers,
    )
    t0 = time.monotonic()

    async def main():
        rng = random.Random(seed ^ 0x70B0)
        for i in range(nodes):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, degree)]
            )
        hosts = list(net.nodes)
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        miner_a = net.nodes[hosts[0]]
        for _ in range(2):
            await net.mine_on(miner_a, spacing_s=2.0)
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == 2,
            120, step=0.25, wall_limit_s=wall_limit_s,
        ), "pre-partition mesh never converged"

        na = int(nodes * split)
        side_a, side_b = hosts[:na], hosts[na:]
        net.net.partition(side_a, side_b)
        miner_b = net.nodes[side_b[0]]
        for _ in range(blocks_major):
            await net.mine_on(miner_a, spacing_s=2.0)
        for _ in range(blocks_minor):
            await net.mine_on(miner_b, spacing_s=2.0)
        sides_ok = await net.run_until(
            lambda: net.converged(side_a) and net.converged(side_b),
            120, step=0.25, wall_limit_s=wall_limit_s,
        )
        diverged = len(net.tips()) == 2

        heal_at = net.clock.now
        net.net.heal()
        # One fresh block on the majority side: the announcement that
        # races the heal (nodes with cross links hear it immediately;
        # everyone else must hear it through the post-sync tip
        # announce).
        await net.mine_on(miner_a, spacing_s=2.0)
        final_height = 2 + blocks_major + 1
        healed = await net.run_until(
            lambda: net.converged() and min(net.heights()) == final_height,
            heal_timeout_vs, step=0.25, wall_limit_s=wall_limit_s,
        )
        heal_vs = net.clock.now - heal_at
        minority_reorged = sum(
            1 for h in side_b if net.nodes[h].metrics.reorgs > 0
        )
        report = _report(
            net, "partition-heal", t0,
            split=[len(side_a), len(side_b)],
            sides_converged_under_partition=sides_ok,
            tips_diverged=diverged,
            healed=healed,
            heal_virtual_s=round(heal_vs, 3),
            final_height=final_height,
            minority_nodes_reorged=minority_reorged,
        )
        report["ok"] = bool(
            healed
            and diverged
            and sides_ok
            and report["converged"]
            and report["ledger_conserved"]
            # The minority side really did live on its own chain and
            # really was reorged back — blocks_minor > 0 makes this a
            # structural requirement, not a vacuous pass.
            and (blocks_minor == 0 or minority_reorged >= 0.9 * len(side_b))
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- flash-crowd IBD -----------------------------------------------------


def flash_crowd(
    joiners: int = 500,
    chain_height: int = 20,
    seed: int = 0,
    difficulty: int = 8,
    join_window_vs: float = 5.0,
    ibd_timeout_vs: float = 300.0,
    wall_limit_s: float | None = 420.0,
    device: str = "cuda",
) -> dict:
    """``joiners`` fresh nodes storm one seed node inside
    ``join_window_vs`` virtual seconds.  The seed's MAX_PEERS /
    MAX_HANDSHAKING caps refuse most of the herd — each joiner also
    knows one random earlier joiner, and the crowd must sync through
    itself.  ok = every node at the seed's tip within the budget."""
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()

    async def main():
        rng = random.Random(seed ^ 0xF1A5)
        seed_node = await net.add_node()
        seed_host = net.host_name(0)
        for _ in range(chain_height):
            await net.mine_on(seed_node, spacing_s=0.05)
        assert seed_node.chain.height == chain_height

        stagger = join_window_vs / max(1, joiners)
        for i in range(1, joiners + 1):
            peers = [seed_host]
            if i > 1:
                peers.append(net.host_name(rng.randrange(1, i)))
            await net.add_node(peers=peers)
            await asyncio.sleep(stagger)
        join_done = net.clock.now

        done = await net.run_until(
            lambda: min(net.heights()) == chain_height and net.converged(),
            ibd_timeout_vs, step=0.25, wall_limit_s=wall_limit_s,
        )
        ibd_vs = net.clock.now - join_done
        seed_peers = seed_node.peer_count()
        report = _report(
            net, "flash-crowd", t0,
            joiners=joiners,
            chain_height=chain_height,
            ibd_complete=done,
            ibd_virtual_s=round(ibd_vs, 3),
            seed_peer_count=seed_peers,
            # The crowd was bigger than the seed's open-arms policy:
            # the interesting regime is the refused majority syncing
            # through the mesh, and this records that it happened.
            seed_capped=seed_peers < joiners,
        )
        report["ok"] = bool(
            done and report["converged"] and report["ledger_conserved"]
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- churn storm ---------------------------------------------------------


def churn_storm(
    nodes: int = 60,
    cycles: int = 5,
    churn_frac: float = 0.25,
    seed: int = 0,
    degree: int = 4,
    difficulty: int = 8,
    settle_timeout_vs: float = 120.0,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """Waves of nodes vanish mid-gossip and return (same identity, same
    address — a restart, not a new peer) while the survivors keep
    mining.  ok = after the storm, every node — returners included —
    converges on one tip and conserves the ledger."""
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()

    async def main():
        rng = random.Random(seed ^ 0xC4B1)
        for i in range(nodes):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, degree)]
            )
        hosts = list(net.nodes)
        miner = net.nodes[hosts[0]]
        assert await net.run_until(
            net.links_up, 60, step=0.1, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        for _ in range(2):
            await net.mine_on(miner, spacing_s=1.0)
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == 2,
            60, step=0.1, wall_limit_s=wall_limit_s,
        ), "mesh never converged pre-churn"

        restarts = 0
        for _cycle in range(cycles):
            victims = rng.sample(hosts[1:], int((nodes - 1) * churn_frac))
            for h in victims:
                await net.stop_node(h)
            # Mine while they are gone: the returners restart behind
            # the tip and must catch up through ordinary sync.
            await net.mine_on(miner, spacing_s=1.0)
            await asyncio.sleep(2.0)
            for h in victims:
                await net.restart_node(h)
                restarts += 1
            await net.mine_on(miner, spacing_s=1.0)
            await asyncio.sleep(2.0)

        final_height = 2 + 2 * cycles
        settled = await net.run_until(
            lambda: net.converged() and min(net.heights()) == final_height,
            settle_timeout_vs, step=0.25, wall_limit_s=wall_limit_s,
        )
        report = _report(
            net, "churn", t0,
            cycles=cycles,
            restarts=restarts,
            settled=settled,
            final_height=final_height,
        )
        report["ok"] = bool(
            settled and report["converged"] and report["ledger_conserved"]
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- eclipse attempt -----------------------------------------------------


def eclipse(
    honest: int = 24,
    attackers: int = 8,
    spam_rounds: int = 30,
    seed: int = 0,
    difficulty: int = 8,
    wall_limit_s: float | None = 240.0,
    device: str = "cuda",
) -> dict:
    """Attackers flood a victim's address book from ``attackers``
    distinct hosts — hundreds of addresses pointing into attacker
    space — and run hostile listeners the victim's discovery may dial.
    The eclipse defenses under test: gossip can only churn the
    "new" bucket (handshake-verified "tried" entries are out of reach),
    per-HOST token buckets clamp unsolicited ADDR no matter how many
    frames arrive, and the book stays bounded.  ok = the victim keeps
    ≥1 honest connection, keeps converging with the honest mesh, and
    attacker addresses never exceed the budgeted trickle."""
    from p1_tpu_torch.node import protocol
    from p1_tpu_torch.node.node import MAX_KNOWN_ADDRS, MAX_TRIED_ADDRS
    from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks

    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    ATTACKER_NET = "66.6."

    async def main():
        rng = random.Random(seed ^ 0xEC11)
        for i in range(honest):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)]
            )
        hosts = list(net.nodes)
        miner = net.nodes[hosts[0]]
        # The victim: discovery ON — exactly the machinery an eclipse
        # targets (it dials what the book tells it to).
        victim_host = "10.9.9.9"
        victim = await net.add_node(
            name=victim_host, peers=[hosts[0]], target_peers=4
        )
        for _ in range(2):
            await net.mine_on(miner, spacing_s=1.0)
        assert await net.run_until(
            lambda: net.converged() and victim.chain.height == 2,
            60, step=0.1, wall_limit_s=wall_limit_s,
        ), "victim never joined the honest mesh"

        # Hostile listeners the poisoned book would dial into: they
        # answer the handshake (advertising height 0 — nothing to
        # serve) and otherwise waste the victim's time.
        listeners = []
        chain = make_blocks(1, difficulty)  # genesis only: right chain id
        for a in range(attackers):
            hp = HostilePeer(
                chain,
                plan=FaultPlan(hello_height=0),
                transport=net.net.host(f"{ATTACKER_NET}0.{a}"),
                host=f"{ATTACKER_NET}0.{a}",
                rng=random.Random(seed * 1000 + a),
            )
            await hp.start()
            listeners.append(hp)

        async def spam(a: int) -> None:
            """One attacker host streams ADDR frames at the victim:
            64 addresses per frame, every frame pointing into attacker
            space (the listeners above plus void)."""
            srng = random.Random(seed * 77 + a)
            src = f"{ATTACKER_NET}0.{a}"
            try:
                reader, writer = await net.net.host(src).connect(
                    victim_host, NODE_PORT
                )
                await protocol.write_frame(
                    writer,
                    protocol.encode_hello(
                        protocol.Hello(
                            miner.chain.genesis.block_hash(),
                            0,
                            listeners[a].port,
                            srng.getrandbits(64) | 1,
                        )
                    ),
                )
                await protocol.read_frame(reader)  # victim's HELLO
                for _ in range(spam_rounds):
                    addrs = [
                        (
                            f"{ATTACKER_NET}{srng.randrange(1, 250)}."
                            f"{srng.randrange(250)}",
                            srng.randrange(1, 0xFFFF),
                        )
                        for _ in range(64)
                    ]
                    await protocol.write_frame(
                        writer, protocol.encode_addr(addrs)
                    )
                    await asyncio.sleep(0.2)
                writer.close()
            except (ConnectionError, OSError, asyncio.IncompleteReadError):
                pass  # victim dropped us: also an answer

        await asyncio.gather(*(spam(a) for a in range(attackers)))
        await asyncio.sleep(5.0)

        # Post-storm: the honest mesh keeps mining; the victim must
        # still follow it.
        for _ in range(2):
            await net.mine_on(miner, spacing_s=1.0)
        followed = await net.run_until(
            lambda: victim.chain.tip_hash == miner.chain.tip_hash,
            60, step=0.1, wall_limit_s=wall_limit_s,
        )

        honest_set = set(hosts)
        honest_links = sum(
            1
            for p in victim._peers.values()
            if p.host in honest_set
        )
        tried_attacker = sum(
            1
            for (h, _pt) in victim._tried_addrs
            if h.startswith(ATTACKER_NET)
        )
        known_attacker = sum(
            1
            for (h, _pt) in victim._known_addrs
            if h.startswith(ATTACKER_NET)
        )
        book = len(victim._known_addrs) + len(victim._tried_addrs)
        spam_sent = attackers * spam_rounds * 64
        report = _report(
            net, "eclipse", t0,
            attackers=attackers,
            spam_addrs_sent=spam_sent,
            victim_honest_links=honest_links,
            victim_followed_honest_tip=followed,
            tried_bucket_attacker_entries=tried_attacker,
            new_bucket_attacker_entries=known_attacker,
            address_book_size=book,
            address_book_bounded=book
            <= MAX_KNOWN_ADDRS + MAX_TRIED_ADDRS,
        )
        # The ADDR budget admits ~1 address/host/second plus the burst:
        # anything near the spam volume means the bucket failed.
        budget_held = known_attacker <= attackers * 80
        report["ok"] = bool(
            followed
            and honest_links >= 1
            and tried_attacker == 0
            and budget_held
            and report["address_book_bounded"]
            and report["ledger_conserved"]
        )
        for hp in listeners:
            await hp.stop()
        await net.stop_all()
        return report

    return net.run(main())


# -- WAN topology --------------------------------------------------------

#: One-way inter-region latencies (seconds) for the wan scenario —
#: deliberately asymmetric (routing asymmetry is real) so the model is
#: exercised per DIRECTION.
_WAN_LATENCY = {
    ("us", "eu"): 0.040,
    ("eu", "us"): 0.048,
    ("us", "asia"): 0.080,
    ("asia", "us"): 0.092,
    ("eu", "asia"): 0.120,
    ("asia", "eu"): 0.132,
    ("us", "au"): 0.095,
    ("au", "us"): 0.110,
    ("eu", "au"): 0.140,
    ("au", "eu"): 0.155,
    ("asia", "au"): 0.060,
    ("au", "asia"): 0.070,
}

#: The wan scenario's default propagation SLO (virtual ms): a few
#: gossip hops across the worst configured path.  Applied when the
#: caller passes no explicit bound AND telemetry makes it measurable.
WAN_DEFAULT_P95_BOUND_MS = 1500.0


def wan(
    region_nodes: int = 10,
    blocks: int = 6,
    seed: int = 0,
    difficulty: int = 8,
    inter_bandwidth_bps: float = 100e6,
    wall_limit_s: float | None = 240.0,
    telemetry: bool = True,
    propagation_p95_bound_ms: float | None = None,
    device: str = "cuda",
) -> dict:
    """Four regions (us/eu/asia/au) with asymmetric inter-region
    latency and shaped bandwidth; blocks are mined round-robin across
    regions.  ok = global convergence, the measured propagation p95
    actually shows the geography (at least one inter-region one-way
    latency — the proof the latency model is load-bearing), AND — from
    the telemetry histograms — the mesh-wide virtual-time
    propagation p95 stays under ``propagation_p95_bound_ms``: a few
    gossip hops across the worst configured path, an actual latency SLO
    instead of bare convergence.

    ``propagation_p95_bound_ms``: None applies the default SLO
    (``WAN_DEFAULT_P95_BOUND_MS``) when the histograms exist and marks
    the SLO ``"unevaluated"`` — excluded from ``ok``, never silently
    passed — when telemetry is off; an EXPLICIT bound with telemetry
    disabled raises ``ValueError`` up front (a bound that cannot be
    measured must fail loudly, not fall back vacuously — the
    negative-control contract; tests/test_scenarios.py carries the negative control)."""
    if not telemetry and propagation_p95_bound_ms is not None:
        raise ValueError(
            "a propagation p95 bound was requested but telemetry is "
            "disabled: the SLO is unmeasurable, not vacuously true"
        )
    regions = ("us", "eu", "asia", "au")
    net = SimNet(
        seed=seed,
        device=device,
        difficulty=difficulty,
        default_profile=LinkProfile(latency_s=0.002, jitter_s=0.001),
        telemetry=telemetry,
    )
    t0 = time.monotonic()

    def region_host(r: str, i: int) -> str:
        return f"10.{regions.index(r) + 1}.0.{i}"

    async def main():
        rng = random.Random(seed ^ 0x3A11)
        by_region: dict[str, list[str]] = {r: [] for r in regions}
        # Profiles first (between region /24s), then nodes: every pair
        # of cross-region hosts gets the matrix latency + shared
        # bandwidth shaping; intra-region stays on the LAN default.
        all_hosts = [
            (r, region_host(r, i))
            for r in regions
            for i in range(region_nodes)
        ]
        for ra, ha in all_hosts:
            for rb, hb in all_hosts:
                if ra != rb:
                    net.net.set_profile(
                        ha,
                        hb,
                        LinkProfile(
                            latency_s=_WAN_LATENCY[(ra, rb)],
                            jitter_s=0.004,
                            bandwidth_bps=inter_bandwidth_bps,
                        ),
                        symmetric=False,
                    )
        for idx, (r, host) in enumerate(all_hosts):
            peers = []
            mine_region = by_region[r]
            if mine_region:
                peers.append(mine_region[-1])  # region backbone
                if len(mine_region) > 1:
                    peers.append(mine_region[rng.randrange(len(mine_region))])
            if idx > 0 and (not mine_region or len(mine_region) % 3 == 1):
                # A gateway link into the regions dialed so far.
                others = [h for _r, h in all_hosts[:idx] if _r != r]
                if others:
                    peers.append(others[rng.randrange(len(others))])
            await net.add_node(name=host, peers=peers)
            by_region[r].append(host)
        assert await net.run_until(
            net.links_up, 60, step=0.1, wall_limit_s=wall_limit_s
        ), "wan mesh never formed"

        for b in range(blocks):
            r = regions[b % len(regions)]
            await net.mine_on(
                net.nodes[by_region[r][0]], spacing_s=3.0
            )
        done = await net.run_until(
            lambda: net.converged() and min(net.heights()) == blocks,
            120, step=0.25, wall_limit_s=wall_limit_s,
        )
        summaries = [
            n.metrics.propagation_summary() for n in net.nodes.values()
        ]
        p95s = [s["p95_ms"] for s in summaries if s["p95_ms"] is not None]
        max_p95_ms = max(p95s) if p95s else 0.0
        min_inter_ms = 1e3 * min(_WAN_LATENCY.values())
        report = _report(
            net, "wan", t0,
            regions={r: len(by_region[r]) for r in regions},
            blocks=blocks,
            propagation_max_p95_ms=max_p95_ms,
            min_inter_region_latency_ms=min_inter_ms,
            geography_visible=max_p95_ms >= min_inter_ms,
        )
        # The telemetry-histogram SLO: mesh-wide p95 propagation (in
        # virtual ms, merged across every node) under the bound.  Three
        # explicit states, none vacuous (the fix — the old
        # code read "no histogram" as "bounded"):
        #   evaluated    — histograms exist, the bound was checked;
        #   unevaluated  — telemetry off AND no bound requested: the
        #                  SLO is out of scope, marked so, and excluded
        #                  from ``ok`` (never counted as a pass);
        #   unmeasurable — a bound applies but the histograms are
        #                  missing (telemetry on, nothing recorded):
        #                  that is a FAILURE, not a pass.
        prop = report["telemetry"]["propagation"]
        bound = (
            WAN_DEFAULT_P95_BOUND_MS
            if propagation_p95_bound_ms is None
            else propagation_p95_bound_ms
        )
        report["propagation_p95_bound_ms"] = bound if telemetry else None
        if not telemetry:
            report["propagation_slo"] = "unevaluated"
            report["propagation_bounded"] = None
            slo_ok = True  # out of scope by request, and SAYS so
        elif prop is None:
            report["propagation_slo"] = "unmeasurable"
            report["propagation_bounded"] = False
            slo_ok = False
        else:
            report["propagation_slo"] = "evaluated"
            report["propagation_bounded"] = prop["p95_ms"] <= bound
            slo_ok = report["propagation_bounded"]
        report["ok"] = bool(
            done
            and report["converged"]
            and report["ledger_conserved"]
            and report["geography_visible"]
            and slo_ok
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- snapshot join (untrusted snapshot sync) -----------------------------


def snapshot_join(
    nodes: int = 16,
    chain_blocks: int = 10,
    seed: int = 0,
    difficulty: int = 8,
    interval: int = 4,
    lie: str | None = None,
    liar_height: int = 12,
    verdict_timeout_vs: float = 300.0,
    wall_limit_s: float | None = 240.0,
    device: str = "cuda",
) -> dict:
    """Untrusted snapshot sync (chain/snapshot.py) at mesh scale.

    Honest form (``lie=None``): a fresh node joins a converged mesh
    with ``--snapshot-sync`` on, boots ASSUMED from a peer-served
    checkpoint snapshot, serves balance queries immediately, and must
    flip to fully-validated once the background replay reproduces the
    state root.  The report measures the assumed-boot and flip times in
    virtual seconds, and re-checks every balance the joiner reported
    while ASSUMED against the audit view of the validated chain — the
    never-contradicted invariant.

    Lying form (``lie`` in "balance"/"root"/"truncate"/"stall"): the
    joiner's FIRST peer is a hostile snapshot server running that
    pathology on a taller fork.  ok = the joiner detects/contains it
    (divergence + quarantine for the internally-consistent "balance"
    lie; refusal/failover for the rest), ends fully-validated, and the
    whole network still converges with the ledger conserved."""
    from p1_tpu_torch.chain.ledger import balances as audit_balances
    from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks

    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    WALLET = "snapshot-wallet"

    async def main():
        rng = random.Random(seed ^ 0x54A9)
        for i in range(nodes):
            await net.add_node(
                peers=[
                    net.host_name(j) for j in _topology_peers(rng, i, 3)
                ],
                snapshot_interval=interval,
                **({"miner_id": WALLET} if i == 0 else {}),
            )
        hosts = list(net.nodes)
        miner = net.nodes[hosts[0]]
        assert await net.run_until(
            net.links_up, 60, step=0.1, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        for _ in range(chain_blocks):
            await net.mine_on(miner, spacing_s=1.0)
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == chain_blocks,
            120, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never converged pre-join"

        peers = [hosts[0], hosts[1]]
        liar = None
        if lie is not None:
            from p1_tpu_torch.node.protocol import MsgType

            if lie in ("balance", "root"):
                plan = FaultPlan(snapshot_lie=lie)
            elif lie == "truncate":
                plan = FaultPlan(snapshot_chunks=1)
            else:
                plan = FaultPlan(swallow=frozenset({MsgType.GETSNAPSHOT}))
            src = "66.9.9.1"
            liar = HostilePeer(
                make_blocks(liar_height, difficulty, miner_id="snapliar"),
                plan=plan,
                transport=net.net.host(src),
                host=src,
                rng=random.Random(seed * 31 + 7),
            )
            await liar.start()
            peers = [f"{src}:{liar.port}", hosts[0]]

        join_at = net.clock.now
        joiner = await net.add_node(
            name="10.99.9.9",
            peers=peers,
            snapshot_sync=True,
            snapshot_interval=interval,
            snapshot_min_lead=2,
        )
        assumed = await net.run_until(
            lambda: joiner.validation_state == "assumed",
            60, step=0.1, wall_limit_s=wall_limit_s,
        )
        assumed_vs = net.clock.now - join_at
        samples: list[tuple[int, bytes, int]] = []

        def sample():
            if joiner.validation_state == "assumed":
                samples.append(
                    (
                        joiner.chain.height,
                        joiner.chain.tip_hash,
                        joiner.chain.balance(WALLET),
                    )
                )
            return False

        await net.run_until(
            sample, 2.0, step=0.5, wall_limit_s=wall_limit_s
        )
        verdict = await net.run_until(
            lambda: joiner.validation_state == "validated"
            and joiner._bg_chain is None,
            verdict_timeout_vs, step=0.25, wall_limit_s=wall_limit_s,
        )
        verdict_vs = net.clock.now - join_at
        # Post-verdict: one more honest block must reach the joiner.
        await net.mine_on(miner, spacing_s=1.0)
        settled = await net.run_until(
            lambda: net.converged(), 120, step=0.25,
            wall_limit_s=wall_limit_s,
        )
        contradicted = 0
        ref = net.nodes[hosts[0]].chain
        if joiner.metrics.snapshot_flips:
            for height, tip_hash, reported in samples:
                if ref.main_hash_at(height) != tip_hash:
                    continue  # claim's block reorged away: retracted
                blocks = [
                    ref._block_at(ref.main_hash_at(h))
                    for h in range(height + 1)
                ]
                if audit_balances(blocks).get(WALLET, 0) != reported:
                    contradicted += 1
        report = _report(
            net, "snapshot-join", t0,
            lie=lie,
            assumed=assumed,
            assumed_virtual_s=round(assumed_vs, 3),
            verdict=verdict,
            verdict_virtual_s=round(verdict_vs, 3),
            flips=joiner.metrics.snapshot_flips,
            divergences=joiner.metrics.snapshot_divergences,
            assumed_samples=len(samples),
            samples_contradicted=contradicted,
        )
        if lie is None:
            report["ok"] = bool(
                assumed
                and verdict
                and settled
                and joiner.metrics.snapshot_flips == 1
                and joiner.metrics.snapshot_divergences == 0
                and contradicted == 0
                and report["ledger_conserved"]
            )
        elif lie == "balance":
            # Internally consistent lie: adopted, then CAUGHT by the
            # background replay — quarantined, fallen back, converged.
            report["ok"] = bool(
                assumed
                and verdict
                and settled
                and joiner.metrics.snapshot_divergences >= 1
                and joiner.metrics.snapshot_flips == 0
                and report["ledger_conserved"]
            )
        else:
            # root/truncate/stall: refused or failed over BEFORE any
            # state was trusted — the joiner may end up assuming an
            # honest peer's snapshot instead (and must then flip).
            report["ok"] = bool(
                verdict
                and settled
                and contradicted == 0
                and report["ledger_conserved"]
            )
        if liar is not None:
            await liar.stop()
        await net.stop_all()
        return report

    return net.run(main())


# -- far field: the sharded 10k-node scenario ----------------------------


def far_field(
    nodes: int = 10_000,
    full_nodes: int = 16,
    blocks: int = 8,
    seed: int = 0,
    difficulty: int = 8,
    degree: int = 4,
    shards: int = 1,
    processes: bool | None = None,
    spacing_s: float = 4.0,
    far_settle_bound_ms: float = 60_000.0,
    wall_limit_s: float | None = 420.0,
    device: str = "cuda",
) -> dict:
    """An order of magnitude past the full simulator: a ``full_nodes``
    core mesh of REAL nodes mines and converges as usual, and every
    announcement then propagates through a ``nodes - full_nodes``
    header-only far field (node/farfield.py) — sharded ``shards`` ways,
    across processes when ``shards > 1`` (``processes=False`` keeps the
    same sharded exchange in one process for determinism pairs).

    ok = the core converges with the ledger conserved, EVERY far-field
    node ends on the core's final tip, and the far field's last header
    arrival lands within ``far_settle_bound_ms`` virtual ms of its
    injection (the convergence-lag SLO; an impossible bound must fail —
    the control test).  The report's ``trace_digest`` is the MERGED
    digest — core event trace + far-field delivery trace — and must be
    byte-identical for the same seed at 1 shard and at N shards, in
    process and across processes (the acceptance pair)."""
    import hashlib

    from p1_tpu_torch.node.farfield import run_far_field

    assert full_nodes >= 2 and nodes > full_nodes
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    feed: list[tuple[float, int, str, str]] = []

    async def main():
        rng = random.Random(seed ^ 0xFA2F)
        for i in range(full_nodes):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)]
            )
        hosts = list(net.nodes)
        miner = net.nodes[hosts[0]]
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "core mesh never formed"
        for _ in range(blocks):
            t_inject = net.clock.now
            block = await net.mine_on(miner, spacing_s=spacing_s)
            parent = feed[-1][2] if feed else ""
            feed.append(
                (
                    t_inject,
                    miner.chain.height,
                    block.block_hash().hex()[:16],
                    parent,
                )
            )
        done = await net.run_until(
            lambda: net.converged() and min(net.heights()) == blocks,
            120, step=0.25, wall_limit_s=wall_limit_s,
        )
        report = _report(
            net, "far-field", t0,
            repro_flags=f"--shards {shards}",
            core_done=done,
        )
        await net.stop_all()
        return report

    report = net.run(main())
    far = run_far_field(
        nodes - full_nodes,
        seed,
        feed,
        degree=degree,
        shards=shards,
        processes=processes,
        wall_limit_s=wall_limit_s,
    )
    core_digest = report["trace_digest"]
    report.update(
        nodes=nodes,
        full_nodes=full_nodes,
        far_nodes=far.nodes,
        shards=far.shards,
        shard_processes=far.processes,
        far_deliveries=far.deliveries,
        far_barrier_rounds=far.rounds,
        far_converged_nodes=far.converged_nodes,
        far_converged=far.converged,
        far_settle_ms=far.settle_ms,
        far_settle_bound_ms=far_settle_bound_ms,
        far_propagation_p50_ms=far.propagation_p50_ms,
        far_propagation_p95_ms=far.propagation_p95_ms,
        core_trace_digest=core_digest,
        far_trace_digest=far.trace_digest,
        # THE merged digest: the shard-count-invariance witness.
        trace_digest=hashlib.sha256(
            (core_digest + far.trace_digest).encode()
        ).hexdigest(),
        wall_s=round(time.monotonic() - t0, 3),
    )
    report["ok"] = bool(
        report["core_done"]
        and report["converged"]
        and report["ledger_conserved"]
        and far.converged
        and far.settle_ms <= far_settle_bound_ms
    )
    return report


# -- selfish mining / block withholding ----------------------------------


def selfish_mining(
    honest: int = 20,
    alpha: float = 0.3,
    finds: int = 120,
    seed: int = 0,
    difficulty: int = 8,
    find_spacing_s: float = 2.0,
    amplification_bound: float = 1.10,
    margin: float = 0.05,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """Eyal–Sirer selfish mining against the real mesh: an attacker
    with hashrate fraction ``alpha`` mines PRIVATELY (an isolated full
    node — nobody dials it, it dials nobody) and releases strategically
    through an honest entry node: withhold while ahead, reveal the
    matching prefix when far ahead, release everything when the honest
    chain draws within one (the override), race at a tie.

    The containment bound under test: this mesh gives the attacker
    γ ≈ 0 — honest nodes NEVER mine on the attacker's block in a tie,
    because fork choice keeps the first-seen tip at equal weight and
    the mesh heard its own block first — and below the γ=0 profit
    threshold (α < ~1/3) selfish mining must then UNDER-perform honest
    mining.  ok asserts the attacker's realized share of the final
    chain's coinbases ≤ ``alpha * amplification_bound + margin`` (plus
    the structural bits: the attack really ran — blocks were withheld,
    at least one override reorged the mesh — and the mesh still
    converged with the ledger conserved).  ``margin=-1`` is the
    impossible-bound control."""
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    ATTACKER = "selfish"

    async def main():
        rng = random.Random(seed ^ 0x5E1F)
        for i in range(honest):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)],
                miner_id=f"honest-{i}",
            )
        hosts = list(net.nodes)
        rep = net.nodes[hosts[0]]  # honest representative / miner
        entry = net.nodes[hosts[1]]  # where attacker blocks enter
        attacker = await net.add_node(
            name="10.66.6.6", peers=[], miner_id=ATTACKER
        )
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        # Warmup: two public blocks (the attacker sees them too — it
        # tracks the public chain even while mining its own).
        for _ in range(2):
            b = await net.mine_on(rep, spacing_s=1.0)
            await attacker._handle_block(b)
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == 2,
            60, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never converged pre-attack"
        warmup_height = rep.chain.height

        withheld: list = []  # unpublished suffix of the private branch
        published: set[bytes] = {rep.chain.tip_hash}
        stats = {
            "withheld_blocks": 0,
            "reveals": 0,
            "overrides": 0,
            "races": 0,
            "attacker_finds": 0,
            "honest_finds": 0,
        }

        async def publish(upto_height: int | None = None) -> None:
            """Release withheld blocks (all, or the prefix at or below
            ``upto_height``) into the mesh through the entry node."""
            while withheld and (
                upto_height is None or withheld[0][0] <= upto_height
            ):
                _h, blk = withheld.pop(0)
                published.add(blk.block_hash())
                await entry._handle_block(blk)
            stats["reveals"] += 1

        for _find in range(finds):
            if rng.random() < alpha:
                stats["attacker_finds"] += 1
                parent_hash = attacker.chain.tip_hash
                blk = await net.mine_on(attacker)  # no peers: stays private
                withheld.append((attacker.chain.height, blk))
                stats["withheld_blocks"] += 1
                if (
                    parent_hash in published
                    and rep.chain.tip_hash != parent_hash
                ):
                    # We were racing at a tie and just pulled ahead:
                    # release immediately — the override that wins both.
                    stats["overrides"] += 1
                    await publish()
            else:
                stats["honest_finds"] += 1
                blk = await net.mine_on(rep)
                await attacker._handle_block(blk)
                if not withheld:
                    pass  # nothing private: honest block just extends
                elif attacker.chain.tip_hash == rep.chain.tip_hash:
                    # The public chain outweighed us: adopt — whatever
                    # was still withheld died on the abandoned branch.
                    withheld.clear()
                else:
                    lead = attacker.chain.height - rep.chain.height
                    if lead <= 0:
                        stats["races"] += 1
                        await publish()  # tie: race the honest block
                    elif lead == 1:
                        stats["overrides"] += 1
                        await publish()  # one ahead: override outright
                    else:
                        await publish(upto_height=rep.chain.height)
            await asyncio.sleep(find_spacing_s)

        # Finale: release anything still private, settle, and let one
        # fresh honest block break any residual tie mesh-wide.
        if withheld:
            await publish()
        await asyncio.sleep(5.0)
        b = await net.mine_on(rep, spacing_s=2.0)
        await attacker._handle_block(b)
        settled = await net.run_until(
            net.converged, 120, step=0.25, wall_limit_s=wall_limit_s
        )

        chain = rep.chain
        revenue = {"attacker": 0, "honest": 0}
        for h in range(warmup_height + 1, chain.height + 1):
            block = chain._block_at(chain.main_hash_at(h))
            who = block.txs[0].recipient
            revenue["attacker" if who == ATTACKER else "honest"] += 1
        total = revenue["attacker"] + revenue["honest"]
        share = revenue["attacker"] / max(1, total)
        actual_alpha = stats["attacker_finds"] / max(1, finds)
        # Bound against the REALIZED hashrate fraction (the seeded
        # draw), not the nominal alpha: the claim is about strategy
        # amplification, not sampling noise.
        bound = actual_alpha * amplification_bound + margin
        mesh_reorgs = sum(
            net.nodes[h].metrics.reorgs for h in hosts
        )
        report = _report(
            net, "selfish-mining", t0,
            alpha=alpha,
            actual_alpha=round(actual_alpha, 4),
            finds=finds,
            **stats,
            attacker_blocks_on_chain=revenue["attacker"],
            honest_blocks_on_chain=revenue["honest"],
            attacker_revenue_share=round(share, 4),
            honest_revenue_share=round(1 - share, 4),
            revenue_share_bound=round(bound, 4),
            containment_held=share <= bound,
            honest_mesh_reorgs=mesh_reorgs,
            settled=settled,
        )
        report["ok"] = bool(
            settled
            and report["converged"]
            and report["ledger_conserved"]
            and report["containment_held"]
            # The attack must actually have run, or the containment
            # claim is vacuous: private blocks were withheld, and at
            # least one override forced honest nodes through a reorg.
            and stats["withheld_blocks"] > 0
            and stats["overrides"] >= 1
            and mesh_reorgs >= 1
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- fee-spam economics vs the governor ----------------------------------


def fee_spam(
    nodes: int = 10,
    spammers: int = 3,
    honest_txs: int = 18,
    seed: int = 0,
    difficulty: int = 8,
    spam_fee: int = 0,
    honest_fee: int = 2,
    spam_rate_per_s: float = 120.0,
    storm_vs: float = 45.0,
    block_every_vs: float = 5.0,
    max_block_txs: int = 8,
    confirm_bound_blocks: int = 4,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """Fee-market spam against the governor: ``spammers`` hosts
    each fund ONE wallet with a single coinbase (the spend limit — spam
    must be protocol-valid, and validity costs balance), then stream TX
    frames at ``spam_rate_per_s`` — real signed zero/low-fee transfers,
    replayed and over-extended past the balance — at honest nodes,
    while an honest wallet submits ``honest_txs`` normal-fee transfers
    and miners keep producing small blocks (``max_block_txs`` squeezes
    capacity so ordering matters).

    The layered defense under test, measured separately: the
    governor's per-peer tx budget drops the firehose at the dispatch
    door (and escalates to a ban), pool admission's balance/debit
    accounting caps what one funded wallet can ever occupy, and
    fee-ordered block selection seats honest transactions first.

    ok = the never-starved invariant — EVERY honest transaction
    confirms within ``confirm_bound_blocks`` blocks of submission —
    plus: the spam genuinely pressured the door (admission drops > 0),
    the spend limit held (mined spam ≤ what the spam balance affords),
    and the mesh converged with the ledger conserved.
    ``confirm_bound_blocks=0`` is the impossible-bound control."""
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import BLOCK_REWARD, Transaction
    from p1_tpu_torch.node import protocol
    from p1_tpu_torch.node.governor import CLASS_TXS

    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    spam_wallets = [
        Keypair.from_seed_text(f"p1-spam-{seed}-{k}") for k in range(spammers)
    ]
    honest_wallet = Keypair.from_seed_text(f"p1-honest-{seed}")
    payee = Keypair.from_seed_text(f"p1-payee-{seed}")

    async def main():
        rng = random.Random(seed ^ 0xFEE5)
        for i in range(nodes):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)],
                max_block_txs=max_block_txs,
                miner_id="pool",
            )
        hosts = list(net.nodes)
        miner = net.nodes[hosts[0]]
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        # Funding: one coinbase per spam wallet (THE spend limit), two
        # for the honest wallet — by mining blocks whose coinbase pays
        # each wallet directly.
        for w in (*spam_wallets, honest_wallet, honest_wallet):
            miner.miner_id = w.account
            await net.mine_on(miner, spacing_s=1.0)
        miner.miner_id = "pool"
        fund_height = miner.chain.height
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == fund_height,
            60, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never converged post-funding"

        genesis = genesis_hash(difficulty)
        spam_budget = spammers * BLOCK_REWARD

        async def spam(k: int) -> dict:
            """One spammer host: HELLO, then a TX firehose — its funded
            set first, then replays and beyond-balance extensions."""
            srng = random.Random(seed * 91 + k)
            wallet = spam_wallets[k]
            victim = hosts[(k + 1) % len(hosts)]
            src = f"66.7.0.{k}"
            # Twice the affordable set: the second half is guaranteed
            # over-balance (amount 1 + fee over a BLOCK_REWARD budget).
            txs = [
                Transaction.transfer(
                    wallet, payee.account, 1, spam_fee, s, chain=genesis
                )
                for s in range(2 * BLOCK_REWARD)
            ]
            frames = [protocol.encode_tx(tx) for tx in txs]
            sent = dropped = 0
            deadline = net.clock.now + storm_vs
            try:
                reader, writer = await net.net.host(src).connect(
                    victim, NODE_PORT
                )
                await protocol.write_frame(
                    writer,
                    protocol.encode_hello(
                        protocol.Hello(
                            genesis, 0, 1, srng.getrandbits(64) | 1
                        )
                    ),
                )
                await protocol.read_frame(reader)
                i = 0
                while net.clock.now < deadline:
                    if writer.is_closing():
                        dropped = 1  # the ban layer severed the session
                        break
                    await protocol.write_frame(writer, frames[i % len(frames)])
                    sent += 1
                    i += 1
                    await asyncio.sleep(1.0 / spam_rate_per_s)
                writer.close()
            except (ConnectionError, OSError, asyncio.IncompleteReadError):
                dropped = 1  # governor escalation severed / refused us
            return {"sent": sent, "severed": dropped}

        async def honest_traffic() -> list[dict]:
            """The honest wallet: normal-fee transfers via its node's
            submit API, spread over the storm."""
            rows = []
            gap = storm_vs / (honest_txs + 1)
            for _ in range(honest_txs):
                await asyncio.sleep(gap)
                node = net.nodes[hosts[2]]
                acct = honest_wallet.account
                seqno = node.mempool.pending_next_seq(
                    acct, node.chain.nonce(acct)
                )
                tx = Transaction.transfer(
                    honest_wallet, payee.account, 1, honest_fee, seqno,
                    chain=genesis,
                )
                await node.submit_tx(tx)
                rows.append(
                    {
                        "txid": tx.txid(),
                        "submitted_vs": net.clock.now,
                        "submitted_height": miner.chain.height,
                    }
                )
            return rows

        async def mining() -> int:
            blocks = 0
            while net.clock.now < t_storm0 + storm_vs + 2 * block_every_vs:
                await asyncio.sleep(block_every_vs)
                await net.mine_on(miner)
                blocks += 1
            return blocks

        t_storm0 = net.clock.now
        spam_results, honest_rows, blocks_mined = (
            await asyncio.gather(
                asyncio.gather(*(spam(k) for k in range(spammers))),
                honest_traffic(),
                mining(),
            )
        )
        # Post-storm: drain any honest stragglers with a few clean
        # blocks, then settle.
        for _ in range(confirm_bound_blocks or 1):
            await net.mine_on(miner, spacing_s=1.0)
        settled = await net.run_until(
            net.converged, 120, step=0.25, wall_limit_s=wall_limit_s
        )

        chain = miner.chain
        confirmed = []
        for row in honest_rows:
            bhash = chain._tx_index.get(row["txid"])
            if bhash is not None:
                confirmed.append(
                    chain.height_of(bhash) - row["submitted_height"]
                )
        spam_mined = 0
        spam_accounts = {w.account for w in spam_wallets}
        for h in range(fund_height + 1, chain.height + 1):
            for tx in chain._block_at(chain.main_hash_at(h)).txs[1:]:
                if tx.sender in spam_accounts:
                    spam_mined += 1
        door_drops = sum(
            net.nodes[h].governor.admission_drops[CLASS_TXS] for h in hosts
        )
        spam_sent = sum(r["sent"] for r in spam_results)
        # Escalation reached the misbehavior layer: spam hosts scored
        # (and, transiently, banned — the 30 s ban itself expires).
        spam_scored = sum(
            1
            for k in range(spammers)
            if any(
                f"66.7.0.{k}" in net.nodes[h]._violations for h in hosts
            )
        )
        report = _report(
            net, "fee-spam", t0,
            spammers=spammers,
            spam_frames_sent=spam_sent,
            spammers_scored=spam_scored,
            admission_tx_drops=door_drops,
            spam_txs_mined=spam_mined,
            spam_budget_txs=spam_budget,
            blocks_mined_in_storm=blocks_mined,
            honest_submitted=len(honest_rows),
            honest_confirmed=len(confirmed),
            honest_confirm_blocks_max=max(confirmed, default=0),
            confirm_bound_blocks=confirm_bound_blocks,
            settled=settled,
        )
        report["ok"] = bool(
            settled
            and report["converged"]
            and report["ledger_conserved"]
            # Never starved: every honest tx confirmed, within bound.
            and len(confirmed) == len(honest_rows)
            and (max(confirmed, default=0) <= confirm_bound_blocks)
            # The flood was real (the door dropped frames) and the
            # spend limit held (mined spam within the funded budget).
            and door_drops > 0
            and spam_mined <= spam_budget
            and spam_sent > spam_budget
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- difficulty-retarget oscillation under hashrate shocks ---------------


def retarget_shock(
    nodes: int = 8,
    seed: int = 0,
    difficulty: int = 8,
    window: int = 8,
    spacing: int = 8,
    warm_windows: int = 2,
    shock_factor: int = 8,
    shock_windows: int = 4,
    recovery_windows: int = 10,
    overshoot_bound_bits: int | None = None,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """A hashrate step against the retarget rule, at mesh level: the
    chain runs an opt-in ``RetargetRule(window, spacing)``; the
    scenario drives block finds at the interval the CURRENT difficulty
    and a stepped hashrate imply (``spacing * 2^(d - d0) / h`` — a
    ``shock_factor`` x hashrate jump finds blocks that much faster
    until difficulty catches up), holds the shock for
    ``shock_windows``, then drops the hashrate back.

    The oscillation question is whether the clamp
    (core/retarget.py ``adjusted``: at most ``max_adjust`` bits per
    retarget) bounds the overshoot.  ok asserts, from the sealed
    headers every node converged on: (a) every retarget moved at most
    ``max_adjust`` bits — the clamp held THROUGH assembly and
    validation, not just in the unit rule; (b) peak difficulty never
    exceeded the shock equilibrium ``d0 + log2(shock_factor)`` by more
    than ``overshoot_bound_bits`` (default: ``max_adjust``); (c) the
    DOWNWARD swing is clamp-bounded too — a shock deep enough to hit
    the ``max_step`` timestamp cap leaves the chain clock lagging the
    wall, and the catch-up reads as inflated spans that drag
    difficulty BELOW base on the way back (the oscillation this
    scenario exists to measure): the undershoot must stay within
    ``max_adjust`` bits of base; (d) the rule actually responded
    (peak ≥ 2 bits over base — the load-bearing control;
    ``overshoot_bound_bits=-3`` is the impossible-bound control test);
    (e) after recovery the difficulty returns to within one bit of
    base and holds for the final window.  tests/test_retarget.py pins
    the same clamp at the unit level."""
    import math

    from p1_tpu_torch.core.retarget import RetargetRule

    rule = RetargetRule(window, spacing)
    if overshoot_bound_bits is None:
        overshoot_bound_bits = rule.max_adjust
    shock_bits = round(math.log2(shock_factor))
    base_difficulty = difficulty
    net = SimNet(seed=seed, difficulty=base_difficulty, device=device)
    t0 = time.monotonic()

    async def main():
        rng = random.Random(seed ^ 0x4E7A)
        for i in range(nodes):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)],
                retarget_window=window,
                target_spacing=spacing,
            )
        hosts = list(net.nodes)
        miner = net.nodes[hosts[0]]
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"

        phases = (
            [1] * (warm_windows * window)
            + [shock_factor] * (shock_windows * window)
            + [1] * (recovery_windows * window)
        )
        for h_rate in phases:
            d = miner.chain.required_difficulty(miner.chain.tip_hash)
            dt = spacing * (2.0 ** (d - base_difficulty)) / h_rate
            await net.mine_on(miner, spacing_s=dt)
        final_height = len(phases)
        settled = await net.run_until(
            lambda: net.converged() and min(net.heights()) == final_height,
            180, step=0.25, wall_limit_s=wall_limit_s,
        )

        chain = miner.chain
        series = [
            chain._block_at(chain.main_hash_at(h)).header.difficulty
            for h in range(1, chain.height + 1)
        ]
        deltas = [
            series[i] - series[i - 1] for i in range(1, len(series))
        ]
        clamp_held = all(abs(d) <= rule.max_adjust for d in deltas)
        peak = max(series)
        trough = min(series[warm_windows * window :])
        eq_shock = base_difficulty + shock_bits
        tail = series[-window:]
        report = _report(
            net, "retarget-shock", t0,
            window=window,
            spacing=spacing,
            max_adjust=rule.max_adjust,
            shock_factor=shock_factor,
            difficulty_series=series,
            base_difficulty=base_difficulty,
            peak_difficulty=peak,
            trough_difficulty=trough,
            shock_equilibrium=eq_shock,
            overshoot_bits=peak - eq_shock,
            undershoot_bits=base_difficulty - trough,
            overshoot_bound_bits=overshoot_bound_bits,
            retarget_clamp_held=clamp_held,
            responded=peak >= base_difficulty + 2,
            recovered=max(tail) <= base_difficulty + 1
            and min(tail) >= max(1, base_difficulty - 1),
            settled=settled,
        )
        report["ok"] = bool(
            settled
            and report["converged"]
            and report["ledger_conserved"]
            and clamp_held
            and report["responded"]
            and peak - eq_shock <= overshoot_bound_bits
            and base_difficulty - trough <= rule.max_adjust
            and report["recovered"]
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- snapshot cartel ------------------------------------------------------


def snapshot_cartel(
    nodes: int = 12,
    cartel: int = 3,
    joiners: int = 2,
    chain_blocks: int = 10,
    liar_height: int = 8,
    interval: int = 4,
    seed: int = 0,
    difficulty: int = 8,
    honest_extra_blocks: int = 4,
    verdict_timeout_vs: float = 300.0,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """Coordinated lying-snapshot servers vs the snapshot divergence
    machinery: ``cartel`` hostile peers serve the SAME internally
    consistent lying snapshot (one shared fork with forged balances,
    its HELLO advertising a far-ahead tip), and every joiner's peer
    list puts
    the whole cartel ahead of its one honest contact — so snapshot
    failover lands on another liar telling the same story.

    The containment path under test: each joiner adopts a cartel
    snapshot (ASSUMED — the cartel's HELLO advertises a far-ahead tip
    so its snapshot out-bids the honest mesh's), background
    revalidation replays the cartel's own history, the state root
    refuses to reproduce → divergence → quarantine + server demotion →
    genesis IBD onto the honest chain.
    The cartel's fork is a VALID chain but carries LESS work than the
    honest one (``liar_height < chain_blocks``) — deliberately: a
    "cartel" whose fork outweighs the honest chain is a majority-work
    attacker, and no snapshot machinery can (or should) overrule the
    heaviest-chain rule against majority work.  What the snapshot
    plane owes is exactly this: lying STATE never survives, no matter
    how many coordinated servers repeat it.

    ok = every joiner saw ≥1 divergence and 0 flips, ended
    fully-validated on the honest tip (fooled == 0), the honest mesh
    RETAINED ITS OWN HISTORY (the pre-join block at ``chain_blocks``
    is still every node's main chain — the capture detector), and the
    mesh converged with the ledger conserved.  The control test hands
    the cartel a heavier fork (``liar_height > chain_blocks`` with
    ``honest_extra_blocks=0``): the mesh is captured, the history
    anchor breaks, and ok goes false — proving the assertion detects
    exactly the takeover it exists to catch."""
    from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks

    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()

    async def main():
        rng = random.Random(seed ^ 0xCA47)
        for i in range(nodes):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)],
                snapshot_interval=interval,
            )
        hosts = list(net.nodes)
        miner = net.nodes[hosts[0]]
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        for _ in range(chain_blocks):
            await net.mine_on(miner, spacing_s=1.0)
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == chain_blocks,
            120, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never converged pre-join"
        honest_anchor = miner.chain.main_hash_at(chain_blocks)

        # ONE shared lying chain: the cartel's consistency is the
        # attack — a joiner that fails over cross-checks nothing.
        lying_chain = make_blocks(
            liar_height, difficulty, miner_id="cartel"
        )
        servers = []
        for k in range(cartel):
            src = f"66.9.9.{k}"
            hp = HostilePeer(
                lying_chain,
                # Lying is free: the cartel advertises a far-ahead tip
                # (so joiners prefer its snapshot over the honest
                # mesh's) while serving its short fork and the forged
                # state — the snapshot plane must catch the STATE lie
                # regardless of what the HELLO claimed.
                plan=FaultPlan(
                    snapshot_lie="balance",
                    hello_height=chain_blocks + 16,
                ),
                transport=net.net.host(src),
                host=src,
                rng=random.Random(seed * 37 + k),
            )
            await hp.start()
            servers.append(hp)

        joined = []
        for j in range(joiners):
            peers = [
                f"{hp.host}:{hp.port}" for hp in servers
            ] + [hosts[j % len(hosts)]]
            node = await net.add_node(
                name=f"10.99.8.{j}",
                peers=peers,
                snapshot_sync=True,
                snapshot_min_lead=2,
                snapshot_interval=interval,
            )
            joined.append(node)
            await asyncio.sleep(1.0)

        verdicts = await net.run_until(
            lambda: all(
                n.validation_state == "validated" and n._bg_chain is None
                for n in joined
            ),
            verdict_timeout_vs, step=0.25, wall_limit_s=wall_limit_s,
        )
        # Honest hashrate outruns the cartel's static fork.
        for _ in range(honest_extra_blocks):
            await net.mine_on(miner, spacing_s=1.0)
        settled = await net.run_until(
            net.converged, 180, step=0.25, wall_limit_s=wall_limit_s
        )

        honest_tip = miner.chain.tip_hash
        history_kept = all(
            net.nodes[h].chain.main_hash_at(chain_blocks) == honest_anchor
            for h in hosts
        )
        fooled = sum(
            1
            for n in joined
            if n.chain.tip_hash != honest_tip
            or n.validation_state != "validated"
        )
        divergences = sum(
            n.metrics.snapshot_divergences for n in joined
        )
        flips = sum(n.metrics.snapshot_flips for n in joined)
        cartel_hosts = {hp.host for hp in servers}
        cartel_scored = sum(
            1
            for n in joined
            for h in sorted(cartel_hosts)
            if h in n._violations
        )
        report = _report(
            net, "snapshot-cartel", t0,
            cartel=cartel,
            joiners=joiners,
            liar_height=liar_height,
            verdicts=verdicts,
            divergences=divergences,
            flips=flips,
            fooled=fooled,
            cartel_servers_scored=cartel_scored,
            honest_history_kept=history_kept,
            honest_extra_blocks=honest_extra_blocks,
            settled=settled,
        )
        report["ok"] = bool(
            verdicts
            and settled
            and report["converged"]
            and report["ledger_conserved"]
            and divergences >= joiners
            and flips == 0
            and fooled == 0
            and history_kept
        )
        for hp in servers:
            await hp.stop()
        await net.stop_all()
        return report

    return net.run(main())


# -- version-bits activation ---------------------------------------------


def version_activation(
    nodes: int = 8,
    seed: int = 0,
    difficulty: int = 8,
    vb_window: int = 8,
    vb_threshold: int = 6,
    straggler_per_window: int = 2,
    extra_windows: int = 1,
    fork_bound: int = 0,
    margin: int = 0,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """BIP9-analog version-bits activation on a MIXED-version mesh: a
    majority of nodes signal ``feature-x`` on bit 0 while one
    straggler runs the legacy table — it mines literal ``version=1``
    forever and has never heard of deployments.  The straggler keeps a
    deterministic slice of the hashrate (``straggler_per_window`` block
    slots per retarget-window), so the signaling window carries exactly
    ``vb_window - straggler_per_window`` signaling blocks — at or above
    ``vb_threshold`` by construction — and the deployment must walk
    DEFINED → STARTED → LOCKED_IN → ACTIVE at the predicted heights.

    The no-fork bound under test: header ``version`` is NOT consensus
    here (exactly as in Bitcoin's soft-fork deployments pre-enforcement),
    so the mixed mesh must never diverge — not while the stragglers'
    legacy blocks interleave with signaling ones pre-activation, not at
    the LOCKED_IN boundary, and not after ACTIVE clears the signal bit.
    ok asserts persistent-fork observations ≤ ``fork_bound + margin``
    (``margin=-1`` is the impossible-bound control) plus the structural
    bits: the straggler really mined on both sides of activation and its
    blocks were accepted by everyone, and the signaling window really
    carried ≥ threshold signaling headers."""
    assert vb_window - straggler_per_window >= vb_threshold, (
        "shape can never lock in: raise the signaling share"
    )
    start = vb_window  # first full window: heights [W, 2W)
    deploy = (("feature-x", 0, start, vb_window * 16),)
    # Ladder prediction, in tip heights at window boundaries: the
    # window [W, 2W) is STARTED and is the one whose signal count is
    # judged, so LOCKED_IN begins at 2W and ACTIVE at 3W.
    activation_height = 3 * vb_window
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    STRAGGLER = "straggler"

    async def main():
        from p1_tpu_torch.chain.versionbits import TOP_BITS, signals

        rng = random.Random(seed ^ 0xB1B9)
        for i in range(nodes - 1):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)],
                miner_id=f"signal-{i}",
                deployments=deploy,
                vb_window=vb_window,
                vb_threshold=vb_threshold,
            )
        hosts = list(net.nodes)
        rep = net.nodes[hosts[0]]
        # The straggler joins the same mesh as a full peer — the point
        # is precisely that nothing about deployments is negotiated.
        straggler = await net.add_node(
            peers=[hosts[0], hosts[-1]], miner_id=STRAGGLER
        )
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"

        dep_report = (
            lambda: rep.versionbits.states_report(rep.chain)["feature-x"]
        )
        ladder: dict[int, str] = {0: dep_report()["state"]}
        versions = {"signaling": set(), "straggler": set()}
        stats = {
            "straggler_finds": 0,
            "straggler_finds_pre_activation": 0,
            "signal_finds": 0,
            "fork_checks": 0,
            "forks_observed": 0,
        }

        # Versionbits windows are ANCHORED at multiples of vb_window
        # (genesis fills slot 0 of window 0), so the straggler's slots
        # are sampled per anchored window — its share of any window the
        # threshold judges is exact, which is what makes the lock-in
        # deterministic rather than a coin flip on the seed.
        target_height = vb_window * (3 + extra_windows) - 1
        window, slots = -1, set()
        for h in range(1, target_height + 1):
            if h // vb_window != window:
                window = h // vb_window
                slots = set(
                    rng.sample(range(vb_window), straggler_per_window)
                )
            if h % vb_window in slots:
                miner, side = straggler, "straggler"
                stats["straggler_finds"] += 1
                if h < activation_height:
                    stats["straggler_finds_pre_activation"] += 1
            else:
                miner = net.nodes[hosts[h % (nodes - 1)]]
                side = "signaling"
                stats["signal_finds"] += 1
            blk = await net.mine_on(miner, spacing_s=1.0)
            versions[side].add(blk.header.version)
            assert await net.run_until(
                lambda: min(net.heights()) >= h,
                60, step=0.25, wall_limit_s=wall_limit_s,
            ), f"block {h} never propagated"
            if h % vb_window == 0:
                # Window boundary: a persistent tip split here is
                # exactly the fork the scenario exists to rule out.
                stats["fork_checks"] += 1
                if not await net.run_until(
                    net.converged, 60, step=0.25,
                    wall_limit_s=wall_limit_s,
                ):
                    stats["forks_observed"] += 1
                ladder[h] = dep_report()["state"]

        settled = await net.run_until(
            net.converged, 120, step=0.25, wall_limit_s=wall_limit_s
        )

        # Chain autopsy: whose coinbases landed, and did the STARTED
        # window really carry enough signaling headers.
        chain = rep.chain
        straggler_on_chain = {"pre": 0, "post": 0}
        signal_bit_in_started_window = 0
        for h in range(1, chain.height + 1):
            block = chain._block_at(chain.main_hash_at(h))
            if block.txs[0].recipient == STRAGGLER:
                side = "pre" if h < activation_height else "post"
                straggler_on_chain[side] += 1
            if start <= h < 2 * vb_window and signals(
                block.header.version, 0
            ):
                signal_bit_in_started_window += 1

        ladder_ok = (
            ladder.get(vb_window) == "started"
            and ladder.get(2 * vb_window) == "locked_in"
            and ladder.get(3 * vb_window) == "active"
        )
        # Every signaling node must agree the bit is ACTIVE; the
        # straggler's report is empty — it has no deployments to state.
        states_agree = all(
            net.nodes[h].versionbits.states_report(net.nodes[h].chain)[
                "feature-x"
            ]["state"] == "active"
            for h in hosts
        ) and straggler.versionbits.states_report(straggler.chain) == {}

        bound = fork_bound + margin
        containment_held = stats["forks_observed"] <= bound
        report = _report(
            net, "version-activation", t0,
            vb_window=vb_window,
            vb_threshold=vb_threshold,
            activation_height=activation_height,
            ladder={str(h): s for h, s in sorted(ladder.items())},
            ladder_ok=ladder_ok,
            states_agree=states_agree,
            signal_bit_in_started_window=signal_bit_in_started_window,
            straggler_blocks_pre_activation=straggler_on_chain["pre"],
            straggler_blocks_post_activation=straggler_on_chain["post"],
            signaling_versions=sorted(
                f"0x{v:08x}" for v in versions["signaling"]
            ),
            straggler_versions=sorted(
                f"0x{v:08x}" for v in versions["straggler"]
            ),
            fork_bound_effective=bound,
            containment_held=containment_held,
            settled=settled,
            **stats,
        )
        report["ok"] = bool(
            settled
            and report["converged"]
            and report["ledger_conserved"]
            and containment_held
            and ladder_ok
            and states_agree
            # The mix must actually have run, or the no-fork claim is
            # vacuous: legacy blocks on BOTH sides of activation, all
            # accepted; the signaling window really cleared threshold;
            # the straggler never emitted anything but literal 1.
            and straggler_on_chain["pre"] > 0
            and straggler_on_chain["post"] > 0
            and signal_bit_in_started_window >= vb_threshold
            and versions["straggler"] == {1}
            and TOP_BITS | 1 in versions["signaling"]
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- registry / CLI entry ------------------------------------------------

def soak(
    seed: int = 0,
    difficulty: int = 8,
    days: float = 7.0,
    nodes: int = 5,
    **kwargs,
) -> dict:
    """Longevity soak: ≥1 virtual WEEK of mesh life (node/chaos.py
    ``longevity_soak``) — steady mining, recurring fault/heal cycles
    across every injector, wallet traffic — with the leak invariants
    (RSS, ban tables, caches, task counts, retry counters) asserted at
    quiesce.  Registered here so `p1 sim soak --seed N` is the one-flag
    repro like every other scenario."""
    from p1_tpu_torch.node.chaos import longevity_soak

    return longevity_soak(
        seed=seed, difficulty=difficulty, days=days, nodes=nodes, **kwargs
    )


def fleet_failover(
    replicas: int = 3,
    sessions: int = 6,
    chain_blocks: int = 4,
    post_blocks: int = 3,
    seed: int = 0,
    difficulty: int = 8,
    wall_limit_s: float | None = 240.0,
    device: str = "cuda",
) -> dict:
    """The kill-one-replica proof, deterministic form: N
    serving replicas on one chain, ``sessions`` wallet watchers whose
    ReplicaSets spread subscriptions across them (distinct
    ``spread_key`` per session), one replica killed MID-PUSH — every
    wallet must fail over at its verified cursor and end the run with a
    gap-free, fully matched confirmation stream: zero missed
    confirmations, by construction of the invariant, not by luck.

    ``ok`` requires: subscriptions actually spread (>= 2 distinct
    active targets before the kill with >= 2 live replicas), at least
    one session failed over, every session's height stream is
    contiguous with every event matched (each block pays the watched
    wallet), and the mesh converged with the ledger conserved.  The
    wall-clock fleet figure (notify p95 under kill, queue depth) is
    ``benchmarks/wallet_plane.py``'s job — this scenario pins the
    CORRECTNESS half in virtual time, replayable by seed."""
    from p1_tpu_torch.node import client

    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    WALLET = "fleet-wallet"

    async def main():
        rng = random.Random(seed ^ 0xF1EE7)
        for i in range(replicas):
            # Every node mines to the watched wallet: any block from
            # any survivor is a confirmation the watchers must see.
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 2)],
                miner_id=WALLET,
            )
        hosts = list(net.nodes)
        assert await net.run_until(
            net.links_up, 60, step=0.1, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        for _ in range(chain_blocks):
            await net.mine_on(net.nodes[hosts[0]], spacing_s=1.0)
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == chain_blocks,
            120, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never converged pre-watch"

        targets = [(h, NODE_PORT) for h in hosts]
        sets = [
            client.ReplicaSet(targets, spread_key=k) for k in range(sessions)
        ]
        streams: list[list[dict]] = [[] for _ in range(sessions)]
        errors: list[str | None] = [None] * sessions

        async def _watch(k: int) -> None:
            transport = net.net.host(f"77.9.0.{k}")
            try:
                async for ev in client.watch(
                    hosts[0], NODE_PORT, [WALLET], difficulty,
                    replica_set=sets[k], transport=transport,
                    cross_check_every=0, reconnect_delay_s=0.5,
                    max_session_failures=None,
                ):
                    streams[k].append(ev)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — judged in the report
                errors[k] = f"{type(e).__name__}: {e}"

        tasks = [asyncio.create_task(_watch(k)) for k in range(sessions)]
        # All ears first (a subscription that lands after the block
        # anchors at the NEW tip and owes nothing for it), then one
        # block that every session must see pushed.
        assert await net.run_until(
            lambda: sum(
                n.subscriptions.snapshot()["live"]
                for n in net.nodes.values()
            ) >= sessions,
            120, step=0.25, wall_limit_s=wall_limit_s,
        ), "sessions never all subscribed"
        await net.mine_on(net.nodes[hosts[0]], spacing_s=1.0)
        assert await net.run_until(
            lambda: all(streams[k] for k in range(sessions)),
            120, step=0.25, wall_limit_s=wall_limit_s,
        ), "not every session saw the pre-kill block"

        actives = [s.active for s in sets if s.active is not None]
        spread = len(set(actives))
        # The directed kill: the replica carrying the most sessions.
        tally: dict[str, int] = {}
        for a in actives:
            tally[a[0]] = tally.get(a[0], 0) + 1
        victim = max(sorted(tally), key=lambda h: tally[h])
        riders = tally[victim]
        await net.crash_node(victim, torn=0)
        survivor = next(h for h in hosts if h != victim)
        for _ in range(post_blocks):
            await net.mine_on(net.nodes[survivor], spacing_s=1.0)
        final_h = net.nodes[survivor].chain.height
        settled = await net.run_until(
            lambda: all(
                streams[k] and streams[k][-1]["height"] >= final_h
                for k in range(sessions)
            ),
            300, step=0.25, wall_limit_s=wall_limit_s,
        )
        for task in tasks:
            task.cancel()
        for task in tasks:
            try:
                await task
            except asyncio.CancelledError:
                pass

        gap_free = all(
            [ev["height"] for ev in s]
            == list(range(s[0]["height"], s[0]["height"] + len(s)))
            for s in streams if s
        )
        all_matched = all(ev["matched"] for s in streams for ev in s)
        failovers = sum(s.failovers for s in sets)
        report = _report(
            net, "fleet-failover", t0,
            repro_flags=f"--replicas {replicas} --sessions {sessions}",
            replicas=replicas,
            sessions=sessions,
            victim=victim,
            victim_riders=riders,
            spread=spread,
            failovers=failovers,
            gap_free=gap_free,
            all_matched=all_matched,
            missed_confirmations=0 if (gap_free and all_matched) else 1,
            errors=[e for e in errors if e],
        )
        report["ok"] = bool(
            settled
            and gap_free
            and all_matched
            and not any(errors)
            and failovers >= riders >= 1
            and (spread >= 2 or replicas < 2 or sessions < 2)
            and report["ledger_conserved"]
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- relay bandwidth budget: flood vs set reconciliation ------------------


def _tx_plane_bytes(node) -> int:
    """Bytes this node has SENT on the transaction plane: TX pushes plus
    every reconciliation frame (node.py ``_RELAY_ACCOUNTING`` families
    ``tx`` + ``recon``).  Blocks, serves, control are excluded — the
    budget under test is tx relay, and nothing else runs during the
    measured storm anyway."""
    rb = node.metrics.relay_bytes()
    return rb.get("tx", 0) + rb.get("recon", 0)


_PROP_BUCKETS_MS = (25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000)


def _prop_histogram(delays_ms: list[float]) -> dict:
    """Fixed-bucket histogram + quantiles of per-(tx, node) propagation
    delays, virtual milliseconds — the per-arm telemetry the A/B report
    carries so a regression shows WHERE the tail moved, not just that
    one number crossed another."""
    buckets = {f"le_{b}ms": 0 for b in _PROP_BUCKETS_MS}
    buckets["inf"] = 0
    s = sorted(delays_ms)
    for d in s:
        for b in _PROP_BUCKETS_MS:
            if d <= b:
                buckets[f"le_{b}ms"] += 1
                break
        else:
            buckets["inf"] += 1

    def pick(q: float) -> float:
        return round(s[min(len(s) - 1, int(q * len(s)))], 1) if s else 0.0

    return {
        "count": len(s),
        "p50_ms": pick(0.50),
        "p95_ms": pick(0.95),
        "max_ms": round(s[-1], 1) if s else 0.0,
        "buckets": buckets,
    }


def relay_budget(
    nodes: int = 16,
    seed: int = 0,
    difficulty: int = 8,
    degree: int = 6,
    senders: int = 4,
    txs_per_sender: int = 48,
    storm_vs: float = 30.0,
    egress_bps: float = 64_000.0,
    recon_interval_s: float = 0.25,
    recon_flood_degree: int = 0,
    min_reduction: float = 5.0,
    wall_limit_s: float | None = 420.0,
    device: str = "cuda",
) -> dict:
    """THE A/B: the identical mesh, the identical
    seeded tx storm, run twice — arm one floods transactions (the
    flood-only relay), arm two reconciles them (``recon_gossip``) —
    and the report holds both arms' per-link byte totals and propagation
    histograms side by side.

    Every host sits behind a shared ``egress_bps`` uplink (the netsim
    per-host shaping): that is the physical budget
    flooding actually spends, because a node that pushes a tx to
    ``degree`` neighbors serializes ``degree`` copies through ONE access
    link.  The recon arm runs spine-less (``recon_flood_degree=0``, the
    bandwidth-optimal configuration: every tx push is diff-driven, so
    nothing is ever sent to a peer that already has it) and must win on
    BOTH axes at once — bytes AND latency — because the flood arm's
    duplicates are what saturate the shared uplinks.

    ok = tx-plane bytes per transaction drop by at least
    ``min_reduction`` (a >=5x budget) AND the recon arm's
    propagation p95 is equal-or-better — efficiency may not be bought
    with latency.  An absurd ``min_reduction`` (the impossible-bound
    control, pinned by tests/test_scenarios.py) must fail."""
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import BLOCK_REWARD, Transaction

    assert txs_per_sender * 2 <= 2 * BLOCK_REWARD, (
        "storm shape exceeds the two-coinbase wallet budget"
    )
    total_txs = senders * txs_per_sender
    wallets = [
        Keypair.from_seed_text(f"p1-relay-{seed}-{k}") for k in range(senders)
    ]
    payee = Keypair.from_seed_text(f"p1-relay-payee-{seed}")
    genesis = genesis_hash(difficulty)
    t0 = time.monotonic()

    def arm(recon: bool) -> dict:
        net = SimNet(
            seed=seed,
            device=device,
            difficulty=difficulty,
            default_profile=LinkProfile(latency_s=0.01, jitter_s=0.002),
        )

        async def main():
            rng = random.Random(seed ^ 0x3E1A)
            for i in range(nodes):
                await net.add_node(
                    peers=[
                        net.host_name(j)
                        for j in _topology_peers(rng, i, degree)
                    ],
                    recon_gossip=recon,
                    recon_interval_s=recon_interval_s,
                    recon_flood_degree=recon_flood_degree,
                    miner_id="pool",
                )
            hosts = list(net.nodes)
            miner = net.nodes[hosts[0]]
            assert await net.run_until(
                net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
            ), "mesh never formed"
            # Two coinbases per sender wallet: budget for 48 amount-1
            # fee-1 transfers each.
            for w in wallets:
                for _ in range(2):
                    miner.miner_id = w.account
                    await net.mine_on(miner, spacing_s=1.0)
            miner.miner_id = "pool"
            fund_height = miner.chain.height
            assert await net.run_until(
                lambda: net.converged() and min(net.heights()) == fund_height,
                60, step=0.25, wall_limit_s=wall_limit_s,
            ), "mesh never converged post-funding"

            # The uplinks close AFTER funding: the storm is the measured
            # phase, and block sync shouldn't pay the shaped price.
            for h in hosts:
                net.net.host_egress[h] = egress_bps
            base_plane = sum(_tx_plane_bytes(n) for n in net.nodes.values())
            base_links = dict(net.net.link_bytes)
            submits: dict[bytes, tuple[str, float]] = {}

            async def sender(k: int) -> None:
                host = hosts[(k * nodes) // senders]
                node, w = net.nodes[host], wallets[k]
                gap = storm_vs / txs_per_sender
                for s in range(txs_per_sender):
                    await asyncio.sleep(gap)
                    tx = Transaction.transfer(
                        w, payee.account, 1, 1, s, chain=genesis
                    )
                    submits[tx.txid()] = (host, net.clock.now)
                    await node.submit_tx(tx)

            await asyncio.gather(*(sender(k) for k in range(senders)))
            want = set(submits)
            delivered = await net.run_until(
                lambda: all(
                    want <= n.tx_seen_at.keys()
                    for n in net.nodes.values()
                ),
                180, step=0.25, wall_limit_s=wall_limit_s,
            )
            # Measure the instant delivery completes: recon idle rounds
            # up to here are honestly charged to the recon arm.
            plane = sum(_tx_plane_bytes(n) for n in net.nodes.values())
            delays_ms = [
                1000.0 * (n.tx_seen_at[txid] - t_sub)
                for txid, (origin, t_sub) in submits.items()
                for h, n in net.nodes.items()
                if h != origin and txid in n.tx_seen_at
            ]
            link_deltas = [
                total - base_links.get(key, 0)
                for key, total in net.net.link_bytes.items()
            ]
            recon_stats = {
                "rounds": sum(
                    n.metrics.recon_rounds for n in net.nodes.values()
                ),
                "success": sum(
                    n.metrics.recon_success for n in net.nodes.values()
                ),
                "fallbacks": sum(
                    n.metrics.recon_fallbacks for n in net.nodes.values()
                ),
                "txs_reconciled": sum(
                    n.metrics.txs_reconciled for n in net.nodes.values()
                ),
            }
            out = {
                "arm": "recon" if recon else "flood",
                "delivered": delivered,
                "tx_plane_bytes": plane - base_plane,
                "bytes_per_tx": round((plane - base_plane) / total_txs, 1),
                "link_bytes_storm_total": sum(link_deltas),
                "link_bytes_storm_max": max(link_deltas, default=0),
                "propagation": _prop_histogram(delays_ms),
                "recon": recon_stats,
            }
            if recon:
                # The framework report (converged / conserved / digest)
                # must read the nodes BEFORE stop_all pops them.
                out["_base"] = _report(
                    net, "relay-budget", t0,
                    repro_flags=f"--nodes {nodes}",
                )
            else:
                out["trace_digest"] = net.trace_digest()
            await net.stop_all()
            return out

        return net.run(main())

    flood = arm(recon=False)
    recon = arm(recon=True)
    base = recon.pop("_base")
    recon["trace_digest"] = base["trace_digest"]
    reduction = (
        flood["bytes_per_tx"] / recon["bytes_per_tx"]
        if recon["bytes_per_tx"]
        else float("inf")
    )
    report = dict(
        base,
        total_txs=total_txs,
        egress_bps=egress_bps,
        flood=flood,
        recon=recon,
        relay_bytes_per_tx={
            "flood": flood["bytes_per_tx"], "recon": recon["bytes_per_tx"]
        },
        reduction=round(reduction, 2),
        min_reduction=min_reduction,
    )
    report["ok"] = bool(
        flood["delivered"]
        and recon["delivered"]
        and reduction >= min_reduction
        # Equal-or-better: the byte win may not cost latency.
        and recon["propagation"]["p95_ms"] <= flood["propagation"]["p95_ms"]
        and recon["recon"]["success"] > 0
    )
    return report


# -- reconciliation overload: the flood fallback --------------------------


def recon_fallback(
    nodes: int = 5,
    seed: int = 0,
    difficulty: int = 8,
    burst: int = 80,
    recon_interval_s: float = 1.0,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """Overload the sketch: one node takes a ``burst`` of transactions
    (> the codec's MAX_CAPACITY=64) inside a single reconciliation
    interval, with the flood spine OFF (``recon_flood_degree=0``) so the
    whole burst must ride one round.  The set difference exceeds any
    sketch the responder can serve, decode fails — DETECTED, by the
    codec's verification syndrome, not mis-decoded — and the initiator's
    RECONCILDIFF(failure) makes both ends flood their frozen windows.

    ok = every burst tx reaches every node anyway (flood is the pressure
    valve), at least one fallback was counted, and NO link was demoted —
    overload is congestion, not misbehavior, and one failed round must
    not cost a link its recon plane."""
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import BLOCK_REWARD, Transaction
    from p1_tpu_torch.node.reconcile import MAX_CAPACITY

    assert burst > MAX_CAPACITY, "burst must exceed sketch capacity"
    coinbases = (2 * burst + BLOCK_REWARD - 1) // BLOCK_REWARD
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    wallet = Keypair.from_seed_text(f"p1-burst-{seed}")
    payee = Keypair.from_seed_text(f"p1-burst-payee-{seed}")

    async def main():
        rng = random.Random(seed ^ 0xFA11)
        for i in range(nodes):
            await net.add_node(
                peers=[
                    net.host_name(j) for j in _topology_peers(rng, i, 2)
                ],
                recon_gossip=True,
                recon_interval_s=recon_interval_s,
                recon_flood_degree=0,
                miner_id="pool",
            )
        hosts = list(net.nodes)
        origin = net.nodes[hosts[0]]
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        for _ in range(coinbases):
            origin.miner_id = wallet.account
            await net.mine_on(origin, spacing_s=1.0)
        origin.miner_id = "pool"
        fund_height = origin.chain.height
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == fund_height,
            60, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never converged post-funding"

        genesis = genesis_hash(difficulty)
        # The whole burst lands at ONE virtual instant: submit_tx never
        # sleeps, so no reconciliation tick can slice the burst into
        # decodable halves.
        txids = []
        for s in range(burst):
            tx = Transaction.transfer(
                wallet, payee.account, 1, 1, s, chain=genesis
            )
            txids.append(tx.txid())
            await origin.submit_tx(tx)
        want = set(txids)
        delivered = await net.run_until(
            lambda: all(
                want <= n.tx_seen_at.keys() for n in net.nodes.values()
            ),
            120, step=0.25, wall_limit_s=wall_limit_s,
        )
        fallbacks = sum(
            n.metrics.recon_fallbacks for n in net.nodes.values()
        )
        demotions = sum(
            n.metrics.recon_demotions for n in net.nodes.values()
        )
        report = _report(
            net, "recon-fallback", t0,
            repro_flags=f"--burst {burst}",
            burst=burst,
            delivered=delivered,
            recon_fallbacks=fallbacks,
            recon_demotions=demotions,
            recon_rounds=sum(
                n.metrics.recon_rounds for n in net.nodes.values()
            ),
        )
        report["ok"] = bool(
            delivered
            and report["converged"]
            and report["ledger_conserved"]
            and fallbacks >= 1
            and demotions == 0
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- sketch poisoning: the recon plane's byzantine containment ------------


def recon_poison(
    nodes: int = 8,
    seed: int = 0,
    difficulty: int = 8,
    honest_txs: int = 24,
    storm_vs: float = 30.0,
    recon_interval_s: float = 0.5,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """A ``sketch_poisoner`` (node/byzantine.py) camps a listening
    address; the victim node dials it as a configured peer, so the
    poisoner sits on the victim's OUTBOUND recon rotation — garbage
    sketches fail every round the victim initiates there, fabricated
    RECONCILDIFFs promise short ids nothing maps to, and REQRECON/GETTX
    spam burns responder serves.

    The containment under test: the victim burns RECON_DEMOTE_FAILURES
    rounds, demotes the link to plain flood (``recon_demotions``), and
    honest relay NEVER stalls — every honest tx reaches every honest
    node while reconciliation keeps succeeding on honest links.  ok
    asserts exactly that, plus that the poisoner really served garbage
    (its stats say so) and the honest mesh stayed converged."""
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.node.byzantine import new_stats, sketch_poisoner

    POISON_HOST = "66.6.0.66"
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    wallet = Keypair.from_seed_text(f"p1-poison-{seed}")
    payee = Keypair.from_seed_text(f"p1-poison-payee-{seed}")
    stats = new_stats()

    async def main():
        rng = random.Random(seed ^ 0x9013)
        deadline = net.clock.wall() + storm_vs + 120
        poison_task = asyncio.ensure_future(
            sketch_poisoner(
                POISON_HOST, NODE_PORT, difficulty, deadline, None,
                stats, transport=net.net.host(POISON_HOST),
            )
        )
        dials = 0
        for i in range(nodes):
            peers = [net.host_name(j) for j in _topology_peers(rng, i, 3)]
            if i == nodes - 1:
                peers.append(POISON_HOST)  # the victim dials the trap
            dials += len(peers)
            await net.add_node(
                peers=peers,
                recon_gossip=True,
                recon_interval_s=recon_interval_s,
                miner_id="pool",
            )
        hosts = list(net.nodes)
        victim = net.nodes[hosts[-1]]
        # links_up can't apply: the poisoner end registers no _Peer, so
        # the poisoner dial contributes 1 registration, not 2.
        assert await net.run_until(
            lambda: sum(n.peer_count() for n in net.nodes.values())
            >= 2 * (dials - 1) + 1,
            60, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never formed"
        miner = net.nodes[hosts[0]]
        for _ in range(2):
            miner.miner_id = wallet.account
            await net.mine_on(miner, spacing_s=1.0)
        miner.miner_id = "pool"
        fund_height = miner.chain.height
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == fund_height,
            60, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never converged post-funding"

        genesis = genesis_hash(difficulty)
        txids = []
        gap = storm_vs / honest_txs
        for s in range(honest_txs):
            await asyncio.sleep(gap)
            tx = Transaction.transfer(
                wallet, payee.account, 1, 1, s, chain=genesis
            )
            txids.append(tx.txid())
            await net.nodes[hosts[s % (nodes - 1)]].submit_tx(tx)
        want = set(txids)
        delivered = await net.run_until(
            lambda: all(
                want <= n.tx_seen_at.keys() for n in net.nodes.values()
            ),
            120, step=0.25, wall_limit_s=wall_limit_s,
        )
        poison_task.cancel()
        try:
            await poison_task
        except asyncio.CancelledError:
            pass
        honest_success = sum(
            n.metrics.recon_success for n in net.nodes.values()
        )
        report = _report(
            net, "recon-poison", t0,
            honest_txs=honest_txs,
            delivered=delivered,
            victim_demotions=victim.metrics.recon_demotions,
            victim_fallbacks=victim.metrics.recon_fallbacks,
            honest_recon_success=honest_success,
            poisoner_attacks=dict(stats["attacks"]),
        )
        report["ok"] = bool(
            delivered
            and report["converged"]
            and report["ledger_conserved"]
            # The attack really ran: garbage sketches were served and
            # the victim paid with demotion, not with stalled relay.
            and stats["attacks"].get("garbage_sketch", 0) >= 1
            and victim.metrics.recon_demotions >= 1
            # ... while reconciliation kept working between honest ends.
            and honest_success > 0
        )
        await net.stop_all()
        return report

    return net.run(main())


# -- mixed-version mesh: recon activates by version bits ------------------


def recon_mixed(
    nodes: int = 8,
    seed: int = 0,
    difficulty: int = 8,
    vb_window: int = 8,
    vb_threshold: int = 6,
    txs_per_phase: int = 8,
    recon_interval_s: float = 0.5,
    wall_limit_s: float | None = 300.0,
    device: str = "cuda",
) -> dict:
    """Recon rides the evolution contract: upgraded nodes carry a
    "txrecon" version-bits deployment AND ``recon_gossip=True``, one
    straggler runs the legacy table with flood-only relay.  Before the
    deployment is ACTIVE the upgraded nodes must keep flooding (zero
    reconciliation rounds — the wire stays the shared dialect); after
    the miners' signals lock it in and activate it, reconciliation
    starts among upgraded links while the straggler keeps receiving
    every tx by flood and by answering sketches it never initiates.

    ok = both phases' txs reach EVERY node including the straggler, no
    rounds ran pre-activation, rounds succeed post-activation, and the
    mixed mesh never forked."""
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction

    deploy = (("txrecon", 0, vb_window, vb_window * 16),)
    activation_height = 3 * vb_window
    net = SimNet(seed=seed, difficulty=difficulty, device=device)
    t0 = time.monotonic()
    wallet = Keypair.from_seed_text(f"p1-mixed-{seed}")
    payee = Keypair.from_seed_text(f"p1-mixed-payee-{seed}")

    async def main():
        rng = random.Random(seed ^ 0x717C)
        for i in range(nodes - 1):
            await net.add_node(
                peers=[net.host_name(j) for j in _topology_peers(rng, i, 3)],
                recon_gossip=True,
                recon_interval_s=recon_interval_s,
                deployments=deploy,
                vb_window=vb_window,
                vb_threshold=vb_threshold,
                miner_id="pool",
            )
        hosts = list(net.nodes)
        straggler = await net.add_node(peers=[hosts[0], hosts[-1]])
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=wall_limit_s
        ), "mesh never formed"
        miner = net.nodes[hosts[0]]
        for _ in range(2):
            miner.miner_id = wallet.account
            await net.mine_on(miner, spacing_s=1.0)
        miner.miner_id = "pool"
        genesis = genesis_hash(difficulty)

        async def submit_wave(first_seq: int) -> set[bytes]:
            ids = set()
            for s in range(first_seq, first_seq + txs_per_phase):
                tx = Transaction.transfer(
                    wallet, payee.account, 1, 1, s, chain=genesis
                )
                ids.add(tx.txid())
                await net.nodes[hosts[s % (nodes - 1)]].submit_tx(tx)
                await asyncio.sleep(0.5)
            return ids

        # Phase A: pre-activation.  Upgraded nodes have recon configured
        # but the deployment gate holds it shut.
        pre = await submit_wave(0)
        pre_delivered = await net.run_until(
            lambda: all(
                pre <= n.tx_seen_at.keys() for n in net.nodes.values()
            ),
            60, step=0.25, wall_limit_s=wall_limit_s,
        )
        rounds_pre = sum(
            n.metrics.recon_rounds for n in net.nodes.values()
        )

        # Every block an upgraded miner seals signals bit 0; the
        # straggler just follows.  Walk the ladder to ACTIVE.
        while miner.chain.height < activation_height:
            await net.mine_on(
                net.nodes[hosts[miner.chain.height % (nodes - 1)]],
                spacing_s=1.0,
            )
        assert await net.run_until(
            lambda: net.converged()
            and min(net.heights()) >= activation_height,
            120, step=0.25, wall_limit_s=wall_limit_s,
        ), "mesh never reached activation height"
        state = miner.versionbits.states_report(miner.chain)["txrecon"][
            "state"
        ]

        # Phase B: post-activation.  Recon runs among upgraded links;
        # the straggler still sees everything.
        post = await submit_wave(txs_per_phase)
        post_delivered = await net.run_until(
            lambda: all(
                post <= n.tx_seen_at.keys() for n in net.nodes.values()
            ),
            120, step=0.25, wall_limit_s=wall_limit_s,
        )
        success_post = sum(
            n.metrics.recon_success for n in net.nodes.values()
        )
        settled = await net.run_until(
            net.converged, 60, step=0.25, wall_limit_s=wall_limit_s
        )
        report = _report(
            net, "recon-mixed", t0,
            activation_state=state,
            activation_height=activation_height,
            pre_delivered=pre_delivered,
            post_delivered=post_delivered,
            recon_rounds_pre_activation=rounds_pre,
            recon_success_post_activation=success_post,
            straggler_txs_seen=len(straggler.tx_seen_at),
        )
        report["ok"] = bool(
            pre_delivered
            and post_delivered
            and settled
            and report["ledger_conserved"]
            and state == "active"
            # The wire contract held: silent pre-activation, live after.
            and rounds_pre == 0
            and success_post > 0
        )
        await net.stop_all()
        return report

    return net.run(main())


SCENARIOS = {
    "partition-heal": partition_heal,
    "flash-crowd": flash_crowd,
    "churn": churn_storm,
    "eclipse": eclipse,
    "wan": wan,
    "snapshot-join": snapshot_join,
    "far-field": far_field,
    "selfish-mining": selfish_mining,
    "fee-spam": fee_spam,
    "retarget-shock": retarget_shock,
    "snapshot-cartel": snapshot_cartel,
    "version-activation": version_activation,
    "fleet-failover": fleet_failover,
    "soak": soak,
    "relay-budget": relay_budget,
    "recon-fallback": recon_fallback,
    "recon-poison": recon_poison,
    "recon-mixed": recon_mixed,
}


def run_scenario(name: str, **kwargs) -> dict:
    """Run one named scenario; unknown kwargs raise TypeError (the CLI
    filters per-scenario flags before calling)."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; have: {', '.join(sorted(SCENARIOS))}"
        ) from None
    return fn(**kwargs)
