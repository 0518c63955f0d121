"""The chaos plane: combined-fault search over the simulated mesh.

Every robustness layer so far was proven against ONE fault family at a
time — supervision against stalling peers, the FaultStore
against a bad disk, the governor against floods,
the simulator against partitions.  Jepsen-style experience
says the bugs that split chains live in the *compositions*: a crash
during a reorg while the disk is ENOSPC-degraded and the mesh is
partitioned.  This module points the deterministic simulator
(node/netsim.py) at exactly that space:

- ``generate_schedule`` — a seeded generator composing every existing
  injector into one randomized, virtual-time-stamped event list:
  abrupt crash/recover (``SimNet.crash_node`` — torn store appends,
  stale mempool checkpoints, no shutdown hooks), StoreFaultPlan disk
  errors and bit-flips, partitions, link latency/loss spikes,
  HostilePeer/GreedyPeer adversaries, transaction traffic, and
  scenario-driven mining on both sides of every cut.  Schedules are
  fully deterministic per seed and JSON-round-trippable.
- ``run_chaos`` — the orchestrator: applies a schedule to a live mesh
  of full persistent nodes, clears every fault in a deterministic
  epilogue, settles, and checks the global invariant suite at quiesce:
  ledger conservation on every node, convergence to one tip within
  bounded virtual time after the last fault clears, no node stuck
  serve-only once its disk healed, every crashed node's store
  fsck-clean (verdict 0/1, never 2) at recovery AND at shutdown, no
  resurrected already-mined transaction in any pool, and proof/filter
  caches consistent with the post-reorg chain.
- ``shrink_schedule`` — delta debugging (ddmin): on a violation, the
  schedule is minimized to the smallest event list that still
  reproduces it, and ``write_repro``/``run_repro`` round-trip a
  replayable artifact (seed + schedule + expected digest) through
  ``p1 chaos --repro``.

Determinism contract: the whole run — crash/recover cycles included —
hashes into the simulator's event-trace digest; two runs of one seed
are byte-identical in-process and across processes under
PYTHONHASHSEED (tests/test_chaos.py, tests/test_cli.py).

What the crash model does NOT capture (honesty): the
torn-append artifact is the FaultStore's single-record tear — kernel
page-cache reordering that loses an EARLIER acknowledged write while a
later one survives is outside it (the store fsyncs per append, so that
scenario requires a lying disk, which the writer-refusal covers
separately); fsync-reordering across the mempool checkpoint and the
store is likewise not modeled — the checkpoint is atomic-or-absent.

The port's copy of ``p1_tpu/node/chaos.py``: ``run_chaos``,
``run_repro`` and the soaks take ``device`` and give it to their
``SimNet``.  A repro artifact of either package replays in the other
with the same ``expected_trace_digest``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import time
from pathlib import Path

from p1_tpu_torch.node.netsim import NODE_PORT, LinkProfile, SimNet

__all__ = [
    "CHAOS_BUGS",
    "fsck_verdict",
    "generate_schedule",
    "generate_soak_schedule",
    "longevity_soak",
    "run_chaos",
    "run_repro",
    "shrink_schedule",
    "write_repro",
]

#: Repro artifact format tag (bump on layout change).
REPRO_FORMAT = "p1-chaos-repro-1"

#: Snapshot-sync joiners a schedule may spawn (node indices n_nodes..):
#: enough to compose join + crash + liar interactions, small enough to
#: keep tier-1 sweep runtimes flat.
MAX_JOINERS = 2
#: Checkpoint spacing every chaos node runs with: small enough that the
#: warmup + a couple of mine events cross a checkpoint, so joiners get
#: real snapshots to boot from inside short schedules.
SNAPSHOT_INTERVAL = 4

#: Live wallet watchers a schedule may run concurrently (slots 0..N-1):
#: enough to compose watch + crash + flood interactions, small enough
#: to keep tier-1 sweep runtimes flat (mirrors MAX_JOINERS).
MAX_WATCHERS = 2

#: Test-only injectable bugs, each a known-broken recovery behavior the
#: shrinker acceptance proof seeds deliberately (never reachable from
#: production config — only the ``--inject-bug`` flag threads them):
#:
#: - ``relapse-disk``: recovery silently re-arms the recovered node's
#:   disk fault — the "recovery declared the disk healthy without
#:   proving it" bug class; the node degrades serve-only on its first
#:   post-recover append and stays there, violating the serve-only
#:   invariant.
#: - ``deaf-recover``: the recovered node comes back with an empty peer
#:   list — the "recovered node rejoins nothing" bug class; when nobody
#:   happens to dial it, the mesh converges without it.
#: - ``mute-push``: a watcher's confirmations arrive stripped of their
#:   match — the "push plane silently drops the one event the wallet
#:   subscribed for" bug class; the zero-missed-confirmations invariant
#:   must flag it at quiesce.
CHAOS_BUGS = ("relapse-disk", "deaf-recover", "mute-push")


# -- schedule generation ---------------------------------------------------


def generate_schedule(
    seed: int,
    n_nodes: int,
    n_events: int = 12,
    horizon_vs: float = 30.0,
    txs: bool = True,
) -> list[dict]:
    """One randomized, well-formed fault schedule: ``n_events`` events
    at seeded virtual-time offsets in (0, ``horizon_vs``].  Well-formed
    means runnable, not balanced — crashes may outlive the schedule
    (the orchestrator's epilogue recovers everything), and any SUBSET
    of a generated schedule is also runnable (events on dead/absent
    targets degrade to no-ops), which is what lets the ddmin shrinker
    cut arbitrary chunks.

    Event ops and their composition sources:

    - ``mine`` — scenario-driven block production (both sides of a cut
      mine, so heals reorg);
    - ``tx`` — a signed wallet spend submitted to a live node (funds
      ride node 0's pinned coinbase identity);
    - ``crash`` / ``recover`` — abrupt death (optionally with a torn
      in-flight append) and resume-path reboot;
    - ``corrupt`` — flip one byte of a CRASHED node's store file
      (bit-rot while down; recovery must quarantine, never trust);
    - ``disk_fail`` / ``disk_heal`` — arm/clear a persistent
      StoreFaultPlan write error on a LIVE node (degrade→serve-only→
      supervised recovery, inside the adversarial mesh);
    - ``partition`` / ``heal`` — contiguous split (the backbone
      topology keeps both sides internally connected);
    - ``slow_link`` / ``restore_link`` — latency/jitter/loss spike on
      every link of one host;
    - ``hostile`` — a HostilePeer (stale or swallowed sync replies)
      dials a victim; ``flood`` — a GreedyPeer protocol-valid flood;
    - ``snap_join`` — a fresh snapshot-syncing node (``snapshot_sync``)
      joins the mesh mid-schedule: it boots ASSUMED from whatever
      snapshot a peer serves (or falls back to IBD) and must flip to
      fully-validated by quiesce.  Joiners live at indices >=
      ``n_nodes`` and are crash/recover/corrupt-eligible like everyone
      else — which is exactly how crash-during-snapshot-download and
      crash-during-background-revalidation compose into schedules;
    - ``snap_liar`` — a hostile SNAPSHOT SERVER (lying balances, a
      corrupted root, a truncated chunk stream, or a full stall) plus a
      joiner that dials it first and an honest node second: the joiner
      must detect/contain the lie and still converge;
    - ``stage_crash`` — a crash at one pipeline stage boundary
      (node/pipeline.py): validate/store arm a one-shot lane-worker
      death on a live node (respawn-and-retry must hold), the on-loop
      stages (frame/admission/relay) crash the process, stage-tagged;
    - ``rebase`` — a LIVE node advances its base via the maintenance
      plane while mining and serving; the ``crash: true``
      variant runs the durable store half (seal + sidecar spill) and
      kills the process BEFORE the in-RAM rebase — the mid-rebase
      kill-9, which must reboot as an ordinary un-rebased node;
    - ``seal_sidecar_crash`` — the ``.sdx`` state-delta write fails at
      a forced seal (the tolerated sidecar failure family: the roll
      must land, the failure must count, the plane must self-heal);
    - ``online_prune`` / ``online_compact_crash`` — the
      node-side maintenance commands: prune while serving, and a
      compaction whose off-loop planning dies mid-write (the node must
      self-clean the tmp artifacts and keep serving);
    - ``watch_start`` / ``watch_stop`` — a live wallet watcher
      (``client.watch`` over the sim transport) subscribes to
      the payee account against one node with the whole mesh as
      fallback, and later churns away.  Watchers still live at quiesce
      owe the push-plane invariant: a gap-free, commitment-verified
      stream to the converged tip with ZERO missed confirmations —
      crashes of the serving node mid-push, floods, and partitions
      included;
    - ``sub_flood`` — a GreedyPeer hammering the subscription plane
      (SUBSCRIBE churn plus unverifiable resume cursors): the
      degradation ladder and admission tables must shed it without
      harming honest watchers;
    - ``replica_kill`` / ``replica_join`` — the fleet-provisioning
      family: ``replica_kill`` crashes the node a live
      watcher's ReplicaSet is actively riding (the directed
      kill-one-replica, resolved at runtime from the wallet's own
      ``active`` pointer; the scheduled node is the fallback victim
      when no watcher is live), and ``replica_join`` spawns an honest
      snapshot-bootstrapped joiner AND rebalances every live watcher's
      ReplicaSet onto it (``update_targets``) — wallets must fail over
      and re-spread with ZERO missed confirmations either way.
    """
    rng = random.Random((seed << 3) ^ 0xC4A05)
    joiners: set[int] = set()
    watchers: set[int] = set()
    pruned_any = False
    rebased_any = False
    times = sorted(
        round(rng.uniform(0.5, horizon_vs), 3) for _ in range(n_events)
    )
    crashed: set[int] = set()
    disks_down: set[int] = set()
    slowed: set[int] = set()
    partitioned = False
    hostiles = 0
    events: list[dict] = []
    for at in times:
        ops = [("mine", 5.0)]
        if txs:
            ops.append(("tx", 2.0))
        if len(crashed) < max(1, n_nodes - 2):
            ops.append(("crash", 2.5))
        if crashed:
            ops.append(("recover", 2.0))
            ops.append(("corrupt", 1.0))
        if not partitioned and n_nodes >= 4:
            ops.append(("partition", 1.5))
        if partitioned:
            ops.append(("heal", 2.0))
        if len(disks_down) < n_nodes - 1:
            ops.append(("disk_fail", 1.5))
        if disks_down:
            ops.append(("disk_heal", 1.5))
        if len(slowed) < n_nodes - 1:
            ops.append(("slow_link", 1.0))
        if slowed:
            ops.append(("restore_link", 1.0))
        if hostiles < 2:
            ops.append(("hostile", 0.75))
            ops.append(("flood", 0.5))
        if len(joiners) < MAX_JOINERS:
            ops.append(("snap_join", 1.0))
            ops.append(("snap_liar", 0.75))
        # Wallet push plane: live watchers churn on and off
        # mid-schedule, and the subscription port takes protocol-valid
        # floods; a stopped slot may restart (the churn the soak's
        # ``subs`` clusters run at week scale).
        if len(watchers) < MAX_WATCHERS:
            ops.append(("watch_start", 1.0))
        if watchers:
            ops.append(("watch_stop", 0.5))
        if hostiles < 2:
            ops.append(("sub_flood", 0.5))
        # Fleet provisioning: kill the replica a wallet is
        # riding, and join a fresh one into live ReplicaSets.
        if watchers and len(crashed) < max(1, n_nodes - 2):
            ops.append(("replica_kill", 0.75))
        if len(joiners) < MAX_JOINERS:
            ops.append(("replica_join", 0.75))
        # Segmented-store plane.  ``seg_roll`` forces a live
        # node's active segment to seal mid-mesh; ``prune`` discards a
        # live node's deep body segments while it serves (at most one
        # pruned host per schedule — someone must keep the archive);
        # ``compact_crash`` drops the exact tmp-file artifact of a
        # compaction killed before its atomic replace onto a crashed
        # node's store.  All three degrade to no-ops on single-file
        # stores, keeping every subset runnable for the shrinker.
        ops.append(("seg_roll", 0.75))
        if not pruned_any:
            ops.append(("prune", 0.5))
        if crashed:
            ops.append(("compact_crash", 0.5))
        # Always-on maintenance plane: the node-side
        # zero-downtime operations, driven through the same _maintain
        # entry `p1 maintain` uses.  Re-basing and pruning both shrink
        # a host's deep-history serving capacity, so each is capped
        # like ``prune`` — someone must keep the archive.  All degrade
        # to no-ops on single-file stores or refused preconditions
        # (subset-runnability for the shrinker).
        if not rebased_any and len(crashed) < max(1, n_nodes - 2):
            ops.append(("rebase", 0.75))
        ops.append(("seal_sidecar_crash", 0.5))
        if not pruned_any:
            ops.append(("online_prune", 0.5))
        ops.append(("online_compact_crash", 0.5))
        # Staged-pipeline plane: a crash at every stage
        # boundary.  The two lane stages (validate/store) die as WORKER
        # deaths — the pipeline must respawn the lane and retry without
        # losing the job; the three on-loop stages (frame/admission/
        # relay) have no thread to kill, so their boundary crash IS a
        # process crash, recorded with the stage name.
        if len(crashed) < max(1, n_nodes - 2):
            ops.append(("stage_crash", 1.0))
        op = rng.choices([o for o, _ in ops], [w for _, w in ops])[0]
        ev: dict = {"at": at, "op": op}
        if op == "mine":
            ev["node"] = rng.randrange(n_nodes)
        elif op == "tx":
            ev["amount"] = rng.randrange(1, 5)
            ev["fee"] = rng.randrange(0, 3)
        elif op == "snap_join":
            slot = n_nodes + len(joiners)
            ev["node"] = slot
            ev["peers"] = sorted(rng.sample(range(n_nodes), min(2, n_nodes)))
            joiners.add(slot)
        elif op == "snap_liar":
            slot = n_nodes + len(joiners)
            ev["node"] = slot
            ev["peers"] = [rng.randrange(n_nodes)]
            ev["fault"] = rng.choice(("balance", "root", "truncate", "stall"))
            ev["height"] = rng.choice((8, 12))
            joiners.add(slot)
            hostiles += 1
        elif op == "crash":
            universe = [*range(n_nodes), *sorted(joiners)]
            victims = [i for i in universe if i not in crashed]
            ev["node"] = rng.choice(victims)
            # 0 = clean kill; >0 seeds the torn-append offset.
            ev["torn"] = rng.choice((0, 0, rng.randrange(1, 1 << 16)))
            crashed.add(ev["node"])
            disks_down.discard(ev["node"])  # a dead process holds no plan
        elif op == "recover":
            ev["node"] = rng.choice(sorted(crashed))
            crashed.discard(ev["node"])
        elif op == "corrupt":
            ev["node"] = rng.choice(sorted(crashed))
            ev["offset"] = rng.randrange(1 << 20)
        elif op == "partition":
            ev["frac"] = rng.choice((0.3, 0.5, 0.7))
            partitioned = True
        elif op == "heal":
            partitioned = False
        elif op == "disk_fail":
            import errno

            up = [i for i in range(n_nodes) if i not in disks_down]
            ev["node"] = rng.choice(up)
            ev["errno"] = rng.choice((errno.ENOSPC, errno.EIO))
            disks_down.add(ev["node"])
        elif op == "disk_heal":
            ev["node"] = rng.choice(sorted(disks_down))
            disks_down.discard(ev["node"])
        elif op == "slow_link":
            cands = [i for i in range(n_nodes) if i not in slowed]
            ev["node"] = rng.choice(cands)
            ev["latency_ms"] = rng.choice((50, 150, 400))
            ev["loss"] = rng.choice((0.0, 0.2, 0.5))
            slowed.add(ev["node"])
        elif op == "restore_link":
            ev["node"] = rng.choice(sorted(slowed))
            slowed.discard(ev["node"])
        elif op == "hostile":
            ev["node"] = rng.randrange(n_nodes)
            ev["fault"] = rng.choice(("stale", "swallow"))
            ev["height"] = rng.randrange(3, 9)
            hostiles += 1
        elif op == "flood":
            ev["node"] = rng.randrange(n_nodes)
            ev["kind"] = rng.choice(("queries", "blocks"))
            hostiles += 1
        elif op == "watch_start":
            slot = min(s for s in range(MAX_WATCHERS) if s not in watchers)
            ev["watcher"] = slot
            ev["node"] = rng.randrange(n_nodes)
            watchers.add(slot)
        elif op == "replica_kill":
            # The true victim (a live watcher's active target) is only
            # knowable at runtime; ``node`` is the fallback victim and
            # the conservative bookkeeping entry — whoever actually
            # dies, later events on dead targets degrade to no-ops.
            victims = [i for i in range(n_nodes) if i not in crashed]
            ev["node"] = rng.choice(victims)
            crashed.add(ev["node"])
        elif op == "replica_join":
            slot = n_nodes + len(joiners)
            ev["node"] = slot
            ev["peers"] = sorted(rng.sample(range(n_nodes), min(2, n_nodes)))
            joiners.add(slot)
        elif op == "watch_stop":
            ev["watcher"] = rng.choice(sorted(watchers))
            watchers.discard(ev["watcher"])
        elif op == "sub_flood":
            ev["node"] = rng.randrange(n_nodes)
            hostiles += 1
        elif op == "seg_roll":
            ev["node"] = rng.randrange(n_nodes)
        elif op == "prune":
            ev["node"] = rng.randrange(n_nodes)
            ev["keep"] = rng.choice((2, 4))
            pruned_any = True
        elif op == "compact_crash":
            ev["node"] = rng.choice(sorted(crashed))
            ev["junk"] = rng.randrange(1, 1 << 16)
        elif op == "rebase":
            victims = [i for i in range(n_nodes) if i not in crashed]
            ev["node"] = rng.choice(victims)
            # Small keeps: a 30-vs schedule mines ~a dozen blocks, and
            # a keep past the chain height degrades the event to a
            # refusal no-op every time (we want SOME organic fires).
            ev["keep"] = rng.choice((2, 4))
            ev["crash"] = rng.random() < 0.34
            rebased_any = True
            if ev["crash"]:
                # The mid-rebase kill: the process dies after the store
                # half — downstream scheduling must treat it as crashed.
                crashed.add(ev["node"])
                disks_down.discard(ev["node"])
        elif op == "seal_sidecar_crash":
            ev["node"] = rng.randrange(n_nodes)
        elif op == "online_prune":
            ev["node"] = rng.randrange(n_nodes)
            ev["keep"] = rng.choice((2, 4))
            pruned_any = True
        elif op == "online_compact_crash":
            ev["node"] = rng.randrange(n_nodes)
        elif op == "stage_crash":
            from p1_tpu_torch.node.pipeline import LANE_STAGES, STAGES

            universe = [*range(n_nodes), *sorted(joiners)]
            victims = [i for i in universe if i not in crashed]
            ev["node"] = rng.choice(victims)
            ev["stage"] = rng.choice(STAGES)
            if ev["stage"] not in LANE_STAGES:
                # On-loop stage boundary: the process dies (clean kill —
                # torn appends belong to the plain crash op).
                crashed.add(ev["node"])
                disks_down.discard(ev["node"])
        events.append(ev)
    return events


# -- longevity soak --------------------------------------------------------

#: One virtual day, seconds.
DAY_VS = 86_400.0


def generate_soak_schedule(
    seed: int,
    n_nodes: int,
    horizon_vs: float,
    fault_clusters: int,
    blocks: int,
    txs_per_cluster: int = 2,
    fault_window_vs: float = 240.0,
) -> list[dict]:
    """A LONG-horizon schedule shaped for longevity, not density: the
    same event vocabulary as ``generate_schedule``, but every
    disruptive fault is paired with its clearing event inside a bounded
    ``fault_window_vs`` envelope (crash→recover, partition→heal,
    disk_fail→disk_heal, slow_link→restore_link, hostile/flood→calm,
    watch_start→watch_stop).
    A week-long open partition is the partition-heal scenario's
    question; the longevity question is whether a week of RECURRING
    fault/heal cycles, steady mining, and wallet traffic leaves any
    monotone growth behind — so faults here recur and clear, block
    production ticks through the whole horizon, and two ``probe``
    events (midpoint and end) snapshot the per-node leak gauges the
    quiesce invariants compare.

    The envelope also keeps the event count proportional to the fault
    count rather than the horizon: an unclosed crash would have every
    surviving peer redialing the corpse twice a second for six virtual
    days (RECONNECT_DELAY_S), drowning the run in events the scenario
    never meant to test."""
    rng = random.Random((seed << 4) ^ 0x50AC7)
    events: list[dict] = []
    maintained = 0
    for b in range(blocks):
        at = (b + 1) * horizon_vs / (blocks + 1)
        events.append(
            {"at": round(at, 3), "op": "mine", "node": b % n_nodes}
        )
    slot_vs = horizon_vs / max(1, fault_clusters)
    assert slot_vs > fault_window_vs + 2.0, (
        "fault clusters overlap: lengthen the horizon or reduce clusters"
    )
    joiners = 0
    for c in range(fault_clusters):
        at = round(c * slot_vs + rng.uniform(1.0, slot_vs - fault_window_vs - 1.0), 3)
        end = round(at + rng.uniform(30.0, fault_window_vs), 3)
        kind = rng.choice(
            (
                "crash",
                "crash",
                "partition",
                "disk_fail",
                "slow_link",
                "hostile",
                "flood",
                "snap_join",
                "maintenance",
                "subs",
            )
        )
        if kind == "crash":
            victim = rng.randrange(n_nodes)
            events.append(
                {
                    "at": at,
                    "op": "crash",
                    "node": victim,
                    "torn": rng.choice((0, rng.randrange(1, 1 << 16))),
                }
            )
            events.append({"at": end, "op": "recover", "node": victim})
            if rng.random() < 0.5:
                events.append(
                    {
                        "at": round((at + end) / 2, 3),
                        "op": "corrupt",
                        "node": victim,
                        "offset": rng.randrange(1 << 20),
                    }
                )
        elif kind == "partition":
            events.append(
                {
                    "at": at,
                    "op": "partition",
                    "frac": rng.choice((0.3, 0.5, 0.7)),
                }
            )
            events.append({"at": end, "op": "heal"})
        elif kind == "disk_fail":
            import errno

            victim = rng.randrange(n_nodes)
            events.append(
                {
                    "at": at,
                    "op": "disk_fail",
                    "node": victim,
                    "errno": rng.choice((errno.ENOSPC, errno.EIO)),
                }
            )
            events.append({"at": end, "op": "disk_heal", "node": victim})
        elif kind == "slow_link":
            victim = rng.randrange(n_nodes)
            events.append(
                {
                    "at": at,
                    "op": "slow_link",
                    "node": victim,
                    "latency_ms": rng.choice((50, 150, 400)),
                    "loss": rng.choice((0.0, 0.2)),
                }
            )
            events.append(
                {"at": end, "op": "restore_link", "node": victim}
            )
        elif kind == "hostile":
            events.append(
                {
                    "at": at,
                    "op": "hostile",
                    "node": rng.randrange(n_nodes),
                    "fault": rng.choice(("stale", "swallow")),
                    "height": rng.randrange(3, 9),
                }
            )
            events.append({"at": end, "op": "calm"})
        elif kind == "flood":
            events.append(
                {
                    "at": at,
                    "op": "flood",
                    "node": rng.randrange(n_nodes),
                    "kind": rng.choice(("queries", "blocks")),
                }
            )
            events.append({"at": end, "op": "calm"})
        elif kind == "snap_join" and joiners < MAX_JOINERS:
            slot = n_nodes + joiners
            joiners += 1
            events.append(
                {
                    "at": at,
                    "op": "snap_join",
                    "node": slot,
                    "peers": sorted(
                        rng.sample(range(n_nodes), min(2, n_nodes))
                    ),
                }
            )
        elif kind == "maintenance":
            # A maintenance cycle inside one fault envelope:
            # sidecar-failure at a seal, then a live re-base, then
            # either an online prune (FIRST cluster only — someone
            # must keep the archive over a week of clusters) or a
            # compaction with its planning failure injected.  Recurring
            # across a virtual week, this is exactly the "always-on
            # node" longevity question: does repeated self-maintenance
            # leak or drift anything the quiesce gauges can see?
            victim = rng.randrange(n_nodes)
            events.append(
                {"at": at, "op": "seal_sidecar_crash", "node": victim}
            )
            events.append(
                {
                    "at": round((at + end) / 2, 3),
                    "op": "rebase",
                    "node": victim,
                    "keep": 8,
                    "crash": False,
                }
            )
            if maintained == 0:
                events.append(
                    {
                        "at": end,
                        "op": "online_prune",
                        "node": victim,
                        "keep": 4,
                    }
                )
            else:
                events.append(
                    {"at": end, "op": "online_compact_crash", "node": victim}
                )
            maintained += 1
        elif kind == "subs":
            # Subscription churn: a wallet rides the push
            # plane across the envelope, then unsubscribes.  Recurring
            # subscribe/consume/drop cycles are the push plane's
            # longevity question — does a week of watcher churn leave
            # sessions, queue bytes, or registry entries behind for the
            # quiesce gauges to see?
            events.append(
                {
                    "at": at,
                    "op": "watch_start",
                    "node": rng.randrange(n_nodes),
                    "watcher": c % MAX_WATCHERS,
                }
            )
            # A block inside the envelope, so every churn cycle carries
            # at least one real push before the watcher unsubscribes.
            events.append(
                {
                    "at": round(at + (end - at) * 0.75, 3),
                    "op": "mine",
                    "node": rng.randrange(n_nodes),
                }
            )
            events.append(
                {"at": end, "op": "watch_stop", "watcher": c % MAX_WATCHERS}
            )
        for _ in range(txs_per_cluster):
            events.append(
                {
                    "at": round(rng.uniform(at, end), 3),
                    "op": "tx",
                    "amount": rng.randrange(1, 5),
                    "fee": rng.randrange(0, 3),
                }
            )
    events.append({"at": round(horizon_vs / 2, 3), "op": "probe"})
    events.append({"at": round(horizon_vs, 3), "op": "probe"})
    return sorted(events, key=lambda e: e["at"])


def longevity_soak(
    seed: int = 0,
    nodes: int = 5,
    days: float = 7.0,
    clusters_per_day: float = 4.0,
    blocks_per_day: float = 48.0,
    difficulty: int = 8,
    settle_vs: float = 240.0,
    rss_bound_mb: float = 2048.0,
    wall_limit_s: float | None = 600.0,
    device: str = "cuda",
) -> dict:
    """The ≥1-virtual-week longevity soak: ``days`` of
    virtual mesh life — steady block production, recurring
    fault/heal cycles across every injector family, wallet traffic —
    compressed through the chaos plane's virtual clock, then held to
    the full quiesce invariant suite PLUS the leak invariants the probe
    events feed: bounded RSS, ban/violation tables, address books,
    signature/proof/filter caches, per-node task counts, and
    supervision/store retry counters whose second-half growth must stay
    proportional to the first half (a runaway retry loop shows up as a
    hockey stick even when every individual table is capped).

    Returns a scenario-shaped report (``p1 sim soak`` runs it): chaos
    report fields + ``scenario``/``repro`` stamps, ``ok`` iff zero
    violations."""
    horizon_vs = days * DAY_VS
    events = generate_soak_schedule(
        seed,
        nodes,
        horizon_vs,
        fault_clusters=max(1, round(days * clusters_per_day)),
        blocks=max(1, round(days * blocks_per_day)),
    )
    report = run_chaos(
        seed,
        nodes=nodes,
        events=events,
        difficulty=difficulty,
        settle_vs=settle_vs,
        wall_limit_s=wall_limit_s,
        rss_bound_mb=rss_bound_mb,
        device=device,
    )
    report["scenario"] = "soak"
    report["days_virtual"] = round(report["virtual_s"] / DAY_VS, 3)
    report["repro"] = f"p1 sim soak --seed {seed}"
    return report


def _vm_rss_mb() -> float | None:
    """Current process RSS in MB via /proc (None off-Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        return None
    return None


# -- store verdicts --------------------------------------------------------


def fsck_verdict(path) -> int:
    """The `p1 fsck` exit-code contract as a pure function of the store
    file's bytes: 0 = clean framing, 1 = damage a salvage recovers
    (torn tail / quarantinable spans — at least one good record or an
    empty-but-valid log survives), 2 = unrecoverable (missing, not a
    chain store, or nothing salvageable).  The chaos invariant: a
    crashed node's store must NEVER reach 2 — whatever the schedule
    did, recovery has something valid to stand on.

    Segmented stores (chain/segstore.py) verdict per SEGMENT straight
    off the directory — the manifest is a rebuildable cache, so only an
    unscannable segment (destroyed magic) is unrecoverable; stray
    segments from a mid-roll crash are scanned too."""
    from p1_tpu_torch.chain import segstore
    from p1_tpu_torch.chain.store import ChainStore

    path = Path(path)
    if not path.exists():
        return 2
    if segstore.is_segmented(path):
        seg_dir = path.with_name(path.name + ".d")
        files = (
            sorted(seg_dir.glob("seg*.p1s")) if seg_dir.exists() else []
        )
        if not files:
            # Fully-pruned stores keep their .hdrx plane; anything else
            # with zero segments lost the archive wholesale.
            hdrx = (
                list(seg_dir.glob("seg*.hdrx")) if seg_dir.exists() else []
            )
            return 0 if hdrx else 2
        worst = 0
        for f in files:
            data = f.read_bytes()
            if not data or segstore._torn_magic(data):
                worst = max(worst, 1)  # torn first write: heals empty
                continue
            try:
                scan = ChainStore.scan(data)
            except ValueError:
                return 2
            if not scan.clean:
                worst = max(worst, 1)
        return worst
    data = path.read_bytes()
    try:
        scan = ChainStore.scan(data)
    except ValueError:
        return 2
    if scan.clean:
        return 0
    # Damaged but salvageable as long as the framing walk itself stood
    # up (it did — scan returned).  A store reduced to bad spans only
    # still salvages to a valid empty log, which resyncs from peers.
    return 1


# -- the orchestrator ------------------------------------------------------


def run_chaos(
    seed: int,
    nodes: int = 6,
    n_events: int = 12,
    events: list[dict] | None = None,
    difficulty: int = 8,
    store_dir=None,
    horizon_vs: float = 30.0,
    settle_vs: float = 240.0,
    wall_limit_s: float | None = 180.0,
    inject_bug: str | None = None,
    txs: bool = True,
    keep_trace: bool = False,
    rss_bound_mb: float | None = None,
    pipeline_workers: int = 0,
    recon: bool = False,
    device: str = "cuda",
) -> dict:
    """Run one chaos schedule end to end and return the report.

    ``events`` replays an explicit schedule (the repro path); None
    generates one from the seed.  ``store_dir`` holds every node's
    on-disk state for the run; None uses a private temp directory.
    ``inject_bug`` (test-only, see ``CHAOS_BUGS``) seeds a known
    recovery bug so the shrinker pipeline can be proven against a
    violation that is guaranteed to exist.  ``device`` goes to the
    ``SimNet``: where the blocks are sealed and the signature batches
    run.

    Report: ``ok`` iff every invariant held; ``violations`` lists
    ``{"invariant", "detail"}`` rows; ``trace_digest`` is the
    simulator's running event hash — the replay-identity witness.
    """
    assert inject_bug is None or inject_bug in CHAOS_BUGS, inject_bug
    if events is None:
        events = generate_schedule(
            seed, nodes, n_events, horizon_vs=horizon_vs, txs=txs
        )
    if store_dir is None:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="p1chaos") as tmp:
            return run_chaos(
                seed,
                nodes=nodes,
                events=events,
                difficulty=difficulty,
                store_dir=tmp,
                settle_vs=settle_vs,
                wall_limit_s=wall_limit_s,
                inject_bug=inject_bug,
                txs=txs,
                keep_trace=keep_trace,
                rss_bound_mb=rss_bound_mb,
                pipeline_workers=pipeline_workers,
                recon=recon,
                device=device,
            )
    t0 = time.monotonic()
    net = SimNet(
        seed=seed,
        difficulty=difficulty,
        store_dir=store_dir,
        keep_trace=keep_trace,
        device=device,
        # The whole schedule corpus runs over SEGMENTED
        # stores (tiny segments, so a few mined blocks cross roll
        # boundaries) — crashes/torn writes/bit-rot now land on segment
        # files, and the fsck invariant verdicts per segment.
        segmented_store=store_dir is not None,
        # Staged-node sweeps run the whole corpus with lane
        # workers enabled; the virtual loop keeps lane jobs synchronous
        # (SimLoop.run_in_executor), so the digest stays seed-stable.
        pipeline_workers=pipeline_workers,
    )
    runner = _ChaosRunner(
        net, nodes, difficulty, inject_bug, settle_vs, wall_limit_s,
        rss_bound_mb=rss_bound_mb, recon=recon,
    )
    report = net.run(runner.main(events))
    report["seed"] = seed
    report["nodes"] = nodes
    report["repro"] = f"p1 chaos --seed {seed} --nodes {nodes}"
    if rss_bound_mb is not None:
        # RSS at quiesce vs the soak bound — read here, OUTSIDE the
        # event loop (the probe path stays pure reads, and /proc IO
        # never lands on the loop the transitive-blocking lint guards).
        # VmRSS, not peak: CPython's allocator rarely returns freed
        # arenas, but a bounded-table mesh at quiesce must still fit.
        rss_mb = _vm_rss_mb()
        report["rss_mb"] = rss_mb
        report["rss_bound_mb"] = rss_bound_mb
        if rss_mb is not None and rss_mb > rss_bound_mb:
            report["violations"].append(
                {
                    "invariant": "rss",
                    "detail": f"process RSS {rss_mb:.0f} MB over the "
                    f"{rss_bound_mb:.0f} MB soak bound at quiesce",
                }
            )
    report["wall_s"] = round(time.monotonic() - t0, 3)
    report["ok"] = not report["violations"]
    return report


class _Watcher:
    """One live wallet on the push plane: ``client.watch`` driven over
    the sim transport against a primary node with the whole founder
    mesh as fallback, recording every VERIFIED event for the quiesce
    invariants.  The watch itself is deterministic (no randomness, no
    wall clock), so watchers ride the trace-digest contract like any
    other actor.

    ``floor`` is the strict-coverage floor: the height below the first
    verified event, pushed UP whenever the stream re-anchors past a
    hole (a reorg deeper than the rewind ring resets the TOFU anchor —
    the wallet would rescan history below it, so the gap-free claim
    restarts there).  ``resets`` counts those holes."""

    def __init__(
        self, net, serial, primary, fallbacks, item, difficulty, mute=False
    ):
        from p1_tpu_torch.node.client import ReplicaSet

        self.net = net
        self.serial = serial
        self.primary = primary
        self.targets = [(primary, NODE_PORT)] + [
            (h, NODE_PORT) for h in fallbacks if h != primary
        ]
        self.item = item
        self.difficulty = difficulty
        self.mute = mute
        # The wallet-side fleet policy: health-scored target
        # selection with live rebalancing.  spread_key=0 keeps the
        # schedule's named primary as the first dial (all targets start
        # tied, join order breaks the tie), so schedule semantics read
        # the same as the old rotation — the policy differences show up
        # under faults, which is where they belong.
        self.rs = ReplicaSet(self.targets, spread_key=0)
        self.events: list[dict] = []
        self.by_height: dict[int, dict] = {}  # height -> LAST event there
        self.floor: int | None = None
        self.resets = 0
        self.error: str | None = None
        self._last_h: int | None = None
        self._task: asyncio.Task | None = None

    def add_target(self, host: str) -> None:
        """A freshly provisioned replica joined the serving set: fold it
        into the live watch's ReplicaSet (op ``replica_join``)."""
        t = (host, NODE_PORT)
        if t not in self.targets:
            self.targets.append(t)
            self.rs.update_targets(self.targets)

    @property
    def live(self) -> bool:
        return self._task is not None and not self._task.done()

    @property
    def tip_height(self) -> int:
        """The watch's CURRENT verified position (not its max — after a
        reorg rewind the re-pushed branch is where the stream stands)."""
        return -1 if self._last_h is None else self._last_h

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        from p1_tpu_torch.node import client

        transport = self.net.net.host(f"77.7.0.{self.serial}")
        try:
            # cross_check_every=0: the per-event commitment verification
            # (header link, PoW, H-link) stays on; the periodic
            # cross-replica audit is OFF because an honest mesh mid-fork
            # genuinely disagrees — when the fork point predates this
            # watch's ring, adjudication resolves conservatively by
            # demoting the serving peer, and a week of partitions would
            # slowly demote honest nodes.  The audit path is proven by
            # the lying-replica suites (tests/test_subscriptions.py).
            async for ev in client.watch(
                self.targets[0][0],
                NODE_PORT,
                [self.item],
                self.difficulty,
                replica_set=self.rs,
                transport=transport,
                cross_check_every=0,
                reconnect_delay_s=0.5,
                max_session_failures=None,
            ):
                h = ev["height"]
                if self.floor is None:
                    self.floor = h - 1
                elif self._last_h is not None and h > self._last_h + 1:
                    self.resets += 1
                    self.floor = h - 1
                self._last_h = h
                if self.mute and ev["matched"]:
                    # Injected bug (``mute-push``): the confirmation
                    # arrives stripped of its match — exactly what the
                    # zero-missed-confirmations invariant must catch.
                    ev = {**ev, "matched": False, "txids": ()}
                self.events.append(ev)
                self.by_height[h] = ev
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — recorded, judged at quiesce
            self.error = f"{type(e).__name__}: {e}"


class _ChaosRunner:
    """One schedule's execution state (hosts, wallets, live actors)."""

    def __init__(self, net, n_nodes, difficulty, inject_bug, settle_vs,
                 wall_limit_s, rss_bound_mb=None, recon=False):
        from p1_tpu_torch.core.keys import Keypair

        self.net = net
        self.n = n_nodes
        self.difficulty = difficulty
        self.inject_bug = inject_bug
        self.settle_vs = settle_vs
        self.wall_limit_s = wall_limit_s
        # Base mesh hosts, then the (lazily spawned) snapshot-joiner
        # slots — one flat list so every schedule index resolves the
        # same way whether it names a founder or a joiner.
        self.hosts = [net.host_name(i) for i in range(n_nodes)] + [
            f"10.99.0.{k}" for k in range(MAX_JOINERS)
        ]
        self.joiner_hosts = self.hosts[n_nodes:]
        #: (host, height, tip hash, wallet balance) reported by joiners
        #: WHILE in the ASSUMED state — checked against the validated
        #: history at quiesce (the never-contradicted invariant).
        self.samples: list[tuple] = []
        # Deterministic wallet: node 0 mines to this account, so its
        # spends are funded the moment the warmup blocks land.
        self.wallet = Keypair.from_seed_text(f"p1-chaos-{net.seed}")
        self.payee = Keypair.from_seed_text(f"p1-chaos-{net.seed}-payee")
        self.actors: list = []  # hostile/greedy peers, stopped at epilogue
        #: Live wallet watchers by schedule slot; churned-away ones move
        #: to ``retired_watchers`` (still judged for honesty at quiesce).
        self.watchers: dict[int, _Watcher] = {}
        self.retired_watchers: list[_Watcher] = []
        self.watch_serial = 0
        self.slowed: set[str] = set()
        self.partitioned = False
        self.rss_bound_mb = rss_bound_mb
        #: Run the whole mesh with set-reconciliation tx
        #: gossip on (no deployment table — recon from block 0).
        #: OPT-IN so the seed-stable trace-digest corpus keeps its
        #: recorded hashes; the recon sweep pins its own.
        self.recon = recon
        #: Leak-gauge snapshots taken by ``probe`` events (the soak
        #: schedule places one at the midpoint and one at the horizon);
        #: the quiesce leak invariants compare the last two.
        self.probes: list[dict] = []
        self.recover_verdicts: list[int] = []
        self.counts = {
            "applied": 0,
            "crashes": 0,
            "recoveries": 0,
            "txs": 0,
            "watchers": 0,
        }

    # -- helpers ----------------------------------------------------------

    def _alive(self, idx: int, mining: bool = False) -> str | None:
        """Resolve a schedule's node index to a LIVE host, walking
        forward deterministically when the named one is down (subsets
        of a schedule must stay runnable).  ``mining`` additionally
        skips degraded serve-only nodes: they reject even their own
        sealed blocks (by design), so a mine event on one is a no-op
        the schedule did not intend."""
        for k in range(self.n):
            host = self.hosts[(idx + k) % self.n]
            node = self.net.nodes.get(host)
            if node is None:
                continue
            if mining and node._store_degraded:
                continue
            return host
        return None

    def _record(self, *fields) -> None:
        # Chaos actions are trace events: the digest must pin the
        # schedule as executed, not just its network side effects.
        self.net.net._record("chaos", self.net.clock.now, *fields)

    # -- event application -------------------------------------------------

    async def _apply(self, ev: dict) -> None:
        net = self.net
        op = ev["op"]
        if op == "mine":
            host = self._alive(ev["node"], mining=True)
            if host is not None:
                self._record("mine", host)
                await net.mine_on(net.nodes[host])
        elif op == "tx":
            from p1_tpu_torch.core.genesis import genesis_hash
            from p1_tpu_torch.core.tx import Transaction

            host = self._alive(0)
            if host is None:
                return
            node = net.nodes[host]
            acct = self.wallet.account
            seq = node.mempool.pending_next_seq(acct, node.chain.nonce(acct))
            tx = Transaction.transfer(
                self.wallet,
                self.payee.account,
                ev["amount"],
                ev["fee"],
                seq,
                chain=genesis_hash(self.difficulty),
            )
            self._record("tx", host, seq)
            await node.submit_tx(tx)
            self.counts["txs"] += 1
        elif op == "crash":
            host = self.hosts[ev["node"]]
            if host in net.nodes:
                await net.crash_node(host, torn=ev.get("torn", 0))
                self.counts["crashes"] += 1
        elif op == "recover":
            host = self.hosts[ev["node"]]
            if host in net.crashed:
                await self._recover(host)
        elif op == "corrupt":
            from p1_tpu_torch.chain.segstore import is_segmented

            host = self.hosts[ev["node"]]
            if host not in net.crashed:
                return  # only a DOWN node's disk rots unobserved
            path = Path(net.configs[host].store_path)
            if is_segmented(path):
                # Segmented layout: the rot lands in a SEGMENT file
                # (the manifest is a rebuildable cache, and destroying
                # it would model a different fault than record bit-rot).
                seg_dir = path.with_name(path.name + ".d")
                segs = [
                    f
                    for f in sorted(seg_dir.glob("seg*.p1s"))
                    if f.stat().st_size > 9
                ]
                if not segs:
                    return
                path = segs[ev["offset"] % len(segs)]
            data = bytearray(path.read_bytes())
            if len(data) <= 9:
                return  # magic only: nothing to rot
            # Never the magic: a destroyed format tag is fsck verdict 2
            # by definition, and this event models bit-rot in records.
            off = 8 + ev["offset"] % (len(data) - 8)
            data[off] ^= 0x20
            path.write_bytes(bytes(data))
            self._record("corrupt", host, off)
        elif op == "seg_roll":
            host = self.hosts[ev["node"]]
            store = net.stores.get(host)
            if (
                host in net.nodes
                and store is not None
                and hasattr(store, "roll_segment")
            ):
                try:
                    store.roll_segment()
                except OSError:
                    pass  # an armed disk-fault plan owns this failure
                else:
                    self._record("seg_roll", host)
        elif op == "prune":
            host = self.hosts[ev["node"]]
            node = net.nodes.get(host)
            store = net.stores.get(host)
            if (
                node is None
                or store is None
                or not hasattr(store, "prune_below")
            ):
                return
            floor = max(0, node.chain.height - ev["keep"])
            try:
                n = store.prune_below(floor)
            except OSError:
                return  # armed disk fault: the node's paths degrade
            if n:
                # Prune-while-serving: the node now refuses block sync
                # into the pruned range (peers fail over to the archive
                # holders) and a later crash/recover re-IBDs through
                # the mesh — both paths the invariants then check.
                node.chain.prune_floor = store.pruned_below
                self._record("prune", host, floor, n)
        elif op == "compact_crash":
            host = self.hosts[ev["node"]]
            if host not in net.crashed:
                return
            path = Path(net.configs[host].store_path)
            seg_dir = path.with_name(path.name + ".d")
            segs = (
                sorted(seg_dir.glob("seg*.p1s")) if seg_dir.exists() else []
            )
            if not segs:
                return
            victim = segs[ev["junk"] % len(segs)]
            # The exact artifact of a per-segment compaction killed
            # before its atomic os.replace: a partial sibling tmp.
            # Recovery must ignore it (verdict <= 1, records intact).
            tmp = victim.with_name(f"{victim.name}.seg.{ev['junk']}")
            tmp.write_bytes(b"P1TPUCH3" + bytes([ev["junk"] & 0xFF]) * 64)
            self._record("compact_crash", host)
        elif op == "rebase":
            host = self._alive(ev["node"])
            if host is None:
                return
            node = net.nodes[host]
            store = net.stores.get(host)
            if store is None or not hasattr(store, "ensure_sidecars"):
                return  # no segmented spill plane: nothing to rebase onto
            if ev.get("crash"):
                # Kill-9 mid-rebase: the durable store half (seal +
                # sidecar spill) lands, the process dies BEFORE the
                # in-RAM rebase.  Reboot must come back as an ordinary
                # un-rebased node (fsck <= 1, records an exact prefix)
                # with the spare sidecars simply awaiting reuse.
                try:
                    store.roll_segment()
                    store.ensure_sidecars()
                except OSError:
                    return  # an armed disk-fault plan owns this failure
                self._record("rebase_crash", host)
                await net.crash_node(host, torn=0)
                self.counts["crashes"] += 1
                return
            reply = await node._maintain(
                {"op": "rebase", "keep": ev["keep"]}
            )
            # Refusals (short chain, assumed posture, degraded store)
            # are fine — the event degrades to a no-op, which is what
            # keeps arbitrary schedule subsets runnable for the
            # shrinker.
            if reply.get("ok"):
                self._record("rebase", host, reply["new_base"])
        elif op == "seal_sidecar_crash":
            host = self._alive(ev["node"])
            store = net.stores.get(host) if host is not None else None
            if (
                host is None
                or store is None
                or not hasattr(store, "fail_next_sidecar")
            ):
                return
            before = store.healed["sdx_failures"]
            store.fail_next_sidecar = True
            try:
                store.roll_segment()
            except OSError:
                return  # an armed disk-fault plan owns this failure
            finally:
                # An empty active segment skips the roll and leaves the
                # seam armed — disarm so a later organic seal does not
                # inherit this event's fault.
                store.fail_next_sidecar = False
            if store.healed["sdx_failures"] > before:
                self._record("seal_sidecar_crash", host)
        elif op == "online_prune":
            host = self._alive(ev["node"])
            if host is None:
                return
            reply = await net.nodes[host]._maintain(
                {"op": "prune", "keep": ev["keep"]}
            )
            if reply.get("ok") and reply.get("segments_pruned"):
                self._record(
                    "online_prune", host, reply["segments_pruned"]
                )
        elif op == "online_compact_crash":
            host = self._alive(ev["node"])
            store = net.stores.get(host) if host is not None else None
            if (
                host is None
                or store is None
                or not hasattr(store, "fail_next_compact")
            ):
                return
            # The off-loop planner dies mid-write (a partial tmp on
            # disk): the node must self-clean the artifact, degrade
            # cleanly, and recover — while every session it was serving
            # stays connected.
            store.fail_next_compact = True
            reply = await net.nodes[host]._maintain({"op": "compact"})
            store.fail_next_compact = False
            self._record(
                "online_compact_crash", host, int(bool(reply.get("ok")))
            )
        elif op == "stage_crash":
            from p1_tpu_torch.node.pipeline import LANE_STAGES

            stage = ev["stage"]
            if stage in LANE_STAGES:
                # Lane-worker death on a LIVE node: the pipeline must
                # respawn the lane and retry the job (fires inline at
                # pipeline_workers=0 too, so the sim exercises the same
                # accounting) — the invariants then prove nothing was
                # lost at the boundary.
                host = self._alive(ev["node"])
                if host is not None:
                    self._record("stage_crash", host, stage)
                    net.nodes[host].pipeline.fail_next(stage)
            else:
                # On-loop stage boundary: no thread to kill — the
                # process dies, stage-tagged in the trace.
                host = self.hosts[ev["node"]]
                if host in net.nodes:
                    self._record("stage_crash", host, stage)
                    await net.crash_node(host, torn=0)
                    self.counts["crashes"] += 1
        elif op == "partition":
            k = max(1, min(self.n - 1, int(self.n * ev["frac"])))
            self.partitioned = True
            net.net.partition(self.hosts[:k], self.hosts[k:])
        elif op == "heal":
            if self.partitioned:
                self.partitioned = False
                net.net.heal()
        elif op == "disk_fail":
            from p1_tpu_torch.chain.testing import StoreFaultPlan

            host = self.hosts[ev["node"]]
            store = net.stores.get(host)
            if host in net.nodes and store is not None:
                self._record("disk_fail", host, ev["errno"])
                store.plan = StoreFaultPlan(
                    fail_writes_from=store.writes + 1,
                    write_errno=ev["errno"],
                )
        elif op == "disk_heal":
            host = self.hosts[ev["node"]]
            store = net.stores.get(host)
            if store is not None:
                self._record("disk_heal", host)
                store.clear_faults()
        elif op == "slow_link":
            host = self.hosts[ev["node"]]
            self.slowed.add(host)
            self._record("slow_link", host, ev["latency_ms"], ev["loss"])
            profile = LinkProfile(
                latency_s=ev["latency_ms"] / 1e3,
                jitter_s=ev["latency_ms"] / 4e3,
                loss=ev["loss"],
            )
            for other in self.hosts:
                if other != host:
                    net.net.set_profile(host, other, profile)
        elif op == "restore_link":
            self._restore_link(self.hosts[ev["node"]])
        elif op == "hostile":
            from p1_tpu_torch.node.protocol import MsgType
            from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks

            victim = self._alive(ev["node"])
            if victim is None:
                return
            src = f"66.6.0.{len(self.actors)}"
            plan = (
                FaultPlan(stale_replies=True)
                if ev["fault"] == "stale"
                else FaultPlan(swallow=frozenset({MsgType.GETBLOCKS}))
            )
            hp = HostilePeer(
                make_blocks(ev["height"], self.difficulty),
                plan=plan,
                transport=net.net.host(src),
                host=src,
                rng=random.Random(net.seed * 101 + len(self.actors)),
            )
            await hp.start()
            self._record("hostile", victim, ev["fault"])
            await hp.dial(victim, NODE_PORT)
            self.actors.append(hp)
        elif op == "snap_join":
            await self._snap_join(ev)
        elif op == "snap_liar":
            await self._snap_join(ev, fault=ev["fault"])
        elif op == "probe":
            # Leak-gauge snapshot (the longevity soak's midpoint/end
            # markers): recorded in the trace — a probe that silently
            # vanished would void the leak comparison.
            self._record("probe", len(self.probes))
            self.probes.append(self._gauge_snapshot())
        elif op == "calm":
            # Stop every live adversary (the soak's bounded-envelope
            # closer for hostile/flood clusters).
            self._record("calm", len(self.actors))
            for actor in self.actors:
                await actor.stop()
            self.actors.clear()
        elif op == "flood":
            from p1_tpu_torch.node.testing import FloodPlan, GreedyPeer, make_blocks

            victim = self._alive(ev["node"])
            if victim is None:
                return
            src = f"66.6.1.{len(self.actors)}"
            plan = (
                FloodPlan(queries=True, burst=4, pause_s=0.25)
                if ev["kind"] == "queries"
                else FloodPlan(blocks=True, burst=4, pause_s=0.25)
            )
            gp = GreedyPeer(
                make_blocks(4, self.difficulty),
                plan=plan,
                transport=net.net.host(src),
                rng=random.Random(net.seed * 103 + len(self.actors)),
            )
            self._record("flood", victim, ev["kind"])
            await gp.start(victim, NODE_PORT)
            self.actors.append(gp)
        elif op == "watch_start":
            await self._watch_start(ev)
        elif op == "replica_kill":
            await self._replica_kill(ev)
        elif op == "replica_join":
            await self._replica_join(ev)
        elif op == "watch_stop":
            w = self.watchers.pop(ev["watcher"], None)
            if w is not None:
                self._record("watch_stop", ev["watcher"], len(w.events))
                await w.stop()
                self.retired_watchers.append(w)
        elif op == "sub_flood":
            from p1_tpu_torch.node.testing import FloodPlan, GreedyPeer, make_blocks

            victim = self._alive(ev["node"])
            if victim is None:
                return
            src = f"66.6.2.{len(self.actors)}"
            gp = GreedyPeer(
                make_blocks(2, self.difficulty),
                plan=FloodPlan(subscribe=True, burst=4, pause_s=0.25),
                transport=net.net.host(src),
                rng=random.Random(net.seed * 109 + len(self.actors)),
            )
            self._record("sub_flood", victim)
            await gp.start(victim, NODE_PORT)
            self.actors.append(gp)
        self.counts["applied"] += 1

    async def _watch_start(self, ev: dict) -> None:
        """Spawn one live watcher (op ``watch_start``) on the payee
        account — the wallet whose confirmations the quiesce invariant
        must prove were never missed.  Idempotent per slot (subsets of
        a schedule stay runnable); a slot freed by ``watch_stop`` may
        restart with a fresh watcher — the churn."""
        slot = ev["watcher"]
        if slot in self.watchers:
            return
        primary = self._alive(ev["node"])
        if primary is None:
            return
        w = _Watcher(
            self.net,
            serial=self.watch_serial,
            primary=primary,
            fallbacks=self.hosts[: self.n],
            item=self.payee.account,
            difficulty=self.difficulty,
            mute=self.inject_bug == "mute-push",
        )
        self.watch_serial += 1
        self.counts["watchers"] += 1
        self.watchers[slot] = w
        self._record("watch_start", primary, slot)
        await w.start()

    async def _replica_kill(self, ev: dict) -> None:
        """The directed kill-one-replica (op ``replica_kill``): crash
        the node a live watcher's ReplicaSet is actively riding —
        mid-push, which is exactly when the wallet-side failover must
        replay the cursor gap-free.  Falls back to the scheduled node
        when no watcher is live (subsets stay runnable)."""
        victim = None
        for slot in sorted(self.watchers):
            w = self.watchers[slot]
            if not w.live or w.rs.active is None:
                continue
            host = w.rs.active[0]
            if host in self.net.nodes:
                victim = host
                break
        if victim is None:
            victim = self._alive(ev["node"])
        if victim is None or victim not in self.net.nodes:
            return
        self._record("replica_kill", victim)
        await self.net.crash_node(victim, torn=0)
        self.counts["crashes"] += 1

    async def _replica_join(self, ev: dict) -> None:
        """Fleet growth (op ``replica_join``): an honest snapshot-
        bootstrapped joiner enters the mesh (the same supervised
        GETSNAPSHOT cold start ``p1 serve --bootstrap`` runs), and
        every LIVE watcher's ReplicaSet rebalances onto it — the next
        failover may land on the newcomer, which must serve the same
        commitment chain as everyone else or be demoted."""
        host = self.hosts[ev["node"]]
        await self._snap_join(ev)
        if host not in self.net.nodes:
            return  # join refused (slot taken, no peers): no rebalance
        folded = 0
        for w in self.watchers.values():
            if w.live:
                w.add_target(host)
                folded += 1
        self._record("replica_join", host, folded)

    async def _snap_join(self, ev: dict, fault: str | None = None) -> None:
        """Spawn one snapshot-syncing joiner (op ``snap_join``), or one
        joiner whose FIRST peer is a hostile snapshot server running the
        scheduled pathology (op ``snap_liar``).  Idempotent per slot so
        schedule subsets stay runnable."""
        host = self.hosts[ev["node"]]
        net = self.net
        if host in net.nodes or host in net.crashed:
            return
        peers = []
        if fault is not None:
            from p1_tpu_torch.node.protocol import MsgType
            from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks

            if fault in ("balance", "root"):
                plan = FaultPlan(snapshot_lie=fault)
            elif fault == "truncate":
                plan = FaultPlan(snapshot_chunks=1)
            else:  # "stall": a server that never answers GETSNAPSHOT
                plan = FaultPlan(swallow=frozenset({MsgType.GETSNAPSHOT}))
            src = f"66.9.0.{len(self.actors)}"
            liar = HostilePeer(
                make_blocks(
                    ev["height"], self.difficulty, miner_id=f"snapliar-{src}"
                ),
                plan=plan,
                transport=net.net.host(src),
                host=src,
                rng=random.Random(net.seed * 107 + len(self.actors)),
            )
            await liar.start()
            self.actors.append(liar)
            peers.append(f"{src}:{liar.port}")
        for p in ev.get("peers", ()):
            alive = self._alive(p)
            if alive is not None and alive not in peers:
                peers.append(alive)
        self._record("snap_join", host, fault or "honest")
        await net.add_node(
            name=host,
            peers=peers,
            snapshot_sync=True,
            snapshot_min_lead=2,
            snapshot_interval=SNAPSHOT_INTERVAL,
            recon_gossip=self.recon,
        )

    def _restore_link(self, host: str) -> None:
        if host not in self.slowed:
            return
        self.slowed.discard(host)
        self._record("restore_link", host)
        for other in self.hosts:
            if other != host:
                self.net.net.set_profile(
                    host, other, self.net.net.default_profile
                )

    async def _recover(self, host: str) -> None:
        net = self.net
        verdict = fsck_verdict(net.configs[host].store_path)
        self.recover_verdicts.append(verdict)
        if self.inject_bug == "deaf-recover":
            # Test-only seeded bug: the reboot loses its peer list.
            net.configs[host] = dataclasses.replace(
                net.configs[host], peers=()
            )
        await net.recover_node(host)
        if self.inject_bug == "relapse-disk":
            from p1_tpu_torch.chain.testing import StoreFaultPlan

            # Test-only seeded bug: recovery declared the disk healthy
            # without proving it — the first post-recover append fails
            # and the node is stuck serve-only.
            net.stores[host].plan = StoreFaultPlan(fail_writes_from=1)
        self.counts["recoveries"] += 1

    # -- the run -----------------------------------------------------------

    async def main(self, events: list[dict]) -> dict:
        net = self.net
        violations: list[dict] = []
        # Preamble: backbone + one seeded extra edge, node 0's coinbase
        # pinned to the funded wallet, two warmup blocks everywhere.
        topo = random.Random(net.seed ^ 0x70B0C4)
        for i, host in enumerate(self.hosts[: self.n]):
            peers = []
            if i > 0:
                peers.append(self.hosts[i - 1])
                if i > 2:
                    peers.append(self.hosts[topo.randrange(i - 1)])
            kwargs = {"miner_id": self.wallet.account} if i == 0 else {}
            await net.add_node(
                name=host,
                peers=peers,
                snapshot_interval=SNAPSHOT_INTERVAL,
                recon_gossip=self.recon,
                **kwargs,
            )
        assert await net.run_until(
            net.links_up, 60, step=0.25, wall_limit_s=self.wall_limit_s
        ), "chaos mesh never formed"
        miner0 = net.nodes[self.hosts[0]]
        for _ in range(2):
            await net.mine_on(miner0, spacing_s=1.0)
        assert await net.run_until(
            lambda: net.converged() and min(net.heights()) == 2,
            60,
            step=0.25,
            wall_limit_s=self.wall_limit_s,
        ), "chaos mesh never converged pre-schedule"

        # The schedule, in virtual time.
        t_start = net.clock.now
        for ev in sorted(events, key=lambda e: e["at"]):
            target = t_start + ev["at"]
            if target > net.clock.now:
                await asyncio.sleep(target - net.clock.now)
            await self._apply(ev)
            self._sample_assumed()

        # Epilogue: clear EVERY fault, deterministically, then settle.
        for actor in self.actors:
            await actor.stop()
        self.actors.clear()
        for host in sorted(self.slowed):
            self._restore_link(host)
        if self.partitioned:
            self.partitioned = False
            net.net.heal()
        for host, store in sorted(net.stores.items()):
            if host in net.nodes:
                store.clear_faults()
        for host in sorted(net.crashed):
            await self._recover(host)
        faults_cleared_at = net.clock.now
        # Give the disk-recovery supervisor its backoff window: a node
        # that degraded serve-only while the fault was armed clears the
        # state one jittered retry AFTER the heal, not the same instant.
        # "Permanently stuck" means still degraded past this bound.
        await net.run_until(
            lambda: not any(
                n._store_degraded for n in net.nodes.values()
            ),
            self.settle_vs / 4,
            step=0.25,
            wall_limit_s=self.wall_limit_s,
        )
        # Two-phase settle: let post-heal sync land, then mine one
        # fresh block (the announcement that must reach EVERY node —
        # including any the schedule just rebooted, and the tie-break
        # for same-height competing tips partition mining left) and
        # require global convergence on it.
        await net.run_until(
            net.converged,
            self.settle_vs / 2,
            step=0.25,
            wall_limit_s=self.wall_limit_s,
        )
        settle_host = self._alive(0, mining=True)
        if settle_host is not None:
            await net.mine_on(net.nodes[settle_host])
        converged = await net.run_until(
            lambda: net.converged()
            and len(set(net.heights())) == 1
            # Snapshot joiners owe a finished verdict: ASSUMED must have
            # resolved — flip or quarantine+fallback — by quiesce.
            and all(
                n.validation_state == "validated"
                for n in net.nodes.values()
            ),
            self.settle_vs / 2,
            step=0.25,
            wall_limit_s=self.wall_limit_s,
        )
        settle_vs = net.clock.now - faults_cleared_at
        # Push-plane quiesce: the settle block above was pushed to every
        # live subscription — give every surviving watcher the window to
        # verify its way (failovers and gap replays included) to the
        # converged tip before judging its stream.
        if converged and self.watchers:
            tip_h = max(net.heights())
            await net.run_until(
                lambda: all(
                    # Zero events = the watch TOFU-anchored AT the
                    # converged tip (a late start racing the settle
                    # block): caught up by definition.
                    not w.live or w.tip_height < 0 or w.tip_height >= tip_h
                    for w in self.watchers.values()
                ),
                self.settle_vs / 2,
                step=0.25,
                wall_limit_s=self.wall_limit_s,
            )

        # -- the invariant suite, at quiesce -------------------------------
        if not converged:
            tips = {h: n.chain.tip_hash.hex()[:12] for h, n in net.nodes.items()}
            violations.append(
                {
                    "invariant": "converge",
                    "detail": f"tips still split {settle_vs:.1f}vs after "
                    f"the last fault cleared: {tips}",
                }
            )
        if not net.ledger_conserved():
            violations.append(
                {
                    "invariant": "ledger",
                    "detail": "ledger sum != BLOCK_REWARD * height somewhere",
                }
            )
        for host, node in net.nodes.items():
            if node._store_degraded:
                violations.append(
                    {
                        "invariant": "serve-only",
                        "detail": f"{host} still degraded serve-only after "
                        "its disk healed",
                    }
                )
        for verdict in self.recover_verdicts:
            if verdict > 1:
                violations.append(
                    {
                        "invariant": "fsck",
                        "detail": "a crashed store was unrecoverable "
                        "(verdict 2) at reboot",
                    }
                )
        for host, node in net.nodes.items():
            if node.validation_state != "validated":
                violations.append(
                    {
                        "invariant": "assumed",
                        "detail": f"{host} still in the ASSUMED state at "
                        "quiesce (revalidation never resolved)",
                    }
                )
        violations.extend(self._check_pools())
        violations.extend(self._check_caches())
        violations.extend(self._check_assumed_samples())
        violations.extend(self._check_watchers(converged))
        violations.extend(self._check_leaks())
        all_watchers = self.retired_watchers + list(self.watchers.values())
        for w in self.watchers.values():
            await w.stop()

        from p1_tpu_torch.node.telemetry import propagation_summary_ms

        heights = net.heights()
        report = {
            "events": len(events),
            "schedule_tail": [e["op"] for e in events][-6:],
            **self.counts,
            "recover_verdicts": self.recover_verdicts,
            "virtual_s": round(net.clock.now, 3),
            "net_events": net.net.events,
            "probes": len(self.probes),
            # The raw leak-gauge snapshots (midpoint vs end): the
            # numbers behind any "leak" violation, kept in the report
            # so a failing soak is diagnosable from its JSON alone.
            "leak_gauges": {
                "mid": self.probes[-2] if len(self.probes) >= 2 else None,
                "end": self.probes[-1] if self.probes else None,
            },
            "settle_virtual_s": round(settle_vs, 3),
            "watch_events": sum(len(w.events) for w in all_watchers),
            "watch_resets": sum(w.resets for w in all_watchers),
            "heights": {"min": min(heights), "max": max(heights)},
            "reorgs_total": sum(
                n.metrics.reorgs for n in net.nodes.values()
            ),
            # Telemetry timeline: survivor-side propagation
            # latency under the whole fault schedule, virtual-time —
            # the "how did gossip feel while the mesh burned" figure a
            # convergence bit cannot carry.
            "telemetry": {
                "propagation": propagation_summary_ms(
                    n.telemetry for n in net.nodes.values()
                )
            },
            "violations": violations,
        }
        await net.stop_all()
        # Shutdown verdicts AFTER the stores closed cleanly: whatever
        # the schedule inflicted, what reaches disk must stay loadable.
        for host in self.hosts:
            config = net.configs.get(host)
            if config is None:
                continue  # a joiner slot this schedule never spawned
            path = config.store_path
            if path and fsck_verdict(path) > 1:
                report["violations"].append(
                    {
                        "invariant": "fsck",
                        "detail": f"{host}'s store unrecoverable at shutdown",
                    }
                )
        report["trace_digest"] = net.trace_digest()
        return report

    def _gauge_snapshot(self) -> dict:
        """Per-node leak gauges: everything that must NOT grow
        monotonically over a long, stationary fault mix.  Pure reads —
        a probe must never perturb what it measures."""
        out: dict[str, dict] = {}
        for host in self.hosts:
            node = self.net.nodes.get(host)
            if node is None:
                continue
            out[host] = {
                "tasks": len(node._tasks) + len(node._sessions),
                "banned": len(node._banned_until),
                "violations": len(node._violations),
                "known_addrs": len(node._known_addrs),
                "tried_addrs": len(node._tried_addrs),
                "mempool": len(node.mempool),
                "sig_cache": len(node.sig_cache),
                "subs_live": node.subscriptions.snapshot()["live"],
                "subs_queue_bytes": node.subscriptions.queue_depth_bytes,
                "gauge_bytes": node._memory_gauge(),
                # Supervision/store retry counters: monotone by design —
                # the leak check bounds their second-half GROWTH, not
                # their value (a runaway retry loop is a hockey stick
                # even when every table above stays capped).  Liveness
                # pings are deliberately NOT in here: their rate rides
                # topology and gossip idleness, not retry health.
                "retry_counters": int(
                    node.metrics.sync_stalls
                    + node.metrics.sync_failovers
                    + node.metrics.sync_exhausted
                    + node.metrics.store_retries
                    + node.metrics.mempool_sync_stalls
                    + node.metrics.cblock_fetch_stalls
                ),
            }
        return out

    def _check_leaks(self) -> list[dict]:
        """The longevity invariants: hard caps on every bounded table
        at quiesce, plus mid-vs-end growth comparisons from the probe
        snapshots.  Active only when a schedule carried probes (the
        soak always does); a plain chaos schedule skips it."""
        from p1_tpu_torch.node.node import (
            MAX_KNOWN_ADDRS,
            MAX_PEERS,
            MAX_TRACKED_HOSTS,
            MAX_TRIED_ADDRS,
        )

        out: list[dict] = []
        if len(self.probes) < 2:
            return out
        mid, end = self.probes[-2], self.probes[-1]
        for host in self.hosts:
            node = self.net.nodes.get(host)
            if node is None:
                continue
            caps = [
                ("banned", len(node._banned_until), MAX_TRACKED_HOSTS),
                ("violations", len(node._violations), MAX_TRACKED_HOSTS),
                ("known_addrs", len(node._known_addrs), MAX_KNOWN_ADDRS),
                ("tried_addrs", len(node._tried_addrs), MAX_TRIED_ADDRS),
                ("sig_cache", len(node.sig_cache), node.sig_cache.max_entries),
                (
                    "proof_cache_bytes",
                    node.chain.proof_cache.bytes_used,
                    node.chain.proof_cache.max_bytes,
                ),
                (
                    "filter_index_bytes",
                    node.chain.filter_index.bytes_used,
                    node.chain.filter_index.max_bytes,
                ),
                ("tasks", len(node._tasks) + len(node._sessions),
                 MAX_PEERS + 16),
            ]
            for name, value, cap in caps:
                if value > cap:
                    out.append(
                        {
                            "invariant": "leak",
                            "detail": f"{host} {name} = {value} over its "
                            f"bound {cap} at quiesce",
                        }
                    )
            m, e = mid.get(host), end.get(host)
            if m is None or e is None:
                continue  # crashed across a probe: growth unreadable
            if e["tasks"] > m["tasks"] + 8:
                out.append(
                    {
                        "invariant": "leak",
                        "detail": f"{host} task count grew {m['tasks']} -> "
                        f"{e['tasks']} over the second half",
                    }
                )
            if e["mempool"] > m["mempool"] + 64:
                out.append(
                    {
                        "invariant": "leak",
                        "detail": f"{host} mempool grew {m['mempool']} -> "
                        f"{e['mempool']} over the second half",
                    }
                )
            growth = e["retry_counters"] - m["retry_counters"]
            # A crash between the probes resets the node's counters
            # (recover builds a fresh Node): negative growth means a
            # restart, not a recovery of leaked memory — skip.
            if growth > 3 * m["retry_counters"] + 100:
                out.append(
                    {
                        "invariant": "leak",
                        "detail": f"{host} supervision/retry counters grew "
                        f"{growth} in the second half vs "
                        f"{m['retry_counters']} in the first — a runaway "
                        "retry loop",
                    }
                )
        return out

    def _sample_assumed(self) -> None:
        """Record every ASSUMED joiner's answer to "what is the wallet's
        balance at your tip?" — the claims the flip must never have let
        a fully-validated node contradict."""
        for host in self.joiner_hosts:
            node = self.net.nodes.get(host)
            if node is None or node.validation_state != "assumed":
                continue
            self.samples.append(
                (
                    host,
                    node.chain.height,
                    node.chain.tip_hash,
                    node.chain.balance(self.wallet.account),
                )
            )

    def _check_assumed_samples(self) -> list[dict]:
        """The snapshot invariant: for every joiner that FLIPPED (its
        snapshot was confirmed honest), every balance it reported while
        ASSUMED must match what the validated history says at the same
        block.  Joiners that diverged made no claim that survived — the
        quarantine retracted their state wholesale."""
        from p1_tpu_torch.chain.ledger import balances as audit_balances

        out = []
        account = self.wallet.account
        for host, height, tip_hash, reported in self.samples:
            node = self.net.nodes.get(host)
            if node is None or node.metrics.snapshot_flips == 0:
                continue
            for ref_host, ref in self.net.nodes.items():
                if ref_host == host or ref.chain.base_height != 0:
                    continue
                if ref.chain.main_hash_at(height) != tip_hash:
                    continue  # sampled tip reorged away: no surviving claim
                blocks = [
                    ref.chain._block_at(ref.chain.main_hash_at(h))
                    for h in range(height + 1)
                ]
                truth = audit_balances(blocks).get(account, 0)
                if truth != reported:
                    out.append(
                        {
                            "invariant": "assumed-balance",
                            "detail": f"{host} reported {reported} for the "
                            f"wallet at height {height} while ASSUMED; the "
                            f"validated chain says {truth}",
                        }
                    )
                break
        return out

    def _check_watchers(self, converged: bool) -> list[dict]:
        """The push-plane invariants at quiesce.

        Every watcher STILL LIVE at the horizon owes the push
        plane's claim: its verified stream is gap-free from its coverage floor
        to the converged tip, byte-agrees with the converged chain
        (block hash AND filter-header commitment per height), and holds
        a matched event carrying the paying txids for EVERY height the
        watched wallet was paid — zero missed confirmations, whatever
        the schedule did to the serving nodes.  Churned-away watchers
        are judged for honesty only: the mesh tells no lies, so a
        watch that ended in a CommitmentViolation demoted an honest
        node — itself a bug.  And no node may hold more live
        subscription entries than there are live watchers: a dead
        session whose registry entry survived is a leak."""
        out: list[dict] = []
        all_watchers = self.retired_watchers + list(self.watchers.values())
        for w in all_watchers:
            if w.error is not None and "CommitmentViolation" in w.error:
                out.append(
                    {
                        "invariant": "push-honest",
                        "detail": f"watcher {w.serial} convicted an honest "
                        f"mesh of lying: {w.error}",
                    }
                )
        if not converged or not self.watchers:
            return out
        live_watchers = sum(1 for w in self.watchers.values() if w.live)
        subs_live = sum(
            n.subscriptions.snapshot()["live"]
            for n in self.net.nodes.values()
        )
        if subs_live > live_watchers:
            out.append(
                {
                    "invariant": "push-leak",
                    "detail": f"{subs_live} live subscription entries for "
                    f"{live_watchers} live watchers at quiesce — dead "
                    "sessions left registry entries behind",
                }
            )
        # The converged truth, from an archive-grade node (full blocks
        # from genesis); the generators cap pruning/re-basing at one
        # host per schedule, so one nearly always exists — without one
        # the deep replay below has no ground truth and is skipped.
        ref = next(
            (
                n
                for n in self.net.nodes.values()
                if n.chain.base_height == 0 and not n.chain.prune_floor
            ),
            None,
        )
        if ref is None:
            return out
        chain = ref.chain
        tip_h = chain.height
        account = self.payee.account
        paid: dict[int, set[bytes]] = {}
        for h in range(1, tip_h + 1):
            blk = chain._block_at(chain.main_hash_at(h))
            ids = {
                tx.txid()
                for tx in blk.txs
                if account in (tx.sender, tx.recipient)
            }
            if ids:
                paid[h] = ids
        for slot, w in sorted(self.watchers.items()):
            if not w.live:
                out.append(
                    {
                        "invariant": "push-live",
                        "detail": f"watcher {slot} died mid-watch: {w.error}",
                    }
                )
                continue
            if w.tip_height < 0:
                # Zero events: the watch TOFU-anchored at the converged
                # tip (a late start racing the settle block), so there
                # was nothing to push and nothing to judge — its floor
                # is unset, which also skips the per-height checks.
                continue
            if w.tip_height < tip_h:
                out.append(
                    {
                        "invariant": "push-lag",
                        "detail": f"watcher {slot} stuck at height "
                        f"{w.tip_height} with the mesh converged at {tip_h}",
                    }
                )
                continue
            lo = w.floor if w.floor is not None else tip_h
            for h in range(lo + 1, tip_h + 1):
                ev = w.by_height.get(h)
                if ev is None:
                    out.append(
                        {
                            "invariant": "push-gap",
                            "detail": f"watcher {slot} has no event for "
                            f"height {h} inside its verified window",
                        }
                    )
                elif ev["block_hash"] != chain.main_hash_at(h):
                    out.append(
                        {
                            "invariant": "push-chain",
                            "detail": f"watcher {slot}'s last event at "
                            f"height {h} is not the converged block",
                        }
                    )
                elif ev["filter_header"] != chain.filter_headers.header_at(h):
                    out.append(
                        {
                            "invariant": "push-commit",
                            "detail": f"watcher {slot}'s filter header at "
                            f"height {h} contradicts the converged "
                            "commitment chain",
                        }
                    )
                elif h in paid and (
                    not ev["matched"] or not paid[h] <= set(ev["txids"])
                ):
                    out.append(
                        {
                            "invariant": "push-missed",
                            "detail": f"watcher {slot} missed the wallet's "
                            f"confirmation at height {h} "
                            f"(matched={ev['matched']})",
                        }
                    )
        return out

    def _check_pools(self) -> list[dict]:
        """No crash-restart (or reorg) may resurrect a transaction the
        node's own main chain already mined — the mempool
        crash-consistency invariant."""
        out = []
        for host, node in self.net.nodes.items():
            for txid in node.mempool._txs:
                if txid in node.chain._tx_index:
                    out.append(
                        {
                            "invariant": "resurrect",
                            "detail": f"{host} pool holds mined tx "
                            f"{txid.hex()[:16]}",
                        }
                    )
        return out

    def _check_caches(self) -> list[dict]:
        """Proof/filter caches must agree with the post-reorg chain:
        every resident filter byte-matches a fresh build from the block
        body, and the tip block's transaction proofs verify as a
        stateless client would."""
        from p1_tpu_torch.chain.filters import block_filter
        from p1_tpu_torch.chain.proof import SPVError, verify_tx_proof

        out = []
        for host, node in self.net.nodes.items():
            chain = node.chain
            tip = chain.tip
            # sorted: the dedup set must not pick the probe order, or
            # the violation list (and any repro built from it) rides
            # hash order — the exact class `p1 lint`'s set-iteration
            # rule pins.
            for height in sorted({1, chain.height // 2, chain.height}):
                bhash = chain.main_hash_at(height)
                if bhash is None:
                    continue
                cached = chain.filter_index.get(bhash)
                if cached is not None and cached != block_filter(
                    chain._block_at(bhash)
                ):
                    out.append(
                        {
                            "invariant": "caches",
                            "detail": f"{host} filter for height {height} "
                            "diverges from its block",
                        }
                    )
            for tx in tip.txs[:2]:
                proof = chain.tx_proof(tx.txid())
                try:
                    if proof is None:
                        raise SPVError("no proof for a tip transaction")
                    verify_tx_proof(
                        proof,
                        self.difficulty,
                        chain.genesis.block_hash(),
                        txid=tx.txid(),
                    )
                    if proof.height != chain.height:
                        raise SPVError("tip proof at wrong height")
                except SPVError as e:
                    out.append(
                        {
                            "invariant": "caches",
                            "detail": f"{host} tip proof failed: {e}",
                        }
                    )
        return out


# -- delta-debugging shrinker ---------------------------------------------


def shrink_schedule(
    events: list[dict], reproduces, max_runs: int = 120
) -> tuple[list[dict], int]:
    """Minimize ``events`` to a small list that still ``reproduces``
    (ddmin: try dropping chunks at doubling granularity, restart
    coarse after every success).  ``reproduces(subset) -> bool`` runs
    one full chaos replay per call, so ``max_runs`` bounds total cost;
    the result is 1-minimal when the budget allows (no single event can
    be removed), merely smaller when it doesn't."""
    assert reproduces(events), "the full schedule must reproduce first"
    runs = 1
    n = 2
    while len(events) >= 2 and runs < max_runs:
        chunk = max(1, len(events) // n)
        reduced = False
        for start in range(0, len(events), chunk):
            candidate = events[:start] + events[start + chunk :]
            if not candidate:
                continue
            runs += 1
            if reproduces(candidate):
                events = candidate
                n = max(n - 1, 2)
                reduced = True
                break
            if runs >= max_runs:
                break
        if not reduced:
            if n >= len(events):
                break
            n = min(len(events), 2 * n)
    return events, runs


# -- repro artifacts -------------------------------------------------------


def write_repro(
    path,
    report: dict,
    events: list[dict],
    *,
    seed: int,
    nodes: int,
    difficulty: int,
    inject_bug: str | None = None,
) -> None:
    """One replayable violation: everything ``run_repro`` needs to
    reproduce it from nothing — seed, topology size, the (shrunk)
    schedule, the expected violations and trace digest."""
    artifact = {
        "format": REPRO_FORMAT,
        "seed": seed,
        "nodes": nodes,
        "difficulty": difficulty,
        "inject_bug": inject_bug,
        "events": events,
        "expected_violations": sorted(
            {v["invariant"] for v in report["violations"]}
        ),
        "expected_trace_digest": report["trace_digest"],
    }
    Path(path).write_text(json.dumps(artifact, indent=1))


def run_repro(path, device: str = "cuda") -> tuple[dict, dict]:
    """Replay a repro artifact on ``device``; returns ``(report, artifact)``.
    Raises ValueError for anything that is not a chaos repro."""
    try:
        artifact = json.loads(Path(path).read_text())
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable repro artifact {path}: {e}") from None
    if not isinstance(artifact, dict) or artifact.get("format") != REPRO_FORMAT:
        raise ValueError(f"{path} is not a {REPRO_FORMAT} artifact")
    report = run_chaos(
        artifact["seed"],
        nodes=artifact["nodes"],
        events=artifact["events"],
        difficulty=artifact["difficulty"],
        inject_bug=artifact.get("inject_bug"),
        device=device,
    )
    return report, artifact
