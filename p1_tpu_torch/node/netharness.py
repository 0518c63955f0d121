"""The `p1 net` soak harness: spawn a localhost mesh, drive it, audit it.

Extracted from ``cli.py`` (which keeps only parsing + dispatch): the
subprocess mesh spawner with its readiness handshake and shared mining
deadline, the benign signed-transfer economy (``inject_txs``), the
byzantine-actor runner (``node/byzantine.py``), and the summary
auditor — convergence, exact ledger conservation, byzantine containment,
memory bounds.  This is the repo's net-level soak rig; tests
(``tests/test_cli.py``) and operators invoke it through `p1 net`.

The port's copy of ``p1_tpu/node/netharness.py``: each child is
``python -m p1_tpu_torch node`` with the parent's ``--device``, so a
net on the card runs every node's miner and signature batches there.
A child's start (the torch import, then the card's) can take many
seconds, which is why the mining deadline starts only after every
child's ready line.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

from p1_tpu_torch.node.byzantine import byzantine_actor, new_stats


async def inject_txs(
    ports, keys, difficulty, deadline, rate, retarget=None
) -> tuple[int, int]:
    """Drive a live economy during a `p1 net` run: ~``rate`` transfers/sec,
    each one a real wallet round — GETACCOUNT for the sender's next seq at
    its own node, sign chain-bound, push via the tx client.  Best-effort:
    a busy node (GIL-bound mining) or an unaffordable pick just skips a
    beat; the audit invariant is conservation, not delivery."""
    import random

    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.node.client import get_account, send_tx

    tag = genesis_hash(difficulty, retarget)
    submitted = failed = 0
    rng = random.Random(0xD1CE)
    period = 1.0 / rate
    while time.time() < deadline - 1.0:
        i = rng.randrange(len(keys))
        recipient = keys[rng.randrange(len(keys))].account
        try:
            state = await get_account(
                "127.0.0.1",
                ports[i],
                keys[i].account,
                difficulty,
                timeout=5,
                retarget=retarget,
            )
            amount = rng.randint(1, 5)
            if state.balance >= amount + 1:
                tx = Transaction.transfer(
                    keys[i], recipient, amount, 1, state.next_seq, chain=tag
                )
                await send_tx(
                    "127.0.0.1",
                    ports[i],
                    tx,
                    difficulty,
                    timeout=5,
                    retarget=retarget,
                )
                submitted += 1
        except (
            ConnectionError,
            OSError,
            ValueError,
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
        ):
            failed += 1
        await asyncio.sleep(period)
    return submitted, failed


async def net_drive(
    ports, keys, difficulty, deadline, rate, n_byzantine, retarget=None
):
    """Run the benign economy and the byzantine actors concurrently."""
    byz_stats = new_stats()
    tasks = []
    if rate > 0:
        tasks.append(
            inject_txs(ports, keys, difficulty, deadline, rate, retarget)
        )
    for actor in range(n_byzantine):
        tasks.append(
            byzantine_actor(
                actor, ports, difficulty, deadline, retarget, byz_stats
            )
        )
    results = await asyncio.gather(*tasks, return_exceptions=True)
    submitted = failed = 0
    for r in results:
        if isinstance(r, tuple):
            submitted, failed = r
        elif isinstance(r, BaseException):
            raise r
    return submitted, failed, byz_stats


def run_net(args) -> int:
    """Spawn N `p1_tpu_torch node` subprocesses in a full mesh and check they
    converge on one tip (benchmark config 4, BASELINE.json:10).  With
    ``--tx-rate`` the run carries a live signed-transfer economy between
    the miners' accounts, and the summary audits every node's ledger for
    exact conservation — the whole consensus stack (signatures, nonces,
    overdraw rejection, reorg undo) exercised under real concurrent
    forks."""
    import subprocess

    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.retarget import RetargetRule

    # Validate the retarget flag pair up front: a bad pair must be ONE
    # clean CLI error here, not N child-node tracebacks (or — for a lone
    # --target-spacing — a silently fixed-difficulty run).
    try:
        net_rule = RetargetRule.from_params(
            getattr(args, "retarget_window", 0),
            getattr(args, "target_spacing", 0),
        )
    except ValueError as e:
        raise SystemExit(str(e))
    ports = [args.base_port + i for i in range(args.nodes)]
    keys = [
        Keypair.from_seed_text(f"p1-net-{args.base_port}-{i}")
        for i in range(args.nodes)
    ]
    procs = []
    for i, port in enumerate(ports):
        cmd = [
            sys.executable,
            "-m",
            "p1_tpu_torch",
            "node",
            "--port",
            str(port),
            "--difficulty",
            str(args.difficulty),
            "--backend",
            args.backend,
            "--device",
            args.device,
            "--deadline",
            "stdin",
            "--miner-id",
            keys[i].account if args.tx_rate > 0 else f"node{i}",
        ]
        if args.chunk:
            cmd += ["--chunk", str(args.chunk)]
        if args.batch:
            cmd += ["--batch", str(args.batch)]
        # Tight liveness deadlines for the localhost mesh: a silent
        # camper (the byzantine "camp" attack, or any wedged peer) is
        # probed within 10 s and evicted 5 s later, so soak statuses
        # show the keepalive layer actually firing.  Honest miners
        # gossip constantly and never get probed.
        cmd += ["--ping-interval", "10", "--pong-timeout", "5"]
        # Tight sync supervision to match: a localhost batch turns
        # around in milliseconds, so a 5 s no-progress window on a
        # catch-up is decisively a stall — soak statuses surface the
        # failover layer under byzantine serve-and-starve peers while
        # honest syncs (progress resets the deadline) never trip it.
        cmd += ["--sync-stall-timeout", "5"]
        if net_rule is not None:
            cmd += [
                "--retarget-window", str(net_rule.window),
                "--target-spacing", str(net_rule.spacing),
            ]
        if args.no_compact_gossip:
            cmd += ["--no-compact-gossip"]
        if args.discover:
            # One seed only; discovery must assemble the mesh.
            peers = [f"127.0.0.1:{ports[0]}"] if i else []
            cmd += ["--target-peers", str(args.nodes - 1)]
        else:
            peers = [f"127.0.0.1:{p}" for p in ports[:i]]
        if peers:
            cmd += ["--peers", *peers]
        procs.append(
            subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True
            )
        )
    statuses = []
    try:
        # Readiness handshake: interpreter startup can cost many seconds on
        # a loaded host, so a deadline computed before the children exist
        # could expire before they boot.  Every child prints a ready line;
        # only then does the shared mining deadline start counting.
        for proc in procs:
            ready = json.loads(proc.stdout.readline())
            assert "ready" in ready, ready
        deadline = time.time() + args.duration
        for proc in procs:
            proc.stdin.write(f"{deadline!r}\n")
            proc.stdin.flush()  # leave stdin open: communicate() closes it
        txs_submitted = txs_failed = 0
        byz_stats = None
        n_byz = getattr(args, "byzantine", 0)
        if args.tx_rate > 0 or n_byz > 0:
            txs_submitted, txs_failed, byz_stats = asyncio.run(
                net_drive(
                    ports,
                    keys,
                    args.difficulty,
                    deadline,
                    args.tx_rate,
                    n_byz,
                    retarget=net_rule,
                )
            )
        for proc in procs:
            out, _ = proc.communicate(timeout=args.duration + 120)
            lines = (out or "").strip().splitlines()
            if not lines:
                raise RuntimeError(f"node pid {proc.pid} produced no status output")
            statuses.append(json.loads(lines[-1]))
    finally:
        for proc in procs:  # never leave orphaned miners holding the ports
            if proc.poll() is None:
                proc.kill()
    tips = {s["tip"] for s in statuses}
    result = {
        "config": "net",
        "nodes": args.nodes,
        "difficulty": args.difficulty,
        "converged": len(tips) == 1,
        "height": max(s["height"] for s in statuses),
        "blocks_mined_total": sum(s["blocks_mined"] for s in statuses),
        "reorgs_total": sum(s["reorgs"] for s in statuses),
        # Gossip bandwidth elided by compact block relay, net-wide.
        "compact_bytes_saved_total": sum(
            s["compact"]["bytes_saved"] for s in statuses
        ),
        "compact_tx_hit_total": sum(
            s["compact"]["tx_hits"] for s in statuses
        ),
        "compact_tx_fetched_total": sum(
            s["compact"]["tx_fetched"] for s in statuses
        ),
        "wire_bytes_total": sum(
            s["wire"]["bytes_sent"] for s in statuses
        ),
        # Network-level propagation delay (gossip send -> accept), the
        # worst node's view: median of per-node medians would hide a slow
        # peer, so report the max median and the max p95 across nodes.
        "propagation_delay_ms": {
            "max_median": max(
                (s["propagation"]["median_ms"] or 0.0 for s in statuses),
                default=0.0,
            ),
            "max_p95": max(
                (s["propagation"]["p95_ms"] or 0.0 for s in statuses),
                default=0.0,
            ),
            "samples_total": sum(s["propagation"]["samples"] for s in statuses),
        },
        "statuses": statuses,
    }
    if args.tx_rate > 0:
        from p1_tpu_torch.core.tx import BLOCK_REWARD

        # Conservation: every block carries a coinbase and fees credit the
        # miner, so each node's ledger must sum to exactly reward x its
        # height — across hundreds of reorgs and a live spend stream.
        conserved = all(
            s["ledger_sum"] == BLOCK_REWARD * s["height"] for s in statuses
        )
        result["economy"] = {
            "txs_submitted": txs_submitted,
            "txs_failed": txs_failed,
            "txs_accepted_total": sum(s["txs_accepted"] for s in statuses),
            "ledger_conserved": conserved,
        }
        if not conserved:
            result["converged"] = False  # fail loudly: consensus bug
    if n_byz > 0 and byz_stats is not None:
        # The byzantine soak's containment contract, asserted in the
        # summary rather than left to log-reading: honest nodes must
        # have (a) kept converging and conserving (checked above),
        # (b) actually banned the attackers (their oversized/garbage
        # frames are scorable, so refused connects must appear), and
        # (c) stayed within their memory bounds — the address book and
        # pool caps hold under spam.
        from p1_tpu_torch.mempool import Mempool
        from p1_tpu_torch.node.node import MAX_KNOWN_ADDRS, MAX_TRIED_ADDRS

        attacks_sent = sum(byz_stats["attacks"].values())
        bans_fired = byz_stats["refused_connects"] > 0
        pool_cap = Mempool().max_txs  # the node's actual bound
        memory_bounded = all(
            s["known_addrs"] <= MAX_KNOWN_ADDRS + MAX_TRIED_ADDRS
            and s["mempool"] <= pool_cap
            for s in statuses
        )
        result["byzantine"] = {
            "attackers": n_byz,
            "attacks_sent": attacks_sent,
            "attacks": byz_stats["attacks"],
            "refused_connects": byz_stats["refused_connects"],
            "slow_hellos": byz_stats["slow_hellos"],
            # Silent-camper sessions the ATTACKERS saw torn down early
            # (camping sessions send nothing after HELLO, so these are
            # keepalive reaps), next to the nodes' aggregate idle-
            # eviction telemetry — an upper bound that can also include
            # an honest peer evicted during a GIL stall.
            "camp_evictions": byz_stats["camp_evictions"],
            "idle_evictions_total": sum(
                s.get("liveness", {}).get("peers_evicted_idle", 0)
                for s in statuses
            ),
            "bans_fired": bans_fired,
            "memory_bounded": memory_bounded,
            "contained": bool(
                result["converged"] and bans_fired and memory_bounded
            ),
        }
        if not result["byzantine"]["contained"]:
            result["converged"] = False
    print(json.dumps(result))
    return 0 if result["converged"] else 1
