"""Command line of the port: ``python -m p1_tpu_torch <command>``.

The port of ``p1_tpu/cli.py``'s ``mine`` and ``sweep`` (benchmark configs
1/2), ``replay`` (config 3), ``keygen`` and the offline store commands
``balances``, ``compact``, ``fsck`` and ``snapshot``, with the reference's
flags, exit codes and JSON keys.  Each prints JSON on stdout; logs go to
stderr.

  python -m p1_tpu_torch mine --difficulty 20 --blocks 10              # on the card
  python -m p1_tpu_torch mine --difficulty 8 --blocks 2 --device cpu    # plain version
  python -m p1_tpu_torch sweep --difficulties 16:22 --blocks 5
  python -m p1_tpu_torch replay --n 10000 --difficulty 16               # on the card
  python -m p1_tpu_torch replay --n 32 --difficulty 8 --device cpu      # plain version
  python -m p1_tpu_torch keygen --out key.json
  python -m p1_tpu_torch balances --store chain.p1                     # on the card
  python -m p1_tpu_torch fsck --store chain.p1 --device cpu            # plain version

The store commands load the store untrusted, so every signature window
is revalidated: on the card (``hashx/csrc/ed25519_msm.cu``) by default,
with the plain PyTorch version under ``--device cpu``.

The node and its clients, with the reference's flags, exit codes and
JSON (``node`` takes ``--device`` in place of the reference's
``--platform``):

  python -m p1_tpu_torch node --difficulty 20 --port 9444              # on the card
  python -m p1_tpu_torch node --backend cpu --device cpu --difficulty 12
  python -m p1_tpu_torch net --nodes 4 --difficulty 20 --duration 20 --tx-rate 2
  python -m p1_tpu_torch tx --key K --recipient R --amount 5 --port 9444
  python -m p1_tpu_torch status|metrics|account|fees|proof|headers|watch|maintain ...

BASELINE config 5, the nonce search sharded over a mesh of slots
(``--backend sharded``: one slot on each card), in one process
or as a pod of processes that mine in lockstep over gloo, the leader
gossiping:

  python -m p1_tpu_torch mine --backend sharded --difficulty 28 --blocks 5
  python -m p1_tpu_torch pod --coordinator 127.0.0.1:7000 --num-hosts 2 --host-id 0 --duration 60
  python -m p1_tpu_torch pod --coordinator 127.0.0.1:7000 --num-hosts 2 --host-id 1 --duration 60

A node mines through the search kernel (``--backend cuda``, the
default) and sends the signature batches of deep sync, mempool pages
and ``--revalidate-store`` to ``ed25519_msm.cu``; ``--device cpu`` runs
both kernels' plain versions.  Without a card and without ``--device
cpu`` the node refuses to start.

The simulation, serving and fault planes: ``sim`` runs a scenario of
full nodes in virtual time and ``chaos`` seeded fault schedules over
such a mesh, each printing the reference's one-line JSON with its trace
digest.  A mesh seals its blocks through the search kernel on the card;
``--device cpu`` seals them with hashlib (the same blocks, the same
digest), and without a card and without ``--device cpu`` both exit 2.
``serve`` runs read-only replica workers over a chain store (host code):

  python -m p1_tpu_torch sim partition-heal --seed 0                 # 1,000 nodes, on the card
  python -m p1_tpu_torch sim fee-spam --seed 0 --device cpu
  python -m p1_tpu_torch chaos --seed 0 --schedules 2 --device cpu
  python -m p1_tpu_torch serve --store chain.p1 --difficulty 12 --port 9555 --workers 2

``lint`` runs the determinism/async-safety analyzer
(``p1_tpu_torch/analysis``) over the port's own sources: host code that
reads files and runs nothing on the card, so it takes no ``--device``
(exit 0 clean, 1 violations, stale grants or parse errors, 2 usage):

  python -m p1_tpu_torch lint [--json] [--rule R] [--granted] [--path P]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import statistics
import sys
import time


def _add_common(p: argparse.ArgumentParser, device_choices=None) -> None:
    p.add_argument("--difficulty", type=int, default=16)
    p.add_argument(
        "--backend",
        default="cuda",
        help="hash backend registry name (cuda, sharded: the search over "
        "a mesh of slots; host only: cpu, numpy, native)",
    )
    p.add_argument("--batch", type=int, default=None, help="device batch override")
    p.add_argument(
        "--device",
        default="cuda",
        choices=device_choices,
        help="where the backend runs: cuda (default; fails without a card) "
        "or cpu (the plain PyTorch version)",
    )


def _add_retarget(p: argparse.ArgumentParser) -> None:
    """Chain-identity flags for opt-in difficulty retargeting: the rule is
    committed into genesis, so they select the chain."""
    p.add_argument(
        "--retarget-window",
        type=int,
        default=0,
        help="adjust difficulty every N blocks (0 = fixed difficulty; "
        "the rule is part of the chain's genesis identity)",
    )
    p.add_argument(
        "--target-spacing",
        type=int,
        default=0,
        help="target seconds per block for retargeting (set together "
        "with --retarget-window)",
    )


def _add_sig_device(p: argparse.ArgumentParser) -> None:
    """Where an untrusted store load verifies its signature batches."""
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where signature batches are verified: cuda (default; the "
        "ed25519_msm kernel, fails without a card) or cpu (the plain "
        "PyTorch version)",
    )


def _pin_sig_device(args) -> None:
    """The ``device`` signature rung, on the card or (``--device cpu``)
    on its plain version."""
    from p1_tpu_torch.core import keys

    keys.set_sig_backend("device", device=args.device)


def _fee_arg(value: str):
    """--fee: an integer or the literal 'auto' — validated by argparse so
    a typo is a usage error, not a runtime failure after other work."""
    if value == "auto":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"fee must be an integer or 'auto', got {value!r}"
        )


def _retarget_rule(args):
    """The ``RetargetRule`` selected by the flags, or None (fixed)."""
    from p1_tpu_torch.core.retarget import RetargetRule

    try:
        return RetargetRule.from_params(args.retarget_window, args.target_spacing)
    except ValueError as e:
        raise SystemExit(str(e))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="p1_tpu_torch",
        description="proof-of-work blockchain on PyTorch and CUDA (port of p1_tpu)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mine", help="mine N blocks from genesis (configs 1/2/5)")
    _add_common(p)
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a torch.profiler trace of the mining loop (the card's "
        "kernels and the host) into DIR/mine_trace.json, after one warm-up "
        "block (open it in Perfetto or chrome://tracing)",
    )

    p = sub.add_parser(
        "sweep", help="difficulty sweep: time-to-block scaling (config 2)"
    )
    _add_common(p)
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument(
        "--difficulties",
        default="16:25",
        help="half-open range LO:HI (e.g. 16:25) or comma list (16,20,24)",
    )
    p.add_argument("--blocks", type=int, default=5, help="blocks per difficulty")

    p = sub.add_parser("replay", help="generate+verify a header chain (config 3)")
    _add_common(p)
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument(
        "--method",
        choices=["host", "native", "device", "both", "all"],
        default="both",
        help="verification engine(s): host=hashlib oracle, native=C++ "
        "SHA-NI host engine, device=one kernel launch on --device; "
        "both=host+device, all=every engine (host+native on a retargeting "
        "chain)",
    )
    p.add_argument("--out", default=None, help="write generated headers here")
    p.add_argument("--verify", default=None, help="verify this header file instead")
    _add_retarget(p)

    p = sub.add_parser("node", help="run one p2p node")
    _add_common(p, device_choices=("cuda", "cpu"))
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument("--peers", nargs="*", default=[], help="host:port ...")
    p.add_argument("--no-mine", action="store_true")
    p.add_argument(
        "--miner-id",
        default=None,
        help="coinbase recipient id (default: random per process)",
    )
    p.add_argument("--store", default=None, help="chain persistence path")
    p.add_argument(
        "--revalidate-store",
        action="store_true",
        help="re-run full stateless validation (PoW, merkle, Ed25519) "
        "over the stored chain at boot instead of the trusted fast "
        "resume (the store is this node's own validated, flocked log)",
    )
    p.add_argument(
        "--verify-workers",
        type=int,
        default=0,
        help="verification worker count for batched Ed25519 verification "
        "on the untrusted validation paths (--revalidate-store, deep "
        "sync); 0 = unpinned (reported as 1).  The "
        "port's rungs run no pool (the device rung orders its launches "
        "on the card's stream): the count is reported in status; never "
        "changes validation outcomes",
    )
    p.add_argument(
        "--pipeline-workers",
        type=int,
        default=0,
        help="staged block pipeline: off-loop worker lanes for the "
        "validate and store stages (node/pipeline.py).  0 = inline "
        "historical node (every stage on the event loop); N >= 1 moves "
        "batched signature pre-verification and the whole fsync chain "
        "onto worker threads and, when --verify-workers is 0, sets "
        "the verify worker count to N.  Never changes validation outcomes or "
        "wire behavior, only where the CPU/IO cost is paid",
    )
    p.add_argument(
        "--sig-backend",
        default="auto",
        choices=["auto", "cryptography", "native", "fallback", "device"],
        help="Ed25519 verification backend: auto and device route "
        "batches to the device rung (the ed25519_msm kernel on the card, "
        "or its plain version under --device cpu) and serial verifies to "
        "the native C++ engine (pure Python without a toolchain); native "
        "runs batches on that engine too (a warning, then auto, where it "
        "does not build); cryptography names a rung the port does not "
        "have (a warning, then auto); fallback forces pure Python.  Never "
        "changes validation outcomes, only the cost model",
    )
    p.add_argument(
        "--store-degraded-exit",
        action="store_true",
        help="exit (code 4) on the first store write failure instead of "
        "the default degraded serve-only mode (which keeps answering "
        "headers/blocks/proof queries while retrying the disk with "
        "backoff) — for operators who prefer a supervisor restart",
    )
    p.add_argument("--duration", type=float, default=None, help="exit after N s")
    p.add_argument(
        "--deadline",
        default=None,
        help="unix time to stop mining at (overrides --duration; lets a "
        "multi-process net quiesce simultaneously), or 'stdin' to print a "
        "ready line and read the deadline from stdin once the parent has "
        "seen every node come up (interpreter startup on a loaded host "
        "can cost many seconds, so parent-computed wall times are unsafe)",
    )
    p.add_argument("--status-interval", type=float, default=10.0)
    p.add_argument(
        "--no-compact-gossip",
        action="store_true",
        help="push full BLOCK frames instead of compact blocks (local "
        "preference; compact and full nodes interoperate)",
    )
    p.add_argument(
        "--mempool-ttl",
        type=float,
        default=3600.0,
        help="drop pool transactions older than this many seconds "
        "(hygiene for unmineable spends; 0 = never)",
    )
    p.add_argument(
        "--target-peers",
        type=int,
        default=0,
        help="peer-discovery out-degree: dial addresses learned via "
        "GETADDR/ADDR gossip until this many connections hold (0 = only "
        "the configured --peers; one seed peer bootstraps the rest)",
    )
    p.add_argument(
        "--handshake-timeout",
        type=float,
        default=10.0,
        help="seconds a new connection gets to complete HELLO before "
        "being reaped (liveness layer)",
    )
    p.add_argument(
        "--ping-interval",
        type=float,
        default=60.0,
        help="probe a peer with PING after this many seconds of silence; "
        "any received frame counts as liveness",
    )
    p.add_argument(
        "--pong-timeout",
        type=float,
        default=20.0,
        help="seconds of continued silence after a PING probe before the "
        "peer is evicted and its slot reused",
    )
    p.add_argument(
        "--sync-stall-timeout",
        type=float,
        default=10.0,
        help="progress deadline on an in-flight chain/mempool sync: a "
        "peer that advances nothing (blocks accepted, pages consumed — "
        "not mere liveness) within this window is demoted and the "
        "request re-issued to another peer (0 disables supervision)",
    )
    p.add_argument(
        "--sync-attempts",
        type=int,
        default=8,
        help="failover budget per catch-up episode: consecutive "
        "no-progress re-issues before the node stops chasing and waits "
        "for a fresh sync trigger (progress resets the budget)",
    )
    p.add_argument(
        "--mem-watermark-mb",
        type=float,
        default=0.0,
        help="overload high watermark in MB on the node's accounted "
        "memory gauge (resident chain bodies + pending pool + peer "
        "write buffers): above it the node SHEDs low-priority gossip "
        "and mempool pages and pauses mining while consensus-critical "
        "headers/blocks/proof service keeps running; back to NORMAL "
        "below 80%% of the mark (0 = no shedding)",
    )
    p.add_argument(
        "--body-cache",
        type=int,
        default=0,
        help="memory-bounded operation: keep only the last N main-chain "
        "block BODIES resident (headers/metadata always stay), evicting "
        "older bodies once durably in the store and refetching on "
        "demand — bounds RSS at O(N) instead of O(chain); 0 = fully "
        "resident (requires --store)",
    )
    p.add_argument(
        "--store-segment-mb",
        type=float,
        default=0.0,
        help="segmented store layout (chain/segstore.py): shard the "
        "append-only log into bounded segment files of this many MB "
        "(per-segment fsck/compaction/pruning; a single-file store "
        "upgrades losslessly on the first writer acquire); 0 keeps the "
        "store's existing layout",
    )
    p.add_argument(
        "--prune",
        type=int,
        default=0,
        metavar="KEEP_BLOCKS",
        help="pruned mode: discard block-body segments below the latest "
        "snapshot checkpoint, keeping at least KEEP_BLOCKS recent "
        "bodies — headers/filters/snapshots keep serving, block-sync "
        "requests into the pruned range are refused without "
        "disconnecting (0 = archive node; implies a segmented store)",
    )
    p.add_argument(
        "--snapshot-interval",
        type=int,
        default=0,
        metavar="BLOCKS",
        help="state checkpoint / served-snapshot cadence in blocks — "
        "also the granularity of `p1 maintain rebase` targets (must "
        "agree across nodes for served snapshot heights to line up; "
        "0 = the chain default)",
    )
    p.add_argument(
        "--no-admission-control",
        action="store_true",
        help="disable the per-peer blocks/txs/queries admission budgets "
        "(on by default; the budgets sit far above honest rates and "
        "only clip protocol-valid floods)",
    )
    p.add_argument(
        "--no-telemetry",
        action="store_true",
        help="disable the telemetry plane's latency recording "
        "(node/telemetry.py stage spans + histograms; counters and "
        "`p1 status` stay live — recording is observer-only, so this "
        "is an overhead knob, never a behavior change)",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "status",
        help="query a running node's status JSON (height, peers, sync/"
        "storage/overload state) over the wire",
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--watch",
        type=float,
        default=None,
        metavar="N",
        help="re-poll every N seconds until Ctrl-C (clean exit 0) — a "
        "live operator view without shell loops",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "metrics",
        help="query a running node's (or replica's) telemetry registry "
        "over the wire (node/telemetry.py): per-stage block-pipeline "
        "latency histograms, query latency, counters",
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    fmt = p.add_mutually_exclusive_group()
    fmt.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="raw registry snapshot JSON instead of the human table",
    )
    fmt.add_argument(
        "--prom",
        action="store_true",
        help="Prometheus text exposition (scrape-ready)",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "maintain",
        help="drive a running node's zero-downtime maintenance plane "
        "(v13): live re-base, online prune/compact, or the maintenance/"
        "version-bits status report — all without restarting the node",
    )
    p.add_argument(
        "op",
        choices=("status", "rebase", "prune", "compact"),
        help="status = report the maintenance plane (counters + "
        "version-bits deployments); rebase = advance the in-RAM base "
        "to a checkpoint, spilling history to the sidecar planes; "
        "prune = discard body segments below the floor; compact = "
        "rewrite dirty segments without dead side-branch records",
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--keep",
        type=int,
        default=None,
        metavar="N",
        help="blocks to keep behind the tip (rebase/prune; default: "
        "the node's checkpoint interval)",
    )
    _add_retarget(p)

    p = sub.add_parser("tx", help="submit a signed transaction to a running node")
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--key",
        required=True,
        help="sender key file from `p1 keygen` (the sender id is the "
        "key's account fingerprint — spends are signed, not asserted)",
    )
    p.add_argument("--recipient", required=True)
    p.add_argument("--amount", type=int, required=True)
    p.add_argument(
        "--fee",
        type=_fee_arg,
        default=1,
        help="fee units, or 'auto' to price at the node's recent "
        "confirmed-fee median (floor 1)",
    )
    p.add_argument(
        "--max-fee",
        type=int,
        default=100,
        help="refuse an --fee auto quote above this many units — the "
        "quote is peer-supplied, and a hostile or broken node must not "
        "be able to price a wallet's spend unbounded (explicit --fee N "
        "is never capped: the user stated the number)",
    )
    p.add_argument(
        "--seq",
        type=int,
        default=None,
        help="account nonce to spend (consensus requires the sender's "
        "exact next nonce; default: query the node via GETACCOUNT and "
        "use its next usable seq)",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "account",
        help="query an account's balance/nonce from a running node",
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--account", default=None, help="account id (or use --key)"
    )
    p.add_argument(
        "--key", default=None, help="key file; queries its fingerprint account"
    )
    _add_retarget(p)

    p = sub.add_parser(
        "fees", help="query confirmed-fee percentiles from a running node"
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--window", type=int, default=0, help="blocks to sample (0 = node default)"
    )
    _add_retarget(p)

    p = sub.add_parser(
        "proof",
        help="fetch + SPV-verify a transaction inclusion proof from a node",
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--txid", required=True, help="hex txid (printed by `p1 tx`)"
    )
    p.add_argument(
        "--headers",
        default=None,
        metavar="FILE",
        help="anchor the proof against a locally verified header chain "
        "(from `p1 headers --out FILE`) instead of trusting the peer's "
        "tip claim — full light-client confirmation",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "headers",
        help="light client: fetch + locally verify a node's header chain",
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--out", default=None, help="write the verified headers here "
        "(80 bytes each; feeds `p1 replay --verify` and `p1 proof --headers`)"
    )
    p.add_argument(
        "--stall-timeout",
        type=float,
        default=15.0,
        help="per-round progress deadline: a GETHEADERS round that grows "
        "nothing within this window abandons the session and retries "
        "(against --fallback peers, round-robin, when given)",
    )
    p.add_argument(
        "--fallback",
        nargs="*",
        default=[],
        help="host:port alternates to fail over to when the primary "
        "stalls mid-sync (accumulated headers are kept)",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "watch",
        help="live wallet push plane (v14): subscribe for block events, "
        "verify each against the filter-header commitment chain, and "
        "print one JSON line per verified event; a peer caught lying is "
        "demoted and the watch fails over to --fallback replicas at the "
        "verified cursor; exit 4 when every peer is proven dishonest",
    )
    p.add_argument("account", help="account id to watch (utf-8 watch item)")
    p.add_argument(
        "--item",
        action="append",
        default=[],
        help="extra watch item: another account id, or a txid as 64 hex "
        "chars (repeatable)",
    )
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9444)
    p.add_argument(
        "--fallback",
        action="append",
        nargs="*",
        default=[],
        metavar="HOST:PORT",
        help="replica to fail over to when the active target dies or is "
        "caught lying (also a cross-check source); repeatable, and each "
        "use also accepts a space-separated list",
    )
    p.add_argument(
        "--fallback-file",
        default=None,
        metavar="PATH",
        help="file of host:port replicas, one per line (# comments and "
        "blank lines ignored) — the fleet roster an orchestrator "
        "rewrites as replicas join and leave",
    )
    p.add_argument(
        "--deadline",
        type=float,
        default=None,
        help="exit 0 after this many seconds (tests/harnesses); "
        "default: watch until interrupted",
    )
    p.add_argument(
        "--max-events",
        type=int,
        default=0,
        help="exit 0 after this many verified events (0 = no cap)",
    )
    p.add_argument(
        "--cross-check-every",
        type=int,
        default=32,
        help="verify the committed tip against a fallback replica every "
        "N events (0 = self-consistency checks only)",
    )
    p.add_argument(
        "--max-session-failures",
        type=int,
        default=None,
        help="give up (exit 1) after N consecutive dead sessions "
        "(default: retry forever)",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "pod",
        help="multi-process pod miner: N processes, one miner on the network",
    )
    # Not _add_common: the pod always runs the sharded mesh backend, so a
    # --backend flag would be a silent no-op.  chunk/batch MUST match
    # across processes (PodMiner validates at startup).
    p.add_argument("--difficulty", type=int, default=16)
    p.add_argument("--batch", type=int, default=None, help="per-slot batch")
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument("--coordinator", required=True, help="host:port of process 0")
    p.add_argument("--num-hosts", type=int, required=True)
    p.add_argument("--host-id", type=int, required=True)
    p.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where this process's slots run: cuda (default; the search "
        "kernel, fails without a card) or cpu (the plain PyTorch version); "
        "the pod's collectives ride gloo either way",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="leader's p2p port")
    p.add_argument("--peers", nargs="*", default=[], help="host:port ...")
    p.add_argument("--miner-id", default=None)
    p.add_argument("--store", default=None)
    p.add_argument(
        "--duration",
        type=float,
        default=None,
        help="leader: stop mining after N s; both roles also arm a "
        "peer-loss watchdog (force-exit after P1_POD_GRACE_S, default "
        "600 s, with no lockstep progress — the grace covers the first "
        "search's kernel build)",
    )
    p.set_defaults(no_mine=False, deadline=None, status_interval=10.0, backend="sharded")

    p = sub.add_parser("net", help="N-node localhost net (config 4)")
    _add_common(p, device_choices=("cuda", "cpu"))
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--base-port", type=int, default=19444)
    p.add_argument(
        "--byzantine",
        type=int,
        default=0,
        help="run this many actively malicious participants alongside "
        "the honest mesh (invalid signatures, overdraws, replays, "
        "forged compact blocks, ADDR spam, oversized frames — each "
        "from its own loopback alias so bans land on the attacker); "
        "the summary asserts the honest net converged, conserved, "
        "banned them, and stayed within memory bounds",
    )
    p.add_argument(
        "--tx-rate",
        type=float,
        default=0.0,
        help="inject ~R signed transfers/sec between the miners' accounts "
        "during the run (each node mines to a keyed account); the summary "
        "then audits ledger conservation (sum == reward x height) on "
        "every node",
    )
    p.add_argument(
        "--no-compact-gossip",
        action="store_true",
        help="children push full BLOCK frames instead of compact blocks",
    )
    p.add_argument(
        "--discover",
        action="store_true",
        help="bootstrap the topology via peer discovery: every node dials "
        "ONLY node 0 and must find the rest through GETADDR/ADDR (vs the "
        "default statically configured full mesh)",
    )
    _add_retarget(p)

    p = sub.add_parser(
        "keygen", help="create an Ed25519 spending key (account = fingerprint)"
    )
    p.add_argument("--out", required=True, help="key file to write (0600)")
    p.add_argument(
        "--seed-text",
        default=None,
        help="derive deterministically from this label (TESTS ONLY: the "
        "seed is sha256(label), so the account is publicly spendable)",
    )
    p.add_argument(
        "--force",
        action="store_true",
        help="overwrite an existing key file (DESTROYS the old seed — "
        "coins held by its account become unspendable)",
    )

    p = sub.add_parser(
        "balances", help="account balances from a persisted chain"
    )
    p.add_argument(
        "--difficulty",
        type=int,
        default=None,
        help="chain selector (default: inferred from the store's records)",
    )
    p.add_argument("--store", required=True, help="chain persistence path")
    p.add_argument(
        "--account", default=None, help="print one account instead of all"
    )
    _add_retarget(p)
    _add_sig_device(p)

    p = sub.add_parser(
        "compact", help="rewrite a chain store to just its main branch"
    )
    p.add_argument("--store", required=True, help="chain persistence path")
    p.add_argument(
        "--out",
        default=None,
        help="write here instead of replacing the store in place",
    )
    _add_retarget(p)
    _add_sig_device(p)

    p = sub.add_parser(
        "fsck",
        help="scan a chain store offline: report per-record integrity and "
        "salvage every checksum-valid record into a fresh verified store "
        "(also upgrades v2 stores to the checksummed v3 framing); exit 0 "
        "= clean, 1 = salvaged with losses, 2 = unrecoverable",
    )
    p.add_argument("--store", required=True, help="chain persistence path")
    p.add_argument(
        "--out",
        default=None,
        help="write the salvaged store here instead of replacing in place",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable per-segment report (one row per segment "
        "with its own verdict/spans/salvage counts; single-file stores "
        "report as one segment)",
    )
    _add_sig_device(p)

    p = sub.add_parser(
        "snapshot",
        help="ledger-state snapshots (chain/snapshot.py): create one "
        "from a chain store's latest checkpoint, verify a snapshot "
        "file's integrity (manifest, chunk digests, state root), or "
        "print its manifest; exit 0 clean / 1 salvageable issue / 2 "
        "unrecoverable",
    )
    p.add_argument(
        "action",
        choices=["create", "verify", "info"],
        help="create: --store -> --file; verify/info: --file",
    )
    p.add_argument("--store", default=None, help="chain store (create)")
    p.add_argument(
        "--file", default=None, help="snapshot file path (all actions)"
    )
    p.add_argument(
        "--interval",
        type=int,
        default=0,
        help="checkpoint interval override for create (0 = the chain "
        "default: the retarget window, else 64); the snapshot lands on "
        "the latest multiple at or below the store's tip",
    )
    _add_retarget(p)
    _add_sig_device(p)

    p = sub.add_parser(
        "serve",
        help="read-only replica worker(s): serve headers/filters/proof "
        "queries from a chain store over mmap, WITHOUT the writer lock "
        "— attach any number to a live node's store and scale query "
        "QPS with cores while the node only mines and validates",
    )
    p.add_argument("--store", required=True, help="chain persistence path")
    p.add_argument("--difficulty", type=int, default=16, help="chain selector")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--port",
        type=int,
        default=9555,
        help="listen port (0 = ephemeral; --workers > 1 needs a real "
        "port, shared via SO_REUSEPORT)",
    )
    p.add_argument(
        "--workers",
        type=int,
        default=1,
        help="replica processes to run against this store on this port "
        "(SO_REUSEPORT fan-out; each worker holds its own mmap and "
        "caches)",
    )
    p.add_argument(
        "--refresh-interval",
        type=float,
        default=0.25,
        help="seconds between tail rescans for blocks the node appended",
    )
    p.add_argument(
        "--bootstrap",
        action="append",
        default=[],
        metavar="HOST:PORT",
        help="cold-start the store from this full node before serving: "
        "PoW-verified header skeleton, chunk-verified snapshot, adopted "
        "filter headers, then bodies above the base — seconds, not an "
        "IBD; repeatable (extra peers are failovers and the cross-check "
        "source); the worker then keeps pulling new blocks from the "
        "bootstrap peers while it serves",
    )
    p.add_argument(
        "--deadline",
        type=float,
        default=None,
        help="exit after this many seconds (tests/harnesses); default: "
        "serve until interrupted",
    )
    _add_retarget(p)


    p = sub.add_parser(
        "sim",
        help="deterministic network-simulator scenarios (1000-node "
        "meshes in virtual time, one JSON report line)",
    )
    p.add_argument(
        "scenario",
        nargs="?",
        default="partition-heal",
        help="scenario name (see --list); default partition-heal",
    )
    p.add_argument(
        "--list", action="store_true", help="list scenarios and exit"
    )
    p.add_argument(
        "--seed",
        type=int,
        default=0,
        help="determinism seed: same seed => byte-identical event trace "
        "(the report's trace_digest)",
    )
    p.add_argument(
        "--nodes",
        type=int,
        default=None,
        help="mesh size (scenarios with a fixed shape ignore it)",
    )
    p.add_argument("--difficulty", type=int, default=8)
    p.add_argument(
        "--joiners", type=int, default=None, help="flash-crowd joiner count"
    )
    p.add_argument(
        "--cycles", type=int, default=None, help="churn stop/restart waves"
    )
    p.add_argument(
        "--attackers", type=int, default=None, help="eclipse attacker hosts"
    )
    p.add_argument(
        "--region-nodes", type=int, default=None, help="wan nodes per region"
    )
    p.add_argument(
        "--shards",
        type=int,
        default=None,
        help="far-field shard count (>1 = one OS process per shard over "
        "the pipe seam; the merged trace digest must not move with it)",
    )
    p.add_argument(
        "--days",
        type=float,
        default=None,
        help="soak scenario: virtual days to run (default 7)",
    )
    p.add_argument(
        "--no-telemetry",
        action="store_true",
        help="run the scenario's nodes with telemetry recording off — "
        "the trace digest must match the telemetry-on run (the "
        "observer contract; tests compare exactly this)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the mesh's device work runs: cuda (default; every "
        "block sealed by the sha256d_search kernel, signature batches on "
        "the card; fails without a card) or cpu (hashlib sealing, the "
        "plain PyTorch signature rung); the trace digest is the same",
    )

    p = sub.add_parser(
        "chaos",
        help="combined-fault search over the simulated mesh: seeded "
        "crash/disk/partition/adversary schedules, invariant checks, "
        "self-shrinking repros",
    )
    p.add_argument(
        "--seed",
        type=int,
        default=0,
        help="first schedule seed (determinism: same seed => "
        "byte-identical event trace)",
    )
    p.add_argument(
        "--schedules",
        type=int,
        default=1,
        help="how many consecutive seeds to sweep (default 1)",
    )
    p.add_argument("--nodes", type=int, default=6, help="mesh size per run")
    p.add_argument(
        "--events", type=int, default=12, help="fault events per schedule"
    )
    p.add_argument("--difficulty", type=int, default=8)
    p.add_argument(
        "--repro",
        metavar="FILE",
        help="replay a repro artifact instead of sweeping (exit 1 iff "
        "the recorded violation reproduces)",
    )
    p.add_argument(
        "--out",
        metavar="FILE",
        default="chaos_repro.json",
        help="where a violation's shrunk repro artifact is written "
        "(default chaos_repro.json)",
    )
    p.add_argument(
        "--no-shrink",
        action="store_true",
        help="on violation, write the full schedule without minimizing",
    )
    p.add_argument(
        "--inject-bug",
        choices=["relapse-disk", "deaf-recover"],
        help="TEST ONLY: seed a known recovery bug so the shrink/repro "
        "pipeline can be exercised against a guaranteed violation",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the mesh's device work runs: cuda (default; every "
        "block sealed by the sha256d_search kernel, signature batches on "
        "the card; fails without a card) or cpu (hashlib sealing, the "
        "plain PyTorch signature rung); the trace digest is the same",
    )

    p = sub.add_parser("bench", help="headline benchmark (one JSON line)")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default): the kernels on the card; cpu: their plain PyTorch versions",
    )

    p = sub.add_parser(
        "lint",
        help="determinism/async-safety static analysis over p1_tpu_torch "
        "(exit 0 clean, 1 findings or stale grants, 2 usage)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="full machine-readable report on stdout",
    )
    p.add_argument(
        "--rule",
        action="append",
        default=None,
        metavar="NAME",
        help="run only this rule (repeatable; default: all registered "
        "rules — see docs/LINT.md for the catalog)",
    )
    p.add_argument(
        "--granted",
        action="store_true",
        help="also list allowlisted findings with their grant reasons",
    )
    p.add_argument(
        "--path",
        action="append",
        default=None,
        metavar="FILE_OR_DIR",
        help="report only findings under this file/directory (repeatable; "
        "package-relative like node/node.py, or a real path).  The "
        "analysis still runs whole-package and settlement stays global, "
        "so a scoped run can't hide a stale grant — this narrows what "
        "you LOOK at for fast pre-commit loops",
    )
    return parser


# -- mine ----------------------------------------------------------------


def mine_chain(miner, difficulty: int, blocks: int):
    """Mine ``blocks`` headers from genesis; return (headers, times, hashes)."""
    from p1_tpu_torch.core.genesis import genesis_header
    from p1_tpu_torch.core.header import BlockHeader

    if blocks < 1:
        raise SystemExit("--blocks must be >= 1")

    tip = genesis_header(difficulty)
    headers, times, hashes = [], [], 0
    for height in range(1, blocks + 1):
        draft = BlockHeader(1, tip.block_hash(), bytes(32), tip.timestamp + 1, difficulty, 0)
        t0 = time.perf_counter()
        sealed = miner.search_nonce(draft)
        dt = time.perf_counter() - t0
        if sealed is None:
            raise RuntimeError(f"no seal found for height {height}")
        times.append(dt)
        hashes += miner.last_stats.hashes_done
        logging.info(
            "block d=%d height=%d nonce=%d t=%.3fs hps=%.0f",
            difficulty,
            height,
            sealed.nonce,
            dt,
            miner.last_stats.hashes_per_sec,
        )
        headers.append(sealed)
        tip = sealed
    return headers, times, hashes


def mine_report(
    backend: str, difficulty: int, times: list[float], hashes: int, profile_dir: str | None = None
) -> dict:
    """The ``cmd_mine`` JSON object of ``p1_tpu``, key for key."""
    total = sum(times)
    return {
        "config": "mine",
        "backend": backend,
        "difficulty": difficulty,
        "blocks": len(times),
        "hashes_per_sec": round(hashes / total) if total else 0,
        "time_to_block_s": round(statistics.median(times), 4),
        "total_s": round(total, 3),
        **({"profile_dir": profile_dir} if profile_dir else {}),
    }


#: The Chrome trace ``mine --profile DIR`` writes into DIR.
PROFILE_TRACE = "mine_trace.json"


def profile_mining(miner, difficulty: int, blocks: int, out_dir: str, device: str):
    """``mine_chain`` under ``torch.profiler`` (the card's kernels and the
    host, or the host alone for ``device="cpu"``), after one warm-up block
    so the trace shows steady-state steps, not the kernel's first build
    and load; the Chrome trace goes to ``out_dir/PROFILE_TRACE``.  Returns
    ``mine_chain``'s result and each kernel wrapper's launches inside the
    traced window."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    from p1_tpu_torch.node.runner import kernel_launches

    mine_chain(miner, difficulty, 1)
    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    before = kernel_launches()
    logging.info("profiling mining loop into %s", out_dir)
    with profile(activities=activities) as prof:
        result = mine_chain(miner, difficulty, blocks)
    launches = {k: n - before.get(k, 0) for k, n in kernel_launches().items()}
    path = pathlib.Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / PROFILE_TRACE))
    return result, launches


def cmd_mine(args) -> int:
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    kwargs = {"batch": args.batch} if args.batch else {}
    backend = get_backend(args.backend, device=args.device, **kwargs)
    miner = Miner(backend=backend, chunk=args.chunk)
    if args.profile:
        (_, times, hashes), launches = profile_mining(
            miner, args.difficulty, args.blocks, args.profile, args.device
        )
        logging.info("profiled kernel launches: %s", json.dumps(launches))
    else:
        _, times, hashes = mine_chain(miner, args.difficulty, args.blocks)
    print(json.dumps(mine_report(args.backend, args.difficulty, times, hashes, args.profile)))
    return 0


def _parse_difficulties(spec: str) -> list[int]:
    try:
        if ":" in spec:
            lo, _, hi = spec.partition(":")
            out = list(range(int(lo), int(hi)))
        else:
            out = [int(d) for d in spec.split(",") if d]
    except ValueError:
        out = []
    if not out or not all(0 <= d <= 255 for d in out):
        raise SystemExit(
            f"bad difficulty spec {spec!r} (want LO:HI or a comma list)"
        )
    return out


def cmd_sweep(args) -> int:
    """Benchmark config 2: nonce-space scaling across difficulties.

    One JSON line per difficulty with median time-to-block and the
    aggregate hash rate, so the scaling curve (time ~ 2^d / rate, floored
    by launch latency) is reproducible from a single command.
    """
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    kwargs = {"batch": args.batch} if args.batch else {}
    backend = get_backend(args.backend, device=args.device, **kwargs)
    miner = Miner(backend=backend, chunk=args.chunk)
    for difficulty in _parse_difficulties(args.difficulties):
        _, times, hashes = mine_chain(miner, difficulty, args.blocks)
        total = sum(times)
        print(
            json.dumps(
                {
                    "config": "sweep",
                    "backend": args.backend,
                    "difficulty": difficulty,
                    "blocks": args.blocks,
                    "time_to_block_s": round(statistics.median(times), 4),
                    "hashes_per_sec": round(hashes / total) if total else 0,
                    "total_s": round(total, 3),
                }
            ),
            flush=True,
        )
    return 0


# -- replay --------------------------------------------------------------


def cmd_replay(args) -> int:
    from p1_tpu_torch.chain import (
        generate_headers,
        parse_headers,
        replay_device,
        replay_host,
        replay_native,
    )
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.header import HEADER_SIZE
    from p1_tpu_torch.hashx import get_backend

    rule = _retarget_rule(args)
    if rule is not None and args.method in ("device", "both"):
        # The host oracle and the C++ engine are retarget-aware; the device
        # kernel implements the benchmark-config form (one target for the
        # whole chain) and would mis-report an honest retargeting chain as
        # invalid at the first adjustment.
        print(
            "retargeting chains verify with --method host/native/all "
            "(the device engine is fixed-difficulty)",
            file=sys.stderr,
        )
        return 2
    if args.verify:
        with open(args.verify, "rb") as fh:
            raw = fh.read()
        if len(raw) % HEADER_SIZE:
            print(f"{args.verify}: not a multiple of {HEADER_SIZE} bytes", file=sys.stderr)
            return 2
        headers = parse_headers(raw)
        # Pin the file to the chain the operator selected: header[0] is
        # otherwise SELF-attested, and a forged file whose genesis claims
        # difficulty 1 would "verify" with no meaningful work behind it.
        if not headers or headers[0].block_hash() != genesis_hash(args.difficulty, rule):
            print(
                f"{args.verify}: does not start at this chain's genesis "
                "(check --difficulty / retarget flags)",
                file=sys.stderr,
            )
            return 2
    else:
        kwargs = {"batch": args.batch} if args.batch else {}
        backend = get_backend(args.backend, device=args.device, **kwargs)
        t0 = time.perf_counter()
        headers = generate_headers(args.n, args.difficulty, backend=backend, retarget=rule)
        logging.info("generated %d headers in %.1fs", args.n, time.perf_counter() - t0)
        if args.out:
            with open(args.out, "wb") as fh:
                for h in headers:
                    fh.write(h.serialize())

    reports = []
    if args.method in ("host", "both", "all"):
        reports.append(replay_host(headers, retarget=rule))
    if args.method in ("native", "all"):
        reports.append(replay_native(headers, retarget=rule))
    if args.method in ("device", "both", "all") and rule is None:
        # Fixed-difficulty only (the guard above refuses explicit device
        # requests on retargeting chains; `all` covers what can run there:
        # host + native).
        reports.append(replay_device(headers, device=args.device))
        reports.append(replay_device(headers, device=args.device))  # warm (build amortized)
    ok = all(r.valid for r in reports)
    print(
        json.dumps(
            {
                "config": "replay",
                "n_headers": len(headers),
                "valid": ok,
                "first_invalid": next((r.first_invalid for r in reports if not r.valid), None),
                "results": [
                    {
                        "method": r.method,
                        "headers_per_sec": round(r.headers_per_sec),
                        "elapsed_s": round(r.elapsed_s, 4),
                    }
                    for r in reports
                ],
            }
        )
    )
    return 0 if ok else 1


# -- node, net and the wallet/operator clients ----------------------------


def cmd_node(args) -> int:
    _retarget_rule(args)  # flag-pair validation: clean error, no traceback
    # The CPU miner thread is GIL-bound (hashlib holds the GIL for
    # 80-byte messages) and the default 5 ms switch interval lets it
    # convoy the event loop hard enough that a wallet's HELLO can starve
    # past its 10 s timeout on 1-vCPU hosts (observed live).  A 0.5 ms
    # interval hands the loop the GIL ~10x more often for a few percent
    # of hash throughput — only worth paying in the node process, where
    # p2p responsiveness under mining load is the product.
    sys.setswitchinterval(0.0005)
    from p1_tpu_torch.node.runner import run_node

    try:
        return asyncio.run(run_node(args))
    except KeyboardInterrupt:
        return 0


def cmd_status(args) -> int:
    """Query a running node's full status JSON (`p1 status`) — the same
    object the node logs, served over the wire (GETSTATUS/STATUS, v9),
    overload block included.  Works even while the node sheds load.

    ``--watch N`` re-polls every N seconds until Ctrl-C (clean exit 0)
    — the live operator view that used to need a shell loop.  One poll
    failing mid-watch prints the error and keeps watching (a node
    restarting must not kill the dashboard); without --watch a failure
    is exit 1 as before."""
    import time as _time

    from p1_tpu_torch.node.client import get_status

    watch = getattr(args, "watch", None)
    if watch is not None and watch <= 0:
        print("--watch needs a positive interval", file=sys.stderr)
        return 2
    try:
        while True:
            try:
                status = asyncio.run(
                    get_status(
                        args.host,
                        args.port,
                        args.difficulty,
                        retarget=_retarget_rule(args),
                    )
                )
                print(
                    json.dumps(status, indent=2, sort_keys=True), flush=True
                )
            except (
                ConnectionError,
                OSError,
                ValueError,
                asyncio.TimeoutError,
                asyncio.IncompleteReadError,
            ) as e:
                print(f"status query failed: {e}", file=sys.stderr)
                if watch is None:
                    return 1
            if watch is None:
                return 0
            _time.sleep(watch)
    except KeyboardInterrupt:
        # Ctrl-C is how a watch ENDS, not an error: exit clean wherever
        # in the poll/sleep cycle it lands.
        return 0


def cmd_maintain(args) -> int:
    """Drive a running node's maintenance plane (`p1 maintain`,
    GETMAINTAIN/MAINTAIN v13).  Exit-code contract, test-pinned: 0 when
    the node answered ``{"ok": true}``; 1 when it REFUSED (``{"ok":
    false}`` — busy, assumed chain, degraded store, nothing to do at
    this height) or the wire failed; 2 on usage errors caught locally.
    The refusal detail lands on stderr, the full reply JSON on stdout
    either way — scripts branch on the exit code, operators read the
    reply."""
    from p1_tpu_torch.node.client import maintain

    if args.keep is not None and args.keep < 0:
        print("--keep must be >= 0", file=sys.stderr)
        return 2
    if args.keep is not None and args.op in ("status", "compact"):
        print(f"--keep does not apply to {args.op!r}", file=sys.stderr)
        return 2
    command: dict = {"op": args.op}
    if args.keep is not None:
        command["keep"] = args.keep
    try:
        reply = asyncio.run(
            maintain(
                args.host,
                args.port,
                command,
                args.difficulty,
                retarget=_retarget_rule(args),
            )
        )
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.TimeoutError,
        asyncio.IncompleteReadError,
    ) as e:
        print(f"maintain command failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(reply, indent=2, sort_keys=True), flush=True)
    if not (isinstance(reply, dict) and reply.get("ok") is True):
        error = reply.get("error") if isinstance(reply, dict) else reply
        print(f"maintain refused: {error}", file=sys.stderr)
        return 1
    return 0


def cmd_metrics(args) -> int:
    """Query a node's (or `p1 serve` replica's) telemetry registry
    (`p1 metrics`, GETMETRICS/METRICS v12) and render it: human latency
    table by default, ``--json`` for the raw snapshot, ``--prom`` for
    Prometheus text exposition.  The render runs on the wire payload —
    the CLI holds no registry of its own, so what you see is exactly
    what the node exported."""
    from p1_tpu_torch.node.client import get_metrics
    from p1_tpu_torch.node.telemetry import format_prometheus, format_table

    try:
        snap = asyncio.run(
            get_metrics(
                args.host,
                args.port,
                args.difficulty,
                retarget=_retarget_rule(args),
            )
        )
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.TimeoutError,
        asyncio.IncompleteReadError,
    ) as e:
        print(f"metrics query failed: {e}", file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(snap, indent=2, sort_keys=True))
    elif args.prom:
        sys.stdout.write(format_prometheus(snap))
    else:
        for key in ("role", "miner_id", "height"):
            if key in snap:
                print(f"{key}: {snap[key]}")
        print(format_table(snap))
    return 0


# -- tx ------------------------------------------------------------------


def cmd_tx(args) -> int:
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.node.client import send_tx

    try:
        from p1_tpu_torch.core.genesis import genesis_hash
        from p1_tpu_torch.node.client import get_account

        key = Keypair.load(args.key)
        rule = _retarget_rule(args)
        if args.fee == "auto":
            from p1_tpu_torch.node.client import get_fees

            stats = asyncio.run(
                get_fees(args.host, args.port, args.difficulty, retarget=rule)
            )
            fee = max(1, stats.p50)
            if fee > args.max_fee:
                # The quote is the PEER's number; signing it unseen would
                # let one hostile node drain the account through fees.
                print(
                    f"refusing auto fee {fee} above --max-fee "
                    f"{args.max_fee} (node quote p50={stats.p50} over "
                    f"{stats.samples} samples); pass an explicit --fee "
                    f"or raise --max-fee to accept",
                    file=sys.stderr,
                )
                return 2
        else:
            fee = args.fee
        seq = args.seq
        if seq is None:
            # Wallet convenience: consensus wants the exact next nonce, so
            # ask the node (chain nonce advanced past its pending pool).
            state = asyncio.run(
                get_account(
                    args.host,
                    args.port,
                    key.account,
                    args.difficulty,
                    retarget=rule,
                )
            )
            seq = state.next_seq
        tx = Transaction.transfer(
            key,
            args.recipient,
            args.amount,
            fee,
            seq,
            chain=genesis_hash(args.difficulty, rule),
        )
        height = asyncio.run(
            send_tx(args.host, args.port, tx, args.difficulty, retarget=rule)
        )
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.TimeoutError,
        asyncio.IncompleteReadError,  # clean close mid-handshake (EOFError)
    ) as e:
        print(f"tx submission failed: {e}", file=sys.stderr)
        return 1
    print(
        json.dumps(
            {
                "config": "tx",
                "txid": tx.txid().hex(),
                "sender": tx.sender,
                "seq": seq,
                "fee": fee,
                "peer_height": height,
            }
        )
    )
    return 0


# -- account -------------------------------------------------------------


def cmd_account(args) -> int:
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.node.client import get_account

    if (args.account is None) == (args.key is None):
        print("pass exactly one of --account / --key", file=sys.stderr)
        return 2
    try:
        account = args.account or Keypair.load(args.key).account
        state = asyncio.run(
            get_account(
                args.host,
                args.port,
                account,
                args.difficulty,
                retarget=_retarget_rule(args),
            )
        )
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.TimeoutError,
        asyncio.IncompleteReadError,
    ) as e:
        print(f"account query failed: {e}", file=sys.stderr)
        return 1
    print(
        json.dumps(
            {
                "config": "account",
                "account": state.account,
                "balance": state.balance,
                "nonce": state.nonce,
                "next_seq": state.next_seq,
                "height": state.tip_height,
            }
        )
    )
    return 0


# -- fees ----------------------------------------------------------------


def cmd_fees(args) -> int:
    from p1_tpu_torch.node.client import get_fees

    try:
        stats = asyncio.run(
            get_fees(
                args.host,
                args.port,
                args.difficulty,
                window=args.window,
                retarget=_retarget_rule(args),
            )
        )
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.TimeoutError,
        asyncio.IncompleteReadError,
    ) as e:
        print(f"fee query failed: {e}", file=sys.stderr)
        return 1
    print(
        json.dumps(
            {
                "config": "fees",
                "window_blocks": stats.window_blocks,
                "samples": stats.samples,
                "p25": stats.p25,
                "p50": stats.p50,
                "p75": stats.p75,
                "suggested_fee": max(1, stats.p50),
                "height": stats.tip_height,
            }
        )
    )
    return 0


# -- proof ---------------------------------------------------------------


def cmd_proof(args) -> int:
    """Fetch an SPV inclusion proof and verify it CLIENT-SIDE.

    Exit codes: 0 = confirmed and proof verifies; 1 = query failed;
    3 = not confirmed on the peer's main chain; 4 = the peer served a
    proof that FAILS verification (a lying or broken peer — loud exit).
    """
    from p1_tpu_torch.chain.proof import SPVError, verify_tx_proof
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.node.client import get_proof

    try:
        rule = _retarget_rule(args)
        txid = bytes.fromhex(args.txid)
        if len(txid) != 32:
            raise ValueError("txid must be 32 hex-encoded bytes")
        proof = asyncio.run(
            get_proof(
                args.host, args.port, txid, args.difficulty, retarget=rule
            )
        )
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.TimeoutError,
        asyncio.IncompleteReadError,
    ) as e:
        print(f"proof query failed: {e}", file=sys.stderr)
        return 1
    if proof is None:
        print(json.dumps({"config": "proof", "confirmed": False}))
        return 3
    try:
        verify_tx_proof(
            proof,
            args.difficulty,
            genesis_hash(args.difficulty, rule),
            txid=txid,
            retarget=rule,
        )
    except SPVError as e:
        print(f"peer served an INVALID proof: {e}", file=sys.stderr)
        return 4
    confirmations = proof.confirmations  # the peer's claim...
    anchored = False
    if rule is not None and not args.headers:
        # Retargeting chains verify at the header's claimed difficulty
        # (schedule-floored — chain/proof.py), and height/tip/
        # confirmations are all the peer's claims; only --headers
        # anchoring pins them to a locally verified chain.  Say so
        # loudly rather than letting scripts equate the two modes.
        print(
            "warning: retargeting chain without --headers — proof "
            "verified at its claimed difficulty only, and the height/"
            "confirmation figures are the peer's unverified claims; "
            "anchor against `p1 headers` output for real light-client "
            "verification",
            file=sys.stderr,
        )
    if args.headers:
        # ...unless anchored: the proof's block must sit at its claimed
        # height on a LOCALLY verified header chain, and confirmations are
        # then computed from that chain — no peer claims left anywhere.
        headers = _load_header_file(args.headers, args.difficulty, rule)
        if (
            proof.height >= len(headers)
            or headers[proof.height].block_hash()
            != proof.header.block_hash()
        ):
            print(
                "proof's block is not on the locally verified header "
                "chain (stale, side-branch, or forged)",
                file=sys.stderr,
            )
            return 4
        confirmations = len(headers) - proof.height
        anchored = True
    print(
        json.dumps(
            {
                "config": "proof",
                "confirmed": True,
                "verified": True,
                "txid": args.txid,
                "height": proof.height,
                "confirmations": confirmations,
                "anchored": anchored,
                "block": proof.header.block_hash().hex(),
                # The work bar this evidence meets (== chain difficulty on
                # fixed chains; the header's claim on retargeting chains).
                "difficulty": proof.header.difficulty,
                "index": proof.index,
                "branch_len": len(proof.branch),
                "amount": proof.tx.amount,
                "recipient": proof.tx.recipient,
            }
        )
    )
    return 0


# -- headers -------------------------------------------------------------


def _load_header_file(path: str, difficulty: int, rule):
    """Read + fully verify a header file as this chain's header chain.
    Returns the genesis-first header list; raises SystemExit on any
    failure (wrong chain, bad PoW/linkage/schedule) — a light client must
    never proceed on unverified headers."""
    from p1_tpu_torch.chain import parse_headers, replay_packed
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.core.hashutil import sha256d
    from p1_tpu_torch.core.header import HEADER_SIZE

    raw = open(path, "rb").read()
    if not raw or len(raw) % HEADER_SIZE:
        print(f"{path}: not a header file", file=sys.stderr)
        raise SystemExit(2)
    # Packed-bytes plane end to end: genesis pinning hashes the first 80
    # bytes directly, verification hands the whole file to the host
    # engine in one call (replay_packed), and the object parse happens
    # once, after the chain has proven itself — seeding each header's
    # encoding cache with the file's exact bytes.
    if sha256d(raw[:HEADER_SIZE]) != make_genesis(difficulty, rule).block_hash():
        print(
            f"{path}: does not start at this chain's genesis "
            "(check --difficulty / retarget flags)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    report = replay_packed(raw, retarget=rule)
    if not report.valid:
        print(
            f"{path}: header chain INVALID at index {report.first_invalid}",
            file=sys.stderr,
        )
        raise SystemExit(4)
    return parse_headers(raw)


def cmd_headers(args) -> int:
    """Light-client sync: fetch the peer's header chain (~80 B/block) and
    verify it locally — PoW, linkage, and (with the retarget flags) the
    full contextual difficulty schedule.  Trusts nothing but work."""
    from p1_tpu_torch.chain import replay_fast
    from p1_tpu_torch.node.client import get_headers

    rule = _retarget_rule(args)

    def _addr(spec: str) -> tuple[str, int]:
        host, _, port = spec.rpartition(":")
        return (host or "127.0.0.1", int(port))

    try:
        headers = asyncio.run(
            get_headers(
                args.host,
                args.port,
                args.difficulty,
                retarget=rule,
                stall_timeout_s=args.stall_timeout,
                fallback_peers=[_addr(s) for s in args.fallback],
            )
        )
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.TimeoutError,
        asyncio.IncompleteReadError,
    ) as e:
        print(f"header sync failed: {e}", file=sys.stderr)
        return 1
    report = replay_fast(headers, retarget=rule)
    if report.valid and args.out:
        with open(args.out, "wb") as fh:
            for h in headers:
                fh.write(h.serialize())
    print(
        json.dumps(
            {
                "config": "headers",
                "height": len(headers) - 1,
                "tip": headers[-1].block_hash().hex(),
                "tip_difficulty": headers[-1].difficulty,
                "valid": report.valid,
                "first_invalid": report.first_invalid,
                "verify_headers_per_sec": round(report.headers_per_sec),
                "out": args.out if report.valid else None,
            }
        )
    )
    # A peer serving an invalid chain is loud (4), like a lying proof.
    return 0 if report.valid else 4


# -- watch ---------------------------------------------------------------


def cmd_watch(args) -> int:
    """Live wallet notifications: subscribe to a node or replica,
    verify every pushed event against the filter-header commitment
    chain (client.watch does the believing only after checking), and
    print one JSON line per verified block — matched ones carry the
    confirmed txids.  A peer caught lying is demoted and the watch
    fails over to --fallback replicas at the last verified cursor, so
    no confirmation is missed across the switch; when every peer is
    proven dishonest the exit is loud (4), like a lying proof."""
    from p1_tpu_torch.node.client import CommitmentViolation, watch

    rule = _retarget_rule(args)

    def _addr(spec: str) -> tuple[str, int]:
        host, _, port = spec.rpartition(":")
        return (host or "127.0.0.1", int(port))

    def _item(s: str):
        # 64 hex chars = a raw txid; anything else is an account id.
        if len(s) == 64:
            try:
                return bytes.fromhex(s)
            except ValueError:
                pass
        return s

    items = [args.account, *(_item(s) for s in args.item)]

    from pathlib import Path

    # --fallback is repeatable and each use takes a list; --fallback-file
    # adds a host:port-per-line roster.  Order is preserved (flag order,
    # then file order) and duplicates collapse — the ReplicaSet inside
    # client.watch treats the order as the tie-break preference.
    specs: list[str] = []
    for group in args.fallback:
        specs.extend(group if isinstance(group, list) else [group])
    if args.fallback_file is not None:
        try:
            for line in Path(args.fallback_file).read_text().splitlines():
                line = line.split("#", 1)[0].strip()
                if line:
                    specs.append(line)
        except OSError as e:
            print(f"watch failed: --fallback-file: {e}", file=sys.stderr)
            return 2
    fallbacks = list(dict.fromkeys(_addr(s) for s in specs))

    async def _run() -> int:
        gen = watch(
            args.host,
            args.port,
            items,
            args.difficulty,
            retarget=rule,
            fallback_peers=fallbacks,
            cross_check_every=args.cross_check_every,
            max_session_failures=args.max_session_failures,
        )
        n = 0
        try:
            async for ev in gen:
                print(
                    json.dumps(
                        {
                            "height": ev["height"],
                            "block": ev["block_hash"].hex(),
                            "filter_header": ev["filter_header"].hex(),
                            "matched": ev["matched"],
                            "txids": [t.hex() for t in ev["txids"]]
                            if ev["matched"]
                            else [],
                            "peer": f"{ev['peer'][0]}:{ev['peer'][1]}",
                            "target": f"{ev['peer'][0]}:{ev['peer'][1]}",
                            "failovers": ev["failovers"],
                        }
                    ),
                    flush=True,
                )
                n += 1
                if args.max_events and n >= args.max_events:
                    return 0
        finally:
            await gen.aclose()
        return 0

    try:
        if args.deadline is not None:
            try:
                return asyncio.run(asyncio.wait_for(_run(), args.deadline))
            except (asyncio.TimeoutError, TimeoutError):
                return 0  # the deadline is a clean exit, like `p1 serve`
        return asyncio.run(_run())
    except CommitmentViolation as e:
        print(f"watch failed: {e}", file=sys.stderr)
        return 4
    except (
        ConnectionError,
        OSError,
        ValueError,
        asyncio.IncompleteReadError,
    ) as e:
        print(f"watch failed: {e}", file=sys.stderr)
        return 1


def cmd_net(args) -> int:
    from p1_tpu_torch.node.netharness import run_net

    return run_net(args)


# -- pod -----------------------------------------------------------------


def cmd_pod(args) -> int:
    """Multi-process mining (BASELINE config 5, multi-process form): every
    process joins one gloo process group and mirrors the same sharded
    search in lockstep; process 0 additionally runs the p2p node, so the
    whole pod presents as a single miner on the gossip network.

    Failure handling: each role arms a no-progress watchdog (bounded runs
    only; ``parallel/watchdog.py``).  A follower that loses the pod exits
    3 (``POD_LOST_EXIT``) — restart it with the same ``--host-id`` under
    any supervisor once the pod coordinator is back.  The LEADER owns the
    chain store and the gossip identity, so it does NOT go dark: the
    watchdog re-execs it into single-process sharded mining against the
    same store/port/peers (``pod_leader_failover``) and the chain keeps
    growing while the pod is rebuilt.  Every death path leaves by
    ``os._exit``: a process blocked in a collective whose peer died may
    never return on its own."""
    import os

    import torch.distributed as dist

    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.node.runner import kernel_launches, run_node
    from p1_tpu_torch.parallel import PodMiner, init_distributed
    from p1_tpu_torch.parallel.watchdog import POD_LOST_EXIT, PodWatchdog, grace_s, pod_leader_failover

    is_leader = args.host_id == 0
    if is_leader:
        # The node's serial signature rung, loaded (on a host that has not
        # built it, compiled) before the pod forms: not in the gap before
        # the first lockstep point, which the followers time.
        from p1_tpu_torch.core import _ed25519_native

        _ed25519_native.load()
    init_distributed(args.coordinator, args.num_hosts, args.host_id, timeout_s=grace_s())
    # Arm the watchdog BEFORE any blocking collective (the construction
    # handshake included): a peer that dies during startup must not hang a
    # bounded run.  Long-running services (no --duration) supervise
    # externally.
    watchdog = None
    if args.duration is not None:
        deadline = time.time() + args.duration
        on_trip = (lambda: pod_leader_failover(args, deadline)) if is_leader else None
        watchdog = PodWatchdog(role="leader" if is_leader else "follower", on_trip=on_trip)
    try:
        kwargs = {"batch": args.batch} if args.batch else {}
        backend = get_backend("sharded", device=args.device, **kwargs)
        miner = PodMiner(is_leader=is_leader, backend=backend, chunk=args.chunk)
    except (ValueError, RuntimeError) as e:
        # The pod is already broken (a config mismatch, no card): the
        # peers are waiting in a collective this process will never join,
        # so leave at once and loudly.
        print(f"pod startup failed: {e}", file=sys.stderr, flush=True)
        os._exit(2)
    logging.info(
        "pod process %d/%d: %d global slots, %s",
        args.host_id,
        args.num_hosts,
        backend.n_devices,
        "leader" if is_leader else "follower",
    )
    if watchdog is not None:
        miner.heartbeat = watchdog.beat
    if not is_leader:
        try:
            mirrored = miner.follow()
        except Exception as e:
            # A lost peer makes gloo raise out of the collective (or
            # block, which the watchdog ends): same event, same exit code.
            print(f"pod follower lost the mesh: {e}", file=sys.stderr, flush=True)
            os._exit(POD_LOST_EXIT)
        if watchdog is not None:
            watchdog.cancel()
        logging.info("kernel launches: %s", json.dumps(kernel_launches()))
        print(json.dumps({"config": "pod", "role": "follower", "searches": mirrored}), flush=True)
        dist.destroy_process_group()
        return 0
    sys.setswitchinterval(0.0005)  # as cmd_node: the loop beside the miner thread
    try:
        return asyncio.run(run_node(args, miner=miner))
    finally:
        miner.shutdown()
        if watchdog is not None:
            watchdog.cancel()
        logging.info("pod searches: %d", miner.searches)
        dist.destroy_process_group()


# -- keygen and the store tools (engines in chain/tooling.py) --------------


def cmd_keygen(args) -> int:
    from p1_tpu_torch.core.keys import Keypair

    key = (
        Keypair.from_seed_text(args.seed_text)
        if args.seed_text is not None
        else Keypair.generate()
    )
    try:
        key.save(args.out, overwrite=args.force)
    except FileExistsError:
        print(
            f"{args.out} already exists; refusing to destroy its seed "
            "(use --force to overwrite)",
            file=sys.stderr,
        )
        return 2
    print(json.dumps({"config": "keygen", "account": key.account, "path": args.out}))
    return 0


def cmd_balances(args) -> int:
    from p1_tpu_torch.chain.tooling import run_balances

    _pin_sig_device(args)
    return run_balances(
        args.store,
        args.account,
        expected_difficulty=args.difficulty,
        retarget=_retarget_rule(args),
    )


def cmd_compact(args) -> int:
    from p1_tpu_torch.chain.tooling import run_compact

    _pin_sig_device(args)
    return run_compact(args.store, args.out, retarget=_retarget_rule(args))


def cmd_fsck(args) -> int:
    from p1_tpu_torch.chain.tooling import run_fsck

    _pin_sig_device(args)
    return run_fsck(args.store, args.out, json_out=args.json)


def cmd_snapshot(args) -> int:
    from p1_tpu_torch.chain.tooling import run_snapshot

    _pin_sig_device(args)
    return run_snapshot(
        args.action,
        args.store,
        args.file,
        interval=args.interval,
        retarget=_retarget_rule(args),
    )


# -- the simulation, serving and fault planes -------------------------


def _sim_device_ready(args) -> bool:
    """``sim`` / ``chaos`` on the card need one: without it they say so
    and exit non-zero instead of carrying on on the host."""
    if args.device != "cuda":
        return True
    import torch

    if torch.cuda.is_available():
        return True
    print(
        f"{args.cmd} runs on the card (--device cuda) and no CUDA device is "
        "available; pass --device cpu to seal with hashlib and run the "
        "plain signature rung",
        file=sys.stderr,
    )
    return False


def cmd_serve(args) -> int:
    """Read-only replica worker(s) over a chain store (`p1 serve`).

    Each worker mmaps the store WITHOUT the writer flock (a live node
    keeps appending underneath; the worker's refresh loop follows the
    tail) and answers headers/filters/proof/blocks/status queries behind
    governor admission — node/queryplane.py.  ``--workers N`` forks N
    processes sharing one port via SO_REUSEPORT, so query throughput
    scales with cores.  Prints one JSON line per worker with the bound
    port once serving."""
    import os
    import signal

    from p1_tpu_torch.node.queryplane import serve_replica

    retarget = _retarget_rule(args)
    if args.workers > 1 and args.port == 0:
        print("--workers > 1 needs an explicit --port", file=sys.stderr)
        return 2
    if args.workers < 1:
        print("--workers must be >= 1", file=sys.stderr)
        return 2

    def _addr(spec: str) -> tuple[str, int]:
        host, _, port = spec.rpartition(":")
        return (host or "127.0.0.1", int(port))

    upstreams = [_addr(s) for s in args.bootstrap]
    if upstreams:
        # Cold start BEFORE any worker serves (and before SO_REUSEPORT
        # forks — exactly one process writes the store): PoW-verified
        # skeleton, chunk-verified snapshot pinned to it, adopted filter
        # headers, bodies above the base.  node/provision.py.
        from p1_tpu_torch.node.provision import BootstrapError, bootstrap_store

        try:
            report = asyncio.run(
                bootstrap_store(
                    args.store,
                    upstreams,
                    args.difficulty,
                    retarget=retarget,
                    progress=lambda m: print(f"bootstrap: {m}", file=sys.stderr),
                )
            )
        except (BootstrapError, ConnectionError, OSError, ValueError) as e:
            print(f"serve failed: bootstrap: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"config": "bootstrap", **report}), flush=True)

    def _worker(primary: bool = True) -> int:
        async def _run() -> int:
            try:
                srv = await serve_replica(
                    args.store,
                    args.difficulty,
                    retarget=retarget,
                    host=args.host,
                    port=args.port,
                    refresh_interval_s=args.refresh_interval,
                    reuse_port=args.workers > 1,
                )
            except (OSError, ValueError) as e:
                print(f"serve failed: {e}", file=sys.stderr)
                return 1
            sync = None
            if upstreams and primary:
                # Only the primary worker writes the store; siblings see
                # the appends through their own refresh loops.
                from p1_tpu_torch.chain.store import ChainStore
                from p1_tpu_torch.node.provision import UpstreamSync

                sync_store = ChainStore(args.store, fsync=False)
                sync = UpstreamSync(
                    sync_store,
                    srv.view,
                    upstreams,
                    args.difficulty,
                    retarget=retarget,
                    poll_interval_s=max(args.refresh_interval, 0.25),
                )
                sync.start()
            print(
                json.dumps(
                    {
                        "config": "serve",
                        "port": srv.port,
                        "height": srv.view.tip_height,
                        "records": srv.view.records,
                        "assumed_base": srv.view.assumed_base,
                        "pid": os.getpid(),
                    }
                ),
                flush=True,
            )
            # Graceful drain on SIGTERM: stop accepting, push every live
            # session a final cursor marker, then exit 0 — a wallet sees
            # an ordinary gap event and fails over mid-stream, not a
            # dead socket it must time out on.
            term = asyncio.Event()
            loop = asyncio.get_running_loop()
            try:
                loop.add_signal_handler(signal.SIGTERM, term.set)
            except (NotImplementedError, RuntimeError):
                pass  # non-unix / nested loop: deadline still works
            try:
                if args.deadline is not None:
                    await asyncio.wait_for(term.wait(), args.deadline)
                else:
                    await term.wait()
            except (asyncio.TimeoutError, TimeoutError):
                pass
            except asyncio.CancelledError:
                pass
            finally:
                if sync is not None:
                    await sync.stop()
                    sync_store.close()
                drained = await srv.drain()
                print(
                    json.dumps(
                        {"config": "drain", "sessions": drained,
                         "pid": os.getpid()}
                    ),
                    flush=True,
                )
            return 0

        try:
            return asyncio.run(_run())
        except KeyboardInterrupt:
            return 0

    procs = []
    if args.workers > 1:
        import multiprocessing

        for _ in range(args.workers - 1):
            proc = multiprocessing.Process(
                target=_worker, args=(False,), daemon=True
            )
            proc.start()
            procs.append(proc)
    try:
        return _worker()
    finally:
        for proc in procs:
            proc.terminate()
            proc.join(timeout=5)


def cmd_sim(args) -> int:
    """Run one simulator scenario (node/scenarios.py) and print its
    report as a single JSON line — exit 0 iff the scenario's invariant
    held.  Pure virtual time: the 1000-node default runs in tier-1
    minutes of wall clock on one host."""
    import inspect

    from p1_tpu_torch.node.scenarios import SCENARIOS, run_scenario

    if args.list:
        for name, fn in sorted(SCENARIOS.items()):
            doc = (inspect.getdoc(fn) or "").split(".")[0].replace("\n", " ")
            print(f"{name}: {doc}")
        return 0
    if args.scenario not in SCENARIOS:
        raise SystemExit(
            f"unknown scenario {args.scenario!r}; "
            f"have: {', '.join(sorted(SCENARIOS))} (p1 sim --list)"
        )
    accepted = inspect.signature(SCENARIOS[args.scenario]).parameters
    flag_map = {
        "nodes": args.nodes,
        "joiners": args.joiners,
        "cycles": args.cycles,
        "attackers": args.attackers,
        "region_nodes": args.region_nodes,
        "shards": args.shards,
        "days": args.days,
        # Only passed when disabling: scenarios default telemetry on.
        "telemetry": False if args.no_telemetry else None,
    }
    kwargs = {
        k: v for k, v in flag_map.items() if v is not None and k in accepted
    }
    if not _sim_device_ready(args):
        return 2
    report = run_scenario(
        args.scenario,
        seed=args.seed,
        difficulty=args.difficulty,
        device=args.device,
        **kwargs,
    )
    print(json.dumps(report))
    return 0 if report.get("ok") else 1


def cmd_chaos(args) -> int:
    """Chaos sweep / repro replay (node/chaos.py).  Exit-code contract:
    0 = every schedule's invariants held, 1 = a violation was found and
    its (shrunk) repro artifact written — or, under --repro, the
    artifact's violation reproduced — 2 = usage error (argparse's own
    exit, plus unreadable/foreign repro files)."""
    from p1_tpu_torch.node import chaos

    if not _sim_device_ready(args):
        return 2
    if args.repro:
        try:
            report, artifact = chaos.run_repro(args.repro, device=args.device)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        hit = sorted({v["invariant"] for v in report["violations"]})
        print(
            json.dumps(
                {
                    "repro": args.repro,
                    "expected": artifact["expected_violations"],
                    "observed": hit,
                    "trace_digest": report["trace_digest"],
                    "digest_match": report["trace_digest"]
                    == artifact["expected_trace_digest"],
                    "reproduced": bool(hit),
                }
            )
        )
        return 1 if hit else 0
    digests = []
    for seed in range(args.seed, args.seed + args.schedules):
        events = chaos.generate_schedule(seed, args.nodes, args.events)
        report = chaos.run_chaos(
            seed,
            nodes=args.nodes,
            events=events,
            difficulty=args.difficulty,
            inject_bug=args.inject_bug,
            device=args.device,
        )
        digests.append(report["trace_digest"])
        if report["ok"]:
            continue
        target = report["violations"][0]["invariant"]
        shrunk, runs = events, 0
        if not args.no_shrink:

            def reproduces(subset):
                rep = chaos.run_chaos(
                    seed,
                    nodes=args.nodes,
                    events=subset,
                    difficulty=args.difficulty,
                    inject_bug=args.inject_bug,
                    device=args.device,
                )
                return any(
                    v["invariant"] == target for v in rep["violations"]
                )

            shrunk, runs = chaos.shrink_schedule(events, reproduces)
        final = chaos.run_chaos(
            seed,
            nodes=args.nodes,
            events=shrunk,
            difficulty=args.difficulty,
            inject_bug=args.inject_bug,
            device=args.device,
        )
        chaos.write_repro(
            args.out,
            final,
            shrunk,
            seed=seed,
            nodes=args.nodes,
            difficulty=args.difficulty,
            inject_bug=args.inject_bug,
        )
        print(
            json.dumps(
                {
                    "ok": False,
                    "seed": seed,
                    "violations": final["violations"],
                    "schedule_events": len(events),
                    "shrunk_events": len(shrunk),
                    "shrink_runs": runs,
                    "repro": args.out,
                    "trace_digest": final["trace_digest"],
                }
            )
        )
        return 1
    print(
        json.dumps(
            {
                "ok": True,
                "schedules": args.schedules,
                "seed_first": args.seed,
                "nodes": args.nodes,
                "events_per_schedule": args.events,
                "trace_digests": digests,
            }
        )
    )
    return 0


def cmd_lint(args) -> int:
    """`lint`: the AST determinism/async-safety pass
    (p1_tpu_torch/analysis) over the port's sources.

    Exit-code contract (tests/test_torch_cli.py pins it): 0 = every rule
    clean (no unallowlisted findings, no stale grants), 1 = violations,
    2 = usage (argparse errors, unknown --rule names, bad --path)."""
    from pathlib import Path

    from p1_tpu_torch.analysis import RULES, run_analysis
    from p1_tpu_torch.analysis.allowlist import GRANTS
    from p1_tpu_torch.analysis.engine import PKG_ROOT

    if args.rule:
        unknown = [r for r in args.rule if r not in RULES]
        if unknown:
            print(
                f"p1 lint: unknown rule(s) {', '.join(sorted(unknown))} "
                f"(have: {', '.join(sorted(RULES))})",
                file=sys.stderr,
            )
            return 2
        rules = [RULES[r] for r in args.rule]
    else:
        rules = None

    paths = None
    if args.path:
        paths = []
        for raw in args.path:
            # package-relative spellings first (the common pre-commit
            # case: `lint --path node/node.py` from anywhere), then
            # real filesystem paths.
            p = (PKG_ROOT / raw).resolve()
            if not p.exists():
                p = Path(raw).resolve()
            if not p.exists():
                print(f"p1 lint: no such path: {raw}", file=sys.stderr)
                return 2
            try:
                rel = p.relative_to(PKG_ROOT).as_posix()
            except ValueError:
                print(
                    f"p1 lint: {raw} is outside the analyzed package "
                    f"({PKG_ROOT})",
                    file=sys.stderr,
                )
                return 2
            if rel == ".":
                continue  # the whole package: no constraint
            paths.append(rel + "/" if p.is_dir() else rel)
        paths = paths or None

    report = run_analysis(rules=rules, paths=paths)
    if args.as_json:
        print(json.dumps(report.to_json()))
    else:
        for f in report.violations:
            print(f)
        for s in report.stale:
            print(f"stale grant: {s}")
        for e in report.parse_errors:
            print(f"parse error: {e}")
        if args.granted:
            for f in report.granted:
                reason = GRANTS[f.rule][f.file][f.key]
                print(f"granted: {f}  [{reason}]")
        scoped = (
            f", scoped to {', '.join(report.scoped_to)}"
            if report.scoped_to
            else ""
        )
        print(
            f"p1 lint: {report.files} files, {len(report.rules)} rules, "
            f"{len(report.violations)} violation(s), "
            f"{len(report.granted)} granted, {len(report.stale)} stale "
            f"grant(s){scoped}"
        )
    return 0 if report.clean else 1


def cmd_bench(args) -> int:
    from p1_tpu_torch import bench

    return bench.main(["--device", args.device])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    handler = {
        "mine": cmd_mine,
        "sweep": cmd_sweep,
        "replay": cmd_replay,
        "node": cmd_node,
        "status": cmd_status,
        "metrics": cmd_metrics,
        "maintain": cmd_maintain,
        "tx": cmd_tx,
        "keygen": cmd_keygen,
        "account": cmd_account,
        "proof": cmd_proof,
        "fees": cmd_fees,
        "headers": cmd_headers,
        "watch": cmd_watch,
        "net": cmd_net,
        "pod": cmd_pod,
        "balances": cmd_balances,
        "compact": cmd_compact,
        "fsck": cmd_fsck,
        "snapshot": cmd_snapshot,
        "serve": cmd_serve,
        "sim": cmd_sim,
        "chaos": cmd_chaos,
        "lint": cmd_lint,
        "bench": cmd_bench,
    }[args.cmd]
    return handler(args)


if __name__ == "__main__":
    sys.exit(main())
