"""The p2p node: gossip, chain sync, and the mining loop.

Capability parity: the reference's "p2p node … gossip network …
longest-chain" (BASELINE.json:5,10); benchmark config 4 is four of these on
localhost.  Design:

- **Single-threaded asyncio core** — every chain/mempool/peer mutation
  happens on the event loop, so there are no data races by construction.
  The only other thread is the miner's ``run_in_executor`` worker, which
  touches nothing but its own ``HashBackend`` and a ``threading.Event``.
- **Push gossip**: a new block or tx is pushed whole to every peer (the
  chain dedups blocks, the mempool dedups txs, so floods terminate).
  Out-of-order arrivals park in the chain's orphan pool and a GETBLOCKS
  locator sync backfills the gap.
- **Mining abort on new tip**: the in-flight ``search_nonce`` holds a
  ``threading.Event``; any tip movement sets it, the worker returns, and
  the loop reassembles against the new tip — stale work dies in one chunk.

The port's copy of ``p1_tpu/node/node.py``: the same wire behaviour,
status keys and metrics on the same events.  Its device work is the
port's: the miner's worker thread searches with the registry's backend
(``cuda``: the ``sha256d_search.cu`` kernel; ``cpu``: hashlib), and
signature batches of deep sync, mempool pages and ``--revalidate-store``
(``preverify_signatures``, on the validate lane when
``pipeline_workers >= 1``) go to the ``device`` rung, the
``ed25519_msm.cu`` kernel.  ``NodeConfig.device`` says where both run:
``cuda`` (without a card the node refuses to start) or ``cpu`` (the
kernels' plain PyTorch versions).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import logging
import os
import random
from pathlib import Path

from p1_tpu_torch.chain import AddResult, AddStatus, Chain, ChainStore
from p1_tpu_torch.chain.store import fsync_dir
from p1_tpu_torch.chain import snapshot as chain_snapshot
from p1_tpu_torch.chain.snapshot import SnapshotError
from p1_tpu_torch.chain.validate import ValidationError, preverify_signatures
from p1_tpu_torch.chain.versionbits import Deployment, VBState, VersionBits
from p1_tpu_torch.config import NodeConfig
from p1_tpu_torch.core import keys
from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.sigcache import SignatureCache
from p1_tpu_torch.core.tx import Transaction
from p1_tpu_torch.mempool import Mempool
from p1_tpu_torch.miner import Miner
from p1_tpu_torch.node import protocol
from p1_tpu_torch.node import reconcile
from p1_tpu_torch.node.governor import (
    CLASS_BLOCKS,
    CLASS_QUERIES,
    CLASS_TXS,
    PENDING_CBLOCKS_PER_PEER,
    WRITE_QUEUE_GOSSIP_MAX,
    ResourceGovernor,
)
from p1_tpu_torch.node.pipeline import NodePipeline, WorkerCrash
from p1_tpu_torch.node.protocol import Hello, MsgType
from p1_tpu_torch.node.supervision import RequestSupervisor
from p1_tpu_torch.node.transport import SOCKET_TRANSPORT, Transport

log = logging.getLogger("p1_tpu_torch.node")

SYNC_BATCH = 500
#: Headers per GETHEADERS reply (80 B each — 2000 is a 160 KB frame).
HEADERS_BATCH = 2000
#: Address-book bound and per-ADDR-reply cap (peer discovery).
MAX_KNOWN_ADDRS = 1024
ADDR_REPLY_MAX = 64
#: Tried-address bucket: addresses verified by a completed handshake.
#: Kept apart from the gossip-fed book so unsolicited ADDR floods can
#: never evict a known-good node (the eclipse vector) — gossip
#: fills the "new" book, handshakes promote to "tried".
MAX_TRIED_ADDRS = 256
#: Per-peer unsolicited-ADDR budget: a token bucket refilled at
#: ADDR_TOKENS_RATE addresses/second up to one full reply's burst.  Our
#: own GETADDR requests re-credit the responder (solicited replies
#: always fit); a peer streaming ADDR frames on its own initiative is
#: clamped to the refill rate, excess entries silently ignored.
ADDR_TOKENS_MAX = float(ADDR_REPLY_MAX)
ADDR_TOKENS_RATE = 1.0
#: How often the discovery loop checks whether to dial a learned address.
DISCOVERY_INTERVAL_S = 1.0
#: Minimum spacing between repeat GETADDR broadcasts while under target.
READDR_INTERVAL_S = 30.0
#: Server-side cap on a GETFEES sample window — like SYNC_BATCH /
#: HEADERS_BATCH, a peer must not be able to drive O(chain) scans on the
#: event loop by asking big.
FEE_WINDOW_MAX = 1024
#: Filters per GETFILTERS reply (a filter is a few bytes per tx; 1000
#: keeps the frame well under MAX_FRAME even for full blocks).
FILTER_BATCH = 1000
#: Pending compact-block reconstructions awaiting a BLOCKTXN reply.  Small
#: and FIFO-capped: entries exist only for the one GETBLOCKTXN round trip;
#: anything stranded (peer died mid-answer) is evicted by newer blocks and
#: the chain heals through ordinary locator sync.
MAX_PENDING_CBLOCKS = 64
#: Connected-peer cap: the last unbounded per-peer resource (sessions +
#: writer buffers).  Gossip needs a handful of peers; a dialer flood past
#: the cap is refused at handshake time.
MAX_PEERS = 64
#: Cap on inbound connections that have not yet completed HELLO.  A
#: pre-handshake socket never enters ``_peers`` (so MAX_PEERS can't see
#: it) yet holds a session task and transport buffers — without this
#: bound an accept flood grows ``_sessions`` until the handshake timeout
#: fires, and with none it grows forever.  Sized above any honest burst
#: (a whole net restarting dials in well under this).
MAX_HANDSHAKING = 32
#: Byte budget for one BLOCKS reply — safely under protocol.MAX_FRAME so a
#: sync reply is never a frame the receiver is guaranteed to reject.
SYNC_BYTES = 8 << 20
#: Caps for one MEMPOOL sync reply (count and encoded bytes).
MEMPOOL_SYNC_TXS = 2000
MEMPOOL_SYNC_BYTES = 2 << 20
RECONNECT_DELAY_S = 0.5
GOSSIP_SEND_TIMEOUT_S = 5.0
#: Set-reconciliation relay (Erlay analog).  Per-peer bound on
#: txids queued for the next reconciliation round — overflow floods the
#: oldest entries instead of dropping them (flood is the pressure valve,
#: reconciliation the optimisation, never the other way around).
RECON_PENDING_MAX = 4096
#: Consecutive failed/stalled rounds before a peer is demoted off the
#: recon plane back to plain flooding, and for how long.  Demotion is
#: per-peer and self-healing: a poisoned or broken peer costs us its own
#: link's efficiency, never relay liveness.
RECON_DEMOTE_FAILURES = 3
RECON_DEMOTE_S = 60.0
#: Cap on mempool entries scanned to serve one GETTX fallback fetch when
#: the short-id is no longer in the recon window — bounds the work a
#: hostile GETTX spray can demand.
RECON_GETTX_SCAN_MAX = 4096
#: Misbehavior scoring: a host that commits this many protocol violations
#: (malformed frames, wrong chain/version, bad handshake) within the
#: window is refused at accept time for the ban duration.  Violations are
#: PEER-side faults only — our own refusals (peer cap, self-connect)
#: never count against the remote.
BAN_SCORE_THRESHOLD = 3
BAN_WINDOW_S = 60.0
BAN_DURATION_S = 30.0
#: Bound on tracked misbehaving hosts: an attacker cycling source
#: addresses must not grow node memory one deque per address forever —
#: on overflow, stale entries are pruned first, then oldest-arbitrary.
MAX_TRACKED_HOSTS = 4096
#: Relay races: a full-mesh peer relays each block it accepts once, so
#: when several peers relay the same new block all but the first arrival
#: are duplicates, charged to the blocks budget.  A peer's FIRST push of
#: one of our last RELAY_RACE_BLOCKS connected blocks earns that charge
#: back (``_refund_relay_race``); a repeat, or a push of an older block,
#: stays charged.  So the honest duplicate stream scales with the mesh's
#: block rate — hundreds a second when four nodes mine difficulty 20 on
#: one card, past the blocks refill — while a replay flood is cut at the
#: governor's rate, one free frame per block the mesh mines at most.
RELAY_RACE_BLOCKS = 256
#: Mining POLICY (never consensus): refuse to extend a tip stamped more
#: than this far past local wall time — the hostile-bootstrap-anchor
#: guard (_mining_parent).  30 days: unreachable by honest +1 s/block
#: clock drift at any plausible block count, decades under any attack
#: anchor worth mounting.
ANCHOR_SLACK_S = 30 * 86_400
#: Snapshot chunks per SNAPSHOT reply (server cap AND client ask size):
#: 8 chunks x ~110 KB worst case stays far under MAX_FRAME while keeping
#: a multi-million-account transfer to a few hundred round trips.
SNAPSHOT_BATCH = 8
#: Manifest chunk-count cap a fetching node will accept: bounds the
#: worst-case snapshot RAM a hostile manifest can commit us to
#: (4096 chunks x 4096 accounts = ~16M accounts) before any chunk bytes
#: arrive.
SNAPSHOT_MAX_CHUNKS = 4096

#: Validation states (the snapshot plane's trust posture, surfaced in
#: ``status()["snapshot"]``).  ASSUMED = serving state that came from a
#: verified-but-untrusted snapshot while the real history revalidates in
#: the background; VALIDATED = every block behind the tip was fully
#: validated by this node.
VALIDATED = "validated"
ASSUMED = "assumed"


class _Refused(Exception):
    """Session ended by OUR policy (peer cap, self-connect) — ends the
    connection like a ValueError but never scores against the remote."""


#: Admission classes per message type (node/governor.py).  Only
#: UNSOLICITED traffic is charged: pushes (BLOCK/CBLOCK/TX) and requests
#: that make us compute or serve (the GET* family).  Reply frames
#: (BLOCKS, MEMPOOL, HEADERS, BLOCKTXN, ACCOUNT, PROOF, FEES) are never
#: charged — we asked for them, and charging them would let the budget
#: starve our own IBD.  ADDR keeps its dedicated per-host book budget;
#: PING/PONG stay free — liveness must never be rationed.
_MSG_CLASS = {
    MsgType.BLOCK: CLASS_BLOCKS,
    MsgType.CBLOCK: CLASS_BLOCKS,
    MsgType.TX: CLASS_TXS,
    MsgType.GETBLOCKS: CLASS_QUERIES,
    MsgType.GETHEADERS: CLASS_QUERIES,
    MsgType.GETMEMPOOL: CLASS_QUERIES,
    MsgType.GETACCOUNT: CLASS_QUERIES,
    MsgType.GETPROOF: CLASS_QUERIES,
    MsgType.GETFEES: CLASS_QUERIES,
    MsgType.GETADDR: CLASS_QUERIES,
    MsgType.GETBLOCKTXN: CLASS_QUERIES,
    MsgType.GETSTATUS: CLASS_QUERIES,
    MsgType.GETFILTERS: CLASS_QUERIES,
    MsgType.GETSNAPSHOT: CLASS_QUERIES,
    MsgType.GETMETRICS: CLASS_QUERIES,
    MsgType.GETMAINTAIN: CLASS_QUERIES,
    # The wallet push plane (v14): registering/cancelling a watch and
    # asking for the filter-header commitment chain are requests that
    # make us serve — charged like every other GET*.
    MsgType.SUBSCRIBE: CLASS_QUERIES,
    MsgType.UNSUBSCRIBE: CLASS_QUERIES,
    MsgType.GETFILTERHEADERS: CLASS_QUERIES,
    # The reconciliation plane (v15): opening a round, closing it, and
    # the short-ID fetch all make us compute (a sketch) or serve (TX
    # pushes) — charged like every other request.  The capacity clamp
    # in node/reconcile.py bounds what any single admitted frame can
    # cost; admission bounds how often a peer may present one.
    MsgType.REQRECON: CLASS_QUERIES,
    MsgType.RECONCILDIFF: CLASS_QUERIES,
    MsgType.GETTX: CLASS_QUERIES,
}

#: The OTHER half of the admission contract, spelled out: frames the
#: governor deliberately never charges.  Reply frames (we asked; a
#: budget here would let a slow disk starve our own IBD), the
#: handshake, liveness probes (never rationed), and ADDR, which keeps
#: its dedicated per-host address-book budget instead of a token
#: class.  Every MsgType must appear in exactly one of _MSG_CLASS /
#: _ADMISSION_EXEMPT — the import-time assert below and the
#: wire-contract lint rule both fail a frame type that rides free
#: because somebody FORGOT to classify it (the historical shape:
#: rounds 9–12 each added frames, and an unclassified frame is
#: invisibly maximally permissive).
_ADMISSION_EXEMPT = frozenset(
    {
        MsgType.HELLO,
        MsgType.BLOCKS,
        MsgType.MEMPOOL,
        MsgType.ACCOUNT,
        MsgType.PROOF,
        MsgType.BLOCKTXN,
        MsgType.HEADERS,
        MsgType.FEES,
        MsgType.ADDR,
        MsgType.PING,
        MsgType.PONG,
        MsgType.STATUS,
        MsgType.METRICS,
        MsgType.FILTERS,
        MsgType.SNAPSHOT,
        MsgType.MAINTAIN,
        # Push-plane frames WE emit (EVENT) or asked for
        # (FILTERHEADERS) — charging them would ration our own pushes.
        MsgType.EVENT,
        MsgType.FILTERHEADERS,
        # The sketch reply to OUR REQRECON — solicited like MEMPOOL; an
        # unsolicited one is dropped by the dispatch arm (and scored
        # toward flood demotion), so exemption buys an attacker nothing.
        MsgType.SKETCH,
    }
)
assert (
    set(_MSG_CLASS) | _ADMISSION_EXEMPT == set(MsgType)
    and not set(_MSG_CLASS) & _ADMISSION_EXEMPT
), "every frame type needs exactly one admission classification"

#: Frames dropped while the node is in the SHED overload state.
#: Consensus-critical service — block ingest, headers/blocks/proof
#: serving, liveness, the status probe — stays up; the pool and the
#: address book (pure capacity consumers, fully recoverable from peers
#: later) go quiet first, exactly like the storage layer's serve-only
#: mode sheds ingest but keeps serving.
_SHED_DROPS = frozenset(
    {
        MsgType.TX,
        MsgType.MEMPOOL,
        MsgType.GETMEMPOOL,
        MsgType.GETFEES,
        MsgType.GETACCOUNT,
        MsgType.GETADDR,
        MsgType.ADDR,
        # Snapshot serving is a pure capacity consumer (a joiner can
        # retry any peer later); under SHED it goes quiet with the rest.
        MsgType.GETSNAPSHOT,
        # The telemetry export sheds too — GETSTATUS is the minimal
        # health probe and stays up; the full latency dump is capacity
        # an overloaded node may refuse (scrapers retry).
        MsgType.GETMETRICS,
        # NEW subscriptions shed under overload (a wallet retries any
        # replica); live ones keep degrading down their own ladder, and
        # UNSUBSCRIBE stays up because it frees capacity.
        MsgType.SUBSCRIBE,
        # The whole reconciliation exchange is tx-plane capacity, shed
        # with TX/MEMPOOL: a dropped round degrades to flood (or a
        # retry next interval), never to a lost transaction — the same
        # recoverability argument as the pool itself.  SKETCH is a
        # solicited reply, but unlike BLOCKS the round it answers has
        # its own stall fallback, so shedding it cannot wedge a
        # supervisor.
        MsgType.REQRECON,
        MsgType.SKETCH,
        MsgType.RECONCILDIFF,
        MsgType.GETTX,
    }
)

#: The keep side, spelled out frame by frame: consensus-critical
#: service (block ingest and the sync/relay frames), solicited replies
#: (dropping a reply we asked for would wedge our own supervisors),
#: liveness, and the GETSTATUS health probe — overload must stay
#: observable while it is happening.  Every MsgType must appear in
#: exactly one of _SHED_DROPS / _SHED_KEEPS; the assert and the
#: wire-contract lint rule close the "new frame forgot its SHED
#: classification" hole structurally.
_SHED_KEEPS = frozenset(
    {
        MsgType.HELLO,
        MsgType.BLOCK,
        MsgType.CBLOCK,
        MsgType.GETBLOCKS,
        MsgType.BLOCKS,
        MsgType.GETBLOCKTXN,
        MsgType.BLOCKTXN,
        MsgType.GETHEADERS,
        MsgType.HEADERS,
        MsgType.GETPROOF,
        MsgType.PROOF,
        MsgType.GETFILTERS,
        MsgType.FILTERS,
        MsgType.ACCOUNT,
        MsgType.FEES,
        MsgType.SNAPSHOT,
        MsgType.PING,
        MsgType.PONG,
        MsgType.GETSTATUS,
        MsgType.STATUS,
        MsgType.METRICS,
        # The maintenance plane stays reachable under overload for the
        # same reason GETSTATUS does: online prune/compact/rebase are
        # exactly the operations an operator reaches for WHILE the node
        # is resource-pressured — shedding them would make the fix for
        # overload unavailable during overload.
        MsgType.GETMAINTAIN,
        MsgType.MAINTAIN,
        # UNSUBSCRIBE frees capacity; EVENT/FILTERHEADERS are frames we
        # push or asked for; GETFILTERHEADERS is the commitment-chain
        # probe a wallet uses to decide whether to TRUST us — shedding
        # it during overload would make a loaded replica look like a
        # lying one.
        MsgType.UNSUBSCRIBE,
        MsgType.GETFILTERHEADERS,
        MsgType.EVENT,
        MsgType.FILTERHEADERS,
    }
)
assert (
    _SHED_DROPS | _SHED_KEEPS == set(MsgType)
    and not _SHED_DROPS & _SHED_KEEPS
), "every frame type needs exactly one SHED classification"

#: Relay-byte accounting families.  Every frame type maps to
#: the bandwidth plane its bytes spend, and every SENT frame is counted
#: at the one send choke point (``_Peer.send``) into a per-msgtype
#: ``relay.bytes.<name>`` telemetry counter plus this family label.
#: The families are what the relay A/B budget reasons over: ``tx`` +
#: ``recon`` together form the tx-relay plane that set reconciliation
#: exists to shrink; ``block`` announces stay flooded by design and are
#: budgeted separately; ``serve``/``push``/``control``/``handshake``
#: are demand-driven, not relay overhead.  Exhaustive like the
#: admission/SHED tables — the assert below and the wire-contract lint
#: rule fail any frame type whose bytes would otherwise silently vanish
#: from the bandwidth budget.
_RELAY_ACCOUNTING: dict = {
    MsgType.HELLO: "handshake",
    MsgType.BLOCK: "block",
    MsgType.CBLOCK: "block",
    MsgType.GETBLOCKS: "block",
    MsgType.BLOCKS: "block",
    MsgType.GETBLOCKTXN: "block",
    MsgType.BLOCKTXN: "block",
    MsgType.GETHEADERS: "block",
    MsgType.HEADERS: "block",
    MsgType.TX: "tx",
    MsgType.GETMEMPOOL: "tx",
    MsgType.MEMPOOL: "tx",
    MsgType.REQRECON: "recon",
    MsgType.SKETCH: "recon",
    MsgType.RECONCILDIFF: "recon",
    MsgType.GETTX: "recon",
    MsgType.GETACCOUNT: "serve",
    MsgType.ACCOUNT: "serve",
    MsgType.GETPROOF: "serve",
    MsgType.PROOF: "serve",
    MsgType.GETFEES: "serve",
    MsgType.FEES: "serve",
    MsgType.GETFILTERS: "serve",
    MsgType.FILTERS: "serve",
    MsgType.GETSNAPSHOT: "serve",
    MsgType.SNAPSHOT: "serve",
    MsgType.GETFILTERHEADERS: "serve",
    MsgType.FILTERHEADERS: "serve",
    MsgType.SUBSCRIBE: "push",
    MsgType.EVENT: "push",
    MsgType.UNSUBSCRIBE: "push",
    MsgType.GETADDR: "control",
    MsgType.ADDR: "control",
    MsgType.PING: "control",
    MsgType.PONG: "control",
    MsgType.GETSTATUS: "control",
    MsgType.STATUS: "control",
    MsgType.GETMETRICS: "control",
    MsgType.METRICS: "control",
    MsgType.GETMAINTAIN: "control",
    MsgType.MAINTAIN: "control",
}
assert set(_RELAY_ACCOUNTING) == set(MsgType) and all(
    _RELAY_ACCOUNTING.values()
), "every frame type needs a relay-byte accounting family"

#: msgtype byte -> telemetry counter name, precomputed so the hot send
#: path never formats a string.
_RELAY_COUNTER_NAME = {
    int(m): "relay.bytes." + m.name.lower() for m in MsgType
}


#: NodeMetrics counter fields, in their historical (dataclass) order.
#: Families, for readers: block/tx flow (mined/accepted/rejected/reorgs,
#: hashes), compact relay (BIP152-style hits/fetches/bytes saved), wire
#: traffic (counted at the one send choke point and the session read
#: loop), liveness probes, lost-task crash observation, request
#: supervision (stalls/failovers/demotions — see node/supervision.py),
#: storage durability (chain/store.py degraded mode), the query serving
#: plane, and untrusted snapshot sync.
_METRIC_COUNTERS = (
    "blocks_mined",
    "blocks_accepted",
    "blocks_rejected",
    "reorgs",
    "txs_accepted",
    "hashes_done",
    "cblocks_sent",
    "cblocks_received",
    "cblock_tx_hits",
    "cblock_tx_fetched",
    "cblock_bytes_saved",
    "bytes_sent",
    "bytes_received",
    "pings_sent",
    "peers_evicted_idle",
    "task_crashes",
    "sync_stalls",
    "sync_failovers",
    "sync_demotions",
    "sync_exhausted",
    "cblock_fetch_stalls",
    "mempool_sync_stalls",
    "store_errors",
    "store_retries",
    "store_recoveries",
    "store_blocks_deferred",
    "store_segments_pruned",
    "pruned_refusals",
    "proofs_served",
    "filters_served",
    "filter_bytes_served",
    "snapshot_fetches",
    "snapshot_chunks_served",
    "snapshot_flips",
    "snapshot_divergences",
    "snapshot_fallbacks",
    "snapshot_stalls",
    "revalidated_blocks",
    "worker_respawns",
    # The always-on maintenance plane: zero-downtime
    # operations a long-running node performs on itself while mining
    # and serving, plus the continuous-snapshot economics they enable.
    "rebases",
    "online_prunes",
    "online_compactions",
    "segments_compacted",
    "compaction_records_dropped",
    "snapshot_incremental_builds",
    "snapshot_chunks_reused",
    # Set-reconciliation tx relay (Erlay analog): rounds we
    # initiated, sketches we served as responder, rounds that decoded,
    # rounds that fell back to flood/paging, peers demoted off the
    # recon plane, and individual txs delivered via reconciliation.
    "recon_rounds",
    "recon_sketches_served",
    "recon_success",
    "recon_fallbacks",
    "recon_demotions",
    "txs_reconciled",
)
#: Float-valued point-in-time fields (mining timing).
_METRIC_GAUGES = ("mine_elapsed_s", "last_block_time_s")


class NodeMetrics:
    """Counters surfaced by ``Node.status()`` (metrics).

    The storage lives on the telemetry registry
    (node/telemetry.py) so every counter is exportable over GETMETRICS /
    `p1 metrics` / Prometheus — but the ATTRIBUTE surface is unchanged:
    ``metrics.blocks_mined += 1`` still works everywhere it always did
    (``__getattr__``/``__setattr__`` route to the registry), and the
    ``status()`` key contract is pinned byte-for-byte by
    tests/test_telemetry.py.  Unknown attribute names still raise
    AttributeError — a typo must not silently mint a counter.
    """

    __slots__ = ("registry", "propagation_delays_s", "relay_counters")

    def __init__(self, registry=None):
        from p1_tpu_torch.node.telemetry import MetricsRegistry

        object.__setattr__(
            self,
            "registry",
            registry if registry is not None else MetricsRegistry(),
        )
        #: Rolling window of block propagation delays (peer's gossip
        #: send -> our acceptance), seconds — the host-side
        #: timing of gossip round-trips.  Bounded; kept as a raw deque
        #: (the historical ``propagation_summary`` contract) alongside
        #: the registry's ``block.propagation_s`` histogram.
        object.__setattr__(
            self, "propagation_delays_s", collections.deque(maxlen=1024)
        )
        #: msgtype byte -> registry Counter for ``relay.bytes.<name>``,
        #: populated lazily on first send of each frame type so the
        #: registry only carries rows for traffic that actually flowed.
        object.__setattr__(self, "relay_counters", {})
        for name in _METRIC_COUNTERS:
            self.registry.counter(name)
        for name in _METRIC_GAUGES:
            self.registry.gauge(name)

    def __getattr__(self, name):
        registry = object.__getattribute__(self, "registry")
        c = registry.counters.get(name)
        if c is not None:
            return c.value
        g = registry.gauges.get(name)
        if g is not None:
            return g.value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        registry = object.__getattribute__(self, "registry")
        c = registry.counters.get(name)
        if c is not None:
            c.value = value
            return
        g = registry.gauges.get(name)
        if g is not None:
            g.value = value
            return
        raise AttributeError(name)

    def count_relay(self, mtype_byte: int, nbytes: int) -> None:
        """Attribute ``nbytes`` of sent wire traffic to its frame type.

        Called from the one send choke point (``_Peer.send``) so the
        per-msgtype ``relay.bytes.*`` counters and the exhaustive
        ``_RELAY_ACCOUNTING`` family table together account for every
        byte the node puts on the wire (plus the 4-byte length prefix,
        matching ``bytes_sent``).  Unknown bytes are ignored rather
        than raising — the send path must never die on a frame the
        decoder would reject anyway.
        """
        registry = object.__getattribute__(self, "registry")
        counters = object.__getattribute__(self, "relay_counters")
        c = counters.get(mtype_byte)
        if c is None:
            name = _RELAY_COUNTER_NAME.get(mtype_byte)
            if name is None:
                return
            c = registry.counter(name)
            counters[mtype_byte] = c
        c.value += nbytes

    def relay_bytes(self) -> dict:
        """{family: bytes_sent} over ``_RELAY_ACCOUNTING`` families."""
        counters = object.__getattribute__(self, "relay_counters")
        out: dict = {}
        for mtype_byte, c in counters.items():
            family = _RELAY_ACCOUNTING[MsgType(mtype_byte)]
            out[family] = out.get(family, 0) + c.value
        return out

    @property
    def hashes_per_sec(self) -> float:
        return self.hashes_done / self.mine_elapsed_s if self.mine_elapsed_s else 0.0

    def propagation_summary(self) -> dict:
        """{median_ms, p95_ms, samples} over the rolling delay window."""
        delays = sorted(self.propagation_delays_s)
        if not delays:
            return {"median_ms": None, "p95_ms": None, "samples": 0}
        return {
            "median_ms": round(1e3 * delays[len(delays) // 2], 3),
            "p95_ms": round(1e3 * delays[min(len(delays) - 1, int(0.95 * len(delays)))], 3),
            "samples": len(delays),
        }


@dataclasses.dataclass
class _PendingCompact:
    """A compact block whose missing transactions are in flight."""

    header: "BlockHeader"
    txs: list  # block-order slots; None where a tx is still missing
    want: dict  # index -> advertised txid (what GETBLOCKTXN asked for)
    sent_ts: float  # original sender's timestamp (propagation telemetry)
    #: When the GETBLOCKTXN round trip was issued (monotonic).  The
    #: supervision loop abandons reconstructions older than the sync
    #: stall deadline and recovers the block via locator sync instead of
    #: waiting on the FIFO cap — a peer that never answers must not be
    #: able to delay a pushed block by squatting the pending slot.
    asked_at: float = 0.0


@dataclasses.dataclass
class _SnapshotFetch:
    """One in-flight snapshot download (manifest, then chunk ranges).
    Everything verifies incrementally: the manifest's anchor block
    before any chunk is asked for, each chunk's digest the moment it
    lands.  Purely in-RAM — a crash mid-transfer loses it and the next
    boot simply starts over (the normal-resume recovery contract)."""

    peer: "_Peer"
    asked_at: float
    manifest: "chain_snapshot.Manifest | None" = None
    chunks: list = dataclasses.field(default_factory=list)


class _Peer:
    def __init__(
        self,
        writer: asyncio.StreamWriter,
        label: str,
        metrics: NodeMetrics | None = None,
    ):
        self.writer = writer
        self.label = label
        self.metrics = metrics
        self.synced_once = False
        #: The peer's advertised listening address (peername host + HELLO
        #: listen port), once the handshake ran; None for non-listening
        #: tooling clients.  Keys the discovery loop's "already connected"
        #: check and is what GETADDR replies share.
        self.addr: tuple[str, int] | None = None
        #: The address WE dialed to reach this peer, if outbound.  May be
        #: an alias of ``addr`` (hostname vs peername IP) — the discovery
        #: loop treats both as connected so it never dials a live peer
        #: again under a different spelling.
        self.dial_addr: tuple[str, int] | None = None
        #: The tip height the peer advertised in its HELLO — the bar our
        #: own chain must reach before the initial mempool sync is worth
        #: requesting (see ``mempool_requested``).
        self.hello_height = 0
        #: One-shot: the initial mempool sync for this peer has been
        #: requested.  It is deferred until our chain has caught up to the
        #: peer's advertised height — pool admission checks affordability
        #: against OUR tip, so asking for transactions while our chain is
        #: still behind would refuse perfectly valid spends of balances we
        #: haven't learned yet.  (Keyed on the advertised height, not on
        #: one peer's batch quiescing: with several peers serving the same
        #: blocks, a duplicate batch quiesces early while the ledger is
        #: still behind.)
        self.mempool_requested = False
        #: (fee, txid) of the last mempool-sync tx received from this peer;
        #: must strictly advance in key order or the sync stops (hostile
        #: responders can't loop us).
        self.mempool_cursor: tuple[int, bytes] | None = None
        #: When a GETMEMPOOL page request to this peer went out and no
        #: MEMPOOL reply has landed yet (None = nothing outstanding).
        #: The supervision loop treats an aged entry as a stalled sync.
        self.mempool_inflight_since: float | None = None
        #: True once the peer's HELLO carried a nonzero instance nonce —
        #: a real node, not a one-shot tooling client.  Only nodes are
        #: eligible targets for sync failover (a wallet ignores
        #: GETBLOCKS).
        self.is_node = False
        #: Sync-priority demerits: one per supervised fetch this peer
        #: stalled.  A demotion, never a ban — the peer keeps its
        #: connection and its gossip, it just sorts last when the node
        #: picks who to re-ask (supervision.py's design note).
        self.sync_demerits = 0
        # --- Set-reconciliation relay state (Erlay analog) ---
        #: Pairwise short-id salt, derived from the two instance nonces
        #: at HELLO (node/reconcile.py ``pair_salt``).  None until the
        #: handshake ran, or for tooling clients (nonce 0) — a peer
        #: without a salt is simply flooded to, like every peer before
        #: this round.
        self.recon_salt: bytes | None = None
        #: short_id -> txid of txs queued for the NEXT reconciliation
        #: round on this link instead of being flooded (insertion
        #: ordered; bounded by RECON_PENDING_MAX with flood as the
        #: overflow valve).
        self.recon_pending: dict[int, bytes] = {}
        #: Responder side: the short_id -> txid set we sketched in our
        #: last SKETCH reply, held until the initiator's RECONCILDIFF
        #: closes the round (serves their diff / GETTX fetches from it).
        self.recon_window: dict[int, bytes] = {}
        #: True when recon_window was sketched for a FULL-pool round
        #: (initial mempool sync) — failure must not flood whole pools.
        self.recon_window_full = False
        #: The serve station: short_id -> txid of the last CLOSED round
        #: (either role), kept so the peer's deferred GETTX resolves
        #: without a pool scan.  Replaced whole each close — never
        #: merged — so it cannot grow past one round's size.
        self.recon_served: dict[int, bytes] = {}
        #: Initiator side: the short_id -> txid set frozen into the
        #: round in flight, and whether that round is a full-pool sync.
        self.recon_round: dict[int, bytes] = {}
        self.recon_round_full = False
        #: When our REQRECON went out and no usable SKETCH has landed
        #: (None = no round in flight).  Aged entries count as failed
        #: rounds — a silent responder must not wedge the plane.
        self.recon_inflight_since: float | None = None
        #: Short ids the peer announced in RECONCILDIFF that we have not
        #: yet received as TX pushes; the next tick GETTXes leftovers.
        self.recon_expect: set[int] = set()
        #: Consecutive failed/stalled rounds; reaching
        #: RECON_DEMOTE_FAILURES demotes the peer to flood until
        #: ``recon_demoted_until`` passes.
        self.recon_failures = 0
        self.recon_demoted_until = 0.0
        #: One-shot: the initial mempool sync should run as a full-pool
        #: reconciliation round on the next tick (set where the classic
        #: path would have sent GETMEMPOOL).
        self.recon_full_pending = False
        #: Remote host (peername IP), for per-HOST accounting such as the
        #: ADDR budget — per-connection state would reset on reconnect.
        self.host: str | None = (
            writer.get_extra_info("peername") or (None,)
        )[0]
        #: Per-peer multi-class admission budget (node/governor.py),
        #: assigned by the session once the governor is known.
        self.budget = None
        #: Hashes of recent blocks this peer pushed as duplicates, oldest
        #: first: each earns one relay-race refund (``Node.
        #: _refund_relay_race``).  Twice the recent window, so a hash
        #: leaves it only after leaving the window.
        self.raced: collections.OrderedDict[bytes, None] = (
            collections.OrderedDict()
        )

    async def send(self, payload: bytes) -> None:
        await protocol.write_frame(self.writer, payload)
        # Counted after write+drain: failed sends don't inflate the total.
        # Known slack: a send cancelled between write and drain (guarded
        # timeout) may still be flushed by the transport and reach the
        # peer uncounted — the figure is "completed send calls", a slight
        # UNDERcount under peer stalls, never an overcount.
        if self.metrics is not None:
            self.metrics.bytes_sent += len(payload) + 4
            if payload:
                # Per-msgtype relay-byte attribution: same
                # choke point, same +4 framing overhead as bytes_sent.
                self.metrics.count_relay(payload[0], len(payload) + 4)


class Node:
    """One blockchain node: chain + mempool + p2p + (optionally) a miner."""

    def __init__(
        self,
        config: NodeConfig,
        miner: Miner | None = None,
        store: ChainStore | None = None,
        transport: Transport | None = None,
        rng: random.Random | None = None,
    ):
        self.config = config
        #: The network/clock seam (node/transport.py).  Default = real
        #: sockets + system clocks, byte-identical to the historical
        #: behavior; the simulator (node/netsim.py) injects in-memory
        #: links under a virtual clock so a thousand of these run
        #: deterministically in one process.
        self.transport = transport if transport is not None else SOCKET_TRANSPORT
        self.clock = self.transport.clock
        #: Telemetry plane (node/telemetry.py): counters, gauges, and
        #: per-stage latency histograms, reading time ONLY through the
        #: transport clock — wall time live, virtual time under the
        #: simulator.  Recording is observer-only by contract: the
        #: determinism pair (tests/test_telemetry.py) pins that a
        #: simulated run's trace digest is byte-identical with the
        #: plane enabled and disabled.
        from p1_tpu_torch.node.telemetry import MetricsRegistry, NodeLogAdapter

        self.telemetry = MetricsRegistry(
            clock=self.clock.monotonic, enabled=config.telemetry
        )
        #: Hot-path instrumentation, pre-resolved: the block pipeline
        #: dispatches thousands of frames a second, and the generic
        #: ``registry.span()`` (dict lookup + context-manager + span
        #: allocation per region) measurably taxes it — the stage spans
        #: below use ``_tel_clock`` stamps + cached histogram refs
        #: instead (~half the cost; benchmarks/telemetry_overhead.py is
        #: the receipt).  ``_tel_clock is None`` IS the disabled check.
        if self.telemetry.enabled:
            self._tel_clock = self.clock.monotonic
            self._h_frame = self.telemetry.histogram("stage.frame_s")
            self._h_admission = self.telemetry.histogram(
                "stage.admission_s"
            )
            self._h_validate = self.telemetry.histogram("stage.validate_s")
            self._h_store = self.telemetry.histogram("stage.store_s")
            self._h_relay = self.telemetry.histogram("stage.relay_s")
            self._h_query = self.telemetry.histogram("query.request_s")
        else:
            self._tel_clock = None
        #: Deterministic 1-in-8 sampler for the PER-FRAME micro stages
        #: (frame decode, admission): they run for every frame at
        #: microsecond durations, so full recording would tax the hot
        #: path for distributions that a uniform sample captures
        #: identically.  The block stages (validate/store/relay) and
        #: query latency record every event.  A counter, not an RNG —
        #: sampling must not perturb simulated determinism.
        self._tel_tick = 0
        #: Identity-carrying logger: every record is prefixed with this
        #: node's host:port, so multi-node processes (`p1 net`, the
        #: simulator, netharness) stop interleaving anonymously.
        self.log = NodeLogAdapter(log, self._log_ident)
        #: Node-local RNG.  None (production) draws identity from the
        #: OS; a seeded instance (config.rng_seed, or injected directly)
        #: makes the node's identity AND its supervision jitter a pure
        #: function of the seed — the reproducibility contract simulated
        #: runs assert byte-for-byte.
        if rng is None and config.rng_seed is not None:
            rng = random.Random(config.rng_seed)
        self._rng = rng
        if rng is not None:
            nonce = rng.getrandbits(64) | 1
            tag = f"m-{rng.getrandbits(32):08x}"
        else:
            import secrets

            nonce = secrets.randbits(64) | 1
            tag = f"m-{secrets.token_hex(4)}"
        #: Random per-process id carried in HELLO: dialing an address that
        #: answers with OUR nonce means we dialed ourselves (an address
        #: book can legitimately learn our own address from peers) — the
        #: connection is dropped and the address forgotten.
        self.instance_nonce = nonce  # never 0 (= client)
        #: Coinbase identity: distinct per node unless pinned by config, so
        #: concurrent miners assemble *different* candidate blocks and the
        #: fork-choice machinery is actually exercised at network level.
        self.miner_id = config.miner_id or tag
        self.chain = Chain(config.difficulty, retarget=config.retarget_rule())
        if config.snapshot_interval > 0:
            self.chain.checkpoint_interval = config.snapshot_interval
        #: Snapshot plane (chain/snapshot.py).  The node's
        #: trust posture: VALIDATED until a snapshot boot, ASSUMED from
        #: snapshot adoption until the background revalidation either
        #: reproduces the snapshot's state root (flip to VALIDATED) or
        #: catches it lying (quarantine + fall back to genesis IBD —
        #: also VALIDATED, of the honest chain built so far).
        self.validation_state = VALIDATED
        self._snap_fetch: _SnapshotFetch | None = None
        #: Manifest of the ADOPTED snapshot (None unless ASSUMED) and
        #: the host that served it (divergence blames it).
        self._snap_meta = None
        self._snap_source: str | None = None
        #: Background revalidation: a second, genesis-anchored Chain
        #: replaying the real history through the batched-signature
        #: lane while the assumed chain serves.  None unless ASSUMED.
        self._bg_chain: Chain | None = None
        self._bg_last_staller: _Peer | None = None
        #: Served-snapshot cache: ((height, block hash), (manifest
        #: payload, chunk payloads), bytes) for the latest checkpoint —
        #: rebuilt lazily when the checkpoint moves, charged to the
        #: memory gauge.
        self._snapshot_cache = None
        #: Incremental snapshot residue (chain/snapshot.py
        #: ``build_records_incremental``): the per-account build state
        #: from the LAST checkpoint build, plus the dirty accounts whose
        #: changes postdate that build's checkpoint — together they make
        #: the next build O(accounts touched), never O(accounts).
        self._snapshot_inc = None
        self._snapshot_dirty: set[str] = set()
        #: Version-bits activation engine
        #: (chain/versionbits.py): in-place protocol evolution by miner
        #: signal.  Empty deployment table (the default) mines the
        #: legacy ``version=1`` byte-identically to a chain without them.
        self.versionbits = VersionBits(
            tuple(Deployment(*d) for d in config.deployments),
            window=config.vb_window,
            threshold=config.vb_threshold,
        )
        #: Optional version-bits gate for the reconciliation relay: when
        #: the deployment table carries a "txrecon" row, recon rounds are
        #: initiated only once it reaches ACTIVE — the mixed-version
        #: mesh upgrades link by link as miners signal, flood remaining
        #: the shared dialect throughout (the evolution contract).
        self._recon_deployment = next(
            (d for d in self.versionbits.deployments if d.name == "txrecon"),
            None,
        )
        #: Round-robin cursor over outbound recon-active peers — one
        #: reconciliation initiation per tick, not a thundering herd.
        self._recon_rotate = 0
        #: Same shape for the GETTX chase: one link's announced-but-
        #: undelivered ids fetched per tick (the dedup pacing).
        self._recon_chase_rotate = 0
        #: txid -> monotonic arrival stamp for accepted txs (bounded,
        #: insertion-ordered).  Pure observation for the propagation
        #: budget (scenarios read it to compute relay p95); never feeds
        #: back into relay decisions.
        self.tx_seen_at: dict[bytes, float] = {}
        #: Name of the maintenance operation currently running, or None.
        #: One at a time: rebase/prune/compact each assume the store
        #: segment set is not shifting under them, and serializing here
        #: is cheaper than making them mutually crash-consistent.
        self._maintenance_busy: str | None = None
        #: Verify-once signature cache (core/sigcache.py): ONE instance
        #: shared by this node's mempool admission and its chain's block
        #: validation, so a transfer verified at relay/admission connects
        #: (and mines) without re-paying the Ed25519 backend — and the
        #: hit/miss telemetry in ``status()["validation"]`` is this
        #: node's own, not the process default's.
        self.sig_cache = SignatureCache()
        self.chain.sig_cache = self.sig_cache
        if config.verify_workers > 0:
            # Explicit pin only: an unpinned node must not clobber
            # another node's pin in a multi-node test process.
            keys.set_verify_workers(config.verify_workers)
        elif config.pipeline_workers > 0:
            # Staged pipeline sizing: --pipeline-workers N without an
            # explicit verify pin sizes the Ed25519 verify pool too —
            # the validate lane's parallelism lives INSIDE the verify
            # pool (one lane thread fanning a preverify batch), so the
            # two knobs default together.
            keys.set_verify_workers(config.pipeline_workers)
        if config.sig_backend in ("auto", "device"):
            # Same explicit-pin discipline for the signature backend
            # (core/keys.py ladder): "auto" on the card must not clobber
            # another node's pin in multi-node test processes.  A node
            # off the card pins the device rung to its plain version:
            # without a card the kernel's batches would raise.
            if config.sig_backend == "device" or config.device != "cuda":
                keys.set_sig_backend("device", device=config.device)
        else:
            keys.set_sig_backend(config.sig_backend)
        # balance_of is a bound-late lambda (not a bound method) so the
        # store-resume path in start(), which REPLACES self.chain, keeps
        # the pool pointed at the live chain's ledger.  The chain tag is
        # safe to bind eagerly: it is a pure function of the chain
        # parameters (difficulty + retarget rule), which a resume cannot
        # change (start() refuses mismatched stores).
        self.mempool = Mempool(
            balance_of=lambda acct: self.chain.balance(acct),
            nonce_of=lambda acct: self.chain.nonce(acct),
            chain_tag=self.chain.genesis.block_hash(),
            sig_cache=self.sig_cache,
            # The transport clock, so admission stamps / TTL ages ride
            # virtual time under the simulator like every node deadline.
            clock=self.clock.monotonic,
        )
        self.metrics = NodeMetrics(registry=self.telemetry)
        #: The wallet push plane (node/subscriptions.py): watch-filter
        #: subscriptions pushed at every block connect, reading the
        #: chain through a late-bound getter because start()'s resume
        #: paths and live re-basing REPLACE self.chain.
        from p1_tpu_torch.node.subscriptions import (
            ChainSubSource,
            SubscriptionManager,
        )

        self.subscriptions = SubscriptionManager(
            ChainSubSource(lambda: self.chain),
            clock=self.clock.monotonic,
            registry=self.telemetry,
        )
        #: ``store`` is injectable (tests pass a fault-injecting
        #: ``chain/testing.py`` FaultStore); by default the config path
        #: decides persistence.
        if store is not None:
            self.store = store
        elif config.store_path:
            # Layout sniffing (chain/segstore.py): an existing
            # segmented store reopens segmented regardless of flags;
            # --store-segment-mb / --prune opt a fresh or single-file
            # store into the segmented layout (single-file upgrades
            # losslessly on acquire).  Spelled as a conditional over
            # the two constructors — the analysis plane's attribute
            # binder unifies them to the ChainStore base, keeping the
            # store-blocking call chains provable.
            from p1_tpu_torch.chain.segstore import (
                DEFAULT_SEGMENT_BYTES,
                SegmentedStore,
                is_segmented,
            )

            seg_bytes = config.store_segment_bytes
            if config.prune_keep_blocks > 0 and seg_bytes == 0:
                seg_bytes = DEFAULT_SEGMENT_BYTES
            self.store = (
                SegmentedStore(
                    config.store_path,
                    segment_bytes=seg_bytes or DEFAULT_SEGMENT_BYTES,
                )
                if seg_bytes > 0 or is_segmented(config.store_path)
                else ChainStore(config.store_path)
            )
        else:
            self.store = None
        #: Storage degradation state (the disk analog of sync-stall
        #: failover): a failed append/fsync flips the node into a
        #: degraded SERVE-ONLY mode — it stops accepting/persisting new
        #: blocks and stops mining, but keeps answering headers/blocks/
        #: proof/account queries from the chain it already holds — while
        #: ``_store_recovery_loop`` retries the disk under the same
        #: jittered-backoff policy the sync supervisor uses.  Blocks
        #: accepted in the failing instant wait in ``_store_pending`` so
        #: recovery persists them in order before new ones.
        self._store_degraded = False
        self._store_last_error: str | None = None
        self._store_pending: list[Block] = []
        self._store_sup = RequestSupervisor(
            stall_timeout_s=1.0,  # unused: only the backoff math is
            attempts_max=1 << 30,  # borrowed, and retries never exhaust
            backoff_base_s=config.sync_backoff_base_s,
            backoff_max_s=config.sync_backoff_max_s,
            clock=self.clock.monotonic,
            rng=self._rng,
        )
        #: Set when a store failure should end the process instead of
        #: degrading (``--store-degraded-exit``); the CLI watches it.
        self.store_fatal = asyncio.Event()
        #: Overload resilience (node/governor.py): per-peer admission
        #: budgets, the write-queue caps, and the SHED state machine over
        #: the accounted memory gauge (``_memory_gauge``) — the third leg
        #: of the degradation triad after sync-stall and disk-fault
        #: handling.
        self.governor = ResourceGovernor(
            watermark_bytes=config.mem_watermark_bytes,
            admission=config.admission_control,
            clock=self.clock.monotonic,
        )
        #: Staged block pipeline (node/pipeline.py): the
        #: validate and store lanes every CPU/IO-heavy stage routes
        #: through.  workers=0 (default) executes inline — scheduling
        #: byte-identical to the historical dispatch-everything-inline
        #: node; workers>=1 moves signature pre-verification and the
        #: whole fsync chain onto worker threads.  Lane depth/bytes feed
        #: ``_memory_gauge`` so queue growth back-pressures at the
        #: governor's front door; worker deaths respawn and count into
        #: the task-crash lineage below.
        self.pipeline = NodePipeline(
            workers=config.pipeline_workers,
            on_respawn=self._worker_respawned,
        )
        if miner is not None:
            self.miner = miner
        else:
            kwargs = {"batch": config.batch} if config.batch else {}
            # The config's device goes to every backend: ``cuda`` runs
            # the search kernel there (raising without a card), and the
            # hashlib ``cpu`` backend refuses any device but the host.
            kwargs["device"] = config.device
            from p1_tpu_torch.hashx import get_backend

            self.miner = Miner(
                backend=get_backend(config.backend, **kwargs), chunk=config.chunk
            )
        self._peers: dict[asyncio.StreamWriter, _Peer] = {}
        #: Supervision of the node-wide locator catch-up job: ONE
        #: progress deadline over "is this chain still advancing toward
        #: what peers advertised", targeting whichever peer was asked
        #: last.  Any accepted block is progress (the serving peer does
        #: not matter — catch-up converges on the same chain from
        #: anyone), so an honest-slow peer that keeps landing batches
        #: never trips it; a peer that answers PINGs but starves the
        #: sync does, and the locator fails over (_check_block_sync).
        self._sync = RequestSupervisor(
            stall_timeout_s=config.sync_stall_timeout_s or 10.0,
            attempts_max=config.sync_attempts_max,
            backoff_base_s=config.sync_backoff_base_s,
            backoff_max_s=config.sync_backoff_max_s,
            clock=self.clock.monotonic,
            rng=self._rng,
        )
        #: Supervision of the background revalidation fetch (its own
        #: supervisor: the assumed chain's tip sync and the history
        #: replay are independent jobs with independent stall blame).
        self._bg_sup = RequestSupervisor(
            stall_timeout_s=config.sync_stall_timeout_s or 10.0,
            attempts_max=config.sync_attempts_max,
            backoff_base_s=config.sync_backoff_base_s,
            backoff_max_s=config.sync_backoff_max_s,
            clock=self.clock.monotonic,
            rng=self._rng,
        )
        #: Set when a batch-synced block (gossip=False — locator sync,
        #: orphan backfill) moved our tip: the catch-up path never
        #: re-gossips individual blocks (a 500-block IBD must not push
        #: 500 frames at every peer), so when the episode QUIESCES the
        #: node announces its final tip once instead.  Without this, a
        #: block only propagates as far as nodes that could connect it
        #: directly: the first peer that needed a backfill becomes a
        #: gossip dead end, and after a partition heals, mesh regions
        #: with no direct link across the old cut never converge — found
        #: by the 1000-node partition-heal simulation (node/netsim.py),
        #: invisible at the 7-node scale real sockets allowed.  It is
        #: Bitcoin's post-IBD tip announcement, one flag's worth.
        self._announce_tip = False
        #: Discovery dials in flight (dedup against the next tick).
        self._dialing: set[tuple[str, int]] = set()
        #: Misbehavior scoring: host -> recent violation times / ban expiry.
        self._violations: dict[str, collections.deque] = {}
        self._banned_until: dict[str, float] = {}
        #: Seconds spent in pool admission of pushed transactions (the
        #: decode is the frame's; this is the signature check and the
        #: pool), admitted or not; the runner logs it at exit.
        self.tx_admission_s = 0.0
        #: The last RELAY_RACE_BLOCKS connected block hashes, oldest
        #: first (``_refund_relay_race``).
        self._recent_connects: collections.OrderedDict[bytes, None] = (
            collections.OrderedDict()
        )
        #: (block hash, announcing peer) -> partially reconstructed compact
        #: block (see ``_handle_cblock``); FIFO-capped.  Keyed per PEER so
        #: a front-runner pushing a tampered txid list for a real block
        #: cannot squat the hash — an honest peer's announcement of the
        #: same block reconstructs independently — and so a BLOCKTXN reply
        #: only ever resolves the request sent to that same peer.
        self._pending_cblocks: collections.OrderedDict[
            tuple[bytes, _Peer], _PendingCompact
        ] = collections.OrderedDict()
        #: Address book, two buckets: ``_known_addrs`` ("new") is seeded
        #: from config and fed by ADDR gossip, FIFO-bounded — hostile
        #: gossip churns only here; ``_tried_addrs`` holds addresses a
        #: completed handshake verified, bounded separately, and gossip
        #: can never evict them (the eclipse-resistance split).  The
        #: discovery loop (``target_peers`` > 0) dials tried first.
        #: Neither contains our own address knowingly — a self-dial is
        #: detected by nonce and the address dropped.
        self._known_addrs: collections.OrderedDict[
            tuple[str, int], float
        ] = collections.OrderedDict(
            (addr, 0.0) for addr in config.peer_addrs()
        )
        self._tried_addrs: collections.OrderedDict[
            tuple[str, int], float
        ] = collections.OrderedDict()
        #: Per-HOST unsolicited-ADDR token buckets: host -> [tokens,
        #: last_refill].  Keyed like the misbehavior tracking (not per
        #: connection — a reconnect must not refresh the budget, or ~16
        #: quick reconnects flush the whole gossip book) and bounded the
        #: same way against address-cycling attackers.
        self._addr_budgets: dict[str, list[float]] = {}
        #: Pool mutation count at the last persisted checkpoint, and the
        #: in-flight checkpoint writer task (stop() drains it before the
        #: final synchronous save — see _checkpoint_mempool).
        self._mempool_saved_at = 0
        self._mempool_io: asyncio.Task | None = None
        self._server: asyncio.Server | None = None
        self._tasks: list[asyncio.Task] = []
        #: Live session/background tasks in CREATION order (a dict used
        #: as an ordered set: ``stop()`` iterates it, and reproducible
        #: simulated runs need reproducible teardown order — a plain
        #: set's id()-based iteration was a trace-divergence source).
        self._sessions: dict[asyncio.Task, None] = {}
        #: Inbound sessions still inside the HELLO exchange (MAX_HANDSHAKING).
        self._handshaking = 0
        self._abort = None  # threading.Event of the in-flight search
        self._mine_task: asyncio.Task | None = None
        self._post_seal: asyncio.Task | None = None  # shielded seal handling
        self._running = False
        self.port: int | None = None  # bound listen port (after start)

    # -- lifecycle -------------------------------------------------------

    def _log_ident(self) -> str:
        """This node's log attribution: the configured host plus the
        BOUND port once the listener is up (before that, the configured
        one — 0 for ephemeral test nodes, which still disambiguates by
        host under the simulator)."""
        return f"{self.config.host}:{self.port if self.port else self.config.port}"

    def _untrack_session(self, task) -> None:
        """Done-callback for fire-and-forget session tasks (dials, sync
        failovers): untrack, and OBSERVE a crash.  Without the
        ``exception()`` read, a task dying of a bug is silent until the
        GC maybe logs "exception was never retrieved" — the
        dead-recovery-loop failure shape the lost-task lint rule pins.
        Expected connection-layer failures are handled inside the tasks
        themselves; anything surfacing HERE is a programming error, so
        it is logged loudly and counted."""
        self._sessions.pop(task, None)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            self.metrics.task_crashes += 1
            self.log.error("session task %r died: %r", task.get_name(), exc)

    def _worker_respawned(self, stage: str) -> None:
        """Pipeline lane worker died and was respawned (node/pipeline.py
        supervision) — same observability contract as the task
        supervisor above: the crash is COUNTED, never silent."""
        self.metrics.worker_respawns += 1
        self.log.warning("%s pipeline worker died; respawned", stage)

    def _addr_book_path(self):
        return (
            Path(f"{self.config.store_path}.addrs")
            if self.config.store_path
            else None
        )

    def _mempool_path(self):
        return (
            Path(f"{self.config.store_path}.mempool")
            if self.config.store_path
            else None
        )

    def _snapshot_path(self):
        """The snapshot sidecar next to the store: present exactly while
        the node is (or crashed while) in the ASSUMED state — a resume
        that finds it boots from the snapshot again and restarts the
        background revalidation; the flip deletes it."""
        if self.store is not None:
            return Path(f"{self.store.path}.snapshot")
        if self.config.store_path:
            return Path(f"{self.config.store_path}.snapshot")
        return None

    def _load_mempool(self) -> None:
        """Resume the pending pool (Bitcoin's mempool.dat analog): every
        record re-passes full admission against the freshly loaded chain,
        so anything the downtime invalidated is dropped, and restored
        ages keep the TTL clock honest across the restart."""
        from p1_tpu_torch.mempool import load_mempool

        path = self._mempool_path()
        if path is None or not path.exists():
            return
        restored, dropped = load_mempool(self.mempool, path)
        if restored or dropped:
            self.log.info(
                "mempool resumed: %d restored, %d dropped on revalidation",
                restored,
                dropped,
            )

    def _save_mempool(self) -> None:
        """Synchronous save (shutdown path — nothing left to stall)."""
        from p1_tpu_torch.mempool import save_mempool

        path = self._mempool_path()
        if path is None:
            return
        try:
            save_mempool(self.mempool, path)
            self._mempool_saved_at = self.mempool.mutations
        except OSError as e:
            self.log.warning("could not persist mempool %s: %s", path, e)

    async def _checkpoint_mempool(self) -> None:
        """Periodic crash checkpoint: skipped when the pool is unchanged
        since the last save; the encoding AND atomic write both run in a
        worker thread — a near-capacity pool (~tens of MB) must not
        stall frame reads, ping deadlines, or mining for the duration.
        The snapshot itself is taken on the event loop, where all pool
        mutation happens, so it is internally consistent (transactions
        are frozen dataclasses — safe to serialize off-thread).  The
        worker future is exposed as ``_mempool_io`` so ``stop()`` can
        wait it out: cancelling this coroutine does NOT stop the thread,
        and a stale checkpoint landing after the shutdown save would
        silently roll the file back."""
        from p1_tpu_torch.mempool import dump_mempool, write_mempool_file

        path = self._mempool_path()
        if path is None or self.mempool.mutations == self._mempool_saved_at:
            return
        mutations = self.mempool.mutations
        rows = self.mempool.snapshot()
        # Store-lane seam, not a bare to_thread: the checkpoint rides
        # the same writer lane as every other persistence chain (append
        # order with respect to block writes is preserved when staged),
        # and ``offload=True`` keeps it off-loop at workers=0 exactly as
        # the historical to_thread call did.
        self._mempool_io = asyncio.create_task(
            self.pipeline.run_store(
                lambda: write_mempool_file(dump_mempool(rows), path),
                offload=True,
            )
        )
        try:
            await self._mempool_io
            self._mempool_saved_at = mutations
        except (OSError, WorkerCrash) as e:
            self.log.warning("could not persist mempool %s: %s", path, e)
        finally:
            self._mempool_io = None

    def _load_addr_book(self) -> None:
        """Resume discovery state: a restarting node re-joins the network
        it knew instead of depending on its seed peers being alive."""
        path = self._addr_book_path()
        if path is None or not path.exists():
            return
        try:
            entries = json.loads(path.read_text())
        except (ValueError, OSError) as e:
            self.log.warning("ignoring unreadable address book %s: %s", path, e)
            return
        # Two formats: the current {"tried": [...], "new": [...]} split
        # and the legacy flat list (loaded as "new" — a restart earns
        # tried status afresh through real handshakes).
        if isinstance(entries, dict):
            tried_rows = entries.get("tried", [])
            new_rows = entries.get("new", [])
            if not isinstance(tried_rows, list) or not isinstance(
                new_rows, list
            ):
                self.log.warning("ignoring malformed address book %s", path)
                return
        elif isinstance(entries, list):
            tried_rows, new_rows = [], entries
        else:
            # Parsable-but-wrong content is just as corrupt as unparsable
            # bytes — the book is a cache, never worth failing startup.
            self.log.warning("ignoring malformed address book %s", path)
            return

        def _rows(rows, limit):
            for entry in rows[:limit]:
                try:
                    host, port = entry
                    # Mirror the ADDR wire rules (protocol.encode_addr):
                    # a row the codec would refuse must not enter the
                    # book, or every later GETADDR reply dies on our own
                    # encode.
                    if (
                        isinstance(host, str)
                        and 0 < len(host.encode("utf-8")) <= 255
                        and 0 < int(port) <= 0xFFFF
                    ):
                        yield (host, int(port))
                except (TypeError, ValueError):
                    continue  # one bad row must not poison the rest

        for addr in _rows(tried_rows, MAX_TRIED_ADDRS):
            self._tried_addrs.setdefault(addr, 0.0)
        for addr in _rows(new_rows, MAX_KNOWN_ADDRS):
            if addr not in self._tried_addrs:
                self._known_addrs.setdefault(addr, 0.0)

    def _save_addr_book(self) -> None:
        path = self._addr_book_path()
        if path is None:
            return
        try:
            tmp = path.with_suffix(".addrs.tmp")
            tmp.write_text(
                json.dumps(
                    {
                        "tried": [list(a) for a in self._tried_addrs],
                        "new": [list(a) for a in self._known_addrs],
                    }
                )
            )
            tmp.replace(path)  # atomic: never a torn book
        except OSError as e:
            self.log.warning("could not persist address book %s: %s", path, e)

    def _try_snapshot_resume(self) -> bool:
        """Resume a node that crashed (or stopped) in the ASSUMED state:
        the ``.snapshot`` sidecar holds the verified snapshot, the store
        holds only snapshot-descendant records.  Returns True when the
        assumed chain was rebuilt (the caller skips the genesis resume).

        Robustness cases, all exercised by the chaos plane:

        - flip completed but crashed before the sidecar unlink: the
          store's first record connects from genesis — the sidecar is
          stale; delete it and take the normal resume;
        - sidecar unreadable/corrupt (bit-rot while down): quarantine it
          and fall through to the normal resume with ``orphans_ok`` (the
          snapshot-descendant records park as orphans and ordinary IBD
          rebuilds from peers) — never a refused boot;
        - the normal case: rebuild the assumed chain from the sidecar,
          replay the store's post-snapshot records onto it, restart the
          background revalidation."""
        snap_path = self._snapshot_path()
        if snap_path is None or not snap_path.exists():
            return False
        ghash = self.chain.genesis.block_hash()
        first = self.store.first_header()
        if first is not None and (
            first.block_hash() == ghash or first.prev_hash == ghash
        ):
            # The flip's store rewrite landed; only the unlink is owed.
            self.log.info("stale snapshot sidecar after a completed flip — removing")
            snap_path.unlink()
            return False
        try:
            snap = chain_snapshot.load_snapshot(snap_path)
        except (OSError, SnapshotError) as e:
            self.log.error(
                "snapshot sidecar unreadable (%s) — quarantining; booting "
                "via ordinary IBD",
                e,
            )
            try:
                os.replace(
                    snap_path, snap_path.with_name(snap_path.name + ".quarantine")
                )
            except OSError:
                pass
            self._orphans_ok_boot = True
            return False
        chain = Chain.from_snapshot(
            self.config.difficulty, snap, retarget=self.config.retarget_rule()
        )
        chain.sig_cache = self.sig_cache
        if self.config.snapshot_interval > 0:
            chain.checkpoint_interval = self.config.snapshot_interval
        anchor = snap.block_hash
        for block in self.store.load_blocks():
            if block.block_hash() == anchor:
                continue
            # The node's own flocked log of blocks it validated while
            # ASSUMED: the same trusted-resume contract as the genesis
            # path (contextual rules + ledger still run).
            chain.add_block(block, trusted=True)
        self.chain = chain
        self.validation_state = ASSUMED
        self._snap_meta = snap.manifest
        if self.config.body_cache_blocks > 0:
            chain.body_source = self.store
        self.log.warning(
            "resumed in ASSUMED state from snapshot at height %d "
            "(tip %d) — background revalidation restarting",
            snap.height,
            chain.height,
        )
        return True

    def _prunebase_path(self):
        if self.config.store_path is None:
            return None
        return Path(f"{self.config.store_path}.prunebase")

    def _try_prunebase_resume(self) -> bool:
        """Resume a PRUNED node: history below the prune floor is gone
        from disk by policy, so the genesis resume cannot reconnect the
        surviving records — the ``.prunebase`` sidecar (this node's OWN
        snapshot of its validated state, written before each prune)
        anchors the chain at the prune base instead and the surviving
        segments replay on top.  Unlike a peer-served snapshot this
        boots VALIDATED: the state is ours, persisted under the writer
        lock, the same trust the trusted resume extends to the log.  A
        missing/corrupt sidecar degrades to ordinary IBD with
        ``orphans_ok`` (safe, just slower) — never a refused boot."""
        if getattr(self.store, "pruned_below", 0) <= 0:
            return False
        base_path = self._prunebase_path()
        if base_path is None or not base_path.exists():
            self._orphans_ok_boot = True
            return False
        try:
            snap = chain_snapshot.load_snapshot(base_path)
        except (OSError, SnapshotError) as e:
            self.log.error(
                "prune-base sidecar unreadable (%s) — quarantining; "
                "booting via ordinary IBD",
                e,
            )
            try:
                os.replace(
                    base_path,
                    base_path.with_name(base_path.name + ".quarantine"),
                )
            except OSError:
                pass
            self._orphans_ok_boot = True
            return False
        chain = Chain.from_snapshot(
            self.config.difficulty, snap, retarget=self.config.retarget_rule()
        )
        chain.assumed = False  # our own validated state, not a peer claim
        chain.sig_cache = self.sig_cache
        if self.config.snapshot_interval > 0:
            chain.checkpoint_interval = self.config.snapshot_interval
        anchor = snap.block_hash
        for block in self.store.iter_blocks():
            if block.block_hash() == anchor:
                continue
            chain.add_block(block, trusted=True)
        chain.prune_floor = self.store.pruned_below
        self.chain = chain
        if self.config.body_cache_blocks > 0:
            chain.body_source = self.store
        self.log.info(
            "resumed pruned chain base=%d tip=%d (bodies below %d "
            "discarded; headers in the segment plane)",
            snap.height,
            chain.height,
            self.store.pruned_below,
        )
        return True

    async def start(self) -> None:
        self._load_addr_book()
        self._orphans_ok_boot = False
        if self.store is not None:
            # Hold the store's writer lock for the node's whole lifetime
            # (not just from the first append): a second node on the same
            # store, or a compaction while we run, must fail loudly.
            self.store.acquire()
            if self._try_snapshot_resume():
                self._load_mempool()
                return await self._start_services()
            if self._try_prunebase_resume():
                self._load_mempool()
                return await self._start_services()
            body_cache = self.config.body_cache_blocks
            if body_cache > 0:
                # Memory-bounded resume: never materialize the whole
                # block list — the store streams records through
                # load_chain's eviction loop, so peak RSS is bounded by
                # the keep window.  The difficulty pre-check reads just
                # the first record's header.
                blocks = None
                held_difficulty = self.store.first_difficulty()
            else:
                blocks = self.store.load_blocks()
                held_difficulty = (
                    blocks[0].header.difficulty if blocks else None
                )
            if (
                held_difficulty is not None
                and held_difficulty != self.config.difficulty
            ):
                # Restarting with a different --difficulty would silently
                # reject every persisted record and interleave a second,
                # incompatible chain behind them.  Release the writer lock
                # before raising: an in-process retry with the corrected
                # difficulty must not find its own leaked flock.
                self.store.close()
                raise RuntimeError(
                    f"store {self.store.path} holds a difficulty-"
                    f"{held_difficulty} chain; node configured "
                    f"for {self.config.difficulty}"
                )
            # load_chain already routes every record through full add_block
            # validation, and keeps persisted side branches alive (store.py)
            # — adopt it wholesale instead of re-validating main_chain only.
            # Its none-connected guard (a store from a chain with different
            # parameters) surfaces as ValueError; close the store before
            # re-raising so a corrected in-process retry doesn't find its
            # own stale flock.
            try:
                self.chain = self.store.load_chain(
                    self.config.difficulty,
                    blocks,
                    retarget=self.config.retarget_rule(),
                    # Our own flocked log of blocks we already validated:
                    # fast resume by default (store.py's trust argument).
                    # A revalidation (trusted=False) runs through the
                    # batched signature fast lane against THIS node's
                    # verify-once cache.
                    trusted=not self.config.revalidate_store,
                    body_cache=body_cache,
                    sig_cache=self.sig_cache,
                    # A heal that quarantined records may have cut the
                    # log loose from genesis; the survivors park as
                    # orphans and the ordinary locator sync backfills
                    # the gap — refusing to boot here bricked crash
                    # recovery (found by the chaos sweep, node/chaos.py).
                    # Same relaxation when a quarantined SNAPSHOT sidecar
                    # left the store holding snapshot-descendant records
                    # with no genesis linkage (_try_snapshot_resume).
                    orphans_ok=self.store.healed["quarantined_records"] > 0
                    or self._orphans_ok_boot,
                )
            except ValueError as e:
                self.store.close()
                raise RuntimeError(str(e)) from e
            if self.config.snapshot_interval > 0:
                # The resume built a fresh Chain; re-apply the
                # checkpoint-cadence override (roots recorded at the
                # default cadence during the load stay — they are valid
                # commitments, just differently spaced).
                self.chain.checkpoint_interval = self.config.snapshot_interval
            if body_cache > 0:
                # Keep evicting as the chain grows past resume (the
                # governor loop sweeps; the source survives the resume).
                self.chain.body_source = self.store
            if self.chain.height:
                self.log.info(
                    "resumed chain height=%d tip=%s",
                    self.chain.height,
                    self.chain.tip_hash.hex()[:16],
                )
            # After the chain: admission validates against the ledger.
            self._load_mempool()
        await self._start_services()

    async def _start_services(self) -> None:
        """Everything after chain/mempool resume: the listener and the
        background loops — one tail shared by the genesis and snapshot
        resume paths."""
        self._running = True
        # The resume paths grew the chain with nobody subscribed; the
        # push plane promises events from NOW, not a replay of boot.
        self.subscriptions.reset_cursor()
        self._server = await self.transport.listen(
            self._on_inbound, self.config.host, self.config.port
        )
        self.port = self._server.port
        self.log.info("listening on %s:%d", self.config.host, self.port)
        for host, port in self.config.peer_addrs():
            self._tasks.append(asyncio.create_task(self._dial_loop(host, port)))
        if self.config.target_peers > 0:
            self._tasks.append(asyncio.create_task(self._discovery_loop()))
        if self.config.mempool_ttl_s > 0 or self.store is not None:
            # TTL expiry and/or the crash checkpoint: a persistent node
            # with expiry disabled still checkpoints its pool.
            self._tasks.append(asyncio.create_task(self._housekeeping_loop()))
        if self.config.sync_stall_timeout_s > 0:
            # Request supervision: progress deadlines + failover for
            # every multi-round fetch (0 disables, e.g. single-peer
            # tooling rigs that want no background re-requests).
            self._tasks.append(asyncio.create_task(self._supervision_loop()))
        # Set-reconciliation heartbeat, spawned UNCONDITIONALLY:
        # round initiation is gated per tick (operator switch + "txrecon"
        # deployment state), but the tick's bookkeeping half — aging out
        # silent rounds and GETTX-chasing diff ids a recon-ON peer
        # announced to us — must run even on a recon-off node, or a
        # straggler that answers sketches could book announced ids and
        # never fetch them.
        self._tasks.append(asyncio.create_task(self._recon_loop()))
        if (
            self.config.mem_watermark_bytes > 0
            or self.config.body_cache_blocks > 0
        ):
            # Overload governor tick: gauge observation (SHED
            # hysteresis) and the body-eviction sweep.  Skipped when
            # neither feature is configured — admission control and the
            # write-queue caps are inline and need no loop.
            self._tasks.append(asyncio.create_task(self._governor_loop()))
        if self.validation_state == ASSUMED:
            # A (re)boot in the ASSUMED state owes the network a finished
            # revalidation: restart the background lane immediately.
            self._bg_start()
        if self.config.mine:
            self.start_mining()

    async def stop(self) -> None:
        self._running = False
        # Stop the miner FIRST: stop_mining awaits the shielded final-block
        # handling while peer sessions are still alive, so a block sealed in
        # the last instant reaches peers before any connection is torn down.
        await self.stop_mining()
        # Cancel inbound session handlers along with our own tasks BEFORE
        # waiting on the server: Python 3.12's Server.wait_closed() blocks
        # until every connection handler returns, and handlers sit in
        # read_frame() indefinitely.
        pending = [*self._tasks, *self._sessions]
        for task in pending:
            task.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        self._tasks.clear()
        self._sessions.clear()
        for writer in list(self._peers):
            writer.close()
        self._peers.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._save_addr_book()
        if self._mempool_io is not None:
            # A cancelled housekeeping task cannot cancel its worker
            # THREAD: let any in-flight checkpoint write finish before
            # the authoritative shutdown save, or the stale file could
            # land second and roll back every admission since.
            await asyncio.gather(self._mempool_io, return_exceptions=True)
        # Drain the pipeline lanes: any store-lane job already submitted
        # (appends, prune sidecars, checkpoint writes) completes before
        # the synchronous shutdown writes below — stop() must never race
        # its own store worker for the flock.
        self.pipeline.drain_and_close()
        self._save_mempool()
        if self.store is not None:
            if self._store_pending:
                # Last chance: the disk may have recovered since the
                # failure; anything still unwritable is re-fetchable
                # from peers on the next start.
                self._store_flush()
            self.store.close()

    def start_mining(self) -> None:
        """Start the mining loop on a running node (idempotent)."""
        if self._running and self._mine_task is None:
            self._mine_task = asyncio.create_task(self._mine_loop())
            self._tasks.append(self._mine_task)

    async def stop_mining(self) -> None:
        """Stop the mining loop but keep the node gossiping (tests/CLI)."""
        if self._mine_task is not None:
            self._mine_task.cancel()
            self._abort_inflight_search()
            try:
                await self._mine_task
            except asyncio.CancelledError:
                pass
            except Exception:
                # A mine loop that already died of its own exception re-raises
                # it here; stop()/stop_mining() must still run the rest of
                # teardown (sessions, server socket, store).
                self.log.exception("mine task ended with error")
            if self._mine_task in self._tasks:
                self._tasks.remove(self._mine_task)
            self._mine_task = None
        # A block sealed in the final instant enters the chain and reaches
        # peers only once the shielded _post_seal task runs to completion —
        # cancelling the mine loop does not cancel it, and awaiting it here
        # is what guarantees callers observe a fully-propagated stop.
        await self._await_post_seal()

    async def _await_post_seal(self) -> None:
        if self._post_seal is not None:
            results = await asyncio.gather(
                self._post_seal, return_exceptions=True
            )
            self._post_seal = None
            for r in results:
                if isinstance(r, BaseException) and not isinstance(
                    r, asyncio.CancelledError
                ):
                    # Nothing else can surface a failure on this path (the
                    # mine loop is already gone) — don't lose it.
                    self.log.error("post-seal block handling failed: %r", r)

    # -- storage durability (degraded serve-only mode) --------------------

    async def _store_append(self, blocks) -> None:
        """Persist freshly accepted blocks — the STORE stage.  The
        append + fsync chain runs on the pipeline's store-writer lane
        (inline when staging is off), so the event loop never waits on
        the disk when a worker is configured; failure handling stays on
        the loop (``_store_fail`` touches asyncio state).

        A failing disk (ENOSPC, EIO, fsync error) degrades the NODE
        instead of unwinding the connection handler that happened to
        deliver the block — the fault is the disk's, never the peer's,
        and dropping the session would punish a healthy peer and
        reconnect-loop forever against the same full disk."""
        if self.store is None:
            return
        self._store_pending.extend(blocks)
        if not self._store_degraded:
            if await self._store_flush_staged(
                nbytes=sum(len(b.serialize()) for b in blocks)
            ):
                await self._maybe_prune()

    async def _store_flush_staged(self, nbytes: int = 0) -> bool:
        """Drain pending records via the store lane; True = caught up."""
        exc = await self.pipeline.run_store(self._store_flush_io, nbytes=nbytes)
        if exc is not None:
            self._store_fail(exc)
            return False
        return True

    def _store_flush(self) -> bool:
        """Synchronous drain (the shutdown path — stop() runs after the
        pipeline lanes closed, so the final flush is direct by design)."""
        exc = self._store_flush_io()
        if exc is not None:
            self._store_fail(exc)
            return False
        return True

    def _store_flush_io(self) -> OSError | None:
        """Pure IO: write every pending record in order; returns the
        failure instead of raising (it runs on the store lane, and the
        degradation machinery — supervisor spawns, asyncio.Event — must
        only ever run on the loop).  Reads of ``_store_pending`` and
        the chain index are GIL-atomic; the lane is single-threaded, so
        two drains never interleave."""
        while self._store_pending:
            block = self._store_pending[0]
            try:
                # The height hint feeds the segmented store's manifest
                # (height spans -> segments, what pruning consults); a
                # record the chain no longer indexes appends heightless.
                entry = self.chain._index.get(block.block_hash())
                self.store.append(
                    block, height=entry.height if entry else None
                )
            except OSError as e:
                return e
            self._store_pending.pop(0)
        return None

    async def _maybe_prune(self) -> None:
        """Pruned mode: discard body segments wholly below
        the prune floor — the older of (tip - prune_keep_blocks) and
        the latest snapshot-checkpoint height, so a pruned node can
        always still serve its newest snapshot's rollback window.
        Cheap when there is nothing to do (one pass over the manifest
        rows).  The decision and the ledger-state capture run ON-loop
        (they read live chain structures the loop mutates); the sidecar
        write + unlinks run on the store lane."""
        keep = self.config.prune_keep_blocks
        if keep <= 0 or self.store is None:
            return
        if getattr(self.store, "prune_below", None) is None:
            return  # single-file layout: nothing to discard per segment
        interval = self.chain.checkpoint_interval
        checkpoint = (self.chain.height // interval) * interval
        floor = min(self.chain.height - keep, checkpoint)
        if floor <= self.chain.prune_floor:
            return
        await self._prune_now(floor)

    async def _prune_now(self, floor: int) -> int:
        """The prune executor shared by the automatic policy above and
        the explicit ``online_prune`` maintenance command: durable
        prune-base sidecar first, then the segment unlinks, on the
        store lane.  Returns segments removed (0 when nothing qualifies
        or the store failed — a failure flips degraded mode)."""
        if not self.store.prunable_segments(floor):
            return 0
        # The prune-base sidecar FIRST, durably: our own validated
        # state at the latest checkpoint is what the next boot
        # anchors on once the history below it stops existing.
        state = self.chain.snapshot_state()
        if state is None:
            return 0
        s_height, s_block, balances, nonces, _root = state
        manifest, chunks = chain_snapshot.build_records(
            s_height, s_block, balances, nonces
        )
        result = await self.pipeline.run_store(
            self._prune_io, manifest, chunks, floor
        )
        if isinstance(result, OSError):
            self._store_fail(result)
            return 0
        if result:
            self.metrics.store_segments_pruned += result
            self.chain.prune_floor = self.store.pruned_below
            self.log.info(
                "pruned %d body segment(s) below height %d "
                "(headers retained)",
                result,
                self.store.pruned_below,
            )
        return result

    def _prune_io(self, manifest, chunks, floor) -> int | OSError:
        """Store-lane half of pruning: durable prune-base sidecar, then
        the segment unlinks.  Returns segments removed, or the failure."""
        try:
            base_path = self._prunebase_path()
            tmp = base_path.with_name(f"{base_path.name}.{os.getpid()}")
            chain_snapshot.write_snapshot(tmp, manifest, chunks)
            os.replace(tmp, base_path)
            fsync_dir(base_path.parent)
            return self.store.prune_below(floor)
        except OSError as e:
            return e

    # -- the always-on maintenance plane -----------------------

    async def _maintain(self, command) -> dict:
        """Execute one maintenance command (the GETMAINTAIN wire frame,
        driven by `p1 maintain`).  Refusals are ANSWERS — ``{"ok":
        false, "error": ...}`` — never dropped sessions or protocol
        violations: the whole point of the plane is that operating on a
        live node must not cost it connectivity.  One operation at a
        time (``_maintenance_busy``): rebase/prune/compact each assume
        the segment set is not shifting under them."""
        if not isinstance(command, dict):
            return {"ok": False, "error": "maintenance command must be an object"}
        op = command.get("op")
        if op == "status":
            return {"ok": True, **self.maintenance_report()}
        if op not in ("rebase", "prune", "compact"):
            return {"ok": False, "error": f"unknown maintenance op {op!r}"}
        if self._maintenance_busy is not None:
            return {
                "ok": False,
                "error": f"maintenance busy: {self._maintenance_busy}",
            }
        if self.validation_state != VALIDATED:
            return {
                "ok": False,
                "error": "chain is assumed: maintenance waits for revalidation",
            }
        if self._store_degraded:
            return {
                "ok": False,
                "error": "store degraded: maintenance needs a healthy disk",
            }
        keep = command.get("keep", self.chain.checkpoint_interval)
        if not isinstance(keep, int) or isinstance(keep, bool) or keep < 0:
            return {"ok": False, "error": "keep must be a non-negative integer"}
        self._maintenance_busy = op
        try:
            if op == "rebase":
                return await self.rebase(keep)
            if op == "prune":
                return await self.online_prune(keep)
            return await self.online_compact()
        finally:
            self._maintenance_busy = None

    async def rebase(self, keep: int) -> dict:
        """Live re-basing, leg (a) of the zero-downtime plane: advance
        the chain's base to the newest checkpoint at least ``keep``
        blocks below the tip WITHOUT restarting.  Ordering is the crash
        contract: the store half runs first and durably (seal the
        active segment, spill ``.hdrx``/``.sdx`` sidecars for every
        sealed segment, off-loop on the store lane), so by the time the
        in-RAM index forgets the deep history it is already servable
        and bootable from the sidecar planes — a kill between the two
        halves reboots as an un-rebased node with spare sidecars."""
        chain = self.chain
        interval = chain.checkpoint_interval
        target = ((chain.height - keep) // interval) * interval
        if target <= chain.base_height:
            return {
                "ok": False,
                "error": (
                    f"nothing to rebase: target {target} at or below "
                    f"base {chain.base_height}"
                ),
            }
        if target not in chain.state_checkpoints:
            return {
                "ok": False,
                "error": f"no state checkpoint at height {target}",
            }
        t0 = self.clock.monotonic()
        if self.store is not None and hasattr(self.store, "ensure_sidecars"):

            def _spill():
                try:
                    self.store.roll_segment()
                    return self.store.ensure_sidecars()
                except OSError as e:
                    return e

            spilled = await self.pipeline.run_store(_spill, offload=True)
            if isinstance(spilled, OSError):
                self._store_fail(spilled)
                return {"ok": False, "error": f"sidecar spill failed: {spilled}"}
        stats = chain.rebase(target)
        self.metrics.rebases += 1
        self.log.info(
            "rebased live: base %d -> %d, dropped %d block(s), "
            "freed ~%d bytes",
            stats["old_base"],
            stats["new_base"],
            stats["dropped_blocks"],
            stats["freed_bytes"],
        )
        return {
            "ok": True,
            "duration_s": round(self.clock.monotonic() - t0, 6),
            **stats,
        }

    async def online_prune(self, keep: int) -> dict:
        """Online pruning, half of leg (c): discard body segments
        wholly below min(tip - keep, latest checkpoint) on the LIVE
        node — the explicit-command twin of the automatic
        ``_maybe_prune`` policy, sharing its executor (and therefore
        its prune-base durability ordering) exactly."""
        if self.store is None or getattr(self.store, "prune_below", None) is None:
            return {"ok": False, "error": "online prune needs a segmented store"}
        chain = self.chain
        checkpoint = (
            chain.height // chain.checkpoint_interval
        ) * chain.checkpoint_interval
        floor = min(chain.height - keep, checkpoint)
        t0 = self.clock.monotonic()
        if floor <= chain.prune_floor:
            pruned = 0
        else:
            pruned = await self._prune_now(floor)
            if self._store_degraded:
                return {
                    "ok": False,
                    "error": self._store_last_error or "store failed during prune",
                }
        self.metrics.online_prunes += 1
        return {
            "ok": True,
            "segments_pruned": pruned,
            "floor": chain.prune_floor,
            "duration_s": round(self.clock.monotonic() - t0, 6),
        }

    async def online_compact(self) -> dict:
        """Online compaction, the other half of leg (c): rewrite dirty
        sealed segments without their dead (off-main-chain) records
        while the node keeps mining and serving.  Split exactly like
        pruning: the expensive half (read sealed bytes, build verified
        replacements under tmp names) runs off-loop on the store lane
        and never touches a live file; each swap then commits ON-loop
        between awaits — rename + span-table fixup as one synchronous
        step, so no reader can observe a half-swapped segment.  The
        drop set is only ever hashes this chain POSITIVELY indexes off
        its main chain — unknown records are kept (chain/tooling.py's
        rule), so online compaction can never widen data loss."""
        store = self.store
        if store is None or getattr(store, "plan_compaction", None) is None:
            return {"ok": False, "error": "online compact needs a segmented store"}
        chain = self.chain
        drop = {
            bhash
            for bhash, entry in chain._index.items()
            if chain.main_hash_at(entry.height) != bhash
        }
        t0 = self.clock.monotonic()

        def _plan():
            try:
                return store.plan_compaction(drop)
            except OSError as e:
                return e

        plans = await self.pipeline.run_store(_plan, offload=True)
        if isinstance(plans, OSError):
            self._store_fail(plans)
            return {"ok": False, "error": f"compaction planning failed: {plans}"}
        committed: list[int] = []
        dropped = 0
        for i, plan in enumerate(plans):
            try:
                n = store.commit_compacted_segment(plan)
            except OSError as e:
                # A failed swap degrades the store like any other write
                # fault; unswapped replacements are stale the moment it
                # recovers, so discard them all.
                store.discard_compaction(plans[i:])
                self._store_fail(e)
                return {"ok": False, "error": f"compaction commit failed: {e}"}
            if n:
                committed.append(plan["seg_id"])
                dropped += n
        if committed:

            def _refresh():
                try:
                    store.refresh_sidecars(committed)
                    store.flush_manifest()
                except OSError as e:
                    return e

            refreshed = await self.pipeline.run_store(_refresh, offload=True)
            if isinstance(refreshed, OSError):
                self._store_fail(refreshed)
                return {
                    "ok": False,
                    "error": f"post-compaction refresh failed: {refreshed}",
                }
            self.metrics.segments_compacted += len(committed)
            self.metrics.compaction_records_dropped += dropped
            self.log.info(
                "compacted %d segment(s) online, dropped %d dead record(s)",
                len(committed),
                dropped,
            )
        self.metrics.online_compactions += 1
        return {
            "ok": True,
            "segments_compacted": len(committed),
            "records_dropped": dropped,
            "duration_s": round(self.clock.monotonic() - t0, 6),
        }

    def maintenance_report(self) -> dict:
        """The maintenance plane's JSON surface — ``status()`` embeds
        it, and ``{"op": "status"}`` over GETMAINTAIN serves it alone.
        Fixed key set (tests/test_telemetry.py pins status keys)."""
        return {
            "busy": self._maintenance_busy,
            "rebases": self.metrics.rebases,
            "online_prunes": self.metrics.online_prunes,
            "online_compactions": self.metrics.online_compactions,
            "segments_compacted": self.metrics.segments_compacted,
            "compaction_records_dropped": (
                self.metrics.compaction_records_dropped
            ),
            "snapshot_incremental_builds": (
                self.metrics.snapshot_incremental_builds
            ),
            "snapshot_chunks_reused": self.metrics.snapshot_chunks_reused,
            "base_height": self.chain.base_height,
            "versionbits": {
                "window": self.versionbits.window,
                "threshold": self.versionbits.threshold,
                "deployments": self.versionbits.states_report(self.chain),
            },
        }

    async def _store_sync_staged(self) -> None:
        """Guarded batch-close fsync via the store lane (the BLOCKS
        resync path)."""
        if self.store is None or self._store_degraded:
            return
        exc = await self.pipeline.run_store(self._store_sync_io)
        if exc is not None:
            self._store_fail(exc)

    def _store_sync_io(self) -> OSError | None:
        try:
            self.store.sync()
        except OSError as e:
            return e
        return None

    def _store_fail(self, exc: OSError) -> None:
        self.metrics.store_errors += 1
        self._store_last_error = f"{type(exc).__name__}: {exc}"
        if self._store_degraded:
            return
        self._store_degraded = True
        self.log.error(
            "store write failed (%s) — entering degraded serve-only mode "
            "(%d records pending)",
            exc,
            len(self._store_pending),
        )
        # Stop chasing blocks we would only refuse: the in-flight sync
        # episode ends, the in-flight nonce search aborts (the mining
        # loop pauses itself while degraded).
        self._sync.idle()
        self._abort_inflight_search()
        if self.config.store_degraded_exit:
            # Escape hatch for operators who prefer a supervisor restart
            # to a degraded node: signal the CLI runner and stand down.
            self.log.critical(
                "store failed and --store-degraded-exit is set — "
                "signaling shutdown"
            )
            self.store_fatal.set()
            return
        if self._running:
            self._spawn_store_recovery()

    def _spawn_store_recovery(self) -> None:
        task = asyncio.create_task(self._store_recovery_loop())
        self._sessions[task] = None
        task.add_done_callback(self._store_recovery_done)

    def _store_recovery_done(self, task: asyncio.Task) -> None:
        """A recovery task that dies while the node is still degraded
        would strand it serve-only forever — ``_store_fail`` early-returns
        once degraded, so nothing else ever respawns the loop.  Surface
        the wreck and restart; the loop's own backoff (first await) keeps
        a persistent crash from spinning."""
        self._sessions.pop(task, None)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            return
        self.log.error("store recovery loop died: %r", exc)
        if self._running and self._store_degraded:
            self._spawn_store_recovery()

    async def _store_recovery_loop(self) -> None:
        """Retry the store under the RequestSupervisor backoff policy
        (jittered exponential, same knobs as sync failover) until writes
        succeed again, then leave degraded mode and backfill: the blocks
        refused at the door are re-fetched from peers via an ordinary
        locator sync — nothing was acknowledged, so nothing is owed."""
        sup = self._store_sup
        while self._running and self._store_degraded:
            retry_delay = sup.record_stall()
            self.telemetry.observe("store.retry_backoff_s", retry_delay)
            await asyncio.sleep(retry_delay)
            if not (self._running and self._store_degraded):
                return
            self.metrics.store_retries += 1
            # Disk retries ride the store lane too — the recovery probe
            # must not re-inline the very fsync chain the lane absorbed.
            if not await self._store_flush_staged():
                continue  # still failing: _store_fail counted it, back off
            # Prove durability, not just a buffered write.  (With an
            # empty pending list this can pass while the disk is
            # still full — the next real append re-degrades, which
            # is self-correcting.)
            exc = await self.pipeline.run_store(self._store_sync_io)
            if exc is not None:
                self.metrics.store_errors += 1
                self._store_last_error = f"{type(exc).__name__}: {exc}"
                continue
            self._store_degraded = False
            self._store_last_error = None
            self.metrics.store_recoveries += 1
            sup.attempts = 0
            sup.idle()
            self.log.warning(
                "store recovered — leaving degraded mode, backfilling "
                "blocks refused meanwhile"
            )
            await self.request_sync()
            return

    # -- untrusted snapshot sync (chain/snapshot.py) ------------

    def _snapshot_records(self):
        """(manifest payload, chunk payloads) for the latest checkpoint
        height, built lazily and cached until the checkpoint moves (or
        reorgs).  None while ASSUMED — a node must never relay state it
        has not itself validated — or when the chain is too short to
        hold a checkpoint."""
        if self.validation_state != VALIDATED:
            return None
        chain = self.chain
        height = (chain.height // chain.checkpoint_interval) * (
            chain.checkpoint_interval
        )
        if height <= chain.base_height:
            return None
        key = (height, chain.main_hash_at(height))
        if self._snapshot_cache is not None and self._snapshot_cache[0] == key:
            return self._snapshot_cache[1]
        state = chain.snapshot_state()
        if state is None:
            return None
        h, block, balances, nonces, root = state
        # Incremental build: re-encode only the accounts the
        # ledger touched since the LAST build — the pending residue
        # (accounts whose changes postdated the previous checkpoint)
        # plus everything applied/undone since.  A superset of the true
        # diff is always safe; missing an account would serve a stale
        # chunk, so the manifest root is cross-checked against the
        # chain's own checkpoint commitment below.
        self._snapshot_dirty |= chain.collect_dirty_accounts()
        manifest_payload, chunks, inc, reused = (
            chain_snapshot.build_records_incremental(
                self._snapshot_inc,
                h,
                block,
                balances,
                nonces,
                self._snapshot_dirty,
            )
        )
        built_root = chain_snapshot.parse_manifest(manifest_payload).state_root
        if built_root != root:
            # The incremental path disagreeing with the validated
            # checkpoint root means the dirty set missed an account —
            # a bug, but one that must cost a full rebuild, never a
            # lying snapshot on the wire.
            self.log.error(
                "incremental snapshot root mismatch at height %d; "
                "falling back to full rebuild",
                h,
            )
            manifest_payload, chunks, inc, reused = (
                chain_snapshot.build_records_incremental(
                    None, h, block, balances, nonces, set()
                )
            )
        self.metrics.snapshot_incremental_builds += 1
        self.metrics.snapshot_chunks_reused += reused
        self._snapshot_inc = inc
        # Accounts touched by blocks BEYOND this checkpoint were just
        # consumed from the dirty set but are not reflected in the
        # published state — they must stay dirty for the next build.
        try:
            self._snapshot_dirty = self._dirty_beyond(h)
        except OSError:
            # A body refetch failing (degraded store) only costs the
            # residue: the next build runs cold but correct.
            self._snapshot_inc = None
            self._snapshot_dirty = set()
        size = (
            len(manifest_payload)
            + sum(len(c) for c in chunks)
            # The build residue is retained state too: charge its
            # dominant parts (entry payloads + leaf hashes) to the same
            # gauge the served-snapshot cache rides.
            + sum(len(e) for e in inc.entries.values())
            + 32 * len(inc.leaves)
        )
        self._snapshot_cache = (key, (manifest_payload, chunks), size)
        return manifest_payload, chunks

    def _dirty_beyond(self, height: int) -> set[str]:
        """Accounts touched by main-chain blocks ABOVE ``height`` — the
        part of the ledger's dirty set a snapshot anchored AT ``height``
        does not capture.  O(blocks past the checkpoint), normally under
        one checkpoint interval; bodies may refetch from the store."""
        from p1_tpu_torch.chain.statedelta import block_accounts

        chain = self.chain
        out: set[str] = set()
        for hh in range(height + 1, chain.height + 1):
            bh = chain.main_hash_at(hh)
            if bh is None:
                continue
            out |= block_accounts(chain._block_at(bh))
        return out

    async def _request_snapshot(self, peer: _Peer) -> None:
        """Start a snapshot download from ``peer`` (manifest first).
        Supervised like every other multi-round fetch: stalls demote and
        fail over (``_check_snapshot_fetch``)."""
        self._snap_fetch = _SnapshotFetch(
            peer=peer, asked_at=self.clock.monotonic()
        )
        self.metrics.snapshot_fetches += 1
        self.log.info("requesting state snapshot from %s", peer.label)
        await self._send_guarded(peer, protocol.encode_getsnapshot(0, 0))

    def _validate_snapshot_manifest(self, manifest) -> None:
        """Cheap-to-check gates BEFORE any chunk round trips: the anchor
        block must carry real work (full stateless validation — the same
        PoW-before-state discipline as compact-block handling), and the
        claimed shape must be bounded.  Raises SnapshotError /
        ValidationError."""
        if manifest.height < 1:
            raise SnapshotError("snapshot at genesis height")
        if len(manifest.chunk_digests) > SNAPSHOT_MAX_CHUNKS:
            raise SnapshotError(
                f"{len(manifest.chunk_digests)} chunks exceeds the "
                f"{SNAPSHOT_MAX_CHUNKS} cap"
            )
        # On a retargeting chain the contextual difficulty of a deep
        # block is unknowable without the history (the very thing a
        # snapshot skips) — check PoW at the CLAIMED difficulty, like
        # orphan parking; the background revalidation re-checks it
        # contextually.  Difficulty 0 would pass vacuously.
        claimed = (
            manifest.block.header.difficulty
            if self.chain.retarget is not None
            else self.config.difficulty
        )
        if claimed < 1:
            raise SnapshotError("workless snapshot anchor")
        from p1_tpu_torch.chain.validate import check_block

        check_block(
            manifest.block,
            claimed,
            chain_tag=self.chain.genesis.block_hash(),
            sig_cache=self.sig_cache,
        )

    async def _snapshot_fetch_failed(
        self, peer: _Peer, reason: str, score: bool
    ) -> None:
        """Abandon the in-flight snapshot download.  ``score=True`` for
        integrity violations (bad digests, bad manifest — forgery,
        scorable); stalls stay unscored (slowness is not a violation).
        Either way the fetch fails over: another peer's snapshot if one
        qualifies, else ordinary genesis IBD — the node always has a
        trust-free path forward."""
        self._snap_fetch = None
        self.log.warning("snapshot fetch from %s failed: %s", peer.label, reason)
        if peer.writer in self._peers:
            peer.sync_demerits += 1
            self.metrics.sync_demotions += 1
        if score and peer.host:
            self._record_violation(peer.host)
        other = self._pick_sync_peer(exclude=peer)
        if other is not None and self._snapshot_worthwhile(other):
            await self._request_snapshot(other)
        elif other is not None:
            await self._request_blocks(other)
        elif peer.writer in self._peers:
            # Last peer standing: IBD from it validates everything, so
            # no trust is extended by falling back to ordinary sync.
            await self._request_blocks(peer)

    def _snapshot_worthwhile(self, peer: _Peer) -> bool:
        """Would a snapshot from ``peer`` beat ordinary IBD right now?"""
        return (
            self.config.snapshot_sync
            and self.config.sync_stall_timeout_s > 0
            and peer.is_node
            and self.validation_state == VALIDATED
            and self._snap_fetch is None
            and self._bg_chain is None
            and self.chain.height == 0
            and peer.hello_height - self.chain.height
            >= max(1, self.config.snapshot_min_lead)
        )

    async def _handle_snapshot(self, body, peer: _Peer) -> None:
        """One SNAPSHOT reply (manifest or chunk range) of an in-flight
        fetch.  Unsolicited frames are ignored; every byte verifies
        against the manifest as it arrives."""
        fetch = self._snap_fetch
        if fetch is None or fetch.peer is not peer:
            return
        now = self.clock.monotonic()
        if body[0] == "none":
            # The peer serves no snapshot (too short, or itself ASSUMED):
            # not a fault — fall back to ordinary sync with it.
            self._snap_fetch = None
            await self._request_blocks(peer)
            return
        if body[0] == "manifest":
            if fetch.manifest is not None:
                return  # duplicate
            try:
                manifest = chain_snapshot.parse_manifest(body[1])
                self._validate_snapshot_manifest(manifest)
            except (SnapshotError, ValidationError) as e:
                await self._snapshot_fetch_failed(
                    peer, f"bad manifest: {e}", score=True
                )
                return
            fetch.manifest = manifest
            fetch.asked_at = now
            await self._send_guarded(
                peer, protocol.encode_getsnapshot(0, SNAPSHOT_BATCH)
            )
            return
        # chunks
        if fetch.manifest is None:
            return  # chunks before the manifest: ignore
        _, start, chunks = body
        if start != len(fetch.chunks) or not chunks:
            return  # stale/duplicate range; supervision re-asks on stall
        digests = fetch.manifest.chunk_digests
        for payload in chunks:
            i = len(fetch.chunks)
            if i >= len(digests) or chain_snapshot.chunk_digest(
                payload
            ) != digests[i]:
                # Lying mid-transfer: caught on THIS chunk, before the
                # rest of the download is paid for.
                await self._snapshot_fetch_failed(
                    peer, f"chunk {i} fails its manifest digest", score=True
                )
                return
            fetch.chunks.append(payload)
        fetch.asked_at = now
        if len(fetch.chunks) < len(digests):
            await self._send_guarded(
                peer,
                protocol.encode_getsnapshot(len(fetch.chunks), SNAPSHOT_BATCH),
            )
            return
        try:
            snap = chain_snapshot.assemble(fetch.manifest, fetch.chunks)
        except SnapshotError as e:
            await self._snapshot_fetch_failed(peer, str(e), score=True)
            return
        self._snap_fetch = None
        await self._adopt_snapshot(snap, fetch.chunks, peer)

    async def _adopt_snapshot(self, snap, chunk_payloads, peer: _Peer) -> None:
        """Enter the ASSUMED state: swap the serving chain for one
        anchored on the verified snapshot, persist the sidecar, start
        the background revalidation, and catch up to the serving peer's
        tip.  The node serves balance/header/proof queries from this
        instant — that is the whole point — while trusting nothing
        beyond what it can still detect and undo."""
        if self.validation_state != VALIDATED or self._bg_chain is not None:
            return
        if snap.height <= self.chain.height:
            # An ordinary sync outran the download while it was in
            # flight — the validated chain is already past the snapshot,
            # so there is nothing left worth assuming.
            return
        chain = Chain.from_snapshot(
            self.config.difficulty, snap, retarget=self.config.retarget_rule()
        )
        chain.sig_cache = self.sig_cache
        if self.config.snapshot_interval > 0:
            chain.checkpoint_interval = self.config.snapshot_interval
        self.chain = chain
        self.validation_state = ASSUMED
        self._snap_meta = snap.manifest
        self._snap_source = peer.host
        self._abort_inflight_search()  # mining pauses while ASSUMED
        self.log.warning(
            "booted from snapshot: height=%d root=%s from %s — ASSUMED "
            "state, serving immediately; background revalidation starting",
            snap.height,
            snap.state_root.hex()[:16],
            peer.label,
        )
        snap_path = self._snapshot_path()
        if snap_path is not None:
            try:
                # Store lane: sidecar IO (write + fsync) is writer work.
                await self.pipeline.run_store(
                    chain_snapshot.write_snapshot,
                    snap_path,
                    chain_snapshot.encode_manifest(snap.manifest),
                    chunk_payloads,
                )
            except OSError as e:
                self.log.warning("could not persist snapshot sidecar: %s", e)
        # Reset the store onto the assumed layout (anchor + descendants):
        # any genesis-connected records an outrun ordinary sync already
        # persisted would otherwise leave a mixed log the resume cannot
        # interpret.  The history they held is re-fetched (and properly
        # revalidated) by the background lane anyway.
        await self.pipeline.run_store(self._rewrite_store, chain)
        if self.store is not None and self.config.body_cache_blocks > 0:
            chain.body_source = self.store
        self._bg_start()
        await self._request_blocks(peer)

    def _bg_start(self) -> None:
        """Arm the background revalidation: a second, genesis-anchored
        chain that replays the REAL history through the batched
        validation lane while the assumed chain serves.  The
        fetch itself is driven by ``_check_bg_sync`` ticks and the
        BLOCKS routing in ``_dispatch``."""
        if self._bg_chain is not None or self._snap_meta is None:
            return
        chain = Chain(
            self.config.difficulty, retarget=self.config.retarget_rule()
        )
        chain.sig_cache = self.sig_cache
        if self.config.snapshot_interval > 0:
            chain.checkpoint_interval = self.config.snapshot_interval
        # Pin the snapshot height as an explicit checkpoint so the
        # divergence comparison reads an exact-height root regardless of
        # how the serving node's interval relates to ours.
        chain.checkpoint_extra.add(self._snap_meta.height)
        self._bg_chain = chain

    async def _bg_request(self, peer: _Peer) -> None:
        if self._bg_chain is None:
            return
        self._bg_sup.begin(peer)
        await self._send_guarded(
            peer, protocol.encode_getblocks(self._bg_chain.locator())
        )

    async def _check_bg_sync(self) -> None:
        """Supervision tick for the background revalidation fetch: kick
        it when idle, demote + fail over when the serving peer stalls —
        the same progress-buys-the-slot contract as the main sync."""
        bg = self._bg_chain
        if bg is None:
            return
        sup = self._bg_sup
        if not sup.active:
            if not sup.ready():
                return  # backoff from the last stall still arming
            if sup.exhausted():
                sup.attempts = 0  # new episode after the cooldown
            peer = self._pick_sync_peer(exclude=self._bg_last_staller)
            if peer is not None:
                await self._bg_request(peer)
            return
        staller = sup.target
        gone = staller.writer not in self._peers
        if not (gone or sup.stalled()):
            return
        self.metrics.snapshot_stalls += 1
        if not gone:
            staller.sync_demerits += 1
            self.metrics.sync_demotions += 1
            self.log.warning(
                "background revalidation stalled on %s — failing over",
                staller.label,
            )
        self._bg_last_staller = staller
        sup.record_stall()  # arms the jittered backoff; next tick re-kicks
        # The unobtainable-history rule: the snapshot came with an
        # implicit promise that its history exists.  If the replay has
        # consumed everything every connected peer advertises and still
        # sits below the snapshot height, nobody can back the claim —
        # an unbackable snapshot is treated exactly like a lying one
        # (quarantine + fall back to the validated chain).  Advertised
        # heights are handshake-stale, so this only under-triggers: a
        # peer that has since grown past the snapshot height will push
        # its blocks and the replay resumes through the normal routes.
        meta = self._snap_meta
        if meta is not None and self._bg_chain is not None:
            peer_best = max(
                (
                    p.hello_height
                    for p in self._peers.values()
                    if p.is_node
                ),
                default=0,
            )
            if peer_best < meta.height and bg.height >= peer_best:
                await self._snapshot_diverged(
                    "snapshot history unobtainable: no connected peer "
                    "advertises the snapshot height"
                )

    async def _check_snapshot_fetch(self, now: float) -> None:
        """Supervision tick for an in-flight snapshot download."""
        fetch = self._snap_fetch
        if fetch is None:
            return
        deadline = self.config.sync_stall_timeout_s
        if (
            fetch.peer.writer in self._peers
            and now - fetch.asked_at <= deadline
        ):
            return
        self.metrics.snapshot_stalls += 1
        await self._snapshot_fetch_failed(
            fetch.peer, "snapshot transfer stalled", score=False
        )

    async def _check_bg_done(self) -> None:
        """The verdict: once the background chain's main chain crosses
        the snapshot height, compare — same block hash AND same state
        root means the snapshot told the truth (flip to VALIDATED);
        anything else means it lied (quarantine + fall back)."""
        bg, meta = self._bg_chain, self._snap_meta
        if bg is None or meta is None or bg.height < meta.height:
            return
        at = bg.main_hash_at(meta.height)
        if at is None:
            return
        if at == meta.block_hash:
            root = bg.state_checkpoints.get(meta.height)
            if root == meta.state_root:
                await self._snapshot_flip()
            else:
                await self._snapshot_diverged(
                    "replayed state root does not match the snapshot's claim"
                )
        else:
            await self._snapshot_diverged(
                "snapshot anchor block is not on the fully-validated chain"
            )

    async def _snapshot_flip(self) -> None:
        """ASSUMED → VALIDATED: the replayed history reproduced the
        snapshot's state root, so the background chain (which now holds
        the full validated history) becomes the serving chain, with the
        assumed chain's post-snapshot blocks transplanted on top.  The
        store is rewritten as a full genesis-first log and the sidecar
        removed — a later restart is an ordinary resume."""
        bg, assumed = self._bg_chain, self.chain
        self._bg_chain = None
        self._bg_sup.idle()
        for h in range(assumed.base_height + 1, assumed.height + 1):
            bh = assumed.main_hash_at(h)
            if bh is None:
                break
            bg.add_block(assumed._block_at(bh))
        self.chain = bg
        self.validation_state = VALIDATED
        self.metrics.snapshot_flips += 1
        self._snap_meta = None
        self._snap_source = None
        self.log.warning(
            "background revalidation CONFIRMED the snapshot — flipped to "
            "fully-validated at height %d",
            bg.height,
        )
        # The heaviest single blocking window in the old node (~seconds
        # at 100k blocks): the genesis-first store rewrite, now absorbed
        # by the store lane.  ``bg`` is already detached from serving
        # (self.chain points at it, but nothing mutates it until this
        # coroutine resumes), so the worker reads a quiescent chain.
        await self.pipeline.run_store(self._rewrite_store, bg)
        snap_path = self._snapshot_path()
        if snap_path is not None and snap_path.exists():
            try:
                os.unlink(snap_path)
            except OSError:
                pass  # stale sidecar; the next resume detects and drops it
        if self.store is not None and self.config.body_cache_blocks > 0:
            bg.body_source = self.store
        # Mining resumes on the next loop tick (the ASSUMED gate cleared);
        # one broadcast sync mops up anything gossip dropped meanwhile,
        # and one tip announce publishes the now-fully-backed chain —
        # peers that never saw the snapshot's branch can finally
        # orphan-backfill the WHOLE history from us.
        await self.request_sync()
        await self._announce_tip_now()

    async def _snapshot_diverged(self, reason: str) -> None:
        """The snapshot LIED (or its chain lost): quarantine the sidecar,
        demote + score the serving peer, and fall back to genesis IBD on
        the fully-validated background chain — which keeps serving
        headers and every other query throughout.  Never a crash, never
        silent acceptance."""
        bg = self._bg_chain
        self._bg_chain = None
        self._bg_sup.idle()
        self.metrics.snapshot_divergences += 1
        self.metrics.snapshot_fallbacks += 1
        self.log.error(
            "snapshot DIVERGED (%s) — quarantining it, demoting the "
            "serving peer, falling back to genesis IBD",
            reason,
        )
        snap_path = self._snapshot_path()
        if snap_path is not None and snap_path.exists():
            try:
                os.replace(
                    snap_path,
                    snap_path.with_name(snap_path.name + ".quarantine"),
                )
            except OSError as e:
                self.log.warning("could not quarantine snapshot sidecar: %s", e)
        host = self._snap_source
        if host:
            self._record_violation(host)
            for p in self._peers.values():
                if p.host == host:
                    p.sync_demerits += 1
                    self.metrics.sync_demotions += 1
        self._snap_meta = None
        self._snap_source = None
        self.chain = bg
        self.validation_state = VALIDATED
        await self.pipeline.run_store(self._rewrite_store, bg)
        if self.store is not None and self.config.body_cache_blocks > 0:
            bg.body_source = self.store
        await self.request_sync()
        # The fallback chain may carry MORE work than anything our peers
        # hold (the snapshot's branch was real blocks even if its state
        # claim lied): announce it once so the mesh can weigh it — fork
        # choice, not this node, decides.
        await self._announce_tip_now()

    async def _announce_tip_now(self) -> None:
        """Push the current tip to every peer once (the validation-state
        transitions' counterpart of the post-IBD ``_announce_tip``
        flag): receivers connect it or orphan-backfill the history —
        which this node, now holding a full genesis-connected chain,
        can serve end to end."""
        if self.chain.height == 0 or not self._peers:
            return
        payload, saved = self._block_gossip_payload(self.chain.tip)
        n = await self._gossip(payload)
        if saved and n:
            self.metrics.cblocks_sent += n
            self.metrics.cblock_bytes_saved += saved * n

    def _rewrite_store(self, chain: Chain) -> None:
        """Replace the store's contents with ``chain``'s main branch
        (the flip/fallback transition out of the ASSUMED store layout,
        where records hang off a snapshot anchor instead of genesis):
        tmp + atomic replace + directory fsync, then re-acquire and
        re-index.  A failure leaves the OLD store intact — the running
        chain is authoritative either way, and the next resume's
        sidecar logic sorts out whichever layout survived."""
        if self.store is None:
            return
        from p1_tpu_torch.chain.store import fsync_dir, save_chain

        path = self.store.path
        tmp = path.with_name(f"{path.name}.flip.{os.getpid()}")
        try:
            save_chain(chain, tmp)
            self.store.close()  # release the flock on the old inode
            os.replace(tmp, path)
            fsync_dir(path.parent)
            self.store.acquire()
            self.store.reindex_spans()
            self._store_pending.clear()
        except OSError as e:
            self.log.error(
                "store rewrite after the validation flip failed (%s) — "
                "keeping the previous layout; a restart will re-derive "
                "state from the sidecar",
                e,
            )
            try:
                if tmp.exists():
                    os.unlink(tmp)
                self.store.acquire()  # make sure the writer lock is back
            except OSError:
                pass

    # -- overload resilience (node/governor.py) ---------------------------

    def _memory_gauge(self) -> int:
        """The node's accounted memory: resident chain bodies + pending
        pool bytes + peer transport write buffers + the verify-once
        signature cache.  Deterministic and reversible (unlike OS RSS,
        which CPython's allocator rarely returns), so the SHED
        hysteresis can actually come back down when the pressure goes
        away."""
        write_buf = 0
        recon_entries = 0
        for peer in self._peers.values():
            transport = peer.writer.transport
            if transport is not None and not transport.is_closing():
                write_buf += transport.get_write_buffer_size()
            # Recon relay maps: bounded per peer, but bounded
            # is not free at MAX_PEERS x RECON_PENDING_MAX — ~36 bytes
            # per short-id->txid entry (int key + 32-byte txid).
            recon_entries += (
                len(peer.recon_pending)
                + len(peer.recon_window)
                + len(peer.recon_round)
                + len(peer.recon_served)
                + len(peer.recon_expect)
            )
        return (
            36 * recon_entries
            +
            self.chain.resident_body_bytes
            + getattr(self.mempool, "bytes_pending", 0)
            + write_buf
            + self.sig_cache.bytes_used
            # Serving-plane caches: bounded LRUs, but bounded
            # is not free — the gauge must see them or a proof/filter
            # query storm becomes untracked RAM under the watermark.
            + self.chain.proof_cache.bytes_used
            + self.chain.filter_index.bytes_used
            # Served-snapshot cache: one checkpoint's worth
            # of canonical state bytes, rebuilt per checkpoint.
            + (self._snapshot_cache[2] if self._snapshot_cache else 0)
            # Staged pipeline: bytes referenced by in-flight
            # lane jobs.  Queue growth on the validate/store lanes is
            # memory the loop has admitted but not yet retired — wiring
            # it here means back-pressure sheds at the front door
            # instead of letting worker queues balloon.
            + self.pipeline.queued_bytes
        )

    async def _governor_loop(self) -> None:
        """Gauge tick: feed the SHED state machine and run the body
        eviction sweep.  A quarter second bounds both detection latency
        under a flood and how far past the keep window the resident set
        can grow between sweeps."""
        while self._running:
            await asyncio.sleep(0.25)
            try:
                if self.config.body_cache_blocks > 0:
                    self.chain.evict_bodies(self.config.body_cache_blocks)
                if self.governor.observe(self._memory_gauge()):
                    if self.governor.shedding:
                        self.log.warning(
                            "overload: %d tracked bytes over the %d "
                            "watermark — SHED state (low-priority gossip "
                            "dropped, mining paused)",
                            self.governor.tracked_bytes,
                            self.governor.watermark_bytes,
                        )
                        # Stop burning CPU on a candidate we'd assemble
                        # under pressure; the loop pauses itself while
                        # shedding.
                        self._abort_inflight_search()
                    else:
                        self.log.warning(
                            "overload cleared: %d tracked bytes below the "
                            "low watermark — back to NORMAL",
                            self.governor.tracked_bytes,
                        )
            except Exception:
                # The governor must never die of one bad tick — it is
                # the layer that keeps overload survivable.
                self.log.exception("governor tick failed")

    # -- p2p ------------------------------------------------------------

    def _hello(self) -> bytes:
        return protocol.encode_hello(
            Hello(
                self.chain.genesis.block_hash(),
                self.chain.height,
                self.port or 0,
                self.instance_nonce,
            )
        )

    def _is_banned(self, host: str) -> bool:
        until = self._banned_until.get(host)
        if until is None:
            return False
        if self.clock.monotonic() >= until:
            del self._banned_until[host]
            return False
        return True

    def _record_violation(self, host: str) -> None:
        now = self.clock.monotonic()
        window = self._violations.setdefault(host, collections.deque())
        window.append(now)
        while window and now - window[0] > BAN_WINDOW_S:
            window.popleft()
        if len(window) >= BAN_SCORE_THRESHOLD:
            self._banned_until[host] = now + BAN_DURATION_S
            window.clear()
            self.log.warning(
                "banning %s for %.0fs after repeated protocol violations",
                host,
                BAN_DURATION_S,
            )
        # Keep the tracking itself bounded (it guards against hostile
        # input — it must not be a memory hole for address-cycling
        # attackers): prune stale entries first, oldest-arbitrary after.
        if len(self._violations) > MAX_TRACKED_HOSTS:
            cutoff = now - BAN_WINDOW_S
            self._violations = {
                h: w
                for h, w in self._violations.items()
                if w and w[-1] >= cutoff
            }
            while len(self._violations) > MAX_TRACKED_HOSTS:
                del self._violations[next(iter(self._violations))]
        if len(self._banned_until) > MAX_TRACKED_HOSTS:
            self._banned_until = {
                h: u for h, u in self._banned_until.items() if u > now
            }
            while len(self._banned_until) > MAX_TRACKED_HOSTS:
                del self._banned_until[next(iter(self._banned_until))]

    async def _on_inbound(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peername = writer.get_extra_info("peername")
        if peername and self._is_banned(peername[0]):
            # Refused before any handshake work: a banned flooder costs us
            # one accept + close, nothing more.
            writer.close()
            return
        if self._handshaking >= MAX_HANDSHAKING:
            # Accept-flood guard: sockets that haven't proven anything yet
            # may hold at most MAX_HANDSHAKING session slots between them.
            # Cost of refusal: one accept + close.
            writer.close()
            return
        task = asyncio.current_task()
        assert task is not None
        self._sessions[task] = None
        try:
            await self._peer_session(reader, writer, "in", inbound=True)
        finally:
            self._sessions.pop(task, None)

    async def _dial_loop(self, host: str, port: int) -> None:
        """Keep one outbound connection to a configured peer alive."""
        while self._running:
            try:
                reader, writer = await self.transport.connect(host, port)
            except OSError:
                await asyncio.sleep(RECONNECT_DELAY_S)
                continue
            await self._peer_session(
                reader, writer, f"out:{host}:{port}", dial_addr=(host, port)
            )
            await asyncio.sleep(RECONNECT_DELAY_S)

    async def _dial_once(self, host: str, port: int) -> None:
        """One discovery-driven connection attempt (no retry loop: the
        discovery loop re-evaluates the address book every tick, so a
        failed or rejected dial is simply superseded)."""
        try:
            try:
                reader, writer = await asyncio.wait_for(
                    self.transport.connect(host, port), timeout=5.0
                )
            except (OSError, asyncio.TimeoutError):
                # Unreachable: demote/forget (a live peer's ADDR gossip
                # re-teaches it if it comes back; a tried entry survives
                # one failure as a rumor rather than vanishing).
                self._demote_addr((host, port))
                return
            registered = await self._peer_session(
                reader, writer, f"disc:{host}:{port}", dial_addr=(host, port)
            )
            if not registered:
                # Accepted TCP but failed the handshake (wrong chain,
                # version skew, peer full, ourselves): demote/forget, or
                # the next tick redials the same dead end forever and
                # starves every other candidate in the book.  (A self-
                # connect already erased the address inside the session —
                # demote leaves absent entries absent.)
                self._demote_addr((host, port))
        finally:
            self._dialing.discard((host, port))

    async def _discovery_loop(self) -> None:
        """Dial learned addresses until ``target_peers`` connections hold
        (the gossip network's discovery half: one seed peer
        bootstraps the rest)."""
        last_readdr = 0.0
        while self._running:
            await asyncio.sleep(DISCOVERY_INTERVAL_S)
            # Count node peers only: a long-lived wallet/monitoring client
            # (no advertised address) must not satisfy the target and
            # suppress dialing the real network.
            node_peers = [
                p for p in self._peers.values() if p.addr is not None
            ]
            deficit = self.config.target_peers - len(node_peers)
            if deficit <= 0:
                continue
            # "Connected" covers both spellings of a live peer (its
            # advertised addr AND whatever alias we dialed), and the
            # configured peers are excluded outright — their _dial_loop
            # owns them (including mid-handshake windows where no peer is
            # registered yet).
            connected = {p.addr for p in node_peers}
            connected |= {
                p.dial_addr
                for p in self._peers.values()
                if p.dial_addr is not None
            }
            connected |= set(self.config.peer_addrs())
            started = 0
            # Handshake-verified addresses first: an attacker who filled
            # the gossip book cannot redirect the next dials away from
            # nodes we have actually spoken to.
            for addr in [*self._tried_addrs, *self._known_addrs]:
                if deficit <= started:
                    break
                if addr in connected or addr in self._dialing:
                    continue
                if self._is_banned(addr[0]):
                    continue  # don't court a host we're refusing
                self._dialing.add(addr)
                task = asyncio.create_task(self._dial_once(*addr))
                self._sessions[task] = None
                task.add_done_callback(self._untrack_session)
                started += 1
            now = self.clock.monotonic()
            if (
                started == 0
                and self._peers
                and now - last_readdr >= READDR_INTERVAL_S
            ):
                # Under target with nothing new to dial: periodically ask
                # the peers we DO have for more addresses (new nodes may
                # have joined since the handshake-time GETADDR).  Rate-
                # limited — a node whose target exceeds the network size
                # would otherwise chatter GETADDR every tick forever.
                last_readdr = now
                # Re-ask outbound peers only, crediting each reply —
                # same reasoning as the handshake-time GETADDR: inbound
                # connections must never be able to induce a grant.
                outbound = [
                    p
                    for p in self._peers.values()
                    if p.dial_addr is not None
                ]
                for p in outbound:
                    if p.host:
                        self._addr_budget(p.host, grant=True)
                if outbound:
                    payload = protocol.encode_getaddr()
                    await asyncio.gather(
                        *(self._send_guarded(p, payload) for p in outbound)
                    )

    async def _housekeeping_loop(self) -> None:
        """Periodic pool hygiene: expire transactions that have sat
        unmineable past the configured TTL (mempool.expire)."""
        ttl = self.config.mempool_ttl_s
        interval = max(1.0, min(30.0, ttl / 4)) if ttl > 0 else 30.0
        while self._running:
            await asyncio.sleep(interval)
            if ttl > 0:
                dropped = self.mempool.expire(ttl)
                if dropped:
                    self.log.info(
                        "expired %d stale mempool transactions", dropped
                    )
            # Periodic checkpoint so a crash (not just a clean stop)
            # loses at most one interval's worth of admissions.
            await self._checkpoint_mempool()

    # -- request supervision (sync-stall failover) -----------------------

    async def _request_blocks(self, peer: _Peer) -> None:
        """Issue a supervised locator sync request to ``peer``: the
        progress deadline (re)arms and the supervisor records who to
        blame if nothing lands.  Every GETBLOCKS the node sends to a
        single chosen peer goes through here — the quiesce-time
        ``request_sync`` broadcast is the one exception (it asks
        everyone at once, so there is no staller to supervise)."""
        if self._store_degraded:
            return  # serve-only: don't solicit blocks we would refuse
        if self._snap_fetch is not None:
            # A snapshot download is in flight: replaying history in
            # parallel would just race the download to the tip and waste
            # both (the failure path re-solicits blocks explicitly).
            return
        self._sync.begin(peer)
        await self._send_guarded(
            peer, protocol.encode_getblocks(self.chain.locator())
        )

    async def _request_mempool(
        self, peer: _Peer, cursor: tuple[int, bytes] | None = None
    ) -> None:
        """Issue a supervised mempool (page) request to ``peer``."""
        peer.mempool_requested = True
        peer.mempool_inflight_since = self.clock.monotonic()
        if (
            cursor is None
            and self._recon_enabled()
            and self._recon_peer_active(peer, self.clock.monotonic())
        ):
            # Initial pool sync rides the reconciliation plane when the
            # link supports it: the next tick runs a FULL-pool round
            # (both sides sketch everything they have), so two mostly-
            # overlapping pools cost one sketch exchange instead of
            # re-shipping the whole pool page by page.  The in-flight
            # stamp above keeps ``_check_mempool_sync`` as the safety
            # net either way, and a failed round falls back to classic
            # cursor paging (never a whole-pool flood).
            peer.recon_full_pending = True
            return
        await self._send_guarded(peer, protocol.encode_getmempool(cursor))

    def _pick_sync_peer(self, exclude: _Peer | None = None) -> _Peer | None:
        """The best peer to re-ask: node peers only (a tooling client
        ignores GETBLOCKS), fewest demerits first, taller advertised
        tips breaking ties.  Falls back to the excluded staller itself
        when it is the only peer left — with jittered backoff and a
        bounded attempt budget, retrying the sole source beats giving
        up."""
        candidates = [
            p
            for p in self._peers.values()
            if p.is_node and p is not exclude
        ]
        if not candidates:
            if exclude is not None and exclude.writer in self._peers:
                return exclude
            return None
        return min(
            candidates, key=lambda p: (p.sync_demerits, -p.hello_height)
        )

    async def _supervision_loop(self) -> None:
        """Progress deadlines for every supervised fetch (supervision.py).
        One poll loop rather than a timer per request: all request state
        lives on the event loop anyway, and a tick at a quarter of the
        stall deadline bounds detection latency at ~1.25x the deadline
        without growing a task per in-flight fetch."""
        interval = max(0.05, self.config.sync_stall_timeout_s / 4)
        while self._running:
            await asyncio.sleep(interval)
            now = self.clock.monotonic()
            try:
                await self._check_block_sync()
                await self._check_pending_cblocks(now)
                await self._check_mempool_sync(now)
                await self._check_snapshot_fetch(now)
                await self._check_bg_sync()
            except Exception:
                # The supervisor must never die of one bad tick — it is
                # the layer that un-wedges everything else.
                self.log.exception("request supervision tick failed")

    async def _check_block_sync(self) -> None:
        """The tentpole deadline: an in-flight locator sync that has
        advanced the chain by nothing within ``sync_stall_timeout_s``
        (or whose serving peer disconnected outright) is re-issued to a
        different eligible peer; the staller is demoted, never banned."""
        sup = self._sync
        if not sup.active:
            return
        staller = sup.target
        gone = staller.writer not in self._peers
        if not (gone or sup.stalled()):
            return
        self.metrics.sync_stalls += 1
        if not gone:
            staller.sync_demerits += 1
            self.metrics.sync_demotions += 1
            self.log.warning(
                "sync stall: %s advanced nothing in %.1fs — demoting "
                "and failing over",
                staller.label,
                sup.stall_timeout_s,
            )
        if sup.exhausted():
            # Budget spent on consecutive no-progress failovers: stop
            # chasing until something new triggers a sync (fresh HELLO,
            # orphan, compact push) — which also starts a fresh budget.
            self.metrics.sync_exhausted += 1
            sup.attempts = 0
            sup.idle()
            self.log.warning(
                "sync failover budget exhausted (%d attempts); waiting "
                "for a fresh trigger",
                sup.attempts_max,
            )
            return
        delay = sup.record_stall()
        # Supervision timing: the jittered backoff each stall armed —
        # with the stall deadline itself, the latency a starved sync
        # episode pays before its failover lands.
        self.telemetry.observe("sync.backoff_s", delay)
        task = asyncio.create_task(self._failover_blocks(staller, delay))
        self._sessions[task] = None
        task.add_done_callback(self._untrack_session)

    async def _failover_blocks(self, staller: _Peer, delay: float) -> None:
        """After the jittered backoff, re-issue the locator to the best
        non-stalling peer (selection deferred to AFTER the sleep — the
        peer set may have changed meanwhile)."""
        await asyncio.sleep(delay)
        if not self._running:
            return
        candidate = self._pick_sync_peer(exclude=staller)
        if candidate is None:
            # Nobody connected to ask: the dial/discovery loops own
            # reconnection, and a fresh handshake restarts the sync.
            return
        self.metrics.sync_failovers += 1
        self.log.info(
            "sync failover: re-issuing locator to %s", candidate.label
        )
        await self._request_blocks(candidate)

    async def _check_pending_cblocks(self, now: float) -> None:
        """A GETBLOCKTXN round trip that outlives the stall deadline is
        abandoned: the reconstruction is dropped, the silent peer
        demoted, and the block recovered through ordinary supervised
        locator sync — a compact push must never be the only way a
        block can arrive (the FIFO cap alone left stranded entries
        squatting until MAX_PENDING_CBLOCKS newer pushes evicted
        them)."""
        deadline = self.config.sync_stall_timeout_s
        stale = [
            key
            for key, pending in self._pending_cblocks.items()
            if now - pending.asked_at > deadline
        ]
        if not stale:
            return
        last_staller = None
        for key in stale:
            del self._pending_cblocks[key]
            bhash, peer = key
            self.metrics.cblock_fetch_stalls += 1
            if peer.writer in self._peers:
                peer.sync_demerits += 1
                self.metrics.sync_demotions += 1
            last_staller = peer
            self.log.warning(
                "GETBLOCKTXN to %s stalled %.1fs — dropping "
                "reconstruction of %s, recovering via locator sync",
                peer.label,
                deadline,
                bhash.hex()[:16],
            )
        candidate = self._pick_sync_peer(exclude=last_staller)
        if candidate is not None:
            self.metrics.sync_failovers += 1
            await self._request_blocks(candidate)

    async def _check_mempool_sync(self, now: float) -> None:
        """A mempool page request with no MEMPOOL reply inside the
        deadline: stop waiting on that peer (demote) and solicit the
        pool from one other idle peer — pools overlap heavily, so any
        honest peer recovers most of what the staller withheld."""
        deadline = self.config.sync_stall_timeout_s
        for peer in list(self._peers.values()):
            since = peer.mempool_inflight_since
            if since is None or now - since <= deadline:
                continue
            peer.mempool_inflight_since = None
            self.metrics.mempool_sync_stalls += 1
            peer.sync_demerits += 1
            self.metrics.sync_demotions += 1
            self.log.warning(
                "mempool sync with %s stalled %.1fs — asking another "
                "peer",
                peer.label,
                deadline,
            )
            other = self._pick_sync_peer(exclude=peer)
            if (
                other is not None
                and other is not peer
                and other.mempool_inflight_since is None
            ):
                await self._request_mempool(other)

    def _learn_addr(self, addr: tuple[str, int], tried: bool = False) -> None:
        """Merge one address into the bounded book (refreshes recency).
        ``tried`` promotes it to the handshake-verified bucket, where
        gossip-driven churn can never reach it."""
        if tried:
            self._known_addrs.pop(addr, None)
            self._tried_addrs.pop(addr, None)
            self._tried_addrs[addr] = self.clock.monotonic()
            while len(self._tried_addrs) > MAX_TRIED_ADDRS:
                self._tried_addrs.popitem(last=False)
            return
        if addr in self._tried_addrs:
            return  # already known-good; gossip cannot demote it
        self._known_addrs.pop(addr, None)
        self._known_addrs[addr] = self.clock.monotonic()
        while len(self._known_addrs) > MAX_KNOWN_ADDRS:
            self._known_addrs.popitem(last=False)

    def _forget_addr(self, addr: tuple[str, int]) -> None:
        """Drop an address from both buckets (dead, or ourselves)."""
        self._known_addrs.pop(addr, None)
        self._tried_addrs.pop(addr, None)

    def _demote_addr(self, addr: tuple[str, int]) -> None:
        """One failed dial: a tried address loses its protected status
        but stays as a rumor (a real node may be mid-restart — exactly
        when an eclipse attacker wants it erased for good); an unproven
        one is forgotten outright.  An address absent from both buckets
        (e.g. already dropped as a self-connect) stays absent."""
        if self._tried_addrs.pop(addr, None) is not None:
            self._learn_addr(addr)  # back to the gossip book
        else:
            self._known_addrs.pop(addr, None)

    def _addr_budget(self, host: str, grant: bool = False) -> list[float]:
        """The host's refilled ADDR token bucket ([tokens, last_refill]).
        ``grant`` ADDS one reply's worth of credit (bounded) — used when
        WE solicit with a GETADDR, so each reply we ask for fits the
        budget even when several outbound peers share one host (the
        localhost mesh).  Grants are additive rather than set-to-max
        because two same-host solicited replies would otherwise race for
        a single refill; safe because only our own outbound dials can
        trigger a grant, never an inbound peer."""
        now = self.clock.monotonic()
        bucket = self._addr_budgets.get(host)
        if bucket is None:
            bucket = self._addr_budgets[host] = [ADDR_TOKENS_MAX, now]
            if len(self._addr_budgets) > MAX_TRACKED_HOSTS:
                # Drop only buckets that are BOTH stale and sitting at
                # exactly the base refill — those provably carry no
                # state (they equal what a fresh create would mint).
                # Everything else is information: recent activity, spent
                # budget mid-window, and above all tokens ABOVE the cap,
                # which are solicited-reply credit granted to an
                # outbound peer — clawing that back mid-reply would
                # silently ignore part of an ADDR answer we asked for
                # (the old `< ADDR_TOKENS_MAX` filter did
                # exactly that).
                refill_s = ADDR_TOKENS_MAX / ADDR_TOKENS_RATE
                cutoff = now - refill_s
                self._addr_budgets = {
                    h: b
                    for h, b in self._addr_budgets.items()
                    if b[1] >= cutoff or b[0] != ADDR_TOKENS_MAX
                }
                self._addr_budgets.setdefault(host, bucket)
                while len(self._addr_budgets) > MAX_TRACKED_HOSTS:
                    del self._addr_budgets[next(iter(self._addr_budgets))]
        elif grant:
            bucket[0] = min(4 * ADDR_TOKENS_MAX, bucket[0] + ADDR_TOKENS_MAX)
            bucket[1] = now
        else:
            if bucket[0] < ADDR_TOKENS_MAX:
                # Trickle refill toward the base cap; never claw back
                # grant credit sitting above it.
                bucket[0] = min(
                    ADDR_TOKENS_MAX,
                    bucket[0] + (now - bucket[1]) * ADDR_TOKENS_RATE,
                )
            bucket[1] = now
        return bucket

    async def _peer_session(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        label: str,
        dial_addr: tuple[str, int] | None = None,
        inbound: bool = False,
    ) -> bool:
        """Run one peer session to completion.  Returns whether the peer
        ever completed the handshake and registered — False means the
        address is not worth redialing (discovery forgets it).

        Liveness contract (the layer every Bitcoin-family node carries):
        the HELLO must arrive within ``handshake_timeout_s``; after that a
        peer silent for ``ping_interval_s`` is probed with a PING and gets
        ``pong_timeout_s`` more to show ANY frame before eviction.  So a
        socket can hold one of the MAX_PEERS slots only while provably
        alive, and a pre-handshake socket (counted in ``_handshaking``)
        for at most the handshake window."""
        peer = _Peer(writer, label, self.metrics)
        peer.dial_addr = dial_addr
        peer.budget = self.governor.budget()
        registered = False
        # All session reads go through one FrameReader: timeouts cancel
        # reads at arbitrary awaits, and only a reader that keeps partial
        # progress itself can resume at the same stream position (a plain
        # read_frame cancelled between length prefix and body would desync
        # the stream and mis-score the peer).
        frames = protocol.FrameReader(reader, clock=self.clock.monotonic)
        if inbound:
            self._handshaking += 1
        try:
            if len(self._peers) >= MAX_PEERS:
                raise _Refused(f"peer limit {MAX_PEERS} reached")
            # Height at the moment our HELLO leaves: if the chain moves
            # during the handshake round trip, the advertisement below
            # is stale and must be corrected (see the tip push after
            # registration).
            hello_sent_height = self.chain.height
            await peer.send(self._hello())
            # Deadline on the whole HELLO read: a socket that connects and
            # goes quiet must not hold resources past this window.  A
            # TimeoutError lands in TimeoutError ⊂ OSError below — reaped,
            # not scored (slowness is not a protocol violation).
            payload = await asyncio.wait_for(
                frames.read(), timeout=self.config.handshake_timeout_s
            )
            self.metrics.bytes_received += len(payload) + 4
            mtype, hello = protocol.decode(payload)
            if mtype is not MsgType.HELLO:
                raise protocol.ProtocolError("expected HELLO")
            if hello.genesis_hash != self.chain.genesis.block_hash():
                raise protocol.ChainMismatch("genesis mismatch")
            if hello.nonce and hello.nonce == self.instance_nonce:
                # We dialed our own listening address (the book can learn
                # it from peers' ADDR gossip) — drop it for good.
                if dial_addr is not None:
                    self._forget_addr(dial_addr)
                raise _Refused("connected to self")
            if len(self._peers) >= MAX_PEERS:
                # Re-check at registration: the pre-handshake check above
                # races across the two awaits (a flood of simultaneous
                # dials all pass it while _peers is still small).
                raise _Refused(f"peer limit {MAX_PEERS} reached")
            self._peers[writer] = peer
            registered = True
            if inbound:
                self._handshaking -= 1
                inbound = False  # the finally below must not double-count
            self.log.info("peer %s connected (their height %d)", label, hello.tip_height)
            peer.hello_height = hello.tip_height
            peer.is_node = bool(hello.nonce)  # 0 = one-shot tooling client
            if hello.nonce:
                # Pairwise short-id salt for set reconciliation: both
                # ends derive the identical value from the sorted nonce
                # pair, so sketches agree without any extra negotiation.
                # Derived unconditionally (even with recon disabled): a
                # recon-off node still ANSWERS REQRECON with a sketch of
                # what it has, keeping straggler meshes correct.
                peer.recon_salt = reconcile.pair_salt(
                    self.instance_nonce, hello.nonce
                )
            if hello.listen_port:
                # The peer's claimed reachable address: its socket host +
                # the listen port it advertised.  NOT promoted to tried —
                # the port is self-claimed and unverified, and an inbound
                # attacker completing 256 cheap HELLOs with rotating port
                # claims would otherwise flush the whole tried bucket.
                # Charged against the same per-host ADDR budget as gossip:
                # a reconnect loop claiming a new port each time is just
                # an ADDR flood spelled differently.
                peername = writer.get_extra_info("peername")
                if peername:
                    peer.addr = (peername[0], hello.listen_port)
                    bucket = self._addr_budget(peername[0])
                    if bucket[0] >= 1.0:
                        bucket[0] -= 1.0
                        self._learn_addr(peer.addr)
            if dial_addr is not None:
                # Tried promotion is outbound-only (Bitcoin's rule, for
                # Bitcoin's reason): WE dialed this exact address and a
                # real node answered — that is verified reachability,
                # which no inbound claim can counterfeit.
                self._learn_addr(dial_addr, tried=True)
            if hello.nonce and dial_addr is not None:
                # Solicit addresses on OUTBOUND connections only
                # (Bitcoin's rule): an inbound attacker could otherwise
                # induce the ask and ride the solicited budget grant to
                # flush the gossip book by reconnecting.  We control the
                # dial rate, so the grant is attacker-independent.
                if peer.host:
                    self._addr_budget(peer.host, grant=True)
                await peer.send(protocol.encode_getaddr())
            if peer.is_node and self.chain.height > hello_sent_height:
                # The chain moved while the handshake was in flight, so
                # the height we advertised is stale and the peer may
                # have (correctly, on its information) decided not to
                # sync from us.  Push the current tip once: the peer
                # connects it or orphan-backfills through ordinary
                # locator sync.  Without this, a block that lands
                # during the handshake RTT is never advertised on the
                # new link at all — on a WAN-latency simulated mesh,
                # every cross-region link formed during one block's
                # propagation window went dark this way and a region
                # mined a competing fork (node/netsim.py found it; a
                # ~100 ms race real-socket tests never hit).
                payload, _saved = self._block_gossip_payload(self.chain.tip)
                await self._send_guarded(peer, payload)
            if self._snapshot_worthwhile(peer):
                # Fresh node, far-ahead peer, snapshot sync enabled:
                # fetch a state snapshot instead of replaying history —
                # boot-from-snapshot in seconds, with the robustness
                # contract (verify, ASSUME, revalidate, flip-or-
                # quarantine) carried by the snapshot plane above.
                await self._request_snapshot(peer)
            elif hello.tip_height > self.chain.height:
                # Blocks first, mempool after: the BLOCKS handler requests
                # the pool once our chain reaches the advertised height,
                # so admission's affordability check runs against a
                # caught-up ledger.  Supervised: a peer that advertises a
                # taller tip and then starves the sync is failed over
                # within the progress deadline (_check_block_sync).
                await self._request_blocks(peer)
            else:
                # Learn the peer's pending transactions too: block sync
                # alone would leave a late joiner's pool empty until fresh
                # gossip.
                await self._request_mempool(peer)
            ping_pending = False
            while self._running:
                # Idle probing: wait ping_interval_s for traffic; on
                # silence send one PING and allow pong_timeout_s more.
                # ANY frame proves liveness (resets the probe) — the PONG
                # itself is never specifically required, so a peer busy
                # streaming sync batches is never penalized for not
                # answering promptly.  Byte-level progress counts too: a
                # peer trickling one large frame over a slow link shows
                # ``frames.progressed()`` at each timeout and is left
                # alone — only true silence is probed and evicted.
                timeout = (
                    self.config.pong_timeout_s
                    if ping_pending
                    else self.config.ping_interval_s
                )
                try:
                    payload = await asyncio.wait_for(
                        frames.read(), timeout=timeout
                    )
                except (TimeoutError, asyncio.TimeoutError):
                    # Both spellings: asyncio.TimeoutError only became the
                    # builtin in Python 3.11; on 3.10 a bare TimeoutError
                    # would miss it and the probe path would never run.
                    grace = (
                        self.config.ping_interval_s
                        + self.config.pong_timeout_s
                    )
                    if frames.progressed() and not frames.overdue(grace):
                        ping_pending = False  # flowing, just slowly
                        continue
                    # Overdue trickle falls through to the probe path: one
                    # more PING + pong_timeout, then eviction — same reap,
                    # no misbehavior score (slowness is not a violation).
                    if ping_pending:
                        self.metrics.peers_evicted_idle += 1
                        raise _Refused(
                            f"peer idle past keepalive deadline "
                            f"({self.config.ping_interval_s:.0f}s + "
                            f"{self.config.pong_timeout_s:.0f}s probe)"
                        ) from None
                    ping_pending = True
                    self.metrics.pings_sent += 1
                    await self._send_guarded(
                        peer, protocol.encode_ping(self.instance_nonce)
                    )
                    continue
                ping_pending = False
                self.metrics.bytes_received += len(payload) + 4
                await self._dispatch(peer, payload)
        except (
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,  # pre-3.11: not an OSError subclass
            ConnectionError,
            ValueError,
            OSError,
            _Refused,
        ) as e:
            self.log.info("peer %s closed: %s", label, e)
            if isinstance(e, protocol.ProtocolError) and not isinstance(
                e, protocol.ChainMismatch
            ):
                # Peer-side protocol violation (malformed frame, bad
                # handshake bytes) — score it; repeat offenders get
                # refused at accept time for a cooldown.  Plain
                # ValueErrors stay unscored (they can originate in OUR
                # encode paths while answering an innocent peer), and so
                # do well-formed HELLOs for the wrong chain or version:
                # that is misconfiguration — e.g. a wallet run with the
                # wrong --difficulty — not hostility, and scoring it
                # would let three such invocations ban loopback.
                peername = writer.get_extra_info("peername")
                if peername:
                    self._record_violation(peername[0])
        finally:
            if inbound:  # still mid-handshake: release the slot
                self._handshaking -= 1
            self.subscriptions.drop(writer)
            self._peers.pop(writer, None)
            writer.close()
        return registered

    async def _dispatch(self, peer: _Peer, payload: bytes) -> None:
        # Wire-frame stage span: the decode cost a frame pays before any
        # admission or state work (the block pipeline's first leg).
        # ``clk`` is None iff telemetry is disabled; ``sclk`` is
        # additionally None on the 7-of-8 frames the micro-stage
        # sampler skips (see _tel_tick) — frame/admission ride sclk,
        # query latency below rides clk and records every event.
        clk = self._tel_clock
        sclk = None
        if clk is not None:
            self._tel_tick += 1
            if not (self._tel_tick & 7):
                sclk = clk
        if sclk is not None:
            t0 = sclk()
            mtype, body = protocol.decode(payload)
            self._h_frame.observe(sclk() - t0)
        else:
            mtype, body = protocol.decode(payload)
        # Overload front door (node/governor.py), BEFORE any state or
        # compute is spent on the frame.  SHED drops low-priority
        # traffic wholesale; admission charges the peer's class budget
        # for everything unsolicited and drops the excess — sustained
        # flooding escalates to the ordinary misbehavior score (and so,
        # eventually, to the accept-time ban).
        if self.governor.shedding and mtype in _SHED_DROPS:
            if mtype is MsgType.MEMPOOL:
                # Not the peer's fault we refused its page: don't let the
                # in-flight marker age into a stall demerit.
                peer.mempool_inflight_since = None
            elif mtype is MsgType.SKETCH:
                # Same courtesy for a shed sketch reply: close the round
                # without a demerit, re-queueing what it carried so the
                # txs retry once the pressure clears (no fallback flood
                # — under SHED the tx plane is being shed wholesale).
                peer.recon_round.update(peer.recon_pending)
                peer.recon_pending = peer.recon_round
                peer.recon_round = {}
                peer.recon_round_full = False
                peer.recon_inflight_since = None
            self.governor.shed_drop()
            return
        cls = _MSG_CLASS.get(mtype)
        if cls is not None:
            if sclk is not None:
                t0 = sclk()
                admitted = self.governor.admit(peer.budget, cls)
                self._h_admission.observe(sclk() - t0)
            else:
                admitted = self.governor.admit(peer.budget, cls)
            if not admitted:
                if peer.budget.owes_violation(cls) and peer.host:
                    self.log.warning(
                        "admission budget exceeded: dropping %s flood from %s",
                        cls,
                        peer.label,
                    )
                    self._record_violation(peer.host)
                    if self._is_banned(peer.host):
                        # The score just crossed the ban threshold: sever
                        # the live session too — the accept-time refusal
                        # alone would let the flooder keep this socket for
                        # the whole ban and never feel it.
                        raise _Refused(
                            f"{cls} flood from {peer.label}: banned"
                        )
                return
        # Query-plane request latency: one admitted GET* frame from
        # decode-done to reply-sent (every branch below falls through to
        # the common exit, so one stamp pair covers them all).
        query_t0 = (
            clk() if clk is not None and cls == CLASS_QUERIES else None
        )
        if mtype is MsgType.BLOCK:
            sent_ts, block = body
            await self._handle_block(block, origin=peer, sent_ts=sent_ts)
        elif mtype is MsgType.TX:
            await self._handle_tx(body, origin=peer)
        elif mtype is MsgType.GETBLOCKS:
            if (
                self.chain.prune_floor
                and self.chain.sync_start_height(body) < self.chain.prune_floor
            ):
                # Pruned-range refusal: the bodies below the
                # prune floor were discarded by policy.  Answer with an
                # EMPTY batch instead of disconnecting — an honest
                # syncing peer reads it as a stall and fails over to an
                # archive peer (node/supervision.py); our ``pruned``
                # status field lets it avoid us up front.
                self.metrics.pruned_refusals += 1
                await self._send_guarded(peer, protocol.encode_blocks([]))
            else:
                try:
                    blocks = self.chain.blocks_after(body, limit=SYNC_BATCH)
                except OSError as e:
                    # A segment went EIO under a body refetch: degrade
                    # to serve-only (the store recovery loop re-probes
                    # the disk) but keep THIS session — the fault is
                    # the disk's, not the peer's.
                    self._store_fail(e)
                    blocks = []
                # Cap the reply by encoded bytes too: with ~half-KB txs
                # a 500-block batch can exceed the receiver's frame
                # cap, which would wedge sync in a reconnect loop.
                capped, total = [], 0
                for blk in blocks:
                    total += len(blk.serialize()) + 4
                    if capped and total > SYNC_BYTES:
                        break
                    capped.append(blk)
                await self._send_guarded(
                    peer, protocol.encode_blocks(capped)
                )
        elif mtype is MsgType.BLOCKS:
            # Batch the store's durability: per-append fsync (~2 ms) is
            # right for the one-block gossip cadence but would stall this
            # event loop for seconds across a deep resync batch — and a
            # crash mid-batch only loses blocks the peer will re-serve.
            batch_fsync = self.store is not None and self.store.fsync
            if batch_fsync:
                self.store.fsync = False
            # VALIDATE stage: prove the whole batch's transfer
            # signatures into the verify-once cache with one batched
            # call before the per-block connect loop — a deep-sync reply
            # of 500 tx-bearing blocks pays the Ed25519 backend once,
            # not per transfer, and on the pipeline's validate lane the
            # ctypes engine (which releases the GIL) runs off-loop.
            # Purely a cache-warmer: per-block check_block still
            # decides, with identical outcomes
            # (chain/validate.py preverify_signatures).  The generator
            # hands the lane the same tx objects the frame decoded —
            # zero-copy, no re-encode.
            await self.pipeline.run_validate(
                preverify_signatures,
                (tx for block in body for tx in block.txs),
                self.chain.genesis.block_hash(),
                self.sig_cache,
                nbytes=sum(len(block.serialize()) for block in body),
            )
            accepted_any = False
            bg_accepted = 0
            try:
                for block in body:
                    # Content routing while a background revalidation is
                    # running (ASSUMED state): historical blocks — the
                    # ones only the genesis-anchored background chain
                    # can connect — feed IT; blocks the serving chain
                    # knows how to place take the normal path (both, for
                    # the overlap around the snapshot anchor).  Without
                    # the split, history would park as orphans in the
                    # assumed chain and never validate anything.
                    bg = self._bg_chain
                    handled = False
                    if bg is not None and (
                        block.block_hash() in bg
                        or block.header.prev_hash in bg
                    ):
                        st = bg.add_block(block)
                        if st.status is AddStatus.ACCEPTED and st.connected:
                            bg_accepted += len(st.connected)
                            self.metrics.revalidated_blocks += len(
                                st.connected
                            )
                            self._bg_sup.progress()
                        handled = True
                    if bg is None or (
                        block.block_hash() in self.chain
                        or block.header.prev_hash in self.chain
                    ):
                        res = await self._handle_block(
                            block, origin=peer, gossip=False
                        )
                        accepted_any |= res.status is AddStatus.ACCEPTED
                        handled = True
                    if not handled:
                        # Neither chain knows the parent: a gap in the
                        # history fetch — park in the background chain's
                        # bounded orphan pool, never the serving one's.
                        bg.add_block(block)
            finally:
                if batch_fsync:
                    self.store.fsync = True
                    await self._store_sync_staged()
            if bg_accepted:
                # The replay advanced: verdict check (flip/diverge), and
                # if still running, keep pulling history from this peer.
                await self._check_bg_done()
                if self._bg_chain is not None and body:
                    await self._bg_request(peer)
            # Progress was made and the batch was non-empty: there may be
            # more behind it (an empty/duplicate reply ends the loop).
            if accepted_any and body:
                await self._request_blocks(peer)
            else:
                if self._announce_tip:
                    # Catch-up quiesced on a new tip: announce it once
                    # (see _announce_tip).  Receivers that followed the
                    # same sync dedup it for the cost of one frame;
                    # receivers beyond a healed cut learn the chain
                    # exists and pull the rest via orphan backfill.
                    # The announce must NOT skip the quiescing peer:
                    # with interleaved catch-up episodes the tip can
                    # come from a different peer entirely, and the one
                    # whose empty reply quiesced us may be BEHIND it —
                    # a crash-recovered node that synced 2->4 from a
                    # stale peer and 4->7 from a fresh one consumed the
                    # one-shot flag on the stale peer's quiesce and
                    # skipped exactly the node that needed the push,
                    # leaving it forked forever (found by the chaos
                    # sweep, node/chaos.py seed 30; the redundant frame
                    # to an already-caught-up server is one dedup).
                    self._announce_tip = False
                    payload, saved = self._block_gossip_payload(
                        self.chain.tip
                    )
                    n = await self._gossip(payload)
                    if saved and n:
                        self.metrics.cblocks_sent += n
                        self.metrics.cblock_bytes_saved += saved * n
                if (
                    self._sync.target is peer
                    and self.chain.height >= peer.hello_height
                ):
                    # The supervised sync quiesced AND delivered what the
                    # peer advertised: a completed episode, not a stall.
                    # A non-advancing reply BELOW the advertised height
                    # (empty frames, re-served stale batches) leaves the
                    # deadline armed instead — chatty uselessness must
                    # read as a stall, or it would be the cheapest way
                    # to defeat the failover.  (A different peer's sync
                    # stays armed either way.)
                    self._sync.idle()
                if (
                    not peer.mempool_requested
                    and self.chain.height >= peer.hello_height
                ):
                    # Block sync with this peer quiesced AND our chain
                    # reached what it advertised: NOW ask for its pool,
                    # with our ledger caught up (one-shot per peer).  If
                    # another peer's sync is still filling the gap, the
                    # next quiesced batch re-checks.
                    await self._request_mempool(peer)
        elif mtype is MsgType.GETMEMPOOL:
            page, more = self.mempool.sync_page(body, MEMPOOL_SYNC_TXS)
            raws, total = [], 0
            for tx in page:
                raw = tx.serialize()
                total += len(raw) + 2
                if raws and total > MEMPOOL_SYNC_BYTES:
                    more = True  # byte-trimmed: the rest is still out there
                    break
                raws.append(raw)
            await self._send_guarded(peer, protocol.encode_mempool(raws, more))
        elif mtype is MsgType.MEMPOOL:
            more, txs = body
            peer.mempool_inflight_since = None  # page landed: not stalled
            # VALIDATE stage: batch the page's signatures into the
            # verify-once cache before per-tx admission (same fast lane
            # as deep-sync block batches; outcomes unchanged), off-loop
            # on the pipeline's validate lane.
            await self.pipeline.run_validate(
                preverify_signatures,
                txs,
                self.chain.genesis.block_hash(),
                self.sig_cache,
                nbytes=sum(len(tx.serialize()) for tx in txs),
            )
            for tx in txs:
                await self._handle_tx(tx, origin=peer)
            if more:
                # Continue from the largest key received, and only if it
                # strictly advances — key-ordering is (-fee, txid), so a
                # responder replaying old keys can't spin the sync.
                from p1_tpu_torch.mempool import sync_key

                cursor = None
                if txs:
                    last = max(txs, key=lambda t: sync_key(t.fee, t.txid()))
                    cursor = (last.fee, last.txid())
                prev = peer.mempool_cursor
                if cursor is not None and (
                    prev is None or sync_key(*cursor) > sync_key(*prev)
                ):
                    peer.mempool_cursor = cursor
                    await self._request_mempool(peer, cursor)
                else:
                    # "More coming" with an empty or non-advancing tail:
                    # chatty uselessness, and once it simply
                    # ENDED the sync silently — a hostile responder
                    # could park a node's pool sync forever at zero
                    # cost.  It now reads as the stall it is: demote and
                    # re-solicit from one other idle peer, same recovery
                    # as the in-flight deadline path.
                    self.metrics.mempool_sync_stalls += 1
                    peer.sync_demerits += 1
                    self.metrics.sync_demotions += 1
                    self.log.warning(
                        "mempool sync with %s stopped advancing — asking "
                        "another peer",
                        peer.label,
                    )
                    other = self._pick_sync_peer(exclude=peer)
                    if (
                        other is not None
                        and other is not peer
                        and other.mempool_inflight_since is None
                    ):
                        await self._request_mempool(other)
        elif mtype is MsgType.GETACCOUNT:
            # Wallet/CLI query: consensus state at OUR tip plus the next
            # usable seq net of our pending pool (p1 tx auto-seq).
            nonce = self.chain.nonce(body)
            await self._send_guarded(
                peer,
                protocol.encode_account(
                    protocol.AccountState(
                        body,
                        self.chain.balance(body),
                        nonce,
                        self.mempool.pending_next_seq(body, nonce),
                        self.chain.height,
                    )
                ),
            )
        elif mtype is MsgType.CBLOCK:
            await self._handle_cblock(body, peer)
        elif mtype is MsgType.GETBLOCKTXN:
            bhash, indices = body
            block = self.chain.get(bhash)
            if block is not None and indices[-1] < len(block.txs):
                await self._send_guarded(
                    peer,
                    protocol.encode_blocktxn(
                        bhash, [block.txs[i].serialize() for i in indices]
                    ),
                )
            # Unknown block / out-of-range indices: ignore — the requester
            # falls back to locator sync, and answering garbage helps no one.
        elif mtype is MsgType.BLOCKTXN:
            await self._handle_blocktxn(body, peer)
        elif mtype is MsgType.GETFEES:
            # Wallet fee query: confirmed-fee percentiles at our tip.
            stats = self.chain.fee_stats(min(body or 32, FEE_WINDOW_MAX))
            await self._send_guarded(
                peer,
                protocol.encode_fees(
                    protocol.FeeStats(
                        stats["window_blocks"],
                        stats["samples"],
                        stats["p25"],
                        stats["p50"],
                        stats["p75"],
                        self.chain.height,
                    )
                ),
            )
        elif mtype is MsgType.FEES:
            pass  # reply frame: meaningful to querying clients only
        elif mtype is MsgType.GETADDR:
            # Share listening addresses we know, minus the asker's own
            # (it does not need to learn itself): every tried address
            # first (handshake-verified beats rumor), newest gossip after.
            tried = [a for a in self._tried_addrs if a != peer.addr]
            addrs = tried[-ADDR_REPLY_MAX:]
            room = ADDR_REPLY_MAX - len(addrs)
            if room > 0:
                addrs += [
                    a for a in self._known_addrs if a != peer.addr
                ][-room:]
            await self._send_guarded(peer, protocol.encode_addr(addrs))
        elif mtype is MsgType.ADDR:
            # Per-HOST token bucket: one host must not be able to churn
            # the whole gossip book by streaming ADDR frames — nor by
            # reconnecting for fresh budgets (and tried addresses are out
            # of reach regardless).  Over-budget entries are ignored, not
            # scored — ADDR is advisory.
            bucket = (
                self._addr_budget(peer.host) if peer.host else [0.0, 0.0]
            )
            for addr in body[:ADDR_REPLY_MAX]:  # cap hostile batches
                if bucket[0] < 1.0:
                    break
                bucket[0] -= 1.0
                self._learn_addr(addr)
        elif mtype is MsgType.GETHEADERS:
            # Headers-first sync for light clients: same locator
            # semantics as GETBLOCKS, 80 B/block on the wire.  Served
            # from the always-resident header index (``headers_after``)
            # — never a body refetch, so header sync keeps working over
            # pruned and evicted ranges.
            headers = self.chain.headers_after(body, limit=HEADERS_BATCH)
            await self._send_guarded(
                peer, protocol.encode_headers(headers)
            )
        elif mtype is MsgType.HEADERS:
            pass  # reply frame: meaningful to light clients only
        elif mtype is MsgType.GETPROOF:
            # SPV query: serve the inclusion proof (or not-found) from the
            # chain's txid index; the client verifies it, we just attest
            # our main-chain view.  Served through the proof cache
            # (chain/proof.py): a repeat query is a payload memo hit plus
            # a 4-byte tip-height patch, a cold one fills proof templates
            # for the whole containing block in one merkle pass.
            await self._send_guarded(peer, self._proof_payload(body))
        elif mtype is MsgType.GETFILTERS:
            # Light-client filter sync (chain/filters.py): the compact
            # filters for a main-chain height range, each pinned to its
            # block hash.  Range-capped like GETBLOCKS/GETHEADERS so one
            # query can't drive an O(chain) scan on the event loop.
            start, count = body
            entries = []
            for h in range(start, start + min(count, FILTER_BATCH)):
                bhash = self.chain.main_hash_at(h)
                if bhash is None:
                    break
                fbytes = self.chain.block_filter(bhash)
                entries.append((bhash, fbytes))
            self.metrics.filters_served += len(entries)
            self.metrics.filter_bytes_served += sum(
                len(f) for _, f in entries
            )
            await self._send_guarded(
                peer, protocol.encode_filters(start, entries)
            )
        elif mtype is MsgType.FILTERS:
            pass  # reply frame: meaningful to light clients only
        elif mtype is MsgType.GETFILTERHEADERS:
            # The BIP157-analog commitment chain (chain/filters.py): the
            # proof surface a wallet cross-checks untrusted filter
            # streams against.  ``range`` refuses (empty reply) rather
            # than partially answer a span this chain has not committed
            # — pruned/rebased nodes are honestly short, never wrong.
            start, count = body
            await self._send_guarded(
                peer,
                protocol.encode_filterheaders(
                    start,
                    self.chain.filter_headers.range(
                        start, min(count, FILTER_BATCH)
                    ),
                ),
            )
        elif mtype is MsgType.FILTERHEADERS:
            pass  # reply frame: meaningful to light clients only
        elif mtype is MsgType.SUBSCRIBE:
            # Wallet push plane (node/subscriptions.py): register this
            # session's watch items; an unverifiable resume cursor is
            # refused by disconnect (unscored — a pruned window or a
            # wallet that last spoke to a liar is not hostility), which
            # is the wallet's signal to fail over.
            cursor, items = body
            sub_writer = peer.writer

            async def _sub_push(payload: bytes, w=sub_writer) -> None:
                protocol.write_frame_nowait(w, payload)

            def _sub_buf(w=sub_writer) -> int:
                transport = w.transport
                return (
                    transport.get_write_buffer_size()
                    if transport is not None
                    else 0
                )

            ok = await self.subscriptions.subscribe(
                sub_writer,
                items,
                cursor,
                send=_sub_push,
                buffer_size=_sub_buf,
                close=sub_writer.close,
            )
            if not ok:
                raise _Refused("resume cursor not on the committed chain")
        elif mtype is MsgType.UNSUBSCRIBE:
            self.subscriptions.unsubscribe(peer.writer)
        elif mtype is MsgType.EVENT:
            pass  # push frame: meaningful to subscribed wallets only
        elif mtype is MsgType.GETSNAPSHOT:
            # Snapshot serving (chain/snapshot.py): manifest or a chunk
            # range of the latest checkpoint state.  Range-capped and
            # governor-admitted like every other query; an ASSUMED node
            # (or a chain too short for a checkpoint) answers "none".
            start, count = body
            records = self._snapshot_records()
            if records is None:
                await self._send_guarded(peer, protocol.encode_snapshot_none())
            elif count == 0:
                await self._send_guarded(
                    peer, protocol.encode_snapshot_manifest(records[0])
                )
            else:
                chunks = records[1][start : start + min(count, SNAPSHOT_BATCH)]
                self.metrics.snapshot_chunks_served += len(chunks)
                await self._send_guarded(
                    peer, protocol.encode_snapshot_chunks(start, chunks)
                )
        elif mtype is MsgType.SNAPSHOT:
            await self._handle_snapshot(body, peer)
        elif mtype is MsgType.GETSTATUS:
            # Operator probe (`p1 status`): the same JSON the node logs,
            # served over the wire — deliberately NOT in _SHED_DROPS, so
            # overload stays observable while it is happening.
            await self._send_guarded(
                peer, protocol.encode_status(self.status())
            )
        elif mtype is MsgType.GETMETRICS:
            # Telemetry probe (`p1 metrics`): the registry snapshot —
            # per-stage latency histograms, counters, gauges.  IS shed
            # under overload (unlike GETSTATUS): scrapers retry.
            await self._send_guarded(
                peer, protocol.encode_metrics(self.telemetry_snapshot())
            )
        elif mtype is MsgType.GETMAINTAIN:
            # Maintenance command (`p1 maintain`): live re-basing,
            # online prune/compact, version-bits status — executed
            # inline on the dispatch loop (the ops themselves push
            # their heavy halves onto the store lane), refusals
            # answered as {"ok": false}, never dropped sessions.
            await self._send_guarded(
                peer, protocol.encode_maintain(await self._maintain(body))
            )
        elif mtype in (MsgType.STATUS, MsgType.METRICS, MsgType.MAINTAIN):
            pass  # reply frames: meaningful to querying clients only
        elif mtype is MsgType.PING:
            await self._send_guarded(peer, protocol.encode_pong(body))
        elif mtype is MsgType.PONG:
            pass  # arrival already reset the session's idle probe
        elif mtype in (MsgType.ACCOUNT, MsgType.PROOF):
            pass  # reply frames: meaningful to querying clients only
        elif mtype is MsgType.REQRECON:
            # Responder half of a reconciliation round: freeze our queue
            # for this link (merging any window a vanished initiator
            # left behind) and serve a sketch sized for the estimated
            # difference.  Served even when recon is locally disabled —
            # a sketch of what we have is one small frame and keeps
            # straggler links correct; no salt (tooling client) means
            # there is nothing coherent to sketch, so the frame is
            # ignored and the asker's stall fallback covers it.
            if peer.recon_salt is not None:
                full, remote_size = body
                window = peer.recon_window
                window.update(peer.recon_pending)
                peer.recon_pending.clear()
                if full:
                    for txid in self.mempool.txids():
                        window.setdefault(
                            reconcile.short_id(peer.recon_salt, txid), txid
                        )
                peer.recon_window_full = full
                cap = reconcile.estimate_capacity(len(window), remote_size)
                self.metrics.recon_sketches_served += 1
                await self._send_guarded(
                    peer,
                    protocol.encode_sketch(
                        len(window), reconcile.sketch(window, cap)
                    ),
                )
        elif mtype is MsgType.SKETCH:
            # Initiator half: XOR our round's sketch against the peer's
            # at ITS capacity and decode the symmetric difference.
            # Admission-exempt but self-guarding: without a round in
            # flight the frame is unsolicited and ignored.
            if peer.recon_inflight_since is not None:
                _remote_size, sk = body
                ours = reconcile.sketch(
                    peer.recon_round, reconcile.capacity_of(sk)
                )
                diff = reconcile.decode(reconcile.combine(ours, sk))
                if diff is None:
                    await self._recon_fallback(peer)
                else:
                    await self._recon_close(peer, diff)
        elif mtype is MsgType.RECONCILDIFF:
            # The initiator closed the round.  Success carries the WHOLE
            # symmetric difference as an announcement: ids we recognize
            # are ours (the peer will GETTX them — the window stays
            # alive as the serve station), ids we don't are the peer's
            # (book them; our next heartbeat GETTXs whatever no other
            # link delivered first).  Failure floods the window (every
            # queued tx still propagates, at flood cost) — except for a
            # full-pool round, where the initiator's classic-paging
            # fallback pulls what it needs instead of us flooding a
            # whole pool.
            success, sids = body
            window = peer.recon_window
            peer.recon_window = {}
            was_full = peer.recon_window_full
            peer.recon_window_full = False
            if success:
                # The window becomes the serve station for the peer's
                # deferred GETTX; ids we recognize nowhere are the
                # peer's half of the diff.  "Nowhere" must include the
                # round we just retired (``recon_served`` before the
                # swap): a tx consumed into the previous round lives in
                # no other per-link structure, and booking it would
                # fetch a copy we already hold.
                served = peer.recon_served
                peer.recon_served = window
                for sid in sids:
                    if (
                        sid not in window
                        and sid not in peer.recon_pending
                        and sid not in served
                    ):
                        peer.recon_expect.add(sid)
            elif not was_full:
                for txid in window.values():
                    tx = self.mempool.get(txid)
                    if tx is not None:
                        await self._gossip_peers(
                            [peer], protocol.encode_tx(tx)
                        )
        elif mtype is MsgType.GETTX:
            # Explicit fetch of short ids a RECONCILDIFF promised.  The
            # window/queue resolve most; the rest fall to a BOUNDED pool
            # scan (the short id is salted per link, so there is no
            # precomputed index — the cap prices a hostile GETTX spray).
            if peer.recon_salt is not None:
                lookup = dict(peer.recon_served)
                lookup.update(peer.recon_window)
                lookup.update(peer.recon_pending)
                missing = {sid for sid in body if sid not in lookup}
                if missing:
                    for n, txid in enumerate(self.mempool.txids()):
                        if not missing or n >= RECON_GETTX_SCAN_MAX:
                            break
                        sid = reconcile.short_id(peer.recon_salt, txid)
                        if sid in missing:
                            missing.discard(sid)
                            lookup[sid] = txid
                for sid in body:
                    tx = self.mempool.get(lookup.get(sid, b""))
                    if tx is not None:
                        # The one place reconciled txs cross the wire:
                        # every push is an explicit fetch of something
                        # the peer verified it still lacks.
                        self.metrics.txs_reconciled += 1
                        await self._gossip_peers([peer], protocol.encode_tx(tx))
        elif mtype is MsgType.HELLO:
            pass  # late HELLO: ignore
        if query_t0 is not None:
            self._h_query.observe(clk() - query_t0)

    def _proof_payload(self, txid: bytes) -> bytes:
        """The wire PROOF reply for ``txid``, through the chain's proof
        cache: the serialized payload (tip zeroed) is memoized on the
        cache entry on first serve, so repeats cost one dict lookup and
        a 4-byte tip patch — the verify-once economics of the sigcache
        applied to the proof path."""
        entry = self.chain.tx_proof_entry(txid)
        if entry is None:
            return protocol.encode_proof(None)
        if entry.payload is None:
            self.chain.proof_cache.note_payload(
                entry, protocol.encode_proof(entry.proof)
            )
        self.metrics.proofs_served += 1
        return protocol.patch_proof_tip(entry.payload, self.chain.height)

    async def _send_guarded(self, peer: _Peer, payload: bytes) -> None:
        """Reply/continuation send with a timeout: a peer that stops
        reading while we block in drain() must not wedge the dispatch
        loop.  Without this, two peers answering each other's sync
        requests with multi-MB replies can fill both transport buffers
        and deadlock — a stalled peer is dropped instead.

        The timeout scales with payload size: a flat 5 s on an
        8 MB sync reply would drop every healthy peer on a link slower
        than ~1.6 MB/s and livelock its initial sync through the reconnect
        loop.  The floor stays at GOSSIP_SEND_TIMEOUT_S for small pushes;
        big replies get 1 s per 100 KB — still far faster than any link
        worth keeping, but tolerant of a slow-but-live one.

        Write-queue squat guard (node/governor.py): a peer that keeps
        ASKING while never READING grows our transport buffer without
        ever tripping the send timeout (each send returns once the data
        is buffered).  Past the hard cap the peer is disconnected — the
        replies it refused to read are re-fetchable, the memory is
        not."""
        transport = peer.writer.transport if peer.writer is not None else None
        if (
            transport is not None
            and transport.get_write_buffer_size() > self.governor.write_queue_max
        ):
            self.governor.peers_dropped_squat += 1
            self.log.warning(
                "write queue for %s over %d bytes — dropping the "
                "squatting peer",
                peer.label,
                self.governor.write_queue_max,
            )
            peer.writer.close()  # reader loop will reap it
            return
        timeout = GOSSIP_SEND_TIMEOUT_S + len(payload) / 100_000
        try:
            await asyncio.wait_for(peer.send(payload), timeout=timeout)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            peer.writer.close()  # reader loop will reap it

    async def _gossip(self, payload: bytes, skip: _Peer | None = None) -> int:
        """Send to all peers concurrently; a stalled peer times out and is
        dropped instead of blocking propagation (and the mining loop).
        Returns the number of peers targeted (metrics accounting).

        Best-effort sends additionally skip peers already sitting on
        megabytes of unread replies (the soft write-queue bound): there
        is no point queuing a push behind a backlog, and the skipped
        peer heals through ordinary locator sync."""
        return await self._gossip_peers(
            [p for p in self._peers.values() if p is not skip], payload
        )

    async def _gossip_peers(self, peers, payload: bytes) -> int:
        """The shared fan-out half of ``_gossip``: apply the write-queue
        back-pressure skip to an explicit peer list and send to the
        survivors concurrently.  The reconciliation relay reuses it to
        flood a SUBSET of peers (the flood spine, fallback floods)."""
        targets = []
        for p in peers:
            transport = p.writer.transport
            if (
                transport is not None
                and transport.get_write_buffer_size() > WRITE_QUEUE_GOSSIP_MAX
            ):
                self.governor.write_queue_drops += 1
                continue
            targets.append(p)
        if targets:
            await asyncio.gather(
                *(self._send_guarded(p, payload) for p in targets)
            )
        return len(targets)

    # -- set-reconciliation tx relay (Erlay analog) ------------
    #
    # Flooding ships every tx to every link: per-node relay bandwidth
    # grows with the CONNECTIVITY of the mesh, not its size.  The recon
    # plane replaces most of that with per-link set reconciliation
    # (node/reconcile.py): announcements queue per link as 4-byte short
    # ids, and a periodic sketch exchange transfers only the symmetric
    # DIFFERENCE of the two queues — O(what the peer is missing), no
    # matter how much the sets overlap.  A small flood spine
    # (``recon_flood_degree`` outbound links per node) keeps worst-case
    # latency at flood speed; reconciliation sweeps the remaining links.
    # Flood stays the universal fallback — decode failure, stalled
    # responder, demoted or pre-RECONCILE peer all degrade to exactly
    # the flood-only behavior, so reconciliation is only ever an
    # optimisation, never a liveness dependency.

    def _recon_enabled(self) -> bool:
        """Whether THIS node queues txs for reconciliation and initiates
        rounds.  ``config.recon_gossip`` is the operator switch; a
        "txrecon" version-bits deployment (when the table carries one)
        additionally gates on miner-signalled activation, so a mixed-
        version mesh upgrades by signal with flood as the shared
        dialect throughout (the evolution contract).  Recon-off
        nodes still ANSWER REQRECON — serving a sketch of what we have
        costs one small frame and keeps straggler links correct."""
        if not self.config.recon_gossip:
            return False
        dep = self._recon_deployment
        if dep is None:
            return True
        return (
            self.versionbits.state_for_next(
                self.chain, self.chain.tip_hash, dep
            )
            is VBState.ACTIVE
        )

    def _recon_peer_active(self, peer: _Peer, now: float) -> bool:
        """Is this link on the reconciliation plane right now?  Needs a
        pairwise salt (real node, handshake done) and no standing
        demotion."""
        return (
            peer.recon_salt is not None
            and peer.is_node
            and peer.recon_demoted_until <= now
        )

    def _recon_fail(self, peer: _Peer) -> None:
        """Count one failed/stalled round; demote the link to plain
        flooding after RECON_DEMOTE_FAILURES in a row.  Demotion is the
        anti-poisoning story: a peer serving garbage sketches (or none)
        costs us a few wasted frames and then only ITS link's
        efficiency — honest relay continues via flood regardless."""
        peer.recon_failures += 1
        self.metrics.recon_fallbacks += 1
        if peer.recon_failures >= RECON_DEMOTE_FAILURES:
            peer.recon_failures = 0
            peer.recon_demoted_until = self.clock.monotonic() + RECON_DEMOTE_S
            peer.sync_demerits += 1
            self.metrics.recon_demotions += 1
            self.log.warning(
                "peer %s demoted off recon plane for %.0fs",
                peer.label,
                RECON_DEMOTE_S,
            )

    async def _relay_tx(
        self, tx: Transaction, txid: bytes, skip: _Peer | None = None
    ) -> None:
        """Relay one accepted tx: flood the spine, queue the rest.

        Per link, in ``_peers`` insertion order: peers off the recon
        plane are flooded exactly as before; the first
        ``recon_flood_degree`` OUTBOUND and first ``recon_flood_degree``
        INBOUND recon links also get the flood push — the low-latency
        spine, symmetric on purpose: with the dial-earlier topologies
        this repo builds, an outbound-only spine is a DAG pointing at
        the oldest nodes and a tx could only climb back against it at
        reconciliation cadence.  An attacker occupying an inbound spine
        slot merely RECEIVES txs early (it controls nothing about our
        relay to anyone else).  Every other recon link gets the tx
        queued as a short id for its next reconciliation round.  Queue
        overflow floods the oldest entry instead of dropping it — flood
        is the pressure valve, reconciliation the optimisation, never
        the reverse."""
        payload = protocol.encode_tx(tx)
        if not self._recon_enabled():
            await self._gossip(payload, skip=skip)
            return
        now = self.clock.monotonic()
        flood = []
        spine_out = spine_in = max(0, self.config.recon_flood_degree)
        for p in self._peers.values():
            if p is skip:
                continue
            if not self._recon_peer_active(p, now):
                flood.append(p)
                continue
            if p.dial_addr is not None and spine_out > 0:
                spine_out -= 1
                flood.append(p)
                continue
            if p.dial_addr is None and spine_in > 0:
                spine_in -= 1
                flood.append(p)
                continue
            p.recon_pending[reconcile.short_id(p.recon_salt, txid)] = txid
            while len(p.recon_pending) > RECON_PENDING_MAX:
                old_sid = next(iter(p.recon_pending))
                old = self.mempool.get(p.recon_pending.pop(old_sid))
                if old is not None:
                    await self._gossip_peers([p], protocol.encode_tx(old))
        await self._gossip_peers(flood, payload)

    async def _recon_loop(self) -> None:
        """The reconciliation heartbeat: every ``recon_interval_s``, age
        out silent rounds, chase promised-but-undelivered txs (GETTX),
        run any queued full-pool sync round, then initiate ONE steady-
        state round, round-robin over outbound recon links.  One
        initiation per tick, not a thundering herd — with every node
        ticking, each link still reconciles once per interval on
        average, from whichever end dialed it."""
        while self._running:
            await asyncio.sleep(self.config.recon_interval_s)
            try:
                await self._recon_tick()
            except Exception:
                # Heartbeat must survive one bad tick: flood fallback
                # keeps relay correct even if reconciliation is wedged.
                self.log.exception("recon tick failed")

    async def _recon_tick(self) -> None:
        now = self.clock.monotonic()
        # Stall deadline for a round in flight.  Self-supervised HERE
        # (not in the supervision loop) so the plane ages out silent
        # responders even when sync supervision is disabled; a few
        # intervals of slack tolerates a slow link, the send-timeout
        # floor tolerates a long tick.
        # Twice the send timeout, not equal to it: a round's SKETCH can
        # legitimately serialize behind a congested uplink for several
        # seconds, and aging it out at the first opportunity turns
        # congestion into demotions into MORE flooding (measured in the
        # relay-budget A/B before this slack was added).
        stall_s = max(
            8 * self.config.recon_interval_s, 2 * GOSSIP_SEND_TIMEOUT_S
        )
        chase = []
        for p in list(self._peers.values()):
            if (
                p.recon_inflight_since is not None
                and now - p.recon_inflight_since > stall_s
            ):
                await self._recon_fallback(p)
            if p.recon_expect and p.recon_inflight_since is None:
                chase.append(p)
            if (
                p.recon_full_pending
                and p.recon_inflight_since is None
                and self._recon_peer_active(p, now)
            ):
                p.recon_full_pending = False
                await self._recon_start(p, full=True)
        if chase:
            # Announced-but-undelivered short ids: fetch explicitly,
            # once, from ONE link per tick (round-robin).  The pacing is
            # load-bearing, not politeness: during a propagation wave
            # several links announce the SAME tx within one interval,
            # and chasing them all in the same tick fetches that tx once
            # per link.  Serialized, the first fetch lands before the
            # next link's turn and ``_handle_tx``'s cross-link discard
            # cancels the rest (measured: same-tick chasing re-bought a
            # 2.4x duplicate-delivery factor the diff announcements had
            # just eliminated).  The set is cleared either way, so a
            # peer that never answers GETTX can't grow state or wedge
            # anything.
            self._recon_chase_rotate = (
                self._recon_chase_rotate + 1
            ) % len(chase)
            p = chase[self._recon_chase_rotate]
            sids = sorted(p.recon_expect)[: protocol.MAX_RECON_IDS]
            p.recon_expect.clear()
            await self._send_guarded(p, protocol.encode_gettx(sids))
        if not self._recon_enabled() or self.governor.shedding:
            # Under shed pressure the tx plane is already being dropped
            # at admission; initiating new rounds would only add load.
            return
        # Initiate even with an empty local queue: the responder's queue
        # for THIS link rides the same round (its pending freezes into
        # the sketch window, and the decoded diff books it as "theirs"),
        # so the dialing side's heartbeat is what drains BOTH
        # directions.  An idle-link round costs ~30 bytes total.
        candidates = [
            p
            for p in self._peers.values()
            if p.dial_addr is not None
            and p.recon_inflight_since is None
            and self._recon_peer_active(p, now)
        ]
        if candidates:
            self._recon_rotate = (self._recon_rotate + 1) % len(candidates)
            await self._recon_start(candidates[self._recon_rotate], full=False)

    async def _recon_start(self, peer: _Peer, full: bool) -> None:
        """Freeze this link's queue into a round and request a sketch.
        A full round (initial pool sync) additionally folds our whole
        pool in, so the decoded difference is exactly the symmetric
        difference of the two mempools."""
        peer.recon_round = dict(peer.recon_pending)
        peer.recon_pending.clear()
        if full:
            for txid in self.mempool.txids():
                peer.recon_round.setdefault(
                    reconcile.short_id(peer.recon_salt, txid), txid
                )
        peer.recon_round_full = full
        peer.recon_inflight_since = self.clock.monotonic()
        self.metrics.recon_rounds += 1
        await self._send_guarded(
            peer, protocol.encode_reqrecon(len(peer.recon_round), full=full)
        )

    async def _recon_close(self, peer: _Peer, diff) -> None:
        """Successful decode on the initiator: announce the WHOLE
        symmetric difference with RECONCILDIFF and book the half we
        lack as expected.

        Nobody pushes transactions here — that is the dedup
        that made the byte budget real.  Each end books the diff ids it
        doesn't recognize and fetches them with GETTX one heartbeat
        LATER; a copy arriving from any other link in that window
        cancels the fetch (``_handle_tx`` discards the id under every
        link salt), so a tx crossing a well-connected mesh is sent to
        each node once, not once per racing link.  An id costs 4 bytes
        where an eager duplicate push costs a whole transaction —
        measured in the relay-budget A/B, eager pushing tripled the
        recon arm's bytes."""
        round_, was_full = peer.recon_round, peer.recon_round_full
        peer.recon_round = {}
        peer.recon_round_full = False
        peer.recon_inflight_since = None
        peer.recon_failures = 0
        self.metrics.recon_success += 1
        # The decoded diff is ≤ sketch capacity (64), comfortably inside
        # the frame's id cap.
        await self._send_guarded(
            peer, protocol.encode_recondiff(True, tuple(diff))
        )
        # Book only ids we recognize NOWHERE on this link.  The frozen
        # round alone is not enough: a tx that arrived (from any link)
        # after the freeze sits in this link's pending queue, shows up
        # in the diff as "missing from the round", and booking it would
        # fetch a copy we already hold — the arrival can't have
        # cancelled a booking that didn't exist yet.
        peer.recon_expect.update(
            sid
            for sid in diff
            if sid not in round_
            and sid not in peer.recon_pending
            and sid not in peer.recon_window
            and sid not in peer.recon_served
        )
        # Our half stays fetchable: the round becomes the serve station
        # the peer's deferred GETTX resolves from, without a pool scan.
        peer.recon_served = round_
        if was_full:
            # The supervised initial sync completed over the recon plane.
            peer.mempool_inflight_since = None

    async def _recon_fallback(self, peer: _Peer) -> None:
        """Failed round on the initiator side (undecodable sketch or a
        silent responder): tell the responder (best effort), degrade
        THIS round to the pre-recon behavior — flood what it carried,
        or classic cursor paging for a full-pool sync (flooding a whole
        pool is exactly what reconciliation exists to avoid) — and
        count toward demotion."""
        round_, was_full = peer.recon_round, peer.recon_round_full
        peer.recon_round = {}
        peer.recon_round_full = False
        peer.recon_inflight_since = None
        self._recon_fail(peer)
        await self._send_guarded(peer, protocol.encode_recondiff(False))
        if was_full:
            peer.mempool_inflight_since = self.clock.monotonic()
            await self._send_guarded(peer, protocol.encode_getmempool(None))
            return
        for txid in round_.values():
            tx = self.mempool.get(txid)
            if tx is not None:
                await self._gossip_peers([peer], protocol.encode_tx(tx))

    # -- chain/mempool handlers -----------------------------------------

    def _block_gossip_payload(self, block: Block) -> tuple[bytes, int]:
        """Choose the push encoding: compact when there are transactions
        worth eliding (the receiver's mempool should hold them), full
        BLOCK otherwise (an empty/coinbase-only block has nothing to
        elide, and the full form needs no round trip ever; a >u16-tx
        block exceeds the compact form's counts).  Returns (payload,
        bytes saved per delivered peer) — the CALLER accounts metrics
        once it knows how many peers actually received it."""
        now = self.clock.wall()
        full = protocol.encode_block(block, sent_ts=now)
        if self.config.compact_gossip and 1 < len(block.txs) <= 0xFFFF:
            compact = protocol.encode_cblock(block, sent_ts=now)
            return compact, len(full) - len(compact)
        return full, 0

    async def _handle_cblock(
        self, cb: protocol.CompactBlock, peer: _Peer
    ) -> None:
        """Reconstruct a compact block from the mempool; fetch the rest.

        Order of operations is the DoS story: the header must carry proof
        of work at the EXACT difficulty consensus requires of its parent
        (``Chain.required_difficulty`` — contextual, so this holds on
        retargeting chains too) before any state is touched or any request
        sent; parking a pending reconstruction or triggering a GETBLOCKTXN
        round trip therefore costs a real block's worth of work.  A
        compact push whose parent we don't know can't be priced — it falls
        straight to locator sync, which an out-of-order arrival needs
        anyway.  Txids are full SHA-256d hashes, so mempool hits are
        byte-exact by construction and full consensus validation still
        runs in ``_handle_block``.
        """
        from p1_tpu_torch.core.header import meets_target

        header = cb.header
        bhash = header.block_hash()
        if self._store_degraded:
            # Serve-only: don't spend a GETBLOCKTXN round trip on a
            # block the door will refuse; recovery re-fetches it.
            self.metrics.store_blocks_deferred += 1
            return
        if bhash in self.chain:
            self._refund_relay_race(peer, bhash)
            return  # duplicate push
        if (bhash, peer) in self._pending_cblocks:
            return  # duplicate push
        expected = self.chain.required_difficulty(header.prev_hash)
        if expected is None:
            await self._request_blocks(peer)
            return
        if header.difficulty != expected or not meets_target(
            bhash, header.difficulty
        ):
            self.metrics.blocks_rejected += 1
            self.log.warning("rejected compact block from %s: bad work", peer.label)
            return
        self.metrics.cblocks_received += 1
        txs: list = [None] * cb.ntx
        for i, tx in cb.prefilled:
            txs[i] = tx
        rest = [i for i in range(cb.ntx) if txs[i] is None]
        want: dict[int, bytes] = {}
        for i, txid in zip(rest, cb.txids):
            tx = self.mempool.get(txid)
            if tx is not None:
                txs[i] = tx
                self.metrics.cblock_tx_hits += 1
            else:
                want[i] = txid
        if not want:
            await self._handle_block(
                Block(header, tuple(txs)), origin=peer, sent_ts=cb.sent_ts
            )
            return
        held = sum(1 for (_h, p) in self._pending_cblocks if p is peer)
        if held >= PENDING_CBLOCKS_PER_PEER:
            # One peer must not squat the reconstruction table: each slot
            # pins a partially rebuilt block in RAM until the deadline
            # reaps it.  The block is real (it passed the work gate), so
            # locator sync recovers it — refusing the slot loses nothing.
            self.governor.cblock_slot_drops += 1
            return
        self._pending_cblocks[(bhash, peer)] = _PendingCompact(
            header, txs, want, cb.sent_ts, asked_at=self.clock.monotonic()
        )
        while len(self._pending_cblocks) > MAX_PENDING_CBLOCKS:
            self._pending_cblocks.popitem(last=False)
        await self._send_guarded(
            peer, protocol.encode_getblocktxn(bhash, sorted(want))
        )

    async def _handle_blocktxn(self, body, peer: _Peer) -> None:
        bhash, txs = body
        # Keyed by (hash, peer): an unsolicited BLOCKTXN from a peer we
        # never asked resolves nothing and cannot destroy a reconstruction
        # in flight with the peer we DID ask.
        pending = self._pending_cblocks.pop((bhash, peer), None)
        if pending is None:
            return  # answered twice / evicted meanwhile / never asked
        indices = sorted(pending.want)
        if len(txs) != len(indices):
            self.log.warning("BLOCKTXN wrong count from %s", peer.label)
            return
        for i, tx in zip(indices, txs):
            if tx.txid() != pending.want[i]:
                # The reply does not match the advertised block — drop the
                # reconstruction; the chain heals via sync if it was real.
                self.log.warning("BLOCKTXN txid mismatch from %s", peer.label)
                return
            pending.txs[i] = tx
        self.metrics.cblock_tx_fetched += len(indices)
        await self._handle_block(
            Block(pending.header, tuple(pending.txs)),
            origin=peer,
            sent_ts=pending.sent_ts,
        )

    async def _handle_block(
        self,
        block: Block,
        origin: _Peer | None = None,
        gossip: bool = True,
        sent_ts: float | None = None,
    ):
        if self._store_degraded and block.block_hash() not in self.chain:
            # Degraded serve-only mode: a block we cannot persist is a
            # block we must not acknowledge — accepting it would let the
            # in-memory chain run ahead of a disk that will lose it.
            # Peers keep it; recovery re-fetches via locator sync.
            self.metrics.store_blocks_deferred += 1
            return AddResult(
                AddStatus.REJECTED, reason="store degraded: serve-only mode"
            )
        # Zero-repack pipeline: a block decoded off the wire carries its
        # exact frame bytes in its encoding cache (core/block.py), so the
        # hashing below (add_block's validation), the store append, and
        # the re-relay encode all reuse them — the block is packed at
        # most once per process lifetime (the host ingest
        # plane).  Only mempool-reconstructed compact blocks serialize
        # fresh, once, on first use (their full frame never arrived).
        clk = self._tel_clock
        t0 = clk() if clk is not None else 0.0
        if block.block_hash() not in self.chain:
            # VALIDATE stage: batch-verify the block's transfer
            # signatures into the verify-once cache on the pipeline's
            # validate lane BEFORE the connect — add_block's check_block
            # then hits the cache, so the Ed25519 cost (the old stage
            # table's dominant term) is paid off-loop when staging is
            # on.  Cache-warmer only: outcomes are check_block's alone,
            # and a hostile invalid-signature block just pays its
            # (bounded, ban-scored) verify at connect time instead.
            await self.pipeline.run_validate(
                preverify_signatures,
                block.txs,
                self.chain.genesis.block_hash(),
                self.sig_cache,
                nbytes=len(block.serialize()),
            )
        res = self.chain.add_block(block)
        if clk is not None:
            self._h_validate.observe(clk() - t0)
        if res.status is AddStatus.ACCEPTED:
            # Any accepted block is catch-up progress no matter who
            # served it: the supervised sync's deadline and attempt
            # budget reset (supervision.py — the honest-slow guarantee).
            self._sync.progress()
            if gossip and getattr(origin, "budget", None) is not None:
                # A pushed block that connected as NEW earns its charge
                # back (governor.py): PoW makes new blocks self-limiting,
                # so the blocks budget only ever throttles duplicates,
                # stale relays, and orphan spray — an honest miner can
                # never exhaust it, however fast the mesh mines.  Batch
                # sync replies (gossip=False) were never charged.
                origin.budget.refund(CLASS_BLOCKS)
            if sent_ts:
                # Push-gossip propagation delay (send -> accept), recorded
                # only for blocks that actually connected: duplicates and
                # orphans would skew the figure toward re-delivery noise.
                # Falsy covers both "no stamp" spellings — None (never
                # passed a stamp) and the codec's 0.0 "no stamp" encode
                # (protocol.encode_block) — so an unstamped tooling push
                # can't record a nonsense epoch-sized delay.
                prop_delay = max(0.0, self.clock.wall() - sent_ts)
                self.metrics.propagation_delays_s.append(prop_delay)
                # Histogram twin of the raw window: virtual-time under
                # the sim, so scenarios assert p95 propagation bounds.
                self.telemetry.observe("block.propagation_s", prop_delay)
            self.metrics.blocks_accepted += 1
            # incl. cascaded orphans; a failing disk degrades, never
            # unwinds this handler (_store_append).
            t0 = clk() if clk is not None else 0.0
            await self._store_append(res.connected)
            if clk is not None:
                self._h_store.observe(clk() - t0)
            for b in res.connected:
                # Serving plane: build each connected block's compact
                # filter while its body is hot (incremental-at-connect;
                # anything LRU-evicted later rebuilds from the store).
                self.chain.filter_index.add_block(b)
                self._recent_connects[b.block_hash()] = None
            while len(self._recent_connects) > RELAY_RACE_BLOCKS:
                self._recent_connects.popitem(last=False)
            # Push plane: notify live subscriptions of the connect (the
            # no-subscriber case is a cursor fast-forward, not a build).
            await self.subscriptions.notify()
            if res.tip_changed:
                if not gossip:
                    # Batch-synced tip movement: queue the one-shot
                    # announce for when the episode quiesces.
                    self._announce_tip = True
                if res.removed:
                    self.metrics.reorgs += 1
                self.mempool.apply_block_delta(res.removed, res.added)
                self._abort_inflight_search()
                tip = self.chain.tip
                self.log.info(
                    "tip height=%d hash=%s nonce=%d txs=%d reorg=%d source=%s",
                    self.chain.height,
                    tip.block_hash().hex()[:16],
                    tip.header.nonce,
                    len(tip.txs),
                    len(res.removed),
                    origin.label if origin else "local",
                )
            if gossip:
                # Relay-fan-out stage span: encode + the concurrent send
                # round (awaits included — the figure is what a tip push
                # costs this event loop end to end).
                t0 = clk() if clk is not None else 0.0
                payload, saved_per_peer = self._block_gossip_payload(block)
                n = await self._gossip(payload, skip=origin)
                if clk is not None:
                    self._h_relay.observe(clk() - t0)
                if saved_per_peer and n:
                    # Per delivered peer: each would otherwise have
                    # received the full BLOCK frame.
                    self.metrics.cblocks_sent += n
                    self.metrics.cblock_bytes_saved += saved_per_peer * n
        elif res.status is AddStatus.DUPLICATE and gossip and origin is not None:
            self._refund_relay_race(origin, block.block_hash())
        elif res.status is AddStatus.ORPHAN and origin is not None:
            await self._request_blocks(origin)
        elif res.status is AddStatus.REJECTED:
            self.metrics.blocks_rejected += 1
            self.log.warning(
                "rejected block from %s: %s",
                origin.label if origin else "local",
                res.reason,
            )
        return res

    def _refund_relay_race(self, peer: _Peer, bhash: bytes) -> None:
        """Refund a pushed duplicate that can be a relay race: ``peer``'s
        first push of one of our RELAY_RACE_BLOCKS most recently connected
        blocks (the RELAY_RACE_BLOCKS note)."""
        budget = getattr(peer, "budget", None)
        if budget is None or bhash not in self._recent_connects:
            return
        if bhash in peer.raced:
            return  # a repeat: the replay the budget exists to cut
        peer.raced[bhash] = None
        if len(peer.raced) > 2 * RELAY_RACE_BLOCKS:
            peer.raced.popitem(last=False)
        budget.refund(CLASS_BLOCKS)

    async def _handle_tx(self, tx: Transaction, origin: _Peer | None = None) -> None:
        t0 = self.clock.monotonic()
        added = self.mempool.add(tx)
        self.tx_admission_s += self.clock.monotonic() - t0
        if added:
            self.metrics.txs_accepted += 1
            txid = tx.txid()
            # Arrival stamp for the propagation budget (bounded: drop
            # the oldest entry like a poor man's deque-of-dict).
            if len(self.tx_seen_at) >= 8192:
                self.tx_seen_at.pop(next(iter(self.tx_seen_at)))
            self.tx_seen_at[txid] = self.clock.monotonic()
            # A delivered tx settles every link's RECONCILDIFF IOU for
            # it, not just the origin's: other links may have announced
            # the same tx in their own diffs, and discarding it here —
            # under each link's own salt — is what turns racing
            # announcements into ONE delivery instead of one per link
            # (the dedup; eager cross-link pushes measured 3x
            # the bytes).
            for p in self._peers.values():
                if p.recon_expect and p.recon_salt is not None:
                    p.recon_expect.discard(
                        reconcile.short_id(p.recon_salt, txid)
                    )
            await self._relay_tx(tx, txid, skip=origin)

    async def submit_tx(self, tx: Transaction) -> None:
        """Local API: inject a transaction (CLI/tests)."""
        await self._handle_tx(tx, origin=None)

    async def request_sync(self) -> None:
        """Ask every peer for blocks past our locator.  Used at quiesce: a
        push dropped in the final instant (send timeout, reconnect window)
        leaves no descendant to trigger an orphan backfill, so tips could
        stay split on a same-height tie without this pull."""
        if self._store_degraded:
            return  # serve-only: don't solicit blocks we would refuse
        if self._peers:
            await self._gossip(protocol.encode_getblocks(self.chain.locator()))

    # -- mining ----------------------------------------------------------

    def _abort_inflight_search(self) -> None:
        if self._abort is not None:
            self._abort.set()

    def _mining_parent(self) -> Block:
        """The block this miner chooses to extend.  Normally the tip —
        but MINING POLICY (not consensus: the DAG's validity rules stay
        wall-clock-free) refuses to extend a block stamped more than
        ``ANCHOR_SLACK_S`` past local wall time.  The height-1
        bootstrap-anchor exemption (core/retarget.py) means a hostile
        first miner CAN stamp decades ahead and validly poison the
        chain clock — every later honest stamp would crawl at parent+1,
        spans would read seconds, and difficulty would ratchet toward
        255 until the chain stalls.  This guard is how the honest
        majority responds: their miners build from the heaviest
        sanely-stamped block instead, out-working and orphaning the
        poisoned suffix.  Wall time influences only which branch THIS
        miner grows, never what any node accepts — replay determinism
        holds.

        The slack is deliberately enormous compared to the consensus
        cap: honest chains legitimately run their clock ahead of wall
        time during mining bursts (strict increase forces +1 s stamps
        at any block rate, so a 5k-block soak sits ~1.4 h "in the
        future"; an early too-tight bound of now + max_increment wedged
        real nodes at height ~33, hot-looping one candidate).  Only an
        anchor-style jump — months-to-decades, impossible to reach by
        +1 s crawling at any realistic block count — trips it.
        """
        tip = self.chain.tip
        if self.chain.retarget is None:
            return tip
        bound = int(self.clock.wall()) + ANCHOR_SLACK_S
        if tip.header.timestamp <= bound:
            return tip
        return self.chain.best_block_within(bound)

    def _assemble(self) -> Block:
        parent = self._mining_parent()
        on_tip = parent.block_hash() == self.chain.tip_hash
        height = self.chain.height_of(parent.block_hash()) + 1
        coinbase = Transaction.coinbase(self.miner_id, height)
        if on_tip:
            txs = (
                coinbase,
                *self.mempool.select(max(0, self.config.max_block_txs - 1)),
            )
        else:
            # Policy fork off a poisoned suffix: pool selection is only
            # guaranteed connectable against the TIP's ledger, so carry
            # the coinbase alone until the honest branch takes over.
            txs = (coinbase,)
        ts = max(parent.header.timestamp + 1, int(self.clock.wall()))
        if self.chain.retarget is not None:
            # The shared clamp: largest consensus-valid stamp (strict
            # increase; forward cap from height 2 — a runaway local
            # clock must not assemble a block every peer rejects).
            ts = self.chain.retarget.clamp_timestamp(
                height - 1, parent.header.timestamp, ts
            )
        header = BlockHeader(
            # Version-bits signaling: top-bits + every
            # deployment bit worth signaling on this parent, or the
            # legacy literal 1 when no deployments are configured.
            version=self.versionbits.mining_version(
                self.chain, parent.block_hash()
            ),
            prev_hash=parent.block_hash(),
            merkle_root=merkle_root([tx.txid() for tx in txs]),
            timestamp=ts,
            # What consensus requires of the next block — equals the
            # configured difficulty unless a retarget rule has moved it.
            difficulty=self.chain.required_difficulty(parent.block_hash()),
            nonce=0,
        )
        return Block(header, txs)

    async def _mine_loop(self) -> None:
        try:
            await self._mine_loop_inner()
        except asyncio.CancelledError:
            raise
        except Exception:
            # A silently dead miner looks like a healthy idle node; make
            # the failure loud here — stop_mining() swallows (logs) the
            # re-raise so teardown still completes.
            self.log.exception("mining loop died")
            raise

    async def _mine_loop_inner(self) -> None:
        import threading

        loop = asyncio.get_running_loop()
        while self._running:
            if (
                self._store_degraded
                or self.governor.shedding
                or self.validation_state != VALIDATED
            ):
                # Serve-only / SHED / ASSUMED: a sealed block would be
                # refused at the door (degraded disk), assembled under
                # memory pressure the node is trying to shed, or built
                # on state this node has not yet validated (mining on an
                # assumed tip would WAGER hashpower on a peer's claim) —
                # don't burn the CPU.  Mining resumes when the state
                # clears / the revalidation flips.
                await asyncio.sleep(0.25)
                continue
            candidate = self._assemble()
            self._abort = threading.Event()
            t0 = self.clock.monotonic()
            sealed = await loop.run_in_executor(
                None, self.miner.search_nonce, candidate.header, self._abort
            )
            stats = self.miner.last_stats
            self.metrics.hashes_done += stats.hashes_done
            self.metrics.mine_elapsed_s += stats.elapsed_s
            if sealed is None:
                continue  # aborted: tip moved under us, reassemble
            block = Block(sealed, candidate.txs)
            self.metrics.blocks_mined += 1
            self.metrics.last_block_time_s = self.clock.monotonic() - t0
            self.log.info(
                "mined height=%d nonce=%d txs=%d t=%.3fs hps=%.0f",
                self.chain.height + 1,
                sealed.nonce,
                len(block.txs),
                self.metrics.last_block_time_s,
                stats.hashes_per_sec,
            )
            # Shield the post-seal handling.  add_block + gossip happen
            # inside the _post_seal task, which cancellation of THIS loop
            # cannot kill; the guarantee that the sealed block lands in the
            # chain and reaches peers comes from stop_mining()/stop()
            # awaiting _post_seal, NOT from any ordering within this loop.
            # Without the shield, cancellation between add_block and the
            # gossip send strands the miner one block ahead forever.
            self._post_seal = asyncio.create_task(
                self._handle_block(block, origin=None)
            )
            await asyncio.shield(self._post_seal)
            self._post_seal = None
            await asyncio.sleep(0)  # let gossip/tx handlers breathe

    # -- introspection ---------------------------------------------------

    def peer_count(self) -> int:
        return len(self._peers)

    def telemetry_snapshot(self) -> dict:
        """The METRICS wire payload (`p1 metrics`): the registry dump
        plus just enough identity to label a scrape.  Distinct from
        ``status()`` — that is the curated operator view; this is the
        raw catalog every exporter renders from.

        The validation-backend counters (keys.STATS) are
        synced into registry gauges HERE, on the export path only:
        they are process-wide accumulators owned by core/keys.py, and
        mirroring them at verify time would put a registry write on the
        hot validation path for a number only scrapes read.  Gauges
        (not counters) because the registry copy is a mirror, not the
        source of truth."""
        for name, value in (
            ("validation.sigs_serial", keys.STATS.serial),
            ("validation.sigs_batched", keys.STATS.batched),
            ("validation.sigs_cached", self.sig_cache.hits),
            *(
                (f"validation.backend.{b}", keys.STATS.backends.get(b, 0))
                for b in keys.SIG_BACKENDS
            ),
        ):
            self.telemetry.gauge(name).value = value
        return {
            "role": "node",
            "miner_id": self.miner_id,
            "height": self.chain.height,
            **self.telemetry.snapshot(),
        }

    def status(self) -> dict:
        """The two BASELINE metrics + node state, JSON-ready."""
        return {
            "miner_id": self.miner_id,
            "height": self.chain.height,
            "tip": self.chain.tip_hash.hex(),
            "peers": self.peer_count(),
            "known_addrs": len(self._known_addrs) + len(self._tried_addrs),
            "banned_hosts": sum(
                1
                for until in self._banned_until.values()
                if until > self.clock.monotonic()
            ),
            "mempool": len(self.mempool),
            "hashes_per_sec": round(self.metrics.hashes_per_sec),
            "time_to_block_s": round(self.metrics.last_block_time_s, 3),
            "blocks_mined": self.metrics.blocks_mined,
            "blocks_accepted": self.metrics.blocks_accepted,
            "reorgs": self.metrics.reorgs,
            "txs_accepted": self.metrics.txs_accepted,
            "propagation": self.metrics.propagation_summary(),
            # Compact block relay effectiveness (BIP152-style gossip).
            "compact": {
                "sent": self.metrics.cblocks_sent,
                "received": self.metrics.cblocks_received,
                "tx_hits": self.metrics.cblock_tx_hits,
                "tx_fetched": self.metrics.cblock_tx_fetched,
                "bytes_saved": self.metrics.cblock_bytes_saved,
            },
            "wire": {
                "bytes_sent": self.metrics.bytes_sent,
                "bytes_received": self.metrics.bytes_received,
                # Per-family relay-byte attribution: where
                # this node's outbound bandwidth actually went, keyed by
                # _RELAY_ACCOUNTING family ("tx" + "recon" = the relay
                # plane the reconciliation work budgets).
                "relay_bytes": self.metrics.relay_bytes(),
            },
            # Set-reconciliation relay (node/reconcile.py):
            # round outcomes plus the per-link plane state.
            "recon": {
                "enabled": self._recon_enabled(),
                "rounds": self.metrics.recon_rounds,
                "sketches_served": self.metrics.recon_sketches_served,
                "success": self.metrics.recon_success,
                "fallbacks": self.metrics.recon_fallbacks,
                "demotions": self.metrics.recon_demotions,
                "txs_reconciled": self.metrics.txs_reconciled,
                "active_links": sum(
                    1
                    for p in self._peers.values()
                    if self._recon_peer_active(p, self.clock.monotonic())
                ),
                "pending": sum(
                    len(p.recon_pending) for p in self._peers.values()
                ),
            },
            "liveness": {
                "pings_sent": self.metrics.pings_sent,
                "peers_evicted_idle": self.metrics.peers_evicted_idle,
            },
            # Request supervision: sync-stall detection and failover
            # (node/supervision.py) — how often catch-up was rescued
            # from a non-serving peer.
            "sync": {
                "stalls": self.metrics.sync_stalls,
                "failovers": self.metrics.sync_failovers,
                "demotions": self.metrics.sync_demotions,
                "exhausted": self.metrics.sync_exhausted,
                "cblock_fetch_stalls": self.metrics.cblock_fetch_stalls,
                "mempool_stalls": self.metrics.mempool_sync_stalls,
            },
            # Storage durability: disk health (degraded = serve-only
            # mode after ENOSPC/EIO, recovering under backoff) plus what
            # the store's startup scan had to quarantine or truncate
            # (chain/store.py's v3 checksum framing).
            "storage": {
                "persistent": self.store is not None,
                "degraded": self._store_degraded,
                "errors": self.metrics.store_errors,
                "retries": self.metrics.store_retries,
                "recoveries": self.metrics.store_recoveries,
                "blocks_deferred": self.metrics.store_blocks_deferred,
                "pending_records": len(self._store_pending),
                "last_error": self._store_last_error,
                "healed": dict(self.store.healed)
                if self.store is not None
                else None,
                # Segmented layout + pruned mode: the
                # wire-visible ``pruned`` posture — a syncing peer
                # reading this knows not to ask us for deep history.
                "segmented": getattr(self.store, "segments", None)
                is not None
                and len(getattr(self.store, "segments", ())) > 0,
                "pruned": {
                    "enabled": self.config.prune_keep_blocks > 0,
                    "keep_blocks": self.config.prune_keep_blocks,
                    "floor": self.chain.prune_floor,
                    "segments_pruned": self.metrics.store_segments_pruned,
                    "refusals": self.metrics.pruned_refusals,
                },
            },
            # Overload resilience (node/governor.py): SHED state +
            # hysteresis over the accounted memory gauge, per-peer
            # admission drops, write-queue enforcement, and the
            # memory-bounded operation telemetry (bodies evicted from
            # the RAM index / refetched on demand from the store).
            "overload": {
                **self.governor.snapshot(),
                "resident_body_bytes": self.chain.resident_body_bytes,
                "bodies_evicted": self.chain.bodies_evicted,
                "body_refetches": self.chain.body_refetches,
                "body_cache_blocks": self.config.body_cache_blocks,
                "mining_paused": self.governor.shedding
                or self._store_degraded
                or self.validation_state != VALIDATED,
            },
            # Staged pipeline (node/pipeline.py): per-stage
            # queue depths + worker liveness — an operator reading a
            # growing store depth is watching disk back-pressure form
            # before the governor sheds on it.
            "pipeline": {
                **self.pipeline.status(),
                "worker_respawns": self.metrics.worker_respawns,
            },
            # Untrusted snapshot sync (chain/snapshot.py): the
            # node's trust posture and the snapshot plane's telemetry —
            # an operator reading "assumed" knows every answer is
            # conditioned on a snapshot still being revalidated.
            "snapshot": {
                "state": self.validation_state,
                "base_height": self.chain.base_height,
                "checkpoint_interval": self.chain.checkpoint_interval,
                "checkpoints": len(self.chain.state_checkpoints),
                "fetching": self._snap_fetch is not None,
                "revalidating": self._bg_chain is not None,
                "bg_height": (
                    self._bg_chain.height
                    if self._bg_chain is not None
                    else None
                ),
                "fetches": self.metrics.snapshot_fetches,
                "chunks_served": self.metrics.snapshot_chunks_served,
                "flips": self.metrics.snapshot_flips,
                "divergences": self.metrics.snapshot_divergences,
                "fallbacks": self.metrics.snapshot_fallbacks,
                "stalls": self.metrics.snapshot_stalls,
                "revalidated_blocks": self.metrics.revalidated_blocks,
            },
            # The always-on maintenance plane: what the node
            # has done to itself while serving — live re-bases, online
            # prune/compact — plus the continuous-snapshot economics
            # (incremental builds vs chunks reused) and the
            # version-bits activation report.
            "maintenance": self.maintenance_report(),
            # Query serving plane: read-traffic counters (how
            # many proofs/filters this node served and at what cache hit
            # rate) — the host-side view of the tier benchmarks/
            # query_plane.py measures; replica workers (`p1 serve`)
            # report their own copy of this block over GETSTATUS.
            "queries": {
                "proofs_served": self.metrics.proofs_served,
                "filters_served": self.metrics.filters_served,
                "filter_bytes_served": self.metrics.filter_bytes_served,
                "proof_cache": self.chain.proof_cache.snapshot(),
                "filter_cache": self.chain.filter_index.snapshot(),
            },
            # Wallet push plane (node/subscriptions.py): live
            # watch sessions, the degradation ladder's counters
            # (coalesced/dropped/disconnected — a slow wallet degrades,
            # the write gauge does not balloon), cursor replays, and
            # the filter-header commitment chain's span.
            "subscriptions": {
                **self.subscriptions.snapshot(),
                "filter_headers": len(self.chain.filter_headers),
            },
            # Validation fast lane: the verify-once signature
            # cache (this node's instance — hits are blocks connecting
            # without re-paying Ed25519 for mempool-resident transfers)
            # plus the process-wide backend accounting (how many
            # signatures went through batch calls vs one-at-a-time, and
            # on which backend).
            "validation": {
                **self.sig_cache.snapshot(),
                "batched": keys.STATS.batched,
                "batches": keys.STATS.batches,
                "serial": keys.STATS.serial,
                "pool_dispatches": keys.STATS.pool_dispatches,
                # backend_label, not backend(): a GETSTATUS served on
                # the loop reads the memoized name and never resolves
                # the ladder itself.
                "backend": keys.backend_label(),
                # Per-backend signature counts (ladder) — the
                # key set is FIXED (every rung always present, zeros
                # included) so the status wire contract stays
                # byte-pinnable (tests/test_telemetry.py STATUS_KEYS).
                "backends": {
                    name: keys.STATS.backends.get(name, 0)
                    for name in keys.SIG_BACKENDS
                },
                "workers": keys.verify_workers(),
            },
            # Conservation probe: with a coinbase in every block (ours) and
            # fees credited to miners, the ledger must sum to exactly
            # BLOCK_REWARD x height — any double-spend or bad reorg undo
            # breaks this, so `p1 net` audits it across all nodes.
            "ledger_sum": sum(self.chain.balances_snapshot().values()),
        }
