"""Node-wide resource governor: overload as a first-class, survivable state.

The third leg of the degradation triad.  Sync-stall failover
handles peers that starve us; the storage durability layer
handles a disk that fails us; this module handles peers that give us TOO
MUCH — protocol-valid block/tx/query floods that, before it existed, could
grow node memory (the unbounded in-RAM chain index above all) or starve
honest traffic until the process OOMed.  Bitcoin Core's answer is the
model (PAPERS.md lineage: ``-maxmempool`` eviction, orphan-pool caps,
BIP152 bandwidth discipline): every queue bounded, every peer budgeted,
degradation explicit.  Three layers:

- **Admission control** — per-PEER token buckets, one per traffic class
  (``blocks`` / ``txs`` / ``queries``), generalizing the per-host ADDR
  budget that already guards the address book.  An over-budget frame is
  dropped at the dispatch door (the chain/mempool/reply machinery never
  sees it), and sustained flooding past the budget escalates to the
  node's existing misbehavior score — one violation per
  ``DROPS_PER_VIOLATION`` drops, so an honest burst that clips the
  budget by a few frames is never scored while a flood earns its ban.
  Solicited replies (BLOCKS, MEMPOOL, HEADERS, BLOCKTXN, ...) are never
  charged: we asked for them, and charging them would let the budget
  starve our own IBD.

- **Memory-bounded operation** — the chain evicts block *bodies* from
  the RAM index once they are safely in the append-only store
  (``Chain.evict_bodies`` + ``ChainStore.read_body``), keeping headers
  and metadata resident; anything evicted is refetched on demand.  The
  governor owns the policy (how many recent bodies stay hot, when to
  sweep); the mechanism lives in chain/store.

- **Load shedding** — above a high watermark on the node's *accounted*
  memory gauge (resident chain bodies + pending pool bytes + peer write
  buffers — deterministic and reversible, unlike OS RSS, which CPython's
  allocator rarely returns) the node enters a SHED state mirroring the
  storage layer's serve-only mode: low-priority traffic (tx gossip,
  mempool pages, address chatter, fee/account queries) is dropped,
  consensus-critical service (headers, blocks, proofs, block ingest)
  keeps running, and mining pauses.  Hysteresis: NORMAL resumes only
  below ``low_fraction`` x the watermark, so the state can't flap at the
  boundary.

Pure state machines over an injectable clock (testable without
sleeping), like ``node/supervision.py``; the node owns every send,
every score, and the gauge computation.
"""

from __future__ import annotations

import enum
import time

__all__ = [
    "TokenBucket",
    "PeerBudget",
    "ResourceGovernor",
    "OverloadState",
    "CLASS_BLOCKS",
    "CLASS_TXS",
    "CLASS_QUERIES",
]

#: Traffic classes.  ``blocks`` = unsolicited block pushes (BLOCK,
#: CBLOCK); ``txs`` = unsolicited transaction pushes (TX); ``queries`` =
#: everything a peer asks us to compute or serve (GETBLOCKS, GETHEADERS,
#: GETMEMPOOL, GETACCOUNT, GETPROOF, GETFEES, GETADDR, GETBLOCKTXN,
#: GETSTATUS).  ADDR keeps its own dedicated per-host budget (node.py
#: ``_addr_budgets``) — it guards a different resource (the address
#: book), with different crediting rules.
CLASS_BLOCKS = "blocks"
CLASS_TXS = "txs"
CLASS_QUERIES = "queries"

#: (refill rate tokens/s, burst cap) per class.  Sized generously above
#: any honest peer — and the blocks class is additionally REFUNDED for
#: every push that connects as a new block (``PeerBudget.refund``), so
#: an honest miner never exhausts it no matter how fast the mesh mines:
#: what the refill rate must actually cover is the honest *duplicate*
#: rate, the relay race where several peers push the same block and all
#: but the first arrival is a (charged) dup.  A 3-node localhost
#: byzantine soak at difficulty 12 measures ~95 dup/s per peer at
#: ~190 blocks/s network-wide — the 128/s refill sits above that
#: regime's ceiling while a replay flood (thousands/s of the same
#: block) still hits the cliff in under a second past the burst.  Tx
#: gossip forwards each admission once; queries come one per sync round.
DEFAULT_RATES: dict[str, tuple[float, float]] = {
    CLASS_BLOCKS: (128.0, 1024.0),
    CLASS_TXS: (64.0, 1024.0),
    CLASS_QUERIES: (32.0, 256.0),
}

#: Over-budget drops in one class before ONE misbehavior violation is
#: charged.  An honest burst clips the budget by a handful of frames at
#: worst; a flood crosses this every second or two and earns the
#: existing 3-violations ban.
DROPS_PER_VIOLATION = 64

#: Per-peer outbound write-buffer cap, bytes.  A peer that sends queries
#: but never reads replies grows OUR transport buffer — the write-queue
#: squat.  Past the cap the peer is disconnected: the data it refused to
#: read is re-fetchable, the memory is not.  Comfortably above one
#: full sync reply (SYNC_BYTES = 8 MB) plus gossip slack.
WRITE_QUEUE_MAX = 12 << 20

#: Gossip (best-effort) sends additionally skip peers whose buffer is
#: already past this softer bound — no reason to queue a push behind
#: megabytes of unread replies; the peer heals via locator sync.
WRITE_QUEUE_GOSSIP_MAX = 2 << 20

#: Hard cap on compact-block reconstructions a single peer may hold
#: open.  The global FIFO (MAX_PENDING_CBLOCKS) bounds the total; this
#: bounds how much of it one peer can squat — each slot pins a partially
#: rebuilt block (up to a full block's transactions) in RAM.
PENDING_CBLOCKS_PER_PEER = 8


class OverloadState(enum.Enum):
    NORMAL = "normal"
    SHED = "shed"


class TokenBucket:
    """The refilled token bucket, extracted from the ADDR-budget inline
    lists into a primitive with testable invariants:

    - ``tokens`` never exceeds ``burst`` through refill alone, and never
      exceeds ``grant_cap`` through grants;
    - refill accrues at ``rate`` tokens/s from the last observation and
      never runs backward (a clock that stalls refills nothing);
    - credit sitting above ``burst`` (solicited grants) is never clawed
      back by a refill observation — the ADDR lesson.
    """

    __slots__ = ("rate", "burst", "grant_cap", "tokens", "stamp", "_clock")

    def __init__(
        self,
        rate: float,
        burst: float,
        *,
        grant_cap: float | None = None,
        clock=time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = float(burst)
        self.grant_cap = float(grant_cap) if grant_cap is not None else 4 * self.burst
        self.tokens = self.burst
        self._clock = clock
        self.stamp = clock()

    def _refill(self) -> None:
        now = self._clock()
        if self.tokens < self.burst:
            elapsed = max(0.0, now - self.stamp)
            self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self.stamp = now

    def take(self, n: float = 1.0) -> bool:
        """Spend ``n`` tokens if available; False (and no spend) if not."""
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def grant(self, n: float) -> None:
        """ADD solicited credit (bounded by ``grant_cap``) — additive,
        not set-to-max, for the same reason as the ADDR budget: two
        solicited replies in flight must not race for one refill."""
        self._refill()
        self.tokens = min(self.grant_cap, self.tokens + n)

    def peek(self) -> float:
        self._refill()
        return self.tokens


class PeerBudget:
    """One peer's admission state: a bucket per traffic class plus the
    drop tallies that escalate to misbehavior scoring."""

    __slots__ = ("buckets", "dropped", "_pending_violation")

    def __init__(self, rates=None, clock=time.monotonic):
        rates = DEFAULT_RATES if rates is None else rates
        self.buckets = {
            cls: TokenBucket(rate, burst, clock=clock)
            for cls, (rate, burst) in rates.items()
        }
        self.dropped = {cls: 0 for cls in self.buckets}
        self._pending_violation = {cls: 0 for cls in self.buckets}

    def admit(self, cls: str) -> bool:
        """True = within budget.  False = drop the frame; the counters
        advance and ``owes_violation`` may fire."""
        if self.buckets[cls].take():
            return True
        self.dropped[cls] += 1
        self._pending_violation[cls] += 1
        return False

    def refund(self, cls: str) -> None:
        """Return one admission charge — the node refunds a pushed block
        that connected as NEW: PoW makes new blocks self-limiting (an
        attacker cannot mint them faster than the honest mesh), so
        refunding them keeps the budget a pure duplicate/spam throttle
        that no honest mining rate can exhaust."""
        self.buckets[cls].grant(1.0)

    def owes_violation(self, cls: str) -> bool:
        """True once per ``DROPS_PER_VIOLATION`` drops in ``cls`` —
        consumed: the caller charges the misbehavior score exactly once."""
        if self._pending_violation[cls] >= DROPS_PER_VIOLATION:
            self._pending_violation[cls] = 0
            return True
        return False


class ResourceGovernor:
    """The node-wide overload state machine + admission front door.

    The node computes the memory gauge (it owns the chain, the pool, and
    the sockets) and calls ``observe(tracked_bytes)`` from its tick
    loops; everything else is bookkeeping over that number and the
    per-peer budgets.
    """

    def __init__(
        self,
        *,
        watermark_bytes: int = 0,
        low_fraction: float = 0.8,
        admission: bool = True,
        rates: dict[str, tuple[float, float]] | None = None,
        write_queue_max: int = WRITE_QUEUE_MAX,
        clock=time.monotonic,
    ):
        #: High watermark on the accounted gauge; 0 disables shedding
        #: (admission control and write-queue caps stay on — they are
        #: free and bound per-peer resources regardless).
        self.watermark_bytes = int(watermark_bytes)
        self.low_watermark_bytes = int(low_fraction * self.watermark_bytes)
        self.admission = admission
        self.rates = DEFAULT_RATES if rates is None else rates
        self.write_queue_max = int(write_queue_max)
        self._clock = clock
        self.state = OverloadState.NORMAL
        #: Last observed gauge (surfaced by status()).
        self.tracked_bytes = 0
        #: Peak of the gauge over the governor's lifetime (soak assertions).
        self.tracked_peak_bytes = 0
        # -- counters (mirrored into NodeMetrics by the node) --
        self.sheds = 0  # NORMAL -> SHED transitions
        self.shed_drops = 0  # frames dropped because state is SHED
        self.admission_drops = {cls: 0 for cls in self.rates}
        self.write_queue_drops = 0  # gossip sends skipped (soft bound)
        self.peers_dropped_squat = 0  # sessions ended at the hard cap
        self.cblock_slot_drops = 0  # per-peer reconstruction cap hits

    # -- admission ---------------------------------------------------------

    def budget(self) -> PeerBudget:
        """A fresh per-peer budget (the node hangs it on the session)."""
        return PeerBudget(self.rates, clock=self._clock)

    def admit(self, budget: PeerBudget, cls: str) -> bool:
        """Admission verdict for one frame of class ``cls``."""
        if not self.admission:
            return True
        if budget.admit(cls):
            return True
        self.admission_drops[cls] += 1
        return False

    # -- load shedding -----------------------------------------------------

    @property
    def shedding(self) -> bool:
        return self.state is OverloadState.SHED

    def observe(self, tracked_bytes: int) -> bool:
        """Feed one gauge observation; returns True when the state
        changed (the node logs transitions)."""
        self.tracked_bytes = int(tracked_bytes)
        if self.tracked_bytes > self.tracked_peak_bytes:
            self.tracked_peak_bytes = self.tracked_bytes
        if self.watermark_bytes <= 0:
            return False
        if (
            self.state is OverloadState.NORMAL
            and self.tracked_bytes > self.watermark_bytes
        ):
            self.state = OverloadState.SHED
            self.sheds += 1
            return True
        if (
            self.state is OverloadState.SHED
            and self.tracked_bytes < self.low_watermark_bytes
        ):
            self.state = OverloadState.NORMAL
            return True
        return False

    def shed_drop(self) -> None:
        self.shed_drops += 1

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``status()["overload"]`` block."""
        return {
            "state": self.state.value,
            "tracked_bytes": self.tracked_bytes,
            "tracked_peak_bytes": self.tracked_peak_bytes,
            "watermark_bytes": self.watermark_bytes,
            "sheds": self.sheds,
            "shed_drops": self.shed_drops,
            "admission_dropped": dict(self.admission_drops),
            "write_queue_drops": self.write_queue_drops,
            "peers_dropped_squat": self.peers_dropped_squat,
            "cblock_slot_drops": self.cblock_slot_drops,
        }
