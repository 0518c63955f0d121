"""P2P wire protocol: length-prefixed binary frames.

Capability parity: the reference's gossip protocol (BASELINE.json:5,10).
Frame = 4-byte big-endian payload length + 1-byte message type + payload.
Deterministic binary payloads reuse the core serializers, so a message's
bytes are exactly the consensus bytes — nothing to re-canonicalize.

Messages:

- HELLO:     genesis hash (32) + tip height (4) + listen port (2) + u64
             instance nonce (random per node process — a node that
             receives its OWN nonce back just dialed itself via a
             gossiped address and drops the connection, Bitcoin's
             self-connect detection).  Sent both ways on connect; genesis
             mismatch = disconnect.
- BLOCK:     f64 sender wall-clock send time + one serialized block (push
             gossip).  The timestamp is *telemetry only* — receivers use
             it to measure propagation delay (send -> accept), never for
             consensus.  Clocks are trusted to the extent NTP keeps hosts
             in sync; the benchmark topology is localhost, where the skew
             is zero by construction (gossip round-trip timing).
- TX:        one serialized transaction (push gossip).
- GETBLOCKS: u16 count + count * 32-byte locator hashes (sync request).
             Requester-side contract (not wire-visible): every
             multi-round fetch — this, GETBLOCKTXN, paged GETMEMPOOL,
             and the light client's GETHEADERS loop — runs under
             request supervision (node/supervision.py): the requester
             holds a *progress* deadline over the round and re-issues
             to a different peer when nothing advances, so serving
             slowly-but-surely is always safe while serving nothing
             (however chattily) forfeits the sync to someone else.
- BLOCKS:    u16 count + count * (u32 len + serialized block) (sync reply).
- GETMEMPOOL: empty body (start of sync) or u64 fee + 32-byte txid — the
             stable cursor of the last transaction already received; the
             reply covers fee-descending (txid-ascending) keys strictly
             after it.
- GETACCOUNT: u8 len + account id bytes — query one account's consensus
             state at the peer's tip (balance, nonce) plus the next
             usable seq net of the peer's own pending pool (what a wallet
             should sign next).  Serves `p1 account` and `p1 tx`'s
             auto-seq.
- ACCOUNT:   u8 len + account + u64 balance + u64 nonce + u64 next_seq +
             u32 tip height (the reply's reference point).
- MEMPOOL:   u8 more + u16 count + count * (u16 len + serialized tx).
             Late joiners learn in-flight transactions this way
             (blocks-only sync would leave their pools empty); pools
             larger than one reply continue while ``more`` is set.  A key
             cursor, not a positional one: pool churn between pages can't
             skip entries, and the requester enforces strictly-advancing
             cursors so a hostile responder can't loop it.
- GETPROOF:  32-byte txid — request an SPV inclusion proof for a
             main-chain-confirmed transaction (`p1 proof`).
- PROOF:     u8 found; if found: u32 height + u32 tip height + u32 tx
             index + 80-byte header + u16 branch count + count * 32-byte
             merkle siblings + u16 tx len + serialized tx.  The client
             verifies PoW + merkle branch + tx validity itself
             (p1_tpu_torch/chain/proof.py) — the reply is evidence, not an
             assertion to trust.
- CBLOCK:    compact block push (BIP152's idea, full-txid form): f64 send
             timestamp + 80-byte header + u16 ntx + u16 n_prefilled +
             n_prefilled * (u16 index + u32 len + raw tx) + one 32-byte
             txid per remaining transaction, in block order.  The sender
             prefills what receivers cannot have (the coinbase); the
             receiver reconstructs the rest from its mempool — txids are
             full SHA-256d hashes of the exact wire bytes, so a match IS
             the transaction (no BIP152 short-id collision handling
             needed) — and fetches whatever it lacks with GETBLOCKTXN.
- GETBLOCKTXN: 32-byte block hash + u16 count + count * u16 ascending tx
             indices the requester could not reconstruct.
- BLOCKTXN:  32-byte block hash + u16 count + count * (u32 len + raw tx)
             answering a GETBLOCKTXN, same index order as requested.
- GETADDR:   empty body — ask a peer for addresses of other nodes it
             knows (peer discovery; asked once per session).
- ADDR:      u16 count + count * (u16 port + u8 len + utf-8 host) —
             known listening addresses.  Receivers merge them into a
             bounded address book; with ``--target-peers N`` set a node
             dials discovered addresses until it holds N connections, so
             a new node bootstraps the whole network from one seed peer.
- GETFEES:   u16 window (blocks to sample; 0 = server default) — fee
             estimation query (`p1 fees`, `p1 tx --fee auto`).
- FEES:      u16 window used + u32 sample count + u64 p25/p50/p75 fee
             percentiles over transfers confirmed in the window + u32 tip
             height.  Confirmed fees only: what actually cleared, not the
             pending bid book.
- PING:      u64 nonce — keepalive probe.  A node that has heard nothing
             from a peer for its idle interval sends one; ANY frame (not
             just the PONG) counts as liveness, so a busy peer never
             wastes a round trip.  A peer that stays silent through the
             probe's answer window is evicted and its slot reused — the
             liveness layer every Bitcoin-family node carries, without
             which 64 cheap silent sockets pin MAX_PEERS forever.
- PONG:      u64 nonce echoed from the PING.  Tooling clients answer too
             (node/client.py) so a slow SPV sync isn't evicted as dead.
- GETHEADERS: u16 count + count * 32-byte locator hashes — headers-first
             sync for light clients (`p1 headers`): same locator
             semantics as GETBLOCKS, but the reply carries bare headers.
- GETSTATUS: empty body — operator probe (`p1 status`): ask a running
             node for its full status JSON (height, peers, sync/storage/
             overload state).  Served even in the SHED overload state:
             overload must stay observable while it is happening.
- STATUS:    the node's ``status()`` dict as canonical JSON (utf-8).
             Deliberately JSON, not a packed layout — the status surface
             grows every round and must not cost a version bump per
             field.
- HEADERS:   u16 count + count * 80-byte serialized headers, main chain
             ascending from the first recognized locator hash.  A light
             client iterates GETHEADERS until the reply is empty, then
             verifies the whole chain itself (replay_host — PoW, linkage,
             and the retarget difficulty schedule), needing ~80 B/block
             instead of full blocks and trusting nothing but work.
- GETFILTERS: u32 start height + u16 count — request the compact block
             filters (chain/filters.py, BIP158 analog) for a main-chain
             height range.  A light client that has synced headers
             downloads the filter stream, matches its own accounts/txids
             LOCALLY, and fetches only the (rare) matching blocks — sync
             by filter match instead of per-address queries.
- FILTERS:   u32 start height + u16 count + count * (32-byte block hash
             + u32 filter len + filter bytes), heights ascending from
             the requested start.  The block hash lets the client pin
             each filter to its independently verified header chain; the
             filter itself is a Golomb-coded set over the block's txids
             and account ids with zero false negatives (a non-match is
             proof of absence).  The server caps ``count`` like the
             other range queries — ask again from where the reply ended.
- GETSNAPSHOT: u32 start chunk + u16 count — snapshot-state sync
             (chain/snapshot.py).  count 0 asks for the MANIFEST
             (height, block hash, state root, per-chunk digests, the
             full anchor block); count >= 1 asks for that chunk range.
             Served range-capped and governor-admitted like every
             other query; an ASSUMED node answers "none" (it must not
             relay state it has not itself validated).
- GETMETRICS: empty body — telemetry probe (`p1 metrics`): ask a node
             (or a `p1 serve` replica) for its metrics registry snapshot
             (node/telemetry.py — counters, gauges, per-stage latency
             histograms).  Unlike GETSTATUS it IS shed under overload:
             the status probe is the minimal health signal and stays up;
             the full latency export is a capacity consumer an
             overloaded node may refuse.
- METRICS:   the registry snapshot as canonical JSON (utf-8) — same
             growth-without-version-bump rationale as STATUS.
- SNAPSHOT:  u8 kind — 0 none (no snapshot available), 1 manifest
             (u32 len + manifest payload), 2 chunks (u32 start + u16
             count + count * (u32 len + chunk payload)).  Everything
             inside is checkable against the manifest: the receiver
             verifies each chunk's digest AS IT ARRIVES and the state
             root at the end — a peer lying mid-transfer is caught on
             the first bad chunk.  The payloads are exactly the
             snapshot-file records, so wire and disk cannot drift.
- GETMAINTAIN: a maintenance command as canonical JSON (utf-8):
             ``{"op": "status"}`` reports the maintenance plane
             (version-bits deployment states, rebase/prune/compact
             counters, busy flag); ``{"op": "rebase", "keep": N}``,
             ``{"op": "prune", "keep": N}`` and ``{"op": "compact"}``
             run the corresponding zero-downtime operation on a live
             node (`p1 maintain`).  JSON like STATUS: the operator
             surface grows, the wire version must not.
- MAINTAIN:  the maintenance reply as canonical JSON — ``{"ok": bool,
             ...}`` with op-specific fields (the rebase result, prune
             floor, compaction stats, or the status report).  Errors
             come back as ``{"ok": false, "error": "..."}`` rather
             than a dropped session: a refused maintenance command is
             an answer, not a protocol violation.
- REQRECON:  u8 full + u32 set size — open one set-reconciliation round
             (node/reconcile.py, the Erlay-analog relay plane): "my
             pending-announcement window for you holds N short IDs;
             sketch yours".  ``full`` = 1 asks the responder to sketch
             its WHOLE pool (the initial mempool sync sharing the
             short-ID machinery) instead of just the pending window.
             The set size feeds the responder's capacity estimate; it
             is advisory, never trusted past the capacity clamp.
- SKETCH:    u32 set size + u16 word count + words * u32 syndromes —
             the reconciliation sketch reply (word count is capped at
             MAX_CAPACITY + 1; anything larger is a protocol
             violation, the sketch-poisoning bound).  The requester
             XORs its own equal-capacity sketch over the same salted
             short-ID space and decodes the symmetric difference.
- RECONCILDIFF: u8 success + u16 count + count * u32 short IDs — the
             round-closing frame from the initiator.  success=1 lists
             the decoded difference (the responder serves its side as
             TX pushes and clears its frozen window); success=0 means
             the difference exceeded the sketch capacity or the bytes
             did not decode — both sides fall back to FLOOD for the
             frozen window, so reconciliation failure costs bandwidth,
             never transactions.
- GETTX:     u16 count + count * u32 short IDs — fetch transactions by
             salted short ID (the fallback/fetch half of the exchange:
             the initiator asks for diff elements it cannot map
             locally).  Unknown IDs are skipped, not errors — a missed
             tx arrives on a later round or in a block.

The port's copy of ``p1_tpu/node/protocol.py``: every frame byte for byte
the reference's, so nodes of both packages share one network.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import struct
import time

from p1_tpu_torch.chain.proof import TxProof
from p1_tpu_torch.core.block import Block
from p1_tpu_torch.core.header import HEADER_SIZE, BlockHeader
from p1_tpu_torch.core.tx import Transaction
from p1_tpu_torch.node.reconcile import MAX_CAPACITY as RECON_MAX_CAPACITY

class ProtocolError(ValueError):
    """The peer sent bytes that violate the protocol (malformed frame,
    wrong version, unparsable payload).  A dedicated subclass so the
    node's misbehavior scoring can tell PEER-side faults apart from
    ValueErrors raised by our own encode paths — only the former may
    count against the remote."""


class ChainMismatch(ProtocolError):
    """A well-formed HELLO for the wrong chain or protocol version.
    Still ends the session — but as *misconfiguration*, not hostility:
    the node's ban scoring must ignore it, or three wallet invocations
    with the wrong --difficulty/retarget flags inside the scoring window
    would ban 127.0.0.1 and refuse a whole localhost mesh.
    Ban scores are reserved for malformed bytes and forgeries."""


MAX_FRAME = 32 << 20  # hard cap against hostile length prefixes
_LEN = struct.Struct(">I")
#: Wire protocol version, carried in HELLO.  Bump when the message surface
#: changes incompatibly — layout changes (v2: BLOCK gained the f64
#: telemetry timestamp, transactions gained chain/pubkey/sig fields) but
#: also pure additions (v3: GETPROOF/PROOF): HELLO enforces strict version
#: equality, so bumping on additions means a mixed-version pair fails the
#: handshake with a clear error instead of dying mid-session the first
#: time the newer side queries a message the older one calls a protocol
#: violation.  The first protocol spoke an unversioned HELLO; its frames fail here as
#: "bad HELLO size".  v4 added compact block relay (CBLOCK/GETBLOCKTXN/
#: BLOCKTXN); v5 headers-first sync (GETHEADERS/HEADERS); v6 peer
#: discovery (GETADDR/ADDR + the HELLO instance nonce); v7 fee
#: estimation (GETFEES/FEES); v8 liveness (PING/PONG + handshake/idle
#: deadlines — a v7 node would call the probe a protocol violation); v9
#: the operator status probe (GETSTATUS/STATUS — `p1 status` renders a
#: running node's full status JSON, overload block included); v10 the
#: query serving plane (GETFILTERS/FILTERS — compact block filters for
#: light-client sync by filter match, chain/filters.py); v11 untrusted
#: snapshot sync (GETSNAPSHOT/SNAPSHOT — chunked ledger-state snapshots
#: with a self-describing manifest, chain/snapshot.py); v12 the
#: telemetry plane (GETMETRICS/METRICS — the metrics registry snapshot
#: of node/telemetry.py, served by nodes and replicas); v13 the
#: maintenance plane (GETMAINTAIN/MAINTAIN — `p1 maintain` drives live
#: re-basing, online prune/compact, and version-bits status on a
#: running node without restarting it); v14 the wallet push plane
#: (SUBSCRIBE/EVENT/UNSUBSCRIBE — watch-filter subscriptions pushed at
#: block connect with gap-free resume cursors — plus GETFILTERHEADERS/
#: FILTERHEADERS, the BIP157-analog filter-header commitment chain a
#: wallet cross-checks untrusted filter streams against); v15 the
#: bandwidth-scale relay plane (REQRECON/SKETCH/RECONCILDIFF/GETTX —
#: Erlay-analog set-reconciliation tx gossip over salted short IDs,
#: node/reconcile.py, with flood kept as the fallback and for block
#: announces).
PROTOCOL_VERSION = 15
_HELLO = struct.Struct(">B32sIHQ")


class MsgType(enum.IntEnum):
    """One byte after the length prefix.  Every member must thread the
    whole wire contract — encoder, ``_decode`` arm, ``_dispatch`` arm,
    admission class (node.py ``_MSG_CLASS``/``_ADMISSION_EXEMPT``),
    SHED classification (``_SHED_DROPS``/``_SHED_KEEPS``), and a
    ``MSG_SINCE`` version row — enforced structurally by the
    ``wire-contract`` lint rule and at import by the asserts beside
    each table."""

    HELLO = 1
    BLOCK = 2
    TX = 3
    GETBLOCKS = 4
    BLOCKS = 5
    GETMEMPOOL = 6
    MEMPOOL = 7
    GETACCOUNT = 8
    ACCOUNT = 9
    GETPROOF = 10
    PROOF = 11
    CBLOCK = 12
    GETBLOCKTXN = 13
    BLOCKTXN = 14
    GETHEADERS = 15
    HEADERS = 16
    GETADDR = 17
    ADDR = 18
    GETFEES = 19
    FEES = 20
    PING = 21
    PONG = 22
    GETSTATUS = 23
    STATUS = 24
    GETFILTERS = 25
    FILTERS = 26
    GETSNAPSHOT = 27
    SNAPSHOT = 28
    GETMETRICS = 29
    METRICS = 30
    GETMAINTAIN = 31
    MAINTAIN = 32
    SUBSCRIBE = 33
    EVENT = 34
    UNSUBSCRIBE = 35
    GETFILTERHEADERS = 36
    FILTERHEADERS = 37
    REQRECON = 38
    SKETCH = 39
    RECONCILDIFF = 40
    GETTX = 41


#: The wire version that introduced each frame type — the version-gate
#: half of the wire contract.  HELLO enforces strict version equality,
#: so this table is not a negotiation surface; it is the AUDITABLE
#: history the module docstring used to carry only in prose, and the
#: ``wire-contract`` lint rule fails any member without a row (or any
#: row claiming a version newer than ``PROTOCOL_VERSION`` — a frame
#: cannot ship ahead of its version bump).
MSG_SINCE: dict[MsgType, int] = {
    # the v1/v2 baseline surface (the unversioned first protocol,
    # retroactively v1; BLOCK's telemetry stamp and the tx field
    # extensions were the v2 layout change)
    MsgType.HELLO: 1,
    MsgType.BLOCK: 1,
    MsgType.TX: 1,
    MsgType.GETBLOCKS: 1,
    MsgType.BLOCKS: 1,
    MsgType.GETMEMPOOL: 1,
    MsgType.MEMPOOL: 1,
    MsgType.GETACCOUNT: 1,
    MsgType.ACCOUNT: 1,
    MsgType.GETPROOF: 3,
    MsgType.PROOF: 3,
    MsgType.CBLOCK: 4,
    MsgType.GETBLOCKTXN: 4,
    MsgType.BLOCKTXN: 4,
    MsgType.GETHEADERS: 5,
    MsgType.HEADERS: 5,
    MsgType.GETADDR: 6,
    MsgType.ADDR: 6,
    MsgType.GETFEES: 7,
    MsgType.FEES: 7,
    MsgType.PING: 8,
    MsgType.PONG: 8,
    MsgType.GETSTATUS: 9,
    MsgType.STATUS: 9,
    MsgType.GETFILTERS: 10,
    MsgType.FILTERS: 10,
    MsgType.GETSNAPSHOT: 11,
    MsgType.SNAPSHOT: 11,
    MsgType.GETMETRICS: 12,
    MsgType.METRICS: 12,
    MsgType.GETMAINTAIN: 13,
    MsgType.MAINTAIN: 13,
    MsgType.SUBSCRIBE: 14,
    MsgType.EVENT: 14,
    MsgType.UNSUBSCRIBE: 14,
    MsgType.GETFILTERHEADERS: 14,
    MsgType.FILTERHEADERS: 14,
    MsgType.REQRECON: 15,
    MsgType.SKETCH: 15,
    MsgType.RECONCILDIFF: 15,
    MsgType.GETTX: 15,
}
assert set(MSG_SINCE) == set(MsgType), "every frame type needs a version row"
assert all(1 <= v <= PROTOCOL_VERSION for v in MSG_SINCE.values())


@dataclasses.dataclass(frozen=True)
class AccountState:
    account: str
    balance: int
    nonce: int  # confirmed transfers at the tip (consensus nonce)
    next_seq: int  # nonce + the peer's own pending spends (what to sign next)
    tip_height: int


@dataclasses.dataclass(frozen=True)
class CompactBlock:
    """Decoded CBLOCK: everything needed to reconstruct the block from a
    mempool — or to know exactly which transactions to fetch."""

    sent_ts: float
    header: BlockHeader
    ntx: int
    prefilled: tuple[tuple[int, Transaction], ...]  # (index, tx) ascending
    txids: tuple[bytes, ...]  # remaining transactions, block order


@dataclasses.dataclass(frozen=True)
class FeeStats:
    """Decoded FEES reply: confirmed-fee percentiles at the peer's tip."""

    window_blocks: int
    samples: int
    p25: int
    p50: int
    p75: int
    tip_height: int


@dataclasses.dataclass(frozen=True)
class BlockEvent:
    """One decoded push-plane EVENT (v14): everything a subscribed
    wallet needs to verify the notification before believing it — the
    raw header (PoW + linkage), the filter bytes (re-match locally) and
    the filter header (check the commitment chain).  ``matched`` and
    ``txids`` are the server's *claim* about the session's watch set; a
    trustless client treats them as hints and re-derives both."""

    height: int
    raw_header: bytes  # 80 bytes, serialized
    filter_header: bytes  # 32-byte commitment at this height
    filter: bytes  # the block's compact filter
    matched: bool  # server's claim: filter matched the watch set
    txids: tuple[bytes, ...]  # server's claim: confirmed watched txids


@dataclasses.dataclass(frozen=True)
class GapEvent:
    """A push-plane degradation notice: events for heights
    ``[start, end]`` were dropped (the slow-consumer drop-to-cursor
    rung).  The session stays live; the client owes itself a replay of
    the window — from this server or any other replica, the commitment
    chain makes them interchangeable."""

    start: int
    end: int


@dataclasses.dataclass(frozen=True)
class Hello:
    genesis_hash: bytes
    tip_height: int
    listen_port: int
    #: Random per-process id; lets a node recognize (and drop) a dial to
    #: itself.  0 = one-shot tooling clients that never listen.
    nonce: int = 0


def encode_hello(h: Hello) -> bytes:
    return bytes([MsgType.HELLO]) + _HELLO.pack(
        PROTOCOL_VERSION, h.genesis_hash, h.tip_height, h.listen_port, h.nonce
    )


def encode_block(block: Block, sent_ts: float | None = None) -> bytes:
    # ``serialize`` is memoized on the block (core/block.py): relaying a
    # block that arrived by gossip re-frames the SAME wire bytes — the
    # zero-repack pipeline's relay leg.
    #
    # ``sent_ts`` is the sender's wall clock for the receiver's
    # propagation telemetry; None encodes 0.0 = "no stamp" (receivers
    # skip the sample).  The codec deliberately reads NO clock of its
    # own: stamps come from the caller's (possibly virtual) transport
    # clock, which is what keeps simulated traces byte-identical.
    ts = 0.0 if sent_ts is None else sent_ts
    return bytes([MsgType.BLOCK]) + struct.pack(">d", ts) + block.serialize()


def encode_tx(tx: Transaction) -> bytes:
    return bytes([MsgType.TX]) + tx.serialize()


def encode_getblocks(locator: list[bytes]) -> bytes:
    if len(locator) > 0xFFFF:
        raise ValueError("locator too long")
    return (
        bytes([MsgType.GETBLOCKS])
        + struct.pack(">H", len(locator))
        + b"".join(locator)
    )


def encode_blocks(blocks: list[Block]) -> bytes:
    parts = [bytes([MsgType.BLOCKS]), struct.pack(">H", len(blocks))]
    for block in blocks:
        raw = block.serialize()
        parts.append(_LEN.pack(len(raw)))
        parts.append(raw)
    return b"".join(parts)


def encode_getaccount(account: str) -> bytes:
    raw = account.encode("utf-8")
    if not 0 < len(raw) <= 255:
        raise ValueError("account id must encode to 1..255 bytes")
    return bytes([MsgType.GETACCOUNT]) + struct.pack(">B", len(raw)) + raw


def encode_account(state: AccountState) -> bytes:
    raw = state.account.encode("utf-8")
    return (
        bytes([MsgType.ACCOUNT])
        + struct.pack(">B", len(raw))
        + raw
        + struct.pack(
            ">QQQI", state.balance, state.nonce, state.next_seq, state.tip_height
        )
    )


def encode_cblock(block: Block, sent_ts: float | None = None) -> bytes:
    """Compact form of ``block``: prefill the coinbase (receivers cannot
    have it — it is minted by this block), elide everything else to its
    txid.  ~32 bytes per transaction on the wire instead of the full
    serialization.  ``sent_ts`` as in ``encode_block``: the caller's
    stamp or 0.0 = none, never a codec-side clock read."""
    ts = 0.0 if sent_ts is None else sent_ts
    if len(block.txs) > 0xFFFF:
        # The compact form's counts are u16; consensus blocks are u32.
        # Callers fall back to the full BLOCK encoding (node.py does).
        raise ValueError("too many transactions for a compact block")
    prefilled = []
    txids = []
    for i, tx in enumerate(block.txs):
        if i == 0 and tx.is_coinbase:
            prefilled.append((i, tx))
        else:
            txids.append(tx.txid())
    parts = [
        bytes([MsgType.CBLOCK]),
        struct.pack(">d", ts),
        block.header.serialize(),
        struct.pack(">HH", len(block.txs), len(prefilled)),
    ]
    for i, tx in prefilled:
        raw = tx.serialize()
        parts.append(struct.pack(">HI", i, len(raw)))
        parts.append(raw)
    parts.extend(txids)
    return b"".join(parts)


def encode_getblocktxn(block_hash: bytes, indices: list[int]) -> bytes:
    if len(block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    if not indices or len(indices) > 0xFFFF:
        raise ValueError("need 1..65535 indices")
    return (
        bytes([MsgType.GETBLOCKTXN])
        + block_hash
        + struct.pack(">H", len(indices))
        + struct.pack(f">{len(indices)}H", *indices)
    )


def encode_blocktxn(block_hash: bytes, raw_txs: list[bytes]) -> bytes:
    """``raw_txs`` are pre-serialized transactions in the requested index
    order."""
    if len(block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    if len(raw_txs) > 0xFFFF:
        raise ValueError("too many transactions for one BLOCKTXN")
    parts = [
        bytes([MsgType.BLOCKTXN]),
        block_hash,
        struct.pack(">H", len(raw_txs)),
    ]
    for raw in raw_txs:
        parts.append(struct.pack(">I", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def encode_getfees(window: int = 0) -> bytes:
    if not 0 <= window <= 0xFFFF:
        raise ValueError("bad fee window")
    return bytes([MsgType.GETFEES]) + struct.pack(">H", window)


def encode_fees(stats: FeeStats) -> bytes:
    return bytes([MsgType.FEES]) + struct.pack(
        ">HIQQQI",
        stats.window_blocks,
        stats.samples,
        stats.p25,
        stats.p50,
        stats.p75,
        stats.tip_height,
    )


def encode_getaddr() -> bytes:
    return bytes([MsgType.GETADDR])


def encode_getstatus() -> bytes:
    return bytes([MsgType.GETSTATUS])


def encode_status(status: dict) -> bytes:
    """The node's ``status()`` dict as canonical JSON (v9, `p1 status`).
    JSON rather than a packed layout: the status surface grows every
    round, and an operator probe should never be the reason a field
    addition bumps the wire version."""
    import json

    return bytes([MsgType.STATUS]) + json.dumps(
        status, separators=(",", ":")
    ).encode("utf-8")


def encode_getmetrics() -> bytes:
    return bytes([MsgType.GETMETRICS])


def encode_metrics(snapshot: dict) -> bytes:
    """A metrics registry snapshot (node/telemetry.py) as canonical
    JSON — same shape rationale as STATUS: the metric catalog grows
    every round and must not cost a wire version per addition."""
    import json

    return bytes([MsgType.METRICS]) + json.dumps(
        snapshot, separators=(",", ":")
    ).encode("utf-8")


def encode_getmaintain(command: dict) -> bytes:
    """A maintenance command (v13, `p1 maintain`) as canonical JSON —
    ``{"op": "status"|"rebase"|"prune"|"compact", ...}``.  JSON for the
    same reason as STATUS: operator surfaces grow every round and must
    not cost a wire version per field."""
    import json

    return bytes([MsgType.GETMAINTAIN]) + json.dumps(
        command, separators=(",", ":")
    ).encode("utf-8")


def encode_maintain(reply: dict) -> bytes:
    """The maintenance reply — ``{"ok": bool, ...}``; refusals travel
    as ``{"ok": false, "error": ...}``, never as dropped sessions."""
    import json

    return bytes([MsgType.MAINTAIN]) + json.dumps(
        reply, separators=(",", ":")
    ).encode("utf-8")


def encode_ping(nonce: int) -> bytes:
    return bytes([MsgType.PING]) + struct.pack(">Q", nonce)


def encode_pong(nonce: int) -> bytes:
    return bytes([MsgType.PONG]) + struct.pack(">Q", nonce)


def encode_addr(addrs: list[tuple[str, int]]) -> bytes:
    if len(addrs) > 0xFFFF:
        raise ValueError("too many addresses for one ADDR frame")
    parts = [bytes([MsgType.ADDR]), struct.pack(">H", len(addrs))]
    for host, port in addrs:
        raw = host.encode("utf-8")
        if not 0 < len(raw) <= 255 or not 0 < port <= 0xFFFF:
            raise ValueError(f"bad address {host}:{port}")
        parts.append(struct.pack(">HB", port, len(raw)))
        parts.append(raw)
    return b"".join(parts)


def encode_getheaders(locator: list[bytes]) -> bytes:
    if len(locator) > 0xFFFF:
        raise ValueError("locator too long")
    return (
        bytes([MsgType.GETHEADERS])
        + struct.pack(">H", len(locator))
        + b"".join(locator)
    )


def encode_headers(headers: list[BlockHeader]) -> bytes:
    if len(headers) > 0xFFFF:
        raise ValueError("too many headers for one HEADERS frame")
    return (
        bytes([MsgType.HEADERS])
        + struct.pack(">H", len(headers))
        + b"".join(h.serialize() for h in headers)
    )


def encode_headers_raw(raw_headers: list[bytes]) -> bytes:
    """HEADERS from pre-serialized 80-byte header slices — the read
    replica's zero-parse serving path (node/queryplane.py): headers come
    straight off the mmap'd store, no BlockHeader objects anywhere."""
    if len(raw_headers) > 0xFFFF:
        raise ValueError("too many headers for one HEADERS frame")
    for raw in raw_headers:
        if len(raw) != HEADER_SIZE:
            raise ValueError("raw header must be exactly 80 bytes")
    return (
        bytes([MsgType.HEADERS])
        + struct.pack(">H", len(raw_headers))
        + b"".join(raw_headers)
    )


def encode_blocks_raw(raw_blocks: list[bytes]) -> bytes:
    """BLOCKS from pre-serialized block records — the replica serves the
    store's exact record bytes without a Block object round trip."""
    if len(raw_blocks) > 0xFFFF:
        raise ValueError("too many blocks for one BLOCKS frame")
    parts = [bytes([MsgType.BLOCKS]), struct.pack(">H", len(raw_blocks))]
    for raw in raw_blocks:
        parts.append(_LEN.pack(len(raw)))
        parts.append(raw)
    return b"".join(parts)


def encode_getfilters(start_height: int, count: int) -> bytes:
    if not 0 <= start_height <= 0xFFFFFFFF:
        raise ValueError("bad filter start height")
    if not 0 < count <= 0xFFFF:
        raise ValueError("need 1..65535 filters")
    return bytes([MsgType.GETFILTERS]) + struct.pack(">IH", start_height, count)


def encode_filters(start_height: int, entries: list[tuple[bytes, bytes]]) -> bytes:
    """``entries`` are (block hash, filter bytes) pairs for consecutive
    main-chain heights ascending from ``start_height``."""
    if len(entries) > 0xFFFF:
        raise ValueError("too many filters for one FILTERS frame")
    parts = [
        bytes([MsgType.FILTERS]),
        struct.pack(">IH", start_height, len(entries)),
    ]
    for bhash, fbytes in entries:
        if len(bhash) != 32:
            raise ValueError("block hash must be 32 bytes")
        parts.append(bhash)
        parts.append(_LEN.pack(len(fbytes)))
        parts.append(fbytes)
    return b"".join(parts)


def encode_getfilterheaders(start_height: int, count: int) -> bytes:
    if not 0 <= start_height <= 0xFFFFFFFF:
        raise ValueError("bad filter-header start height")
    if not 0 < count <= 0xFFFF:
        raise ValueError("need 1..65535 filter headers")
    return bytes([MsgType.GETFILTERHEADERS]) + struct.pack(
        ">IH", start_height, count
    )


def encode_filterheaders(start_height: int, headers: list[bytes]) -> bytes:
    """``headers`` are consecutive 32-byte filter-header commitments
    ascending from ``start_height``; an empty list is the clean refusal
    (range not committed here — pruned/re-based history)."""
    if len(headers) > 0xFFFF:
        raise ValueError("too many filter headers for one frame")
    for h in headers:
        if len(h) != 32:
            raise ValueError("filter header must be 32 bytes")
    return (
        bytes([MsgType.FILTERHEADERS])
        + struct.pack(">IH", start_height, len(headers))
        + b"".join(headers)
    )


def encode_subscribe(
    items: list[bytes], cursor: tuple[int, bytes] | None = None
) -> bytes:
    """Register (or replace) the session's watch set.  ``cursor`` is the
    gap-free resume point — the last (height, filter_header) the client
    VERIFIED; the server replays everything after it before pushing
    live, and refuses (drops the session) if its committed chain
    contradicts the cursor — a client would rather fail over than ride
    a server on the wrong branch."""
    if not 0 < len(items) <= 0xFFFF:
        raise ValueError("need 1..65535 watch items")
    if cursor is None:
        head = bytes([MsgType.SUBSCRIBE, 0])
    else:
        height, fheader = cursor
        if len(fheader) != 32:
            raise ValueError("cursor filter header must be 32 bytes")
        head = (
            bytes([MsgType.SUBSCRIBE, 1])
            + struct.pack(">I", height)
            + fheader
        )
    parts = [head, struct.pack(">H", len(items))]
    for it in items:
        if not 0 < len(it) <= 255:
            raise ValueError("watch item must be 1..255 bytes")
        parts.append(bytes([len(it)]))
        parts.append(it)
    return b"".join(parts)


def encode_unsubscribe() -> bytes:
    return bytes([MsgType.UNSUBSCRIBE])


def encode_event(ev: BlockEvent) -> bytes:
    """One block-connect push (EVENT kind 0)."""
    if len(ev.raw_header) != HEADER_SIZE:
        raise ValueError("event header must be exactly 80 bytes")
    if len(ev.filter_header) != 32:
        raise ValueError("event filter header must be 32 bytes")
    if len(ev.txids) > 0xFFFF:
        raise ValueError("too many txids for one EVENT")
    for txid in ev.txids:
        if len(txid) != 32:
            raise ValueError("event txid must be 32 bytes")
    return b"".join(
        (
            bytes([MsgType.EVENT, 0]),
            struct.pack(">I", ev.height),
            ev.raw_header,
            ev.filter_header,
            _LEN.pack(len(ev.filter)),
            ev.filter,
            struct.pack(">BH", int(ev.matched), len(ev.txids)),
            *ev.txids,
        )
    )


def encode_event_gap(start: int, end: int) -> bytes:
    """The drop-to-cursor notice (EVENT kind 1): heights [start, end]
    were shed for this slow consumer instead of queueing unboundedly."""
    if end < start:
        raise ValueError("bad gap range")
    return bytes([MsgType.EVENT, 1]) + struct.pack(">II", start, end)


#: Byte offset of ``tip_height`` inside an encoded found-PROOF payload:
#: type byte + found byte + u32 height puts the u32 tip at bytes 6..10
#: (encode_proof's ">III" pack).  ``patch_proof_tip`` below is what
#: makes serialized proofs cacheable at all: everything else in the
#: payload is reorg-stable (chain/proof.py CachedProof), so serving a
#: cached proof is one 4-byte splice instead of a re-encode.
_PROOF_TIP_OFF = 6


def patch_proof_tip(payload: bytes, tip_height: int) -> bytes:
    """A copy of a cached found-PROOF payload with the current tip height
    stamped in — the hot serving path for repeat proof queries."""
    return (
        payload[:_PROOF_TIP_OFF]
        + struct.pack(">I", tip_height)
        + payload[_PROOF_TIP_OFF + 4 :]
    )


def encode_getsnapshot(start_chunk: int = 0, count: int = 0) -> bytes:
    """``count`` 0 = manifest request; >= 1 = that chunk range."""
    if not 0 <= start_chunk <= 0xFFFFFFFF:
        raise ValueError("bad snapshot start chunk")
    if not 0 <= count <= 0xFFFF:
        raise ValueError("bad snapshot chunk count")
    return bytes([MsgType.GETSNAPSHOT]) + struct.pack(">IH", start_chunk, count)


def encode_snapshot_none() -> bytes:
    return bytes([MsgType.SNAPSHOT, 0])


def encode_snapshot_manifest(manifest_payload: bytes) -> bytes:
    return (
        bytes([MsgType.SNAPSHOT, 1])
        + _LEN.pack(len(manifest_payload))
        + manifest_payload
    )


def encode_snapshot_chunks(start: int, chunk_payloads: list[bytes]) -> bytes:
    if len(chunk_payloads) > 0xFFFF:
        raise ValueError("too many chunks for one SNAPSHOT frame")
    parts = [
        bytes([MsgType.SNAPSHOT, 2]),
        struct.pack(">IH", start, len(chunk_payloads)),
    ]
    for payload in chunk_payloads:
        parts.append(_LEN.pack(len(payload)))
        parts.append(payload)
    return b"".join(parts)


def encode_getproof(txid: bytes) -> bytes:
    if len(txid) != 32:
        raise ValueError("txid must be 32 bytes")
    return bytes([MsgType.GETPROOF]) + txid


def encode_proof(proof: TxProof | None) -> bytes:
    """``None`` encodes the not-found reply."""
    if proof is None:
        return bytes([MsgType.PROOF, 0])
    raw_tx = proof.tx.serialize()
    return b"".join(
        (
            bytes([MsgType.PROOF, 1]),
            struct.pack(">III", proof.height, proof.tip_height, proof.index),
            proof.header.serialize(),
            struct.pack(">H", len(proof.branch)),
            *proof.branch,
            struct.pack(">H", len(raw_tx)),
            raw_tx,
        )
    )


def encode_getmempool(cursor: tuple[int, bytes] | None = None) -> bytes:
    head = bytes([MsgType.GETMEMPOOL])
    if cursor is None:
        return head
    fee, txid = cursor
    return head + struct.pack(">Q32s", fee, txid)


def encode_mempool(raw_txs: list[bytes], more: bool = False) -> bytes:
    """``raw_txs`` are pre-serialized transactions (the caller already
    serialized them for its byte budget — don't pay that twice)."""
    if len(raw_txs) > 0xFFFF:
        raise ValueError("too many transactions for one MEMPOOL frame")
    parts = [
        bytes([MsgType.MEMPOOL]),
        struct.pack(">BH", int(more), len(raw_txs)),
    ]
    for raw in raw_txs:
        parts.append(struct.pack(">H", len(raw)))
        parts.append(raw)
    return b"".join(parts)


#: SKETCH word ceiling: the codec's capacity clamp plus its reserved
#: verification syndrome.  Decoding rejects anything larger OUTRIGHT —
#: an adversarial sketch must not be able to buy unbounded field work.
MAX_SKETCH_WORDS = RECON_MAX_CAPACITY + 1
#: RECONCILDIFF/GETTX short-ID ceiling: a decoded difference can never
#: exceed the capacity clamp, so honest frames stay far below this.
MAX_RECON_IDS = 256


def encode_reqrecon(set_size: int, full: bool = False) -> bytes:
    if not 0 <= set_size <= 0xFFFFFFFF:
        raise ValueError("bad reconciliation set size")
    return bytes([MsgType.REQRECON]) + struct.pack(">BI", int(full), set_size)


def encode_sketch(set_size: int, sketch: bytes) -> bytes:
    """``sketch`` is the serialized codec output (node/reconcile.py) —
    whole 4-byte words, at least capacity 1, at most the clamp."""
    if not 0 <= set_size <= 0xFFFFFFFF:
        raise ValueError("bad reconciliation set size")
    words = len(sketch) // 4
    if len(sketch) % 4 or not 2 <= words <= MAX_SKETCH_WORDS:
        raise ValueError("bad sketch size")
    return (
        bytes([MsgType.SKETCH])
        + struct.pack(">IH", set_size, words)
        + sketch
    )


def _pack_short_ids(short_ids) -> bytes:
    ids = list(short_ids)
    if len(ids) > MAX_RECON_IDS:
        raise ValueError("too many short IDs for one frame")
    if any(not 0 <= s <= 0xFFFFFFFF for s in ids):
        raise ValueError("short ID out of range")
    return struct.pack(">H", len(ids)) + struct.pack(
        f">{len(ids)}I", *ids
    )


def encode_recondiff(success: bool, short_ids=()) -> bytes:
    return (
        bytes([MsgType.RECONCILDIFF, int(success)])
        + _pack_short_ids(short_ids)
    )


def encode_gettx(short_ids) -> bytes:
    ids = list(short_ids)
    if not ids:
        raise ValueError("GETTX needs at least one short ID")
    return bytes([MsgType.GETTX]) + _pack_short_ids(ids)


def decode(payload: bytes):
    """(MsgType, decoded body) for one frame payload; raises
    ``ProtocolError`` (a ValueError) on malformed input — the peer loop
    treats that as a scorable protocol violation."""
    try:
        return _decode(payload)
    except ProtocolError:
        raise
    except ValueError as e:
        # Anything the nested deserializers reject is equally the peer's
        # bytes at fault — normalize so the caller scores uniformly.
        raise ProtocolError(str(e)) from e


def _decode(payload: bytes):
    if not payload:
        raise ValueError("empty frame")
    try:
        mtype = MsgType(payload[0])
    except ValueError as e:
        raise ValueError(f"unknown message type {payload[0]}") from e
    body = payload[1:]
    if mtype is MsgType.HELLO:
        if len(body) != _HELLO.size:
            raise ValueError("bad HELLO size")
        version, *fields = _HELLO.unpack(body)
        if version != PROTOCOL_VERSION:
            raise ChainMismatch(
                f"protocol version mismatch: peer speaks v{version}, "
                f"this node v{PROTOCOL_VERSION}"
            )
        return mtype, Hello(*fields)
    if mtype is MsgType.BLOCK:
        if len(body) < 8:
            raise ValueError("bad BLOCK")
        (sent_ts,) = struct.unpack_from(">d", body)
        return mtype, (sent_ts, Block.deserialize(body[8:]))
    if mtype is MsgType.TX:
        return mtype, Transaction.deserialize(body)
    if mtype is MsgType.GETBLOCKS:
        if len(body) < 2:
            raise ValueError("bad GETBLOCKS")
        (n,) = struct.unpack_from(">H", body)
        if len(body) != 2 + 32 * n:
            raise ValueError("bad GETBLOCKS size")
        return mtype, [body[2 + 32 * i : 2 + 32 * (i + 1)] for i in range(n)]
    if mtype is MsgType.BLOCKS:
        if len(body) < 2:
            raise ValueError("bad BLOCKS")
        (n,) = struct.unpack_from(">H", body)
        off = 2
        blocks = []
        for _ in range(n):
            if len(body) < off + _LEN.size:
                raise ValueError("truncated BLOCKS")
            (blen,) = _LEN.unpack_from(body, off)
            off += _LEN.size
            if len(body) < off + blen:
                raise ValueError("truncated BLOCKS entry")
            blocks.append(Block.deserialize(body[off : off + blen]))
            off += blen
        if off != len(body):
            raise ValueError("trailing bytes in BLOCKS")
        return mtype, blocks
    if mtype is MsgType.GETACCOUNT:
        if len(body) < 1 or len(body) != 1 + body[0] or body[0] == 0:
            raise ValueError("bad GETACCOUNT")
        return mtype, body[1:].decode("utf-8")
    if mtype is MsgType.ACCOUNT:
        if len(body) < 1:
            raise ValueError("bad ACCOUNT")
        alen = body[0]
        if len(body) != 1 + alen + 28 or alen == 0:
            raise ValueError("bad ACCOUNT size")
        account = body[1 : 1 + alen].decode("utf-8")
        balance, nonce, next_seq, height = struct.unpack(
            ">QQQI", body[1 + alen :]
        )
        return mtype, AccountState(account, balance, nonce, next_seq, height)
    if mtype is MsgType.CBLOCK:
        if len(body) < 8 + HEADER_SIZE + 4:
            raise ValueError("bad CBLOCK")
        (sent_ts,) = struct.unpack_from(">d", body)
        off = 8
        header = BlockHeader.deserialize(body[off : off + HEADER_SIZE])
        off += HEADER_SIZE
        ntx, n_prefilled = struct.unpack_from(">HH", body, off)
        off += 4
        if n_prefilled > ntx:
            raise ValueError("bad CBLOCK prefill count")
        prefilled = []
        last_index = -1
        for _ in range(n_prefilled):
            if len(body) < off + 6:
                raise ValueError("truncated CBLOCK prefill")
            index, tlen = struct.unpack_from(">HI", body, off)
            off += 6
            if index <= last_index or index >= ntx:
                raise ValueError("bad CBLOCK prefill index")
            last_index = index
            if len(body) < off + tlen:
                raise ValueError("truncated CBLOCK prefill tx")
            prefilled.append(
                (index, Transaction.deserialize(body[off : off + tlen]))
            )
            off += tlen
        n_ids = ntx - n_prefilled
        if len(body) != off + 32 * n_ids:
            raise ValueError("bad CBLOCK txid section")
        txids = tuple(
            body[off + 32 * i : off + 32 * (i + 1)] for i in range(n_ids)
        )
        return mtype, CompactBlock(
            sent_ts, header, ntx, tuple(prefilled), txids
        )
    if mtype is MsgType.GETBLOCKTXN:
        if len(body) < 34:
            raise ValueError("bad GETBLOCKTXN")
        bhash = body[:32]
        (n,) = struct.unpack_from(">H", body, 32)
        if n == 0 or len(body) != 34 + 2 * n:
            raise ValueError("bad GETBLOCKTXN size")
        indices = list(struct.unpack_from(f">{n}H", body, 34))
        if any(b <= a for a, b in zip(indices, indices[1:])):
            raise ValueError("GETBLOCKTXN indices must ascend")
        return mtype, (bhash, indices)
    if mtype is MsgType.BLOCKTXN:
        if len(body) < 34:
            raise ValueError("bad BLOCKTXN")
        bhash = body[:32]
        (n,) = struct.unpack_from(">H", body, 32)
        off = 34
        txs = []
        for _ in range(n):
            if len(body) < off + 4:
                raise ValueError("truncated BLOCKTXN")
            (tlen,) = struct.unpack_from(">I", body, off)
            off += 4
            if len(body) < off + tlen:
                raise ValueError("truncated BLOCKTXN entry")
            txs.append(Transaction.deserialize(body[off : off + tlen]))
            off += tlen
        if off != len(body):
            raise ValueError("trailing bytes in BLOCKTXN")
        return mtype, (bhash, txs)
    if mtype is MsgType.GETFEES:
        if len(body) != 2:
            raise ValueError("bad GETFEES")
        return mtype, struct.unpack(">H", body)[0]
    if mtype is MsgType.FEES:
        if len(body) != 34:
            raise ValueError("bad FEES")
        return mtype, FeeStats(*struct.unpack(">HIQQQI", body))
    if mtype is MsgType.GETADDR:
        if body:
            raise ValueError("bad GETADDR")
        return mtype, None
    if mtype is MsgType.GETSTATUS:
        if body:
            raise ValueError("bad GETSTATUS")
        return mtype, None
    if mtype is MsgType.GETMETRICS:
        if body:
            raise ValueError("bad GETMETRICS")
        return mtype, None
    if mtype in (MsgType.STATUS, MsgType.METRICS, MsgType.GETMAINTAIN, MsgType.MAINTAIN):
        import json

        try:
            status = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise ValueError(f"bad {mtype.name} payload: {e}") from e
        if not isinstance(status, dict):
            raise ValueError(f"bad {mtype.name} payload: not an object")
        return mtype, status
    if mtype in (MsgType.PING, MsgType.PONG):
        if len(body) != 8:
            raise ValueError(f"bad {mtype.name}")
        return mtype, struct.unpack(">Q", body)[0]
    if mtype is MsgType.ADDR:
        if len(body) < 2:
            raise ValueError("bad ADDR")
        (n,) = struct.unpack_from(">H", body)
        off = 2
        addrs = []
        for _ in range(n):
            if len(body) < off + 3:
                raise ValueError("truncated ADDR")
            port, hlen = struct.unpack_from(">HB", body, off)
            off += 3
            if hlen == 0 or port == 0 or len(body) < off + hlen:
                raise ValueError("bad ADDR entry")
            addrs.append((body[off : off + hlen].decode("utf-8"), port))
            off += hlen
        if off != len(body):
            raise ValueError("trailing bytes in ADDR")
        return mtype, addrs
    if mtype is MsgType.GETHEADERS:
        if len(body) < 2:
            raise ValueError("bad GETHEADERS")
        (n,) = struct.unpack_from(">H", body)
        if len(body) != 2 + 32 * n:
            raise ValueError("bad GETHEADERS size")
        return mtype, [body[2 + 32 * i : 2 + 32 * (i + 1)] for i in range(n)]
    if mtype is MsgType.HEADERS:
        if len(body) < 2:
            raise ValueError("bad HEADERS")
        (n,) = struct.unpack_from(">H", body)
        if len(body) != 2 + HEADER_SIZE * n:
            raise ValueError("bad HEADERS size")
        return mtype, [
            BlockHeader.deserialize(
                body[2 + HEADER_SIZE * i : 2 + HEADER_SIZE * (i + 1)]
            )
            for i in range(n)
        ]
    if mtype is MsgType.GETFILTERS:
        if len(body) != 6:
            raise ValueError("bad GETFILTERS")
        start, count = struct.unpack(">IH", body)
        if count == 0:
            raise ValueError("bad GETFILTERS count")
        return mtype, (start, count)
    if mtype is MsgType.FILTERS:
        if len(body) < 6:
            raise ValueError("bad FILTERS")
        start, n = struct.unpack_from(">IH", body)
        off = 6
        entries = []
        for _ in range(n):
            if len(body) < off + 36:
                raise ValueError("truncated FILTERS")
            bhash = body[off : off + 32]
            (flen,) = _LEN.unpack_from(body, off + 32)
            off += 36
            if len(body) < off + flen:
                raise ValueError("truncated FILTERS entry")
            entries.append((bhash, body[off : off + flen]))
            off += flen
        if off != len(body):
            raise ValueError("trailing bytes in FILTERS")
        return mtype, (start, entries)
    if mtype is MsgType.GETFILTERHEADERS:
        if len(body) != 6:
            raise ValueError("bad GETFILTERHEADERS")
        start, count = struct.unpack(">IH", body)
        if count == 0:
            raise ValueError("bad GETFILTERHEADERS count")
        return mtype, (start, count)
    if mtype is MsgType.FILTERHEADERS:
        if len(body) < 6:
            raise ValueError("bad FILTERHEADERS")
        start, n = struct.unpack_from(">IH", body)
        if len(body) != 6 + 32 * n:
            raise ValueError("bad FILTERHEADERS size")
        return mtype, (
            start,
            [body[6 + 32 * i : 6 + 32 * (i + 1)] for i in range(n)],
        )
    if mtype is MsgType.SUBSCRIBE:
        if len(body) < 1:
            raise ValueError("bad SUBSCRIBE")
        has_cursor = body[0]
        if has_cursor not in (0, 1):
            raise ValueError("bad SUBSCRIBE cursor flag")
        off = 1
        cursor = None
        if has_cursor:
            if len(body) < off + 36:
                raise ValueError("truncated SUBSCRIBE cursor")
            (height,) = struct.unpack_from(">I", body, off)
            cursor = (height, body[off + 4 : off + 36])
            off += 36
        if len(body) < off + 2:
            raise ValueError("truncated SUBSCRIBE")
        (n,) = struct.unpack_from(">H", body, off)
        off += 2
        if n == 0:
            raise ValueError("SUBSCRIBE needs at least one watch item")
        items = []
        for _ in range(n):
            if len(body) < off + 1:
                raise ValueError("truncated SUBSCRIBE item")
            ilen = body[off]
            off += 1
            if ilen == 0 or len(body) < off + ilen:
                raise ValueError("bad SUBSCRIBE item")
            items.append(body[off : off + ilen])
            off += ilen
        if off != len(body):
            raise ValueError("trailing bytes in SUBSCRIBE")
        return mtype, (cursor, items)
    if mtype is MsgType.UNSUBSCRIBE:
        if body:
            raise ValueError("bad UNSUBSCRIBE")
        return mtype, None
    if mtype is MsgType.EVENT:
        if len(body) < 1:
            raise ValueError("bad EVENT")
        kind = body[0]
        if kind == 1:
            if len(body) != 9:
                raise ValueError("bad EVENT gap size")
            start, end = struct.unpack_from(">II", body, 1)
            if end < start:
                raise ValueError("bad EVENT gap range")
            return mtype, GapEvent(start, end)
        if kind != 0:
            raise ValueError(f"bad EVENT kind {kind}")
        off = 1
        if len(body) < off + 4 + HEADER_SIZE + 32 + _LEN.size:
            raise ValueError("truncated EVENT")
        (height,) = struct.unpack_from(">I", body, off)
        off += 4
        raw_header = body[off : off + HEADER_SIZE]
        off += HEADER_SIZE
        fheader = body[off : off + 32]
        off += 32
        (flen,) = _LEN.unpack_from(body, off)
        off += _LEN.size
        if len(body) < off + flen + 3:
            raise ValueError("truncated EVENT filter")
        fbytes = body[off : off + flen]
        off += flen
        matched, ntx = struct.unpack_from(">BH", body, off)
        off += 3
        if matched not in (0, 1):
            raise ValueError("bad EVENT matched flag")
        if len(body) != off + 32 * ntx:
            raise ValueError("bad EVENT txid section")
        txids = tuple(
            body[off + 32 * i : off + 32 * (i + 1)] for i in range(ntx)
        )
        return mtype, BlockEvent(
            height, raw_header, fheader, fbytes, bool(matched), txids
        )
    if mtype is MsgType.GETSNAPSHOT:
        if len(body) != 6:
            raise ValueError("bad GETSNAPSHOT")
        return mtype, struct.unpack(">IH", body)
    if mtype is MsgType.SNAPSHOT:
        if len(body) < 1:
            raise ValueError("bad SNAPSHOT")
        kind = body[0]
        if kind == 0:
            if len(body) != 1:
                raise ValueError("trailing bytes in SNAPSHOT")
            return mtype, ("none",)
        if kind == 1:
            if len(body) < 1 + _LEN.size:
                raise ValueError("truncated SNAPSHOT manifest")
            (mlen,) = _LEN.unpack_from(body, 1)
            if len(body) != 1 + _LEN.size + mlen:
                raise ValueError("bad SNAPSHOT manifest length")
            return mtype, ("manifest", body[1 + _LEN.size :])
        if kind == 2:
            if len(body) < 7:
                raise ValueError("truncated SNAPSHOT chunks")
            start, n = struct.unpack_from(">IH", body, 1)
            off = 7
            chunks = []
            for _ in range(n):
                if len(body) < off + _LEN.size:
                    raise ValueError("truncated SNAPSHOT chunk")
                (clen,) = _LEN.unpack_from(body, off)
                off += _LEN.size
                if len(body) < off + clen:
                    raise ValueError("truncated SNAPSHOT chunk entry")
                chunks.append(body[off : off + clen])
                off += clen
            if off != len(body):
                raise ValueError("trailing bytes in SNAPSHOT")
            return mtype, ("chunks", start, chunks)
        raise ValueError(f"bad SNAPSHOT kind {kind}")
    if mtype is MsgType.GETPROOF:
        if len(body) != 32:
            raise ValueError("bad GETPROOF")
        return mtype, body
    if mtype is MsgType.PROOF:
        if len(body) < 1:
            raise ValueError("bad PROOF")
        if body[0] == 0:
            if len(body) != 1:
                raise ValueError("trailing bytes in PROOF")
            return mtype, None
        if body[0] != 1:
            raise ValueError("bad PROOF found flag")
        off = 1
        if len(body) < off + 12 + HEADER_SIZE + 2:
            raise ValueError("truncated PROOF")
        height, tip_height, index = struct.unpack_from(">III", body, off)
        off += 12
        header = BlockHeader.deserialize(body[off : off + HEADER_SIZE])
        off += HEADER_SIZE
        (nbranch,) = struct.unpack_from(">H", body, off)
        off += 2
        if len(body) < off + 32 * nbranch + 2:
            raise ValueError("truncated PROOF branch")
        branch = tuple(
            body[off + 32 * i : off + 32 * (i + 1)] for i in range(nbranch)
        )
        off += 32 * nbranch
        (txlen,) = struct.unpack_from(">H", body, off)
        off += 2
        if len(body) != off + txlen:
            raise ValueError("bad PROOF tx size")
        tx = Transaction.deserialize(body[off:])
        return mtype, TxProof(tx, header, height, tip_height, index, branch)
    if mtype is MsgType.GETMEMPOOL:
        if not body:
            return mtype, None
        if len(body) != 40:
            raise ValueError("bad GETMEMPOOL")
        fee, txid = struct.unpack(">Q32s", body)
        return mtype, (fee, txid)
    if mtype is MsgType.MEMPOOL:
        if len(body) < 3:
            raise ValueError("bad MEMPOOL")
        more, n = struct.unpack_from(">BH", body)
        off = 3
        txs = []
        for _ in range(n):
            if len(body) < off + 2:
                raise ValueError("truncated MEMPOOL")
            (tlen,) = struct.unpack_from(">H", body, off)
            off += 2
            if len(body) < off + tlen:
                raise ValueError("truncated MEMPOOL entry")
            txs.append(Transaction.deserialize(body[off : off + tlen]))
            off += tlen
        if off != len(body):
            raise ValueError("trailing bytes in MEMPOOL")
        return mtype, (bool(more), txs)
    if mtype is MsgType.REQRECON:
        if len(body) != 5:
            raise ValueError("bad REQRECON")
        full, set_size = struct.unpack(">BI", body)
        if full > 1:
            raise ValueError("bad REQRECON full flag")
        return mtype, (bool(full), set_size)
    if mtype is MsgType.SKETCH:
        if len(body) < 6:
            raise ValueError("bad SKETCH")
        set_size, words = struct.unpack_from(">IH", body)
        if not 2 <= words <= MAX_SKETCH_WORDS:
            raise ValueError("bad SKETCH word count")
        if len(body) != 6 + 4 * words:
            raise ValueError("bad SKETCH size")
        return mtype, (set_size, body[6:])
    if mtype is MsgType.RECONCILDIFF:
        if len(body) < 3:
            raise ValueError("bad RECONCILDIFF")
        success = body[0]
        if success > 1:
            raise ValueError("bad RECONCILDIFF flag")
        return mtype, (bool(success), _unpack_short_ids(body[1:]))
    if mtype is MsgType.GETTX:
        ids = _unpack_short_ids(body)
        if not ids:
            raise ValueError("empty GETTX")
        return mtype, ids
    raise AssertionError(mtype)


def _unpack_short_ids(body: bytes) -> tuple:
    if len(body) < 2:
        raise ValueError("bad short-ID list")
    (n,) = struct.unpack_from(">H", body)
    if n > MAX_RECON_IDS:
        raise ValueError("too many short IDs")
    if len(body) != 2 + 4 * n:
        raise ValueError("bad short-ID list size")
    return struct.unpack_from(f">{n}I", body, 2)


async def write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(_LEN.pack(len(payload)) + payload)
    await writer.drain()


def write_frame_nowait(writer, payload: bytes) -> None:
    """Buffer one frame without draining — the push plane's send
    primitive.  A slow consumer grows the transport write buffer
    instead of blocking the notifier; the subscription ladder
    (node/subscriptions.py) reads that buffer size and degrades
    (coalesce → drop-to-cursor → disconnect) long before the hard cap.
    drain() here would invert that: one stalled wallet at the default
    64 KiB high-water mark would block every other subscriber's
    notification."""
    writer.write(_LEN.pack(len(payload)) + payload)


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        # Purely peer-supplied bytes: a hostile length prefix is the
        # canonical scorable violation (node misbehavior bans).
        raise ProtocolError(f"frame of {n} bytes exceeds cap")
    return await reader.readexactly(n)


#: Minimum sustained delivery rate for an in-progress frame.  Byte-level
#: progress counts as liveness (a slow link mid-frame is not silence) —
#: but unboundedly so, one byte per probe interval would re-pin a peer
#: slot forever, the very attack the liveness layer closes.  So a frame
#: must complete within grace + promised_size / MIN_FRAME_RATE seconds
#: (``FrameReader.overdue``; node.py passes its idle deadlines as the
#: grace).  10 kB/s tolerates any link worth keeping, and even a hostile
#: 32 MB frame trickled at exactly the floor bounds the slot hold to
#: under an hour of real bandwidth spent — paid, not free.
MIN_FRAME_RATE = 10_000


class FrameReader:
    """Cancellation-tolerant framed reader for the node's session loop.

    ``read_frame`` is two ``readexactly`` calls; a timeout (``wait_for``)
    that cancels it BETWEEN them — length prefix consumed, body pending —
    desyncs the stream, and the next read then interprets body bytes as a
    length prefix: an honest-but-slow peer would be scored for a protocol
    violation it never committed.  This reader instead accumulates all
    partial progress in its own buffer, so a cancelled ``read`` resumes at
    the exact stream position, and it records whether ANY bytes arrived
    since the last completed frame (``progressed``) — the idle prober's
    way to tell a peer trickling a large frame over a slow link (alive,
    never evicted while ``overdue`` is not) from one that has gone silent.
    """

    def __init__(self, reader: asyncio.StreamReader, clock=time.monotonic):
        self._reader = reader
        self._buf = bytearray()
        self._need: int | None = None  # body length once the prefix parsed
        self._progress = False
        self._started: float | None = None  # first byte of current frame
        #: Injectable monotonic clock (tests drive the delivery-budget
        #: math without real sleeps — the liveness deflake; the
        #: governor's TokenBucket set the pattern).
        self._clock = clock

    def progressed(self) -> bool:
        """True if bytes arrived mid-frame since the last completed frame
        or last call (the flag is consumed)."""
        p = self._progress
        self._progress = False
        return p

    def overdue(self, grace: float) -> bool:
        """True when the in-progress frame has outlived its delivery
        budget of ``grace`` + promised_size / MIN_FRAME_RATE seconds —
        the bound that keeps byte-trickle liveness from being free."""
        if self._started is None:
            return False
        budget = grace + (self._need or _LEN.size) / MIN_FRAME_RATE
        return self._clock() - self._started > budget

    async def read(self) -> bytes:
        while True:
            target = _LEN.size if self._need is None else self._need
            while len(self._buf) < target:
                chunk = await self._reader.read(target - len(self._buf))
                if not chunk:
                    raise asyncio.IncompleteReadError(bytes(self._buf), target)
                if self._started is None:
                    self._started = self._clock()
                self._progress = True
                self._buf += chunk
            if self._need is None:
                (n,) = _LEN.unpack(bytes(self._buf))
                if n > MAX_FRAME:
                    raise ProtocolError(f"frame of {n} bytes exceeds cap")
                self._need = n
                self._buf.clear()
                continue
            payload = bytes(self._buf)
            self._buf.clear()
            self._need = None
            self._started = None
            # A completed frame is reported to the caller, which resets its
            # idle state wholesale; ``progressed`` is reserved for partial
            # progress only, so one finished frame can't also grant a later
            # silent interval a free pass.
            self._progress = False
            return payload
