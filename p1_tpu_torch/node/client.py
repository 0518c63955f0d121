"""Thin p2p client: one-shot wallet/tooling rounds against a running node.

Capability parity: a usable mempool needs an entry point for transactions
from outside the node process (BASELINE.json:5 names the mempool; without
this, only miners' own processes could ever create payload for blocks).
Each client call speaks one round of the ordinary peer protocol — HELLO
exchange (validating genesis, i.e. that both sides run the same chain
parameters), then its one request — and disconnects; the node treats the
client like any short-lived peer.

The port's copy of ``p1_tpu/node/client.py``.
"""

from __future__ import annotations

import asyncio
import contextlib

from p1_tpu_torch.core.genesis import make_genesis
from p1_tpu_torch.core.tx import Transaction
from p1_tpu_torch.node import protocol
from p1_tpu_torch.node.protocol import Hello, MsgType


@contextlib.asynccontextmanager
async def _session(
    host: str,
    port: int,
    difficulty: int,
    retarget=None,
    handshake_timeout: float | None = None,
    transport=None,
):
    """Connect + HELLO-validate against the chain selected by
    ``difficulty`` (+ optional ``RetargetRule`` — part of chain identity);
    yields (reader, writer, peer_hello).  The ONE copy of the handshake
    all clients share — a protocol change lands here once.

    ``handshake_timeout`` bounds connect + HELLO exchange with its own
    deadline: a half-open peer (accepts TCP, never answers — a dead
    process behind a live listen backlog) must cost a supervised caller
    one stall, not its entire overall timeout.  None keeps the caller's
    outer ``wait_for`` as the only bound (the one-shot clients, whose
    whole round is already a single short timeout).

    ``transport`` is the network seam (node/transport.py): None dials
    real sockets; a simulator handle runs the SAME client code over
    in-memory links under the virtual clock — how the chaos plane puts
    verifying wallets inside its deterministic storms."""

    async def _connect():
        if transport is None:
            reader, writer = await asyncio.open_connection(host, port)
        else:
            reader, writer = await transport.connect(host, port)
        try:
            genesis_hash = make_genesis(difficulty, retarget).block_hash()
            await protocol.write_frame(
                writer, protocol.encode_hello(Hello(genesis_hash, 0, 0))
            )
            mtype, hello = protocol.decode(
                await protocol.read_frame(reader)
            )
            if mtype is not MsgType.HELLO:
                raise ValueError("node did not HELLO")
            if hello.genesis_hash != genesis_hash:
                raise ValueError(
                    "genesis mismatch: node runs a different chain "
                    "(check --difficulty / retarget flags)"
                )
            return reader, writer, hello
        except BaseException:
            # Incl. the cancellation a handshake timeout injects: the
            # socket must not outlive the abandoned attempt.
            writer.close()
            raise

    if handshake_timeout is None:
        reader, writer, hello = await _connect()
    else:
        reader, writer, hello = await asyncio.wait_for(
            _connect(), handshake_timeout
        )
    try:
        yield reader, writer, hello
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _read_msg(reader, writer):
    """One decoded frame, transparently answering keepalive PINGs — a
    client mid-round (e.g. a long headers sync between requests) must
    show liveness or the node's idle probe evicts it (node.py)."""
    while True:
        mtype, body = protocol.decode(await protocol.read_frame(reader))
        if mtype is MsgType.PING:
            await protocol.write_frame(writer, protocol.encode_pong(body))
            continue
        return mtype, body


async def send_tx(
    host: str,
    port: int,
    tx: Transaction,
    difficulty: int,
    timeout: float = 10.0,
    retarget=None,
) -> int:
    """Push ``tx`` to the node at host:port; return the node's tip height.

    ``difficulty`` selects the chain (it determines the genesis block the
    HELLO handshake validates against); a mismatch raises ValueError
    rather than silently feeding a transaction to the wrong network.
    """

    async def _run() -> int:
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            hello,
        ):
            await protocol.write_frame(writer, protocol.encode_tx(tx))
            return hello.tip_height

    return await asyncio.wait_for(_run(), timeout)


async def get_proof(
    host: str,
    port: int,
    txid: bytes,
    difficulty: int,
    timeout: float = 10.0,
    retarget=None,
):
    """Fetch the SPV inclusion proof for ``txid`` from the node at
    host:port.  Returns a ``TxProof`` or ``None`` (not confirmed on the
    node's main chain).  The caller verifies the proof itself with
    ``p1_tpu_torch.chain.verify_tx_proof`` — never trust, always check."""

    async def _run():
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):
            await protocol.write_frame(writer, protocol.encode_getproof(txid))
            while True:
                mtype, body = await _read_msg(reader, writer)
                if mtype is MsgType.PROOF:
                    return body

    return await asyncio.wait_for(_run(), timeout)


async def get_headers(
    host: str,
    port: int,
    difficulty: int,
    timeout: float = 60.0,
    retarget=None,
    max_headers: int = 1_000_000,
    stall_timeout_s: float = 15.0,
    fallback_peers=(),
    attempts_max: int = 4,
):
    """Headers-first light-client sync: the node's full main-chain header
    list, genesis-first, ~80 B per block.  Fetches until a reply adds
    nothing new; the CALLER must then verify the chain itself with
    ``p1_tpu_torch.chain.replay_host`` (PoW, linkage, difficulty schedule) —
    this function moves bytes, it does not bless them.  ``max_headers``
    bounds memory against a responder that streams garbage forever.

    Supervised (node/supervision.py, the same layer the node runs over
    its own locator sync): each GETHEADERS round must land a reply that
    grows the chain within ``stall_timeout_s``, or the session is
    abandoned and the fetch resumes — accumulated headers kept — against
    the next address in ``[primary, *fallback_peers]`` after a jittered
    backoff.  The locator is rebuilt from what we already hold, so a
    failover re-fetches at most one batch, and the link-point truncation
    below already handles a fallback peer on a different (heavier-tip)
    branch.  ``attempts_max`` consecutive stalls raise ``SyncStalled``;
    progress resets the budget, so an honest-slow peer that keeps
    serving batches is never abandoned.  Protocol violations (unlinked
    or non-contiguous batches) still raise ``ValueError`` immediately —
    a lying peer is not retried, only a stalled one."""
    from p1_tpu_torch.node.supervision import RequestSupervisor, SyncStalled

    async def _run():
        genesis = make_genesis(difficulty, retarget)
        headers = [genesis.header]
        hashes = [genesis.block_hash()]
        pos = {hashes[0]: 0}
        from p1_tpu_torch.chain.chain import locator_hashes

        sup = RequestSupervisor(
            stall_timeout_s=stall_timeout_s, attempts_max=attempts_max
        )
        targets = [(host, port), *(tuple(p) for p in fallback_peers)]
        ti = 0
        while True:
            t_host, t_port = targets[ti]
            try:
                async with _session(
                    t_host,
                    t_port,
                    difficulty,
                    retarget,
                    # The handshake is a round too: a half-open target
                    # costs one stall, then the fetch rotates on.
                    handshake_timeout=stall_timeout_s,
                ) as (
                    reader,
                    writer,
                    _,
                ):
                    while True:
                        await protocol.write_frame(
                            writer,
                            protocol.encode_getheaders(
                                locator_hashes(hashes)
                            ),
                        )
                        sup.begin(targets[ti])

                        async def _reply():
                            while True:
                                mtype, body = await _read_msg(reader, writer)
                                if mtype is MsgType.HEADERS:
                                    return body

                        body = await asyncio.wait_for(
                            _reply(), stall_timeout_s
                        )
                        new = [h for h in body if h.block_hash() not in pos]
                        if not new:
                            return headers
                        sup.progress()
                        # A live peer can reorg between batches (and a
                        # failover peer may follow a different branch):
                        # the next reply then restarts below our tip.
                        # Each batch must link to a header we hold —
                        # truncate back to that link point (the stale
                        # branch tail is no longer the serving peer's
                        # main chain) and extend contiguously; anything
                        # that links nowhere is a protocol violation,
                        # not something to append and let verification
                        # blame on an honest peer later.
                        at = pos.get(new[0].prev_hash)
                        if at is None:
                            raise ValueError(
                                "HEADERS reply does not link to the "
                                "known chain"
                            )
                        if at != len(headers) - 1:
                            for h in hashes[at + 1 :]:
                                del pos[h]
                            del headers[at + 1 :]
                            del hashes[at + 1 :]
                        for h in new:
                            if h.prev_hash != hashes[-1]:
                                raise ValueError(
                                    "HEADERS batch is not contiguous"
                                )
                            headers.append(h)
                            hashes.append(h.block_hash())
                            pos[hashes[-1]] = len(hashes) - 1
                        if len(headers) > max_headers:
                            raise ValueError(
                                f"peer served more than {max_headers} "
                                "headers"
                            )
            except (
                ConnectionError,
                OSError,
                asyncio.IncompleteReadError,
                asyncio.TimeoutError,  # pre-3.11 spelling of the builtin
                TimeoutError,
            ) as e:
                # Stalled round or dead session — never a protocol
                # violation (those raise above).  Rotate to the next
                # target and resume from the headers already held.
                if sup.exhausted():
                    raise SyncStalled(
                        f"headers sync exhausted {attempts_max} failover "
                        f"attempts; last peer {t_host}:{t_port} ({e!r})"
                    ) from e
                delay = sup.record_stall()
                ti = (ti + 1) % len(targets)
                await asyncio.sleep(delay)

    return await asyncio.wait_for(_run(), timeout)


async def get_fees(
    host: str,
    port: int,
    difficulty: int,
    window: int = 0,
    timeout: float = 10.0,
    retarget=None,
) -> protocol.FeeStats:
    """Query confirmed-fee percentiles from the node at host:port — the
    wallet's price signal for `p1 tx --fee auto` (0 window = the node's
    default sample)."""

    async def _run() -> protocol.FeeStats:
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):
            await protocol.write_frame(writer, protocol.encode_getfees(window))
            while True:
                mtype, body = await _read_msg(reader, writer)
                if mtype is MsgType.FEES:
                    return body

    return await asyncio.wait_for(_run(), timeout)


async def get_status(
    host: str,
    port: int,
    difficulty: int,
    timeout: float = 10.0,
    retarget=None,
) -> dict:
    """Fetch a running node's full status JSON (`p1 status`) — height,
    peers, sync/storage health, and the overload block (governor state,
    admission drops, memory gauge).  Served even while the node sheds
    load, so the probe works exactly when an operator needs it most."""

    async def _run() -> dict:
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):
            await protocol.write_frame(writer, protocol.encode_getstatus())
            while True:
                mtype, body = await _read_msg(reader, writer)
                if mtype is MsgType.STATUS:
                    return body

    return await asyncio.wait_for(_run(), timeout)


async def maintain(
    host: str,
    port: int,
    command: dict,
    difficulty: int,
    timeout: float = 30.0,
    retarget=None,
) -> dict:
    """Drive a running node's maintenance plane (`p1 maintain`, v13):
    ``{"op": "status"|"rebase"|"prune"|"compact", ...}`` over
    GETMAINTAIN, returning the MAINTAIN reply — ``{"ok": bool, ...}``.
    A refused command comes back as ``{"ok": false, "error": ...}``:
    the zero-downtime contract means refusals are answers, never
    dropped sessions.  Kept reachable under SHED like GETSTATUS — an
    overloaded node must still accept the operation that relieves it.
    The default timeout is longer than the query probes': a re-base or
    compaction spills real bytes before answering."""

    async def _run() -> dict:
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):
            await protocol.write_frame(
                writer, protocol.encode_getmaintain(command)
            )
            while True:
                mtype, body = await _read_msg(reader, writer)
                if mtype is MsgType.MAINTAIN:
                    return body

    return await asyncio.wait_for(_run(), timeout)


async def get_metrics(
    host: str,
    port: int,
    difficulty: int,
    timeout: float = 10.0,
    retarget=None,
) -> dict:
    """Fetch a node's (or a `p1 serve` replica's) telemetry registry
    snapshot (`p1 metrics`, v12): counters, gauges, and the per-stage
    latency histograms of node/telemetry.py.  Unlike GETSTATUS this
    probe is shed under overload — a refused scrape times out here and
    the caller retries later."""

    async def _run() -> dict:
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):
            await protocol.write_frame(writer, protocol.encode_getmetrics())
            while True:
                mtype, body = await _read_msg(reader, writer)
                if mtype is MsgType.METRICS:
                    return body

    return await asyncio.wait_for(_run(), timeout)


async def get_account(
    host: str,
    port: int,
    account: str,
    difficulty: int,
    timeout: float = 10.0,
    retarget=None,
) -> protocol.AccountState:
    """Query ``account``'s consensus state (balance, nonce, next usable
    seq) from the node at host:port — what a wallet needs before signing.
    Skips unrelated frames the node pushes at handshake (e.g. its
    GETMEMPOOL request) until the ACCOUNT reply arrives."""

    async def _run() -> protocol.AccountState:
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):
            await protocol.write_frame(writer, protocol.encode_getaccount(account))
            while True:
                mtype, body = await _read_msg(reader, writer)
                if mtype is MsgType.ACCOUNT:
                    return body

    return await asyncio.wait_for(_run(), timeout)


async def get_filters(
    host: str,
    port: int,
    start_height: int,
    count: int,
    difficulty: int,
    timeout: float = 30.0,
    retarget=None,
) -> list[tuple[bytes, bytes]]:
    """Fetch compact block filters for a main-chain height range: (block
    hash, filter bytes) pairs ascending from ``start_height``.  The
    server caps the range — fewer entries than asked means ask again
    from where the reply ended (or the chain ended there)."""

    async def _run():
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):
            await protocol.write_frame(
                writer, protocol.encode_getfilters(start_height, count)
            )
            while True:
                mtype, body = await _read_msg(reader, writer)
                if mtype is MsgType.FILTERS:
                    start, entries = body
                    if start != start_height:
                        raise ValueError(
                            "FILTERS reply for a different start height"
                        )
                    return entries

    return await asyncio.wait_for(_run(), timeout)


class CommitmentViolation(ValueError):
    """A peer's served filter stream contradicts the filter-header
    commitment chain — the one client error that means "this peer is
    lying", not "this peer is slow".  Callers demote the peer (never
    retry it) and fail over; `p1 watch` maps it to exit code 4, the
    same verdict `p1 headers` gives a fake header chain."""


async def _fheaders_range(reader, writer, start: int, count: int, page: int = 1000):
    """Fetch ``count`` filter headers ascending from height ``start``
    over an open session.  Stops early (returns fewer) when the peer's
    committed span ends — FILTERHEADERS is all-or-nothing per request,
    so a short reply is an honest refusal, not a partial answer."""
    out: list[bytes] = []
    h = start
    while len(out) < count:
        await protocol.write_frame(
            writer,
            protocol.encode_getfilterheaders(h, min(page, count - len(out))),
        )
        while True:
            mtype, body = await _read_msg(reader, writer)
            if mtype is MsgType.FILTERHEADERS:
                got_start, headers = body
                break
        if not headers:
            return out
        if got_start != h:
            raise ValueError("FILTERHEADERS reply for a different start height")
        out.extend(headers)
        h += len(headers)
    return out


async def get_filter_headers(
    host: str,
    port: int,
    start_height: int,
    count: int,
    difficulty: int,
    timeout: float = 30.0,
    retarget=None,
    transport=None,
) -> list[bytes]:
    """Fetch the filter-header commitment chain for a height range:
    32-byte headers ascending from ``start_height``, where
    ``header[i] = H(filter_hash[i] || header[i-1])`` anchored at the
    all-zero genesis filter header (chain/filters.py).  Every honest
    replica derives the identical chain from block bytes alone, so two
    peers disagreeing on any height is PROOF at least one is lying —
    the cross-check `filter_scan` and `watch` build their failover on.
    A shorter-than-asked reply means the peer's committed span ends
    there (pruned or still syncing) — honest refusal, not an error."""

    async def _run():
        async with _session(
            host, port, difficulty, retarget, transport=transport
        ) as (reader, writer, _):
            return await _fheaders_range(reader, writer, start_height, count)

    return await asyncio.wait_for(_run(), timeout)


async def _pinned_filter_hash(
    host, port, difficulty, retarget, transport, prev_hash, want_hash
):
    """The TRUE filter hash at one height: fetch the block pinned by
    ``want_hash`` (requested by locator ``prev_hash``), verify the pin
    and its merkle commitment, and compute the filter locally.  Block
    bytes that hash to the pinned header ARE the truth — whichever
    peer serves them cannot influence the result."""
    from p1_tpu_torch.chain.filters import block_filter, filter_hash

    async with _session(
        host, port, difficulty, retarget, transport=transport
    ) as (reader, writer, _):
        await protocol.write_frame(writer, protocol.encode_getblocks([prev_hash]))
        while True:
            mtype, body = await _read_msg(reader, writer)
            if mtype is MsgType.BLOCKS:
                break
        if not body or body[0].block_hash() != want_hash:
            raise ValueError("peer did not serve the hash-pinned block")
        if not body[0].merkle_ok():
            raise ValueError("pinned block fails its merkle commitment")
        return filter_hash(block_filter(body[0]))


async def _adjudicate(
    mine: list[bytes],
    other,
    hashes: list[bytes],
    upto: int,
    difficulty: int,
    retarget,
    transport,
) -> str:
    """Two peers disagree on the filter-header chain at height ``upto``
    — name the liar.  ``mine`` is the serving peer's full committed
    chain [0..upto]; ``other`` is (host, port) of the disagreeing peer;
    ``hashes`` is the hash-pinned header skeleton.  Finds the first
    diverging height d (everything below is agreed, and the genesis
    anchor is agreed by construction), fetches the hash-pinned block at
    d, computes the true filter hash locally, and checks which side's
    header[d] extends the agreed prefix with the truth.  Returns
    "self" (serving peer lies), "other" (cross-check peer lies), or
    "both" (neither side committed the true filter)."""
    from p1_tpu_torch.chain.filters import (
        GENESIS_FILTER_HEADER,
        block_filter,
        filter_hash,
        next_filter_header,
    )

    theirs = await get_filter_headers(
        *other, 0, upto + 1, difficulty, retarget=retarget, transport=transport
    )
    if len(mine) != upto + 1 or len(theirs) != upto + 1:
        raise ValueError("commitment span vanished during adjudication")
    d = next(i for i in range(upto + 1) if mine[i] != theirs[i])
    prev = GENESIS_FILTER_HEADER if d == 0 else mine[d - 1]
    if d == 0:
        # Genesis is local knowledge — no fetch needed.
        fhash_true = filter_hash(block_filter(make_genesis(difficulty, retarget)))
    else:
        try:
            fhash_true = await _pinned_filter_hash(
                *other, difficulty, retarget, transport, hashes[d - 1], hashes[d]
            )
        except (ConnectionError, OSError, ValueError, asyncio.IncompleteReadError):
            # The cross-check peer won't serve the block; without it the
            # dispute cannot be settled from this side alone.
            raise ValueError(
                "adjudication peer refused the hash-pinned block"
            ) from None
    truth = next_filter_header(fhash_true, prev)
    if truth == mine[d]:
        return "other"
    if truth == theirs[d]:
        return "self"
    return "both"


async def get_snapshot(
    host: str,
    port: int,
    difficulty: int,
    timeout: float = 60.0,
    retarget=None,
    out_path=None,
):
    """Fetch the node's current state snapshot (chain/snapshot.py):
    manifest first, then chunk ranges, each chunk verified against its
    manifest digest AS IT ARRIVES and the state root checked at the end
    — the same incremental integrity contract the node's own snapshot
    boot applies.  Returns a fully verified ``LedgerSnapshot`` (or None
    when the peer serves no snapshot); ``out_path`` additionally writes
    the CRC-framed snapshot file.  The STATE is still only the serving
    peer's claim — only replaying the history proves it (the trust
    model `p1 snapshot` prints)."""
    from p1_tpu_torch.chain import snapshot as chain_snapshot

    async def _run():
        async with _session(host, port, difficulty, retarget) as (
            reader,
            writer,
            _,
        ):

            async def _reply():
                while True:
                    mtype, body = await _read_msg(reader, writer)
                    if mtype is MsgType.SNAPSHOT:
                        return body

            await protocol.write_frame(writer, protocol.encode_getsnapshot(0, 0))
            body = await _reply()
            if body[0] == "none":
                return None
            if body[0] != "manifest":
                raise ValueError("peer answered chunks before the manifest")
            manifest_payload = body[1]
            manifest = chain_snapshot.parse_manifest(manifest_payload)
            chunks: list[bytes] = []
            while len(chunks) < len(manifest.chunk_digests):
                await protocol.write_frame(
                    writer, protocol.encode_getsnapshot(len(chunks), 8)
                )
                body = await _reply()
                if body[0] != "chunks" or body[1] != len(chunks) or not body[2]:
                    raise ValueError("bad SNAPSHOT chunk range from peer")
                for payload in body[2]:
                    i = len(chunks)
                    if (
                        i >= len(manifest.chunk_digests)
                        or chain_snapshot.chunk_digest(payload)
                        != manifest.chunk_digests[i]
                    ):
                        raise ValueError(f"chunk {i} fails its manifest digest")
                    chunks.append(payload)
            snap = chain_snapshot.assemble(manifest, chunks)
            if out_path is not None:
                chain_snapshot.write_snapshot(out_path, manifest_payload, chunks)
            return snap

    return await asyncio.wait_for(_run(), timeout)


async def filter_scan(
    host: str,
    port: int,
    watch_items,
    difficulty: int,
    timeout: float = 120.0,
    retarget=None,
    fetch_blocks: bool = True,
    start_height: int = 1,
    page: int = 500,
    fallback_peers=(),
    verify_commitment: bool = True,
    transport=None,
):
    """Light-client sync by filter match (the serving plane's
    wallet flow): ONE session that

    1. syncs the peer's header chain (GETHEADERS locator rounds — the
       ~80 B/block skeleton),
    2. pages the compact filter stream (GETFILTERS) and matches
       ``watch_items`` (account ids as utf-8 bytes, and/or txids)
       locally — the peer never learns WHICH accounts the wallet
       watches, and the wallet asks zero per-address questions,
    3. fetches only the matching blocks (rare: the designed false-
       positive rate per absent item is ~1/M ≈ 1.3e-6) and pins each to
       the header chain by hash, dropping any filter false positives
       after inspection.

    Returns ``(headers, matches)`` where matches is a list of
    ``(height, block)`` — or ``(headers, [(height, block_hash), ...])``
    with ``fetch_blocks=False`` for callers that only want locations.
    Zero false negatives is the filter construction's guarantee
    (chain/filters.py): every block that actually touches a watched
    item IS in the matches (property-tested against full block scans).

    Trust model: same as ``get_headers`` — the header chain should be
    verified by the caller (``replay_host``); filters and blocks are
    pinned to it by hash, and fetched blocks are checked against their
    header's merkle commitment here, so a lying peer can omit service
    but cannot substitute content.

    Commitment verification (``verify_commitment``, v14): every served
    filter is checked against the peer's own filter-header chain
    (``header[i] = H(filter_hash[i] || header[i-1])``, genesis-anchored
    so the whole prefix is verified from local knowledge when the scan
    starts at height 1).  A peer whose filters contradict its own
    commitments raises ``CommitmentViolation`` immediately.  With
    ``fallback_peers``, the committed tip is also cross-checked against
    an independent replica; a disagreement is adjudicated by fetching
    the hash-pinned block at the first diverging height and computing
    the true filter locally — the proven liar is DEMOTED (never asked
    again this call) and the scan fails over to the next peer, so a
    wallet behind one dishonest replica still gets every confirmation.
    """
    from p1_tpu_torch.chain.chain import locator_hashes
    from p1_tpu_torch.chain.filters import (
        GENESIS_FILTER_HEADER,
        block_filter,
        filter_hash,
        matches_any,
        next_filter_header,
    )

    items = [
        it.encode("utf-8") if isinstance(it, str) else bytes(it)
        for it in watch_items
    ]
    demoted: set = set()

    async def _scan_one(t_host, t_port, cross_peers):
        genesis = make_genesis(difficulty, retarget)
        headers = [genesis.header]
        hashes = [genesis.block_hash()]
        pos = {hashes[0]: 0}
        async with _session(
            t_host, t_port, difficulty, retarget, transport=transport
        ) as (
            reader,
            writer,
            _,
        ):

            async def _reply(want):
                while True:
                    mtype, body = await _read_msg(reader, writer)
                    if mtype is want:
                        return body

            # 1. headers skeleton (single-session variant of get_headers;
            # the supervised multi-peer fetch lives there — this scan is
            # one wallet round against one chosen peer).
            while True:
                await protocol.write_frame(
                    writer, protocol.encode_getheaders(locator_hashes(hashes))
                )
                batch = await _reply(MsgType.HEADERS)
                new = [h for h in batch if h.block_hash() not in pos]
                if not new:
                    break
                at = pos.get(new[0].prev_hash)
                if at is None:
                    raise ValueError(
                        "HEADERS reply does not link to the known chain"
                    )
                if at != len(headers) - 1:
                    for h in hashes[at + 1 :]:
                        del pos[h]
                    del headers[at + 1 :]
                    del hashes[at + 1 :]
                for h in new:
                    if h.prev_hash != hashes[-1]:
                        raise ValueError("HEADERS batch is not contiguous")
                    headers.append(h)
                    hashes.append(h.block_hash())
                    pos[hashes[-1]] = len(hashes) - 1

            # 2. filter stream + local match, recording each accepted
            # filter's hash so step 2b can replay the commitment chain.
            matched: list[tuple[int, bytes]] = []
            scan_lo = max(1, start_height)
            fhashes: dict[int, bytes] = {}
            verified_to = scan_lo - 1
            h = scan_lo
            while h < len(hashes):
                await protocol.write_frame(
                    writer,
                    protocol.encode_getfilters(
                        h, min(page, len(hashes) - h)
                    ),
                )
                start, entries = await _reply(MsgType.FILTERS)
                if not entries:
                    break
                stop = False
                for i, (bhash, fbytes) in enumerate(entries):
                    height = start + i
                    if height >= len(hashes):
                        stop = True  # peer's chain ran ahead of our skeleton
                        break
                    if bhash != hashes[height]:
                        # The peer reorged between the header sync and
                        # this page; the stale tail's filters are for
                        # blocks we did not pin — stop at the divergence
                        # (a fuller client would re-sync headers).
                        stop = True
                        break
                    if items and matches_any(fbytes, bhash, items):
                        matched.append((height, bhash))
                    fhashes[height] = filter_hash(fbytes)
                    verified_to = height
                if stop:
                    break
                h = start + len(entries)

            # 2b. replay the peer's filter-header commitment chain over
            # the filters it just served.  Starting at height 1 the
            # anchor is the all-zero genesis header — fully verified
            # from local knowledge; a deeper start trusts the anchor
            # unless a fallback corroborates the tip below.
            if verify_commitment and verified_to >= scan_lo:
                served = await _fheaders_range(
                    reader, writer, scan_lo - 1, verified_to - scan_lo + 2
                )
                if len(served) == verified_to - scan_lo + 2:
                    prev = served[0]
                    if scan_lo == 1:
                        want_anchor = next_filter_header(
                            filter_hash(block_filter(genesis)),
                            GENESIS_FILTER_HEADER,
                        )
                        if prev != want_anchor:
                            raise CommitmentViolation(
                                f"{t_host}:{t_port} commits a wrong "
                                "genesis filter header"
                            )
                    for off, height in enumerate(
                        range(scan_lo, verified_to + 1)
                    ):
                        expect = next_filter_header(fhashes[height], prev)
                        if served[off + 1] != expect:
                            raise CommitmentViolation(
                                f"{t_host}:{t_port} served a filter at "
                                f"height {height} that contradicts its "
                                "own commitment chain"
                            )
                        prev = expect
                    # Cross-check the committed tip against independent
                    # replicas: honest peers derive the identical chain,
                    # so any disagreement has exactly one explanation —
                    # somebody forged a filter — and the hash-pinned
                    # block at the divergence names them.
                    for peer in list(cross_peers):
                        if peer in demoted:
                            continue
                        try:
                            theirs = await get_filter_headers(
                                *peer,
                                verified_to,
                                1,
                                difficulty,
                                retarget=retarget,
                                transport=transport,
                            )
                        except (
                            ConnectionError,
                            OSError,
                            ValueError,
                            asyncio.IncompleteReadError,
                            asyncio.TimeoutError,
                            TimeoutError,
                        ):
                            continue  # unreachable/short peer ≠ evidence
                        if not theirs or theirs[0] == prev:
                            continue
                        mine = await _fheaders_range(
                            reader, writer, 0, verified_to + 1
                        )
                        verdict = await _adjudicate(
                            mine,
                            peer,
                            hashes,
                            verified_to,
                            difficulty,
                            retarget,
                            transport,
                        )
                        if verdict in ("other", "both"):
                            demoted.add(peer)
                        if verdict in ("self", "both"):
                            raise CommitmentViolation(
                                f"{t_host}:{t_port} serves forged filters "
                                f"(proven at cross-check vs "
                                f"{peer[0]}:{peer[1]})"
                            )

            if not fetch_blocks:
                return headers, matched

            # 3. fetch ONLY the matched blocks, pinned by hash; drop
            # false positives after inspection (a block whose filter
            # matched but that touches none of the watched items).
            out = []
            for height, bhash in matched:
                await protocol.write_frame(
                    writer,
                    protocol.encode_getblocks([hashes[height - 1]]),
                )
                blocks = await _reply(MsgType.BLOCKS)
                if not blocks or blocks[0].block_hash() != bhash:
                    raise ValueError(
                        "peer did not serve the filter-matched block"
                    )
                block = blocks[0]
                if not block.merkle_ok():
                    raise ValueError(
                        "matched block fails its merkle commitment"
                    )
                touched = set()
                for tx in block.txs:
                    touched.add(tx.txid())
                    touched.add(tx.sender.encode("utf-8"))
                    touched.add(tx.recipient.encode("utf-8"))
                if any(it in touched for it in items):
                    out.append((height, block))
            return headers, out

    async def _run():
        targets = [(host, port), *(tuple(p) for p in fallback_peers)]
        last_exc: CommitmentViolation | None = None
        for i, (t_host, t_port) in enumerate(targets):
            if (t_host, t_port) in demoted:
                continue
            others = [t for j, t in enumerate(targets) if j != i]
            try:
                return await _scan_one(t_host, t_port, others)
            except CommitmentViolation as e:
                # A proven liar: demote (never re-ask) and fail over to
                # the next replica with the same watch list.
                demoted.add((t_host, t_port))
                last_exc = e
        raise last_exc if last_exc is not None else CommitmentViolation(
            "all peers demoted"
        )

    return await asyncio.wait_for(_run(), timeout)


class ReplicaSet:
    """Wallet-side target selection over a replica fleet — the policy
    that replaces ``watch``'s static fallback tuple (the fleet half).

    The set holds an ordered list of replica addresses plus an optional
    ``full_node`` of last resort, and scores every target from the
    signals the watch loop already produces: dead/stalled sessions
    (``note_stall``), EVENTGAP shedding (``note_gap``), verified events
    (``note_event``), cross-check corroborations (``note_agreement``),
    and proven commitment violations (``note_violation`` — permanent
    demotion, same contract as ``watch``'s demoted set).  ``pick()``
    returns the healthiest live replica, preferring targets whose
    filter-header chains have agreed at cross-checks, and sheds to the
    full node ONLY when every replica is demoted or mid-outage
    (``SHED_AFTER`` consecutive dead sessions) — read capacity stays on
    the replica tier unless the tier is actually gone.

    ``spread_key`` rotates tie-breaks so a fleet of wallets started
    with distinct keys (e.g. a session serial) spreads its
    subscriptions across replicas instead of dog-piling the first
    address.  ``update_targets`` rebalances live: a replica that died
    leaves (its health forgotten), a freshly provisioned one joins cold
    and, being unscored, is immediately eligible — the elastic-fleet
    seam the chaos ``replica_join`` op drives.

    Everything here is deterministic (no clock, no randomness): the
    same signal sequence always selects the same targets, which is what
    lets the chaos plane put ReplicaSet-driven wallets inside the
    trace-digest contract."""

    #: Consecutive dead/stalled sessions after which a replica counts
    #: as mid-outage for the shed-to-full-node decision.
    SHED_AFTER = 2

    def __init__(self, replicas, *, full_node=None, spread_key: int = 0):
        self.full_node = tuple(full_node) if full_node is not None else None
        self.spread_key = int(spread_key)
        self.demoted: set[tuple] = set()
        self.failovers = 0
        self.rebalances = 0
        self.active: tuple | None = None
        self._order: list[tuple] = []
        self._health: dict[tuple, dict] = {}
        self.update_targets(replicas)
        self.rebalances = 0  # construction is not a rebalance

    def __len__(self) -> int:
        return len(self._order)

    @staticmethod
    def _fresh() -> dict:
        return {
            "stalls": 0,  # dead/stalled sessions, cumulative
            "gaps": 0,  # EVENTGAP shed notices
            "events": 0,  # verified events served
            "agreements": 0,  # cross-check corroborations
            "streak": 0,  # CONSECUTIVE stalls since the last event
        }

    def _h(self, target) -> dict:
        t = tuple(target)
        h = self._health.get(t)
        if h is None:
            h = self._health[t] = self._fresh()
        return h

    # -- policy signals ------------------------------------------------

    def note_stall(self, target) -> None:
        h = self._h(target)
        h["stalls"] += 1
        h["streak"] += 1

    def note_gap(self, target) -> None:
        self._h(target)["gaps"] += 1

    def note_event(self, target) -> None:
        h = self._h(target)
        h["events"] += 1
        h["streak"] = 0

    def note_agreement(self, target) -> None:
        self._h(target)["agreements"] += 1

    def note_violation(self, target) -> None:
        """Proven commitment violation: permanent demotion."""
        self.demoted.add(tuple(target))

    # -- membership ----------------------------------------------------

    def update_targets(self, replicas) -> tuple[list, list]:
        """Rebalance to a new replica list (a replica died, a fresh one
        joined): returns ``(joined, left)``.  Health carries over for
        replicas that persist; leavers are forgotten entirely (a
        re-provisioned address starts cold), and demotions are NOT
        forgotten — a liar that rejoins under the same address stays
        demoted."""
        new = list(dict.fromkeys(tuple(p) for p in replicas))
        seen = set(new)
        left = [t for t in self._order if t not in seen]
        joined = [t for t in new if t not in self._health]
        self._order = new
        for t in joined:
            self._health[t] = self._fresh()
        for t in left:
            self._health.pop(t, None)
        if joined or left:
            self.rebalances += 1
        if (
            self.active is not None
            and self.active not in seen
            and self.active != self.full_node
        ):
            self.active = None
        return joined, left

    def peers(self) -> list[tuple]:
        """Every target (replicas, then the full node) — the universe
        the watch cross-check corroborates against."""
        out = list(self._order)
        if self.full_node is not None and self.full_node not in out:
            out.append(self.full_node)
        return out

    def live(self) -> list[tuple]:
        return [t for t in self.peers() if t not in self.demoted]

    # -- selection -----------------------------------------------------

    def _score(self, target) -> float:
        """Lower is better.  The consecutive-stall streak dominates
        (a replica mid-outage must lose to any healthy one fast);
        cumulative stalls and shed gaps drag; agreement at cross-checks
        and served events earn bounded preference (bounded so a
        long-lived favorite cannot become unsheddable)."""
        h = self._h(target)
        return (
            4.0 * h["streak"]
            + 1.0 * h["stalls"]
            + 0.5 * h["gaps"]
            - 2.0 * min(h["agreements"], 8)
            - 0.05 * min(h["events"], 32)
        )

    def pick(self) -> tuple | None:
        """The target the next session should dial: the healthiest live
        replica (ties broken by ``spread_key``-rotated join order), the
        full node when the replica tier is exhausted, None when every
        target is demoted (the caller raises)."""
        replicas = [t for t in self._order if t not in self.demoted]
        node_ok = (
            self.full_node is not None and self.full_node not in self.demoted
        )
        if not replicas:
            return self.full_node if node_ok else None
        if node_ok and all(
            self._h(t)["streak"] >= self.SHED_AFTER for t in replicas
        ):
            return self.full_node
        n = len(self._order)
        return min(
            replicas,
            key=lambda t: (
                self._score(t),
                (self._order.index(t) - self.spread_key) % n,
            ),
        )

    def mark_active(self, target) -> None:
        """Record the target a session is now riding; counts a failover
        whenever it differs from the previous one."""
        t = tuple(target)
        if self.active is not None and self.active != t:
            self.failovers += 1
        self.active = t

    def snapshot(self) -> dict:
        """The replica-health/selection surface (`p1 watch` JSON,
        OBSERVABILITY.md catalog)."""
        return {
            "replicas": len(self._order),
            "demoted": len(self.demoted),
            "failovers": self.failovers,
            "rebalances": self.rebalances,
            "active": (
                f"{self.active[0]}:{self.active[1]}" if self.active else None
            ),
            "health": {
                f"{h}:{p}": dict(v) for (h, p), v in self._health.items()
            },
        }


async def watch(
    host: str,
    port: int,
    watch_items,
    difficulty: int,
    *,
    retarget=None,
    cursor: tuple[int, bytes] | None = None,
    fallback_peers=(),
    replica_set: ReplicaSet | None = None,
    transport=None,
    handshake_timeout: float = 10.0,
    cross_check_every: int = 32,
    rewind_ring: int = 1024,
    reconnect_delay_s: float = 0.25,
    max_session_failures: int | None = None,
):
    """Live wallet push plane (v14): SUBSCRIBE to a node or replica and
    yield one verified dict per connected block —

        {"height", "block_hash", "filter_header", "matched",
         "txids", "peer"}

    ``matched`` is re-derived LOCALLY from the pushed filter (the
    server's claim is only a hint, as is ``txids`` — a wallet confirms
    a payment by fetching the block or an SPV proof, both hash-pinned).

    Verify-before-believe, per event: the raw header must link to the
    previous verified block and carry the chain's proof of work, and the
    pushed filter must extend the filter-header commitment chain from
    the last verified cursor (``H(filter_hash || prev)``).  Any
    contradiction raises/handles ``CommitmentViolation``: the peer is
    DEMOTED and the watch fails over to the next of ``fallback_peers``,
    re-subscribing at the last verified cursor so the new replica
    replays exactly the missed window — zero missed confirmations
    across a lying or dying replica.

    Degradation handling: a coalesce hole (skipped heights) or an
    explicit gap notice triggers a cursor re-subscribe on the same
    session — the server replays the hole as full events.  A server
    that keeps shedding rotates like a dead one.  Reorgs rewind through
    a ring of the last ``rewind_ring`` verified blocks; deeper reorgs
    reset the anchor (the wallet should rescan history — see below).

    Trust scope: with a ``cursor`` (the last (height, filter_header)
    the CALLER verified, e.g. from a prior ``filter_scan``), everything
    yielded is anchored to that knowledge.  Without one, the anchor is
    trust-on-first-use at the serving peer's committed tip and the
    watch verifies FORWARD from there — historical verification is
    ``filter_scan``'s job.  ``cross_check_every`` events, the committed
    tip is compared against an independent fallback; disagreement is
    adjudicated via the hash-pinned block at the first divergence when
    the ring still covers it, else resolved conservatively by failing
    over.  ``max_session_failures`` bounds consecutive dead sessions
    (None = retry forever; daemons bound the watch by deadline/cancel
    instead).

    Target selection: a ``replica_set`` (``ReplicaSet``) makes the
    fleet policy explicit — health-scored selection, agreement
    preference, shed-to-full-node, live rebalancing via
    ``update_targets`` — and ``host``/``port`` are then ignored for
    dialing (the set picks).  Without one, an internal set over
    ``[(host, port), *fallback_peers]`` reproduces the classic
    rotate-on-failure order (all targets start tied, so join order
    breaks ties exactly like the old round-robin)."""
    from p1_tpu_torch.chain.filters import (
        filter_hash,
        matches_any,
        next_filter_header,
    )
    from p1_tpu_torch.core.header import BlockHeader, meets_target

    items = [
        it.encode("utf-8") if isinstance(it, str) else bytes(it)
        for it in watch_items
    ]
    if not items:
        raise ValueError("watch needs at least one watch item")

    if replica_set is not None and fallback_peers:
        raise ValueError("pass either replica_set or fallback_peers")
    rs = (
        replica_set
        if replica_set is not None
        else ReplicaSet([(host, port), *(tuple(p) for p in fallback_peers)])
    )
    anchor = (int(cursor[0]), bytes(cursor[1])) if cursor is not None else None
    anchor_bhash: bytes | None = None
    ring: dict[int, tuple[bytes, bytes]] = {}  # height -> (bhash, fheader)
    failures = 0
    events_seen = 0
    last_violation: CommitmentViolation | None = None
    net_errors = (
        ConnectionError,
        OSError,
        asyncio.IncompleteReadError,
        asyncio.TimeoutError,
        TimeoutError,
    )

    async def _cross_check(serving, height, fheader):
        """Compare our verified committed tip against one independent
        replica; on disagreement, adjudicate and demote the proven
        liar.  Raises CommitmentViolation when the SERVING peer loses
        (or when the divergence predates what this watch verified —
        conservative: fail over rather than keep riding a suspect)."""
        for peer in rs.peers():
            if peer == serving or peer in rs.demoted:
                continue
            try:
                theirs = await get_filter_headers(
                    *peer, height, 1, difficulty,
                    retarget=retarget, transport=transport,
                )
            except net_errors + (ValueError,):
                continue  # unreachable/short peer is not evidence
            if not theirs:
                continue
            if theirs[0] == fheader:
                # Corroborated: both chains agree — the agreement
                # preference the selection policy feeds on.
                rs.note_agreement(serving)
                rs.note_agreement(peer)
                return
            try:
                mine_chain = await get_filter_headers(
                    *serving, 0, height + 1, difficulty,
                    retarget=retarget, transport=transport,
                )
            except net_errors + (ValueError,):
                return
            if len(mine_chain) != height + 1:
                return
            cover = {hh: ring[hh][0] for hh in ring}
            try:
                verdict = await _adjudicate(
                    mine_chain, peer, cover, height,
                    difficulty, retarget, transport,
                )
            except KeyError:
                # First divergence below the ring: cannot fetch the
                # pinned block to prove who lies — prefer failover.
                verdict = "self"
            except net_errors + (ValueError,):
                continue
            if verdict in ("other", "both"):
                rs.note_violation(peer)
            if verdict in ("self", "both"):
                raise CommitmentViolation(
                    f"{serving[0]}:{serving[1]} filter-header chain "
                    f"disproven against {peer[0]}:{peer[1]}"
                )
            else:
                rs.note_agreement(serving)
            return

    while True:
        serving = rs.pick()
        if serving is None:
            if last_violation is not None:
                raise last_violation
            raise ConnectionError("all watch peers demoted")
        rs.mark_active(serving)
        got_event = False
        try:
            async with _session(
                *serving,
                difficulty,
                retarget,
                handshake_timeout=handshake_timeout,
                transport=transport,
            ) as (reader, writer, hello):
                if anchor is None:
                    # TOFU anchor at the peer's committed tip — walk
                    # back from its claimed height to the end of the
                    # committed span (replica refresh lag is ~0..1).
                    h = hello.tip_height
                    while h >= 0 and anchor is None:
                        got = await _fheaders_range(reader, writer, h, 1)
                        if got:
                            anchor = (h, got[0])
                        else:
                            h -= 1
                    if anchor is None:
                        raise ConnectionError(
                            "peer commits no filter headers yet"
                        )
                await protocol.write_frame(
                    writer, protocol.encode_subscribe(items, anchor)
                )
                bridge_rounds = 0
                while True:
                    mtype, ev = await _read_msg(reader, writer)
                    if mtype is not MsgType.EVENT:
                        continue
                    if isinstance(ev, protocol.GapEvent):
                        # Drop-to-cursor notice: re-subscribe at our
                        # verified anchor; the server replays the hole
                        # as full events (no separate bridge protocol).
                        # (A draining replica sends one of these as its
                        # goodbye, then refuses the re-subscribe — the
                        # net error below fails over cursor-intact.)
                        rs.note_gap(serving)
                        bridge_rounds += 1
                        if bridge_rounds > 8:
                            raise ConnectionError(
                                "peer keeps shedding this session"
                            )
                        await protocol.write_frame(
                            writer, protocol.encode_subscribe(items, anchor)
                        )
                        continue
                    header = BlockHeader.deserialize(ev.raw_header)
                    bhash = header.block_hash()
                    hv = ev.height
                    if hv <= anchor[0]:
                        # Reorg: the server walked back.  Rewind to the
                        # fork point through the verified ring.
                        ent = ring.get(hv - 1)
                        if ent is None:
                            anchor = None
                            anchor_bhash = None
                            ring.clear()
                            raise ConnectionError(
                                "reorg deeper than the rewind ring"
                            )
                        for k in [k for k in ring if k >= hv]:
                            del ring[k]
                        anchor = (hv - 1, ent[1])
                        anchor_bhash = ent[0]
                    if hv != anchor[0] + 1:
                        # Coalesce hole: replay it via cursor
                        # re-subscribe (replaces this session's sub).
                        bridge_rounds += 1
                        if bridge_rounds > 8:
                            raise ConnectionError(
                                "peer cannot replay the hole"
                            )
                        await protocol.write_frame(
                            writer, protocol.encode_subscribe(items, anchor)
                        )
                        continue
                    # Verify before believing.
                    if (
                        anchor_bhash is not None
                        and header.prev_hash != anchor_bhash
                    ):
                        raise CommitmentViolation(
                            f"{serving[0]}:{serving[1]} pushed a header "
                            "that does not link to the verified chain"
                        )
                    if not meets_target(bhash, header.difficulty) or (
                        retarget is None and header.difficulty != difficulty
                    ):
                        raise CommitmentViolation(
                            f"{serving[0]}:{serving[1]} pushed a header "
                            "without the chain's proof of work"
                        )
                    expect_fh = next_filter_header(
                        filter_hash(ev.filter), anchor[1]
                    )
                    if expect_fh != ev.filter_header:
                        raise CommitmentViolation(
                            f"{serving[0]}:{serving[1]} pushed a filter "
                            "that contradicts the commitment chain at "
                            f"height {hv}"
                        )
                    local_matched = matches_any(ev.filter, bhash, items)
                    ring[hv] = (bhash, expect_fh)
                    if len(ring) > rewind_ring:
                        del ring[min(ring)]
                    anchor = (hv, expect_fh)
                    anchor_bhash = bhash
                    bridge_rounds = 0
                    got_event = True
                    failures = 0
                    events_seen += 1
                    rs.note_event(serving)
                    if (
                        cross_check_every
                        and len(rs.live()) > 1
                        and events_seen % cross_check_every == 0
                    ):
                        await _cross_check(serving, hv, expect_fh)
                    yield {
                        "height": hv,
                        "block_hash": bhash,
                        "filter_header": expect_fh,
                        "matched": local_matched,
                        "txids": tuple(ev.txids),
                        "peer": serving,
                        "failovers": rs.failovers,
                    }
        except CommitmentViolation as e:
            # Proven liar: never ask again, fail over at the verified
            # cursor — the next replica replays the missed window.
            rs.note_violation(serving)
            last_violation = e
        except net_errors:
            # Dead/stalled/refusing session — not evidence of lying.
            # A session that dies before ANY event may mean the cursor
            # was refused (our anchor reorged away, or sits past a
            # pruned window): after repeated refusals, rewind the
            # anchor one verified ring step and try again.
            rs.note_stall(serving)
            if not got_event:
                failures += 1
                if (
                    max_session_failures is not None
                    and failures >= max_session_failures
                ):
                    raise
                if failures >= 2 and anchor is not None:
                    lower = [k for k in ring if k < anchor[0]]
                    if lower:
                        k = max(lower)
                        anchor = (k, ring[k][1])
                        anchor_bhash = ring[k][0]
            await asyncio.sleep(reconnect_delay_s)
