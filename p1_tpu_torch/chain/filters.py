"""Compact block filters: BIP158-style Golomb-coded sets for light clients.

The serving-plane problem this solves (ROADMAP open item 1): an SPV
wallet watching K accounts previously had to ask a node K questions per
block (GETACCOUNT/GETPROOF fan-out), and the node had to answer every
one from the consensus thread.  A compact block filter inverts the
query: the node publishes, per block, a few-bytes-per-transaction
probabilistic digest of *everything the block touches* (txids + sender
and recipient account ids), and the wallet downloads the digest stream
and asks its K questions LOCALLY.  A match means "download this block
and look" (rarely a false positive, bounded below); a non-match is a
**guarantee** the block is irrelevant — the construction has zero false
negatives, which is the property the wallet's correctness rests on and
the one the property tests pin (tests/test_queryplane.py).

The port's copy of ``p1_tpu/chain/filters.py``: the same filter bytes
and filter-header chain.

Construction (Bitcoin's BIP158, adapted):

- Each item (a byte string) is hashed to a 64-bit value and mapped
  uniformly onto ``[0, N*M)`` where N is the number of distinct items
  and 1/M the designed false-positive rate per queried item.  BIP158
  keys SipHash with the block hash; hashlib has no SipHash, so the map
  here is the first 8 bytes of SHA-256 over ``block_hash[:16] || item``
  — same independence-per-block property (a colliding pair in one
  block's filter is independent of every other block's), built from the
  primitive the codebase already trusts.
- The sorted values are delta-encoded with Golomb-Rice coding at
  parameter P (quotient in unary, P remainder bits).  With M ≈ 1.497 *
  2**P the expected cost is ~(P + 1.5) bits/item — ~2.6 bytes per item
  at the default P=19, i.e. ~8 bytes per transaction vs the hundreds of
  bytes of the transaction itself.
- The filter commits to N (u32 prefix), and matching decodes the
  stream once against the query set — O(filter + K log K), no
  per-query re-decode.

``P``/``M`` are parameters (wire payloads carry only the encoded
bytes; both sides derive P/M from the protocol constants) so the
property tests can run a deliberately lossy filter (small M) and
actually *measure* the false-positive rate against the designed bound
instead of asserting 0 ≈ 0 at the production 1/784931.

Durability note: a filter is a pure function of the block's canonical
bytes, so the append-only block log (chain/store.py) is already its
durable home — what this module adds is the bounded in-RAM
``FilterIndex`` (built incrementally at connect, backfillable for
existing stores, LRU-bounded so it cannot become the next O(chain) RAM
term the governor has to chase) and the codec both the node and the
read replicas (node/queryplane.py) share.
"""

from __future__ import annotations

import hashlib

#: Golomb-Rice remainder bits (BIP158's P) and the designed inverse
#: false-positive rate per queried item (BIP158's M).  M/2**P ≈ 1.497
#: minimizes bits/item for a given rate.
FILTER_P = 19
FILTER_M = 784931

#: How much of the block hash keys the per-block hash map.  16 bytes is
#: plenty of independence; keeping the key short keeps the per-item
#: hash input small.
_KEY_LEN = 16


def filter_items(block) -> set[bytes]:
    """The byte strings a block's filter commits to: every txid and every
    sender/recipient account id (utf-8).  Account ids are what wallets
    watch ("did anything touch my account?"); txids are what tools that
    already know a txid watch ("is my tx confirmed yet?").  A set —
    BIP158 dedups identical elements, and so does the value map below."""
    items: set[bytes] = set()
    for tx in block.txs:
        items.add(tx.txid())
        items.add(tx.sender.encode("utf-8"))
        items.add(tx.recipient.encode("utf-8"))
    return items


def _hash_to_range(key: bytes, item: bytes, f: int) -> int:
    """Map ``item`` uniformly onto [0, f) under the per-block ``key``.

    The multiply-shift map (h * f) >> 64 over a 64-bit hash is BIP158's
    uniform range reduction — unbiased for any f << 2**64, unlike a
    modulo."""
    h = int.from_bytes(
        hashlib.sha256(key + item).digest()[:8], "big"
    )
    return (h * f) >> 64


def _mapped_values(key: bytes, items, n: int, m: int) -> list[int]:
    f = n * m
    return sorted({_hash_to_range(key, it, f) for it in items})


class _BitWriter:
    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def unary(self, q: int) -> None:
        # q one-bits then a zero — BIP158's quotient encoding.
        while q >= 32:
            self.write(0xFFFFFFFF, 32)
            q -= 32
        self.write(((1 << q) - 1) << 1, q + 1)

    def done(self) -> bytes:
        if self._nbits:
            self._buf.append((self._acc << (8 - self._nbits)) & 0xFF)
            self._acc = 0
            self._nbits = 0
        return bytes(self._buf)


class _BitReader:
    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        end = self._pos + nbits
        if end > 8 * len(self._data):
            raise ValueError("filter bitstream truncated")
        out = 0
        pos = self._pos
        data = self._data
        while nbits > 0:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, nbits)
            out = (out << take) | (
                (byte >> (avail - take)) & ((1 << take) - 1)
            )
            pos += take
            nbits -= take
        self._pos = pos
        return out

    def unary(self) -> int:
        q = 0
        while self.read(1):
            q += 1
            if q > 8 * len(self._data):
                raise ValueError("filter unary run exceeds stream")
        return q


def encode_filter(key: bytes, items, p: int = FILTER_P, m: int = FILTER_M) -> bytes:
    """Build one filter: u32 N (distinct mapped values) + the Golomb-Rice
    bitstream of sorted deltas.  ``key`` is the block hash (truncated
    internally); an empty item set encodes as four zero bytes."""
    key = key[:_KEY_LEN]
    values = _mapped_values(key, items, max(1, len(set(items))), m)
    out = _BitWriter()
    last = 0
    for v in values:
        delta = v - last
        out.unary(delta >> p)
        out.write(delta, p)
        last = v
    return len(values).to_bytes(4, "big") + out.done()


def decode_values(filter_bytes: bytes, p: int = FILTER_P):
    """Yield the filter's sorted absolute values.  Raises ValueError on a
    truncated stream — peer-supplied filters go through here, so the
    caller can treat that as a protocol fault."""
    if len(filter_bytes) < 4:
        raise ValueError("filter shorter than its count prefix")
    n = int.from_bytes(filter_bytes[:4], "big")
    reader = _BitReader(filter_bytes[4:])
    last = 0
    for _ in range(n):
        q = reader.unary()
        r = reader.read(p)
        last += (q << p) | r
        yield last


def filter_count(filter_bytes: bytes) -> int:
    if len(filter_bytes) < 4:
        raise ValueError("filter shorter than its count prefix")
    return int.from_bytes(filter_bytes[:4], "big")


def matches_any(
    filter_bytes: bytes,
    key: bytes,
    items,
    p: int = FILTER_P,
    m: int = FILTER_M,
) -> bool:
    """True when ANY of ``items`` may be in the filtered block.

    Zero false negatives by construction: an item that was in the
    block's item set maps to a value the encoder committed, and the
    same map is applied to the query — so a miss here is proof of
    absence (what lets a light client SKIP the block).  False positives
    happen at ~len(items)/M per block and cost one wasted block fetch."""
    key = key[:_KEY_LEN]
    n = filter_count(filter_bytes)
    if n == 0 or not items:
        return False
    f = n * m
    targets = sorted({_hash_to_range(key, it, f) for it in items})
    ti = 0
    for value in decode_values(filter_bytes, p):
        while ti < len(targets) and targets[ti] < value:
            ti += 1
        if ti == len(targets):
            return False
        if targets[ti] == value:
            return True
    return False


def decode_value_set(filter_bytes: bytes, p: int = FILTER_P) -> frozenset:
    """The filter's mapped values as a set — the push plane's shared
    decode: one pass per block, then ``matches_values`` per subscriber
    is a handful of hashes and set probes instead of a re-decode (the
    difference between O(subs · filter) and O(filter + subs · items)
    per connect at 100k live subscriptions)."""
    return frozenset(decode_values(filter_bytes, p))


def matches_values(
    values,
    n: int,
    key: bytes,
    items,
    m: int = FILTER_M,
) -> bool:
    """``matches_any`` against a pre-decoded value set (``values`` from
    ``decode_value_set``, ``n`` from ``filter_count``)."""
    if n == 0 or not items:
        return False
    key = key[:_KEY_LEN]
    f = n * m
    return any(_hash_to_range(key, it, f) in values for it in items)


def block_filter(block, p: int = FILTER_P, m: int = FILTER_M) -> bytes:
    """The canonical filter for ``block`` — keyed by its own hash, so a
    filter is verifiable against (and only against) the block it claims
    to summarize."""
    return encode_filter(block.block_hash(), filter_items(block), p, m)


class FilterIndex:
    """Bounded LRU of per-block filters, maintained at connect time.

    The node adds every block it connects (``Chain.add_block`` →
    node._handle_block path); anything evicted — or anything from
    before this feature existed ("backfillable for existing stores") —
    is rebuilt on demand from the block body, which the store can
    always re-serve (``ChainStore.read_body``).  ``bytes_used`` is
    charged to the node's accounted memory gauge, so a filter flood can
    never be the RAM term the PR-4 governor doesn't see."""

    def __init__(self, max_bytes: int = 16 << 20):
        import collections

        self.max_bytes = int(max_bytes)
        self._lru: "collections.OrderedDict[bytes, bytes]" = (
            collections.OrderedDict()
        )
        self.bytes_used = 0
        self.built = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._lru)

    def get(self, block_hash: bytes) -> bytes | None:
        f = self._lru.get(block_hash)
        if f is None:
            self.misses += 1
            return None
        self._lru.move_to_end(block_hash)
        self.hits += 1
        return f

    def add_block(self, block) -> bytes:
        """Build + cache ``block``'s filter (idempotent)."""
        bhash = block.block_hash()
        cached = self._lru.get(bhash)
        if cached is not None:
            self._lru.move_to_end(bhash)
            return cached
        f = block_filter(block)
        self._lru[bhash] = f
        self.bytes_used += len(f) + len(bhash)
        self.built += 1
        while self.bytes_used > self.max_bytes and len(self._lru) > 1:
            old_hash, old_f = self._lru.popitem(last=False)
            self.bytes_used -= len(old_f) + len(old_hash)
        return f

    def get_or_build(self, block_hash: bytes, block_loader) -> bytes:
        """The serving path: cached filter, or rebuild from the body
        ``block_loader(block_hash)`` re-serves (the chain's ``_block_at``
        / the store's ``read_body``)."""
        f = self.get(block_hash)
        if f is not None:
            return f
        return self.add_block(block_loader(block_hash))

    def snapshot(self) -> dict:
        return {
            "entries": len(self._lru),
            "bytes": self.bytes_used,
            "built": self.built,
            "hits": self.hits,
            "misses": self.misses,
        }


# -- the filter-header commitment chain (BIP157 analog) --------------------

#: The virtual header "before genesis" — the chain's anchor.  All-zero,
#: like BIP157's: the first real header is then a pure function of the
#: genesis block's filter, so two honest servers can never disagree.
GENESIS_FILTER_HEADER = b"\x00" * 32


def filter_hash(filter_bytes: bytes) -> bytes:
    return hashlib.sha256(filter_bytes).digest()


def next_filter_header(fhash: bytes, prev_header: bytes) -> bytes:
    """``filter_header[i] = H(filter_hash[i] || filter_header[i-1])`` —
    each header commits to every filter before it, so a wallet that
    knows ONE trusted header height can verify a whole served filter
    stream below it, and two servers that disagree anywhere disagree at
    the tip."""
    return hashlib.sha256(fhash + prev_header).digest()


class FilterHeaderChain:
    """The height-indexed commitment chain over the main branch.

    This is what closes the ROUND9 trust gap: filters themselves are
    pure functions of block bytes, but a wallet syncing from ONE
    untrusted replica had no way to tell a served filter from a forged
    one without downloading the block.  The header chain makes forgery
    *comparable*: any two servers of the same chain must serve identical
    filter headers at every height, so a wallet cross-checks the stream
    against a second source (or a single hash-pinned block fetch) and
    demotes whichever side broke the commitment.

    Maintained incrementally by ``sync()`` against any height→hash /
    height→filter source (the node's ``Chain``, a replica's mmap view).
    Entries store ``(block_hash, filter_header)`` so a reorg is detected
    by hash comparison and handled by truncate-and-extend.  A source
    that cannot produce a filter (pruned/re-based history with the body
    gone) simply stops the extension: the chain stays short and range
    queries refuse cleanly — wallets fail over to an archive holder,
    they are never served an uncommitted guess.
    """

    def __init__(self):
        self._entries: list[tuple[bytes, bytes]] = []  # index = height
        self.rebuilds = 0  # reorg truncations observed

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def tip_height(self) -> int:
        """Highest committed height; -1 when empty/unavailable."""
        return len(self._entries) - 1

    def header_at(self, height: int) -> bytes | None:
        if 0 <= height < len(self._entries):
            return self._entries[height][1]
        if height == -1:
            return GENESIS_FILTER_HEADER
        return None

    def hash_at(self, height: int) -> bytes | None:
        """The BLOCK hash the commitment at ``height`` was built for."""
        if 0 <= height < len(self._entries):
            return self._entries[height][0]
        return None

    def range(self, start: int, count: int) -> list[bytes]:
        """Headers for ``start .. start+count-1``; empty when any part of
        the span is not committed (refusal, never a partial lie)."""
        if start < 0 or count <= 0 or start + count > len(self._entries):
            return []
        return [h for _, h in self._entries[start : start + count]]

    def seed(self, entries: list[tuple[bytes, bytes]]) -> None:
        """Adopt a ``(block_hash, filter_header)`` prefix wholesale — the
        snapshot-bootstrapped replica's case (node/provision.py): the
        bodies below the snapshot base are not on disk, so the prefix
        cannot be recomputed locally; it is adopted from the bootstrap
        peer under the same trust model as the assumed snapshot itself
        (any forgery diverges from every honest server at the first
        adopted height, which is exactly what the wallet cross-check and
        hash-pinned adjudication catch).  Replaces the whole chain;
        ``sync()`` then extends from the adopted tip using real bodies."""
        self._entries = [(bytes(bh), bytes(fh)) for bh, fh in entries]

    def sync(self, tip_height: int, hash_at, filter_at) -> list[int]:
        """Advance (or repair) the chain against a source of truth;
        returns the heights whose commitments are new or changed — the
        push plane's notification list.

        ``hash_at(h) -> bytes | None`` and ``filter_at(h) -> bytes |
        None`` read the source's main branch.  The common case is O(1):
        the stored tip hash still matches and only new heights extend.
        A mismatch walks back to the fork point, truncates, and
        re-extends (the reorg path).  ``filter_at`` returning None stops
        the extension — the remaining span stays uncommitted."""
        # Walk back over any suffix the source no longer agrees with.
        top = len(self._entries) - 1
        while top >= 0 and self._entries[top][0] != hash_at(top):
            top -= 1
        if top < len(self._entries) - 1:
            del self._entries[top + 1 :]
            self.rebuilds += 1
        changed: list[int] = []
        prev = (
            self._entries[-1][1] if self._entries else GENESIS_FILTER_HEADER
        )
        for h in range(len(self._entries), tip_height + 1):
            bhash = hash_at(h)
            if bhash is None:
                break
            fbytes = filter_at(h)
            if fbytes is None:
                break  # pruned/spilled body: stay honestly short
            prev = next_filter_header(filter_hash(fbytes), prev)
            self._entries.append((bhash, prev))
            changed.append(h)
        return changed
