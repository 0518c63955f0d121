"""Snapshot-state sync: canonical ledger serialization + merkle state root.

ROADMAP item 2 (the assumeUTXO analog, Bitcoin-Core lineage): a new node
should boot from a *state snapshot* in seconds and serve queries
immediately, while the chain history revalidates in the background.  The
hard part is the robustness contract — a snapshot is untrusted input
from an adversarial peer — so everything in this module is built to be
checkable:

The port's copy of ``p1_tpu/chain/snapshot.py``: snapshot files and
``state_root`` are byte-identical to the JAX package's.

- **Canonical serialization.**  Account state (balances + nonces) is
  encoded as a sorted-by-account sequence of fixed-layout entries, cut
  into chunks of ``CHUNK_ACCOUNTS``.  Same state ⇒ same bytes,
  regardless of dict insertion order or ``PYTHONHASHSEED``
  (property-tested in tests/test_snapshot.py) — which is what makes the
  digests below meaningful.
- **Merkle-ized state root.**  One SHA-256d leaf per account entry,
  combined with the same duplicate-odd-leaf tree as block merkle roots
  (``core/block.py``).  ``Chain`` commits this root at checkpoint
  heights (the retarget interval, or ``DEFAULT_CHECKPOINT_INTERVAL`` on
  fixed-difficulty chains) as it applies blocks, so a replaying node can
  compare its own state against a snapshot's claim at exactly one
  height.
- **Self-describing manifest + chunk digests.**  The manifest names the
  snapshot height, block hash, state root, account count, and one
  SHA-256d digest per chunk — plus the full serialized anchor block, so
  a receiver can check the block hash, PoW, and merkle commitment
  before spending anything on chunks.  Chunks verify *incrementally* as
  they arrive (digest per chunk), so a peer lying mid-transfer is
  caught on the first bad chunk, not after the whole download.
- **CRC-framed v3-style records on disk.**  Snapshot files reuse the
  chain store's framing discipline (``P1TPUSS1`` magic; per-record
  CRC32 trailer over length prefix + payload): a torn tail or bit-rot
  is detected, never trusted through.

Trust model (spelled out because it is easy to over-read): the state
root proves the *chunks* match the *manifest* — nothing more.  Until
background revalidation replays the real history and reproduces the
same root at the same height, the whole snapshot — root included — is
just the serving peer's claim.  ``docs/ROUND12.md`` carries the full
honesty notes; ``node/node.py`` carries the ASSUMED→VALIDATED flip.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from pathlib import Path

from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.hashutil import sha256d

__all__ = [
    "CHUNK_ACCOUNTS",
    "DEFAULT_CHECKPOINT_INTERVAL",
    "MAGIC",
    "IncrementalState",
    "LedgerSnapshot",
    "Manifest",
    "SnapshotError",
    "build_records",
    "build_records_incremental",
    "chunk_digest",
    "encode_chunks",
    "load_snapshot",
    "parse_chunk",
    "parse_manifest",
    "read_records",
    "state_root",
    "verify_file",
    "write_snapshot",
]

#: Snapshot file format tag — versioned like the chain store's magic.
MAGIC = b"P1TPUSS1"

#: Accounts per chunk.  ~26 B/entry for short account ids means a chunk
#: is a few hundred KB at worst — far under the wire frame cap, so one
#: SNAPSHOT reply can carry several chunks.
CHUNK_ACCOUNTS = 4096

#: Checkpoint spacing on fixed-difficulty chains (retargeting chains use
#: their retarget window — the "natural" consensus cadence this feature
#: is specified against).  Chain commits a state root at every multiple.
DEFAULT_CHECKPOINT_INTERVAL = 64

_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")
_U32 = struct.Struct(">I")
_ENTRY_TAIL = struct.Struct(">QQ")  # balance, nonce
_MANIFEST_VERSION = 1
#: Hard cap on one snapshot record (manifest or chunk) — the same bound
#: the chain store enforces, for the same reason: a corrupt length
#: prefix must not drive an unbounded read.
MAX_RECORD = 32 << 20


class SnapshotError(ValueError):
    """Snapshot bytes that fail their own integrity contract (framing,
    digest, root, or layout) — untrusted input doing what untrusted
    input does."""


# -- canonical state encoding ---------------------------------------------


def _encode_entry(account: str, balance: int, nonce: int) -> bytes:
    raw = account.encode("utf-8")
    if not 0 < len(raw) <= 255:
        raise SnapshotError(f"account id encodes to {len(raw)} bytes")
    if balance < 0 or nonce < 0:
        raise SnapshotError(f"negative state for {account!r}")
    return bytes([len(raw)]) + raw + _ENTRY_TAIL.pack(balance, nonce)


def _iter_entries(
    balances: dict[str, int], nonces: dict[str, int]
):
    """(account, balance, nonce) for every account with ANY nonzero
    state, in canonical (utf-8 byte) order — the one definition both the
    root and the chunk encoder share, so they cannot drift."""
    accounts = {a for a, v in balances.items() if v}
    accounts.update(a for a, n in nonces.items() if n)
    for account in sorted(accounts, key=lambda a: a.encode("utf-8")):
        yield account, balances.get(account, 0), nonces.get(account, 0)


def state_root(balances: dict[str, int], nonces: dict[str, int]) -> bytes:
    """Merkle root over the canonical account entries (32 bytes).  Empty
    state maps to the all-zeros root, like an empty merkle tree."""
    leaves = [
        sha256d(_encode_entry(a, b, n)) for a, b, n in _iter_entries(balances, nonces)
    ]
    return merkle_root(leaves)


def encode_chunks(
    balances: dict[str, int],
    nonces: dict[str, int],
    chunk_accounts: int = CHUNK_ACCOUNTS,
) -> list[bytes]:
    """The canonical chunk payloads: sorted entries, ``chunk_accounts``
    per chunk.  Deterministic for a given state by construction."""
    entries = [
        _encode_entry(a, b, n) for a, b, n in _iter_entries(balances, nonces)
    ]
    chunks = []
    for i in range(0, len(entries), chunk_accounts):
        part = entries[i : i + chunk_accounts]
        chunks.append(_U32.pack(len(part)) + b"".join(part))
    return chunks


def parse_chunk(payload: bytes) -> list[tuple[str, int, int]]:
    """Decode one chunk payload back to (account, balance, nonce) rows;
    raises ``SnapshotError`` on any malformation (hostile input)."""
    if len(payload) < _U32.size:
        raise SnapshotError("truncated chunk")
    (n,) = _U32.unpack_from(payload)
    off = _U32.size
    rows = []
    for _ in range(n):
        if len(payload) < off + 1:
            raise SnapshotError("truncated chunk entry")
        alen = payload[off]
        if alen == 0 or len(payload) < off + 1 + alen + _ENTRY_TAIL.size:
            raise SnapshotError("bad chunk entry")
        account = payload[off + 1 : off + 1 + alen].decode("utf-8")
        balance, nonce = _ENTRY_TAIL.unpack_from(payload, off + 1 + alen)
        rows.append((account, balance, nonce))
        off += 1 + alen + _ENTRY_TAIL.size
    if off != len(payload):
        raise SnapshotError("trailing bytes in chunk")
    return rows


def chunk_digest(payload: bytes) -> bytes:
    return sha256d(payload)


# -- the manifest ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Manifest:
    """The snapshot's self-description: what it claims, and the digests
    that make every other byte of it checkable against the claim."""

    height: int
    block_hash: bytes
    state_root: bytes
    accounts: int
    chunk_digests: tuple[bytes, ...]
    #: The full anchor block at ``height`` — hash, PoW, and merkle
    #: commitment are checkable before any chunk is fetched, and the
    #: header is what the assumed chain extends from.
    block: Block


def encode_manifest(m: Manifest) -> bytes:
    raw_block = m.block.serialize()
    parts = [
        bytes([_MANIFEST_VERSION]),
        struct.pack(">I", m.height),
        m.block_hash,
        m.state_root,
        struct.pack(">II", m.accounts, len(m.chunk_digests)),
        *m.chunk_digests,
        _LEN.pack(len(raw_block)),
        raw_block,
    ]
    return b"".join(parts)


def parse_manifest(payload: bytes) -> Manifest:
    """Decode + internally verify a manifest payload: the embedded block
    must hash to the claimed block hash (a manifest whose anchor does
    not even match itself is rejected before any network round)."""
    if len(payload) < 1 + 4 + 32 + 32 + 8:
        raise SnapshotError("truncated manifest")
    if payload[0] != _MANIFEST_VERSION:
        raise SnapshotError(f"unknown manifest version {payload[0]}")
    (height,) = struct.unpack_from(">I", payload, 1)
    block_hash = payload[5:37]
    root = payload[37:69]
    accounts, n_chunks = struct.unpack_from(">II", payload, 69)
    off = 77
    if len(payload) < off + 32 * n_chunks + _LEN.size:
        raise SnapshotError("truncated manifest digests")
    digests = tuple(
        payload[off + 32 * i : off + 32 * (i + 1)] for i in range(n_chunks)
    )
    off += 32 * n_chunks
    (blen,) = _LEN.unpack_from(payload, off)
    off += _LEN.size
    if len(payload) != off + blen:
        raise SnapshotError("bad manifest block length")
    try:
        block = Block.deserialize(payload[off:])
    except ValueError as e:
        raise SnapshotError(f"bad manifest anchor block: {e}") from e
    if block.block_hash() != block_hash:
        raise SnapshotError("manifest anchor block does not match its hash")
    return Manifest(height, block_hash, root, accounts, digests, block)


@dataclasses.dataclass(frozen=True)
class LedgerSnapshot:
    """A fully verified snapshot: manifest + the reconstructed state.
    ``assemble`` is the only constructor that matters — it re-derives
    every digest and the root, so holding one of these means the bytes
    were at least internally consistent (NOT that the state is true;
    that is the background revalidation's job)."""

    manifest: Manifest
    balances: dict[str, int]
    nonces: dict[str, int]

    @property
    def height(self) -> int:
        return self.manifest.height

    @property
    def block_hash(self) -> bytes:
        return self.manifest.block_hash

    @property
    def state_root(self) -> bytes:
        return self.manifest.state_root


def assemble(manifest: Manifest, chunk_payloads: list[bytes]) -> LedgerSnapshot:
    """Rebuild the state from verified parts; raises ``SnapshotError``
    on any digest/count/order/root mismatch.  This is the LAST integrity
    gate before a node dares serve the state in ASSUMED mode."""
    if len(chunk_payloads) != len(manifest.chunk_digests):
        raise SnapshotError(
            f"{len(chunk_payloads)} chunks for "
            f"{len(manifest.chunk_digests)} digests"
        )
    balances: dict[str, int] = {}
    nonces: dict[str, int] = {}
    prev_key: bytes | None = None
    total = 0
    for i, payload in enumerate(chunk_payloads):
        if chunk_digest(payload) != manifest.chunk_digests[i]:
            raise SnapshotError(f"chunk {i} fails its manifest digest")
        for account, balance, nonce in parse_chunk(payload):
            key = account.encode("utf-8")
            if prev_key is not None and key <= prev_key:
                raise SnapshotError("chunk entries out of canonical order")
            prev_key = key
            if balance:
                balances[account] = balance
            if nonce:
                nonces[account] = nonce
            total += 1
    if total != manifest.accounts:
        raise SnapshotError(
            f"{total} accounts decoded, manifest claims {manifest.accounts}"
        )
    if state_root(balances, nonces) != manifest.state_root:
        raise SnapshotError("state root mismatch")
    return LedgerSnapshot(manifest, balances, nonces)


def build_records(
    height: int,
    block: Block,
    balances: dict[str, int],
    nonces: dict[str, int],
    chunk_accounts: int = CHUNK_ACCOUNTS,
) -> tuple[bytes, list[bytes]]:
    """(manifest payload, chunk payloads) for a state — the serving
    side's one-stop shop (node GETSNAPSHOT cache, ``p1 snapshot
    create``)."""
    chunks = encode_chunks(balances, nonces, chunk_accounts)
    manifest = Manifest(
        height=height,
        block_hash=block.block_hash(),
        state_root=state_root(balances, nonces),
        accounts=sum(1 for _ in _iter_entries(balances, nonces)),
        chunk_digests=tuple(chunk_digest(c) for c in chunks),
        block=block,
    )
    return encode_manifest(manifest), chunks


# -- incremental building (round 20: continuous snapshot publication) ------


@dataclasses.dataclass
class IncrementalState:
    """The reusable residue of one ``build_records_incremental`` run:
    every per-account encoded entry and leaf hash, the canonical key
    order, and the chunk payloads + digests — everything the NEXT build
    can reuse for accounts a dirty set does not name.  Purely an
    optimization cache: holding a stale or wrong one can cost bytes
    re-encoded, never a wrong snapshot, because reuse is gated on the
    dirty set the chain derived from its own ledger applications."""

    entries: dict[str, bytes]
    leaves: dict[str, bytes]
    keys: list[str]
    chunks: list[bytes]
    digests: list[bytes]
    chunk_accounts: int
    #: Every level of the state-root merkle tree (leaves up to root,
    #: virtual odd-tail duplication — see ``_merkle_levels``) and the
    #: key → leaf-index map: together they turn the root recompute into
    #: an O(delta·log n) path update when the key set is stable, which
    #: profiling showed was the whole residual cost of a warm build.
    levels: list[list[bytes]] = dataclasses.field(default_factory=list)
    index: dict[str, int] = dataclasses.field(default_factory=dict)


def _merkle_levels(leaves: list[bytes]) -> list[list[bytes]]:
    """All levels of ``merkle_root``'s tree WITHOUT materializing the
    odd-tail duplicates (the pair step treats a missing right sibling
    as the left one, exactly like core/block.py's combine) — so a path
    update never has to keep a trailing copy coherent."""
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        lvl = levels[-1]
        levels.append(
            [
                sha256d(lvl[i] + (lvl[i + 1] if i + 1 < len(lvl) else lvl[i]))
                for i in range(0, len(lvl), 2)
            ]
        )
    return levels


def _merkle_update(levels: list[list[bytes]], changed: set[int]) -> None:
    """Recompute only the tree paths above the ``changed`` leaf indices
    (level 0 must already hold the new leaves)."""
    for depth in range(len(levels) - 1):
        lvl, up = levels[depth], levels[depth + 1]
        parents = {i // 2 for i in changed}
        for pi in sorted(parents):
            i = 2 * pi
            up[pi] = sha256d(
                lvl[i] + (lvl[i + 1] if i + 1 < len(lvl) else lvl[i])
            )
        changed = parents


def build_records_incremental(
    prev: IncrementalState | None,
    height: int,
    block: Block,
    balances: dict[str, int],
    nonces: dict[str, int],
    dirty: set[str],
    chunk_accounts: int = CHUNK_ACCOUNTS,
) -> tuple[bytes, list[bytes], IncrementalState, int]:
    """``build_records``, continuously: re-encode and re-hash ONLY the
    accounts in ``dirty`` (plus any the previous build never saw),
    reuse untouched chunk payloads and digests outright, and return
    the new reusable state alongside ``(manifest_payload, chunks)``
    plus the count of chunks reused verbatim.

    **Byte-identity contract** (pinned in tests): the manifest and
    chunk payloads are byte-for-byte what ``build_records`` produces
    for the same state — incremental is a cost model, never a format.

    **Correctness contract on ``dirty``**: it must be a superset of
    every account whose (balance, nonce) differs from the state
    ``prev`` was built over — the chain guarantees this by recording
    touched accounts on BOTH apply and undo, so reorgs and tip
    advances alike land in the set.  A too-big set only costs reuse.

    Cost: O(delta·log accounts) on the steady-state path — the key set
    is stable (no account created or emptied), so entry encodes, leaf
    hashes, chunk joins, and the merkle path updates are all bounded by
    the delta, and the O(accounts) work left is pointer copies of the
    cached dicts/levels.  A membership change (create/delete shifts the
    canonical order) degrades that build to the O(accounts) re-sort and
    tree rebuild, exactly like the chunk-reuse gate below.
    """
    # Steady-state fast path: by the dirty-superset contract, the key
    # set can only change at accounts the dirty set names — if each of
    # those keeps its membership (existed before and still has state,
    # or neither), the canonical order is prev's, verbatim.
    if (
        prev is not None
        and prev.levels
        and prev.chunk_accounts == chunk_accounts
        and all(
            (a in prev.entries)
            == bool(balances.get(a, 0) or nonces.get(a, 0))
            for a in dirty
        )
    ):
        keys = prev.keys
        entries = dict(prev.entries)
        leaves = dict(prev.leaves)
        levels = [lvl.copy() for lvl in prev.levels]
        changed: set[int] = set()
        for a in dirty:
            if a not in entries:
                continue  # touched but stateless before and after
            e = _encode_entry(a, balances.get(a, 0), nonces.get(a, 0))
            if entries[a] == e:
                continue  # dirty is a superset; this one didn't move
            entries[a] = e
            leaves[a] = sha256d(e)
            pos = prev.index[a]
            levels[0][pos] = leaves[a]
            changed.add(pos)
        if changed:
            _merkle_update(levels, changed)
        chunks = list(prev.chunks)
        digests = list(prev.digests)
        dirty_chunks = sorted({pos // chunk_accounts for pos in sorted(changed)})
        for ci in dirty_chunks:
            i = ci * chunk_accounts
            part_keys = keys[i : i + chunk_accounts]
            payload = _U32.pack(len(part_keys)) + b"".join(
                entries[a] for a in part_keys
            )
            chunks[ci] = payload
            digests[ci] = chunk_digest(payload)
        reused = len(chunks) - len(dirty_chunks)
        manifest = Manifest(
            height=height,
            block_hash=block.block_hash(),
            state_root=levels[-1][0] if keys else merkle_root([]),
            accounts=len(keys),
            chunk_digests=tuple(digests),
            block=block,
        )
        state = IncrementalState(
            entries=entries,
            leaves=leaves,
            keys=keys,
            chunks=chunks,
            digests=digests,
            chunk_accounts=chunk_accounts,
            levels=levels,
            index=prev.index,
        )
        return encode_manifest(manifest), chunks, state, reused

    accounts = {a for a, v in balances.items() if v}
    accounts.update(a for a, n in nonces.items() if n)
    keys = sorted(accounts, key=lambda a: a.encode("utf-8"))
    reuse_entries = prev is not None
    entries: dict[str, bytes] = {}
    leaves: dict[str, bytes] = {}
    for a in keys:
        if reuse_entries and a not in dirty and a in prev.entries:
            entries[a] = prev.entries[a]
            leaves[a] = prev.leaves[a]
        else:
            e = _encode_entry(a, balances.get(a, 0), nonces.get(a, 0))
            entries[a] = e
            leaves[a] = sha256d(e)
    chunks: list[bytes] = []
    digests: list[bytes] = []
    reused = 0
    reuse_chunks = prev is not None and prev.chunk_accounts == chunk_accounts
    for ci, i in enumerate(range(0, len(keys), chunk_accounts)):
        part_keys = keys[i : i + chunk_accounts]
        if (
            reuse_chunks
            and ci < len(prev.chunks)
            and prev.keys[i : i + chunk_accounts] == part_keys
            and not any(a in dirty for a in part_keys)
        ):
            chunks.append(prev.chunks[ci])
            digests.append(prev.digests[ci])
            reused += 1
            continue
        payload = _U32.pack(len(part_keys)) + b"".join(
            entries[a] for a in part_keys
        )
        chunks.append(payload)
        digests.append(chunk_digest(payload))
    levels = _merkle_levels([leaves[a] for a in keys]) if keys else []
    manifest = Manifest(
        height=height,
        block_hash=block.block_hash(),
        state_root=levels[-1][0] if keys else merkle_root([]),
        accounts=len(keys),
        chunk_digests=tuple(digests),
        block=block,
    )
    state = IncrementalState(
        entries=entries,
        leaves=leaves,
        keys=keys,
        chunks=chunks,
        digests=digests,
        chunk_accounts=chunk_accounts,
        levels=levels,
        index={a: i for i, a in enumerate(keys)},
    )
    return encode_manifest(manifest), chunks, state, reused


# -- the file format -------------------------------------------------------


def _frame(payload: bytes) -> bytes:
    prefix = _LEN.pack(len(payload))
    return prefix + payload + _CRC.pack(zlib.crc32(payload, zlib.crc32(prefix)))


def write_snapshot(path, manifest_payload: bytes, chunk_payloads: list[bytes]) -> None:
    """Atomic snapshot file write: tmp + fsync + rename + directory
    fsync (the chain store's durability discipline — a half-written
    snapshot must never exist under the real name)."""
    import os

    from p1_tpu_torch.chain.store import fsync_dir

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as fh:
        fh.write(MAGIC)
        fh.write(_frame(manifest_payload))
        for chunk in chunk_payloads:
            fh.write(_frame(chunk))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)


def _scan_records(data: bytes) -> tuple[list[bytes], list[str]]:
    """(payloads, issues) from a snapshot file's raw bytes.  Framing
    damage is reported, never trusted: a record that fails its CRC ends
    the scan (everything behind it is unreachable — unlike the chain
    store, snapshot records have no independent value worth resyncing
    for: an incomplete chunk set is unusable anyway)."""
    issues: list[str] = []
    if not data.startswith(MAGIC):
        raise SnapshotError("not a snapshot file")
    payloads: list[bytes] = []
    off = len(MAGIC)
    while off < len(data):
        if off + _LEN.size + _CRC.size > len(data):
            issues.append(f"torn tail at {off}")
            break
        (n,) = _LEN.unpack_from(data, off)
        if n > MAX_RECORD:
            issues.append(f"oversized record length at {off}")
            break
        end = off + _LEN.size + n + _CRC.size
        if end > len(data):
            issues.append(f"torn record at {off}")
            break
        body_end = end - _CRC.size
        if zlib.crc32(data[off:body_end]) != _CRC.unpack_from(data, body_end)[0]:
            issues.append(f"checksum mismatch at {off}")
            break
        payloads.append(data[off + _LEN.size : body_end])
        off = end
    return payloads, issues


def read_records(path) -> tuple[bytes, list[bytes], list[str]]:
    """(manifest payload, chunk payloads, framing issues) from a
    snapshot file.  Raises ``SnapshotError`` when no manifest record is
    readable at all."""
    data = Path(path).read_bytes()
    payloads, issues = _scan_records(data)
    if not payloads:
        raise SnapshotError(f"{path}: no readable snapshot records")
    return payloads[0], payloads[1:], issues


def load_snapshot(path) -> LedgerSnapshot:
    """Read + fully verify a snapshot file (manifest parse, chunk
    digests, state root).  The boot path: everything a node needs to
    enter ASSUMED mode, or a ``SnapshotError`` explaining why not."""
    manifest_payload, chunk_payloads, _issues = read_records(path)
    manifest = parse_manifest(manifest_payload)
    # Extra records past the manifest's chunk count are tolerated as
    # framing noise only when the needed set is complete and verifies.
    return assemble(manifest, chunk_payloads[: len(manifest.chunk_digests)])


def verify_file(path) -> dict:
    """The `p1 snapshot verify` engine: a JSON-ready report plus the
    documented exit verdict — 0 clean, 1 salvageable issue (framing
    noise past a complete, root-verified snapshot), 2 unrecoverable
    (unreadable manifest, missing/corrupt chunks, digest or root
    mismatch)."""
    path = Path(path)
    report: dict = {"snapshot": str(path)}
    if not path.exists():
        report.update(status="missing", verdict=2)
        return report
    try:
        manifest_payload, chunk_payloads, issues = read_records(path)
        manifest = parse_manifest(manifest_payload)
    except SnapshotError as e:
        report.update(status="unrecoverable", error=str(e), verdict=2)
        return report
    report.update(
        height=manifest.height,
        block_hash=manifest.block_hash.hex(),
        state_root=manifest.state_root.hex(),
        accounts=manifest.accounts,
        chunks=len(manifest.chunk_digests),
        chunks_present=len(chunk_payloads),
        issues=issues,
    )
    if len(chunk_payloads) > len(manifest.chunk_digests):
        issues.append(
            f"{len(chunk_payloads) - len(manifest.chunk_digests)} extra "
            "records past the manifest's chunk count"
        )
    try:
        assemble(manifest, chunk_payloads[: len(manifest.chunk_digests)])
    except SnapshotError as e:
        report.update(status="unrecoverable", error=str(e), verdict=2)
        return report
    if issues:
        # The needed record set is complete and verifies end to end;
        # the damage is confined to bytes past it — rewriting the file
        # from the verified records recovers a clean snapshot.
        report.update(status="salvageable", verdict=1)
    else:
        report.update(status="clean", verdict=0)
    return report
