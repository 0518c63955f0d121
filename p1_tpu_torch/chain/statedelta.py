"""Per-segment ledger-state deltas: the ``.sdx`` sidecar plane.

Round 20 (the always-on node), leg (b) of the zero-downtime operations
plane: when a segment seals (chain/segstore.py ``_roll``), the net
ledger effect of every record inside it — per-account balance shifts
and nonce increments, in canonical account order — is written to a
``segNNNNN.sdx`` sidecar next to the segment, with the same durability
framing as everything else in the store family (magic + CRC-framed
JSON, tmp + rename + dir-fsync).

The port's copy of ``p1_tpu/chain/statedelta.py``: the same ``.sdx``
bytes.

What that buys:

- **Incremental state derivation.**  The ledger state at a segment
  boundary is the previous boundary's state plus one delta — O(delta)
  accounts touched, never O(accounts) — so continuous snapshot
  publication (chain/snapshot.py ``build_records_incremental``) and
  offline state audits can advance checkpoint state without replaying
  a single block body.
- **Prune survival.**  Like the ``.hdrx`` header sidecar, the delta
  outlives its segment's bodies: a pruned archive still knows *what
  the discarded records did to the state*, which is exactly the part a
  boot snapshot needs to extend.

Trust + failure model, identical to the header plane: the sidecar is
**derivable cache**, never the only copy — the segment's records are
the data, and a failed or missing sidecar costs a rebuild
(``write_segment_delta`` over the segment bytes), never data.  The
store tolerates sidecar write failures (``healed["sdx_failures"]``)
exactly as it tolerates ``hdrx_failures``.

Determinism: the delta is a pure function of the segment bytes —
accounts serialize sorted by utf-8 key, JSON with sorted keys, no
floats — so two nodes sealing byte-identical segments write
byte-identical sidecars (pinned in tests/test_maintenance.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from pathlib import Path

# NOTE: chain.store is imported lazily inside the functions that scan
# segment bytes — chain/chain.py imports ``block_accounts`` from here,
# and chain/store.py imports chain/chain.py, so a module-level store
# import would close an import cycle.
from p1_tpu_torch.core.block import Block

__all__ = [
    "SDX_MAGIC",
    "SegmentDelta",
    "block_accounts",
    "load_segment_delta",
    "segment_delta",
    "write_segment_delta",
]

#: Sidecar format tag, versioned like every other on-disk magic here.
SDX_MAGIC = b"P1TPUSD1"

_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")


def block_accounts(block: Block) -> set[str]:
    """Every account whose balance or nonce ``block`` touches — the
    coinbase recipient plus each transfer's sender and recipient.  The
    chain's dirty-account tracking (incremental snapshot creation) and
    the segment delta below share this one definition."""
    accounts: set[str] = set()
    for i, tx in enumerate(block.txs):
        if i == 0 and tx.is_coinbase:
            accounts.add(tx.recipient)
            continue
        accounts.add(tx.sender)
        accounts.add(tx.recipient)
    return accounts


@dataclasses.dataclass(frozen=True)
class SegmentDelta:
    """The net ledger effect of one segment's records.

    ``balances``/``nonces`` map account → signed shift (nonces only
    ever shift up within one segment, but the type stays signed so the
    arithmetic composes).  ``records`` counts the blocks summed;
    ``first_hash``/``last_hash`` pin which records, so a delta can be
    cross-checked against the segment it claims to describe."""

    records: int
    balances: dict[str, int]
    nonces: dict[str, int]
    first_hash: bytes | None
    last_hash: bytes | None

    def apply(
        self, balances: dict[str, int], nonces: dict[str, int]
    ) -> tuple[dict[str, int], dict[str, int]]:
        """State after this delta, from copies (inputs untouched).
        Zero entries drop on the way out — the same invariant the live
        ``Ledger`` keeps, so derived state compares clean against it."""
        out_b = dict(balances)
        out_n = dict(nonces)
        for account, d in self.balances.items():
            v = out_b.get(account, 0) + d
            if v:
                out_b[account] = v
            else:
                out_b.pop(account, None)
        for account, d in self.nonces.items():
            v = out_n.get(account, 0) + d
            if v:
                out_n[account] = v
            else:
                out_n.pop(account, None)
        return out_b, out_n


def segment_delta(segment_data: bytes) -> SegmentDelta:
    """Sum the ledger effect of every record in a segment's raw bytes.

    Frames are walked with the store's own scanner (torn tails and bad
    spans are simply not part of the sum — the sidecar describes what
    the segment durably holds).  The per-block delta rule is the
    ledger's (``Ledger._block_delta`` with ``check=False``): this
    module must never invent a second definition of what a block does
    to the state."""
    from p1_tpu_torch.chain.ledger import Ledger
    from p1_tpu_torch.chain.store import ChainStore

    ledger = Ledger()
    balances: dict[str, int] = {}
    nonces: dict[str, int] = {}
    records = 0
    first_hash: bytes | None = None
    last_hash: bytes | None = None
    for off, n in ChainStore.scan(segment_data).spans:
        block = Block.deserialize(segment_data[off : off + n])
        delta = ledger._block_delta(block, check=False)
        for account, d in delta.balances.items():
            balances[account] = balances.get(account, 0) + d
        for account, d in delta.nonces.items():
            nonces[account] = nonces.get(account, 0) + d
        bhash = block.block_hash()
        if first_hash is None:
            first_hash = bhash
        last_hash = bhash
        records += 1
    return SegmentDelta(
        records=records,
        balances={a: d for a, d in balances.items() if d},
        nonces={a: d for a, d in nonces.items() if d},
        first_hash=first_hash,
        last_hash=last_hash,
    )


def _encode(delta: SegmentDelta) -> bytes:
    payload = json.dumps(
        {
            "version": 1,
            "records": delta.records,
            "balances": delta.balances,
            "nonces": delta.nonces,
            "first_hash": delta.first_hash.hex() if delta.first_hash else None,
            "last_hash": delta.last_hash.hex() if delta.last_hash else None,
        },
        sort_keys=True,
        separators=(",", ":"),
    ).encode("utf-8")
    body = _LEN.pack(len(payload)) + payload
    return SDX_MAGIC + body + _CRC.pack(zlib.crc32(body))


def write_segment_delta(segment_data: bytes, out_path) -> SegmentDelta:
    """Derive + durably write the sidecar for a segment's bytes (tmp +
    fsync + rename + dir-fsync — the store family's discipline; a crash
    leaves either the old sidecar or the new one, both derivable).
    Returns the delta it wrote."""
    from p1_tpu_torch.chain.store import fsync_dir

    delta = segment_delta(segment_data)
    out_path = Path(out_path)
    tmp = out_path.with_name(f"{out_path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as fh:
        fh.write(_encode(delta))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, out_path)
    fsync_dir(out_path.parent)
    return delta


def load_segment_delta(path) -> SegmentDelta | None:
    """Parse a sidecar file; None when missing/corrupt — like the
    manifest and the header plane, a bad sidecar is a cache miss (the
    caller rebuilds from the segment), never an error to propagate."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    if not data.startswith(SDX_MAGIC):
        return None
    off = len(SDX_MAGIC)
    if off + _LEN.size + _CRC.size > len(data):
        return None
    (n,) = _LEN.unpack_from(data, off)
    end = off + _LEN.size + n
    if end + _CRC.size > len(data):
        return None
    body = data[off:end]
    if zlib.crc32(body) != _CRC.unpack_from(data, end)[0]:
        return None
    try:
        d = json.loads(data[off + _LEN.size : end].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None
    if not isinstance(d, dict) or d.get("version") != 1:
        return None
    try:
        return SegmentDelta(
            records=int(d["records"]),
            balances={a: int(v) for a, v in d["balances"].items()},
            nonces={a: int(v) for a, v in d["nonces"].items()},
            first_hash=bytes.fromhex(d["first_hash"]) if d["first_hash"] else None,
            last_hash=bytes.fromhex(d["last_hash"]) if d["last_hash"] else None,
        )
    except (KeyError, TypeError, ValueError, AttributeError):
        return None
