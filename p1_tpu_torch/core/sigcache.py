"""Verify-once signature cache: the tx-level Ed25519 memo (round 8).

The port's copy of ``p1_tpu/core/sigcache.py``, as it is.

Bitcoin Core's sigcache exists because a node verifies most signatures
TWICE on the happy path — once at mempool admission, once when the block
carrying the transaction connects.  Same here: relay validation, block
connect, reorg resurrection, and compact-block reconstruction all re-ask
the same question.  This cache answers it once per process:

- **Keyed by (txid, pubkey, sig)** — the txid already commits to the
  exact pubkey/sig/message bytes (SHA-256d over the full serialization),
  so a hit IS the transaction whose ownership proof was checked; pubkey
  and sig are folded in anyway so the key stands on collision resistance
  twice over.  Keys are 16-byte digests **salted per process**
  (``os.urandom``): an attacker who can predict cache keys could try to
  engineer digest collisions offline; with a salt the keyspace is fresh
  every boot (the same reason Bitcoin salts its sigcache).
- **Successes only.**  A negative result is never cached: failure is the
  rare hostile case, re-verifying it costs the attacker more than us,
  and a poisoned negative entry could censor a valid transaction.
- **Bounded LRU**, and the node charges ``bytes_used`` to the overload
  memory gauge (node/governor.py) so SHED accounting stays honest.

Single-threaded by design: consult/populate happens on the node's event
loop (admission, block connect); the batch-verification worker threads
never touch the cache — they hand results back to the loop thread, which
populates it.
"""

from __future__ import annotations

import collections
import hashlib
import os

#: Default capacity.  At ~120 bytes of accounted cost per entry this is
#: a ~7.9 MB ceiling — two orders of magnitude below the body-cache
#: terms the memory gauge tracks, but charged all the same.
DEFAULT_MAX_ENTRIES = 65_536

#: Accounted bytes per entry: 16-byte digest + bytes-object and
#: OrderedDict slot overhead, rounded up.  An estimate (CPython doesn't
#: expose exact dict internals), kept deliberately pessimistic so the
#: gauge never under-charges.
ENTRY_COST = 120


class SignatureCache:
    """Bounded, salted, verify-once cache for transaction signatures."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.max_entries = int(max_entries)
        self._salt = os.urandom(16)
        self._entries: collections.OrderedDict[bytes, None] = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0

    def _key(self, txid: bytes, pubkey: bytes, sig: bytes) -> bytes:
        h = hashlib.sha256(self._salt)
        h.update(txid)
        h.update(pubkey)
        h.update(sig)
        return h.digest()[:16]

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        """What this cache charges the node's accounted memory gauge."""
        return len(self._entries) * ENTRY_COST

    def hit(self, txid: bytes, pubkey: bytes, sig: bytes) -> bool:
        """True iff this exact signature was proven valid earlier this
        process (LRU-refreshes the entry); counts a miss otherwise."""
        key = self._key(txid, pubkey, sig)
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def add(self, txid: bytes, pubkey: bytes, sig: bytes) -> None:
        """Record a PROVEN-VALID signature (callers only ever add after
        a successful backend verify or batch membership)."""
        key = self._key(txid, pubkey, sig)
        self._entries[key] = None
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def snapshot(self) -> dict:
        """The ``status()["validation"]`` cache block."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "entries": len(self._entries),
            "bytes": self.bytes_used,
        }


#: Process-default cache: what ``Transaction.verify_signature`` uses
#: when no explicit cache is wired in (standalone tools, light clients,
#: tests building bare Chains).  A Node owns its OWN instance so its
#: hit/miss telemetry isn't polluted by co-resident nodes in one
#: process (multi-node tests, `p1 net`).
DEFAULT = SignatureCache()
