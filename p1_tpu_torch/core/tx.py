"""Minimal transaction type with deterministic serialization + ownership.

The port's copy of ``p1_tpu/core/tx.py``: the same fields, the same bytes
(``serialize``/``deserialize`` round-trip with the JAX package's encoding,
so txids agree), the same ownership check.

Capability parity: the reference has a mempool of pending transactions feeding
block assembly (BASELINE.json:5).  The exact reference tx format is unknown
(reference checkout unavailable — SURVEY.md §0), so this is a deliberately
simple account-model transfer: sender/recipient ids, amount, fee, and a
sender-sequence number for uniqueness.  Deterministic big-endian serialization
with length-prefixed ids; txid = SHA-256d of the serialization.

Ownership (round 4): a non-coinbase transaction carries the sender's Ed25519
public key and a signature over ``signing_bytes()`` — the five core fields
PLUS the ``chain`` tag (the target chain's genesis hash), so a signature
authorizes one spend on one chain: without the tag, a spend observed on a
difficulty-16 chain could be replayed byte-identically against the same
account's funds on a difficulty-20 chain.  Consensus
(chain/validate.py) checks the tag against the chain's genesis and
the mempool against its configured chain, and both require
``verify_signature()`` — the sender id must be the key's fingerprint
(core/keys.py) and the signature must check out, so only the key
holder can spend from a fingerprint account.  Coinbases stay unsigned (they
are minted by consensus per chain, not spent by an owner) and MUST carry
empty pubkey/sig/chain.  The txid commits to the signature too (like a
pre-segwit Bitcoin txid commits to scriptSig); Ed25519 signing is
deterministic, so an honest signer produces one txid per transaction.

Canonical-encoding cache: like ``BlockHeader``, the frozen instance
memoizes ``serialize()``, ``signing_bytes()`` and ``txid()`` via
``object.__setattr__`` (non-field slots — equality, hashing, and
``dataclasses.replace`` ignore them, so ``transfer()``'s replace-with-sig
starts clean), and ``deserialize``/``deserialize_prefix`` seed the cache
with the exact wire bytes.  The layout round-trips byte-identically
(length-prefixed fields, fixed-width integers — tested), so a transaction
is packed at most once per process no matter how many times gossip,
block assembly, persistence, and relay re-serialize it.
"""

from __future__ import annotations

import dataclasses
import struct

from p1_tpu_torch.core import keys as _keys
from p1_tpu_torch.core import sigcache as _sigcache

_MAX_ID_LEN = 255
_NUMS = struct.Struct(">QQQ")

#: Reserved sender id marking a block-reward (coinbase) transaction.  A
#: coinbase is what gives each miner's candidate block a distinct identity:
#: recipient = the miner's id, seq = the block height, so two miners working
#: on the same tip produce different merkle roots and therefore different
#: headers — concurrent mining yields genuinely competing blocks instead of
#: every node re-deriving the identical one.
COINBASE_SENDER = "coinbase"
BLOCK_REWARD = 50


@dataclasses.dataclass(frozen=True)
class Transaction:
    sender: str
    recipient: str
    amount: int
    fee: int
    seq: int  # per-sender sequence number (uniqueness / replay protection)
    pubkey: bytes = b""  # sender's Ed25519 public key (empty for coinbase)
    sig: bytes = b""  # Ed25519 signature over signing_bytes()
    chain: bytes = b""  # target chain's genesis hash (empty for coinbase)

    def __post_init__(self) -> None:
        for name in ("sender", "recipient"):
            raw = getattr(self, name).encode("utf-8")
            if not 0 < len(raw) <= _MAX_ID_LEN:
                raise ValueError(f"{name} must encode to 1..{_MAX_ID_LEN} bytes")
        for name in ("amount", "fee", "seq"):
            v = getattr(self, name)
            if not 0 <= v <= 0xFFFFFFFFFFFFFFFF:
                raise ValueError(f"{name}={v} out of uint64 range")
        for name in ("pubkey", "sig", "chain"):
            if len(getattr(self, name)) > _MAX_ID_LEN:
                raise ValueError(f"{name} exceeds {_MAX_ID_LEN} bytes")

    def signing_bytes(self) -> bytes:
        """What the sender signs: the five core fields plus the chain tag
        (everything except the proof itself) — signatures are chain-bound."""
        raw = self.__dict__.get("_signing")
        if raw is None:
            s = self.sender.encode("utf-8")
            r = self.recipient.encode("utf-8")
            raw = b"".join(
                (
                    struct.pack(">B", len(s)),
                    s,
                    struct.pack(">B", len(r)),
                    r,
                    struct.pack(">QQQ", self.amount, self.fee, self.seq),
                    struct.pack(">B", len(self.chain)),
                    self.chain,
                )
            )
            object.__setattr__(self, "_signing", raw)
        return raw

    def serialize(self) -> bytes:
        raw = self.__dict__.get("_raw")
        if raw is None:
            raw = b"".join(
                (
                    self.signing_bytes(),
                    struct.pack(">B", len(self.pubkey)),
                    self.pubkey,
                    struct.pack(">B", len(self.sig)),
                    self.sig,
                )
            )
            object.__setattr__(self, "_raw", raw)
        return raw

    @classmethod
    def deserialize(cls, data: bytes) -> "Transaction":
        tx, rest = cls.deserialize_prefix(data)
        if rest:
            raise ValueError(f"{len(rest)} trailing bytes after transaction")
        return tx

    @classmethod
    def deserialize_prefix(cls, data: bytes) -> tuple["Transaction", bytes]:
        """Parse one transaction off the front of ``data``; return (tx, rest).

        Offset-walking hot path that builds the instance directly: the
        wire format structurally guarantees every ``__post_init__``
        constraint (one-byte length prefixes cap the variable fields at
        255, ``>QQQ`` caps the integers at uint64, utf-8 decode/encode
        round-trips byte-identically) except non-empty ids, which are
        checked explicitly — so gossip ingest never re-validates what
        the framing already proves.
        """
        buf = bytes(data)
        total = len(buf)
        off = 0
        try:
            n = buf[off]
            s = buf[off + 1 : off + 1 + n]
            off += 1 + n
            n = buf[off]
            r = buf[off + 1 : off + 1 + n]
            off += 1 + n
            amount, fee, seq = _NUMS.unpack_from(buf, off)
            off += 24
            n = buf[off]
            chain = buf[off + 1 : off + 1 + n]
            off += 1 + n
            signing_end = off
            n = buf[off]
            pubkey = buf[off + 1 : off + 1 + n]
            off += 1 + n
            n = buf[off]
            sig = buf[off + 1 : off + 1 + n]
            off += 1 + n
        except (IndexError, struct.error):
            raise ValueError("truncated transaction") from None
        if off > total:
            # A short final slice advances ``off`` past the end without
            # tripping the index probes above.
            raise ValueError("truncated transaction")
        if not s:
            raise ValueError("sender must encode to 1..255 bytes")
        if not r:
            raise ValueError("recipient must encode to 1..255 bytes")
        tx = object.__new__(cls)
        tx.__dict__.update(
            sender=s.decode("utf-8"),
            recipient=r.decode("utf-8"),
            amount=amount,
            fee=fee,
            seq=seq,
            pubkey=pubkey,
            sig=sig,
            chain=chain,
            # Seed the encoding caches with exactly the bytes consumed:
            # the layout round-trips byte-identically, so they ARE
            # canonical — and ``signing_bytes`` is by construction the
            # wire prefix through the chain tag, so signature checks on
            # ingested transactions never re-pack either.
            _raw=buf[:off] if off < total else buf,
            _signing=buf[:signing_end],
        )
        return tx, buf[off:]

    def txid(self) -> bytes:
        digest = self.__dict__.get("_txid")
        if digest is None:
            from p1_tpu_torch.core.hashutil import sha256d

            digest = sha256d(self.serialize())
            object.__setattr__(self, "_txid", digest)
        return digest

    @property
    def is_coinbase(self) -> bool:
        return self.sender == COINBASE_SENDER

    def verify_signature(self, cache=None) -> bool:
        """True iff this transaction proves ownership of its sender account.

        Coinbase: must be bare (no pubkey/sig/chain) — minted, not spent.
        Transfer: sender id must be the carried pubkey's fingerprint and the
        signature must verify over ``signing_bytes()`` (which commits to the
        ``chain`` tag — whether the tag names the RIGHT chain is the
        caller's contextual check).  Memoized through the verify-once
        signature cache (core/sigcache.py — ``cache`` names one
        explicitly, None uses the process default) so gossip admission +
        block validation + resurrection re-checks are O(1) after the
        first; the txid key commits to every byte the check depends on.
        """
        if self.is_coinbase:
            return not self.pubkey and not self.sig and not self.chain
        if self.sender != _keys.account_id_or_none(self.pubkey):
            return False
        if cache is None:
            cache = _sigcache.DEFAULT
        txid = self.txid()
        if cache.hit(txid, self.pubkey, self.sig):
            return True
        if not _keys.verify(self.pubkey, self.sig, self.signing_bytes()):
            return False
        cache.add(txid, self.pubkey, self.sig)
        return True

    @classmethod
    def transfer(
        cls,
        key: "_keys.Keypair",
        recipient: str,
        amount: int,
        fee: int,
        seq: int,
        chain: bytes = b"",
    ) -> "Transaction":
        """Build and sign a spend from ``key``'s account, bound to the
        chain whose genesis hash is ``chain`` (consensus rejects transfers
        whose tag names a different chain)."""
        unsigned = cls(key.account, recipient, amount, fee, seq, chain=chain)
        sig = key.sign(unsigned.signing_bytes())
        return dataclasses.replace(unsigned, pubkey=key.pubkey, sig=sig)

    @classmethod
    def coinbase(
        cls, miner_id: str, height: int, reward: int = BLOCK_REWARD
    ) -> "Transaction":
        """The block-reward transaction for ``miner_id`` at ``height``.

        seq = height makes the coinbase (and with it the merkle root) unique
        per height even for the same miner; miner_id distinguishes miners.
        """
        return cls(COINBASE_SENDER, miner_id, reward, 0, height)
