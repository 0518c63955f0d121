"""Fleet provisioning: snapshot-cold-started replicas (`p1 serve
--bootstrap`) and the upstream pull loop that keeps them current.

The north star needs read capacity to be ELASTIC: the push plane
proved one replica carries 100k live wallet sessions, but adding a
second replica still meant a full IBD (or out-of-band store copies).
This module closes that gap with the two Bitcoin-lineage designs the
repo already trusts end to end:

- **assumeUTXO-analog snapshots**: ``bootstrap_store`` pulls
  a state snapshot over the supervised GETSNAPSHOT path, verifying the
  manifest and every chunk digest AS THEY ARRIVE (client.get_snapshot),
  and pins the snapshot's anchor block to a PoW-verified header
  skeleton fetched first — a snapshot server lying about height, root,
  or content is DEMOTED exactly as in snapshot sync and the next peer is tried.
- **BIP157-analog commitment chains**: the filter headers for
  the adopted window [0..base] are fetched from the peer and, when a
  second bootstrap peer is available, cross-checked and adjudicated via
  the hash-pinned block at the first divergence (client._adjudicate) —
  the same machinery a watching wallet uses, applied at provision time.

What lands on disk next to the store:

- ``<store>.snapshot`` — the CRC-framed snapshot file (chain/snapshot).
- ``<store>.bootbase`` — this module's sidecar: the base height, the
  PoW-verified headers 1..base, and the adopted filter headers 0..base,
  digest-trailed and written atomically (tmp + rename).  ReplicaView
  (node/queryplane.py) reads it at attach and seeds heights 1..base as
  ADOPTED entries: headers served, bodies/filters refused honestly —
  the same contract as a pruned archive.
- the chain store itself — bodies for (base..tip] fetched by locator
  rounds, each pinned to the verified skeleton by hash and checked
  against its merkle commitment before the append.

Crash model: every stage is resumable.  The sidecars are atomic
(rename) so a crash leaves either nothing or a whole file; a torn or
absent ``.bootbase`` restarts the snapshot stages cleanly, an intact
one skips straight to the body fill, and the body fill itself resumes
from whatever the store already holds (the locator does the dedup).

``UpstreamSync`` is the serving-time half: a supervised locator-pull
loop against the upstream peers that appends new PoW-checked blocks to
the replica's own store (this process is the store's writer — the
ReplicaView refresh loop picks them up and the push plane notifies).
Appends run off-loop (``asyncio.to_thread``): a replica mid-push must
not stall its sessions on an fsync.

The port's copy of ``p1_tpu/node/provision.py``: the bootstrap checks
its header skeleton with ``chain/replay.replay_fast`` on the host, as the
reference does.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import struct
from pathlib import Path

from p1_tpu_torch.core.genesis import make_genesis
from p1_tpu_torch.core.header import HEADER_SIZE, meets_target
from p1_tpu_torch.node import protocol
from p1_tpu_torch.node.protocol import MsgType

__all__ = [
    "BootstrapError",
    "UpstreamSync",
    "bootstrap_store",
    "read_bootbase",
    "write_bootbase",
]

#: Bootbase sidecar format tag (bump on layout change).
BOOTBASE_MAGIC = b"P1TPUBB1"

#: Network failure shapes that mean "rotate peers", never "peer lies".
NET_ERRORS = (
    ConnectionError,
    OSError,
    asyncio.IncompleteReadError,
    asyncio.TimeoutError,
    TimeoutError,
)


class BootstrapError(ValueError):
    """Cold-start provisioning failed for every offered peer — the
    caller gets the full story (who was tried, who was demoted, why)
    in one message instead of the last peer's symptom."""


# -- the .bootbase sidecar -------------------------------------------------


def _bootbase_path(store_path) -> Path:
    p = Path(store_path)
    return p.with_name(p.name + ".bootbase")


def write_bootbase(store_path, headers: list[bytes], fheaders: list[bytes]) -> Path:
    """Atomically write the adopted-prefix sidecar: ``headers`` are the
    80-byte serialized headers for heights 1..base (genesis excluded —
    it is local knowledge), ``fheaders`` the 32-byte filter headers for
    heights 0..base.  Layout: magic, u32 base, headers, filter headers,
    and a sha256 digest over everything before it — a torn write can
    never parse."""
    base = len(headers)
    if len(fheaders) != base + 1:
        raise ValueError("bootbase needs filter headers for 0..base")
    payload = BOOTBASE_MAGIC + struct.pack(">I", base)
    payload += b"".join(headers) + b"".join(fheaders)
    payload += hashlib.sha256(payload).digest()
    path = _bootbase_path(store_path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_bootbase(store_path):
    """Parse the sidecar next to ``store_path``; returns ``(base,
    headers, fheaders)`` or None when absent/torn/corrupt (a bad
    sidecar restarts the bootstrap stages — it never half-loads)."""
    path = _bootbase_path(store_path)
    try:
        raw = path.read_bytes()
    except (FileNotFoundError, IsADirectoryError):
        return None
    if len(raw) < len(BOOTBASE_MAGIC) + 4 + 32:
        return None
    if raw[: len(BOOTBASE_MAGIC)] != BOOTBASE_MAGIC:
        return None
    if hashlib.sha256(raw[:-32]).digest() != raw[-32:]:
        return None
    (base,) = struct.unpack_from(">I", raw, len(BOOTBASE_MAGIC))
    off = len(BOOTBASE_MAGIC) + 4
    want = off + base * HEADER_SIZE + (base + 1) * 32 + 32
    if len(raw) != want:
        return None
    headers = [
        raw[off + i * HEADER_SIZE : off + (i + 1) * HEADER_SIZE]
        for i in range(base)
    ]
    off += base * HEADER_SIZE
    fheaders = [raw[off + i * 32 : off + (i + 1) * 32] for i in range(base + 1)]
    return base, headers, fheaders


# -- cold start ------------------------------------------------------------


async def _blocks_round(reader, writer, locator):
    from p1_tpu_torch.node.client import _read_msg

    await protocol.write_frame(writer, protocol.encode_getblocks(locator))
    while True:
        mtype, body = await _read_msg(reader, writer)
        if mtype is MsgType.BLOCKS:
            return body


async def bootstrap_store(
    store_path,
    peers,
    difficulty: int,
    *,
    retarget=None,
    stall_timeout_s: float = 15.0,
    snapshot_timeout_s: float = 120.0,
    progress=None,
) -> dict:
    """Cold-start a replica store at ``store_path`` from ``peers`` (a
    list of ``(host, port)``); returns a report dict with the measured
    stages (the PERF.md cold-start figure reads them).  Stages:

    1. PoW-verified header skeleton (supervised ``get_headers`` across
       all peers, then ``replay_fast`` + the genesis pin).
    2. Snapshot: manifest + chunk-verified payloads from the first peer
       that serves one, its anchor pinned to the skeleton — a server
       whose snapshot fails ANY check is demoted and the next is tried.
       No snapshot anywhere degrades to a full body fill from genesis
       (an IBD — slower, never wrong).
    3. Adopted filter headers [0..base], genesis anchor recomputed
       locally, cross-checked against a second peer when one is live
       (disagreement adjudicated via the hash-pinned block; the proven
       liar is demoted).  Then the ``.bootbase`` sidecar lands
       atomically.
    4. Body fill (base..skeleton tip] by locator rounds into the local
       ChainStore — each block hash-pinned to the skeleton and
       merkle-checked; resumes from whatever a previous (crashed) run
       already appended.

    A valid ``.bootbase`` from a previous run whose base hash still
    sits on the skeleton skips stages 2–3 (the crash-resume path)."""
    import time as _time

    from p1_tpu_torch.chain import snapshot as chain_snapshot
    from p1_tpu_torch.chain.chain import locator_hashes
    from p1_tpu_torch.chain.filters import (
        GENESIS_FILTER_HEADER,
        block_filter,
        filter_hash,
        next_filter_header,
    )
    from p1_tpu_torch.chain.replay import replay_fast
    from p1_tpu_torch.chain.store import ChainStore
    from p1_tpu_torch.node.client import (
        CommitmentViolation,
        _adjudicate,
        _session,
        get_filter_headers,
        get_headers,
        get_snapshot,
    )

    def _say(msg: str) -> None:
        if progress is not None:
            progress(msg)

    targets = [tuple(p) for p in peers]
    if not targets:
        raise BootstrapError("bootstrap needs at least one peer")
    demoted: list[tuple[tuple, str]] = []
    t0 = _time.perf_counter()
    report: dict = {"store": str(store_path), "peers": len(targets)}

    # -- 1. verified header skeleton --------------------------------------
    genesis = make_genesis(difficulty, retarget)
    _say("fetching header skeleton")
    headers = await get_headers(
        targets[0][0],
        targets[0][1],
        difficulty,
        timeout=max(60.0, stall_timeout_s * 8),
        retarget=retarget,
        stall_timeout_s=stall_timeout_s,
        fallback_peers=targets[1:],
    )
    if headers[0].block_hash() != genesis.block_hash():
        raise BootstrapError("header skeleton does not start at our genesis")
    rep = replay_fast(headers, retarget=retarget)
    if not rep.valid:
        raise BootstrapError(
            f"header skeleton fails verification at index {rep.first_invalid}"
        )
    hashes = [h.block_hash() for h in headers]
    tip = len(hashes) - 1
    report["skeleton_tip"] = tip
    report["headers_s"] = round(_time.perf_counter() - t0, 3)

    def _alive():
        down = {t for t, _ in demoted}
        return [t for t in targets if t not in down]

    def _demote(peer, why: str) -> None:
        demoted.append((tuple(peer), why))
        _say(f"demoted {peer[0]}:{peer[1]}: {why}")

    # -- 2+3. snapshot + adopted filter headers (or resume) ----------------
    base = 0
    fheaders: list[bytes] = []
    resumed = False
    bb = read_bootbase(store_path)
    if bb is not None:
        rbase, rheaders, rfheaders = bb
        from p1_tpu_torch.core.header import BlockHeader

        if rbase <= tip and (
            not rheaders
            or BlockHeader.deserialize(rheaders[-1]).block_hash()
            == hashes[rbase]
        ):
            base, fheaders, resumed = rbase, rfheaders, True
            _say(f"resuming from existing bootbase (base {base})")
        # A sidecar off the verified skeleton (the snapshot peer's
        # branch lost, or garbage): restart the snapshot stages.
    if not resumed:
        t_snap = _time.perf_counter()
        snap_path = Path(store_path).with_name(Path(store_path).name + ".snapshot")
        manifest = None
        for peer in list(_alive()):
            try:
                got = await get_snapshot(
                    *peer,
                    difficulty,
                    timeout=snapshot_timeout_s,
                    retarget=retarget,
                    out_path=snap_path,
                )
            except NET_ERRORS:
                continue  # unreachable: not evidence, try the next
            except ValueError as e:
                _demote(peer, f"snapshot failed verification: {e}")
                continue
            if got is None:
                continue  # serves no snapshot: honest, just unhelpful
            m_height, m_bhash = got.height, got.block_hash
            if m_height < 1 or m_height > tip or hashes[m_height] != m_bhash:
                _demote(peer, "snapshot anchor is not on the verified chain")
                continue
            manifest, snap_peer = got, peer
            break
        if manifest is not None:
            base = manifest.height
            _say(f"snapshot verified at height {base}")
            # Adopted filter headers [0..base] from the snapshot peer.
            try:
                fheaders = await get_filter_headers(
                    *snap_peer, 0, base + 1, difficulty, retarget=retarget
                )
            except NET_ERRORS as e:
                raise BootstrapError(
                    f"snapshot peer vanished serving filter headers: {e!r}"
                ) from e
            if len(fheaders) != base + 1:
                raise BootstrapError(
                    "snapshot peer refuses filter headers for its own window"
                )
            want0 = next_filter_header(
                filter_hash(block_filter(genesis)), GENESIS_FILTER_HEADER
            )
            if fheaders[0] != want0:
                _demote(snap_peer, "commits a wrong genesis filter header")
                raise BootstrapError(
                    f"{snap_peer[0]}:{snap_peer[1]} commits a wrong genesis"
                    " filter header"
                )
            # Cross-check the adopted tip against a second live peer —
            # the wallet-grade agreement test, applied at provision.
            for other in _alive():
                if other == snap_peer:
                    continue
                try:
                    theirs = await get_filter_headers(
                        *other, base, 1, difficulty, retarget=retarget
                    )
                except NET_ERRORS + (ValueError,):
                    continue
                if not theirs or theirs[0] == fheaders[base]:
                    break  # corroborated (or honestly short)
                try:
                    verdict = await _adjudicate(
                        fheaders, other, hashes, base,
                        difficulty, retarget, None,
                    )
                except NET_ERRORS + (ValueError,):
                    continue
                if verdict in ("other", "both"):
                    _demote(other, "filter-header chain disproven")
                if verdict in ("self", "both"):
                    _demote(snap_peer, "filter-header chain disproven")
                    raise CommitmentViolation(
                        f"{snap_peer[0]}:{snap_peer[1]} serves forged filter"
                        f" headers (proven vs {other[0]}:{other[1]})"
                    )
                break
            write_bootbase(
                store_path,
                [h.serialize() for h in headers[1 : base + 1]],
                fheaders,
            )
        else:
            _say("no peer serves a snapshot — falling back to a full fill")
        report["snapshot_s"] = round(_time.perf_counter() - t_snap, 3)
    report["base"] = base
    report["resumed"] = resumed

    # -- 4. body fill (base..tip] ------------------------------------------
    t_fill = _time.perf_counter()
    pos = {bh: i for i, bh in enumerate(hashes)}
    store = ChainStore(store_path, fsync=False)
    store.acquire()
    fetched = 0
    try:
        # Resume point: whatever the store (plus the adopted base)
        # already covers — a fresh ReplicaView indexes both.
        from p1_tpu_torch.node.queryplane import ReplicaView

        view = ReplicaView(store_path, difficulty, retarget)
        try:
            while view.tip_height < tip and _alive():
                peer = _alive()[0]
                try:
                    async with _session(
                        *peer,
                        difficulty,
                        retarget,
                        handshake_timeout=stall_timeout_s,
                    ) as (reader, writer, _):
                        stalled = False
                        while view.tip_height < tip:
                            locator = locator_hashes(list(view._main))
                            blocks = await asyncio.wait_for(
                                _blocks_round(reader, writer, locator),
                                stall_timeout_s,
                            )
                            new = 0
                            for block in blocks:
                                bhash = block.block_hash()
                                h = pos.get(bhash)
                                if h is None or h > tip:
                                    break  # off/past the skeleton: done
                                if view.hash_at(h) == bhash:
                                    continue  # already held
                                if block.header.prev_hash != hashes[h - 1]:
                                    raise ValueError(
                                        "block does not link to the skeleton"
                                    )
                                if not block.merkle_ok():
                                    raise ValueError(
                                        "block fails its merkle commitment"
                                    )
                                await asyncio.to_thread(
                                    store.append, block, h
                                )
                                new += 1
                                fetched += 1
                            if new:
                                await asyncio.to_thread(store.sync)
                                view.refresh()
                            else:
                                stalled = True
                                break
                        if stalled and view.tip_height < tip:
                            _demote(peer, "stopped serving bodies")
                except NET_ERRORS:
                    _demote(peer, "dead/stalled session during body fill")
                except ValueError as e:
                    _demote(peer, f"served bad blocks: {e}")
            if view.tip_height < tip:
                raise BootstrapError(
                    f"body fill stalled at height {view.tip_height}/{tip}; "
                    f"demoted: {[(f'{h}:{p}', why) for (h, p), why in demoted]}"
                )
        finally:
            view.close()
    finally:
        store.close()
    report["blocks_fetched"] = fetched
    report["fill_s"] = round(_time.perf_counter() - t_fill, 3)
    report["tip"] = tip
    report["demoted"] = [
        {"peer": f"{h}:{p}", "why": why} for (h, p), why in demoted
    ]
    report["cold_start_s"] = round(_time.perf_counter() - t0, 3)
    _say(
        f"cold start complete: base {base}, tip {tip}, "
        f"{fetched} bodies in {report['cold_start_s']}s"
    )
    return report


# -- serving-time upstream pull --------------------------------------------


class UpstreamSync:
    """Keeps a bootstrapped replica current: a supervised locator-pull
    loop against the upstream peers, appending new blocks to the
    replica's OWN store (this process is the writer; the ReplicaView
    refresh loop indexes the appends and the push plane notifies).

    Verification before every append: the block must link to a header
    the view already holds, carry the chain's proof of work (fixed
    difficulty pinned when ``retarget`` is None — the same self-attest
    scope as ``client.watch``), and pass its merkle commitment.  A peer
    violating any of those is demoted permanently; a dead or stalled
    one just rotates.  Appends and fsyncs run in a worker thread so a
    pull burst never stalls the serving loop mid-push."""

    def __init__(
        self,
        store,
        view,
        peers,
        difficulty: int,
        *,
        retarget=None,
        poll_interval_s: float = 1.0,
        stall_timeout_s: float = 15.0,
    ):
        self.store = store
        self.view = view
        self.targets = [tuple(p) for p in peers]
        self.difficulty = difficulty
        self.retarget = retarget
        self.poll_interval_s = poll_interval_s
        self.stall_timeout_s = stall_timeout_s
        self.demoted: set[tuple] = set()
        self.pulled = 0
        self.rounds = 0
        self.stalls = 0
        self._ti = 0
        self._task: asyncio.Task | None = None

    def _append_batch(self, blocks: list) -> None:
        for block, h in blocks:
            self.store.append(block, h)
        self.store.sync()

    async def poll_once(self) -> int:
        """One pull round against the current upstream; returns blocks
        appended.  Rotates to the next peer on failure."""
        from p1_tpu_torch.chain.chain import locator_hashes
        from p1_tpu_torch.node.client import _session

        live = [t for t in self.targets if t not in self.demoted]
        if not live:
            raise ConnectionError("all upstream peers demoted")
        peer = live[self._ti % len(live)]
        self.rounds += 1
        try:
            async with _session(
                *peer,
                self.difficulty,
                self.retarget,
                handshake_timeout=self.stall_timeout_s,
            ) as (reader, writer, _):
                total = 0
                while True:
                    self.view.refresh()
                    blocks = await asyncio.wait_for(
                        _blocks_round(
                            reader, writer, locator_hashes(list(self.view._main))
                        ),
                        self.stall_timeout_s,
                    )
                    batch: list = []
                    for block in blocks:
                        bhash = block.block_hash()
                        if bhash in self.view._entries:
                            continue
                        parent = self.view._entries.get(block.header.prev_hash)
                        if parent is None:
                            continue  # orphan: wait for its parent
                        if not meets_target(bhash, block.header.difficulty) or (
                            self.retarget is None
                            and block.header.difficulty != self.difficulty
                        ):
                            raise ValueError("block without the chain's PoW")
                        if not block.merkle_ok():
                            raise ValueError("block fails merkle commitment")
                        batch.append((block, parent.height + 1))
                    if not batch:
                        return total
                    await asyncio.to_thread(self._append_batch, batch)
                    self.view.refresh()
                    total += len(batch)
                    self.pulled += len(batch)
        except NET_ERRORS:
            self.stalls += 1
            self._ti += 1
            return 0
        except ValueError:
            self.demoted.add(peer)
            self._ti += 1
            return 0

    async def run(self) -> None:
        """The serve-time loop (`p1 serve --bootstrap` spawns this as a
        task): poll, sleep, repeat until cancelled."""
        while True:
            await self.poll_once()
            await asyncio.sleep(self.poll_interval_s)

    def start(self) -> None:
        self._task = asyncio.create_task(self.run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def snapshot(self) -> dict:
        return {
            "upstreams": len(self.targets),
            "demoted": len(self.demoted),
            "pulled": self.pulled,
            "rounds": self.rounds,
            "stalls": self.stalls,
        }
