"""The port's always-on maintenance plane: live re-basing, continuous
incremental snapshots, online prune/compact while serving, and
version-bits protocol evolution.

Mirrors tests/test_maintenance.py against ``p1_tpu_torch``, every class,
``TestCadenceBench`` holding the port's
``benchmarks/maintenance_cadence.py`` to the port's pins
(``hashx/perf_record.py``).  Blocks are sealed by
the hashlib backend (``get_backend("cpu", device="cpu")``) and nodes run
on the host (``tests/test_torch_node.py``'s ``_config``).

Four property families anchor the plane:

- **incremental == full**: ``build_records_incremental`` is a cost
  model, never a format — manifest and chunks byte-identical to
  ``build_records`` on every state, with reuse proportional to the
  untouched account mass.
- **sidecar == replay**: a segment's ``.sdx`` state delta applied over
  the pre-segment state equals the live ledger after the segment —
  derived from the ledger's own delta rule, one definition only.
- **maintenance never disconnects**: rebase/prune/compact run on a
  LIVE node — refusals are answers, sessions stay open, a mid-op disk
  fault degrades the store without widening loss (compaction tmps
  self-clean), and a live-attached replica keeps serving across
  compaction and refuses loudly (not wrongly) once the store prunes.
- **activation is a pure header function**: the BIP9-analog ladder
  walks DEFINED → STARTED → LOCKED_IN → ACTIVE on signal counts alone,
  legacy version=1 headers never signal, and an empty deployment table
  is byte-identical to history.

``TestCrossPackage`` holds the port's ``.sdx`` sidecars, snapshot records
and version-bits headers byte-equal to the JAX package's.
"""

import pytest

from test_torch_node import DIFF, _config, run
from torch_testutil import account

from p1_tpu_torch.chain import Chain, statedelta
from p1_tpu_torch.chain import snapshot as snaplib
from p1_tpu_torch.chain.versionbits import (
    TOP_BITS,
    Deployment,
    VBState,
    VersionBits,
    signals,
)
from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.tx import BLOCK_REWARD, Transaction
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.miner import Miner
from p1_tpu_torch.node import Node, protocol
from p1_tpu_torch.node.client import maintain as client_maintain
from p1_tpu_torch.node.protocol import MsgType
from p1_tpu_torch.node.queryplane import ReplicaView

_MINER = Miner(backend=get_backend("cpu", device="cpu"), chunk=4096)


def _grow(chain: Chain, n: int, label="alice", version=None) -> Chain:
    """Append ``n`` coinbase-only blocks; ``version`` may be an int, a
    callable of the chain (the version-bits miner hook shape), or None
    for the legacy literal 1."""
    for _ in range(n):
        h = chain.height + 1
        txs = (Transaction.coinbase(account(label), h),)
        parent = chain.tip
        v = version(chain) if callable(version) else (version or 1)
        draft = BlockHeader(
            version=v,
            prev_hash=parent.block_hash(),
            merkle_root=merkle_root([t.txid() for t in txs]),
            timestamp=parent.header.timestamp + 60,
            difficulty=chain.difficulty,
            nonce=0,
        )
        sealed = _MINER.search_nonce(draft)
        res = chain.add_block(Block(sealed, txs))
        assert res.status.value == "accepted", res.reason
    return chain


async def _mine(node, n: int, label="alice") -> None:
    """Mine EXACTLY ``n`` blocks on ``node`` through its normal accept
    path — no mining race, so tests can assert exact heights."""
    old = node.miner_id
    node.miner_id = account(label)
    try:
        for _ in range(n):
            candidate = node._assemble()
            sealed = _MINER.search_nonce(candidate.header)
            await node._handle_block(
                Block(sealed, candidate.txs), origin=None
            )
    finally:
        node.miner_id = old


def _mconfig(store, **kw):
    """A maintenance-plane node: segmented store, small segments so a
    handful of blocks spans several, tight checkpoint cadence."""
    kw.setdefault("store_path", store)
    kw.setdefault("store_segment_bytes", 400)
    kw.setdefault("snapshot_interval", 4)
    return _config(**kw)


async def _side_block(node) -> Block:
    """Forge and inject one valid side-branch block (one below the
    tip, so strictly less work) — a dead record for compaction."""
    chain = node.chain
    parent = chain._block_at(chain.main_hash_at(chain.height - 2))
    txs = (Transaction.coinbase(account("mallory"), chain.height - 1),)
    draft = BlockHeader(
        version=1,
        prev_hash=parent.block_hash(),
        merkle_root=merkle_root([t.txid() for t in txs]),
        timestamp=parent.header.timestamp + 61,
        difficulty=chain.difficulty,
        nonce=0,
    )
    sealed = _MINER.search_nonce(draft)
    blk = Block(sealed, txs)
    tip = chain.tip_hash
    await node._handle_block(blk, origin=None)
    assert chain.tip_hash == tip  # stayed a side branch
    assert blk.block_hash() in chain._index
    return blk


# -- version bits ---------------------------------------------------------


class TestVersionBits:
    def _vb(self, start=8, timeout=800):
        return VersionBits(
            (Deployment("feature-x", 0, start, timeout),),
            window=8,
            threshold=6,
        )

    def test_signals_requires_the_top_bits_tag(self):
        # Legacy version=1 has bit 0 SET but never signals: the
        # top-bits convention is what makes mixed meshes safe.
        assert not signals(1, 0)
        assert signals(TOP_BITS | 1, 0)
        assert not signals(TOP_BITS | 1, 1)
        assert not signals(0x60000001, 0)  # top bits 011, not 001
        assert not signals(TOP_BITS, 0)  # tagged but not signaling

    def test_empty_table_mines_literal_legacy_version(self):
        chain = _grow(Chain(1), 2)
        vb = VersionBits((), window=8, threshold=6)
        assert vb.mining_version(chain, chain.tip_hash) == 1
        assert vb.states_report(chain) == {}

    def test_ladder_walks_on_schedule_when_miners_signal(self):
        vb = self._vb()
        dep = vb.deployments[0]
        chain = Chain(1)
        # seen[tip] is the state governing block tip+1 (state_for_next
        # looks FORWARD): block 8 is the first STARTED one, 16 the
        # first LOCKED_IN, 24 the first ACTIVE.
        seen = {}
        for _ in range(33):
            _grow(chain, 1, version=lambda c: vb.mining_version(c, c.tip_hash))
            seen[chain.height] = vb.state_for_next(chain, chain.tip_hash, dep)
        assert seen[6] is VBState.DEFINED
        assert seen[7] is VBState.STARTED
        assert seen[14] is VBState.STARTED
        assert seen[15] is VBState.LOCKED_IN
        assert seen[22] is VBState.LOCKED_IN
        assert seen[23] is VBState.ACTIVE
        assert seen[33] is VBState.ACTIVE
        # The miner hook clears the signal bit once ACTIVE but keeps
        # the top-bits tag (future deployments share the field).
        assert vb.mining_version(chain, chain.tip_hash) == TOP_BITS

    def test_below_threshold_window_does_not_lock_in(self):
        vb = self._vb()
        dep = vb.deployments[0]
        chain = _grow(Chain(1), 7)  # window 0: DEFINED
        # STARTED window [8, 16): only 5 signaling < threshold 6.
        _grow(chain, 5, version=TOP_BITS | 1)
        _grow(chain, 3, version=1)
        assert chain.height == 15
        _grow(chain, 1, version=TOP_BITS | 1)
        assert vb.state_for_next(chain, chain.tip_hash, dep) is VBState.STARTED
        # The NEXT window carries 6: locks in at its boundary.
        _grow(chain, 5, version=TOP_BITS | 1)
        _grow(chain, 2, version=1)
        _grow(chain, 1, version=TOP_BITS | 1)
        assert chain.height == 24
        assert (
            vb.state_for_next(chain, chain.tip_hash, dep) is VBState.LOCKED_IN
        )

    def test_timeout_window_fails_the_deployment_permanently(self):
        vb = self._vb(start=8, timeout=24)
        dep = vb.deployments[0]
        chain = _grow(Chain(1), 22, version=1)  # nobody signals
        assert vb.state_for_next(chain, chain.tip_hash, dep) is VBState.STARTED
        # One more block: the next one (24) starts the timeout window.
        _grow(chain, 1, version=1)
        assert vb.state_for_next(chain, chain.tip_hash, dep) is VBState.FAILED
        # Even unanimous late signaling cannot resurrect it.
        _grow(chain, 16, version=TOP_BITS | 1)
        assert vb.state_for_next(chain, chain.tip_hash, dep) is VBState.FAILED
        assert vb.mining_version(chain, chain.tip_hash) == TOP_BITS

    def test_speedy_trial_threshold_beats_timeout_at_same_boundary(self):
        # A window that both crosses the timeout AND meets the
        # threshold locks in — the speedy-trial evaluation order.
        vb = self._vb(start=8, timeout=16)
        dep = vb.deployments[0]
        chain = _grow(Chain(1), 7)
        _grow(chain, 8, version=TOP_BITS | 1)
        assert chain.height == 15
        _grow(chain, 1, version=TOP_BITS | 1)
        assert (
            vb.state_for_next(chain, chain.tip_hash, dep) is VBState.LOCKED_IN
        )

    def test_states_report_shape(self):
        vb = self._vb()
        chain = _grow(Chain(1), 9, version=TOP_BITS | 1)
        rep = vb.states_report(chain)
        assert rep == {
            "feature-x": {
                "bit": 0,
                "start_height": 8,
                "timeout_height": 800,
                "state": "started",
            }
        }


# -- per-segment state deltas (.sdx) --------------------------------------


class TestStateDelta:
    def test_block_accounts_names_every_touched_account(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 2, label="alice")
                cb = node.chain.tip
                assert statedelta.block_accounts(cb) == {account("alice")}
                tag = node.chain.genesis.block_hash()
                from torch_testutil import key_for

                tx = Transaction.transfer(
                    key_for("alice"), account("bob"), 2, 1, 0, chain=tag
                )
                await node.submit_tx(tx)
                await _mine(node, 1, label="carol")
                blk = node.chain.tip
                assert statedelta.block_accounts(blk) >= {
                    account("alice"),
                    account("bob"),
                    account("carol"),
                }
            finally:
                await node.stop()

        run(scenario())

    def test_summed_segment_deltas_equal_the_live_ledger(self, tmp_path):
        """Every segment's delta applied in order from the empty state
        reproduces the chain's exact balances and nonces — the property
        that lets an incremental snapshot build trust the sidecars."""

        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 6, label="alice")
                store = node.store
                store.roll_segment()
                balances: dict[str, int] = {}
                nonces: dict[str, int] = {}
                for seg in store.segments:
                    data = store._seg_path(seg).read_bytes()
                    d = statedelta.segment_delta(data)
                    balances, nonces = d.apply(balances, nonces)
                assert balances == node.chain.balances_snapshot()
            finally:
                await node.stop()

        run(scenario())

    def test_sidecar_roundtrip_and_malformation_tolerance(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 4, label="alice")
                node.store.roll_segment()
                seg = node.store.segments[0]
                data = node.store._seg_path(seg).read_bytes()
            finally:
                await node.stop()
            out = tmp_path / "seg0.sdx"
            written = statedelta.write_segment_delta(data, out)
            assert written.records >= 1
            loaded = statedelta.load_segment_delta(out)
            assert loaded == written
            # Malformation never raises — a bad sidecar is just absent
            # (the consumer recomputes from the segment).
            out.write_bytes(b"garbage")
            assert statedelta.load_segment_delta(out) is None
            out.write_bytes(statedelta.SDX_MAGIC + b"\x01")
            assert statedelta.load_segment_delta(out) is None
            assert statedelta.load_segment_delta(tmp_path / "nope.sdx") is None

        run(scenario())


# -- incremental snapshot builds ------------------------------------------


class TestIncrementalSnapshot:
    def _state(self, n=300):
        balances = {f"acct-{i:04d}": 10 + i for i in range(n)}
        nonces = {f"acct-{i:04d}": i % 7 for i in range(n)}
        return balances, nonces

    def test_cold_build_is_byte_identical_to_full(self):
        chain = _grow(Chain(1), 1)
        balances, nonces = self._state()
        full = snaplib.build_records(
            1, chain.tip, balances, nonces, chunk_accounts=16
        )
        m, chunks, inc, reused = snaplib.build_records_incremental(
            None, 1, chain.tip, balances, nonces, set(), chunk_accounts=16
        )
        assert (m, chunks) == full
        assert reused == 0
        assert len(inc.keys) == 300

    def test_warm_build_reuses_untouched_chunks_byte_identically(self):
        chain = _grow(Chain(1), 2)
        balances, nonces = self._state()
        _, _, inc, _ = snaplib.build_records_incremental(
            None, 1, chain.tip, balances, nonces, set(), chunk_accounts=16
        )
        # In-place mutations (no key-shift): exactly two chunks dirty.
        balances["acct-0007"] += 5
        nonces["acct-0200"] += 1
        dirty = {"acct-0007", "acct-0200"}
        full = snaplib.build_records(
            2, chain.tip, balances, nonces, chunk_accounts=16
        )
        m, chunks, inc2, reused = snaplib.build_records_incremental(
            inc, 2, chain.tip, balances, nonces, dirty, chunk_accounts=16
        )
        assert (m, chunks) == full
        assert reused == len(chunks) - 2

        # Create + destroy shift the key order: chunks at and past the
        # shift point re-encode, the result stays byte-identical.
        balances["newcomer"] = 42
        del balances["acct-0100"]
        nonces.pop("acct-0100", None)
        dirty = {"newcomer", "acct-0100"}
        full = snaplib.build_records(
            3, chain.tip, balances, nonces, chunk_accounts=16
        )
        m, chunks, inc3, reused = snaplib.build_records_incremental(
            inc2, 3, chain.tip, balances, nonces, dirty, chunk_accounts=16
        )
        assert (m, chunks) == full
        # Chunks wholly before the deletion point still reuse.
        assert reused >= 1
        assert "acct-0100" not in inc3.entries

    def test_oversized_dirty_set_costs_reuse_never_bytes(self):
        # Every account marked dirty, none actually changed: the build
        # must stay byte-identical, and the value re-check means the
        # too-big set costs per-account encodes, never chunk rebuilds.
        chain = _grow(Chain(1), 1)
        balances, nonces = self._state(50)
        _, _, inc, _ = snaplib.build_records_incremental(
            None, 1, chain.tip, balances, nonces, set(), chunk_accounts=16
        )
        m, chunks, _, reused = snaplib.build_records_incremental(
            inc, 1, chain.tip, balances, nonces,
            set(balances), chunk_accounts=16,
        )
        assert (m, chunks) == snaplib.build_records(
            1, chain.tip, balances, nonces, chunk_accounts=16
        )
        assert reused == len(chunks)
        # And when an oversized set hides ONE real change, exactly that
        # chunk re-encodes.
        balances["acct-0001"] += 7
        m, chunks, _, reused = snaplib.build_records_incremental(
            inc, 1, chain.tip, balances, nonces,
            set(balances), chunk_accounts=16,
        )
        assert (m, chunks) == snaplib.build_records(
            1, chain.tip, balances, nonces, chunk_accounts=16
        )
        assert reused == len(chunks) - 1

    def test_node_publishes_incrementally_and_cross_checks_root(
        self, tmp_path
    ):
        """The node's continuous publication: the second snapshot build
        reuses the first's residue, the published root matches the
        chain's recorded checkpoint root, and the dirty-set plumbing
        (collect + re-seed beyond the checkpoint) keeps it exact."""

        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 5)
                payload, chunks = node._snapshot_records()
                assert (
                    snaplib.parse_manifest(payload).state_root
                    == node.chain.state_checkpoints[4]
                )
                assert node.metrics.snapshot_incremental_builds == 1
                # Cache hit: the checkpoint has not moved.
                assert node._snapshot_records() == (payload, chunks)
                assert node.metrics.snapshot_incremental_builds == 1
                await _mine(node, 4, label="bob")
                payload2, chunks2 = node._snapshot_records()
                assert (
                    snaplib.parse_manifest(payload2).state_root
                    == node.chain.state_checkpoints[8]
                )
                assert node.metrics.snapshot_incremental_builds == 2
                # Byte-identity with a cold full build of the same
                # checkpoint state — incremental is never a format.
                h, block, balances, nonces, _root = (
                    node.chain.snapshot_state()
                )
                assert h == 8
                assert (payload2, chunks2) == snaplib.build_records(
                    h, block, balances, nonces
                )
            finally:
                await node.stop()

        run(scenario())


# -- live re-basing -------------------------------------------------------


class TestChainRebase:
    def _chain(self, blocks=10, interval=4):
        chain = Chain(1)
        chain.checkpoint_interval = interval
        return _grow(chain, blocks)

    def test_rebase_drops_history_keeps_ledger_and_tip(self):
        chain = self._chain(10)
        assert {4, 8} <= set(chain.state_checkpoints)
        tip = chain.tip_hash
        balances = chain.balances_snapshot()
        stats = chain.rebase(8)
        assert stats["old_base"] == 0 and stats["new_base"] == 8
        # Heights 0..7 left the index: genesis + 7 blocks.
        assert stats["dropped_blocks"] == 8
        assert chain.base_height == 8 and chain.height == 10
        assert chain.tip_hash == tip
        assert chain.balances_snapshot() == balances
        assert chain.main_hash_at(9) is not None
        assert chain.main_hash_at(7) is None
        assert min(chain.state_checkpoints) == 8
        # The chain keeps extending and checkpointing past the rebase.
        _grow(chain, 2)
        assert chain.height == 12 and 12 in chain.state_checkpoints

    def test_rebase_target_validation(self):
        chain = self._chain(10)
        with pytest.raises(ValueError, match="cadence"):
            chain.rebase(7)
        with pytest.raises(ValueError, match="outside"):
            chain.rebase(0)
        with pytest.raises(ValueError, match="outside"):
            chain.rebase(12)
        chain.state_checkpoints.pop(4)
        with pytest.raises(ValueError, match="no recorded state root"):
            chain.rebase(4)
        # A failed rebase left the chain untouched.
        assert chain.base_height == 0 and chain.height == 10

    def test_rebase_is_idempotent_about_the_base(self):
        chain = self._chain(10)
        chain.rebase(4)
        stats = chain.rebase(8)
        assert stats["old_base"] == 4 and stats["new_base"] == 8
        with pytest.raises(ValueError, match="outside"):
            chain.rebase(8)


class TestMaintainOps:
    """The node-level plane: every op through the same ``_maintain``
    entry the GETMAINTAIN wire frame and `p1 maintain` drive."""

    def test_live_rebase_then_node_keeps_mining_and_serving(
        self, tmp_path
    ):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 9, label="alice")
                r = await node._maintain({"op": "rebase", "keep": 4})
                assert r["ok"], r
                assert r["old_base"] == 0 and r["new_base"] == 4
                assert r["dropped_blocks"] >= 4
                assert node.chain.base_height == 4
                assert node.metrics.rebases == 1
                # The ledger and tip are untouched; the node mines on.
                assert (
                    node.chain.balance(account("alice")) == 9 * BLOCK_REWARD
                )
                await _mine(node, 3, label="bob")
                assert node.chain.height == 12
                # The spilled sidecar planes back the dropped history.
                sealed = [s for s in node.store.segments if s.sealed]
                assert sealed
                assert all(
                    node.store.hdrx_path(s).exists() for s in sealed
                )
                # status() reports through the maintenance block.
                maint = node.status()["maintenance"]
                assert maint["rebases"] == 1 and maint["base_height"] == 4
                assert maint["busy"] is None
            finally:
                await node.stop()

        run(scenario())

    def test_rebase_refuses_when_nothing_to_do(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 9, label="alice")
                assert (await node._maintain({"op": "rebase", "keep": 4}))[
                    "ok"
                ]
                r = await node._maintain({"op": "rebase", "keep": 8})
                assert not r["ok"] and "nothing to rebase" in r["error"]
                assert node.metrics.rebases == 1
            finally:
                await node.stop()

        run(scenario())

    def test_online_prune_discards_and_is_idempotent(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 10, label="alice")
                node.store.roll_segment()
                r = await node._maintain({"op": "prune", "keep": 2})
                assert r["ok"], r
                assert r["segments_pruned"] >= 1
                # The reply's floor is the EFFECTIVE one: segments
                # prune wholly, so it lands at or below the requested
                # min(10 - 2, checkpoint 8).
                assert 0 < r["floor"] <= 8
                assert node.chain.prune_floor == r["floor"]
                assert node.store.pruned_below == r["floor"]
                # Again: nothing further below the floor — ok, zero.
                r2 = await node._maintain({"op": "prune", "keep": 2})
                assert r2["ok"] and r2["segments_pruned"] == 0
                assert node.metrics.online_prunes == 2
                # Still serving: headers full-range, tip proofs live.
                locator = [node.chain.genesis.block_hash()]
                assert len(node.chain.headers_after(locator)) == 10
                tip_tx = node.chain.tip.txs[0]
                assert node.chain.tx_proof(tip_tx.txid()) is not None
            finally:
                await node.stop()

        run(scenario())

    def test_online_compact_drops_dead_records_only(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 6, label="alice")
                side = await _side_block(node)
                await _mine(node, 2, label="alice")
                # Seal everything so the dead record sits in a sealed
                # segment (compaction only rewrites sealed ones).
                assert (await node._maintain({"op": "rebase", "keep": 2}))[
                    "ok"
                ]
                before = node.chain.height
                r = await node._maintain({"op": "compact"})
                assert r["ok"], r
                assert r["records_dropped"] >= 1
                assert r["segments_compacted"] >= 1
                assert node.metrics.online_compactions == 1
                assert node.metrics.compaction_records_dropped >= 1
                # The node never stopped: chain intact, still mines.
                assert node.chain.height == before
                await _mine(node, 1, label="bob")
                # The dead record is gone from disk; the store reopens
                # clean (fsck finds the exact main-chain records).
            finally:
                await node.stop()
            reopened = Node(_mconfig(str(tmp_path / "c.dat")))
            await reopened.start()
            try:
                assert reopened.chain.height == 9
                assert (
                    reopened.chain.main_hash_at(reopened.chain.height)
                    is not None
                )
                assert side.block_hash() not in reopened.chain._index
            finally:
                await reopened.stop()

        run(scenario())

    def test_compact_without_dead_records_is_a_clean_noop(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 5, label="alice")
                r = await node._maintain({"op": "compact"})
                assert r["ok"] and r["segments_compacted"] == 0
                assert r["records_dropped"] == 0
            finally:
                await node.stop()

        run(scenario())

    def test_refusals_are_answers_never_disconnects(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 2, label="alice")
                cases = [
                    (["not", "a", "dict"], "must be an object"),
                    ({"op": "frobnicate"}, "unknown maintenance op"),
                    ({"op": None}, "unknown maintenance op"),
                    ({"op": "rebase", "keep": -1}, "non-negative"),
                    ({"op": "rebase", "keep": True}, "non-negative"),
                    ({"op": "prune", "keep": "4"}, "non-negative"),
                ]
                for command, needle in cases:
                    r = await node._maintain(command)
                    assert not r["ok"] and needle in r["error"], (
                        command,
                        r,
                    )
                # One op at a time: a busy plane refuses the second.
                node._maintenance_busy = "compact"
                r = await node._maintain({"op": "rebase", "keep": 0})
                assert not r["ok"] and "busy" in r["error"]
                node._maintenance_busy = None
                # status is always served, busy or not.
                node._maintenance_busy = "rebase"
                r = await node._maintain({"op": "status"})
                assert r["ok"] and r["busy"] == "rebase"
                node._maintenance_busy = None
                # No refusal cost the node its counters or its chain.
                assert node.metrics.rebases == 0
                assert node.chain.height == 2
            finally:
                await node.stop()

        run(scenario())

    def test_status_op_serves_the_full_report(self, tmp_path):
        async def scenario():
            node = Node(
                _mconfig(
                    str(tmp_path / "c.dat"),
                    deployments=(("feature-x", 0, 8, 800),),
                    vb_window=8,
                    vb_threshold=6,
                )
            )
            await node.start()
            try:
                await _mine(node, 1, label="alice")
                r = await node._maintain({"op": "status"})
                assert r["ok"] and r["busy"] is None
                vb = r["versionbits"]
                assert vb["window"] == 8 and vb["threshold"] == 6
                assert vb["deployments"]["feature-x"]["state"] == "defined"
                # And the mined header already carries the tagged
                # version (the deployment table changes what we mine).
                assert node.chain.tip.header.version == TOP_BITS
            finally:
                await node.stop()

        run(scenario())


# -- maintenance under disk faults ----------------------------------------


class TestMaintainFaults:
    def test_compact_planner_fault_degrades_and_self_cleans(
        self, tmp_path
    ):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 6, label="alice")
                await _side_block(node)
                await _mine(node, 2, label="alice")
                assert (await node._maintain({"op": "rebase", "keep": 2}))[
                    "ok"
                ]
                node.store.fail_next_compact = True
                r = await node._maintain({"op": "compact"})
                assert not r["ok"] and "planning failed" in r["error"]
                assert node._store_degraded
                assert node.metrics.online_compactions == 0
                # The partial tmp the fault landed mid-write is gone —
                # a failed compaction must never widen loss.
                seg_dir = node.store.seg_dir
                assert not list(seg_dir.glob("*.tmp"))
                # Degraded store: further maintenance refused, node up.
                r2 = await node._maintain({"op": "rebase", "keep": 2})
                assert not r2["ok"] and "degraded" in r2["error"]
                assert node.chain.height == 8
            finally:
                await node.stop()

        run(scenario())

    def test_sdx_sidecar_fault_is_tolerated_not_fatal(self, tmp_path):
        """A failed ``.sdx`` write at seal is a healed degradation —
        the delta recomputes from the segment — so a live rebase rides
        through it."""

        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 9, label="alice")
                before = node.store.healed["sdx_failures"]
                node.store.fail_next_sidecar = True
                r = await node._maintain({"op": "rebase", "keep": 4})
                assert r["ok"], r
                assert node.store.healed["sdx_failures"] == before + 1
                assert not node._store_degraded
                assert node.chain.base_height == 4
            finally:
                await node.stop()

        run(scenario())


# -- the live-attached replica --------------------------------------------


class TestReplicaAcrossMaintenance:
    def test_replica_serves_across_online_compaction(self, tmp_path):
        """A flock-free replica attached BEFORE an online compaction
        keeps serving after it — the segment files were rewritten
        underneath the mmap and the refresh path must re-pin them."""

        async def scenario():
            store = str(tmp_path / "c.dat")
            node = Node(_mconfig(store))
            await node.start()
            try:
                await _mine(node, 6, label="alice")
                view = ReplicaView(store, DIFF)
                try:
                    assert view.tip_height == 6
                    await _side_block(node)
                    await _mine(node, 2, label="alice")
                    assert (
                        await node._maintain({"op": "rebase", "keep": 2})
                    )["ok"]
                    r = await node._maintain({"op": "compact"})
                    assert r["ok"] and r["records_dropped"] >= 1
                    await _mine(node, 1, label="bob")
                    view.refresh()
                    assert view.tip_height == node.chain.height == 9
                    assert view.raw_header(9) == (
                        node.chain.tip.header.serialize()
                    )
                finally:
                    view.close()
            finally:
                await node.stop()

        run(scenario())

    def test_replica_refuses_loudly_once_the_node_prunes(self, tmp_path):
        """Online pruning under a live replica: the refresh must raise
        the pruned-store refusal — never silently serve a view with
        holes in it."""

        async def scenario():
            store = str(tmp_path / "c.dat")
            node = Node(_mconfig(store))
            await node.start()
            try:
                await _mine(node, 10, label="alice")
                node.store.roll_segment()
                view = ReplicaView(store, DIFF)
                try:
                    assert view.tip_height == 10
                    r = await node._maintain({"op": "prune", "keep": 2})
                    assert r["ok"] and r["segments_pruned"] >= 1
                    with pytest.raises(ValueError, match="pruned"):
                        view.refresh()
                finally:
                    view.close()
                # A FRESH attach refuses the same way.
                with pytest.raises(ValueError, match="pruned"):
                    ReplicaView(store, DIFF)
            finally:
                await node.stop()

        run(scenario())


# -- the wire -------------------------------------------------------------


class TestMaintainWire:
    def test_protocol_roundtrip(self):
        frame = protocol.encode_getmaintain({"op": "rebase", "keep": 4})
        mtype, body = protocol.decode(frame)
        assert mtype is MsgType.GETMAINTAIN
        assert body == {"op": "rebase", "keep": 4}
        frame = protocol.encode_maintain({"ok": True, "new_base": 8})
        mtype, body = protocol.decode(frame)
        assert mtype is MsgType.MAINTAIN
        assert body == {"ok": True, "new_base": 8}

    def test_client_maintain_end_to_end(self, tmp_path):
        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 9, label="alice")
                r = await client_maintain(
                    "127.0.0.1", node.port, {"op": "status"}, DIFF
                )
                assert r["ok"] and r["busy"] is None
                assert r["base_height"] == 0
                r = await client_maintain(
                    "127.0.0.1",
                    node.port,
                    {"op": "rebase", "keep": 4},
                    DIFF,
                )
                assert r["ok"] and r["new_base"] == 4
                # A refusal travels the wire as an ANSWER; the session
                # (and the node's serving posture) survives to answer
                # the next query on a fresh connection.
                r = await client_maintain(
                    "127.0.0.1", node.port, {"op": "nope"}, DIFF
                )
                assert not r["ok"] and "unknown" in r["error"]
                r = await client_maintain(
                    "127.0.0.1", node.port, {"op": "status"}, DIFF
                )
                assert r["ok"] and r["base_height"] == 4
            finally:
                await node.stop()

        run(scenario())


class TestCadenceBench:
    """The ``bench`` maintenance probe (benchmarks/maintenance_cadence.py)
    against its perf_record.py pins: the metric names ``bench`` wires in
    must exist, and the O(delta) claim must actually show up as a >1
    incremental-over-full speedup even at a toy shape."""

    def test_quick_probe_keys_and_speedup(self):
        from p1_tpu_torch.benchmarks.maintenance_cadence import bench_quick

        out = bench_quick(accounts=2_000, delta=16, blocks=48)
        for key in (
            "snapshot_incr_builds_per_sec",
            "snapshot_full_builds_per_sec",
            "snapshot_cadence_speedup",
            "snapshot_chunks_reused",
            "rebase_ms",
            "rebase_dropped_blocks",
            "rebase_freed_bytes",
        ):
            assert key in out, key
        assert out["snapshot_cadence_speedup"] > 1.0
        assert out["rebase_dropped_blocks"] > 0
        assert out["rebase_ms"] < 1_000.0

    def test_pins_exist_and_are_sane(self):
        # The guard constants bench divides by: nonzero, right side of
        # the degraded comparison (fraction < 1 for rates, factor > 1 for
        # latencies).
        from p1_tpu_torch.hashx import perf_record as pr

        assert pr.RECORDED_SNAPSHOT_CADENCE_BPS > 0
        assert pr.RECORDED_REBASE_MS > 0
        assert 0 < pr.SNAPSHOT_CADENCE_DEGRADED_FRACTION < 1
        assert pr.REBASE_DEGRADED_FACTOR > 1


class TestCrossPackage:
    """Bytes the maintenance plane writes or serves are the reference's."""

    def test_sdx_sidecars_equal_the_references(self, tmp_path):
        from p1_tpu.chain import statedelta as ref_statedelta

        async def scenario():
            node = Node(_mconfig(str(tmp_path / "c.dat")))
            await node.start()
            try:
                await _mine(node, 6, label="alice")
                tag = node.chain.genesis.block_hash()
                from torch_testutil import key_for

                tx = Transaction.transfer(key_for("alice"), account("bob"), 2, 1, 0, chain=tag)
                await node.submit_tx(tx)
                await _mine(node, 2, label="carol")
                node.store.roll_segment()
                return [node.store._seg_path(seg).read_bytes() for seg in node.store.segments], [
                    node.store.sdx_path(seg) for seg in node.store.segments
                ]
            finally:
                await node.stop()

        segments, sidecars = run(scenario())
        written = [p for p in sidecars if p.exists()]
        assert written  # the store wrote sidecars for its closed segments
        for i, data in enumerate(segments):
            ours, ref = tmp_path / f"port{i}.sdx", tmp_path / f"ref{i}.sdx"
            statedelta.write_segment_delta(data, ours)
            ref_statedelta.write_segment_delta(data, ref)
            assert ours.read_bytes() == ref.read_bytes(), i
        for path in written:
            seg_data = segments[sidecars.index(path)]
            ref = tmp_path / "ref_check.sdx"
            ref_statedelta.write_segment_delta(seg_data, ref)
            assert path.read_bytes() == ref.read_bytes(), path.name

    def test_snapshot_records_equal_the_references(self):
        from p1_tpu.chain import snapshot as ref_snaplib
        from p1_tpu.core.block import Block as RefBlock

        chain = _grow(Chain(1), 3)
        ref_tip = RefBlock.deserialize(chain.tip.serialize())
        balances = {f"acct-{i:04d}": 10 + i for i in range(120)}
        nonces = {f"acct-{i:04d}": i % 7 for i in range(120)}
        for chunk_accounts in (16, 1000):
            ours = snaplib.build_records(3, chain.tip, balances, nonces, chunk_accounts=chunk_accounts)
            ref = ref_snaplib.build_records(3, ref_tip, balances, nonces, chunk_accounts=chunk_accounts)
            assert ours == ref
        m, chunks, _, _ = snaplib.build_records_incremental(None, 3, chain.tip, balances, nonces, set(),
                                                            chunk_accounts=16)  # fmt: skip
        assert (m, chunks) == ref_snaplib.build_records(3, ref_tip, balances, nonces, chunk_accounts=16)

    def test_version_bits_ladder_equals_the_references(self):
        from p1_tpu.chain import Chain as RefChain
        from p1_tpu.chain.versionbits import Deployment as RefDeployment
        from p1_tpu.chain.versionbits import VersionBits as RefVersionBits
        from p1_tpu.core.block import Block as RefBlock

        vb = VersionBits((Deployment("feature-x", 0, 8, 800),), window=8, threshold=6)
        ref_vb = RefVersionBits((RefDeployment("feature-x", 0, 8, 800),), window=8, threshold=6)
        chain, ref = Chain(1), RefChain(1)
        for _ in range(26):
            _grow(chain, 1, version=lambda c: vb.mining_version(c, c.tip_hash))
            assert ref.add_block(RefBlock.deserialize(chain.tip.serialize())).status.value == "accepted"
            assert vb.mining_version(chain, chain.tip_hash) == ref_vb.mining_version(ref, ref.tip_hash)
            assert vb.states_report(chain) == ref_vb.states_report(ref)
        assert vb.states_report(chain)["feature-x"]["state"] == "active"
