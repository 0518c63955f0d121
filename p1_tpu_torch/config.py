"""Node/miner configuration: one config dataclass.

The port's copy of ``p1_tpu/config.py``.  Everything a node process
needs: chain parameters, hash backend choice, p2p identity and peer list,
persistence path, mining switches.  The CLI (p1_tpu_torch/cli.py) builds
one of these from flags; tests build them directly.

Two fields differ from the reference: ``backend`` defaults to ``cuda``
(the search kernel on the card), and ``device`` says where the node's
device work runs — the nonce search and the signature batches of the
``device`` rung — ``cuda`` (the default; a node without a card refuses to
start) or ``cpu`` (the kernels' plain PyTorch versions, what the tests
pass).  It is the port's counterpart of the reference CLI's
``--platform`` pin.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    difficulty: int = 16
    backend: str = "cuda"  # hash backend registry name (cuda, cpu)
    #: Where the backend and the ``device`` signature rung run: "cuda"
    #: (the kernels) or "cpu" (their plain PyTorch versions).
    device: str = "cuda"
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral (tests); CLI defaults to 9444
    peers: tuple[str, ...] = ()  # "host:port" dial targets
    mine: bool = True
    store_path: str | None = None  # chain log; None = in-memory only
    max_block_txs: int = 1000
    batch: int | None = None  # device batch override for cuda
    chunk: int | None = None  # miner abort granularity (nonces per call)
    #: Coinbase recipient id.  None = a random per-process id, which is what
    #: makes two independent miners produce *different* candidate blocks.
    miner_id: str | None = None
    #: Opt-in difficulty retargeting (core/retarget.py).  0 = fixed
    #: difficulty (every benchmark config).  Both must be set together;
    #: the pair is part of chain identity (committed into genesis).
    retarget_window: int = 0
    target_spacing: int = 0
    #: Gossip blocks carrying transactions as compact blocks (header +
    #: txids, ~32 B/tx) instead of full serializations; receivers
    #: reconstruct from their mempool and fetch only what they lack.
    #: Local preference, not a chain parameter — mixed nets interoperate.
    compact_gossip: bool = True
    #: Age after which a pending transaction is dropped from the pool
    #: (hygiene — an unmineable spend must not occupy capacity forever;
    #: the owner can always rebroadcast).  0 disables expiry.
    mempool_ttl_s: float = 3600.0
    #: Peer discovery out-degree: when > 0, the node dials addresses
    #: learned via GETADDR/ADDR gossip until it holds this many
    #: connections — one seed peer bootstraps the whole network.  0 (the
    #: default) dials only the configured ``peers``; the address book and
    #: GETADDR serving stay on either way.
    target_peers: int = 0
    #: Liveness deadlines (node/node.py peer sessions).  A connection must
    #: complete its HELLO within ``handshake_timeout_s`` or it is reaped —
    #: a pre-handshake socket holds node resources but proves nothing.
    #: After the handshake, a peer silent for ``ping_interval_s`` gets a
    #: PING probe; silence through another ``pong_timeout_s`` means
    #: eviction and the ``MAX_PEERS`` slot is reused.  ANY received frame
    #: counts as liveness, so chatty peers are never probed at all.
    handshake_timeout_s: float = 10.0
    ping_interval_s: float = 60.0
    pong_timeout_s: float = 20.0
    #: Request supervision (node/supervision.py).  An in-flight multi-round
    #: fetch (locator block sync, compact-block GETBLOCKTXN round, paged
    #: mempool sync) must show *progress* — blocks accepted, pages
    #: consumed, not mere liveness — within ``sync_stall_timeout_s`` or
    #: the node re-issues the request to a different eligible peer and
    #: demotes (never bans) the staller.  Failovers back off with jitter
    #: from ``sync_backoff_base_s`` doubling up to ``sync_backoff_max_s``,
    #: and at most ``sync_attempts_max`` consecutive stalls are chased per
    #: catch-up episode (progress resets the budget).  The deadline is
    #: deliberately far above any honest batch turnaround: a slow peer
    #: that keeps landing blocks is never demoted.
    sync_stall_timeout_s: float = 10.0
    sync_attempts_max: int = 8
    sync_backoff_base_s: float = 0.25
    sync_backoff_max_s: float = 5.0
    #: Escape hatch for the storage durability layer: by default a store
    #: write failure (ENOSPC, EIO, fsync error) degrades the node into a
    #: serve-only mode that retries the disk with backoff and recovers
    #: in place; with this set the node signals fatal instead (the CLI
    #: exits 4) for operators who prefer a supervisor restart.
    store_degraded_exit: bool = False
    #: Overload resilience (node/governor.py).  ``admission_control``
    #: gates the per-peer multi-class token buckets at the dispatch door
    #: (blocks / txs / queries — floods are dropped and escalate to the
    #: misbehavior score; solicited replies are never charged).  On by
    #: default: the budgets sit far above any honest peer's rates.
    admission_control: bool = True
    #: High watermark (bytes) on the node's accounted memory gauge
    #: (resident chain bodies + pending pool bytes + peer write
    #: buffers).  Above it the node enters the SHED overload state —
    #: low-priority gossip and mempool pages drop, mining pauses,
    #: consensus-critical headers/blocks/proof service keeps running —
    #: with hysteresis back to NORMAL below 80% of the mark.  0 (the
    #: default) disables shedding; admission control and the per-peer
    #: write-queue caps stay on regardless.
    mem_watermark_bytes: int = 0
    #: Memory-bounded operation: keep only the most recent N main-chain
    #: block BODIES resident in the RAM index (headers and all metadata
    #: stay), evicting older bodies once they are durably refetchable
    #: from the append-only store and re-reading them on demand.  Cuts
    #: steady-state and resume peak RSS from O(chain) to O(N).
    #: 0 disables (fully
    #: resident — the historical behavior); requires ``store_path``.
    body_cache_blocks: int = 0
    #: Segmented store layout (chain/segstore.py): shard the append-only
    #: log into bounded segment files of this many bytes (per-segment
    #: fsck/compaction/pruning — the archive-scale layout).  0 keeps
    #: whatever layout the store already has (an existing segmented
    #: store reopens segmented; a fresh or single-file store stays
    #: single-file).  A single-file store upgrades LOSSLESSLY on the
    #: first writer acquire when this is set.
    store_segment_bytes: int = 0
    #: Pruned mode: keep at least this many recent block
    #: BODIES on disk and discard whole body segments below the latest
    #: snapshot checkpoint — the node keeps serving headers, cached
    #: filters, and snapshots, and REFUSES (without disconnecting)
    #: block-sync requests into the pruned range; honest joiners fail
    #: over to an archive peer or snapshot-sync.  0 disables (archive
    #: node — the default).  Requires (and implies) a segmented store.
    prune_keep_blocks: int = 0
    #: Validation worker count (core/keys.py ``set_verify_workers``) for
    #: batched Ed25519 verification on the untrusted paths.  0 = unpinned
    #: (reported as 1).  The port's rungs run no pool (the device rung orders its launches
    #: on the card's stream), so the size is recorded and reported in
    #: ``status()["validation"]["workers"]``; it NEVER changes
    #: validation outcomes.
    verify_workers: int = 0
    #: Staged block pipeline (node/pipeline.py): off-loop
    #: worker lanes for the validate and store stages.  0 (the default)
    #: keeps the historical inline node — every stage on the event
    #: loop, scheduling byte-identical to before the refactor.  N >= 1
    #: moves batched signature pre-verification and the whole fsync
    #: chain (append, checkpoints, snapshot flips) onto worker threads
    #: and, when ``verify_workers`` is 0, sets the verify worker count
    #: to N.  Staging NEVER changes validation outcomes or wire
    #: behavior — the network simulator proves the trace digest is
    #: byte-identical with staging on or off — only where the CPU/IO
    #: cost is paid.
    pipeline_workers: int = 0
    #: Signature-verification backend (core/keys.py ladder).  "auto"
    #: (default) and "device" send batches to the ``device`` rung
    #: (hashx/ed25519_msm.py: the ``ed25519_msm.cu`` kernel, or its
    #: plain version under ``device="cpu"``) and serial verifies to the
    #: native C++ engine where it builds; "native" runs batches on that
    #: engine too; "cryptography" names a rung the port does not have (a
    #: warning, then auto); "fallback" forces the pure-Python tier.  Backend choice NEVER changes
    #: validation outcomes — every rung is verdict- and error-text-
    #: equivalent by test — only the cost model.
    sig_backend: str = "auto"
    #: Deterministic identity/jitter seed.  None (production) draws the
    #: HELLO instance nonce and default miner id from the OS and leaves
    #: supervision backoff jitter on an unseeded RNG; a seed makes all
    #: of it a pure function of the seed — what lets the network
    #: simulator (node/netsim.py) replay a thousand-node run
    #: byte-for-byte.  Never affects consensus: identity and jitter
    #: only.
    rng_seed: int | None = None
    #: Untrusted snapshot sync (chain/snapshot.py, the assumeUTXO
    #: analog).  When True, a FRESH node (height 0) whose peer
    #: advertises a tip at least ``snapshot_min_lead`` blocks ahead
    #: fetches a ledger-state snapshot instead of replaying history:
    #: it verifies the manifest/chunk digests/state root, starts
    #: serving queries immediately in the ASSUMED validation state, and
    #: revalidates the real history in the background — flipping to
    #: fully-validated on a matching state root, or quarantining the
    #: snapshot, demoting the serving peer, and falling back to genesis
    #: IBD on any divergence.  Off by default: assumed state is a trust
    #: posture an operator must opt into.
    snapshot_sync: bool = False
    #: Minimum advertised-height lead before a snapshot is preferred
    #: over ordinary IBD (a snapshot round trip is pointless for a
    #: nearly caught-up peer).
    snapshot_min_lead: int = 4
    #: State-root checkpoint spacing override (0 = the chain default:
    #: the retarget window when one is active, else
    #: chain/snapshot.py DEFAULT_CHECKPOINT_INTERVAL).  Must agree
    #: across nodes for served snapshot heights to line up with what
    #: joiners can revalidate; it is a policy knob, never consensus.
    snapshot_interval: int = 0
    #: Telemetry plane (node/telemetry.py): per-stage latency histograms
    #: over the block pipeline (admission/validate/store/relay), query
    #: request latency, and supervision backoff timing, exported over
    #: GETMETRICS / `p1 metrics`.  Counters (NodeMetrics/status()) stay
    #: live either way; False removes every telemetry clock read —
    #: recording is observer-only by contract (the sim determinism pair
    #: proves the trace digest is identical in both states), so this
    #: knob exists for overhead control, not correctness.
    telemetry: bool = True
    #: Re-run the full stateless validation (PoW, merkle, Ed25519) over
    #: every stored block at boot instead of the trusted fast resume.
    #: The store is this node's own flocked append-only log of blocks it
    #: already validated, so the default trusts it; set True when
    #: on-disk integrity is in question.
    revalidate_store: bool = False
    #: Version-bits protocol evolution (chain/versionbits.py, the BIP9
    #: analog): named feature deployments as
    #: ``(name, bit, start_height, timeout_height)`` tuples.  Miners
    #: aware of a deployment signal its bit in mined header versions
    #: while it is STARTED/LOCKED_IN; activation is a pure function of
    #: the header chain, so every configured node reports the same
    #: state at the same height.  Empty (the default) mines the legacy
    #: ``version=1`` headers — byte-identical to a chain without them.
    #: Header version is NOT a consensus field, so mixed
    #: configured/legacy meshes never fork on signaling alone (the
    #: ``version_activation`` scenario pins this).
    deployments: tuple = ()
    #: Signaling window length in blocks and the signal count within one
    #: completed window that locks a deployment in.  Like
    #: ``snapshot_interval``: must agree across nodes for their state
    #: reports to line up — policy coordination, never consensus.
    vb_window: int = 8
    vb_threshold: int = 6
    #: Set-reconciliation tx relay (node/reconcile.py, the Erlay
    #: analog).  Off by default: flood relay stays the
    #: baseline behavior and every pre-recon sim trace is untouched.
    #: When on, accepted transactions queue into per-peer pending
    #: windows and periodic sketch rounds exchange only the symmetric
    #: difference; flood remains the fallback (decode failure, demoted
    #: poisoners, non-recon peers) and block announces always flood.
    #: Local relay policy, never consensus — but a deployment named
    #: ``txrecon`` in ``deployments`` additionally gates activation on
    #: the version-bits plane reaching ACTIVE, so a mesh can roll the
    #: feature out by miner signaling with stragglers staying correct.
    recon_gossip: bool = False
    #: Seconds between reconciliation rounds (one outbound peer per
    #: tick, round-robin).  Bounds tx propagation latency over
    #: reconciled links at roughly diameter * interval in the worst
    #: case; the flood spine below keeps the common case flood-fast.
    recon_interval_s: float = 1.0
    #: Low-latency flood spine: relay each accepted tx by ordinary
    #: flood to this many outbound reconciling peers (dial order, so
    #: the spine is deterministic) and reconcile the rest.  Erlay's
    #: shape: flooding a few links spans the mesh fast; sketches carry
    #: the redundant copies that were the bandwidth bill.
    recon_flood_degree: int = 1

    def retarget_rule(self):
        """The chain's ``RetargetRule``, or None for fixed difficulty."""
        from p1_tpu_torch.core.retarget import RetargetRule

        return RetargetRule.from_params(
            self.retarget_window, self.target_spacing
        )

    def peer_addrs(self) -> list[tuple[str, int]]:
        # A bare "host:port" string would otherwise iterate character-wise.
        peers = (self.peers,) if isinstance(self.peers, str) else self.peers
        out = []
        for peer in peers:
            host, _, port = peer.rpartition(":")
            out.append((host or "127.0.0.1", int(port)))
        return out
