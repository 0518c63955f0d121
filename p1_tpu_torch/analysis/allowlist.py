"""The audited exceptions: rule -> file -> construct key -> REASON.

Every entry is a sentence a reviewer can audit, not a bare pass.  Both
directions are enforced by the engine (tests/test_torch_analysis.py
keeps the tree settled in tier-1):

- a finding with no grant here fails the build;
- a grant here that no finding consumes fails the build too — stale
  grants rot into blanket permissions.

The port's table is the JAX package's (``p1_tpu/analysis/allowlist.py``)
key for key: the port's modules are copies of the reference's, so the
same constructs sit in the same files.  Each reason was checked against
the port's file; where the port's code deliberately differs from the
reference (the relay-race refund in node/node.py, the replica drain in
node/queryplane.py, the per-thread temporary manifest in
chain/segstore.py) the reason says whether the difference touches the
granted construct.  tests/test_torch_analysis.py holds both packages'
findings equal file for file.

Wall-clock grants descend from a retired tokenizer lint (same files,
same constructs); the reasons are its audit comments.  Notes that
shaped that list and still bind future edits:

- node/protocol.py once held a ``time.time`` grant for encode_block's
  default send stamp: the codec now encodes 0.0 = "no
  stamp" and every caller stamps from its own transport clock — the
  stamp is INSIDE the frame bytes, so a codec-side host-clock read
  made simulated flood traces nondeterministic.  Do not re-grant it.
- chain/snapshot.py entered coverage clock-free with ZERO grants
  and must stay that way: snapshot integrity checking and
  (de)serialization are pure functions of bytes, and granting the
  module a clock seam it does not need would only invite one
  (tests/test_torch_simlint.py pins this by name).
- node/reconcile.py entered coverage with ZERO grants and
  must stay that way: the sketch codec is pure GF(2^32) arithmetic
  over bytes — no clock, no rng, no loop — and every consumer-side
  timing decision (round cadence, stall aging, demotion windows)
  lives in node/node.py where the existing grants already cover it.
- chain/segstore.py holds no grant: its temporary manifest is named by
  process and thread (``os.getpid()``, ``threading.get_ident()``), never
  by a clock read.

The four rules with no entries below — lost-task, unseeded-rng,
set-iteration, await-state — currently hold over the WHOLE package
with zero exceptions (the two findings they once had, chaos.py's
set-literal probe iteration and supervision.py's implicitly-seeded
fallback rng, were fixed rather than granted).  Keep it
that way where possible: for these rules a fix is almost always
smaller than an audit-proof reason.
"""

from __future__ import annotations

#: rule name -> file (relative to p1_tpu_torch/) -> grant key -> audited
#: reason.
GRANTS: dict[str, dict[str, dict[str, str]]] = {
    "wall-clock": {
        # -- async product code running under the (possibly virtual)
        #    loop: asyncio.sleep is loop-relative, sim-compatible BY
        #    CONSTRUCTION — granted per file so a NEW module acquiring
        #    sleeps is a deliberate edit, not a silent pass.
        "node/node.py": {
            "asyncio.sleep": "node coroutines sleep on their own loop; "
            "the simulator virtualizes the loop itself (the port's "
            "relay-race refund, _refund_relay_race, ages duplicates by "
            "connected-block count and reads no clock)",
        },
        "node/client.py": {
            "asyncio.sleep": "light-client backoff sleeps ride the "
            "caller's loop (virtual under netsim)",
        },
        "node/provision.py": {
            "asyncio.sleep": "UpstreamSync poll interval rides the "
            "caller's loop (virtual under netsim); bootstrap runs "
            "before the replica serves, outside any injected Clock",
        },
        # -- the simulator itself: sleeps are virtual here, and
        #    time.monotonic guards REAL wall budgets (SimWallTimeout)
        #    plus the scenario reports' wall_s — deliberate host reads.
        "node/netsim.py": {
            "time.monotonic": "SimWallTimeout real-wall budget + report "
            "wall_s: deliberate host-clock reads about the sim, not in it",
            "asyncio.sleep": "the virtual loop's own sleep primitive",
        },
        "node/scenarios.py": {
            "time.monotonic": "scenario wall_s reporting and wall "
            "budgets (same split as netsim.py)",
            "asyncio.sleep": "scenario driver sleeps on the virtual loop",
        },
        "node/chaos.py": {
            "time.monotonic": "chaos sweeps' SimWallTimeout budget and "
            "report wall_s (same split as scenarios.py)",
            "asyncio.sleep": "chaos schedules sleep on the virtual loop",
        },
        "node/farfield.py": {
            "time.monotonic": "the shard coordinator's real-wall "
            "budget guard and report wall_s — deliberate host-clock "
            "reads ABOUT the far-field run, never inside its "
            "integer-microsecond event time (same split as netsim.py); "
            "the engine itself is synchronous and clock-free",
        },
        # -- harness/tooling that drives REAL processes and sockets on
        #    the host clock by design (subprocess meshes, soak drivers,
        #    operator runners) — not part of the simulated node.
        "node/runner.py": {
            "time.time": "operator soak runner: wall-clock deadlines "
            "over real processes",
            "time.monotonic": "real elapsed/rate figures for the soak "
            "report",
            "asyncio.sleep": "paces a REAL node's status polling",
        },
        "node/netharness.py": {
            "time.time": "subprocess-mesh harness deadlines over real "
            "sockets",
            "asyncio.sleep": "real-socket settle/poll pacing",
        },
        "node/byzantine.py": {
            "asyncio.sleep": "attacker session pacing under the "
            "(possibly virtual) loop",
        },
        "node/testing.py": {
            "asyncio.sleep": "hostile/greedy peer harness pacing under "
            "the (possibly virtual) loop",
        },
        # -- the read-replica serving plane: a real-socket, separate-
        #    process tier (`p1 serve`) out of the simulator's scope.
        "node/queryplane.py": {
            "time.monotonic": "replica uptime/QPS windows on the host "
            "clock (separate process, never simulated)",
            "asyncio.sleep": "replica refresh pacing on its own real "
            "loop (the port's drain awaits the closed listener in stop "
            "rather than before the subscriber drain, which adds no "
            "sleep)",
        },
        # -- benchmark timing, not node behavior.
        "chain/replay.py": {
            "time.perf_counter": "replay throughput figures (the "
            "benchmark IS a wall-clock measurement)",
        },
    },
    "lost-task": {},
    "unseeded-rng": {},
    "set-iteration": {},
    "blocking-in-async": {
        # Currently EMPTY: no direct blocking calls run on any async
        # loop today.  Store fsyncs, signature preverification, and
        # checkpoint writes all travel through NodePipeline.run_store /
        # run_validate (node/pipeline.py) — callables handed to a lane,
        # never called from the coroutine — so the house pattern for new
        # blocking work is "give it to the pipeline", not "grant it
        # here".  A grant added here is acknowledged debt: each one
        # names a call the staged pipeline has not absorbed yet.
    },
    "await-state": {},
    # -- transitive-blocking: THE STAGE SPLIT'S OFFLOAD WORK
    #    LIST.  Each grant is one call chain, found by the whole-
    #    package call graph, through which an async def blocks the
    #    consensus loop today.  The reason names the pipeline stage
    #    (wire framing → admission → validation → store → relay) the
    #    multi-core split must move it to.  Removing a grant here
    #    should mean the chain moved off-loop — not that the lint
    #    stopped seeing it.
    #
    #    The staged pipeline (node/pipeline.py) retired ten of the
    #    twelve node/node.py grants this table once held: it now owns
    #    every chain they named.  Per-retirement record:
    #
    #    - Node._handle_block->ctypes.CDLL: wire blocks preverify
    #      signatures on the VALIDATE lane before add_block; the
    #      residual on-loop check_block verify is a sig-cache hit for
    #      every honestly-signed block (only invalid-signature blocks
    #      pay it, bounded by the ban that follows) and goes through
    #      Chain.check_block, an instance-attribute seam the call
    #      graph correctly no longer binds to the ctypes engine.
    #    - Node._handle_block->open: _store_append submits
    #      _store_flush_io to the STORE lane; append+fsync left the
    #      loop.
    #    - Node._dispatch->ctypes.CDLL: BLOCKS/MEMPOOL batch
    #      preverification runs on the VALIDATE lane.
    #    - Node._dispatch->os.fsync: the BLOCKS batch-close sync runs
    #      on the STORE lane (_store_sync_io).
    #    - Node._store_recovery_loop->open / ->os.fsync: degraded-mode
    #      flush retries and the recovery sync probe submit the same
    #      _io helpers to the STORE lane.
    #    - Node._adopt_snapshot->open / ->os.fsync: the snapshot
    #      sidecar write and the genesis-first store rewrite run on
    #      the STORE lane.
    #    - Node._snapshot_flip->os.fsync and
    #      Node._snapshot_diverged->os.fsync: _rewrite_store — the
    #      heaviest single blocking window in the node — runs on the
    #      STORE lane for both the flip and the quarantine path.
    #
    #    The two survivors are boundary cases by design, not misses:
    #    start() has no sessions to stall and stop() drains the
    #    pipeline BEFORE its final flush precisely so shutdown IO can
    #    stay synchronous.
    "transitive-blocking": {
        "node/node.py": {
            "Node.start->open": "startup-only: the resume path opens/"
            "locks/replays the store before the node serves a single "
            "frame — no session exists to stall; stays on-loop by "
            "design",
            "Node.stop->open": "shutdown-only: the final store flush "
            "runs after pipeline.drain_and_close() joined the store "
            "worker; a lane submit here would race its own teardown",
        },
        "node/queryplane.py": {
            "serve_replica->open": "replica attach (ReplicaView "
            "refresh: manifest read + per-segment mmap) runs once at "
            "worker startup before any session exists; steady-state "
            "refreshes only stat/remap the tail — stays on-loop by "
            "design",
        },
        "node/provision.py": {
            "bootstrap_store->open": "startup-only: cold start runs "
            "BEFORE the replica serves its first frame — no session "
            "exists to stall, and the store appends/syncs already "
            "ride asyncio.to_thread; the residual on-loop IO is the "
            "bootbase sidecar write and snapshot spool, once per "
            "bootstrap by design",
        },
    },
    # -- escaped-state: await-state folded one call level.
    "escaped-state": {
        "node/node.py": {
            "chain": "_handle_snapshot: the flagged pre-await read of "
            "self.chain sits in early-returning branches "
            "(_request_blocks fallbacks), and the post-await writer "
            "(_adopt_snapshot) RE-VALIDATES after the scheduling "
            "point — validation_state, _bg_chain, and snapshot-vs-"
            "height are all re-read before the install, the safe "
            "shape the rule's docstring names",
        },
    },
    "wire-contract": {
        # EMPTY and should stay so: a grant here would bless a frame
        # type with a hole in its encoder/decoder/dispatch/admission/
        # shed/version contract.  The only legitimate tenant is a
        # frame mid-introduction across two commits, removed when the
        # second half lands.
    },
}
