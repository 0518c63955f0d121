"""Staged block pipeline: off-loop validate/store lanes.

The node's block lifecycle is five stages — wire framing → admission →
validation → store → relay.  Framing, admission, and relay are pure
event-loop work (parse a length-prefixed frame, charge a token bucket,
fan a payload out to peer write queues) and stay on the loop.  The two
CPU/IO-heavy stages move here:

- **validate**: batched Ed25519 pre-verification (core/keys.py): in the
  port, the ``device`` rung's ``ed25519_msm.cu`` launches, called from
  the lane thread, so the loop keeps serving while a window verifies
  (this module only moves the *call site* off the loop).
- **store**: every granted fsync chain — append, batch-close sync,
  prune-base sidecar flips, mempool/addr checkpoints, snapshot flips —
  runs on a dedicated single-thread writer lane.  One thread owns the
  flocked append fd, so the store's single-writer discipline and append
  ordering survive unchanged (the lane's queue IS the append order).

``workers == 0`` (the default) disables staging: ``run_validate`` /
``run_store`` call the function inline with **no awaits**, so the
scheduling behavior is byte-identical to the historical inline node.
``workers >= 1`` submits through ``loop.run_in_executor``.  Under the
network simulator this is STILL synchronous — ``SimLoop.run_in_executor``
resolves the future inline (netsim.py) — which is what makes the sim
trace digest byte-identical with staging on or off at 1 worker: the
determinism proof is by construction, not by test luck.

Hand-off is zero-copy: stage functions receive the same ``bytes`` /
``memoryview`` objects the wire frame decoded into (the packed plane
never re-encodes between stages); ``nbytes`` only *accounts* those
buffers against the governor gauge while a job is in flight, it never
copies them.

Supervision: a lane worker that dies mid-job (the chaos injector's
``fail_next`` seam, or a pool whose thread was torn down under it)
raises ``WorkerCrash``; the pipeline respawns the lane's pool, counts
the respawn, and retries the job once — mirroring the node task
supervisor's crash-count-and-restart lineage (NodeMetrics.task_crashes).

The port's copy of ``p1_tpu/node/pipeline.py``.
"""

from __future__ import annotations

import concurrent.futures
import threading
from concurrent.futures import ThreadPoolExecutor

import asyncio

STAGES = ("frame", "admission", "validate", "store", "relay")

#: Stages with an off-loop lane (the other three live on the event loop
#: and can only "crash" by the whole process dying — the chaos injector
#: maps those stage-crash events to process crashes).
LANE_STAGES = ("validate", "store")


class WorkerCrash(RuntimeError):
    """A pipeline lane worker died mid-job (injected or real)."""


class _Lane:
    """One off-loop stage: a single-thread pool plus depth accounting.

    ``max_workers=1`` is a correctness choice, not a tuning default: the
    lane's FIFO queue is what preserves per-peer arrival order through
    the validate stage and append order through the store stage.
    Parallelism comes from *inside* the jobs (the verify pool fans one
    preverify batch across cores), never from concurrent lane jobs.
    """

    def __init__(self, name: str, workers: int):
        self.name = name
        self.workers = workers
        self.pool: ThreadPoolExecutor | None = (
            self._make_pool() if workers > 0 else None
        )
        self.depth = 0  # jobs submitted and not yet finished
        self.queued_bytes = 0  # payload bytes those jobs reference
        self.jobs = 0  # lifetime jobs (telemetry)
        self.respawns = 0  # worker deaths survived
        self.fail_next = False  # chaos seam: next job dies
        self.alive = True

    def _make_pool(self) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"p1-{self.name}"
        )

    def respawn(self) -> None:
        if self.pool is not None:
            # wait=False: the dead worker has nothing left to run, and
            # the respawn happens on the event loop — never block it.
            self.pool.shutdown(wait=False)
        if self.workers > 0:
            self.pool = self._make_pool()
        self.respawns += 1
        self.alive = True


class NodePipeline:
    """Validate/store lanes with governor-visible depth accounting.

    The node owns exactly one; stages call ``run_validate`` /
    ``run_store`` with a plain synchronous function and its arguments.
    The function runs off-loop when staging is on, inline when off —
    callers never branch on the mode.
    """

    def __init__(self, workers: int = 0, on_respawn=None):
        self.workers = workers
        self._lanes = {name: _Lane(name, workers) for name in LANE_STAGES}
        #: Called with the lane name after a worker respawn (the node
        #: wires this to NodeMetrics so crashes are counted, per the
        #: task-supervisor lineage).
        self.on_respawn = on_respawn
        # Guards respawn against the (loop thread, lane thread) pair
        # both observing a broken pool; cheap and uncontended.
        self._respawn_lock = threading.Lock()

    # -- introspection ------------------------------------------------

    @property
    def staged(self) -> bool:
        return self.workers > 0

    @property
    def queued_bytes(self) -> int:
        """Bytes referenced by in-flight lane jobs (governor gauge)."""
        return sum(lane.queued_bytes for lane in self._lanes.values())

    def depths(self) -> dict[str, int]:
        return {name: lane.depth for name, lane in self._lanes.items()}

    def status(self) -> dict:
        """The ``status()["pipeline"]`` block: depths + worker liveness."""
        return {
            "workers": self.workers,
            "validate_depth": self._lanes["validate"].depth,
            "store_depth": self._lanes["store"].depth,
            "queued_bytes": self.queued_bytes,
            "validate_alive": self._lanes["validate"].alive,
            "store_alive": self._lanes["store"].alive,
        }

    # -- chaos seam ---------------------------------------------------

    def fail_next(self, stage: str) -> None:
        """Arm a one-shot worker death on ``stage``'s next job.

        The chaos injector's stage-boundary crash corpus uses this for
        the off-loop stages; it also fires at ``workers == 0`` so the
        respawn accounting is exercised identically in the sim.
        """
        self._lanes[stage].fail_next = True

    # -- stage entry points -------------------------------------------

    async def run_validate(self, fn, *args, nbytes: int = 0):
        return await self._run(self._lanes["validate"], fn, args, nbytes, False)

    async def run_store(self, fn, *args, nbytes: int = 0, offload: bool = False):
        """``offload=True``: keep the job off-loop even at ``workers == 0``
        (via the loop's default executor — what ``asyncio.to_thread``
        did).  For call sites that were ALREADY threaded before staging
        (the mempool checkpoint) and must not regress onto the loop when
        staging is off; under the simulator both paths are synchronous,
        so the determinism contract is unaffected."""
        return await self._run(self._lanes["store"], fn, args, nbytes, offload)

    async def _run(self, lane: _Lane, fn, args, nbytes: int, offload: bool):
        lane.depth += 1
        lane.queued_bytes += nbytes
        lane.jobs += 1
        try:
            try:
                return await self._submit(lane, fn, args, offload)
            except WorkerCrash:
                self._respawn(lane)
                # Retry once: a worker death must not lose the job (the
                # store lane's job IS the durability chain).  A second
                # crash propagates to the caller's error path.
                return await self._submit(lane, fn, args, offload)
        finally:
            lane.depth -= 1
            lane.queued_bytes -= nbytes

    async def _submit(self, lane: _Lane, fn, args, offload: bool = False):
        if lane.pool is None:
            if offload:
                loop = asyncio.get_running_loop()
                return await loop.run_in_executor(
                    None, self._call, lane, fn, args
                )
            # Staging off: inline, no awaits — scheduling-identical to
            # the historical single-threaded node.
            return self._call(lane, fn, args)
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(
                lane.pool, self._call, lane, fn, args
            )
        except concurrent.futures.BrokenExecutor as e:
            raise WorkerCrash(f"{lane.name} worker pool broken") from e
        except RuntimeError as e:
            # submit() on a shut-down pool — the real-world shape of a
            # dead worker (TaskStop, interpreter teardown races).
            if "shutdown" in str(e) or "interpreter" in str(e):
                raise WorkerCrash(f"{lane.name} worker pool dead") from e
            raise

    def _call(self, lane: _Lane, fn, args):
        if lane.fail_next:
            lane.fail_next = False
            lane.alive = False
            raise WorkerCrash(f"injected {lane.name} worker death")
        return fn(*args)

    def _respawn(self, lane: _Lane) -> None:
        with self._respawn_lock:
            lane.respawn()
        if self.on_respawn is not None:
            self.on_respawn(lane.name)

    # -- lifecycle ----------------------------------------------------

    def drain_and_close(self) -> None:
        """Flush queued lane jobs and release the worker threads.

        ``shutdown(wait=True)`` runs everything already submitted — the
        store lane's queue drains in append order before the node closes
        the store, so stop() never races its own writer.
        """
        for lane in self._lanes.values():
            if lane.pool is not None:
                lane.pool.shutdown(wait=True)
                lane.pool = None
            lane.alive = False
