"""Pod failure handling: the no-progress watchdog and leader failover.

The port of ``p1_tpu/parallel/watchdog.py``: the process-level failsafes
``python -m p1_tpu_torch pod`` arms around the lockstep mesh — a follower
that loses the pod exits 3 for its supervisor; the leader re-execs itself
into single-process mining on the same store so the chain never goes dark.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

#: The documented supervisor signal: a pod process that lost its mesh
#: exits with this code (``Restart=on-failure`` restarts it once the
#: coordinator is back).  ONE constant shared by the watchdog trip and
#: the follower's dead-collective exit so the two paths can never drift.
POD_LOST_EXIT = 3


def grace_s() -> float:
    """The longest legitimate gap between lockstep points, in seconds:
    ``P1_POD_GRACE_S`` (the JAX package's name, so an operator's
    supervisor settings carry over), default 600."""
    return float(os.environ.get("P1_POD_GRACE_S", "600"))


class PodWatchdog:
    """No-progress failsafe: a vanished pod peer leaves the survivor
    blocked inside a collective (or failing in every one), so if no
    lockstep point is reached for ``grace`` seconds the process fails
    over.  ``grace`` covers the longest LEGITIMATE inter-beat gap — the
    first search's kernel build plus one chunk — independent of run
    length (progress-based, not an absolute deadline).

    On trip the watchdog runs ``on_trip`` — the LEADER re-execs itself
    into a single-process node against the same store and identity
    (``pod_leader_failover``), while followers, whose chain state lives
    in the leader, exit ``POD_LOST_EXIT`` for their external supervisor
    to restart.  ``os._exit`` either way: a process wedged in a gloo
    collective, or holding a process group at interpreter exit, may
    never return.

    ``beat()`` is a plain monotonic-timestamp store (the hot path runs it
    per chunk); one long-lived daemon thread polls.
    """

    _POLL_S = 1.0

    def __init__(self, role: str, on_trip=None):
        self.role = role
        self.grace_s = grace_s()
        self._on_trip = on_trip
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()

    def cancel(self) -> None:
        self._stop.set()

    def _poll(self) -> None:
        while not self._stop.wait(self._POLL_S):
            if time.monotonic() - self._last > self.grace_s:
                logging.error(
                    "pod watchdog (%s): no lockstep progress for %.0fs "
                    "(peer lost?), failing over",
                    self.role,
                    self.grace_s,
                )
                if self._on_trip is not None:
                    try:
                        self._on_trip()
                    except Exception:
                        # A failed leader failover (os.execv can raise
                        # ENOMEM/E2BIG, or the interpreter path vanished)
                        # must still END the wedged process — the exit
                        # code is the supervisor's only signal.
                        logging.exception("pod failover failed")
                os._exit(POD_LOST_EXIT)  # followers, or a failed on_trip


def pod_leader_failover(args, deadline: float) -> None:
    """Degrade the pod leader to a single-process ``node`` when a pod peer
    vanishes.

    ``os.execv`` replaces the wedged process image in place: the thread
    stuck in the dead collective, the process group and its sockets all
    go with it, while the pid (for the operator) and the environment
    survive.  The store's writer flock is released automatically — Python
    opens files close-on-exec — so the SAME process re-acquires the SAME
    store and mining continues on the persisted chain with the same
    coinbase identity and peer list, for the remainder of the original
    window.  A leader configured with ``--port 0`` re-binds a fresh
    ephemeral port; pinned ports are re-bound exactly.
    """
    argv = [
        sys.executable, "-m", "p1_tpu_torch", "node",
        "--difficulty", str(args.difficulty),
        "--backend", "sharded",  # this process's own mesh: no process group
        "--device", args.device,
        "--host", args.host,
        "--port", str(args.port),
        "--duration", f"{max(5.0, deadline - time.time()):.1f}",
    ]  # fmt: skip
    if args.peers:
        argv += ["--peers", *args.peers]
    if args.miner_id:
        argv += ["--miner-id", args.miner_id]
    if args.store:
        argv += ["--store", args.store]
    if args.chunk:
        argv += ["--chunk", str(args.chunk)]
    if args.batch:
        argv += ["--batch", str(args.batch)]
    logging.error("pod leader failing over to solo mining: %s", " ".join(argv))
    sys.stderr.flush()
    os.execv(sys.executable, argv)
