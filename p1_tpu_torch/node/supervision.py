"""Request supervision: progress deadlines for multi-round fetches.

The robustness gap this closes: every multi-round
fetch the node performs — locator block sync, the compact-block
GETBLOCKTXN round, paged mempool sync, the light client's headers loop —
was re-requested from the single peer that triggered it, forever.  The
liveness layer (node.py's probe/evict loop) only proves a peer is
*talking*; a peer that answers PINGs, or trickles bytes above the
MIN_FRAME_RATE floor, or serves syntactically valid replies that never
advance the chain, stays comfortably under that bar while pinning a fresh
node's catch-up indefinitely.  Bitcoin-family nodes carry a second,
sharper deadline for exactly this (the stalling-sync-peer timeout behind
headers-first IBD): *progress*, not liveness, is what buys a sync peer
its slot.

``RequestSupervisor`` is that deadline as a reusable state machine:

- one in-flight **target** (an opaque peer key) with a progress deadline
  — ``stalled()`` fires when the job has advanced nothing (blocks
  accepted, headers appended, pages consumed — the OWNER defines
  progress and calls ``progress()``) within ``stall_timeout_s``;
- a **jittered exponential backoff** between failovers (``record_stall``
  arms it, ``ready()`` gates the re-issue) so a mesh of recovering nodes
  doesn't re-ask in lockstep;
- a **bounded attempt budget**: ``attempts_max`` failovers per episode,
  reset whenever real progress lands (a live sync is not a failing one).

It is a pure state machine over an injectable clock and RNG (testable
without sleeping), and deliberately knows nothing about peers, sockets,
or messages: the owner decides who is eligible, performs the send, and —
critically — *demotes rather than bans* the staller.  Slowness is not a
protocol violation; the staller keeps its connection and merely loses
sync-peer priority (node.py's ``_Peer.sync_demerits``).

The port's copy of ``p1_tpu/node/supervision.py``.
"""

from __future__ import annotations

import random
import secrets
import time

__all__ = ["RequestSupervisor", "SyncStalled"]

#: Default jitter band applied to every backoff delay: the computed delay
#: is scaled by a uniform draw from [0.5, 1.5).  Wide enough that two
#: nodes failing over off the same staller won't re-issue in lockstep.
_JITTER_LO = 0.5
_JITTER_SPAN = 1.0


class SyncStalled(ConnectionError):
    """A supervised fetch ran out of failover attempts: every eligible
    target stalled past its progress deadline.  A ``ConnectionError``
    subclass so existing callers that already handle dead-peer errors
    (CLI commands, retry loops) treat exhaustion the same way."""


class RequestSupervisor:
    """Progress-deadline bookkeeping for ONE multi-round fetch job.

    The owner drives it::

        sup.begin(peer)          # request sent; the deadline arms
        sup.progress()           # the job advanced; deadline + budget reset
        if sup.stalled():        # deadline expired with no progress
            delay = sup.record_stall()   # count it, arm jittered backoff
            ...pick a DIFFERENT target, wait sup.ready(), re-issue...
        sup.idle()               # job complete; nothing in flight

    All methods are synchronous and O(1); the owner polls from its own
    tick loop (node.py's ``_supervision_loop``) or wraps awaits in
    timeouts (client.py's headers fetch).
    """

    def __init__(
        self,
        *,
        stall_timeout_s: float,
        attempts_max: int,
        backoff_base_s: float = 0.25,
        backoff_max_s: float = 5.0,
        clock=time.monotonic,
        rng: random.Random | None = None,
    ):
        self.stall_timeout_s = float(stall_timeout_s)
        self.attempts_max = int(attempts_max)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._clock = clock
        # The fallback seeds EXPLICITLY from OS entropy: production
        # jitter wants real randomness, but a bare random.Random() says
        # so only by omission — and the unseeded-rng lint rule can't
        # tell intent from a forgotten seed.  Simulated paths must pass
        # a seeded rng (the node wires config.rng_seed through here).
        self._rng = rng if rng is not None else random.Random(secrets.randbits(64))
        #: Opaque key of the peer the in-flight request targets (None =
        #: nothing supervised right now).
        self.target = None
        self._since: float | None = None
        self._retry_at = 0.0
        #: Failovers charged against the current episode (reset by
        #: progress — only *consecutive* stalls exhaust the budget).
        self.attempts = 0
        #: Lifetime stall count (telemetry; never reset).
        self.stalls = 0

    # -- owner signals ---------------------------------------------------

    def begin(self, target) -> None:
        """A request is now in flight against ``target``; arm the
        progress deadline.  Re-targeting an active job just moves the
        deadline — the job is one catch-up episode, not one request."""
        self.target = target
        self._since = self._clock()

    def progress(self) -> None:
        """The job advanced.  Resets the deadline AND the attempt budget:
        a sync that keeps landing blocks — however slowly — is healthy,
        and must never exhaust its budget by accumulating ancient
        stalls (the honest-slow-peer guarantee)."""
        if self.target is not None:
            self._since = self._clock()
        self.attempts = 0

    def idle(self) -> None:
        """The job completed (or its trigger evaporated): stop
        supervising until the next ``begin``."""
        self.target = None
        self._since = None

    # -- owner queries ---------------------------------------------------

    @property
    def active(self) -> bool:
        return self.target is not None

    def stalled(self) -> bool:
        """True when the in-flight request has outlived its progress
        deadline."""
        return (
            self._since is not None
            and self._clock() - self._since > self.stall_timeout_s
        )

    def exhausted(self) -> bool:
        """True when the episode's failover budget is spent."""
        return self.attempts >= self.attempts_max

    def ready(self) -> bool:
        """True when the backoff armed by the last ``record_stall`` has
        elapsed — the gate on re-issuing the request."""
        return self._clock() >= self._retry_at

    def record_stall(self) -> float:
        """Count one stall: charge an attempt, clear the in-flight
        target, and arm a jittered exponential backoff.  Returns the
        delay until ``ready()`` — callers that sleep (the headers client)
        use it directly; pollers (the node loop) just re-check."""
        self.stalls += 1
        self.attempts += 1
        # Exponent clamped: a caller that disables exhaustion (the store
        # recovery loop runs with attempts_max effectively infinite) can
        # accumulate thousands of attempts, and 2**attempts would
        # overflow the int->float conversion long before the min() could
        # discard it.  Past the clamp the delay is backoff_max_s anyway.
        delay = min(
            self.backoff_max_s,
            self.backoff_base_s * (2.0 ** min(self.attempts - 1, 60)),
        )
        delay *= _JITTER_LO + _JITTER_SPAN * self._rng.random()
        self._retry_at = self._clock() + delay
        self.idle()
        return delay
