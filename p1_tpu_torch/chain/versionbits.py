"""BIP9-analog version-bits: in-place protocol evolution by miner signal.

Leg (d) of the always-on node: a deployed feature activates on
a RUNNING mesh — no flag-day restart — by miners signaling readiness in
the header ``version`` field they already mine, with activation decided
by a pure function of the header chain so every node that has the same
headers reports the same state at the same height.

The state machine is Bitcoin's BIP9 shape, per deployment:

- **DEFINED** until the window containing ``start_height`` begins;
- **STARTED** from there: miners aware of the deployment set its bit;
- **LOCKED_IN** once a completed window carries >= ``threshold``
  signaling headers (checked before the timeout each boundary — the
  "speedy trial" ordering, so a window that both crosses the timeout
  and meets the threshold still locks in);
- **ACTIVE** one full window after LOCKED_IN (the grace period
  stragglers get to upgrade);
- **FAILED** permanently if the timeout window starts first.

Signaling uses the BIP9 top-bits convention: ``version`` =
``TOP_BITS | (1 << bit)`` per signaled deployment.  ``TOP_BITS``
(0x20000000) distinguishes a version-bits header from the legacy
``version=1`` every header before version bits carries — a legacy header
signals nothing, and ``mining_version`` returns literal 1 when no
deployments are configured, so a node with an empty deployment table
produces byte-identical traces to every earlier round.

**What activation does NOT do here**: header ``version`` is not a
consensus field (core/validate.py checks PoW/merkle/signatures, never
version), and activation adds no retroactive validity rule — so a mixed
mesh can NEVER fork on version bits alone, by construction.  That
no-fork property is exactly what the ``version_activation`` scenario
(node/scenarios.py) pins with an impossible-bound control.  Activation
is the coordination layer: what feature a node advertises, mines with,
and reports — the wire-contract rule (``p1 lint``) keeps the frame
catalog exhaustively versioned underneath it.

State is computed per window boundary and memoized by (deployment,
boundary block hash): a reorg across a boundary lands on a different
boundary hash and recomputes, while steady-state queries are a dict
hit.  Headers below an assumed/re-based chain's base are unknowable;
the walk treats them as non-signaling, which only ever DELAYS lock-in
(conservative, documented in the node's maintenance report).

The port's copy of ``p1_tpu/chain/versionbits.py``: the same states at the
same heights on the same headers.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = [
    "Deployment",
    "TOP_BITS",
    "TOP_MASK",
    "VBState",
    "VersionBits",
    "signals",
]

#: BIP9 top-bits: the high 3 bits of a signaling header's version must
#: be exactly 001.  Legacy headers (version=1) never match.
TOP_BITS = 0x20000000
TOP_MASK = 0xE0000000


class VBState(enum.Enum):
    DEFINED = "defined"
    STARTED = "started"
    LOCKED_IN = "locked_in"
    ACTIVE = "active"
    FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class Deployment:
    """One named feature deployment.

    ``bit`` is the version bit miners set while STARTED/LOCKED_IN
    (0..28 — bits 29..31 are the top-bits tag).  ``start_height`` /
    ``timeout_height`` bound the signaling period in heights (BIP9 uses
    median-time-past; heights are this chain's deterministic analog —
    the sim's virtual clocks make time-based bounds unreproducible)."""

    name: str
    bit: int
    start_height: int
    timeout_height: int

    def __post_init__(self):
        if not 0 <= self.bit <= 28:
            raise ValueError(f"deployment bit {self.bit} outside 0..28")
        if self.timeout_height <= self.start_height:
            raise ValueError(
                f"{self.name}: timeout {self.timeout_height} <= "
                f"start {self.start_height}"
            )


def signals(version: int, bit: int) -> bool:
    """True when a header ``version`` signals ``bit`` under the
    top-bits convention."""
    return (version & TOP_MASK) == TOP_BITS and bool(version & (1 << bit))


class VersionBits:
    """The per-chain activation engine: deployments + window/threshold,
    evaluated against a ``Chain``'s header index."""

    def __init__(
        self,
        deployments: tuple[Deployment, ...],
        window: int,
        threshold: int,
    ):
        if window < 1:
            raise ValueError("window must be >= 1")
        if not 1 <= threshold <= window:
            raise ValueError(
                f"threshold {threshold} outside 1..window({window})"
            )
        bits = [d.bit for d in deployments]
        if len(set(bits)) != len(bits):
            raise ValueError("deployments share a version bit")
        self.deployments = tuple(deployments)
        self.window = window
        self.threshold = threshold
        #: (deployment name, boundary block hash) -> state.  Bounded by
        #: O(deployments x boundaries actually queried); reorgs change
        #: the boundary hash, so stale entries are simply never hit.
        self._cache: dict[tuple[str, bytes], VBState] = {}

    # -- state machine -----------------------------------------------------

    def state_for_next(self, chain, prev_hash: bytes, dep: Deployment) -> VBState:
        """The deployment's state governing the block that would be
        mined ON ``prev_hash`` — a pure function of the header chain up
        to ``prev_hash`` (every node agrees given the same headers).

        BIP9 evaluates state per retarget period; here the state is
        constant across each ``window``-aligned height span and
        transitions only at boundaries, evaluated by walking completed
        windows from the deployment's start.
        """
        entry_height = chain.height_of(prev_hash) + 1
        boundary = entry_height - (entry_height % self.window)
        # Walk prev_hash back to the boundary's last header (height
        # boundary-1); headers are always resident, O(window).
        bh = prev_hash
        h = entry_height - 1
        while h >= boundary:
            hdr = chain.header_of(bh)
            if hdr is None:
                return VBState.DEFINED  # below the base: unknowable
            bh = hdr.prev_hash
            h -= 1
        return self._state_at_boundary(chain, boundary, bh, dep)

    def _state_at_boundary(
        self, chain, boundary: int, last_hash: bytes, dep: Deployment
    ) -> VBState:
        """State for the window starting at ``boundary``, whose parent
        chain ends at ``last_hash`` (the height ``boundary - 1`` block,
        or the below-base sentinel when the walk fell off the index).
        Recurses boundary-by-boundary toward the deployment start;
        memoized per (deployment, boundary hash)."""
        if boundary < self.window or boundary <= dep.start_height - self.window:
            # Before any window wholly past start can complete —
            # genesis-adjacent or pre-start: DEFINED unless started.
            if boundary >= dep.start_height:
                return (
                    VBState.FAILED
                    if boundary >= dep.timeout_height
                    else VBState.STARTED
                )
            return VBState.DEFINED
        key = (dep.name, last_hash)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        # Walk the just-completed window [boundary - window, boundary)
        # counting signals, and find the previous boundary's last hash.
        count = 0
        bh = last_hash
        truncated = False
        for _ in range(self.window):
            hdr = chain.header_of(bh)
            if hdr is None:
                truncated = True  # window crosses the base: count what we saw
                break
            if signals(hdr.version, dep.bit):
                count += 1
            bh = hdr.prev_hash
        prev_boundary = boundary - self.window
        prev = self._state_at_boundary(chain, prev_boundary, bh, dep)
        if prev is VBState.DEFINED:
            if boundary >= dep.timeout_height:
                state = VBState.FAILED
            elif boundary >= dep.start_height:
                state = VBState.STARTED
            else:
                state = VBState.DEFINED
        elif prev is VBState.STARTED:
            # Threshold before timeout at each boundary (speedy-trial
            # ordering): a window meeting both locks in.
            if count >= self.threshold and prev_boundary >= dep.start_height:
                state = VBState.LOCKED_IN
            elif boundary >= dep.timeout_height:
                state = VBState.FAILED
            else:
                state = VBState.STARTED
        elif prev is VBState.LOCKED_IN:
            state = VBState.ACTIVE
        else:  # ACTIVE / FAILED are terminal
            state = prev
        if not truncated:
            self._cache[key] = state
        return state

    # -- the two consumers -------------------------------------------------

    def mining_version(self, chain, prev_hash: bytes) -> int:
        """The ``version`` a block mined on ``prev_hash`` should carry:
        top-bits plus every deployment bit currently worth signaling
        (STARTED or LOCKED_IN).  Literal 1 — the legacy constant every
        header before version bits carries — when no deployments are
        configured, so an empty table is byte-identical to history."""
        if not self.deployments:
            return 1
        version = TOP_BITS
        for dep in self.deployments:
            state = self.state_for_next(chain, prev_hash, dep)
            if state in (VBState.STARTED, VBState.LOCKED_IN):
                version |= 1 << dep.bit
        return version

    def states_report(self, chain) -> dict:
        """Per-deployment state at the current tip — the maintenance
        plane's JSON surface (``p1 maintain status``, MAINTAIN wire)."""
        out = {}
        for dep in self.deployments:
            state = self.state_for_next(chain, chain.tip_hash, dep)
            out[dep.name] = {
                "bit": dep.bit,
                "start_height": dep.start_height,
                "timeout_height": dep.timeout_height,
                "state": state.value,
            }
        return out
