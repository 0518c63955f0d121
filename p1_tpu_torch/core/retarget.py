"""Difficulty retargeting: the consensus rule that keeps block spacing.

The port's copy of ``p1_tpu/core/retarget.py``, unchanged: the rule is
pure Python and part of chain identity, so both packages must agree on
it to the bit.  Its text, from the reference:

Capability parity: BASELINE.json's configs pin difficulty per run (16..28),
so fixed difficulty stays the default everywhere — but a "Bitcoin-like toy
cryptocurrency" (BASELINE.json:5) whose difficulty can never move is only
half a consensus engine, so retargeting ships as an **opt-in chain
parameter**.  Design (Bitcoin's shape, bit-granular):

- Every ``window`` blocks, compare the observed span of the last window
  against ``spacing * (window - 1)`` (window blocks bound window-1
  intervals — honoring, not repeating, Bitcoin's famous 2015/2016
  off-by-one) and move the difficulty by whole bits: one bit per 2x
  deviation, clamped to ``max_adjust`` bits per retarget (Bitcoin clamps
  the timespan 4x = our default 2 bits).  Difficulty here is "required
  leading zero bits" (core/header.py), so ±1 bit is exactly ±2x work —
  integer comparisons only, no floats anywhere near consensus.
- The rule's parameters are **committed into the genesis block**
  (core/genesis.py): two chains with different rules have different chain
  ids, so the HELLO handshake and chain-bound transaction signatures
  enforce rule agreement with no extra protocol surface.
- Timestamp rules, both directions (enforced at connect time in
  chain/chain.py), with consensus kept a pure function of the block DAG
  (SURVEY §5 determinism — no wall-clock future bound anywhere):

  * **Backward**: timestamps must strictly increase, so the observed
    span is positive — and backdating is unprofitable anyway, since
    claiming a shorter span only *raises* the difficulty.
  * **Forward**: a block may claim at most ``max_step * spacing``
    seconds above its parent.  Without this cap, forward-dating is the
    profitable direction: a miner closing a window with one inflated
    timestamp claims an arbitrarily long span and buys ``max_adjust``
    bits of easier difficulty, and doing it repeatedly ratchets the
    difficulty to 1 (VERDICT r4 — the attack simulation in
    tests/test_retarget.py reproduces the collapse at 10% hashrate
    uncapped).  With the cap, fake time must be accumulated block by
    block.  The honest-contribution subtlety (measured in the same
    simulation, and the reason the naive threshold is wrong): once any
    inflated stamp lands, strict-increase forces every later honest
    block to stamp parent+1, so honest blocks stop contributing real
    time to spans entirely — the attacker's own surplus must carry the
    whole forgery, ~alpha * window * max_step * spacing per window,
    and holding even one easier bit needs that to exceed ~2x the
    expected span: **sustained-forgery threshold alpha* ~= 2 /
    max_step of the hashrate**.  At the default ``max_step=4`` the
    simulation shows a 25% attacker held to the honest equilibrium
    (time-average within a bit) while collapse requires ~40%+ —
    near-majority hashrate, where the chain is already reorg-attackable
    and no timestamp rule can save it.  Honest cost of the cap: a block
    that genuinely took > 4x spacing gets a truncated stamp
    (probability e^-4 ~= 1.8% at equilibrium, negligible span effect),
    and a dormant chain's difficulty decays toward a returning
    hashrate at max_adjust bits per window instead of instantly.

  This is the strongest bound a WALL-CLOCK-FREE rule can offer: with
  consensus a pure function of the block DAG, "time" ultimately IS
  what the majority of stamps say (Bitcoin bounds forward-dating with
  its +2h network-time rule — a wall clock — for exactly this reason).
  DAG-purity buys deterministic replay and testability at that price,
  and the cap prices the residual attack at near-majority hashrate.

Resolution floor, observed live: timestamps are integer seconds and
must strictly increase, so when real blocks arrive faster than 1/s the
chain clock advances +1 s per block regardless of real time — a window
of W blocks then spans ~W seconds and a rule with ``spacing`` near 1
reads perfect pacing forever, never adjusting.  Retargeting only
regulates block rates at or below ~1 block/second; pick ``spacing``
comfortably above 1 (and expect the rule to RAISE difficulty until real
spacing exceeds a second before it can see anything).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RetargetRule:
    """Opt-in difficulty adjustment parameters (a chain-identity field)."""

    window: int  # blocks per retarget period
    spacing: int  # target seconds between blocks
    max_adjust: int = 2  # max bits moved per retarget (2 bits = Bitcoin's 4x)
    #: Per-block timestamp-increment cap, in multiples of ``spacing`` —
    #: the forward-dating bound (module docstring).  4 puts the
    #: sustained-forgery threshold at ~2/max_step = half the hashrate
    #: (simulation: 25% attackers held, collapse needs ~40%+) while
    #: truncating only e^-4 ≈ 1.8% of honest blocks.  Part of chain
    #: identity like the rest.
    max_step: int = 4

    def __post_init__(self) -> None:
        # Upper bounds are consensus sanity AND native-engine safety: the
        # C++ verifier ring-buffers `window` timestamps and does int64
        # span arithmetic (spacing * window * 2^max_adjust must not
        # overflow), and it is built -fno-exceptions, where a gigantic
        # allocation would abort the process instead of raising.
        if not 2 <= self.window <= 1_000_000:
            raise ValueError("retarget window must be in 2..1_000_000 blocks")
        if not 1 <= self.spacing <= 31_536_000:  # one year per block, max
            raise ValueError("target spacing must be in 1..31_536_000 seconds")
        if not 1 <= self.max_adjust <= 8:
            raise ValueError("max_adjust must be in 1..8 bits")
        if not 2 <= self.max_step <= 1024:
            raise ValueError("max_step must be in 2..1024 spacings")

    @property
    def max_increment(self) -> int:
        """Largest valid ``timestamp - parent.timestamp`` in seconds."""
        return self.max_step * self.spacing

    def timestamp_violation(
        self, parent_height: int, parent_ts: int, ts: int
    ) -> str | None:
        """The ONE home of the timestamp consensus rule (reason string,
        or None if valid) — connect-time validation, the light-client
        replay verifier, and the miner's clamp all delegate here so the
        three can never diverge (the from_params convention).

        Strict increase always; the forward cap from height 2 on.
        Height 1 is exempt: genesis carries a fixed timestamp (chain
        identity), so the first block must be free to anchor the chain
        clock at the real bootstrap time — see the module docstring and
        the MINING-POLICY guard in node.py that keeps a hostile anchor
        from being extended."""
        if ts <= parent_ts:
            return "timestamp does not increase over parent"
        delta = ts - parent_ts
        if parent_height >= 1 and delta > self.max_increment:
            return (
                f"timestamp advances {delta}s over parent, cap is "
                f"{self.max_increment}s"
            )
        return None

    def clamp_timestamp(
        self, parent_height: int, parent_ts: int, ts: int
    ) -> int:
        """The largest consensus-valid stamp not exceeding ``ts`` for a
        child of (parent_height, parent_ts) — what an honest assembler
        uses when its wall clock runs past the cap."""
        ts = max(ts, parent_ts + 1)
        if parent_height >= 1:
            ts = min(ts, parent_ts + self.max_increment)
        return ts

    @classmethod
    def from_params(
        cls, window: int, spacing: int
    ) -> "RetargetRule | None":
        """The ONE home of flag/config-pair validation: both must be set
        together; (0, 0) selects fixed difficulty (None).  CLI and
        NodeConfig both delegate here so the wallet and node paths can
        never diverge on what chain a flag pair names."""
        if bool(window) != bool(spacing):
            raise ValueError(
                "--retarget-window and --target-spacing must be set together"
            )
        return cls(window, spacing) if window else None

    @property
    def expected_span(self) -> int:
        """Target seconds for one whole window (window-1 intervals)."""
        return self.spacing * (self.window - 1)

    def adjusted(self, parent_difficulty: int, span: int) -> int:
        """The difficulty for the block that opens a new window, given the
        observed ``span`` of the window just closed.  Integer-only: one
        bit harder per halving of the expected span, one bit easier per
        doubling, clamped to ``max_adjust`` and to the 1..255 range the
        header can express (difficulty 0 would make every hash valid)."""
        span = max(1, span)
        adj = 0
        while adj < self.max_adjust and span * (2 << adj) <= self.expected_span:
            adj += 1
        if adj == 0:
            while adj > -self.max_adjust and span >= (2 << (-adj)) * self.expected_span:
                adj -= 1
        return min(255, max(1, parent_difficulty + adj))
