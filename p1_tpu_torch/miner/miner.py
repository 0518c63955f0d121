"""``Miner.search_nonce()``: the proof-of-work search loop.

The port of ``p1_tpu/miner/miner.py``, unchanged in behaviour: the miner
asks its ``HashBackend`` to scan a *chunk* of nonce space per call (the
``cuda`` backend pipelines kernel steps within a chunk), checks the abort
signal between chunks so a new chain tip cancels stale work promptly, and
rolls the header timestamp to reopen the nonce space when all 2**32
candidates are exhausted.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.hashx.backend import HashBackend, get_backend

NONCE_SPACE = 1 << 32


@dataclasses.dataclass
class MineStats:
    """Counters from one ``search_nonce`` call (metrics surface)."""

    hashes_done: int = 0
    elapsed_s: float = 0.0
    timestamp_rolls: int = 0
    aborted: bool = False

    @property
    def hashes_per_sec(self) -> float:
        return self.hashes_done / self.elapsed_s if self.elapsed_s > 0 else 0.0


class Miner:
    """Drives a ``HashBackend`` over nonce space to seal block headers.

    ``backend`` is a backend or a registry name; a name is resolved with
    ``device`` when one is given (``Miner(device="cpu")`` is the ``cuda``
    backend's plain version on the CPU; ``Miner()`` runs on the card).

    ``chunk`` is the number of nonces requested per backend call — the abort
    granularity.  ``chunk=None`` derives 4x the backend's ``step_span`` (the
    nonces one device step covers) when it has one, keeping the pipeline
    full, else a CPU-friendly 2**22.
    """

    def __init__(
        self,
        backend: str | HashBackend = "cuda",
        chunk: int | None = None,
        max_timestamp_rolls: int | None = None,
        device: str | None = None,
    ):
        if isinstance(backend, str):
            kwargs = {} if device is None else {"device": device}
            backend = get_backend(backend, **kwargs)
        self.backend = backend
        if chunk is None:
            span = getattr(self.backend, "step_span", None)
            chunk = 4 * span if span else 1 << 22
        if chunk <= 0:
            raise ValueError("chunk must be positive")
        self.chunk = chunk
        self.max_timestamp_rolls = max_timestamp_rolls
        self.last_stats = MineStats()

    def search_nonce(
        self,
        header: BlockHeader,
        abort: threading.Event | None = None,
        start_nonce: int = 0,
    ) -> BlockHeader | None:
        """Find a sealed header whose hash meets ``header.difficulty``.

        Returns the input header with the winning nonce (and possibly a
        rolled timestamp) attached, or None if ``abort`` was set first.
        The search is deterministic for a given header: nonce space is
        scanned in increasing order from ``start_nonce``, so the earliest
        valid nonce at the original timestamp is always preferred.
        """
        stats = MineStats()
        self.last_stats = stats
        t0 = time.perf_counter()
        try:
            while True:
                prefix = header.mining_prefix()
                nonce = start_nonce
                while nonce < NONCE_SPACE:
                    if abort is not None and abort.is_set():
                        stats.aborted = True
                        return None
                    count = min(self.chunk, NONCE_SPACE - nonce)
                    res = self.backend.search(prefix, nonce, count, header.difficulty)
                    stats.hashes_done += res.hashes_done
                    if res.nonce is not None:
                        return header.with_nonce(res.nonce)
                    nonce += count
                # Nonce space exhausted: roll the timestamp and rescan.
                if (
                    self.max_timestamp_rolls is not None
                    and stats.timestamp_rolls >= self.max_timestamp_rolls
                ):
                    return None
                stats.timestamp_rolls += 1
                header = header.with_timestamp(header.timestamp + 1)
                start_nonce = 0
        finally:
            stats.elapsed_s = time.perf_counter() - t0
