"""The pipelined host loop shared by device-stepped backends.

The port of ``PipelinedSearchMixin`` (``p1_tpu/hashx/jax_backend.py:66``):
the same opening ramp, the same one-step-deep pipeline and the same host
masking of a partial final step, so a port backend and its reference
counterpart issue the same sequence of step spans for the same scan.

Where JAX's async dispatch plus a late ``int(np.asarray(idx))`` gave the
pipeline for free, here each CUDA step's 4-byte result is copied without
blocking into pinned host memory and a ``torch.cuda.Event`` is recorded
behind the copy; ``_drain_one`` waits on that event only after the next
step has been enqueued.  ``.item()`` on the device tensor would synchronise
the whole stream at once and empty the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from p1_tpu_torch.core.header import target_from_difficulty, target_to_words
from p1_tpu_torch.hashx.backend import SearchResult
from p1_tpu_torch.hashx.sha256_ref import header_midstate, header_tail_words, sha256d


@dataclasses.dataclass(frozen=True)
class SearchArrays:
    """The per-search inputs of a step, in both forms a step reads.

    ``words`` is the 19-word host form (midstate 8, tail 3, target 8) that
    the CUDA kernel takes by value; ``midstate``/``tail``/``target`` are the
    int64 tensors on ``device`` that the plain version computes with.
    """

    words: tuple[int, ...]
    midstate: torch.Tensor
    tail: torch.Tensor
    target: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.midstate.device


def search_arrays(
    midstate: np.ndarray, tail: np.ndarray, target: np.ndarray, device: str | torch.device
) -> SearchArrays:
    """The port's step inputs from the three numpy ``uint32`` arrays that
    ``p1_tpu``'s ``_search_arrays`` builds: (8,), (3,) and (8,) words."""
    parts = [np.asarray(a, dtype=np.uint32) for a in (midstate, tail, target)]
    if [p.shape for p in parts] != [(8,), (3,), (8,)]:
        raise ValueError(f"expected (8,), (3,), (8,) words, got {[p.shape for p in parts]}")
    tensors = [torch.tensor(p.astype(np.int64), device=device) for p in parts]
    return SearchArrays(tuple(int(x) for p in parts for x in p), *tensors)


#: A step function: (SearchArrays, nonce_base) -> (1,) int32 tensor holding
#: the offset of the earliest hit in [nonce_base, nonce_base + span), or span.
StepFn = Callable[[SearchArrays, int], torch.Tensor]

#: Opening-ramp parameters, the reference's (``jax_backend.py:54-63``), so
#: a port backend ramps exactly where the reference does: the floor puts a
#: difficulty-20 hit (expected at ~2²⁰ nonces) in the first step with ~98%
#: probability; above difficulty 26 the opening steps almost never hit.
_RAMP_FLOOR = 1 << 22
_RAMP_FACTOR = 8
_RAMP_MAX_DIFFICULTY = 26


class PipelinedSearchMixin:
    """The host loop shared by every device-stepped backend.

    Subclasses provide ``step_span`` (nonces evaluated per full device step),
    ``device`` and ``_make_step(span)`` (a step function for a given span).
    ``search`` then scans an arbitrary range with a one-step pipeline and
    host-side masking of the partial final step, opening a fresh easy scan
    with the reference's geometric ramp from ``ramp_floor``.
    """

    step_span: int
    device: torch.device
    #: Smallest opening step; None disables the ramp.
    ramp_floor: int | None = _RAMP_FLOOR

    def _make_step(self, span: int) -> StepFn:
        raise NotImplementedError

    def sha256d(self, data: bytes) -> bytes:
        return sha256d(data)  # single digests stay on host

    def _search_arrays(self, header_prefix: bytes, difficulty: int) -> SearchArrays:
        return search_arrays(
            np.array(header_midstate(header_prefix), dtype=np.uint32),
            np.array(header_tail_words(header_prefix), dtype=np.uint32),
            np.array(target_to_words(target_from_difficulty(difficulty)), dtype=np.uint32),
            self.device,
        )

    def search(
        self, header_prefix: bytes, nonce_start: int, count: int, difficulty: int
    ) -> SearchResult:
        self._check_search_args(header_prefix, nonce_start, count, difficulty)
        arrays = self._search_arrays(header_prefix, difficulty)

        ramping = (
            self.ramp_floor is not None
            and nonce_start == 0
            and difficulty <= _RAMP_MAX_DIFFICULTY
            and self.step_span > self.ramp_floor
        )
        span = self.ramp_floor if ramping else self.step_span

        # Batched scan with a one-step pipeline.  Each step covers
        # [base, base+span); a partial final step is masked on the host
        # by re-checking the hit offset against the remaining count.
        pending: list[tuple[int, int, torch.Tensor, torch.cuda.Event | None]] = []
        done = 0
        result: SearchResult | None = None
        while done < count and result is None:
            base = nonce_start + done
            valid = min(span, count - done)
            pending.append((base, valid, *self._enqueue(self._make_step(span), arrays, base)))
            done += valid
            span = min(span * _RAMP_FACTOR, self.step_span)
            if len(pending) > 1:
                result = self._drain_one(pending, nonce_start)
        while result is None and pending:
            result = self._drain_one(pending, nonce_start)
        if result is not None:
            return result
        return SearchResult(None, count)

    @staticmethod
    def _enqueue(step: StepFn, arrays: SearchArrays, base: int):
        """Launch one step; return (host-readable result, ready event)."""
        idx = step(arrays, base)
        if not idx.is_cuda:
            return idx, None
        host = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
        host.copy_(idx, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _drain_one(self, pending: list, nonce_start: int) -> SearchResult | None:
        base, valid, host, ready = pending.pop(0)
        if ready is not None:
            ready.synchronize()  # blocks until this step's copy is done
        offset = int(host.reshape(-1)[0])
        if offset < valid:
            nonce = base + offset
            return SearchResult(nonce, nonce - nonce_start + 1)
        return None
