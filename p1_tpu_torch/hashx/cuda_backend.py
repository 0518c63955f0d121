"""CUDA hash backend: the SHA-256d nonce search as a hand-written Hopper kernel.

The port of ``p1_tpu/hashx/pallas_backend.py``, registered as ``cuda`` (the
counterpart of ``tpu``).  The kernel is ``csrc/sha256d_search.cu``; its
plain PyTorch version is ``torch_sha256.search_step``.

Layout: a block of ``threads`` threads covers a tile of ``sub · threads``
consecutive flat offsets, ``sub`` rows of one nonce per thread, and a step
of ``batch`` nonces launches ``batch / tile`` blocks.  The result is one
int32 device cell, set to ``batch`` before the launch and lowered by
``atomicMin`` to the earliest hit: the Pallas step's contract, so the
pipelined host loop (``torch_backend.PipelinedSearchMixin``) composes
unchanged.

A step on a CUDA tensor launches the kernel or raises; a step on a CPU
tensor runs the plain version.  The CPU runs only when the caller asked
for it (``device="cpu"``, what the tests pass), as the ``tpu`` backend
runs in interpret mode off-TPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from p1_tpu_torch.hashx import kernel_build
from p1_tpu_torch.hashx.backend import HashBackend, register
from p1_tpu_torch.hashx.torch_backend import (
    _RAMP_FLOOR,
    PipelinedSearchMixin,
    SearchArrays,
    StepFn,
)
from p1_tpu_torch.hashx.torch_sha256 import search_step

#: Nonces each thread hashes per step (rows of a block's tile).
_DEFAULT_SUB = 4
#: Threads per block (nonces in one row of the tile).
_DEFAULT_THREADS = 256
#: Device-step batch on the card.  A step moves 4 bytes and runs ~ms, so
#: the batch trades launch overhead against abort granularity; PERF.md's
#: sweep on the H100 picks it.
_DEFAULT_BATCH = 1 << 26
#: Steps on the CPU are for parity tests: keep them small.
_CPU_BATCH = 1 << 12


class SearchKernel:
    """Wrapper of the ``sha256d_search.cu`` kernel: builds the library on
    first use and counts launches (``launches``, one per kernel launch)."""

    SOURCE = "sha256d_search.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._built: kernel_build.BuiltKernel | None = None

    def built(self) -> kernel_build.BuiltKernel:
        if self._built is None:
            built = kernel_build.build(self.SOURCE)
            built.lib.p1_sha256d_search.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),  # words: midstate, tail, target
                ctypes.c_uint32,  # nonce_base
                ctypes.c_int,  # batch
                ctypes.c_int,  # sub
                ctypes.c_int,  # threads
                ctypes.c_void_p,  # out (device int32 cell)
                ctypes.c_void_p,  # stream
            ]
            built.lib.p1_sha256d_search.restype = ctypes.c_int
            built.lib.p1_sha256d_search_attrs.argtypes = [
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            built.lib.p1_sha256d_search_attrs.restype = ctypes.c_int
            self._built = built
        return self._built

    def attributes(self) -> tuple[int, int]:
        """(registers per thread, local-memory bytes per thread)."""
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = self.built().lib.p1_sha256d_search_attrs(ctypes.byref(regs), ctypes.byref(local))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        return regs.value, local.value

    def __call__(
        self,
        words: tuple[int, ...],
        nonce_base: int,
        batch: int,
        sub: int,
        threads: int,
        out: torch.Tensor,
    ) -> None:
        """Launch one step on the current stream of ``out``'s device; ``out``
        is a (1,) int32 CUDA cell that already holds ``batch``."""
        if not (out.is_cuda and out.dtype == torch.int32 and out.numel() == 1):
            raise ValueError("out must be a one-element int32 CUDA tensor")
        if len(words) != 19:
            raise ValueError(f"expected 19 words (midstate, tail, target), got {len(words)}")
        fn = self.built().lib.p1_sha256d_search
        with torch.cuda.device(out.device):
            err = fn(
                (ctypes.c_uint32 * 19)(*words),
                nonce_base & 0xFFFFFFFF,
                batch,
                sub,
                threads,
                out.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"sha256d_search launch failed: CUDA error {err}")
        self.launches += 1


#: The one wrapper of the search kernel in this process.
sha256d_search = SearchKernel()


def _check_tile(batch: int, sub: int, threads: int) -> int:
    if sub < 1 or not 1 <= threads <= 1024:
        raise ValueError(f"sub={sub} must be >= 1 and threads={threads} in 1..1024")
    return sub * threads


@functools.cache
def cuda_search_fn(
    batch: int, sub: int = _DEFAULT_SUB, threads: int = _DEFAULT_THREADS
) -> StepFn:
    """The search step (analog of ``pallas_search_fn``): (SearchArrays,
    nonce_base) -> (1,) int32 first-hit offset in [0, batch] (``batch`` =
    miss), on the arrays' device."""
    block = _check_tile(batch, sub, threads)
    if batch % block:
        raise ValueError(f"batch {batch} not a multiple of the {block} tile")
    if batch >= 1 << 31:
        # The kernel's first-hit min runs in int32 (atomicMin on a signed
        # cell): a 2³¹ batch would wrap the miss sentinel negative and
        # mask every hit.
        raise ValueError(f"batch {batch} must be < 2**31")

    def step(arrays: SearchArrays, nonce_base: int) -> torch.Tensor:
        device = arrays.device
        if device.type == "cpu":
            idx = search_step(arrays.midstate, arrays.tail, arrays.target, nonce_base, batch)
            return idx.to(torch.int32).reshape(1)
        if device.type != "cuda":
            raise ValueError(f"no search kernel for device {device}")
        out = torch.full((1,), batch, dtype=torch.int32, device=device)
        sha256d_search(arrays.words, nonce_base, batch, sub, threads, out)
        return out

    return step


@register("cuda")
class CudaBackend(PipelinedSearchMixin, HashBackend):
    """SHA-256d nonce search as a CUDA kernel on one card (``cuda``).

    ``device="cuda"`` (the default) runs the kernel and raises when no card
    is present; ``device="cpu"`` runs the plain PyTorch version.
    """

    def __init__(
        self,
        batch: int | None = None,
        sub: int = _DEFAULT_SUB,
        threads: int = _DEFAULT_THREADS,
        device: str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the cuda backend needs a CUDA device and none is available; "
                    "pass device='cpu' to run the plain PyTorch version"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        if batch is None:
            batch = _CPU_BATCH if self.device.type == "cpu" else _DEFAULT_BATCH
        block = _check_tile(batch, sub, threads)
        if batch % block:
            raise ValueError(f"batch {batch} must be a multiple of {block}")
        if batch >= 1 << 31:
            # Same int32-sentinel bound cuda_search_fn enforces; checked
            # here too so misconfiguration fails at construction.
            raise ValueError(f"batch {batch} must be < 2**31")
        if _RAMP_FLOOR % block:
            # Ramp spans are powers of two; a tile that doesn't divide them
            # can't take part in the opening ramp.
            self.ramp_floor = None
        self.batch = batch
        self.sub = sub
        self.threads = threads
        self.step_span = batch
        self.kernel = sha256d_search

    def _make_step(self, span: int) -> StepFn:
        return cuda_search_fn(span, self.sub, self.threads)
