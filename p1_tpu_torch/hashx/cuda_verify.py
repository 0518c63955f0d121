"""Header-chain verification as a hand-written Hopper kernel.

The port of the device half of ``p1_tpu/chain/replay.py:replay_device``:
``jax_sha256.verify_header_chain_segments``, which the JAX package runs
as one XLA program (no Pallas kernel).  The kernel is
``csrc/verify_chain.cu``, one thread per header; its plain PyTorch version
is ``torch_sha256.verify_header_chain_segments``.

``first_invalid`` is the entry: on a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs ``plain_first_invalid``, the plain version
over the reference's (S, segment, 20) layout.  Either way the answer is
the index of the first invalid header, or N.
"""

from __future__ import annotations

import ctypes

import torch

from p1_tpu_torch.hashx import kernel_build
from p1_tpu_torch.hashx.torch_sha256 import verify_header_chain_segments

#: Threads per block, one header each: two warps, so that the ``replay``
#: launch (10,000 headers: 157 blocks) reaches every SM of an H100 (132).
THREADS = 64


def blocks_for(n: int) -> int:
    """Blocks of ``THREADS`` that cover ``n`` headers once: header i is
    thread ``i % THREADS`` of block ``i // THREADS``."""
    if not 0 < n < 1 << 31:
        # The first-invalid min runs in int32 (atomicMin on a signed cell
        # whose miss value is N).
        raise ValueError(f"the kernel takes 0 < N < 2**31 headers, got {n}")
    return -(-n // THREADS)


class VerifyKernel:
    """Wrapper of the ``verify_chain.cu`` kernel: builds the library on
    first use and counts launches (``launches``, one per kernel launch)."""

    SOURCE = "verify_chain.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._built: kernel_build.BuiltKernel | None = None

    def built(self) -> kernel_build.BuiltKernel:
        if self._built is None:
            built = kernel_build.build(self.SOURCE)
            built.lib.p1_verify_chain.argtypes = [
                ctypes.c_void_p,  # words: device (n, 20) uint32
                ctypes.c_int,  # n
                ctypes.POINTER(ctypes.c_uint32),  # target (8) + difficulty
                ctypes.c_int,  # blocks
                ctypes.c_int,  # threads per block
                ctypes.c_void_p,  # out (device int32 cell)
                ctypes.c_void_p,  # stream
            ]
            built.lib.p1_verify_chain.restype = ctypes.c_int
            built.lib.p1_verify_chain_attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
            built.lib.p1_verify_chain_attrs.restype = ctypes.c_int
            self._built = built
        return self._built

    def attributes(self) -> tuple[int, int]:
        """(registers per thread, local-memory bytes per thread)."""
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = self.built().lib.p1_verify_chain_attrs(ctypes.byref(regs), ctypes.byref(local))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        return regs.value, local.value

    def __call__(
        self,
        words: torch.Tensor,
        target_words: tuple[int, ...],
        difficulty: int,
        out: torch.Tensor,
    ) -> None:
        """Launch on the current stream of ``words``' device.  ``words`` is a
        contiguous (N, 20) int32 CUDA tensor of the big-endian header words;
        ``out`` is a (1,) int32 CUDA cell that already holds N."""
        n = words.shape[0]
        blocks = blocks_for(n)
        if not (words.is_cuda and words.dtype == torch.int32 and words.dim() == 2
                and words.shape[1] == 20 and words.is_contiguous()
                and words.data_ptr() % 16 == 0):  # fmt: skip
            raise ValueError("words must be a contiguous, 16-byte aligned (N, 20) int32 CUDA tensor")
        if not (out.device == words.device and out.dtype == torch.int32 and out.numel() == 1):
            raise ValueError("out must be a one-element int32 tensor on the words' device")
        if len(target_words) != 8 or not 0 <= difficulty <= 0xFFFFFFFF:
            raise ValueError("expected 8 target words and a uint32 difficulty")
        fn = self.built().lib.p1_verify_chain
        with torch.cuda.device(words.device):
            err = fn(
                words.data_ptr(),
                n,
                (ctypes.c_uint32 * 9)(*target_words, difficulty),
                blocks,
                THREADS,
                out.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"verify_chain launch failed: CUDA error {err}")
        self.launches += 1


#: The one wrapper of the verify kernel in this process.
verify_chain = VerifyKernel()


def first_invalid(
    words: torch.Tensor, target_words: tuple[int, ...], difficulty: int
) -> int:
    """Index of the first invalid header of the chain ``words`` (its first
    header is the genesis), or its number of headers.

    On a CUDA tensor (int32 words, shape (..., 20)) the kernel verifies the
    rows as one flat chain in one launch; on a CPU tensor (int64 words in
    the reference's (S, segment, 20) layout) ``plain_first_invalid``
    answers.  The segments change no index."""
    if words.is_cuda:
        flat = words.reshape(-1, 20)
        out = torch.full((1,), flat.shape[0], dtype=torch.int32, device=words.device)
        verify_chain(flat, target_words, difficulty, out)
        return int(out[0])
    if words.device.type != "cpu":
        raise ValueError(f"no verify kernel for device {words.device}")
    return plain_first_invalid(words, target_words, difficulty)


def plain_first_invalid(
    words3: torch.Tensor, target_words: tuple[int, ...], difficulty: int
) -> int:
    """``first_invalid`` by the plain version, on the int64 words' device:
    it scans the segments carrying the digest, and the local indices are
    offset and reduced as the reference's ``replay_device`` does."""
    s, segment = words3.shape[:2]
    target = torch.tensor(target_words, dtype=torch.int64, device=words3.device)
    idxs = verify_header_chain_segments(words3, target, difficulty)
    bad = [k * segment + i for k, i in enumerate(idxs.tolist()) if i < segment]
    return min(bad, default=s * segment)
