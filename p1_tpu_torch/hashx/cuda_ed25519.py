"""Ed25519 decompression, gate and MSM as hand-written Hopper kernels.

The port of the device program of ``p1_tpu/hashx/ed25519_msm.py``
(``_jit_gate_msm``: ``_gate_all`` and ``_msm_tree``), which the JAX
package runs as XLA (no Pallas kernel), preceded by the point
decompression that the JAX package leaves on the host.  The kernels are
``csrc/ed25519_msm.cu``: (a) one block per eight points, which decodes
them, builds one shared window table per point, runs the gate on four
lanes per point and the block's share of the MSM as Horner over windows;
(b) one block that sums the blocks' accumulators and ANDs the points'
flags.  Their plain PyTorch version is
``ed25519_msm.plain_decode_gate_msm``.

``decode_gate_msm`` is the entry: on CUDA tensors it launches the kernels
or raises; on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from p1_tpu_torch.hashx import kernel_build
from p1_tpu_torch.hashx.ed25519_msm import (
    FE_LIMBS,
    SCALAR_WORDS,
    DecodeGateMsm,
    plain_decode_gate_msm,
)

#: Points per block of kernel (a): its gate warp's eight groups of four
#: lanes.  1,033 points (a 1,024-signature batch) make 130 blocks, about
#: one per SM of the H100's 132.
POINTS_PER_BLOCK = 8
#: Threads per block of kernel (a): the gate warp and three MSM warps.
THREADS = 128
#: The int32 read-back: the all-ok flag and X, Y, Z, T of the sum.
RESULT_LEN = 1 + 4 * FE_LIMBS
#: Block 0's phases, in the order ``phase_clocks`` records their ends
#: (``Phase`` in the source): the start, then warp 0's decompression,
#: tables and gate, and warp 1's window sums, Horner's high half and the
#: block's accumulator.
PHASES = ("start", "decoded", "tables", "gate", "window_sums", "horner_high", "accumulator")


def blocks_for(n_points: int) -> int:
    """Blocks of ``POINTS_PER_BLOCK`` points that cover ``n_points`` once:
    block b takes points 8b .. 8b + 7."""
    if not 0 < n_points < 1 << 30:
        raise ValueError(f"the kernel takes 0 < N < 2**30 points, got {n_points}")
    return -(-n_points // POINTS_PER_BLOCK)


class Ed25519Kernel:
    """Wrapper of the ``ed25519_msm.cu`` kernels: builds the library on
    first use and counts launches (``launches``: one per call, which runs
    kernel (a) and then kernel (b) on the current stream)."""

    SOURCE = "ed25519_msm.cu"
    #: Kernel names in the SASS, by ``attributes``' index.
    KERNELS = ("decode_gate_msm_kernel", "point_sum_kernel")

    def __init__(self) -> None:
        self.launches = 0
        self._built: kernel_build.BuiltKernel | None = None

    def built(self) -> kernel_build.BuiltKernel:
        if self._built is None:
            built = kernel_build.build(self.SOURCE)
            built.lib.p1_ed25519_decode_gate_msm.argtypes = [
                ctypes.c_void_p,  # encodings: device (n, 8) uint32
                ctypes.c_void_p,  # scalars: device (n, 8) uint32
                ctypes.c_int,  # n
                ctypes.c_int,  # blocks of kernel (a)
                ctypes.c_int,  # threads per block of kernel (a)
                ctypes.c_void_p,  # decoded: device (n, 4, 10) int32
                ctypes.c_void_p,  # flags: device (n,) int32
                ctypes.c_void_p,  # partials: device (blocks, 4, 10) int32
                ctypes.c_void_p,  # result: device (41,) int32
                ctypes.c_void_p,  # phase_clocks: device (7,) int64, or null
                ctypes.c_void_p,  # stream
            ]
            built.lib.p1_ed25519_decode_gate_msm.restype = ctypes.c_int
            built.lib.p1_ed25519_attrs.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
            built.lib.p1_ed25519_attrs.restype = ctypes.c_int
            self._built = built
        return self._built

    def attributes(self, which: int = 0) -> dict:
        """Registers per thread, local-memory bytes per thread and static
        shared-memory bytes per block of kernel (a) (``which`` 0) or (b) (1)."""
        regs, local, shared = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = self.built().lib.p1_ed25519_attrs(which, *(ctypes.byref(v) for v in (regs, local, shared)))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        return {"registers": regs.value, "local_bytes": local.value, "shared_bytes": shared.value}

    def __call__(
        self,
        encodings: torch.Tensor,
        scalars: torch.Tensor,
        decoded: torch.Tensor,
        flags: torch.Tensor,
        partials: torch.Tensor,
        result: torch.Tensor,
        phase_clocks: torch.Tensor | None = None,
    ) -> None:
        """Launch on the current stream of ``encodings``' device.
        ``encodings`` is a contiguous (N, 8) int32 CUDA tensor of encoding
        words, ``scalars`` (N, 8) int32 words; ``decoded`` (N, 4, 10),
        ``flags`` (N,), ``partials`` (``blocks_for(N)``, 4, 10) and
        ``result`` (41,) are int32 outputs on the same device.
        ``phase_clocks``, where given, a (7,) int64 tensor there, gets the
        SM clock at the ends of block 0's phases (``PHASES``)."""
        n = encodings.shape[0] if encodings.dim() == 2 else 0
        blocks = blocks_for(n)
        shapes = (
            (encodings, (n, SCALAR_WORDS)),
            (scalars, (n, SCALAR_WORDS)),
            (decoded, (n, 4, FE_LIMBS)),
            (flags, (n,)),
            (partials, (blocks, 4, FE_LIMBS)),
            (result, (RESULT_LEN,)),
        )
        for t, shape in shapes:
            if not (t.is_cuda and t.device == encodings.device and t.dtype == torch.int32
                    and tuple(t.shape) == shape and t.is_contiguous()):  # fmt: skip
                raise ValueError(f"expected a contiguous int32 CUDA tensor of shape {shape}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")  # fmt: skip
        if phase_clocks is not None and not (
            phase_clocks.is_cuda and phase_clocks.device == encodings.device
            and phase_clocks.dtype == torch.int64 and tuple(phase_clocks.shape) == (len(PHASES),)
        ):  # fmt: skip
            raise ValueError(f"phase_clocks must be a ({len(PHASES)},) int64 tensor on {encodings.device}")
        fn = self.built().lib.p1_ed25519_decode_gate_msm
        with torch.cuda.device(encodings.device):
            err = fn(
                encodings.data_ptr(),
                scalars.data_ptr(),
                n,
                blocks,
                THREADS,
                decoded.data_ptr(),
                flags.data_ptr(),
                partials.data_ptr(),
                result.data_ptr(),
                None if phase_clocks is None else phase_clocks.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"ed25519_msm launch failed: CUDA error {err}")
        self.launches += 1


#: The one wrapper of the Ed25519 kernels in this process.
ed25519_msm = Ed25519Kernel()


def outputs_for(encodings: torch.Tensor) -> tuple[DecodeGateMsm, torch.Tensor]:
    """The kernels' outputs for ``encodings``, allocated on its device:
    the result, decoded points and flags, and the per-block partials."""
    n, dev = encodings.shape[0], encodings.device
    out = DecodeGateMsm(
        result=torch.empty(RESULT_LEN, dtype=torch.int32, device=dev),
        decoded=torch.empty((n, 4, FE_LIMBS), dtype=torch.int32, device=dev),
        flags=torch.empty(n, dtype=torch.int32, device=dev),
    )
    return out, torch.empty((blocks_for(n), 4, FE_LIMBS), dtype=torch.int32, device=dev)


def decode_gate_msm(encodings: torch.Tensor, scalars: torch.Tensor) -> DecodeGateMsm:
    """Decompression, the gate and the MSM of one batch: the kernels on
    CUDA tensors (outputs allocated here, on the same device), the plain
    version on CPU tensors.  ``encodings``: (N, 8) int32 words of the
    32-byte point encodings; ``scalars``: (N, 8) int32 words."""
    if encodings.is_cuda:
        out, partials = outputs_for(encodings)
        ed25519_msm(encodings, scalars, out.decoded, out.flags, partials, out.result)
        return out
    if encodings.device.type != "cpu":
        raise ValueError(f"no Ed25519 kernel for device {encodings.device}")
    return plain_decode_gate_msm(encodings, scalars)
