"""Ed25519 gate and MSM as hand-written Hopper kernels.

The port of the device program of ``p1_tpu/hashx/ed25519_msm.py``
(``_jit_gate_msm``: ``_gate_all`` and ``_msm_tree``), which the JAX
package runs as XLA (no Pallas kernel).  The kernels are
``csrc/ed25519_msm.cu``: (a) one thread per (point, role) — the gate by
q and the point's own scalar multiplication — and (b) one block that
sums the products and ANDs the gate flags.  Their plain PyTorch version
is ``ed25519_msm.plain_gate_msm``.

``gate_msm`` is the entry: on CUDA tensors it launches the kernels or
raises; on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from p1_tpu_torch.hashx import kernel_build
from p1_tpu_torch.hashx.ed25519_msm import FE_LIMBS, SCALAR_WORDS, GateMsm, plain_gate_msm

#: Threads per block of kernel (a), one per (point, role): one warp per
#: block, so a batch's ~2,000 threads spread over as many SMs as it has
#: warps.
THREADS = 32
#: The int32 read-back: the all-ok flag and X, Y, Z, T of the sum.
RESULT_LEN = 1 + 4 * FE_LIMBS


def blocks_for(n_points: int) -> int:
    """Blocks of ``THREADS`` that cover the ``2 · n_points`` (point, role)
    threads once: thread t is point t // 2, role t % 2."""
    if not 0 < n_points < 1 << 30:
        raise ValueError(f"the kernel takes 0 < N < 2**30 points, got {n_points}")
    return -(-2 * n_points // THREADS)


class Ed25519Kernel:
    """Wrapper of the ``ed25519_msm.cu`` kernels: builds the library on
    first use and counts launches (``launches``: one per call, which runs
    kernel (a) and then kernel (b) on the current stream)."""

    SOURCE = "ed25519_msm.cu"
    #: Kernel names in the SASS, by ``attributes``' index.
    KERNELS = ("gate_smul_kernel", "point_sum_kernel")

    def __init__(self) -> None:
        self.launches = 0
        self._built: kernel_build.BuiltKernel | None = None

    def built(self) -> kernel_build.BuiltKernel:
        if self._built is None:
            built = kernel_build.build(self.SOURCE)
            built.lib.p1_ed25519_gate_msm.argtypes = [
                ctypes.c_void_p,  # points: device (n, 4, 10) int32
                ctypes.c_void_p,  # scalars: device (n, 8) uint32
                ctypes.c_int,  # n
                ctypes.c_int,  # blocks of kernel (a)
                ctypes.c_int,  # threads per block of kernel (a)
                ctypes.c_void_p,  # products: device (n, 4, 10) int32
                ctypes.c_void_p,  # flags: device (n,) int32
                ctypes.c_void_p,  # result: device (41,) int32
                ctypes.c_void_p,  # stream
            ]
            built.lib.p1_ed25519_gate_msm.restype = ctypes.c_int
            built.lib.p1_ed25519_attrs.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
            built.lib.p1_ed25519_attrs.restype = ctypes.c_int
            self._built = built
        return self._built

    def attributes(self, which: int = 0) -> tuple[int, int]:
        """(registers per thread, local-memory bytes per thread) of kernel
        (a) (``which`` 0) or (b) (1)."""
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = self.built().lib.p1_ed25519_attrs(which, ctypes.byref(regs), ctypes.byref(local))
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        return regs.value, local.value

    def __call__(
        self,
        points: torch.Tensor,
        scalars: torch.Tensor,
        products: torch.Tensor,
        flags: torch.Tensor,
        result: torch.Tensor,
    ) -> None:
        """Launch on the current stream of ``points``' device.  ``points``
        is a contiguous (N, 4, 10) int32 CUDA tensor of limbs, ``scalars``
        (N, 8) int32 words; ``products`` (N, 4, 10), ``flags`` (N,) and
        ``result`` (41,) are int32 outputs on the same device."""
        n = points.shape[0] if points.dim() == 3 else 0
        blocks = blocks_for(n)
        shapes = (
            (points, (n, 4, FE_LIMBS)),
            (scalars, (n, SCALAR_WORDS)),
            (products, (n, 4, FE_LIMBS)),
            (flags, (n,)),
            (result, (RESULT_LEN,)),
        )
        for t, shape in shapes:
            if not (t.is_cuda and t.device == points.device and t.dtype == torch.int32
                    and tuple(t.shape) == shape and t.is_contiguous()):  # fmt: skip
                raise ValueError(f"expected a contiguous int32 CUDA tensor of shape {shape}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")  # fmt: skip
        fn = self.built().lib.p1_ed25519_gate_msm
        with torch.cuda.device(points.device):
            err = fn(
                points.data_ptr(),
                scalars.data_ptr(),
                n,
                blocks,
                THREADS,
                products.data_ptr(),
                flags.data_ptr(),
                result.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"ed25519_msm launch failed: CUDA error {err}")
        self.launches += 1


#: The one wrapper of the Ed25519 kernels in this process.
ed25519_msm = Ed25519Kernel()


def gate_msm(points: torch.Tensor, scalars: torch.Tensor) -> GateMsm:
    """The gate and the MSM of one batch: the kernels on CUDA tensors
    (outputs allocated here, on the same device), the plain version on
    CPU tensors.  ``points``: (N, 4, 10) int32 limbs; ``scalars``: (N, 8)
    int32 words."""
    if points.is_cuda:
        n = points.shape[0]
        out = GateMsm(
            result=torch.empty(RESULT_LEN, dtype=torch.int32, device=points.device),
            products=torch.empty((n, 4, FE_LIMBS), dtype=torch.int32, device=points.device),
            flags=torch.empty(n, dtype=torch.int32, device=points.device),
        )
        ed25519_msm(points, scalars, out.products, out.flags, out.result)
        return out
    if points.device.type != "cpu":
        raise ValueError(f"no Ed25519 kernel for device {points.device}")
    return plain_gate_msm(points, scalars)
