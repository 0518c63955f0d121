from p1_tpu_torch.hashx.backend import (
    HashBackend,
    SearchResult,
    available_backends,
    get_backend,
    register,
)

# Import for registration side effects.
from p1_tpu_torch.hashx import cpu as _cpu  # noqa: F401

# The kernel backend imports torch: it loads on first use.
from p1_tpu_torch.hashx.backend import register_lazy as _register_lazy


def _load_cuda():
    from p1_tpu_torch.hashx import cuda_backend

    return cuda_backend.CudaBackend


_register_lazy("cuda", _load_cuda)

__all__ = [
    "HashBackend",
    "SearchResult",
    "available_backends",
    "get_backend",
    "register",
]
