from p1_tpu_torch.hashx.backend import (
    HashBackend,
    SearchResult,
    available_backends,
    get_backend,
    register,
)

# Import for registration side effects.
from p1_tpu_torch.hashx import cpu as _cpu  # noqa: F401
from p1_tpu_torch.hashx import numpy_backend as _numpy  # noqa: F401

# The kernel backends import torch and the native one builds a library:
# all load on first use.
from p1_tpu_torch.hashx.backend import register_lazy as _register_lazy


def _load_cuda():
    from p1_tpu_torch.hashx import cuda_backend

    return cuda_backend.CudaBackend


def _load_torch():
    from p1_tpu_torch.hashx import torch_backend

    return torch_backend.TorchBackend


def _load_sharded():
    from p1_tpu_torch.hashx import sharded

    return sharded.ShardedBackend


def _load_native():
    from p1_tpu_torch.hashx import native_backend

    return native_backend.NativeBackend


_register_lazy("cuda", _load_cuda)
_register_lazy("torch", _load_torch)
_register_lazy("sharded", _load_sharded)
_register_lazy("native", _load_native)

__all__ = [
    "HashBackend",
    "SearchResult",
    "available_backends",
    "get_backend",
    "register",
]
