"""p1-tpu on PyTorch and CUDA: the port of ``p1_tpu`` to an NVIDIA H100.

A second package beside ``p1_tpu``, which stays the reference it is held
against.  It imports ``torch``, numpy and the standard library, never
``jax`` and never ``p1_tpu``: where it needs one of the reference's
JAX-free modules it keeps its own copy under the same module path.

This slice carries the mining path:

- ``p1_tpu_torch.core``   — ``BlockHeader`` (the reference's 80-byte
  encoding), target math, the fixed-difficulty genesis header.
- ``p1_tpu_torch.hashx``  — its own ``HashBackend`` registry: ``cpu``
  (hashlib) and ``cuda``, the SHA-256d nonce search as a hand-written
  CUDA kernel for Hopper (``hashx/csrc/sha256d_search.cu``) with its plain
  PyTorch version beside it (``hashx/torch_sha256.py``).
- ``p1_tpu_torch.miner``  — ``Miner.search_nonce()``.
- ``p1_tpu_torch.cli``    — ``python -m p1_tpu_torch mine``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``); without a card they raise.
"""

__version__ = "0.1.0"
