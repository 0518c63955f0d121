"""Helpers of the port's node tests (``tests/test_torch_*.py``).

- ``stx``: ``tests/txutil.py``'s signed transfer, carried into the port
  by its bytes.  Transfers are signed by the JAX package's keys (the
  ``cryptography`` wheel, fast); the port signs in pure Python (~6 ms a
  signature on a CPU host), the same 64 bytes either way (RFC 8032).
- ``NodeConfig``: the port's config with ``backend="cpu"`` and
  ``device="cpu"`` unless a test says otherwise.  The port's defaults
  run on the card (``cuda``); the reference tests build their nodes with
  the reference's ``cpu`` backend, and ``device="cpu"`` pins the
  ``device`` signature rung to its plain version, which a host without
  a card needs for any batch of ``BATCH_MIN`` or more.
"""

from txutil import account, key_for  # noqa: F401 - re-exported
from txutil import stx as ref_stx

from p1_tpu_torch.config import NodeConfig as _NodeConfig
from p1_tpu_torch.core.tx import Transaction


def stx(*args, **kwargs) -> Transaction:
    """``txutil.stx``'s transfer as the port's transaction."""
    return Transaction.deserialize(ref_stx(*args, **kwargs).serialize())


def NodeConfig(**kw) -> _NodeConfig:
    """The port's ``NodeConfig`` on the host: hashlib mining and the
    signature rung's plain version, unless overridden."""
    kw.setdefault("backend", "cpu")
    kw.setdefault("device", "cpu")
    return _NodeConfig(**kw)
