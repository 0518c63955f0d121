"""Fast host-side SHA-256d (``hashlib``) for block ids and seal checks.

The port's copy of ``p1_tpu/core/hashutil.py``.  The pure-Python
implementation in ``p1_tpu_torch.hashx.sha256_ref`` stays the ground truth
for tests and the midstate computation only.
"""

from __future__ import annotations

import hashlib

_sha256 = hashlib.sha256  # bound once: this runs several times per block


def sha256d(data: bytes) -> bytes:
    return _sha256(_sha256(data).digest()).digest()
