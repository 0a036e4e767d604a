"""Content fingerprints for arrays (counterpart of
``keystone_tpu/utils/hashing.py`` § array_fingerprint)."""

from __future__ import annotations

import hashlib

import numpy as np


def array_fingerprint(*arrays) -> str:
    """A short digest of each array's shape, dtype and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        arr = np.asarray(a)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]
