"""Durable file I/O for the out-of-core fit (counterpart of the pieces of
``keystone_tpu/utils/durable.py`` that the feature block store and the
solver's epoch checkpoint use).

- BLAKE2b sidecar checksums (``<file>.b2``), verified on read: a torn
  write or bit rot surfaces as ``CorruptStateError`` instead of training
  on damaged features;
- bounded retry with exponential backoff for transient I/O errors;
- atomic publication (tmp + fsync + ``os.replace``) and a rolling
  last-good copy for the epoch checkpoint (``save_npz`` / ``load_npz``).

The reference's fault-injection sites and metrics counters wait for the
port's operations layer (ROADMAP A9).
"""

from __future__ import annotations

import hashlib
import logging
import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

CHECKSUM_SUFFIX = ".b2"

#: transient I/O errors ``with_retries`` retries
TRANSIENT = (OSError,)

#: retries of a transient read before it raises
IO_RETRIES = 2


class CorruptStateError(RuntimeError):
    """A durable file failed its integrity check (checksum mismatch,
    truncation, an unreadable payload).  Not an ``OSError``: retrying a
    deterministic corruption is futile, so ``with_retries`` lets it through."""


def compute_checksum(path: str, chunk_bytes: int = 1 << 20) -> str:
    """Streaming BLAKE2b-128 of a file's content."""
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while chunk := f.read(chunk_bytes):
            h.update(chunk)
    return h.hexdigest()


def checksum_path(path: str) -> str:
    return path + CHECKSUM_SUFFIX


def write_checksum(path: str, digest: Optional[str] = None) -> str:
    """Write ``<path>.b2`` atomically for ``path``'s content (or for a
    ``digest`` the caller computed from the bytes it wrote); returns it."""
    if digest is None:
        digest = compute_checksum(path)
    side = checksum_path(path)
    tmp = f"{side}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(digest + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, side)
    return digest


def verify_checksum(path: str) -> bool:
    """True when ``path`` matches its sidecar, False when it has none
    (an unsealed file); raises ``CorruptStateError`` on a mismatch."""
    side = checksum_path(path)
    if not os.path.exists(side):
        return False
    with open(side) as f:
        expected = f.read().strip()
    actual = compute_checksum(path)
    if actual != expected:
        raise CorruptStateError(f"checksum mismatch for {path}: content={actual[:12]}… sidecar={expected[:12]}…")
    return True


def with_retries(fn: Callable, retries: int = IO_RETRIES, base_delay: float = 0.05, max_delay: float = 2.0,
                 description: str = ""):
    """``fn()`` with up to ``retries`` retries of a transient error, after
    exponential backoff with jitter; ``CorruptStateError`` and other
    errors propagate at once."""
    rng = random.Random()
    attempt = 0
    while True:
        try:
            return fn()
        except TRANSIENT as e:
            attempt += 1
            if attempt > retries:
                raise
            delay = min(max_delay, base_delay * 2.0 ** (attempt - 1)) * (1.0 + 0.5 * rng.random())
            logger.warning("transient I/O failure%s (%s); retry %d/%d in %.2fs",
                           f" in {description}" if description else "", e, attempt, retries, delay)
            time.sleep(delay)


def _fsync_dir(dirpath: str) -> None:
    """Best-effort directory fsync, so that a rename itself is durable."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


#: serializes a payload's rename with its sidecar's in this process
_PUBLISH_LOCK = threading.Lock()


def atomic_write(path: str, write_fn: Callable[[str], None]) -> None:
    """Publish a file atomically: ``write_fn(tmp)`` writes the payload,
    then fsync, rename, directory fsync and the checksum sidecar, the
    digest taken from the tmp bytes before the rename."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    write_fn(tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    digest = compute_checksum(tmp)
    with _PUBLISH_LOCK:
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
        write_checksum(path, digest=digest)


def _rotated(path: str, i: int) -> str:
    return f"{path}.{i}"


def rotate(path: str, keep: int) -> None:
    """Shift ``path`` → ``path.1`` → … → ``path.keep-1`` with their
    sidecars, dropping the oldest."""
    for i in range(keep - 1, 0, -1):
        src = path if i == 1 else _rotated(path, i - 1)
        if not os.path.exists(src):
            continue
        try:
            os.replace(src, _rotated(path, i))
            if os.path.exists(checksum_path(src)):
                os.replace(checksum_path(src), checksum_path(_rotated(path, i)))
        except OSError:
            pass


def save_npz(path: str, arrays: Dict[str, np.ndarray], keep: int = 2) -> None:
    """Publish ``arrays`` as an ``.npz`` checkpoint, atomically and
    checksummed, the previous one rotated to ``path.1`` first (the
    last-good fallback ``load_npz`` reads when the newest is damaged)."""
    rotate(path, keep)

    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())

    with_retries(lambda: atomic_write(path, write), description=f"checkpoint save {os.path.basename(path)}")


def load_npz(path: str, validate: Optional[Callable[[Dict[str, np.ndarray]], bool]] = None
             ) -> Optional[Tuple[Dict[str, np.ndarray], str]]:
    """The newest valid checkpoint among ``path``, ``path.1``, …: its
    sidecar matches, it parses, and ``validate`` accepts it.  Returns
    ``(arrays, path_used)``, or None when no candidate is valid."""
    candidates = [path]
    i = 1
    while os.path.exists(_rotated(path, i)):
        candidates.append(_rotated(path, i))
        i += 1
    for cand in candidates:
        if not os.path.exists(cand):
            continue

        def read(cand=cand):
            verify_checksum(cand)
            with np.load(cand, allow_pickle=False) as z:
                return {k: np.asarray(z[k]) for k in z.files}

        try:
            arrays = with_retries(read, description=f"checkpoint load {os.path.basename(cand)}")
        except (CorruptStateError, OSError, ValueError) as e:
            logger.warning("skipping unreadable checkpoint %s: %s", cand, e)
            continue
        if validate is not None and not validate(arrays):
            logger.info("checkpoint %s rejected by its validator", cand)
            continue
        if cand != path:
            logger.warning("resumed from fallback checkpoint %s (newer candidates invalid)", cand)
        return arrays, cand
    return None
