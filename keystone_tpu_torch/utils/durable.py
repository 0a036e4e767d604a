"""Hardened durable-state I/O: the survival side of the fault contract
(counterpart of ``keystone_tpu/utils/durable.py``).

Every persistence path of the port converges here (saved pipeline
prefixes in ``workflow/state.py``, the solvers' epoch and L-BFGS
checkpoints, the block stores' files), so the guarantees are uniform:

- **atomic publication**: tmp + fsync + ``os.replace``; a crash mid-save
  never destroys the previous good file, and readers never see a
  half-written one;
- **BLAKE2b sidecar checksums** (``<file>.b2``) verified on load: bit
  rot, torn writes and injected corruption surface as a typed
  :class:`CorruptStateError` instead of silently wrong weights;
- **bounded retry with exponential backoff and jitter** for transient
  I/O (``KEYSTONE_IO_RETRIES``, default 2);
- **rolling keep-N retention with last-good fallback**: ``save_npz``
  rotates the previous checkpoint to ``<file>.1`` (…``.N-1``) before
  publishing, and ``load_npz`` scans newest to oldest, skipping corrupt
  or unreadable candidates.

The injected counterpart lives in ``keystone_tpu_torch.faults``:
``save_npz`` carries the ``ckpt.save`` site (write + publish phases) and
``load_npz`` the ``ckpt.load`` site.  The file formats are the
reference's, so either package reads the other's checkpoints.
"""

from __future__ import annotations

import hashlib
import logging
import os
import random
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.obs import metrics

logger = logging.getLogger(__name__)

CHECKSUM_SUFFIX = ".b2"

#: exception types retried as transient by :func:`with_retries`
#: (FaultInjected subclasses OSError, so injected flakiness is absorbed
#: exactly like real flaky storage).
TRANSIENT = (OSError,)


class CorruptStateError(RuntimeError):
    """Durable state failed its integrity check (checksum mismatch,
    truncation, or an unreadable payload).  Deliberately NOT an
    ``OSError``: retrying a deterministic corruption is futile, so the
    retry layer must not absorb it — fallback/requarantine paths own
    it instead."""


# ------------------------------------------------------------- checksums


def compute_checksum(path: str, chunk_bytes: int = 1 << 20) -> str:
    """Streaming BLAKE2b-128 of a file's content."""
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def checksum_path(path: str) -> str:
    return path + CHECKSUM_SUFFIX


def write_checksum(path: str, digest: Optional[str] = None) -> str:
    """Write ``<path>.b2`` (atomically) for the current content of
    ``path`` — or for a caller-supplied ``digest`` (publishers that
    hashed their own bytes before the rename, so the sidecar can never
    describe somebody else's payload); returns the digest."""
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


def verify_checksum(path: str, required: bool = False) -> bool:
    """Verify ``path`` against its sidecar.  Returns True on a verified
    match, False when no sidecar exists (legacy files pass unverified
    unless ``required``); raises :class:`CorruptStateError` on mismatch.
    """
    side = checksum_path(path)
    if not os.path.exists(side):
        if required:
            raise CorruptStateError(f"missing checksum sidecar for {path}")
        return False
    with open(side) as f:
        expected = f.read().strip()
    actual = compute_checksum(path)
    if actual != expected:
        metrics.inc("durable.corruption")
        raise CorruptStateError(
            f"checksum mismatch for {path}: content={actual[:12]}… "
            f"sidecar={expected[:12]}…"
        )
    return True


# --------------------------------------------------------- retry/backoff


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        logger.warning("bad %s=%r; using %d", name, os.environ.get(name), default)
        return default


def backoff_delays(
    retries: int,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    seed: Optional[int] = None,
) -> Iterable[float]:
    """Exponential backoff delays with multiplicative jitter.  A ``seed``
    makes the jitter deterministic (chaos-test replay); default jitter
    decorrelates a fleet of restarting workers."""
    rng = random.Random(seed)
    for attempt in range(retries):
        delay = min(max_delay, base_delay * (2.0**attempt))
        yield delay * (1.0 + jitter * rng.random())


def with_retries(
    fn: Callable,
    retries: Optional[int] = None,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: Tuple = TRANSIENT,
    description: str = "",
    sleep: Callable[[float], None] = time.sleep,
    retry_if: Optional[Callable[[BaseException], bool]] = None,
):
    """Call ``fn()`` with up to ``retries`` bounded retries on transient
    errors.  ``retries=None`` resolves ``KEYSTONE_IO_RETRIES`` (default
    2) so every I/O path honors the knob without plumbing.  Exceptions
    outside ``retry_on`` — notably :class:`CorruptStateError` —
    propagate immediately.  ``retry_if``: an extra predicate a caught
    exception must ALSO satisfy to be retried — for callers whose
    transient/deterministic split is finer than exception types (e.g.
    ``multihost.initialize``, where only connection-shaped
    ``RuntimeError``s are worth the backoff budget)."""
    if retries is None:
        retries = max(0, _env_int("KEYSTONE_IO_RETRIES", 2))
    delays = iter(backoff_delays(retries, base_delay, max_delay))
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if isinstance(e, CorruptStateError):
                raise
            if retry_if is not None and not retry_if(e):
                raise
            attempt += 1
            if attempt > retries:
                raise
            metrics.inc("durable.retries")
            delay = next(delays)
            logger.warning(
                "transient I/O failure%s (%s); retry %d/%d in %.2fs",
                f" in {description}" if description else "",
                e,
                attempt,
                retries,
                delay,
            )
            sleep(delay)


# -------------------------------------------------- atomic npz + rolling


def _fsync_dir(dirpath: str) -> None:
    """Best-effort directory fsync so the rename itself is durable."""
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


#: serializes the payload-rename + sidecar-publish pair within this
#: process: a watchdog-abandoned checkpoint attempt racing its own
#: retry (utils/guard.run_with_deadline) must not interleave the two
#: renames (payload B with sidecar A would read as corrupt)
_PUBLISH_LOCK = threading.Lock()


def atomic_write(path: str, write_fn: Callable[[str], None]) -> None:
    """Publish a file atomically: ``write_fn(tmp)`` writes the payload,
    then fsync + rename + dir fsync + checksum sidecar.  The tmp name is
    per-pid AND per-thread so concurrent writers — other processes on a
    shared directory, or a watchdog-abandoned stage attempt racing its
    own retry (utils/guard.run_with_deadline) — never truncate each
    other mid-write.  The digest is computed from OUR tmp bytes before
    the rename and the rename+sidecar pair is published under a
    process-wide lock, so the sidecar always describes the payload that
    landed with it; publication stays last-writer-wins, which is
    idempotent for the stage-retry case because stages are pure
    functions of memoized inputs."""
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
    """Shift ``path`` → ``path.1`` → … → ``path.keep-1`` (with sidecars),
    dropping the oldest.  Best-effort under concurrent writers: a
    rename that loses a race is skipped, never fatal — every individual
    publish stays atomic."""
    if keep <= 1:
        return
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


def prune_rotated(path: str, keep: int) -> None:
    """Delete rotated copies beyond ``keep`` (retention shrink)."""
    i = max(1, keep)
    while True:
        cand = _rotated(path, i)
        if not os.path.exists(cand):
            break
        for p in (cand, checksum_path(cand)):
            try:
                os.remove(p)
            except OSError:
                pass
        i += 1


def save_npz(
    path: str,
    arrays: Dict[str, np.ndarray],
    keep: int = 2,
    retries: Optional[int] = None,
    fault_site: str = "ckpt.save",
) -> None:
    """Durably publish a dict of arrays as an ``.npz`` checkpoint.

    The previous file rotates to ``path.1`` (…``path.keep-1``) first, so
    the newest checkpoint getting corrupted still leaves a last-good
    fallback for :func:`load_npz`.  The write itself is atomic, retried
    on transient errors, and checksummed.  Fault sites: the ``write``
    phase fires inside the retry scope (a transient injected failure is
    absorbed); the ``publish`` phase fires after the sidecar lands, so
    ``corrupt``/``truncate`` actions damage exactly what a subsequent
    load must detect."""
    rotate(path, keep)
    prune_rotated(path, keep)

    def _write(tmp: str) -> None:
        fault_point(fault_site, path=tmp, phase="write")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())

    with_retries(
        lambda: atomic_write(path, _write),
        retries=retries,
        description=f"checkpoint save {os.path.basename(path)}",
    )
    fault_point(fault_site, path=path, phase="publish")


def load_npz(
    path: str,
    validate: Optional[Callable[[Dict[str, np.ndarray]], bool]] = None,
    fault_site: str = "ckpt.load",
) -> Optional[Tuple[Dict[str, np.ndarray], str]]:
    """Load the newest *valid* checkpoint among ``path``, ``path.1``, …

    Validity = checksum sidecar matches (when present), the npz parses,
    and ``validate(arrays)`` (when given) accepts it.  Invalid
    candidates are skipped with a warning — the resume scan degrades to
    the last good epoch instead of crashing the fit.  Returns
    ``(arrays, path_used)`` or None when no candidate survives.
    Transient read errors retry with backoff before the candidate is
    declared dead."""
    candidates = [path]
    i = 1
    while os.path.exists(_rotated(path, i)):
        candidates.append(_rotated(path, i))
        i += 1

    for cand in candidates:
        if not os.path.exists(cand):
            continue

        def _read(cand=cand):
            fault_point(fault_site, path=cand)
            verify_checksum(cand)
            with np.load(cand, allow_pickle=False) as z:
                return {k: np.asarray(z[k]) for k in z.files}

        try:
            arrays = with_retries(
                _read, description=f"checkpoint load {os.path.basename(cand)}"
            )
        except CorruptStateError as e:
            metrics.inc("durable.skipped_corrupt")
            logger.warning("skipping corrupt checkpoint %s: %s", cand, e)
            continue
        except Exception as e:
            metrics.inc("durable.skipped_unreadable")
            logger.warning("skipping unreadable checkpoint %s: %s", cand, e)
            continue
        if validate is not None:
            try:
                ok = bool(validate(arrays))
            except Exception as e:
                logger.warning("checkpoint %s failed validation: %s", cand, e)
                continue
            if not ok:
                logger.info("checkpoint %s rejected by validator", cand)
                continue
        if cand != path:
            metrics.inc("durable.fallback")
            logger.warning(
                "resumed from fallback checkpoint %s (newer candidates "
                "invalid)",
                cand,
            )
        return arrays, cand
    return None


def quarantine(path: str) -> Optional[str]:
    """Move a known-bad state file (and its sidecar) aside as
    ``<path>.corrupt`` so resume scans stop tripping over it; returns
    the new path (None when the rename failed)."""
    dest = path + ".corrupt"
    try:
        os.replace(path, dest)
    except OSError:
        return None
    side = checksum_path(path)
    if os.path.exists(side):
        try:
            os.replace(side, checksum_path(dest))
        except OSError:
            pass
    metrics.inc("durable.quarantined")
    logger.warning("quarantined corrupt state file %s -> %s", path, dest)
    return dest
