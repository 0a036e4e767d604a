"""Versioned model registry on the durable layer, and the poll watcher
that turns a registry publish into a live fleet hot-swap (counterpart
of ``keystone_tpu/serve/registry.py``).

Layout (the reference's; every file published through
``utils/durable.atomic_write``: tmp + fsync + rename + BLAKE2b sidecar,
so a crash mid-publish never destroys the previous good version and
readers never see a torn one)::

    <root>/
      v0001/model.pkl     (+ model.pkl.b2 sidecar)
      v0001/artifacts/    MANIFEST.json + one blob per bucket (+ sidecars)
      v0002/model.pkl     (+ sidecar)
      v0002/BAD           (+ sidecar)  the rollout-rollback quarantine mark
      CURRENT             (+ sidecar)  the version id serving traffic

``model.pkl`` holds the port's own payload: ``FittedPipeline.save``'s
``torch.save`` file (the reference pickles its JAX pipeline there).  The
pointer, the quarantine mark and the version directories are the
reference's byte for byte, so either package reads the other's.

``publish`` writes the artifacts, then the model file, and flips
``CURRENT`` last, so a watcher that sees the new pointer finds a whole
version behind it.  ``load(None)`` (the deploy path) tries current,
then newest to oldest, skipping corrupt, unreadable and quarantined
versions; ``load(version)`` (the forensic path) is strict.

:class:`RegistryWatcher` is what ``cli serve --watch`` runs: poll
``current()``, and when it moves, load that version and its artifacts
and swap them into the fleet (through the guarded rollout when given a
``RolloutConfig`` with a canary fraction).  A failure is logged and
counted, never fatal.
"""

from __future__ import annotations

import io
import json
import logging
import os
import random
import re
import threading
from typing import List, Optional, Tuple

import torch

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.utils import durable

logger = logging.getLogger(__name__)

CURRENT = "CURRENT"
MODEL_FILE = "model.pkl"
ARTIFACTS_DIR = "artifacts"
MANIFEST_FILE = "MANIFEST.json"
#: the quarantine mark: a rollout rollback durably marks the condemned
#: version with ``<vdir>/BAD`` (checksummed like every registry file), so
#: the watcher and the ``load(None)`` deploy walk skip it.  Re-publishing
#: the version id, or an explicit clear, removes it.
BAD_FILE = "BAD"

_VERSION_RE = re.compile(r"^v(\d+)$")


class RegistryError(RuntimeError):
    """A registry operation failed structurally (unknown version, empty
    registry, malformed version id), as opposed to transient I/O
    (retried) or corruption (:class:`~keystone_tpu_torch.utils.durable.CorruptStateError`)."""


def _bytes_writer(data: bytes):
    def _w(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    return _w


def write_artifact_bundle(adir: str, bundle: dict, describe: str = "artifact bundle") -> None:
    """Write an artifact bundle into ``adir`` in the registry layout: one
    checksummed blob per entry, ``MANIFEST.json`` LAST (a crash mid-write
    leaves blobs without a manifest, which ``load_artifacts`` reads as no
    bundle), transient errors retried.  The one writer behind
    ``ModelRegistry.publish(..., artifacts=)`` and ``cli export --out``."""
    os.makedirs(adir, exist_ok=True)
    manifest = bundle.get("manifest") or {}
    blobs = bundle.get("blobs") or {}
    for key, ent in (manifest.get("entries") or {}).items():
        data = blobs.get(key)
        if data is None:
            raise RegistryError(f"artifact bundle entry {key!r} has no blob")
        durable.with_retries(
            lambda p=os.path.join(adir, ent["file"]), d=bytes(data): durable.atomic_write(p, _bytes_writer(d)),
            description=f"{describe}/{key}",
        )
    mtext = json.dumps(manifest, indent=2, sort_keys=True).encode()
    durable.with_retries(
        lambda: durable.atomic_write(os.path.join(adir, MANIFEST_FILE), _bytes_writer(mtext)),
        description=f"{describe} manifest",
    )


class ModelRegistry:
    """Filesystem-backed versioned store of fitted pipelines."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------ paths
    def version_dir(self, version: str) -> str:
        return os.path.join(self.root, version)

    def model_path(self, version: str) -> str:
        return os.path.join(self.version_dir(version), MODEL_FILE)

    def artifacts_dir(self, version: str) -> str:
        return os.path.join(self.version_dir(version), ARTIFACTS_DIR)

    def _current_path(self) -> str:
        return os.path.join(self.root, CURRENT)

    def bad_path(self, version: str) -> str:
        return os.path.join(self.version_dir(version), BAD_FILE)

    # ------------------------------------------------------------ reads
    def versions(self) -> List[str]:
        """Published version ids, oldest to newest (numeric order)."""
        out = []
        try:
            entries = os.listdir(self.root)
        except OSError:
            return []
        for name in entries:
            m = _VERSION_RE.match(name)
            if m and os.path.exists(self.model_path(name)):
                out.append((int(m.group(1)), name))
        return [name for _, name in sorted(out)]

    def quarantined(self, version: str) -> Optional[str]:
        """The quarantine reason when ``version`` carries a ``BAD`` mark,
        else None.  Fail-safe: an unreadable or corrupt mark still counts,
        so a half-written condemnation never re-admits its version."""
        path = self.bad_path(version)
        if not os.path.exists(path):
            return None
        try:
            durable.verify_checksum(path)
            with open(path) as f:
                return f.read().strip() or "quarantined"
        except (OSError, UnicodeDecodeError, durable.CorruptStateError):
            return "quarantined (mark unreadable)"

    def quarantine(self, version: str, reason: str = "") -> None:
        """Durably mark ``version`` bad: a rollout rollback
        (``serve/rollout.py``) calls this so the watcher's next poll and
        the ``load(None)`` deploy walk skip it.  Cleared by re-publishing
        the version id or by :meth:`clear_quarantine`."""
        if not os.path.exists(self.model_path(version)):
            raise RegistryError(f"cannot quarantine unpublished version {version!r}")
        text = (reason or "quarantined").strip() + "\n"
        durable.with_retries(
            lambda: durable.atomic_write(self.bad_path(version), _bytes_writer(text.encode())),
            description=f"registry quarantine {version}",
        )
        metrics.inc("serve.registry_quarantines")
        logger.warning("quarantined %s in registry %s: %s", version, self.root, text.strip())

    def clear_quarantine(self, version: str) -> bool:
        """Remove ``version``'s quarantine mark (the operator's override);
        True when a mark was removed."""
        path = self.bad_path(version)
        removed = False
        for p in (path, path + durable.CHECKSUM_SUFFIX):
            try:
                os.unlink(p)
                removed = True
            except OSError:
                pass
        if removed:
            logger.info("cleared quarantine on %s in registry %s", version, self.root)
        return removed

    def current(self, strict: bool = False) -> Optional[str]:
        """The version id ``CURRENT`` points at (None: nothing published).
        An unreadable or corrupt pointer is "no news" by default;
        ``strict=True`` raises instead (the watcher counts it as a poll
        error and backs off)."""
        path = self._current_path()
        if not os.path.exists(path):
            return None
        try:
            durable.verify_checksum(path)
            with open(path) as f:
                v = f.read().strip()
        except (OSError, UnicodeDecodeError, durable.CorruptStateError) as e:
            if strict:
                raise
            logger.warning("unreadable CURRENT pointer in %s: %s", self.root, e)
            return None
        return v or None

    def _read_model(self, version: str, map_location=None):
        from keystone_tpu_torch.workflow.pipeline import FittedPipeline

        path = self.model_path(version)

        def _read():
            durable.verify_checksum(path)
            return FittedPipeline.load(path, map_location=map_location)

        return durable.with_retries(_read, description=f"registry load {version}")

    def load(self, version: Optional[str] = None, map_location=None) -> Tuple[object, str]:
        """Load a fitted pipeline onto ``map_location`` (default: where it
        was saved from); returns ``(fitted, version)``.

        Explicit ``version``: strict, corruption raises.  ``None``: the
        deploy path: ``current()``, then every published version newest to
        oldest, skipping quarantined (``serve.registry_quarantine_skips``)
        and corrupt or unreadable candidates (a fallback is counted as
        ``serve.registry_fallback``)."""
        if version is not None:
            if version not in self.versions():
                raise RegistryError(f"version {version!r} not in registry {self.root} (have: {self.versions()})")
            fitted = self._read_model(version, map_location)
            metrics.inc("serve.registry_loads")
            return fitted, version
        candidates = []
        cur = self.current()
        if cur:
            candidates.append(cur)
        candidates.extend(v for v in reversed(self.versions()) if v not in candidates)
        if not candidates:
            raise RegistryError(f"registry {self.root} has no versions")
        for i, cand in enumerate(candidates):
            why_bad = self.quarantined(cand)
            if why_bad is not None:
                # as undeployable as a corrupt one; load(version) still
                # reads it for an operator debugging the bad publish
                metrics.inc("serve.registry_quarantine_skips")
                logger.warning("skipping quarantined registry version %s: %s", cand, why_bad)
                continue
            try:
                fitted = self._read_model(cand, map_location)
            except Exception as e:
                logger.warning("skipping unreadable registry version %s: %s", cand, e)
                continue
            metrics.inc("serve.registry_loads")
            if i > 0:
                metrics.inc("serve.registry_fallback")
                logger.warning("serving fallback version %s (newer candidates invalid)", cand)
            return fitted, cand
        raise RegistryError(f"registry {self.root}: no loadable version among {candidates}")

    # ----------------------------------------------------------- writes
    def next_version(self) -> str:
        vs = self.versions()
        n = int(_VERSION_RE.match(vs[-1]).group(1)) + 1 if vs else 1
        return f"v{n:04d}"

    def publish(self, fitted, version: Optional[str] = None, set_current: bool = True,
                artifacts: Optional[dict] = None) -> str:
        """Durably publish a fitted pipeline as a new version and (by
        default) flip ``CURRENT`` to it.  ``artifacts``: its artifact
        bundle (``FrozenApplier.export_artifacts``), written under the
        version before the model file, which lands before the pointer: a
        watcher that sees the new version finds its artifacts whole (or
        absent as a unit)."""
        version = version or self.next_version()
        if not _VERSION_RE.match(version):
            raise RegistryError(f"version ids must look like v0001, got {version!r}")
        os.makedirs(self.version_dir(version), exist_ok=True)
        buf = io.BytesIO()
        torch.save({"config": None, "pipeline": fitted}, buf)
        blob = buf.getvalue()
        if artifacts:
            self._write_artifacts(version, artifacts)
        durable.with_retries(
            lambda: durable.atomic_write(self.model_path(version), _bytes_writer(blob)),
            description=f"registry publish {version}",
        )
        # re-publishing a version id is the operator's word that it is
        # good again: lift the quarantine before the pointer moves
        self.clear_quarantine(version)
        if set_current:
            self.set_current(version)
        metrics.inc("serve.registry_published")
        logger.info("published %s to registry %s", version, self.root)
        return version

    def publish_artifacts(self, version: str, bundle: dict) -> None:
        """Attach an artifact bundle to an already-published version
        (``cli export --model-dir`` without ``--model``)."""
        if not os.path.exists(self.model_path(version)):
            raise RegistryError(f"cannot attach artifacts to unpublished version {version!r}")
        self._write_artifacts(version, bundle)

    def _write_artifacts(self, version: str, bundle: dict) -> None:
        write_artifact_bundle(self.artifacts_dir(version), bundle, describe=f"registry artifact {version}")

    def load_artifacts(self, version: str) -> Optional[dict]:
        """The artifact bundle published with ``version``, or None when it
        has none or its manifest is unreadable.  Corrupt-tolerant: a bad
        manifest drops the whole bundle, a bad blob just its bucket, each
        counted as ``serve.artifact_fallbacks`` and logged, never raised: a
        damaged artifact degrades a deploy to the walk.  The
        ``serve.artifact_load`` fault site fires per file read."""
        adir = self.artifacts_dir(version)
        mpath = os.path.join(adir, MANIFEST_FILE)
        if not os.path.exists(mpath):
            return None
        try:
            fault_point("serve.artifact_load", path=mpath)
            durable.verify_checksum(mpath)
            with open(mpath, "rb") as f:
                manifest = json.loads(f.read().decode())
        except Exception as e:
            metrics.inc("serve.artifact_fallbacks")
            logger.warning("unreadable artifact manifest for %s (%s: %s); the version walks", version,
                           type(e).__name__, e)
            return None
        blobs = {}
        for key, ent in (manifest.get("entries") or {}).items():
            path = os.path.join(adir, str(ent.get("file", "")))
            try:
                fault_point("serve.artifact_load", path=path)
                durable.verify_checksum(path)
                with open(path, "rb") as f:
                    blobs[key] = f.read()
            except Exception as e:
                metrics.inc("serve.artifact_fallbacks")
                logger.warning("skipping unreadable artifact %s/%s (%s: %s); that bucket walks", version, key,
                               type(e).__name__, e)
        if not blobs:
            return None
        return {"manifest": manifest, "blobs": blobs}

    def set_current(self, version: str) -> None:
        if not os.path.exists(self.model_path(version)):
            raise RegistryError(f"cannot point CURRENT at unpublished version {version!r}")
        durable.with_retries(
            lambda: durable.atomic_write(self._current_path(), _bytes_writer((version + "\n").encode())),
            description="registry CURRENT update",
        )


class RegistryWatcher:
    """Poll a registry and hot-swap the service when ``CURRENT`` moves.

    ``cli serve --watch N`` runs one.  A failed poll, load or swap is
    logged and counted (``serve.watch_errors``) and the fleet keeps its
    version; consecutive failures back off exponentially (jittered ±50%,
    capped at ``max_backoff_seconds``; the live wait is the gauge
    ``serve.watch_backoff_seconds``).  ``rollout``: a
    :class:`~keystone_tpu_torch.serve.rollout.RolloutConfig` with a canary
    fraction routes each swap through the guarded rollout (a bad publish
    canaries, rolls back and is quarantined).  A loaded version's tensors
    go to the device the service serves on."""

    def __init__(self, service, registry: ModelRegistry, poll_seconds: float = 5.0, on_swap=None,
                 max_backoff_seconds: float = 300.0, rollout=None):
        self.service = service
        self.registry = registry
        self.poll_seconds = max(0.05, float(poll_seconds))
        self.max_backoff_seconds = max(self.poll_seconds, float(max_backoff_seconds))
        self.on_swap = on_swap
        self.rollout = rollout
        #: once-per-version log damper for quarantined-CURRENT skips
        self._last_quarantine_skip: Optional[str] = None
        self._consecutive_errors = 0
        self._rng = random.Random()  # jitter only
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-registry-watch")

    def start(self) -> "RegistryWatcher":
        self._thread.start()
        return self

    def next_wait(self) -> float:
        """The wait before the next poll: the interval while healthy,
        ``min(cap, interval·2^errors)`` jittered to 50–150% (never below
        the interval) after consecutive failures."""
        if self._consecutive_errors <= 0:
            metrics.set_gauge("serve.watch_backoff_seconds", 0.0)
            return self.poll_seconds
        backoff = min(self.max_backoff_seconds, self.poll_seconds * (2.0 ** min(self._consecutive_errors, 32)))
        wait = min(self.max_backoff_seconds, max(self.poll_seconds, backoff * (0.5 + self._rng.random())))
        metrics.set_gauge("serve.watch_backoff_seconds", wait)
        return wait

    def _loop(self) -> None:
        while not self._stop.wait(self.next_wait()):
            try:
                self._poll_once()
                self._consecutive_errors = 0
            except Exception as e:
                self._consecutive_errors += 1
                metrics.inc("serve.watch_errors")
                logger.warning("registry watch iteration failed (%d consecutive): %s", self._consecutive_errors, e)
                rec = getattr(self.service, "recorder", None)
                if rec is not None:
                    rec.ops("serve.watch_error", error=f"{type(e).__name__}: {e}", n=self._consecutive_errors)

    def _poll_once(self) -> None:
        # strict: a corrupt CURRENT is a poll error (backoff), not "no news"
        cur = self.registry.current(strict=True)
        if not cur or cur == self.service.version:
            return
        why_bad = self.registry.quarantined(cur)
        if why_bad is not None:
            # a rollback condemned exactly this version: "no news", logged
            # once per version
            metrics.inc("serve.watch_quarantine_skips")
            if cur != self._last_quarantine_skip:
                self._last_quarantine_skip = cur
                logger.warning("watcher skipping quarantined CURRENT %s: %s", cur, why_bad)
            return
        fitted, ver = self.registry.load(cur, map_location=self.service.device)
        # best effort: a version without (or with damaged) artifacts walks
        arts = self.registry.load_artifacts(ver)
        if self.rollout is not None and self.rollout.canary is not None:
            from keystone_tpu_torch.serve.rollout import CanaryController

            info = CanaryController(self.service, self.rollout, registry=self.registry).run(
                fitted, version=ver, artifacts=arts)
            if info.get("verdict") != "committed":
                metrics.inc("serve.watch_rollbacks")
                logger.warning("watcher canary of %s rolled back (%s); version quarantined", ver, info.get("reason"))
                if self.on_swap is not None:
                    self.on_swap(info)
                return
        else:
            info = self.service.swap(fitted, version=ver, artifacts=arts)
        metrics.inc("serve.watch_swaps")
        logger.info("watcher swapped in %s (pause %.1f ms)", ver, 1000.0 * info.get("pause_seconds", 0.0))
        rec = getattr(self.service, "recorder", None)
        if rec is not None:
            rec.ops("serve.watch_swap", version=ver, pause_seconds=info.get("pause_seconds", 0.0))
        if self.on_swap is not None:
            self.on_swap(info)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
