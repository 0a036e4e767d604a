"""One replica's serve loop: the worker-process side of the process fleet
(counterpart of ``keystone_tpu/serve/worker.py``).

``worker_main`` is the spawn target of
:class:`~keystone_tpu_torch.serve.procfleet.WorkerHandle`: it loads the
deploy payload the router staged (the fitted pipeline and, optionally,
its artifact bundle, one ``torch.save`` file) onto the device the spec
names (``cuda`` unless the caller asks for ``cpu``), freezes it there,
installs the bundle, primes every padding bucket (with a bundle, each
bucket's first call captures that bucket's CUDA graph in THIS process),
beats a shared-memory heartbeat, answers ``ready``, and then serves
``apply`` frames until the router says ``bye`` or the control pipe dies
with it.

The worker owns the CUDA context of its replica: the router holds no
weights on the card for a process fleet, and N workers drive the card
from N interpreters, so the host work of a flush (the copy in, the
executor walk or the graph replay, the read-back) runs past the
router's GIL.  Several workers on one card each hold a context; without
an MPS daemon their kernels take turns on the card.

Protocol (``serve/wire.py``; strict request/response, one in flight):

- ``{"op": "apply", "ref": <slab ref>, "n": k, "deadline_s": t|null}``
  → ``{"op": "result", "ref": <slab ref>, "seconds": dt}``: the input
  reference names a slab of the ROUTER's pool (or an ingress admission
  block's slab), the result reference one of this worker's pool (each
  side owns and unlinks its own slabs).  The result holds the first k
  rows.
- a failed apply answers ``{"op": "error", "kind", "etype", "emsg"}``,
  where ``kind`` carries the error taxonomy across the boundary
  (``deadline``, ``oserror``, ``memory``, ``circuit``, ``too_large`` or
  ``content``, the bisectable family), so poison isolation and breaker
  charging behave as they do in one process.  The port's kernel
  failures (``KernelError``) and the card's ``OutOfMemoryError`` ride
  ``oserror`` and ``memory``: infrastructure, never bisected.
- ``{"op": "ping"}`` → ``{"op": "pong", "pid": ...}``; ``{"op": "bye"}``
  ends the loop.

Every reply's ``telemetry`` carries the worker's kernel report
(:func:`kernel_report`): its wrappers' launches (``ops/fisher_kernels``,
``ops/gram_kernels``), the launches its bucket graphs replayed
(``utils/graphs.REPLAYED``) and its peak reserved device memory, so the
router counts the kernels that ran in its workers.

Workers are always started with the ``spawn`` method: a forked child
must never touch the parent's CUDA context.  A worker takes over the
router's numerics (:func:`process_settings`: its CPU thread count, its
TF32 flags, its descriptor stream mode), so its results round as the
router's threaded fleet's would.
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import threading
import time

import numpy as np

from keystone_tpu_torch.serve import wire
from keystone_tpu_torch.serve.telemetry import WorkerTelemetry

logger = logging.getLogger(__name__)

#: how often the worker refreshes its shared heartbeat slot
#: (``time.monotonic`` is CLOCK_MONOTONIC on Linux: one clock for the
#: router and its workers)
HEARTBEAT_INTERVAL_S = 0.25


def classify_error(exc: BaseException) -> str:
    """The cross-process error taxonomy (``serve/service.py``'s
    ``_poison_suspect`` contract, serialized): infrastructure rides
    ``oserror`` (the port's kernel failures too), capacity ``memory``
    (the card's out-of-memory too), sheds ``deadline``; everything else
    is ``content``, the bisectable family."""
    import torch

    from keystone_tpu_torch.kernels.build import KernelError
    from keystone_tpu_torch.utils import guard

    if isinstance(exc, wire.PayloadTooLarge):
        # an oversized RESULT (the request fit, its output overflowed the
        # slab cap): the router raises the same typed refusal
        return "too_large"
    if isinstance(exc, guard.DeadlineExceeded):
        return "deadline"
    if isinstance(exc, guard.CircuitOpenError):
        return "circuit"
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "memory"
    if isinstance(exc, (OSError, KernelError)):
        return "oserror"
    return "content"


def load_payload(source, device):
    """A staged deploy payload (a path, or its bytes from the network
    fleet's deploy frame) loaded with every tensor on ``device``."""
    import torch

    f = io.BytesIO(source) if isinstance(source, (bytes, bytearray, memoryview)) else source
    payload = torch.load(f, map_location=device, weights_only=False)
    if not isinstance(payload, dict) or "pipeline" not in payload:
        raise TypeError("not a staged worker payload")
    return payload


def _build_applier(payload: dict, device):
    """Freeze the staged pipeline for ``device`` and install its artifact
    bundle, whole or not at all.  A bundle that does not install (skew, a
    CPU worker: a CUDA graph needs the card) is logged and the walk
    serves: a worker comes up serving.  The router counts it once, from
    the ready frame's ``artifact_buckets`` (``ReplicaPool.
    _count_worker_install``); a count here would reach the router a
    second time through the worker's telemetry."""
    from keystone_tpu_torch.utils.hashing import pipeline_fingerprint
    from keystone_tpu_torch.workflow.pipeline import FrozenApplier

    pipeline = payload["pipeline"]
    if isinstance(pipeline, FrozenApplier):
        if pipeline.device.type != device.type:
            raise ValueError(f"an applier frozen for {pipeline.device} cannot serve on {device}: stage the "
                             "fitted pipeline, and each worker freezes it for its own device")
        pipeline.device = device
        applier = pipeline
        sig = applier.fingerprint() if payload.get("artifacts") else None
    else:
        applier = FrozenApplier(pipeline, device=device)
        sig = pipeline_fingerprint(pipeline) if payload.get("artifacts") else None
    installed = 0
    artifacts = payload.get("artifacts")
    if artifacts:
        try:
            installed = applier.install_artifacts(artifacts, device=device, signature=sig, strict=True)
        except Exception as e:
            logger.warning("worker artifact install failed (%s: %s); the walk serves", type(e).__name__, e)
    return applier, installed


class WorkerApplier:
    """The worker's frozen applier on its device and its own CUDA stream
    (a capture cannot run on the default stream): host rows in, the
    first ``n`` output rows back on the host."""

    def __init__(self, applier, device):
        import torch

        self.applier = applier
        self.device = device
        self.stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None

    def on_stream(self):
        import torch

        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def __call__(self, arr: np.ndarray, n: int, deadline=None) -> np.ndarray:
        """Copy the host batch to the device (pinned, on the worker's
        stream), apply, and read the first ``n`` rows back."""
        from keystone_tpu_torch.workflow.dataset import Dataset, _to_device

        with self.on_stream():
            out = self.applier(Dataset(_to_device(arr, self.device), n=int(n)), deadline=deadline)
            return out.array[: int(n)].cpu().numpy()

    def installed_buckets(self) -> int:
        return self.applier.installed_buckets()


def _prime(wa: WorkerApplier, buckets, item_shape, dtype) -> int:
    """Run every padding bucket through the applier, the shapes the router
    will dispatch (with a bundle, each bucket's first call captures its
    graph).  A pipeline that declares degradation also warms the
    deadline-carrying walk, as the in-process service does."""
    from keystone_tpu_torch.utils import guard

    if not buckets or item_shape is None:
        return 0
    n = 0
    for b in buckets:
        zeros = np.zeros((int(b),) + tuple(item_shape), np.dtype(dtype))
        wa(zeros, int(b))
        n += 1
        if wa.applier._degradable and wa.installed_buckets():
            wa(zeros, int(b), deadline=guard.Deadline.after(86400.0))
            n += 1
    return n


def worker_device(spec: dict):
    """The device a worker serves on: ``spec["device"]``, the card by
    default.  A CUDA device that is not there raises: a worker never
    falls back to the CPU."""
    from keystone_tpu_torch.utils.device import resolve_device

    return resolve_device(spec.get("device") or "cuda")


def process_settings() -> dict:
    """The router's process-wide numerics a worker takes over, so that its
    results round as the router's threaded fleet's would: the CPU thread
    count (reductions split by it), the TF32 flags of cuBLAS and cuDNN,
    and the descriptor stream mode (``utils/precision.py``)."""
    import torch

    from keystone_tpu_torch.utils import precision

    return {"num_threads": torch.get_num_threads(), "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "tf32_cudnn": bool(torch.backends.cudnn.allow_tf32), "matmul_mode": precision.matmul_mode()}


def setup_worker(spec: dict):
    """The worker's process-wide settings from its spec (those of
    :func:`process_settings` the router sent) and its device."""
    import torch

    from keystone_tpu_torch.utils import precision

    threads = spec.get("num_threads")
    if threads:
        torch.set_num_threads(int(threads))
    if "tf32_matmul" in spec:
        torch.backends.cuda.matmul.allow_tf32 = bool(spec["tf32_matmul"])
    if "tf32_cudnn" in spec:
        torch.backends.cudnn.allow_tf32 = bool(spec["tf32_cudnn"])
    if spec.get("matmul_mode"):
        precision.set_matmul(spec["matmul_mode"])
    device = worker_device(spec)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    return device


def kernel_report(device) -> dict:
    """What this worker process's kernels did: the wrappers' launches,
    the launches its bucket graphs replayed, and its peak reserved device
    memory (bytes; 0 on the CPU).  Cumulative over the process."""
    import torch

    from keystone_tpu_torch.ops import fisher_kernels, gram_kernels
    from keystone_tpu_torch.utils import graphs

    peak = int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0
    return {"pid": os.getpid(), "device": str(device),
            "launches": {**fisher_kernels.LAUNCHES, **gram_kernels.LAUNCHES},
            "replayed": dict(graphs.REPLAYED), "peak_reserved_bytes": peak}


def build_from_payload(payload: dict, spec: dict, device, tel=None):
    """The cold start shared by both worker transports (the pipe-spawned
    process worker and the TCP worker of ``serve/net.py``): freeze the
    pipeline on ``device``, install its bundle, prime every padding
    bucket.  Returns ``(worker applier, installed, primed)``.  ``tel``
    records ``worker.build`` / ``worker.prime`` spans for the ready
    frame."""
    span = tel.span if tel is not None else (lambda _name, **_a: contextlib.nullcontext())
    with span("worker.build"):
        applier, installed = _build_applier(payload, device)
        wa = WorkerApplier(applier, device)
    with span("worker.prime"):
        primed = _prime(wa, spec.get("buckets"), spec.get("item_shape"), spec.get("dtype") or "float32")
    return wa, installed, primed


def _artifact_keys(wa) -> list:
    """The (shape, dtype) keys of the installed bucket programs, shipped on
    the ready frame so the router labels its prime samples for a remote
    replica."""
    progs = getattr(getattr(wa, "applier", wa), "_bucket_programs", None) or {}
    out = []
    for shape, dtype in progs:
        out.append([list(shape), np.dtype(dtype).str])
    return out


def _deadline(msg: dict):
    from keystone_tpu_torch.utils import guard

    deadline_s = msg.get("deadline_s")
    return None if deadline_s is None else guard.Deadline.after(float(deadline_s))


def worker_main(conn, spec: dict) -> None:
    """The worker process entry point (spawned by ``WorkerHandle``).

    ``conn``: the worker end of the control pipe.  ``spec``: plain data:
    ``name``/``index`` (labels), ``payload_path``, ``device`` (default
    ``cuda``), ``num_threads``, ``buckets``/``item_shape``/``dtype`` (the
    prime set; no item shape skips priming), ``max_slab_bytes``, and
    ``heartbeat`` (a shared ``multiprocessing.Value('d')`` this loop
    refreshes)."""
    hb = spec.get("heartbeat")
    stop_beating = threading.Event()

    def beat_loop():
        while not stop_beating.wait(HEARTBEAT_INTERVAL_S):
            hb.value = time.monotonic()

    if hb is not None:
        hb.value = time.monotonic()
        threading.Thread(target=beat_loop, daemon=True, name="hb").start()

    # the response pool honours the router's slab cap: a result wider than
    # the default must not turn into a bisectable content error
    pool = wire.SlabPool(prefix=f"{spec.get('name', 'serve')}-w",
                         max_slab_bytes=int(spec.get("max_slab_bytes") or wire.DEFAULT_MAX_SLAB_BYTES))
    attacher = wire.SlabAttacher()
    device = None
    tel = None
    t0 = time.monotonic()
    try:
        device = setup_worker(spec)
        tel = WorkerTelemetry(report=lambda: kernel_report(device))
        with tel.span("worker.load"):
            payload = load_payload(spec["payload_path"], device)
        wa, installed, primed = build_from_payload(payload, spec, device, tel=tel)
        del payload
    except BaseException as e:
        try:
            wire.send_frame(conn, {"op": "fatal", "etype": type(e).__name__, "emsg": str(e)[:800]})
        except (OSError, ValueError):
            pass
        pool.close()
        stop_beating.set()
        return
    wire.send_frame(conn, {
        "op": "ready",
        "pid": os.getpid(),
        "device": str(device),
        "primed": primed,
        "artifact_buckets": installed,
        "artifact_keys": _artifact_keys(wa),
        "startup_seconds": round(time.monotonic() - t0, 3),
        "telemetry": tel.ship(t_rx=t0),
    })

    held: list = []  # response slabs, reusable once the NEXT frame lands
    try:
        while True:
            try:
                msg = wire.recv_frame(conn)
            except (EOFError, OSError):
                return  # the router died; nothing to serve for
            # strict request/response: the router sent this frame after
            # reading the previous response, so its slab is free again
            while held:
                pool.release(held.pop())
            op = msg.get("op")
            if op == "bye":
                try:
                    wire.send_frame(conn, {"op": "bye_ack"})
                except (OSError, ValueError):
                    pass
                return
            if op == "ping":
                wire.send_frame(conn, {"op": "pong", "pid": os.getpid()})
                continue
            if op != "apply":
                wire.send_frame(conn, {"op": "error", "kind": "content", "etype": "WireError",
                                       "emsg": f"unknown op {op!r}"})
                continue
            t_apply = time.monotonic()
            try:
                with tel.span("worker.attach"):
                    # the card's copy in goes through pinned memory, which
                    # copies the view; the CPU reads a copy it owns
                    arr = attacher.view(msg["ref"]) if device.type == "cuda" else attacher.read(msg["ref"])
                n = int(msg.get("n", arr.shape[0]))
                with tel.span("worker.apply", n=n):
                    result = wa(arr, n, deadline=_deadline(msg))
                del arr
                slab, ref = wire.write_array(pool, result)
            except BaseException as e:
                wire.send_frame(conn, {
                    "op": "error", "kind": classify_error(e), "etype": type(e).__name__, "emsg": str(e)[:800],
                    "seconds": round(time.monotonic() - t_apply, 6), "telemetry": tel.ship(t_rx=t_apply),
                })
                continue
            held.append(slab)
            wire.send_frame(conn, {"op": "result", "ref": ref, "seconds": round(time.monotonic() - t_apply, 6),
                                   "telemetry": tel.ship(t_rx=t_apply)})
    finally:
        stop_beating.set()
        attacher.close()
        pool.close()
        try:
            conn.close()
        except OSError:
            pass
