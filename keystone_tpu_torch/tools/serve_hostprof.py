"""Where a serving flush's host time goes.

Serves the ImageNetSiftLcsFV scorer (seeded random weights, one
replica, padding buckets 8..128) and drives closed loops of single-image
requests, each run reporting images/s, flushes, requests a flush and:

- ``cpu_s``: the CPU seconds of each group of threads in the serving
  process (``client``, ``front`` (the receivers and senders of process
  clients), ``batcher``, ``replica`` (the flush worker), ``supervisor``,
  ``other``), from per-thread CPU clocks, beside the window's wall
  seconds and the process's total CPU seconds;
- ``flush_ms``: the replica worker's wall milliseconds a flush by step,
  from timers this script wraps round the service's own methods:
  ``stack`` (the riders' rows into one array), ``pad``, ``to_device``
  (the pinned host-to-device copy), ``walk`` (the frozen graph's
  executor walk, which launches the kernels), ``read`` (the read-back,
  which waits for the device), ``deliver`` (the futures and latency
  accounting), ``recorder`` (the flight recorder's hooks on that
  thread), ``rest`` (the remainder of the flush: shedding, metrics, the
  router's and breaker's accounting);
- ``client_submit_ms``: the mean wall milliseconds of one ``submit`` on
  the submitting thread.

The clients run three ways: ``threads`` (client threads in the serving
process, as ``chip_smoke.py``'s S1 drives it), ``threads, no recorder``
and ``processes`` (client processes, each sending raw image bytes over a
pipe to a receiving thread of the serving process and reading the top-5
ids back through a sending thread, so the clients' own Python runs under
another interpreter lock).

    python -m keystone_tpu_torch.tools.serve_hostprof              # on the card, full width
    python -m keystone_tpu_torch.tools.serve_hostprof --device cpu --small --requests 64

Prints one JSON object on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import threading
import time
from collections import defaultdict

import numpy as np

BUCKETS = (8, 16, 32, 64, 128)
FULL = dict(pca_dims=64, gmm_k=256, num_classes=1000, image_hw=128)  # bench.py's widths
SMALL = dict(pca_dims=8, gmm_k=4, num_classes=10, image_hw=32)
POOL = 256  # distinct seeded images the clients cycle through


def build_scorer_service(device="cuda", small=False, recorder=True, max_wait_ms=1.0, queue_bound=4096):
    """A primed one-replica service over the seeded two-branch scorer;
    returns ``(service, images)`` with ``POOL`` seeded uint8 images."""
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    w = SMALL if small else FULL
    dev = resolve_device(device)
    cfg = P.Config(sift_step=4, sift_bin_size=4, lcs_step=6, lcs_subpatch=6, top_k=5)
    params = params_from_numpy(P.random_params(pca_dims=w["pca_dims"], gmm_k=w["gmm_k"],
                                               num_classes=w["num_classes"], seed=0), dev)
    scorer = P.build_scorer_from_params(params, cfg, dev)
    images = np.random.default_rng(0).integers(0, 256, (POOL, w["image_hw"], w["image_hw"], 3), dtype=np.uint8)
    svc = serve(Pipeline.of(scorer).freeze(device=dev), max_batch=BUCKETS[-1], buckets=BUCKETS,
                max_wait_ms=max_wait_ms, queue_bound=queue_bound, example=images[0], recorder=recorder,
                name="hostprof")
    return svc, images


# ------------------------------------------------------------- the timers
class StepTimers:
    """Exclusive wall seconds by (thread group, step): a timed call's
    own time less that of the timed calls inside it, from wrappers
    installed on the serving classes for the life of the context."""

    def __init__(self):
        self.s = defaultdict(float)
        self.n = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()

    def wrap(self, owner, attr: str, step: str, undo: list) -> None:
        fn = getattr(owner, attr)
        timers = self

        def timed(*a, **kw):
            stack = timers._local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                if stack:
                    stack[-1] += dt
                key = (group_of(threading.current_thread().name), step)
                with timers._lock:
                    timers.s[key] += dt - inner
                    timers.n[key] += 1

        setattr(owner, attr, timed)
        undo.append((owner, attr, fn))

    @contextlib.contextmanager
    def installed(self):
        from keystone_tpu_torch.obs.recorder import FlightRecorder
        from keystone_tpu_torch.serve import fleet, service

        undo: list = []
        try:
            # the worker's runner (_run_flush) is bound at start: its
            # _run_batch is looked up a call, so it is the outermost timer
            for attr, step in (("submit", "submit"), ("_run_batch", "rest"), ("_apply_reqs", "stack"),
                               ("_apply_rows", "read"), ("_deliver_completed", "deliver")):
                self.wrap(service.PipelineService, attr, step, undo)
            self.wrap(service, "pad_rows", "pad", undo)
            self.wrap(service, "_to_device", "to_device", undo)
            self.wrap(fleet.Replica, "apply", "walk", undo)
            for attr in ("batch", "batch_update", "annotate", "finish"):
                self.wrap(FlightRecorder, attr, "recorder", undo)
            yield self
        finally:
            for owner, attr, fn in reversed(undo):
                setattr(owner, attr, fn)

    def flush_ms(self, flushes: int) -> dict:
        """The replica worker's exclusive milliseconds a flush by step,
        and their sum (``flush``)."""
        steps = ("stack", "pad", "to_device", "walk", "read", "deliver", "recorder", "rest")
        out = {k: self.s[("replica", k)] * 1e3 / max(1, flushes) for k in steps}
        out["flush"] = sum(out.values())
        return out


def group_of(name: str) -> str:
    for part, group in (("-replica", "replica"), ("-batcher", "batcher"), ("-supervisor", "supervisor"),
                        ("client", "client"), ("front", "front")):
        if part in name:
            return group
    return "other"


class ThreadClocks:
    """CPU seconds by thread group over a window: long-lived threads read
    through their CPU clocks at both ends, the window's own threads
    report theirs (``time.thread_time``) as they end."""

    def __init__(self):
        self.own = defaultdict(float)
        self._lock = threading.Lock()

    @staticmethod
    def _read() -> dict:
        out = {}
        for t in threading.enumerate():
            if t.ident is None or t is threading.current_thread():
                continue
            with contextlib.suppress(OSError, ProcessLookupError):
                out[t.ident] = (t.name, time.clock_gettime(time.pthread_getcpuclockid(t.ident)))
        return out

    def start(self) -> None:
        self._t0, self._w0, self._p0 = self._read(), time.perf_counter(), time.process_time()

    def report(self, seconds: float) -> None:
        with self._lock:
            self.own[group_of(threading.current_thread().name)] += seconds

    def stop(self) -> dict:
        wall, proc = time.perf_counter() - self._w0, time.process_time() - self._p0
        t1 = self._read()
        cpu = defaultdict(float, self.own)
        for ident, (name, c1) in t1.items():
            if ident in self._t0 and group_of(name) not in ("client", "front"):
                cpu[group_of(name)] += c1 - self._t0[ident][1]
        return {"wall_s": wall, "process_cpu_s": proc, "cpu_s": dict(cpu)}


# ------------------------------------------------------------ the clients
def _thread_clients(svc, images, n, clients, window, clocks, lat):
    nxt = iter(range(n))
    lock = threading.Lock()
    errors: list = []

    def client():
        c0 = time.thread_time()
        pending = []
        try:
            while True:
                while len(pending) < window:
                    with lock:
                        i = next(nxt, None)
                    if i is None:
                        break
                    pending.append((i, time.perf_counter(), svc.submit(images[i % len(images)])))
                if not pending:
                    return
                i, t0, fut = pending.pop(0)
                fut.result(timeout=120)
                lat[i] = time.perf_counter() - t0
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            clocks.report(time.thread_time() - c0)

    threads = [threading.Thread(target=client, name=f"client-{j}") for j in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"client threads failed: {errors[:1]}")


def _process_client(conn, n, window, shape, seed):
    """One client process: ``n`` requests, ``window`` outstanding, raw
    uint8 image bytes out and top-5 id bytes back, in order."""
    imgs = np.random.default_rng(seed).integers(0, 256, (POOL,) + tuple(shape), dtype=np.uint8)
    conn.recv()  # go
    sent, lat, t_sent = 0, [], {}
    for got in range(n):
        while sent < n and sent - got < window:
            t_sent[sent] = time.perf_counter()
            conn.send_bytes(imgs[sent % POOL].tobytes())
            sent += 1
        conn.recv_bytes()
        lat.append(time.perf_counter() - t_sent.pop(got))
    conn.send(lat)
    conn.close()


def _process_clients(svc, shape, n, clients, window, clocks, lat):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    per = n // clients
    pairs = [ctx.Pipe() for _ in range(clients)]
    procs = [ctx.Process(target=_process_client, args=(child, per, window, shape, 1 + j), daemon=True)
             for j, (_, child) in enumerate(pairs)]
    for p in procs:
        p.start()
    errors: list = []

    def receiver(conn, futs):
        c0 = time.thread_time()
        try:
            for _ in range(per):
                futs.put(svc.submit(np.frombuffer(conn.recv_bytes(), np.uint8).reshape(shape)))
        except Exception as e:  # reported below
            errors.append(e)
            futs.put(None)
        finally:
            clocks.report(time.thread_time() - c0)

    def sender(conn, futs):
        c0 = time.thread_time()
        try:
            for _ in range(per):
                fut = futs.get(timeout=120)
                if fut is None:
                    return
                conn.send_bytes(np.ascontiguousarray(fut.result(timeout=120)).tobytes())
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            clocks.report(time.thread_time() - c0)

    threads = []
    for j, (conn, _) in enumerate(pairs):
        futs: queue.Queue = queue.Queue()
        threads += [threading.Thread(target=receiver, args=(conn, futs), name=f"front-recv-{j}"),
                    threading.Thread(target=sender, args=(conn, futs), name=f"front-send-{j}")]
    for t in threads:
        t.start()
    clocks.start()
    for conn, _ in pairs:
        conn.send("go")
    for t in threads:
        t.join(timeout=600)
    for j, (conn, _) in enumerate(pairs):
        if conn.poll(120):
            lat[j * per:(j + 1) * per] = conn.recv()
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"process clients failed: {errors[:1]}")
    return per * clients


def run(svc, images, mode: str, n: int, clients: int, window: int) -> dict:
    """One closed loop under the timers; the report of one mode."""
    from keystone_tpu_torch.obs import metrics

    lat = [0.0] * n
    clocks = ThreadClocks()
    b0 = metrics.REGISTRY.counter_total("serve.batches")
    with StepTimers().installed() as timers:
        if mode == "processes":
            n = _process_clients(svc, images.shape[1:], n, clients, window, clocks, lat)
            lat = lat[:n]
        else:
            clocks.start()
            _thread_clients(svc, images, n, clients, window, clocks, lat)
        window_clock = clocks.stop()
    flushes = int(metrics.REGISTRY.counter_total("serve.batches") - b0)
    submits = timers.n[("client", "submit")] + timers.n[("front", "submit")]
    submit_s = timers.s[("client", "submit")] + timers.s[("front", "submit")]
    return {
        "mode": mode, "requests": n, "clients": clients, "outstanding_per_client": window,
        "images_per_s": n / window_clock["wall_s"], "flushes": flushes, "requests_per_flush": n / max(1, flushes),
        "p50_ms": float(np.percentile(lat, 50) * 1e3), "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "wall_ms_per_flush": window_clock["wall_s"] * 1e3 / max(1, flushes),
        "flush_ms": timers.flush_ms(flushes),
        "client_submit_ms": submit_s * 1e3 / max(1, submits),
        **window_clock,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="narrow widths (a check on the CPU)")
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--window", type=int, default=32, help="requests outstanding a client at saturation")
    ap.add_argument("--low-requests", type=int, default=512, help="requests of the one-outstanding loops")
    args = ap.parse_args(argv)
    report = {"device": args.device, "small": args.small, "runs": []}
    for recorder in (True, False):
        svc, images = build_scorer_service(args.device, args.small, recorder=recorder)
        try:
            modes = ("threads", "processes") if recorder else ("threads",)
            for mode in modes:
                run(svc, images, mode, 4 * args.clients * min(args.window, 4), args.clients, args.window)  # warm-up
                for n, window in ((args.requests, args.window), (args.low_requests, 1)):
                    r = run(svc, images, mode, n, args.clients, window)
                    r["recorder"] = recorder
                    report["runs"].append(r)
                    print(json.dumps(r), flush=True)
        finally:
            svc.close(timeout=120)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
