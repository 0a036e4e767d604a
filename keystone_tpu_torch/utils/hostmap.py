"""Where host-side work runs (counterpart of
``keystone_tpu/utils/hostmap.py``), at two scales.

**Per-item maps on this host's cores** (:func:`host_map`): the host text
stage (tokenize → n-gram → tf → featurize) is pure Python, so threads
cannot run it in parallel (the GIL serializes them).  Workers here are
processes, with two deliberate choices:

- **the forkserver start method** (spawn where there is none), never
  fork: the calling process may hold a CUDA context, and a child forked
  from it cannot use CUDA and inherits the runtime's locked threads.  The
  forkserver's server process is fresh and this module imports nothing
  heavy, so workers start clean; torch enters a worker only when the
  mapped callable's module imports it while unpickling, and a worker
  never touches the card;
- **one persistent pool a process**, not a pool a call: a streamed sweep
  calls ``host_map`` once a stage a batch, and pools made per call would
  pay the workers' start-up thousands of times.  Tasks carry the pickled
  callable each time and workers cache it by digest.

Sizing: ``KEYSTONE_HOST_WORKERS`` overrides; the default is the CPU
count.  With 1 worker, small inputs or an unpicklable callable the map
is plain sequential.

**The serving fleet's host map** (:class:`HostMap`): the machines a
network fleet (``serve/net.py``) may spawn ``python -m
keystone_tpu_torch.cli worker`` processes on, with each host's slot
budget, which the autoscaler's ``add_replica`` respects.  Local hosts
spawn directly, remote ones through an ssh command.  The map only spawns:
a worker registers when it dials the router's listener, so one started
by hand joins the same way.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import pickle
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

_EXECUTOR = None
#: host_map is called from stream producer threads as well as the main
#: thread; the lock keeps two racing callers from each building (and one
#: orphaning) a worker pool
_EXECUTOR_LOCK = threading.Lock()
_EXECUTOR_WORKERS = 0
_POOL_WARNED = False
_POOL_SIZE_NOTED = False

#: worker side: digest → unpickled callable (a vocabulary model unpickles
#: once a worker, not once a batch), bounded so that a sweep of many
#: fitted models does not grow a worker without limit
_FN_CACHE: Dict[bytes, Callable] = {}
_FN_CACHE_CAP = 8


def host_workers() -> int:
    env = os.environ.get("KEYSTONE_HOST_WORKERS")
    if env is not None:
        try:
            return max(1, int(env))
        except ValueError:
            logger.warning("KEYSTONE_HOST_WORKERS=%r is not an integer; using 1", env)
            return 1
    return os.cpu_count() or 1


def _run_task(digest: bytes, fn_bytes: bytes, chunk: list) -> list:
    fn = _FN_CACHE.get(digest)
    if fn is None:
        fn = pickle.loads(fn_bytes)
        while len(_FN_CACHE) >= _FN_CACHE_CAP:
            _FN_CACHE.pop(next(iter(_FN_CACHE)))  # oldest first
        _FN_CACHE[digest] = fn
    return [fn(x) for x in chunk]


def _get_executor(workers: int):
    """(executor, its worker count), or (None, 0) where no pool can be
    made.  The pool is made once a process; a later caller asking for
    another size reuses it (noted once) rather than restarting workers."""
    global _EXECUTOR, _EXECUTOR_WORKERS, _POOL_WARNED, _POOL_SIZE_NOTED
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None:
            # an explicit forkserver or spawn context below, never fork
            import multiprocessing as mp  # lint: allow-proc-spawn
            from concurrent.futures import ProcessPoolExecutor

            method = "forkserver" if "forkserver" in mp.get_all_start_methods() else "spawn"
            try:
                _EXECUTOR = ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context(method))
            except Exception:
                if not _POOL_WARNED:
                    logger.warning("host_map worker pool unavailable; mapping sequentially", exc_info=True)
                    _POOL_WARNED = True
                return None, 0
            _EXECUTOR_WORKERS = workers
            atexit.register(shutdown)
        elif workers != _EXECUTOR_WORKERS and not _POOL_SIZE_NOTED:
            logger.info("host_map pool already sized at %d workers; a request for %d reuses it "
                        "(one pool a process)", _EXECUTOR_WORKERS, workers)
            _POOL_SIZE_NOTED = True
        return _EXECUTOR, _EXECUTOR_WORKERS


def pool_workers() -> int:
    """The live pool's worker count; 0 when there is none (maps run in turn)."""
    with _EXECUTOR_LOCK:
        return _EXECUTOR_WORKERS if _EXECUTOR is not None else 0


def shutdown() -> None:
    """Stop the worker pool (idempotent; a later host_map starts another)."""
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is not None:
            _EXECUTOR.shutdown(wait=False, cancel_futures=True)
            _EXECUTOR = None


def host_map(fn: Callable, items: Sequence, workers: Optional[int] = None, min_items: int = 512) -> List:
    """``[fn(x) for x in items]``, over the persistent worker pool when the
    input is large enough to pay for the tasks.  Order is kept and the
    results are the sequential map's.  Sequential for small inputs, one
    worker, an unpicklable callable, and a pool that cannot be made or
    breaks.  An exception ``fn`` raises propagates unchanged, as the
    sequential map would raise it: a data error is neither retried nor
    demoted."""
    items = items if isinstance(items, list) else list(items)
    w = host_workers() if workers is None else max(1, int(workers))
    if w <= 1 or len(items) < max(min_items, 2):
        return [fn(x) for x in items]
    try:
        fn_bytes = pickle.dumps(fn)
    except Exception:
        # closures and lambdas: sequential rather than failing the map
        return [fn(x) for x in items]
    ex, pool_w = _get_executor(w)
    if ex is None:
        return [fn(x) for x in items]
    from concurrent.futures import CancelledError
    from concurrent.futures.process import BrokenProcessPool

    digest = hashlib.blake2b(fn_bytes, digest_size=16).digest()
    # ~2 chunks a worker of the pool's actual size: smooths stragglers
    # without multiplying the callable's transfer
    chunk = max(1, -(-len(items) // (pool_w * 2)))
    chunks = [items[i:i + chunk] for i in range(0, len(items), chunk)]
    try:
        futures = [ex.submit(_run_task, digest, fn_bytes, c) for c in chunks]
        out: List = []
        for f in futures:
            out.extend(f.result())
        return out
    except (BrokenProcessPool, CancelledError, RuntimeError) as e:
        # a worker died, or a concurrent caller saw the same broken pool
        # first and shut it down (submit then raises RuntimeError and the
        # pending futures cancel): finish this map sequentially and let
        # the next call build a fresh pool.  A RuntimeError fn raised
        # itself is a data error and propagates (BrokenProcessPool is a
        # RuntimeError too, so it is tested first)
        if not isinstance(e, (BrokenProcessPool, CancelledError)) and "schedule new futures" not in str(e):
            raise
        logger.warning("host_map worker pool broke; completing this map sequentially and rebuilding "
                       "the pool on next use")
        shutdown()
        return [fn(x) for x in items]


# ---------------------------------------------------------- fleet host map

#: names that mean "this machine" — spawned directly, no ssh hop
LOCAL_HOSTS = frozenset({"local", "localhost", "127.0.0.1"})


class HostCapacityError(RuntimeError):
    """Every host in the map is at its slot budget.  A ``RuntimeError``
    — capacity exhaustion is an operator-visible limit, not transient
    infrastructure the retry ladder should absorb."""


class HostEntry:
    """One machine the fleet may spawn workers on: a host name and a
    slot budget (``None`` = unbounded)."""

    __slots__ = ("host", "slots", "spawned")

    def __init__(self, host: str, slots: Optional[int] = None):
        self.host = str(host)
        self.slots = None if slots is None else max(1, int(slots))
        self.spawned: list = []  # live subprocess.Popen handles

    @property
    def local(self) -> bool:
        return self.host in LOCAL_HOSTS

    def in_flight(self) -> int:
        self.spawned = [p for p in self.spawned if p.poll() is None]
        return len(self.spawned)

    def has_room(self) -> bool:
        return self.slots is None or self.in_flight() < self.slots


def parse_hosts(spec) -> List[HostEntry]:
    """The ``--hosts`` grammar: ``host[:slots]`` entries, comma
    separated — ``"local:2,10.0.0.5:4"`` — or an already-split list of
    entry strings / ``(host, slots)`` pairs.  A bare host has an
    unbounded slot budget."""
    if isinstance(spec, str):
        parts: Sequence = [p for p in spec.split(",") if p.strip()]
    else:
        parts = list(spec)
    entries: List[HostEntry] = []
    for part in parts:
        if isinstance(part, HostEntry):
            entries.append(part)
            continue
        if isinstance(part, (tuple, list)) and len(part) == 2:
            entries.append(HostEntry(part[0], part[1]))
            continue
        text = str(part).strip()
        host, _, slots = text.partition(":")
        if not host:
            raise ValueError(f"empty host in hosts spec {spec!r}")
        try:
            entries.append(HostEntry(host, int(slots) if slots else None))
        except ValueError:
            raise ValueError(
                f"bad slot count {slots!r} for host {host!r} "
                f"(want host[:slots])"
            ) from None
    if not entries:
        raise ValueError(f"hosts spec {spec!r} names no hosts")
    return entries


class HostMap:
    """The serving fleet's machine registry: where ``add_replica`` may
    spawn ``cli worker --connect`` processes, and how many per
    host.  Local hosts spawn directly; remote hosts go through an ssh
    command template (overridable — site launchers vary).  The map only
    SPAWNS; registration happens when the worker dials the router's
    listener, so a worker started by hand (or by an operator on a host
    this map has never heard of) joins identically."""

    def __init__(
        self,
        hosts,
        python: Optional[str] = None,
        ssh_command: Optional[Sequence[str]] = None,
    ):
        import sys

        self.entries = parse_hosts(hosts)
        self.python = python or sys.executable
        #: the hop for non-local hosts; BatchMode so a missing key fails
        #: fast instead of prompting inside a serving control plane
        self.ssh_command = list(
            ssh_command
            if ssh_command is not None
            else ("ssh", "-o", "BatchMode=yes")
        )
        self._lock = threading.Lock()
        self._seq = 0

    def capacity(self) -> Optional[int]:
        """Total slot budget, or ``None`` when any host is unbounded —
        the autoscaler clamps its scale-up target to this."""
        total = 0
        for e in self.entries:
            if e.slots is None:
                return None
            total += e.slots
        return total

    def in_flight(self) -> int:
        with self._lock:
            return sum(e.in_flight() for e in self.entries)

    def _pick(self, allow_overflow: bool = False) -> HostEntry:
        """Least-loaded host with a free slot (ties break in map
        order, so the first-listed host fills first at equal load).

        ``allow_overflow``: when every budget is full, fall back to the
        least-loaded host anyway.  This is the blue/green swap's
        transient allowance — a staged generation COEXISTS with the old
        one it replaces until commit, so a slot budget sized to the
        steady-state fleet would otherwise fail every swap.  Steady
        consumers (the autoscaler, heals) keep the hard budget."""
        best: Optional[HostEntry] = None
        for e in self.entries:
            if not e.has_room():
                continue
            if best is None or e.in_flight() < best.in_flight():
                best = e
        if best is None and allow_overflow:
            best = min(self.entries, key=lambda e: e.in_flight())
            import logging

            logging.getLogger(__name__).info(
                "host slot budgets full; overflowing swap spawn onto %s "
                "(transient: the replaced generation retires at commit)",
                best.host,
            )
        if best is None:
            raise HostCapacityError(
                f"all {len(self.entries)} host(s) are at their slot "
                f"budget (capacity {self.capacity()})"
            )
        return best

    def _command(self, entry: HostEntry, args: List[str]) -> List[str]:
        local_cmd = [self.python, "-m", "keystone_tpu_torch.cli", "worker"] + args
        if entry.local:
            return local_cmd
        return self.ssh_command + [entry.host] + local_cmd

    def spawn(
        self,
        connect_address: str,
        worker_name: Optional[str] = None,
        extra_args: Sequence[str] = (),
        allow_overflow: bool = False,
    ):
        """Start one ``cli worker`` pointed at the router's
        listener; returns the ``subprocess.Popen``.  The child inherits
        this environment (so ``KEYSTONE_FAULTS`` plans and platform
        pins propagate exactly as they do to pipe-spawned workers).
        ``allow_overflow`` exempts this spawn from the slot budget —
        the swap path's transient allowance (see :meth:`_pick`)."""
        import subprocess

        with self._lock:
            entry = self._pick(allow_overflow=allow_overflow)
            self._seq += 1
            name = worker_name or f"{entry.host}-w{self._seq}"
            args = ["--connect", str(connect_address), "--name", name]
            args.extend(extra_args)
            cmd = self._command(entry, args)
            proc = subprocess.Popen(cmd, env=dict(os.environ))
            entry.spawned.append(proc)
        import logging

        logging.getLogger(__name__).info(
            "spawned worker %s on %s (pid %d)", name, entry.host, proc.pid
        )
        return proc

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity(),
                "in_flight": sum(e.in_flight() for e in self.entries),
                "hosts": [
                    {
                        "host": e.host,
                        "slots": e.slots,
                        "in_flight": e.in_flight(),
                    }
                    for e in self.entries
                ],
            }

    def close(self, timeout: float = 3.0) -> None:
        """Reap every spawned worker: terminate, short grace, kill.
        Workers also exit on their own when the router's listener goes
        away (their reconnect budget runs dry), but a closing pool must
        not leave children to that slow path."""
        with self._lock:
            procs = [p for e in self.entries for p in e.spawned]
            for e in self.entries:
                e.spawned = []
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + max(0.2, timeout)
        for p in procs:
            remain = deadline - time.monotonic()
            try:
                p.wait(max(0.05, remain))
            except Exception:
                try:
                    p.kill()
                    p.wait(1.0)
                except Exception:
                    pass
