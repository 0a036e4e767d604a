"""The serving fleet's host map (counterpart of the ``HostMap`` half of
``keystone_tpu/utils/hostmap.py``): the machines a network fleet
(``serve/net.py``) may spawn ``python -m keystone_tpu_torch.cli worker``
processes on, with each host's slot budget, which the autoscaler's
``add_replica`` respects.  Local hosts spawn directly, remote ones
through an ssh command.  The map only spawns: a worker registers when it
dials the router's listener, so one started by hand joins the same way.

The reference's other half, the process pool its host text stage maps
over, has no counterpart: the port's host text stage maps in turn.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

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
