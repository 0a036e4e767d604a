"""What a kernel wrapper tells a CUDA-graph capture in progress on its
thread (the frozen applier's bucket graphs, ``workflow/pipeline.py``).

A graph replays its kernels by address, so a tensor a wrapper reads from
a cache of its own (``ops/fisher_kernels.py::_weights_for``) must live
as long as the graph: the wrapper hands it to :func:`keep`, and the
capture holds it.  A launch recorded into a graph runs no kernel, so the
wrapper does not count it in its ``LAUNCHES``: it reports it with
:func:`note_launch`, the capture records it, and each replay adds the
graph's recorded launches to :data:`REPLAYED` (what a run reads beside
the wrappers' counts: kernels that ran = ``LAUNCHES`` + ``REPLAYED``).
"""

from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager

#: kernel launches made by graph replays, by wrapper name (each replay
#: adds its graph's launches recorded at capture); ``reset_replayed``
REPLAYED: Counter = Counter()
_REPLAYED_LOCK = threading.Lock()

#: one capture at a time in the process: a capture's setup must not
#: interleave with another thread's
CAPTURE_LOCK = threading.Lock()

_TLS = threading.local()


class CaptureRecord:
    """What one capture saw: the tensors to keep alive with the graph,
    and the kernel launches recorded into it, by wrapper name."""

    __slots__ = ("kept", "launches")

    def __init__(self):
        self.kept: list = []
        self.launches: Counter = Counter()


@contextmanager
def recording():
    """Record the wrappers' launches and kept tensors on this thread for
    the duration (the capture's body)."""
    rec = CaptureRecord()
    prev = getattr(_TLS, "record", None)
    _TLS.record = rec
    try:
        yield rec
    finally:
        _TLS.record = prev


def keep(*objs) -> None:
    """Hold ``objs`` for as long as the graph being captured on this
    thread lives (nothing outside a capture)."""
    rec = getattr(_TLS, "record", None)
    if rec is not None:
        rec.kept.extend(objs)


def note_launch(name: str) -> bool:
    """A wrapper's launch on this thread: True when a capture records it
    (the wrapper then leaves its ``LAUNCHES`` alone), False otherwise."""
    rec = getattr(_TLS, "record", None)
    if rec is None:
        return False
    rec.launches[name] += 1
    return True


def add_replayed(launches: Counter) -> None:
    """A replay ran these launches."""
    with _REPLAYED_LOCK:
        REPLAYED.update(launches)


def reset_replayed() -> None:
    with _REPLAYED_LOCK:
        REPLAYED.clear()
