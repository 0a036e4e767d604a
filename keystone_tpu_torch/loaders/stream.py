"""Host-side building blocks of a streamed dataset (counterpart of
``keystone_tpu/loaders/stream.py`` § batched, prefetched, stream_labeled).

- ``batched``: a re-iterable batch source over an in-memory array;
- ``prefetched``: a re-iterable source whose host work (decode,
  synthesis) runs on a producer thread, ``prefetch`` batches ahead of
  the consumer.  The thread makes host arrays only: every device copy
  stays on the consumer's thread;
- ``stream_labeled``: an in-memory LabeledData's features as a stream.

``resilient`` (per-batch retries, deadlines, a bad-batch quota), the
fault points and the metrics counters wait for ROADMAP A9.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def batched(array: np.ndarray, batch_size: int) -> Callable[[], Iterator[np.ndarray]]:
    """Re-iterable batch source over an in-memory array."""

    def gen():
        for i in range(0, len(array), batch_size):
            yield array[i:i + batch_size]

    return gen


def prefetched(source, prefetch: int = 2) -> Callable[[], Iterator]:
    """Re-iterable source whose batches are made on a producer thread.

    ``source``: an iterable of host batches, or a callable returning a
    fresh iterator.  Its batches reach the consumer through a queue
    ``prefetch`` deep; an error on the thread re-raises in the consumer.
    A consumer that leaves early stops the thread and drops the batches
    it had parked."""
    depth = max(1, int(prefetch))

    def gen():
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            # gives up once the consumer has left, so the thread never
            # parks forever on a full queue holding decoded batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in source() if callable(source) else iter(source):
                    if stop.is_set() or not put(batch):
                        return
            except Exception as e:  # surfaces in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True, name="stream-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)
            while True:  # drop parked batches with the generator
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    return gen


def stream_labeled(labeled, batch_size: int):
    """An in-memory LabeledData's features as a StreamDataset on their
    device (the demo path for a streamed fit without files): the source
    array stays in memory, but the streamed fit paths run."""
    from keystone_tpu_torch.loaders.labeled import LabeledData
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    data = labeled.data
    return LabeledData(StreamDataset(batched(data.numpy(), batch_size), n=data.n, device=data.device),
                       labeled.labels)
