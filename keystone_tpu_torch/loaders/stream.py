"""Host-side building blocks of a streamed dataset (counterpart of
``keystone_tpu/loaders/stream.py`` § batched, prefetched, stream_labeled,
require_stream_test_path, resolve_train_source, add_stream_args).

- ``batched``: a re-iterable batch source over an in-memory array;
- ``prefetched``: a re-iterable source whose host work (decode,
  synthesis) runs on a producer thread, ``prefetch`` batches ahead of
  the consumer.  The thread makes host arrays only: every device copy
  stays on the consumer's thread;
- ``stream_labeled``: an in-memory LabeledData's features as a stream;
- ``require_stream_test_path``, ``resolve_train_source`` and
  ``add_stream_args``: the ``--stream`` plumbing the apps share.

``resilient`` (per-batch retries, deadlines, a bad-batch quota), the
fault points and the metrics counters wait for ROADMAP A9.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

#: batches a file loader's producer thread makes ahead of the consumer
PREFETCH = 2


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


def require_stream_test_path(config) -> None:
    """An app run with ``stream`` and a training path must be given a
    test path: evaluating on the training source would load the whole
    of what streaming exists to keep out of memory."""
    if config.stream and config.train_path and not config.test_path:
        raise ValueError("--stream needs --test-path: evaluating on the training source would eagerly load the "
                         "data streaming exists to avoid")


def resolve_train_source(config, load, stream, synthetic):
    """The training set of a ``--stream`` app, one of four: the files
    streamed, the files loaded, the synthetic set as a stream (the demo
    path), or the synthetic set.  ``load``/``stream`` take the path (and
    ``stream`` a ``batch_size``), ``synthetic`` nothing."""
    if config.stream and config.train_path:
        return stream(config.train_path, batch_size=config.stream_batch_size)
    if config.train_path:
        return load(config.train_path)
    if config.stream:
        return stream_labeled(synthetic(), config.stream_batch_size)
    return synthetic()


def add_stream_args(parser, default_batch_size: int, noun: str) -> None:
    """The ``--stream`` / ``--stream-batch-size`` arguments the apps share."""
    parser.add_argument("--stream", "--out-of-core", action="store_true", dest="stream",
                        help=f"re-read {noun} from disk every sweep; fits run out of core")
    parser.add_argument("--stream-batch-size", type=int, default=default_batch_size)
