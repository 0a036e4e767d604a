"""Host-side building blocks of a streamed dataset (counterpart of
``keystone_tpu/loaders/stream.py`` § batched, prefetched, stream_labeled,
require_stream_test_path, resolve_train_source, add_stream_args).

- ``batched``: a re-iterable batch source over an in-memory array;
- ``resilient``: a re-iterable source that survives transient
  per-batch failures: bounded per-batch retry with exponential backoff,
  then a ``max_bad_batches`` drop quota, and with ``timeout`` a watchdog
  around each fetch (``utils/guard.run_with_deadline``);
- ``prefetched``: a re-iterable source whose host work (decode,
  synthesis) runs on a producer thread, ``prefetch`` batches ahead of
  the consumer.  The thread makes host arrays only: every device copy
  stays on the consumer's thread;
- ``stream_labeled``: an in-memory LabeledData's features as a stream;
- ``require_stream_test_path``, ``resolve_train_source`` and
  ``add_stream_args``: the ``--stream`` plumbing the apps share.

``batched`` carries the ``stream.batch`` fault site, and every fetch
lands in the ``stream.batch_seconds`` histogram; ``resilient`` counts its
retries and drops (``stream.retries``, ``stream.bad_batches``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.obs import metrics

logger = logging.getLogger(__name__)

#: batches a file loader's producer thread makes ahead of the consumer
PREFETCH = 2


def _deadline_exceeded_type():
    """guard.DeadlineExceeded, imported only where a timeout is set."""
    from keystone_tpu_torch.utils.guard import DeadlineExceeded

    return DeadlineExceeded


def batched(array: np.ndarray, batch_size: int) -> Callable[[], Iterator[np.ndarray]]:
    """Re-iterable batch source over an in-memory array.  Carries the
    ``stream.batch`` fault site, so a plan can flake any stream built on
    it."""

    def gen():
        for i in range(0, len(array), batch_size):
            t0 = time.perf_counter()
            fault_point("stream.batch", index=i // batch_size)
            batch = array[i:i + batch_size]
            metrics.observe("stream.batch_seconds", time.perf_counter() - t0, source="batched")
            yield batch

    gen.fires_stream_batch = True
    return gen


def resilient(
    source,
    retries: int = 2,
    max_bad_batches: int = 0,
    base_delay: float = 0.05,
    max_delay: float = 1.0,
    sleep: Callable[[float], None] = time.sleep,
    timeout: Optional[float] = None,
) -> Callable[[], Iterator]:
    """Re-iterable batch source that survives transient per-batch
    failures (the Spark-task-retry analogue for input streams).

    A failed fetch is retried up to ``retries`` times with exponential
    backoff; each retry re-creates the underlying iterator (``source``
    must be re-iterable, this module's standing contract) and replays to
    the failed position.  A batch that still fails with its retries
    exhausted is DROPPED against the ``max_bad_batches`` quota — the
    reference tolerated lost partitions the same way, by bounded data
    loss rather than job death — and once the quota is spent the last
    error propagates.  ``max_bad_batches=0`` (default) means retry-only:
    transient flakiness is absorbed, deterministic failure still fails
    the fit.

    ``timeout`` (seconds, per batch fetch): a watchdog around each
    ``next()`` — a source that silently HANGS (stuck NFS read, wedged
    decoder) raises ``utils.guard.DeadlineExceeded``, an ``OSError``,
    so it is retried and then counted against ``max_bad_batches``
    exactly like a raising batch, instead of blocking the iterator
    forever.  The fetch runs on a watchdog worker thread only when a
    timeout is configured (default None: same-thread, zero overhead);
    after a timeout the suspect iterator is abandoned and a fresh one
    replays, per the retry contract above.  Costs to know about: each
    guarded fetch spawns one short-lived thread (~tens of µs — noise
    against ms-scale batch decode, but don't configure timeouts on
    microsecond-batch sources), and each ABANDONED fetch parks a daemon
    thread in ``next()`` until the source wakes — bounded by
    ``retries + max_bad_batches`` per stream, never unbounded.

    A source that ends BEFORE the replay position raises rather than
    silently truncating the stream.  One ambiguity is undetectable from
    the iterator protocol alone: a plain generator dies at the batch
    that raised, so a DROPPED batch on a generator source ends the
    stream at the drop point (observationally identical to a source
    whose final batch was bad) — it is logged loudly, and exact-n
    consumers (``FeatureBlockStore.from_batches``) still fail on the row
    shortfall.  A nonzero drop quota therefore wants batch-resumable
    iterators (e.g. file-per-batch readers), where fetches after a
    failed batch keep working.

    Note: dropped batches shrink the delivered row count, so only
    consumers that tolerate ragged totals (df sweeps, statistics) should
    run with a nonzero quota; exact-n consumers (FeatureBlockStore
    spills) keep the default.
    """
    # a source that does not fire the stream.batch site itself (a
    # loader's generator) fires it here, once per fetch, so a plan can
    # flake any resilient stream; ``batched`` fires it per batch already
    fire = not getattr(source, "fires_stream_batch", False)
    if not callable(source) and iter(source) is source:
        raise ValueError(
            "resilient() needs a re-iterable source: pass a callable "
            "returning a fresh iterator (or a list of batches), not a "
            "one-shot generator/iterator"
        )

    def gen():
        delivered = 0  # batches yielded to the consumer
        dropped = set()  # absolute indices written off against the quota
        attempt = 0  # failures of the batch at `attempt_idx`
        attempt_idx = -1  # the budget is PER BATCH, not pooled
        swallowed_last = False  # previous fetch was a dropped batch failing
        stall = 0  # consecutive restarts with zero progress
        progress_mark = None  # (delivered, len(dropped)) at last restart
        last_err = None  # the exception that ended the previous cycle
        while True:
            # a restart cycle that neither delivered nor dropped anything
            # AND ended in a fetch timeout is spinning (e.g. a dropped
            # batch that HANGS on every replay — it cannot be skipped,
            # only re-executed): fail loudly after a bounded number of
            # such cycles instead of paying one timeout per cycle
            # forever.  Raise-y transient failures are exempt — their
            # budget is PER BATCH (the module's documented contract),
            # and alternating failures across different replay batches
            # must not pool into one abort.
            mark = (delivered, len(dropped))
            barren = progress_mark is not None and mark == progress_mark
            if not barren:
                stall = 0
            elif timeout is not None and isinstance(
                last_err, _deadline_exceeded_type()
            ):
                stall += 1
                if stall > retries:
                    raise last_err
            progress_mark = mark
            src = source() if callable(source) else iter(source)
            pos = 0  # absolute index of the next fetch from this iterator
            restart = False
            while not restart:
                # everything before `target` was already handled: either
                # delivered to the consumer (replayed silently) or
                # dropped (its failure swallowed)
                target = delivered + len(dropped)
                idx = pos
                t_fetch = time.perf_counter()

                def fetch(src=src, idx=idx):
                    batch = next(src)
                    if fire:  # after the fetch: the iterator stays at idx + 1
                        fault_point("stream.batch", index=idx)
                    return batch

                try:
                    if timeout is None:
                        batch = fetch()
                    else:
                        from keystone_tpu_torch.utils import guard

                        batch = guard.run_with_deadline(
                            fetch,
                            guard.Deadline.after(timeout),
                            site="stream.batch",
                            index=idx,
                        )
                    metrics.observe(
                        "stream.batch_seconds",
                        time.perf_counter() - t_fetch,
                        source="resilient",
                    )
                    pos += 1
                    swallowed_last = False
                except StopIteration:
                    if idx < target:
                        raise RuntimeError(
                            f"stream source ended at batch {idx} while "
                            f"replaying to batch {target}: the source "
                            "shrank (or a non-resumable iterator died on "
                            "a dropped batch) — refusing to silently "
                            "truncate the stream"
                        )
                    if swallowed_last:
                        # undetectable generator-death-vs-final-bad-batch
                        # ambiguity (see docstring): be loud about it
                        logger.warning(
                            "stream ended immediately after dropped batch "
                            "%d; if the source is a plain generator its "
                            "remaining batches are unreachable (use a "
                            "batch-resumable iterator with "
                            "max_bad_batches)",
                            idx - 1,
                        )
                    return
                except Exception as e:
                    pos += 1
                    last_err = e
                    # a timed-out fetch may leave the abandoned watchdog
                    # worker still INSIDE next(src) — pulling more from
                    # that iterator would blow up ("generator already
                    # executing") and charge the error to the next
                    # healthy batch.  The drop/swallow paths WANT to
                    # continue the same iterator (that is how a
                    # batch-resumable source skips past a bad batch), so
                    # give the worker a short grace to vacate — cancel-
                    # aware work exits promptly — and only fall back to
                    # a fresh-iterator replay when it is truly stuck.
                    occupied = False
                    if timeout is not None and isinstance(
                        e, _deadline_exceeded_type()
                    ):
                        w = getattr(e, "worker", None)
                        if w is not None:
                            w.join(min(1.0, timeout))
                        occupied = w is None or w.is_alive()
                    if idx in dropped:
                        swallowed_last = True
                        if occupied:
                            restart = True
                        continue  # a written-off batch failing again
                    swallowed_last = False
                    if idx != attempt_idx:
                        attempt_idx, attempt = idx, 0
                    attempt += 1
                    if attempt <= retries:
                        metrics.inc("stream.retries")
                        delay = min(
                            max_delay, base_delay * (2.0 ** (attempt - 1))
                        )
                        logger.warning(
                            "stream batch %d failed (%s); retry %d/%d "
                            "in %.2fs",
                            idx,
                            e,
                            attempt,
                            retries,
                            delay,
                        )
                        sleep(delay)
                        # the iterator is suspect after an exception:
                        # restart fresh and replay rather than pull more
                        restart = True
                        continue
                    if idx >= target and len(dropped) < max_bad_batches:
                        dropped.add(idx)
                        metrics.inc("stream.bad_batches")
                        attempt_idx, attempt = -1, 0
                        # if the source is a dead generator, the next
                        # fetch is StopIteration — flag it so the
                        # truncation warning above fires
                        swallowed_last = True
                        logger.warning(
                            "stream batch %d failed %d times; dropping "
                            "it (%d/%d bad-batch quota used)",
                            idx,
                            retries + 1,
                            len(dropped),
                            max_bad_batches,
                        )
                        if occupied:
                            restart = True  # see timeout note above
                        continue
                    # out of quota — or an already-DELIVERED batch failed
                    # its replay (dropping it would desync the consumer)
                    raise
                else:
                    if idx == attempt_idx:
                        # the batch that was failing came through
                        attempt_idx, attempt = -1, 0
                    if idx < target:
                        continue  # replaying an already-delivered batch
                    yield batch
                    delivered += 1

    gen.fires_stream_batch = True
    return gen


def prefetched(source, transform: Optional[Callable] = None, prefetch: int = 2) -> Callable[[], Iterator]:
    """Re-iterable source whose batches are made on a producer thread.

    ``source``: an iterable of host batches, or a callable returning a
    fresh iterator.  Each batch passes through ``transform`` (when given)
    on the thread, then reaches the consumer through a queue ``prefetch``
    deep; an error on the thread, in the source or in ``transform``,
    re-raises in the consumer.  A consumer that leaves early stops the
    thread and drops the batches it had parked."""
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
                    if transform is not None:
                        batch = transform(batch)
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


def stream_labeled(labeled, batch_size: int, prefetch: int = 0):
    """An in-memory LabeledData's features as a StreamDataset on their
    device (the demo path for a streamed fit without files): the source
    array stays in memory, but the streamed fit paths run.  ``prefetch``
    as ``StreamDataset``'s (0: the batches are cut on the consumer's
    thread)."""
    from keystone_tpu_torch.loaders.labeled import LabeledData
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    data = labeled.data
    return LabeledData(StreamDataset(batched(data.numpy(), batch_size), n=data.n, prefetch=prefetch,
                                     device=data.device), labeled.labels)


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
