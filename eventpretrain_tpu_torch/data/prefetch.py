"""Background-thread batch prefetcher.

Counterpart of eventpretrain_tpu/data/prefetch.py: one daemon thread runs
the pipeline (host decode, packing, encoding, and the device half that
decodes and rasterises on the card) ahead of the training loop through a
queue of depth 2, so the host builds the next batch while the card runs
the step. An exception in the producer is raised in the consumer.

The producer enqueues its device work on the current stream of its own
thread, which is the device's default stream, as is the training loop's:
the step's kernels follow the batch's in stream order, with no event or
extra synchronisation. (A blocking host-to-device copy in the producer
waits for the work queued before it; the consumer never waits on the
producer's copies.)

Unlike the JAX version, a consumer that stops early (a ``break``, an
exception in the step, or ``close()`` on the iterator) stops the producer:
its wait on a full queue ends, the pipeline's iterator is closed (its
``finally`` blocks run), and the thread is joined before the consumer goes
on, so no thread is left holding device batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class Prefetcher:
    """Wrap any batch iterable with depth-``size`` background prefetch."""

    _END = object()
    _POLL_S = 0.1

    def __init__(self, iterable: Iterable, size: int = 2):
        self.iterable = iterable
        self.size = size

    def __len__(self) -> int:
        return len(self.iterable)  # type: ignore[arg-type]

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.size)
        err: list[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            it = iter(self.iterable)
            try:
                for item in it:
                    if not put(item):
                        break
            except BaseException as e:  # surface in consumer
                err.append(e)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                put(self._END)

        t = threading.Thread(target=producer, daemon=True,
                             name="Prefetcher")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a producer waiting on a full queue sees ``stop`` within one
            # poll; the batches left in the queue go with it
            stop.set()
            t.join()
