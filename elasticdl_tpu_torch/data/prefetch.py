"""Background batch prefetch: overlap host IO/decode with device steps
(port of elasticdl_tpu/data/prefetch.py, without its chained stages,
which only the host-tier sparse path uses).

While the device executes step N, a bounded background thread reads
records and runs the user ``dataset_fn`` for step N+1. Producer
exceptions re-raise in the consumer (a bad record must fail the task,
not hang it). ``close()`` stops the producer even mid-queue, so an
abandoned iterator does not leak a blocked thread; iterators are
context managers so abandonment is explicit.
"""

import queue
import threading
from typing import Iterator

_SENTINEL = object()


class PrefetchIterator:
    def __init__(self, source: Iterator, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error = None
        self._done = False
        self._thread = threading.Thread(
            target=self._produce, args=(source,), daemon=True
        )
        self._thread.start()

    def _produce(self, source):
        try:
            for item in source:
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as exc:  # re-raised in the consumer
            self._error = exc
        while not self._stop.is_set():
            try:
                self._queue.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._stop.is_set():
            # Exhausted/closed iterators stay exhausted (repeat the
            # stored error rather than blocking on an empty queue).
            if self._error is not None:
                raise self._error
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # Unblock a producer waiting on a full queue, then wait for it to
        # exit: a producer mid-read outliving its task would race the
        # next task's producer on the shared (non-thread-safe) reader.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch(source: Iterator, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(source, depth)
