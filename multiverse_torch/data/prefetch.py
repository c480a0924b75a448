"""Host-side batch prefetching.

The port's own copy of ``multiverse_tpu/data/prefetch.py``. The
reference assembles each feed_dict synchronously between sess.run calls
(reference: code/pred_models.py:1719-1732), stalling the accelerator on
host work. Here batch assembly runs on a background thread a fixed
number of batches ahead, so step N+1's inputs are packed while the
device runs step N.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class PrefetchIterator:
    """Wrap a batch iterator with a bounded background producer.

    Iterator-protocol safe: ``next()`` after exhaustion (or after the
    producer's exception propagated) raises ``StopIteration`` instead
    of blocking on an empty queue.  ``close()`` (also the context-
    manager exit) stops the producer so an abandoned iterator does not
    leave a thread blocked in ``put`` pinning ``depth`` assembled
    batches for the life of the process.
    """

    _END = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err = None
        self._stop = threading.Event()
        self._done = False

        def _put(item) -> bool:
            # bounded put that gives up when close() was called —
            # q.put() without the stop check blocks forever once the
            # consumer is gone
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in iterator:
                    if not _put(item):
                        return
            except BaseException as e:  # propagate to the consumer
                self._err = e
            finally:
                _put(self._END)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer thread and drop any buffered batches."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch(iterator: Iterator, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterator, depth=depth)
