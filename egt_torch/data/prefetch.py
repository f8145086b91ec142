"""Background batch prefetching.

The port's own copy of `egt_tpu/data/prefetch.py`: batch assembly (numpy or
the native assembler) and, through `transform`, the host-to-card copy run in
a worker thread a few steps ahead of the training loop, so the card does not
wait on the feed path. `waited` is the time the consumer spent blocked on
the next item, which the engine reports as the share of an epoch spent
waiting for data.
"""

from __future__ import annotations

import queue
import threading
import time

_SENTINEL = object()


class Prefetcher:
    """Iterate `iterator` in a daemon thread, applying `transform` (e.g. the
    copy to the card) in the worker, keeping up to `depth` ready batches."""

    def __init__(self, iterator, transform=None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self.waited = 0.0

        def work():
            try:
                for item in iterator:
                    self._q.put(transform(item) if transform else item)
            except BaseException as e:  # propagate to the consumer
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            t = time.perf_counter()
            item = self._q.get()
            self.waited += time.perf_counter() - t
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item
