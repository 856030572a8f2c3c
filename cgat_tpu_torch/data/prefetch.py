"""Host-side batch prefetch: collate ahead of the device.

Counterpart of ``cgat_tpu/data/prefetch.py``. On the card a training step
is one replay of a CUDA graph, which returns at once; collating the next
batch inline then leaves the card idle for the collate's ~3 ms. Wrapping a
loader in :class:`PrefetchLoader` moves the collation (numpy, and the CPU
tensors it ends in) onto a background thread that stays ``depth``
batches ahead, as the reference's torch DataLoader workers did
(lightning_module.py:357-411). The thread launches no work on the card:
the consumer copies each batch there itself. The consumer's wait on the
queue is the span ``prefetch_wait``; the thread's collates are not in a
trace (``utils/profiling.py``).
"""
from __future__ import annotations

import queue
import threading

from ..utils.profiling import annotate

_DONE, _ERR = object(), object()


class PrefetchLoader:
    """Wrap any loader (``GraphLoader``, the streaming loader, the grouped
    loaders); delegates ``set_epoch``/``__len__`` and re-exposes
    ``last_counts`` in step with each yielded batch. An error raised while
    producing is raised in the consumer; the thread is joined when the
    iteration ends, is left early or fails."""

    def __init__(self, inner, depth: int = 2):
        self.inner = inner
        self.depth = depth
        self.last_counts = {"edges": 0, "graphs": 0}

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def produce():
            try:
                for batch in self.inner:
                    if stop.is_set():
                        return
                    q.put((batch, dict(getattr(self.inner, "last_counts",
                                               {"edges": 0, "graphs": 0}))))
                q.put(_DONE)
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                q.put((_ERR, e))

        t = threading.Thread(target=produce, daemon=True,
                             name="PrefetchLoader")
        t.start()
        try:
            while True:
                with annotate("prefetch_wait"):
                    item = q.get()
                if item is _DONE:
                    break
                if item[0] is _ERR:
                    raise item[1]
                batch, counts = item
                self.last_counts = counts
                yield batch
        finally:
            # a consumer that stops early leaves the producer blocked on a
            # full queue: drain it until the producer sees the stop
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
