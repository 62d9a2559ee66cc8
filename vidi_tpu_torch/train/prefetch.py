"""Background batch prefetch for the training loop.

The reference trains with 4 torch DataLoader worker processes decoding video
off the training process (reference: Vidi1.5_9B/scripts/finetune.sh:52,
dataloader_num_workers). The JAX equivalent here is a bounded-queue thread:
the producer runs the dataset __getitem__ / collate (host decode, numpy)
while the device executes the current step, so host data work overlaps
device compute instead of serializing with it. One thread suffices because
the decode feed itself is native C++ (media/video.py) and releases the GIL
inside libav calls.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class Prefetcher:
    """Wrap an iterator; pull items ahead on a daemon thread.

    Exceptions raised by the source are re-raised at the consuming site on
    the next __next__ call (matching plain-iterator semantics). `depth`
    bounds host memory: at most `depth` prepared batches exist at once.
    """

    def __init__(self, source: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator):
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            self._q.put((_SENTINEL, e))
            return
        self._q.put((_SENTINEL, None))

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, "_done", False):
            raise StopIteration  # keep raising, like a plain iterator
        item = self._q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            self._done = True
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        return item
