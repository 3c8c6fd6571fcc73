"""Host-side double-buffered prefetcher (overlap input copy with compute).

Copy of ``repro/data/pipeline.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

__all__ = ["prefetch"]


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """The items of ``it`` in order, produced on a daemon thread into a
    queue of at most ``depth`` items, so that the next batch is drawn
    while the caller works on this one."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
