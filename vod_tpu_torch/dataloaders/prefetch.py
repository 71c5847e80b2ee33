"""Background prefetching of host-side query batches (a copy of
`vod_tpu/dataloaders/prefetch.py`, which the port does not import).

The host prepares batch t+1 while the card runs step t: a daemon thread and a
bounded queue double-buffer the query-side batches.
"""

from __future__ import annotations

import queue
import threading
import typing as typ

_SENTINEL = object()


def prefetch_iterator(it: typ.Iterable, size: int = 2) -> typ.Iterator:
    """Wrap an iterator so items are produced ahead of consumption."""
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list[BaseException] = []

    def worker() -> None:
        try:
            for item in it:
                q.put(item)
        except BaseException as exc:  # noqa: BLE001 - surfaced to the consumer
            err.append(exc)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
