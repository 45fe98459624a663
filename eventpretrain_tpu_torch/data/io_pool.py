"""Thread-pool loading of samples for the host pipelines.

Counterpart of eventpretrain_tpu/data/io_pool.py. A source's
``load(index)`` is numpy and file IO, which release the interpreter lock
in their reads and decompression, so worker threads suffice: no pickling,
no copy of the dataset per worker, one page cache. Only the ``load``
calls, which draw no random numbers, run on the pool; every draw stays on
the pipeline's thread in index order, so the random stream is the
sequential path's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence


def make_pool(num_workers: int) -> Optional[ThreadPoolExecutor]:
    """None for sequential loading, else a pool of ``num_workers``
    threads; its owner shuts it down (``with`` or ``shutdown``)."""
    if num_workers <= 0:
        return None
    return ThreadPoolExecutor(max_workers=num_workers,
                              thread_name_prefix="evp-load")


def map_loads(load: Callable[[int], object], indices: Sequence,
              pool: Optional[ThreadPoolExecutor]) -> list:
    """``[load(i) for i in indices]``, fanned over the pool when there is
    one; the results come back in index order either way, and a load that
    raises raises here."""
    if pool is None:
        return [load(int(i)) for i in indices]
    return list(pool.map(lambda i: load(int(i)), indices))
