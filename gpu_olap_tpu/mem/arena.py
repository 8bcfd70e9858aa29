"""Buffer arena — the slab allocator analogue.

The reference pools GPU memory in fixed size classes to avoid cudaMalloc churn
(``slab_allocator.rs:24-130``: smallest class >= size, O(1) free-list pop,
bounded slabs per class).  Under JAX, XLA owns raw HBM allocation, so the design
point shifts (SURVEY.md §2.3): what must be pooled is *shapes* — reusing
fixed-shape donated device buffers avoids both recompiles and realloc churn.
The arena hands out bucket-shaped host staging buffers and tracks device-side
bytes against ``max_hbm_bytes`` (the allocator's accounting role).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Tuple

import numpy as np

from ..utils.tracing import get_logger

logger = get_logger(__name__)


def size_class(n_rows: int, growth: float = 2.0, minimum: int = 1024) -> int:
    """Smallest shape bucket >= n_rows (find_slab_class analogue,
    ``slab_allocator.rs:95-107``)."""
    b = minimum
    while b < n_rows:
        b = int(b * growth)
    return b


class BufferArena:
    """Pooled, bucket-shaped pinned host staging buffers + device byte
    accounting.

    ``acquire`` pops a free buffer of the right (bucket, dtype) class or
    allocates a new one up to ``max_buffers_per_class``
    (``slab_allocator.rs:50-68``); ``release`` returns it to the pool
    (``:71-93``)."""

    def __init__(self, max_bytes: int = 8 << 30, max_buffers_per_class: int = 16,
                 growth: float = 2.0, min_bucket: int = 1024):
        self.max_bytes = max_bytes
        self.max_buffers_per_class = max_buffers_per_class
        self.growth = growth
        self.min_bucket = min_bucket
        self._free: Dict[Tuple[int, str], List[np.ndarray]] = collections.defaultdict(list)
        self._allocated_bytes = 0
        self._allocated_count: Dict[Tuple[int, str], int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def bucket(self, n_rows: int) -> int:
        return size_class(n_rows, self.growth, self.min_bucket)

    def acquire(self, n_rows: int, dtype) -> np.ndarray:
        rows = self.bucket(n_rows)
        key = (rows, np.dtype(dtype).str)
        with self._lock:
            pool = self._free[key]
            if pool:
                return pool.pop()
            nbytes = rows * np.dtype(dtype).itemsize
            if self._allocated_bytes + nbytes > self.max_bytes:
                raise MemoryError(
                    f"arena limit exceeded: {self._allocated_bytes + nbytes} "
                    f"> {self.max_bytes}"
                )
            self._allocated_bytes += nbytes
            self._allocated_count[key] += 1
        return np.empty(rows, dtype=dtype)

    def release(self, buf: np.ndarray) -> None:
        key = (buf.shape[0], buf.dtype.str)
        with self._lock:
            pool = self._free[key]
            if len(pool) < self.max_buffers_per_class:
                pool.append(buf)
            else:
                # pool full: drop (the reference cudaFrees here,
                # slab_allocator.rs:82-86)
                self._allocated_bytes -= buf.nbytes
                self._allocated_count[key] -= 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "allocated_bytes": self._allocated_bytes,
                "classes": {
                    f"{k[0]}x{k[1]}": {"allocated": self._allocated_count[k],
                                       "free": len(v)}
                    for k, v in self._free.items()
                },
            }

    def __del__(self):
        try:
            logger.debug("arena drop: %s", self.stats())
        except Exception:
            pass
