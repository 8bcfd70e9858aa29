"""Device->host transfer helper.

Splits each large array into ~8 MB pieces and issues ``copy_to_host_async``
on every piece before converting any, so the pieces' transfers overlap
instead of running one array at a time.  Whether this beats one
``jax.device_get`` on a local PCIe link has not been measured on the H100.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .jaxenv import ensure_jax

jax = ensure_jax()

PIECE_BYTES = 8 << 20


def fetch_arrays(arrays: Sequence, piece_bytes: int = PIECE_BYTES) -> List[np.ndarray]:
    """Pull device arrays to host numpy with chunked async pipelining.

    Preserves order; passes numpy inputs through untouched.  Slicing
    dispatches are async and cheap; the conversion loop overlaps each
    piece's transfer with the previous pieces' copies."""
    pieces = []          # flat list of device pieces
    layout = []          # per array: ("np", value) | ("jax", start, count)
    for a in arrays:
        if isinstance(a, np.ndarray) or not hasattr(a, "copy_to_host_async"):
            layout.append(("np", a))
            continue
        nbytes = a.size * a.dtype.itemsize
        if nbytes <= piece_bytes or a.ndim != 1:
            layout.append(("jax", len(pieces), 1))
            pieces.append(a)
            continue
        rows = max(1, piece_bytes // max(a.dtype.itemsize, 1))
        n = a.shape[0]
        start = len(pieces)
        for lo in range(0, n, rows):
            pieces.append(a[lo:lo + rows])
        layout.append(("jax", start, len(pieces) - start))
    for p in pieces:
        try:
            p.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
    host = [np.asarray(p) for p in pieces]
    out = []
    for entry in layout:
        if entry[0] == "np":
            out.append(np.asarray(entry[1]))
        else:
            _, start, count = entry
            if count == 1:
                out.append(host[start])
            else:
                out.append(np.concatenate(host[start:start + count]))
    return out
