"""Distributed shuffle — radix partitioning lifted to the device mesh.

The reference's 256-way radix partition (``join_kernels.cuh:45-76``) becomes,
one level up, a hash partition of rows over mesh devices with an
``all_to_all`` exchange (SURVEY.md §2.6: radix partitioning lifted to the
mesh).  Implemented with ``shard_map``: each device buckets its local
rows by destination (histogram + prefix sum + rank scatter, atomics-free),
exchanges fixed-capacity bucket blocks over the interconnect, and unpacks with received
counts.  Fixed capacities keep shapes static; overflow is reported for
host-side growth, and skew-aware capacity headroom comes from
``skew.recommend_capacity``.
"""

from __future__ import annotations

import functools

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from jax import shard_map  # noqa: E402

from ..ops.hashing import bucket_layout, partition_of  # noqa: E402
from .mesh import AXIS  # noqa: E402


def shuffle_rows_local(keys, payloads, row_valid, ndev: int, capacity: int):
    """Per-device half of the shuffle (runs inside shard_map).

    ``keys``: int64 (n,) partition key codes.  ``payloads``: list of arrays to
    ship alongside.  Returns (recv_keys (ndev*capacity,), recv_payloads,
    recv_valid, overflow)."""
    dest = partition_of(keys, ndev)
    gather_idx, counts, overflow = bucket_layout(dest, row_valid, ndev, capacity)

    def pack(arr):
        return arr[gather_idx]  # (ndev, capacity)

    send_keys = pack(keys)
    send_payloads = [pack(p) for p in payloads]

    recv_keys = jax.lax.all_to_all(send_keys, AXIS, split_axis=0, concat_axis=0,
                                   tiled=True)
    recv_payloads = [
        jax.lax.all_to_all(p, AXIS, split_axis=0, concat_axis=0, tiled=True)
        for p in send_payloads
    ]
    recv_counts = jax.lax.all_to_all(
        counts.reshape(ndev, 1), AXIS, split_axis=0, concat_axis=0, tiled=True
    ).reshape(ndev)

    slot = jnp.arange(capacity, dtype=jnp.int64)[None, :]
    recv_valid = (slot < recv_counts[:, None]).reshape(-1)
    flat = lambda a: a.reshape(-1)
    return (flat(recv_keys), [flat(p) for p in recv_payloads], recv_valid,
            overflow)


def make_shuffle(mesh, n_payloads: int, capacity: int):
    """Build a jitted sharded shuffle over ``mesh``.

    Input/output arrays are row-sharded over the hosts axis; per-device local
    shards flow through ``shuffle_rows_local``."""
    ndev = mesh.devices.size

    in_specs = (P(AXIS),) * (2 + n_payloads)
    out_specs = ((P(AXIS),) + (P(AXIS),) * n_payloads + (P(AXIS), P()))

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    def _shuffle(keys, row_valid, *payloads):
        rk, rp, rv, overflow = shuffle_rows_local(
            keys, list(payloads), row_valid, ndev, capacity
        )
        overflow_any = jax.lax.pmax(overflow.astype(jnp.int32), AXIS)
        return (rk, *rp, rv, overflow_any)

    return jax.jit(_shuffle)
