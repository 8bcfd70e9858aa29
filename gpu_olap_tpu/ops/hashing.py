"""Device hash functions + radix partitioning.

The reference hashes with the MurmurHash3 finalizer and partitions on 8 radix
bits with atomicAdd scatter (``join_kernels.cuh:26-41,45-76``).  The engine's
partition pass is the same hash but atomics-free: histogram (segment_sum) +
exclusive prefix sum + vectorized rank-scatter — identical 3-step structure to
the radix-sort pass recipe (``sort_kernel.rs:41-47``).  The same function is
the distributed shuffle's bucketing step, lifted one level (SURVEY.md §2.6).
"""

from __future__ import annotations

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402


def hash64(x: jnp.ndarray) -> jnp.ndarray:
    """MurmurHash3-style 64-bit finalizer (fmix64) on int64 keys.

    Same avalanche structure the reference uses (``join_kernels.cuh:26-41``);
    computed in uint64."""
    h = x.astype(jnp.uint64)
    h = h ^ (h >> 33)
    h = h * jnp.uint64(0xFF51AFD7ED558CCD)
    h = h ^ (h >> 33)
    h = h * jnp.uint64(0xC4CEB9FE1A85EC53)
    h = h ^ (h >> 33)
    return h.astype(jnp.int64) & jnp.int64(0x7FFFFFFFFFFFFFFF)


def hash32(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit MurmurHash3 finalizer over folded int64 keys — 32-bit
    multiplies only, avalanche quality preserved by
    folding the high word in (``join_kernels.cuh:26-33`` is the 32-bit
    variant the reference uses for int32 keys)."""
    u = x.astype(jnp.uint32) ^ (x >> 32).astype(jnp.uint32)
    u = u ^ (u >> 16)
    u = u * jnp.uint32(0x85EBCA6B)
    u = u ^ (u >> 13)
    u = u * jnp.uint32(0xC2B2AE35)
    u = u ^ (u >> 16)
    return u


def partition_of(key: jnp.ndarray, num_partitions: int) -> jnp.ndarray:
    """Radix partition id of a key (hash then modulo, like hash % capacity at
    ``join_kernels.cuh:93``) — int32 lanes, native-width hash."""
    return (hash32(key) % jnp.uint32(num_partitions)).astype(jnp.int32)


def bucket_layout(dest: jnp.ndarray, row_valid, num_buckets: int, bucket_cap: int):
    """Arrange rows into a (num_buckets, bucket_cap) dense layout.

    Returns (gather_idx (num_buckets, bucket_cap), counts (num_buckets,),
    overflow flag).  ``gather_idx`` indexes into the *original* row order;
    slots >= counts[b] are padding (point at row 0).

    This is the radix_partition_kernel analogue: histogram + prefix-sum +
    scatter, with the scatter expressed as a stable sort by destination."""
    n = dest.shape[0]
    arange = jnp.arange(n, dtype=jnp.int32)
    dest32 = dest.astype(jnp.int32)
    if row_valid is None:
        dest_eff = dest32
    else:
        dest_eff = jnp.where(row_valid, dest32,
                             jnp.int32(num_buckets))  # invalid -> drop bucket
    # stable sort rows by destination; rows of bucket b occupy a contiguous run
    sorted_dest, sorted_rows = jax.lax.sort((dest_eff, arange), num_keys=2,
                                            is_stable=False)
    # histogram from run boundaries (binary search — scatter-free; the query
    # set is tiny, so searchsorted's internal scatter is bucket-sized)
    bucket_ids = jnp.arange(num_buckets + 1, dtype=jnp.int32)
    bounds = jnp.searchsorted(sorted_dest, bucket_ids, side="left", method="sort")
    counts = bounds[1:] - bounds[:-1]
    overflow = jnp.max(counts) > bucket_cap
    offsets = bounds[:-1]  # exclusive prefix over buckets
    slot = jnp.arange(bucket_cap, dtype=jnp.int32)[None, :]
    src = jnp.clip(offsets[:, None] + slot, 0, n - 1)
    gather_idx = sorted_rows[src]
    return gather_idx, counts.astype(jnp.int64), overflow
