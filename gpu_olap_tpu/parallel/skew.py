"""Skew handling for the distributed shuffle (BASELINE config 5, Zipfian keys).

Naive hash partitioning sends every occurrence of a hot key to one device; a
Zipfian key distribution then caps scaling at the hottest device.  Strategy
(PAPERS.md skew-join literature, reference broadcast-join escape hatch at
``join_kernel.rs:62-77``):

1. detect heavy keys from a (sampled) histogram;
2. capacity planning: shuffle bucket capacity sized from the observed
   partition histogram plus headroom instead of the uniform n/ndev;
3. hybrid exchange: heavy build-side keys are *broadcast* (replicated to all
   devices) while their probe rows stay local — the classic
   broadcast/split skew join.
"""

from __future__ import annotations


import numpy as np

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402

from ..ops.hashing import partition_of  # noqa: E402


def partition_histogram(keys: jnp.ndarray, num_partitions: int) -> jnp.ndarray:
    """Rows per hash partition (the skew detector's raw signal): one
    scatter-add over the destination ids."""
    dest = partition_of(keys, num_partitions)
    return jax.ops.segment_sum(
        jnp.ones(keys.shape[0], dtype=jnp.int64), dest,
        num_segments=num_partitions,
    )


def recommend_capacity(hist: np.ndarray, ndev: int = 1,
                       headroom: float = 1.25, align: int = 128) -> int:
    """Per-(source, destination) shuffle bucket capacity from an observed
    FULL-TABLE destination histogram.

    Each source device holds ~1/ndev of the table, so the hottest
    destination's rows split ~evenly across the ndev send buckets aimed at
    it: bucket peak ~= hist_peak / ndev.  Sizing buckets at the full
    hist_peak (the round-1 bug) made every receive buffer ndev-times
    oversized — per-device local work then never shrank with the mesh and
    scaling efficiency collapsed.

    Assumes placement of rows across source shards is ~uniform per key
    (true for hash/round-robin sharded inputs).  If rows are clustered by
    key across shards, one source bucket can hold up to the full hist_peak
    — callers must check the shuffle overflow flag (the engine path retries
    with doubled capacity; benches must FAIL, not report)."""
    peak = int(np.max(np.asarray(hist))) if len(hist) else 1
    cap = int(peak * headroom / max(ndev, 1)) + 1
    return ((cap + align - 1) // align) * align


def detect_heavy_keys(keys: np.ndarray, row_threshold: int,
                      max_heavy: int = 128) -> np.ndarray:
    """Host-side heavy-hitter detection (exact, via sort): keys whose
    frequency exceeds ``row_threshold``.  Run on a sample for large inputs."""
    uniq, counts = np.unique(np.asarray(keys), return_counts=True)
    heavy = uniq[counts > row_threshold]
    if len(heavy) > max_heavy:
        order = np.argsort(counts[counts > row_threshold])[::-1]
        heavy = heavy[order[:max_heavy]]
    return heavy.astype(np.int64)


def split_by_heavy(keys: jnp.ndarray, heavy_keys: np.ndarray) -> jnp.ndarray:
    """Boolean mask of rows carrying heavy keys (device-side, LUT-free).

    ``heavy_keys`` is small (<= max_heavy) so an O(n * h) compare is cheap and
    vectorizes on the VPU."""
    if len(heavy_keys) == 0:
        return jnp.zeros(keys.shape[0], dtype=bool)
    hk = jnp.asarray(heavy_keys)
    return jnp.any(keys[:, None] == hk[None, :], axis=1)
