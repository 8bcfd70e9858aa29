"""Filter kernels.

The reference's JIT'd filter writes a bitmask then compacts via prefix-sum +
scatter (``filter_kernel.rs:1-5``, ``codegen.rs:36-47``).  Here the predicate
is traced into the same XLA program as its consumers, so the mask *fuses* into
downstream segment reductions and joins for free (the BASELINE "predicate
fusion" requirement) — the engine therefore carries row-validity masks instead
of eagerly compacting.  Compaction (prefix-sum + scatter, identical structure)
is only applied when an operator needs dense rows or at the host boundary.
"""

from __future__ import annotations

from typing import Optional

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402


def combine_mask(row_valid: Optional[jnp.ndarray], pred_data, pred_valid):
    """AND a predicate result (SQL TRUE only: value & not-null) into a row mask."""
    mask = pred_data.astype(bool)
    if pred_valid is not None:
        mask = mask & pred_valid
    if row_valid is not None:
        mask = mask & row_valid
    return mask


def compaction_indices(mask: jnp.ndarray):
    """Stable compaction permutation: returns (gather_idx, count).

    ``gather_idx[i]`` is the source row for dense slot i (slots >= count hold
    the masked-out rows).  Implemented as a sort by (inverted mask, position),
    scatter-free (a choice made on the previous accelerator, to re-measure
    against a cumsum + scatter on the H100).  The position rides
    as a second KEY with is_stable=False: total order == stable semantics
    without XLA's hidden tie-break iota operand per merge pass."""
    n = mask.shape[0]
    arange = jnp.arange(n, dtype=jnp.int32)  # row counts < 2^31: narrow lane
    inv = (~mask).astype(jnp.int32)
    _, gather_idx = jax.lax.sort((inv, arange), num_keys=2, is_stable=False)
    count = jnp.sum(mask.astype(jnp.int64))
    return gather_idx, count


def compact_column(data, mask_gather_idx, count):
    """Gather a column into dense prefix order."""
    out = data[mask_gather_idx]
    return out
