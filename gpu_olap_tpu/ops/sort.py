"""Multi-key ORDER BY — the radix-sort analogue.

The reference specifies an 8-pass LSB radix sort of (key, row_id) pairs with a
descending flag (``sort_kernel.rs:12-32``).  Here ``lax.sort`` over multiple
int64 order-code operands plays that role:
one fused sort delivers multi-key lexicographic ordering with per-key
ASC/DESC and NULLS FIRST/LAST, returning a row permutation.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402


def order_by_permutation(
    keys: Sequence[dict],  # {codes: int64 (pre order_code'd), nulls: bool|None,
                           #  ascending: bool, nulls_last: bool}
    row_valid: Optional[jnp.ndarray],
    n: int,
):
    """Return a permutation placing valid rows first in requested order.

    Sort-operand minimal: the validity lane and per-key null lanes are only
    materialized when they can actually vary (every operand rides every merge
    pass of the sort), and the permutation payload is int32 (row counts are
    < 2^31 by construction)."""
    arange = jnp.arange(n, dtype=jnp.int32)
    ops = []
    if row_valid is not None:
        ops.append((~row_valid).astype(jnp.int32))
    for k in keys:
        codes = k["codes"]
        if not k["ascending"]:
            codes = -codes  # codes are clipped by order_code, negation is safe
        nulls = k.get("nulls")
        if nulls is not None:
            null_op = nulls.astype(jnp.int32)
            if not k.get("nulls_last", True):
                null_op = 1 - null_op
            ops.append(null_op)
        ops.append(codes)
    res = jax.lax.sort(tuple(ops) + (arange,), num_keys=len(ops) + 1,
                       is_stable=False)
    return res[-1]


def top_k_permutation(keys, row_valid, n: int, k: int):
    """Fused ORDER BY ... LIMIT k.

    Single descending key over full-width codes uses ``lax.top_k`` (avoids the
    full sort when k << n); otherwise falls back to the full sort."""
    if len(keys) == 1 and not keys[0]["ascending"] and keys[0].get("nulls") is None \
            and row_valid is None and k <= n:
        _, idx = jax.lax.top_k(keys[0]["codes"], k)
        return idx.astype(jnp.int64)
    return order_by_permutation(keys, row_valid, n)[:k]
