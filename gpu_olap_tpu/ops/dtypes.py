"""Device dtype helpers: order codes, sentinels, masked values.

Shared by the sort / join / aggregate kernels.  All operate on jnp arrays inside
jit traces.
"""

from __future__ import annotations

import numpy as np

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402

INT64_MIN = np.int64(np.iinfo(np.int64).min)
INT64_MAX = np.int64(np.iinfo(np.int64).max)


def order_code(data, np_kind: str):
    """Map a column to a sort operand whose ascending order == SQL ordering.

    Floats stay in float space — ``lax.sort``'s total-order comparator handles
    f64 natively, so no f64<->s64 bitcast is needed.  Ints are clipped by 2 so
    descending negation and null sentinels cannot overflow (same contract as
    the CPU oracle).  int32 operands (the small-key fast path) keep their
    width."""
    if np_kind == "f":
        return data.astype(jnp.float64)
    if data.dtype == jnp.int32:
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        return jnp.clip(data, lo + 2, hi - 2)
    codes = data.astype(jnp.int64)
    return jnp.clip(codes, INT64_MIN + 2, INT64_MAX - 2)


def key_code(data, validity, np_kind: str):
    """Exact join/group key encoding: (operand, null_flag).

    The operand keeps its own space (int64 for ints/codes, float64 for floats
    with -0.0 normalized and NaN nulled) — sort/searchsorted/boundary
    comparisons are exact in either space, and no bitcast is needed.  Nullness is a separate flag
    array so every value stays a legal key (the reference sentinel-encodes and
    loses this, ``record_batch_convert.rs:102-110``)."""
    if np_kind == "f":
        f = data.astype(jnp.float64)
        f = jnp.where(f == 0.0, 0.0, f)  # -0.0 == 0.0 in SQL
        isnan = jnp.isnan(f)
        codes = jnp.where(isnan, 0.0, f)
        nulls = isnan if validity is None else (isnan | ~validity)
    else:
        codes = data.astype(jnp.int64)
        nulls = None if validity is None else ~validity
    if nulls is None:
        nulls = jnp.zeros(data.shape, dtype=jnp.bool_)
    return codes, nulls


def key_fill(dtype) -> object:
    """Neutral fill for unused key slots, matching the operand space."""
    import numpy as _np

    d = _np.dtype(dtype)
    if d.kind == "f":
        return _np.float64(-_np.inf)
    return _np.iinfo(d).min


def key_top(dtype) -> object:
    """Sentinel greater than every valid key, matching the operand space."""
    import numpy as _np

    d = _np.dtype(dtype)
    if d.kind == "f":
        return _np.float64(_np.inf)
    return _np.iinfo(d).max


def masked_fill(data, mask, fill):
    """Replace entries where mask is False with ``fill``."""
    return jnp.where(mask, data, jnp.asarray(fill, dtype=data.dtype))
