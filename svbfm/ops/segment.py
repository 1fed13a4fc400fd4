"""Segment reductions for column-sweep sufficient statistics.

The reference walks each feature column's occurrence list serially
(``fm_learn_vb.h:534-539``); here per-column sums over a bin's entries are
segment reductions over column-sorted arrays.  ``jax.ops.segment_sum`` with
sortedness hints lowers to an XLA scatter-add; a cumsum-based variant is kept
for benchmarking since sorted segments admit a scatter-free formulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sorted_segment_sum(data: jax.Array, seg: jax.Array, num_segments: int) -> jax.Array:
    """Sum `data` by sorted segment ids.  Padding entries must carry
    seg == num_segments - 1 with data == 0 (or any in-range id with 0 data)."""
    return jax.ops.segment_sum(
        data, seg, num_segments=num_segments, indices_are_sorted=True
    )


def segment_sum(data: jax.Array, seg: jax.Array, num_segments: int) -> jax.Array:
    return jax.ops.segment_sum(data, seg, num_segments=num_segments)


def sorted_segment_sum_cumsum(data: jax.Array, ptr: jax.Array) -> jax.Array:
    """Scatter-free sorted segment sum given segment boundary pointers.

    ptr: int32 [C+1]; returns [C] sums.  Uses an f32 cumsum, so prefer the
    scatter path when per-segment magnitudes are small relative to the total.
    """
    c = jnp.cumsum(data)
    c = jnp.concatenate([jnp.zeros((1,), data.dtype), c])
    return c[ptr[1:]] - c[ptr[:-1]]


def take_rows(table, idx, mode: str = "clip"):
    """Row-gather with FLATTENED indices.

    The earlier accelerator's XLA backend lowered gathers with
    multi-dimensional start-index arrays far slower than rank-1 index
    vectors (not measured on the H100).  Every gather in the framework goes
    through here: flatten the index array, gather, reshape back.

    table: [R] or [R, W]; idx: any int shape -> returns idx.shape (+ [W]).
    """
    import jax.numpy as jnp

    flat = jnp.take(table, idx.reshape(-1), axis=0, mode=mode)
    return flat.reshape(idx.shape + table.shape[1:])


def take_cols(table, idx, mode: str = "clip"):
    """Like take_rows but gathers along the LAST axis of [..., R] tables
    (used for [K, D]-shaped parameter tables indexed by feature id)."""
    import jax.numpy as jnp

    flat = jnp.take(table, idx.reshape(-1), axis=-1, mode=mode)
    return flat.reshape(table.shape[:-1] + idx.shape)
