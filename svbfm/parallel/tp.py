"""Feature-axis (tensor-parallel) FM scoring.

For models whose parameter tables outgrow one device's HBM (very large D,
e.g. KDD Music's 625k attributes at K=100+, or industrial id spaces), the
latent table V [K, D] and w [D] shard over the ``data`` mesh axis along D.
Each device computes the partial pairwise-trick sums over ITS feature
range — out-of-range ids contribute zero — and a single ``psum`` combines:

    y = w0 + sum_dev( sum_{i in shard} w_i x_i )
        + 0.5 * sum_f [ (sum_dev s_f^dev)^2 - sum_dev s2_f^dev ]

where s_f^dev = sum_{i in shard} v_fi x_i.  Note the square applies AFTER
the cross-device sum of s_f, so the collective carries [K, N] partial sums
(K * N * 4 bytes over ICI) — the FM analogue of tensor-parallel matmul
partials.  Rows (the batch) stay replicated here; compose with data
sharding by splitting the batch outside.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svbfm.parallel.mesh import DATA_AXIS


def shard_params_by_feature(mesh: Mesh, w0, w, v):
    """Place w/v sharded over the feature axis (last dim), w0 replicated."""
    rep = NamedSharding(mesh, P())
    shd_w = NamedSharding(mesh, P(DATA_AXIS))
    shd_v = NamedSharding(mesh, P(None, DATA_AXIS))
    return (jax.device_put(jnp.asarray(w0), rep),
            jax.device_put(jnp.asarray(w), shd_w),
            jax.device_put(jnp.asarray(v), shd_v))


def make_tp_scorer(mesh: Mesh, num_attributes: int, k0: bool = True,
                   k1: bool = True):
    """Returns jit(fn(w0, w_sharded, v_sharded, ids, vals) -> scores [N]).

    ids/vals are replicated [N, P]; each device masks ids to its local
    feature range, gathers from its local table shard, and partial sums are
    combined with psum (s_f before squaring, s2 and linear terms after).
    """
    n_dev = mesh.devices.size
    d_pad = -(-num_attributes // n_dev) * n_dev
    shard_size = d_pad // n_dev

    def scorer(w0, w_l, v_l, ids, vals):
        # shard-local feature range [lo, lo + shard_size)
        lo = jax.lax.axis_index(DATA_AXIS) * shard_size
        local = ids - lo
        in_range = (local >= 0) & (local < shard_size)
        local = jnp.clip(local, 0, shard_size - 1)
        x = jnp.where(in_range, vals, 0.0)

        N, P_row = ids.shape
        acc = jnp.zeros((N,), v_l.dtype)
        s = jnp.zeros((v_l.shape[0], N), v_l.dtype)
        s2 = jnp.zeros((v_l.shape[0], N), v_l.dtype)
        for p in range(P_row):
            if k1:
                acc = acc + jnp.take(w_l, local[:, p]) * x[:, p]
            d = jnp.take(v_l, local[:, p], axis=-1) * x[:, p]  # [K, N]
            s = s + d
            s2 = s2 + d * d
        acc = jax.lax.psum(acc, DATA_AXIS)
        s = jax.lax.psum(s, DATA_AXIS)  # sum BEFORE squaring
        s2 = jax.lax.psum(s2, DATA_AXIS)
        out = 0.5 * (s * s - s2).sum(0) + acc
        if k0:
            out = out + w0
        return out

    fn = jax.jit(jax.shard_map(
        scorer, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(None, DATA_AXIS), P(), P()),
        out_specs=P(),
    ))
    return fn, d_pad


def pad_feature_dim(arr: np.ndarray, d_pad: int) -> np.ndarray:
    """Zero-pad the last (feature) dimension to the sharded width."""
    pad = d_pad - arr.shape[-1]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
    return np.pad(np.asarray(arr), widths)
