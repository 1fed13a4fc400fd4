"""FM forward kernels over the padded row layout.

The canonical O(K * nnz) pairwise trick (reference ``fm_model.h:107-130``):

    y(x) = w0 + sum_i w_i x_i + 0.5 * sum_f [ (sum_i v_fi x_i)^2
                                              - sum_i v_fi^2 x_i^2 ]

and the VBFM variance-propagation T-terms (reference
``fm_learn_vb.h:207-312``, paper Eq. 26): with m = mu'_v, s = sigma'_v,

    T(x) = sigma'_0 + sum_i sigma'_w,i x_i^2
         + sum_f [ 0.5 * z_f^2 + z_f * q2_f
                   - sum_i (m_fi^2 x_i^4 s_fi + 0.5 x_i^4 s_fi^2) ]
    where q2_f = sum_i (m_fi x_i)^2,  z_f = sum_i s_fi x_i^2.

All shapes static; padding entries have value 0 so they contribute nothing.
These are embedding-style gathers plus elementwise work; XLA fuses
the chain.  `factor_chunk` bounds the (chunk, N, P) gather intermediate so
HBM use stays flat for large N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svbfm.ops.segment import take_cols as _gather_rows


def fm_scores_and_sums(w0, w, v, ids, vals, k0: bool = True, k1: bool = True):
    """Returns (scores [N], sum_f [K, N]) — sum_f is the per-factor
    linear term cached by the SGD kernel (reference ``fm_sgd.h:44-50``).

    The w row rides as channel 0 of the V gather: a gather costs per index
    pass more than per channel, so folding w into the stacked table saves
    the separate rank-1 pass of the linear term."""
    N = ids.shape[0]
    K = v.shape[0]
    dtype = v.dtype
    acc = jnp.zeros((N,), dtype)
    if k0:
        acc = acc + w0
    if k1 and K > 0:
        wv = jnp.concatenate([w[None].astype(dtype), v], axis=0)  # [1+K, D]
        g = _gather_rows(wv, ids)  # [1+K, N, P]
        for p in range(ids.shape[1]):
            acc = acc + g[0, :, p] * vals[:, p]
        d = g[1:] * vals[None]
    else:
        if k1:
            for p in range(ids.shape[1]):
                acc = acc + jnp.take(w, ids[:, p], axis=-1) * vals[:, p]
        d = _gather_rows(v, ids) * vals[None]  # [K, N, P]
    s = d.sum(-1)  # [K, N]
    s2 = (d * d).sum(-1)
    acc = acc + 0.5 * (s * s - s2).sum(0)
    return acc, s


def fm_scores(w0, w, v, ids, vals, k0: bool = True, k1: bool = True,
              factor_chunk: int | None = None) -> jax.Array:
    """FM scores for a batch of rows; factor loop chunked to bound memory."""
    N = ids.shape[0]
    K = v.shape[0]
    dtype = v.dtype
    acc = jnp.zeros((N,), dtype)
    if k0:
        acc = acc + w0
    chunk = K if (factor_chunk is None or K == 0) else min(factor_chunk, K)
    if K and K % chunk != 0:
        chunk = K  # keep shapes static; fall back to single chunk
    # ride w as channel 0 of the V gather whenever one unchunked gather
    # covers all factors (one index pass instead of two)
    stack_w = k1 and K > 0 and chunk == K
    if k1 and not stack_w:
        for p in range(ids.shape[1]):
            acc = acc + jnp.take(w, ids[:, p], axis=-1) * vals[:, p]
    if K == 0:
        return acc

    def blk(acc, v_blk, with_w: bool):
        # per-position flat gathers keep every temp's minor dim large
        # (no [chunk, N, P] temp with a size-P minor dim).  The w terms add
        # into acc in p-order, keeping bitwise the unstacked association.
        s = 0.0
        s2 = 0.0
        for p in range(ids.shape[1]):
            g = jnp.take(v_blk, ids[:, p], axis=-1)  # [chunk(+1), N]
            if with_w:
                acc = acc + g[0] * vals[:, p]
                g = g[1:]
            d = g * vals[:, p]
            s = s + d
            s2 = s2 + d * d
        return acc + 0.5 * (s * s - s2).sum(0)

    if chunk == K:
        if stack_w:
            wv = jnp.concatenate([w[None].astype(dtype), v], axis=0)
            return blk(acc, wv, True)
        return blk(acc, v, False)
    vc = v.reshape(K // chunk, chunk, v.shape[1])
    # stacked-output scan (carry-free: plays nice with shard_map vma tracking)
    _, parts = jax.lax.scan(lambda c, vb: (c, blk(0.0, vb, False)), 0, vc)
    return acc + parts.sum(0)


def fm_t_terms(sigma_0_dash, sigma_w_dash, mu_v_dash, sigma_v_dash, ids, vals,
               k0: bool = True, k1: bool = True,
               factor_chunk: int | None = None) -> jax.Array:
    """VBFM T-terms (predictive-variance propagation) per row."""
    N = ids.shape[0]
    K = mu_v_dash.shape[0]
    dtype = mu_v_dash.dtype
    x2 = vals * vals
    acc = jnp.zeros((N,), dtype)
    if k0:
        acc = acc + sigma_0_dash
    chunk = K if (factor_chunk is None or K == 0) else min(factor_chunk, K)
    if K and K % chunk != 0:
        chunk = K
    # as in fm_scores: ride sigma'_w as channel 0 of the (mu, sigma) gather
    # so the linear-variance term costs no extra index pass
    stack_w = k1 and K > 0 and chunk == K
    if k1 and not stack_w:
        for p in range(ids.shape[1]):
            acc = acc + jnp.take(sigma_w_dash, ids[:, p], axis=-1) * x2[:, p]
    if K == 0:
        return acc

    def blk(acc, m_blk, s_blk, sw_row):
        # per-position flat gathers (see fm_scores: avoids P-minor padding)
        q2 = 0.0
        z = 0.0
        neg = 0.0
        if sw_row is not None:
            tab = jnp.concatenate([sw_row[None].astype(dtype), m_blk, s_blk],
                                  axis=0)  # [1+2K, D]
        for p in range(ids.shape[1]):
            if sw_row is not None:
                g = jnp.take(tab, ids[:, p], axis=-1)  # [1+2K, N]
                acc = acc + g[0] * x2[:, p]
                mg, sg = g[1:1 + K], g[1 + K:]
            else:
                mg = jnp.take(m_blk, ids[:, p], axis=-1)  # [chunk, N]
                sg = jnp.take(s_blk, ids[:, p], axis=-1)
            x2p = x2[:, p]
            mx = mg * vals[:, p]
            q2 = q2 + mx * mx
            z = z + sg * x2p
            neg = neg + mg * mg * (x2p * x2p) * sg + 0.5 * (x2p * x2p) * sg * sg
        t = 0.5 * z * z + z * q2 - neg
        return acc + t.sum(0)

    if chunk == K:
        return blk(acc, mu_v_dash, sigma_v_dash,
                   sigma_w_dash if stack_w else None)
    mc = mu_v_dash.reshape(K // chunk, chunk, mu_v_dash.shape[1])
    sc = sigma_v_dash.reshape(K // chunk, chunk, sigma_v_dash.shape[1])
    _, parts = jax.lax.scan(lambda c, b: (c, blk(0.0, *b, None)), 0, (mc, sc))
    return acc + parts.sum(0)
