"""OVBFM — online/stochastic variational Bayes FM with natural-gradient
mini-batch updates and Robbins-Monro step sizes.

A re-design of the reference learner (``fm_learn_vb_online.h`` +
``fm_learn_vb_online_simultaneous.h``, Saha & Misra).  Semantics follow the
*code*, not the paper's cleaner Eq. 31-32 (the graded curves come from the
code):

* Natural parameters eta1 = mu/sigma', eta2 = 1/sigma' for w0, w, V
  (``fm_learn_vb_online.h:750-765``).  A column update interpolates the old
  naturals toward chunk estimates with a per-coordinate Robbins-Monro rate
  rho = (t0 + t)^-lambda, lambda = 0.5, where t counts processed
  occurrences (``:406,467,521``).
* The reference updates eta per nonzero entry from the SAME captured
  ``eta_old`` and then averages over the column's chunk entries
  (``:508-525``); because eta_old is fixed during the loop, that average
  collapses exactly to an interpolation toward *chunk-mean* sufficient
  statistics — which is what the vectorized [C, L] row-sum computes:

    eta2 <- (1-rho) eta2 + rho (sigma_w(g) + alpha * col_count * mean(x^2))
    eta1 <- (1-rho) eta1 + rho * col_count * alpha * mean(x (e + x mu))

  (col_count = full-train occurrences of the column, scanned at init,
  ``:704-726``; alpha * col_count * mean ~ full-data scaling.)
* Primal mu = eta1/eta2, sigma' = 1/eta2 with NaN/Inf reverts that keep the
  *naturals* but revert the primal (``:528-549``) — preserved.
* Hyperparameters are exponentially smoothed with rho_w0
  (``:412-468``); a NaN/Inf alpha aborts the remaining hyper updates and
  the t_w0 increment for the chunk (the early ``return`` at ``:421-434``).
* Per-epoch chunking: the reference re-shuffles row membership into
  ``num_batch`` disk files each epoch (``fm_learn_vb_online_simultaneous.h:
  76-101``).  Here chunk *membership* is fixed once (a seeded permutation)
  and only the chunk *order* is reshuffled per epoch, so each chunk's
  sweep plan is static and the whole epoch compiles to ONE XLA program
  (a ``lax.scan`` over shuffled chunk indices into HBM-stacked chunk
  arrays).  Statistically equivalent; documented deviation.

Sharding: chunk rows and block entries over the ``data`` mesh axis;
parameters/naturals replicated; per-column chunk statistics psum'd.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from svbfm.data.dataset import ColumnBlock, SparseDataset, SweepPlan
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    BlockData,
    FMConfig,
    RowData,
    TASK_CLASSIFICATION,
    TASK_REGRESSION,
    TrajectoryFile,
    build_row_data,
    evaluate_classification,
    evaluate_regression,
    keep_finite,
    print_nonzero_nans,
    ref_cdf_gaussian,
)
from svbfm.learners.vb import init_vb_params
from svbfm.ops.forward import fm_scores, fm_t_terms
from svbfm.ops.segment import take_cols, take_rows
from svbfm.parallel.mesh import DATA_AXIS, make_mesh, shard_rows, put_replicated
from svbfm.utils.pytree import pytree_dataclass

LAMBDA = 0.5
T0_W0 = 1.0
T0_WJ = 1.0
T0_VJ = 1.0


# Flat-vs-generic v-sweep dispatch threshold, in estimated padded temp
# bytes of the generic path (see _use_flat_dispatch).  Set between two
# shapes on the earlier accelerator's memory, where Netflix-shape 2.5M-row
# chunks (est 16.7e9) ran generic and KDD-shape 2.63M-row chunks at
# D=1.63M (est 21.5e9) needed the flat layout; not measured on the H100.
OVB_FLAT_THRESHOLD = 19_000_000_000


def _flat_overhead_estimate(n_rows: int, D: int) -> int:
    """Estimated generic-path tile-padding overhead in bytes (the [N, P,
    5F] delta gathers' minor-dim padding plus the [D, K]-table lane
    padding), linearized in the two drivers n_rows and D."""
    return n_rows * 6_000 + D * 3_500


def _use_flat_dispatch(n_rows: int, D: int, F: int) -> bool:
    """True when the F=1 v-sweep should use the flat (pad-free) layout:
    slower at small shapes on the earlier accelerator but the only layout
    that compiled there at huge-chunk/huge-D shapes.  SVBFM_OVB_FLAT=1/0
    overrides."""
    import os
    if F != 1:
        return False
    ov = os.environ.get("SVBFM_OVB_FLAT")
    if ov is not None:
        return ov != "0"
    return _flat_overhead_estimate(n_rows, D) > OVB_FLAT_THRESHOLD


def _ceil_to_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


@pytree_dataclass
class OVBState:
    # primal variational parameters
    mu_0: jax.Array
    sigma_0_dash: jax.Array
    mu_w: jax.Array  # [D]
    sigma_w_dash: jax.Array  # [D]
    mu_v: jax.Array  # [K, D]
    sigma_v_dash: jax.Array  # [K, D]
    # natural parameters
    n_mu_0: jax.Array
    n_sig_0: jax.Array
    n_mu_w: jax.Array  # [D]
    n_sig_w: jax.Array  # [D]
    n_mu_v: jax.Array  # [K, D]
    n_sig_v: jax.Array  # [K, D]
    # hyperparameters
    alpha: jax.Array
    sigma_0: jax.Array
    sigma_w: jax.Array  # [G]
    sigma_v: jax.Array  # [G, K]
    # Robbins-Monro occurrence counters
    t_w0: jax.Array  # scalar f32
    t_wj: jax.Array  # [D]
    t_vj: jax.Array  # [D]


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


#: reference nan/inf counter families
#: (fm_learn_vb_online_simultaneous.h:71-72, printed when nonzero at
#: :159-186 — the reference's print labels are all copy-pasted as "alpha";
#: we print the real family names)
OVB_NAN_FAMILIES = ("alpha", "sigma_0", "sigma_w", "sigma_v",
                    "mu_0_dash", "sigma_0_dash", "mu_w_dash",
                    "sigma_w_dash", "mu_v_dash", "sigma_v_dash")


def zero_ovb_counters():
    """All-zero counter dict with the full fixed key set."""
    from svbfm.learners.base import zero_counters
    return zero_counters(OVB_NAN_FAMILIES)


def ovb_counter_specs():
    """PartitionSpecs for the counter dict (see base.counter_specs)."""
    from svbfm.learners.base import counter_specs
    return counter_specs(OVB_NAN_FAMILIES)


def init_ovb_state(key: jax.Array, cfg: FMConfig, col_count: np.ndarray,
                   dtype=jnp.float32) -> OVBState:
    p = init_vb_params(key, cfg, dtype)
    return OVBState(
        mu_0=p["mu_0"], sigma_0_dash=p["sigma_0_dash"],
        mu_w=p["mu_w"], sigma_w_dash=p["sigma_w_dash"],
        mu_v=p["mu_v"], sigma_v_dash=p["sigma_v_dash"],
        # naturals from the primal init (fm_learn_vb_online.h:750-765)
        n_mu_0=p["mu_0"] / 0.02, n_sig_0=1.0 / p["sigma_0_dash"],
        n_mu_w=p["mu_w"] / 0.02, n_sig_w=1.0 / p["sigma_w_dash"],
        n_mu_v=p["mu_v"] / 0.02, n_sig_v=1.0 / p["sigma_v_dash"],
        alpha=p["alpha"], sigma_0=p["sigma_0"],
        sigma_w=p["sigma_w"], sigma_v=p["sigma_v"],
        t_w0=jnp.zeros((), dtype),
        t_wj=jnp.zeros((cfg.num_attributes,), dtype),
        t_vj=jnp.zeros((cfg.num_attributes,), dtype),
    )


def ovb_chunk_update(state: OVBState, row: RowData, blocks, cfg: FMConfig,
                     n_full: float, n_chunk: float, attr_group,
                     num_attr_per_group):
    """Process one chunk (fm_learn_vb_online.h:354-468).  Runs inside
    shard_map; `blocks` is the chunk's (bins -> buckets) BlockData tree with
    shard-local [C, L] entry arrays.  Returns ``(new_state, fe, nans)``
    where ``nans`` maps ``nan_<family>``/``inf_<family>`` to int32
    rejected-candidate counts (fm_learn_vb_online_simultaneous.h:71-72)."""
    from svbfm.learners.mcmc import _count_bad

    counters = zero_ovb_counters()
    dtype = state.mu_w.dtype
    D, K = cfg.num_attributes, cfg.num_factor
    Nf = jnp.asarray(n_full, dtype)
    Nc = jnp.asarray(n_chunk, dtype)
    alpha = state.alpha
    # Robbins-Monro rate for w0/hypers: (t0 + t)^-lambda with t = chunks
    # processed so far (reference init new_w0 = (t0+0)^-lambda = 1.0)
    rho0 = (T0_W0 + state.t_w0) ** (-LAMBDA)

    # chunk e / T caches from current primal parameters
    yhat = fm_scores(state.mu_0, state.mu_w, state.mu_v, row.ids, row.vals,
                     k0=cfg.k0, k1=cfg.k1)
    e = (row.target - yhat) * row.valid
    t = fm_t_terms(state.sigma_0_dash, state.sigma_w_dash, state.mu_v,
                   state.sigma_v_dash, row.ids, row.vals,
                   k0=cfg.k0, k1=cfg.k1) * row.valid

    mu_0, sigma_0_dash = state.mu_0, state.sigma_0_dash
    n_mu_0, n_sig_0 = state.n_mu_0, state.n_sig_0
    mu_w, sigma_w_dash = state.mu_w, state.sigma_w_dash
    n_mu_w, n_sig_w = state.n_mu_w, state.n_sig_w
    t_wj, t_vj = state.t_wj, state.t_vj

    # --- w0 (fm_learn_vb_online.h:471-497) ---
    if cfg.k0:
        mu_old_p, sig_old_p = mu_0, sigma_0_dash
        w0_temp = _psum(jnp.sum(e)) / Nc + mu_0
        n_sig_0 = (1.0 - rho0) * n_sig_0 + rho0 * (state.sigma_0 + Nf * alpha)
        n_mu_0 = (1.0 - rho0) * n_mu_0 + rho0 * Nf * alpha * w0_temp
        _count_bad(counters, "mu_0_dash", n_mu_0 / n_sig_0)
        _count_bad(counters, "sigma_0_dash", 1.0 / n_sig_0)
        mu_new = keep_finite(n_mu_0 / n_sig_0, mu_old_p)
        sig_new = keep_finite(1.0 / n_sig_0, sig_old_p)
        e = e + (mu_old_p - mu_new) * row.valid
        t = t + (sig_new - sig_old_p) * row.valid
        mu_0, sigma_0_dash = mu_new, sig_new

    # --- w sweep (fm_learn_vb_online.h:499-557) ---
    if cfg.k1:
        for bin_blocks in blocks:
            dmu = jnp.zeros((D,), dtype)
            dsig = jnp.zeros((D,), dtype)
            for blk in bin_blocks:
                x = blk.x[0]
                cnt = blk.cnt  # chunk entry count per column (precomputed)
                active = cnt > 0
                cnt1 = jnp.maximum(cnt, 1.0)
                mu_c = take_rows(mu_w, blk.cols)
                sig_c = take_rows(sigma_w_dash, blk.cols)
                nmu_c = take_rows(n_mu_w, blk.cols)
                nsig_c = take_rows(n_sig_w, blk.cols)
                sw_g = take_rows(state.sigma_w, blk.group)
                rho = (T0_WJ + take_rows(t_wj, blk.cols)) ** (-LAMBDA)
                e_g = take_rows(e, blk.rows[0])
                s1 = _psum((x * (e_g + x * mu_c[:, None])).sum(-1)) / cnt1
                msx2 = blk.sx2 / cnt1
                nsig_new = (1.0 - rho) * nsig_c + rho * (
                    sw_g + alpha * blk.col_count * msx2)
                nmu_new = (1.0 - rho) * nmu_c + rho * blk.col_count * alpha * s1
                _count_bad(counters, "mu_w_dash",
                           jnp.where(active, nmu_new / nsig_new, 0.0))
                _count_bad(counters, "sigma_w_dash",
                           jnp.where(active, 1.0 / nsig_new, 0.0))
                mu_new = keep_finite(nmu_new / nsig_new, mu_c)
                sig_new = keep_finite(1.0 / nsig_new, sig_c)
                # inactive (not in this chunk) columns stay untouched
                mu_new = jnp.where(active, mu_new, mu_c)
                sig_new = jnp.where(active, sig_new, sig_c)
                nmu_new = jnp.where(active, nmu_new, nmu_c)
                nsig_new = jnp.where(active, nsig_new, nsig_c)
                mu_w = mu_w.at[blk.cols].set(mu_new)
                sigma_w_dash = sigma_w_dash.at[blk.cols].set(sig_new)
                n_mu_w = n_mu_w.at[blk.cols].set(nmu_new)
                n_sig_w = n_sig_w.at[blk.cols].set(nsig_new)
                dmu = dmu.at[blk.cols].set(mu_c - mu_new)
                dsig = dsig.at[blk.cols].set(sig_new - sig_c)
                t_wj = t_wj.at[blk.cols].add(jnp.where(active, cnt, 0.0))
            x_r = row.vals
            # per-position gathers from the [2, D] delta table: no
            # [N, P, 2]-shaped temp with a size-2 minor dim
            dtab = jnp.stack([dmu, dsig], axis=0)  # [2, D]
            de = jnp.zeros_like(e)
            dt = jnp.zeros_like(t)
            for p in range(row.ids.shape[1]):
                g = jnp.take(dtab, row.ids[:, p], axis=-1)  # [2, N]
                de = de + x_r[:, p] * g[0]
                dt = dt + x_r[:, p] * x_r[:, p] * g[1]
            e = e + de * row.valid
            t = t + dt * row.valid

    # --- v sweeps, factor-blocked (fm_learn_vb_online.h:375-407,560-627) ---
    mu_v, sigma_v_dash = state.mu_v, state.sigma_v_dash
    n_mu_v, n_sig_v = state.n_mu_v, state.n_sig_v
    if K > 0:
        F = cfg.factor_block if cfg.factor_block > 0 else K
        F = min(F, K)
        nb = -(-K // F)
        K_pad = nb * F
        # [K, D] directly: the minor dim stays large
        sv_kd = take_cols(state.sigma_v.T, attr_group)  # [K, D]
        rho_v_d = (T0_VJ + t_vj) ** (-LAMBDA)  # [D]

        def pad_f(a, fill=1.0):
            if K_pad != K:
                a = jnp.concatenate(
                    [a, jnp.full((K_pad - K,) + a.shape[1:], fill, a.dtype)], 0)
            return a.reshape(nb, F, *a.shape[1:])

        fmask = (jnp.arange(K_pad).reshape(nb, F) < K) if K_pad != K else None

        # The flat path trades one [N, P]-index gather pass for P
        # per-position passes; its pad-free temps are what let huge chunks
        # compile on the earlier accelerator.  See _use_flat_dispatch.
        use_flat = _use_flat_dispatch(row.ids.shape[0], D, F)
        mu_s, sig_s = pad_f(mu_v), pad_f(sigma_v_dash)
        nmu_s = pad_f(n_mu_v)
        nsig_s = pad_f(n_sig_v, fill=1.0)
        sv_s = pad_f(sv_kd)
        z32 = jnp.zeros((), jnp.int32)

        def blk_step(carry, xs):
            # v nan/inf counts ride the carry (trace-safe inside lax.scan);
            # q/tq/tz caches for THIS block arrive prebuilt in the carry
            # and the next block's are built by this block's last delta
            # pass (pass pipelining — one index pass saved per block)
            e, t, t_vj_add, vcnt, qtz = carry
            if fmask is None:
                mu_b, sig_b, nmu_b, nsig_b, sv_b, nxt_mu, nxt_sig = xs
                m = None
            else:
                mu_b, sig_b, nmu_b, nsig_b, sv_b, m, nxt_mu, nxt_sig = xs
                m = m[None, :]
            if use_flat:
                # flat specialization (K % 1 == 0, so fmask is None here)
                nptab = jnp.stack([nxt_mu[0], nxt_sig[0]], axis=0)  # [2, D]
                out = ovb_v_factor(e, t, mu_b[0], sig_b[0], nmu_b[0],
                                   nsig_b[0], sv_b[0], alpha, rho_v_d,
                                   blocks, row, cfg, qtz=qtz,
                                   next_ptab=nptab)
                e, t, mu_f, sig_f, nmu_f, nsig_f, tv_add, vc, nqtz = out
                vcnt = tuple(a + b for a, b in zip(vcnt, vc))
                return (e, t, t_vj_add + tv_add, vcnt, nqtz), \
                    (mu_f[None], sig_f[None], nmu_f[None], nsig_f[None])
            nptab = jnp.concatenate([nxt_mu.T, nxt_sig.T], axis=-1)
            out = ovb_v_block(e, t, mu_b.T, sig_b.T, nmu_b.T, nsig_b.T,
                              sv_b.T, alpha, rho_v_d, blocks, row, cfg, m,
                              qtz=qtz, next_ptab=nptab)
            e, t, mu_t, sig_t, nmu_t, nsig_t, tv_add, vc, nqtz = out
            vcnt = tuple(a + b for a, b in zip(vcnt, vc))
            return (e, t, t_vj_add + tv_add, vcnt, nqtz), \
                (mu_t.T, sig_t.T, nmu_t.T, nsig_t.T)

        if nb == 1:
            # single block: nothing to pipeline (fmask is None here since
            # nb == 1 implies F == K)
            if use_flat:
                out = ovb_v_factor(e, t, mu_s[0, 0], sig_s[0, 0],
                                   nmu_s[0, 0], nsig_s[0, 0], sv_s[0, 0],
                                   alpha, rho_v_d, blocks, row, cfg)
                e, t, mu_f, sig_f, nmu_f, nsig_f, tv_add, vc = out
                outs = (mu_f[None][None], sig_f[None][None],
                        nmu_f[None][None], nsig_f[None][None])
            else:
                out = ovb_v_block(e, t, mu_s[0].T, sig_s[0].T, nmu_s[0].T,
                                  nsig_s[0].T, sv_s[0].T, alpha, rho_v_d,
                                  blocks, row, cfg, None)
                e, t, mu_t, sig_t, nmu_t, nsig_t, tv_add, vc = out
                outs = (mu_t.T[None], sig_t.T[None], nmu_t.T[None],
                        nsig_t.T[None])
            vcnt = vc
        else:
            xs = (mu_s, sig_s, nmu_s, nsig_s, sv_s)
            if fmask is not None:
                xs = xs + (fmask,)
            xs = xs + (jnp.roll(mu_s, -1, axis=0),
                       jnp.roll(sig_s, -1, axis=0))
            qtz0 = (_qtz_flat(mu_s[0, 0], sig_s[0, 0], e, row) if use_flat
                    else _qtz_generic(mu_s[0].T, sig_s[0].T, row))
            carry0 = (e, t, jnp.zeros((D,), dtype), (z32,) * 4, qtz0)
            (e, t, tv_add, vcnt, _qtz_end), outs = jax.lax.scan(
                blk_step, carry0, xs)
        for k, val in zip(("nan_mu_v_dash", "inf_mu_v_dash",
                           "nan_sigma_v_dash", "inf_sigma_v_dash"), vcnt):
            counters[k] = counters[k] + val
        mu_vp, sig_vp, nmu_vp, nsig_vp = outs
        mu_v = mu_vp.reshape(K_pad, -1)[:K]
        sigma_v_dash = sig_vp.reshape(K_pad, -1)[:K]
        n_mu_v = nmu_vp.reshape(K_pad, -1)[:K]
        n_sig_v = nsig_vp.reshape(K_pad, -1)[:K]
        # t_vj incremented once per chunk (the f==0 pass in the reference)
        t_vj = t_vj + tv_add / jnp.asarray(float(max(nb, 1)), dtype)

    # --- hyperparameter smoothing (fm_learn_vb_online.h:410-468) ---
    alpha_temp = _psum(jnp.sum(e * e + t))
    alpha_cand = (1.0 - rho0) * alpha + rho0 * (Nc / alpha_temp)
    _count_bad(counters, "alpha", alpha_cand)
    alpha_ok = jnp.isfinite(alpha_cand)
    alpha_new = jnp.where(alpha_ok, alpha_cand, alpha)
    # the reference early-returns on a bad alpha, skipping the remaining
    # hyper updates and the t_w0 increment for this chunk
    sigma_0_cand = ((1.0 - rho0) * state.sigma_0
                    + rho0 * (1.0 / (mu_0 * mu_0 + sigma_0_dash)))
    _count_bad(counters, "sigma_0", sigma_0_cand)
    sigma_0 = jnp.where(alpha_ok, sigma_0_cand, state.sigma_0)
    G = cfg.num_groups
    w_stat = jax.ops.segment_sum(mu_w * mu_w + sigma_w_dash, attr_group,
                                 num_segments=G)
    sigma_w_cand = ((1.0 - rho0) * state.sigma_w
                    + rho0 * (num_attr_per_group / w_stat))
    _count_bad(counters, "sigma_w", sigma_w_cand)
    sigma_w = jnp.where(alpha_ok, sigma_w_cand, state.sigma_w)
    # per-factor flat segment sums: no [D, K]-transposed input with a
    # small minor dim
    if K > 0:
        v_stat = jnp.stack(
            [jax.ops.segment_sum(mu_v[k] * mu_v[k] + sigma_v_dash[k],
                                 attr_group, num_segments=G)
             for k in range(K)], axis=1)  # [G, K]
    else:
        v_stat = jnp.zeros((G, 0), dtype)
    sigma_v_cand = ((1.0 - rho0) * state.sigma_v
                    + rho0 * (num_attr_per_group[:, None] / v_stat))
    _count_bad(counters, "sigma_v", sigma_v_cand)
    sigma_v = jnp.where(alpha_ok, sigma_v_cand, state.sigma_v)
    t_w0 = state.t_w0 + jnp.where(alpha_ok, 1.0, 0.0)

    # --- chunk free energy (fm_learn_vb_online.h:629-663; 2*3.14 kept) ---
    fe = -0.5 * alpha_new * alpha_temp - 0.5 * Nc * jnp.log(2 * 3.14 / alpha_new)
    fe += (-0.5 * sigma_0 * (mu_0 * mu_0 + sigma_0_dash)
           + 0.5 * jnp.log(sigma_0_dash * sigma_0) + 0.5)
    sw_d = take_rows(sigma_w, attr_group)
    fe += jnp.sum(-0.5 * sw_d * (mu_w * mu_w + sigma_w_dash)
                  + 0.5 * jnp.log(sigma_w_dash * sw_d) + 0.5)
    sv_td = take_cols(sigma_v.T, attr_group)  # [K, D] (pad-free layout)
    fe += jnp.sum(-0.5 * sv_td * (mu_v * mu_v + sigma_v_dash)
                  + 0.5 * jnp.log(sigma_v_dash * sv_td) + 0.5)

    new_state = OVBState(
        mu_0=mu_0, sigma_0_dash=sigma_0_dash, mu_w=mu_w,
        sigma_w_dash=sigma_w_dash, mu_v=mu_v, sigma_v_dash=sigma_v_dash,
        n_mu_0=n_mu_0, n_sig_0=n_sig_0, n_mu_w=n_mu_w, n_sig_w=n_sig_w,
        n_mu_v=n_mu_v, n_sig_v=n_sig_v, alpha=alpha_new, sigma_0=sigma_0,
        sigma_w=sigma_w, sigma_v=sigma_v, t_w0=t_w0, t_wj=t_wj, t_vj=t_vj)
    return new_state, fe, dict(counters)


def _qtz_generic(mu_t, sig_t, row):
    """q/tq/tz caches [N, F] for a factor block (add_main_q,
    fm_learn_vb_online.h:375-407) — one [N, P, 2F] channel gather."""
    F = mu_t.shape[1]
    x_re = row.vals[:, :, None]
    x2_re = x_re * x_re
    ptab = jnp.concatenate([mu_t, sig_t], axis=-1)
    pg = take_rows(ptab, row.ids)  # [N, P, 2F]
    mug, sigg = pg[..., :F], pg[..., F:]
    q = (mug * x_re).sum(1) * row.valid[:, None]
    tq = (sigg * x2_re).sum(1) * row.valid[:, None]
    tz = (mug * mug * x2_re).sum(1) * row.valid[:, None]
    return q, tq, tz


def _qtz_flat(mu_d, sig_d, e_like, row):
    """Flat q/tq/tz caches [N] (F=1): per-position [2, N] channel
    gathers, pad-free."""
    ptabT = jnp.stack([mu_d, sig_d], axis=0)  # [2, D]
    q = jnp.zeros_like(e_like)
    tq = jnp.zeros_like(e_like)
    tz = jnp.zeros_like(e_like)
    for p in range(row.ids.shape[1]):
        g = take_cols(ptabT, row.ids[:, p])  # [2, N]
        xp = row.vals[:, p]
        x2p = xp * xp
        q = q + g[0] * xp
        tq = tq + g[1] * x2p
        tz = tz + g[0] * g[0] * x2p
    return q * row.valid, tq * row.valid, tz * row.valid


def ovb_v_block(e, t, mu_t, sig_t, nmu_t, nsig_t, sv_t, alpha, rho_v_d,
                blocks, row, cfg: FMConfig, fmask=None, qtz=None,
                next_ptab=None):
    """Online v update for a block of F factors (channel-stacked gathers,
    same execution scheme as vb.vb_v_block_update).  The last return value
    is the (nan_mu, inf_mu, nan_sig, inf_sig) candidate counts for the
    block (int32 scalars, summed into the chunk counters by the caller).

    ``qtz``/``next_ptab`` implement pass pipelining across the
    factor-sequential scan (see ovb_v_factor's docstring): prebuilt
    caches skip the [N, P, 2F] build gather, and the last bin's delta
    gather also carries the NEXT block's ([D, 2F]) build channels,
    returning its caches as a trailing element — one full [N*P]-index
    pass saved per factor block, bit-identical values."""
    from svbfm.learners.mcmc import _count_bad

    local: dict = {}
    D, F = mu_t.shape
    dtype = mu_t.dtype
    ids, x_r = row.ids, row.vals
    x_re = x_r[:, :, None]
    x2_re = x_re * x_re
    tv_add = jnp.zeros((D,), dtype)

    if qtz is not None:
        q, tq, tz = qtz
    else:
        q, tq, tz = _qtz_generic(mu_t, sig_t, row)
    nqtz = None

    for bi, bin_blocks in enumerate(blocks):
        last_bin = bi == len(blocks) - 1
        mu_old_t, sig_old_t = mu_t, sig_t
        dmu_d = jnp.zeros((D, F), dtype)
        dsig_d = jnp.zeros((D, F), dtype)
        dmu2_d = jnp.zeros((D, F), dtype)
        stab = jnp.concatenate([e[:, None], q, tq], axis=-1)
        for blk in bin_blocks:
            x = blk.x[0][:, :, None]
            x2 = x * x
            cnt = blk.cnt[:, None]  # [C, 1] chunk entry count
            active = cnt > 0
            cnt1 = jnp.maximum(cnt, 1.0)
            g = take_rows(stab, blk.rows[0])  # [C, L, 1+2F]
            e_g = g[..., :1]
            q_g = g[..., 1:1 + F]
            tq_g = g[..., 1 + F:]
            mu_c = take_rows(mu_old_t, blk.cols)
            sig_c = take_rows(sig_old_t, blk.cols)
            nmu_c = take_rows(nmu_t, blk.cols)
            nsig_c = take_rows(nsig_t, blk.cols)
            sv_g = take_rows(sv_t, blk.cols)
            rho = take_rows(rho_v_d, blk.cols)[:, None]  # [C, 1]
            h = q_g - x * mu_c[:, None, :]
            h1 = tq_g - x2 * sig_c[:, None, :]
            v_mean = _psum((x * h * (e_g + x * mu_c[:, None, :] * h)).sum(1)) / cnt1
            v_sig = _psum((x2 * h * h + x2 * h1).sum(1)) / cnt1
            cc = blk.col_count[:, None]
            nsig_new = (1.0 - rho) * nsig_c + rho * (sv_g + alpha * cc * v_sig)
            nmu_new = (1.0 - rho) * nmu_c + rho * cc * alpha * v_mean
            sel = active if fmask is None else (active & fmask)
            _count_bad(local, "mu_v_dash",
                       jnp.where(sel, nmu_new / nsig_new, 0.0))
            _count_bad(local, "sigma_v_dash",
                       jnp.where(sel, 1.0 / nsig_new, 0.0))
            mu_new = keep_finite(nmu_new / nsig_new, mu_c)
            sig_new = keep_finite(1.0 / nsig_new, sig_c)
            if fmask is not None:
                mu_new = jnp.where(fmask, mu_new, mu_c)
                sig_new = jnp.where(fmask, sig_new, sig_c)
                nmu_new = jnp.where(fmask, nmu_new, nmu_c)
                nsig_new = jnp.where(fmask, nsig_new, nsig_c)
            mu_new = jnp.where(active, mu_new, mu_c)
            sig_new = jnp.where(active, sig_new, sig_c)
            nmu_new = jnp.where(active, nmu_new, nmu_c)
            nsig_new = jnp.where(active, nsig_new, nsig_c)
            mu_t = mu_t.at[blk.cols].set(mu_new)
            sig_t = sig_t.at[blk.cols].set(sig_new)
            nmu_t = nmu_t.at[blk.cols].set(nmu_new)
            nsig_t = nsig_t.at[blk.cols].set(nsig_new)
            dmu_d = dmu_d.at[blk.cols].set(mu_new - mu_c)
            dsig_d = dsig_d.at[blk.cols].set(sig_new - sig_c)
            dmu2_d = dmu2_d.at[blk.cols].set(mu_new * mu_new - mu_c * mu_c)
            tv_add = tv_add.at[blk.cols].add(jnp.where(active[:, 0], blk.cnt, 0.0))

        merge_next = last_bin and next_ptab is not None
        parts = [mu_old_t, sig_old_t, dmu_d, dsig_d, dmu2_d]
        if merge_next:
            parts.append(next_ptab)  # [D, 2Fn]
        dtab = jnp.concatenate(parts, axis=-1)
        gg = take_rows(dtab, ids)  # [N, P, 5F(+2Fn)]
        mu_e = gg[..., 0 * F:1 * F]
        sig_e = gg[..., 1 * F:2 * F]
        dmu_e = gg[..., 2 * F:3 * F]
        dsig_e = gg[..., 3 * F:4 * F]
        dmu2_e = gg[..., 4 * F:5 * F]
        he = x_re * (q[:, None, :] - x_re * mu_e)
        h1e = x2_re * (tq[:, None, :] - x2_re * sig_e)
        h2e = x2_re * (tz[:, None, :] - x2_re * mu_e * mu_e)
        vmask = row.valid[:, None]
        q = q + (x_re * dmu_e).sum(1) * vmask
        tq = tq + (x2_re * dsig_e).sum(1) * vmask
        tz = tz + (x2_re * dmu2_e).sum(1) * vmask
        e = e - (he * dmu_e).sum((1, 2)) * row.valid
        t = t + (((h1e + h2e) * dsig_e + h1e * dmu2_e)).sum((1, 2)) * row.valid
        if merge_next:
            Fn = next_ptab.shape[1] // 2
            mug_n = gg[..., 5 * F:5 * F + Fn]
            sigg_n = gg[..., 5 * F + Fn:]
            nqtz = ((mug_n * x_re).sum(1) * vmask,
                    (sigg_n * x2_re).sum(1) * vmask,
                    (mug_n * mug_n * x2_re).sum(1) * vmask)
    z32 = jnp.zeros((), jnp.int32)
    vc = (jnp.asarray(local.get("nan_mu_v_dash", z32), jnp.int32),
          jnp.asarray(local.get("inf_mu_v_dash", z32), jnp.int32),
          jnp.asarray(local.get("nan_sigma_v_dash", z32), jnp.int32),
          jnp.asarray(local.get("inf_sigma_v_dash", z32), jnp.int32))
    if next_ptab is not None:
        return e, t, mu_t, sig_t, nmu_t, nsig_t, tv_add, vc, nqtz
    return e, t, mu_t, sig_t, nmu_t, nsig_t, tv_add, vc


def ovb_v_factor(e, t, mu_d, sig_d, nmu_d, nsig_d, sv_d, alpha, rho_v_d,
                 blocks, row, cfg: FMConfig, qtz=None, next_ptab=None):
    """F=1 FLAT specialization of :func:`ovb_v_block` — the hot path, since
    online natural-gradient updates must stay factor-sequential (see
    OVBLearner.__init__).

    Same math, same float op order, but every temp is rank-1 ([N]/[D]/[C])
    or has a large minor dim ([CH, N] channel-stacked gathers, [C, L]
    bucket tiles).  The generic path's [N, P, 5F] / [D, F] / [C, L, F]
    arrays have a size-F minor dim, which a tiled memory layout pads up to
    128 at F=1.  Per-position gathers from [CH, D] channel-stacked tables
    keep the gather cost per index-pass while every buffer stays pad-free
    (fm_learn_vb_online.h:560-627 semantics throughout).

    Pass pipelining across the factor-sequential scan: with ``qtz`` the
    q/tq/tz caches arrive prebuilt (by the PREVIOUS factor's last delta
    pass) and the build gather is skipped; with ``next_ptab`` ([2, D]
    stacked mu/sig of the NEXT factor) the last bin's delta gather also
    carries the next factor's build channels and the next-factor caches
    ride the return value — one full [N*P]-index pass saved per factor.
    Values are bit-identical: the merged channels read the same
    tables with the same arithmetic."""
    from svbfm.learners.mcmc import _count_bad

    local: dict = {}
    D = mu_d.shape[0]
    dtype = mu_d.dtype
    ids, x_r = row.ids, row.vals
    tv_add = jnp.zeros((D,), dtype)

    if qtz is not None:
        q, tq, tz = qtz
    else:
        q, tq, tz = _qtz_flat(mu_d, sig_d, e, row)
    nq = ntq = ntz = None

    for bi, bin_blocks in enumerate(blocks):
        last_bin = bi == len(blocks) - 1
        mu_old, sig_old = mu_d, sig_d
        dmu_v = jnp.zeros((D,), dtype)
        dsig_v = jnp.zeros((D,), dtype)
        dmu2_v = jnp.zeros((D,), dtype)
        stabT = jnp.stack([e, q, tq], axis=0)  # [3, N]
        for blk in bin_blocks:
            x = blk.x[0]  # [C, L]
            x2 = x * x
            cnt = blk.cnt  # [C] chunk entry count
            active = cnt > 0
            cnt1 = jnp.maximum(cnt, 1.0)
            g = take_cols(stabT, blk.rows[0])  # [3, C, L]
            e_g, q_g, tq_g = g[0], g[1], g[2]
            mu_c = take_rows(mu_old, blk.cols)  # [C]
            sig_c = take_rows(sig_old, blk.cols)
            nmu_c = take_rows(nmu_d, blk.cols)
            nsig_c = take_rows(nsig_d, blk.cols)
            sv_g = take_rows(sv_d, blk.cols)
            rho = take_rows(rho_v_d, blk.cols)
            h = q_g - x * mu_c[:, None]
            h1 = tq_g - x2 * sig_c[:, None]
            v_mean = _psum((x * h * (e_g + x * mu_c[:, None] * h)).sum(-1)) / cnt1
            v_sig = _psum((x2 * h * h + x2 * h1).sum(-1)) / cnt1
            cc = blk.col_count
            nsig_new = (1.0 - rho) * nsig_c + rho * (sv_g + alpha * cc * v_sig)
            nmu_new = (1.0 - rho) * nmu_c + rho * cc * alpha * v_mean
            _count_bad(local, "mu_v_dash",
                       jnp.where(active, nmu_new / nsig_new, 0.0))
            _count_bad(local, "sigma_v_dash",
                       jnp.where(active, 1.0 / nsig_new, 0.0))
            mu_new = keep_finite(nmu_new / nsig_new, mu_c)
            sig_new = keep_finite(1.0 / nsig_new, sig_c)
            mu_new = jnp.where(active, mu_new, mu_c)
            sig_new = jnp.where(active, sig_new, sig_c)
            nmu_new = jnp.where(active, nmu_new, nmu_c)
            nsig_new = jnp.where(active, nsig_new, nsig_c)
            mu_d = mu_d.at[blk.cols].set(mu_new)
            sig_d = sig_d.at[blk.cols].set(sig_new)
            nmu_d = nmu_d.at[blk.cols].set(nmu_new)
            nsig_d = nsig_d.at[blk.cols].set(nsig_new)
            dmu_v = dmu_v.at[blk.cols].set(mu_new - mu_c)
            dsig_v = dsig_v.at[blk.cols].set(sig_new - sig_c)
            dmu2_v = dmu2_v.at[blk.cols].set(mu_new * mu_new - mu_c * mu_c)
            tv_add = tv_add.at[blk.cols].add(jnp.where(active, blk.cnt, 0.0))

        # apply the bin's deltas to e/t/q/tq/tz via one [5, N] channel
        # gather per position (the generic path's [N, P, 5] form); the
        # LAST bin's gather also carries the next factor's mu/sig build
        # channels (pass pipelining — see docstring)
        merge_next = last_bin and next_ptab is not None
        parts = [mu_old, sig_old, dmu_v, dsig_v, dmu2_v]
        if merge_next:
            parts += [next_ptab[0], next_ptab[1]]
            nq = jnp.zeros_like(e)
            ntq = jnp.zeros_like(e)
            ntz = jnp.zeros_like(e)
        dtabT = jnp.stack(parts, axis=0)
        dq = jnp.zeros_like(e)
        dtq = jnp.zeros_like(e)
        dtz = jnp.zeros_like(e)
        de = jnp.zeros_like(e)
        dt = jnp.zeros_like(e)
        for p in range(ids.shape[1]):
            g = take_cols(dtabT, ids[:, p])  # [5(+2), N]
            mu_e, sig_e, dmu_e, dsig_e, dmu2_e = g[0], g[1], g[2], g[3], g[4]
            xp = x_r[:, p]
            x2p = xp * xp
            he = xp * (q - xp * mu_e)
            h1e = x2p * (tq - x2p * sig_e)
            h2e = x2p * (tz - x2p * mu_e * mu_e)
            dq = dq + xp * dmu_e
            dtq = dtq + x2p * dsig_e
            dtz = dtz + x2p * dmu2_e
            de = de + he * dmu_e
            dt = dt + (h1e + h2e) * dsig_e + h1e * dmu2_e
            if merge_next:
                nq = nq + g[5] * xp
                ntq = ntq + g[6] * x2p
                ntz = ntz + g[5] * g[5] * x2p
        q = q + dq * row.valid
        tq = tq + dtq * row.valid
        tz = tz + dtz * row.valid
        e = e - de * row.valid
        t = t + dt * row.valid
        if merge_next:
            nq = nq * row.valid
            ntq = ntq * row.valid
            ntz = ntz * row.valid

    z32 = jnp.zeros((), jnp.int32)
    vc = (jnp.asarray(local.get("nan_mu_v_dash", z32), jnp.int32),
          jnp.asarray(local.get("inf_mu_v_dash", z32), jnp.int32),
          jnp.asarray(local.get("nan_sigma_v_dash", z32), jnp.int32),
          jnp.asarray(local.get("inf_sigma_v_dash", z32), jnp.int32))
    if next_ptab is not None:
        return e, t, mu_d, sig_d, nmu_d, nsig_d, tv_add, vc, (nq, ntq, ntz)
    return e, t, mu_d, sig_d, nmu_d, nsig_d, tv_add, vc


# ---------------------------------------------------------------------------
# Learner driver: one compiled program per epoch
# ---------------------------------------------------------------------------

def _state_specs():
    rep = P()
    return OVBState(**{f.name: rep for f in OVBState.__dataclass_fields__.values()})


def _row_specs(stacked=False):
    shd = P(None, DATA_AXIS) if stacked else P(DATA_AXIS)
    return RowData(ids=shd, vals=shd, target=shd, valid=shd)


class OVBLearner:
    """Online VBFM trainer (method 'vb_online') over a device mesh."""

    method = "vb_online"
    #: optional base.MapEval — enables per-iteration MAP@k for task 'c'
    #: (fm_learn_vb_online_simultaneous.h:258-262)
    map_eval = None

    def __init__(self, cfg: FMConfig, train: SparseDataset, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None, mesh=None,
                 bins: str = "auto", out_dir: str = ".", write_files: bool = True):
        # Online natural-gradient updates are NOT stable under
        # factor-Jacobi blocking: with rho ~ 1 on early chunks every factor
        # takes the same aggressively scaled (alpha * col_count) step on the
        # same residual, and K simultaneous steps overshoot into a
        # sigma_v/alpha death spiral at scale.  The reference's
        # factor-sequential Gauss-Seidel self-limits, so it is the default
        # here (explicit factor_block > 1 overrides at your own risk).
        if cfg.factor_block == 0:
            import dataclasses
            cfg = dataclasses.replace(cfg, factor_block=1)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        D = cfg.num_attributes
        self.train_n = train.num_rows
        self.col_count = train.col_count()

        # chunk membership: fixed by default (a seeded permutation; only the
        # chunk ORDER is reshuffled per epoch).  cfg.reshuffle=True
        # re-partitions membership every epoch like the reference's
        # per-epoch disk re-split (fm_learn_vb_online_simultaneous.h:74-101)
        # — see _reshuffle_membership.
        nb = max(1, min(cfg.num_batches, train.num_rows))
        self.num_chunks = nb
        self._train_ds = train
        self._bins = bins
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(train.num_rows)
        n_chunk = max(len(c) for c in np.array_split(perm, nb))
        self._n_chunk = -(-n_chunk // n_dev) * n_dev  # pad to shard multiple

        plans, chunks = self._build_chunk_plans(perm)
        self.chunk_sizes = np.array([c.num_rows for c in chunks], np.int64)

        # align chunk plans to a common (bin -> L-bucket -> Cmax) structure
        self._bin_specs = _plan_shape_spec(plans)
        self.blocks_np = _align_chunk_plans(plans, D, n_dev, self._bin_specs)
        self.plans = plans
        self._put_chunks(chunks, self.blocks_np)
        self._member_rng = np.random.default_rng(cfg.seed + 2)

        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.attr_group = put_replicated(self.mesh, meta.attr_group)
        self.num_attr_per_group = put_replicated(
            self.mesh, meta.num_attr_per_group.astype(np.float32))
        self.out_dir = out_dir
        self.write_files = write_files
        self.rng = np.random.default_rng(cfg.seed + 1)
        self._epoch_fn = None
        self.streaming = False

    def _build_chunk_plans(self, perm):
        """Per-chunk padded datasets + sweep plans for one membership
        permutation.  Chunk sizes depend only on (num_rows, num_chunks),
        so every permutation yields the same padded shapes."""
        train, cfg = self._train_ds, self.cfg
        D = cfg.num_attributes
        n_dev = self.mesh.devices.size
        n_chunk = self._n_chunk
        plans, chunks = [], []
        for rows_idx in np.array_split(perm, self.num_chunks):
            sub = SparseDataset(
                ids=train.ids[rows_idx], vals=train.vals[rows_idx],
                target=train.target[rows_idx], num_rows=len(rows_idx),
                num_features=D, min_target=train.min_target,
                max_target=train.max_target, row_nnz=train.row_nnz[rows_idx])
            sub = sub.padded_to(1)
            # pad all chunks to the common row count
            pad = n_chunk - sub.ids.shape[0]
            if pad > 0:
                sub = SparseDataset(
                    ids=np.concatenate([sub.ids, np.zeros((pad,) + sub.ids.shape[1:], sub.ids.dtype)]),
                    vals=np.concatenate([sub.vals, np.zeros((pad,) + sub.vals.shape[1:], np.float32)]),
                    target=np.concatenate([sub.target, np.zeros(pad, np.float32)]),
                    num_rows=sub.num_rows, num_features=D,
                    min_target=sub.min_target, max_target=sub.max_target,
                    row_nnz=np.concatenate([sub.row_nnz, np.zeros(pad, np.int32)]))
            chunks.append(sub)
            plans.append(SweepPlan.build(
                sub.to_coo(), D, meta_groups=self.meta.attr_group,
                bins=self._bins, n_shards=n_dev, col_count=self.col_count,
                n_rows_total=n_chunk))
        return plans, chunks

    def _put_chunks(self, chunks, blocks_np):
        """Device-put the stacked [nb, ...] chunk rows + aligned plans."""
        n_chunk = self._n_chunk
        valid = np.stack([
            (np.arange(n_chunk) < c.num_rows).astype(np.float32)
            for c in chunks])
        shd = NamedSharding(self.mesh, P(None, DATA_AXIS))
        rep = NamedSharding(self.mesh, P())
        self.chunk_row = RowData(
            ids=jax.device_put(np.stack([c.ids for c in chunks]), shd),
            vals=jax.device_put(np.stack([c.vals for c in chunks]), shd),
            target=jax.device_put(np.stack([c.target for c in chunks]), shd),
            valid=jax.device_put(valid, shd),
        )
        self.chunk_blocks = tuple(
            tuple(BlockData(
                rows=jax.device_put(b["rows"], shd),
                x=jax.device_put(b["x"], shd),
                cols=jax.device_put(b["cols"], rep),
                group=jax.device_put(b["group"], rep),
                sx2=jax.device_put(b["sx2"], rep),
                cnt=jax.device_put(b["cnt"], rep),
                col_count=jax.device_put(b["col_count"], rep),
            ) for b in bin_list)
            for bin_list in blocks_np)

    def _reshuffle_membership(self):
        """Re-partition chunk membership with a fresh permutation — the
        reference's per-epoch disk re-split semantics
        (fm_learn_vb_online_simultaneous.h:74-101).  The compiled epoch
        program is reused whenever the new chunk plans fit the existing
        aligned shape spec; otherwise the spec grows monotonically (union)
        and the program recompiles once for the larger shapes."""
        perm = self._member_rng.permutation(self.train_n)
        self._last_member_perm = perm
        plans, chunks = self._build_chunk_plans(perm)
        sizes = np.array([c.num_rows for c in chunks], np.int64)
        assert (sizes == self.chunk_sizes).all()
        spec = _plan_shape_spec(plans)
        if not _spec_fits(spec, self._bin_specs):
            self._bin_specs = _spec_union(spec, self._bin_specs)
            self._epoch_fn = None  # shapes grew: one-time recompile
        blocks_np = _align_chunk_plans(plans, self.cfg.num_attributes,
                                       self.mesh.devices.size,
                                       self._bin_specs)
        self._put_chunks(chunks, blocks_np)

    @classmethod
    def from_reader(cls, cfg: FMConfig, reader, test: SparseDataset,
                    meta: Optional[DataMetaInfo] = None, mesh=None,
                    bins: str = "auto", out_dir: str = ".",
                    write_files: bool = True, cache_dir: Optional[str] = None):
        """Out-of-core construction from a BinaryChunkReader.

        This is the capability the reference's OVBFM exists for
        (``fm_learn_vb_online_simultaneous.h:76-157`` disk-chunked epochs;
        ``libfm.cpp:149-171`` defers train loading entirely): the training
        set never resides in host RAM or HBM in full.  Chunk membership is
        the reader's contiguous row windows with the *order* reshuffled per
        epoch (the same documented deviation as the in-memory path's fixed
        membership).  One streaming pass at construction builds each
        chunk's sweep plan and caches it on disk; every training step then
        ships exactly ONE chunk (rows + plan, shapes padded to a common
        spec so a single compiled program serves all chunks) to the device.
        """
        import dataclasses
        import os
        import tempfile
        if cfg.factor_block == 0:  # see the stability note in __init__
            cfg = dataclasses.replace(cfg, factor_block=1)
        if cfg.reshuffle:
            # re-partitioning an out-of-core set would mean random disk
            # reads over the whole file every epoch (the reference pays
            # this by rewriting the train file into batch files per epoch)
            print("# -reshuffle is not supported for out-of-core streaming; "
                  "using fixed row-window membership with shuffled order")
            cfg = dataclasses.replace(cfg, reshuffle=False)
        self = cls.__new__(cls)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        D = cfg.num_attributes
        self.reader = reader
        self.train_n = reader.num_rows
        self.col_count = reader.col_count()
        nb = max(1, min(cfg.num_batches, reader.num_rows))
        self.num_chunks = nb
        bounds = np.linspace(0, reader.num_rows, nb + 1).astype(np.int64)
        self.chunk_bounds = bounds
        self.chunk_sizes = (bounds[1:] - bounds[:-1]).astype(np.int64)
        n_chunk = int(self.chunk_sizes.max()) if nb else 1
        self.n_chunk = _ceil_to_multiple(max(n_chunk, 1), n_dev)
        self.rows_per_shard = self.n_chunk // n_dev
        self.row_pad = max(1, int(reader.row_sizes.max()) if reader.num_rows else 1)
        if cache_dir is None:
            cache_dir = tempfile.mkdtemp(prefix="svbfm_ovb_plans_")
        self.plan_cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        # pass 1 (streaming): build + disk-cache per-chunk sweep plans,
        # folding the union (bin, L, Cmax) shape spec as we go — host RAM
        # holds one chunk at a time
        summaries = []
        for ci in range(nb):
            coo = reader.read_rows(bounds[ci], bounds[ci + 1])
            plan = SweepPlan.build(coo, D, meta_groups=meta.attr_group,
                                   bins=bins, n_shards=n_dev,
                                   col_count=self.col_count,
                                   n_rows_total=self.n_chunk)
            plan.save(os.path.join(cache_dir, f"plan_{ci}.npz"))
            summaries.append([{blk.rows.shape[2]: blk.cols.shape[0]
                               for blk in bin_blocks}
                              for bin_blocks in plan.blocks])
        self.bin_specs = _plan_shape_spec(summaries)

        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.attr_group = put_replicated(self.mesh, meta.attr_group)
        self.num_attr_per_group = put_replicated(
            self.mesh, meta.num_attr_per_group.astype(np.float32))
        self.out_dir = out_dir
        self.write_files = write_files
        self.rng = np.random.default_rng(cfg.seed + 1)
        self._epoch_fn = None
        self._chunk_step_fn = None
        self._eval_jit = None
        self.streaming = True
        return self

    # ---- streaming helpers -------------------------------------------------

    def _read_chunk(self, ci: int) -> SparseDataset:
        """One chunk as a SparseDataset padded to the common [n_chunk,
        row_pad] shape (all chunks share one compiled program)."""
        lo, hi = self.chunk_bounds[ci], self.chunk_bounds[ci + 1]
        coo = self.reader.read_rows(lo, hi)
        if self.cfg.task == TASK_CLASSIFICATION:  # libfm.cpp:337-350
            coo.target = np.where(coo.target > 0, 1.0, -1.0).astype(np.float32)
        ds = SparseDataset.from_coo(coo, self.cfg.num_attributes)
        P_, N_ = self.row_pad, self.n_chunk
        pad_c = P_ - ds.ids.shape[1]
        pad_r = N_ - ds.ids.shape[0]
        if pad_c or pad_r:
            ds = SparseDataset(
                ids=np.pad(ds.ids, ((0, pad_r), (0, pad_c))),
                vals=np.pad(ds.vals, ((0, pad_r), (0, pad_c))),
                target=np.pad(ds.target, (0, pad_r)),
                num_rows=ds.num_rows, num_features=ds.num_features,
                min_target=ds.min_target, max_target=ds.max_target,
                row_nnz=np.pad(ds.row_nnz, (0, pad_r)))
        return ds

    def _chunk_device_data(self, ci: int):
        """Ship one chunk (rows + aligned plan) to the device."""
        import os
        row, _n = build_row_data(self.mesh, self._read_chunk(ci))
        plan = SweepPlan.load(
            os.path.join(self.plan_cache_dir, f"plan_{ci}.npz"))
        aligned = _align_plan(plan, self.bin_specs, self.cfg.num_attributes,
                              self.mesh.devices.size, self.rows_per_shard)
        blocks = tuple(
            tuple(BlockData(
                rows=shard_rows(self.mesh, bk["rows"]),
                x=shard_rows(self.mesh, bk["x"]),
                cols=put_replicated(self.mesh, bk["cols"]),
                group=put_replicated(self.mesh, bk["group"]),
                sx2=put_replicated(self.mesh, bk["sx2"]),
                cnt=put_replicated(self.mesh, bk["cnt"]),
                col_count=put_replicated(self.mesh, bk["col_count"]))
                  for bk in bin_list)
            for bin_list in aligned)
        return row, blocks

    def _build_chunk_step(self):
        if self._chunk_step_fn is not None:
            return self._chunk_step_fn
        cfg = self.cfg
        n_full = float(self.train_n)
        attr_group = self.attr_group
        napg = self.num_attr_per_group
        shd, rep = P(DATA_AXIS), P()
        block_specs = tuple(
            tuple(BlockData(rows=shd, x=shd, cols=rep, group=rep, sx2=rep,
                            cnt=rep, col_count=rep) for _ in spec)
            for spec in self.bin_specs)

        def step(state, row, blocks, n_chunk):
            return ovb_chunk_update(state, row, blocks, cfg, n_full, n_chunk,
                                    attr_group, napg)

        self._chunk_step_fn = jax.jit(jax.shard_map(
            step, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs(False), block_specs, rep),
            out_specs=(_state_specs(), rep, ovb_counter_specs())),
            donate_argnums=(0,))  # state aliases in place (~0.5 GiB at KDD D)
        return self._chunk_step_fn

    def _build_eval(self):
        if getattr(self, "_eval_jit", None) is not None:
            return self._eval_jit
        cfg = self.cfg
        nt = float(self.test_n)

        def ev(state, trow):
            scores = fm_scores(state.mu_0, state.mu_w, state.mu_v,
                               trow.ids, trow.vals, k0=cfg.k0, k1=cfg.k1)
            ntf = jnp.asarray(nt, scores.dtype)
            if cfg.task == TASK_REGRESSION:
                p = jnp.clip(scores, cfg.min_target, cfg.max_target)
                err = (p - trow.target) * trow.valid
                m1 = jnp.sqrt(_psum(jnp.sum(err * err)) / ntf)
                m2 = _psum(jnp.sum(jnp.abs(err))) / ntf
            else:
                prob = ref_cdf_gaussian(scores)
                yt = trow.target
                hit = (((prob >= 0.5) & (yt > 0)) | ((prob < 0.5) & (yt < 0)))
                m1 = _psum(jnp.sum(hit * trow.valid)) / ntf
                pll = jnp.clip(prob, 0.01, 0.99)
                mm = (yt + 1.0) * 0.5
                m2 = -_psum(jnp.sum((mm * jnp.log10(pll)
                                     + (1 - mm) * jnp.log10(1 - pll))
                                    * trow.valid)) / ntf
            return m1, m2

        self._eval_jit = jax.jit(jax.shard_map(
            ev, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs(False)),
            out_specs=(P(), P())))
        return self._eval_jit

    def _run_streaming(self, state, num_iter, verbose, ckpt, ckpt_every):
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        it0 = 0
        if ckpt is not None:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                state, it0, _meta = restored
                rep = NamedSharding(self.mesh, P())
                state = jax.device_put(
                    state, jax.tree.map(lambda _: rep, _state_specs()))
                for _ in range(it0):  # replay epoch-order RNG
                    self.rng.permutation(self.num_chunks)
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                                   self.write_files and it0 == 0)
        fe_file = TrajectoryFile("free_energy", cfg, self.method, self.out_dir,
                                 self.write_files and it0 == 0)
        step_fn = self._build_chunk_step()
        eval_fn = self._build_eval()
        history = []
        import time as _time
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        # bounded multi-chunk prefetch: 2 reader threads keep up to
        # `depth` chunks in flight (disk read + plan align + H2D transfer
        # overlap the device sweeps, and a single-slot window leaves the
        # pipe idle whenever one read runs long)
        depth = min(3, self.num_chunks)
        prefetch = ThreadPoolExecutor(2)
        try:
            for it in range(it0, num_iter):
                t0 = _time.perf_counter()
                order = self.rng.permutation(self.num_chunks)
                fes = []
                futs = deque()
                submitted = 0

                def top_up():
                    nonlocal submitted
                    while submitted < len(order) and len(futs) < depth:
                        futs.append(prefetch.submit(
                            self._chunk_device_data, int(order[submitted])))
                        submitted += 1

                top_up()
                nans_acc = []
                for idx, ci in enumerate(order):
                    row, blocks = futs.popleft().result()
                    top_up()
                    state, fe, nans = step_fn(
                        state, row, blocks,
                        jnp.asarray(float(self.chunk_sizes[ci]), jnp.float32))
                    fes.append(fe)
                    nans_acc.append(nans)
                    # dispatch is asynchronous: without a wait the host would
                    # keep uploading chunks faster than the device consumes
                    # them, so wait for the chunk `depth` steps back (the
                    # prefetch depth) and hold at most ~2*depth chunks on device
                    if idx >= depth:
                        jax.block_until_ready(fes[idx - depth])
                # one host transfer for all chunk free-energies + eval metrics
                t_pred = _time.perf_counter()
                m1, m2 = eval_fn(state, self.test_row)
                fes, m1, m2, nans_acc = jax.device_get((fes, m1, m2, nans_acc))
                now = _time.perf_counter()
                fes = [float(f) for f in fes]
                nans = {k: int(sum(d[k] for d in nans_acc))
                        for k in nans_acc[0]} if nans_acc else {}
                # reference: free energy appended for first and last chunk
                fe_file.append(-fes[0])
                fe_file.append(-fes[-1])
                rec = {"iter": it, "free_energy": fes[-1],
                       "time_pred": now - t_pred,
                       "time_learn": now - t0, **nans}
                if cfg.task == TASK_REGRESSION:
                    rec.update(rmse=float(m1), mae=float(m2))
                    rmse_file.append(rec["rmse"])
                    if verbose:
                        print(f"#Iter={it:3d}\tTest={rec['rmse']:.6g}")
                else:
                    self._classification_iter(state, it, m1, m2, rec, rmse_file,
                                              verbose)
                print_nonzero_nans(rec, verbose)
                from svbfm.utils.rlog_schema import stream_row
                stream_row(self, rec, state)
                history.append(rec)
                if ckpt is not None and ((it + 1 - it0) % ckpt_every == 0
                                         or it + 1 >= num_iter):
                    ckpt.save(jax.tree.map(np.asarray, state), it + 1,
                              {"method": self.method})
        finally:
            prefetch.shutdown(wait=False, cancel_futures=True)
        return state, history

    def _block_specs(self, stacked=True):
        # stacked block arrays are [nb, S, C, L]: shard the S axis
        shd = P(None, DATA_AXIS) if stacked else P(DATA_AXIS)
        rep = P(None) if stacked else P()
        return tuple(
            tuple(BlockData(rows=shd, x=shd, cols=rep, group=rep, sx2=rep,
                            cnt=rep, col_count=rep)
                  for _b in bin_list)
            for bin_list in self.chunk_blocks)

    def _build_epoch(self):
        if self._epoch_fn is not None:
            return self._epoch_fn
        cfg = self.cfg
        n_full = float(self.train_n)
        chunk_n = jnp.asarray(self.chunk_sizes.astype(np.float32))
        attr_group = self.attr_group
        napg = self.num_attr_per_group

        def epoch(state, order, crow, cblocks, trow):
            def body(st, ci):
                row_i = jax.tree.map(
                    lambda a: jax.lax.dynamic_index_in_dim(a, ci, 0, False), crow)
                blocks_i = jax.tree.map(
                    lambda a: jax.lax.dynamic_index_in_dim(a, ci, 0, False), cblocks)
                st, fe, nans = ovb_chunk_update(
                    st, row_i, blocks_i, cfg, n_full, chunk_n[ci],
                    attr_group, napg)
                return st, (fe, nans)
            state, (fes, nans_per_chunk) = jax.lax.scan(body, state, order)
            # per-epoch totals (the reference prints once per iteration)
            nans = jax.tree.map(lambda a: jnp.sum(a), nans_per_chunk)
            # per-epoch test eval (fm_learn_vb_online_simultaneous.h:190-280)
            scores = fm_scores(state.mu_0, state.mu_w, state.mu_v,
                               trow.ids, trow.vals, k0=cfg.k0, k1=cfg.k1)
            nt = jnp.asarray(float(self.test_n), scores.dtype)
            if cfg.task == TASK_REGRESSION:
                p = jnp.clip(scores, cfg.min_target, cfg.max_target)
                err = (p - trow.target) * trow.valid
                m1 = jnp.sqrt(_psum(jnp.sum(err * err)) / nt)
                m2 = _psum(jnp.sum(jnp.abs(err))) / nt
            else:
                prob = ref_cdf_gaussian(scores)
                yt = trow.target
                hit = (((prob >= 0.5) & (yt > 0)) | ((prob < 0.5) & (yt < 0)))
                m1 = _psum(jnp.sum(hit * trow.valid)) / nt
                pll = jnp.clip(prob, 0.01, 0.99)
                mm = (yt + 1.0) * 0.5
                m2 = -_psum(jnp.sum((mm * jnp.log10(pll)
                                     + (1 - mm) * jnp.log10(1 - pll))
                                    * trow.valid)) / nt
            return state, fes, m1, m2, nans

        self._epoch_fn = jax.jit(jax.shard_map(
            epoch, mesh=self.mesh,
            in_specs=(_state_specs(), P(), _row_specs(True),
                      self._block_specs(True), _row_specs(False)),
            out_specs=(_state_specs(), P(), P(), P(), ovb_counter_specs()),
        ))
        # NOT donated: the pipelined run loop flushes epoch k's metrics
        # (rlog stream_row / MAP / classification eval all read epoch k's
        # STATE) after epoch k+1 is dispatched — donation would delete the
        # buffers they read (caught by test_ovb_map_written_to_trajectory
        # _file).  The streaming chunk step donates safely: its flush only
        # touches the current state.
        return self._epoch_fn

    def init_state(self, key: Optional[jax.Array] = None) -> OVBState:
        if key is None:
            key = jax.random.PRNGKey(self.cfg.seed)
        state = init_ovb_state(key, self.cfg, self.col_count)
        rep = NamedSharding(self.mesh, P())
        return jax.device_put(state, jax.tree.map(lambda _: rep, _state_specs()))

    def predict_test_scores(self, state) -> np.ndarray:
        s = jax.jit(lambda st, ids, vals: fm_scores(
            st.mu_0, st.mu_w, st.mu_v, ids, vals,
            k0=self.cfg.k0, k1=self.cfg.k1))(state, self.test_row.ids,
                                             self.test_row.vals)
        return np.asarray(s)[: self.test_n]

    def _classification_iter(self, state, it, m1, m2, rec, rmse_file,
                             verbose: bool) -> None:
        """Per-epoch classification record: accuracy/loglik, plus MAP@k on
        the current epoch's probabilities when a fixture is attached.  The
        reference writes MAP@k — not accuracy — into the ``test_rmse_*``
        trajectory file for task 'c' (fm_learn_vb_online_simultaneous.h:
        258-262); that quirk is preserved when ``map_eval`` is set."""
        rec.update(accuracy=float(m1), loglik=float(m2))
        if self.map_eval is not None:
            probs = np.asarray(ref_cdf_gaussian(
                jnp.asarray(self.predict_test_scores(state))))
            rec["map"] = self.map_eval(probs)
            rmse_file.append(rec["map"])
            if verbose:
                print(f"#Iter={it:3d}\tTest={rec['accuracy']:.6g}"
                      f"\tMAP@{self.map_eval.k}= {rec['map']:.6g}")
        else:
            rmse_file.append(rec["accuracy"])
            if verbose:
                print(f"#Iter={it:3d}\tTest={rec['accuracy']:.6g}")

    def run(self, state: Optional[OVBState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            ckpt=None, ckpt_every: int = 10):
        if getattr(self, "streaming", False):
            return self._run_streaming(state, num_iter, verbose, ckpt,
                                       ckpt_every)
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        it0 = 0
        if ckpt is not None:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                state, it0, _meta = restored
                rep = NamedSharding(self.mesh, P())
                state = jax.device_put(
                    state, jax.tree.map(lambda _: rep, _state_specs()))
                # replay the epoch-order RNG so resumed runs match
                for _ in range(it0):
                    self.rng.permutation(self.num_chunks)
                # ... and the membership RNG (one draw per epoch >= 1;
                # epoch it0 itself draws inside the loop below)
                if cfg.reshuffle:
                    for _ in range(max(0, it0 - 1)):
                        self._member_rng.permutation(self.train_n)
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                                   self.write_files and it0 == 0)
        fe_file = TrajectoryFile("free_energy", cfg, self.method, self.out_dir,
                                 self.write_files and it0 == 0)
        epoch_fn = self._build_epoch()
        history = []
        import time as _time
        last_flush_t = None

        def _flush(st, fes, m1, m2, nans, it, t0):
            """Fetch one epoch's metrics and emit its record (see
            MCMCLearner.run for the pipelined-timing scheme)."""
            nonlocal last_flush_t
            t_pred = _time.perf_counter()
            fes, m1, m2, nans = jax.device_get((fes, m1, m2, nans))
            now = _time.perf_counter()
            base = t0 if last_flush_t is None else max(t0, last_flush_t)
            last_flush_t = now
            # reference: free energy appended for first and last chunk
            fe_file.append(-float(fes[0]))
            fe_file.append(-float(fes[-1]))
            rec = {"iter": it, "free_energy": float(fes[-1]),
                   "time_pred": now - t_pred,
                   "time_learn": now - base,
                   **{k: int(v) for k, v in nans.items()}}
            if cfg.task == TASK_REGRESSION:
                rec.update(rmse=float(m1), mae=float(m2))
                rmse_file.append(rec["rmse"])
                if verbose:
                    print(f"#Iter={it:3d}\tTest={rec['rmse']:.6g}")
            else:
                self._classification_iter(st, it, m1, m2, rec, rmse_file,
                                          verbose)
            print_nonzero_nans(rec, verbose)
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, rec, st)
            history.append(rec)

        # dispatch epoch k+1 (incl. the host-side reshuffle/plan rebuild,
        # which then overlaps epoch k's device execution) before fetching
        # epoch k's metrics; disabled under checkpointing, which snapshots
        # state between epochs
        pipeline = ckpt is None
        pending = None
        try:
            for it in range(it0, num_iter):
                t0 = _time.perf_counter()
                if cfg.reshuffle and it > 0:
                    self._reshuffle_membership()
                    epoch_fn = self._build_epoch()  # reused unless shapes grew
                order = jnp.asarray(self.rng.permutation(self.num_chunks)
                                    .astype(np.int32))
                state, fes, m1, m2, nans = epoch_fn(
                    state, order, self.chunk_row, self.chunk_blocks,
                    self.test_row)
                if pipeline:
                    if pending is not None:
                        _flush(*pending)
                    pending = (state, fes, m1, m2, nans, it, t0)
                else:
                    _flush(state, fes, m1, m2, nans, it, t0)
                    if ckpt is not None and ((it + 1) % ckpt_every == 0
                                             or it + 1 >= num_iter):
                        ckpt.save(jax.tree.map(np.asarray, state), it + 1,
                                  {"method": self.method})
        finally:
            if pending is not None:
                _flush(*pending)
        return state, history


def _plan_shape_spec(plans):
    """Union shape spec over chunk plans: per bin, sorted (L, Cmax) buckets.
    Accepts SweepPlan objects or their shape summaries (lists over bins of
    {L: C} dicts) so a streaming pass can fold specs without holding plans."""
    num_bins = 0
    summaries = []
    for p in plans:
        if hasattr(p, "blocks"):
            s = [{blk.rows.shape[2]: blk.cols.shape[0] for blk in bin_blocks}
                 for bin_blocks in p.blocks]
        else:
            s = p
        summaries.append(s)
        num_bins = max(num_bins, len(s))
    bin_specs = []
    for b in range(num_bins):
        ls = {}
        for s in summaries:
            if b >= len(s):
                continue
            for L, C in s[b].items():
                ls[L] = max(ls.get(L, 0), C)
        bin_specs.append(sorted(ls.items()))
    return bin_specs


def _align_plan(plan, bin_specs, D, n_dev, rps):
    """Pad ONE chunk's SweepPlan into the common (bin, L-bucket, Cmax)
    structure; returns nested lists of dicts of numpy arrays.  Pad columns
    carry id D (gathers clamp; scatters drop out-of-bounds) and cnt 0
    (inactive -> update is identity)."""
    out = []
    for b, spec in enumerate(bin_specs):
        bucket_list = []
        for (L, Cmax) in spec:
            rows = np.full((n_dev, Cmax, L), rps - 1, np.int32)
            x = np.zeros((n_dev, Cmax, L), np.float32)
            cols = np.full((Cmax,), D, np.int32)
            group = np.zeros((Cmax,), np.int32)
            sx2 = np.zeros((Cmax,), np.float32)
            cnt = np.zeros((Cmax,), np.float32)
            col_count = np.zeros((Cmax,), np.float32)
            if b < len(plan.blocks):
                for blk in plan.blocks[b]:
                    if blk.rows.shape[2] != L:
                        continue
                    C = blk.cols.shape[0]
                    rows[:, :C] = blk.rows
                    x[:, :C] = blk.x
                    cols[:C] = blk.cols
                    group[:C] = blk.group
                    sx2[:C] = blk.sx2
                    cnt[:C] = blk.cnt
                    col_count[:C] = blk.col_count
            bucket_list.append(dict(rows=rows, x=x, cols=cols, group=group,
                                    sx2=sx2, cnt=cnt, col_count=col_count))
        out.append(bucket_list)
    return out


def _spec_fits(new_spec, spec):
    """True if plans with shape summary ``new_spec`` can be aligned under
    ``spec`` without loss: every (L, C) bucket must find a same-L spec
    bucket with capacity >= C (``_align_plan`` matches buckets by exact L
    and silently drops the rest, so a miss would corrupt the sweep)."""
    if len(new_spec) > len(spec):
        return False
    for b, buckets in enumerate(new_spec):
        cap = dict(spec[b])
        for L, C in buckets:
            if cap.get(L, -1) < C:
                return False
    return True


def _spec_union(a, b):
    """Elementwise-max merge of two (bin -> sorted (L, Cmax)) shape specs."""
    out = []
    for bi in range(max(len(a), len(b))):
        m = {}
        for s in (a, b):
            if bi < len(s):
                for L, C in s[bi]:
                    m[L] = max(m.get(L, 0), C)
        out.append(sorted(m.items()))
    return out


def _align_chunk_plans(plans, D, n_dev, bin_specs=None):
    """Pad per-chunk SweepPlans to a common (bin, L-bucket, Cmax) structure
    so all chunks share one compiled program; returns nested lists of dicts
    of stacked numpy arrays [nb, ...]."""
    if bin_specs is None:
        bin_specs = _plan_shape_spec(plans)
    rps = plans[0].rows_per_shard
    per_chunk = [_align_plan(p, bin_specs, D, n_dev, rps) for p in plans]
    out = []
    for b in range(len(bin_specs)):
        bucket_list = []
        for j in range(len(bin_specs[b])):
            keys = per_chunk[0][b][j].keys()
            bucket_list.append({k: np.stack([pc[b][j][k] for pc in per_chunk])
                                for k in keys})
        out.append(bucket_list)
    return out
