"""Out-of-core batch Gibbs-MCMC / ALS: HBM-windowed sweeps (``-cache_size``).

The reference's ``LargeSparseMatrixHD`` (``src/util/fmatrix.h:110-233``,
wired in ``Data.h:112-171``) feeds ALL batch learners — MCMC/ALS included —
from a windowed disk cache.  This is the MCMC counterpart of
:class:`svbfm.learners.vb_windowed.WindowedVBLearner`: the residual
cache e [N] and the per-factor-block q cache (flat ``[F*N]``) stay
device-resident while row data and column-bucket plans stream host->device
one window per pass.  Host RAM (or disk via
:class:`svbfm.data.stream.BinaryChunkReader`) is the backing store.

Sweep semantics and the RNG key chain mirror
:func:`svbfm.learners.mcmc.mcmc_draw_all` exactly (same draw order:
alpha, w0, w hyperpriors, w z-table, w bins, v hyperpriors, per factor
block: one [F, D] z-table + per-bin bucket draws via
:func:`~svbfm.learners.mcmc.exact_block_draws` + unobserved prior
draws), so trajectories match the resident learner at the same
``factor_block`` up to f32 reassociation of the per-column statistics
(the window axis splits each column's occurrence-list reduction) —
pinned by ``tests/test_mcmc_windowed.py``.  Conditionals per
``fm_learn_mcmc.h:628-899``; hyperpriors ``:901-1089``.
"""

from __future__ import annotations

import time as _time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from svbfm.data.dataset import SparseDataset
from svbfm.data.libfm_text import COOData
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    FMConfig,
    TASK_REGRESSION,
    TrajectoryFile,
    keep_finite,
    ref_cdf_gaussian,
    truncnorm_mean_negative,
    truncnorm_mean_positive,
)
from svbfm.learners.mcmc import (
    ALPHA_0,
    GAMMA_0,
    MCMCState,
    W0_MEAN_0,
    _count_bad,
    _maybe_sample,
    exact_block_draws,
    zero_nan_counters,
)
from svbfm.learners.vb_windowed import (WindowBackpressure,
                                        build_windowed_plan)
from svbfm.models.fm import init_fm_params
from svbfm.ops.forward import fm_scores
from svbfm.ops.segment import take_cols, take_rows


class WindowedMCMCLearner:
    """Batch Gibbs/ALS with HBM-windowed row/plan data (``-cache_size``).

    ``train_src`` is a host :class:`SparseDataset` or a
    :class:`~svbfm.data.stream.BinaryChunkReader`.  Single-device only
    (out-of-core is a one-chip capability; multi-chip problems shard the
    data instead)."""

    method = "mcmc"
    map_eval = None

    def __init__(self, cfg: FMConfig, train_src, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None,
                 num_windows: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True,
                 w_lambda_init: Optional[np.ndarray] = None,
                 v_lambda_init: Optional[np.ndarray] = None,
                 plan=None):
        import dataclasses

        from svbfm.data.stream import BinaryChunkReader
        from svbfm.data.dataset import _ceil_to
        from svbfm.parallel.mesh import make_mesh

        self.mesh = make_mesh(1)
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        D = cfg.num_attributes

        if isinstance(train_src, BinaryChunkReader):
            n_rows = train_src.num_rows
            nnz_bytes = 8 * int(train_src.row_sizes.sum())
            targets = train_src.targets
            assert targets is not None, "windowed MCMC needs the .y targets"

            def src_window(lo, hi):
                return train_src.read_rows(lo, hi)
        else:
            ds: SparseDataset = train_src
            n_rows = ds.num_rows
            nnz_bytes = 8 * int(ds.row_nnz[: n_rows].sum())
            targets = ds.target[: n_rows]

            def src_window(lo, hi):
                coo = ds.to_coo()
                m = (coo.row >= lo) & (coo.row < hi)
                return COOData(row=(coo.row[m] - lo).astype(np.int32),
                               col=coo.col[m], val=coo.val[m],
                               target=coo.target[lo:hi],
                               num_rows=hi - lo, num_features=D)

        if num_windows is None:
            if cache_bytes is None:
                cache_bytes = 2 * 1024**3
            num_windows = max(1, -(-2 * nnz_bytes // cache_bytes))
        wlen = _ceil_to(-(-n_rows // max(1, int(num_windows))), 1024)
        self.wlen = wlen
        self.num_windows = max(1, -(-n_rows // wlen))
        bounds = [min(w * wlen, n_rows) for w in range(self.num_windows + 1)]
        bounds[-1] = n_rows

        # factor blocking: windowed requires >= 1 and K % F == 0; auto
        # picks the largest divisor <= 4 (same policy as windowed VB)
        K = cfg.num_factor
        if K > 0 and (cfg.factor_block < 1 or K % cfg.factor_block != 0):
            fb = 1
            for d in (4, 3, 2):
                if K % d == 0:
                    fb = d
                    break
            cfg = dataclasses.replace(cfg, factor_block=fb)
        self.cfg = cfg
        self.F = min(cfg.factor_block, K) if K > 0 else 0

        if plan is not None:
            assert plan.num_windows == self.num_windows \
                and plan.wlen == wlen and plan.n_rows == n_rows
            self.plan = plan
        else:
            self.plan = build_windowed_plan(
                lambda w: src_window(bounds[w], bounds[w + 1]),
                self.num_windows, wlen, D, None, meta.attr_group, n_rows)
        self.train_n = n_rows
        self.n_pad = self.num_windows * wlen
        self.train_target_np = np.ascontiguousarray(
            np.asarray(targets, np.float32))

        self.attr_group = jnp.asarray(meta.attr_group, jnp.int32)
        self.napg = jnp.asarray(meta.num_attr_per_group, jnp.float32)
        self.unobserved = jnp.asarray(self.plan.unobserved)

        from svbfm.learners.base import build_row_data
        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.test_target_np = np.asarray(test.target[: test.num_rows])

        self.out_dir = out_dir
        self.write_files = write_files
        # -regular: per-group lambda init (libfm.cpp:367-407)
        self.w_lambda_init = (
            w_lambda_init if w_lambda_init is not None
            else np.full(cfg.num_groups, cfg.regw, np.float32))
        self.v_lambda_init = (
            v_lambda_init if v_lambda_init is not None
            else np.full((cfg.num_groups, cfg.num_factor), cfg.regv,
                         np.float32))
        self._build_programs()

    # ---- compiled programs ------------------------------------------------

    def _build_programs(self):
        cfg = self.cfg
        F, N, Wlen = self.F, self.n_pad, self.wlen
        K = cfg.num_factor
        G = cfg.num_groups
        P = self.plan.ids[0].shape[1] if self.plan.ids else 1
        num_cases = float(self.train_n)
        attr_group, napg = self.attr_group, self.napg
        unobserved = self.unobserved

        # ---- A: scalar draws + hyperpriors + z-tables (key chain mirrors
        # mcmc.mcmc_draw_all / the staged a_stage exactly) ----
        def a_small(state, valid):
            from svbfm.learners.mcmc import (draw_v_hyperpriors,
                                             draw_w_hyperpriors)
            dtype = state.w.dtype
            Nf = jnp.asarray(num_cases, dtype)
            e, key = state.e, state.key
            counters = zero_nan_counters()

            def next_key():
                nonlocal key
                key, sub = jax.random.split(key)
                return sub

            # draw_alpha (fm_learn_mcmc.h:901-929); sums masked by valid
            alpha = state.alpha
            if not cfg.do_multilevel:
                alpha = jnp.asarray(ALPHA_0, dtype)
            else:
                sse = jnp.sum(e * e * valid)
                draw = jax.random.gamma(
                    next_key(), (ALPHA_0 + Nf) / 2.0,
                    dtype=dtype) / ((GAMMA_0 + sse) / 2.0)
                _count_bad(counters, "alpha", draw)
                alpha = keep_finite(draw, state.alpha)

            w0 = state.w0
            if cfg.k0:
                acc = jnp.sum((e - w0) * valid)
                s2 = 1.0 / (cfg.reg0 + alpha * Nf)
                mean = -s2 * (alpha * acc - W0_MEAN_0 * cfg.reg0)
                new_w0 = _maybe_sample(cfg.do_sample, next_key(), mean, s2,
                                       w0, zero_on_bad_sigma=False,
                                       counters=counters, count_as="w0")
                e = e - (w0 - new_w0)
                w0 = new_w0

            w_mu, w_lambda = state.w_mu, state.w_lambda
            zw_d = jnp.zeros((state.w.shape[0],), dtype)
            if cfg.k1:
                w_mu, w_lambda = draw_w_hyperpriors(
                    state.w, w_mu, w_lambda, attr_group, napg, cfg, G,
                    next_key, dtype, counters=counters)
                if cfg.do_sample:
                    # the w sweep's one z-table (w_sweep_main)
                    zw_d = jax.random.normal(next_key(),
                                             (state.w.shape[0],), dtype)
            v_mu, v_lambda = state.v_mu, state.v_lambda
            if K > 0:
                v_mu, v_lambda = draw_v_hyperpriors(
                    state.v, v_mu, v_lambda, attr_group, napg, cfg, G, K,
                    next_key, dtype, counters=counters)
            new_state = state.replace(w0=w0, alpha=alpha, w_mu=w_mu,
                                      w_lambda=w_lambda, v_mu=v_mu,
                                      v_lambda=v_lambda, e=e, key=key)
            nans = {k: jnp.asarray(val, jnp.int32)
                    for k, val in counters.items()}
            return new_state, zw_d, nans

        self._p_a = jax.jit(a_small, donate_argnums=(0,))

        # ---- w sweep (fm_learn_mcmc.h:671-718) ----
        def make_wstats(bin_idx):
            buckets = self.plan.bins[bin_idx]

            def wstats(e, lo, *bucket_arrays):
                e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
                outs = []
                for j, bu in enumerate(buckets):
                    rows_b = bucket_arrays[2 * j]
                    x_b = bucket_arrays[2 * j + 1]
                    e_g = jnp.take(e_w, rows_b.reshape(-1)).reshape(
                        rows_b.shape)
                    outs.append((x_b * e_g).sum(-1))
                return tuple(outs)

            return jax.jit(wstats)

        self._p_wstats = [make_wstats(b) for b in range(len(self.plan.bins))]

        def make_wdraw(bin_idx):
            buckets = self.plan.bins[bin_idx]

            def wdraw(w, w_mu, w_lambda, alpha, zw_d, nan_w, inf_w, *sxes):
                dw = jnp.zeros_like(w)
                counters = {"nan_w": nan_w, "inf_w": inf_w}
                for j, bu in enumerate(buckets):
                    sxe = sxes[j]  # [C]
                    cols = jnp.asarray(bu.cols)
                    w_c = jnp.take(w, cols)
                    mu_g = jnp.take(w_mu, jnp.asarray(bu.group))
                    lam_g = jnp.take(w_lambda, jnp.asarray(bu.group))
                    sx2 = jnp.asarray(bu.sx2)
                    w_mean = sxe - w_c * sx2
                    s2 = 1.0 / (lam_g + alpha * sx2)
                    mean = -s2 * (alpha * w_mean - mu_g * lam_g)
                    if cfg.do_sample:
                        val = mean + jnp.sqrt(s2) * jnp.take(zw_d, cols)
                    else:
                        val = mean
                    val = jnp.where(jnp.isfinite(s2), val,
                                    jnp.zeros_like(val))
                    _count_bad(counters, "w", val)
                    new_w = keep_finite(val, w_c)
                    w = w.at[cols].set(new_w)
                    dw = dw.at[cols].set(w_c - new_w)
                return w, dw, counters["nan_w"], counters["inf_w"]

            return jax.jit(wdraw)

        self._p_wdraw = [make_wdraw(b) for b in range(len(self.plan.bins))]

        def wpatch(dw, e, ids_w, vals_w, lo):
            e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
            for p in range(P):
                e_w = e_w - vals_w[:, p] * jnp.take(dw, ids_w[:, p])
            return jax.lax.dynamic_update_slice(e, e_w, (lo,))

        self._p_wpatch = jax.jit(wpatch, donate_argnums=(1,))

        def w_unobserved(w, w_mu, w_lambda, zw_d, nan_w, inf_w):
            # fm_learn_mcmc.h:671-718 tail: unobserved -> prior draw
            counters = {"nan_w": nan_w, "inf_w": inf_w}
            mu_d = jnp.take(w_mu, attr_group)
            lam_d = jnp.take(w_lambda, attr_group)
            s2_d = 1.0 / lam_d
            if cfg.do_sample:
                un = mu_d + jnp.sqrt(s2_d) * zw_d
                un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
            else:
                un = jnp.where(jnp.isfinite(s2_d), mu_d,
                               jnp.zeros_like(mu_d))
            _count_bad(counters, "w", jnp.where(unobserved, un, 0.0))
            new_un = keep_finite(un, w)
            return (jnp.where(unobserved, new_un, w),
                    counters["nan_w"], counters["inf_w"])

        self._p_wunobs = jax.jit(w_unobserved)

        # ---- v factor blocks ----
        if F:
            def build_q(v_tt, fq, ids_w, vals_w, lo):
                # v_tt [F, D]; fq flat [F*N]; one window's q build
                q = jnp.zeros((F, Wlen), jnp.float32)
                for p in range(P):
                    q = q + jnp.take(v_tt, ids_w[:, p], axis=-1) \
                        * vals_w[:, p][None]
                for f in range(F):
                    fq = jax.lax.dynamic_update_slice(fq, q[f],
                                                      (f * N + lo,))
                return fq

            self._p_build = jax.jit(build_q, donate_argnums=(1,))

            def make_stats(bin_idx):
                buckets = self.plan.bins[bin_idx]

                def stats(e, fq, v_t, lo, *bucket_arrays):
                    e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
                    q_w = jnp.stack([jax.lax.dynamic_slice(
                        fq, (f * N + lo,), (Wlen,)) for f in range(F)])
                    eq = jnp.concatenate([e_w[None], q_w], 0)  # [1+F, Wlen]
                    outs = []
                    for j, bu in enumerate(buckets):
                        rows_b = bucket_arrays[2 * j]
                        x_b = bucket_arrays[2 * j + 1]
                        C, L = rows_b.shape
                        v_c = take_rows(v_t, jnp.asarray(bu.cols))  # [C, F]
                        g = jnp.take(eq, rows_b.reshape(-1), axis=-1)
                        g = g.reshape(1 + F, C, L)
                        e_g, q_g = g[0], g[1:]
                        xb = x_b[None]
                        h = xb * (q_g - xb * v_c.T[:, :, None])  # [F, C, L]
                        s0 = (h * e_g[None]).sum(-1)  # [F, C]
                        sh2 = (h * h).sum(-1)
                        m_x = jnp.einsum(
                            "fcl,gcl->fgc", h, h,
                            precision=jax.lax.Precision.HIGHEST)
                        outs.append((s0, sh2, m_x))
                    return tuple(outs)

                return jax.jit(stats)

            self._p_stats = [make_stats(b)
                             for b in range(len(self.plan.bins))]

            def make_draw(bin_idx):
                buckets = self.plan.bins[bin_idx]

                def draw(v_t, mu_t, lam_t, alpha, z_d, nan_v, inf_v,
                         *stats):
                    # v_t/mu_t/lam_t [D, F]; z_d [F, D]
                    D_ = v_t.shape[0]
                    v_old_t = v_t
                    dv_d = jnp.zeros((D_, F), jnp.float32)
                    for j, bu in enumerate(buckets):
                        s0 = stats[3 * j]
                        sh2 = stats[3 * j + 1]
                        m_x = stats[3 * j + 2]
                        cols = jnp.asarray(bu.cols)
                        v_c = take_rows(v_old_t, cols)
                        mu_g = take_rows(mu_t, cols)
                        lam_g = take_rows(lam_t, cols)
                        zmat = take_cols(z_d, cols) if cfg.do_sample \
                            else None
                        new_v_cf, nan_c, inf_c = exact_block_draws(
                            s0, sh2, m_x, v_c, mu_g, lam_g, alpha, zmat)
                        nan_v = nan_v + nan_c
                        inf_v = inf_v + inf_c
                        v_t = v_t.at[cols].set(new_v_cf)
                        dv_d = dv_d.at[cols].set(v_c - new_v_cf)
                    dtab = jnp.concatenate([v_old_t.T, dv_d.T], axis=0)
                    return v_t, dtab, nan_v, inf_v  # dtab [2F, D]

                return jax.jit(draw)

            self._p_draw = [make_draw(b) for b in range(len(self.plan.bins))]

            def patch(dtab, e, fq, ids_w, vals_w, lo):
                # same algebra as mcmc._v_block_pass's patch_tile
                e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
                q_t = jnp.stack([jax.lax.dynamic_slice(
                    fq, (f * N + lo,), (Wlen,)) for f in range(F)])
                dq = jnp.zeros_like(q_t)
                de = jnp.zeros_like(e_w)
                for p in range(P):
                    gg = jnp.take(dtab, ids_w[:, p], axis=-1)  # [2F, Wlen]
                    xp = vals_w[:, p][None]
                    v_e, dv_e = gg[:F], gg[F:]
                    h_e = xp * (q_t - xp * v_e)
                    dq = dq + xp * dv_e
                    de = de + (h_e * dv_e).sum(0)
                q_t = q_t - dq
                e_w = e_w - de
                e = jax.lax.dynamic_update_slice(e, e_w, (lo,))
                for f in range(F):
                    fq = jax.lax.dynamic_update_slice(fq, q_t[f],
                                                      (f * N + lo,))
                return e, fq

            self._p_patch = jax.jit(patch, donate_argnums=(1, 2))

            def v_unobserved(v_t, mu_t, lam_t, sub, nan_v, inf_v):
                counters = {"nan_v": nan_v, "inf_v": inf_v}
                new_un = _maybe_sample(cfg.do_sample, sub, mu_t,
                                       1.0 / lam_t, v_t, counters=counters,
                                       count_as="v",
                                       count_mask=unobserved[:, None])
                return (jnp.where(unobserved[:, None], new_un, v_t),
                        counters["nan_v"], counters["inf_v"])

            self._p_vunobs = jax.jit(v_unobserved)

        # ---- C: windowed re-predict + resident eval ----
        def repredict(w0, w, v, e, ids_w, vals_w, y_w, lo):
            s = fm_scores(w0, w, v, ids_w, vals_w, k0=cfg.k0, k1=cfg.k1)
            if cfg.task == TASK_REGRESSION:
                s = s - y_w
            return jax.lax.dynamic_update_slice(e, s, (lo,))

        self._p_repredict = jax.jit(repredict, donate_argnums=(3,))

        def evaluate(state, psum_all, psum_but5, it, trow):
            scores = fm_scores(state.w0, state.w, state.v, trow.ids,
                               trow.vals, k0=cfg.k0, k1=cfg.k1)
            nt = jnp.asarray(float(self.test_n), scores.dtype)
            itf = it.astype(scores.dtype)
            if cfg.task == TASK_REGRESSION:
                p = jnp.clip(scores, cfg.min_target, cfg.max_target)
                psum_all = psum_all + p
                psum_but5 = psum_but5 + jnp.where(it >= 5, p, 0.0)

                def _rmse(pred, norm):
                    pr = jnp.clip(pred * norm, cfg.min_target,
                                  cfg.max_target)
                    err = (pr - trow.target) * trow.valid
                    return jnp.sqrt(jnp.sum(err * err) / nt)

                err_this = (p - trow.target) * trow.valid
                rmse_this = jnp.sqrt(jnp.sum(err_this * err_this) / nt)
                rmse_all = _rmse(psum_all, 1.0 / (itf + 1.0))
                rmse_but5 = jnp.where(
                    it >= 5,
                    _rmse(psum_but5, 1.0 / jnp.maximum(itf - 4.0, 1.0)),
                    rmse_all)
                err_all = (jnp.clip(psum_all / (itf + 1.0), cfg.min_target,
                                    cfg.max_target) - trow.target) \
                    * trow.valid
                mae_all = jnp.sum(jnp.abs(err_all)) / nt
                metrics = dict(rmse=rmse_all, rmse_this=rmse_this,
                               rmse_all_but5=rmse_but5, mae=mae_all,
                               alpha=state.alpha, w_mu=state.w_mu,
                               w_lambda=state.w_lambda, v_mu=state.v_mu,
                               v_lambda=state.v_lambda)
            else:
                prob = ref_cdf_gaussian(scores)
                psum_all = psum_all + prob
                psum_but5 = psum_but5 + jnp.where(it >= 5, prob, 0.0)
                pm = psum_all / (itf + 1.0)
                yt = trow.target
                hit = (((pm >= 0.5) & (yt > 0)) | ((pm < 0.5) & (yt < 0)))
                acc = jnp.sum(hit * trow.valid) / nt
                m = (yt + 1.0) * 0.5
                pll = jnp.clip(pm, 0.01, 0.99)
                ll = -jnp.sum((m * jnp.log10(pll)
                               + (1 - m) * jnp.log10(1 - pll))
                              * trow.valid) / nt
                metrics = dict(accuracy=acc, loglik=ll, alpha=state.alpha,
                               w_mu=state.w_mu, w_lambda=state.w_lambda,
                               v_mu=state.v_mu, v_lambda=state.v_lambda)
            return psum_all, psum_but5, metrics

        self._p_eval = jax.jit(evaluate, donate_argnums=(1, 2))

        if cfg.task != TASK_REGRESSION:
            def resample(e, y_w, sub, lo, widx):
                # truncated-normal latent resampling per window
                # (fm_learn_mcmc_simultaneous.h:196-219); e_w == yhat here
                e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
                if cfg.do_sample:
                    subw = jax.random.fold_in(sub, widx)
                    u = jax.random.uniform(subw, e_w.shape, e_w.dtype,
                                           1e-7, 1.0 - 1e-7)
                    pl = ref_cdf_gaussian(-e_w)
                    cdf = jnp.where(y_w >= 0, pl + u * (1 - pl), u * pl)
                    cdf = jnp.clip(cdf, 1e-7, 1 - 1e-7)
                    sampled = e_w + jnp.sqrt(2.0) \
                        * jax.scipy.special.erfinv(2 * cdf - 1)
                else:
                    sampled = jnp.where(y_w >= 0,
                                        truncnorm_mean_positive(e_w),
                                        truncnorm_mean_negative(e_w))
                return jax.lax.dynamic_update_slice(e, e_w - sampled, (lo,))

            self._p_resample = jax.jit(resample, donate_argnums=(0,))

    # ---- state ------------------------------------------------------------

    def init_state(self, key: Optional[jax.Array] = None) -> MCMCState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev,
                                init_w_normal=True)
        N = self.n_pad
        e = np.zeros(N, np.float32)
        sc = jax.jit(lambda w0, w, v, ids, vals: fm_scores(
            w0, w, v, ids, vals, k0=cfg.k0, k1=cfg.k1))
        y = np.zeros(N, np.float32)
        y[: self.train_n] = self.train_target_np[: self.train_n]
        for w in range(self.num_windows):
            lo = w * self.wlen
            yhat = np.asarray(sc(params.w0, params.w, params.v,
                                 jnp.asarray(self.plan.ids[w]),
                                 jnp.asarray(self.plan.vals[w])))
            # e = yhat - y (MCMC sign convention)
            e[lo:lo + self.wlen] = yhat - y[lo:lo + self.wlen]
        valid = (np.arange(N) < self.train_n).astype(np.float32)
        self._valid = jnp.asarray(valid)
        self._train_y = y  # host; per-window slices uploaded in stage C
        G, K = cfg.num_groups, cfg.num_factor
        self._fq = jnp.zeros(self.F * N, jnp.float32) if self.F else None
        return MCMCState(
            w0=params.w0, w=params.w, v=params.v,
            alpha=jnp.ones((), jnp.float32),
            w_mu=jnp.zeros((G,), jnp.float32),
            w_lambda=jnp.asarray(self.w_lambda_init, jnp.float32),
            v_mu=jnp.zeros((G, K), jnp.float32),
            v_lambda=jnp.asarray(self.v_lambda_init, jnp.float32),
            e=jnp.asarray(e), key=key)

    # ---- one iteration ------------------------------------------------------

    def _put_window(self, w):
        return (jax.device_put(self.plan.ids[w]),
                jax.device_put(self.plan.vals[w]))

    def _iteration(self, state: MCMCState, psum_all, psum_but5, it):
        cfg = self.cfg
        F, N, Wlen = self.F, self.n_pad, self.wlen
        K = cfg.num_factor
        lo_of = lambda w: jnp.asarray(w * Wlen, jnp.int32)

        state, zw_d, nans = self._p_a(state, self._valid)
        e = state.e
        nan_w = nans["nan_w"]
        inf_w = nans["inf_w"]
        nan_v = nans["nan_v"]
        inf_v = nans["inf_v"]
        key = state.key

        # --- w sweep ---
        w = state.w
        if cfg.k1:
            for b, buckets in enumerate(self.plan.bins):
                if not buckets:
                    continue
                acc = None
                bp = WindowBackpressure(lag=1)
                for wi in range(self.num_windows):
                    barrs = []
                    for bu in buckets:
                        barrs += [jax.device_put(bu.rows[wi]),
                                  jax.device_put(bu.x[wi])]
                    part = bp(self._p_wstats[b](e, lo_of(wi), *barrs))
                    acc = part if acc is None else tuple(
                        a + q for a, q in zip(acc, part))
                w, dw, nan_w, inf_w = self._p_wdraw[b](
                    w, state.w_mu, state.w_lambda, state.alpha, zw_d,
                    nan_w, inf_w, *acc)
                bp = WindowBackpressure()
                for wi in range(self.num_windows):
                    ids_w, vals_w = self._put_window(wi)
                    e = bp(self._p_wpatch(dw, e, ids_w, vals_w, lo_of(wi)))
            w, nan_w, inf_w = self._p_wunobs(w, state.w_mu, state.w_lambda,
                                             zw_d, nan_w, inf_w)

        # --- v sweeps, factor blocks (key chain mirrors _v_blocked_sweep) ---
        v = state.v
        if K > 0:
            mu_dk = take_rows(state.v_mu, self.attr_group)  # [D, K]
            lam_dk = take_rows(state.v_lambda, self.attr_group)
            nb = K // F
            fq = self._fq
            for b in range(nb):
                fs = slice(b * F, (b + 1) * F)
                v_t = v[fs].T  # [D, F]
                mu_t = mu_dk[:, fs]
                lam_t = lam_dk[:, fs]
                if cfg.do_sample:
                    key, kb = jax.random.split(key)
                    z_d = jax.random.normal(kb, (F, v.shape[1]),
                                            jnp.float32)
                else:
                    z_d = jnp.zeros((F, v.shape[1]), jnp.float32)
                v_tt = v_t.T  # [F, D]
                bp = WindowBackpressure()
                for wi in range(self.num_windows):
                    ids_w, vals_w = self._put_window(wi)
                    fq = bp(self._p_build(v_tt, fq, ids_w, vals_w,
                                          lo_of(wi)))
                for bi, buckets in enumerate(self.plan.bins):
                    if not buckets:
                        continue
                    acc = None
                    bp = WindowBackpressure(lag=1)
                    for wi in range(self.num_windows):
                        barrs = []
                        for bu in buckets:
                            barrs += [jax.device_put(bu.rows[wi]),
                                      jax.device_put(bu.x[wi])]
                        part = bp(self._p_stats[bi](e, fq, v_t, lo_of(wi),
                                                    *barrs))
                        flat = [x for tup in part for x in tup]
                        acc = flat if acc is None else [
                            a + x for a, x in zip(acc, flat)]
                    v_t, dtab, nan_v, inf_v = self._p_draw[bi](
                        v_t, mu_t, lam_t, state.alpha, z_d, nan_v, inf_v,
                        *acc)
                    bp = WindowBackpressure()
                    for wi in range(self.num_windows):
                        ids_w, vals_w = self._put_window(wi)
                        e, fq = bp(self._p_patch(dtab, e, fq, ids_w,
                                                 vals_w, lo_of(wi)))
                key, sub = jax.random.split(key)
                v_t, nan_v, inf_v = self._p_vunobs(v_t, mu_t, lam_t, sub,
                                                   nan_v, inf_v)
                v = v.at[fs].set(v_t.T)
            self._fq = fq

        # --- C: full re-predict + eval (+ classification resampling) ---
        state = state.replace(w=w, v=v, e=e, key=key)
        e = state.e
        bp = WindowBackpressure()
        for wi in range(self.num_windows):
            lo = wi * Wlen
            ids_w, vals_w = self._put_window(wi)
            y_w = jnp.asarray(self._train_y[lo:lo + Wlen])
            e = bp(self._p_repredict(state.w0, state.w, state.v, e,
                                     ids_w, vals_w, y_w, lo_of(wi)))
        state = state.replace(e=e)
        psum_all, psum_but5, metrics = self._p_eval(
            state, psum_all, psum_but5, jnp.asarray(it, jnp.int32),
            self.test_row)
        if cfg.task != TASK_REGRESSION:
            key, sub = jax.random.split(state.key)
            e = state.e
            bp = WindowBackpressure()
            for wi in range(self.num_windows):
                lo = wi * Wlen
                y_w = jnp.asarray(self._train_y[lo:lo + Wlen])
                e = bp(self._p_resample(e, y_w, sub, lo_of(wi),
                                        jnp.asarray(wi, jnp.int32)))
            state = state.replace(e=e, key=key)
        metrics = dict(metrics, nan_w=nan_w, inf_w=inf_w, nan_v=nan_v,
                       inf_v=inf_v, nan_alpha=nans["nan_alpha"],
                       inf_alpha=nans["inf_alpha"], nan_w0=nans["nan_w0"],
                       inf_w0=nans["inf_w0"], nan_w_mu=nans["nan_w_mu"],
                       inf_w_mu=nans["inf_w_mu"],
                       nan_w_lambda=nans["nan_w_lambda"],
                       inf_w_lambda=nans["inf_w_lambda"],
                       nan_v_mu=nans["nan_v_mu"],
                       inf_v_mu=nans["inf_v_mu"],
                       nan_v_lambda=nans["nan_v_lambda"],
                       inf_v_lambda=nans["inf_v_lambda"])
        return state, psum_all, psum_but5, metrics

    # ---- run loop ---------------------------------------------------------

    def run(self, state: Optional[MCMCState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            chunk: Optional[int] = None, ckpt=None, ckpt_every: int = 10):
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        n_pad = self.test_row.target.shape[0]
        psum_all = jnp.zeros((n_pad,), jnp.float32)
        psum_but5 = jnp.zeros((n_pad,), jnp.float32)
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir, self.write_files)
        history = []
        for it in range(num_iter):
            t0 = _time.perf_counter()
            state, psum_all, psum_but5, metrics = self._iteration(
                state, psum_all, psum_but5, it)
            metrics = jax.device_get(metrics)
            wall = _time.perf_counter() - t0
            rec = {"iter": it, "time_learn": wall, "time_pred": 0.0}
            if not self.plan.conflict_free:
                rec["conflict_free"] = False
            rec.update({k: (float(v) if np.ndim(v) == 0 else v)
                        for k, v in metrics.items()})
            if cfg.task == TASK_REGRESSION:
                rmse_file.append(rec["rmse"])
                if verbose:
                    print(f"#Iter={it:3d}\tTest={rec['rmse']:.6g}"
                          f"\tTest(this)={rec['rmse_this']:.6g}")
            else:
                rmse_file.append(rec["accuracy"])
                if verbose:
                    print(f"#Iter={it:3d}\tTest={rec['accuracy']:.6g}")
            from svbfm.learners.base import print_nonzero_nans
            print_nonzero_nans(rec, verbose)
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, rec)
            history.append(rec)
        self._pred_sum_all = np.asarray(psum_all)[: self.test_n]
        self._pred_iters = num_iter
        return state, history

    def predict_test_scores(self, state: MCMCState) -> np.ndarray:
        """Posterior-mean predictions (pred_sum_all/num_iter) when sampling,
        else the current parameters' scores (fm_learn_mcmc.h:355-379)."""
        if self.cfg.do_sample and getattr(self, "_pred_iters", 0):
            pm = self._pred_sum_all / float(self._pred_iters)
            return pm
        s = jax.jit(lambda w0, w, v, ids, vals: fm_scores(
            w0, w, v, ids, vals, k0=self.cfg.k0, k1=self.cfg.k1))(
            state.w0, state.w, state.v, self.test_row.ids,
            self.test_row.vals)
        return np.asarray(s)[: self.test_n]


class WindowedALSLearner(WindowedMCMCLearner):
    """Windowed ALS = windowed MCMC with do_sample=False,
    do_multilevel=False (libfm.cpp:131-135)."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        import dataclasses
        cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=False)
        super().__init__(cfg, *args, **kwargs)
