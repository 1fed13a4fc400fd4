"""Feature-sharded (tensor-parallel) MCMC/ALS training over a (data, feature)
mesh.

The Gibbs/ALS analogue of :mod:`svbfm.parallel.tp_vb`: the parameter
tables w [D] and v [K, D] shard over the ``feature`` mesh axis (the axis the
reference's single-address-space sampler cannot scale,
``fm_learn_mcmc.h:628-1089``), rows and the e residual cache shard over
``data``.  Each (data, feature) device draws ONLY its own feature shard's
columns:

* Conflict-free bins partition by feature shard (``tp_vb._build_tp_plan``).
  Within a bin every data row has at most one in-bin entry *globally*, so the
  e/q cache patches from different shards are additive AND exact — each
  shard accumulates its columns' row-layout contributions locally and ONE
  stacked psum over the FEATURE axis per bin applies the full patch.
* Per-column statistics (sum x·e, the h-statistics, the cross-factor
  correction matrix M) psum over the DATA axis only — a column lives on
  exactly one feature shard.
* Hyperprior group statistics are local segment sums psum'd over FEATURE;
  the gamma/normal hyperprior draws then run replicated from the shared key
  chain, so every device holds identical hyperparameters.
* z-tables for the column draws are generated shard-locally in W-aligned
  chunks keyed by the GLOBAL column index (``_z_table_local``) — draw
  values are independent of the (data, feature) mesh factorization (so
  trajectories are invariant to it) without replicating an O(D) table.

Semantics: identical draw algebra to :mod:`svbfm.learners.mcmc`
(conditionals ``fm_learn_mcmc.h:628-899``, hyperpriors ``:931-1089``,
guards); ALS mode (do_sample=False, do_multilevel=False) matches the
replicated blocked ALSLearner to float tolerance (tests/test_tp_mcmc.py).
The learner subclasses :class:`svbfm.learners.mcmc.MCMCLearner`, reusing
its fused run loop, posterior-mean accumulators, checkpoint/resume, RLog and
trajectory-file machinery unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from svbfm.data.dataset import SparseDataset, SweepPlan
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import FMConfig, RowData, TASK_REGRESSION, keep_finite
from svbfm.learners.mcmc import (
    ALPHA_0,
    BETA_0,
    GAMMA_0,
    MU_0,
    MCMCLearner,
    MCMCState,
    _auto_factor_block,
    _maybe_sample,
    draw_alpha,
    draw_w0,
)
from svbfm.models.fm import init_fm_params
from svbfm.ops.segment import take_cols, take_rows
from svbfm.parallel.mesh import DATA_AXIS, FEATURE_AXIS
from svbfm.parallel.tp_vb import (
    TPPlanData,
    _build_tp_plan,
    _plan_specs,
    tp_scores,
)


def _psum_d(x):
    return jax.lax.psum(x, DATA_AXIS)


def _psum_f(x):
    return jax.lax.psum(x, FEATURE_AXIS)


# ---------------------------------------------------------------------------
# Hyperprior draws with feature-sharded tables
# ---------------------------------------------------------------------------

def tp_draw_w_hyperpriors(w_l, w_mu, w_lambda, ag_l, napg, cfg: FMConfig, G,
                          next_key, dtype):
    """draw_w_lambda / draw_w_mu (fm_learn_mcmc.h:931-1007) with w sharded:
    per-group deviation/sum stats are local segment sums psum'd over FEATURE
    (pad columns carry group id G -> dropped); the draws run replicated from
    the shared key chain."""
    if not cfg.do_multilevel:
        return jnp.full((G,), MU_0, dtype), w_lambda
    mu_d = take_rows(w_mu, ag_l, mode="clip")
    dev = _psum_f(jax.ops.segment_sum((w_l - mu_d) ** 2, ag_l,
                                      num_segments=G))
    lam_gamma = BETA_0 * (w_mu - MU_0) ** 2 + GAMMA_0 + dev
    lam_alpha = ALPHA_0 + napg + 1.0
    if cfg.do_sample:
        draw = jax.random.gamma(next_key(), lam_alpha / 2.0,
                                dtype=dtype) / (lam_gamma / 2.0)
    else:
        draw = lam_alpha / lam_gamma
    w_lambda = keep_finite(draw, w_lambda)
    wsum = _psum_f(jax.ops.segment_sum(w_l, ag_l, num_segments=G))
    mu_mean = (wsum + BETA_0 * MU_0) / (napg + BETA_0)
    mu_s2 = 1.0 / ((napg + BETA_0) * w_lambda)
    w_mu = _maybe_sample(cfg.do_sample, next_key(), mu_mean, mu_s2, w_mu,
                         zero_on_bad_sigma=False)
    return w_mu, w_lambda


def tp_draw_v_hyperpriors(v_l, v_mu, v_lambda, ag_l, napg, cfg: FMConfig, G,
                          K, next_key, dtype):
    """fm_learn_mcmc.h:1011-1089 with v sharded over features."""
    if not cfg.do_multilevel:
        return jnp.full((G, K), MU_0, dtype), v_lambda
    dev = _psum_f(jax.ops.segment_sum(
        ((v_l - take_rows(v_mu, ag_l, mode="clip").T) ** 2).T,
        ag_l, num_segments=G))  # [G, K]
    lam_gamma = BETA_0 * (v_mu - MU_0) ** 2 + GAMMA_0 + dev
    lam_alpha = ALPHA_0 + napg[:, None] + 1.0
    if cfg.do_sample:
        draw = jax.random.gamma(next_key(), lam_alpha / 2.0,
                                dtype=dtype) / (lam_gamma / 2.0)
    else:
        draw = lam_alpha / lam_gamma
    v_lambda = keep_finite(draw, v_lambda)
    vsum = _psum_f(jax.ops.segment_sum(v_l.T, ag_l, num_segments=G))
    mu_mean = (vsum + BETA_0 * MU_0) / (napg[:, None] + BETA_0)
    mu_s2 = 1.0 / ((napg[:, None] + BETA_0) * v_lambda)
    v_mu = _maybe_sample(cfg.do_sample, next_key(), mu_mean, mu_s2, v_mu,
                         zero_on_bad_sigma=False)
    return v_mu, v_lambda


# ---------------------------------------------------------------------------
# Sharded sweeps
# ---------------------------------------------------------------------------

_Z_CHUNK = 8192


def _z_table_local(kb, F: int, D_loc: int, lo, dtype):
    """This shard's [F, D_loc] slice of the conceptual global z-table
    WITHOUT materializing it: global columns are generated in W-aligned
    chunks keyed by fold_in(kb, chunk_index), so z[f, d] depends only on
    (kb, f, d).  Draws therefore stay invariant to the (data, feature)
    mesh factorization while per-device memory is O(F * (D_loc + 2W))
    instead of O(F * D_pad) — the replicated-table version would
    re-materialize the very footprint -feature_shards exists to shard."""
    W = _Z_CHUNK
    nc = -(-D_loc // W) + 1
    c0 = lo // W
    chunks = jax.vmap(
        lambda c: jax.random.normal(jax.random.fold_in(kb, c), (F, W),
                                    dtype))(c0 + jnp.arange(nc))
    z = jnp.moveaxis(chunks, 0, 1).reshape(F, nc * W)
    return jax.lax.dynamic_slice(z, (0, lo - c0 * W), (F, D_loc))

def tp_w_sweep(e, w_l, w_mu, w_lambda, alpha, plan: TPPlanData, row: RowData,
               cfg: FMConfig, next_key, D_loc: int, ag_l, unob_l):
    """Binned w sweep + unobserved prior draws (fm_learn_mcmc.h:671-718)
    with w feature-sharded.  Each shard draws its own columns; the per-bin
    e patch is a local masked row-layout pass psum'd once over FEATURE."""
    dtype = w_l.dtype
    lo = jax.lax.axis_index(FEATURE_AXIS) * D_loc
    ids, x_r = row.ids, row.vals
    zw_l = None
    if cfg.do_sample:
        # one z value per column per sweep (its bucket, or the unobserved
        # prior), generated shard-locally but keyed by GLOBAL column index
        zw_l = _z_table_local(next_key(), 1, D_loc, lo, dtype)[0]
    for bin_blocks in plan.blocks:
        dw_l = jnp.zeros((D_loc,), dtype)
        for blk in bin_blocks:
            rows_l, x = blk.rows[0, 0], blk.x[0, 0]  # [C, L] local
            colsl = blk.cols[0]  # [C] local ids (pad: D_loc -> dropped)
            w_c = take_rows(w_l, colsl)
            mu_g = take_rows(w_mu, blk.group[0], mode="clip")
            lam_g = take_rows(w_lambda, blk.group[0], mode="clip")
            e_g = take_rows(e, rows_l)
            sxe = _psum_d((x * e_g).sum(-1))
            sx2 = blk.sx2[0]
            w_mean = sxe - w_c * sx2
            s2 = 1.0 / (lam_g + alpha * sx2)
            mean = -s2 * (alpha * w_mean - mu_g * lam_g)
            if cfg.do_sample:
                val = mean + jnp.sqrt(s2) * take_rows(zw_l, colsl)
            else:
                val = mean
            val = jnp.where(jnp.isfinite(s2), val, jnp.zeros_like(val))
            new_w = keep_finite(val, w_c)
            w_l = w_l.at[colsl].set(new_w)  # pad index -> dropped
            dw_l = dw_l.at[colsl].set(w_c - new_w)
        # e patch: local per-position contributions, ONE feature psum
        de = jnp.zeros((e.shape[0],), dtype)
        for p in range(ids.shape[1]):
            lid = ids[:, p] - lo
            inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
            de = de + (x_r[:, p] * inr) * jnp.take(
                dw_l, jnp.clip(lid, 0, D_loc - 1))
        e = e - _psum_f(de)
    # unobserved columns: posterior == prior N(mu_g, 1/lambda_g)
    mu_d = take_rows(w_mu, ag_l, mode="clip")
    lam_d = take_rows(w_lambda, ag_l, mode="clip")
    s2_d = 1.0 / lam_d
    if cfg.do_sample:
        un = mu_d + jnp.sqrt(s2_d) * zw_l
        un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
    else:
        un = jnp.where(jnp.isfinite(s2_d), mu_d, jnp.zeros_like(mu_d))
    return e, jnp.where(unob_l, keep_finite(un, w_l), w_l)


def tp_v_block_pass(e, v_t, mu_t, lam_t, key, plan: TPPlanData, row: RowData,
                    cfg: FMConfig, alpha, exact_seq: bool, D_loc: int,
                    unob_l):
    """One factor-block bin sweep with v feature-sharded.  The correction
    algebra is learners.mcmc._v_block_pass's (closed-form cross-factor
    she updates via the per-column M matrix); here the [F, N] q cache is
    replicated across the feature axis (local partials + one psum) and the
    per-bin e/q patches are local masked passes psum'd once over FEATURE.
    ``v_t``/``mu_t``/``lam_t``: [D_loc, F].  Returns (e, v_t, key)."""
    _, F = v_t.shape
    dtype = v_t.dtype
    lo = jax.lax.axis_index(FEATURE_AXIS) * D_loc
    ids, x_r = row.ids, row.vals
    n = ids.shape[0]
    if cfg.do_sample:
        key, kb = jax.random.split(key)
        z_l = _z_table_local(kb, F, D_loc, lo, dtype)
    # q [F, N]: local partials + ONE feature psum (total q everywhere)
    q = jnp.zeros((F, n), dtype)
    v_tt = v_t.T  # [F, D_loc]
    for p in range(ids.shape[1]):
        lid = ids[:, p] - lo
        inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
        q = q + jnp.take(v_tt, jnp.clip(lid, 0, D_loc - 1), axis=-1) \
            * (x_r[:, p] * inr)[None]
    q = _psum_f(q)
    for bin_blocks in plan.blocks:
        v_old_t = v_t
        dv_d = jnp.zeros((D_loc, F), dtype)
        eq_t = jnp.concatenate([e[None], q], axis=0)  # [1+F, N]
        for blk in bin_blocks:
            rows_l, x = blk.rows[0, 0], blk.x[0, 0]  # [C, L] local
            colsl = blk.cols[0]
            C, L = rows_l.shape
            g = jnp.take(eq_t, rows_l.reshape(-1), axis=-1)
            g = g.reshape(1 + F, C, L)
            e_g = g[0]
            q_g = g[1:]
            v_c = take_rows(v_old_t, colsl)  # [C, F]
            mu_g = take_rows(mu_t, colsl)
            lam_g = take_rows(lam_t, colsl)
            h = x[None] * (q_g - x[None] * v_c.T[:, :, None])  # [F, C, L]
            s0 = (h * e_g[None]).sum(-1)  # [F, C]
            sh2_raw = (h * h).sum(-1)
            if exact_seq:
                # cross-factor matrix forces f32 accumulation (the
                # exact-conditionals contract, see learners.mcmc)
                m_x = jnp.einsum("fcl,gcl->fgc", h, h,
                                 precision=jax.lax.Precision.HIGHEST)
                s0, sh2_all, m_x = _psum_d((s0, sh2_raw, m_x))
            else:
                s0, sh2_all = _psum_d((s0, sh2_raw))
                m_x = None
            if cfg.do_sample:
                zmat = take_cols(z_l, colsl)  # [F, C]
            if exact_seq:
                from svbfm.learners.mcmc import exact_block_draws
                new_v_cf, _nan, _inf = exact_block_draws(
                    s0, sh2_all, m_x, v_c, mu_g, lam_g, alpha,
                    zmat if cfg.do_sample else None)
            else:
                she, sh2 = s0.T, sh2_all.T  # [C, F]
                v_mean = she - v_c * sh2
                s2 = 1.0 / (lam_g + alpha * sh2)
                mean = -s2 * (alpha * v_mean - mu_g * lam_g)
                if cfg.do_sample:
                    mean = mean + jnp.sqrt(s2) * zmat.T
                mean = jnp.where(jnp.isfinite(s2), mean, 0.0)
                new_v_cf = keep_finite(mean, v_c)
            v_t = v_t.at[colsl].set(new_v_cf)  # pad -> dropped
            dv_d = dv_d.at[colsl].set(v_c - new_v_cf)
        # exact per-bin e/q patch: local masked row-layout pass, ONE stacked
        # [F+1, N] feature psum.  Computing every position against the
        # pre-patch q is exact: each row has <= 1 in-bin entry globally, so
        # only one position contributes a nonzero dv for any row.
        vtab = jnp.concatenate([v_old_t.T, dv_d.T], axis=0)  # [2F, D_loc]
        dq = jnp.zeros((F, n), dtype)
        de = jnp.zeros((n,), dtype)
        for p in range(ids.shape[1]):
            lid = ids[:, p] - lo
            inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
            gg = jnp.take(vtab, jnp.clip(lid, 0, D_loc - 1), axis=-1) * inr
            xp = x_r[:, p][None]
            h_e = xp * (q - xp * gg[:F])
            dq = dq + xp * gg[F:]
            de = de + (h_e * gg[F:]).sum(0)
        patch = _psum_f(jnp.concatenate([dq, de[None]], axis=0))
        q = q - patch[:F]
        e = e - patch[F]
    # unobserved columns take the prior
    s2_d = 1.0 / lam_t  # [D_loc, F]
    if cfg.do_sample:
        un = mu_t + jnp.sqrt(s2_d) * z_l.T
        un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
    else:
        un = jnp.where(jnp.isfinite(s2_d), mu_t, jnp.zeros_like(mu_t))
    v_t = jnp.where(unob_l[:, None], keep_finite(un, v_t), v_t)
    return e, v_t, key


def tp_mcmc_draw_all(state: MCMCState, row: RowData, plan: TPPlanData,
                     cfg: FMConfig, num_cases: float, D_loc: int):
    """One Gibbs/ALS sweep + full re-predict with feature-sharded tables.
    Runs inside shard_map over the (data, feature) mesh.  Draw order matches
    learners.mcmc.mcmc_draw_all (fm_learn_mcmc.h draw_all)."""
    dtype = state.w.dtype
    G, K = cfg.num_groups, cfg.num_factor
    N = jnp.asarray(num_cases, dtype)
    e = state.e
    key = state.key
    ag_l = plan.attr_group[0]  # [D_loc]
    unob_l = plan.unobserved[0]
    napg = plan.num_attr_per_group

    def next_key():
        nonlocal key
        key, sub = jax.random.split(key)
        return sub

    alpha = draw_alpha(e, row.valid, state.alpha, cfg, N, next_key, dtype)

    w0 = state.w0
    if cfg.k0:
        e, w0 = draw_w0(e, row.valid, w0, cfg, alpha, N, next_key)

    w_l, v_l = state.w, state.v  # local [D_loc], [K, D_loc]
    w_mu, w_lambda = state.w_mu, state.w_lambda
    v_mu, v_lambda = state.v_mu, state.v_lambda

    if cfg.k1:
        w_mu, w_lambda = tp_draw_w_hyperpriors(
            w_l, w_mu, w_lambda, ag_l, napg, cfg, G, next_key, dtype)
        e, w_l = tp_w_sweep(e, w_l, w_mu, w_lambda, alpha, plan, row, cfg,
                            next_key, D_loc, ag_l, unob_l)

    if K > 0:
        v_mu, v_lambda = tp_draw_v_hyperpriors(
            v_l, v_mu, v_lambda, ag_l, napg, cfg, G, K, next_key, dtype)
        F_eff = 1 if cfg.factor_block == 1 else \
            (min(cfg.factor_block, K) if cfg.factor_block > 0 else K)
        if K % F_eff:
            F_eff = 1
        exact = not (cfg.mcmc_factor_jacobi and not cfg.do_sample)
        mu_dk_l = take_rows(v_mu, ag_l, mode="clip")  # [D_loc, K]
        lam_dk_l = take_rows(v_lambda, ag_l, mode="clip")
        for b0 in range(0, K, F_eff):
            v_t = jax.lax.dynamic_slice_in_dim(v_l, b0, F_eff, axis=0).T
            mu_t = jax.lax.dynamic_slice_in_dim(mu_dk_l, b0, F_eff, axis=1)
            lam_t = jax.lax.dynamic_slice_in_dim(lam_dk_l, b0, F_eff, axis=1)
            e, v_t, key = tp_v_block_pass(
                e, v_t, mu_t, lam_t, key, plan, row, cfg, alpha, exact,
                D_loc, unob_l)
            v_l = jax.lax.dynamic_update_slice_in_dim(v_l, v_t.T, b0, axis=0)

    # full re-predict (fm_learn_mcmc_simultaneous.h:134-176)
    yhat = tp_scores(w0, w_l, v_l, row.ids, row.vals, D_loc, cfg.k0, cfg.k1)
    if cfg.task == TASK_REGRESSION:
        yhat = yhat - row.target

    # nan/inf draw counters are not tracked on the TP path (shard-local
    # sweep values would need a feature-axis psum that double-counts the
    # replicated draws); the base MCMC/BS learners surface them
    from svbfm.learners.mcmc import zero_nan_counters
    return MCMCState(w0=w0, w=w_l, v=v_l, alpha=alpha, w_mu=w_mu,
                     w_lambda=w_lambda, v_mu=v_mu, v_lambda=v_lambda,
                     e=yhat, key=key), zero_nan_counters()


# ---------------------------------------------------------------------------
# Learner
# ---------------------------------------------------------------------------

class TPMCMCLearner(MCMCLearner):
    """Gibbs-MCMC trainer with feature-sharded tables over a (data, feature)
    mesh.  Use when D*K outgrows one device's HBM.  Reuses MCMCLearner's
    fused run loop / posterior-mean accumulators / checkpointing; only the
    draw kernel, scoring and spec trees change."""

    method = "mcmc"
    # the staged huge-N path assumes the replicated-parameter layout; the
    # feature-sharded draw falls back to the fused programs
    _staged_capable = False

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh=None, bins: str = "auto", out_dir: str = ".",
                 write_files: bool = False,
                 w_lambda_init: Optional[np.ndarray] = None,
                 v_lambda_init: Optional[np.ndarray] = None):
        from svbfm.parallel.mesh import make_mesh2d
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh2d(n_feature=1)
        assert self.mesh.axis_names == (DATA_AXIS, FEATURE_AXIS)
        Sd, Sf = self.mesh.devices.shape
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        D = cfg.num_attributes
        coo = train.to_coo()
        self.plan = SweepPlan.build(coo, D, meta_groups=meta.attr_group,
                                    bins=bins, n_shards=Sd)
        self.plan_data, self.D_loc = _build_tp_plan(self.mesh, self.plan,
                                                    meta, D)
        self.D_pad = self.D_loc * Sf
        self.train_row, self.train_n = self._put_row(train, Sd)
        self.test_row, self.test_n = self._put_row(test, Sd)
        if cfg.factor_block == 0 and cfg.num_factor > 1:
            import dataclasses
            n_loc = self.train_row.ids.shape[0] // Sd
            fb = _auto_factor_block(self.plan, cfg.num_factor, n_loc)
            cfg = dataclasses.replace(cfg, factor_block=fb)
            self.cfg = cfg
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.train_target = self.train_row.target
        self.out_dir = out_dir
        self.write_files = write_files
        self.w_lambda_init = (
            w_lambda_init if w_lambda_init is not None
            else np.full(cfg.num_groups, cfg.regw, np.float32))
        self.v_lambda_init = (
            v_lambda_init if v_lambda_init is not None
            else np.full((cfg.num_groups, cfg.num_factor), cfg.regv,
                         np.float32))
        from svbfm.parallel.tp_vb import check_tp_memory_budget
        check_tp_memory_budget(self.plan_data,
                               self.train_row.ids.shape[0] // Sd,
                               cfg.num_factor, type(self).__name__,
                               channels=3 * max(cfg.num_factor, 1) + 2)
        self._build_jits()

    def _put_row(self, ds: SparseDataset, Sd: int):
        # rows pad to the DATA shard count (the plan's row ids assume it)
        ds = ds.padded_to(Sd)
        valid = (np.arange(ds.ids.shape[0]) < ds.num_rows).astype(np.float32)
        dsh = NamedSharding(self.mesh, P(DATA_AXIS))
        return RowData(
            ids=jax.device_put(ds.ids, dsh),
            vals=jax.device_put(ds.vals, dsh),
            target=jax.device_put(ds.target, dsh),
            valid=jax.device_put(valid, dsh)), ds.num_rows

    def _sspec(self):
        rep, fsh, dsh = P(), P(FEATURE_AXIS), P(DATA_AXIS)
        return MCMCState(w0=rep, w=fsh, v=P(None, FEATURE_AXIS), alpha=rep,
                         w_mu=rep, w_lambda=rep, v_mu=rep, v_lambda=rep,
                         e=dsh, key=rep)

    def _rspec(self):
        dsh = P(DATA_AXIS)
        return RowData(ids=dsh, vals=dsh, target=dsh, valid=dsh)

    def _pspec(self):
        return _plan_specs(self.plan_data)

    def _build_jits(self):
        cfg = self.cfg
        num_cases = float(self.train_n)
        D_loc = self.D_loc

        def step_fn(state, row, plan):
            return tp_mcmc_draw_all(state, row, plan, cfg, num_cases, D_loc)

        self._step = jax.jit(jax.shard_map(
            step_fn, mesh=self.mesh,
            in_specs=(self._sspec(), self._rspec(), self._pspec()),
            out_specs=(self._sspec(), self._nanspec()),
        ))

        def scores_fn(w0, w, v, ids, vals):
            return tp_scores(w0, w, v, ids, vals, D_loc, cfg.k0, cfg.k1)

        self._scores = jax.jit(jax.shard_map(
            scores_fn, mesh=self.mesh,
            in_specs=(P(), P(FEATURE_AXIS), P(None, FEATURE_AXIS),
                      P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=P(DATA_AXIS),
        ))
        self._fused_cache = {}

    def _draw_inprog(self, state, row, plan, *extras):
        return tp_mcmc_draw_all(state, row, plan, self.cfg,
                                float(self.train_n), self.D_loc)

    def _test_scores_inprog(self, state, trow, *extras):
        cfg = self.cfg
        return tp_scores(state.w0, state.w, state.v, trow.ids, trow.vals,
                         self.D_loc, cfg.k0, cfg.k1)

    def init_state(self, key: Optional[jax.Array] = None) -> MCMCState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        # identical parameter draws to the replicated learner, then padded
        # to the sharded width (ALS trajectories match to float tolerance)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev, init_w_normal=True)
        pad = self.D_pad - cfg.num_attributes
        w = np.pad(np.asarray(params.w), (0, pad))
        v = np.pad(np.asarray(params.v), ((0, 0), (0, pad)))
        shardings = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                                 self._sspec())
        w_d = jax.device_put(w, shardings.w)
        v_d = jax.device_put(v, shardings.v)
        yhat = self._scores(params.w0, w_d, v_d,
                            self.train_row.ids, self.train_row.vals)
        e = yhat - self.train_row.target
        G, K = cfg.num_groups, cfg.num_factor
        state = MCMCState(
            w0=params.w0, w=w_d, v=v_d,
            alpha=jnp.ones((), jnp.float32),
            w_mu=jnp.zeros((G,), jnp.float32),
            w_lambda=jnp.asarray(self.w_lambda_init, jnp.float32),
            v_mu=jnp.zeros((G, K), jnp.float32),
            v_lambda=jnp.asarray(self.v_lambda_init, jnp.float32),
            e=e, key=key)
        return jax.device_put(state, shardings)


class TPALSLearner(TPMCMCLearner):
    """Feature-sharded ALS (= MCMC with do_sample=False, do_multilevel=False,
    libfm.cpp:131-135)."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        import dataclasses
        cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=False)
        super().__init__(cfg, *args, **kwargs)
