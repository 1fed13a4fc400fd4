"""MCMC (Gibbs) and ALS learners for factorization machines.

A re-design of the reference ``fm_learn_mcmc.h`` +
``fm_learn_mcmc_simultaneous.h`` (libFM's Bayesian FM, Freudenthaler et al.).
ALS is MCMC with ``do_sample=False, do_multilevel=False`` exactly as the
reference CLI rewrites ``-method als`` (``libfm.cpp:131-135``).

Execution strategy mirrors :mod:`svbfm.learners.vb`: conflict-free
binned column sweeps under ``shard_map`` over the data axis, psum'd
sufficient statistics, replicated parameters.  Randomness comes from a
``jax.random`` key chain, restoring the ``-seed`` flag that the reference
registers but ignores (``libfm.cpp:123`` seeds from time(NULL)).

Reference semantics preserved:
  - e-sign convention: e = yhat - y (``fm_learn_mcmc_simultaneous.h:79``).
  - conditional draws (``fm_learn_mcmc.h:628-1089``):
      w ~ N( -s^2 (alpha * sum x(e - w x) - mu_g lambda_g), s^2 ),
        s^2 = 1/(lambda_g + alpha * sum x^2)
      v ~ N( -s^2 (alpha * (sum h e - v sum h^2) - mu lambda), s^2 ),
        h = x (q - x v), s^2 = 1/(lambda + alpha * sum h^2)
      alpha ~ Gamma((alpha_0 + N)/2, (gamma_0 + sum e^2)/2)
      group hyperpriors mu_g, lambda_g per draw_w_mu/draw_w_lambda.
  - hyperprior constants alpha_0 = gamma_0 = beta_0 = 1, mu_0 = 0
    (``fm_learn_mcmc.h:1100-1103``).
  - full re-predict of train+test every iteration for numerical stability
    (``fm_learn_mcmc_simultaneous.h:134``).
  - posterior-mean prediction accumulators pred_sum_all / all_but5.
  - NaN/Inf guards: sigma^2 bad -> param = 0; draw bad -> keep old.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from svbfm.data.dataset import SparseDataset, SweepPlan
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    FMConfig,
    PlanData,
    RowData,
    TASK_REGRESSION,
    TrajectoryFile,
    build_plan_data,
    build_row_data,
    evaluate_classification,
    evaluate_regression,
    keep_finite,
    plan_specs_for,
    ref_cdf_gaussian,
)
from svbfm.learners.vb import _exact_tile_len
from svbfm.models.fm import init_fm_params
from svbfm.ops.forward import fm_scores
from svbfm.parallel.mesh import DATA_AXIS, make_mesh
from svbfm.utils.pytree import pytree_dataclass


@pytree_dataclass
class MCMCState:
    w0: jax.Array  # scalar
    w: jax.Array  # [D]
    v: jax.Array  # [K, D]
    alpha: jax.Array  # scalar
    w_mu: jax.Array  # [G]
    w_lambda: jax.Array  # [G]
    v_mu: jax.Array  # [G, K]
    v_lambda: jax.Array  # [G, K]
    e: jax.Array  # [N] sharded; e = yhat - y
    key: jax.Array  # PRNG key (replicated)


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


from svbfm.ops.segment import take_cols, take_rows


def _gather(a, idx):
    return take_rows(a, idx)


#: counter families (fm_learn_mcmc_simultaneous.h:100-128 nan_cntr_*/
#: inf_cntr_*) — fixed so the nans pytree has a static structure
NAN_FAMILIES = ("alpha", "w0", "w", "w_mu", "w_lambda",
                "v", "v_mu", "v_lambda")


def zero_nan_counters():
    """All-zero counter dict with the full fixed key set."""
    from svbfm.learners.base import zero_counters
    return zero_counters(NAN_FAMILIES)


def nan_counter_specs():
    """PartitionSpecs for the counters (see base.counter_specs)."""
    from svbfm.learners.base import counter_specs
    return counter_specs(NAN_FAMILIES)


def _count_bad(counters, name, *cands):
    """Accumulate nan/inf CANDIDATE counts per parameter family (the
    reference's nan_cntr_*/inf_cntr_* at fm_learn_mcmc_simultaneous.h:100,
    printed only when nonzero).  ``counters`` is a trace-time dict of
    jnp.int32 scalars; None disables counting (the TP draw paths)."""
    if counters is None:
        return
    for cand in cands:
        counters[f"nan_{name}"] = counters.get(f"nan_{name}", 0) \
            + jnp.sum(jnp.isnan(cand), dtype=jnp.int32)
        counters[f"inf_{name}"] = counters.get(f"inf_{name}", 0) \
            + jnp.sum(jnp.isinf(cand), dtype=jnp.int32)


def _maybe_sample(do_sample: bool, key, mean, sigma_sqr, old, zero_on_bad_sigma=True,
                  counters=None, count_as=None, count_mask=None):
    """Reference guard pattern: bad sigma^2 -> 0 (uncounted); bad draw ->
    count + keep old (fm_learn_mcmc.h:686-712: the sigma guard zeroes BEFORE
    the nan/inf counter check, so a bad-sigma draw is never counted).
    ``count_mask`` restricts counting to a subset (e.g. unobserved cols)."""
    val = mean
    if do_sample:
        val = mean + jnp.sqrt(sigma_sqr) * jax.random.normal(key, mean.shape, mean.dtype)
    if zero_on_bad_sigma:
        val = jnp.where(jnp.isfinite(sigma_sqr), val, jnp.zeros_like(val))
    if count_as is not None:
        _count_bad(counters, count_as,
                   val if count_mask is None else jnp.where(count_mask, val, 0.0))
    return keep_finite(val, old)


def exact_block_draws(s0, sh2_all, m_x, v_c, mu_g, lam_g, alpha, zmat):
    """Draw one bucket's F factors with EXACT sequential conditionals.

    The sequential-draw recurrence
        new_v_f = base_f + s2_f*alpha*corr_f,
        corr_f  = sum_{g<f} (v_g - new_v_g) * M[g, f]
    is, in d := v - new_v, one batched unit-lower-triangular solve:
        (I + diag(s2*alpha) . M^T_strict-lower) d = v - base.
    The python F-loop compiles to F dependent [C]-vector steps; the batched
    solve runs the SAME recurrence as one operation.  Non-finite draws (the
    reference's revert guards, fm_learn_mcmc.h:697-710) would contaminate
    later factors through the
    solve, so on any non-finite result the bucket falls back to the
    sequential loop (predicated: compiled in, executed only when needed).

    s0/sh2_all: [F, C]; m_x: [F, F, C]; v_c/mu_g/lam_g: [C, F];
    zmat: [F, C] noise table or None (deterministic ALS).
    Returns (new_v_cf [C, F], nan_count, inf_count)."""
    F, C = s0.shape
    dtype = v_c.dtype
    s2m = 1.0 / (lam_g + alpha * sh2_all.T)  # [C, F]
    base = -s2m * (alpha * (s0.T - v_c * sh2_all.T) - mu_g * lam_g)
    if zmat is not None:
        base = base + jnp.sqrt(s2m) * zmat.T
    tl = jnp.tril(jnp.ones((F, F), dtype), -1)
    tmat = ((alpha * s2m)[:, :, None]
            * jnp.transpose(m_x, (2, 1, 0)) * tl[None])
    dsol = jax.lax.linalg.triangular_solve(
        tmat, (v_c - base)[:, :, None], left_side=True,
        lower=True, unit_diagonal=True)[:, :, 0]
    val_solve = v_c - dsol  # [C, F]
    ok = jnp.all(jnp.isfinite(val_solve)) & jnp.all(jnp.isfinite(s2m))

    def _loop_path():
        corr = jnp.zeros((F, C), dtype)
        nan_c = jnp.zeros((), jnp.int32)
        inf_c = jnp.zeros((), jnp.int32)
        new_cols = []
        for f in range(F):
            she = s0[f] - corr[f]
            sh2 = sh2_all[f]
            v_cf = v_c[:, f]
            v_mean = she - v_cf * sh2
            s2 = 1.0 / (lam_g[:, f] + alpha * sh2)
            mean = -s2 * (alpha * v_mean - mu_g[:, f] * lam_g[:, f])
            val = mean + jnp.sqrt(s2) * zmat[f] if zmat is not None else mean
            val = jnp.where(jnp.isfinite(s2), val, 0.0)
            nan_c = nan_c + jnp.sum(jnp.isnan(val), dtype=jnp.int32)
            inf_c = inf_c + jnp.sum(jnp.isinf(val), dtype=jnp.int32)
            new_v = keep_finite(val, v_cf)
            # closed-form effect of this draw on later factors' h·e
            corr = corr + (v_cf - new_v)[None, :] * m_x[f]
            new_cols.append(new_v)
        return jnp.stack(new_cols, axis=1), nan_c, inf_c

    def _fast_path():
        # counts are 0 by the `ok` predicate; computing them from val_solve
        # keeps the same varying-manual-axes as the loop path under
        # shard_map (the TP sweep's per-shard values vary over 'feature')
        return (val_solve,
                jnp.sum(jnp.isnan(val_solve), dtype=jnp.int32),
                jnp.sum(jnp.isinf(val_solve), dtype=jnp.int32))

    return jax.lax.cond(ok, _fast_path, _loop_path)


def _v_blocked_sweep(e, v, v_mu, v_lambda, alpha, plan, row, cfg, F, key,
                     exact_seq=True, counters=None):
    """Factor-blocked v sweep shared by ALS (do_sample=False) and Gibbs
    sampling (do_sample=True).

    With ``exact_seq=False`` the cross-factor corrections are skipped and all
    F factors update from the pre-bin residual (factor-Jacobi within each
    bin) — not a valid Gibbs kernel, but a fine deterministic ALS fixed-point
    iteration (the round-1 scheme).

    Channel-stacks the e/q gathers over F factors — one index pass per bin
    instead of F — while keeping EXACT sequential conditionals.  Factors are
    processed in order within each conflict-free bin; instead of updating
    the gathered residual e_g between factor draws (a serial chain of
    [C, L] stages), the effect of earlier
    factors' draws on later factors' h·e statistics is applied in closed
    form: within a bin every row appears under at most one column, so

        she_f(e after draws of f' < f) = she_f(e_pre_bin)
                                         - sum_{f'<f} dv_{f'} * M[f', f]
        with M[f', f, c] = sum_l h_{f'} h_f   (per column c).

    All [F, C, L] statistics (h, she_0, sh2, M) are computed batched with one
    psum; the factor recursion touches only [C]/[F, C] arrays, which XLA
    fuses into a negligible tail.  sh2_f needs no correction (h is
    independent of e and of other factors' draws).  Every conditional
    mean/variance therefore sees the latest parameter values; the coordinate
    order is (bin, factor, column) instead of the reference's
    (factor, column) — a different but equally valid Gibbs scan order /
    exact Gauss–Seidel ordering.  Conditionals match fm_learn_mcmc.h:780-835.

    The per-bin row-layout e/q patch recomputes h from the pre-bin q and v
    snapshot, which is exact because q_f depends only on v_f and in-bin rows
    are disjoint per column (draws never touch the row caches mid-bin)."""
    K, D = v.shape
    dtype = v.dtype
    mu_dk = take_rows(v_mu, plan.attr_group)  # [D, K]
    lam_dk = take_rows(v_lambda, plan.attr_group)
    nb = K // F

    def blk_step(e, v_t, mu_t, lam_t, key):
        e, v_t, _q, key = _v_block_pass(e, v_t, mu_t, lam_t, key, plan, row,
                                        cfg, alpha, exact_seq=exact_seq,
                                        counters=counters)
        return e, v_t, key

    for b in range(nb):
        fs = slice(b * F, (b + 1) * F)
        v_t = v[fs].T  # [D, F]
        mu_t = mu_dk[:, fs]
        lam_t = lam_dk[:, fs]
        e, v_t, key = blk_step(e, v_t, mu_t, lam_t, key)
        # unobserved columns: posterior == prior N(mu, 1/lambda)
        key, sub = jax.random.split(key)
        new_un = _maybe_sample(cfg.do_sample, sub, mu_t, 1.0 / lam_t, v_t,
                               counters=counters, count_as="v",
                               count_mask=plan.unobserved[:, None])
        v_new = jnp.where(plan.unobserved[:, None], new_un, v_t)
        v = v.at[fs].set(v_new.T)
    return e, v, key


def _pvary(x):
    """Type a shard-local constant as varying over the data axis (fori
    carries must type-match their body outputs under shard_map)."""
    return jax.lax.pcast(x, (DATA_AXIS,), to="varying")


# One fused draw_all beyond this many work units (shard-local rows x
# factor blocks) is split into per-stage programs (A: scalar draws + w
# sweep / B: one factor block / C: re-predict + eval).  MCMC adds the
# cross-factor M einsum per bucket, so the threshold sits slightly lower
# than vb.VB_STAGE_UNITS.  Set on the earlier accelerator, whose runtime
# ended long single executions; not measured on the H100.
MCMC_STAGE_UNITS = 2.0e8


# Budget for one big temp set in padded f32 elements (~4 GB).  Deliberately
# larger than learners.vb's VB_TILE_BUDGET so that every fused config up
# to ML-10M rows at K=20 stays untiled: tiled sweeps run one sweep per
# program (see _clamp_chunk).  Huge-N problems (Netflix 100M) cross it and
# run tiled + staged.  Sized for the earlier accelerator's memory; not
# measured on the H100.  Module variable so tests can lower it.
MCMC_TILE_BUDGET = 1_000_000_000


def _mc_row_tiles(n_loc: int, CH: int) -> int:
    """Row-tile count for CH-channel-stacked [CH, N] gather temps."""
    return max(1, -(-(n_loc * (-(-CH // 8) * 8)) // MCMC_TILE_BUDGET))


def _mc_col_tiles(C: int, L: int, F: int) -> int:
    """Column-tile count for a bucket's stats pass: the [1+F, Ct, L]
    gather result plus the [F, Ct, L] h temp, last dims padded (8, 128)."""
    per_col = (1 + 2 * F) * (-(-L // 128) * 128)
    return max(1, -(-(C * per_col) // MCMC_TILE_BUDGET))


def _v_block_pass(e, v_t, mu_t, lam_t, key, plan, row, cfg, alpha,
                  exact_seq=True, q_extra=None, counters=None):
    """One factor-block bin sweep over the MAIN design (the body of
    :func:`_v_blocked_sweep`; see its docstring for the correction algebra).

    ``v_t``/``mu_t``/``lam_t`` are [D, F].  ``q_extra`` ([F, N], optional)
    adds non-main contributions to the q cache — the BS learner passes the
    per-relation qB gathers so h sees the TOTAL q (fm_learn_mcmc.h:510-560).
    Returns ``(e, v_t, q, key)`` with q the post-sweep total q cache.

    Memory discipline at huge N (Netflix 100M on one chip): the q build,
    the per-bucket stats gathers, and the per-bin cache patch are tiled
    (row tiles via in-place fori dynamic slices, column tiles with the
    stats reduction fused in) whenever their channel-stacked temps would
    exceed :data:`MCMC_TILE_BUDGET` — same scheme as
    ``vb.vb_v_block_update``, bitwise-identical results (tiles split only
    independent rows/columns; every reduction keeps its axis intact).
    Tiled sweeps run one iteration per program (``MCMCLearner._needs_tiling``
    forces chunk=1; see ``_clamp_chunk``)."""
    D, F = v_t.shape
    dtype = v_t.dtype
    ids, x_r = row.ids, row.vals
    n_loc, P_row = ids.shape
    if cfg.do_sample:
        # ONE [F, D] standard-normal table per block step: every column
        # is drawn exactly once per sweep (one bucket of one bin), so a
        # per-column z is valid — and it removes the per-bucket
        # split/normal chain that serializes the program on the key.
        key, kb = jax.random.split(key)
        z_d = jax.random.normal(kb, (F, D), dtype)
    v_tt = v_t.T  # [F, D]

    # --- q build (one flat gather per row position), row-tiled at huge N ---
    def build_q(ids_t, x_t, q0):
        for p in range(P_row):
            q0 = q0 + jnp.take(v_tt, ids_t[:, p], axis=-1) * x_t[:, p][None]
        return q0

    rtb = _mc_row_tiles(n_loc, F)
    ntb = None if rtb == 1 else _exact_tile_len(n_loc, rtb)
    q0 = (jnp.zeros((F, n_loc), dtype) if q_extra is None else q_extra)
    if ntb is None:
        q = build_q(ids, x_r, q0)
    else:
        if q_extra is None:
            q0 = _pvary(q0)

        def bbody(i, qc):
            lo = i * ntb
            out = build_q(
                jax.lax.dynamic_slice_in_dim(ids, lo, ntb, 0),
                jax.lax.dynamic_slice_in_dim(x_r, lo, ntb, 0),
                jax.lax.dynamic_slice_in_dim(qc, lo, ntb, -1))
            return jax.lax.dynamic_update_slice_in_dim(qc, out, lo, -1)

        q = jax.lax.fori_loop(0, n_loc // ntb, bbody, q0)

    for bin_blocks in plan.blocks:
        v_old_t = v_t
        dv_d = jnp.zeros((D, F), dtype)
        eq_t = jnp.concatenate([e[None], q], axis=0)  # [1+F, N]
        for blk in bin_blocks:
            C, L = blk.rows[0].shape
            v_c = take_rows(v_old_t, blk.cols)  # [C, F]
            mu_g = take_rows(mu_t, blk.cols)
            lam_g = take_rows(lam_t, blk.cols)

            def tile_stats(rows_t, x_t, v_ct):
                # rows_t/x_t [Ct, L]; batched statistics: h, she vs
                # pre-bin e, sh2, and the cross-factor matrix M for the
                # sequential-draw corrections (see docstring)
                g = jnp.take(eq_t, rows_t.reshape(-1), axis=-1)
                g = g.reshape(1 + F, *rows_t.shape)
                e_g = g[0]
                q_g = g[1:]  # [F, Ct, L]
                xb = x_t[None]
                h = xb * (q_g - xb * v_ct.T[:, :, None])  # [F, Ct, L]
                s0 = (h * e_g[None]).sum(-1)  # [F, Ct]
                # sh2 (the conditional-variance denominator) always comes
                # from the full-f32 elementwise sum; the cross-factor matrix M is
                # a matrix product and must force f32 accumulation
                # (Precision DEFAULT may use reduced-precision tensor-core
                # inputs and break the exact-conditionals contract)
                sh2 = (h * h).sum(-1)  # [F, Ct]
                m_x = (jnp.einsum("fcl,gcl->fgc", h, h,
                                  precision=jax.lax.Precision.HIGHEST)
                       if exact_seq else None)
                return s0, sh2, m_x

            ct = _mc_col_tiles(C, L, F)
            if ct == 1:
                s0, sh2_raw, m_x = tile_stats(blk.rows[0], blk.x[0], v_c)
            else:
                # fori over overlap-clamped column tiles writing into
                # preallocated stats buffers; stats are pure functions of
                # pre-bin state, so the overlapped tail recomputing a
                # column and rewriting the same value is harmless
                Ct = min(C, -(-(-(-C // ct)) // 8) * 8)  # ceil8 tile
                nct = -(-C // Ct)
                rows_a, x_a = blk.rows[0], blk.x[0]
                lo_max = C - Ct

                def cbody(i, acc):
                    lo = jnp.minimum(i * Ct, lo_max)
                    outs = tile_stats(
                        jax.lax.dynamic_slice_in_dim(rows_a, lo, Ct, 0),
                        jax.lax.dynamic_slice_in_dim(x_a, lo, Ct, 0),
                        jax.lax.dynamic_slice_in_dim(v_c, lo, Ct, 0))
                    return tuple(
                        jax.lax.dynamic_update_slice_in_dim(a, o, lo, -1)
                        for a, o in zip(acc, outs))

                init = (_pvary(jnp.zeros((F, C), dtype)),
                        _pvary(jnp.zeros((F, C), dtype)))
                if exact_seq:
                    init = init + (_pvary(jnp.zeros((F, F, C), dtype)),)
                    s0, sh2_raw, m_x = jax.lax.fori_loop(0, nct, cbody, init)
                else:
                    def cbody2(i, acc):
                        lo = jnp.minimum(i * Ct, lo_max)
                        s0t, sht, _ = tile_stats(
                            jax.lax.dynamic_slice_in_dim(rows_a, lo, Ct, 0),
                            jax.lax.dynamic_slice_in_dim(x_a, lo, Ct, 0),
                            jax.lax.dynamic_slice_in_dim(v_c, lo, Ct, 0))
                        return (
                            jax.lax.dynamic_update_slice_in_dim(
                                acc[0], s0t, lo, -1),
                            jax.lax.dynamic_update_slice_in_dim(
                                acc[1], sht, lo, -1))

                    s0, sh2_raw = jax.lax.fori_loop(0, nct, cbody2, init)
                    m_x = None
            if exact_seq:
                s0, sh2_all, m_x = _psum((s0, sh2_raw, m_x))
            else:
                s0, sh2_all = _psum((s0, sh2_raw))
            if cfg.do_sample:
                zmat = take_cols(z_d, blk.cols)  # [F, C]
            if exact_seq:
                new_v_cf, nan_c, inf_c = exact_block_draws(
                    s0, sh2_all, m_x, v_c, mu_g, lam_g, alpha,
                    zmat if cfg.do_sample else None)
                if counters is not None:
                    counters["nan_v"] = counters.get("nan_v", 0) + nan_c
                    counters["inf_v"] = counters.get("inf_v", 0) + inf_c
            else:
                # factor-Jacobi: all F conditionals from the pre-bin e
                she, sh2 = s0.T, sh2_all.T  # [C, F]
                v_mean = she - v_c * sh2
                s2 = 1.0 / (lam_g + alpha * sh2)
                mean = -s2 * (alpha * v_mean - mu_g * lam_g)
                if cfg.do_sample:
                    mean = mean + jnp.sqrt(s2) * zmat.T
                mean = jnp.where(jnp.isfinite(s2), mean, 0.0)
                _count_bad(counters, "v", mean)
                new_v_cf = keep_finite(mean, v_c)
            v_t = v_t.at[blk.cols].set(new_v_cf)
            dv_d = dv_d.at[blk.cols].set(v_c - new_v_cf)
        # exact per-bin patch (per-position flat gathers); h comes from
        # the pre-bin q for EVERY position (dq applied once at the end),
        # row-tiled with in-place dynamic slices at huge N
        vtab = jnp.concatenate([v_old_t.T, dv_d.T], axis=0)  # [2F, D]
        ids_pn, x_pn = ids.T, x_r.T  # [P, N]

        def patch_tile(ids_t, x_t, q_t, e_t):
            dq = jnp.zeros_like(q_t)
            de = jnp.zeros_like(e_t)
            for p in range(P_row):
                gg = jnp.take(vtab, ids_t[p], axis=-1)  # [2F, Nt]
                xp = x_t[p][None]
                v_e, dv_e = gg[:F], gg[F:]
                h_e = xp * (q_t - xp * v_e)
                dq = dq + xp * dv_e
                de = de + (h_e * dv_e).sum(0)
            return q_t - dq, e_t - de

        rt = _mc_row_tiles(n_loc, 4 * F)
        nt = None if rt == 1 else _exact_tile_len(n_loc, rt)
        if nt is None:
            q, e = patch_tile(ids_pn, x_pn, q, e)
        else:
            def pbody(i, carry):
                qc, ec = carry
                lo = i * nt
                q_t, e_t = patch_tile(
                    jax.lax.dynamic_slice_in_dim(ids_pn, lo, nt, -1),
                    jax.lax.dynamic_slice_in_dim(x_pn, lo, nt, -1),
                    jax.lax.dynamic_slice_in_dim(qc, lo, nt, -1),
                    jax.lax.dynamic_slice_in_dim(ec, lo, nt, -1))
                return (jax.lax.dynamic_update_slice_in_dim(qc, q_t, lo, -1),
                        jax.lax.dynamic_update_slice_in_dim(ec, e_t, lo, -1))

            q, e = jax.lax.fori_loop(0, n_loc // nt, pbody, (q, e))
    return e, v_t, q, key


# Budget for the blocked sweep's big temps in padded f32 elements (~5 GB,
# sized for the earlier accelerator's memory; not measured on the H100):
# the [1+F, C, L] per-bin gather result and the [2F, N]/[F, N] patch-pass
# temps.  _auto_factor_block picks the largest divisor of K that fits; F=1
# falls back to the factor-sequential scan (always safe).
MCMC_BLOCK_BUDGET = 1280 * 1024 * 1024


def _blocked_peak_elems(plan: SweepPlan, F: int, n_loc: int) -> int:
    """Estimated peak padded-f32 temp elements of one _v_blocked_sweep block
    pass, counting the last two dims padded to (8, 128) tiles."""
    c8 = lambda a: -(-a // 8) * 8
    c128 = lambda a: -(-a // 128) * 128
    gather = 0
    for bin_blocks in plan.blocks:
        # per bucket: gather result g [1+F, C, L] + h [F, C, L] + M [F, F, C]
        tot = max(((1 + 2 * F) * c8(blk.rows.shape[1]) * c128(blk.rows.shape[2])
                   + F * c8(F) * c128(blk.rows.shape[1]))
                  for blk in bin_blocks)
        gather = max(gather, tot)
    # per-position patch: gg [2F, N] + h_e/dv products [F, N] + q/eq_t [F, N]
    patch = (c8(2 * F) + 3 * c8(F)) * c128(n_loc)
    return max(gather, patch)


def _auto_factor_block(plan: SweepPlan, K: int, n_loc: int) -> int:
    """Largest divisor of K whose blocked-sweep temps fit MCMC_BLOCK_BUDGET
    untiled.  When nothing fits (huge N), the row/column-tiled pass bounds
    the temps instead, so memory no longer caps F — pick the largest
    divisor <= 4 (fb=4 was the best VB block at Netflix-100M on the
    earlier accelerator; not measured on the H100)."""
    for d in range(K, 1, -1):
        if K % d == 0 and _blocked_peak_elems(plan, d, n_loc) <= MCMC_BLOCK_BUDGET:
            return d
    for d in (4, 3, 2):
        if K % d == 0:
            return d
    return 1


# Hyperprior constants (fm_learn_mcmc.h:1100-1103)
ALPHA_0 = GAMMA_0 = BETA_0 = 1.0
MU_0 = 0.0
W0_MEAN_0 = 0.0


def draw_alpha(e, valid, alpha_old, cfg: FMConfig, N, next_key, dtype,
               counters=None):
    """fm_learn_mcmc.h:901-929."""
    if not cfg.do_multilevel:
        return jnp.asarray(ALPHA_0, dtype)
    sse = _psum(jnp.sum(e * e * valid))
    draw = jax.random.gamma(next_key(), (ALPHA_0 + N) / 2.0,
                            dtype=dtype) / ((GAMMA_0 + sse) / 2.0)
    _count_bad(counters, "alpha", draw)
    return keep_finite(draw, alpha_old)


def draw_w0(e, valid, w0, cfg: FMConfig, alpha, N, next_key, counters=None):
    """fm_learn_mcmc.h:628-668.  Returns (e, w0)."""
    acc = _psum(jnp.sum((e - w0) * valid))
    s2 = 1.0 / (cfg.reg0 + alpha * N)
    mean = -s2 * (alpha * acc - W0_MEAN_0 * cfg.reg0)
    new_w0 = _maybe_sample(cfg.do_sample, next_key(), mean, s2, w0,
                           zero_on_bad_sigma=False, counters=counters,
                           count_as="w0")
    return e - (w0 - new_w0), new_w0


def draw_w_hyperpriors(w, w_mu, w_lambda, attr_group, napg, cfg: FMConfig,
                       G, next_key, dtype, counters=None):
    """draw_w_lambda then draw_w_mu (fm_learn_mcmc.h:425-426, 931-1007)."""
    if not cfg.do_multilevel:
        return jnp.full((G,), MU_0, dtype), w_lambda
    dev = jax.ops.segment_sum((w - _gather(w_mu, attr_group)) ** 2,
                              attr_group, num_segments=G)
    lam_gamma = BETA_0 * (w_mu - MU_0) ** 2 + GAMMA_0 + dev
    lam_alpha = ALPHA_0 + napg + 1.0
    if cfg.do_sample:
        draw = jax.random.gamma(next_key(), lam_alpha / 2.0,
                                dtype=dtype) / (lam_gamma / 2.0)
    else:
        draw = lam_alpha / lam_gamma
    _count_bad(counters, "w_lambda", draw)
    w_lambda = keep_finite(draw, w_lambda)
    wsum = jax.ops.segment_sum(w, attr_group, num_segments=G)
    mu_mean = (wsum + BETA_0 * MU_0) / (napg + BETA_0)
    mu_s2 = 1.0 / ((napg + BETA_0) * w_lambda)
    w_mu = _maybe_sample(cfg.do_sample, next_key(), mu_mean, mu_s2, w_mu,
                         zero_on_bad_sigma=False, counters=counters,
                         count_as="w_mu")
    return w_mu, w_lambda


def draw_v_hyperpriors(v, v_mu, v_lambda, attr_group, napg, cfg: FMConfig,
                       G, K, next_key, dtype, counters=None):
    """fm_learn_mcmc.h:1011-1089."""
    if not cfg.do_multilevel:
        return jnp.full((G, K), MU_0, dtype), v_lambda
    dev = jax.ops.segment_sum(
        ((v - take_rows(v_mu, attr_group).T) ** 2).T,
        attr_group, num_segments=G)  # [G, K]
    lam_gamma = BETA_0 * (v_mu - MU_0) ** 2 + GAMMA_0 + dev
    lam_alpha = ALPHA_0 + napg[:, None] + 1.0
    if cfg.do_sample:
        draw = jax.random.gamma(next_key(), lam_alpha / 2.0,
                                dtype=dtype) / (lam_gamma / 2.0)
    else:
        draw = lam_alpha / lam_gamma
    _count_bad(counters, "v_lambda", draw)
    v_lambda = keep_finite(draw, v_lambda)
    vsum = jax.ops.segment_sum(v.T, attr_group, num_segments=G)  # [G, K]
    mu_mean = (vsum + BETA_0 * MU_0) / (napg[:, None] + BETA_0)
    mu_s2 = 1.0 / ((napg[:, None] + BETA_0) * v_lambda)
    v_mu = _maybe_sample(cfg.do_sample, next_key(), mu_mean, mu_s2, v_mu,
                         zero_on_bad_sigma=False, counters=counters,
                         count_as="v_mu")
    return v_mu, v_lambda


def w_sweep_main(e, w, w_mu, w_lambda, alpha, plan, row, cfg: FMConfig,
                 next_key, counters=None):
    """Binned main-block w sweep + unobserved prior draws
    (fm_learn_mcmc.h:671-718).  Returns (e, w)."""
    dtype = w.dtype
    D = w.shape[0]
    zw_d = None
    if cfg.do_sample:
        # one [D] z-table per sweep (each column drawn exactly once: its
        # bucket, or the unobserved prior draw) — avoids a per-bucket
        # key-split/normal chain
        zw_d = jax.random.normal(next_key(), (D,), dtype)
    for bin_blocks in plan.blocks:
        dw = jnp.zeros((D,), dtype)
        for blk in bin_blocks:
            rows, x = blk.rows[0], blk.x[0]  # [C, L]
            w_c = _gather(w, blk.cols)
            mu_g = _gather(w_mu, blk.group)
            lam_g = _gather(w_lambda, blk.group)
            e_g = _gather(e, rows)
            sxe = _psum((x * e_g).sum(-1))
            w_mean = sxe - w_c * blk.sx2
            s2 = 1.0 / (lam_g + alpha * blk.sx2)
            mean = -s2 * (alpha * w_mean - mu_g * lam_g)
            if cfg.do_sample:
                val = mean + jnp.sqrt(s2) * _gather(zw_d, blk.cols)
            else:
                val = mean
            val = jnp.where(jnp.isfinite(s2), val, jnp.zeros_like(val))
            _count_bad(counters, "w", val)
            new_w = keep_finite(val, w_c)
            w = w.at[blk.cols].set(new_w)
            dw = dw.at[blk.cols].set(w_c - new_w)
        # one row-layout residual patch per bin: e -= x * (w_old - w_new)
        # (per-position flat gathers: [N, P] temps tile-pad 64x)
        for p in range(row.ids.shape[1]):
            e = e - row.vals[:, p] * jnp.take(dw, row.ids[:, p])
    # unobserved columns: posterior = prior N(mu_g, 1/lambda_g)
    mu_d = _gather(w_mu, plan.attr_group)
    lam_d = _gather(w_lambda, plan.attr_group)
    s2_d = 1.0 / lam_d
    if cfg.do_sample:
        un = mu_d + jnp.sqrt(s2_d) * zw_d  # zw_d unused for observed cols
        un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
    else:
        un = jnp.where(jnp.isfinite(s2_d), mu_d, jnp.zeros_like(mu_d))
    _count_bad(counters, "w", jnp.where(plan.unobserved, un, 0.0))
    new_un = keep_finite(un, w)
    return e, jnp.where(plan.unobserved, new_un, w)


def v_factor_main_bins(e, q, v_f, mu_f, lam_f, alpha, plan, row,
                       cfg: FMConfig, key, counters=None):
    """One factor's main-block bin sweep on the TOTAL q cache with exact
    per-bin e/q patches (draw_v, fm_learn_mcmc.h:784-840) + unobserved
    prior draws.  Returns (e, q, v_f, key)."""
    dtype = v_f.dtype
    D = v_f.shape[0]
    if cfg.do_sample:
        key, sub = jax.random.split(key)
        z_d = jax.random.normal(sub, (D,), dtype)
    for bin_blocks in plan.blocks:
        v_old_d = v_f  # pre-bin snapshot (functional)
        dv = jnp.zeros((D,), dtype)
        for blk in bin_blocks:
            rows, x = blk.rows[0], blk.x[0]
            v_c = _gather(v_old_d, blk.cols)
            mu_g = _gather(mu_f, blk.group)
            lam_g = _gather(lam_f, blk.group)
            e_g = _gather(e, rows)
            q_g = _gather(q, rows)
            h = x * (q_g - x * v_c[:, None])
            she = _psum((h * e_g).sum(-1))
            sh2 = _psum((h * h).sum(-1))
            v_mean = she - v_c * sh2
            s2 = 1.0 / (lam_g + alpha * sh2)
            mean = -s2 * (alpha * v_mean - mu_g * lam_g)
            if cfg.do_sample:
                val = mean + jnp.sqrt(s2) * _gather(z_d, blk.cols)
            else:
                val = mean
            val = jnp.where(jnp.isfinite(s2), val, jnp.zeros_like(val))
            _count_bad(counters, "v", val)
            new_v = keep_finite(val, v_c)
            v_f = v_f.at[blk.cols].set(new_v)
            dv = dv.at[blk.cols].set(v_c - new_v)
        # one row-layout patch per bin: h from pre-bin q and v
        # (per-position flat gathers from a [2, D] stacked table)
        vtab = jnp.stack([v_old_d, dv], axis=0)
        dq = 0.0
        de = 0.0
        for p in range(row.ids.shape[1]):
            g = jnp.take(vtab, row.ids[:, p], axis=-1)  # [2, N]
            xp = row.vals[:, p]
            h_e = xp * (q - xp * g[0])
            dq = dq + xp * g[1]
            de = de + h_e * g[1]
        q = q - dq
        e = e - de
    # unobserved columns take the prior
    mu_d = _gather(mu_f, plan.attr_group)
    lam_d = _gather(lam_f, plan.attr_group)
    s2_d = 1.0 / lam_d
    if cfg.do_sample:
        un = mu_d + jnp.sqrt(s2_d) * z_d
        un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
    else:
        un = jnp.where(jnp.isfinite(s2_d), mu_d, jnp.zeros_like(mu_d))
    _count_bad(counters, "v", jnp.where(plan.unobserved, un, 0.0))
    v_f = jnp.where(plan.unobserved, keep_finite(un, v_f), v_f)
    return e, q, v_f, key


def _tiled_scores(w0, w, v, ids, vals, cfg):
    """Full forward pass with the [1+K, N] channel-stacked gather bounded
    by row tiles at huge N (the re-predict at Netflix-100M would otherwise
    materialize a ~10 GB temp).  Bitwise identical to the one-shot path
    (tiles split independent rows only)."""
    n_loc = ids.shape[0]
    K = v.shape[0]
    rt = _mc_row_tiles(n_loc, 1 + K)
    nt = None if rt == 1 else _exact_tile_len(n_loc, rt)
    if nt is None:
        return fm_scores(w0, w, v, ids, vals, k0=cfg.k0, k1=cfg.k1)

    def body(i, acc):
        lo = i * nt
        s = fm_scores(w0, w, v,
                      jax.lax.dynamic_slice_in_dim(ids, lo, nt, 0),
                      jax.lax.dynamic_slice_in_dim(vals, lo, nt, 0),
                      k0=cfg.k0, k1=cfg.k1)
        return jax.lax.dynamic_update_slice_in_dim(acc, s, lo, 0)

    return jax.lax.fori_loop(0, n_loc // nt, body,
                             _pvary(jnp.zeros((n_loc,), v.dtype)))


def mcmc_draw_all(state: MCMCState, row: RowData, plan: PlanData, cfg: FMConfig,
                  num_cases: float):
    """One Gibbs sweep + full re-predict of the train e-cache.  Runs inside
    shard_map.  Returns ``(new_state, nans)`` where ``nans`` maps
    ``nan_<family>``/``inf_<family>`` to int32 rejected-candidate counts
    (the reference's per-iteration nan/inf counters,
    fm_learn_mcmc_simultaneous.h:100-128)."""
    dtype = state.w.dtype
    G, K = cfg.num_groups, cfg.num_factor
    N = jnp.asarray(num_cases, dtype)
    e = state.e
    key = state.key
    counters = zero_nan_counters()

    def next_key():
        nonlocal key
        key, sub = jax.random.split(key)
        return sub

    alpha = draw_alpha(e, row.valid, state.alpha, cfg, N, next_key, dtype,
                       counters=counters)

    w0 = state.w0
    if cfg.k0:
        e, w0 = draw_w0(e, row.valid, w0, cfg, alpha, N, next_key,
                        counters=counters)

    w, v = state.w, state.v
    w_mu, w_lambda = state.w_mu, state.w_lambda
    v_mu, v_lambda = state.v_mu, state.v_lambda

    if cfg.k1:
        w_mu, w_lambda = draw_w_hyperpriors(
            w, w_mu, w_lambda, plan.attr_group, plan.num_attr_per_group,
            cfg, G, next_key, dtype, counters=counters)
        e, w = w_sweep_main(e, w, w_mu, w_lambda, alpha, plan, row, cfg,
                            next_key, counters=counters)

    # --- group hyperpriors for v (fm_learn_mcmc.h:1011-1089) ---
    if K > 0:
        v_mu, v_lambda = draw_v_hyperpriors(
            v, v_mu, v_lambda, plan.attr_group, plan.num_attr_per_group,
            cfg, G, K, next_key, dtype, counters=counters)

        # --- v sweeps (fm_learn_mcmc.h:510-622, 780-835) ---
        # Factor execution: both Gibbs and ALS default to the factor-blocked
        # channel-stacked sweep (O(1) index passes per bin; conditionals stay
        # exact via in-bin sequential e_g updates, see _v_blocked_sweep).
        # cfg.factor_block=1 forces the reference's factor-major sequential
        # chain (the exact reference coordinate ordering).
        D = v.shape[1]
        F_eff = 1 if cfg.factor_block == 1 else \
            (min(cfg.factor_block, K) if cfg.factor_block > 0 else K)
        if F_eff > 1 and K % F_eff == 0:
            exact = not (cfg.mcmc_factor_jacobi and not cfg.do_sample)
            e, v, key = _v_blocked_sweep(e, v, v_mu, v_lambda, alpha, plan,
                                         row, cfg, F_eff, key,
                                         exact_seq=exact, counters=counters)
            v_done = True
        else:
            v_done = False

        def f_step(carry, xs):
            # the v counters must ride the scan carry (a dict mutated inside
            # the scan body would leak its tracers)
            e, key, vnan, vinf = carry
            v_f, mu_f, lam_f = xs  # [D], [G], [G]
            q = jnp.zeros_like(e)
            for p in range(row.ids.shape[1]):
                q = q + jnp.take(v_f, row.ids[:, p]) * row.vals[:, p]
            local: dict = {}
            e, q, v_f, key = v_factor_main_bins(
                e, q, v_f, mu_f, lam_f, alpha, plan, row, cfg, key,
                counters=local)
            vnan = vnan + local.get("nan_v", 0)
            vinf = vinf + local.get("inf_v", 0)
            return (e, key, vnan, vinf), v_f

        if not v_done:
            z32 = jnp.zeros((), jnp.int32)
            (e, key, vnan, vinf), v = jax.lax.scan(
                f_step, (e, key, z32, z32), (v, v_mu.T, v_lambda.T))
            counters["nan_v"] = counters.get("nan_v", 0) + vnan
            counters["inf_v"] = counters.get("inf_v", 0) + vinf

    # --- full re-predict (fm_learn_mcmc_simultaneous.h:134-176): regression
    # restores e := yhat - y immediately; classification leaves e = yhat for
    # the learner's truncated-normal target resampling (:196-219) ---
    yhat = _tiled_scores(w0, w, v, row.ids, row.vals, cfg)
    if cfg.task == TASK_REGRESSION:
        yhat = yhat - row.target

    new_state = MCMCState(w0=w0, w=w, v=v, alpha=alpha, w_mu=w_mu,
                          w_lambda=w_lambda, v_mu=v_mu, v_lambda=v_lambda,
                          e=yhat, key=key)
    nans = {k: jnp.asarray(val, jnp.int32) for k, val in counters.items()}
    return new_state, nans


def _state_specs():
    rep, shd = P(), P(DATA_AXIS)
    return MCMCState(w0=rep, w=rep, v=rep, alpha=rep, w_mu=rep, w_lambda=rep,
                     v_mu=rep, v_lambda=rep, e=shd, key=rep)


def _row_specs():
    shd = P(DATA_AXIS)
    return RowData(ids=shd, vals=shd, target=shd, valid=shd)




class MCMCLearner:
    """Gibbs-MCMC / ALS trainer over a device mesh."""

    method = "mcmc"
    #: optional base.MapEval — enables per-iteration MAP@k for task 'c'
    #: (fm_learn_mcmc_simultaneous.h:270-275)
    map_eval = None
    #: class defaults so subclasses with bespoke __init__s (TP/BS) keep the
    #: full-test-set eval; MCMCLearner.__init__ overrides per instance
    _rest_valid = None
    _eval_n = None

    def __init__(self, cfg: FMConfig, train: SparseDataset, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None, mesh=None,
                 bins: str = "auto", out_dir: str = ".", write_files: bool = True,
                 w_lambda_init: Optional[np.ndarray] = None,
                 v_lambda_init: Optional[np.ndarray] = None,
                 num_eval_cases: Optional[int] = None,
                 plan: Optional[SweepPlan] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        n = self.mesh.devices.size
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        if plan is not None:
            # prebuilt (e.g. SweepPlan.load cache — the host-side build
            # costs minutes at 100M rows); must match (train, n_shards)
            assert plan.num_shards == n
            self.plan = plan
        else:
            coo = train.to_coo()
            self.plan = SweepPlan.build(coo, cfg.num_attributes,
                                        meta_groups=meta.attr_group,
                                        bins=bins, n_shards=n)
        self.train_row, self.train_n = build_row_data(self.mesh, train)
        self.test_row, self.test_n = build_row_data(self.mesh, test)
        # Per-iteration eval over the first num_eval_cases test rows, with
        # the held-back remainder evaluated separately as rmse_test2_*
        # (fm_learn_mcmc_simultaneous.h:240-256; the reference computes the
        # test2 values but its log lines are commented out — we stream them
        # as a documented superset).  The primary eval mask REPLACES the
        # test valid mask, exactly like the reference's _evaluate(0, nec).
        self._rest_valid = None
        self._eval_n = self.test_n
        if num_eval_cases is not None and 0 < num_eval_cases < self.test_n:
            from svbfm.parallel.mesh import shard_rows
            n_pad = self.test_row.ids.shape[0]
            idx = np.arange(n_pad)
            emask = (idx < num_eval_cases).astype(np.float32)
            rest = ((idx >= num_eval_cases) & (idx < self.test_n)).astype(
                np.float32)
            self.test_row = self.test_row.replace(
                valid=shard_rows(self.mesh, emask))
            self._rest_valid = shard_rows(self.mesh, rest)
            self._eval_n = int(num_eval_cases)
        if cfg.factor_block == 0 and cfg.num_factor > 1:
            # auto-pick the factor block so the channel-stacked sweep's
            # temps fit HBM (falls to 1 = factor-sequential when nothing fits)
            import dataclasses
            n_loc = self.train_row.ids.shape[0] // n
            fb = _auto_factor_block(self.plan, cfg.num_factor, n_loc)
            cfg = dataclasses.replace(cfg, factor_block=fb)
            self.cfg = cfg
        self.plan_data = build_plan_data(self.mesh, self.plan, meta)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.train_target = self.train_row.target
        self.out_dir = out_dir
        self.write_files = write_files
        # -regular: per-group lambda init (libfm.cpp:367-407)
        self.w_lambda_init = (w_lambda_init if w_lambda_init is not None
                              else np.full(cfg.num_groups, cfg.regw, np.float32))
        self.v_lambda_init = (v_lambda_init if v_lambda_init is not None
                              else np.full((cfg.num_groups, cfg.num_factor), cfg.regv, np.float32))
        self._build_jits()

    # Spec trees for the jitted programs — overridable so sharded variants
    # (e.g. the feature-sharded parallel.tp_mcmc learner) reuse the whole
    # run/fused-eval/checkpoint machinery with their own layouts.
    def _sspec(self):
        return _state_specs()

    def _rspec(self):
        return _row_specs()

    def _pspec(self):
        return plan_specs_for(self.plan_data)

    def _nanspec(self):
        """Spec tree for the draw's nan/inf counter dict (second return
        value of the draw_all functions); {} for variants that don't count."""
        return nan_counter_specs()

    def _build_jits(self):
        cfg = self.cfg
        num_cases = float(self.train_n)

        def step_fn(state, row, plan):
            return mcmc_draw_all(state, row, plan, cfg, num_cases)

        self._step = jax.jit(jax.shard_map(
            step_fn, mesh=self.mesh,
            in_specs=(self._sspec(), self._rspec(), self._pspec()),
            out_specs=(self._sspec(), self._nanspec()),
        ))

        def scores_fn(w0, w, v, ids, vals):
            return fm_scores(w0, w, v, ids, vals, k0=cfg.k0, k1=cfg.k1)

        self._scores = jax.jit(scores_fn)
        self._fused_cache = {}

    # Extra device args threaded through the fused programs (the BS learner
    # passes its relation structures here); specs must mirror them.
    _extra_args: tuple = ()
    _extra_specs: tuple = ()

    def _draw_inprog(self, state, row, plan, *extras):
        return mcmc_draw_all(state, row, plan, self.cfg, float(self.train_n))

    def _test_scores_inprog(self, state, trow, *extras):
        cfg = self.cfg
        return fm_scores(state.w0, state.w, state.v, trow.ids, trow.vals,
                         k0=cfg.k0, k1=cfg.k1)

    def _iter_body(self, carry, row, plan, trow, it0, *extras, rest=None):
        """One Gibbs draw + in-program eval with running posterior-mean
        accumulators (pred_sum_all / all_but5,
        fm_learn_mcmc_simultaneous.h:152-302).  Runs inside shard_map.
        With ``rest`` (the held-back test mask when num_eval_cases < test
        rows), also evaluates rmse_test2_this/all over the remainder
        (fm_learn_mcmc_simultaneous.h:252-258)."""
        state, psum_all, psum_but5, it = carry
        state, nans = self._draw_inprog(state, row, plan, *extras)
        return self._eval_tail(state, nans, psum_all, psum_but5, it, row,
                               trow, *extras, rest=rest)

    def _eval_tail(self, state, nans, psum_all, psum_but5, it, row, trow,
                   *extras, rest=None):
        """Post-draw in-program eval + classification target resampling
        (the tail of :meth:`_iter_body`, shared with the staged huge-N
        path's C stage)."""
        cfg = self.cfg
        scores = self._test_scores_inprog(state, trow, *extras)
        nt = jnp.asarray(float(self._eval_n or self.test_n), scores.dtype)
        itf = it.astype(scores.dtype)
        if cfg.task == TASK_REGRESSION:
            p = jnp.clip(scores, cfg.min_target, cfg.max_target)
            psum_all = psum_all + p
            psum_but5 = psum_but5 + jnp.where(it >= 5, p, 0.0)
            def _rmse(pred, norm):
                pr = jnp.clip(pred * norm, cfg.min_target, cfg.max_target)
                err = (pr - trow.target) * trow.valid
                return jnp.sqrt(_psum(jnp.sum(err * err)) / nt)
            err_this = (p - trow.target) * trow.valid
            rmse_this = jnp.sqrt(_psum(jnp.sum(err_this * err_this)) / nt)
            rmse_all = _rmse(psum_all, 1.0 / (itf + 1.0))
            rmse_but5 = jnp.where(
                it >= 5, _rmse(psum_but5, 1.0 / jnp.maximum(itf - 4.0, 1.0)),
                rmse_all)
            err_all = (jnp.clip(psum_all / (itf + 1.0), cfg.min_target,
                                cfg.max_target) - trow.target) * trow.valid
            mae_all = _psum(jnp.sum(jnp.abs(err_all))) / nt
            metrics = dict(rmse=rmse_all, rmse_this=rmse_this,
                           rmse_all_but5=rmse_but5, mae=mae_all,
                           alpha=state.alpha,
                           w_mu=state.w_mu, w_lambda=state.w_lambda,
                           v_mu=state.v_mu, v_lambda=state.v_lambda)
            if rest is not None:
                n2 = jnp.asarray(float(self.test_n - self._eval_n),
                                 scores.dtype)
                e2 = (p - trow.target) * rest
                metrics["rmse_test2_this"] = jnp.sqrt(
                    _psum(jnp.sum(e2 * e2)) / n2)
                pm2 = (jnp.clip(psum_all / (itf + 1.0), cfg.min_target,
                                cfg.max_target) - trow.target) * rest
                metrics["rmse_test2_all"] = jnp.sqrt(
                    _psum(jnp.sum(pm2 * pm2)) / n2)
        else:
            prob = ref_cdf_gaussian(scores)
            psum_all = psum_all + prob
            psum_but5 = psum_but5 + jnp.where(it >= 5, prob, 0.0)
            pm = psum_all / (itf + 1.0)
            yt = trow.target
            hit = (((pm >= 0.5) & (yt > 0)) | ((pm < 0.5) & (yt < 0)))
            acc = _psum(jnp.sum(hit * trow.valid)) / nt
            m = (yt + 1.0) * 0.5
            pll = jnp.clip(pm, 0.01, 0.99)
            ll = -_psum(jnp.sum((m * jnp.log10(pll) + (1 - m) * jnp.log10(1 - pll))
                                * trow.valid)) / nt
            hit_this = (((prob >= 0.5) & (yt > 0)) | ((prob < 0.5) & (yt < 0)))
            acc_this = _psum(jnp.sum(hit_this * trow.valid)) / nt
            pll_this = jnp.clip(prob, 0.01, 0.99)
            ll_this = -_psum(jnp.sum(
                (m * jnp.log10(pll_this) + (1 - m) * jnp.log10(1 - pll_this))
                * trow.valid)) / nt
            metrics = dict(accuracy=acc, loglik=ll, acc_this=acc_this,
                           ll_this=ll_this, alpha=state.alpha,
                           w_mu=state.w_mu, w_lambda=state.w_lambda,
                           v_mu=state.v_mu, v_lambda=state.v_lambda)
            state = self._resample_class_targets_jax(state, row)
        metrics.update(nans)
        return (state, psum_all, psum_but5, it + 1), metrics

    def _resample_class_targets_jax(self, state, row):
        """Truncated-normal latent resampling
        (fm_learn_mcmc_simultaneous.h:196-219).  e currently equals yhat."""
        from svbfm.learners.base import (truncnorm_mean_negative,
                                         truncnorm_mean_positive)
        e = state.e
        y = row.target
        key, sub = jax.random.split(state.key)
        if self.cfg.do_sample:
            sub = jax.random.fold_in(sub, jax.lax.axis_index(DATA_AXIS))
            u = jax.random.uniform(sub, e.shape, e.dtype, 1e-7, 1.0 - 1e-7)
            lo = ref_cdf_gaussian(-e)  # P(z < 0), z ~ N(e,1)
            cdf = jnp.where(y >= 0, lo + u * (1 - lo), u * lo)
            cdf = jnp.clip(cdf, 1e-7, 1 - 1e-7)
            sampled = e + jnp.sqrt(2.0) * jax.scipy.special.erfinv(2 * cdf - 1)
        else:
            sampled = jnp.where(y >= 0, truncnorm_mean_positive(e),
                                truncnorm_mean_negative(e))
        return state.replace(e=e - sampled, key=key)

    # default multi-iteration fusion width when run(chunk=None); subclasses
    # whose draw carries an inner lax.scan (BS) unroll and use a smaller one
    _default_chunk = 10

    def _clamp_chunk(self, chunk: int) -> int:
        """Hook for subclasses whose fused program degrades at chunk>1.
        The base learner clamps to 1 when the sweep's internal memory
        tiling engages: the earlier accelerator's compiler miscompiled
        tiling loops nested inside the fused iteration scan (see
        _v_block_pass)."""
        return 1 if self._needs_tiling() else chunk

    def _fused_steps(self, chunk: int):
        if chunk in self._fused_cache:
            return self._fused_cache[chunk]
        shd = P(DATA_AXIS)
        has_rest = self._rest_valid is not None

        def multi(state, psum_all, psum_but5, it0, row, plan, trow, *extras):
            rest = extras[0] if has_rest else None
            draws = extras[1:] if has_rest else extras

            def body(carry, _):
                return self._iter_body(carry, row, plan, trow, it0, *draws,
                                       rest=rest)

            (state, psum_all, psum_but5, it), metrics = jax.lax.scan(
                body, (state, psum_all, psum_but5, it0), None, length=chunk)
            return state, psum_all, psum_but5, it, metrics

        in_specs = (self._sspec(), shd, shd, P(), self._rspec(),
                    self._pspec(), self._rspec(),
                    *((shd,) if has_rest else ()), *self._extra_specs)
        from svbfm.learners.base import named_shardings
        fn = jax.jit(jax.shard_map(
            multi, mesh=self.mesh,
            in_specs=in_specs,
            out_specs=(self._sspec(), shd, shd, P(), P()),
        ), in_shardings=named_shardings(self.mesh, in_specs))
        self._fused_cache[chunk] = fn
        return fn

    # ---- staged huge-N path (mirrors learners.vb._staged_*) --------------
    #: subclasses with bespoke draw paths (relational BS, feature-sharded
    #: TP) opt out; they fall back to the fused programs
    _staged_capable = True

    def _stage_layout(self):
        """(F, nb) of the staged factor blocking (requires factor_block>=1
        with K % F == 0)."""
        K = self.cfg.num_factor
        F = min(max(self.cfg.factor_block, 1), K) if K else 0
        nb = K // F if K else 0
        return F, nb

    def _staged_mode(self) -> bool:
        """True when one fused draw_all would exceed MCMC_STAGE_UNITS and
        the sweep is splittable by factor block."""
        import os
        ov = os.environ.get("SVBFM_MCMC_STAGED")
        if ov == "0":
            return False
        cfg = self.cfg
        K = cfg.num_factor
        F = min(max(cfg.factor_block, 1), K) if K else 0
        ok = (self._staged_capable and not self._extra_args and K > 0
              and cfg.factor_block >= 1 and K % F == 0)
        if not ok:
            if ov == "1":
                raise ValueError(
                    "SVBFM_MCMC_STAGED=1 requires num_factor > 0, "
                    "factor_block >= 1 dividing K, and a learner without "
                    "extra device args (no BS/TP)")
            return False
        if ov == "1":
            return True
        _F, nb = self._stage_layout()
        n_loc = self.train_row.ids.shape[0] // self.mesh.devices.size
        return n_loc * nb > MCMC_STAGE_UNITS

    def _staged_programs(self):
        """Three donated shard_map programs splitting one draw_all + eval
        iteration: A (alpha, w0, w hyperpriors + w sweep, v hyperpriors),
        B (one factor block of the v sweep, block index traced — ONE
        compile for all blocks), C (full re-predict + eval + resampling).
        The draw/key sequence is IDENTICAL to the fused blocked path, so
        trajectories match bitwise (CPU equivalence test)."""
        if getattr(self, "_staged_cache", None) is not None:
            return self._staged_cache
        cfg = self.cfg
        K = cfg.num_factor
        F, _nb = self._stage_layout()
        G = cfg.num_groups
        num_cases = float(self.train_n)
        has_rest = self._rest_valid is not None

        def a_stage(state, row, plan):
            dtype = state.w.dtype
            N = jnp.asarray(num_cases, dtype)
            e, key = state.e, state.key
            counters = zero_nan_counters()

            def next_key():
                nonlocal key
                key, sub = jax.random.split(key)
                return sub

            alpha = draw_alpha(e, row.valid, state.alpha, cfg, N, next_key,
                               dtype, counters=counters)
            w0 = state.w0
            if cfg.k0:
                e, w0 = draw_w0(e, row.valid, w0, cfg, alpha, N, next_key,
                                counters=counters)
            w, v = state.w, state.v
            w_mu, w_lambda = state.w_mu, state.w_lambda
            v_mu, v_lambda = state.v_mu, state.v_lambda
            if cfg.k1:
                w_mu, w_lambda = draw_w_hyperpriors(
                    w, w_mu, w_lambda, plan.attr_group,
                    plan.num_attr_per_group, cfg, G, next_key, dtype,
                    counters=counters)
                e, w = w_sweep_main(e, w, w_mu, w_lambda, alpha, plan, row,
                                    cfg, next_key, counters=counters)
            if K > 0:
                v_mu, v_lambda = draw_v_hyperpriors(
                    v, v_mu, v_lambda, plan.attr_group,
                    plan.num_attr_per_group, cfg, G, K, next_key, dtype,
                    counters=counters)
            new_state = MCMCState(
                w0=w0, w=w, v=v, alpha=alpha, w_mu=w_mu, w_lambda=w_lambda,
                v_mu=v_mu, v_lambda=v_lambda, e=e, key=key)
            nans = {k: jnp.asarray(val, jnp.int32)
                    for k, val in counters.items()}
            return new_state, nans

        def b_stage(state, b, row, plan):
            # one factor block of _v_blocked_sweep with b traced: K % F == 0
            # (staged-mode guard), so idx is always in range
            idx = b * F + jnp.arange(F)
            v_t = take_rows(state.v, idx).T  # [D, F]
            mu_dk = take_rows(state.v_mu, plan.attr_group)  # [D, K]
            lam_dk = take_rows(state.v_lambda, plan.attr_group)
            mu_t = jnp.take(mu_dk, idx, axis=1)  # [D, F]
            lam_t = jnp.take(lam_dk, idx, axis=1)
            exact = not (cfg.mcmc_factor_jacobi and not cfg.do_sample)
            local: dict = {}
            e, v_t, _q, key = _v_block_pass(
                state.e, v_t, mu_t, lam_t, state.key, plan, row, cfg,
                state.alpha, exact_seq=exact, counters=local)
            # unobserved columns: posterior == prior N(mu, 1/lambda)
            key, sub = jax.random.split(key)
            new_un = _maybe_sample(cfg.do_sample, sub, mu_t, 1.0 / lam_t,
                                   v_t, counters=local, count_as="v",
                                   count_mask=plan.unobserved[:, None])
            v_new = jnp.where(plan.unobserved[:, None], new_un, v_t)
            v = state.v.at[idx].set(v_new.T)
            nans = {k: jnp.asarray(local.get(k, 0), jnp.int32)
                    for k in ("nan_v", "inf_v")}
            return state.replace(e=e, v=v, key=key), nans

        def c_stage(state, nans, psum_all, psum_but5, it0, row, plan, trow,
                    *rest):
            rest_m = rest[0] if has_rest else None
            # full re-predict (fm_learn_mcmc_simultaneous.h:134-176)
            yhat = _tiled_scores(state.w0, state.w, state.v, row.ids,
                                 row.vals, cfg)
            if cfg.task == TASK_REGRESSION:
                yhat = yhat - row.target
            state = state.replace(e=yhat)
            (state, psum_all, psum_but5, it), metrics = self._eval_tail(
                state, nans, psum_all, psum_but5, it0, row, trow,
                rest=rest_m)
            return (state, psum_all, psum_but5, it,
                    jax.tree.map(lambda a: a[None], metrics))

        sspec, rspec = self._sspec(), self._rspec()
        pspec = plan_specs_for(self.plan_data)
        nspec = self._nanspec()
        shd = P(DATA_AXIS)
        mesh = self.mesh
        fnA = jax.jit(jax.shard_map(
            a_stage, mesh=mesh, in_specs=(sspec, rspec, pspec),
            out_specs=(sspec, nspec)), donate_argnums=(0,))
        fnB = jax.jit(jax.shard_map(
            b_stage, mesh=mesh, in_specs=(sspec, P(), rspec, pspec),
            out_specs=(sspec, {"nan_v": P(), "inf_v": P()})),
            donate_argnums=(0,))
        fnC = jax.jit(jax.shard_map(
            c_stage, mesh=mesh,
            in_specs=(sspec, nspec, shd, shd, P(), rspec, pspec, rspec,
                      *((shd,) if has_rest else ())),
            out_specs=(sspec, shd, shd, P(), P())), donate_argnums=(0, 2, 3))
        self._staged_cache = (fnA, fnB, fnC)
        return self._staged_cache

    def _staged_iteration(self, state, psum_all, psum_but5, done):
        """Dispatch one iteration as A + nb block programs + C; returns
        (state, psum_all, psum_but5, it, metrics[1]) exactly like a
        chunk=1 fused call.  All calls are async; nothing blocks."""
        fnA, fnB, fnC = self._staged_programs()
        _F, nb = self._stage_layout()
        state, nans = fnA(state, self.train_row, self.plan_data)
        for b in range(nb):
            state, nv = fnB(state, jnp.asarray(b, jnp.int32),
                            self.train_row, self.plan_data)
            nans = dict(nans, nan_v=nans["nan_v"] + nv["nan_v"],
                        inf_v=nans["inf_v"] + nv["inf_v"])
        rest = (() if self._rest_valid is None else (self._rest_valid,))
        return fnC(state, nans, psum_all, psum_but5,
                   jnp.asarray(done, jnp.int32), self.train_row,
                   self.plan_data, self.test_row, *rest)

    def _needs_tiling(self) -> bool:
        """True iff the sweep's internal memory tiling (_mc_row_tiles /
        _mc_col_tiles > 1) engages, in which case the program contains
        top-level tiling loops and runs one iteration per program (see
        _clamp_chunk).  Uses the SAME
        helpers as the kernel so the predicate cannot drift."""
        cfg = self.cfg
        K = cfg.num_factor
        n_loc = self.train_row.ids.shape[0] // self.mesh.devices.size
        if _mc_row_tiles(n_loc, 1 + K) > 1:  # re-predict gather
            return True
        if K > 0:
            F = 1 if cfg.factor_block == 1 else \
                (min(cfg.factor_block, K) if cfg.factor_block > 0 else K)
            if F > 1 and K % F == 0:  # blocked-sweep path
                if _mc_row_tiles(n_loc, 4 * F) > 1:
                    return True
                for bin_blocks in self.plan.blocks:
                    for blk in bin_blocks:
                        if _mc_col_tiles(blk.rows.shape[1],
                                         blk.rows.shape[2], F) > 1:
                            return True
        return False

    def init_state(self, key: Optional[jax.Array] = None) -> MCMCState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev, init_w_normal=True)
        ids, vals = self.train_row.ids, self.train_row.vals
        n_rows = ids.shape[0]
        # at huge single-chip N the one-shot forward pass materializes a
        # [1+K, N] channel-stacked gather temp (~18 GB at Netflix-100M);
        # compute the init residual in bounded row slices instead (init
        # runs once — a python loop is fine).  Multi-device meshes keep
        # the one-shot path: row slicing would reshard across devices.
        # Same valve as vb.VBLearner.init_state.
        row_chunk = 16 * 1024 * 1024
        if self.mesh.devices.size == 1 and n_rows > row_chunk:
            parts = []
            for lo in range(0, n_rows, row_chunk):
                hi = min(lo + row_chunk, n_rows)
                s = self._scores(params.w0, params.w, params.v,
                                 ids[lo:hi], vals[lo:hi])
                parts.append(s - self.train_row.target[lo:hi])
                jax.block_until_ready(parts[-1])  # bound in-flight temps
            e = jnp.concatenate(parts)
        else:
            yhat = self._scores(params.w0, params.w, params.v, ids, vals)
            e = yhat - self.train_row.target  # e = yhat - y (MCMC sign)
        G, K = cfg.num_groups, cfg.num_factor
        state = MCMCState(
            w0=params.w0, w=params.w, v=params.v,
            alpha=jnp.ones((), jnp.float32),
            w_mu=jnp.zeros((G,), jnp.float32),
            w_lambda=jnp.asarray(self.w_lambda_init, jnp.float32),
            v_mu=jnp.zeros((G, K), jnp.float32),
            v_lambda=jnp.asarray(self.v_lambda_init, jnp.float32),
            e=e, key=key)
        # match the step's output shardings to avoid a recompile on step 1
        from jax.sharding import NamedSharding
        shardings = jax.tree.map(lambda spec: NamedSharding(self.mesh, spec),
                                 self._sspec())
        return jax.device_put(state, shardings)

    def predict_test_scores(self, state: MCMCState) -> np.ndarray:
        s = self._scores(state.w0, state.w, state.v,
                         self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]

    def run(self, state: Optional[MCMCState] = None, num_iter: Optional[int] = None,
            verbose: bool = True, chunk: Optional[int] = None,
            ckpt=None, ckpt_every: int = 10):
        """Run ``num_iter`` Gibbs/ALS iterations with fused on-device eval
        (posterior-mean prediction accumulators carried across chunks).
        ``ckpt`` (a CheckpointManager) checkpoints the sampler state AND the
        posterior-mean accumulators, resuming from the latest snapshot.

        When neither MAP@k nor checkpointing is active, the per-chunk metrics
        fetch is PIPELINED: trajectory-file writes, rlog rows, and verbose
        output lag one chunk behind dispatch (a mid-run crash still flushes
        the pending chunk via the finally block below)."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        map_eval = (self.map_eval if cfg.task != TASK_REGRESSION else None)
        staged = self._staged_mode()
        if chunk is None:
            # fixed default chunk => one compiled program shape across runs
            chunk = min(self._default_chunk, num_iter)
        chunk = self._clamp_chunk(chunk)
        if staged:
            chunk = 1  # one draw = A + nb block programs + C
        if map_eval is not None:
            # per-iteration MAP@k ranks the posterior-mean probabilities on
            # host (fm_learn_mcmc_simultaneous.h:270-275); psum_all is only
            # observable between fused chunks, so run one iteration per chunk
            chunk = 1
        from jax.sharding import NamedSharding
        shd = NamedSharding(self.mesh, P(DATA_AXIS))
        rep = NamedSharding(self.mesh, P())
        n_pad = self.test_row.target.shape[0]
        psum_all = jax.device_put(jnp.zeros((n_pad,), jnp.float32), shd)
        psum_but5 = jax.device_put(jnp.zeros((n_pad,), jnp.float32), shd)
        it = 0
        done = 0
        if ckpt is not None:
            restored = ckpt.restore_latest(
                {"state": state, "psum_all": psum_all,
                 "psum_but5": psum_but5})
            if restored is not None:
                blob, it, _meta = restored
                from jax.tree_util import tree_map
                state_sh = jax.tree.map(lambda spec: NamedSharding(self.mesh, spec),
                                        self._sspec())
                state = jax.device_put(blob["state"], state_sh)
                psum_all = jax.device_put(blob["psum_all"], shd)
                psum_but5 = jax.device_put(blob["psum_but5"], shd)
                done = it
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                                   self.write_files and done == 0)
        history = []
        last_saved = it
        import time as _time

        last_flush_t = None

        def _flush(metrics, n, t0):
            """Fetch one chunk's metrics pytree and emit its n records."""
            nonlocal it, last_flush_t
            # ONE host transfer for the whole metrics pytree instead of a
            # blocking copy per key
            t_fetch = _time.perf_counter()
            metrics = jax.device_get(metrics)
            now = _time.perf_counter()
            # The test eval runs INSIDE the fused program; the host-visible
            # predict/eval segment is this blocking fetch (the reference's
            # time_pred brackets predict+evaluate, fm_learn.h:92-95)
            time_pred = (now - t_fetch) / n
            # In pipeline mode chunk k+1 was dispatched before this flush, so
            # now-t0 would span two executions; the interval between flush
            # completions covers exactly this chunk's execution in steady
            # state (the device_get above blocks until chunk k finishes).
            base = t0 if last_flush_t is None else max(t0, last_flush_t)
            iter_wall = (now - base) / n
            last_flush_t = now
            for j in range(n):
                rec = {"iter": it, "time_learn": iter_wall,
                       "time_pred": time_pred}
                if not self.plan.conflict_free:
                    rec["conflict_free"] = False  # Jacobi-bin approximation
                # vector metrics ([G]/[G,K] hyperparameter traces) stay arrays
                rec.update({k: (float(v[j]) if v[j].ndim == 0 else v[j])
                            for k, v in metrics.items()})
                if cfg.task == TASK_REGRESSION:
                    rmse_file.append(rec["rmse"])
                    if verbose:
                        print(f"#Iter={it:3d}\tTest={rec['rmse']:.6g}"
                              f"\tTest(this)={rec['rmse_this']:.6g}")
                else:
                    rmse_file.append(rec["accuracy"])
                    if map_eval is not None:
                        # posterior-mean probabilities at this iteration
                        # (chunk==1 and no pipelining in MAP mode, so
                        # psum_all is exactly iter `it`'s sum)
                        probs = np.asarray(psum_all)[: self.test_n] / (it + 1.0)
                        rec["map"] = map_eval(probs)
                        if verbose:
                            print(f"#Iter={it:3d}\tTest={rec['accuracy']:.6g}"
                                  f"\tMAP@{map_eval.k}= {rec['map']:.6g}")
                    elif verbose:
                        print(f"#Iter={it:3d}\tTest={rec['accuracy']:.6g}")
                from svbfm.learners.base import print_nonzero_nans
                print_nonzero_nans(rec, verbose)
                from svbfm.utils.rlog_schema import stream_row
                stream_row(self, rec)
                history.append(rec)
                it += 1

        # Pipeline the per-chunk metrics fetch: dispatch chunk k+1 (async),
        # THEN device_get chunk k's metrics — the fetch overlaps with
        # chunk k+1's device execution.  Disabled when
        # the host must observe device state between chunks: MAP@k reads
        # psum_all per iteration, checkpointing snapshots state.
        pipeline = map_eval is None and ckpt is None
        pending = None  # (metrics handle, n, t0) of the not-yet-fetched chunk
        try:
            while done < num_iter:
                n = min(chunk, num_iter - done)
                t0 = _time.perf_counter()
                # it0 is rebuilt from the host counter per call: threading
                # the device scalar back in RETRACES the program (a shard_map
                # output scalar's aval carries the mesh axes, i32[]({Auto:
                # ('data',)}) vs a fresh scalar's i32[]({})), a recompile
                # on the first post-warmup run()
                if staged:
                    state, psum_all, psum_but5, _it_out, metrics = \
                        self._staged_iteration(state, psum_all, psum_but5,
                                               done)
                else:
                    fn = self._fused_steps(n)
                    rest = (() if self._rest_valid is None
                            else (self._rest_valid,))
                    state, psum_all, psum_but5, _it_out, metrics = fn(
                        state, psum_all, psum_but5,
                        jnp.asarray(done, jnp.int32),
                        self.train_row, self.plan_data, self.test_row,
                        *rest, *self._extra_args)
                done += n
                if pipeline:
                    if pending is not None:
                        _flush(*pending)
                    pending = (metrics, n, t0)
                else:
                    _flush(metrics, n, t0)
                    if ckpt is not None and (it - last_saved >= ckpt_every
                                             or done >= num_iter):
                        ckpt.save({"state": jax.tree.map(np.asarray, state),
                                   "psum_all": np.asarray(psum_all),
                                   "psum_but5": np.asarray(psum_but5)},
                                  it, {"method": self.method})
                        last_saved = it
        finally:
            # pipeline mode lags record emission one chunk behind dispatch;
            # flush the pending chunk even when the loop raises so its
            # trajectory/rlog rows aren't silently lost
            if pending is not None:
                _flush(*pending)
        # posterior-mean predictor state: the reference's predict() returns
        # pred_sum_all/num_iter when sampling (fm_learn_mcmc.h:355-379)
        self._pred_sum_all = np.asarray(psum_all)[: self.test_n]
        self._pred_iters = it
        return state, history

    def final_test_predictions(self, state: MCMCState) -> np.ndarray:
        """Final test predictions in OUTPUT space, with reference predict()
        semantics: the posterior-mean accumulator pred_sum_all/num_iter when
        sampling (fm_learn_mcmc.h:355-379); last-state scores for ALS.
        Regression values are clamped to [min,max]; classification values
        are probit probabilities in [0, 1]."""
        if self.cfg.do_sample and getattr(self, "_pred_iters", 0) > 0:
            pm = self._pred_sum_all / float(self._pred_iters)
        else:
            pm = self.predict_test_scores(state)
            if self.cfg.task != TASK_REGRESSION:
                pm = np.asarray(ref_cdf_gaussian(jnp.asarray(pm)))
        if self.cfg.task == TASK_REGRESSION:
            return np.clip(pm, self.cfg.min_target, self.cfg.max_target)
        return np.clip(pm, 0.0, 1.0)


class ALSLearner(MCMCLearner):
    """ALS = MCMC with do_sample=False, do_multilevel=False (libfm.cpp:131-135).
    Trajectory files keep the '_mcmc' suffix because the reference rewrites
    the method string before dispatch."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        import dataclasses
        cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=False)
        super().__init__(cfg, *args, **kwargs)
