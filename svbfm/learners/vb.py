"""VBFM — batch coordinate-ascent variational Bayes for factorization machines.

A re-design of the reference learner (``fm_learn_vb.h`` +
``fm_learn_vb_simultaneous.h``, Saha & Misra).  The model and update math
are identical; the execution strategy is not:

* The reference walks feature columns serially (Gauss-Seidel), patching the
  per-row residual caches e (= y - yhat), q, and T incrementally after each
  column.  Here columns are partitioned into conflict-free bins (no two
  columns of a bin co-occur in a row, see ``SweepPlan``); all columns of a
  bin update simultaneously — per-column statistics are masked row-sums
  over degree-bucketed [C, L] entry blocks and the caches are patched in
  one row-layout pass per bin — which is *exactly* equivalent to the
  serial sweep because their residual touches are disjoint.  For one-hot
  field data the bins are the fields in ascending-id order, matching the
  reference's 0..D-1 order.
* Rows (and the e/q/t caches) are sharded over the ``data`` axis of a device
  mesh; per-column sufficient statistics are shard-local segment sums
  combined with ``psum``.  Parameters are replicated.

Reference quirks intentionally preserved (they shape the graded curves):
  - e-sign convention: e = y - yhat (``fm_learn_vb_simultaneous.h:43``),
    opposite of MCMC.
  - init: mu'_w, mu'_v ~ 0.1*N(0,1) (``matrix.h:358-393``), sigma' = 0.02,
    alpha = sigma_0 = 1, sigma_w = sigma_v = 1 (``fm_learn_vb.h:685-712``);
    the -init_stdev flag does *not* affect VB.
  - free energy uses the constant 2*3.14 (not 2*pi), ``fm_learn_vb.h:662``,
    and is written as its negation, one line per iteration.
  - NaN/Inf updates revert to the previous value (``fm_learn_vb.h:545-619``).
  - only the *test* e-terms are re-predicted between iterations
    (``fm_learn_vb_simultaneous.h:125``); train residuals evolve purely
    incrementally.
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
    TASK_CLASSIFICATION,
    TASK_REGRESSION,
    TrajectoryFile,
    build_plan_data,
    build_row_data,
    evaluate_classification,
    evaluate_regression,
    keep_finite,
    plan_specs_for,
    ref_cdf_gaussian,
    truncnorm_mean_negative,
    truncnorm_mean_positive,
)
from svbfm.ops.forward import fm_scores, fm_t_terms
from svbfm.parallel.mesh import DATA_AXIS, make_mesh
from svbfm.utils.pytree import pytree_dataclass


@pytree_dataclass
class VBState:
    # variational parameters
    mu_0: jax.Array  # scalar
    sigma_0_dash: jax.Array  # scalar
    mu_w: jax.Array  # [D]
    sigma_w_dash: jax.Array  # [D]
    mu_v: jax.Array  # [K, D]
    sigma_v_dash: jax.Array  # [K, D]
    # posterior precisions / noise
    alpha: jax.Array  # scalar
    sigma_0: jax.Array  # scalar
    sigma_w: jax.Array  # [G]
    sigma_v: jax.Array  # [G, K]
    # row-sharded residual caches
    e: jax.Array  # [N] = y - yhat (+ incremental patches)
    t: jax.Array  # [N] = T-terms


def init_vb_params(key: jax.Array, cfg: FMConfig, dtype=jnp.float32):
    D, K, G = cfg.num_attributes, cfg.num_factor, cfg.num_groups
    kw, kv = jax.random.split(key)
    return dict(
        mu_0=jnp.zeros((), dtype),
        sigma_0_dash=jnp.asarray(0.02, dtype),
        mu_w=0.1 * jax.random.normal(kw, (D,), dtype),
        sigma_w_dash=jnp.full((D,), 0.02, dtype),
        mu_v=0.1 * jax.random.normal(kv, (K, D), dtype),
        sigma_v_dash=jnp.full((K, D), 0.02, dtype),
        alpha=jnp.ones((), dtype),
        sigma_0=jnp.ones((), dtype),
        sigma_w=jnp.ones((G,), dtype),
        sigma_v=jnp.ones((G, K), dtype),
    )


# ---------------------------------------------------------------------------
# Core sweep ops (shared with OVBFM): run *inside* shard_map
# ---------------------------------------------------------------------------

def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


def _pvary(x):
    """Type a shard-local constant as varying over the data axis (fori/scan
    carries must type-match their body outputs under shard_map)."""
    return jax.lax.pcast(x, (DATA_AXIS,), to="varying")


from svbfm.ops.segment import take_rows


def _gather(a, idx):
    return take_rows(a, idx)


def vb_w_bin_update(e, t, mu_w, sigma_w_dash, sigma_w, alpha, bin_blocks, row):
    """One conflict-free bin of the linear-term sweep (fm_learn_vb.h:527-574).

    Gather-only: per-column stats are masked row-sums over each degree
    bucket's [C, L] entries; the e/t caches are patched in ONE row-layout
    pass using dense per-column delta tables (zero outside the bin)."""
    D = mu_w.shape[0]
    dmu = jnp.zeros((D,), mu_w.dtype)
    dsig = jnp.zeros((D,), mu_w.dtype)
    for blk in bin_blocks:
        rows, x = blk.rows[0], blk.x[0]  # [C, L] shard-local
        mu_c = _gather(mu_w, blk.cols)
        sig_c = _gather(sigma_w_dash, blk.cols)
        sw_g = _gather(sigma_w, blk.group)
        e_g = _gather(e, rows)
        sxe = _psum((x * e_g).sum(-1))
        sigma_new = 1.0 / (sw_g + alpha * blk.sx2)
        sigma_new = keep_finite(sigma_new, sig_c)
        mu_new = sigma_new * alpha * (sxe + mu_c * blk.sx2)
        mu_new = keep_finite(mu_new, mu_c)
        mu_w = mu_w.at[blk.cols].set(mu_new)
        sigma_w_dash = sigma_w_dash.at[blk.cols].set(sigma_new)
        dmu = dmu.at[blk.cols].set(mu_c - mu_new)
        dsig = dsig.at[blk.cols].set(sigma_new - sig_c)
    # row-layout patch (e += x*(mu_old-mu_new), t += x^2*(sig_new-sig_old));
    # per-position flat gathers from the [2, D] delta table
    dtab = jnp.stack([dmu, dsig], axis=0)  # [2, D]
    for p in range(row.ids.shape[1]):
        d = jnp.take(dtab, row.ids[:, p], axis=-1)  # [2, N]
        xp = row.vals[:, p]
        e = e + xp * d[0]
        t = t + xp * xp * d[1]
    return e, t, mu_w, sigma_w_dash


def _nonfinite(x):
    return jnp.sum(~jnp.isfinite(x), dtype=jnp.int32)


# Budget for per-tile gather temps in padded f32 elements (~1 GB).  Shared
# by the kernel's tiling decisions and VBLearner._needs_row_tiling so the
# two can never drift (tiled sweeps run one sweep per program; see
# _fused_steps).  The value and the (8, 128) padding arithmetic below were
# sized for the earlier accelerator's memory and tile layout; they have not
# been measured on the H100.
VB_TILE_BUDGET = 256 * 1024 * 1024


def _col_tile_count(C: int, L: int, F: int) -> int:
    """Column-tile count used for a [C, L] block's stats gather: the
    [Ct, L, 1+2F] temp is padded to (ceil8(L), ceil128(1+2F))."""
    per_col = (-(-L // 8) * 8) * max(128, -(-(1 + 2 * F) // 128) * 128)
    return max(1, -(-(C * per_col) // VB_TILE_BUDGET))


def _row_tile_count(n_loc: int, CH: int) -> int:
    """Row-tile count for the bin cache patch: [CH, N] gather temps with CH
    padded to sublanes of 8."""
    return max(1, -(-(n_loc * (-(-CH // 8) * 8)) // VB_TILE_BUDGET))


def _exact_tile_len(n_loc: int, rt: int):
    """Smallest tile length nt <= ceil(n_loc/rt) that divides n_loc with a
    lane-aligned (multiple-of-1024) value, or None if none exists.  Searches
    tile counts rt..4*rt, so quantum-padded row counts (any power-of-two
    count up to 16) always succeed."""
    for r in range(rt, min(4 * rt, n_loc) + 1):
        if n_loc % r == 0 and (n_loc // r) % 1024 == 0:
            return n_loc // r
    return None


def _patch_channels(F: int, merge_w: bool) -> int:
    """CH of the channel-stacked patch table [5F(+2), D] built per bin."""
    return 5 * F + (2 if merge_w else 0)


# One fused sweep beyond this many work units (shard-local rows x factor
# blocks — index passes, the dominant cost) is split into per-stage
# programs (w sweep / one per factor block / tail+eval).  Staging caps
# peak device memory at one block's temps.  The threshold was set on the
# earlier accelerator, whose runtime ended long single executions; it has
# not been measured on the H100.
VB_STAGE_UNITS = 2.6e8


# Above this many padded f32 bytes, the per-bin [1+2F, N] stats stack is not
# materialized; tile_stats gathers from e/q/tq separately instead (3 index
# passes per tile instead of 1 — only worth it when the stack costs GBs).
# Sized for the earlier accelerator; not measured on the H100.
VB_STATS_STACK_BYTES = 3 * 1024**3


def _split_stats_gathers(n_loc: int, F: int) -> bool:
    ch_pad = -(-(1 + 2 * F) // 8) * 8
    return ch_pad * n_loc * 4 > VB_STATS_STACK_BYTES


# Above this many PADDED bytes, the [F, N] tz cache (sum_i mu^2 x^2,
# fm_learn_vb.h:354-381) is not carried at all: tz is only consumed in the
# bin patch, where the pre-bin mu is gathered anyway, so the patch
# recomputes it per row tile and folds its dt contribution algebraically
# (tz*sum(x^2 dsig) - sum(x^4 mu^2 dsig) — exact for conflict-free bins
# modulo rounding).  Saves one full [ceil8(F), N] buffer (2.98 GiB at
# N=100M, F=4).  The recompute adds patch work, so this is the memory
# valve for N beyond full-Netflix, not a fast path.  The threshold was
# sized on the earlier accelerator just above the largest carried shape
# that fit there; not measured on the H100.  Module variable so tests can
# lower it.
VB_TZ_CARRY_BYTES = 3_400_000_000


def _drop_tz_carry(n_loc: int, F: int) -> bool:
    return (-(-F // 8) * 8) * n_loc * 4 > VB_TZ_CARRY_BYTES


def vb_v_block_update(e, t, mu_t, sig_t, sv_t, alpha, plan, row,
                      fmask=None, w_state=None, prebuilt=None,
                      next_ptab=None):
    """Coordinate sweep for a *block* of F factors (fm_learn_vb.h:577-644).

    mu_t/sig_t are [D, F] slices of the variational factor tables; sv_t is
    the [D, F] per-attribute prior precision.  All per-entry reads are
    channel-stacked so each bin costs O(1) index passes regardless of F —
    batching factors divides the number of index passes by F.

    Memory discipline: every large array keeps a LARGE minor dimension.
    Row caches live as [F, N]; per-entry reads use per-position flat index
    vectors; the [*, L, CH] gather temps are
    bounded by scanning over column tiles with the statistics reduction
    fused into the tile, so only [F, C] / [F, N] results materialize.

    Semantics: bins sequential (exact Gauss-Seidel over columns), factors
    within the block Jacobi (each factor's stats see the block-entry e;
    e/q patches are still *exact* because the FM score is additive over
    factors).  F=1 reproduces the reference's factor-sequential sweep
    exactly; F=K is the fast mode.

    Row caches per factor: q = sum_i mu x_i, tq = sum_i sig x_i^2,
    tz = sum_i mu^2 x_i^2 (add_main_q, fm_learn_vb.h:354-381).

    With ``w_state = (mu_w, sigma_w_dash, sigma_w)`` the linear-term sweep
    rides along in the same index passes (fast mode only).  Returns the
    updated w_state last when given.

    Pass pipelining across STAGED block programs (the 100M-cliff fix; the
    same trick the OVB epoch uses intra-program, vb_online.py): with
    ``prebuilt`` the q/tq(/tz) caches arrive already built (by the
    PREVIOUS block program's last patch pass) and the build gathers are
    skipped; with ``next_ptab`` ([2F, D] stacked mu'/sigma' of the NEXT
    block) the last bin's patch pass rides 2F extra channels in its
    per-position gathers — gathers cost per index pass, not per channel —
    and emits the next block's caches as an extra trailing return value,
    IN PLACE of this block's dead caches (the fori carry aliases, so peak
    HBM is unchanged).  Valid because q/tq/tz depend only on the next
    block's mu'/sigma', which nothing between the two programs touches
    (this block updates only its own factors; the sweep tail only fixes
    UNOBSERVED columns, which appear in no row gather).  Requires
    ``w_state=None``.
    """
    D, F = mu_t.shape
    ids, x_r = row.ids, row.vals
    nan_v = jnp.zeros((), jnp.int32)
    nan_w = jnp.zeros((), jnp.int32)
    if w_state is not None:
        mu_w, sig_w_dash, sigma_w = w_state
        assert next_ptab is None  # patch channel layout assumes one rider

    n_loc, P_row = ids.shape
    dtype = mu_t.dtype
    # budgets count ceil8/ceil128 padded sizes (see VB_TILE_BUDGET).
    # Tiling only engages beyond ML-1M scale; tiled sweeps run one sweep
    # per program (see _fused_steps)

    # beyond VB_TZ_CARRY_BYTES the tz cache is recomputed inside the patch
    # tiles instead of being carried as a third [F, N] buffer
    carry_tz = not _drop_tz_carry(n_loc, F)

    if prebuilt is not None:
        if carry_tz:
            q, tq, tz = prebuilt
        else:
            (q, tq), tz = prebuilt, None
    else:
        # --- q/tq/tz build as [F, N] (one flat gather per row position) ---
        ptab_t = jnp.concatenate([mu_t.T, sig_t.T], axis=0)  # [2F, D]

        def build_qt(ids_t, x_t):
            # ids_t/x_t [Nt, P] -> q/tq(/tz) [F, Nt]
            nt_ = ids_t.shape[0]
            q = jnp.zeros((F, nt_), dtype)
            tq = jnp.zeros((F, nt_), dtype)
            tz = jnp.zeros((F, nt_), dtype) if carry_tz else None
            for p in range(P_row):
                g = jnp.take(ptab_t, ids_t[:, p], axis=-1)  # [2F, Nt]
                xp = x_t[:, p][None]
                x2p = xp * xp
                mug, sigg = g[:F], g[F:]
                q = q + mug * xp
                tq = tq + sigg * x2p
                if carry_tz:
                    tz = tz + mug * mug * x2p
            return (q, tq, tz) if carry_tz else (q, tq)

        # at huge N the per-position [2F, N] gather temps cost GBs (2x2.98
        # GB at N=100M F=4); bound them with the same pad-free
        # in-place row tiling as the cache patch below
        rtb = _row_tile_count(n_loc, 2 * F)
        ntb = None if rtb == 1 else _exact_tile_len(n_loc, rtb)
        if ntb is None:
            caches = build_qt(ids, x_r)
        else:
            def bbody(i, carry):
                lo = i * ntb
                outs = build_qt(
                    jax.lax.dynamic_slice_in_dim(ids, lo, ntb, 0),
                    jax.lax.dynamic_slice_in_dim(x_r, lo, ntb, 0))
                return tuple(
                    jax.lax.dynamic_update_slice_in_dim(c, o, lo, -1)
                    for c, o in zip(carry, outs))

            # zeros must be typed varying over the data axis to match the
            # body outputs (carry types must agree under shard_map)
            caches = jax.lax.fori_loop(
                0, n_loc // ntb, bbody,
                tuple(_pvary(jnp.zeros((F, n_loc), dtype))
                      for _ in range(3 if carry_tz else 2)))
        if carry_tz:
            q, tq, tz = caches
        else:
            (q, tq), tz = caches, None

    n_bins = len(plan.blocks)
    for bi, bin_blocks in enumerate(plan.blocks):
        mu_old_t, sig_old_t = mu_t, sig_t  # pre-bin snapshots (functional)
        dmu_d = jnp.zeros((D, F), dtype)
        dsig_d = jnp.zeros((D, F), dtype)
        dmu2_d = jnp.zeros((D, F), dtype)
        if w_state is not None:
            wdmu_d = jnp.zeros((D,), dtype)
            wdsig_d = jnp.zeros((D,), dtype)
        split_stats = _split_stats_gathers(n_loc, F)
        # one channel-stacked gather source per bin... unless it would cost
        # GBs (huge N): then gather e/q/tq separately inside the tiles
        eq_t = (None if split_stats
                else jnp.concatenate([e[None], q, tq], axis=0))  # [1+2F, N]
        for blk in bin_blocks:
            C, L = blk.rows[0].shape
            mu_c = take_rows(mu_old_t, blk.cols)  # [C, F]
            sig_c = take_rows(sig_old_t, blk.cols)
            sv_g = take_rows(sv_t, blk.cols)

            def tile_stats(rows_t, x_t, mu_ct, sig_ct):
                # rows_t [Ct, L]; returns per-column stats [Ct, F] (+ sxe)
                ridx = rows_t.reshape(-1)
                if split_stats:
                    e_g = jnp.take(e, ridx).reshape(rows_t.shape)
                    q_g = jnp.take(q, ridx, axis=-1).reshape(
                        F, *rows_t.shape)
                    tq_g = jnp.take(tq, ridx, axis=-1).reshape(
                        F, *rows_t.shape)
                else:
                    g = jnp.take(eq_t, ridx, axis=-1)
                    g = g.reshape(1 + 2 * F, *rows_t.shape)  # [1+2F, Ct, L]
                    e_g = g[0]                        # [Ct, L]
                    q_g = g[1:1 + F]                  # [F, Ct, L]
                    tq_g = g[1 + F:]
                xb = x_t[None]                    # [1, Ct, L]
                mu_b = mu_ct.T[:, :, None]        # [F, Ct, 1]
                sig_b = sig_ct.T[:, :, None]
                h = q_g - xb * mu_b
                h1 = tq_g - xb * xb * sig_b
                vm = (xb * h * (e_g[None] + xb * mu_b * h)).sum(-1)   # [F, Ct]
                vs = (xb * xb * (h * h + h1)).sum(-1)                 # [F, Ct]
                sxe = (x_t * e_g).sum(-1)                             # [Ct]
                return vm.T, vs.T, sxe                                # [Ct, F]x2

            # tile over columns so the [Ct, L, 1+2F] gather temp is
            # bounded (padded: L -> ceil8, channels -> ceil128)
            ct = _col_tile_count(C, L, F)
            if ct == 1:
                v_mean, v_sig, sxe = tile_stats(blk.rows[0], blk.x[0],
                                                mu_c, sig_c)
            else:
                # fori_loop over overlap-clamped column tiles writing into
                # preallocated [C, F] stats buffers: no pad, no reshape —
                # a pad+reshape scan would copy every plan array.
                # The last tile may overlap the previous one; stats are
                # pure functions of pre-bin state, so recomputing a column
                # and rewriting the same value is harmless.  Tiled sweeps
                # run one sweep per program (see _fused_steps).
                Ct = min(C, -(-(-(-C // ct)) // 8) * 8)  # ceil8 tile
                nct = -(-C // Ct)
                rows_a, x_a = blk.rows[0], blk.x[0]
                lo_max = C - Ct

                def cbody(i, acc):
                    vm_a, vs_a, sx_a = acc
                    lo = jnp.minimum(i * Ct, lo_max)
                    vm, vs, sx = tile_stats(
                        jax.lax.dynamic_slice_in_dim(rows_a, lo, Ct, 0),
                        jax.lax.dynamic_slice_in_dim(x_a, lo, Ct, 0),
                        jax.lax.dynamic_slice_in_dim(mu_c, lo, Ct, 0),
                        jax.lax.dynamic_slice_in_dim(sig_c, lo, Ct, 0))
                    return (
                        jax.lax.dynamic_update_slice_in_dim(vm_a, vm, lo, 0),
                        jax.lax.dynamic_update_slice_in_dim(vs_a, vs, lo, 0),
                        jax.lax.dynamic_update_slice_in_dim(sx_a, sx, lo, 0))

                v_mean, v_sig, sxe = jax.lax.fori_loop(
                    0, nct, cbody,
                    (_pvary(jnp.zeros((C, F), dtype)),
                     _pvary(jnp.zeros((C, F), dtype)),
                     _pvary(jnp.zeros((C,), dtype))))
            v_mean = _psum(v_mean)
            v_sig = _psum(v_sig)

            sigma_new = 1.0 / (sv_g + alpha * v_sig)
            # padded lanes are excluded from the nan counters: the fused
            # caller fills them with benign 1.0 tables, but the staged
            # b_stage clamps them to factor K-1, which would double-count
            # that factor's non-finite candidates
            nan_v = nan_v + _nonfinite(
                sigma_new if fmask is None
                else jnp.where(fmask, sigma_new, 1.0))
            sigma_new = keep_finite(sigma_new, sig_c)
            mu_new = sigma_new * alpha * v_mean
            nan_v = nan_v + _nonfinite(
                mu_new if fmask is None else jnp.where(fmask, mu_new, 1.0))
            mu_new = keep_finite(mu_new, mu_c)
            if fmask is not None:  # padded factors: freeze
                mu_new = jnp.where(fmask, mu_new, mu_c)
                sigma_new = jnp.where(fmask, sigma_new, sig_c)
            mu_t = mu_t.at[blk.cols].set(mu_new)
            sig_t = sig_t.at[blk.cols].set(sigma_new)
            dmu_d = dmu_d.at[blk.cols].set(mu_new - mu_c)
            dsig_d = dsig_d.at[blk.cols].set(sigma_new - sig_c)
            dmu2_d = dmu2_d.at[blk.cols].set(mu_new * mu_new - mu_c * mu_c)

            if w_state is not None:
                # linear-term update riding the same stats pass
                # (fm_learn_vb.h:527-574)
                wmu_c = take_rows(mu_w, blk.cols)
                wsig_c = take_rows(sig_w_dash, blk.cols)
                sw_g = take_rows(sigma_w, blk.group)
                sxe = _psum(sxe)
                wsig_cand = 1.0 / (sw_g + alpha * blk.sx2)
                wmu_cand = keep_finite(wsig_cand, wsig_c) * alpha * (
                    sxe + wmu_c * blk.sx2)
                nan_w = nan_w + _nonfinite(wsig_cand) + _nonfinite(wmu_cand)
                wsig_new = keep_finite(wsig_cand, wsig_c)
                wmu_new = keep_finite(wmu_cand, wmu_c)
                mu_w = mu_w.at[blk.cols].set(wmu_new)
                sig_w_dash = sig_w_dash.at[blk.cols].set(wsig_new)
                wdmu_d = wdmu_d.at[blk.cols].set(wmu_c - wmu_new)
                wdsig_d = wdsig_d.at[blk.cols].set(wsig_new - wsig_c)

        # --- row-layout cache patch for the whole bin ---
        # Per-entry old values come from the pre-bin tables; deltas are 0
        # for out-of-bin columns so their terms vanish.  Exact for
        # conflict-free bins (a row has <=1 in-bin entry).  One flat
        # gather per row position from a [CH, D] channel-stacked table.
        parts = [mu_old_t.T, sig_old_t.T, dmu_d.T, dsig_d.T, dmu2_d.T]
        if w_state is not None:
            parts += [wdmu_d[None], wdsig_d[None]]
        # last bin + pipelining: the NEXT block's [2F, D] parameter table
        # rides the same gathers and the patch emits its caches (see
        # docstring), overwriting this block's dead q/tq(/tz) in place
        build_next = next_ptab is not None and bi == n_bins - 1
        if build_next:
            parts.append(next_ptab)
        dtab_t = jnp.concatenate(parts, axis=0)  # [5F(+2)(+2F), D]
        CH = dtab_t.shape[0]
        assert CH == _patch_channels(F, w_state is not None) \
            + (2 * F if build_next else 0)  # trace-time pin

        def patch_tile(ids_t, x_t, *tiles):
            # ids_t/x_t [P, Nt]; caches [F, Nt] / [Nt].  Without the tz
            # carry, tz is recomputed here from the pre-bin mu (gathered
            # anyway) and its dt term folded algebraically after the loop.
            if carry_tz:
                q_t, tq_t, tz_t, e_t, t_t = tiles
            else:
                q_t, tq_t, e_t, t_t = tiles
                tz_acc = jnp.zeros_like(q_t)
                a_acc = jnp.zeros_like(q_t)
                b_acc = jnp.zeros_like(q_t)
            if build_next:
                qn = jnp.zeros_like(q_t)
                tqn = jnp.zeros_like(q_t)
                tzn = jnp.zeros_like(q_t) if carry_tz else None
            for p in range(P_row):
                gg = jnp.take(dtab_t, ids_t[p], axis=-1)  # [CH, Nt]
                xp = x_t[p][None]
                x2p = xp * xp
                mu_e = gg[0 * F:1 * F]
                sig_e = gg[1 * F:2 * F]
                dmu_e = gg[2 * F:3 * F]
                dsig_e = gg[3 * F:4 * F]
                dmu2_e = gg[4 * F:5 * F]
                he = xp * (q_t - xp * mu_e)
                h1e = x2p * (tq_t - x2p * sig_e)
                q_t = q_t + xp * dmu_e
                tq_t = tq_t + x2p * dsig_e
                e_t = e_t - (he * dmu_e).sum(0)
                if carry_tz:
                    h2e = x2p * (tz_t - x2p * mu_e * mu_e)
                    tz_t = tz_t + x2p * dmu2_e
                    t_t = t_t + ((h1e + h2e) * dsig_e
                                 + h1e * dmu2_e).sum(0)
                else:
                    t_t = t_t + (h1e * dsig_e + h1e * dmu2_e).sum(0)
                    tz_acc = tz_acc + x2p * (mu_e * mu_e)
                    a_acc = a_acc + x2p * dsig_e
                    b_acc = b_acc + (x2p * x2p) * (mu_e * mu_e) * dsig_e
                if w_state is not None:
                    e_t = e_t + x_t[p] * gg[5 * F]
                    t_t = t_t + x_t[p] * x_t[p] * gg[5 * F + 1]
                if build_next:
                    mun = gg[5 * F:6 * F]
                    sgn = gg[6 * F:7 * F]
                    qn = qn + mun * xp
                    tqn = tqn + sgn * x2p
                    if carry_tz:
                        tzn = tzn + mun * mun * x2p
            if not carry_tz:
                # sum_p h2e_p dsig_p = tz * sum_p x^2 dsig
                #                      - sum_p x^4 mu^2 dsig, with tz
                # recomputed from the pre-bin mu — exact for conflict-free
                # bins (deltas vanish at all but one position per row)
                t_t = t_t + (tz_acc * a_acc - b_acc).sum(0)
                if build_next:
                    return qn, tqn, e_t, t_t
                return q_t, tq_t, e_t, t_t
            if build_next:
                return qn, tqn, tzn, e_t, t_t
            return q_t, tq_t, tz_t, e_t, t_t

        ids_pn = ids.T  # [P, N] (small sublane pad only)
        x_pn = x_r.T
        base = (q, tq, tz, e, t) if carry_tz else (q, tq, e, t)
        rt = _row_tile_count(n_loc, CH)
        nt_exact = None if rt == 1 else _exact_tile_len(n_loc, rt)
        if rt == 1:
            out = patch_tile(ids_pn, x_pn, *base)
            if carry_tz:
                q, tq, tz, e, t = out
            else:
                q, tq, e, t = out
        elif nt_exact is not None:
            # fori_loop over row tiles, patching the caches IN PLACE via
            # dynamic slices: the while-loop carry aliases across
            # iterations, so peak memory is one tile's temps.  The tile
            # length divides n_loc exactly (datasets above
            # _ROW_QUANTUM_MIN_ROWS rows are quantum-padded at build), so
            # no cache is ever copied: a lax.scan — or any pad+slice —
            # here would materialize full-size copies of every cache
            # (~9 GB at N=100M).
            nt = nt_exact

            def body(i, carry):
                lo = i * nt
                ids_t = jax.lax.dynamic_slice_in_dim(ids_pn, lo, nt, -1)
                x_t = jax.lax.dynamic_slice_in_dim(x_pn, lo, nt, -1)
                tiles = tuple(
                    jax.lax.dynamic_slice_in_dim(c, lo, nt, -1)
                    for c in carry)
                outs = patch_tile(ids_t, x_t, *tiles)
                return tuple(
                    jax.lax.dynamic_update_slice_in_dim(c, o, lo, -1)
                    for c, o in zip(carry, outs))

            out = jax.lax.fori_loop(0, n_loc // nt, body, base)
            if carry_tz:
                q, tq, tz, e, t = out
            else:
                q, tq, e, t = out
        else:
            # no exact divisor (un-quantized row count): padded fallback,
            # pays full-cache pad+slice copies — fine at the small n_loc
            # where this can still occur
            nt = -(-(-(-n_loc // rt)) // 1024) * 1024  # ceil(N/rt) -> x1024
            n_pad = nt * rt
            pad = n_pad - n_loc

            def padN(a):  # pad the row axis (last) to n_pad
                if pad:
                    a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
                return a

            ids_p, x_p = padN(ids_pn), padN(x_pn)

            def body(i, carry):
                lo = i * nt
                ids_t = jax.lax.dynamic_slice_in_dim(ids_p, lo, nt, -1)
                x_t = jax.lax.dynamic_slice_in_dim(x_p, lo, nt, -1)
                tiles = tuple(
                    jax.lax.dynamic_slice_in_dim(c, lo, nt, -1)
                    for c in carry)
                outs = patch_tile(ids_t, x_t, *tiles)
                return tuple(
                    jax.lax.dynamic_update_slice_in_dim(c, o, lo, -1)
                    for c, o in zip(carry, outs))

            carry = jax.lax.fori_loop(
                0, rt, body, tuple(padN(a) for a in base))
            out = tuple(a[..., :n_loc] for a in carry)
            if carry_tz:
                q, tq, tz, e, t = out
            else:
                q, tq, e, t = out
    nans = dict(v=nan_v, w=nan_w)
    if w_state is not None:
        return e, t, mu_t, sig_t, nans, (mu_w, sig_w_dash, sigma_w)
    if next_ptab is not None:
        # q/tq(/tz) now hold the NEXT block's caches (built by the last
        # bin's patch pass, in place of this block's dead ones)
        return e, t, mu_t, sig_t, nans, \
            ((q, tq, tz) if carry_tz else (q, tq))
    return e, t, mu_t, sig_t, nans


def vb_update_all(state: VBState, row: RowData, plan: PlanData, cfg: FMConfig, num_cases: float):
    """One full VB sweep (fm_learn_vb.h:383-501) + free energy.  Runs inside
    shard_map; row/cache arrays are shard-local, parameters replicated."""
    dtype = state.mu_w.dtype
    e, t = state.e, state.t
    alpha = state.alpha
    mu_0, sigma_0_dash = state.mu_0, state.sigma_0_dash
    mu_w, sigma_w_dash = state.mu_w, state.sigma_w_dash
    mu_v, sigma_v_dash = state.mu_v, state.sigma_v_dash
    N = jnp.asarray(num_cases, dtype)

    # --- w0 update (fm_learn_vb.h:504-525) ---
    if cfg.k0:
        sigma_old = sigma_0_dash
        sigma_new = 1.0 / (state.sigma_0 + N * alpha)
        w0_temp = _psum(jnp.sum(e * row.valid)) + N * mu_0
        mu_new = sigma_new * alpha * w0_temp
        e = e + (mu_0 - mu_new)
        t = t + (sigma_new - sigma_old)
        mu_0, sigma_0_dash = mu_new, sigma_new

    # In fast mode (factor_block=0) the linear-term sweep rides inside the
    # first v block's index passes (w joins the bin-level Jacobi group);
    # otherwise (exact mode / K=0) it runs standalone, reference-ordered.
    K = cfg.num_factor
    merge_w = cfg.k1 and cfg.factor_block == 0 and K > 0
    nan_w = jnp.zeros((), jnp.int32)
    nan_v = jnp.zeros((), jnp.int32)

    # --- w sweep (fm_learn_vb.h:390-406) ---
    if cfg.k1 and not merge_w:
        for bin_blocks in plan.blocks:
            e, t, mu_w, sigma_w_dash = vb_w_bin_update(
                e, t, mu_w, sigma_w_dash, state.sigma_w, alpha, bin_blocks, row)

    # --- v sweeps, factor-major (fm_learn_vb.h:409-440) ---
    if K > 0:
        F = cfg.factor_block if cfg.factor_block > 0 else K
        F = min(F, K)
        nb = -(-K // F)
        K_pad = nb * F
        # sigma_v as a dense [D, K] per-attribute prior precision table
        sv_dk = take_rows(state.sigma_v, plan.attr_group)  # [D, K]

        def pad_f(a):  # [K, D] -> [nb, F, D]
            if K_pad != K:
                a = jnp.concatenate(
                    [a, jnp.ones((K_pad - K,) + a.shape[1:], a.dtype)], 0)
            return a.reshape(nb, F, *a.shape[1:])

        fmask = None
        if K_pad != K:
            fmask = (jnp.arange(K_pad).reshape(nb, F) < K)

        w_state = (mu_w, sigma_w_dash, state.sigma_w) if merge_w else None

        def blk_step(carry, xs):
            e, t = carry
            if fmask is None:
                mu_b, sig_b, sv_b = xs
                m = None
            else:
                mu_b, sig_b, sv_b, m = xs
                m = m[None, :]
            out = vb_v_block_update(
                e, t, mu_b.T, sig_b.T, sv_b.T, alpha, plan, row, fmask=m,
                w_state=w_state)
            e, t, mu_bt, sig_bt = out[:4]
            return (e, t), (mu_bt.T, sig_bt.T, out[4]["v"], out[4]["w"])

        xs = (pad_f(mu_v), pad_f(sigma_v_dash),
              pad_f(sv_dk.T))
        if fmask is not None:
            xs = xs + (fmask,)
        if nb == 1:
            # avoid lax.scan for a single block: a scan body closing over
            # the (large, loop-invariant) plan arrays compiles to a while
            # loop that re-materializes them per iteration
            xs0 = jax.tree.map(lambda a: a[0], xs)
            if fmask is None:
                mu_b, sig_b, sv_b = xs0
                m = None
            else:
                mu_b, sig_b, sv_b, m = xs0
                m = m[None, :]
            out = vb_v_block_update(
                e, t, mu_b.T, sig_b.T, sv_b.T, alpha, plan, row, fmask=m,
                w_state=w_state)
            e, t, mu_bt, sig_bt = out[:4]
            nan_v = nan_v + out[4]["v"]
            nan_w = nan_w + out[4]["w"]
            if merge_w:
                mu_w, sigma_w_dash, _sw = out[5]
            mu_vp = mu_bt.T[None]
            sig_vp = sig_bt.T[None]
        else:
            if merge_w:
                # multi-block + merged-w not supported under scan (w would
                # update once per block); run w standalone instead
                for bin_blocks in plan.blocks:
                    e, t, mu_w, sigma_w_dash = vb_w_bin_update(
                        e, t, mu_w, sigma_w_dash, state.sigma_w, alpha,
                        bin_blocks, row)
                w_state = None
            (e, t), (mu_vp, sig_vp, nv_b, nw_b) = jax.lax.scan(
                blk_step, (e, t), xs)
            nan_v = nan_v + nv_b.sum()
            nan_w = nan_w + nw_b.sum()
        mu_v = mu_vp.reshape(K_pad, -1)[:K]
        sigma_v_dash = sig_vp.reshape(K_pad, -1)[:K]

    new_state, fe, nan_alpha = vb_finalize(
        e, t, mu_0, sigma_0_dash, mu_w, sigma_w_dash, mu_v, sigma_v_dash,
        state, row, plan, cfg, N)
    # NaN/Inf revert counters — the reference prints "#nans in ..." per
    # iteration (fm_learn_vb_simultaneous.h:89-118)
    nans = dict(nan_w=nan_w, nan_v=nan_v, nan_alpha=nan_alpha)
    return new_state, fe, nans


def vb_finalize(e, t, mu_0, sigma_0_dash, mu_w, sigma_w_dash, mu_v,
                sigma_v_dash, state, row, plan, cfg, N, psum=None):
    """Sweep tail shared by the fused and staged paths: unobserved-column
    fixups, hyperparameter updates (fm_learn_vb.h:446-498), and free
    energy (:646-681; constant 2*3.14 kept).  ``state`` carries the
    PRE-SWEEP hyperparameters (sigma_w/sigma_v/alpha), exactly what the
    reference's update_all reads.  ``psum`` combines the data-sharded
    residual reduction (defaults to the shard_map psum; the single-device
    windowed learner passes identity)."""
    dtype = mu_w.dtype
    K = cfg.num_factor
    alpha = state.alpha
    _psum = psum if psum is not None else globals()["_psum"]

    if K > 0:
        sv_d = take_rows(state.sigma_v, plan.attr_group).T  # [K, D]
        sigma_v_dash = jnp.where(plan.unobserved[None, :], 1.0 / sv_d, sigma_v_dash)
        mu_v = jnp.where(plan.unobserved[None, :], jnp.zeros((), dtype), mu_v)

    # columns with no occurrences: sigma' = 1/sigma_w(g), mu' = 0
    if cfg.k1:
        sw_d = jnp.take(state.sigma_w, plan.attr_group)
        sigma_w_dash = jnp.where(plan.unobserved, 1.0 / sw_d, sigma_w_dash)
        mu_w = jnp.where(plan.unobserved, jnp.zeros((), dtype), mu_w)

    # --- hyperparameter updates (fm_learn_vb.h:446-498) ---
    alpha_temp = _psum(jnp.sum((e * e + t) * row.valid))
    alpha_cand = N / alpha_temp
    nan_alpha = _nonfinite(alpha_cand)
    alpha = keep_finite(alpha_cand, alpha)
    sigma_0 = 1.0 / (mu_0 * mu_0 + sigma_0_dash)
    w_stat = jax.ops.segment_sum(mu_w * mu_w + sigma_w_dash, plan.attr_group,
                                 num_segments=cfg.num_groups)
    sigma_w = plan.num_attr_per_group / w_stat
    v_stat = jax.ops.segment_sum((mu_v * mu_v + sigma_v_dash).T, plan.attr_group,
                                 num_segments=cfg.num_groups)  # [G, K]
    sigma_v = plan.num_attr_per_group[:, None] / v_stat

    # --- free energy (fm_learn_vb.h:646-681; constant 2*3.14 kept) ---
    fe = -0.5 * alpha * alpha_temp - 0.5 * N * jnp.log(2 * 3.14 / alpha)
    fe += -0.5 * sigma_0 * (mu_0 * mu_0 + sigma_0_dash) + 0.5 * jnp.log(sigma_0_dash * sigma_0) + 0.5
    sw_d = jnp.take(sigma_w, plan.attr_group)
    fe += jnp.sum(-0.5 * sw_d * (mu_w * mu_w + sigma_w_dash)
                  + 0.5 * jnp.log(sigma_w_dash * sw_d) + 0.5)
    sv_d = jnp.take(sigma_v, plan.attr_group, axis=0)  # [D, K]
    fe += jnp.sum(-0.5 * sv_d.T * (mu_v * mu_v + sigma_v_dash)
                  + 0.5 * jnp.log(sigma_v_dash * sv_d.T) + 0.5)

    new_state = VBState(
        mu_0=mu_0, sigma_0_dash=sigma_0_dash, mu_w=mu_w, sigma_w_dash=sigma_w_dash,
        mu_v=mu_v, sigma_v_dash=sigma_v_dash, alpha=alpha, sigma_0=sigma_0,
        sigma_w=sigma_w, sigma_v=sigma_v, e=e, t=t)
    return new_state, fe, nan_alpha


# ---------------------------------------------------------------------------
# Learner driver
# ---------------------------------------------------------------------------

def _state_specs():
    rep, shd = P(), P(DATA_AXIS)
    return VBState(
        mu_0=rep, sigma_0_dash=rep, mu_w=rep, sigma_w_dash=rep, mu_v=rep,
        sigma_v_dash=rep, alpha=rep, sigma_0=rep, sigma_w=rep, sigma_v=rep,
        e=shd, t=shd)


def _row_specs():
    shd = P(DATA_AXIS)
    return RowData(ids=shd, vals=shd, target=shd, valid=shd)




class VBLearner:
    """Batch VBFM trainer over a device mesh."""

    method = "vb"

    def __init__(self, cfg: FMConfig, train: SparseDataset, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None, mesh=None,
                 bins: str = "auto", out_dir: str = ".", write_files: bool = True,
                 num_eval_cases: Optional[int] = None,
                 plan: Optional[SweepPlan] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        n = self.mesh.devices.size
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        assert meta.num_attributes == cfg.num_attributes
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
        # Huge-N protection at the factor_block=0 default: a monolithic
        # fused sweep above VB_STAGE_UNITS (fused work is ~invariant in the
        # blocking — total patch channels ≈ 5K either way) must run the
        # staged per-block path, which requires a factor blocking.
        # Auto-select fb=4 (the best block on the earlier accelerator at
        # Netflix-100M; not measured on the H100); this switches the w
        # sweep from merged fast-mode to the reference's standalone
        # ordering — warn loudly.
        if cfg.factor_block == 0 and cfg.num_factor > 0:
            n_loc = self.train_row.ids.shape[0] // n
            fb = min(4, cfg.num_factor)
            if n_loc * (-(-cfg.num_factor // fb)) > VB_STAGE_UNITS:
                import dataclasses
                print(f"# WARNING: problem size exceeds the safe "
                      f"single-program duration; auto-selecting "
                      f"-factor_block {fb} (staged sweep, exact-ordering "
                      f"w semantics). Pass -factor_block to override.")
                cfg = dataclasses.replace(cfg, factor_block=fb)
                self.cfg = cfg
        # per-iteration eval subsetting + held-back remainder (rmse_test2_*)
        # — fm_learn_vb_simultaneous.h:220-232 (see MCMCLearner.__init__)
        self._rest_valid = None
        self._eval_n = self.test_n
        if num_eval_cases is not None and 0 < num_eval_cases < self.test_n:
            from svbfm.parallel.mesh import shard_rows
            idx = np.arange(self.test_row.ids.shape[0])
            self.test_row = self.test_row.replace(valid=shard_rows(
                self.mesh, (idx < num_eval_cases).astype(np.float32)))
            self._rest_valid = shard_rows(self.mesh, (
                (idx >= num_eval_cases) & (idx < self.test_n)
            ).astype(np.float32))
            self._eval_n = int(num_eval_cases)
        self.plan_data = build_plan_data(self.mesh, self.plan, meta)
        self.train_target_np = np.asarray(train.target[: train.num_rows])
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        # Regression sweeps never read the train targets on device (only
        # the classification probit resampling does, vb.py:852): keep them
        # host-side and hand the programs a zero-length placeholder.  At
        # 100M rows the resident [N] target is 0.4 GB of device memory;
        # init_state rebuilds e from the host copy.
        self._device_train_target = cfg.task != TASK_REGRESSION
        if not self._device_train_target:
            from jax.sharding import NamedSharding
            self.train_row = self.train_row.replace(target=jax.device_put(
                np.zeros(0, np.float32),
                NamedSharding(self.mesh, P(DATA_AXIS))))
        self.out_dir = out_dir
        self.write_files = write_files
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        num_cases = float(self.train_n)

        def step_fn(state, row, plan):
            state, fe, _nans = vb_update_all(state, row, plan, cfg, num_cases)
            return state, fe

        self._step = jax.jit(jax.shard_map(
            step_fn, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs(), plan_specs_for(self.plan_data)),
            out_specs=(_state_specs(), P()),
        ))

        # chunk the factor axis of the forward passes so [chunk, N] gather
        # temps stay bounded (~64M elements) at very large N
        n_rows = self.train_row.ids.shape[0]
        fc = None
        if cfg.num_factor > 0 and n_rows * cfg.num_factor > 64 * 1024 * 1024:
            fc = max(1, (64 * 1024 * 1024) // n_rows)
            while fc > 1 and cfg.num_factor % fc != 0:
                fc -= 1

        def scores_fn(params, ids, vals):
            mu_0, mu_w, mu_v = params
            return fm_scores(mu_0, mu_w, mu_v, ids, vals, k0=cfg.k0,
                             k1=cfg.k1, factor_chunk=fc)

        self._scores = jax.jit(scores_fn)

        def t_fn(params, ids, vals):
            s0, sw, mv, sv = params
            return fm_t_terms(s0, sw, mv, sv, ids, vals, k0=cfg.k0,
                              k1=cfg.k1, factor_chunk=fc)

        self._tterms = jax.jit(t_fn)
        self._fused_cache = {}

    def _iter_body(self, state, row, plan, trow, rest=None):
        """One sweep + in-program test eval (and classification resampling).
        Runs inside shard_map; returns (state, per-iteration metrics).
        ``rest`` is the held-back test mask when num_eval_cases < test rows
        (fm_learn_vb_simultaneous.h:227-232)."""
        cfg = self.cfg
        state, fe, nans = vb_update_all(state, row, plan, cfg,
                                        float(self.train_n))
        return self._eval_and_resample(state, fe, nans, row, trow, rest)

    def _eval_and_resample(self, state, fe, nans, row, trow, rest=None):
        """In-program test eval + classification e-resampling (the tail of
        _iter_body, shared with the staged huge-N path)."""
        cfg = self.cfg
        scores = fm_scores(state.mu_0, state.mu_w, state.mu_v,
                           trow.ids, trow.vals, k0=cfg.k0, k1=cfg.k1)
        nt = jnp.asarray(float(self._eval_n), scores.dtype)
        if cfg.task == TASK_REGRESSION:
            p = jnp.clip(scores, cfg.min_target, cfg.max_target)
            err = (p - trow.target) * trow.valid
            rmse = jnp.sqrt(_psum(jnp.sum(err * err)) / nt)
            mae = _psum(jnp.sum(jnp.abs(err))) / nt
            e_c = jnp.clip(state.e, cfg.min_target, cfg.max_target)
            train_rmse = jnp.sqrt(
                _psum(jnp.sum(e_c * e_c * row.valid))
                / jnp.asarray(float(self.train_n), scores.dtype))
            metrics = dict(free_energy=fe, rmse=rmse, mae=mae,
                           train_rmse=train_rmse, alpha=state.alpha,
                           sigma_w=state.sigma_w, sigma_v=state.sigma_v,
                           **nans)
            if rest is not None:
                n2 = jnp.asarray(float(self.test_n - self._eval_n),
                                 scores.dtype)
                e2 = (p - trow.target) * rest
                metrics["rmse_test2_this"] = jnp.sqrt(
                    _psum(jnp.sum(e2 * e2)) / n2)
        else:
            prob = ref_cdf_gaussian(scores)
            yt = trow.target
            hit = (((prob >= 0.5) & (yt > 0)) | ((prob < 0.5) & (yt < 0)))
            acc = _psum(jnp.sum(hit * trow.valid)) / nt
            m = (yt + 1.0) * 0.5
            pll = jnp.clip(prob, 0.01, 0.99)
            ll = -_psum(jnp.sum(
                (m * jnp.log10(pll) + (1 - m) * jnp.log10(1 - pll))
                * trow.valid)) / nt
            metrics = dict(free_energy=fe, accuracy=acc, loglik=ll,
                           alpha=state.alpha, sigma_w=state.sigma_w,
                           sigma_v=state.sigma_v, **nans)
            # probit e-resampling (fm_learn_vb_simultaneous.h:172-200)
            e = state.e
            sampled = jnp.where(row.target >= 0, truncnorm_mean_positive(e),
                                truncnorm_mean_negative(e))
            state = state.replace(e=sampled - e)
        return state, metrics

    def _fused_steps(self, chunk: int):
        """One compiled program running `chunk` sweeps, each followed by
        in-program test evaluation — outputs only the [chunk]-long metric
        arrays plus the final state, so host<->device traffic is O(1) per
        chunk instead of O(state) per iteration."""
        if chunk in self._fused_cache:
            return self._fused_cache[chunk]

        has_rest = self._rest_valid is not None

        def multi(state, row, plan, trow, *rest):
            rest = rest[0] if has_rest else None
            if chunk == 1:
                # direct call: the earlier accelerator's compiler
                # miscompiled the sweep's internal tile loops (large-N
                # memory bounding) nested inside this iteration scan, so
                # tiled sweeps run with chunk=1 (chip_smoke.py phase 5
                # compares the two schedules on the GPU)
                state, metrics = self._iter_body(state, row, plan, trow,
                                                 rest=rest)
                return state, jax.tree.map(lambda a: a[None], metrics)

            def body(st, _):
                return self._iter_body(st, row, plan, trow, rest=rest)

            return jax.lax.scan(body, state, None, length=chunk)

        # donate the state: e/t ([N] row caches) update in place instead of
        # holding old+new copies across the call (0.8 GB at N=100M).  On
        # CPU donation is a no-op (JAX warns and keeps the copy).
        fn = jax.jit(jax.shard_map(
            multi, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs(), plan_specs_for(self.plan_data),
                      _row_specs(), *((P(DATA_AXIS),) if has_rest else ())),
            out_specs=(_state_specs(), P()),
        ), donate_argnums=(0,))
        self._fused_cache[chunk] = fn
        return fn

    # ---- staged huge-N path ----------------------------------------------

    def _stage_layout(self):
        """(F, nb) of the staged factor blocking (requires factor_block>=1)."""
        K = self.cfg.num_factor
        F = min(max(self.cfg.factor_block, 1), K) if K else 0
        nb = -(-K // F) if K else 0
        return F, nb

    def _staged_mode(self) -> bool:
        """True when one fused sweep would exceed the safe single-execution
        duration (see VB_STAGE_UNITS) and the sweep is splittable."""
        import os
        ov = os.environ.get("SVBFM_VB_STAGED")
        cfg = self.cfg
        if ov == "0":
            return False
        if cfg.num_factor <= 0 or cfg.factor_block < 1:
            # unsplittable: the staged path requires a factor blocking
            # (factor_block=0 fast-mode numerics — merged w sweep — have
            # no staged equivalent).  Forcing it anyway would silently run
            # exact-ordering semantics; refuse loudly instead.
            if ov == "1":
                raise ValueError(
                    "SVBFM_VB_STAGED=1 requires num_factor > 0 and "
                    "factor_block >= 1 (the staged path splits the sweep "
                    "by factor block); pass -factor_block")
            return False
        if ov == "1":
            return True
        _F, nb = self._stage_layout()
        n_loc = self.train_row.ids.shape[0] // self.mesh.devices.size
        return n_loc * nb > VB_STAGE_UNITS

    def _staged_programs(self):
        """Three donated shard_map programs splitting one sweep iteration:
        W (w0 + linear-term sweep), B (one factor block, block index as a
        traced scalar — ONE compile for all blocks), C (fixups + hypers +
        free energy + eval + resampling).  Semantics identical to the
        fused path at factor_block>=1 (CPU equivalence test)."""
        if getattr(self, "_staged_cache", None) is not None:
            return self._staged_cache
        cfg = self.cfg
        K = cfg.num_factor
        F, _nb = self._stage_layout()
        num_cases = float(self.train_n)
        has_rest = self._rest_valid is not None

        def w_stage(state, row, plan):
            dtype = state.mu_w.dtype
            e, t = state.e, state.t
            alpha = state.alpha
            mu_0, s0d = state.mu_0, state.sigma_0_dash
            mu_w, swd = state.mu_w, state.sigma_w_dash
            N = jnp.asarray(num_cases, dtype)
            if cfg.k0:  # fm_learn_vb.h:504-525
                sigma_new = 1.0 / (state.sigma_0 + N * alpha)
                w0_temp = _psum(jnp.sum(e * row.valid)) + N * mu_0
                mu_new = sigma_new * alpha * w0_temp
                e = e + (mu_0 - mu_new)
                t = t + (sigma_new - s0d)
                mu_0, s0d = mu_new, sigma_new
            if cfg.k1:  # fm_learn_vb.h:390-406
                for bin_blocks in plan.blocks:
                    e, t, mu_w, swd = vb_w_bin_update(
                        e, t, mu_w, swd, state.sigma_w, alpha, bin_blocks,
                        row)
            return state.replace(e=e, t=t, mu_0=mu_0, sigma_0_dash=s0d,
                                 mu_w=mu_w, sigma_w_dash=swd)

        _F2, nb = self._stage_layout()
        n_loc = self.train_row.ids.shape[0] // self.mesh.devices.size
        # Pass pipelining across block programs: each block's last patch
        # pass also builds the NEXT block's q/tq(/tz) caches, so warm
        # block programs skip their build gathers.  OPT-IN
        # (SVBFM_VB_PIPE=1): it lost on the earlier accelerator at
        # Netflix-100M fb=4, where the +2F channels widened the last bin's
        # padded patch gather; not measured on the H100.  Kept
        # (exactness pinned by tests) for shapes where the balance may
        # differ.  nb == 1 has no cross-block pipelining.
        import os as _os
        pipelined = (nb > 1 and K > 0
                     and _os.environ.get("SVBFM_VB_PIPE") == "1")
        ctz = not _drop_tz_carry(n_loc, F)
        self._stage_pipelined = pipelined

        def b_stage_core(state, b, row, plan, prebuilt):
            idx = b * F + jnp.arange(F)
            fmask = (idx < K)[None, :]
            idxc = jnp.minimum(idx, K - 1)
            mu_b = take_rows(state.mu_v, idxc)  # [F, D]
            sig_b = take_rows(state.sigma_v_dash, idxc)
            sv_dk = take_rows(state.sigma_v, plan.attr_group)  # [D, K]
            sv_b = jnp.take(sv_dk, idxc, axis=1)  # [D, F]
            nptab = None
            if pipelined:
                # next block's parameter table ([2F, D]); for the final
                # block this wraps to block 0 of the NEXT sweep — valid
                # because state.mu_v already holds block 0's update from
                # this sweep, and nothing between the programs (tail
                # fixups touch only unobserved columns; the W stage only
                # mu_w) changes the gathered values
                bn = jnp.where(b + 1 < nb, b + 1, 0)
                idxn = jnp.minimum(bn * F + jnp.arange(F), K - 1)
                mu_n = take_rows(state.mu_v, idxn)  # [F, D]
                sig_n = take_rows(state.sigma_v_dash, idxn)
                nptab = jnp.concatenate([mu_n, sig_n], axis=0)  # [2F, D]
            out = vb_v_block_update(
                state.e, state.t, mu_b.T, sig_b.T, sv_b, state.alpha, plan,
                row, fmask=fmask, prebuilt=prebuilt, next_ptab=nptab)
            e, t, mu_bt, sig_bt = out[:4]
            # out-of-range lanes (K % F != 0 tail) are DROPPED — their
            # frozen values must not race the in-range K-1 lane's update
            mu_v = state.mu_v.at[idx].set(mu_bt.T, mode="drop")
            sig_v = state.sigma_v_dash.at[idx].set(sig_bt.T, mode="drop")
            st = state.replace(e=e, t=t, mu_v=mu_v, sigma_v_dash=sig_v)
            caches = out[5] if pipelined else None
            return st, out[4]["v"], caches

        def b_stage(state, b, row, plan):
            st, nv, _caches = b_stage_core(state, b, row, plan, None)
            return st, nv

        def b_stage_cold(state, b, row, plan):
            st, nv, caches = b_stage_core(state, b, row, plan, None)
            return st, nv, caches

        def b_stage_warm(state, b, caches, row, plan):
            st, nv, caches = b_stage_core(state, b, row, plan, caches)
            return st, nv, caches

        def c_stage(state, nan_v, row, plan, trow, *rest):
            rest_m = rest[0] if has_rest else None
            N = jnp.asarray(num_cases, state.mu_w.dtype)
            new_state, fe, nan_alpha = vb_finalize(
                state.e, state.t, state.mu_0, state.sigma_0_dash,
                state.mu_w, state.sigma_w_dash, state.mu_v,
                state.sigma_v_dash, state, row, plan, cfg, N)
            nans = dict(nan_w=jnp.zeros((), jnp.int32), nan_v=nan_v,
                        nan_alpha=nan_alpha)
            st, metrics = self._eval_and_resample(new_state, fe, nans, row,
                                                  trow, rest_m)
            return st, jax.tree.map(lambda a: a[None], metrics)

        sspec, rspec = _state_specs(), _row_specs()
        pspec = plan_specs_for(self.plan_data)
        mesh = self.mesh
        fnW = jax.jit(jax.shard_map(
            w_stage, mesh=mesh, in_specs=(sspec, rspec, pspec),
            out_specs=sspec), donate_argnums=(0,)) \
            if (cfg.k0 or cfg.k1) else None
        if pipelined:
            cspec = (P(None, DATA_AXIS),) * (3 if ctz else 2)
            fnBs = (
                jax.jit(jax.shard_map(
                    b_stage_cold, mesh=mesh,
                    in_specs=(sspec, P(), rspec, pspec),
                    out_specs=(sspec, P(), cspec)), donate_argnums=(0,)),
                jax.jit(jax.shard_map(
                    b_stage_warm, mesh=mesh,
                    in_specs=(sspec, P(), cspec, rspec, pspec),
                    out_specs=(sspec, P(), cspec)), donate_argnums=(0, 2)),
            )
        else:
            fnBs = (jax.jit(jax.shard_map(
                b_stage, mesh=mesh, in_specs=(sspec, P(), rspec, pspec),
                out_specs=(sspec, P())), donate_argnums=(0,)),)
        fnC = jax.jit(jax.shard_map(
            c_stage, mesh=mesh,
            in_specs=(sspec, P(), rspec, pspec, rspec,
                      *((P(DATA_AXIS),) if has_rest else ())),
            out_specs=(sspec, P())), donate_argnums=(0,))
        self._staged_cache = (fnW, fnBs, fnC)
        return self._staged_cache

    def _staged_iteration(self, state):
        """Dispatch one sweep as W + nb block programs + tail; returns
        (state, metrics) with metrics shaped [1] like a chunk=1 fused
        call.  All calls are async; nothing here blocks.  In pipelined
        mode each block program's last patch pass pre-builds the next
        block's caches (held in self._vcache ACROSS iterations: block
        nb-1 builds next sweep's block-0 caches); only the very first
        block call of a run pays its own build."""
        fnW, fnBs, fnC = self._staged_programs()
        _F, nb = self._stage_layout()
        if fnW is not None:
            state = fnW(state, self.train_row, self.plan_data)
        nan_v = None
        for b in range(nb):
            bj = jnp.asarray(b, jnp.int32)
            if not self._stage_pipelined:
                state, nv = fnBs[0](state, bj, self.train_row,
                                    self.plan_data)
            elif self._vcache is None:
                state, nv, self._vcache = fnBs[0](
                    state, bj, self.train_row, self.plan_data)
            else:
                state, nv, self._vcache = fnBs[1](
                    state, bj, self._vcache, self.train_row,
                    self.plan_data)
            nan_v = nv if nan_v is None else nan_v + nv
        if nan_v is None:
            nan_v = jnp.zeros((), jnp.int32)
        # SVBFM_VB_PIPE_WRAP=0: drop the block-(nb-1) -> next-sweep-block-0
        # cache carry, freeing the ~9 GiB [F, N] caches during the W/C
        # stages (block 0 then cold-builds each sweep — still saves
        # (nb-1)/nb of the build passes).  The memory fallback if the
        # wrapped carry tips the W stage over HBM at huge N.
        import os as _os
        if self._stage_pipelined and \
                _os.environ.get("SVBFM_VB_PIPE_WRAP") == "0":
            self._vcache = None
        rest = (() if self._rest_valid is None else (self._rest_valid,))
        return fnC(state, nan_v, self.train_row, self.plan_data,
                   self.test_row, *rest)

    def _init_target(self, lo: int, hi: int):
        """[lo:hi) slice of the quantum-padded train targets, from the
        device copy when it exists (classification) or the host copy
        (regression — the device placeholder is zero-length)."""
        if self._device_train_target:
            return self.train_row.target[lo:hi]
        y = self.train_target_np
        out = np.zeros(hi - lo, np.float32)
        if lo < y.shape[0]:
            seg = y[lo:min(hi, y.shape[0])]
            out[: seg.shape[0]] = seg
        return out

    def init_state(self, key: Optional[jax.Array] = None) -> VBState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        p = init_vb_params(key, cfg)
        ids, vals = self.train_row.ids, self.train_row.vals
        n_rows = ids.shape[0]
        # at huge single-chip N, one full-N forward/T-term pass stacks
        # multi-GB gather temps on top of the resident row+plan arrays;
        # compute the init caches in bounded row slices instead (init runs
        # once — a python loop is fine).  Multi-device meshes keep the
        # one-shot path: row slicing would reshard across devices.
        row_chunk = 16 * 1024 * 1024
        if self.mesh.devices.size == 1 and n_rows > row_chunk:
            parts_e, parts_t = [], []
            sc = (p["mu_0"], p["mu_w"], p["mu_v"])
            tc = (p["sigma_0_dash"], p["sigma_w_dash"], p["mu_v"],
                  p["sigma_v_dash"])
            for lo in range(0, n_rows, row_chunk):
                hi = min(lo + row_chunk, n_rows)
                parts_e.append(self._init_target(lo, hi)
                               - self._scores(sc, ids[lo:hi], vals[lo:hi]))
                parts_t.append(self._tterms(tc, ids[lo:hi], vals[lo:hi]))
                jax.block_until_ready(parts_t[-1])  # bound in-flight temps
            e = jnp.concatenate(parts_e)
            t = jnp.concatenate(parts_t)
        else:
            yhat = self._scores((p["mu_0"], p["mu_w"], p["mu_v"]), ids, vals)
            # e = y - yhat (VB sign)
            e = self._init_target(0, n_rows) - yhat
            t = self._tterms((p["sigma_0_dash"], p["sigma_w_dash"],
                              p["mu_v"], p["sigma_v_dash"]), ids, vals)
        state = VBState(e=e, t=t, **p)
        # place with the exact shardings the jitted step emits, so the first
        # step call doesn't trigger a second (input-sharding) compilation
        from jax.sharding import NamedSharding
        shardings = jax.tree.map(lambda spec: NamedSharding(self.mesh, spec),
                                 _state_specs())
        return jax.device_put(state, shardings)

    def predict_test_scores(self, state: VBState) -> np.ndarray:
        s = self._scores((state.mu_0, state.mu_w, state.mu_v),
                         self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]

    def _needs_row_tiling(self) -> bool:
        """True iff vb_v_block_update's internal tiling (rt/ct > 1) engages
        for this problem, in which case the sweep contains internal lax.scan
        tiling and must run one iteration per program.  Uses the SAME
        _col_tile_count/_row_tile_count/_patch_channels helpers as the
        kernel, so the predicate cannot drift from the tiling decisions."""
        cfg = self.cfg
        K = cfg.num_factor
        F = max(1, min(cfg.factor_block, K) if cfg.factor_block > 0 else K)
        merge_w = cfg.k1 and cfg.factor_block == 0 and K > 0
        n_loc = self.train_row.ids.shape[0] // self.mesh.devices.size
        if _row_tile_count(n_loc, _patch_channels(F, merge_w)) > 1:
            return True
        for bin_blocks in self.plan.blocks:
            for blk in bin_blocks:
                C, L = blk.rows.shape[1:]
                if _col_tile_count(C, L, F) > 1:
                    return True
        return False

    def _place(self, state: VBState) -> VBState:
        """device_put a (possibly host/numpy) state with step shardings."""
        from jax.sharding import NamedSharding
        shardings = jax.tree.map(lambda spec: NamedSharding(self.mesh, spec),
                                 _state_specs())
        return jax.device_put(state, shardings)

    def run(self, state: Optional[VBState] = None, num_iter: Optional[int] = None,
            verbose: bool = True, chunk: Optional[int] = None,
            ckpt=None, ckpt_every: int = 10, donate: bool = True):
        """Train for ``num_iter`` sweeps; per-iteration test metrics are
        computed on-device inside fused multi-iteration programs (``chunk``
        sweeps per XLA invocation; default: whole run if <= 25, else 10).
        Pass a :class:`svbfm.utils.checkpoint.CheckpointManager` as
        ``ckpt`` to checkpoint every ``ckpt_every`` iterations and resume
        from the latest checkpoint if one exists.

        With ``donate=True`` (default) the passed ``state``'s device
        buffers are DONATED to the fused programs (they alias in place —
        the e/t caches alone are ~0.8 GB at 100M rows): treat it as
        consumed, like any donated JAX array, and continue from the
        returned state.  (On the CPU test backend donation is a no-op, so
        misuse only surfaces on the GPU.)  Library callers that want to reuse
        the passed state (e.g. rerun from the same init) should pass
        ``donate=False``, which copies it once up front."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        elif donate is False:
            # one-time defensive copy so the caller's buffers survive the
            # donated program calls
            state = self._place(jax.tree.map(jnp.array, state))
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        staged = self._staged_mode()
        # pipelined block caches are only valid against the state they were
        # built from; a fresh run (arbitrary state) must cold-build once
        self._vcache = None
        if chunk is None:
            # fixed default chunk => one compiled program shape across runs.
            # Large problems whose sweeps engage internal memory tiling must
            # run one iteration per program (see _fused_steps).
            chunk = 1 if self._needs_row_tiling() else min(10, num_iter)
        if staged:
            chunk = 1  # one sweep = W + nb block programs + tail
        it = 0
        done = 0
        if ckpt is not None:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                state, it, _meta = restored
                state = self._place(state)
                done = it
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                                   self.write_files and done == 0)
        fe_file = TrajectoryFile("free_energy", cfg, self.method, self.out_dir,
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
            # pipeline mode: the interval between flush completions covers
            # exactly this chunk's execution (see MCMCLearner.run)
            base = t0 if last_flush_t is None else max(t0, last_flush_t)
            iter_wall = (now - base) / n
            last_flush_t = now
            for j in range(n):
                rec = {"iter": it, "time_learn": iter_wall,
                       "time_pred": time_pred}
                if not self.plan.conflict_free:
                    rec["conflict_free"] = False  # Jacobi-bin approximation
                    # the tz-free patch fold (vb_v_block_update) is exact
                    # only for conflict-free bins; flag the extra
                    # approximation layer when both are active
                    K = cfg.num_factor
                    F = (min(max(cfg.factor_block, 1), K) if
                         cfg.factor_block > 0 else K)
                    n_loc = (self.train_row.ids.shape[0]
                             // self.mesh.devices.size)
                    if K > 0 and _drop_tz_carry(n_loc, F):
                        rec["tz_free_approx"] = True
                # vector metrics ([G]/[G,K] precision traces) stay arrays
                rec.update({k: (float(v[j]) if v[j].ndim == 0 else v[j])
                            for k, v in metrics.items()})
                fe_file.append(-rec["free_energy"])
                if cfg.task == TASK_REGRESSION:
                    rmse_file.append(rec["rmse"])
                    if verbose:
                        print(f"#Iter={it:3d}\tTrain={rec['train_rmse']:.6g}"
                              f"\tTest={rec['rmse']:.6g}")
                        nw, nv = int(rec.get("nan_w", 0)), int(rec.get("nan_v", 0))
                        if nw or nv or int(rec.get("nan_alpha", 0)):
                            print(f"#nans in w: {nw}\t#nans in v: {nv}\t"
                                  f"#nans in alpha: {int(rec['nan_alpha'])}")
                else:
                    rmse_file.append(rec["accuracy"])
                    if verbose:
                        print(f"#Iter={it:3d}\tTest={rec['accuracy']:.6g}"
                              f"\tTest(ll)={rec['loglik']:.6g}")
                from svbfm.utils.rlog_schema import stream_row
                stream_row(self, rec)
                history.append(rec)
                it += 1

        # Pipeline the per-chunk metrics fetch (dispatch chunk k+1, THEN
        # fetch chunk k) unless the host must observe state between chunks
        # for checkpointing.  Biggest win on the chunk=1 tiled path, where
        # every iteration otherwise pays a serial fetch round-trip.
        pipeline = ckpt is None
        pending = None
        try:
            while done < num_iter:
                n = min(chunk, num_iter - done)
                t0 = _time.perf_counter()
                if staged:
                    state, metrics = self._staged_iteration(state)
                else:
                    fn = self._fused_steps(n)
                    rest = (() if self._rest_valid is None
                            else (self._rest_valid,))
                    state, metrics = fn(state, self.train_row,
                                        self.plan_data, self.test_row,
                                        *rest)
                done += n
                if pipeline:
                    if pending is not None:
                        _flush(*pending)
                    pending = (metrics, n, t0)
                else:
                    _flush(metrics, n, t0)
                    if ckpt is not None and (it - last_saved >= ckpt_every
                                             or done >= num_iter):
                        ckpt.save(jax.tree.map(np.asarray, state), it,
                                  {"method": self.method})
                        last_saved = it
        finally:
            # a crash mid-run still flushes the pending chunk's records
            if pending is not None:
                _flush(*pending)
        return state, history

    def _resample_class_targets(self, state: VBState) -> VBState:
        """Probit e-resampling (fm_learn_vb_simultaneous.h:172-200)."""
        e = state.e
        y = self.train_row.target
        mu = e
        sampled = jnp.where(y >= 0, truncnorm_mean_positive(mu), truncnorm_mean_negative(mu))
        return state.replace(e=sampled - e)
