"""Feature-sharded (tensor-parallel) OVBFM over a (data, feature) mesh.

OVBFM is the learner whose D is largest by construction (the paper's KDD
run: D = 1.63M): its natural-parameter tables n_mu_v/n_sig_v [K, D] (plus
the primal mirrors and the per-coordinate Robbins-Monro counters t_wj/
t_vj [D]) replicate per device in :mod:`svbfm.learners.vb_online` —
at 10x the KDD D they wall one chip.  Here every [D]-indexed table shards
over the FEATURE mesh axis (the same layout as ``tp_vb``); rows and the
per-chunk e/t caches shard over DATA:

* chunk statistics (per-column s1/v_mean/v_sig sums over the chunk's
  occurrence lists) are shard-local row sums psum'd over DATA — each
  column lives on exactly one feature shard;
* the natural-gradient interpolation, the primal recovery mu = n_mu /
  n_sig, and the Robbins-Monro counters are purely per-column (local);
* per-row cache patches (e/t/q) are additive over columns, so each
  feature shard computes its columns' contribution and ONE stacked
  [*, N] psum over FEATURE applies the full patch (the FM analogue of
  tensor-parallel matmul partial sums);
* hyperparameter statistics (per-group sums) are local segment sums
  psum'd over FEATURE; alpha's residual sum psums over DATA.

The v sweep stays FACTOR-SEQUENTIAL, exactly like the replicated
learner: online natural-gradient updates are unstable under factor-
Jacobi blocking (see OVBLearner.__init__'s stability note — reproduced
at 1M rows).  Update equations: ``fm_learn_vb_online.h:354-468``
(chunk update), ``:471-627`` (w0/w/v), ``:629-663`` (chunk free
energy, 2*3.14 kept).  Trajectories match the replicated learner to
float tolerance (tests/test_tp_ovb.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from svbfm.data.dataset import SparseDataset, SweepPlan
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    FMConfig,
    RowData,
    TASK_REGRESSION,
    TrajectoryFile,
    build_row_data,
    keep_finite,
    print_nonzero_nans,
)
from svbfm.learners.vb_online import (
    LAMBDA,
    T0_VJ,
    T0_W0,
    T0_WJ,
    _align_chunk_plans,
    _plan_shape_spec,
    init_ovb_state,
    ovb_counter_specs,
    zero_ovb_counters,
)
from svbfm.ops.segment import take_rows
from svbfm.parallel.mesh import DATA_AXIS, FEATURE_AXIS
from svbfm.parallel.tp_vb import tp_scores, tp_t_terms
from svbfm.utils.pytree import pytree_dataclass


def _psum_d(x):
    return jax.lax.psum(x, DATA_AXIS)


def _psum_f(x):
    return jax.lax.psum(x, FEATURE_AXIS)


@pytree_dataclass
class TPOVBState:
    """OVB state with feature-sharded tables: [D_pad] / [K, D_pad] arrays
    sharded on the feature axis, scalars/group hypers replicated."""

    mu_0: jax.Array
    sigma_0_dash: jax.Array
    mu_w: jax.Array  # [D_pad] f-sharded
    sigma_w_dash: jax.Array
    mu_v: jax.Array  # [K, D_pad] f-sharded (last dim)
    sigma_v_dash: jax.Array
    n_mu_0: jax.Array
    n_sig_0: jax.Array
    n_mu_w: jax.Array  # [D_pad]
    n_sig_w: jax.Array
    n_mu_v: jax.Array  # [K, D_pad]
    n_sig_v: jax.Array
    alpha: jax.Array
    sigma_0: jax.Array
    sigma_w: jax.Array  # [G]
    sigma_v: jax.Array  # [G, K]
    t_w0: jax.Array
    t_wj: jax.Array  # [D_pad] f-sharded
    t_vj: jax.Array  # [D_pad]


@pytree_dataclass
class TPChunkBlock:
    """One aligned degree-bucket of one bin, stacked over chunks and
    partitioned by feature shard."""

    rows: jax.Array  # int32 [nb, Sf, Sd, C, L] local row ids
    x: jax.Array  # f32 [nb, Sf, Sd, C, L]
    cols: jax.Array  # int32 [nb, Sf, C] LOCAL ids (pad: D_loc -> dropped)
    group: jax.Array  # int32 [nb, Sf, C]
    cnt: jax.Array  # f32 [nb, Sf, C] chunk entry count
    col_count: jax.Array  # f32 [nb, Sf, C] full-data count
    sx2: jax.Array  # f32 [nb, Sf, C] chunk sum x^2


def _state_specs():
    rep, fsh, vsh = P(), P(FEATURE_AXIS), P(None, FEATURE_AXIS)
    return TPOVBState(
        mu_0=rep, sigma_0_dash=rep, mu_w=fsh, sigma_w_dash=fsh,
        mu_v=vsh, sigma_v_dash=vsh, n_mu_0=rep, n_sig_0=rep, n_mu_w=fsh,
        n_sig_w=fsh, n_mu_v=vsh, n_sig_v=vsh, alpha=rep, sigma_0=rep,
        sigma_w=rep, sigma_v=rep, t_w0=rep, t_wj=fsh, t_vj=fsh)


def _row_specs():
    dsh = P(DATA_AXIS)
    return RowData(ids=dsh, vals=dsh, target=dsh, valid=dsh)


def _chunk_block_specs(blocks):
    bsh = P(None, FEATURE_AXIS, DATA_AXIS)
    bfh = P(None, FEATURE_AXIS)
    return tuple(
        tuple(TPChunkBlock(rows=bsh, x=bsh, cols=bfh, group=bfh, cnt=bfh,
                           col_count=bfh, sx2=bfh) for _ in bin_list)
        for bin_list in blocks)


def _pick_chunk(blocks, ci):
    return tuple(
        tuple(TPChunkBlock(**{f: getattr(blk, f)[ci]
                              for f in ("rows", "x", "cols", "group", "cnt",
                                        "col_count", "sx2")})
              for blk in bin_list)
        for bin_list in blocks)


def tp_ovb_chunk_update(state: TPOVBState, row: RowData, blocks,
                        cfg: FMConfig, n_full: float, n_chunk, attr_group_l,
                        col_valid_l, napg, D_loc: int):
    """Process one chunk with feature-sharded tables (inside shard_map
    over the 2-D mesh).  Mirrors ``ovb_chunk_update`` exactly; see the
    module docstring for the sharding scheme."""
    from svbfm.learners.mcmc import _count_bad

    counters = zero_ovb_counters()
    dtype = state.mu_w.dtype
    K = cfg.num_factor
    G = cfg.num_groups
    Nf = jnp.asarray(n_full, dtype)
    Nc = n_chunk
    alpha = state.alpha
    lo = jax.lax.axis_index(FEATURE_AXIS) * D_loc
    ids, x_r = row.ids, row.vals
    P_row = ids.shape[1]
    rho0 = (T0_W0 + state.t_w0) ** (-LAMBDA)

    # chunk e / T caches from current primal parameters (TP forward)
    yhat = tp_scores(state.mu_0, state.mu_w, state.mu_v, ids, x_r, D_loc,
                     cfg.k0, cfg.k1)
    e = (row.target - yhat) * row.valid
    t = tp_t_terms(state.sigma_0_dash, state.sigma_w_dash, state.mu_v,
                   state.sigma_v_dash, ids, x_r, D_loc,
                   cfg.k0, cfg.k1) * row.valid

    mu_0, sigma_0_dash = state.mu_0, state.sigma_0_dash
    n_mu_0, n_sig_0 = state.n_mu_0, state.n_sig_0
    mu_w, sigma_w_dash = state.mu_w, state.sigma_w_dash
    n_mu_w, n_sig_w = state.n_mu_w, state.n_sig_w
    t_wj, t_vj = state.t_wj, state.t_vj

    # --- w0 (fm_learn_vb_online.h:471-497) ---
    if cfg.k0:
        mu_old_p, sig_old_p = mu_0, sigma_0_dash
        w0_temp = _psum_d(jnp.sum(e)) / Nc + mu_0
        n_sig_0 = (1.0 - rho0) * n_sig_0 + rho0 * (state.sigma_0 + Nf * alpha)
        n_mu_0 = (1.0 - rho0) * n_mu_0 + rho0 * Nf * alpha * w0_temp
        _count_bad(counters, "mu_0_dash", n_mu_0 / n_sig_0)
        _count_bad(counters, "sigma_0_dash", 1.0 / n_sig_0)
        mu_new = keep_finite(n_mu_0 / n_sig_0, mu_old_p)
        sig_new = keep_finite(1.0 / n_sig_0, sig_old_p)
        e = e + (mu_old_p - mu_new) * row.valid
        t = t + (sig_new - sig_old_p) * row.valid
        mu_0, sigma_0_dash = mu_new, sig_new

    def masked_gather_1(tab, p):
        """Per-position gather from a [CH, D_loc] table, zero outside this
        shard's column range."""
        lid = ids[:, p] - lo
        inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
        return jnp.take(tab, jnp.clip(lid, 0, D_loc - 1), axis=-1) * inr, inr

    # --- w sweep (fm_learn_vb_online.h:499-557) ---
    if cfg.k1:
        for bin_blocks in blocks:
            dmu = jnp.zeros((D_loc,), dtype)
            dsig = jnp.zeros((D_loc,), dtype)
            for blk in bin_blocks:
                rows_l, x = blk.rows[0, 0], blk.x[0, 0]  # [C, L] local
                colsl = blk.cols[0]  # [C] local ids (pad: D_loc)
                cnt = blk.cnt[0]
                active = cnt > 0
                cnt1 = jnp.maximum(cnt, 1.0)
                mu_c = take_rows(mu_w, colsl)
                sig_c = take_rows(sigma_w_dash, colsl)
                nmu_c = take_rows(n_mu_w, colsl)
                nsig_c = take_rows(n_sig_w, colsl)
                sw_g = take_rows(state.sigma_w, blk.group[0], mode="clip")
                rho = (T0_WJ + take_rows(t_wj, colsl)) ** (-LAMBDA)
                e_g = take_rows(e, rows_l)
                s1 = _psum_d((x * (e_g + x * mu_c[:, None])).sum(-1)) / cnt1
                msx2 = blk.sx2[0] / cnt1
                nsig_new = (1.0 - rho) * nsig_c + rho * (
                    sw_g + alpha * blk.col_count[0] * msx2)
                nmu_new = (1.0 - rho) * nmu_c \
                    + rho * blk.col_count[0] * alpha * s1
                _count_bad(counters, "mu_w_dash",
                           jnp.where(active, nmu_new / nsig_new, 0.0))
                _count_bad(counters, "sigma_w_dash",
                           jnp.where(active, 1.0 / nsig_new, 0.0))
                mu_new = keep_finite(nmu_new / nsig_new, mu_c)
                sig_new = keep_finite(1.0 / nsig_new, sig_c)
                mu_new = jnp.where(active, mu_new, mu_c)
                sig_new = jnp.where(active, sig_new, sig_c)
                nmu_new = jnp.where(active, nmu_new, nmu_c)
                nsig_new = jnp.where(active, nsig_new, nsig_c)
                mu_w = mu_w.at[colsl].set(mu_new)  # pad -> dropped
                sigma_w_dash = sigma_w_dash.at[colsl].set(sig_new)
                n_mu_w = n_mu_w.at[colsl].set(nmu_new)
                n_sig_w = n_sig_w.at[colsl].set(nsig_new)
                dmu = dmu.at[colsl].set(mu_c - mu_new)
                dsig = dsig.at[colsl].set(sig_new - sig_c)
                t_wj = t_wj.at[colsl].add(jnp.where(active, cnt, 0.0))
            dtab = jnp.stack([dmu, dsig], axis=0)  # [2, D_loc]
            de = jnp.zeros_like(e)
            dt = jnp.zeros_like(t)
            for p in range(P_row):
                g, _inr = masked_gather_1(dtab, p)
                de = de + x_r[:, p] * g[0]
                dt = dt + x_r[:, p] * x_r[:, p] * g[1]
            patch = _psum_f(jnp.stack([de, dt]))
            e = e + patch[0] * row.valid
            t = t + patch[1] * row.valid

    # --- v sweeps, factor-SEQUENTIAL (stability; see module docstring) ---
    mu_v, sigma_v_dash = state.mu_v, state.sigma_v_dash
    n_mu_v, n_sig_v = state.n_mu_v, state.n_sig_v
    vc_nan = [jnp.zeros((), jnp.int32) for _ in range(4)]
    if K > 0:
        sv_kd = take_rows(state.sigma_v, attr_group_l, mode="clip").T
        # ^ [K, D_loc] prior precisions for this shard's columns
        rho_v_d = (T0_VJ + t_vj) ** (-LAMBDA)  # [D_loc]
        for f in range(K):
            mu_d, sig_d = mu_v[f], sigma_v_dash[f]  # [D_loc]
            nmu_d, nsig_d = n_mu_v[f], n_sig_v[f]
            sv_d = sv_kd[f]
            tv_add = jnp.zeros((D_loc,), dtype)
            # flat q/tq/tz [N]: local partials + ONE stacked feature psum
            q = jnp.zeros_like(e)
            tq = jnp.zeros_like(e)
            tz = jnp.zeros_like(e)
            ptab = jnp.stack([mu_d, sig_d], axis=0)
            for p in range(P_row):
                g, inr = masked_gather_1(ptab, p)
                xp = x_r[:, p] * inr
                x2p = xp * xp
                q = q + g[0] * xp
                tq = tq + g[1] * x2p
                tz = tz + g[0] * g[0] * x2p
            stacked = _psum_f(jnp.stack([q, tq, tz], axis=0)) \
                * row.valid[None]
            q, tq, tz = stacked[0], stacked[1], stacked[2]
            for bin_blocks in blocks:
                mu_old, sig_old = mu_d, sig_d
                dmu_v = jnp.zeros((D_loc,), dtype)
                dsig_v = jnp.zeros((D_loc,), dtype)
                dmu2_v = jnp.zeros((D_loc,), dtype)
                stabT = jnp.stack([e, q, tq], axis=0)  # [3, N]
                for blk in bin_blocks:
                    rows_l, x = blk.rows[0, 0], blk.x[0, 0]
                    colsl = blk.cols[0]
                    x2 = x * x
                    cnt = blk.cnt[0]
                    active = cnt > 0
                    cnt1 = jnp.maximum(cnt, 1.0)
                    g = jnp.take(stabT, rows_l.reshape(-1), axis=-1)
                    g = g.reshape(3, *rows_l.shape)
                    e_g, q_g, tq_g = g[0], g[1], g[2]
                    mu_c = take_rows(mu_old, colsl)
                    sig_c = take_rows(sig_old, colsl)
                    nmu_c = take_rows(nmu_d, colsl)
                    nsig_c = take_rows(nsig_d, colsl)
                    sv_g = take_rows(sv_d, colsl)
                    rho = take_rows(rho_v_d, colsl)
                    h = q_g - x * mu_c[:, None]
                    h1 = tq_g - x2 * sig_c[:, None]
                    v_mean = _psum_d(
                        (x * h * (e_g + x * mu_c[:, None] * h)).sum(-1)) / cnt1
                    v_sig = _psum_d((x2 * h * h + x2 * h1).sum(-1)) / cnt1
                    cc = blk.col_count[0]
                    nsig_new = (1.0 - rho) * nsig_c + rho * (
                        sv_g + alpha * cc * v_sig)
                    nmu_new = (1.0 - rho) * nmu_c + rho * cc * alpha * v_mean
                    local: dict = {}
                    _count_bad(local, "mu_v_dash",
                               jnp.where(active, nmu_new / nsig_new, 0.0))
                    _count_bad(local, "sigma_v_dash",
                               jnp.where(active, 1.0 / nsig_new, 0.0))
                    vc_nan = [a + b for a, b in zip(vc_nan, (
                        local["nan_mu_v_dash"], local["inf_mu_v_dash"],
                        local["nan_sigma_v_dash"],
                        local["inf_sigma_v_dash"]))]
                    mu_new = keep_finite(nmu_new / nsig_new, mu_c)
                    sig_new = keep_finite(1.0 / nsig_new, sig_c)
                    mu_new = jnp.where(active, mu_new, mu_c)
                    sig_new = jnp.where(active, sig_new, sig_c)
                    nmu_new = jnp.where(active, nmu_new, nmu_c)
                    nsig_new = jnp.where(active, nsig_new, nsig_c)
                    mu_d = mu_d.at[colsl].set(mu_new)
                    sig_d = sig_d.at[colsl].set(sig_new)
                    nmu_d = nmu_d.at[colsl].set(nmu_new)
                    nsig_d = nsig_d.at[colsl].set(nsig_new)
                    dmu_v = dmu_v.at[colsl].set(mu_new - mu_c)
                    dsig_v = dsig_v.at[colsl].set(sig_new - sig_c)
                    dmu2_v = dmu2_v.at[colsl].set(
                        mu_new * mu_new - mu_c * mu_c)
                    tv_add = tv_add.at[colsl].add(jnp.where(active, cnt, 0.0))
                # bin patch: local contributions, ONE [5, N] feature psum
                dtabT = jnp.stack([mu_old, sig_old, dmu_v, dsig_v, dmu2_v],
                                  axis=0)
                dq = jnp.zeros_like(e)
                dtq = jnp.zeros_like(e)
                dtz = jnp.zeros_like(e)
                de = jnp.zeros_like(e)
                dt = jnp.zeros_like(e)
                for p in range(P_row):
                    g, inr = masked_gather_1(dtabT, p)
                    xp = x_r[:, p] * inr
                    x2p = xp * xp
                    mu_e, sig_e = g[0], g[1]
                    dmu_e, dsig_e, dmu2_e = g[2], g[3], g[4]
                    he = xp * (q - xp * mu_e)
                    h1e = x2p * (tq - x2p * sig_e)
                    h2e = x2p * (tz - x2p * mu_e * mu_e)
                    dq = dq + xp * dmu_e
                    dtq = dtq + x2p * dsig_e
                    dtz = dtz + x2p * dmu2_e
                    de = de + he * dmu_e
                    dt = dt + (h1e + h2e) * dsig_e + h1e * dmu2_e
                patch = _psum_f(jnp.stack([dq, dtq, dtz, de, dt], axis=0))
                q = q + patch[0] * row.valid
                tq = tq + patch[1] * row.valid
                tz = tz + patch[2] * row.valid
                e = e - patch[3] * row.valid
                t = t + patch[4] * row.valid
            mu_v = mu_v.at[f].set(mu_d)
            sigma_v_dash = sigma_v_dash.at[f].set(sig_d)
            n_mu_v = n_mu_v.at[f].set(nmu_d)
            n_sig_v = n_sig_v.at[f].set(nsig_d)
            # t_vj incremented once per chunk (the f==0 pass)
            if f == 0:
                t_vj = t_vj + tv_add

    for k, val in zip(("nan_mu_v_dash", "inf_mu_v_dash",
                       "nan_sigma_v_dash", "inf_sigma_v_dash"), vc_nan):
        counters[k] = counters[k] + val

    # --- hyperparameter smoothing (fm_learn_vb_online.h:410-468): local
    # per-group partials psum'd over FEATURE (pad cols carry group G) ---
    alpha_temp = _psum_d(jnp.sum(e * e + t))
    alpha_cand = (1.0 - rho0) * alpha + rho0 * (Nc / alpha_temp)
    _count_bad(counters, "alpha", alpha_cand)
    alpha_ok = jnp.isfinite(alpha_cand)
    alpha_new = jnp.where(alpha_ok, alpha_cand, alpha)
    sigma_0_cand = ((1.0 - rho0) * state.sigma_0
                    + rho0 * (1.0 / (mu_0 * mu_0 + sigma_0_dash)))
    _count_bad(counters, "sigma_0", sigma_0_cand)
    sigma_0 = jnp.where(alpha_ok, sigma_0_cand, state.sigma_0)
    w_stat = _psum_f(jax.ops.segment_sum(
        jnp.where(col_valid_l, mu_w * mu_w + sigma_w_dash, 0.0),
        attr_group_l, num_segments=G))
    sigma_w_cand = (1.0 - rho0) * state.sigma_w + rho0 * (napg / w_stat)
    _count_bad(counters, "sigma_w", sigma_w_cand)
    sigma_w = jnp.where(alpha_ok, sigma_w_cand, state.sigma_w)
    if K > 0:
        v_stat = _psum_f(jnp.stack(
            [jax.ops.segment_sum(
                jnp.where(col_valid_l,
                          mu_v[k] * mu_v[k] + sigma_v_dash[k], 0.0),
                attr_group_l, num_segments=G) for k in range(K)], axis=1))
    else:
        v_stat = jnp.zeros((G, 0), dtype)
    sigma_v_cand = ((1.0 - rho0) * state.sigma_v
                    + rho0 * (napg[:, None] / v_stat))
    _count_bad(counters, "sigma_v", sigma_v_cand)
    sigma_v = jnp.where(alpha_ok, sigma_v_cand, state.sigma_v)
    t_w0 = state.t_w0 + jnp.where(alpha_ok, 1.0, 0.0)

    # --- chunk free energy (fm_learn_vb_online.h:629-663; 2*3.14 kept) ---
    fe = -0.5 * alpha_new * alpha_temp \
        - 0.5 * Nc * jnp.log(2 * 3.14 / alpha_new)
    fe += (-0.5 * sigma_0 * (mu_0 * mu_0 + sigma_0_dash)
           + 0.5 * jnp.log(sigma_0_dash * sigma_0) + 0.5)
    sw_d = take_rows(sigma_w, attr_group_l, mode="clip")
    fe += _psum_f(jnp.sum(jnp.where(
        col_valid_l, -0.5 * sw_d * (mu_w * mu_w + sigma_w_dash)
        + 0.5 * jnp.log(sigma_w_dash * sw_d) + 0.5, 0.0)))
    sv_td = take_rows(sigma_v, attr_group_l, mode="clip").T  # [K, D_loc]
    fe += _psum_f(jnp.sum(jnp.where(
        col_valid_l[None, :], -0.5 * sv_td * (mu_v * mu_v + sigma_v_dash)
        + 0.5 * jnp.log(sigma_v_dash * sv_td) + 0.5, 0.0)))

    counters = {k: _psum_f(v) if k.endswith(("w_dash", "v_dash"))
                else v for k, v in counters.items()}
    new_state = TPOVBState(
        mu_0=mu_0, sigma_0_dash=sigma_0_dash, mu_w=mu_w,
        sigma_w_dash=sigma_w_dash, mu_v=mu_v, sigma_v_dash=sigma_v_dash,
        n_mu_0=n_mu_0, n_sig_0=n_sig_0, n_mu_w=n_mu_w, n_sig_w=n_sig_w,
        n_mu_v=n_mu_v, n_sig_v=n_sig_v, alpha=alpha_new, sigma_0=sigma_0,
        sigma_w=sigma_w, sigma_v=sigma_v, t_w0=t_w0, t_wj=t_wj, t_vj=t_vj)
    return new_state, fe, dict(counters)


def _tp_partition_chunk_blocks(mesh, blocks_np, D: int, n_chunk_rows: int):
    """Partition the aligned [nb, ...] chunk plan arrays by feature shard
    (host side), with one common C_max per (bin, bucket) over chunks."""
    Sd, Sf = mesh.devices.shape
    D_loc = -(-D // Sf)
    rps = n_chunk_rows // Sd
    bsh = NamedSharding(mesh, P(None, FEATURE_AXIS, DATA_AXIS))
    bfh = NamedSharding(mesh, P(None, FEATURE_AXIS))
    out = []
    for bin_list in blocks_np:
        bucket_list = []
        for b in bin_list:
            nb, Sd_, C, L = b["rows"].shape[0], b["rows"].shape[1], \
                b["rows"].shape[2], b["rows"].shape[3]
            owners = np.minimum(b["cols"] // D_loc, Sf - 1)  # [nb, C]
            is_pad = b["cols"] >= D
            C_tp = 1
            for ci in range(nb):
                cnts = np.bincount(owners[ci][~is_pad[ci]], minlength=Sf)
                C_tp = max(C_tp, int(cnts.max()) if cnts.size else 1)
            rows = np.full((nb, Sf, Sd_, C_tp, L), rps - 1, np.int32)
            x = np.zeros((nb, Sf, Sd_, C_tp, L), np.float32)
            cols = np.full((nb, Sf, C_tp), D_loc, np.int32)
            group = np.zeros((nb, Sf, C_tp), np.int32)
            cnt = np.zeros((nb, Sf, C_tp), np.float32)
            col_count = np.zeros((nb, Sf, C_tp), np.float32)
            sx2 = np.zeros((nb, Sf, C_tp), np.float32)
            for ci in range(nb):
                for s in range(Sf):
                    sel = np.where((owners[ci] == s) & ~is_pad[ci])[0]
                    c = len(sel)
                    if c == 0:
                        continue
                    rows[ci, s, :, :c] = b["rows"][ci][:, sel]
                    x[ci, s, :, :c] = b["x"][ci][:, sel]
                    cols[ci, s, :c] = b["cols"][ci][sel] - s * D_loc
                    group[ci, s, :c] = b["group"][ci][sel]
                    cnt[ci, s, :c] = b["cnt"][ci][sel]
                    col_count[ci, s, :c] = b["col_count"][ci][sel]
                    sx2[ci, s, :c] = b["sx2"][ci][sel]
            bucket_list.append(TPChunkBlock(
                rows=jax.device_put(rows, bsh), x=jax.device_put(x, bsh),
                cols=jax.device_put(cols, bfh),
                group=jax.device_put(group, bfh),
                cnt=jax.device_put(cnt, bfh),
                col_count=jax.device_put(col_count, bfh),
                sx2=jax.device_put(sx2, bfh)))
        out.append(tuple(bucket_list))
    return tuple(out), D_loc


class TPOVBLearner:
    """OVBFM trainer with feature-sharded natural/primal tables over a
    (data, feature) mesh.  Use when D outgrows one device (the KDD
    regime).  In-memory chunked epochs (fixed membership + shuffled
    order, like the replicated learner's default); regression only for
    now.  Trajectories match :class:`~svbfm.learners.vb_online.
    OVBLearner` to float tolerance."""

    method = "vb_online"
    map_eval = None

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh=None, bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True):
        import dataclasses

        from svbfm.parallel.mesh import make_mesh2d
        if cfg.factor_block == 0:
            cfg = dataclasses.replace(cfg, factor_block=1)
        if cfg.factor_block != 1:
            raise ValueError("TP-OVB implements the (stable) "
                             "factor-sequential sweep only")
        if cfg.task != TASK_REGRESSION:
            raise NotImplementedError("TP-OVB supports regression only; "
                                      "use the replicated OVBLearner for "
                                      "classification")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh2d(n_feature=1)
        assert self.mesh.axis_names == (DATA_AXIS, FEATURE_AXIS)
        Sd, Sf = self.mesh.devices.shape
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        D = cfg.num_attributes
        self.train_n = train.num_rows
        self.col_count = train.col_count()

        nb = max(1, min(cfg.num_batches, train.num_rows))
        self.num_chunks = nb
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(train.num_rows)
        n_chunk = max(len(c) for c in np.array_split(perm, nb))
        self._n_chunk = -(-n_chunk // Sd) * Sd

        plans, chunks = [], []
        for rows_idx in np.array_split(perm, nb):
            sub = SparseDataset(
                ids=train.ids[rows_idx], vals=train.vals[rows_idx],
                target=train.target[rows_idx], num_rows=len(rows_idx),
                num_features=D, min_target=train.min_target,
                max_target=train.max_target,
                row_nnz=train.row_nnz[rows_idx])
            pad = self._n_chunk - sub.ids.shape[0]
            if pad > 0:
                sub = SparseDataset(
                    ids=np.pad(sub.ids, ((0, pad), (0, 0))),
                    vals=np.pad(sub.vals, ((0, pad), (0, 0))),
                    target=np.pad(sub.target, (0, pad)),
                    num_rows=sub.num_rows, num_features=D,
                    min_target=sub.min_target, max_target=sub.max_target,
                    row_nnz=np.pad(sub.row_nnz, (0, pad)))
            chunks.append(sub)
            plans.append(SweepPlan.build(
                sub.to_coo(), D, meta_groups=meta.attr_group, bins=bins,
                n_shards=Sd, col_count=self.col_count,
                n_rows_total=self._n_chunk))
        self.chunk_sizes = np.array([c.num_rows for c in chunks], np.int64)
        blocks_np = _align_chunk_plans(plans, D, Sd, _plan_shape_spec(plans))
        self.chunk_blocks, self.D_loc = _tp_partition_chunk_blocks(
            self.mesh, blocks_np, D, self._n_chunk)
        self.D_pad = self.D_loc * Sf

        dsh2 = NamedSharding(self.mesh, P(None, DATA_AXIS))
        valid = np.stack([
            (np.arange(self._n_chunk) < c.num_rows).astype(np.float32)
            for c in chunks])
        self.chunk_row = RowData(
            ids=jax.device_put(np.stack([c.ids for c in chunks]), dsh2),
            vals=jax.device_put(np.stack([c.vals for c in chunks]), dsh2),
            target=jax.device_put(np.stack([c.target for c in chunks]),
                                  dsh2),
            valid=jax.device_put(valid, dsh2))

        def put_row(ds):
            ds = ds.padded_to(Sd)
            v = (np.arange(ds.ids.shape[0]) < ds.num_rows).astype(np.float32)
            dsh = NamedSharding(self.mesh, P(DATA_AXIS))
            return RowData(ids=jax.device_put(ds.ids, dsh),
                           vals=jax.device_put(ds.vals, dsh),
                           target=jax.device_put(ds.target, dsh),
                           valid=jax.device_put(v, dsh)), ds.num_rows

        self.test_row, self.test_n = put_row(test)
        ag = np.full(self.D_pad, meta.num_attr_groups, np.int32)
        ag[:D] = meta.attr_group
        cv = np.zeros(self.D_pad, bool)
        cv[:D] = True
        repf = NamedSharding(self.mesh, P(FEATURE_AXIS))
        self.attr_group_sh = jax.device_put(ag, repf)
        self.col_valid_sh = jax.device_put(cv, repf)
        self.napg = jax.device_put(
            meta.num_attr_per_group.astype(np.float32),
            NamedSharding(self.mesh, P()))
        self.out_dir = out_dir
        self.write_files = write_files
        self.rng = np.random.default_rng(cfg.seed + 1)
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        n_full = float(self.train_n)
        D_loc = self.D_loc
        nt = float(self.test_n)

        def step(state, row, blocks, n_chunk, ag, cv, napg):
            return tp_ovb_chunk_update(state, row, blocks, cfg, n_full,
                                       n_chunk, ag, cv, napg, D_loc)

        bspec = _chunk_block_specs_unstacked(self.chunk_blocks)
        self._step = jax.jit(jax.shard_map(
            step, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs(), bspec, P(),
                      P(FEATURE_AXIS), P(FEATURE_AXIS), P()),
            out_specs=(_state_specs(), P(), ovb_counter_specs())),
            donate_argnums=(0,))

        def ev(state, trow):
            scores = tp_scores(state.mu_0, state.mu_w, state.mu_v,
                               trow.ids, trow.vals, D_loc, cfg.k0, cfg.k1)
            ntf = jnp.asarray(nt, scores.dtype)
            p = jnp.clip(scores, cfg.min_target, cfg.max_target)
            err = (p - trow.target) * trow.valid
            rmse = jnp.sqrt(_psum_d(jnp.sum(err * err)) / ntf)
            mae = _psum_d(jnp.sum(jnp.abs(err))) / ntf
            return rmse, mae

        self._eval = jax.jit(jax.shard_map(
            ev, mesh=self.mesh, in_specs=(_state_specs(), _row_specs()),
            out_specs=(P(), P())))

    def init_state(self, key: Optional[jax.Array] = None) -> TPOVBState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        rep_state = init_ovb_state(key, cfg, self.col_count)

        def padf(a):
            a = np.asarray(a)
            pad = self.D_pad - a.shape[-1]
            if pad <= 0:
                return a
            widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
            # pad naturals' n_sig with 1.0 (division-safe); rest with 0
            return np.pad(a, widths)

        shardings = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                                 _state_specs())
        vals = {}
        for fname in TPOVBState.__dataclass_fields__:
            a = getattr(rep_state, fname)
            if fname in ("mu_w", "sigma_w_dash", "n_mu_w", "n_sig_w",
                         "mu_v", "sigma_v_dash", "n_mu_v", "n_sig_v",
                         "t_wj", "t_vj"):
                a = padf(a)
            vals[fname] = jax.device_put(np.asarray(a),
                                         getattr(shardings, fname))
        return TPOVBState(**vals)

    def run(self, state: Optional[TPOVBState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            chunk=None, ckpt=None, ckpt_every: int = 10):
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir, self.write_files)
        fe_file = TrajectoryFile("free_energy", cfg, self.method,
                                 self.out_dir, self.write_files)
        history = []
        import time as _time
        for it in range(num_iter):
            t0 = _time.perf_counter()
            order = self.rng.permutation(self.num_chunks)
            fes = []
            nans_acc = []
            for ci in order:
                blocks = _pick_chunk(self.chunk_blocks, int(ci))
                row = jax.tree.map(lambda a: a[int(ci)], self.chunk_row)
                state, fe, nans = self._step(
                    state, row, blocks,
                    jnp.asarray(float(self.chunk_sizes[ci]), jnp.float32),
                    self.attr_group_sh, self.col_valid_sh, self.napg)
                fes.append(fe)
                nans_acc.append(nans)
            rmse, mae = self._eval(state, self.test_row)
            fes, rmse, mae, nans_acc = jax.device_get(
                (fes, rmse, mae, nans_acc))
            fes = [float(f) for f in fes]
            fe_file.append(-fes[0])
            fe_file.append(-fes[-1])
            nans = {k: int(sum(d[k] for d in nans_acc))
                    for k in nans_acc[0]} if nans_acc else {}
            rec = {"iter": it, "rmse": float(rmse), "mae": float(mae),
                   "free_energy": fes[-1],
                   "time_learn": _time.perf_counter() - t0,
                   "time_pred": 0.0, **nans}
            rmse_file.append(rec["rmse"])
            if verbose:
                print(f"#Iter={it:3d}\tTest={rec['rmse']:.6g}")
            print_nonzero_nans(rec, verbose)
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, rec, state)
            history.append(rec)
        return state, history

    def predict_test_scores(self, state: TPOVBState) -> np.ndarray:
        fn = jax.jit(jax.shard_map(
            lambda st, ids, vals: tp_scores(st.mu_0, st.mu_w, st.mu_v, ids,
                                            vals, self.D_loc, self.cfg.k0,
                                            self.cfg.k1),
            mesh=self.mesh,
            in_specs=(_state_specs(), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=P(DATA_AXIS)))
        s = fn(state, self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]


def _chunk_block_specs_unstacked(blocks):
    """Specs for ONE chunk's blocks (after _pick_chunk indexing)."""
    bsh = P(FEATURE_AXIS, DATA_AXIS)
    bfh = P(FEATURE_AXIS)
    return tuple(
        tuple(TPChunkBlock(rows=bsh, x=bsh, cols=bfh, group=bfh, cnt=bfh,
                           col_count=bfh, sx2=bfh) for _ in bin_list)
        for bin_list in blocks)
