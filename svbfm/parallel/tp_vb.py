"""Feature-sharded (tensor-parallel) VBFM training over a (data, feature) mesh.

Scales the axis the reference cannot (``fm_learn_vb.h`` keeps every table in
one address space): the variational tables mu'_w/sigma'_w [D] and
mu'_v/sigma'_v [K, D] shard over the ``feature`` mesh axis while rows and the
e/t residual caches shard over ``data``.  Each (data, feature) device updates
ONLY its own feature shard's columns:

* Conflict-free bins partition *within* each feature shard — a column's
  entry lists live with its owner shard, stacked [Sf, Sd, C, L].
* Per-column sufficient statistics are shard-local row sums psum'd over the
  DATA axis only (the column exists on one feature shard).
* The per-row caches q/tq/tz [K, N] and e/t [N] stay replicated across the
  feature axis: their bin patches are additive over columns, so each shard
  computes its columns' contribution and ONE stacked [3K+2, N] psum over the
  FEATURE axis per bin applies the full patch everywhere — the FM analogue
  of tensor-parallel matmul partial sums (cf. ``parallel/tp.py`` scoring).
* Hyperparameter statistics (per-group sums of mu'^2 + sigma') are local
  segment sums psum'd over FEATURE; alpha's residual sum psums over DATA.

Semantics: identical to the replicated fast mode of
:mod:`svbfm.learners.vb` (``factor_block=0``: all K factors Jacobi
within a bin, bins sequential Gauss-Seidel, linear terms riding the same
index passes) — the TP learner's trajectories match the replicated
learner's to float tolerance (tests/test_tp.py).  Reference parity
anchors: update equations ``fm_learn_vb.h:383-644``, hyper updates
``:446-498``, free energy ``:646-681`` (2*3.14 constant kept).
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
    TrajectoryFile,
    keep_finite,
)
from svbfm.learners.vb import _patch_channels, init_vb_params
from svbfm.ops.segment import take_rows
from svbfm.parallel.mesh import DATA_AXIS, FEATURE_AXIS
from svbfm.utils.pytree import pytree_dataclass


def _psum_d(x):
    return jax.lax.psum(x, DATA_AXIS)


def _psum_f(x):
    return jax.lax.psum(x, FEATURE_AXIS)


@pytree_dataclass
class TPVBState:
    """VB state with feature-sharded tables (global views [D_pad] / [K, D_pad]
    sharded on the feature axis; scalars/groups replicated; e/t data-sharded)."""

    mu_0: jax.Array
    sigma_0_dash: jax.Array
    mu_w: jax.Array  # [D_pad] feature-sharded
    sigma_w_dash: jax.Array  # [D_pad]
    mu_v: jax.Array  # [K, D_pad] feature-sharded (last dim)
    sigma_v_dash: jax.Array  # [K, D_pad]
    alpha: jax.Array
    sigma_0: jax.Array
    sigma_w: jax.Array  # [G]
    sigma_v: jax.Array  # [G, K]
    e: jax.Array  # [N] data-sharded
    t: jax.Array  # [N]


@pytree_dataclass
class TPBlock:
    """One degree-bucket of one bin, partitioned by feature shard."""

    rows: jax.Array  # int32 [Sf, Sd, C, L] local row ids
    x: jax.Array  # f32 [Sf, Sd, C, L]
    cols: jax.Array  # int32 [Sf, C] LOCAL column ids (pad: D_loc -> dropped)
    group: jax.Array  # int32 [Sf, C]
    sx2: jax.Array  # f32 [Sf, C]


@pytree_dataclass
class TPPlanData:
    blocks: tuple  # tuple[tuple[TPBlock, ...], ...]
    attr_group: jax.Array  # int32 [Sf, D_loc] (pad: G -> dropped in segsum)
    unobserved: jax.Array  # bool [Sf, D_loc]
    col_valid: jax.Array  # bool [Sf, D_loc] (False for D..D_pad-1 padding)
    num_attr_per_group: jax.Array  # f32 [G]


def _build_tp_plan(mesh, plan: SweepPlan, meta: DataMetaInfo, D: int):
    """Partition a global SweepPlan's bins by feature shard (host side)."""
    Sd, Sf = mesh.devices.shape
    D_loc = -(-D // Sf)
    rps = plan.rows_per_shard
    shd = NamedSharding(mesh, P(FEATURE_AXIS, DATA_AXIS))
    repf = NamedSharding(mesh, P(FEATURE_AXIS))
    rep = NamedSharding(mesh, P())

    blocks = []
    for bin_blocks in plan.blocks:
        bucket_list = []
        for blk in bin_blocks:
            L = blk.rows.shape[2]
            owner = blk.cols // D_loc  # [C]
            counts = np.bincount(owner, minlength=Sf)
            C_max = max(int(counts.max()), 1)
            rows = np.full((Sf, Sd, C_max, L), rps - 1, np.int32)
            x = np.zeros((Sf, Sd, C_max, L), np.float32)
            cols = np.full((Sf, C_max), D_loc, np.int32)  # pad -> dropped
            group = np.zeros((Sf, C_max), np.int32)
            sx2 = np.zeros((Sf, C_max), np.float32)
            for s in range(Sf):
                sel = np.where(owner == s)[0]
                c = len(sel)
                if c == 0:
                    continue
                rows[s, :, :c] = blk.rows[:, sel]
                x[s, :, :c] = blk.x[:, sel]
                cols[s, :c] = blk.cols[sel] - s * D_loc  # local ids
                group[s, :c] = blk.group[sel]
                sx2[s, :c] = blk.sx2[sel]
            bucket_list.append(TPBlock(
                rows=jax.device_put(rows, shd), x=jax.device_put(x, shd),
                cols=jax.device_put(cols, repf),
                group=jax.device_put(group, repf),
                sx2=jax.device_put(sx2, repf)))
        blocks.append(tuple(bucket_list))

    D_pad = D_loc * Sf
    ag = np.full(D_pad, meta.num_attr_groups, np.int32)  # pad -> dropped
    ag[:D] = meta.attr_group
    unob = np.ones(D_pad, bool)
    unob[:D] = plan.unobserved
    valid = np.zeros(D_pad, bool)
    valid[:D] = True
    return TPPlanData(
        blocks=tuple(blocks),
        attr_group=jax.device_put(ag.reshape(Sf, D_loc), repf),
        unobserved=jax.device_put(unob.reshape(Sf, D_loc), repf),
        col_valid=jax.device_put(valid.reshape(Sf, D_loc), repf),
        num_attr_per_group=jax.device_put(
            meta.num_attr_per_group.astype(np.float32), rep),
    ), D_loc


# Per-device capacity left for the TP kernels' one-shot temps after
# data/params.  Sized for the earlier accelerator's smaller devices, of which
# rows+plan+caches typically took about half; not measured on the H100,
# whose 80 GB would hold several times these temps.  Module-level so tests
# can shrink them to trip the guard at small shapes.
TP_STACK_BYTES = 6 * 1024**3
TP_COL_BYTES = 2 * 1024**3


def check_tp_memory_budget(plan_data: TPPlanData, n_loc: int, K: int,
                           learner: str, channels: int | None = None) -> None:
    """Fail LOUDLY when a TP sweep's unbounded temps would need the
    replicated learners' memory tiling (which the TP kernels do not
    implement: their [1+2K, N]/[3K+2, N] channel stacks and per-bin
    [1+2K, C, L] gathers are single-shot).  The thresholds are absolute
    HBM capacity budgets — NOT the 1-GiB tiling trigger the replicated
    kernels use: TP's single-shot temps may legitimately occupy several
    GiB before anything overflows, and gating on the tiling trigger
    rejected workloads that compiled and ran fine.  Raises RuntimeError
    with remedies instead of letting the compile (or the device) blow
    HBM silently."""
    problems = []
    F = max(K, 1)
    ch = channels if channels is not None else _patch_channels(F, True)
    ch_pad = -(-ch // 8) * 8
    if n_loc * ch_pad * 4 > TP_STACK_BYTES:
        problems.append(
            f"row caches: [~{ch}, {n_loc}] per-bin patch stack "
            f"({n_loc * ch_pad * 4 / 2**30:.1f} GiB padded)")
    for bin_blocks in plan_data.blocks:
        for blk in bin_blocks:
            C, L = blk.rows.shape[-2:]
            per_col = (-(-L // 8) * 8) * max(128, -(-(1 + 2 * F) // 128) * 128)
            if C * per_col * 4 > TP_COL_BYTES:
                problems.append(
                    f"column block [{C}, {L}] stats gather "
                    f"({C * per_col * 4 / 2**30:.1f} GiB padded)")
                break
    if problems:
        raise RuntimeError(
            f"{learner}: problem too large for the feature-sharded (TP) "
            f"sweep's untiled temps ({'; '.join(problems)} exceed the "
            "per-device budget). Remedies: shard the data axis more (n_loc "
            f"= {n_loc} rows/device), reduce factor count K={K}, or use "
            "the replicated learner, whose memory-tiled chunk=1 path "
            "handles large N on one device.")


def _plan_specs(plan_data: TPPlanData):
    shd = P(FEATURE_AXIS, DATA_AXIS)
    repf = P(FEATURE_AXIS)
    blocks = tuple(
        tuple(TPBlock(rows=shd, x=shd, cols=repf, group=repf, sx2=repf)
              for _ in bin_blocks)
        for bin_blocks in plan_data.blocks)
    return TPPlanData(blocks=blocks, attr_group=repf, unobserved=repf,
                      col_valid=repf, num_attr_per_group=P())


def _state_specs():
    rep = P()
    fsh = P(FEATURE_AXIS)
    vsh = P(None, FEATURE_AXIS)
    dsh = P(DATA_AXIS)
    return TPVBState(
        mu_0=rep, sigma_0_dash=rep, mu_w=fsh, sigma_w_dash=fsh,
        mu_v=vsh, sigma_v_dash=vsh, alpha=rep, sigma_0=rep,
        sigma_w=rep, sigma_v=rep, e=dsh, t=dsh)


def _row_specs():
    dsh = P(DATA_AXIS)
    return RowData(ids=dsh, vals=dsh, target=dsh, valid=dsh)


def tp_scores(mu_0, mu_w_l, mu_v_l, ids, vals, D_loc, k0, k1):
    """FM mean scores with feature-sharded tables (inside shard_map):
    per-shard partial sums, s_f psum'd over FEATURE before squaring."""
    K = mu_v_l.shape[0]
    N = ids.shape[0]
    dtype = mu_v_l.dtype
    lo = jax.lax.axis_index(FEATURE_AXIS) * D_loc
    acc = jnp.zeros((N,), dtype)
    s = jnp.zeros((K, N), dtype)
    s2 = jnp.zeros((K, N), dtype)
    for p in range(ids.shape[1]):
        lid = ids[:, p] - lo
        inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
        x = vals[:, p] * inr
        if k1:
            acc = acc + jnp.take(mu_w_l, jnp.clip(lid, 0, D_loc - 1)) * x
        if K:
            d = take_rows(mu_v_l.T, jnp.clip(lid, 0, D_loc - 1)).T * x[None]
            s = s + d
            s2 = s2 + d * d
    acc = _psum_f(acc)
    out = acc
    if K:
        s = _psum_f(s)
        s2 = _psum_f(s2)
        out = out + 0.5 * (s * s - s2).sum(0)
    if k0:
        out = out + mu_0
    return out


def tp_t_terms(sigma_0_dash, sig_w_l, mu_v_l, sig_v_l, ids, vals, D_loc,
               k0, k1):
    """VBFM T-terms with feature-sharded tables: the per-factor partials
    q2_f, z_f and the entrywise negative term combine additively over
    shards BEFORE the nonlinear z^2/z*q2 terms (ops/forward.py:fm_t_terms)."""
    K = mu_v_l.shape[0]
    N = ids.shape[0]
    dtype = mu_v_l.dtype
    lo = jax.lax.axis_index(FEATURE_AXIS) * D_loc
    acc = jnp.zeros((N,), dtype)
    q2 = jnp.zeros((K, N), dtype)
    z = jnp.zeros((K, N), dtype)
    neg = jnp.zeros((K, N), dtype)
    for p in range(ids.shape[1]):
        lid = ids[:, p] - lo
        inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
        lidc = jnp.clip(lid, 0, D_loc - 1)
        x = vals[:, p] * inr
        x2 = x * x
        if k1:
            acc = acc + jnp.take(sig_w_l, lidc) * x2
        if K:
            mg = take_rows(mu_v_l.T, lidc).T  # [K, N]
            sg = take_rows(sig_v_l.T, lidc).T
            mx = mg * x[None]
            q2 = q2 + mx * mx
            z = z + sg * x2[None]
            neg = neg + mg * mg * (x2 * x2)[None] * sg \
                + 0.5 * (x2 * x2)[None] * sg * sg
    acc = _psum_f(acc)
    out = acc
    if K:
        q2 = _psum_f(q2)
        z = _psum_f(z)
        neg = _psum_f(neg)
        out = out + (0.5 * z * z + z * q2 - neg).sum(0)
    if k0:
        out = out + sigma_0_dash
    return out


def tp_vb_update_all(state: TPVBState, row: RowData, plan: TPPlanData,
                     cfg: FMConfig, num_cases: float, D_loc: int):
    """One full VB sweep with feature-sharded tables (inside shard_map over
    the 2-D mesh).  Mirrors learners.vb.vb_update_all's fast mode exactly:
    all K factors Jacobi per bin, w riding the same passes, bins sequential."""
    dtype = state.mu_w.dtype
    K = cfg.num_factor
    G = cfg.num_groups
    N = jnp.asarray(num_cases, dtype)
    e, t = state.e, state.t
    alpha = state.alpha
    mu_0, sigma_0_dash = state.mu_0, state.sigma_0_dash
    mu_w_l, sig_w_l = state.mu_w, state.sigma_w_dash  # local [D_loc]
    mu_v_l, sig_v_l = state.mu_v, state.sigma_v_dash  # local [K, D_loc]
    lo = jax.lax.axis_index(FEATURE_AXIS) * D_loc
    ids, x_r = row.ids, row.vals
    P_row = ids.shape[1]
    ag_l = plan.attr_group[0]  # [D_loc]
    valid_l = plan.col_valid[0]

    # --- w0 update (fm_learn_vb.h:504-525) ---
    if cfg.k0:
        sigma_old = sigma_0_dash
        sigma_new = 1.0 / (state.sigma_0 + N * alpha)
        w0_temp = _psum_d(jnp.sum(e * row.valid)) + N * mu_0
        mu_new = sigma_new * alpha * w0_temp
        e = e + (mu_0 - mu_new)
        t = t + (sigma_new - sigma_old)
        mu_0, sigma_0_dash = mu_new, sigma_new

    merge_w = cfg.k1 and K > 0
    if K > 0:
        mu_t = mu_v_l.T  # [D_loc, K]
        sig_t = sig_v_l.T
        sv_t = take_rows(state.sigma_v, ag_l, mode="clip")  # [D_loc, K]

        # q/tq/tz [K, N]: local partials + ONE feature psum
        ptab_t = jnp.concatenate([mu_t.T, sig_t.T], axis=0)  # [2K, D_loc]
        q = jnp.zeros((K, ids.shape[0]), dtype)
        tq = jnp.zeros_like(q)
        tz = jnp.zeros_like(q)
        for p in range(P_row):
            lid = ids[:, p] - lo
            inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
            g = jnp.take(ptab_t, jnp.clip(lid, 0, D_loc - 1), axis=-1) * inr
            xp = (x_r[:, p] * inr)[None]
            x2p = xp * xp
            mug, sigg = g[:K], g[K:]
            q = q + mug * xp
            tq = tq + sigg * x2p
            tz = tz + mug * mug * x2p
        stacked = _psum_f(jnp.concatenate([q, tq, tz], axis=0))
        q, tq, tz = stacked[:K], stacked[K:2 * K], stacked[2 * K:]

        for bin_blocks in plan.blocks:
            mu_old_t, sig_old_t = mu_t, sig_t
            dmu_d = jnp.zeros((D_loc, K), dtype)
            dsig_d = jnp.zeros((D_loc, K), dtype)
            dmu2_d = jnp.zeros((D_loc, K), dtype)
            wdmu_d = jnp.zeros((D_loc,), dtype)
            wdsig_d = jnp.zeros((D_loc,), dtype)
            eq_t = jnp.concatenate([e[None], q, tq], axis=0)  # [1+2K, N]
            for blk in bin_blocks:
                rows_l, xb2 = blk.rows[0, 0], blk.x[0, 0]  # [C, L] local
                colsl = blk.cols[0]  # [C] local ids (pad: D_loc)
                C, L = rows_l.shape
                mu_c = take_rows(mu_old_t, colsl)  # [C, K]
                sig_c = take_rows(sig_old_t, colsl)
                sv_g = take_rows(sv_t, colsl)
                g = jnp.take(eq_t, rows_l.reshape(-1), axis=-1)
                g = g.reshape(1 + 2 * K, C, L)
                e_g = g[0]
                q_g = g[1:1 + K]
                tq_g = g[1 + K:]
                xb = xb2[None]  # [1, C, L]
                mu_b = mu_c.T[:, :, None]
                sig_b = sig_c.T[:, :, None]
                h = q_g - xb * mu_b
                h1 = tq_g - xb * xb * sig_b
                v_mean = _psum_d(
                    (xb * h * (e_g[None] + xb * mu_b * h)).sum(-1)).T  # [C, K]
                v_sig = _psum_d((xb * xb * (h * h + h1)).sum(-1)).T
                sigma_new = 1.0 / (sv_g + alpha * v_sig)
                sigma_new = keep_finite(sigma_new, sig_c)
                mu_new = keep_finite(sigma_new * alpha * v_mean, mu_c)
                mu_t = mu_t.at[colsl].set(mu_new)  # pad -> dropped
                sig_t = sig_t.at[colsl].set(sigma_new)
                dmu_d = dmu_d.at[colsl].set(mu_new - mu_c)
                dsig_d = dsig_d.at[colsl].set(sigma_new - sig_c)
                dmu2_d = dmu2_d.at[colsl].set(mu_new * mu_new - mu_c * mu_c)

                if merge_w:  # linear terms ride the same pass
                    wmu_c = take_rows(mu_w_l, colsl)
                    wsig_c = take_rows(sig_w_l, colsl)
                    sw_g = take_rows(state.sigma_w, blk.group[0], mode="clip")
                    sxe = _psum_d((xb2 * e_g).sum(-1))
                    wsig_cand = 1.0 / (sw_g + alpha * blk.sx2[0])
                    wmu_cand = keep_finite(wsig_cand, wsig_c) * alpha * (
                        sxe + wmu_c * blk.sx2[0])
                    wsig_new = keep_finite(wsig_cand, wsig_c)
                    wmu_new = keep_finite(wmu_cand, wmu_c)
                    mu_w_l = mu_w_l.at[colsl].set(wmu_new)
                    sig_w_l = sig_w_l.at[colsl].set(wsig_new)
                    wdmu_d = wdmu_d.at[colsl].set(wmu_c - wmu_new)
                    wdsig_d = wdsig_d.at[colsl].set(wsig_new - wsig_c)

            # --- bin patch: local per-entry contributions, ONE stacked
            # [3K+2, N] feature psum, then apply everywhere.  Exact for
            # conflict-free bins (each row has <= 1 in-bin entry per shard
            # union, so contributions against the pre-patch caches sum to
            # the sequential result). ---
            dtab_t = jnp.concatenate(
                [mu_old_t.T, sig_old_t.T, dmu_d.T, dsig_d.T, dmu2_d.T,
                 wdmu_d[None], wdsig_d[None]], axis=0)  # [5K+2, D_loc]
            dq = jnp.zeros((K, ids.shape[0]), dtype)
            dtq = jnp.zeros_like(dq)
            dtz = jnp.zeros_like(dq)
            de = jnp.zeros((ids.shape[0],), dtype)
            dt = jnp.zeros_like(de)
            for p in range(P_row):
                lid = ids[:, p] - lo
                inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
                gg = jnp.take(dtab_t, jnp.clip(lid, 0, D_loc - 1),
                              axis=-1) * inr
                xp = (x_r[:, p] * inr)[None]
                x2p = xp * xp
                mu_e = gg[0 * K:1 * K]
                sig_e = gg[1 * K:2 * K]
                dmu_e = gg[2 * K:3 * K]
                dsig_e = gg[3 * K:4 * K]
                dmu2_e = gg[4 * K:5 * K]
                he = xp * (q - xp * mu_e)
                h1e = x2p * (tq - x2p * sig_e)
                h2e = x2p * (tz - x2p * mu_e * mu_e)
                dq = dq + xp * dmu_e
                dtq = dtq + x2p * dsig_e
                dtz = dtz + x2p * dmu2_e
                de = de - (he * dmu_e).sum(0)
                dt = dt + ((h1e + h2e) * dsig_e + h1e * dmu2_e).sum(0)
                if merge_w:
                    xp1 = x_r[:, p] * inr
                    de = de + xp1 * gg[5 * K]  # e += x*(wmu_old - wmu_new)
                    dt = dt + xp1 * xp1 * gg[5 * K + 1]
            patch = _psum_f(jnp.concatenate(
                [dq, dtq, dtz, de[None], dt[None]], axis=0))
            q = q + patch[:K]
            tq = tq + patch[K:2 * K]
            tz = tz + patch[2 * K:3 * K]
            e = e + patch[3 * K]
            t = t + patch[3 * K + 1]

        # unobserved columns: sigma' = 1/sigma_v(g,f), mu' = 0
        sv_d = sv_t  # [D_loc, K]
        unob = plan.unobserved[0][:, None]
        sig_t = jnp.where(unob, 1.0 / sv_d, sig_t)
        mu_t = jnp.where(unob, jnp.zeros((), dtype), mu_t)
        mu_v_l, sig_v_l = mu_t.T, sig_t.T

    if cfg.k1:
        if K == 0:
            # no v pass to ride: standalone w sweep over bins
            for bin_blocks in plan.blocks:
                wdmu_d = jnp.zeros((D_loc,), dtype)
                wdsig_d = jnp.zeros((D_loc,), dtype)
                for blk in bin_blocks:
                    rows_l, xb2 = blk.rows[0, 0], blk.x[0, 0]
                    colsl = blk.cols[0]
                    wmu_c = take_rows(mu_w_l, colsl)
                    wsig_c = take_rows(sig_w_l, colsl)
                    sw_g = take_rows(state.sigma_w, blk.group[0], mode="clip")
                    e_g = take_rows(e, rows_l)
                    sxe = _psum_d((xb2 * e_g).sum(-1))
                    wsig_new = keep_finite(
                        1.0 / (sw_g + alpha * blk.sx2[0]), wsig_c)
                    wmu_new = keep_finite(
                        wsig_new * alpha * (sxe + wmu_c * blk.sx2[0]), wmu_c)
                    mu_w_l = mu_w_l.at[colsl].set(wmu_new)
                    sig_w_l = sig_w_l.at[colsl].set(wsig_new)
                    wdmu_d = wdmu_d.at[colsl].set(wmu_c - wmu_new)
                    wdsig_d = wdsig_d.at[colsl].set(wsig_new - wsig_c)
                de = jnp.zeros((ids.shape[0],), dtype)
                dt = jnp.zeros_like(de)
                for p in range(P_row):
                    lid = ids[:, p] - lo
                    inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)
                    lidc = jnp.clip(lid, 0, D_loc - 1)
                    xp1 = x_r[:, p] * inr
                    de = de + xp1 * (jnp.take(wdmu_d, lidc) * inr)
                    dt = dt + xp1 * xp1 * (jnp.take(wdsig_d, lidc) * inr)
                patch = _psum_f(jnp.stack([de, dt]))
                e = e + patch[0]
                t = t + patch[1]
        # unobserved: sigma' = 1/sigma_w(g), mu' = 0
        sw_d = take_rows(state.sigma_w, ag_l, mode="clip")
        unob1 = plan.unobserved[0]
        sig_w_l = jnp.where(unob1, 1.0 / sw_d, sig_w_l)
        mu_w_l = jnp.where(unob1, jnp.zeros((), dtype), mu_w_l)

    # --- hyperparameter updates (fm_learn_vb.h:446-498): local per-group
    # partials psum'd over FEATURE (pad columns carry group id G -> dropped)
    alpha_temp = _psum_d(jnp.sum((e * e + t) * row.valid))
    alpha = keep_finite(N / alpha_temp, alpha)
    sigma_0 = 1.0 / (mu_0 * mu_0 + sigma_0_dash)
    w_stat = _psum_f(jax.ops.segment_sum(
        jnp.where(valid_l, mu_w_l * mu_w_l + sig_w_l, 0.0), ag_l,
        num_segments=G))
    sigma_w = plan.num_attr_per_group / w_stat
    v_stat = _psum_f(jax.ops.segment_sum(
        jnp.where(valid_l[:, None], (mu_v_l * mu_v_l + sig_v_l).T, 0.0),
        ag_l, num_segments=G))  # [G, K]
    sigma_v = plan.num_attr_per_group[:, None] / v_stat

    # --- free energy (fm_learn_vb.h:646-681; 2*3.14 kept) ---
    fe = -0.5 * alpha * alpha_temp - 0.5 * N * jnp.log(2 * 3.14 / alpha)
    fe += (-0.5 * sigma_0 * (mu_0 * mu_0 + sigma_0_dash)
           + 0.5 * jnp.log(sigma_0_dash * sigma_0) + 0.5)
    sw_d = take_rows(sigma_w, ag_l, mode="clip")
    fe += _psum_f(jnp.sum(jnp.where(
        valid_l, -0.5 * sw_d * (mu_w_l * mu_w_l + sig_w_l)
        + 0.5 * jnp.log(sig_w_l * sw_d) + 0.5, 0.0)))
    sv_d = take_rows(sigma_v, ag_l, mode="clip")  # [D_loc, K]
    fe += _psum_f(jnp.sum(jnp.where(
        valid_l[:, None], -0.5 * sv_d * (mu_v_l * mu_v_l + sig_v_l).T
        + 0.5 * jnp.log(sig_v_l.T * sv_d) + 0.5, 0.0)))

    new_state = TPVBState(
        mu_0=mu_0, sigma_0_dash=sigma_0_dash, mu_w=mu_w_l,
        sigma_w_dash=sig_w_l, mu_v=mu_v_l, sigma_v_dash=sig_v_l, alpha=alpha,
        sigma_0=sigma_0, sigma_w=sigma_w, sigma_v=sigma_v, e=e, t=t)
    return new_state, fe


class TPVBLearner:
    """VBFM trainer with feature-sharded tables over a (data, feature) mesh.

    Use when D*K outgrows one device's HBM.  Numerics match the replicated
    :class:`svbfm.learners.vb.VBLearner` fast mode (factor_block=0)."""

    method = "vb"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh=None, bins: str = "auto", out_dir: str = ".",
                 write_files: bool = False):
        from svbfm.parallel.mesh import make_mesh2d
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh2d(n_feature=1)
        assert self.mesh.axis_names == (DATA_AXIS, FEATURE_AXIS)
        Sd, Sf = self.mesh.devices.shape
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        D = cfg.num_attributes
        coo = train.to_coo()
        plan = SweepPlan.build(coo, D, meta_groups=meta.attr_group, bins=bins,
                               n_shards=Sd)
        self.plan_data, self.D_loc = _build_tp_plan(self.mesh, plan, meta, D)
        self.D_pad = self.D_loc * Sf

        def put_row(ds: SparseDataset):
            ds = ds.padded_to(Sd)
            valid = (np.arange(ds.ids.shape[0]) < ds.num_rows).astype(
                np.float32)
            dsh = NamedSharding(self.mesh, P(DATA_AXIS))
            return RowData(
                ids=jax.device_put(ds.ids, dsh),
                vals=jax.device_put(ds.vals, dsh),
                target=jax.device_put(ds.target, dsh),
                valid=jax.device_put(valid, dsh)), ds.num_rows

        self.train_row, self.train_n = put_row(train)
        self.test_row, self.test_n = put_row(test)
        check_tp_memory_budget(self.plan_data,
                               self.train_row.ids.shape[0] // Sd,
                               cfg.num_factor, type(self).__name__)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.out_dir = out_dir
        self.write_files = write_files
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        num_cases = float(self.train_n)
        nt = float(self.test_n)
        D_loc = self.D_loc

        def iter_fn(state, row, plan, trow):
            state, fe = tp_vb_update_all(state, row, plan, cfg, num_cases,
                                         D_loc)
            scores = tp_scores(state.mu_0, state.mu_w, state.mu_v,
                               trow.ids, trow.vals, D_loc, cfg.k0, cfg.k1)
            ntf = jnp.asarray(nt, scores.dtype)
            p = jnp.clip(scores, cfg.min_target, cfg.max_target)
            err = (p - trow.target) * trow.valid
            rmse = jnp.sqrt(_psum_d(jnp.sum(err * err)) / ntf)
            return state, dict(free_energy=fe, rmse=rmse)

        self._step = jax.jit(jax.shard_map(
            iter_fn, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs(),
                      _plan_specs(self.plan_data), _row_specs()),
            out_specs=(_state_specs(), P()),
        ))

        def fwd(mu_0, mu_w, mu_v, sig0, sig_w, sig_v, ids, vals):
            s = tp_scores(mu_0, mu_w, mu_v, ids, vals, D_loc, cfg.k0, cfg.k1)
            tt = tp_t_terms(sig0, sig_w, mu_v, sig_v, ids, vals, D_loc,
                            cfg.k0, cfg.k1)
            return s, tt

        self._fwd = jax.jit(jax.shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(), P(FEATURE_AXIS), P(None, FEATURE_AXIS), P(),
                      P(FEATURE_AXIS), P(None, FEATURE_AXIS), P(DATA_AXIS),
                      P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        ))

    def init_state(self, key: Optional[jax.Array] = None) -> TPVBState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        p = init_vb_params(key, cfg)  # same RNG draws as the replicated path

        def padf(a):  # pad the feature (last) dim to D_pad
            pad = self.D_pad - a.shape[-1]
            if pad <= 0:
                return np.asarray(a)
            widths = [(0, 0)] * (np.asarray(a).ndim - 1) + [(0, pad)]
            return np.pad(np.asarray(a), widths)

        shardings = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                                 _state_specs())
        mu_w = padf(p["mu_w"])
        sig_w = padf(p["sigma_w_dash"])
        mu_v = padf(p["mu_v"])
        sig_v = padf(p["sigma_v_dash"])
        mu_w_d = jax.device_put(mu_w, shardings.mu_w)
        sig_w_d = jax.device_put(sig_w, shardings.sigma_w_dash)
        mu_v_d = jax.device_put(mu_v, shardings.mu_v)
        sig_v_d = jax.device_put(sig_v, shardings.sigma_v_dash)
        yhat, tvals = self._fwd(p["mu_0"], mu_w_d, mu_v_d, p["sigma_0_dash"],
                                sig_w_d, sig_v_d,
                                self.train_row.ids, self.train_row.vals)
        e = self.train_row.target - yhat  # e = y - yhat (VB convention)
        state = TPVBState(
            mu_0=p["mu_0"], sigma_0_dash=p["sigma_0_dash"], mu_w=mu_w_d,
            sigma_w_dash=sig_w_d, mu_v=mu_v_d, sigma_v_dash=sig_v_d,
            alpha=p["alpha"], sigma_0=p["sigma_0"], sigma_w=p["sigma_w"],
            sigma_v=p["sigma_v"], e=e, t=tvals)
        return jax.device_put(state, shardings)

    def predict_test_scores(self, state: TPVBState) -> np.ndarray:
        s, _ = self._fwd(state.mu_0, state.mu_w, state.mu_v,
                         state.sigma_0_dash, state.sigma_w_dash,
                         state.sigma_v_dash, self.test_row.ids,
                         self.test_row.vals)
        return np.asarray(s)[: self.test_n]

    def _place(self, state: TPVBState) -> TPVBState:
        """device_put a (possibly host/numpy) state with step shardings."""
        shardings = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                                 _state_specs())
        return jax.device_put(state, shardings)

    def run(self, state: Optional[TPVBState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            ckpt=None, ckpt_every: int = 10):
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        it = 0
        if ckpt is not None:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                state, it, _meta = restored
                state = self._place(state)
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir, self.write_files and it == 0)
        fe_file = TrajectoryFile("free_energy", cfg, self.method,
                                 self.out_dir, self.write_files and it == 0)
        history = []
        last_saved = it
        import time as _time
        while it < num_iter:
            t0 = _time.perf_counter()
            state, metrics = self._step(state, self.train_row,
                                        self.plan_data, self.test_row)
            t1 = _time.perf_counter()
            metrics = jax.device_get(metrics)
            now = _time.perf_counter()
            rec = {"iter": it, "time_learn": now - t0, "time_pred": now - t1,
                   "free_energy": float(metrics["free_energy"]),
                   "rmse": float(metrics["rmse"])}
            fe_file.append(-rec["free_energy"])
            rmse_file.append(rec["rmse"])
            if verbose:
                print(f"#Iter={it:3d}\tTest={rec['rmse']:.6g}")
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, rec, state=state)
            history.append(rec)
            it += 1
            if ckpt is not None and (it - last_saved >= ckpt_every
                                     or it >= num_iter):
                ckpt.save(jax.tree.map(np.asarray, state), it,
                          {"method": self.method})
                last_saved = it
        return state, history
