"""Native relational block structure (BS) for MCMC/ALS.

A re-design of the reference's block-structure Gibbs sampler
(``fm_learn_mcmc.h:134-220`` predict, ``:459-620`` draw_all with relations,
``:722-780`` draw_w_rel, ``:842-899`` draw_v_rel; VLDB'13 "Scaling
Factorization Machines to Relational Data").  Unlike
:func:`svbfm.data.relation.join_relations`, which materializes the join
into a flat design matrix, this learner keeps every relation table factored
on device: memory and per-iteration compute scale with
``O(N + sum_r nnz(rel_r) + sum_r rows(rel_r))`` — never with the expanded
design matrix.

Algorithm (per factor f, per relation r), exactly the reference's algebra:

  per-relation-row caches over the join  (``relation_cache``):
    wnum[rho]  = #train rows joined to rho                      (static)
    qB[rho]    = sum_i v[f, off+i] x_rho,i                      (per factor)
    we[rho]    = sum_{n: j(n)=rho} e_n
    weq[rho]   = sum e_n qO_n          with qO_n = q_n - qB[j(n)]
    wc[rho]    = sum qO_n
    wc2[rho]   = sum qO_n^2

  conditional for relation attribute i (``draw_v_rel``):
    h_rho = x (qB[rho] - x v)
    she   = sum_rho  h_rho we + x weq
    sh2   = sum_rho  h^2 wnum + 2 wc x h + x^2 wc2

  after a conflict-free bin updates its columns, the caches are patched in
  closed form at the *relation* level (one relation-row-layout pass), and the
  data-level e/q caches are resynced once per (relation, factor) with
  ``e += dy[j] + qO * dqB[j]`` — the desync/resync pair of the reference
  collapses to these deltas, so the per-data-row work per factor is O(N)
  regardless of the relation widths.

Execution: the per-rho aggregates are computed with the same degree-bucketed
``[C, L]`` masked row-sums as the column sweeps (a "join plan" built by
:class:`svbfm.data.dataset.SweepPlan` over the join index), sharded over
the data axis with one psum; the relation sweeps themselves are replicated
[R]-level compute with zero communication.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from svbfm.data.dataset import SparseDataset, SweepPlan
from svbfm.data.libfm_text import COOData
from svbfm.data.meta import DataMetaInfo
from svbfm.data.relation import RelationData
from svbfm.learners.base import (
    FMConfig,
    TASK_REGRESSION,
    build_plan_data,
    build_row_data,
    keep_finite,
    plan_specs_for,
)
from svbfm.learners.mcmc import (
    MCMCLearner,
    MCMCState,
    _gather,
    _psum,
    _row_specs,
    _state_specs,
)
from svbfm.ops.segment import take_cols, take_rows
from svbfm.parallel.mesh import DATA_AXIS, put_replicated, shard_rows
from svbfm.utils.pytree import pytree_dataclass


# ---------------------------------------------------------------------------
# Device structures
# ---------------------------------------------------------------------------

@pytree_dataclass
class JoinBlock:
    """One degree-bucket of the join plan: data rows grouped by relation row."""

    rows: jax.Array  # int32 [S, C, L] local data-row ids (sharded)
    x: jax.Array  # f32 [S, C, L] 1.0 real / 0.0 pad (sharded)
    cols: jax.Array  # int32 [C] relation row ids (replicated)


@pytree_dataclass
class RelBlock:
    """One degree-bucket of one conflict-free bin of the relation design."""

    rows: jax.Array  # int32 [C, L] relation row ids (replicated)
    x: jax.Array  # f32 [C, L]
    cols: jax.Array  # int32 [C] relation-local attribute ids
    group: jax.Array  # int32 [C] JOINED-global group ids


@pytree_dataclass
class RelDevice:
    """All device arrays of one relation block."""

    rrow_ids: jax.Array  # int32 [R, Pr] relation-local attr ids (replicated)
    rrow_vals: jax.Array  # f32 [R, Pr]
    join_tr: jax.Array  # int32 [N] train join (sharded)
    join_te: jax.Array  # int32 [N_te] test join (sharded)
    wnum: jax.Array  # f32 [R] train rows per relation row (replicated)
    jplan: tuple  # tuple[JoinBlock, ...]
    rplan: tuple  # tuple[tuple[RelBlock, ...], ...] bins -> buckets
    unobserved: jax.Array  # bool [Dr] attrs with no entry in the relation
    attr_group: jax.Array  # int32 [Dr] JOINED-global group of each attr


@dataclass(frozen=True)
class RelStatic:
    """Static (Python) facts about one relation block."""

    attr_offset: int
    num_attrs: int  # Dr
    num_rows: int  # R
    # patch_pos[b] = row-layout positions that contain bin b's columns.
    # The per-bin cache patches gather a dv table through rrow_ids[:, p];
    # positions holding no in-bin column gather only zeros, so skipping
    # them is exact — and for field-structured relations it turns the
    # O(bins * positions) patch-pass grid into O(bins) passes.
    patch_pos: tuple = ()


def _build_rel_device(mesh, rel: RelationData, join_tr: np.ndarray,
                      join_te: np.ndarray, joined_groups: np.ndarray,
                      n_train_pad: int, n_test_pad: int,
                      bins: str = "auto") -> tuple[RelDevice, RelStatic]:
    n = mesh.devices.size
    R, Dr = rel.num_rows, rel.num_features
    off = rel.attr_offset
    assert off >= 0, "call build_joined_meta before building relation devices"

    # relation row layout [R, Pr] (relation-local ids)
    rel_ds = SparseDataset.from_coo(
        COOData(row=rel.row, col=rel.col, val=rel.val,
                target=np.zeros(R, np.float32), num_rows=R, num_features=Dr))
    # join plan: one Jacobi bin of degree-bucketed [C, L] lists, columns =
    # relation rows, entries = train data rows (sharded like the data);
    # padding data rows are absent from the plan (x=0 masks in every sum)
    jcoo = COOData(row=np.arange(len(join_tr), dtype=np.int32),
                   col=join_tr.astype(np.int32),
                   val=np.ones(len(join_tr), np.float32),
                   target=np.zeros(len(join_tr), np.float32),
                   num_rows=len(join_tr), num_features=R)
    jplan = SweepPlan.build(jcoo, R, bins="jacobi", n_shards=n,
                            n_rows_total=n_train_pad)
    # relation design plan: conflict-free bins within the relation
    rcoo = COOData(row=rel.row, col=rel.col, val=rel.val,
                   target=np.zeros(R, np.float32), num_rows=R,
                   num_features=Dr)
    rplan = SweepPlan.build(rcoo, Dr, meta_groups=joined_groups[off: off + Dr],
                            bins=bins, n_shards=1)
    wnum = np.bincount(join_tr, minlength=R).astype(np.float32)
    # per-bin row-layout positions (see RelStatic.patch_pos)
    patch_pos = []
    for b in range(rplan.num_bins):
        ps = []
        for p in range(rel_ds.ids.shape[1]):
            live = rel_ds.vals[:, p] != 0.0
            if live.any() and (rplan.color[rel_ds.ids[live, p]] == b).any():
                ps.append(p)
        patch_pos.append(tuple(ps))

    jte = np.zeros(n_test_pad, np.int32)
    jte[: len(join_te)] = join_te.astype(np.int32)
    jtr = np.zeros(n_train_pad, np.int32)
    jtr[: len(join_tr)] = join_tr.astype(np.int32)

    dev = RelDevice(
        rrow_ids=put_replicated(mesh, rel_ds.ids),
        rrow_vals=put_replicated(mesh, rel_ds.vals),
        join_tr=shard_rows(mesh, jtr),
        join_te=shard_rows(mesh, jte),
        wnum=put_replicated(mesh, wnum),
        jplan=tuple(
            JoinBlock(rows=shard_rows(mesh, blk.rows),
                      x=shard_rows(mesh, blk.x),
                      cols=put_replicated(mesh, blk.cols))
            for blk in jplan.blocks[0]),
        rplan=tuple(
            tuple(RelBlock(rows=put_replicated(mesh, blk.rows[0]),
                           x=put_replicated(mesh, blk.x[0]),
                           cols=put_replicated(mesh, blk.cols),
                           group=put_replicated(mesh, blk.group))
                  for blk in bin_blocks)
            for bin_blocks in rplan.blocks),
        unobserved=put_replicated(mesh, rplan.unobserved),
        attr_group=put_replicated(
            mesh, joined_groups[off: off + Dr].astype(np.int32)),
    )
    return dev, RelStatic(attr_offset=off, num_attrs=Dr, num_rows=R,
                          patch_pos=tuple(patch_pos))


def _rel_specs(dev: RelDevice) -> RelDevice:
    rep, shd = P(), P(DATA_AXIS)
    return RelDevice(
        rrow_ids=rep, rrow_vals=rep, join_tr=shd, join_te=shd, wnum=rep,
        jplan=tuple(JoinBlock(rows=shd, x=shd, cols=rep) for _ in dev.jplan),
        rplan=tuple(tuple(RelBlock(rows=rep, x=rep, cols=rep, group=rep)
                          for _ in bb) for bb in dev.rplan),
        unobserved=rep, attr_group=rep)


# ---------------------------------------------------------------------------
# BS forward scoring (predict without materializing the join)
# ---------------------------------------------------------------------------

def bs_scores(w0, w, v, ids, vals, rels, rstats, joins, k0=True, k1=True,
              factor_chunk: Optional[int] = None):
    """FM scores over a dataset given its main row layout + per-relation
    joins.  Mirrors ``predict_data_and_write_to_eterms``
    (fm_learn_mcmc.h:116-300) at O(nnz_main + sum nnz_rel + N*|B|) per
    factor."""
    N = ids.shape[0]
    K = v.shape[0]
    dtype = v.dtype
    acc = jnp.zeros((N,), dtype)
    if k0:
        acc = acc + w0
    if k1:
        for p in range(ids.shape[1]):
            acc = acc + jnp.take(w, ids[:, p], axis=-1) * vals[:, p]
        for rd, rs, j in zip(rels, rstats, joins):
            wr = jax.lax.dynamic_slice_in_dim(w, rs.attr_offset, rs.num_attrs)
            lin = jnp.zeros((rs.num_rows,), dtype)
            for p in range(rd.rrow_ids.shape[1]):
                lin = lin + jnp.take(wr, rd.rrow_ids[:, p]) * rd.rrow_vals[:, p]
            acc = acc + jnp.take(lin, j)
    if K == 0:
        return acc
    chunk = K if factor_chunk is None else min(factor_chunk, K)
    if K % chunk != 0:
        chunk = K

    def blk(v_blk):  # [F, D_all]
        F = v_blk.shape[0]
        s = jnp.zeros((F, N), dtype)
        s2 = jnp.zeros((F, N), dtype)
        for p in range(ids.shape[1]):
            d = jnp.take(v_blk, ids[:, p], axis=-1) * vals[:, p]
            s = s + d
            s2 = s2 + d * d
        for rd, rs, j in zip(rels, rstats, joins):
            vr = jax.lax.dynamic_slice_in_dim(v_blk, rs.attr_offset,
                                              rs.num_attrs, axis=1)
            qB = jnp.zeros((F, rs.num_rows), dtype)
            sB = jnp.zeros((F, rs.num_rows), dtype)
            for p in range(rd.rrow_ids.shape[1]):
                d = jnp.take(vr, rd.rrow_ids[:, p], axis=-1) * rd.rrow_vals[:, p]
                qB = qB + d
                sB = sB + d * d
            g = take_cols(jnp.concatenate([qB, sB], axis=0), j)  # [2F, N]
            s = s + g[:F]
            s2 = s2 + g[F:]
        return 0.5 * (s * s - s2).sum(0)

    if chunk == K:
        return acc + blk(v)
    for c0 in range(0, K, chunk):
        acc = acc + blk(jax.lax.dynamic_slice_in_dim(v, c0, chunk))
    return acc


# ---------------------------------------------------------------------------
# Factor-blocked BS v sweep
# ---------------------------------------------------------------------------
#
# The coordinate order is: per factor-block B of size F — main bins
# (bin-major, factor-minor: learners.mcmc._v_block_pass), then each relation
# in turn, ALSO bin-major / factor-minor: each relation bin gathers all F
# factors' per-rho aggregates once and draws the factors with exact
# sequential conditionals via the batched triangular solve
# (learners.mcmc.exact_block_draws) — the per-factor correction matrix is
# derived in _bs_rel_block_sweep.
# Exactness hinges on one invariant: while relation r is being swept (all F
# factors), qO_{r,f} = q_f - qB_{r,f}[join] NEVER changes (updating v[f, i]
# for a relation attr changes q_f and qB_{r,f}[join] by the same amount), so
# the qO moments
#
#   wc_f[rho]      = sum_{n: j(n)=rho} qO_f[n]
#   wcc_{f,g}[rho] = sum qO_f[n] qO_g[n]      (wc2_f = wcc_{f,f})
#
# are constants of the whole relation sweep and ONE channel-stacked join
# pass produces every aggregate all F factors need.  Only the e-aggregates
# evolve: factor f's draws change e by  de_n = dy_f[rho] + qO_f[n] dqB_f[rho]
# (dy/dqB the per-rho prediction/qB deltas), giving closed-form corrections
#
#   we[rho]    += wnum dy_f + wc_f dqB_f          (its own bins patch this
#                                                  incrementally, as before)
#   weq_g[rho] += dy_f wc_g + dqB_f wcc_{f,g}     (applied once per factor
#                                                  for the LATER factors g)
#
# so the per-factor scan touches only [R]-level arrays; the O(K) per-factor
# join passes of the sequential path collapse to O(1) per block.  The float64
# oracle tests/oracle.py:BSBlockedALSOracle pins this order end to end.

def _bs_rel_block_sweep(vblk, e, q, key, rd, rs: RelStatic, b0: int,
                        qB_blk, gB, mu_dk, lam_dk, alpha, cfg: FMConfig,
                        F: int, counters=None):
    """Sweep ONE relation's attributes for factors [b0, b0+F) with exact
    sequential conditionals (draw_v_rel, fm_learn_mcmc.h:842-899).
    Per-function import avoids the circular learners.mcmc dependency.

    vblk: [F, D_all] the block's factor rows; q: [F, N] total q caches;
    qB_blk: [F, R] this relation's block qB; gB: [F, N] its pre-gathered
    qB[join] (still valid here — only this relation's own sweep changes its
    qB, so the gather from _bs_v_blocked is reused instead of repeated).
    Returns (vblk, e, q, key)."""
    from svbfm.learners.mcmc import _count_bad

    R, Dr, off = rs.num_rows, rs.num_attrs, rs.attr_offset
    dtype = e.dtype
    qO = q - gB  # [F, N] — sweep-invariant
    iu0, iu1 = np.triu_indices(F)
    # one join pass: e, e*qO_f, qO_f, and the upper triangle of qO_f*qO_g
    ch = jnp.concatenate(
        [e[None], e[None] * qO, qO, qO[iu0] * qO[iu1]], axis=0)
    parts = _join_aggregate(ch, rd.jplan)
    parts = [(c, _psum(p)) for c, p in parts]
    agg = _scatter_agg(R, parts, dtype)  # [CH, R]
    we0 = agg[0]
    weq0 = agg[1: 1 + F]  # [F, R]
    wc = agg[1 + F: 1 + 2 * F]  # [F, R]
    wcc_u = agg[1 + 2 * F:]  # [F(F+1)/2, R]
    sym = np.zeros((F, F), np.int64)
    sym[iu0, iu1] = np.arange(len(iu0))
    sym[iu1, iu0] = sym[iu0, iu1]
    sym_flat = jnp.asarray(sym.reshape(-1))
    diag_idx = jnp.asarray(sym.diagonal().copy())
    wcc = take_rows(wcc_u, sym_flat).reshape(F, F, R)  # symmetric [F, F, R]
    wn = rd.wnum
    P_u = wcc_u.shape[0]

    mu_r = jax.lax.dynamic_slice(mu_dk, (off, b0), (Dr, F))  # [Dr, F]
    lam_r = jax.lax.dynamic_slice(lam_dk, (off, b0), (Dr, F))
    vr = jax.lax.dynamic_slice_in_dim(vblk, off, Dr, axis=1)  # [F, Dr]
    key, sub = jax.random.split(key)
    zv = (jax.random.normal(sub, (F, Dr), dtype) if cfg.do_sample
          else jnp.zeros((F, Dr), dtype))

    # Bin-major factor-batched sweep: instead of the per-factor
    # scan (F bin passes per relation, each re-gathering every per-rho
    # aggregate), each bin gathers ALL factors' channels once and draws the
    # F factors with exact sequential conditionals via the same batched
    # triangular solve as the main block (learners.mcmc.exact_block_draws).
    # Effect of factor g's draw of column c on factor f's she at column c
    # (every rho in Omega_c has its single bin entry AT column c):
    #   dwe(rho)    = -dv_g (h_g wn + x wc_g)
    #   dweq_f(rho) = -dv_g (h_g wc_f + x wcc_{g,f})
    #   => dshe_f(c) = -dv_g * M[g, f, c],
    #      M[g,f,c] = sum_l h_f h_g wn + h_f x wc_g + x h_g wc_f + x^2 wcc_{g,f}
    # — the (bin, factor, column) scan order of the main block, pinned by
    # tests/oracle.py:BSBlockedALSOracle.
    from svbfm.learners.mcmc import exact_block_draws

    qB0 = qB_blk
    qB = qB_blk  # [F, R] evolving
    we = we0  # [R]
    weq = weq0  # [F, R]
    dy = jnp.zeros((F, R), dtype)
    nan_c = jnp.zeros((), jnp.int32)
    inf_c = jnp.zeros((), jnp.int32)
    hi = jax.lax.Precision.HIGHEST
    for b_i, bin_blocks in enumerate(rd.rplan):
        if not bin_blocks:
            continue
        v_old_r = vr
        dv_r = jnp.zeros((F, Dr), dtype)
        # per-rho channels gathered ONCE per bucket for ALL F factors
        big = jnp.concatenate([qB, we[None], weq, wc, wcc_u, wn[None]],
                              axis=0)  # [3F + 2 + P_u, R]
        for blk in bin_blocks:
            C, L = blk.rows.shape
            v_cf = take_cols(v_old_r, blk.cols)  # [F, C]
            v_c = v_cf.T  # [C, F]
            mu_g = take_rows(mu_r, blk.cols)  # [C, F]
            lam_g = take_rows(lam_r, blk.cols)
            if L == 1:
                # one-entry buckets (one-hot fields): squeeze the length
                # axis — no [*, C, 1] temps with a size-1 minor dim
                g = take_cols(big, blk.rows[:, 0])  # [CH, C]
                qB_g = g[:F]
                we_g = g[F]
                weq_g = g[F + 1: 2 * F + 1]
                wc_g = g[2 * F + 1: 3 * F + 1]
                wccu_g = g[3 * F + 1: 3 * F + 1 + P_u]
                wn_g = g[-1]
                x = blk.x[:, 0]  # [C]
                x2 = x * x
                h = x[None] * (qB_g - x[None] * v_cf)  # [F, C]
                she0 = h * we_g[None] + x[None] * weq_g
                t4u = wccu_g * x2[None]  # [P_u, C]
                sh2 = ((h * h) * wn_g[None] + 2.0 * wc_g * (x[None] * h)
                       + take_rows(t4u, diag_idx))
                hw = h * wn_g[None]
                xw = x[None] * wc_g
                m_x = (h[None] * hw[:, None] + h[None] * xw[:, None]
                       + xw[None] * h[:, None]
                       + take_rows(t4u, sym_flat).reshape(F, F, C))
            else:
                g = take_cols(big, blk.rows)  # [CH, C, L]
                qB_g = g[:F]
                we_g = g[F]
                weq_g = g[F + 1: 2 * F + 1]
                wc_g = g[2 * F + 1: 3 * F + 1]
                wccu_g = g[3 * F + 1: 3 * F + 1 + P_u]
                wn_g = g[-1]
                x = blk.x  # [C, L]
                x2 = x * x
                h = x[None] * (qB_g - x[None] * v_cf[:, :, None])  # [F,C,L]
                she0 = (h * we_g[None] + x[None] * weq_g).sum(-1)  # [F, C]
                t4u = (wccu_g * x2[None]).sum(-1)  # [P_u, C]
                sh2 = ((h * h) * wn_g[None]
                       + 2.0 * wc_g * (x[None] * h)).sum(-1) \
                    + take_rows(t4u, diag_idx)  # [F, C]
                # cross-factor matrix (see derivation above); f32
                # accumulation, like the main block's M
                t1 = jnp.einsum("fcl,gcl->gfc", h, h * wn_g[None],
                                precision=hi)
                t2 = jnp.einsum("fcl,gcl->gfc", h, x[None] * wc_g,
                                precision=hi)
                m_x = (t1 + t2 + jnp.transpose(t2, (1, 0, 2))
                       + take_rows(t4u, sym_flat).reshape(F, F, C))
            zmat = take_cols(zv, blk.cols) if cfg.do_sample else None
            new_v_cf, n1, n2 = exact_block_draws(
                she0, sh2, m_x, v_c, mu_g, lam_g, alpha, zmat)
            nan_c = nan_c + n1
            inf_c = inf_c + n2
            vr = vr.at[:, blk.cols].set(new_v_cf.T)
            dv_r = dv_r.at[:, blk.cols].set(v_cf - new_v_cf.T)
        # relation-row-layout cache patch, all factors at once (each rho
        # has <=1 in-bin entry, so h uses the pre-patch qB of its own row)
        vtab = jnp.concatenate([v_old_r, dv_r], axis=0)  # [2F, Dr]
        for p in rs.patch_pos[b_i]:
            gp = jnp.take(vtab, rd.rrow_ids[:, p], axis=-1)  # [2F, R]
            xp = rd.rrow_vals[:, p]
            v_e, dv_e = gp[:F], gp[F:]
            h_e = xp[None] * (qB - xp[None] * v_e)  # [F, R]
            s1 = (dv_e * h_e).sum(0)  # [R] = sum_g dv_g h_g
            we = we - (s1 * wn + xp * (dv_e * wc).sum(0))
            weq = weq - (s1[None] * wc
                         + xp[None] * jnp.einsum("gr,gfr->fr", dv_e, wcc,
                                                 precision=hi))
            dy = dy - dv_e * h_e
            qB = qB - xp[None] * dv_e
    # unobserved relation attrs -> prior (one z per (factor, attr))
    s2_d = 1.0 / lam_r.T  # [F, Dr]
    un = mu_r.T + jnp.sqrt(s2_d) * zv if cfg.do_sample else mu_r.T
    un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
    _count_bad(counters, "v", jnp.where(rd.unobserved[None], un, 0.0))
    vr = jnp.where(rd.unobserved[None], keep_finite(un, vr), vr)
    if counters is not None:
        counters["nan_v"] = counters.get("nan_v", 0) + nan_c
        counters["inf_v"] = counters.get("inf_v", 0) + inf_c
    dqB = qB - qB0
    vblk = jax.lax.dynamic_update_slice_in_dim(vblk, vr, off, axis=1)
    # resync e and q for the whole block in one gather pass
    gg = take_cols(jnp.concatenate([dy, dqB], axis=0), rd.join_tr)  # [2F, N]
    e = e + gg[:F].sum(0) + (qO * gg[F:]).sum(0)
    q = q + gg[F:]
    return vblk, e, q, key


def _bs_v_blocked(e, v, v_mu, v_lambda, alpha, plan, row, rels, rstats,
                  cfg: FMConfig, qB_pre, F: int, key, counters=None):
    """Factor-blocked BS v sweep (see the order/correction notes above)."""
    from svbfm.learners.mcmc import (_count_bad, _maybe_sample,
                                     _v_block_pass)

    dtype = v.dtype
    K, D_all = v.shape
    n_loc = e.shape[0]
    mu_dk = take_rows(v_mu, plan.attr_group)  # [D_all, K]
    lam_dk = take_rows(v_lambda, plan.attr_group)
    has_main = any(len(bb) for bb in plan.blocks)
    # main attrs occupy [0, d_main); relations are appended after them
    d_main = min((rs.attr_offset for rs in rstats), default=D_all)
    for b0 in range(0, K, F):
        # ONE qB[join] gather per relation per block, reused by the
        # relation sweep below (a relation's qB only changes in its own
        # sweep, so the gathered [F, N] view stays valid until then)
        qB_blks, gBs = [], []
        q = jnp.zeros((F, n_loc), dtype)
        for rd, qB in zip(rels, qB_pre):
            qB_blk = jax.lax.dynamic_slice_in_dim(qB, b0, F, axis=0)
            gB = take_cols(qB_blk, rd.join_tr)  # [F, N]
            qB_blks.append(qB_blk)
            gBs.append(gB)
            q = q + gB
        v_t = jax.lax.dynamic_slice_in_dim(v, b0, F, axis=0).T  # [D_all, F]
        mu_t = jax.lax.dynamic_slice_in_dim(mu_dk, b0, F, axis=1)
        lam_t = jax.lax.dynamic_slice_in_dim(lam_dk, b0, F, axis=1)
        if has_main:
            e, v_t, q, key = _v_block_pass(e, v_t, mu_t, lam_t, key, plan,
                                           row, cfg, alpha, q_extra=q,
                                           counters=counters)
        if d_main > 0:
            # unobserved MAIN columns -> prior, even when the main design
            # has no observed entries at all (plan.unobserved is padded
            # False over relation attrs, so they are never touched here);
            # matches the sequential path's unconditional prior redraw
            key, sub = jax.random.split(key)
            new_un = _maybe_sample(cfg.do_sample, sub, mu_t, 1.0 / lam_t, v_t,
                                   counters=counters, count_as="v",
                                   count_mask=plan.unobserved[:, None])
            v_t = jnp.where(plan.unobserved[:, None], new_un, v_t)
        vblk = v_t.T  # [F, D_all]
        for r_i, (rd, rs) in enumerate(zip(rels, rstats)):
            vblk, e, q, key = _bs_rel_block_sweep(
                vblk, e, q, key, rd, rs, b0, qB_blks[r_i], gBs[r_i],
                mu_dk, lam_dk, alpha, cfg, F, counters=counters)
        v = jax.lax.dynamic_update_slice_in_dim(v, vblk, b0, axis=0)
    return e, v, key


# Budget for the blocked BS sweep's big temps in padded f32 elements: the
# [CH, N] channel stack + its join-plan gather (CH = 1 + 2F + F(F+1)/2),
# the [F, N] q/qO caches, and the [F, F, R] cross-moment table.
def _bs_blocked_peak_elems(F: int, n_loc: int, max_R: int) -> int:
    ch = 1 + 2 * F + F * (F + 1) // 2
    return ch * n_loc * 2 + 4 * F * n_loc + F * F * max_R


def _bs_auto_factor_block(K: int, n_loc: int, max_R: int,
                          plan=None) -> int:
    """Largest divisor of K whose blocked-BS temps — and, when the main
    design has entry blocks (pass ``plan``), the main-block pass's temps —
    fit MCMC_BLOCK_BUDGET.  1 = factor-sequential scan."""
    from svbfm.learners.mcmc import MCMC_BLOCK_BUDGET, _blocked_peak_elems
    for d in range(K, 1, -1):
        if K % d:
            continue
        if _bs_blocked_peak_elems(d, n_loc, max_R) > MCMC_BLOCK_BUDGET:
            continue
        if plan is not None and _blocked_peak_elems(plan, d, n_loc) \
                > MCMC_BLOCK_BUDGET:
            continue
        return d
    return 1


# ---------------------------------------------------------------------------
# BS Gibbs / ALS draw
# ---------------------------------------------------------------------------

def _join_aggregate(channels, jplan):
    """Sum each [N]-channel per relation row over the join plan's buckets.

    channels: [CH, N] stacked data-level values.  Returns [CH, R] psum'd
    aggregates."""
    outs = []
    for blk in jplan:
        g = take_cols(channels, blk.rows[0])  # [CH, C, L]
        part = (g * blk.x[0][None]).sum(-1)  # [CH, C]
        outs.append((blk.cols, part))
    return outs  # list of (cols [C], partial [CH, C]) — caller psums/scatters


def _scatter_agg(R, parts, dtype):
    """[CH, R] table from per-bucket [CH, C] partials ([C]-sized writes)."""
    CH = parts[0][1].shape[0]
    out = jnp.zeros((CH, R), dtype)
    for cols, part in parts:
        out = out.at[:, cols].set(part)
    return out


def mcmc_bs_draw_all(state: MCMCState, row, plan, rels, cfg: FMConfig,
                     rstats, num_cases: float):
    """One block-structure Gibbs/ALS sweep + full re-predict of the train
    e-cache.  Runs inside shard_map.  Scalar/hyperprior/main-block draws are
    the SHARED helpers from learners.mcmc (fm_learn_mcmc.h:411-458); relation
    draws follow draw_w_rel/draw_v_rel (:722-780, :842-899) with
    conflict-free bins inside each relation and hoisted per-relation
    z-tables (one normal draw per sweep, not per bucket)."""
    from svbfm.learners.mcmc import (_count_bad, draw_alpha,
                                     draw_v_hyperpriors, draw_w0,
                                     draw_w_hyperpriors,
                                     v_factor_main_bins, w_sweep_main,
                                     zero_nan_counters)

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

    def rel_z(Dr):
        """One [Dr] z-table per relation sweep (each attr drawn once)."""
        if not cfg.do_sample:
            return None
        return jax.random.normal(next_key(), (Dr,), dtype)

    def guarded(mean, s2, z, cols, old, count_as="w"):
        if z is not None:
            val = mean + jnp.sqrt(s2) * _gather(z, cols)
        else:
            val = mean
        # sigma guard zeroes BEFORE the counter check (fm_learn_mcmc.h:686)
        val = jnp.where(jnp.isfinite(s2), val, jnp.zeros_like(val))
        _count_bad(counters, count_as, val)
        return keep_finite(val, old)

    alpha = draw_alpha(e, row.valid, state.alpha, cfg, N, next_key, dtype,
                       counters=counters)

    w0 = state.w0
    if cfg.k0:
        e, w0 = draw_w0(e, row.valid, w0, cfg, alpha, N, next_key,
                        counters=counters)

    w, v = state.w, state.v
    w_mu, w_lambda = state.w_mu, state.w_lambda
    v_mu, v_lambda = state.v_mu, state.v_lambda
    D_all = w.shape[0]

    if cfg.k1:
        # joined groups cover relation attrs too
        w_mu, w_lambda = draw_w_hyperpriors(
            w, w_mu, w_lambda, plan.attr_group, plan.num_attr_per_group,
            cfg, G, next_key, dtype, counters=counters)
        # main-block w sweep + unobserved-main prior draws (relation attrs
        # are never touched: plan.unobserved is padded False over them)
        e, w = w_sweep_main(e, w, w_mu, w_lambda, alpha, plan, row, cfg,
                            next_key, counters=counters)

        # --- relation w sweeps (draw_w_rel, fm_learn_mcmc.h:722-780) ---
        for rd, rs in zip(rels, rstats):
            R, Dr, off = rs.num_rows, rs.num_attrs, rs.attr_offset
            parts = _join_aggregate(e[None], rd.jplan)
            parts = [(c, _psum(p)) for c, p in parts]
            we = _scatter_agg(R, parts, dtype)[0]  # [R] sum of e per rho
            wr = jax.lax.dynamic_slice_in_dim(w, off, Dr)
            dy = jnp.zeros((R,), dtype)
            zr = rel_z(Dr)
            for b_i, bin_blocks in enumerate(rd.rplan):
                if not bin_blocks:
                    continue
                w_old_r = wr
                dwr = jnp.zeros((Dr,), dtype)
                for blk in bin_blocks:
                    g = take_cols(jnp.stack([we, rd.wnum]), blk.rows)  # [2,C,L]
                    x = blk.x
                    we_g, wn_g = g[0], g[1]
                    w_c = _gather(w_old_r, blk.cols)
                    mu_g = _gather(w_mu, blk.group)
                    lam_g = _gather(w_lambda, blk.group)
                    she = (x * we_g).sum(-1)
                    sh2 = (x * x * wn_g).sum(-1)
                    w_mean = she - w_c * sh2
                    s2 = 1.0 / (lam_g + alpha * sh2)
                    mean = -s2 * (alpha * w_mean - mu_g * lam_g)
                    new_w = guarded(mean, s2, zr, blk.cols, w_c)
                    wr = wr.at[blk.cols].set(new_w)
                    dwr = dwr.at[blk.cols].set(w_c - new_w)
                # relation-row-layout patch over only the positions that
                # hold this bin's columns: we -= x dv wnum ; y += -x dv
                for p in rs.patch_pos[b_i]:
                    dv_e = jnp.take(dwr, rd.rrow_ids[:, p])
                    xp = rd.rrow_vals[:, p]
                    we = we - xp * dv_e * rd.wnum
                    dy = dy - xp * dv_e
            # unobserved relation attrs -> prior (z reused: unused so far)
            mu_d = _gather(w_mu, rd.attr_group)
            lam_d = _gather(w_lambda, rd.attr_group)
            s2_d = 1.0 / lam_d
            if zr is not None:
                un = mu_d + jnp.sqrt(s2_d) * zr
            else:
                un = mu_d
            un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
            _count_bad(counters, "w", jnp.where(rd.unobserved, un, 0.0))
            wr = jnp.where(rd.unobserved, keep_finite(un, wr), wr)
            w = jax.lax.dynamic_update_slice_in_dim(w, wr, off, axis=0)
            # resync e with the relation's linear delta
            e = e + jnp.take(dy, rd.join_tr)

    if K > 0:
        v_mu, v_lambda = draw_v_hyperpriors(
            v, v_mu, v_lambda, plan.attr_group, plan.num_attr_per_group,
            cfg, G, K, next_key, dtype, counters=counters)

        # qB[K, R] per relation, channel-stacked over ALL factors in one
        # gather pass per row-layout position (factor f's qB depends only on
        # the PRE-SWEEP v[f], which is exactly what the scan consumes)
        qB_pre = []
        for rd, rs in zip(rels, rstats):
            v_r = jax.lax.dynamic_slice_in_dim(v, rs.attr_offset,
                                               rs.num_attrs, axis=1)  # [K, Dr]
            qB = jnp.zeros((K, rs.num_rows), dtype)
            for p in range(rd.rrow_ids.shape[1]):
                qB = qB + (jnp.take(v_r, rd.rrow_ids[:, p], axis=-1)
                           * rd.rrow_vals[:, p][None])
            qB_pre.append(qB)

        # factor execution: blocked by default (cfg.factor_block=0 is
        # auto-resolved by the learner; =1 forces the reference's
        # factor-sequential chain, the exact reference coordinate order)
        F_eff = 1 if cfg.factor_block == 1 else \
            (min(cfg.factor_block, K) if cfg.factor_block > 0 else K)
        if F_eff > 1 and K % F_eff == 0:
            e, v, key = _bs_v_blocked(e, v, v_mu, v_lambda, alpha, plan, row,
                                      rels, rstats, cfg, qB_pre, F_eff, key,
                                      counters=counters)
            joins = [rd.join_tr for rd in rels]
            yhat = bs_scores(w0, w, v, row.ids, row.vals, rels, rstats, joins,
                             k0=cfg.k0, k1=cfg.k1)
            if cfg.task == TASK_REGRESSION:
                yhat = yhat - row.target
            return MCMCState(w0=w0, w=w, v=v, alpha=alpha, w_mu=w_mu,
                             w_lambda=w_lambda, v_mu=v_mu, v_lambda=v_lambda,
                             e=yhat, key=key), dict(counters)

        def f_step(carry, xs):
            # v nan/inf counts ride the carry (a dict mutated inside the
            # scan body would leak its tracers)
            e, key, vnan, vinf = carry
            local: dict = {}
            v_f, mu_f, lam_f, qB_all = xs  # [D_all], [G], [G], per-rel [R]
            # total q: main row layout + per-relation qB gathers
            q = jnp.zeros_like(e)
            for p in range(row.ids.shape[1]):
                q = q + jnp.take(v_f, row.ids[:, p]) * row.vals[:, p]
            for rd, qB in zip(rels, qB_all):
                q = q + jnp.take(qB, rd.join_tr)
            # --- main-block bins + unobserved-main prior draws (shared
            # helper; relation attrs stay untouched via the padded mask) ---
            e, q, v_f, key = v_factor_main_bins(
                e, q, v_f, mu_f, lam_f, alpha, plan, row, cfg, key,
                counters=local)

            # --- relation sweeps (draw_v_rel, fm_learn_mcmc.h:842-899) ---
            for r_i, (rd, rs) in enumerate(zip(rels, rstats)):
                R, Dr, off = rs.num_rows, rs.num_attrs, rs.attr_offset
                qB = qB_all[r_i]
                qO = q - jnp.take(qB, rd.join_tr)
                # per-rho aggregates over the join: one 4-channel [4, N]
                # gather pass (e, e*qO, qO, qO^2)
                ch = jnp.stack([e, e * qO, qO, qO * qO], axis=0)
                parts = _join_aggregate(ch, rd.jplan)
                parts = [(c, _psum(p)) for c, p in parts]
                agg = _scatter_agg(R, parts, dtype)
                we, weq, wc, wc2 = agg[0], agg[1], agg[2], agg[3]
                qB0 = qB
                dy = jnp.zeros((R,), dtype)
                vr = jax.lax.dynamic_slice_in_dim(v_f, off, Dr)
                if cfg.do_sample:
                    key, sub = jax.random.split(key)
                    zv = jax.random.normal(sub, (Dr,), dtype)
                else:
                    zv = None
                for b_i, bin_blocks in enumerate(rd.rplan):
                    if not bin_blocks:
                        continue
                    v_old_r = vr
                    dvr = jnp.zeros((Dr,), dtype)
                    for blk in bin_blocks:
                        x = blk.x
                        g = take_cols(
                            jnp.stack([qB, we, weq, wc, wc2, rd.wnum]),
                            blk.rows)  # [6, C, L]
                        qB_g, we_g, weq_g, wc_g, wc2_g, wn_g = (
                            g[0], g[1], g[2], g[3], g[4], g[5])
                        v_c = _gather(v_old_r, blk.cols)
                        mu_g = _gather(mu_f, blk.group)
                        lam_g = _gather(lam_f, blk.group)
                        h = x * (qB_g - x * v_c[:, None])
                        she = (h * we_g + x * weq_g).sum(-1)
                        sh2 = (h * h * wn_g + 2.0 * wc_g * x * h
                               + x * x * wc2_g).sum(-1)
                        v_mean = she - v_c * sh2
                        s2 = 1.0 / (lam_g + alpha * sh2)
                        mean = -s2 * (alpha * v_mean - mu_g * lam_g)
                        if zv is not None:
                            val = mean + jnp.sqrt(s2) * _gather(zv, blk.cols)
                        else:
                            val = mean
                        val = jnp.where(jnp.isfinite(s2), val,
                                        jnp.zeros_like(val))
                        _count_bad(local, "v", val)
                        new_v = keep_finite(val, v_c)
                        vr = vr.at[blk.cols].set(new_v)
                        dvr = dvr.at[blk.cols].set(v_c - new_v)
                    # relation-row-layout cache patch (reference draw_v_rel
                    # final loop): each rho has <=1 in-bin entry, so h uses
                    # the pre-patch qB of its own row
                    vtab = jnp.stack([v_old_r, dvr], axis=0)
                    for p in rs.patch_pos[b_i]:
                        g = jnp.take(vtab, rd.rrow_ids[:, p], axis=-1)
                        xp = rd.rrow_vals[:, p]
                        v_e, dv_e = g[0], g[1]
                        h_e = xp * (qB - xp * v_e)
                        we = we - dv_e * (h_e * rd.wnum + xp * wc)
                        weq = weq - dv_e * (h_e * wc + xp * wc2)
                        dy = dy - dv_e * h_e
                        qB = qB - xp * dv_e
                # unobserved relation attrs -> prior (zv reused: unused z's)
                mu_d = _gather(mu_f, rd.attr_group)
                lam_d = _gather(lam_f, rd.attr_group)
                s2_d = 1.0 / lam_d
                un = mu_d + jnp.sqrt(s2_d) * zv if zv is not None else mu_d
                un = jnp.where(jnp.isfinite(s2_d), un, jnp.zeros_like(un))
                _count_bad(local, "v", jnp.where(rd.unobserved, un, 0.0))
                vr = jnp.where(rd.unobserved, keep_finite(un, vr), vr)
                v_f = jax.lax.dynamic_update_slice_in_dim(v_f, vr, off, axis=0)
                # resync e and q (reference end-of-relation sync)
                dqB = qB - qB0
                g = take_cols(jnp.stack([dy, dqB]), rd.join_tr)  # [2, N]
                e = e + g[0] + qO * g[1]
                q = q + g[1]
            vnan = vnan + local.get("nan_v", 0)
            vinf = vinf + local.get("inf_v", 0)
            return (e, key, vnan, vinf), v_f

        z32 = jnp.zeros((), jnp.int32)
        (e, key, vnan, vinf), v = jax.lax.scan(
            f_step, (e, key, z32, z32), (v, v_mu.T, v_lambda.T, tuple(qB_pre)))
        counters["nan_v"] = counters["nan_v"] + vnan
        counters["inf_v"] = counters["inf_v"] + vinf

    # --- full re-predict (fm_learn_mcmc.h predict_data_and_write_to_eterms) ---
    joins = [rd.join_tr for rd in rels]
    yhat = bs_scores(w0, w, v, row.ids, row.vals, rels, rstats, joins,
                     k0=cfg.k0, k1=cfg.k1)
    if cfg.task == TASK_REGRESSION:
        yhat = yhat - row.target

    return MCMCState(w0=w0, w=w, v=v, alpha=alpha, w_mu=w_mu,
                     w_lambda=w_lambda, v_mu=v_mu, v_lambda=v_lambda,
                     e=yhat, key=key), dict(counters)


# ---------------------------------------------------------------------------
# Learner
# ---------------------------------------------------------------------------

class MCMCBSLearner(MCMCLearner):
    """MCMC/ALS over relational block structure, never materializing the
    join.  ``train``/``test`` are the MAIN design blocks (may have zero
    columns when all features live in relations); ``relations`` +
    ``joins_train``/``joins_test`` carry the factored tables.  ``meta`` must
    be the JOINED meta (``build_joined_meta``), and ``cfg.num_attributes``
    the joined attribute count."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, relations: list[RelationData],
                 joins_train: list[np.ndarray], joins_test: list[np.ndarray],
                 meta: DataMetaInfo, num_main_attributes: int,
                 mesh=None, bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True,
                 w_lambda_init: Optional[np.ndarray] = None,
                 v_lambda_init: Optional[np.ndarray] = None):
        from svbfm.parallel.mesh import make_mesh

        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        n = self.mesh.devices.size
        self.meta = meta
        self.num_main_attributes = num_main_attributes
        coo = train.to_coo()
        # main plan over the main columns only; pad unobserved to D_all with
        # False so relation attrs are never prior-drawn by the main sweep
        self.plan = SweepPlan.build(coo, num_main_attributes,
                                    meta_groups=meta.attr_group[:num_main_attributes],
                                    bins=bins, n_shards=n)
        pad = np.zeros(cfg.num_attributes, dtype=bool)
        pad[:num_main_attributes] = self.plan.unobserved
        self.plan.unobserved = pad
        self.train_row, self.train_n = build_row_data(self.mesh, train)
        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.plan_data = build_plan_data(self.mesh, self.plan, meta)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.train_target = self.train_row.target
        self.out_dir = out_dir
        self.write_files = write_files
        self.w_lambda_init = (w_lambda_init if w_lambda_init is not None
                              else np.full(cfg.num_groups, cfg.regw, np.float32))
        self.v_lambda_init = (v_lambda_init if v_lambda_init is not None
                              else np.full((cfg.num_groups, cfg.num_factor),
                                           cfg.regv, np.float32))

        n_tr_pad = self.train_row.ids.shape[0]
        n_te_pad = self.test_row.ids.shape[0]
        devs, stats = [], []
        min_off = num_main_attributes
        for rel, jt, je in zip(relations, joins_train, joins_test):
            assert rel.attr_offset >= min_off, (
                "relation attr_offset overlaps the main block or an earlier "
                "relation — call build_joined_meta(meta_main, relations) "
                "before constructing the learner")
            min_off = rel.attr_offset + rel.num_features
            d, s = _build_rel_device(self.mesh, rel, np.asarray(jt),
                                     np.asarray(je), meta.attr_group,
                                     n_tr_pad, n_te_pad, bins=bins)
            devs.append(d)
            stats.append(s)
        self.rels = tuple(devs)
        self.rstats = tuple(stats)
        if cfg.factor_block == 0 and cfg.num_factor > 1:
            # auto-pick the factor block so both the main-block pass and the
            # relation moments pass fit the HBM budget (1 = sequential scan)
            import dataclasses

            n_loc = self.train_row.ids.shape[0] // n
            max_R = max((s.num_rows for s in stats), default=1)
            has_main = any(len(bb) for bb in self.plan.blocks)
            fb = _bs_auto_factor_block(cfg.num_factor, n_loc, max_R,
                                       plan=self.plan if has_main else None)
            cfg = dataclasses.replace(cfg, factor_block=fb)
            self.cfg = cfg
        self._extra_args = (self.rels,)
        self._extra_specs = (tuple(_rel_specs(d) for d in self.rels),)
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        num_cases = float(self.train_n)

        def step_fn(state, row, plan, rels):
            return mcmc_bs_draw_all(state, row, plan, rels, cfg, self.rstats,
                                    num_cases)

        self._step = jax.jit(jax.shard_map(
            step_fn, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs(),
                      plan_specs_for(self.plan_data), *self._extra_specs),
            out_specs=(_state_specs(), self._nanspec()),
        ))

        def scores_fn(w0, w, v, ids, vals, rels, joins):
            return bs_scores(w0, w, v, ids, vals, rels, self.rstats, joins,
                             k0=cfg.k0, k1=cfg.k1)

        shd = P(DATA_AXIS)
        self._bs_scores_tr = jax.jit(jax.shard_map(
            scores_fn, mesh=self.mesh,
            in_specs=(P(), P(), P(), shd, shd, *self._extra_specs,
                      tuple(shd for _ in self.rels)),
            out_specs=shd))
        self._fused_cache = {}

    # Both BS factor paths carry a lax.scan over factors, and multi-iteration
    # fusion around it lost on the earlier accelerator (outer scan and
    # Python unrolling alike; not measured on the H100).  One iteration per
    # program.
    _default_chunk = 1

    def _clamp_chunk(self, chunk: int) -> int:
        if chunk > 1:
            import warnings
            warnings.warn(
                "BS learners run chunk=1: multi-iteration fusion around the "
                "factor scan compiles to a 5-20x slower program on this "
                "stack (see mcmc_bs._default_chunk); clamping chunk "
                f"{chunk} -> 1", stacklevel=3)
        return min(chunk, 1)

    def _fused_steps(self, chunk: int):
        """Python-unrolled multi-iteration program (no outer ``lax.scan``).

        The base class fuses ``chunk`` iterations with an outer ``lax.scan``;
        nesting the BS factor scan inside it compiles to a 4x slower program
        (see ``_default_chunk``).  Unrolling keeps the factor scan at top
        level — and at the default ``chunk=1`` removes the outer loop
        entirely.  The metrics pytree is stacked to preserve the
        ``[chunk, ...]`` contract of ``MCMCLearner.run``."""
        if chunk in self._fused_cache:
            return self._fused_cache[chunk]
        shd = P(DATA_AXIS)

        def multi(state, psum_all, psum_but5, it0, row, plan, trow, *extras):
            carry = (state, psum_all, psum_but5, it0)
            ms = []
            for _ in range(chunk):
                carry, m = self._iter_body(carry, row, plan, trow, it0,
                                           *extras)
                ms.append(m)
            metrics = jax.tree.map(lambda *xs: jnp.stack(xs), *ms)
            state, psum_all, psum_but5, it = carry
            return state, psum_all, psum_but5, it, metrics

        fn = jax.jit(jax.shard_map(
            multi, mesh=self.mesh,
            in_specs=(self._sspec(), shd, shd, P(), self._rspec(),
                      self._pspec(), self._rspec(), *self._extra_specs),
            out_specs=(self._sspec(), shd, shd, P(), P()),
        ))
        self._fused_cache[chunk] = fn
        return fn

    def _draw_inprog(self, state, row, plan, *extras):
        (rels,) = extras
        return mcmc_bs_draw_all(state, row, plan, rels, self.cfg, self.rstats,
                                float(self.train_n))

    def _test_scores_inprog(self, state, trow, *extras):
        (rels,) = extras
        joins = [rd.join_te for rd in rels]
        return bs_scores(state.w0, state.w, state.v, trow.ids, trow.vals,
                         rels, self.rstats, joins, k0=self.cfg.k0,
                         k1=self.cfg.k1)

    def init_state(self, key: Optional[jax.Array] = None) -> MCMCState:
        from svbfm.models.fm import init_fm_params

        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev, init_w_normal=True)
        joins = tuple(rd.join_tr for rd in self.rels)
        yhat = self._bs_scores_tr(params.w0, params.w, params.v,
                                  self.train_row.ids, self.train_row.vals,
                                  self.rels, joins)
        e = yhat - self.train_row.target
        G, K = cfg.num_groups, cfg.num_factor
        state = MCMCState(
            w0=params.w0, w=params.w, v=params.v,
            alpha=jnp.ones((), jnp.float32),
            w_mu=jnp.zeros((G,), jnp.float32),
            w_lambda=jnp.asarray(self.w_lambda_init, jnp.float32),
            v_mu=jnp.zeros((G, K), jnp.float32),
            v_lambda=jnp.asarray(self.v_lambda_init, jnp.float32),
            e=e, key=key)
        from jax.sharding import NamedSharding
        shardings = jax.tree.map(lambda spec: NamedSharding(self.mesh, spec),
                                 _state_specs())
        return jax.device_put(state, shardings)

    def predict_test_scores(self, state: MCMCState) -> np.ndarray:
        joins = tuple(rd.join_te for rd in self.rels)
        s = self._bs_scores_te(state.w0, state.w, state.v,
                               self.test_row.ids, self.test_row.vals,
                               self.rels, joins)
        return np.asarray(s)[: self.test_n]

    @property
    def _bs_scores_te(self):
        return self._bs_scores_tr  # same program; join arrays differ


class ALSBSLearner(MCMCBSLearner):
    """ALS over block structure (do_sample=False, do_multilevel=False)."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        import dataclasses
        cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=False)
        super().__init__(cfg, *args, **kwargs)
