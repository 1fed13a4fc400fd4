"""Native relational block structure (learners.mcmc_bs).

Validates the BS sampler's relation-cache algebra (draw_w_rel/draw_v_rel,
fm_learn_mcmc.h:722-899) against (a) the materialized-join MCMC/ALS learner
— model-identical by construction — and (b) the float64 naive-statistics
oracle walking the same coordinate order on the expanded design matrix."""

import dataclasses

import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.libfm_text import COOData
from svbfm.data.meta import DataMetaInfo
from svbfm.data.relation import (RelationData, build_joined_meta,
                                 join_relations)
from svbfm.learners.base import FMConfig
from svbfm.learners.mcmc import ALSLearner, MCMCLearner
from svbfm.learners.mcmc_bs import ALSBSLearner, MCMCBSLearner
from svbfm.parallel.mesh import make_mesh

from oracle import BinOrderALSOracle


def _setup(n=240, n_users=9, n_items=5, K=3, seed=0, wide=2):
    """Main block: user one-hots.  Relation: item one-hot + `wide-1` shared
    attributes per item row (so the expanded design is wider than the main)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    y = (2.0 + 0.3 * users - 0.2 * items
         + 0.4 * rng.standard_normal(n)).astype(np.float32)
    main = COOData(row=np.arange(n, dtype=np.int32),
                   col=users.astype(np.int32),
                   val=np.ones(n, np.float32), target=y,
                   num_rows=n, num_features=n_users)
    per = [np.arange(n_items, dtype=np.int32)]
    cols = [np.arange(n_items, dtype=np.int32)]
    vals = [np.ones(n_items, np.float32)]
    for wi in range(wide - 1):
        per.append(np.arange(n_items, dtype=np.int32))
        cols.append(n_items + wi * 2 + (np.arange(n_items, dtype=np.int32) % 2))
        vals.append(np.full(n_items, 0.5 + 0.5 * wi, np.float32))
    order = np.argsort(np.concatenate(per), kind="stable")
    rel = RelationData(
        row=np.concatenate(per)[order], col=np.concatenate(cols)[order],
        val=np.concatenate(vals)[order], num_rows=n_items,
        num_features=n_items + 2 * (wide - 1),
        meta=DataMetaInfo(n_items + 2 * (wide - 1)))
    meta = build_joined_meta(DataMetaInfo(n_users), [rel])
    cfg = FMConfig(num_attributes=meta.num_attributes, num_factor=K,
                   num_groups=meta.num_attr_groups,
                   min_target=float(y.min()), max_target=float(y.max()),
                   regw=0.05, regv=0.05, seed=3)
    return main, rel, items, meta, cfg, n_users


@pytest.mark.parametrize("n_dev", [1, 4])
def test_bs_als_matches_materialized(n_dev):
    """The BS sweep must reproduce the materialized-join factor-sequential
    ALS trajectory exactly (same coordinate order, same conditionals)."""
    main, rel, items, meta, cfg, d_main = _setup()
    mesh = make_mesh(n_dev)
    D = cfg.num_attributes
    tr = SparseDataset.from_coo(main, D)
    bs = ALSBSLearner(dataclasses.replace(cfg, factor_block=1), tr, tr,
                      [rel], [items], [items], meta, d_main,
                      mesh=mesh, write_files=False)
    s_bs, h_bs = bs.run(num_iter=4, verbose=False)

    joined = join_relations(main, [rel], [items], d_main)
    trj = SparseDataset.from_coo(joined, D)
    mat = ALSLearner(dataclasses.replace(cfg, factor_block=1), trj, trj,
                     meta, mesh=mesh, write_files=False)
    s_m, h_m = mat.run(num_iter=4, verbose=False)
    for hb, hm in zip(h_bs, h_m):
        assert abs(hb["rmse"] - hm["rmse"]) < 1e-5
    np.testing.assert_allclose(np.asarray(s_bs.w), np.asarray(s_m.w),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(s_bs.v), np.asarray(s_m.v),
                               rtol=2e-3, atol=2e-4)


def test_bs_als_matches_binorder_oracle():
    """Independent float64 validation: the oracle computes every conditional
    NAIVELY from the expanded matrix in the BS coordinate order (main bins
    first, then relation bins), so it cross-checks the relation-cache
    algebra (we/weq/wc/wc2 aggregates + closed-form patches) end to end."""
    main, rel, items, meta, cfg, d_main = _setup()
    mesh = make_mesh(1)
    D = cfg.num_attributes
    tr = SparseDataset.from_coo(main, D)
    bs = ALSBSLearner(dataclasses.replace(cfg, factor_block=1), tr, tr,
                      [rel], [items], [items], meta, d_main,
                      mesh=mesh, write_files=False)
    # combined bin coloring: main plan bins, then each relation's bins after
    color = np.zeros(D, np.int32)
    color[:d_main] = bs.plan.color[:d_main]
    nb = bs.plan.num_bins
    rplan_color = None
    from svbfm.data.dataset import SweepPlan
    rcoo = COOData(row=rel.row, col=rel.col, val=rel.val,
                   target=np.zeros(rel.num_rows, np.float32),
                   num_rows=rel.num_rows, num_features=rel.num_features)
    rplan = SweepPlan.build(rcoo, rel.num_features, bins="auto", n_shards=1)
    color[d_main:] = rplan.color + nb

    joined = join_relations(main, [rel], [items], d_main)
    orc = BinOrderALSOracle(joined.row, joined.col, joined.val, joined.target,
                            D, cfg.num_factor, groups=meta.attr_group,
                            regw=0.05, regv=0.05, color=color, factor_block=1)
    state = bs.init_state()
    orc.init(float(state.w0), np.asarray(state.w), np.asarray(state.v))
    for _ in range(3):
        state, _nans = bs._step(state, bs.train_row, bs.plan_data, bs.rels)
        orc.iterate()
        np.testing.assert_allclose(float(state.w0), orc.w0, rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(state.w), orc.w, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.v), orc.v, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(
            np.asarray(state.e)[: joined.num_rows], orc.e, rtol=5e-3,
            atol=5e-3)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_bs_gibbs_trajectory_matches_materialized(n_dev):
    """Sampling mode: same seed + same coordinate order -> the BS Gibbs
    chain must track the materialized-join chain (identical draws up to
    f32 reduction-order noise)."""
    main, rel, items, meta, cfg, d_main = _setup(n=400)
    mesh = make_mesh(n_dev)
    D = cfg.num_attributes
    tr = SparseDataset.from_coo(main, D)
    bs = MCMCBSLearner(dataclasses.replace(cfg, factor_block=1), tr, tr,
                       [rel], [items], [items], meta, d_main,
                       mesh=mesh, write_files=False)
    s_bs, h_bs = bs.run(num_iter=8, verbose=False)
    joined = join_relations(main, [rel], [items], d_main)
    trj = SparseDataset.from_coo(joined, D)
    mat = MCMCLearner(dataclasses.replace(cfg, factor_block=1), trj, trj,
                      meta, mesh=mesh, write_files=False)
    s_m, h_m = mat.run(num_iter=8, verbose=False)
    # identical key chains draw the same randomness only while the programs
    # stay bit-identical; reductions differ, so compare the posterior-mean
    # trajectory loosely
    assert abs(h_bs[-1]["rmse"] - h_m[-1]["rmse"]) < 0.05
    assert h_bs[-1]["rmse"] < 0.6


def test_bs_never_materializes_the_join():
    """Device memory scales with N + nnz(rel) + R: the widest relation row
    never multiplies the train-row layout."""
    main, rel, items, meta, cfg, d_main = _setup(wide=6)  # 6 attrs/item row
    mesh = make_mesh(1)
    D = cfg.num_attributes
    tr = SparseDataset.from_coo(main, D)
    bs = ALSBSLearner(cfg, tr, tr, [rel], [items], [items], meta, d_main,
                      mesh=mesh, write_files=False)
    # main row layout stays 1 nnz/row even though the joined design has 7
    assert bs.train_row.ids.shape[1] == 1
    rd = bs.rels[0]
    assert rd.rrow_ids.shape == (rel.num_rows, 6)
    joined = join_relations(main, [rel], [items], d_main)
    ds_joined = SparseDataset.from_coo(joined, D)
    assert ds_joined.ids.shape[1] == 7  # what materialization would cost
    _, h = bs.run(num_iter=2, verbose=False)
    assert np.isfinite(h[-1]["rmse"])


def test_bs_classification():
    main, rel, items, meta, cfg, d_main = _setup(n=400)
    from svbfm.learners.base import TASK_CLASSIFICATION
    y = np.where(main.target > np.median(main.target), 1.0, -1.0)
    main.target = y.astype(np.float32)
    cfg = dataclasses.replace(cfg, task=TASK_CLASSIFICATION, min_target=-1,
                              max_target=1)
    mesh = make_mesh(1)
    tr = SparseDataset.from_coo(main, cfg.num_attributes)
    bs = MCMCBSLearner(cfg, tr, tr, [rel], [items], [items], meta, d_main,
                       mesh=mesh, write_files=False)
    _, h = bs.run(num_iter=8, verbose=False)
    assert h[-1]["accuracy"] > 0.6


@pytest.mark.parametrize("n_dev", [1, 4])
def test_bs_blocked_als_matches_oracle(n_dev):
    """The factor-blocked BS sweep (default path: ONE moments join-pass per
    relation per block + closed-form we/weq cross-factor corrections) must
    match a float64 oracle that walks the same coordinate order naively on
    the expanded design matrix."""
    from oracle import BSBlockedALSOracle

    main, rel, items, meta, cfg, d_main = _setup()
    mesh = make_mesh(n_dev)
    D = cfg.num_attributes
    tr = SparseDataset.from_coo(main, D)
    bs = ALSBSLearner(cfg, tr, tr, [rel], [items], [items], meta, d_main,
                      mesh=mesh, write_files=False)
    assert bs.cfg.factor_block == cfg.num_factor  # auto -> full block

    from svbfm.data.dataset import SweepPlan
    main_bins = [np.flatnonzero(bs.plan.color[:d_main] == b)
                 for b in range(bs.plan.num_bins)]
    rcoo = COOData(row=rel.row, col=rel.col, val=rel.val,
                   target=np.zeros(rel.num_rows, np.float32),
                   num_rows=rel.num_rows, num_features=rel.num_features)
    rplan = SweepPlan.build(rcoo, rel.num_features, bins="auto", n_shards=1)
    rel_bins = [[d_main + np.flatnonzero(rplan.color == b)
                 for b in range(rplan.num_bins)]]

    joined = join_relations(main, [rel], [items], d_main)
    orc = BSBlockedALSOracle(joined.row, joined.col, joined.val,
                             joined.target, D, cfg.num_factor,
                             groups=meta.attr_group, regw=0.05, regv=0.05,
                             main_bins=main_bins, rel_bins=rel_bins,
                             factor_block=cfg.num_factor)
    state = bs.init_state()
    orc.init(float(state.w0), np.asarray(state.w), np.asarray(state.v))
    for _ in range(3):
        state, _nans = bs._step(state, bs.train_row, bs.plan_data, bs.rels)
        orc.iterate()
        np.testing.assert_allclose(float(state.w0), orc.w0, rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(state.w), orc.w, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.v), orc.v, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(
            np.asarray(state.e)[: joined.num_rows], orc.e, rtol=5e-3,
            atol=5e-3)


def test_bs_blocked_gibbs_matches_sequential_closely():
    """Blocked BS Gibbs (a different but equally valid scan order) must
    reach the same posterior as the factor-sequential chain."""
    main, rel, items, meta, cfg, d_main = _setup(n=400)
    mesh = make_mesh(1)
    tr = SparseDataset.from_coo(main, cfg.num_attributes)
    l_blk = MCMCBSLearner(cfg, tr, tr, [rel], [items], [items], meta, d_main,
                          mesh=mesh, write_files=False)
    assert l_blk.cfg.factor_block == cfg.num_factor
    l_seq = MCMCBSLearner(dataclasses.replace(cfg, factor_block=1), tr, tr,
                          [rel], [items], [items], meta, d_main,
                          mesh=mesh, write_files=False)
    _, h_blk = l_blk.run(num_iter=10, verbose=False)
    _, h_seq = l_seq.run(num_iter=10, verbose=False)
    assert abs(h_blk[-1]["rmse"] - h_seq[-1]["rmse"]) < 0.05
    assert h_blk[-1]["rmse"] < 0.6


@pytest.mark.parametrize("fb", [1, 3])
def test_bs_nan_counters_surface(fb):
    """The BS draw surfaces the reference's nan/inf counters on BOTH factor
    paths (sequential fb=1 and blocked fb=K), all zero on a healthy run."""
    from svbfm.learners.mcmc import NAN_FAMILIES

    main, rel, items, meta, cfg, d_main = _setup()
    D = cfg.num_attributes
    tr = SparseDataset.from_coo(main, D)
    bs = MCMCBSLearner(dataclasses.replace(cfg, factor_block=fb), tr, tr,
                       [rel], [items], [items], meta, d_main,
                       mesh=make_mesh(1), write_files=False)
    _state, hist = bs.run(num_iter=2, verbose=False)
    for rec in hist:
        for fam in NAN_FAMILIES:
            assert rec[f"nan_{fam}"] == 0
            assert rec[f"inf_{fam}"] == 0


@pytest.mark.parametrize("n_dev", [1, 4])
def test_bs_unrolled_chunk_matches_chunk1(n_dev):
    """MCMCBSLearner._fused_steps unrolls the multi-iteration loop in Python
    (the factor lax.scan must stay at top level on this stack); the unrolled
    chunk=2 program must reproduce the chunk=1 trajectory exactly."""
    main, rel, items, meta, cfg, d_main = _setup()
    mesh = make_mesh(n_dev)
    tr = SparseDataset.from_coo(main, cfg.num_attributes)

    def traj(chunk):
        l = MCMCBSLearner(cfg, tr, tr, [rel], [items], [items], meta,
                          d_main, mesh=mesh, write_files=False)
        _s, h = l.run(num_iter=4, verbose=False, chunk=chunk)
        return [r["rmse"] for r in h]

    r1, r2 = traj(1), traj(2)
    assert len(r1) == len(r2) == 4
    np.testing.assert_allclose(r1, r2, rtol=1e-6, atol=1e-7)
