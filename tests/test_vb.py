import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, make_tiny, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.vb import VBLearner, VBState, init_vb_params
from svbfm.parallel.mesh import make_mesh

from oracle import VBOracle


def _setup(num_rows=96, num_users=9, num_items=7, K=3, n_dev=1, seed=2,
           **cfg_kw):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K, task=0,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, **cfg_kw)
    mesh = make_mesh(n_dev)
    tr_ds = SparseDataset.from_coo(tr, D)
    te_ds = SparseDataset.from_coo(te, D)
    learner = VBLearner(cfg, tr_ds, te_ds, meta, mesh=mesh, write_files=False)
    return coo, tr, te, cfg, learner, meta


def _oracle_from_state(tr, cfg, meta, state: VBState):
    orc = VBOracle(tr.row, tr.col, tr.val, tr.target, cfg.num_attributes,
                   cfg.num_factor, groups=meta.attr_group)
    orc.init(float(state.mu_0), float(state.sigma_0_dash),
             np.asarray(state.mu_w), np.asarray(state.sigma_w_dash),
             np.asarray(state.mu_v), np.asarray(state.sigma_v_dash))
    return orc


@pytest.mark.parametrize("n_dev", [1, 4])
def test_vb_matches_serial_oracle(n_dev):
    # factor_block=1 == reference-exact factor-sequential Gauss-Seidel
    coo, tr, te, cfg, learner, meta = _setup(n_dev=n_dev, factor_block=1)
    state = learner.init_state()
    orc = _oracle_from_state(tr, cfg, meta, state)

    # init caches agree
    np.testing.assert_allclose(np.asarray(state.e)[: tr.num_rows], orc.e, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(state.t)[: tr.num_rows], orc.t, rtol=2e-4, atol=2e-4)

    fes = []
    for it in range(3):
        state, fe = learner._step(state, learner.train_row, learner.plan_data)
        fe_o = orc.iterate()
        fes.append((float(fe), fe_o))
        np.testing.assert_allclose(np.asarray(state.mu_w), orc.mu_w, rtol=3e-3, atol=3e-4)
        np.testing.assert_allclose(np.asarray(state.mu_v), orc.mu_v, rtol=3e-3, atol=3e-4)
        np.testing.assert_allclose(np.asarray(state.sigma_w_dash), orc.sigma_w_dash, rtol=3e-3, atol=1e-6)
        np.testing.assert_allclose(float(state.alpha), orc.alpha, rtol=3e-3)
        np.testing.assert_allclose(float(state.mu_0), orc.mu_0, rtol=3e-3, atol=1e-5)
    for fe, fe_o in fes:
        np.testing.assert_allclose(fe, fe_o, rtol=2e-3)


def test_vb_free_energy_increases():
    coo, tr, te, cfg, learner, meta = _setup(num_rows=400, num_users=15, num_items=12, K=4)
    state, history = learner.run(num_iter=8, verbose=False)
    fes = [h["free_energy"] for h in history]
    # coordinate ascent on the ELBO: free energy must be non-decreasing
    # (allow tiny f32 jitter)
    for a, b in zip(fes, fes[1:]):
        assert b >= a - abs(a) * 1e-4


def test_vb_rmse_improves():
    coo, tr, te, cfg, learner, meta = _setup(num_rows=2000, num_users=30, num_items=25, K=4)
    state, history = learner.run(num_iter=10, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0


def test_vb_sharding_invariance():
    """Same math on 1 device and on 8 devices."""
    _, tr, te, cfg, l1, meta = _setup(num_rows=128, n_dev=1, seed=5)
    _, _, _, _, l8, _ = _setup(num_rows=128, n_dev=8, seed=5)
    s1 = l1.init_state()
    s8 = l8.init_state()
    np.testing.assert_allclose(np.asarray(s1.mu_v), np.asarray(s8.mu_v))
    for _ in range(2):
        s1, fe1 = l1._step(s1, l1.train_row, l1.plan_data)
        s8, fe8 = l8._step(s8, l8.train_row, l8.plan_data)
    np.testing.assert_allclose(np.asarray(s1.mu_v), np.asarray(s8.mu_v), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(float(fe1), float(fe8), rtol=1e-3)


def test_tiling_predicate_matches_kernel_and_is_exact(monkeypatch):
    """_needs_row_tiling and the kernel share the tile-count helpers; with a
    tiny budget the tiled path (chunk=1, internal lax.scan tiling) must
    engage AND reproduce the untiled trajectory exactly (tiling is a pure
    memory transform)."""
    from svbfm.learners import vb as vbmod

    coo, tr, te, cfg, learner, meta = _setup(num_rows=400, num_users=15,
                                             num_items=12, K=4)
    assert learner._needs_row_tiling() is False
    _, hist_ref = learner.run(num_iter=3, verbose=False)

    # shrink the budget so both column and row tiling engage at test scale
    monkeypatch.setattr(vbmod, "VB_TILE_BUDGET", 4096)
    learner2 = VBLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                         SparseDataset.from_coo(te, cfg.num_attributes), meta,
                         mesh=make_mesh(1), write_files=False)
    assert learner2._needs_row_tiling() is True
    # predicate agrees with the kernel's actual tile counts
    F = cfg.num_factor
    merge_w = cfg.k1 and cfg.factor_block == 0 and F > 0
    n_loc = learner2.train_row.ids.shape[0]
    engages = vbmod._row_tile_count(
        n_loc, vbmod._patch_channels(F, merge_w)) > 1 or any(
        vbmod._col_tile_count(blk.rows.shape[1], blk.rows.shape[2], F) > 1
        for bb in learner2.plan.blocks for blk in bb)
    assert engages == learner2._needs_row_tiling()

    _, hist_tiled = learner2.run(num_iter=3, verbose=False)
    for r_ref, r_tl in zip(hist_ref, hist_tiled):
        np.testing.assert_allclose(r_tl["rmse"], r_ref["rmse"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r_tl["free_energy"], r_ref["free_energy"],
                                   rtol=1e-5)

    # split-stats mode (huge-N memory path: per-table e/q/tq gathers
    # instead of the [1+2F, N] stack) is a pure memory transform too
    monkeypatch.setattr(vbmod, "VB_STATS_STACK_BYTES", 64)
    learner3 = VBLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                         SparseDataset.from_coo(te, cfg.num_attributes), meta,
                         mesh=make_mesh(1), write_files=False)
    assert vbmod._split_stats_gathers(
        learner3.train_row.ids.shape[0], cfg.num_factor or 1)
    _, hist_split = learner3.run(num_iter=3, verbose=False)
    for r_ref, r_sp in zip(hist_ref, hist_split):
        np.testing.assert_allclose(r_sp["rmse"], r_ref["rmse"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r_sp["free_energy"], r_ref["free_energy"],
                                   rtol=1e-5)


def test_quantum_padded_exact_tile_path(monkeypatch):
    """The pad-free in-place row-tiled patch (tile length divides n_loc —
    the path large quantum-padded datasets take, which avoided the 100M
    compile OOM) must reproduce the untiled trajectory exactly."""
    from svbfm.learners import base as basemod
    from svbfm.learners import vb as vbmod

    coo, tr, te, cfg, learner, meta = _setup(num_rows=3000, num_users=40,
                                             num_items=30, K=4)
    assert learner._needs_row_tiling() is False
    _, hist_ref = learner.run(num_iter=3, verbose=False)

    # quantum-pad the 3000-row dataset to 16384 rows and shrink the budget
    # so the row tiling engages with an exact divisor tile (nt=4096, rt=4)
    monkeypatch.setattr(basemod, "_ROW_QUANTUM_MIN_ROWS", 1000)
    monkeypatch.setattr(vbmod, "VB_TILE_BUDGET", 98304)
    learner2 = VBLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                         SparseDataset.from_coo(te, cfg.num_attributes), meta,
                         mesh=make_mesh(1), write_files=False)
    n_loc = learner2.train_row.ids.shape[0]
    assert n_loc == basemod.ROW_QUANTUM  # quantum padding engaged
    F = cfg.num_factor
    merge_w = cfg.k1 and cfg.factor_block == 0 and F > 0
    rt = vbmod._row_tile_count(n_loc, vbmod._patch_channels(F, merge_w))
    assert rt > 1
    assert vbmod._exact_tile_len(n_loc, rt) is not None  # pad-free path
    assert learner2._needs_row_tiling() is True

    _, hist_tiled = learner2.run(num_iter=3, verbose=False)
    for r_ref, r_tl in zip(hist_ref, hist_tiled):
        np.testing.assert_allclose(r_tl["rmse"], r_ref["rmse"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r_tl["free_energy"], r_ref["free_energy"],
                                   rtol=1e-5)


def test_staged_path_matches_fused(monkeypatch):
    """The staged huge-N path (W + per-factor-block + tail programs, used
    above VB_STAGE_UNITS) must reproduce the fused trajectory
    exactly — staging is a pure execution-schedule transform."""
    from svbfm.learners import vb as vbmod

    # K=5, factor_block=2 -> nb=3 with a padded tail block (K % F != 0),
    # exercising the drop-mode scatter of the last block
    coo, tr, te, cfg, learner, meta = _setup(num_rows=500, num_users=18,
                                             num_items=14, K=5,
                                             factor_block=2)
    assert learner._staged_mode() is False
    _, hist_ref = learner.run(num_iter=4, verbose=False)

    monkeypatch.setattr(vbmod, "VB_STAGE_UNITS", 10)
    monkeypatch.setenv("SVBFM_VB_PIPE", "1")  # opt-in pass pipelining
    learner2 = VBLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                         SparseDataset.from_coo(te, cfg.num_attributes), meta,
                         mesh=make_mesh(1), write_files=False)
    assert learner2._staged_mode() is True
    _, hist_st = learner2.run(num_iter=4, verbose=False)
    # the cross-program pass pipelining engaged (nb=3 > 1): block caches
    # were threaded between block programs and across iterations
    assert learner2._stage_pipelined is True
    assert learner2._vcache is not None
    for r_ref, r_st in zip(hist_ref, hist_st):
        np.testing.assert_allclose(r_st["rmse"], r_ref["rmse"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r_st["free_energy"], r_ref["free_energy"],
                                   rtol=1e-6)
        assert r_st["nan_v"] == r_ref["nan_v"]

    # sharded variant agrees too (psum'd stats under the staged split)
    learner8 = VBLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                         SparseDataset.from_coo(te, cfg.num_attributes), meta,
                         mesh=make_mesh(8), write_files=False)
    assert learner8._staged_mode() is True
    _, hist8 = learner8.run(num_iter=4, verbose=False)
    for r_ref, r8 in zip(hist_ref, hist8):
        np.testing.assert_allclose(r8["rmse"], r_ref["rmse"], rtol=2e-4)


def test_tz_free_patch_matches_carry(monkeypatch):
    """Above VB_TZ_CARRY_BYTES the kernel recomputes tz inside the patch
    tiles instead of carrying a third [F, N] cache (the 2.98 GiB margin
    at N=100M).  The fold is algebraically identical for conflict-free
    bins; trajectories must agree to rounding."""
    from svbfm.learners import vb as vbmod

    coo, tr, te, cfg, learner, meta = _setup(num_rows=700, num_users=20,
                                             num_items=16, K=5,
                                             factor_block=2)
    _, hist_ref = learner.run(num_iter=4, verbose=False)

    monkeypatch.setattr(vbmod, "VB_TZ_CARRY_BYTES", 1)
    l2 = VBLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                   SparseDataset.from_coo(te, cfg.num_attributes), meta,
                   mesh=make_mesh(1), write_files=False)
    _, hist_tf = l2.run(num_iter=4, verbose=False)
    for r_ref, r_tf in zip(hist_ref, hist_tf):
        np.testing.assert_allclose(r_tf["rmse"], r_ref["rmse"], rtol=3e-5)
        np.testing.assert_allclose(r_tf["free_energy"],
                                   r_ref["free_energy"], rtol=3e-5)

    # and under the forced tiled (chunk=1) path + 8-device mesh
    monkeypatch.setattr(vbmod, "VB_TILE_BUDGET", 4096)
    l8 = VBLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                   SparseDataset.from_coo(te, cfg.num_attributes), meta,
                   mesh=make_mesh(8), write_files=False)
    _, hist8 = l8.run(num_iter=4, verbose=False, chunk=1)
    for r_ref, r8 in zip(hist_ref, hist8):
        np.testing.assert_allclose(r8["rmse"], r_ref["rmse"], rtol=3e-4)
