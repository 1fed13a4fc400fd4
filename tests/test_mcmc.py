import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig, TASK_CLASSIFICATION
from svbfm.learners.mcmc import ALSLearner, MCMCLearner
from svbfm.parallel.mesh import make_mesh

from oracle import ALSOracle, BinOrderALSOracle


def _setup(num_rows=96, num_users=9, num_items=7, K=3, n_dev=1, seed=2,
           task=0, **kw):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    if task == TASK_CLASSIFICATION:
        thr = np.median(tr.target)
        tr.target = np.where(tr.target > thr, 1.0, -1.0).astype(np.float32)
        te.target = np.where(te.target > thr, 1.0, -1.0).astype(np.float32)
    cfg = FMConfig(num_attributes=D, num_factor=K, task=task,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, **kw)
    return tr, te, cfg, meta, make_mesh(n_dev)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_als_matches_serial_oracle(n_dev):
    # factor_block=1 == the reference's factor-sequential sweep
    tr, te, cfg, meta, mesh = _setup(n_dev=n_dev, regw=0.05, regv=0.05,
                                     factor_block=1)
    D = cfg.num_attributes
    learner = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                         SparseDataset.from_coo(te, D), meta, mesh=mesh,
                         write_files=False)
    state = learner.init_state()
    orc = ALSOracle(tr.row, tr.col, tr.val, tr.target, D, cfg.num_factor,
                    groups=meta.attr_group, regw=0.05, regv=0.05)
    orc.init(float(state.w0), np.asarray(state.w), np.asarray(state.v))
    np.testing.assert_allclose(np.asarray(state.e)[: tr.num_rows], orc.e,
                               rtol=2e-4, atol=2e-4)
    for it in range(3):
        state, _nans = learner._step(state, learner.train_row, learner.plan_data)
        orc.iterate()
        np.testing.assert_allclose(float(state.w0), orc.w0, rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(np.asarray(state.w), orc.w, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.v), orc.v, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.e)[: tr.num_rows], orc.e,
                                   rtol=5e-3, atol=5e-3)


def test_als_converges():
    tr, te, cfg, meta, mesh = _setup(num_rows=2000, num_users=30, num_items=25,
                                     K=4, regw=0.1, regv=0.1)
    D = cfg.num_attributes
    learner = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                         SparseDataset.from_coo(te, D), meta, mesh=mesh,
                         write_files=False)
    state, history = learner.run(num_iter=10, verbose=False)
    assert history[-1]["rmse_this"] < history[0]["rmse_this"]
    assert history[-1]["rmse_this"] < 1.0


def test_mcmc_converges_posterior_mean():
    tr, te, cfg, meta, mesh = _setup(num_rows=3000, num_users=30, num_items=25, K=4)
    D = cfg.num_attributes
    learner = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                          SparseDataset.from_coo(te, D), meta, mesh=mesh,
                          write_files=False)
    state, history = learner.run(num_iter=15, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0
    assert np.isfinite(history[-1]["alpha"])


def test_mcmc_classification():
    tr, te, cfg, meta, mesh = _setup(num_rows=3000, num_users=30, num_items=25,
                                     K=4, task=TASK_CLASSIFICATION)
    D = cfg.num_attributes
    learner = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                          SparseDataset.from_coo(te, D), meta, mesh=mesh,
                          write_files=False)
    state, history = learner.run(num_iter=10, verbose=False)
    assert history[-1]["accuracy"] > 0.6


@pytest.mark.parametrize("n_dev", [1, 4])
def test_als_blocked_matches_binorder_oracle(n_dev):
    """The factor-blocked sweep's closed-form cross-factor corrections must
    reproduce exact serial Gauss-Seidel in its (bin, factor, column)
    coordinate order — pinned by a float64 oracle walking that order.
    (Factor-Jacobi within bins, the pre-round-2 scheme, fails this.)"""
    tr, te, cfg, meta, mesh = _setup(n_dev=n_dev, K=4, regw=0.05, regv=0.05)
    D = cfg.num_attributes
    learner = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                         SparseDataset.from_coo(te, D), meta, mesh=mesh,
                         write_files=False)
    assert learner.cfg.factor_block == 4  # auto -> full block on tiny data
    state = learner.init_state()
    orc = BinOrderALSOracle(tr.row, tr.col, tr.val, tr.target, D,
                            cfg.num_factor, groups=meta.attr_group,
                            regw=0.05, regv=0.05, color=learner.plan.color)
    orc.init(float(state.w0), np.asarray(state.w), np.asarray(state.v))
    for it in range(3):
        state, _nans = learner._step(state, learner.train_row, learner.plan_data)
        orc.iterate()
        np.testing.assert_allclose(float(state.w0), orc.w0, rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(np.asarray(state.w), orc.w, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.v), orc.v, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.e)[: tr.num_rows], orc.e,
                                   rtol=5e-3, atol=5e-3)


def test_gibbs_blocked_matches_sequential_closely():
    """Factor-blocked Gibbs (channel-stacked gathers, in-bin sequential e_g
    updates) is a valid scan-order permutation of the reference chain: the
    posterior-mean RMSE trajectory should land where the factor-sequential
    sampler does."""
    import dataclasses
    tr, te, cfg, meta, mesh = _setup(num_rows=3000, num_users=30, num_items=25,
                                     K=4)
    D = cfg.num_attributes
    l_blk = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                        SparseDataset.from_coo(te, D), meta, mesh=mesh,
                        write_files=False)  # factor_block=0 -> blocked
    assert l_blk.cfg.factor_block == 4  # auto pick kept the full block
    l_seq = MCMCLearner(dataclasses.replace(cfg, factor_block=1),
                        SparseDataset.from_coo(tr, D),
                        SparseDataset.from_coo(te, D), meta, mesh=mesh,
                        write_files=False)
    s_b, h_b = l_blk.run(num_iter=15, verbose=False)
    s_q, h_q = l_seq.run(num_iter=15, verbose=False)
    assert abs(h_b[-1]["rmse"] - h_q[-1]["rmse"]) < 0.08
    assert h_b[-1]["rmse"] < 1.0


def test_auto_factor_block_clamps_to_budget(monkeypatch):
    """The auto factor block must pick a divisor of K whose temps fit the
    padded-element budget untiled; when nothing fits, the row/col-tiled
    sweep bounds the temps instead and the pick falls to the largest
    divisor <= 4 (the empirically optimal staged block), or 1 when K has
    no such divisor."""
    import svbfm.learners.mcmc as M
    tr, te, cfg, meta, mesh = _setup(K=6)
    D = cfg.num_attributes
    learner = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                          SparseDataset.from_coo(te, D), meta, mesh=mesh,
                          write_files=False)
    assert learner.cfg.factor_block == 6  # tiny data: full block fits
    peak6 = M._blocked_peak_elems(learner.plan, 6, 96)
    assert peak6 > 0
    # shrink the budget below the F=2 peak: nothing fits untiled -> the
    # tiled fallback picks the largest divisor of 6 that is <= 4
    monkeypatch.setattr(M, "MCMC_BLOCK_BUDGET",
                        M._blocked_peak_elems(learner.plan, 2, 96) - 1)
    assert M._auto_factor_block(learner.plan, 6, 96) == 3
    assert M._auto_factor_block(learner.plan, 5, 96) == 1  # no divisor <= 4
    # budget exactly at the F=3 peak: picks 3, skipping 6
    monkeypatch.setattr(M, "MCMC_BLOCK_BUDGET",
                        M._blocked_peak_elems(learner.plan, 3, 96))
    assert M._auto_factor_block(learner.plan, 6, 96) == 3


def test_als_blocked_matches_sequential_closely():
    """Blocked-factor ALS (Jacobi across factors) should converge to the
    same place as the sequential reference sweep."""
    import dataclasses
    tr, te, cfg, meta, mesh = _setup(num_rows=2000, num_users=30, num_items=25,
                                     K=4, regw=0.1, regv=0.1)
    D = cfg.num_attributes
    l_blk = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                       SparseDataset.from_coo(te, D), meta, mesh=mesh,
                       write_files=False)  # factor_block=0 -> blocked
    l_seq = ALSLearner(dataclasses.replace(cfg, factor_block=1),
                       SparseDataset.from_coo(tr, D),
                       SparseDataset.from_coo(te, D), meta, mesh=mesh,
                       write_files=False)
    s_b, h_b = l_blk.run(num_iter=12, verbose=False)
    s_q, h_q = l_seq.run(num_iter=12, verbose=False)
    assert abs(h_b[-1]["rmse_this"] - h_q[-1]["rmse_this"]) < 0.02
    assert h_b[-1]["rmse_this"] < 1.0


def test_nan_counters_surface_and_count():
    """The draw returns the reference's nan/inf counters
    (fm_learn_mcmc_simultaneous.h:100-128): zero on a healthy run, in the
    history records, and incremented when a draw candidate goes bad."""
    import jax
    import jax.numpy as jnp

    from svbfm.learners.mcmc import (_maybe_sample, NAN_FAMILIES,
                                     zero_nan_counters)

    # unit: reference guard order (fm_learn_mcmc.h:686-712) — a nan/inf
    # sigma^2 zeroes the draw BEFORE the counter check (uncounted), while a
    # finite-but-negative sigma^2 slips past the guard and its NaN draw IS
    # counted then reverted
    counters = zero_nan_counters()
    key = jax.random.PRNGKey(0)
    mean = jnp.zeros((4,))
    sigma = jnp.array([1.0, -1.0, jnp.nan, 1.0])  # sqrt(-1)=nan, sqrt(nan)=nan
    out = _maybe_sample(True, key, mean, sigma, jnp.zeros((4,)),
                        counters=counters, count_as="w")
    assert int(counters["nan_w"]) == 1  # only the sigma=-1 draw is counted
    assert np.isfinite(np.asarray(out)).all()  # zeroed / reverted
    # ...while a bad DRAW (no sigma guard, e.g. w0/hyperprior mu) is counted
    # and reverted
    out2 = _maybe_sample(True, key, jnp.full((4,), jnp.nan), jnp.ones((4,)),
                         jnp.zeros((4,)), zero_on_bad_sigma=False,
                         counters=counters, count_as="w0")
    assert int(counters["nan_w0"]) == 4
    assert np.isfinite(np.asarray(out2)).all()  # reverted to old
    # count_mask restricts counting to the masked subset
    counters2 = zero_nan_counters()
    _maybe_sample(True, key, jnp.full((4,), jnp.nan), jnp.ones((4,)),
                  jnp.zeros((4,)), zero_on_bad_sigma=False,
                  counters=counters2, count_as="v",
                  count_mask=jnp.array([True, False, True, False]))
    assert int(counters2["nan_v"]) == 2

    # integration: healthy Gibbs run surfaces all-zero counters per iter
    tr, te, cfg, meta, mesh = _setup(regw=0.1, regv=0.1)
    D = cfg.num_attributes
    learner = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                          SparseDataset.from_coo(te, D), meta, mesh=mesh,
                          write_files=False)
    _state, hist = learner.run(num_iter=2, verbose=False)
    for rec in hist:
        for fam in NAN_FAMILIES:
            assert rec[f"nan_{fam}"] == 0
            assert rec[f"inf_{fam}"] == 0


def test_exact_block_draws_solve_matches_loop():
    """The batched triangular-solve draw equals the sequential correction
    loop (same recurrence), and non-finite inputs trigger the predicated
    loop fallback with the reference's per-factor revert semantics."""
    import jax
    import jax.numpy as jnp
    from svbfm.learners.mcmc import exact_block_draws
    from svbfm.learners.base import keep_finite

    rng = np.random.default_rng(0)
    F, C = 6, 17
    s0 = jnp.asarray(rng.standard_normal((F, C)).astype(np.float32))
    sh2 = jnp.abs(jnp.asarray(rng.standard_normal((F, C)).astype(np.float32)))
    m_x = jnp.asarray(rng.standard_normal((F, F, C)).astype(np.float32))
    v_c = jnp.asarray(rng.standard_normal((C, F)).astype(np.float32))
    mu = jnp.asarray(rng.standard_normal((C, F)).astype(np.float32))
    lam = jnp.abs(jnp.asarray(rng.standard_normal((C, F)).astype(np.float32))) + 0.3
    zmat = jnp.asarray(rng.standard_normal((F, C)).astype(np.float32))
    alpha = 1.7

    def loop_ref(lam_g):
        corr = jnp.zeros((F, C), jnp.float32)
        cols = []
        for f in range(F):
            she = s0[f] - corr[f]
            v_cf = v_c[:, f]
            s2 = 1.0 / (lam_g[:, f] + alpha * sh2[f])
            mean = -s2 * (alpha * (she - v_cf * sh2[f]) - mu[:, f] * lam_g[:, f])
            val = mean + jnp.sqrt(s2) * zmat[f]
            val = jnp.where(jnp.isfinite(s2), val, 0.0)
            new_v = keep_finite(val, v_cf)
            corr = corr + (v_cf - new_v)[None, :] * m_x[f]
            cols.append(new_v)
        return jnp.stack(cols, 1)

    got, nan_c, inf_c = jax.jit(exact_block_draws, static_argnums=())(
        s0, sh2, m_x, v_c, mu, lam, alpha, zmat)
    np.testing.assert_allclose(np.asarray(got), np.asarray(loop_ref(lam)),
                               rtol=2e-4, atol=2e-5)
    assert int(nan_c) == 0 and int(inf_c) == 0

    # non-finite path: a NaN lambda for one column makes s2 NaN for EVERY
    # factor of that column; the solve result is then non-finite, so the
    # predicated loop fallback must run and apply the reference guard
    # (bad sigma^2 -> param zeroed BEFORE counting, fm_learn_mcmc.h:697-710)
    # while other columns still get the sequential-loop values
    lam_bad = lam.at[3, :].set(jnp.nan)
    got_b, nan_b, _ = jax.jit(exact_block_draws)(
        s0, sh2, m_x, v_c, mu, lam_bad, alpha, zmat)
    want_b = loop_ref(lam_bad)
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(want_b),
                               rtol=2e-4, atol=2e-5)
    assert np.isfinite(np.asarray(got_b)).all()
    assert (np.asarray(got_b)[3] == 0.0).all()  # bad-sigma column zeroed
    assert int(nan_b) == 0  # zeroed before counting, like the reference


def test_run_compile_signatures_stay_bounded():
    """Repeated run() calls must not keep retracing the fused program.
    Threading a shard_map output scalar back in used to do exactly that
    (its aval carries the mesh axes; round-3 fix rebuilds it0 from the
    host counter).  Fresh-vs-output array avals still produce a bounded
    set of benign signatures (<=3); the guard is that the set STOPS
    GROWING once every input provenance has been seen."""
    tr, te, cfg, meta, mesh = _setup()
    l = MCMCLearner(cfg, SparseDataset.from_coo(tr, cfg.num_attributes),
                    SparseDataset.from_coo(te, cfg.num_attributes), meta,
                    mesh=mesh, write_files=False)
    state, _ = l.run(num_iter=4, verbose=False, chunk=2)
    state, _ = l.run(state, num_iter=4, verbose=False, chunk=2)
    fn = l._fused_steps(2)
    n2 = fn._cache_size()
    state, _ = l.run(state, num_iter=4, verbose=False, chunk=2)
    state, _ = l.run(state, num_iter=4, verbose=False, chunk=2)
    assert fn._cache_size() == n2 <= 3, (
        f"fused program signatures keep growing: {n2} -> {fn._cache_size()}")


def test_mcmc_staged_path_matches_fused(monkeypatch):
    """The staged huge-N path (A: scalar draws + w sweep / B: one factor
    block / C: re-predict + eval) replays the fused blocked path's exact
    draw/key sequence, so trajectories must match bitwise-closely —
    staging is a pure execution-schedule transform."""
    import svbfm.learners.mcmc as M

    tr, te, cfg, meta, mesh = _setup(num_rows=600, num_users=18,
                                     num_items=14, K=4, factor_block=2)
    D = cfg.num_attributes
    ref = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta, mesh=mesh,
                      write_files=False)
    assert ref._staged_mode() is False
    _, hist_ref = ref.run(num_iter=4, verbose=False)

    monkeypatch.setattr(M, "MCMC_STAGE_UNITS", 10)
    st = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta, mesh=make_mesh(1),
                     write_files=False)
    assert st._staged_mode() is True
    _, hist_st = st.run(num_iter=4, verbose=False)
    for r_ref, r_st in zip(hist_ref, hist_st):
        np.testing.assert_allclose(r_st["rmse"], r_ref["rmse"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r_st["rmse_this"], r_ref["rmse_this"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r_st["alpha"], r_ref["alpha"], rtol=1e-5)
        assert r_st["nan_v"] == r_ref["nan_v"]

    # sharded mesh agrees too (psum'd stats under the staged split)
    st8 = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta, mesh=make_mesh(8),
                      write_files=False)
    assert st8._staged_mode() is True
    _, hist8 = st8.run(num_iter=4, verbose=False)
    for r_ref, r8 in zip(hist_ref, hist8):
        np.testing.assert_allclose(r8["rmse"], r_ref["rmse"], rtol=2e-3,
                                   atol=2e-4)


def test_als_staged_path_matches_fused(monkeypatch):
    """Deterministic ALS through the staged split (no sampling noise, so
    any drift is a real semantics bug)."""
    import svbfm.learners.mcmc as M

    tr, te, cfg, meta, mesh = _setup(num_rows=600, num_users=18,
                                     num_items=14, K=4, factor_block=2,
                                     regw=0.05, regv=0.05)
    D = cfg.num_attributes
    ref = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta, mesh=mesh,
                     write_files=False)
    _, hist_ref = ref.run(num_iter=4, verbose=False)
    monkeypatch.setattr(M, "MCMC_STAGE_UNITS", 10)
    st = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta, mesh=make_mesh(1),
                    write_files=False)
    assert st._staged_mode() is True
    _, hist_st = st.run(num_iter=4, verbose=False)
    for r_ref, r_st in zip(hist_ref, hist_st):
        np.testing.assert_allclose(r_st["rmse"], r_ref["rmse"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r_st["rmse_this"], r_ref["rmse_this"],
                                   rtol=1e-6, atol=1e-7)


def test_mcmc_tiled_sweep_matches_untiled(monkeypatch):
    """The row/column-tiled blocked sweep + tiled re-predict (the huge-N
    memory path) is a pure memory transform: with a tiny budget and a
    quantum-padded row count it must reproduce the untiled trajectory
    exactly, and the _needs_tiling predicate must agree with the kernel's
    tile counts (it forces chunk=1, dodging the nested-scan miscompile)."""
    import svbfm.learners.base as basemod
    import svbfm.learners.mcmc as M

    tr, te, cfg, meta, mesh = _setup(num_rows=3000, num_users=40,
                                     num_items=30, K=4)
    D = cfg.num_attributes
    ref = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta, mesh=mesh,
                      write_files=False)
    assert ref.cfg.factor_block == 4  # auto: full block on small data
    assert ref._needs_tiling() is False
    _, hist_ref = ref.run(num_iter=3, verbose=False)

    # quantum-pad the rows and shrink the budget so every tiling site
    # (q build, stats column tiles, patch row tiles, re-predict) engages
    monkeypatch.setattr(basemod, "_ROW_QUANTUM_MIN_ROWS", 1000)
    monkeypatch.setattr(M, "MCMC_TILE_BUDGET", 98304)
    tl = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta, mesh=make_mesh(1),
                     write_files=False)
    n_loc = tl.train_row.ids.shape[0]
    assert n_loc == basemod.ROW_QUANTUM  # quantum padding engaged
    assert M._mc_row_tiles(n_loc, 4 * 4) > 1
    from svbfm.learners.vb import _exact_tile_len
    assert _exact_tile_len(n_loc, M._mc_row_tiles(n_loc, 4 * 4)) is not None
    assert tl._needs_tiling() is True
    _, hist_tl = tl.run(num_iter=3, verbose=False)
    for r_ref, r_tl in zip(hist_ref, hist_tl):
        np.testing.assert_allclose(r_tl["rmse"], r_ref["rmse"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r_tl["rmse_this"], r_ref["rmse_this"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r_tl["alpha"], r_ref["alpha"], rtol=1e-4)
