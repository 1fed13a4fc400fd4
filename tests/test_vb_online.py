import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.vb_online import OVBLearner
from svbfm.parallel.mesh import make_mesh

from oracle import OVBOracle


def _setup(num_rows=120, num_users=9, num_items=7, K=3, n_dev=1, seed=2,
           num_batches=3, **cfg_kw):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K, task=0,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   num_batches=num_batches, **cfg_kw)
    mesh = make_mesh(n_dev)
    tr_ds = SparseDataset.from_coo(tr, D)
    te_ds = SparseDataset.from_coo(te, D)
    learner = OVBLearner(cfg, tr_ds, te_ds, meta, mesh=mesh, write_files=False)
    return tr, te, cfg, meta, learner


@pytest.mark.parametrize("n_dev", [1, 4])
def test_ovb_matches_serial_oracle(n_dev):
    tr, te, cfg, meta, learner = _setup(n_dev=n_dev, factor_block=1)
    state = learner.init_state()

    orc = OVBOracle(tr.row, tr.col, tr.val, tr.target, cfg.num_attributes,
                    cfg.num_factor, learner.col_count, tr.num_rows,
                    groups=meta.attr_group)
    orc.init(float(state.mu_0), float(state.sigma_0_dash),
             np.asarray(state.mu_w), np.asarray(state.sigma_w_dash),
             np.asarray(state.mu_v), np.asarray(state.sigma_v_dash))

    # replicate the learner's fixed chunk membership + first epoch order
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(tr.num_rows)
    chunk_rows = np.array_split(perm, learner.num_chunks)
    order_rng = np.random.default_rng(cfg.seed + 1)

    for epoch in range(2):
        order = order_rng.permutation(learner.num_chunks)
        import jax.numpy as jnp
        epoch_fn = learner._build_epoch()
        state, fes, m1, m2, nans = epoch_fn(
            state, jnp.asarray(order.astype(np.int32)),
            learner.chunk_row, learner.chunk_blocks, learner.test_row)
        assert all(int(v) == 0 for v in nans.values())  # healthy run
        for ci in order:
            orc.chunk_update(chunk_rows[ci])
        np.testing.assert_allclose(float(state.mu_0), orc.mu_0, rtol=3e-3, atol=1e-4)
        np.testing.assert_allclose(np.asarray(state.mu_w), orc.mu_w, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.mu_v), orc.mu_v, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(state.sigma_w_dash), orc.sigma_w_dash,
                                   rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(float(state.alpha), orc.alpha, rtol=5e-3)
        np.testing.assert_allclose(np.asarray(state.t_wj), orc.t_wj)
        np.testing.assert_allclose(np.asarray(state.t_vj), orc.t_vj)


def test_ovb_converges():
    tr, te, cfg, meta, learner = _setup(num_rows=3000, num_users=30,
                                        num_items=25, K=4, num_batches=5)
    state, history = learner.run(num_iter=12, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0


def test_ovb_sharding_invariance():
    tr, te, cfg, meta, l1 = _setup(num_rows=256, n_dev=1, seed=5)
    *_x, l8 = _setup(num_rows=256, n_dev=8, seed=5)
    s1, h1 = l1.run(num_iter=3, verbose=False)
    s8, h8 = l8.run(num_iter=3, verbose=False)
    np.testing.assert_allclose(h1[-1]["rmse"], h8[-1]["rmse"], rtol=2e-3)
    np.testing.assert_allclose(np.asarray(s1.mu_v), np.asarray(s8.mu_v),
                               rtol=3e-3, atol=3e-4)


def test_ovb_classification():
    import numpy as np
    from svbfm.learners.base import TASK_CLASSIFICATION
    coo = make_movielens_like(num_users=25, num_items=20, num_ratings=2500,
                              rank=2, noise=0.4, seed=9)
    tr, te = train_test_split(coo, 0.2, seed=10)
    thr = np.median(tr.target)
    tr.target = np.where(tr.target > thr, 1.0, -1.0).astype(np.float32)
    te.target = np.where(te.target > thr, 1.0, -1.0).astype(np.float32)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 25])
    cfg = FMConfig(num_attributes=D, num_factor=4, task=TASK_CLASSIFICATION,
                   min_target=-1.0, max_target=1.0,
                   num_groups=meta.num_attr_groups, seed=7, num_batches=5)
    learner = OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                         SparseDataset.from_coo(te, D), meta,
                         mesh=make_mesh(2), write_files=False)
    state, history = learner.run(num_iter=8, verbose=False)
    assert history[-1]["accuracy"] > 0.6


def test_ovb_reshuffle_membership():
    """cfg.reshuffle re-partitions chunk membership every epoch (the
    reference's per-epoch disk re-split, fm_learn_vb_online_simultaneous
    .h:74-101) while reusing the compiled epoch program, and stays
    deterministic under the seed."""
    tr, te, cfg, meta, learner = _setup(num_rows=3000, num_users=30,
                                        num_items=25, K=4, num_batches=5,
                                        reshuffle=True)
    state, history = learner.run(num_iter=6, verbose=False)
    # membership actually changed: the last drawn permutation is a real
    # permutation of all rows and differs from the seeded initial one
    perm = learner._last_member_perm
    assert np.array_equal(np.sort(perm), np.arange(tr.num_rows))
    init_perm = np.random.default_rng(cfg.seed).permutation(tr.num_rows)
    assert not np.array_equal(perm, init_perm)
    assert history[-1]["rmse"] < history[0]["rmse"]

    # determinism: a second identical run reproduces the trajectory
    *_x, learner2 = _setup(num_rows=3000, num_users=30, num_items=25, K=4,
                           num_batches=5, reshuffle=True)
    s2, h2 = learner2.run(num_iter=6, verbose=False)
    np.testing.assert_allclose(
        [h["rmse"] for h in history], [h["rmse"] for h in h2], rtol=1e-6)

    # reshuffling must differ from the fixed-membership trajectory after
    # epoch 0 (epoch 0 shares the initial membership)
    *_y, learner3 = _setup(num_rows=3000, num_users=30, num_items=25, K=4,
                           num_batches=5)
    s3, h3 = learner3.run(num_iter=6, verbose=False)
    np.testing.assert_allclose(history[0]["rmse"], h3[0]["rmse"], rtol=1e-6)
    assert abs(history[-1]["rmse"] - h3[-1]["rmse"]) > 1e-9


def test_ovb_reshuffle_resume_matches(tmp_path):
    """Checkpoint resume replays the membership RNG so a resumed
    reshuffling run reproduces the uninterrupted one."""
    from svbfm.utils.checkpoint import CheckpointManager

    *_a, l_full = _setup(num_rows=1500, num_users=20, num_items=15, K=3,
                         num_batches=4, reshuffle=True)
    s_full, h_full = l_full.run(num_iter=6, verbose=False)

    *_b, l_a = _setup(num_rows=1500, num_users=20, num_items=15, K=3,
                      num_batches=4, reshuffle=True)
    ck = CheckpointManager(str(tmp_path / "ck"))
    l_a.run(num_iter=3, verbose=False, ckpt=ck, ckpt_every=3)

    *_c, l_b = _setup(num_rows=1500, num_users=20, num_items=15, K=3,
                      num_batches=4, reshuffle=True)
    s_res, h_res = l_b.run(num_iter=6, verbose=False, ckpt=ck, ckpt_every=3)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s_res.mu_v),
                               np.asarray(s_full.mu_v), rtol=1e-5, atol=1e-7)


def test_ovb_v_factor_matches_generic_block():
    """The F=1 flat v-sweep (ovb_v_factor, the factor-sequential hot path)
    must reproduce the generic ovb_v_block instance exactly: same gathers,
    same float op order, only pad-free layouts."""
    import jax
    import jax.numpy as jnp

    from svbfm.learners.vb_online import ovb_v_block, ovb_v_factor

    tr, te, cfg, meta, learner = _setup(num_rows=400, num_users=17,
                                        num_items=13, K=1, factor_block=1)
    state = learner.init_state()
    row = jax.tree.map(lambda a: np.asarray(a)[0], learner.chunk_row)
    blocks = jax.tree.map(lambda a: np.asarray(a)[0], learner.chunk_blocks)
    D = cfg.num_attributes
    rng = np.random.default_rng(3)
    e = jnp.asarray(rng.standard_normal(row.ids.shape[0]), jnp.float32)
    t = jnp.asarray(rng.random(row.ids.shape[0]), jnp.float32) * 0.1
    mu = jnp.asarray(rng.standard_normal(D), jnp.float32) * 0.1
    sig = jnp.asarray(rng.random(D), jnp.float32) * 0.05 + 0.01
    nmu = jnp.asarray(rng.standard_normal(D), jnp.float32)
    nsig = jnp.asarray(rng.random(D), jnp.float32) + 0.5
    sv = jnp.ones((D,), jnp.float32)
    rho_v_d = jnp.full((D,), 0.7, jnp.float32)
    alpha = jnp.asarray(1.3, jnp.float32)

    from jax.sharding import PartitionSpec
    P0 = PartitionSpec()
    out_spec = (P0, P0, P0, P0, P0, P0, P0, (P0, P0, P0, P0))

    def wrap(fn):
        return jax.jit(jax.shard_map(
            fn, mesh=learner.mesh, in_specs=(P0,) * 6, out_specs=out_spec))

    out_g = wrap(lambda e, t, mu, sig, nmu, nsig: ovb_v_block(
        e, t, mu[:, None], sig[:, None], nmu[:, None], nsig[:, None],
        sv[:, None], alpha, rho_v_d, blocks, row, cfg, None))(
            e, t, mu, sig, nmu, nsig)
    out_f = wrap(lambda e, t, mu, sig, nmu, nsig: ovb_v_factor(
        e, t, mu, sig, nmu, nsig, sv, alpha, rho_v_d, blocks, row, cfg))(
            e, t, mu, sig, nmu, nsig)
    for g, f, name in zip(out_g[:6], out_f[:6],
                          ("e", "t", "mu", "sig", "nmu", "nsig")):
        np.testing.assert_allclose(np.asarray(g).reshape(-1),
                                   np.asarray(f).reshape(-1),
                                   rtol=2e-6, atol=2e-7, err_msg=name)
    np.testing.assert_allclose(np.asarray(out_g[6]), np.asarray(out_f[6]))
    assert all(int(a) == int(b) for a, b in zip(out_g[7], out_f[7]))


def test_ovb_flat_pipelined_matches_generic_trajectory(monkeypatch):
    """The production KDD configuration — flat F=1 v-sweep with the
    pass-pipelined factor scan (qtz carry + next_ptab merge) — must
    reproduce the generic path's trajectory exactly; only layouts and
    gather packing differ."""
    tr, te, cfg, meta, lg = _setup(num_rows=600, num_users=19, num_items=15,
                                   K=4, factor_block=1, num_batches=4)
    sg, hg = lg.run(num_iter=4, verbose=False)

    monkeypatch.setenv("SVBFM_OVB_FLAT", "1")
    *_x, lf = _setup(num_rows=600, num_users=19, num_items=15,
                     K=4, factor_block=1, num_batches=4)
    sf, hf = lf.run(num_iter=4, verbose=False)
    for rg, rf in zip(hg, hf):
        np.testing.assert_allclose(rf["rmse"], rg["rmse"], rtol=1e-6)
        np.testing.assert_allclose(rf["free_energy"], rg["free_energy"],
                                   rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sf.mu_v), np.asarray(sg.mu_v),
                               rtol=1e-5, atol=1e-7)


def test_flat_dispatch_boundary(monkeypatch):
    """The flat-vs-generic layout dispatch is pinned at the calibrated
    threshold (both layouts produce identical trajectories — the
    equivalence tests above — so a mis-dispatch costs only performance,
    but the boundary itself must not drift silently)."""
    from svbfm.learners.vb_online import (
        OVB_FLAT_THRESHOLD, _flat_overhead_estimate, _use_flat_dispatch)

    monkeypatch.delenv("SVBFM_OVB_FLAT", raising=False)
    # the two round-4 calibration endpoints must dispatch as measured:
    # Netflix-shape 2.5M-row chunks at D=498k ran GENERIC and fit HBM;
    # KDD-shape 2.63M-row chunks at D=1.63M OOM'd generic and need flat
    assert _use_flat_dispatch(2_500_000, 497_959, F=1) is False
    assert _use_flat_dispatch(2_630_000, 1_625_951, F=1) is True
    # threshold straddle: one byte below/above the calibrated cut
    n_lo = (OVB_FLAT_THRESHOLD - 3_500) // 6_000
    assert _flat_overhead_estimate(n_lo, 1) <= OVB_FLAT_THRESHOLD
    assert _use_flat_dispatch(n_lo, 1, F=1) is False
    assert _use_flat_dispatch(n_lo + 1, 1, F=1) is True
    # only the F=1 factor-sequential sweep has a flat specialization
    assert _use_flat_dispatch(10**9, 10**8, F=2) is False
    # env overrides win in both directions
    monkeypatch.setenv("SVBFM_OVB_FLAT", "1")
    assert _use_flat_dispatch(100, 100, F=1) is True
    monkeypatch.setenv("SVBFM_OVB_FLAT", "0")
    assert _use_flat_dispatch(10**10, 10**9, F=1) is False
