"""Feature-axis (tensor-parallel) scoring: sharded V/w across the mesh."""
import numpy as np
import jax.numpy as jnp

from svbfm.models.fm import init_fm_params
from svbfm.ops.forward import fm_scores
from svbfm.parallel.mesh import make_mesh
from svbfm.parallel.tp import (make_tp_scorer, pad_feature_dim,
                               shard_params_by_feature)


def test_tp_scores_match_replicated():
    import jax
    rng = np.random.default_rng(0)
    D, K, N, P = 1000, 8, 512, 3
    w0 = np.float32(0.3)
    w = rng.standard_normal(D).astype(np.float32)
    v = (0.1 * rng.standard_normal((K, D))).astype(np.float32)
    ids = rng.integers(0, D, size=(N, P)).astype(np.int32)
    vals = rng.random((N, P)).astype(np.float32)

    ref = np.asarray(fm_scores(jnp.asarray(w0), jnp.asarray(w), jnp.asarray(v),
                               jnp.asarray(ids), jnp.asarray(vals)))

    mesh = make_mesh(8)
    scorer, d_pad = make_tp_scorer(mesh, D)
    w0_s, w_s, v_s = shard_params_by_feature(
        mesh, w0, pad_feature_dim(w, d_pad), pad_feature_dim(v, d_pad))
    out = np.asarray(scorer(w0_s, w_s, v_s, jnp.asarray(ids), jnp.asarray(vals)))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def _tp_train_setup(seed=2):
    from svbfm.data.dataset import SparseDataset
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.synth import make_movielens_like, train_test_split
    from svbfm.learners.base import FMConfig
    coo = make_movielens_like(num_users=20, num_items=14, num_ratings=700,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 20])
    cfg = FMConfig(num_attributes=D, num_factor=4,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7)
    return (cfg, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta, D)


def test_tp_vb_training_matches_replicated():
    """Feature-sharded VB TRAINING: a (data=2, feature=4) mesh with V/w
    tables sharded over features reproduces the replicated fast-mode
    VBLearner's trajectory (SURVEY TP row)."""
    from svbfm.learners.vb import VBLearner
    from svbfm.parallel.mesh import make_mesh2d
    from svbfm.parallel.tp_vb import TPVBLearner
    cfg, tr_ds, te_ds, meta, D = _tp_train_setup()
    l_rep = VBLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(2),
                      write_files=False)
    s_rep, h_rep = l_rep.run(num_iter=5, verbose=False)

    l_tp = TPVBLearner(cfg, tr_ds, te_ds, meta,
                       mesh=make_mesh2d(n_data=2, n_feature=4))
    # tables really are feature-sharded
    assert l_tp.D_loc * 4 >= D and l_tp.D_loc < D
    s_tp, h_tp = l_tp.run(num_iter=5, verbose=False)

    mu_v_tp = np.asarray(s_tp.mu_v)[:, :D]
    np.testing.assert_allclose(mu_v_tp, np.asarray(s_rep.mu_v),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_tp.mu_w)[:D],
                               np.asarray(s_rep.mu_w), rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(float(s_tp.alpha), float(s_rep.alpha),
                               rtol=1e-4)
    for a, b in zip(h_tp, h_rep):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=1e-4)
        np.testing.assert_allclose(a["free_energy"], b["free_energy"],
                                   rtol=1e-4)


def test_tp_vb_feature_shard_invariance():
    """The TP trajectory is invariant to the (data, feature) factorization."""
    from svbfm.parallel.mesh import make_mesh2d
    from svbfm.parallel.tp_vb import TPVBLearner
    cfg, tr_ds, te_ds, meta, D = _tp_train_setup(seed=5)
    l_a = TPVBLearner(cfg, tr_ds, te_ds, meta,
                      mesh=make_mesh2d(n_data=4, n_feature=2))
    s_a, h_a = l_a.run(num_iter=3, verbose=False)
    l_b = TPVBLearner(cfg, tr_ds, te_ds, meta,
                      mesh=make_mesh2d(n_data=1, n_feature=8))
    s_b, h_b = l_b.run(num_iter=3, verbose=False)
    np.testing.assert_allclose(np.asarray(s_a.mu_v)[:, :D],
                               np.asarray(s_b.mu_v)[:, :D],
                               rtol=5e-4, atol=1e-5)
    for a, b in zip(h_a, h_b):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=1e-4)


def test_tp_no_k0_k1():
    rng = np.random.default_rng(1)
    D, K, N, P = 64, 4, 128, 2
    v = (0.1 * rng.standard_normal((K, D))).astype(np.float32)
    ids = rng.integers(0, D, size=(N, P)).astype(np.int32)
    vals = rng.random((N, P)).astype(np.float32)
    ref = np.asarray(fm_scores(jnp.asarray(0.0), jnp.zeros(D, jnp.float32),
                               jnp.asarray(v), jnp.asarray(ids),
                               jnp.asarray(vals), k0=False, k1=False))
    mesh = make_mesh(4)
    scorer, d_pad = make_tp_scorer(mesh, D, k0=False, k1=False)
    w0_s, w_s, v_s = shard_params_by_feature(
        mesh, 0.0, pad_feature_dim(np.zeros(D, np.float32), d_pad),
        pad_feature_dim(v, d_pad))
    out = np.asarray(scorer(w0_s, w_s, v_s, jnp.asarray(ids), jnp.asarray(vals)))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_tp_budget_check_fails_loudly(monkeypatch):
    """Shapes whose sweep temps would need the replicated learners' memory
    tiling (which TP does not implement) must fail at CONSTRUCTION with an
    informative error, not blow HBM at compile/run time."""
    import pytest
    from svbfm.learners import vb as vbmod
    from svbfm.parallel.mesh import make_mesh2d
    from svbfm.parallel.tp_mcmc import TPMCMCLearner
    from svbfm.parallel.tp_vb import TPVBLearner

    from svbfm.parallel import tp_vb as tpmod

    cfg, tr_ds, te_ds, meta, D = _tp_train_setup()
    # shrink the capacity budgets so this small problem trips the same
    # predicate an oversized problem would trip at the real budgets
    monkeypatch.setattr(tpmod, "TP_STACK_BYTES", 64)
    monkeypatch.setattr(tpmod, "TP_COL_BYTES", 64)
    mesh = make_mesh2d(n_data=2, n_feature=4)
    with pytest.raises(RuntimeError, match="replicated learner"):
        TPVBLearner(cfg, tr_ds, te_ds, meta, mesh=mesh)
    with pytest.raises(RuntimeError, match="replicated learner"):
        TPMCMCLearner(cfg, tr_ds, te_ds, meta, mesh=mesh)
