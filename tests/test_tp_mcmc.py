"""Feature-sharded (tensor-parallel) MCMC/ALS training over (data, feature)
meshes: parity with the replicated learners and mesh-factorization
invariance."""
import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.mcmc import ALSLearner, MCMCLearner
from svbfm.parallel.mesh import make_mesh, make_mesh2d
from svbfm.parallel.tp_mcmc import TPALSLearner, TPMCMCLearner


def _setup(seed=3, n=900):
    coo = make_movielens_like(num_users=25, num_items=16, num_ratings=n,
                              rank=2, noise=0.3, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 25])
    cfg = FMConfig(num_attributes=D, num_factor=4,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=11,
                   regw=0.1, regv=0.1)
    return (cfg, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta, D)


def test_tp_als_matches_replicated():
    """Feature-sharded ALS reproduces the replicated blocked ALSLearner's
    trajectory and final tables (deterministic: no draws)."""
    cfg, tr_ds, te_ds, meta, D = _setup()
    l_rep = ALSLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(2),
                       write_files=False)
    s_rep, h_rep = l_rep.run(num_iter=4, verbose=False)

    l_tp = TPALSLearner(cfg, tr_ds, te_ds, meta,
                        mesh=make_mesh2d(n_data=2, n_feature=4))
    assert l_tp.D_loc * 4 >= D and l_tp.D_loc < D  # really sharded
    assert l_tp.cfg.factor_block == l_rep.cfg.factor_block
    s_tp, h_tp = l_tp.run(num_iter=4, verbose=False)

    np.testing.assert_allclose(np.asarray(s_tp.v)[:, :D],
                               np.asarray(s_rep.v), rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_tp.w)[:D], np.asarray(s_rep.w),
                               rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(float(s_tp.w0), float(s_rep.w0), rtol=1e-4)
    for a, b in zip(h_tp, h_rep):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=2e-4)
        np.testing.assert_allclose(a["rmse_this"], b["rmse_this"], rtol=2e-4)


def test_tp_gibbs_mesh_factorization_invariance():
    """Gibbs draws use replicated z-tables sliced per shard, so the sampled
    trajectory is invariant to the (data, feature) factorization."""
    cfg, tr_ds, te_ds, meta, D = _setup(seed=9)
    l_a = TPMCMCLearner(cfg, tr_ds, te_ds, meta,
                        mesh=make_mesh2d(n_data=4, n_feature=2))
    s_a, h_a = l_a.run(num_iter=4, verbose=False)
    l_b = TPMCMCLearner(cfg, tr_ds, te_ds, meta,
                        mesh=make_mesh2d(n_data=1, n_feature=8))
    s_b, h_b = l_b.run(num_iter=4, verbose=False)
    np.testing.assert_allclose(np.asarray(s_a.v)[:, :D],
                               np.asarray(s_b.v)[:, :D], rtol=2e-3,
                               atol=2e-4)
    for a, b in zip(h_a, h_b):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=5e-4)


def test_tp_gibbs_converges_like_replicated():
    """Sampling-mode TP (different z-table stream than the replicated
    learner) reaches the same posterior-mean RMSE."""
    cfg, tr_ds, te_ds, meta, D = _setup(seed=5, n=1400)
    l_rep = MCMCLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(2),
                        write_files=False)
    _, h_rep = l_rep.run(num_iter=15, verbose=False)
    l_tp = TPMCMCLearner(cfg, tr_ds, te_ds, meta,
                         mesh=make_mesh2d(n_data=2, n_feature=4))
    _, h_tp = l_tp.run(num_iter=15, verbose=False)
    assert abs(h_tp[-1]["rmse"] - h_rep[-1]["rmse"]) < 0.05
    assert h_tp[-1]["rmse"] < h_tp[0]["rmse"]


def test_tp_mcmc_classification():
    cfg, tr_ds, te_ds, meta, D = _setup(seed=13)
    import dataclasses
    med = float(np.median(np.asarray(tr_ds.target[: tr_ds.num_rows])))
    def binarize(ds):
        t = np.where(np.asarray(ds.target) > med, 1.0, -1.0).astype(
            np.float32)
        return dataclasses.replace(ds, target=t, min_target=-1.0,
                                   max_target=1.0)
    cfg = dataclasses.replace(cfg, task=1, min_target=-1.0, max_target=1.0)
    l = TPMCMCLearner(cfg, binarize(tr_ds), binarize(te_ds), meta,
                      mesh=make_mesh2d(n_data=2, n_feature=4))
    _, h = l.run(num_iter=10, verbose=False)
    assert h[-1]["accuracy"] > 0.6


def test_tp_vb_checkpoint_resume(tmp_path):
    """TPVBLearner checkpoints feature-sharded state and resumes with only
    the remaining iterations (CLI -checkpoint -feature_shards path)."""
    import os
    from svbfm.parallel.tp_vb import TPVBLearner
    from svbfm.utils.checkpoint import CheckpointManager
    cfg, tr_ds, te_ds, meta, D = _setup(seed=21)

    def learner():
        return TPVBLearner(cfg, tr_ds, te_ds, meta,
                           mesh=make_mesh2d(n_data=2, n_feature=4))

    s_full, h_full = learner().run(num_iter=6, verbose=False)
    ck = str(tmp_path / "ck")
    os.makedirs(ck, exist_ok=True)
    mgr = CheckpointManager(ck)
    learner().run(num_iter=3, verbose=False, ckpt=mgr, ckpt_every=3)
    assert any(f.endswith(".npz") for f in os.listdir(ck)), \
        "first run wrote no checkpoint"
    s_res, h_res = learner().run(num_iter=6, verbose=False, ckpt=mgr,
                                 ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s_res.mu_v)[:, :D],
                               np.asarray(s_full.mu_v)[:, :D],
                               rtol=1e-5, atol=1e-6)


def test_tp_mcmc_checkpoint_resume(tmp_path):
    """TPMCMCLearner inherits bit-matching checkpoint/resume (incl. the
    posterior-mean accumulators) from MCMCLearner."""
    import os
    from svbfm.utils.checkpoint import CheckpointManager
    cfg, tr_ds, te_ds, meta, D = _setup(seed=23)

    def learner():
        return TPMCMCLearner(cfg, tr_ds, te_ds, meta,
                             mesh=make_mesh2d(n_data=2, n_feature=4))

    s_full, h_full = learner().run(num_iter=6, verbose=False, chunk=3)
    ck = str(tmp_path / "ck")
    os.makedirs(ck, exist_ok=True)
    mgr = CheckpointManager(ck)
    learner().run(num_iter=3, verbose=False, chunk=3, ckpt=mgr, ckpt_every=3)
    assert any(f.endswith(".npz") for f in os.listdir(ck)), \
        "first run wrote no checkpoint"
    s_res, h_res = learner().run(num_iter=6, verbose=False, chunk=3,
                                 ckpt=mgr, ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"],
                               rtol=1e-5)


def test_tp_edge_configs():
    """dim '1,1,0' (K=0) and '0,0,K' (no bias/linear) run feature-sharded."""
    import dataclasses
    cfg, tr_ds, te_ds, meta, D = _setup(seed=31, n=600)
    m = make_mesh2d(n_data=2, n_feature=4)
    l = TPMCMCLearner(dataclasses.replace(cfg, num_factor=0),
                      tr_ds, te_ds, meta, mesh=m)
    _, h = l.run(num_iter=3, verbose=False)
    assert np.isfinite(h[-1]["rmse"])
    l2 = TPALSLearner(dataclasses.replace(cfg, k0=False, k1=False),
                      tr_ds, te_ds, meta, mesh=m)
    _, h2 = l2.run(num_iter=3, verbose=False)
    assert np.isfinite(h2[-1]["rmse"])


def test_tp_multilevel_deterministic_matches_replicated():
    """do_multilevel=True + do_sample=False (deterministic hyperprior
    updates + ALS-style conditional means) pins the TP group-statistic
    algebra (segment sums psum'd over FEATURE) against the replicated
    learner.  ONE full draw step is compared tightly: multi-iteration
    trajectories are chaotic under the multilevel feedback on tiny data,
    so step-level parity is the meaningful deterministic check."""
    import dataclasses
    cfg, tr_ds, te_ds, meta, D = _setup(seed=41)
    cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=True)
    l_rep = MCMCLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(2),
                        write_files=False)
    s_rep, _ = l_rep.run(num_iter=1, verbose=False)
    l_tp = TPMCMCLearner(cfg, tr_ds, te_ds, meta,
                         mesh=make_mesh2d(n_data=2, n_feature=4))
    s_tp, _ = l_tp.run(num_iter=1, verbose=False)
    np.testing.assert_allclose(np.asarray(s_tp.w_mu), np.asarray(s_rep.w_mu),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(s_tp.w_lambda),
                               np.asarray(s_rep.w_lambda), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s_tp.v_mu), np.asarray(s_rep.v_mu),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(s_tp.v_lambda),
                               np.asarray(s_rep.v_lambda), rtol=1e-5)
    np.testing.assert_allclose(float(s_tp.alpha), float(s_rep.alpha),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s_tp.v)[:, :D],
                               np.asarray(s_rep.v), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_tp.w)[:D], np.asarray(s_rep.w),
                               rtol=1e-4, atol=1e-6)
