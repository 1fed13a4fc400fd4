import numpy as np

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.vb import VBLearner
from svbfm.parallel.mesh import make_mesh
from svbfm.utils.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)


def _learner(seed=2):
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=400,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 12])
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7)
    return VBLearner(cfg, SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta, mesh=make_mesh(2),
                     write_files=False)


def test_save_load_roundtrip(tmp_path):
    l = _learner()
    s = l.init_state()
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, s, 5, {"k": "v"})
    s2, step, meta = load_checkpoint(p, s)
    assert step == 5 and meta == {"k": "v"}
    np.testing.assert_array_equal(np.asarray(s.mu_v), np.asarray(s2.mu_v))
    np.testing.assert_array_equal(np.asarray(s.e), np.asarray(s2.e))


def _ckpt_files(path):
    import os
    return sorted(f for f in os.listdir(path) if f.endswith(".npz"))


def test_resume_matches_uninterrupted(tmp_path):
    # continuous run of 6 iters
    l1 = _learner()
    s_full, h_full = l1.run(num_iter=6, verbose=False, chunk=3)

    # run 3, checkpoint, new learner resumes for the remaining 3
    l2 = _learner()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    import os
    os.makedirs(str(tmp_path / "ck"), exist_ok=True)
    s_half, _ = l2.run(num_iter=3, verbose=False, chunk=3, ckpt=mgr,
                       ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "first run wrote no checkpoint"
    l3 = _learner()
    s_res, h_res = l3.run(num_iter=6, verbose=False, chunk=3, ckpt=mgr,
                          ckpt_every=100)
    # the resumed run executed ONLY the remaining 3 iterations
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_allclose(np.asarray(s_res.mu_v), np.asarray(s_full.mu_v),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(s_res.alpha), float(s_full.alpha), rtol=1e-5)
    assert h_res[-1]["iter"] == 5


def _mcmc_cfg_data():
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=400,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 12])
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, regw=0.1, regv=0.1)
    return cfg, tr, te, D, meta


def test_mcmc_resume_matches(tmp_path):
    from svbfm.learners.mcmc import ALSLearner
    cfg, tr, te, D, meta = _mcmc_cfg_data()
    mk = lambda: ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                            SparseDataset.from_coo(te, D), meta,
                            mesh=make_mesh(2), write_files=False)
    s_full, h_full = mk().run(num_iter=6, verbose=False, chunk=3)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mk().run(num_iter=3, verbose=False, chunk=3, ckpt=mgr, ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "MCMC run wrote no checkpoint"
    s_res, h_res = mk().run(num_iter=6, verbose=False, chunk=3, ckpt=mgr,
                            ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_allclose(np.asarray(s_res.v), np.asarray(s_full.v),
                               rtol=1e-5, atol=1e-7)
    # posterior-mean accumulator continuity: running-mean RMSE matches
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"], rtol=1e-5)


def test_mcmc_sampling_resume_matches(tmp_path):
    """Gibbs sampling resume is bit-deterministic: the PRNG key rides in the
    checkpointed state, so a resumed chain equals the uninterrupted one."""
    from svbfm.learners.mcmc import MCMCLearner
    cfg, tr, te, D, meta = _mcmc_cfg_data()
    mk = lambda: MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                             SparseDataset.from_coo(te, D), meta,
                             mesh=make_mesh(2), write_files=False)
    s_full, h_full = mk().run(num_iter=6, verbose=False, chunk=3)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mk().run(num_iter=3, verbose=False, chunk=3, ckpt=mgr, ckpt_every=3)
    s_res, h_res = mk().run(num_iter=6, verbose=False, chunk=3, ckpt=mgr,
                            ckpt_every=100)
    assert len(h_res) == 3
    np.testing.assert_allclose(np.asarray(s_res.v), np.asarray(s_full.v),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"], rtol=1e-5)


def test_bs_sampling_resume_matches(tmp_path):
    """Native relational-BS Gibbs checkpoints/resumes like the flat sampler
    (same MCMCState pytree; relation caches are rebuilt deterministically)."""
    import sys, os, dataclasses
    sys.path.insert(0, os.path.dirname(__file__))
    from test_bs import _setup
    from svbfm.learners.mcmc_bs import MCMCBSLearner
    main, rel, items, meta, cfg, d_main = _setup()
    tr = SparseDataset.from_coo(main, cfg.num_attributes)
    mk = lambda: MCMCBSLearner(dataclasses.replace(cfg, factor_block=1),
                               tr, tr, [rel], [items], [items], meta, d_main,
                               mesh=make_mesh(2), write_files=False)
    s_full, h_full = mk().run(num_iter=6, verbose=False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mk().run(num_iter=3, verbose=False, ckpt=mgr, ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "BS run wrote no checkpoint"
    s_res, h_res = mk().run(num_iter=6, verbose=False, ckpt=mgr,
                            ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_allclose(np.asarray(s_res.v), np.asarray(s_full.v),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"],
                               rtol=1e-5)


def test_mcmc_final_predictions_posterior_mean():
    """Sampling MCMC final predictions use pred_sum_all/num_iter (the
    reference's predict(), fm_learn_mcmc.h:355-379), not the last sample."""
    from svbfm.learners.mcmc import MCMCLearner
    cfg, tr, te, D, meta = _mcmc_cfg_data()
    l = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta,
                    mesh=make_mesh(2), write_files=False)
    state, h = l.run(num_iter=4, verbose=False, chunk=2)
    final = l.final_test_predictions(state)
    # matches the running posterior-mean RMSE reported per iteration
    rmse = float(np.sqrt(np.mean((final - l.test_target_np) ** 2)))
    np.testing.assert_allclose(rmse, h[-1]["rmse"], rtol=1e-5)
    # and differs from the last-sample predictions (noisier)
    last = np.clip(l.predict_test_scores(state), cfg.min_target, cfg.max_target)
    assert not np.allclose(final, last)


def test_sgd_family_resume(tmp_path):
    """Every SGD-family learner checkpoints and resumes to the exact state
    of an uninterrupted run (key chain rides in the state)."""
    from svbfm.learners.sgd import SGDLearner, SGDALearner, SGDOnlineLearner
    from svbfm.learners.exp_sgd import ExpSGDLearner
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=400,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    va, te2 = train_test_split(te, 0.5, seed=4)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 12])
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   learn_rate=0.02, regw=0.01, regv=0.01, num_batches=2)
    tr_ds = SparseDataset.from_coo(tr, D)
    te_ds = SparseDataset.from_coo(te2, D)
    va_ds = SparseDataset.from_coo(va, D)

    makers = {
        "sgd": lambda: SGDLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(2),
                                  write_files=False),
        "sgda": lambda: SGDALearner(cfg, tr_ds, te_ds, va_ds, meta,
                                    mesh=make_mesh(2), write_files=False),
        "sgd_online": lambda: SGDOnlineLearner(cfg, tr_ds, te_ds, meta,
                                               mesh=make_mesh(2),
                                               write_files=False),
        "exp_sgd": lambda: ExpSGDLearner(cfg, tr_ds, te_ds, meta,
                                         mesh=make_mesh(2), write_files=False),
    }
    for name, mk in makers.items():
        s_full, h_full = mk().run(num_iter=4, verbose=False)
        ckdir = str(tmp_path / f"ck_{name}")
        mgr = CheckpointManager(ckdir)
        mk().run(num_iter=2, verbose=False, ckpt=mgr, ckpt_every=2)
        assert _ckpt_files(ckdir), f"{name} wrote no checkpoint"
        s_res, h_res = mk().run(num_iter=4, verbose=False, ckpt=mgr,
                                ckpt_every=100)
        assert len(h_res) == 2 and h_res[0]["iter"] == 2, name
        v_full = s_full[2] if isinstance(s_full, tuple) else s_full.v
        v_res = s_res[2] if isinstance(s_res, tuple) else s_res.v
        np.testing.assert_allclose(np.asarray(v_res), np.asarray(v_full),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_ovb_resume_matches(tmp_path):
    from svbfm.learners.vb_online import OVBLearner
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=400,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 12])
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, num_batches=3)
    mk = lambda: OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                            SparseDataset.from_coo(te, D), meta,
                            mesh=make_mesh(2), write_files=False)
    s_full, h_full = mk().run(num_iter=6, verbose=False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mk().run(num_iter=3, verbose=False, ckpt=mgr, ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "OVB run wrote no checkpoint"
    s_res, h_res = mk().run(num_iter=6, verbose=False, ckpt=mgr, ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_allclose(np.asarray(s_res.mu_v), np.asarray(s_full.mu_v),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"], rtol=1e-5)
