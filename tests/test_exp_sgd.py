import numpy as np

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.exp_sgd import ExpSGDLearner, ExpSGDStocLearner
from svbfm.parallel.mesh import make_mesh


def _setup(num_rows=2000, num_users=30, num_items=25, K=4, n_dev=1, seed=3,
           **cfg_kw):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, **cfg_kw)
    return (SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            cfg, meta, make_mesh(n_dev))


def test_exp_sgd_full_batch_converges():
    tr_ds, te_ds, cfg, meta, mesh = _setup(learn_rate=0.5, stdev=1.0)
    learner = ExpSGDLearner(cfg, tr_ds, te_ds, meta, mesh=mesh,
                            write_files=False)
    state, history = learner.run(num_iter=20, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert np.isfinite(history[-1]["rmse"])


def test_exp_sgd_stoc_converges():
    tr_ds, te_ds, cfg, meta, mesh = _setup(learn_rate=0.05, batch_size=128,
                                           regw=0.01, regv=0.01)
    learner = ExpSGDStocLearner(cfg, tr_ds, te_ds, meta, mesh=mesh,
                                write_files=False)
    state, history = learner.run(num_iter=10, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]


def test_exp_sgd_matches_serial_oracle():
    """Full-batch coordinate sweeps vs the float64 ExpSGDOracle
    (exp_fm_learn_sgd.h:267-455) at factor_block=1 on one-hot field data
    (bin order == natural column order)."""
    from oracle import ExpSGDOracle

    coo = make_movielens_like(num_users=9, num_items=7, num_ratings=96,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 9])
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   learn_rate=0.4, stdev=1.0, regw=0.05, regv=0.05,
                   factor_block=1)
    learner = ExpSGDLearner(cfg, SparseDataset.from_coo(tr, D),
                            SparseDataset.from_coo(te, D), meta,
                            mesh=make_mesh(1), write_files=False)
    state = learner.init_state()
    orc = ExpSGDOracle(tr.row, tr.col, tr.val, tr.target, D, 3,
                       lr=cfg.learn_rate, stdev=cfg.stdev,
                       reg0=cfg.reg0, regw=cfg.regw, regv=cfg.regv)
    orc.init(*[np.asarray(a) for a in state])
    for _ in range(3):
        state, _rmse = learner._step(state, learner.train_row,
                                     learner.plan_data, learner.test_row)
        orc.iterate()
        w0, w, v = state
        np.testing.assert_allclose(float(w0), orc.w0, rtol=3e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(w), orc.w, rtol=3e-3, atol=3e-5)
        np.testing.assert_allclose(np.asarray(v), orc.v, rtol=3e-3, atol=3e-5)
