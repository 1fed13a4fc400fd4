"""Edge dimension configs: k0/k1 off, K=0 (dim '1,1,0' / '0,0,K' etc.)."""
import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.mcmc import ALSLearner
from svbfm.learners.sgd import SGDLearner
from svbfm.learners.vb import VBLearner
from svbfm.parallel.mesh import make_mesh


def _data(seed=2):
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=600,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 12])
    return tr, te, D, meta


from svbfm.learners.exp_sgd import ExpSGDLearner, ExpSGDStocLearner
from svbfm.learners.mcmc import MCMCLearner
from svbfm.learners.vb_online import OVBLearner


@pytest.mark.parametrize("k0,k1,K", [(True, True, 0), (False, False, 3),
                                     (True, False, 2), (False, True, 0)])
@pytest.mark.parametrize("cls", [VBLearner, ALSLearner, SGDLearner,
                                 OVBLearner, MCMCLearner, ExpSGDLearner,
                                 ExpSGDStocLearner])
def test_edge_dims_run_and_stay_finite(k0, k1, K, cls):
    tr, te, D, meta = _data()
    cfg = FMConfig(num_attributes=D, num_factor=K, k0=k0, k1=k1,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   learn_rate=0.05, regw=0.05, regv=0.05, batch_size=64,
                   num_batches=3)
    learner = cls(cfg, SparseDataset.from_coo(tr, D),
                  SparseDataset.from_coo(te, D), meta, mesh=make_mesh(2),
                  write_files=False)
    state, history = learner.run(num_iter=3, verbose=False)
    key = "rmse" if "rmse" in history[-1] else "rmse_this"
    assert np.isfinite(history[-1][key])
    if k0 and cls is not ExpSGDLearner:
        # without the bias term the model can't center 1..5 targets fast
        # (exp-SGD's exponential-family multipliers converge differently)
        assert history[-1][key] < 2.0


@pytest.mark.parametrize("k0,k1,K", [(True, True, 0), (False, False, 3),
                                     (True, False, 2), (False, True, 0)])
def test_edge_dims_relational_bs(k0, k1, K):
    """K=0 / k0=0 / k1=0 on the native relational BS learners (per-factor
    caches and dim handling are branch-heavy there)."""
    from svbfm.data.libfm_text import COOData
    from svbfm.data.relation import RelationData, build_joined_meta
    from svbfm.learners.mcmc_bs import ALSBSLearner, MCMCBSLearner

    rng = np.random.default_rng(4)
    n, n_users, n_items = 200, 11, 6
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n).astype(np.int32)
    y = (2.0 + 0.2 * users + 0.4 * rng.standard_normal(n)).astype(np.float32)
    main = COOData(row=np.arange(n, dtype=np.int32),
                   col=users.astype(np.int32), val=np.ones(n, np.float32),
                   target=y, num_rows=n, num_features=n_users)
    rel = RelationData(row=np.arange(n_items, dtype=np.int32),
                       col=np.arange(n_items, dtype=np.int32),
                       val=np.ones(n_items, np.float32), num_rows=n_items,
                       num_features=n_items, meta=DataMetaInfo(n_items))
    meta = build_joined_meta(DataMetaInfo(n_users), [rel])
    cfg = FMConfig(num_attributes=meta.num_attributes, num_factor=K,
                   k0=k0, k1=k1, num_groups=meta.num_attr_groups,
                   min_target=float(y.min()), max_target=float(y.max()),
                   regw=0.05, regv=0.05, seed=3)
    tr = SparseDataset.from_coo(main, cfg.num_attributes)
    for cls in (MCMCBSLearner, ALSBSLearner):
        bs = cls(cfg, tr, tr, [rel], [items], [items], meta, n_users,
                 mesh=make_mesh(2), write_files=False)
        _s, history = bs.run(num_iter=3, verbose=False)
        key = "rmse" if "rmse" in history[-1] else "rmse_this"
        assert np.isfinite(history[-1][key])
