"""Feature-sharded SGD (parallel.tp_sgd): w/V shard over the feature
axis; trajectories must match the replicated learner at the same
data-shard count (same shuffle keys, same batch membership, same damped
relaxation — only psum reassociation differs)."""

import dataclasses

import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import TASK_CLASSIFICATION, TASK_REGRESSION, FMConfig
from svbfm.learners.sgd import SGDLearner
from svbfm.parallel.mesh import make_mesh, make_mesh2d
from svbfm.parallel.tp_sgd import TPSGDLearner


def _setup(num_rows=900, num_users=18, num_items=14, K=3,
           task=TASK_REGRESSION):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K, task=task,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   learn_rate=0.05, regw=0.01, regv=0.01,
                   batch_size=128)
    return tr, te, D, meta, cfg


@pytest.mark.parametrize("n_data,n_feat", [(1, 2), (2, 2), (1, 4)])
def test_tp_sgd_matches_replicated(n_data, n_feat):
    tr, te, D, meta, cfg = _setup()
    ref = SGDLearner(cfg, SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta,
                     mesh=make_mesh(n_data), write_files=False)
    _, hist_ref = ref.run(num_iter=5, verbose=False)

    tp = TPSGDLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta,
                      mesh=make_mesh2d(n_data=n_data, n_feature=n_feat),
                      write_files=False)
    assert tp.D_pad >= D and tp.D_loc * n_feat == tp.D_pad
    assert tp.num_batches == ref.num_batches
    _, hist_tp = tp.run(num_iter=5, verbose=False)
    for r_ref, r_tp in zip(hist_ref, hist_tp):
        np.testing.assert_allclose(r_tp["rmse"], r_ref["rmse"],
                                   rtol=2e-4, atol=2e-5)


def test_tp_sgd_state_tables_are_feature_sharded():
    tr, te, D, meta, cfg = _setup()
    tp = TPSGDLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta,
                      mesh=make_mesh2d(n_data=2, n_feature=2),
                      write_files=False)
    state = tp.init_state()
    for name in ("w", "v"):
        spec = getattr(state, name).sharding.spec
        assert "feature" in str(spec), (name, spec)
    assert state.w0.sharding.is_fully_replicated
    state, _ = tp.run(state, num_iter=2, verbose=False)
    spec = state.v.sharding.spec
    assert "feature" in str(spec), spec


def test_tp_sgd_classification():
    tr, te, D, meta, cfg = _setup(task=TASK_CLASSIFICATION)
    # binarize targets to +-1 around the rating midpoint (cli task-c rule)
    mid = 0.5 * (cfg.min_target + cfg.max_target)
    tr.target[:] = np.where(tr.target > mid, 1.0, -1.0)
    te.target[:] = np.where(te.target > mid, 1.0, -1.0)
    cfg = dataclasses.replace(cfg, min_target=-1.0, max_target=1.0)
    ref = SGDLearner(cfg, SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta,
                     mesh=make_mesh(1), write_files=False)
    _, hist_ref = ref.run(num_iter=4, verbose=False)
    tp = TPSGDLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta,
                      mesh=make_mesh2d(n_data=1, n_feature=2),
                      write_files=False)
    _, hist_tp = tp.run(num_iter=4, verbose=False)
    for r_ref, r_tp in zip(hist_ref, hist_tp):
        assert abs(r_tp["accuracy"] - r_ref["accuracy"]) <= 0.02
