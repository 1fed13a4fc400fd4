"""Feature-sharded OVBFM (parallel.tp_ovb): the natural/primal tables
shard over the feature axis; trajectories must match the replicated
learner (same chunk membership, same epoch order, same update math —
only psum reassociation differs)."""

import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.vb_online import OVBLearner
from svbfm.parallel.mesh import make_mesh, make_mesh2d
from svbfm.parallel.tp_ovb import TPOVBLearner


def _setup(num_rows=900, num_users=18, num_items=14, K=3, num_batches=4):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   num_batches=num_batches)
    return tr, te, D, meta, cfg


@pytest.mark.parametrize("n_data,n_feat", [(1, 2), (2, 2), (1, 4)])
def test_tp_ovb_matches_replicated(n_data, n_feat):
    tr, te, D, meta, cfg = _setup()
    ref = OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta,
                     mesh=make_mesh(1), write_files=False)
    _, hist_ref = ref.run(num_iter=4, verbose=False)

    tp = TPOVBLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta,
                      mesh=make_mesh2d(n_data=n_data, n_feature=n_feat),
                      write_files=False)
    assert tp.D_pad >= D and tp.D_loc * n_feat == tp.D_pad
    _, hist_tp = tp.run(num_iter=4, verbose=False)
    for r_ref, r_tp in zip(hist_ref, hist_tp):
        np.testing.assert_allclose(r_tp["rmse"], r_ref["rmse"],
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(r_tp["free_energy"],
                                   r_ref["free_energy"], rtol=2e-3)


def test_tp_ovb_state_tables_are_feature_sharded():
    tr, te, D, meta, cfg = _setup()
    tp = TPOVBLearner(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta,
                      mesh=make_mesh2d(n_data=2, n_feature=2),
                      write_files=False)
    state = tp.init_state()
    # the [D_pad]/[K, D_pad] tables shard over 'feature'
    for name in ("mu_w", "n_mu_w", "t_vj"):
        spec = getattr(state, name).sharding.spec
        assert "feature" in str(spec), (name, spec)
    for name in ("mu_v", "n_sig_v"):
        spec = getattr(state, name).sharding.spec
        assert "feature" in str(spec), (name, spec)
    # scalars and group hypers replicated
    assert getattr(state, "sigma_v").sharding.is_fully_replicated
