"""Pairwise (BPR) SGD — the reference's fm_pairSGD kernel (fm_sgd.h:68-131)
made reachable: per-pair combined gradients with the grad_visited dedup,
w0 regularize-only, uniform negative sampling from the item field."""

import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.bpr import BPRLearner
from svbfm.parallel.mesh import make_mesh


def _setup(num_rows=4000, num_users=30, num_items=25, K=4, n_dev=1):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=3, noise=0.3,
                              seed=5)
    # implicit feedback: keep only above-median ratings as positives
    thr = np.median(coo.target)
    keep = coo.target > thr  # per ROW
    from svbfm.data.libfm_text import COOData
    kept_rows = np.where(keep)[0]
    remap = np.full(coo.num_rows, -1, np.int64)
    remap[kept_rows] = np.arange(len(kept_rows))
    m = remap[coo.row] >= 0  # per ENTRY
    pos = COOData(row=remap[coo.row[m]].astype(np.int32), col=coo.col[m],
                  val=coo.val[m], target=np.ones(len(kept_rows), np.float32),
                  num_rows=len(kept_rows), num_features=coo.num_features)
    tr, te = train_test_split(pos, 0.2, seed=6)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K, num_groups=2,
                   min_target=0.0, max_target=1.0, learn_rate=0.05,
                   regw=0.002, regv=0.002, num_batches=8, seed=9)
    return tr, te, D, meta, cfg


@pytest.mark.parametrize("n_dev", [1, 4])
def test_bpr_learns_to_rank(n_dev):
    tr, te, D, meta, cfg = _setup(n_dev=n_dev)
    learner = BPRLearner(cfg, SparseDataset.from_coo(tr, D),
                         SparseDataset.from_coo(te, D), meta,
                         mesh=make_mesh(n_dev), write_files=False)
    # negative field detected as the item range
    assert learner.neg_lo == 30 and learner.neg_hi <= D
    _, hist = learner.run(num_iter=15, verbose=False)
    # pairwise ranking accuracy beats chance and improves
    assert hist[-1]["accuracy"] > 0.55
    assert hist[-1]["accuracy"] > hist[0]["accuracy"] - 0.02
    assert hist[-1]["pair_loss"] < hist[0]["pair_loss"]


def test_bpr_w0_never_moves_from_gradient():
    """fm_pairSGD only regularizes w0 (its pairwise gradient cancels,
    fm_sgd.h:61); with reg0=0, w0 must stay at its init exactly."""
    tr, te, D, meta, cfg = _setup()
    learner = BPRLearner(cfg, SparseDataset.from_coo(tr, D),
                         SparseDataset.from_coo(te, D), meta,
                         mesh=make_mesh(1), write_files=False)
    s0 = learner.init_state()
    w0_init = float(s0.w0)
    state, _ = learner.run(state=s0, num_iter=3, verbose=False)
    assert float(state.w0) == w0_init


def test_bpr_cli(tmp_path):
    from svbfm.data.libfm_text import save_libfm_text
    import os
    tr, te, D, meta, cfg = _setup()
    trf, tef = str(tmp_path / "tr.libfm"), str(tmp_path / "te.libfm")
    save_libfm_text(trf, tr)
    save_libfm_text(tef, te)
    from svbfm.cli import main
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main(["-task", "r", "-train", trf, "-test", tef,
                   "-dim", "1,1,4", "-method", "bpr", "-iter", "3",
                   "-learn_rate", "0.05", "-batch", "4", "-seed", "2"])
    finally:
        os.chdir(old)
    assert rc == 0
    traj = tmp_path / "test_rmse_114_bpr"
    assert traj.exists()
    vals = [float(x) for x in traj.read_text().split()]
    assert len(vals) == 3 and all(np.isfinite(vals))
