"""Per-iteration MAP@k inside the MCMC/OVBFM classification loops.

Reference behavior being matched:
- MCMC prints ``MAP@5= v`` on every ``#Iter`` line, computed on the
  posterior-mean probabilities (fm_learn_mcmc_simultaneous.h:270-275).
- OVBFM writes the MAP value (not accuracy) into the ``test_rmse_*``
  trajectory file for task 'c' (fm_learn_vb_online_simultaneous.h:258-262).
"""

import os

import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.libfm_text import save_libfm_text
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig, MapEval, TASK_CLASSIFICATION
from svbfm.parallel.mesh import make_mesh


def _class_data(num_users=25, num_items=20, num_ratings=2500, seed=9):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_ratings, rank=2, noise=0.4,
                              seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    thr = np.median(tr.target)
    tr.target = np.where(tr.target > thr, 1.0, -1.0).astype(np.float32)
    te.target = np.where(te.target > thr, 1.0, -1.0).astype(np.float32)
    return coo, tr, te


def _user_item_of(coo_sub, num_users):
    """Per-row (user, item) ids from a 2-hot movielens-like COO subset."""
    order = np.lexsort((coo_sub.col, coo_sub.row))
    row = coo_sub.row[order].reshape(-1, 2)
    col = coo_sub.col[order].reshape(-1, 2)
    assert (row[:, 0] == row[:, 1]).all()
    users = col.min(axis=1)
    items = col.max(axis=1) - num_users
    assert (users < num_users).all() and (items >= 0).all()
    return users, items


def _fixture_of(te, num_users):
    users, items = _user_item_of(te, num_users)
    positives = {}
    for u, i, y in zip(users, items, te.target):
        if y > 0:
            positives.setdefault(int(u), set()).add(int(i))
    return users, items, positives


def test_mcmc_per_iteration_map():
    coo, tr, te = _class_data()
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 25])
    cfg = FMConfig(num_attributes=D, num_factor=4, task=TASK_CLASSIFICATION,
                   min_target=-1.0, max_target=1.0,
                   num_groups=meta.num_attr_groups, seed=7)
    from svbfm.learners.mcmc import MCMCLearner
    learner = MCMCLearner(cfg, SparseDataset.from_coo(tr, D),
                          SparseDataset.from_coo(te, D), meta,
                          mesh=make_mesh(2), write_files=False)
    users, items, positives = _fixture_of(te, 25)
    learner.map_eval = MapEval(users, items, positives, k=5)
    state, history = learner.run(num_iter=4, verbose=False)
    assert len(history) == 4
    maps = [rec["map"] for rec in history]
    assert all(0.0 <= m <= 1.0 for m in maps)
    assert maps[-1] > 0.0  # a trained ranker must place some positives top-5
    # MAP must be computed per-iteration: early/late posterior means differ
    assert len(set(round(m, 12) for m in maps)) > 1


def test_ovb_map_written_to_trajectory_file(tmp_path):
    coo, tr, te = _class_data(seed=13)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 25])
    cfg = FMConfig(num_attributes=D, num_factor=4, task=TASK_CLASSIFICATION,
                   min_target=-1.0, max_target=1.0,
                   num_groups=meta.num_attr_groups, seed=7, num_batches=5)
    from svbfm.learners.vb_online import OVBLearner
    learner = OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                         SparseDataset.from_coo(te, D), meta,
                         mesh=make_mesh(2), out_dir=str(tmp_path))
    users, items, positives = _fixture_of(te, 25)
    learner.map_eval = MapEval(users, items, positives, k=5)
    state, history = learner.run(num_iter=3, verbose=False)
    assert all("map" in rec for rec in history)
    # the reference writes MAP (not accuracy) into test_rmse_* for task 'c'
    traj = tmp_path / "test_rmse_114_vb_online"
    vals = [float(x) for x in traj.read_text().split()]
    assert vals == pytest.approx([rec["map"] for rec in history], abs=1e-6)


def test_cli_map_eval_per_iteration(tmp_path, capsys):
    coo, tr, te = _class_data(seed=21)
    trf, tef = str(tmp_path / "c.train"), str(tmp_path / "c.test")
    save_libfm_text(trf, tr)
    save_libfm_text(tef, te)
    users, items = _user_item_of(te, 25)
    fixf = str(tmp_path / "c.fixture")
    with open(fixf, "w") as f:
        for u, i, y in zip(users, items, te.target):
            f.write(f"{1 if y > 0 else 0} {u}:1 {i}:1\n")
    from svbfm.cli import main
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = main(["-task", "c", "-train", trf, "-test", tef,
                   "-dim", "1,1,4", "-method", "mcmc", "-iter", "3",
                   "-seed", "3", "-map_eval", fixf, "-map_k", "5"])
    finally:
        os.chdir(old)
    assert rc == 0
    out = capsys.readouterr().out
    iter_lines = [ln for ln in out.splitlines() if ln.startswith("#Iter=")]
    assert len(iter_lines) == 3
    assert all("MAP@5= " in ln for ln in iter_lines)
