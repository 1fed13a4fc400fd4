"""Out-of-core (HBM-windowed) batch VB: windowed == resident trajectories.

The reference's -cache_size path (LargeSparseMatrixHD, fmatrix.h:110-233)
re-windows the data every sweep without changing the algorithm; the
windowed learner must likewise reproduce the resident VBLearner at the
same factor_block, up to f32 reassociation of the per-column sums (the
window axis splits each column's occurrence-list reduction)."""

import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig, TASK_CLASSIFICATION
from svbfm.learners.vb import VBLearner
from svbfm.learners.vb_windowed import WindowedVBLearner
from svbfm.parallel.mesh import make_mesh


def _setup(num_rows=3000, num_users=40, num_items=30, K=4, task=0, **kw):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=3)
    tr, te = train_test_split(coo, 0.2, seed=4)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    if task == TASK_CLASSIFICATION:
        thr = np.median(tr.target)
        tr.target = np.where(tr.target > thr, 1.0, -1.0).astype(np.float32)
        te.target = np.where(te.target > thr, 1.0, -1.0).astype(np.float32)
    cfg = FMConfig(num_attributes=D, num_factor=K, task=task,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, **kw)
    return tr, te, D, meta, cfg


@pytest.mark.parametrize("factor_block", [1, 2])
def test_windowed_matches_resident(factor_block):
    tr, te, D, meta, cfg = _setup(K=4, factor_block=factor_block)
    ref = VBLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta, mesh=make_mesh(1),
                    write_files=False)
    _, hist_ref = ref.run(num_iter=4, verbose=False)

    win = WindowedVBLearner(cfg, SparseDataset.from_coo(tr, D),
                            SparseDataset.from_coo(te, D), meta,
                            num_windows=3, write_files=False)
    assert win.num_windows >= 2  # actually windowed
    assert win.plan.conflict_free  # field coloring detected and merged
    _, hist_win = win.run(num_iter=4, verbose=False)
    for r_ref, r_w in zip(hist_ref, hist_win):
        np.testing.assert_allclose(r_w["rmse"], r_ref["rmse"],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r_w["free_energy"], r_ref["free_energy"],
                                   rtol=2e-4)
        np.testing.assert_allclose(r_w["alpha"], r_ref["alpha"], rtol=2e-3)


def test_windowed_classification_and_free_energy():
    tr, te, D, meta, cfg = _setup(K=3, task=TASK_CLASSIFICATION,
                                  factor_block=1)
    win = WindowedVBLearner(cfg, SparseDataset.from_coo(tr, D),
                            SparseDataset.from_coo(te, D), meta,
                            num_windows=2, write_files=False)
    _, hist = win.run(num_iter=4, verbose=False)
    assert hist[-1]["accuracy"] > 0.6
    fes = [h["free_energy"] for h in hist]
    assert all(np.isfinite(fes))


def test_windowed_from_binary_reader(tmp_path):
    """End-to-end through the reference binary format: write .x/.y, stream
    windows with BinaryChunkReader, match the resident trajectory."""
    from svbfm.data.binary import save_dvector_binary, save_sparse_binary
    from svbfm.data.stream import BinaryChunkReader

    tr, te, D, meta, cfg = _setup(K=4, factor_block=2)
    x_path, y_path = str(tmp_path / "tr.x"), str(tmp_path / "tr.y")
    save_sparse_binary(x_path, tr.row, tr.col, tr.val, tr.num_rows, D)
    save_dvector_binary(y_path, tr.target)
    reader = BinaryChunkReader(x_path, y_path)
    assert reader.num_rows == tr.num_rows

    ref = VBLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta, mesh=make_mesh(1),
                    write_files=False)
    _, hist_ref = ref.run(num_iter=3, verbose=False)

    win = WindowedVBLearner(cfg, reader, SparseDataset.from_coo(te, D),
                            meta, num_windows=3, write_files=False)
    _, hist_win = win.run(num_iter=3, verbose=False)
    for r_ref, r_w in zip(hist_ref, hist_win):
        np.testing.assert_allclose(r_w["rmse"], r_ref["rmse"],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r_w["free_energy"], r_ref["free_energy"],
                                   rtol=2e-4)
