import numpy as np

from svbfm.data.binary import save_coo_binary
from svbfm.data.stream import BinaryChunkReader, stream_chunks
from svbfm.data.synth import make_tiny


def test_chunk_reader_roundtrip(tmp_path):
    coo = make_tiny(num_rows=100, num_users=10, num_items=8)
    save_coo_binary(str(tmp_path / "d"), coo)
    r = BinaryChunkReader(str(tmp_path / "d.x"), str(tmp_path / "d.y"))
    assert r.num_rows == 100
    assert r.num_cols == coo.num_features
    # full-range read equals original
    back = r.read_rows(0, 100)
    np.testing.assert_array_equal(back.col, coo.col)
    np.testing.assert_allclose(back.val, coo.val)
    np.testing.assert_allclose(back.target, coo.target)
    # window read is consistent with the slice
    w = r.read_rows(30, 40)
    sel = (coo.row >= 30) & (coo.row < 40)
    np.testing.assert_array_equal(w.col, coo.col[sel])
    np.testing.assert_array_equal(w.row, coo.row[sel] - 30)
    # col_count matches
    np.testing.assert_array_equal(
        r.col_count(), np.bincount(coo.col, minlength=coo.num_features))


def test_stream_chunks_cover_all_rows(tmp_path):
    coo = make_tiny(num_rows=97, num_users=9, num_items=7)
    save_coo_binary(str(tmp_path / "d"), coo)
    r = BinaryChunkReader(str(tmp_path / "d.x"), str(tmp_path / "d.y"))
    total = 0
    seen_targets = []
    for ds in stream_chunks(r, 5, order=np.array([3, 1, 4, 0, 2])):
        total += ds.num_rows
        seen_targets.append(ds.target[: ds.num_rows])
    assert total == 97
    np.testing.assert_allclose(np.sort(np.concatenate(seen_targets)),
                               np.sort(coo.target))


def test_sgd_online_streaming_from_file(tmp_path):
    from svbfm.data.dataset import SparseDataset
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.synth import make_movielens_like, train_test_split
    from svbfm.learners.base import FMConfig
    from svbfm.learners.sgd import SGDOnlineLearner
    from svbfm.parallel.mesh import make_mesh

    coo = make_movielens_like(num_users=20, num_items=15, num_ratings=2000,
                              rank=2, noise=0.4, seed=5)
    tr, te = train_test_split(coo, 0.2, seed=6)
    save_coo_binary(str(tmp_path / "tr"), tr)
    reader = BinaryChunkReader(str(tmp_path / "tr.x"), str(tmp_path / "tr.y"))
    D = coo.num_features
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   learn_rate=0.05, regw=0.01, regv=0.01,
                   batch_size=128, num_batches=4)
    learner = SGDOnlineLearner.from_reader(
        cfg, reader, SparseDataset.from_coo(te, D),
        DataMetaInfo(D), mesh=make_mesh(1), write_files=False)
    state, history = learner.run(num_iter=8, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
