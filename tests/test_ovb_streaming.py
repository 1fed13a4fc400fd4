"""Out-of-core OVBFM: streaming chunked epochs from a binary reader.

The reference's OVBFM exists for data that doesn't fit in memory
(fm_learn_vb_online_simultaneous.h:76-157 disk-chunked epochs; libfm.cpp:
149-171 defers train loading).  These tests pin the streaming path against
the in-memory learner and exercise resume.
"""

import numpy as np

from svbfm.data.binary import save_coo_binary
from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.stream import BinaryChunkReader
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig
from svbfm.learners.vb_online import OVBLearner
from svbfm.parallel.mesh import make_mesh
from svbfm.utils.checkpoint import CheckpointManager


def _setup(tmp_path, num_batches, seed=2):
    coo = make_movielens_like(num_users=15, num_items=11, num_ratings=500,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 15])
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   num_batches=num_batches)
    prefix = str(tmp_path / "tr")
    save_coo_binary(prefix, tr)
    reader = BinaryChunkReader(prefix + ".x", prefix + ".y")
    return cfg, tr, te, D, meta, reader


def test_streaming_single_chunk_matches_in_memory(tmp_path):
    """num_batches=1: the streaming chunk IS the full dataset, so the
    trajectory must match the in-memory learner's (row order inside a chunk
    is immaterial — all statistics are row sums)."""
    cfg, tr, te, D, meta, reader = _setup(tmp_path, num_batches=1)
    te_ds = SparseDataset.from_coo(te, D)
    l_mem = OVBLearner(cfg, SparseDataset.from_coo(tr, D), te_ds, meta,
                       mesh=make_mesh(2), write_files=False)
    s_mem, h_mem = l_mem.run(num_iter=3, verbose=False)
    l_str = OVBLearner.from_reader(cfg, reader, te_ds, meta,
                                   mesh=make_mesh(2), write_files=False,
                                   cache_dir=str(tmp_path / "plans"))
    s_str, h_str = l_str.run(num_iter=3, verbose=False)
    np.testing.assert_allclose(np.asarray(s_str.mu_v), np.asarray(s_mem.mu_v),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(h_str[-1]["rmse"], h_mem[-1]["rmse"], rtol=1e-4)


def test_streaming_multichunk_converges(tmp_path):
    cfg, tr, te, D, meta, reader = _setup(tmp_path, num_batches=3)
    te_ds = SparseDataset.from_coo(te, D)
    l = OVBLearner.from_reader(cfg, reader, te_ds, meta, mesh=make_mesh(2),
                               write_files=False,
                               cache_dir=str(tmp_path / "plans"))
    state, hist = l.run(num_iter=5, verbose=False)
    rmses = [h["rmse"] for h in hist]
    assert all(np.isfinite(rmses))
    assert rmses[-1] < rmses[0]
    # free energy finite every epoch
    assert all(np.isfinite(h["free_energy"]) for h in hist)


def test_streaming_resume_matches(tmp_path):
    cfg, tr, te, D, meta, reader = _setup(tmp_path, num_batches=3)
    te_ds = SparseDataset.from_coo(te, D)
    mk = lambda: OVBLearner.from_reader(
        cfg, reader, te_ds, meta, mesh=make_mesh(2), write_files=False,
        cache_dir=str(tmp_path / "plans"))
    s_full, h_full = mk().run(num_iter=4, verbose=False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mk().run(num_iter=2, verbose=False, ckpt=mgr, ckpt_every=2)
    s_res, h_res = mk().run(num_iter=4, verbose=False, ckpt=mgr,
                            ckpt_every=100)
    assert len(h_res) == 2 and h_res[0]["iter"] == 2
    np.testing.assert_allclose(np.asarray(s_res.mu_v), np.asarray(s_full.mu_v),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(h_res[-1]["rmse"], h_full[-1]["rmse"], rtol=1e-5)


def test_streaming_classification(tmp_path):
    coo = make_movielens_like(num_users=15, num_items=11, num_ratings=500,
                              rank=2, noise=0.4, seed=5)
    coo.target = np.where(coo.target > coo.target.mean(), 1.0, -1.0).astype(
        np.float32)
    tr, te = train_test_split(coo, 0.2, seed=6)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 15])
    from svbfm.learners.base import TASK_CLASSIFICATION
    cfg = FMConfig(num_attributes=D, num_factor=2, task=TASK_CLASSIFICATION,
                   min_target=-1.0, max_target=1.0,
                   num_groups=meta.num_attr_groups, seed=7, num_batches=2)
    prefix = str(tmp_path / "tr")
    save_coo_binary(prefix, tr)
    reader = BinaryChunkReader(prefix + ".x", prefix + ".y")
    l = OVBLearner.from_reader(cfg, reader, SparseDataset.from_coo(te, D),
                               meta, mesh=make_mesh(2), write_files=False,
                               cache_dir=str(tmp_path / "plans"))
    state, hist = l.run(num_iter=3, verbose=False)
    assert all(0.0 <= h["accuracy"] <= 1.0 for h in hist)
    assert hist[-1]["accuracy"] > 0.5


def test_cli_deferred_binary_loading(tmp_path, monkeypatch, capsys):
    """vb_online with binary train input streams from disk (libfm.cpp:149-171
    deferred loading): the CLI never materializes the full train set."""
    from svbfm import cli
    coo = make_movielens_like(num_users=15, num_items=11, num_ratings=500,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.2, seed=3)
    save_coo_binary(str(tmp_path / "tr"), tr)
    save_coo_binary(str(tmp_path / "te"), te)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-task", "r", "-train", str(tmp_path / "tr"),
                   "-test", str(tmp_path / "te"), "-dim", "1,1,3",
                   "-method", "vb_online", "-iter", "2", "-batch", "2",
                   "-seed", "7"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "#Iter=  0" in out and "Final" in out
    assert (tmp_path / "test_rmse_113_vb_online").exists()
