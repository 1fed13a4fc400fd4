import os
import tempfile

import numpy as np

from svbfm.data.binary import load_coo_binary, save_coo_binary
from svbfm.data.dataset import SparseDataset, SweepPlan, detect_field_bins, assign_bins_greedy
from svbfm.data.libfm_text import COOData, load_libfm_text, save_libfm_text
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, make_tiny, train_test_split


def test_text_roundtrip(tmp_path):
    coo = make_tiny(num_rows=50)
    p = str(tmp_path / "d.libfm")
    save_libfm_text(p, coo)
    back = load_libfm_text(p, use_native=False)
    assert back.num_rows == coo.num_rows
    assert back.num_features == coo.num_features
    np.testing.assert_array_equal(back.col, coo.col)
    np.testing.assert_allclose(back.val, coo.val)
    np.testing.assert_allclose(back.target, coo.target)


def test_text_parser_rules(tmp_path):
    p = str(tmp_path / "w.libfm")
    with open(p, "w") as f:
        f.write("# a comment line\n")
        f.write("  3.5 0:1 4:2.5  \n")
        f.write("\n")
        f.write("1 2:1 # trailing comment\n")
        f.write("-2.0\n")  # target-only row (no features)
    coo = load_libfm_text(p, use_native=False)
    assert coo.num_rows == 3
    assert coo.num_features == 5
    np.testing.assert_allclose(coo.target, [3.5, 1.0, -2.0])
    np.testing.assert_array_equal(coo.row, [0, 0, 1])
    np.testing.assert_array_equal(coo.col, [0, 4, 2])
    np.testing.assert_allclose(coo.val, [1.0, 2.5, 1.0])


def test_binary_roundtrip(tmp_path):
    coo = make_tiny(num_rows=40)
    prefix = str(tmp_path / "bin")
    save_coo_binary(prefix, coo, transpose=True)
    back = load_coo_binary(prefix)
    assert back.num_rows == coo.num_rows
    np.testing.assert_array_equal(np.sort(back.col), np.sort(coo.col))
    np.testing.assert_allclose(back.target, coo.target)


def test_row_layout():
    coo = make_tiny(num_rows=30)
    ds = SparseDataset.from_coo(coo)
    assert ds.max_row_nnz == 2
    back = ds.to_coo()
    np.testing.assert_array_equal(back.col, coo.col)
    np.testing.assert_allclose(back.target, coo.target)
    cc = ds.col_count()
    np.testing.assert_array_equal(cc, np.bincount(coo.col, minlength=coo.num_features))


def test_field_bin_detection():
    coo = make_tiny(num_rows=60, num_users=7, num_items=5)
    color = detect_field_bins(coo, coo.num_features)
    assert color is not None
    assert (color[:7] == 0).all() and (color[7:] == 1).all()


def test_greedy_coloring_conflict_free():
    rng = np.random.default_rng(0)
    # random sparse data without field structure
    N, D = 40, 15
    rows, cols, vals = [], [], []
    for n in range(N):
        k = rng.integers(1, 5)
        cs = rng.choice(D, size=k, replace=False)
        rows += [n] * k
        cols += list(cs)
        vals += [1.0] * k
    coo = COOData(np.array(rows, np.int32), np.array(cols, np.int32),
                  np.array(vals, np.float32), np.zeros(N, np.float32), N, D)
    color = assign_bins_greedy(coo, D)
    # no two columns of the same color share a row
    for b in range(color.max() + 1):
        seen = set()
        for r, c in zip(coo.row, coo.col):
            if color[c] == b:
                assert r not in seen
                seen.add(r)


def test_sweep_plan_shapes_and_stats():
    coo = make_tiny(num_rows=64, num_users=8, num_items=6)
    meta = DataMetaInfo(coo.num_features)
    plan = SweepPlan.build(coo, coo.num_features, meta.attr_group, n_shards=4)
    assert plan.num_bins == 2
    assert plan.num_shards == 4
    # global sx2 must equal per-column sum of x^2; every entry appears once
    sx2_ref = np.zeros(coo.num_features)
    np.add.at(sx2_ref, coo.col, coo.val.astype(np.float64) ** 2)
    seen_cols = []
    total_entries = 0
    for bin_blocks in plan.blocks:
        for blk in bin_blocks:
            assert blk.rows.shape[0] == 4
            C, L = blk.rows.shape[1:]
            assert blk.cols.shape == (C,)
            np.testing.assert_allclose(blk.sx2, sx2_ref[blk.cols], rtol=1e-6)
            # real entries sit below rows_per_shard; pads carry x == 0
            real = blk.x != 0
            assert (blk.rows[real] < plan.rows_per_shard).all()
            total_entries += int(real.sum())
            seen_cols.extend(blk.cols.tolist())
            # entry counts per column match the data
            cnt_ref = np.bincount(coo.col, minlength=coo.num_features)
            np.testing.assert_array_equal(real.sum((0, 2)), cnt_ref[blk.cols])
    assert total_entries == coo.nnz
    assert sorted(seen_cols) == sorted(np.unique(coo.col).tolist())


def test_split():
    coo = make_movielens_like(num_users=50, num_items=40, num_ratings=2000, seed=3)
    tr, te = train_test_split(coo, 0.2, seed=4)
    assert tr.num_rows + te.num_rows == coo.num_rows
    assert tr.num_features == coo.num_features


def test_sweep_plan_save_load(tmp_path):
    coo = make_tiny(num_rows=80, num_users=9, num_items=7)
    meta = DataMetaInfo(coo.num_features)
    plan = SweepPlan.build(coo, coo.num_features, meta.attr_group, n_shards=2)
    p = str(tmp_path / "plan.npz")
    plan.save(p)
    back = SweepPlan.load(p)
    assert back.num_bins == plan.num_bins
    assert back.rows_per_shard == plan.rows_per_shard
    assert back.conflict_free == plan.conflict_free
    np.testing.assert_array_equal(back.color, plan.color)
    for bb, pb in zip(back.blocks, plan.blocks):
        assert len(bb) == len(pb)
        for b1, b2 in zip(bb, pb):
            np.testing.assert_array_equal(b1.rows, b2.rows)
            np.testing.assert_allclose(b1.x, b2.x)
            np.testing.assert_array_equal(b1.cols, b2.cols)
            np.testing.assert_allclose(b1.sx2, b2.sx2)


def test_auto_bins_jacobi_fallback_warns(monkeypatch, capsys):
    """Above GREEDY_NNZ_CAP, bins=auto must fall back to Jacobi loudly and
    mark the plan non-conflict-free (no silent semantic change)."""
    from svbfm.data import dataset as dsmod
    rng = np.random.default_rng(1)
    N, D = 50, 12
    rows, cols, vals = [], [], []
    for n in range(N):
        k = int(rng.integers(2, 5))
        cs = rng.choice(D, size=k, replace=False)
        rows += [n] * k
        cols += list(cs)
        vals += [1.0] * k
    coo = COOData(np.array(rows, np.int32), np.array(cols, np.int32),
                  np.array(vals, np.float32), np.zeros(N, np.float32), N, D)
    monkeypatch.setattr(dsmod, "GREEDY_NNZ_CAP", 10)
    plan = SweepPlan.build(coo, D, bins="auto")
    out = capsys.readouterr().out
    assert not plan.conflict_free
    assert "WARNING" in out and "Jacobi" in out
    # under the cap: greedy engages, conflict-free, no warning
    monkeypatch.setattr(dsmod, "GREEDY_NNZ_CAP", 10**9)
    plan2 = SweepPlan.build(coo, D, bins="auto")
    out2 = capsys.readouterr().out
    assert plan2.conflict_free
    assert "WARNING" not in out2


def test_parse_bundled_reference_dataset():
    """Parse the reference repo's real bundled dataset (SURVEY.md artifacts:
    data/sa.test_libfm, 100k rows, 2 nnz/row one-hot, max feature id 9991)
    with both the Python and native-C parsers and cross-check them."""
    import pytest
    path = "/root/reference/data/sa.test_libfm"
    if not os.path.exists(path):
        pytest.skip("reference bundle not mounted")
    py = load_libfm_text(path, use_native=False)
    assert py.num_rows == 100_000
    assert py.nnz == 200_000
    assert py.col.max() == 9991
    assert py.num_features == 9992
    np.testing.assert_array_equal(py.row_nnz(), 2)
    nat = load_libfm_text(path, use_native=True)
    np.testing.assert_array_equal(nat.col, py.col)
    np.testing.assert_allclose(nat.val, py.val)
    np.testing.assert_allclose(nat.target, py.target)
