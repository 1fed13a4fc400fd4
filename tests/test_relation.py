import numpy as np

from svbfm.data.binary import save_sparse_binary
from svbfm.data.libfm_text import COOData, save_libfm_text
from svbfm.data.meta import DataMetaInfo
from svbfm.data.relation import (RelationData, build_joined_meta,
                                 join_relations, load_join)


def _rel():
    # 3 relation rows over 4 attributes
    return RelationData(
        row=np.array([0, 0, 1, 2], np.int32),
        col=np.array([0, 2, 1, 3], np.int32),
        val=np.array([1.0, 0.5, 1.0, 2.0], np.float32),
        num_rows=3, num_features=4, meta=DataMetaInfo(4))


def test_join_expansion():
    main = COOData(row=np.array([0, 1], np.int32), col=np.array([1, 0], np.int32),
                   val=np.ones(2, np.float32), target=np.array([1.0, 2.0], np.float32),
                   num_rows=2, num_features=2)
    rel = _rel()
    meta_main = DataMetaInfo(2)
    meta = build_joined_meta(meta_main, [rel])
    assert meta.num_attributes == 6
    assert rel.attr_offset == 2
    # relation groups appended after main groups
    assert meta.num_attr_groups == 2
    np.testing.assert_array_equal(meta.attr_group, [0, 0, 1, 1, 1, 1])

    join = np.array([2, 0])  # row0 -> rel row 2, row1 -> rel row 0
    out = join_relations(main, [rel], [join], 2)
    assert out.num_features == 6
    got = sorted(zip(out.row.tolist(), out.col.tolist(), out.val.tolist()))
    assert got == [(0, 1, 1.0), (0, 5, 2.0),        # main + rel row 2 (3->5)
                   (1, 0, 1.0), (1, 2, 1.0), (1, 4, 0.5)]  # main + rel row 0


def test_relation_load_and_join_files(tmp_path):
    rel = _rel()
    save_sparse_binary(str(tmp_path / "r.x"), rel.row, rel.col, rel.val,
                       rel.num_rows, rel.num_features)
    np.savetxt(str(tmp_path / "r.groups"), [0, 0, 1, 1], fmt="%d")
    loaded = RelationData.load(str(tmp_path / "r"))
    assert loaded.num_rows == 3 and loaded.num_features == 4
    assert loaded.meta.num_attr_groups == 2
    (tmp_path / "r.train").write_text("2\n0\n")
    j = load_join(str(tmp_path / "r.train"), 2)
    np.testing.assert_array_equal(j, [2, 0])


def test_cli_relation_end_to_end(tmp_path):
    import os
    from svbfm.cli import main as cli_main
    rng = np.random.default_rng(0)
    n_users, n_items, n = 8, 3, 200
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    y = 3.0 + 0.5 * rng.standard_normal(n)
    # main features: user one-hot only; items come in via a relation table
    main_tr = COOData(row=np.arange(n, dtype=np.int32), col=users.astype(np.int32),
                      val=np.ones(n, np.float32), target=y.astype(np.float32),
                      num_rows=n, num_features=n_users)
    save_libfm_text(str(tmp_path / "tr.libfm"), main_tr)
    save_libfm_text(str(tmp_path / "te.libfm"), main_tr)
    rel = COOData(row=np.arange(n_items, dtype=np.int32),
                  col=np.arange(n_items, dtype=np.int32),
                  val=np.ones(n_items, np.float32),
                  target=np.zeros(n_items, np.float32),
                  num_rows=n_items, num_features=n_items)
    save_sparse_binary(str(tmp_path / "rel.x"), rel.row, rel.col, rel.val,
                       n_items, n_items)
    np.savetxt(str(tmp_path / "rel.train"), items, fmt="%d")
    np.savetxt(str(tmp_path / "rel.test"), items, fmt="%d")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = cli_main(["-task", "r", "-train", str(tmp_path / "tr.libfm"),
                       "-test", str(tmp_path / "te.libfm"),
                       "-relation", str(tmp_path / "rel"),
                       "-dim", "1,1,2", "-method", "als", "-iter", "3",
                       "-regular", "0.1"])
    finally:
        os.chdir(cwd)
    assert rc == 0
