"""Map-based sparse container parity (reference src/util/smatrix.h)."""

import io

from svbfm.utils.smatrix import (
    SparseMatrix, SparseMatrixBoolean, SparseTensor, SparseTensorBoolean,
    SparseVector,
)


def test_sparse_vector_get_default_and_stream():
    v = SparseVector()
    v[3] = 1.5
    v[1] = 2.0
    assert v.get(3) == 1.5
    assert v.get(99) == 0          # absent -> 0, no insertion
    assert 99 not in v
    s = io.StringIO()
    v.to_stream(s)
    assert s.getvalue() == "1 2\n3 1.5\n"  # ascending key order


def test_sparse_matrix_roundtrip(tmp_path):
    m = SparseMatrix()
    m[2][7] = 0.25
    m[0][1] = -3.0
    m[2][1] = 4.0
    assert m.get(2, 7) == 0.25
    assert m.get(5, 5) == 0 and 5 not in m
    p = str(tmp_path / "m.txt")
    m.to_file(p)
    assert open(p).read() == "0 1 -3\n2 1 4\n2 7 0.25\n"
    m2 = SparseMatrix().from_file(p)
    assert m2.get(0, 1) == -3.0 and m2.get(2, 7) == 0.25 and m2.get(2, 1) == 4.0


def test_sparse_tensor_roundtrip(tmp_path):
    t = SparseTensor()
    t[1][0][2] = 9.0
    t[0][5][5] = 0.5
    p = str(tmp_path / "t.txt")
    t.to_file(p)
    assert open(p).read() == "0 5 5 0.5\n1 0 2 9\n"
    t2 = SparseTensor().from_file(p)
    assert t2.get(1, 0, 2) == 9.0
    assert t2.get(0, 5, 5) == 0.5
    assert t2.get(3, 3, 3) == 0


def test_boolean_variants_roundtrip(tmp_path):
    tb = SparseTensorBoolean()
    tb[0][1].add(4)
    tb[0][1].add(2)
    tb[2][0].add(0)
    assert tb.get(0, 1, 2) and not tb.get(0, 1, 3)
    p = str(tmp_path / "tb.txt")
    tb.to_file(p)
    assert open(p).read() == "0 1 2\n0 1 4\n2 0 0\n"
    tb2 = SparseTensorBoolean().from_file(p)
    assert tb2.get(0, 1, 4) and tb2.get(2, 0, 0) and not tb2.get(2, 0, 1)

    mb = SparseMatrixBoolean()
    mb[3].add(1)
    pm = str(tmp_path / "mb.txt")
    with open(pm, "w") as f:
        f.write("3 1\n5 0\n")
    mb2 = SparseMatrixBoolean().from_file(pm)
    assert mb2.get(3, 1) and mb2.get(5, 0) and not mb2.get(3, 2)


def test_from_file_tolerates_trailing_whitespace(tmp_path):
    p = str(tmp_path / "w.txt")
    with open(p, "w") as f:
        f.write("0 0 1.0\n\n  \n")   # eof-guarded >> loop semantics
    m = SparseMatrix().from_file(p)
    assert m.get(0, 0) == 1.0 and len(m) == 1
