"""Native tooling tests: ctypes parser fast path, svbfm_convert /
svbfm_transpose binaries, and byte-compatibility with the reference
formats (via svbfm.data.binary, which implements the same layout)."""

import os
import subprocess

import numpy as np
import pytest

from svbfm.data.binary import (load_coo_binary, load_sparse_binary,
                               save_coo_binary)
from svbfm.data.libfm_text import _load_native, load_libfm_text, save_libfm_text
from svbfm.data.synth import make_tiny

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")


def _tool(name):
    p = os.path.join(TOOLS, name)
    return p if os.path.exists(p) else None


@pytest.mark.skipif(_load_native() is None, reason="libfm_parse.so not built")
def test_native_parser_matches_python(tmp_path):
    coo = make_tiny(num_rows=200, num_users=12, num_items=9)
    p = str(tmp_path / "d.libfm")
    save_libfm_text(p, coo)
    py = load_libfm_text(p, use_native=False)
    nat = load_libfm_text(p, use_native=True)
    assert nat.num_rows == py.num_rows
    assert nat.num_features == py.num_features
    np.testing.assert_array_equal(nat.row, py.row)
    np.testing.assert_array_equal(nat.col, py.col)
    np.testing.assert_allclose(nat.val, py.val)
    np.testing.assert_allclose(nat.target, py.target)


@pytest.mark.skipif(_load_native() is None, reason="libfm_parse.so not built")
def test_native_parser_edge_rules(tmp_path):
    p = str(tmp_path / "w.libfm")
    with open(p, "w") as f:
        f.write("# comment\n")
        f.write("  3.5 0:1 4:2.5  \n")
        f.write("\n")
        f.write("1 2:1 # trailing\n")
        f.write("-2.0\n")
    coo = load_libfm_text(p, use_native=True)
    assert coo.num_rows == 3
    assert coo.num_features == 5
    np.testing.assert_allclose(coo.target, [3.5, 1.0, -2.0])
    np.testing.assert_array_equal(coo.col, [0, 4, 2])


@pytest.mark.skipif(_tool("svbfm_convert") is None, reason="tools not built")
def test_convert_tool_roundtrip(tmp_path):
    coo = make_tiny(num_rows=150, num_users=10, num_items=8)
    src = str(tmp_path / "d.libfm")
    save_libfm_text(src, coo)
    subprocess.run([_tool("svbfm_convert"), "-ifile", src,
                    "-ofilex", str(tmp_path / "d.x"),
                    "-ofiley", str(tmp_path / "d.y")],
                   check=True, capture_output=True)
    back = load_coo_binary(str(tmp_path / "d"))
    assert back.num_rows == coo.num_rows
    assert back.num_features == coo.num_features
    np.testing.assert_array_equal(back.col, coo.col)
    np.testing.assert_allclose(back.val, coo.val)
    np.testing.assert_allclose(back.target, coo.target)


@pytest.mark.skipif(_tool("svbfm_transpose") is None, reason="tools not built")
def test_transpose_tool(tmp_path):
    coo = make_tiny(num_rows=180, num_users=11, num_items=7)
    save_coo_binary(str(tmp_path / "d"), coo)
    # tiny cache to force multiple window passes
    subprocess.run([_tool("svbfm_transpose"), "-ifile", str(tmp_path / "d.x"),
                    "-ofile", str(tmp_path / "d.xt"),
                    "-cache_size", "256"],
                   check=True, capture_output=True)
    row_t, col_t, val_t, nr_t, nc_t = load_sparse_binary(str(tmp_path / "d.xt"))
    assert nr_t == coo.num_features and nc_t == coo.num_rows
    # transpose of transpose == original entry set
    a = sorted(zip(coo.col.tolist(), coo.row.tolist(), coo.val.tolist()))
    b = sorted(zip(row_t.tolist(), col_t.tolist(), val_t.tolist()))
    assert a == b


REF_CONVERT = "/tmp/refbuild/convert"


@pytest.mark.skipif(not os.path.exists(REF_CONVERT),
                    reason="reference convert not built on this machine")
def test_reference_convert_files_load(tmp_path):
    """Files produced by the REFERENCE convert tool load via our binary
    reader, proving byte compatibility."""
    coo = make_tiny(num_rows=120, num_users=9, num_items=6)
    src = str(tmp_path / "d.libfm")
    save_libfm_text(src, coo)
    subprocess.run([REF_CONVERT, "-ifile", src,
                    "-ofilex", str(tmp_path / "r.x"),
                    "-ofiley", str(tmp_path / "r.y")],
                   check=True, capture_output=True)
    row, col, val, nr, nc = load_sparse_binary(str(tmp_path / "r.x"))
    assert nr == coo.num_rows
    np.testing.assert_array_equal(col, coo.col)
    np.testing.assert_allclose(val, coo.val)


def test_triples_converter(tmp_path):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(TOOLS), "scripts"))
    import triples_to_libfm
    f1 = tmp_path / "train.txt"
    f1.write_text("u1 i1 5\nu1 i2 3\nu2 i1 4\n")
    f2 = tmp_path / "test.txt"
    f2.write_text("u2 i2 2\nu3 i1 1\n")
    gf = tmp_path / "groups"
    triples_to_libfm.main(["--in", f"{f1},{f2}", "--target_column", "2",
                           "--outmeta", str(gf)])
    tr = (tmp_path / "train.txt.libfm").read_text().splitlines()
    te = (tmp_path / "test.txt.libfm").read_text().splitlines()
    assert tr == ["5 0:1 1:1", "3 0:1 2:1", "4 3:1 1:1"]
    # shared id dictionary across files: u2 -> 3, i2 -> 2 reused
    assert te == ["2 3:1 2:1", "1 4:1 1:1"]
    groups = gf.read_text().split()
    assert groups == ["0", "1", "1", "0", "0"]
