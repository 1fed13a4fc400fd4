"""Reference-compatible binary sparse-matrix / target-vector IO.

Formats (byte-compatible with the reference so files produced by its
``convert`` / ``transpose`` tools load directly, and vice versa):

* Sparse matrix (``.x`` / ``.xt`` / ``.data`` / ``.datat``), reference
  ``src/util/fmatrix.h:46-108``:
    header: uint32 id(=2), uint32 float_size, uint64 num_values,
            uint32 num_rows, uint32 num_cols   (packed, 24 bytes)
    then per row: uint32 size, size * { uint32 id, float32 value }

* Dense vector (``.y`` / ``.target``), reference ``src/util/matrix.h:280-328``:
    uint32 id(=1), uint32 data_size, uint32 num_rows, then raw values.
"""

from __future__ import annotations

import struct

import numpy as np

from svbfm.data.libfm_text import COOData

FMATRIX_FILE_ID = 2
DVECTOR_FILE_ID = 1
_HEADER = struct.Struct("<IIQII")


def save_sparse_binary(path: str, row: np.ndarray, col: np.ndarray, val: np.ndarray,
                       num_rows: int, num_cols: int) -> None:
    order = np.argsort(row, kind="stable")
    row, col, val = row[order], col[order], val[order]
    nnz_per_row = np.bincount(row, minlength=num_rows)
    ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(nnz_per_row, out=ptr[1:])
    # interleaved (uint32 id, float32 value) records
    rec = np.empty(len(col), dtype=[("id", "<u4"), ("value", "<f4")])
    rec["id"] = col.astype(np.uint32)
    rec["value"] = val.astype(np.float32)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(FMATRIX_FILE_ID, 4, len(col), num_rows, num_cols))
        for r in range(num_rows):
            k = int(ptr[r + 1] - ptr[r])
            f.write(struct.pack("<I", k))
            if k:
                f.write(rec[ptr[r] : ptr[r + 1]].tobytes())


def load_sparse_binary(path: str):
    """Returns (row, col, val, num_rows, num_cols)."""
    with open(path, "rb") as f:
        buf = f.read()
    fid, float_size, num_values, num_rows, num_cols = _HEADER.unpack_from(buf, 0)
    if fid != FMATRIX_FILE_ID:
        raise ValueError(f"{path}: bad sparse file id {fid}")
    if float_size != 4:
        raise ValueError(f"{path}: unsupported float size {float_size}")
    off = _HEADER.size
    row = np.empty(num_values, dtype=np.int32)
    col = np.empty(num_values, dtype=np.int32)
    val = np.empty(num_values, dtype=np.float32)
    at = 0
    for r in range(num_rows):
        (k,) = struct.unpack_from("<I", buf, off)
        off += 4
        if k:
            rec = np.frombuffer(buf, dtype=[("id", "<u4"), ("value", "<f4")], count=k, offset=off)
            off += 8 * k
            row[at : at + k] = r
            col[at : at + k] = rec["id"]
            val[at : at + k] = rec["value"]
            at += k
    assert at == num_values, f"{path}: nnz mismatch {at} != {num_values}"
    return row, col, val, num_rows, num_cols


def save_dvector_binary(path: str, values: np.ndarray, dtype=np.float32) -> None:
    v = np.asarray(values, dtype=dtype)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", DVECTOR_FILE_ID, v.dtype.itemsize, v.shape[0]))
        f.write(v.tobytes())


def load_dvector_binary(path: str, dtype=np.float32) -> np.ndarray:
    with open(path, "rb") as f:
        fid, data_size, num_rows = struct.unpack("<III", f.read(12))
        if fid != DVECTOR_FILE_ID:
            raise ValueError(f"{path}: bad dvector file id {fid}")
        dt = np.dtype(dtype)
        if data_size != dt.itemsize:
            raise ValueError(f"{path}: itemsize {data_size} != expected {dt.itemsize}")
        return np.frombuffer(f.read(num_rows * dt.itemsize), dtype=dt).copy()


def save_coo_binary(prefix: str, coo: COOData, transpose: bool = False) -> None:
    """Write ``prefix.x`` + ``prefix.y`` (and ``prefix.xt`` with transpose),
    matching the outputs of the reference ``convert``/``transpose`` tools."""
    save_sparse_binary(prefix + ".x", coo.row, coo.col, coo.val, coo.num_rows, coo.num_features)
    save_dvector_binary(prefix + ".y", coo.target, np.float32)
    if transpose:
        save_sparse_binary(prefix + ".xt", coo.col, coo.row, coo.val, coo.num_features, coo.num_rows)


def load_coo_binary(prefix: str) -> COOData:
    import os
    if os.path.exists(prefix + ".x"):
        row, col, val, num_rows, num_cols = load_sparse_binary(prefix + ".x")
        target = load_dvector_binary(prefix + ".y")
    elif os.path.exists(prefix + ".data"):
        row, col, val, num_rows, num_cols = load_sparse_binary(prefix + ".data")
        target = load_dvector_binary(prefix + ".target")
    elif os.path.exists(prefix + ".xt"):
        # only the transpose exists: flip it
        col, row, val, num_cols, num_rows = load_sparse_binary(prefix + ".xt")
        order = np.argsort(row, kind="stable")
        row, col, val = row[order], col[order], val[order]
        target = load_dvector_binary(prefix + ".y")
    else:
        raise FileNotFoundError(f"no binary data at {prefix}.x / {prefix}.data")
    return COOData(row=row.astype(np.int32), col=col.astype(np.int32),
                   val=val.astype(np.float32), target=target.astype(np.float32),
                   num_rows=num_rows, num_features=num_cols)


def has_binary(prefix: str) -> bool:
    import os
    return (
        os.path.exists(prefix + ".x") or os.path.exists(prefix + ".data")
    ) and (os.path.exists(prefix + ".y") or os.path.exists(prefix + ".target"))
