"""Out-of-core streaming over binary sparse data.

The reference streams training data two ways: a windowed read cache over
binary ``.x`` files (``LargeSparseMatrixHD``, ``src/util/fmatrix.h:110-233``)
and per-epoch on-disk chunk files for the online learners
(``fm_learn_vb_online_simultaneous.h:76-157``, ``fm_learn_sgd_online.h:
78-131``).  Here a :class:`BinaryChunkReader` reads row-window chunks of a
``.x``/``.y`` pair directly into :class:`SparseDataset` chunks (host RAM is
bounded by the chunk size), and :func:`stream_chunks` iterates them in any
order for chunked-epoch training — the device only ever holds one chunk.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional

import numpy as np

from svbfm.data.binary import DVECTOR_FILE_ID, FMATRIX_FILE_ID, _HEADER
from svbfm.data.dataset import SparseDataset
from svbfm.data.libfm_text import COOData


class BinaryChunkReader:
    """Row-window reader over a reference-format binary sparse matrix.

    An index pass records each row's byte offset (cheap: header-sized reads
    only), after which any row window loads in one contiguous read."""

    def __init__(self, x_path: str, y_path: Optional[str] = None):
        self.x_path = x_path
        self.y_path = y_path
        with open(x_path, "rb") as f:
            hdr = f.read(_HEADER.size)
            fid, fsize, self.num_values, self.num_rows, self.num_cols = \
                _HEADER.unpack(hdr)
            if fid != FMATRIX_FILE_ID or fsize != 4:
                raise ValueError(f"{x_path}: bad header")
        # index pass: row byte offsets (C fast path streams the file once;
        # the Python fallback reads sequentially in large buffers)
        self.row_offsets = np.empty(self.num_rows + 1, dtype=np.int64)
        self.row_sizes = np.empty(self.num_rows, dtype=np.int64)
        if not self._index_scan_c():
            self._index_scan_py()
        self.targets = None
        if y_path is not None and os.path.exists(y_path):
            with open(y_path, "rb") as f:
                fid, dsize, dim = struct.unpack("<III", f.read(12))
                if fid != DVECTOR_FILE_ID or dsize != 4:
                    raise ValueError(f"{y_path}: bad header")
                self.targets = np.frombuffer(f.read(dim * 4), dtype="<f4")
            assert len(self.targets) == self.num_rows

    def _index_scan_c(self) -> bool:
        import ctypes
        import os
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        so = os.path.join(here, "tools", "libfm_parse.so")
        if not os.path.exists(so):
            return False
        try:
            lib = ctypes.CDLL(so)
            fn = lib.sparse_index_scan
        except (OSError, AttributeError):
            return False
        fn.restype = ctypes.c_int
        rc = fn(self.x_path.encode(), ctypes.c_longlong(_HEADER.size),
                ctypes.c_longlong(self.num_rows),
                self.row_offsets.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong)),
                self.row_sizes.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong)))
        return rc == 0

    def _index_scan_py(self) -> None:
        off = _HEADER.size
        buf_size = 1 << 24
        with open(self.x_path, "rb") as f:
            f.seek(off)
            buf = f.read(buf_size)
            base = off  # file offset of buf[0]
            pos = 0
            for r in range(self.num_rows):
                if pos + 4 > len(buf):
                    base += pos
                    f.seek(base)
                    buf = f.read(buf_size)
                    pos = 0
                (k,) = struct.unpack_from("<I", buf, pos)
                self.row_offsets[r] = base + pos
                self.row_sizes[r] = k
                pos += 4 + 8 * k
        self.row_offsets[self.num_rows] = (
            self.row_offsets[self.num_rows - 1]
            + 4 + 8 * self.row_sizes[self.num_rows - 1]
            if self.num_rows else _HEADER.size)

    def read_rows(self, lo: int, hi: int) -> COOData:
        """Rows [lo, hi) as a COOData with rows renumbered from 0.
        Vectorized: per-entry byte offsets are computed from the row index
        and the (id, value) records are gathered in one fancy-index pass."""
        lo, hi = int(lo), int(hi)
        with open(self.x_path, "rb") as f:
            f.seek(self.row_offsets[lo])
            buf = f.read(int(self.row_offsets[hi] - self.row_offsets[lo]))
        n = hi - lo
        sizes = self.row_sizes[lo:hi]
        nnz = int(sizes.sum())
        row = np.repeat(np.arange(n, dtype=np.int32), sizes)
        # within-row record positions
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sizes, out=ptr[1:])
        pos = np.arange(nnz, dtype=np.int64) - np.repeat(ptr[:-1], sizes)
        starts = self.row_offsets[lo:hi] - self.row_offsets[lo] + 4  # [n]
        entry_off = np.repeat(starts, sizes) + 8 * pos  # [nnz] byte offsets
        b = np.frombuffer(buf, dtype=np.uint8)
        rec = b[entry_off[:, None] + np.arange(8)]  # [nnz, 8]
        col = rec[:, :4].copy().view("<u4").ravel().astype(np.int32)
        val = rec[:, 4:].copy().view("<f4").ravel().astype(np.float32)
        target = (self.targets[lo:hi].astype(np.float32)
                  if self.targets is not None else np.zeros(n, np.float32))
        return COOData(row=row, col=col, val=val, target=target,
                       num_rows=n, num_features=self.num_cols)

    def col_count(self) -> np.ndarray:
        """Full-file per-column occurrence counts (one streaming pass) —
        the OVBFM col_count scan (fm_learn_vb_online.h:704-726)."""
        counts = np.zeros(self.num_cols, dtype=np.int64)
        chunk = max(1, min(self.num_rows, 262144))
        for lo in range(0, self.num_rows, chunk):
            coo = self.read_rows(lo, min(lo + chunk, self.num_rows))
            counts += np.bincount(coo.col, minlength=self.num_cols)
        return counts.astype(np.int32)


def stream_chunks(reader: BinaryChunkReader, num_chunks: int,
                  order: Optional[np.ndarray] = None,
                  min_target: Optional[float] = None,
                  max_target: Optional[float] = None,
                  ) -> Iterator[SparseDataset]:
    """Yield ``num_chunks`` contiguous row-window chunks (optionally in a
    shuffled order) as SparseDatasets."""
    bounds = np.linspace(0, reader.num_rows, num_chunks + 1).astype(np.int64)
    idx = np.arange(num_chunks) if order is None else np.asarray(order)
    for ci in idx:
        coo = reader.read_rows(bounds[ci], bounds[ci + 1])
        ds = SparseDataset.from_coo(coo, reader.num_cols)
        if min_target is not None:
            ds.min_target = min_target
        if max_target is not None:
            ds.max_target = max_target
        yield ds
