"""Out-of-core OVBFM benchmark: data larger than device HBM, bounded memory.

Generates a Netflix-shaped synthetic rating file DIRECTLY to disk in the
reference binary format (vectorized chunk writes — never holding the full
dataset in host RAM), then trains ``OVBLearner.from_reader`` where exactly
one chunk lives in HBM at a time.  This is the capability the reference's
OVBFM exists for (``fm_learn_vb_online_simultaneous.h:76-157``; the paper's
KDD-263M "only online methods fit in RAM" claim).

Usage: python scripts/bench_ovb_stream.py [rows] [K] [num_batches] [epochs] [shape]

``shape`` is ``netflix`` (default: 480k x 17.8k, ratings 1-5) or ``kdd``
(KDD Music per paper Table 1: 1,000,990 users x 624,961 items, ratings
0-100 — the dataset where the reference reports only the online methods
fit in its 16 GB RAM; run with rows=263000000 for the full-scale claim).
"""

import os as _os
import sys as _sys

# "python scripts/x.py" puts scripts/ (not the repo root) on
# sys.path, so bootstrap the package path explicitly
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import os
import struct
import sys
import time

import numpy as np

from svbfm.data.binary import (_HEADER, DVECTOR_FILE_ID,  # noqa: E402
                               FMATRIX_FILE_ID)

# (users, items, y_center, y_spread, y_min, y_max); sizes per paper Table 1
SHAPES = {
    "netflix": (480_189, 17_770, 3.6, 1.0, 1.0, 5.0),
    "kdd": (1_000_990, 624_961, 50.0, 20.0, 0.0, 100.0),
}


def generate_streaming(prefix: str, rows: int, shape: str = "netflix",
                       seed: int = 11, chunk: int = 5_000_000) -> None:
    """Write prefix.x / prefix.y without materializing the dataset: each
    row is (user one-hot, item one-hot), k=2, rank-structured targets."""
    users, items, y0, ys, ylo, yhi = SHAPES[shape]
    if os.path.exists(prefix + ".x") and os.path.exists(prefix + ".y"):
        with open(prefix + ".x", "rb") as f:
            _, _, _, nr, nc = _HEADER.unpack(f.read(_HEADER.size))
        if nr == rows and nc == users + items:
            print(f"# reusing {prefix}.x ({rows} rows)")
            return
    rng = np.random.default_rng(seed)
    rank = 8
    pu = (0.35 * rng.standard_normal((users, rank))).astype(np.float32)
    qi = (0.35 * rng.standard_normal((items, rank))).astype(np.float32)
    bu = (0.4 * rng.standard_normal(users)).astype(np.float32)
    bi = (0.4 * rng.standard_normal(items)).astype(np.float32)
    rec_t = np.dtype([("k", "<u4"), ("id0", "<u4"), ("v0", "<f4"),
                      ("id1", "<u4"), ("v1", "<f4")])
    t0 = time.perf_counter()
    with open(prefix + ".x", "wb") as fx, open(prefix + ".y", "wb") as fy:
        fx.write(_HEADER.pack(FMATRIX_FILE_ID, 4, 2 * rows, rows,
                              users + items))
        fy.write(struct.pack("<III", DVECTOR_FILE_ID, 4, rows))
        done = 0
        while done < rows:
            n = min(chunk, rows - done)
            u = rng.integers(0, users, n)
            i = rng.integers(0, items, n)
            y = y0 + ys * (bu[u] + bi[i]
                           + np.einsum("nk,nk->n", pu[u], qi[i])
                           + 0.6 * rng.standard_normal(n).astype(np.float32))
            y = np.clip(np.rint(y), ylo, yhi).astype(np.float32)
            rec = np.empty(n, rec_t)
            rec["k"] = 2
            rec["id0"] = u
            rec["v0"] = 1.0
            rec["id1"] = users + i
            rec["v1"] = 1.0
            fx.write(rec.tobytes())
            fy.write(y.tobytes())
            done += n
    print(f"# generated {rows} rows in {time.perf_counter()-t0:.0f} s "
          f"({os.path.getsize(prefix + '.x')/2**30:.2f} GiB on disk)",
          flush=True)


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 150_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    nb = int(sys.argv[3]) if len(sys.argv) > 3 else 60
    epochs = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    shape = sys.argv[5] if len(sys.argv) > 5 else "netflix"
    users, items, y0, ys, ylo, yhi = SHAPES[shape]
    prefix = os.environ.get("SVBFM_OVB_PREFIX", f"/tmp/ovb_big_{shape}")
    generate_streaming(prefix, rows, shape)

    import resource

    from svbfm.data.dataset import SparseDataset
    from svbfm.data.libfm_text import COOData
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.stream import BinaryChunkReader
    from svbfm.learners.base import FMConfig
    from svbfm.learners.vb_online import OVBLearner

    D = users + items
    reader = BinaryChunkReader(prefix + ".x", prefix + ".y")
    assert reader.num_rows == rows
    # small in-memory test set drawn from the SAME rank-structured model as
    # the training generator (seed 11), so test RMSE measures real fit —
    # not distance to a constant
    gen_rng = np.random.default_rng(11)
    rank = 8
    pu = (0.35 * gen_rng.standard_normal((users, rank))).astype(np.float32)
    qi = (0.35 * gen_rng.standard_normal((items, rank))).astype(np.float32)
    bu = (0.4 * gen_rng.standard_normal(users)).astype(np.float32)
    bi = (0.4 * gen_rng.standard_normal(items)).astype(np.float32)
    rng = np.random.default_rng(99)
    nt = 500_000
    u = rng.integers(0, users, nt)
    i = rng.integers(0, items, nt)
    yt = y0 + ys * (bu[u] + bi[i] + np.einsum("nk,nk->n", pu[u], qi[i])
                    + 0.6 * rng.standard_normal(nt).astype(np.float32))
    yt = np.clip(np.rint(yt), ylo, yhi).astype(np.float32)
    te = COOData(
        row=np.repeat(np.arange(nt, dtype=np.int32), 2),
        col=np.concatenate([u[:, None], (users + i)[:, None]],
                           axis=1).reshape(-1).astype(np.int32),
        val=np.ones(2 * nt, np.float32),
        target=yt, num_rows=nt, num_features=D)
    meta = DataMetaInfo.from_field_offsets(D, [0, users])
    cfg = FMConfig(num_attributes=D, num_factor=K, min_target=ylo,
                   max_target=yhi, num_groups=meta.num_attr_groups, seed=7,
                   num_batches=nb)
    t0 = time.perf_counter()
    learner = OVBLearner.from_reader(cfg, reader, SparseDataset.from_coo(te, D),
                                     meta, write_files=False,
                                     cache_dir=prefix + "_plans")
    print(f"# construction (streaming plan pass): {time.perf_counter()-t0:.0f} s")
    state = learner.init_state()
    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=1, verbose=False)
    print(f"# epoch 1 (compile + run): {time.perf_counter()-t0:.0f} s "
          f"rmse={hist[-1]['rmse']:.4f}")
    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=epochs, verbose=False)
    wall = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    from svbfm.utils.profiling import device_memory_stats
    dm = device_memory_stats()
    hbm = ""
    if dm and dm.get("peak_bytes_in_use"):
        hbm = f"  hbm_peak_gib={dm['peak_bytes_in_use']/2**30:.1f}"
    print(f"ovb stream sec/epoch: {wall/epochs:.1f}  rmse={hist[-1]['rmse']:.4f}"
          f"  host_rss_gib={rss:.1f}{hbm}")


if __name__ == "__main__":
    main()
