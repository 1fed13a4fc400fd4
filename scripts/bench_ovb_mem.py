"""In-memory OVBFM epoch throughput (the reference's default -method
vb_online operating mode: all chunks resident, one fused epoch program).

Trains OVBFM on ML-10M-shaped synthetic data (71,567 users x 10,681
items) and reports steady s/epoch.  An epoch costs more than a batch-VB
sweep over the same rows because of the reference's factor-sequential
natural-gradient sweep per chunk
(fm_learn_vb_online_simultaneous.h:76-157 — Gauss-Seidel over factors is
a stability requirement, see OVBLearner.__init__).

Usage: python scripts/bench_ovb_mem.py [rows] [K] [num_batches] [epochs]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

import numpy as np

NUM_USERS, NUM_ITEMS = 71_567, 10_681  # ML-10M shape
TEST_ROWS = 500_000


def make_split(rows: int, seed: int = 11):
    from svbfm.data.dataset import SparseDataset

    rng = np.random.default_rng(seed)
    rank = 8
    pu = (0.35 * rng.standard_normal((NUM_USERS, rank))).astype(np.float32)
    qi = (0.35 * rng.standard_normal((NUM_ITEMS, rank))).astype(np.float32)
    bu = (0.4 * rng.standard_normal(NUM_USERS)).astype(np.float32)
    bi = (0.4 * rng.standard_normal(NUM_ITEMS)).astype(np.float32)

    def gen(n):
        u = rng.integers(0, NUM_USERS, n)
        i = rng.integers(0, NUM_ITEMS, n)
        t = (3.6 + bu[u] + bi[i] + np.einsum("nk,nk->n", pu[u], qi[i])
             + 0.6 * rng.standard_normal(n).astype(np.float32))
        y = np.clip(np.rint(t), 1.0, 5.0).astype(np.float32)
        ids = np.stack([u, NUM_USERS + i], axis=1).astype(np.int32)
        D = NUM_USERS + NUM_ITEMS
        return SparseDataset(
            ids=ids, vals=np.ones((n, 2), np.float32), target=y,
            num_rows=n, num_features=D, min_target=float(y.min()),
            max_target=float(y.max()), row_nnz=np.full(n, 2, np.int32))

    return gen(rows), gen(TEST_ROWS)


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    nb = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    epochs = int(sys.argv[4]) if len(sys.argv) > 4 else 5

    t0 = time.perf_counter()
    train, test = make_split(rows)
    print(f"# generated {rows} rows in {time.perf_counter()-t0:.0f} s",
          flush=True)

    from svbfm.data.meta import DataMetaInfo
    from svbfm.learners.base import FMConfig
    from svbfm.learners.vb_online import OVBLearner

    D = train.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    cfg = FMConfig(num_attributes=D, num_factor=K, min_target=train.min_target,
                   max_target=train.max_target, num_groups=meta.num_attr_groups,
                   seed=7, num_batches=nb)
    t0 = time.perf_counter()
    learner = OVBLearner(cfg, train, test, meta, write_files=False)
    print(f"# construction: {time.perf_counter()-t0:.0f} s", flush=True)
    state = learner.init_state()
    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=1, verbose=False)
    print(f"# epoch 1 (compile + run): {time.perf_counter()-t0:.0f} s "
          f"rmse={hist[-1]['rmse']:.4f}", flush=True)
    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=epochs, verbose=False)
    np.asarray(state.mu_0)  # force the final value fetch
    wall = time.perf_counter() - t0
    print(f"ovb in-memory sec/epoch: {wall/epochs:.2f}  "
          f"rmse={hist[-1]['rmse']:.4f}  (rows={rows} nb={nb} K={K})",
          flush=True)


if __name__ == "__main__":
    main()
