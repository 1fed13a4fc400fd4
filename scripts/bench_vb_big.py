"""Full-Netflix-scale BATCH VB on one chip.

The reference paper's scalability story (§5.3) is that at Netflix scale
(100M ratings) its 16 GB machine is near the limit for the *batch* methods
and at KDD scale only the online ones fit.  This benchmark trains batch
VBFM (``-method vb``, dim 1,1,K) on Netflix-shaped synthetic data —
480,189 users x 17,770 items, N train rows (default the full 100M: the
training side of the Netflix prize set) — entirely device-resident on ONE
GPU, using the memory-tiled chunk=1 sweep path.

Usage: python scripts/bench_vb_big.py [rows] [K] [factor_block] [iters]
"""

import os as _os
import sys as _sys

# "python scripts/x.py" puts scripts/ (not the repo root) on
# sys.path, so bootstrap the package path explicitly
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import sys
import time

import numpy as np

NUM_USERS, NUM_ITEMS = 480_189, 17_770  # Netflix shape
TEST_ROWS = 1_000_000


def make_split(rows: int, seed: int = 11):
    """Rank-structured one-hot (user, item) ratings, generated directly into
    the padded [N, 2] row layout (no COO intermediate at 100M rows).
    Caches ids/targets under /tmp so retries skip the generation pass
    (vals are all 1.0 and never stored)."""
    from svbfm.data.dataset import SparseDataset

    cache = f"/tmp/vb_big_{rows}_{seed}"

    def from_cache(tag, n):
        ids = np.load(f"{cache}_{tag}_ids.npy")
        y = np.load(f"{cache}_{tag}_y.npy")
        assert ids.shape == (n, 2)
        D = NUM_USERS + NUM_ITEMS
        return SparseDataset(
            ids=ids, vals=np.ones((n, 2), np.float32), target=y,
            num_rows=n, num_features=D, min_target=float(y.min()),
            max_target=float(y.max()), row_nnz=np.full(n, 2, np.int32))

    try:
        return from_cache("tr", rows), from_cache("te", TEST_ROWS)
    except (FileNotFoundError, AssertionError):
        pass

    rng = np.random.default_rng(seed)
    rank = 8
    pu = (0.35 * rng.standard_normal((NUM_USERS, rank))).astype(np.float32)
    qi = (0.35 * rng.standard_normal((NUM_ITEMS, rank))).astype(np.float32)
    bu = (0.4 * rng.standard_normal(NUM_USERS)).astype(np.float32)
    bi = (0.4 * rng.standard_normal(NUM_ITEMS)).astype(np.float32)

    def gen(n, chunk=20_000_000):
        ids = np.empty((n, 2), dtype=np.int32)
        vals = np.ones((n, 2), dtype=np.float32)
        y = np.empty(n, dtype=np.float32)
        done = 0
        while done < n:
            m = min(chunk, n - done)
            u = rng.integers(0, NUM_USERS, m)
            i = rng.integers(0, NUM_ITEMS, m)
            t = (3.6 + bu[u] + bi[i] + np.einsum("nk,nk->n", pu[u], qi[i])
                 + 0.6 * rng.standard_normal(m).astype(np.float32))
            ids[done:done + m, 0] = u
            ids[done:done + m, 1] = NUM_USERS + i
            y[done:done + m] = np.clip(np.rint(t), 1.0, 5.0)
            done += m
        D = NUM_USERS + NUM_ITEMS
        return SparseDataset(
            ids=ids, vals=vals, target=y, num_rows=n, num_features=D,
            min_target=float(y.min()), max_target=float(y.max()),
            row_nnz=np.full(n, 2, dtype=np.int32))

    tr, te = gen(rows), gen(TEST_ROWS)
    for tag, ds in (("tr", tr), ("te", te)):
        np.save(f"{cache}_{tag}_ids.npy", ds.ids)
        np.save(f"{cache}_{tag}_y.npy", ds.target)
    return tr, te


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    fb = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    iters = int(sys.argv[4]) if len(sys.argv) > 4 else 6

    t0 = time.perf_counter()
    train, test = make_split(rows)
    print(f"# generated {rows} train rows in {time.perf_counter()-t0:.0f} s",
          flush=True)

    import resource

    from svbfm.data.meta import DataMetaInfo
    from svbfm.learners.base import FMConfig
    from svbfm.learners.vb import VBLearner

    D = train.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=fb,
                   min_target=train.min_target, max_target=train.max_target,
                   num_groups=meta.num_attr_groups, seed=7)
    t0 = time.perf_counter()
    from svbfm.data.dataset import SweepPlan
    plan_path = f"/tmp/vb_big_plan_{rows}_11.npz"
    plan = None
    if _os.path.exists(plan_path):
        plan = SweepPlan.load(plan_path)
        print("# plan loaded from cache", flush=True)
    learner = VBLearner(cfg, train, test, meta, write_files=False, plan=plan)
    if plan is None:
        learner.plan.save(plan_path)
    print(f"# plan+transfer in {time.perf_counter()-t0:.0f} s "
          f"(tiled={learner._needs_row_tiling()})", flush=True)
    state = learner.init_state()
    np.asarray(state.mu_0)  # force the init transfers to complete

    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=iters, verbose=True, chunk=1)
    np.asarray(state.mu_0)
    wall = time.perf_counter() - t0
    # iter 1 includes the big fused-program compile; report the steady tail
    steady = wall / iters if iters <= 2 else (
        sum(h["time_learn"] for h in hist[1:]) / (len(hist) - 1))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    from svbfm.utils.profiling import device_memory_stats
    dm = device_memory_stats() or {}
    hbm = dm.get("peak_bytes_in_use", 0) / 2**30
    print(f"# {rows} rows K={K} fb={fb}: {steady:.2f} s/iter steady "
          f"({wall:.0f} s total incl. compile), "
          f"rmse {hist[0]['rmse']:.4f} -> {hist[-1]['rmse']:.4f}, "
          f"host RSS {rss:.1f} GiB, device peak {hbm:.1f} GiB", flush=True)


if __name__ == "__main__":
    main()
