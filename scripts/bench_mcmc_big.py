"""Full-Netflix-scale Gibbs-MCMC / ALS on one chip.

The reference paper's 100M plot (results/100M_20.png) includes MCMC-FM;
this benchmark trains batch Gibbs (or ALS) on Netflix-shaped synthetic
data (480,189 users x 17,770 items, N train rows) entirely
device-resident on ONE GPU, via the staged draw path
(learners.mcmc._staged_*: A scalar draws + w sweep / one program per
factor block / C re-predict + eval) with row/column-tiled temps.

Usage: python scripts/bench_mcmc_big.py [rows] [K] [factor_block] [iters] [method]
"""

import os as _os
import sys as _sys

# "python scripts/x.py" puts scripts/ (not the repo root) on
# sys.path, so bootstrap the package path explicitly
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import sys
import time

import numpy as np

from bench_vb_big import NUM_USERS, make_split


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    fb = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    iters = int(sys.argv[4]) if len(sys.argv) > 4 else 6
    method = sys.argv[5] if len(sys.argv) > 5 else "mcmc"

    t0 = time.perf_counter()
    train, test = make_split(rows)
    print(f"# generated {rows} train rows in {time.perf_counter()-t0:.0f} s",
          flush=True)

    import resource

    from svbfm.data.meta import DataMetaInfo
    from svbfm.learners.base import FMConfig
    from svbfm.learners.mcmc import ALSLearner, MCMCLearner

    D = train.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=fb,
                   min_target=train.min_target, max_target=train.max_target,
                   num_groups=meta.num_attr_groups, seed=7)
    cls = ALSLearner if method == "als" else MCMCLearner
    t0 = time.perf_counter()
    from svbfm.data.dataset import SweepPlan
    plan_path = f"/tmp/vb_big_plan_{rows}_11.npz"
    plan = None
    if _os.path.exists(plan_path):
        plan = SweepPlan.load(plan_path)
        print("# plan loaded from cache", flush=True)
    learner = cls(cfg, train, test, meta, write_files=False, plan=plan)
    if plan is None:
        learner.plan.save(plan_path)
    print(f"# plan+transfer in {time.perf_counter()-t0:.0f} s "
          f"(staged={learner._staged_mode()} "
          f"tiled={learner._needs_tiling()})", flush=True)
    state = learner.init_state()
    np.asarray(state.w0)  # force the init transfers to complete

    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=iters, verbose=True)
    np.asarray(state.w0)
    wall = time.perf_counter() - t0
    # iter 1 includes the staged-program compiles; report the steady tail
    steady = wall / iters if iters <= 2 else (
        sum(h["time_learn"] for h in hist[1:]) / (len(hist) - 1))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    from svbfm.utils.profiling import device_memory_stats
    dm = device_memory_stats() or {}
    hbm = dm.get("peak_bytes_in_use", 0) / 2**30
    print(f"# {method} {rows} rows K={K} fb={fb}: {steady:.2f} s/iter steady "
          f"({wall:.0f} s total incl. compile), "
          f"rmse {hist[0]['rmse']:.4f} -> {hist[-1]['rmse']:.4f}, "
          f"alpha={hist[-1]['alpha']:.3f}, "
          f"host RSS {rss:.1f} GiB, device peak {hbm:.1f} GiB", flush=True)


if __name__ == "__main__":
    main()
