"""Gibbs-MCMC / ALS iteration timing on synthetic ML-shaped data.

Usage: python scripts/bench_gibbs.py [rows] [K] [factor_block] [method]

Measures seconds per Gibbs iteration (full draw_all sweep + on-device
posterior-mean eval, matching the reference fm_learn_mcmc_simultaneous
loop) with the learner's fused multi-iteration program, over chained
fused calls that end in a value fetch.
"""

import os as _os
import sys as _sys

# "python scripts/x.py" puts scripts/ (not the repo root) on
# sys.path, so bootstrap the package path explicitly
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import sys
import time

import numpy as np


def main():
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    fb = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    method = sys.argv[4] if len(sys.argv) > 4 else "mcmc"

    from svbfm.data.dataset import SparseDataset
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.synth import make_movielens_like, train_test_split
    from svbfm.learners.base import FMConfig
    from svbfm.learners.mcmc import ALSLearner, MCMCLearner

    if rows > 2_000_000:  # ML-10M shape
        nu, ni = 71567, 10681
    else:  # ML-1M shape
        nu, ni = 6040, 3952
    coo = make_movielens_like(num_users=nu, num_items=ni,
                              num_ratings=rows + rows // 10,
                              rank=8, noise=0.6, seed=42)
    tr, te = train_test_split(coo, 1.0 / 11.0, seed=43)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, nu])
    cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=fb,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7)
    cls = ALSLearner if method == "als" else MCMCLearner
    learner = cls(cfg, SparseDataset.from_coo(tr, D),
                  SparseDataset.from_coo(te, D), meta,
                  write_files=False)
    print(f"# rows={tr.num_rows} K={K} factor_block={learner.cfg.factor_block}")
    state = learner.init_state()
    t0 = time.perf_counter()
    state, h = learner.run(state, num_iter=10, verbose=False, chunk=5)
    np.asarray(state.w0)  # wait for the warm-up before timing
    print(f"# warmup(compile+10 iters): {time.perf_counter()-t0:.1f} s")
    iters = 20
    t0 = time.perf_counter()
    state, h = learner.run(state, num_iter=iters, verbose=False, chunk=5)
    np.asarray(state.w0)
    wall = time.perf_counter() - t0
    print(f"gibbs sec/iter: {wall/iters:.3f}  rmse={h[-1]['rmse']:.4f} "
          f"alpha={h[-1]['alpha']:.3f}")


if __name__ == "__main__":
    main()
