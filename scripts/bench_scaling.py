"""Data-parallel scaling harness: per-device examples/s over a device mesh.

Runs the batch-VB training step over 1/2/4/.. device data-parallel meshes
and reports examples/s per device count — the artifact a pod owner runs
unmodified on real multi-chip hardware (SURVEY §6: "linear examples/s
scaling from 1 chip to >=2 hosts", a dimension the reference cannot
measure at all — it is a single process, src/libfm/libfm.cpp).

Devices come from jax.devices().  To check the sharded program and the
harness without GPUs, run it on a virtual CPU mesh (the times are then
the CPU backend's, not a device's):

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/bench_scaling.py

Usage:
  python scripts/bench_scaling.py [rows] [K] [iters] [device_counts]
  device_counts: comma list, default "1,2,4,8" (clamped to available)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import sys
import time

import numpy as np


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    counts = ([int(c) for c in sys.argv[4].split(",")]
              if len(sys.argv) > 4 else [1, 2, 4, 8])

    import jax
    avail = len(jax.devices())
    counts = [c for c in counts if c <= avail]

    from svbfm.data.dataset import SparseDataset
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.synth import make_movielens_like, train_test_split
    from svbfm.learners.base import FMConfig
    from svbfm.learners.vb import VBLearner
    from svbfm.parallel.mesh import make_mesh

    n_users = max(rows // 20, 16)
    n_items = max(rows // 40, 12)
    coo = make_movielens_like(num_users=n_users, num_items=n_items,
                              num_ratings=rows, rank=4, noise=0.4, seed=3)
    tr, te = train_test_split(coo, 0.1, seed=4)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, n_users])
    cfg = FMConfig(num_attributes=D, num_factor=K,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7)
    tr_ds = SparseDataset.from_coo(tr, D)
    te_ds = SparseDataset.from_coo(te, D)

    results = []
    base = None
    for n in counts:
        learner = VBLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(n),
                            write_files=False)
        state = learner.init_state()
        # warmup (compile) outside the timed window
        state, _ = learner.run(state, num_iter=1, verbose=False, chunk=1)
        t0 = time.perf_counter()
        state, hist = learner.run(state, num_iter=iters, verbose=False,
                                  chunk=1)
        np.asarray(state.mu_0)  # force completion through any async tail
        wall = time.perf_counter() - t0
        eps = rows * iters / wall
        if base is None:
            base = eps
        results.append(dict(devices=n, sec_per_iter=wall / iters,
                            examples_per_sec=eps, speedup=eps / base,
                            efficiency=eps / base / n,
                            rmse=float(hist[-1]["rmse"])))
        r = results[-1]
        print(f"# devices={n}: {r['sec_per_iter']:.3f} s/iter, "
              f"{eps:,.0f} ex/s, speedup {r['speedup']:.2f}x "
              f"(eff {r['efficiency']:.0%}), rmse {r['rmse']:.4f}",
              flush=True)
    # trajectories must be device-count invariant (same math, psum'd stats)
    print(json.dumps({"metric": "vb_scaling", "rows": rows, "K": K,
                      "platform": jax.devices()[0].platform,
                      "results": results}))


if __name__ == "__main__":
    main()
