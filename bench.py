"""Headline benchmark: batch VBFM training throughput on ML-1M-scale data.

Runs the flagship learner (batch variational Bayes FM, dim 1,1,20 — the
configuration of the reference paper's headline plots, `results/1M_20.png`)
on MovieLens-1M-shaped synthetic data (6040 users x 3952 items, 1M train
rows) and reports training throughput in examples/s, where one "example" is
one training row processed by one full VB sweep (all per-iteration test
metrics are computed on-device inside the same fused program).

``vs_baseline`` compares against the reference C++ implementation
(libFM-VBFM, `src/libfm/src/fm_learn_vb.h`) compiled -O3 and measured on
the host CPU of an earlier development machine with the same data:
REF_SECONDS_PER_ITER below.  Every row names the GPU it ran on; the script
refuses to run without one.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "examples/s", "vs_baseline": N}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# Reference libFM `-method vb -dim 1,1,20` per-iteration wall time on the
# host CPU of an earlier development machine (g++ -O3 build of the
# reference sources, 1M-row synthetic ML-1M data, measured over 9
# iteration intervals of a 10-iteration run: 25 s / 9;
# includes its per-iteration test-set evaluation, as does ours).
REF_SECONDS_PER_ITER = 2.78

NUM_USERS, NUM_ITEMS = 6040, 3952
NUM_TRAIN = 1_000_000
K = 20
WARM_ITERS = 10
TIMED_ITERS = 20


def _bench_vb(num_users, num_items, num_train, ref_sec_per_iter, tag,
              iters_warm, iters_timed):
    """One VB throughput row on ML-shaped synthetic data."""
    from svbfm.data.dataset import SparseDataset
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.synth import make_movielens_like, train_test_split
    from svbfm.learners.base import FMConfig
    from svbfm.learners.vb import VBLearner

    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_train + num_train // 10,
                              rank=8, noise=0.6, seed=42)
    tr, te = train_test_split(coo, 1.0 / 11.0, seed=43)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7)
    learner = VBLearner(cfg, SparseDataset.from_coo(tr, D),
                        SparseDataset.from_coo(te, D), meta,
                        write_files=False)
    state = learner.init_state()

    # warmup: compiles the fused program
    state, _ = learner.run(state, num_iter=iters_warm, verbose=False)
    np.asarray(state.mu_0)

    t0 = time.perf_counter()
    state, history = learner.run(state, num_iter=iters_timed, verbose=False)
    np.asarray(state.mu_0)
    wall = time.perf_counter() - t0
    sec_per_iter = wall / iters_timed

    examples_per_s = tr.num_rows / sec_per_iter
    ref_examples_per_s = tr.num_rows / ref_sec_per_iter
    return {
        "metric": f"vbfm_{tag}_k20_train_throughput",
        "value": round(examples_per_s, 1),
        "unit": "examples/s",
        "vs_baseline": round(examples_per_s / ref_examples_per_s, 3),
        "sec_per_iter": round(sec_per_iter, 4),
        "test_rmse_final": round(history[-1]["rmse"], 5),
        "free_energy_final": round(history[-1]["free_energy"], 1),
    }


def _bench_vb_100m_smoke():
    """Staged batch VB at full-Netflix 100M rows, 3 iterations
    (reduced-iter smoke).  Reuses /tmp-cached synthetic data when present
    (generation and plan build take minutes otherwise)."""
    import sys as _s
    import os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(
        _o.path.abspath(__file__)), "scripts"))
    from bench_vb_big import NUM_USERS as NU, make_split

    from svbfm.data.meta import DataMetaInfo
    from svbfm.learners.base import FMConfig
    from svbfm.learners.vb import VBLearner

    rows = 100_000_000
    train, test = make_split(rows)
    D = train.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NU])
    cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=4,
                   min_target=train.min_target, max_target=train.max_target,
                   num_groups=meta.num_attr_groups, seed=7)
    learner = VBLearner(cfg, train, test, meta, write_files=False)
    state = learner.init_state()
    np.asarray(state.mu_0)
    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=3, verbose=False)
    np.asarray(state.mu_0)
    wall = time.perf_counter() - t0
    steady = hist[-1]["time_learn"]  # last iter: compiles amortized
    # extrapolate the reference's measured ML-1M per-row cost linearly
    # (its sweep is O(K*nnz); 2.78 s / 1M rows)
    ref_sec = REF_SECONDS_PER_ITER * rows / 1_000_000
    return {
        "metric": "vbfm_netflix100m_k20_staged_sec_per_iter",
        "value": round(steady, 2),
        "unit": "s/iter",
        "vs_baseline": round(ref_sec / steady, 3),
        "wall_3iters_incl_compile": round(wall, 1),
        "test_rmse_last": round(hist[-1]["rmse"], 5),
        "staged": True,
    }


def _bench_mcmc_100m_smoke():
    """Staged Gibbs MCMC at full-Netflix 100M rows, 3 iterations (reduced
    smoke).  Shares the /tmp data + SweepPlan caches with the VB smoke."""
    import sys as _s
    import os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(
        _o.path.abspath(__file__)), "scripts"))
    from bench_vb_big import NUM_USERS as NU, make_split

    from svbfm.data.dataset import SweepPlan
    from svbfm.data.meta import DataMetaInfo
    from svbfm.learners.base import FMConfig
    from svbfm.learners.mcmc import MCMCLearner

    rows = 100_000_000
    train, test = make_split(rows)
    D = train.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NU])
    cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=4,
                   min_target=train.min_target, max_target=train.max_target,
                   num_groups=meta.num_attr_groups, seed=7)
    plan_path = f"/tmp/vb_big_plan_{rows}_11.npz"
    plan = SweepPlan.load(plan_path) if os.path.exists(plan_path) else None
    learner = MCMCLearner(cfg, train, test, meta, write_files=False,
                          plan=plan)
    if plan is None:
        learner.plan.save(plan_path)
    state = learner.init_state()
    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=3, verbose=False)
    np.asarray(state.w0)
    wall = time.perf_counter() - t0
    steady = hist[-1]["time_learn"]
    ref_sec = 2.78 * rows / 1_000_000  # O(K*nnz) extrapolation
    return {
        "metric": "gibbs_netflix100m_k20_staged_sec_per_iter",
        "value": round(steady, 2),
        "unit": "s/iter",
        "vs_baseline": round(ref_sec / steady, 3),
        "wall_3iters_incl_compile": round(wall, 1),
        "test_rmse_last": round(hist[-1]["rmse"], 5),
        "staged": True,
    }


def _device_fields() -> dict:
    """Device of every row; the benchmark refuses to run on anything but a
    GPU."""
    import subprocess

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{devices[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0].strip()
    return {"device": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices), "card": card}


def main() -> None:
    device = _device_fields()
    # headline row LAST (the driver parses the final JSON line)
    rows = []
    if os.environ.get("BENCH_FULL") == "1" or "--full" in sys.argv:
        # scale story rows (minutes each)
        try:
            rows.append(_bench_vb(71_567, 10_681, 10_000_000, 58.0, "ml10m",
                                  iters_warm=3, iters_timed=5))
        except Exception as exc:  # pragma: no cover
            rows.append({"metric": "vbfm_ml10m_k20_train_throughput",
                         "value": 0, "unit": "examples/s",
                         "vs_baseline": 0, "error": repr(exc)})
        try:
            rows.append(_bench_vb_100m_smoke())
        except Exception as exc:  # pragma: no cover
            rows.append({"metric": "vbfm_netflix100m_k20_staged_sec_per_iter",
                         "value": 0, "unit": "s/iter", "vs_baseline": 0,
                         "error": repr(exc)})
        try:
            rows.append(_bench_mcmc_100m_smoke())
        except Exception as exc:  # pragma: no cover
            rows.append({"metric": "gibbs_netflix100m_k20_staged_sec_per_iter",
                         "value": 0, "unit": "s/iter", "vs_baseline": 0,
                         "error": repr(exc)})
    rows.append(_bench_vb(NUM_USERS, NUM_ITEMS, NUM_TRAIN,
                          REF_SECONDS_PER_ITER, "ml1m",
                          iters_warm=WARM_ITERS, iters_timed=TIMED_ITERS))
    for r in rows:
        print(json.dumps({**r, **device}), flush=True)


if __name__ == "__main__":
    main()
