"""Per-stage timing of the staged huge-N VB iteration (W / factor-block /
tail programs) — identifies where the 100M-row sweep's time goes.

Waits for every stage's result before the next, so stage times are
separated at the cost of serializing the pipeline — the total reads
slightly above a production iteration.

Usage: python scripts/probe_vb_stage_times.py [rows] [K] [fb] [iters]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

import numpy as np


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    fb = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    iters = int(sys.argv[4]) if len(sys.argv) > 4 else 3

    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from bench_vb_big import NUM_USERS, make_split  # noqa: E402

    from svbfm.data.meta import DataMetaInfo
    from svbfm.learners.base import FMConfig
    from svbfm.learners.vb import VBLearner

    train, test = make_split(rows)
    D = train.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=fb,
                   min_target=train.min_target, max_target=train.max_target,
                   num_groups=meta.num_attr_groups, seed=7)
    # plan cache: the host-side build costs ~6 min at 100M
    from svbfm.data.dataset import SweepPlan
    plan_path = f"/tmp/vb_big_plan_{rows}_11.npz"
    plan = None
    if _os.path.exists(plan_path):
        plan = SweepPlan.load(plan_path)
        print("# plan loaded from cache", flush=True)
    learner = VBLearner(cfg, train, test, meta, write_files=False, plan=plan)
    if plan is None:
        learner.plan.save(plan_path)
    assert learner._staged_mode(), "staged path not engaged at this size"
    state = learner.init_state()
    np.asarray(state.mu_0)

    fnW, fnBs, fnC = learner._staged_programs()
    pipel = learner._stage_pipelined
    nowrap = _os.environ.get("SVBFM_VB_PIPE_WRAP") == "0"
    print(f"# pipelined={pipel} nowrap={nowrap}")
    _F, nb = learner._stage_layout()
    rest = (() if learner._rest_valid is None else (learner._rest_valid,))
    import jax.numpy as jnp

    def fetch(st):
        np.asarray(st.mu_0)

    caches = None
    for it in range(iters):
        tW = tB = tC = 0.0
        t0 = time.perf_counter()
        if fnW is not None:
            state = fnW(state, learner.train_row, learner.plan_data)
            fetch(state)
        tW = time.perf_counter() - t0
        nan_v = None
        tBs = []
        for b in range(nb):
            t1 = time.perf_counter()
            bj = jnp.asarray(b, jnp.int32)
            if not pipel:
                state, nv = fnBs[0](state, bj, learner.train_row,
                                    learner.plan_data)
            elif caches is None:
                state, nv, caches = fnBs[0](state, bj, learner.train_row,
                                            learner.plan_data)
            else:
                state, nv, caches = fnBs[1](state, bj, caches,
                                            learner.train_row,
                                            learner.plan_data)
            fetch(state)
            tBs.append(time.perf_counter() - t1)
            nan_v = nv if nan_v is None else nan_v + nv
        tB = sum(tBs)
        if nowrap:
            caches = None  # free the [F, N] caches during W/C
        t1 = time.perf_counter()
        if nan_v is None:
            nan_v = jnp.zeros((), jnp.int32)
        state, metrics = fnC(state, nan_v, learner.train_row,
                             learner.plan_data, learner.test_row, *rest)
        fetch(state)
        tC = time.perf_counter() - t1
        tot = time.perf_counter() - t0
        print(f"iter {it}: W={tW:.1f}s  B={tB:.1f}s "
              f"({'/'.join(f'{x:.1f}' for x in tBs)})  C={tC:.1f}s  "
              f"total={tot:.1f}s", flush=True)


if __name__ == "__main__":
    main()
