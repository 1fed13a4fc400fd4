"""Relational block-structure benchmark (VLDB'13 scenario).

Netflix-shaped ratings where BOTH sides carry wide attribute vectors via
relations: user rows join a [num_users, user_attrs+1]-wide relation and item
rows a [num_items, item_attrs+1]-wide one.  The materialized design matrix
has nnz = N * (user_attrs + item_attrs + 2); the native BS learner
(learners.mcmc_bs) keeps memory and compute at
O(N + nnz(rel_u) + nnz(rel_i)) — the reference's entire point
(fm_learn_mcmc.h:459-620).

Usage: python scripts/bench_bs.py [rows] [K] [user_attrs] [item_attrs]
                                  [method=als|mcmc] [--materialized]
"""

import os as _os
import sys as _sys

# "python scripts/x.py" puts scripts/ (not the repo root) on
# sys.path, so bootstrap the package path explicitly
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import sys
import time

import numpy as np


def make_relation(num_rows, num_onehot, num_attrs, seed):
    """One-hot id + num_attrs shared dense-ish attributes per row."""
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.relation import RelationData

    rng = np.random.default_rng(seed)
    D = num_onehot + 2 * max(num_attrs, 1)
    rows = [np.arange(num_rows, dtype=np.int32)]
    cols = [np.arange(num_rows, dtype=np.int32) % num_onehot]
    vals = [np.ones(num_rows, np.float32)]
    for a in range(num_attrs):
        rows.append(np.arange(num_rows, dtype=np.int32))
        # each attribute slot has 2 possible columns -> conflict-free pairs
        cols.append(num_onehot + 2 * a + rng.integers(0, 2, num_rows).astype(np.int32))
        vals.append(rng.uniform(0.2, 1.0, num_rows).astype(np.float32))
    order = np.argsort(np.concatenate(rows), kind="stable")
    return RelationData(
        row=np.concatenate(rows)[order], col=np.concatenate(cols)[order],
        val=np.concatenate(vals)[order], num_rows=num_rows, num_features=D,
        meta=DataMetaInfo(D))


def make_bs_problem(rows, ua, ia):
    """The shared benchmark instance: Netflix/ML-shaped ratings with wide
    per-user/per-item attribute relations.  Used by this script AND by
    make_bs_ref_data.py (which feeds the identical data to the reference
    binary), so keep it deterministic."""
    from svbfm.data.libfm_text import COOData

    nu, ni = (71567, 10681) if rows <= 20_000_000 else (480189, 17770)
    rng = np.random.default_rng(5)
    users = rng.integers(0, nu, rows)
    items = rng.integers(0, ni, rows)
    bu = 0.4 * rng.standard_normal(nu)
    bi = 0.4 * rng.standard_normal(ni)
    y = (3.6 + bu[users] + bi[items]
         + 0.5 * rng.standard_normal(rows)).astype(np.float32)
    # main block: EMPTY design (all features live in the relations),
    # matching the reference's pure-BS runs
    main = COOData(row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
                   val=np.zeros(0, np.float32), target=y,
                   num_rows=rows, num_features=0)
    rel_u = make_relation(nu, nu, ua, seed=7)
    rel_i = make_relation(ni, ni, ia, seed=8)
    return main, rel_u, rel_i, users, items, y


def main():
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    ua = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    ia = int(sys.argv[4]) if len(sys.argv) > 4 else 20
    method = sys.argv[5] if len(sys.argv) > 5 else "als"
    materialized = "--materialized" in sys.argv

    from svbfm.data.dataset import SparseDataset
    from svbfm.data.libfm_text import COOData
    from svbfm.data.relation import build_joined_meta, join_relations
    from svbfm.learners.base import FMConfig

    main, rel_u, rel_i, users, items, y = make_bs_problem(rows, ua, ia)
    from svbfm.data.meta import DataMetaInfo
    meta = build_joined_meta(DataMetaInfo(0), [rel_u, rel_i])
    D = meta.num_attributes
    expanded_nnz = rows * (2 + ua + ia)
    print(f"# rows={rows} D={D} expanded_nnz={expanded_nnz/1e6:.0f}M "
          f"(factored: {rel_u.row.size + rel_i.row.size + 2*rows} stored)")
    cfg = FMConfig(num_attributes=D, num_factor=K, min_target=float(y.min()),
                   max_target=float(y.max()), num_groups=meta.num_attr_groups,
                   seed=7, regw=0.05, regv=0.05)
    te_n = min(rows // 10, 1_000_000)
    te = COOData(row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
                 val=np.zeros(0, np.float32), target=y[:te_n],
                 num_rows=te_n, num_features=0)

    t0 = time.perf_counter()
    if materialized:
        joined = join_relations(main, [rel_u, rel_i], [users, items], 0)
        joined_te = join_relations(te, [rel_u, rel_i],
                                   [users[:te_n], items[:te_n]], 0)
        from svbfm.learners.mcmc import ALSLearner, MCMCLearner
        cls = ALSLearner if method == "als" else MCMCLearner
        learner = cls(cfg, SparseDataset.from_coo(joined, D),
                      SparseDataset.from_coo(joined_te, D), meta,
                      write_files=False)
    else:
        from svbfm.learners.mcmc_bs import ALSBSLearner, MCMCBSLearner
        cls = ALSBSLearner if method == "als" else MCMCBSLearner
        learner = cls(cfg, SparseDataset.from_coo(main, D),
                      SparseDataset.from_coo(te, D), [rel_u, rel_i],
                      [users, items], [users[:te_n], items[:te_n]],
                      meta, 0, write_files=False)
    print(f"# build: {time.perf_counter()-t0:.0f} s")
    state = learner.init_state()
    # native BS runs chunk=1 (MCMCBSLearner._default_chunk); the
    # materialized-join learners keep a fixed fused chunk of 3
    chunk = 1 if not materialized else 3
    t0 = time.perf_counter()
    state, h = learner.run(state, num_iter=6, verbose=False, chunk=chunk)
    np.asarray(state.w0)  # wait for the warm-up before timing
    print(f"# warmup(compile+6 iters): {time.perf_counter()-t0:.0f} s")
    iters = 20
    t0 = time.perf_counter()
    state, h = learner.run(state, num_iter=iters, verbose=False, chunk=chunk)
    np.asarray(state.w0)
    wall = time.perf_counter() - t0
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"bs {method} sec/iter: {wall/iters:.2f}  rmse={h[-1]['rmse']:.4f}  "
          f"host_rss_gib={rss:.1f}  mode={'materialized' if materialized else 'native'}")


if __name__ == "__main__":
    main()
