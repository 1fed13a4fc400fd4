"""Serving (batch scoring) throughput benchmark.

Workload: ML-1M-shaped FM (D = 6040 + 3952, 2-nnz one-hot rows), K=20 —
the same model shape as the headline training bench.  Reports two numbers:

- end-to-end rows/s: numpy rows on the host -> predictions on the host,
  through BatchScorer's bounded in-flight pipeline, including the PCIe
  transfers both ways.
- device-resident rows/s: inputs already in device memory (the
  re-ranking / feature-store-on-device scenario), chained calls with one
  value fetch at the end.

Baseline: the reference's own fm_model::predict loop on the host CPU,
measured by scripts/ref_predict_bench.cpp (g++ -O3, reference headers driven
directly).  Run that first to print the comparison line.

Usage: python scripts/bench_serve.py [rows=10000000] [K=20] [reps=10]
"""

import os as _os
import sys as _sys

# "python scripts/x.py" puts scripts/ (not the repo root) on
# sys.path, so bootstrap the package path explicitly
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import sys
import time

import numpy as np

NU, NI = 6040, 3952


def main():
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from svbfm.parallel.mesh import DATA_AXIS, make_mesh
    from svbfm.serve import BatchScorer

    D = NU + NI
    rng = np.random.default_rng(0)
    w0 = 3.5
    w = 0.1 * rng.standard_normal(D).astype(np.float32)
    v = 0.1 * rng.standard_normal((K, D)).astype(np.float32)

    n = np.arange(rows, dtype=np.int64)
    ids = np.stack([(n % NU).astype(np.int32),
                    (NU + (n * 7) % NI).astype(np.int32)], axis=1)
    vals = np.ones((rows, 2), np.float32)

    scorer = BatchScorer(w0, w, v, batch_rows=1 << 20,
                         min_target=1.0, max_target=5.0)

    # --- end-to-end (host -> device -> host) ----------------------------
    warm = scorer.score_rows(ids[: 1 << 20], vals[: 1 << 20])
    t0 = time.perf_counter()
    out = scorer.score_rows(ids, vals)
    wall = time.perf_counter() - t0
    e2e = rows / wall
    print(f"serve end-to-end: {rows} rows in {wall:.3f} s = {e2e/1e6:.2f}M "
          f"rows/s ({2*e2e/1e6:.0f}M idx/s)  mean={out.mean():.4f}")

    # --- device-resident (in-jit scan over distinct batches) ------------
    # The timing needs BOTH (a) per-iteration inputs that differ — XLA
    # hoists loop-invariant gathers out of a scan — and (b) a single value
    # fetch at the end.  A lax.scan cycling through 8
    # distinct pre-loaded batches satisfies both.
    mesh = scorer.mesh
    shd = NamedSharding(mesh, P(DATA_AXIS))
    nb = min(rows, 1 << 20)
    nbatch = min(8, rows // nb) or 1
    ids_d = jax.device_put(ids[: nbatch * nb].reshape(nbatch, nb, 2), shd_b(mesh))
    vals_d = jax.device_put(vals[: nbatch * nb].reshape(nbatch, nb, 2), shd_b(mesh))
    fn = scorer._scorer(2)

    iters = max(reps, 200)

    @jax.jit
    def scan_serve(carry0):
        def body(carry, it):
            b = it % nbatch
            bi = jax.lax.dynamic_index_in_dim(ids_d, b, keepdims=False)
            bv = jax.lax.dynamic_index_in_dim(vals_d, b, keepdims=False)
            s = fn(scorer.w0, scorer.w, scorer.v, bi,
                   bv + carry * 0)  # serialize on the carry
            return s.sum() * 1e-30, s.sum()
        carry, sums = jax.lax.scan(body, carry0,
                                   jnp.arange(iters, dtype=jnp.int32))
        return sums

    s = scan_serve(jnp.float32(0)); np.asarray(s[:1])
    t0 = time.perf_counter()
    s = scan_serve(jnp.float32(1e-12))
    np.asarray(s[:1])
    wall = time.perf_counter() - t0
    dev = nb * iters / wall
    print(f"serve device-resident: {iters}x{nb} rows in {wall:.3f} s = "
          f"{dev/1e6:.2f}M rows/s ({2*dev/1e6:.0f}M idx/s)")
    print("# baseline: scripts/ref_predict_bench.cpp prints the reference "
          "fm_model::predict rows/s on the host CPU")


def shd_b(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from svbfm.parallel.mesh import DATA_AXIS
    return NamedSharding(mesh, P(None, DATA_AXIS))


if __name__ == "__main__":
    main()
