// Reference serving-throughput baseline for scripts/bench_serve.py.
//
// Measures the reference implementation's own predict path
// (fm_model::predict, /root/reference/src/fm_core/fm_model.h:107-130) by
// INCLUDING the read-only reference headers — no reference code lives in
// this repo; this harness only drives it, exactly like the head-to-head
// training runs in PARITY_RUNS.md drive the reference binary.
//
// Build (requires the reference mount):
//   g++ -O3 -o /tmp/ref_predict_bench scripts/ref_predict_bench.cpp \
//       -I /root/reference/src
// Run:
//   /tmp/ref_predict_bench [rows=10000000] [K=20]
//
// Emits: ref_predict rows/s over ML-1M-shaped 2-nnz rows (user+item
// one-hots), the same workload bench_serve.py scores on the GPU.

#include <cstdio>
#include <cstdlib>
#include <chrono>

#include "fm_core/fm_model.h"

int main(int argc, char** argv) {
    long rows = argc > 1 ? atol(argv[1]) : 10000000L;
    int K = argc > 2 ? atoi(argv[2]) : 20;
    const unsigned NU = 6040, NI = 3952;

    fm_model fm;
    fm.num_attribute = NU + NI;
    fm.num_factor = K;
    fm.init_stdev = 0.1;
    fm.init();

    sparse_entry<FM_FLOAT> ent[2];
    sparse_row<FM_FLOAT> x;
    x.size = 2;
    x.data = ent;
    ent[0].value = 1.0f;
    ent[1].value = 1.0f;

    // warm pass so page faults / cache state don't bill the timed loop
    double sink = 0;
    for (long n = 0; n < rows / 10; n++) {
        ent[0].id = (unsigned)(n % NU);
        ent[1].id = NU + (unsigned)((n * 7) % NI);
        sink += fm.predict(x);
    }

    auto t0 = std::chrono::steady_clock::now();
    for (long n = 0; n < rows; n++) {
        ent[0].id = (unsigned)(n % NU);
        ent[1].id = NU + (unsigned)((n * 7) % NI);
        sink += fm.predict(x);
    }
    double wall = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
    printf("ref_predict rows=%ld K=%d wall=%.3f s rows_per_s=%.0f (sink=%g)\n",
           rows, K, wall, rows / wall, sink);
    return 0;
}
