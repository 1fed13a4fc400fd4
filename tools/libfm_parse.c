/* Fast libFM text-format parser (ctypes fast path for
 * svbfm/data/libfm_text.py).
 *
 * Behavior mirrors the reference two-pass loader
 * (/root/reference/src/libfm/src/Data.h:184-278): pass 1 counts rows, nnz
 * and the max feature id; pass 2 fills flat arrays.  Line rules: leading
 * spaces/tabs skipped; empty lines and lines starting with '#' skipped; a
 * line is "<target> <id>:<value> ..." with an optional trailing comment.
 *
 * Exported C ABI:
 *   int libfm_count(const char* path, long long* num_rows, long long* nnz,
 *                   long long* max_feature);
 *   int libfm_fill(const char* path, int* row, int* col, float* val,
 *                  float* target);
 * Both return 0 on success, nonzero on I/O or parse failure.
 */

#include <ctype.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define LINE_BUF (1 << 20)

static const char *skip_ws(const char *p) {
    while (*p == ' ' || *p == '\t') p++;
    return p;
}

/* parse a float with strtod; returns end pointer or NULL */
static const char *parse_f(const char *p, double *out) {
    char *end;
    double v = strtod(p, &end);
    if (end == p) return NULL;
    *out = v;
    return end;
}

static const char *parse_u(const char *p, long long *out) {
    char *end;
    long long v = strtoll(p, &end, 10);
    if (end == p || v < 0) return NULL;
    *out = v;
    return end;
}

typedef int (*emit_fn)(void *ctx, long long row, long long col, double val);

static int scan_file(const char *path, long long *num_rows, long long *nnz,
                     long long *max_feature, int *rowbuf, int *colbuf,
                     float *valbuf, float *targetbuf) {
    FILE *f = fopen(path, "r");
    if (!f) return 1;
    char *line = (char *)malloc(LINE_BUF);
    if (!line) { fclose(f); return 2; }
    long long rows = 0, vals = 0, maxf = -1;
    while (fgets(line, LINE_BUF, f)) {
        const char *p = skip_ws(line);
        if (*p == 0 || *p == '\n' || *p == '\r' || *p == '#') continue;
        double target;
        const char *q = parse_f(p, &target);
        if (!q) { free(line); fclose(f); return 3; }
        if (targetbuf) targetbuf[rows] = (float)target;
        p = q;
        for (;;) {
            p = skip_ws(p);
            if (*p == 0 || *p == '\n' || *p == '\r' || *p == '#') break;
            long long fid;
            double x;
            q = parse_u(p, &fid);
            if (!q || *q != ':') { free(line); fclose(f); return 4; }
            q = parse_f(q + 1, &x);
            if (!q) { free(line); fclose(f); return 5; }
            if (rowbuf) {
                rowbuf[vals] = (int)rows;
                colbuf[vals] = (int)fid;
                valbuf[vals] = (float)x;
            }
            if (fid > maxf) maxf = fid;
            vals++;
            p = q;
        }
        rows++;
    }
    free(line);
    fclose(f);
    if (num_rows) *num_rows = rows;
    if (nnz) *nnz = vals;
    if (max_feature) *max_feature = maxf;
    return 0;
}

int libfm_count(const char *path, long long *num_rows, long long *nnz,
                long long *max_feature) {
    return scan_file(path, num_rows, nnz, max_feature, NULL, NULL, NULL, NULL);
}

int libfm_fill(const char *path, int *row, int *col, float *val,
               float *target) {
    return scan_file(path, NULL, NULL, NULL, row, col, val, target);
}

/* Row-offset index scan over a reference-format binary sparse matrix
 * (header: see /root/reference/src/util/fmatrix.h:46-52; per row a uint32
 * size then size * {uint32 id, float32 value}).  Fills row_offsets
 * (num_rows+1 absolute byte offsets, the first one = header_size) and
 * row_sizes.  Streams with a fixed buffer so files far larger than RAM
 * index in one sequential pass.  Returns 0 on success. */
int sparse_index_scan(const char *path, long long header_size,
                      long long num_rows, long long *row_offsets,
                      long long *row_sizes) {
    FILE *f = fopen(path, "rb");
    if (!f) return 1;
    if (fseek(f, (long)header_size, SEEK_SET) != 0) { fclose(f); return 2; }
    /* skip record payloads via buffered reads (glibc fseek discards the
     * stdio buffer, costing 2 syscalls per row; sequential fread streams) */
    static char skip[1 << 20];
    long long off = header_size;
    for (long long r = 0; r < num_rows; r++) {
        unsigned int k;
        if (fread(&k, 4, 1, f) != 1) { fclose(f); return 3; }
        row_offsets[r] = off;
        row_sizes[r] = (long long)k;
        off += 4 + 8LL * (long long)k;
        long long skip_bytes = 8LL * (long long)k;
        while (skip_bytes > 0) {
            size_t want = skip_bytes > (long long)sizeof(skip)
                              ? sizeof(skip) : (size_t)skip_bytes;
            if (fread(skip, 1, want, f) != want) { fclose(f); return 4; }
            skip_bytes -= (long long)want;
        }
    }
    row_offsets[num_rows] = off;
    fclose(f);
    return 0;
}
