"""Out-of-core batch VBFM: HBM-windowed sweeps with resident caches.

The reference's ``-cache_size`` path (``LargeSparseMatrixHD``,
``src/util/fmatrix.h:110-233``, wired for the batch learners in
``Data.h:112-171``) lets batch training run on data that exceeds memory by
re-windowing the binary file every sweep.  The equivalent here windows
**device memory**, not host RAM: the residual caches e/t ([N]) and the
per-factor-block q/tq/tz caches (flat 1-D ``[F*N]``) stay device-resident,
while the row data (``ids/vals [Wlen, P]``) and the column-bucket plan
arrays stream host->device one window at a time.  Host RAM (or disk, via
:class:`svbfm.data.stream.BinaryChunkReader`) is the backing store.

Sweep semantics are the staged exact-ordering batch VB of
:mod:`svbfm.learners.vb` at ``factor_block >= 1`` (w0 -> standalone w
sweep -> per-factor-block v sweeps, Gauss-Seidel over conflict-free bins,
Jacobi across the F factors of a block with exact cache patches):

  per factor block b:
    build pass   (per window): q/tq/tz[f*N+lo : +Wlen] from mu/sigma
    per bin:
      stats pass (per window): gather e/q/tq at the bin's GLOBAL column
                 buckets, accumulate per-column vm/vs across windows
      draw       (one small program): closed-form updates + delta table
      patch pass (per window): per-position gathers from the [5F, D]
                 delta table patch the window's e/t/q/tq/tz slices

The column buckets use a GLOBAL structure (every window stores the same
column list per bucket, sized by the max per-window degree), so per-window
partial statistics add positionally.  Columns absent from a window carry
x = 0 rows that contribute nothing.

Numerics match the resident :class:`~svbfm.learners.vb.VBLearner` at
the same ``factor_block`` up to f32 reassociation of the per-column sums
(the window axis splits each column's occurrence-list reduction) —
pinned by ``tests/test_vb_windowed.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from svbfm.data.dataset import SparseDataset, _ceil_to
from svbfm.data.libfm_text import COOData
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    FMConfig,
    TASK_REGRESSION,
    TrajectoryFile,
    keep_finite,
    ref_cdf_gaussian,
    truncnorm_mean_negative,
    truncnorm_mean_positive,
)
from svbfm.learners.vb import VBState, init_vb_params
from svbfm.ops.forward import fm_scores, fm_t_terms
from svbfm.ops.segment import take_rows


class WindowBackpressure:
    """Bounds how far the host runs ahead of the device in a window loop.

    Dispatch is asynchronous, so without a wait the host would upload every
    window of a pass before the device had run the first, and the whole
    training set would sit in device memory at once — what ``-cache_size``
    exists to avoid.  Waiting for the readiness of one window's output
    before uploading the next keeps at most ``lag + 1`` windows in flight.
    ``lag=0`` waits for each window's own output, which the patch and build
    chains need because they donate it to the next call; ``lag=1`` waits
    for window w-1's output once the (non-donating) stats accumulation has
    consumed it, so one upload overlaps one window's compute."""

    def __init__(self, lag: int = 0):
        from collections import deque
        self._lag = lag
        self._q = deque()

    def __call__(self, out):
        self._q.append(out)
        if len(self._q) > self._lag:
            jax.block_until_ready(self._q.popleft())
        return out


# ---------------------------------------------------------------------------
# Global windowed plan
# ---------------------------------------------------------------------------

class WindowBucket:
    """One degree bucket of one bin, with a GLOBAL column list shared by
    all windows; per-window [C, L] entry views are filled separately."""

    def __init__(self, cols, group, sx2, L):
        self.cols = cols            # int32 [C] global ids, ascending
        self.group = group          # int32 [C]
        self.sx2 = sx2              # f32 [C] GLOBAL sum of x^2
        self.L = int(L)
        # per-window int32/f32 [C, L] arrays, filled by the builder
        self.rows: list = []
        self.x: list = []


class WindowedPlan:
    """Host-side windowed sweep plan: per-bin global buckets plus the
    per-window row-layout arrays."""

    def __init__(self, num_windows, wlen, bins, ids, vals, unobserved,
                 color, conflict_free, n_rows):
        self.num_windows = num_windows
        self.wlen = wlen            # rows per window (last window padded)
        self.bins = bins            # list[bin] -> list[WindowBucket]
        self.ids = ids              # list[w] -> int32 [Wlen, P]
        self.vals = vals            # list[w] -> f32 [Wlen, P]
        self.unobserved = unobserved
        self.color = color
        self.conflict_free = conflict_free
        self.n_rows = n_rows        # true row count


def _field_ranges(coo: COOData, D: int):
    """Per-position (lo, hi) column ranges when the window has uniform-k
    one-hot field structure, else None (mirrors
    ``dataset.detect_field_bins`` but returns the raw ranges so windows
    can be MERGED before deriving a global coloring)."""
    if coo.nnz == 0 or coo.nnz % coo.num_rows != 0:
        return None
    k = coo.nnz // coo.num_rows
    row_view = coo.row.reshape(coo.num_rows, k)
    if (row_view == row_view[:, :1]).all() and \
            (row_view[:, 0] == np.arange(coo.num_rows,
                                         dtype=row_view.dtype)).all():
        cols = coo.col.reshape(coo.num_rows, k)
        if k > 1 and not (np.diff(cols, axis=1) > 0).all():
            cols = np.sort(cols, axis=1)
    else:
        nnz_per_row = np.bincount(coo.row, minlength=coo.num_rows)
        if (nnz_per_row != k).any():
            return None
        order = np.lexsort((coo.col, coo.row))
        cols = coo.col[order].reshape(coo.num_rows, k)
    return cols.min(axis=0), cols.max(axis=0)


def build_windowed_plan(window_coo: Callable[[int], COOData],
                        num_windows: int, wlen: int, D: int,
                        color: Optional[np.ndarray], groups: np.ndarray,
                        n_rows: int, lane_pad: int = 8) -> WindowedPlan:
    """Two passes over the windows: (A) global degrees/sx2/observed, the
    merged field coloring, and the row-layout arrays; (B) fill each global
    bucket's per-window [C, L] entry views."""
    max_deg = np.zeros(D, dtype=np.int64)
    sx2 = np.zeros(D, dtype=np.float64)
    observed = np.zeros(D, dtype=bool)
    ids_list, vals_list = [], []
    P = 1
    coos = []
    ranges = []
    for w in range(num_windows):
        coo = window_coo(w)
        coos.append(coo)
        deg = np.bincount(coo.col, minlength=D)
        np.maximum(max_deg, deg, out=max_deg)
        np.add.at(sx2, coo.col, coo.val.astype(np.float64) ** 2)
        observed |= deg > 0
        P = max(P, int(coo.row_nnz().max()) if coo.num_rows else 1)
        if ranges is not None:
            r = _field_ranges(coo, D)
            ranges = None if r is None or (
                ranges and len(r[0]) != len(ranges[0][0])) \
                else ranges + [r]

    conflict_free = True
    if color is None:
        if ranges:
            lo = np.min([r[0] for r in ranges], axis=0)
            hi = np.max([r[1] for r in ranges], axis=0)
            if (hi[:-1] < lo[1:]).all():
                color = np.zeros(D, np.int32)
                bounds_c = np.concatenate([lo[1:], [D]])
                start = 0
                for p in range(len(lo)):
                    color[start: bounds_c[p]] = p
                    start = bounds_c[p]
        if color is None:
            print("# WARNING: windowed VB found no one-hot field "
                  "structure; using a single Jacobi bin (approximate "
                  "simultaneous updates, not exact Gauss-Seidel).",
                  flush=True)
            color = np.zeros(D, np.int32)
            conflict_free = False
    num_bins = int(color.max()) + 1 if D else 1
    for coo in coos:
        ds = SparseDataset.from_coo(coo, D)
        ids = np.zeros((wlen, P), np.int32)
        vals = np.zeros((wlen, P), np.float32)
        ids[: ds.ids.shape[0], : ds.ids.shape[1]] = ds.ids
        vals[: ds.vals.shape[0], : ds.vals.shape[1]] = ds.vals
        ids_list.append(ids)
        vals_list.append(vals)

    bins = []
    for b in range(num_bins):
        cols_b = np.where((color == b) & observed)[0]
        buckets = []
        if len(cols_b):
            deg_b = max_deg[cols_b]
            L = lane_pad
            remaining = np.ones(len(cols_b), dtype=bool)
            while remaining.any():
                sel = remaining & (deg_b <= L)
                if sel.any():
                    cb = cols_b[sel].astype(np.int32)
                    buckets.append(WindowBucket(
                        cols=cb, group=groups[cb].astype(np.int32),
                        sx2=sx2[cb].astype(np.float32), L=L))
                    remaining &= ~sel
                L *= 2
        bins.append(buckets)

    # pass B: per-window entry views (pad row id wlen-1 with x=0 is inert)
    slot = np.full(D, -1, np.int64)
    bucket_of = np.full(D, -1, np.int64)
    flat_buckets = []
    for b, buckets in enumerate(bins):
        for bu in buckets:
            bucket_of[bu.cols] = len(flat_buckets)
            slot[bu.cols] = np.arange(len(bu.cols))
            flat_buckets.append(bu)
    for w, coo in enumerate(coos):
        per = [np.full((len(bu.cols), bu.L), wlen - 1, np.int32)
               for bu in flat_buckets]
        perx = [np.zeros((len(bu.cols), bu.L), np.float32)
                for bu in flat_buckets]
        order = np.argsort(coo.col, kind="stable")  # file order per column
        c_s, r_s, v_s = coo.col[order], coo.row[order], coo.val[order]
        # position within column (this window)
        if len(c_s):
            new_c = np.concatenate([[True], c_s[1:] != c_s[:-1]])
            starts = np.where(new_c)[0]
            pos = np.arange(len(c_s), dtype=np.int64) \
                - starts[np.cumsum(new_c) - 1]
        else:
            pos = np.zeros(0, np.int64)
        bidx = bucket_of[c_s]
        sidx = slot[c_s]
        for j in range(len(flat_buckets)):
            m = bidx == j
            if m.any():
                per[j][sidx[m], pos[m]] = r_s[m]
                perx[j][sidx[m], pos[m]] = v_s[m]
        for j, bu in enumerate(flat_buckets):
            bu.rows.append(per[j])
            bu.x.append(perx[j])

    return WindowedPlan(num_windows=num_windows, wlen=wlen, bins=bins,
                        ids=ids_list, vals=vals_list, unobserved=~observed,
                        color=color, conflict_free=conflict_free,
                        n_rows=n_rows)


# ---------------------------------------------------------------------------
# Learner
# ---------------------------------------------------------------------------

class WindowedVBLearner:
    """Batch VBFM with HBM-windowed row/plan data (``-cache_size``).

    ``train_src`` is a host :class:`SparseDataset` or a
    :class:`~svbfm.data.stream.BinaryChunkReader`; ``num_windows``
    splits it into equal row windows (derived from ``cache_bytes`` when
    given: the per-window device arrays are sized to fit).  Single-device
    only (out-of-core is a one-chip capability; multi-chip problems shard
    the data instead)."""

    method = "vb"

    def __init__(self, cfg: FMConfig, train_src, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None,
                 num_windows: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True, plan=None):
        import dataclasses

        from svbfm.data.stream import BinaryChunkReader
        from svbfm.parallel.mesh import make_mesh

        self.mesh = make_mesh(1)
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.meta = meta
        D = cfg.num_attributes

        if isinstance(train_src, BinaryChunkReader):
            n_rows = train_src.num_rows
            nnz_bytes = 8 * int(train_src.row_sizes.sum())
            targets = train_src.targets
            assert targets is not None, "windowed VB needs the .y targets"

            def src_window(lo, hi):
                return train_src.read_rows(lo, hi)
        else:
            ds: SparseDataset = train_src
            n_rows = ds.num_rows
            nnz_bytes = 8 * int(ds.row_nnz[: n_rows].sum())
            targets = ds.target[: n_rows]

            def src_window(lo, hi):
                coo = ds.to_coo()
                m = (coo.row >= lo) & (coo.row < hi)
                return COOData(row=(coo.row[m] - lo).astype(np.int32),
                               col=coo.col[m], val=coo.val[m],
                               target=coo.target[lo:hi],
                               num_rows=hi - lo, num_features=D)

        if num_windows is None:
            if cache_bytes is None:
                cache_bytes = 2 * 1024**3
            # window arrays ~ 2x the window's nnz bytes (rows + buckets)
            num_windows = max(1, -(-2 * nnz_bytes // cache_bytes))
        wlen = _ceil_to(-(-n_rows // max(1, int(num_windows))), 1024)
        self.wlen = wlen
        # re-derive the count from the rounded window length so no window
        # is empty (e.g. 1500 rows / 3 windows -> wlen 1024 -> 2 windows)
        self.num_windows = max(1, -(-n_rows // wlen))
        bounds = [min(w * wlen, n_rows) for w in range(self.num_windows + 1)]
        bounds[-1] = n_rows

        # factor blocking: windowed requires >= 1 (standalone w sweep) and
        # K % F == 0; auto picks the largest divisor <= 4
        K = cfg.num_factor
        if K > 0 and (cfg.factor_block < 1 or K % cfg.factor_block != 0):
            fb = 1
            for d in (4, 3, 2):
                if K % d == 0:
                    fb = d
                    break
            cfg = dataclasses.replace(cfg, factor_block=fb)
        self.cfg = cfg
        self.F = min(cfg.factor_block, K) if K > 0 else 0

        # global coloring: per-window field ranges are detected during the
        # builder's first pass and merged (exact for the paper's one-hot
        # datasets — a single-window probe could mislabel boundary columns
        # absent from that window); non-field data falls back to one
        # Jacobi bin with the same loud warning as SweepPlan.build.
        # ``plan`` short-circuits the build (minutes at 263M rows; the
        # big-bench scripts pickle it) — must match (data, num_windows).
        if plan is not None:
            assert plan.num_windows == self.num_windows \
                and plan.wlen == wlen and plan.n_rows == n_rows
            self.plan = plan
        else:
            self.plan = build_windowed_plan(
                lambda w: src_window(bounds[w], bounds[w + 1]),
                self.num_windows, wlen, D, None, meta.attr_group, n_rows)
        self.train_n = n_rows
        self.n_pad = self.num_windows * wlen
        self.train_target_np = np.asarray(targets, np.float32)

        # device-resident small tables
        self.attr_group = jnp.asarray(meta.attr_group, jnp.int32)
        self.napg = jnp.asarray(meta.num_attr_per_group, jnp.float32)
        self.unobserved = jnp.asarray(self.plan.unobserved)

        # test set resident (small relative to train)
        from svbfm.learners.base import build_row_data
        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.test_target_np = np.asarray(test.target[: test.num_rows])

        self.out_dir = out_dir
        self.write_files = write_files
        self._build_programs()

    # ---- compiled programs ------------------------------------------------

    def _build_programs(self):
        cfg = self.cfg
        F, N = self.F, self.n_pad
        P = self.plan.ids[0].shape[1] if self.plan.ids else 1
        Wlen = self.wlen
        num_cases = float(self.train_n)

        def slice_caches(fq, ftq, ftz, lo):
            q = jnp.stack([jax.lax.dynamic_slice(fq, (f * N + lo,), (Wlen,))
                           for f in range(F)])
            tq = jnp.stack([jax.lax.dynamic_slice(ftq, (f * N + lo,), (Wlen,))
                            for f in range(F)])
            tz = jnp.stack([jax.lax.dynamic_slice(ftz, (f * N + lo,), (Wlen,))
                            for f in range(F)])
            return q, tq, tz

        def write_caches(fq, ftq, ftz, q, tq, tz, lo):
            for f in range(F):
                fq = jax.lax.dynamic_update_slice(fq, q[f], (f * N + lo,))
                ftq = jax.lax.dynamic_update_slice(ftq, tq[f], (f * N + lo,))
                ftz = jax.lax.dynamic_update_slice(ftz, tz[f], (f * N + lo,))
            return fq, ftq, ftz

        def build_w(mu_t, sig_t, fq, ftq, ftz, ids_w, vals_w, lo):
            # mu_t/sig_t [D, F]; caches flat [F*N]; one window's build
            ptab = jnp.concatenate([mu_t.T, sig_t.T], axis=0)  # [2F, D]
            q = jnp.zeros((F, Wlen), jnp.float32)
            tq = jnp.zeros((F, Wlen), jnp.float32)
            tz = jnp.zeros((F, Wlen), jnp.float32)
            for p in range(P):
                g = jnp.take(ptab, ids_w[:, p], axis=-1)  # [2F, Wlen]
                xp = vals_w[:, p][None]
                x2p = xp * xp
                mug, sigg = g[:F], g[F:]
                q = q + mug * xp
                tq = tq + sigg * x2p
                tz = tz + mug * mug * x2p
            return write_caches(fq, ftq, ftz, q, tq, tz, lo)

        self._p_build = jax.jit(build_w, donate_argnums=(2, 3, 4))

        # per-bin stats programs (one compile per bin: bucket shapes differ)
        def make_stats(bin_idx):
            buckets = self.plan.bins[bin_idx]

            def stats_w(e, fq, ftq, mu_t, sig_t, lo, *bucket_arrays):
                # bucket_arrays: (rows, x) per bucket, window-local [C, L]
                e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
                q_w = jnp.stack([jax.lax.dynamic_slice(
                    fq, (f * N + lo,), (Wlen,)) for f in range(F)])
                tq_w = jnp.stack([jax.lax.dynamic_slice(
                    ftq, (f * N + lo,), (Wlen,)) for f in range(F)])
                eq = jnp.concatenate([e_w[None], q_w, tq_w], 0)  # [1+2F, Wlen]
                outs = []
                for j, bu in enumerate(buckets):
                    rows_b = bucket_arrays[2 * j]
                    x_b = bucket_arrays[2 * j + 1]
                    C, L = rows_b.shape
                    mu_c = take_rows(mu_t, jnp.asarray(bu.cols))  # [C, F]
                    sig_c = take_rows(sig_t, jnp.asarray(bu.cols))
                    g = jnp.take(eq, rows_b.reshape(-1), axis=-1)
                    g = g.reshape(1 + 2 * F, C, L)
                    e_g, q_g, tq_g = g[0], g[1:1 + F], g[1 + F:]
                    xb = x_b[None]
                    mu_b = mu_c.T[:, :, None]
                    sig_b = sig_c.T[:, :, None]
                    h = q_g - xb * mu_b
                    h1 = tq_g - xb * xb * sig_b
                    vm = (xb * h * (e_g[None] + xb * mu_b * h)).sum(-1)
                    vs = (xb * xb * (h * h + h1)).sum(-1)
                    outs.append((vm.T, vs.T))  # [C, F] each
                return tuple(outs)

            return jax.jit(stats_w)

        self._p_stats = [make_stats(b) for b in range(len(self.plan.bins))]

        # per-bin draw: stats -> updated tables + [5F, D] delta table
        def make_draw(bin_idx):
            buckets = self.plan.bins[bin_idx]

            def draw(mu_t, sig_t, sv_dk_t, alpha, nan_v, *stats):
                # sv_dk_t [D, F] prior precisions for this block's factors
                D_ = mu_t.shape[0]
                dmu = jnp.zeros((D_, F), jnp.float32)
                dsig = jnp.zeros((D_, F), jnp.float32)
                dmu2 = jnp.zeros((D_, F), jnp.float32)
                mu_out, sig_out = mu_t, sig_t
                for j, bu in enumerate(buckets):
                    vm, vs = stats[2 * j], stats[2 * j + 1]  # [C, F]
                    cols = jnp.asarray(bu.cols)
                    mu_c = take_rows(mu_t, cols)
                    sig_c = take_rows(sig_t, cols)
                    sv_c = take_rows(sv_dk_t, cols)
                    sig_new = 1.0 / (sv_c + alpha * vs)
                    nan_v = nan_v + jnp.sum(~jnp.isfinite(sig_new),
                                            dtype=jnp.int32)
                    sig_new = keep_finite(sig_new, sig_c)
                    mu_new = sig_new * alpha * vm
                    nan_v = nan_v + jnp.sum(~jnp.isfinite(mu_new),
                                            dtype=jnp.int32)
                    mu_new = keep_finite(mu_new, mu_c)
                    mu_out = mu_out.at[cols].set(mu_new)
                    sig_out = sig_out.at[cols].set(sig_new)
                    dmu = dmu.at[cols].set(mu_new - mu_c)
                    dsig = dsig.at[cols].set(sig_new - sig_c)
                    dmu2 = dmu2.at[cols].set(mu_new * mu_new - mu_c * mu_c)
                dtab = jnp.concatenate(
                    [mu_t.T, sig_t.T, dmu.T, dsig.T, dmu2.T], axis=0)
                return mu_out, sig_out, dtab, nan_v

            return jax.jit(draw)

        self._p_draw = [make_draw(b) for b in range(len(self.plan.bins))]

        def patch_w(dtab, e, t, fq, ftq, ftz, ids_w, vals_w, lo):
            # same algebra as vb.vb_v_block_update's patch_tile (carry_tz)
            e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
            t_w = jax.lax.dynamic_slice(t, (lo,), (Wlen,))
            q_t, tq_t, tz_t = slice_caches(fq, ftq, ftz, lo)
            for p in range(P):
                gg = jnp.take(dtab, ids_w[:, p], axis=-1)  # [5F, Wlen]
                xp = vals_w[:, p][None]
                x2p = xp * xp
                mu_e = gg[0 * F:1 * F]
                sig_e = gg[1 * F:2 * F]
                dmu_e = gg[2 * F:3 * F]
                dsig_e = gg[3 * F:4 * F]
                dmu2_e = gg[4 * F:5 * F]
                he = xp * (q_t - xp * mu_e)
                h1e = x2p * (tq_t - x2p * sig_e)
                h2e = x2p * (tz_t - x2p * mu_e * mu_e)
                q_t = q_t + xp * dmu_e
                tq_t = tq_t + x2p * dsig_e
                tz_t = tz_t + x2p * dmu2_e
                e_w = e_w - (he * dmu_e).sum(0)
                t_w = t_w + ((h1e + h2e) * dsig_e + h1e * dmu2_e).sum(0)
            e = jax.lax.dynamic_update_slice(e, e_w, (lo,))
            t = jax.lax.dynamic_update_slice(t, t_w, (lo,))
            fq, ftq, ftz = write_caches(fq, ftq, ftz, q_t, tq_t, tz_t, lo)
            return e, t, fq, ftq, ftz

        self._p_patch = jax.jit(patch_w, donate_argnums=(1, 2, 3, 4, 5))

        # ---- standalone w sweep (fm_learn_vb.h:390-406) ----
        def make_wdraw(bin_idx):
            buckets = self.plan.bins[bin_idx]

            def wdraw(mu_w, sig_w, sigma_w_g, alpha, nan_w, *sxes):
                D_ = mu_w.shape[0]
                wdmu = jnp.zeros((D_,), jnp.float32)
                wdsig = jnp.zeros((D_,), jnp.float32)
                for j, bu in enumerate(buckets):
                    sxe = sxes[j]  # [C]
                    cols = jnp.asarray(bu.cols)
                    mu_c = jnp.take(mu_w, cols)
                    sig_c = jnp.take(sig_w, cols)
                    sw_g = jnp.take(sigma_w_g, jnp.asarray(bu.group))
                    sx2 = jnp.asarray(bu.sx2)
                    sig_new = 1.0 / (sw_g + alpha * sx2)
                    sig_new_k = keep_finite(sig_new, sig_c)
                    mu_new = sig_new_k * alpha * (sxe + mu_c * sx2)
                    nan_w = nan_w + jnp.sum(~jnp.isfinite(sig_new),
                                            dtype=jnp.int32)
                    nan_w = nan_w + jnp.sum(~jnp.isfinite(mu_new),
                                            dtype=jnp.int32)
                    mu_new = keep_finite(mu_new, mu_c)
                    mu_w = mu_w.at[cols].set(mu_new)
                    sig_w = sig_w.at[cols].set(sig_new_k)
                    wdmu = wdmu.at[cols].set(mu_c - mu_new)
                    wdsig = wdsig.at[cols].set(sig_new_k - sig_c)
                dtab = jnp.stack([wdmu, wdsig], axis=0)  # [2, D]
                return mu_w, sig_w, dtab, nan_w

            return jax.jit(wdraw)

        self._p_wdraw = [make_wdraw(b) for b in range(len(self.plan.bins))]

        def make_wstats(bin_idx):
            buckets = self.plan.bins[bin_idx]

            def wstats(e, lo, *bucket_arrays):
                e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
                outs = []
                for j, bu in enumerate(buckets):
                    rows_b = bucket_arrays[2 * j]
                    x_b = bucket_arrays[2 * j + 1]
                    e_g = jnp.take(e_w, rows_b.reshape(-1)).reshape(
                        rows_b.shape)
                    outs.append((x_b * e_g).sum(-1))
                return tuple(outs)

            return jax.jit(wstats)

        self._p_wstats = [make_wstats(b) for b in range(len(self.plan.bins))]

        def wpatch_w(dtab, e, t, ids_w, vals_w, lo):
            e_w = jax.lax.dynamic_slice(e, (lo,), (Wlen,))
            t_w = jax.lax.dynamic_slice(t, (lo,), (Wlen,))
            for p in range(P):
                d = jnp.take(dtab, ids_w[:, p], axis=-1)  # [2, Wlen]
                xp = vals_w[:, p]
                e_w = e_w + xp * d[0]
                t_w = t_w + xp * xp * d[1]
            return (jax.lax.dynamic_update_slice(e, e_w, (lo,)),
                    jax.lax.dynamic_update_slice(t, t_w, (lo,)))

        self._p_wpatch = jax.jit(wpatch_w, donate_argnums=(1, 2))

        # ---- w0 + tail (hypers, free energy, eval, resampling) ----
        def w0_step(state, valid):
            dtype = state.mu_w.dtype
            Nf = jnp.asarray(num_cases, dtype)
            sigma_new = 1.0 / (state.sigma_0 + Nf * state.alpha)
            w0_temp = jnp.sum(state.e * valid) + Nf * state.mu_0
            mu_new = sigma_new * state.alpha * w0_temp
            e = state.e + (state.mu_0 - mu_new)
            t = state.t + (sigma_new - state.sigma_0_dash)
            return state.replace(e=e, t=t, mu_0=mu_new,
                                 sigma_0_dash=sigma_new)

        self._p_w0 = jax.jit(w0_step, donate_argnums=(0,))

        def tail(state, valid, trow, nan_w, nan_v):
            from svbfm.learners.vb import vb_finalize

            class _Plan:
                attr_group = self.attr_group
                num_attr_per_group = self.napg
                unobserved = self.unobserved

            class _Row:
                valid = None

            row = _Row()
            row.valid = valid
            Nf = jnp.asarray(num_cases, state.mu_w.dtype)
            new_state, fe, nan_alpha = vb_finalize(
                state.e, state.t, state.mu_0, state.sigma_0_dash,
                state.mu_w, state.sigma_w_dash, state.mu_v,
                state.sigma_v_dash, state, row, _Plan, cfg, Nf,
                psum=lambda x: x)  # single device: no data-axis reduction
            # test eval (resident, small)
            scores = fm_scores(new_state.mu_0, new_state.mu_w,
                               new_state.mu_v, trow.ids, trow.vals,
                               k0=cfg.k0, k1=cfg.k1)
            nt = jnp.asarray(float(self.test_n), scores.dtype)
            nans = dict(nan_w=nan_w, nan_v=nan_v, nan_alpha=nan_alpha)
            if cfg.task == TASK_REGRESSION:
                p = jnp.clip(scores, cfg.min_target, cfg.max_target)
                err = (p - trow.target) * trow.valid
                rmse = jnp.sqrt(jnp.sum(err * err) / nt)
                mae = jnp.sum(jnp.abs(err)) / nt
                e_c = jnp.clip(new_state.e, cfg.min_target, cfg.max_target)
                train_rmse = jnp.sqrt(jnp.sum(e_c * e_c * valid) / Nf)
                metrics = dict(free_energy=fe, rmse=rmse, mae=mae,
                               train_rmse=train_rmse, alpha=new_state.alpha,
                               sigma_w=new_state.sigma_w,
                               sigma_v=new_state.sigma_v, **nans)
            else:
                prob = ref_cdf_gaussian(scores)
                yt = trow.target
                hit = (((prob >= 0.5) & (yt > 0)) | ((prob < 0.5) & (yt < 0)))
                acc = jnp.sum(hit * trow.valid) / nt
                m = (yt + 1.0) * 0.5
                pll = jnp.clip(prob, 0.01, 0.99)
                ll = -jnp.sum((m * jnp.log10(pll)
                               + (1 - m) * jnp.log10(1 - pll))
                              * trow.valid) / nt
                metrics = dict(free_energy=fe, accuracy=acc, loglik=ll,
                               alpha=new_state.alpha,
                               sigma_w=new_state.sigma_w,
                               sigma_v=new_state.sigma_v, **nans)
                # probit e-resampling (fm_learn_vb_simultaneous.h:172-200)
                e = new_state.e
                ytr = self._train_target_dev
                sampled = jnp.where(ytr >= 0, truncnorm_mean_positive(e),
                                    truncnorm_mean_negative(e))
                new_state = new_state.replace(e=sampled - e)
            return new_state, metrics

        self._p_tail = jax.jit(tail, donate_argnums=(0,))

    # ---- state ------------------------------------------------------------

    def init_state(self, key: Optional[jax.Array] = None) -> VBState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        p = init_vb_params(key, cfg)
        N = self.n_pad
        e = np.zeros(N, np.float32)
        t = np.zeros(N, np.float32)
        sc = jax.jit(lambda prm, ids, vals: fm_scores(
            prm[0], prm[1], prm[2], ids, vals, k0=cfg.k0, k1=cfg.k1))
        tt = jax.jit(lambda prm, ids, vals: fm_t_terms(
            prm[0], prm[1], prm[2], prm[3], ids, vals,
            k0=cfg.k0, k1=cfg.k1))
        y = np.zeros(N, np.float32)
        y[: self.train_n] = self.train_target_np[: self.train_n]
        for w in range(self.num_windows):
            lo = w * self.wlen
            ids = jnp.asarray(self.plan.ids[w])
            vals = jnp.asarray(self.plan.vals[w])
            yhat = np.asarray(sc((p["mu_0"], p["mu_w"], p["mu_v"]),
                                 ids, vals))
            e[lo:lo + self.wlen] = y[lo:lo + self.wlen] - yhat
            t[lo:lo + self.wlen] = np.asarray(
                tt((p["sigma_0_dash"], p["sigma_w_dash"], p["mu_v"],
                    p["sigma_v_dash"]), ids, vals))
        valid = (np.arange(N) < self.train_n).astype(np.float32)
        self._valid = jnp.asarray(valid)
        self._train_target_dev = (jnp.asarray(y)
                                  if cfg.task != TASK_REGRESSION else None)
        # flat caches, (re)built per block each sweep
        self._fq = jnp.zeros(self.F * N, jnp.float32) if self.F else None
        self._ftq = jnp.zeros(self.F * N, jnp.float32) if self.F else None
        self._ftz = jnp.zeros(self.F * N, jnp.float32) if self.F else None
        return VBState(e=jnp.asarray(e), t=jnp.asarray(t), **p)

    # ---- one sweep --------------------------------------------------------

    def _put_window(self, w):
        return (jax.device_put(self.plan.ids[w]),
                jax.device_put(self.plan.vals[w]))

    def _sweep(self, state: VBState):
        cfg = self.cfg
        F, N, Wlen = self.F, self.n_pad, self.wlen
        K = cfg.num_factor
        nan_w = jnp.zeros((), jnp.int32)
        nan_v = jnp.zeros((), jnp.int32)
        if cfg.k0:
            state = self._p_w0(state, self._valid)
        e, t = state.e, state.t
        mu_w, sig_w = state.mu_w, state.sigma_w_dash

        lo_of = lambda w: jnp.asarray(w * Wlen, jnp.int32)

        # --- standalone w sweep ---
        if cfg.k1:
            for b, buckets in enumerate(self.plan.bins):
                if not buckets:
                    continue
                acc = None
                bp = WindowBackpressure(lag=1)
                for w in range(self.num_windows):
                    barrs = []
                    for bu in buckets:
                        barrs += [jax.device_put(bu.rows[w]),
                                  jax.device_put(bu.x[w])]
                    part = bp(self._p_wstats[b](e, lo_of(w), *barrs))
                    acc = part if acc is None else tuple(
                        a + q for a, q in zip(acc, part))
                mu_w, sig_w, dtab, nan_w = self._p_wdraw[b](
                    mu_w, sig_w, state.sigma_w, state.alpha, nan_w, *acc)
                bp = WindowBackpressure()
                for w in range(self.num_windows):
                    ids_w, vals_w = self._put_window(w)
                    e, t = bp(self._p_wpatch(dtab, e, t, ids_w, vals_w,
                                             lo_of(w)))

        # --- v sweeps, factor blocks ---
        mu_v, sig_v = state.mu_v, state.sigma_v_dash
        if K > 0:
            sv_dk = take_rows(state.sigma_v, self.attr_group)  # [D, K]
            nb = K // F
            fq, ftq, ftz = self._fq, self._ftq, self._ftz
            for b in range(nb):
                fs = slice(b * F, (b + 1) * F)
                mu_t = mu_v[fs].T  # [D, F]
                sig_t = sig_v[fs].T
                sv_t = sv_dk[:, fs]
                bp = WindowBackpressure()
                for w in range(self.num_windows):
                    ids_w, vals_w = self._put_window(w)
                    fq, ftq, ftz = bp(self._p_build(mu_t, sig_t, fq, ftq,
                                                    ftz, ids_w, vals_w,
                                                    lo_of(w)))
                for bi, buckets in enumerate(self.plan.bins):
                    if not buckets:
                        continue
                    acc = None
                    bp = WindowBackpressure(lag=1)
                    for w in range(self.num_windows):
                        barrs = []
                        for bu in buckets:
                            barrs += [jax.device_put(bu.rows[w]),
                                      jax.device_put(bu.x[w])]
                        part = bp(self._p_stats[bi](e, fq, ftq, mu_t, sig_t,
                                                    lo_of(w), *barrs))
                        flat = [x for tup in part for x in tup]
                        acc = flat if acc is None else [
                            a + x for a, x in zip(acc, flat)]
                    mu_t, sig_t, dtab, nan_v = self._p_draw[bi](
                        mu_t, sig_t, sv_t, state.alpha, nan_v, *acc)
                    bp = WindowBackpressure()
                    for w in range(self.num_windows):
                        ids_w, vals_w = self._put_window(w)
                        e, t, fq, ftq, ftz = bp(self._p_patch(
                            dtab, e, t, fq, ftq, ftz, ids_w, vals_w,
                            lo_of(w)))
                mu_v = mu_v.at[fs].set(mu_t.T)
                sig_v = sig_v.at[fs].set(sig_t.T)
            self._fq, self._ftq, self._ftz = fq, ftq, ftz

        state = state.replace(e=e, t=t, mu_w=mu_w, sigma_w_dash=sig_w,
                              mu_v=mu_v, sigma_v_dash=sig_v)
        return self._p_tail(state, self._valid, self.test_row, nan_w, nan_v)

    # ---- run loop ---------------------------------------------------------

    def run(self, state: Optional[VBState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            chunk: Optional[int] = None, ckpt=None, ckpt_every: int = 10):
        import time as _time
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir, self.write_files)
        fe_file = TrajectoryFile("free_energy", cfg, self.method,
                                 self.out_dir, self.write_files)
        history = []
        for it in range(num_iter):
            t0 = _time.perf_counter()
            state, metrics = self._sweep(state)
            metrics = jax.device_get(metrics)
            wall = _time.perf_counter() - t0
            rec = {"iter": it, "time_learn": wall, "time_pred": 0.0}
            if not self.plan.conflict_free:
                rec["conflict_free"] = False
            rec.update({k: (float(v) if np.ndim(v) == 0 else v)
                        for k, v in metrics.items()})
            fe_file.append(-rec["free_energy"])
            if cfg.task == TASK_REGRESSION:
                rmse_file.append(rec["rmse"])
                if verbose:
                    print(f"#Iter={it:3d}\tTrain={rec['train_rmse']:.6g}"
                          f"\tTest={rec['rmse']:.6g}")
            else:
                rmse_file.append(rec["accuracy"])
                if verbose:
                    print(f"#Iter={it:3d}\tTest={rec['accuracy']:.6g}"
                          f"\tTest(ll)={rec['loglik']:.6g}")
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, rec)
            history.append(rec)
        return state, history

    def predict_test_scores(self, state: VBState) -> np.ndarray:
        s = jax.jit(lambda prm, ids, vals: fm_scores(
            prm[0], prm[1], prm[2], ids, vals,
            k0=self.cfg.k0, k1=self.cfg.k1))(
            (state.mu_0, state.mu_w, state.mu_v),
            self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]
