"""Experimental exponential-family SGD learners (exp_sgd / exp_sgd_stoc).

A re-design of the reference's experimental learners:

* ``exp_fm_learn_sgd`` (+``_simultaneous``) — **full-batch coordinate-descent
  gradient steps** over the transpose with e/q caches (the MCMC/VB sweep
  skeleton but plain gradients, ``exp_fm_learn_sgd.h:267-455``):

    e        = stdev * yhat - y                (``exp_fm_learn_sgd_simultaneous.h:35,107``)
    w0      -= lr * (sum e + reg0 w0) / N      (``:278``)
    w_i     -= lr * (sum_i x e + regw w) / N   (``:385``)
    v_fi    -= lr * (sum_i h e + regv v) / N,  h = x (q - x v)   (``:428``)

  with incremental e/q patches after each coordinate and NaN/Inf reverts,
  then a full re-predict each iteration.  Executed here as conflict-free
  binned column sweeps (same gather-only scheme as the VB/MCMC learners)
  with factor blocking.

* ``exp_fm_learn_sgd_stoc`` — per-example SGD with exponential-family
  multipliers (``exp_fm_learn_sgd_stoc_element.h:29-43``):
    task r: mult = -(y - (1/stdev) p)          (no clamping)
    task c: mult = -y (1 - sigmoid(y p))
    task p: mult = -(y - exp(clamp(p)))
  Executed as the damped minibatch SGD of :mod:`svbfm.learners.sgd`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from svbfm.data.dataset import SparseDataset, SweepPlan
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    FMConfig,
    RowData,
    TASK_CLASSIFICATION,
    TASK_POISSON,
    TASK_REGRESSION,
    TrajectoryFile,
    build_plan_data,
    build_row_data,
    evaluate_regression,
    keep_finite,
    plan_specs_for,
)
from svbfm.learners.sgd import SGDLearner, SGDState
from svbfm.models.fm import init_fm_params
from svbfm.ops.forward import fm_scores
from svbfm.ops.segment import take_rows
from svbfm.parallel.mesh import DATA_AXIS, make_mesh


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


def exp_sgd_sweep(w0, w, v, e, row, plan, cfg: FMConfig, n_cases: float):
    """One full-batch coordinate gradient sweep (exp_fm_learn_sgd.h:267-455).
    e = stdev*yhat - y on entry; returns updated params (e is re-predicted
    by the caller)."""
    dtype = w.dtype
    D, K = cfg.num_attributes, cfg.num_factor
    lr = cfg.learn_rate
    N = jnp.asarray(n_cases, dtype)

    if cfg.k0:
        w0_sum = _psum(jnp.sum(e * row.valid))
        w0_new = keep_finite(w0 - lr * (w0_sum + cfg.reg0 * w0) / N, w0)
        e = e - (w0 - w0_new) * row.valid
        w0 = w0_new

    if cfg.k1:
        for bin_blocks in plan.blocks:
            dw = jnp.zeros((D,), dtype)
            for blk in bin_blocks:
                x = blk.x[0]
                w_c = take_rows(w, blk.cols)
                e_g = take_rows(e, blk.rows[0])
                w_sum = _psum((x * e_g).sum(-1))
                w_new = keep_finite(w_c - lr * (w_sum + cfg.regw * w_c) / N, w_c)
                w = w.at[blk.cols].set(w_new)
                dw = dw.at[blk.cols].set(w_c - w_new)
            de = 0.0
            for p in range(row.ids.shape[1]):
                de = de + row.vals[:, p] * jnp.take(dw, row.ids[:, p])
            e = e - de * row.valid

    if K > 0:
        F = cfg.factor_block if cfg.factor_block > 0 else K
        F = min(F, K)
        nb = -(-K // F)
        K_pad = nb * F
        ids, x_r = row.ids, row.vals
        x_re = x_r[:, :, None]

        def pad_f(a):
            if K_pad != K:
                a = jnp.concatenate(
                    [a, jnp.zeros((K_pad - K,) + a.shape[1:], a.dtype)], 0)
            return a.reshape(nb, F, *a.shape[1:])

        fmask = (jnp.arange(K_pad).reshape(nb, F) < K) if K_pad != K else None

        def blk_step(carry, xs):
            e = carry
            if fmask is None:
                v_b = xs
                m = None
            else:
                v_b, m = xs
                m = m[None, :]
            v_t = v_b.T  # [D, F]
            vg = take_rows(v_t, ids)  # [N, P, F]
            q = (vg * x_re).sum(1) * row.valid[:, None]  # [N, F]
            for bin_blocks in plan.blocks:
                v_old_t = v_t
                dv_d = jnp.zeros((D, F), dtype)
                stab = jnp.concatenate([e[:, None], q], axis=-1)
                for blk in bin_blocks:
                    x = blk.x[0][:, :, None]
                    g = take_rows(stab, blk.rows[0])  # [C, L, 1+F]
                    e_g, q_g = g[..., :1], g[..., 1:]
                    v_c = take_rows(v_old_t, blk.cols)  # [C, F]
                    h = x * (q_g - x * v_c[:, None, :])
                    v_sum = _psum((h * e_g).sum(1))
                    v_new = keep_finite(
                        v_c - lr * (v_sum + cfg.regv * v_c) / N, v_c)
                    if m is not None:
                        v_new = jnp.where(m, v_new, v_c)
                    v_t = v_t.at[blk.cols].set(v_new)
                    dv_d = dv_d.at[blk.cols].set(v_c - v_new)
                # row patch with pre-bin caches (exact: additive over factors)
                dtab = jnp.concatenate([v_old_t, dv_d], axis=-1)
                gg = take_rows(dtab, ids)  # [N, P, 2F]
                v_e, dv_e = gg[..., :F], gg[..., F:]
                h_e = x_re * (q[:, None, :] - x_re * v_e)
                q = q - (x_re * dv_e).sum(1) * row.valid[:, None]
                e = e - (h_e * dv_e).sum((1, 2)) * row.valid
            return e, v_t.T

        xs = pad_f(v) if fmask is None else (pad_f(v), fmask)
        if nb == 1:
            e, v_out = blk_step(e, jax.tree.map(lambda a: a[0], xs) if fmask else xs[0])
            v = v_out
        else:
            e, v_outs = jax.lax.scan(blk_step, e, xs)
            v = v_outs.reshape(K_pad, -1)[:K]
    return w0, w, v


class ExpSGDLearner:
    """Full-batch exponential-family coordinate SGD (method 'exp_sgd')."""

    method = "exp_sgd"

    def __init__(self, cfg: FMConfig, train: SparseDataset, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None, mesh=None,
                 bins: str = "auto", out_dir: str = ".", write_files: bool = True):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        n = self.mesh.devices.size
        self.meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.plan = SweepPlan.build(train.to_coo(), cfg.num_attributes,
                                    meta_groups=self.meta.attr_group,
                                    bins=bins, n_shards=n)
        self.train_row, self.train_n = build_row_data(self.mesh, train)
        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.plan_data = build_plan_data(self.mesh, self.plan, self.meta)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.out_dir = out_dir
        self.write_files = write_files
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        n_cases = float(self.train_n)
        nt = float(self.test_n)

        def step_fn(params, row, plan, trow):
            w0, w, v = params
            # e = stdev * yhat - y (exp_fm_learn_sgd_simultaneous.h:35,107)
            yhat = fm_scores(w0, w, v, row.ids, row.vals, k0=cfg.k0, k1=cfg.k1)
            e = (cfg.stdev * yhat - row.target) * row.valid
            w0, w, v = exp_sgd_sweep(w0, w, v, e, row, plan, cfg, n_cases)
            # eval (clamped RMSE, fm_learn.h:242-263)
            scores = fm_scores(w0, w, v, trow.ids, trow.vals,
                               k0=cfg.k0, k1=cfg.k1)
            p = jnp.clip(scores, cfg.min_target, cfg.max_target)
            err = (p - trow.target) * trow.valid
            rmse = jnp.sqrt(_psum(jnp.sum(err * err)) / nt)
            return (w0, w, v), rmse

        rep = P()
        self._step = jax.jit(jax.shard_map(
            step_fn, mesh=self.mesh,
            in_specs=((rep, rep, rep), RowData(ids=P(DATA_AXIS), vals=P(DATA_AXIS),
                                               target=P(DATA_AXIS), valid=P(DATA_AXIS)),
                      plan_specs_for(self.plan_data),
                      RowData(ids=P(DATA_AXIS), vals=P(DATA_AXIS),
                              target=P(DATA_AXIS), valid=P(DATA_AXIS))),
            out_specs=((rep, rep, rep), rep),
        ))
        self._scores = jax.jit(lambda w0, w, v, ids, vals: fm_scores(
            w0, w, v, ids, vals, k0=cfg.k0, k1=cfg.k1))

    def init_state(self, key=None):
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        params = init_fm_params(key, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev)
        return (params.w0, params.w, params.v)

    def predict_test_scores(self, state) -> np.ndarray:
        w0, w, v = state
        s = self._scores(w0, w, v, self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]

    def run(self, state=None, num_iter: Optional[int] = None, verbose=True,
            ckpt=None, ckpt_every: int = 10):
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        it0 = 0
        if ckpt is not None:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                blob, it0, _meta = restored
                from jax.sharding import NamedSharding, PartitionSpec as PS
                rep = NamedSharding(self.mesh, PS())
                state = jax.device_put(blob, jax.tree.map(lambda _: rep, blob))
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                                   self.write_files and it0 == 0)
        history = []
        import time as _time
        for it in range(it0, num_iter):
            t0 = _time.perf_counter()
            state, rmse = self._step(state, self.train_row, self.plan_data,
                                     self.test_row)
            t1 = _time.perf_counter()
            rmse = float(rmse)  # blocking fetch = host-visible eval segment
            now = _time.perf_counter()
            rmse_file.append(rmse)
            rec = {"iter": it, "rmse": rmse, "time_pred": now - t1,
                   "time_learn": now - t0}
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, rec)
            history.append(rec)
            if verbose:
                print(f"#Iter={it:3d}\tTest={rmse:.6g}")
            if ckpt is not None and ((it + 1 - it0) % ckpt_every == 0
                                     or it + 1 >= num_iter):
                ckpt.save(jax.tree.map(np.asarray, state), it + 1,
                          {"method": self.method})
        return state, history


class ExpSGDStocLearner(SGDLearner):
    """Per-example exponential-family SGD (method 'exp_sgd_stoc'):
    minibatch-damped like SGDLearner but with the exp-family multipliers."""

    method = "exp_sgd_stoc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        import dataclasses
        cfg = dataclasses.replace(cfg, exp_family=True)
        super().__init__(cfg, *args, **kwargs)
