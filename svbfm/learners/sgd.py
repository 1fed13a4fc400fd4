"""SGD / SGDA / streaming-SGD learners for factorization machines.

A re-design of the reference SGD family:

* ``fm_learn_sgd_element`` (``src/libfm/src/fm_learn_sgd_element.h:36-111``)
  — per-example SGD with a fresh row shuffle each iteration, multipliers
  ``-(y - clamp(p))`` (regression) / ``-y*(1-sigmoid(y*p))`` (classification),
  and the elementwise kernel ``fm_SGD`` (``src/fm_core/fm_sgd.h:33-51``).
* ``fm_learn_sgd_element_adapt_reg`` (SGDA, WSDM'12;
  ``fm_learn_sgd_element_adapt_reg.h:44-352``) — alternating theta steps on
  train and per-group lambda steps on validation using forecasted parameters.
* ``fm_learn_sgd_online`` (``fm_learn_sgd_online.h:36-156``) — epochs over
  disk-chunked shuffled batches of a training file too large for memory.

The serial per-example loop becomes **minibatch SGD under ``shard_map``**:
each device scores its shard of a shuffled minibatch with the O(K*nnz)
pairwise trick, builds dense gradients by scatter-add, and the gradients are
``psum``'d over the data axis so replicated parameters stay in sync.  An
entire epoch is one compiled ``lax.scan`` over minibatches — no host round
trips.  With ``batch_size=1`` the semantics degenerate to the reference's
per-example Gauss-Seidel ordering; the default minibatch is the idiomatic
accelerator operating point and reproduces the reference convergence curves.

Regularization parity: each *occurrence* of a parameter in the batch
contributes one ``reg * theta`` shrinkage term, matching the per-example
kernel which regularizes every touched parameter once per example.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    FMConfig,
    RowData,
    TASK_CLASSIFICATION,
    TASK_REGRESSION,
    TrajectoryFile,
    build_row_data,
    evaluate_classification,
    evaluate_regression,
)
from svbfm.models.fm import init_fm_params
from svbfm.ops.forward import fm_scores
from svbfm.ops.segment import take_cols, take_rows
from svbfm.parallel.mesh import DATA_AXIS, make_mesh
from svbfm.utils.pytree import pytree_dataclass

TASK_POISSON = 2


@pytree_dataclass
class SGDState:
    w0: jax.Array  # scalar
    w: jax.Array  # [D]
    v: jax.Array  # [K, D]
    key: jax.Array


@pytree_dataclass
class SGDAState:
    w0: jax.Array
    w: jax.Array
    v: jax.Array
    key: jax.Array
    # per-group adaptive regularization + last-seen gradients (SGDA)
    reg_w: jax.Array  # [G]
    reg_v: jax.Array  # [G, K]
    # last-seen gradient caches are *per-shard* (each shard records the
    # gradients of its own slice of the batch): leading axis = data shard
    grad_w: jax.Array  # [S, D]
    grad_v: jax.Array  # [S, K, D]


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


def _multiplier(p, y, cfg: FMConfig, scale: float = 1.0):
    """Loss multiplier (fm_learn_sgd_element.h:79-85; adapt_reg uses
    2*(p-y), i.e. scale=2 with the same sign; exp_family variants per
    exp_fm_learn_sgd_stoc_element.h:29-43)."""
    if cfg.task == TASK_REGRESSION:
        if cfg.exp_family:  # -(y - (1/stdev) p), no clamping
            return scale * (p / cfg.stdev - y)
        p = jnp.clip(p, cfg.min_target, cfg.max_target)
        return scale * (p - y)
    elif cfg.task == TASK_CLASSIFICATION:
        return scale * y * (jax.nn.sigmoid(y * p) - 1.0)
    else:  # Poisson-ish task "p": -(y - exp(clamp(p)))
        p = jnp.clip(p, cfg.min_target, cfg.max_target)
        return scale * (jnp.exp(p) - y)


def sgd_minibatch_update(w0, w, v, ids, vals, y, valid, cfg: FMConfig,
                         lr, reg0, regw_d, regv_d, mult_scale: float = 1.0):
    """One data-parallel minibatch step (runs inside shard_map).

    ids/vals/y/valid are the shard-local slice of the batch.  regw_d/regv_d
    are dense per-attribute regularization constants ([D] and [K, D]-bcast)
    so plain SGD (scalar reg) and SGDA (per-group reg) share this kernel.
    Returns updated params and the per-entry gradients (for SGDA).
    """
    p = fm_scores(w0, w, v, ids, vals, k0=cfg.k0, k1=cfg.k1)
    mult = _multiplier(p, y, cfg, mult_scale) * valid

    # A parameter touched c times in the batch would receive c *sequential*
    # per-example steps `theta <- theta(1 - lr*reg) - lr*grad_n` in the
    # reference kernel.  The batched equivalent applies the exact net of the
    # multiplicative reg shrink, (1-lr*reg)^c, and relaxes the summed
    # data-gradient with the geometric damping (1-(1-lr)^c)/c, which ->
    # lr*sum-grad as lr*c -> 0 (exact for rare features) while staying
    # stable for dense parameters like w0 where a plain summed gradient
    # overshoots.
    # per-occurrence relaxation rate: d(step)/d(theta) ~ lr * mult_scale
    rate = jnp.minimum(lr * mult_scale, 1.0)

    def damp(c):
        return (1.0 - (1.0 - rate) ** c) / mult_scale

    # w0: every (valid) example contributes one grad + one reg term
    if cfg.k0:
        n_eff = _psum(jnp.sum(valid))
        g0 = _psum(jnp.sum(mult))
        w0 = (w0 * (1.0 - lr * reg0) ** n_eff
              - damp(n_eff) * g0 / jnp.maximum(n_eff, 1.0))

    D = w.shape[0]
    mask = (vals != 0).astype(vals.dtype) * valid[:, None]
    cnt = _psum(jnp.zeros((D,), w.dtype).at[ids].add(mask))
    cnt1 = jnp.maximum(cnt, 1.0)

    grad_w_entries = mult[:, None] * vals
    if cfg.k1:
        gw = _psum(jnp.zeros((D,), w.dtype).at[ids].add(grad_w_entries))
        w = (w * jnp.maximum(1.0 - lr * regw_d, 0.0) ** cnt
             - damp(cnt) * gw / cnt1)

    # factor gradients: grad_v_fi = mult * (x * s_f - v_fi * x^2)
    vg = take_cols(v, ids)  # [K, B, P]
    s = (vg * vals[None]).sum(-1)  # [K, B]
    grad_v_entries = mult[None, :, None] * (
        s[:, :, None] * vals[None] - vg * (vals * vals)[None])  # [K, B, P]
    K = v.shape[0]
    gv = _psum(jnp.zeros((K, D), v.dtype).at[:, ids].add(grad_v_entries))
    v = (v * jnp.maximum(1.0 - lr * regv_d, 0.0) ** cnt[None, :]
         - damp(cnt)[None, :] * gv / cnt1[None, :])
    return w0, w, v, grad_w_entries, grad_v_entries


def _shuffled_batches(key, row: RowData, num_batches: int):
    """Shard-local shuffle + reshape into [nb, bl, ...] batch arrays."""
    n_loc = row.ids.shape[0]
    # decorrelate shards without desyncing the replicated key chain
    key = jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS))
    perm = jax.random.permutation(key, n_loc)
    bl = n_loc // num_batches
    take = bl * num_batches
    perm = perm[:take]
    ids = row.ids[perm].reshape(num_batches, bl, -1)
    vals = row.vals[perm].reshape(num_batches, bl, -1)
    y = row.target[perm].reshape(num_batches, bl)
    valid = row.valid[perm].reshape(num_batches, bl)
    return ids, vals, y, valid


def sgd_epoch(state: SGDState, row: RowData, cfg: FMConfig, num_batches: int):
    """One SGD epoch = shuffle + scan over minibatches (inside shard_map)."""
    key, sub = jax.random.split(state.key)
    ids_b, vals_b, y_b, valid_b = _shuffled_batches(sub, row, num_batches)
    regw_d = jnp.full_like(state.w, cfg.regw)
    regv_d = jnp.full_like(state.v, cfg.regv)

    def batch_step(carry, xs):
        w0, w, v = carry
        ids, vals, y, valid = xs
        w0, w, v, _, _ = sgd_minibatch_update(
            w0, w, v, ids, vals, y, valid, cfg, cfg.learn_rate, cfg.reg0,
            regw_d, regv_d)
        return (w0, w, v), None

    (w0, w, v), _ = jax.lax.scan(
        batch_step, (state.w0, state.w, state.v), (ids_b, vals_b, y_b, valid_b))
    return SGDState(w0=w0, w=w, v=v, key=key)


def sgda_lambda_update(w0, w, v, reg_w, reg_v, grad_w, grad_v,
                       vids, vvals, vy, vvalid, cfg: FMConfig, attr_group):
    """SGDA lambda (regularization) step on a validation minibatch
    (``fm_learn_sgd_element_adapt_reg.h:159-236``): forecast theta' with the
    last-seen gradients, predict_scaled, then step reg_w/reg_v against the
    forecasted validation loss (clamped at 0).  Runs inside shard_map; at
    batch size 1 it reproduces the reference per-example step exactly (the
    batch damping ``scale_l`` is 1 when n_v == 1)."""
    G = reg_w.shape[0]
    lr = cfg.learn_rate
    g_of = take_rows(attr_group, vids)  # [B, P]
    w_g = take_rows(w, vids)
    v_g = take_cols(v, vids)  # [K, B, P]
    gw_g = take_rows(grad_w, vids)
    gv_g = take_cols(grad_v, vids)
    rw_g = take_rows(jnp.take(reg_w, attr_group), vids)
    rv_g = take_cols(jnp.take(reg_v, attr_group, axis=0).T, vids)

    vmask = (vvals != 0).astype(vvals.dtype) * vvalid[:, None]
    # forecasted parameters theta' = theta - lr*(grad + 2 reg theta)
    w_dash = w_g - lr * (gw_g + 2.0 * rw_g * w_g)
    v_dash = v_g - lr * (gv_g + 2.0 * rv_g * v_g)

    # predict_scaled (adapt_reg.h:159-190)
    p = jnp.zeros(vy.shape, w.dtype)
    if cfg.k0:
        p = p + w0
    if cfg.k1:
        p = p + (w_dash * vvals * vmask).sum(-1)
    d = v_dash * vvals[None] * vmask[None]
    p = p + 0.5 * ((d.sum(-1)) ** 2 - (d * d).sum(-1)).sum(0)
    if cfg.task == TASK_REGRESSION:
        p = jnp.clip(p, cfg.min_target, cfg.max_target)
        grad_loss = 2.0 * (p - vy)
    else:
        grad_loss = vy * (jax.nn.sigmoid(vy * p) - 1.0)
    grad_loss = grad_loss * vvalid

    # lambda_w_grad(g) = -2 lr sum_{i in g} x_i w_i, per example
    # batch damping, same argument as in sgd_minibatch_update
    n_v = _psum(jnp.sum(vvalid))
    scale_l = (1.0 - (1.0 - jnp.minimum(lr, 1.0)) ** n_v) / (
        lr * jnp.maximum(n_v, 1.0))

    seg = jnp.where(vmask > 0, g_of, G)  # pad -> dropped segment
    xw = vvals * w_g * vmask
    lwg = jax.vmap(lambda s, d: jnp.zeros((G + 1,), w.dtype).at[s].add(d)[:G])(
        seg, xw)  # [B, G]
    dreg_w = _psum(jnp.sum(grad_loss[:, None] * (-2.0 * lr) * lwg, axis=0))
    reg_w = jnp.maximum(reg_w - lr * scale_l * dreg_w, 0.0)

    # lambda_v_grad(g,f) = -2 lr (sum_f_dash * sum_f(g) - sum_f_dash_f(g))
    xv = vvals[None] * v_g * vmask[None]  # [K, B, P]
    xv_dash = vvals[None] * v_dash * vmask[None]
    sum_f_dash = xv_dash.sum(-1)  # [K, B]

    def seg_sum_g(data, segs):
        # data [K, B, P] -> [K, B, G]
        def one(dk, sk):
            return jax.vmap(
                lambda s, d: jnp.zeros((G + 1,), w.dtype).at[s].add(d)[:G]
            )(sk, dk)
        return jax.vmap(one)(data, jnp.broadcast_to(segs, data.shape))

    sum_f_g = seg_sum_g(xv, seg[None])  # [K, B, G]
    sum_fdf_g = seg_sum_g(xv_dash * v_g * vvals[None] * vmask[None], seg[None])
    lvg = -2.0 * lr * (sum_f_dash[:, :, None] * sum_f_g - sum_fdf_g)  # [K,B,G]
    dreg_v = _psum(jnp.sum(grad_loss[None, :, None] * lvg, axis=1))  # [K, G]
    reg_v = jnp.maximum(reg_v - lr * scale_l * dreg_v.T, 0.0)
    return reg_w, reg_v


def sgda_epoch(state: SGDAState, row: RowData, val_row: RowData, cfg: FMConfig,
               num_batches: int, attr_group, do_lambda: bool):
    """One SGDA epoch: alternate theta minibatch (train) and lambda minibatch
    (validation), reference ``fm_learn_sgd_element_adapt_reg.h:264-344``."""
    key, k1, k2 = jax.random.split(state.key, 3)
    ids_b, vals_b, y_b, valid_b = _shuffled_batches(k1, row, num_batches)
    vids_b, vvals_b, vy_b, vvalid_b = _shuffled_batches(k2, val_row, num_batches)
    lr = cfg.learn_rate

    def batch_step(carry, xs):
        w0, w, v, reg_w, reg_v, grad_w, grad_v = carry
        ids, vals, y, valid, vids, vvals, vy, vvalid = xs

        # --- theta step on train (adapt_reg.h:123-157; mult = 2*(p-y),
        # reg factor 2*reg) ---
        regw_d = 2.0 * jnp.take(reg_w, attr_group)
        regv_d = 2.0 * jnp.take(reg_v, attr_group, axis=0).T  # [K, D]
        w0, w, v, gw_e, gv_e = sgd_minibatch_update(
            w0, w, v, ids, vals, y, valid, cfg, lr, 2.0 * 0.0,
            regw_d, regv_d, mult_scale=2.0)
        # record last-seen per-attribute gradients (grad_w/grad_v caches);
        # remap pad entries (id 0, val 0) out of range so they are dropped
        # instead of clobbering attribute 0's cached gradient
        D = w.shape[0]
        mask = (vals != 0) & (valid[:, None] > 0)
        ids_sc = jnp.where(mask, ids, D)
        grad_w = grad_w.at[ids_sc].set(gw_e, mode="drop")
        grad_v = grad_v.at[:, ids_sc].set(gv_e, mode="drop")

        if do_lambda:
            # --- lambda step on validation (adapt_reg.h:193-236) ---
            reg_w, reg_v = sgda_lambda_update(
                w0, w, v, reg_w, reg_v, grad_w, grad_v,
                vids, vvals, vy, vvalid, cfg, attr_group)

        return (w0, w, v, reg_w, reg_v, grad_w, grad_v), None

    carry = (state.w0, state.w, state.v, state.reg_w, state.reg_v,
             state.grad_w[0], state.grad_v[0])
    carry, _ = jax.lax.scan(
        batch_step, carry,
        (ids_b, vals_b, y_b, valid_b, vids_b, vvals_b, vy_b, vvalid_b))
    w0, w, v, reg_w, reg_v, grad_w, grad_v = carry
    return SGDAState(w0=w0, w=w, v=v, key=key, reg_w=reg_w, reg_v=reg_v,
                     grad_w=grad_w[None], grad_v=grad_v[None])


# ---------------------------------------------------------------------------
# Learner drivers
# ---------------------------------------------------------------------------

def _row_specs():
    shd = P(DATA_AXIS)
    return RowData(ids=shd, vals=shd, target=shd, valid=shd)


class SGDLearner:
    """Minibatch SGD trainer over a device mesh (method 'sgd')."""

    method = "sgd"

    def __init__(self, cfg: FMConfig, train: SparseDataset, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None, mesh=None,
                 out_dir: str = ".", write_files: bool = True):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        self.train_row, self.train_n = build_row_data(self.mesh, train)
        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.out_dir = out_dir
        self.write_files = write_files
        n_dev = self.mesh.devices.size
        bs = cfg.batch_size if cfg.batch_size > 0 else 1024
        per_shard = self.train_row.ids.shape[0] // n_dev
        self.num_batches = max(1, per_shard // max(1, bs // n_dev))
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        nb = self.num_batches

        def epoch_fn(state, row):
            return sgd_epoch(state, row, cfg, nb)

        rep = P()
        self._epoch = jax.jit(jax.shard_map(
            epoch_fn, mesh=self.mesh,
            in_specs=(SGDState(w0=rep, w=rep, v=rep, key=rep), _row_specs()),
            out_specs=SGDState(w0=rep, w=rep, v=rep, key=rep),
        ))
        self._scores = jax.jit(
            lambda w0, w, v, ids, vals: fm_scores(w0, w, v, ids, vals,
                                                  k0=cfg.k0, k1=cfg.k1))

    def init_state(self, key: Optional[jax.Array] = None) -> SGDState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev)
        state = SGDState(w0=params.w0, w=params.w, v=params.v, key=key)
        from jax.sharding import NamedSharding, PartitionSpec
        rep = NamedSharding(self.mesh, PartitionSpec())
        return jax.device_put(state, SGDState(w0=rep, w=rep, v=rep, key=rep))

    def predict_test_scores(self, state) -> np.ndarray:
        s = self._scores(state.w0, state.w, state.v,
                         self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]

    def _eval_iter(self, state, it, rmse_file, history, verbose, extra=None):
        cfg = self.cfg
        import time as _time
        t0 = _time.perf_counter()
        scores = self.predict_test_scores(state)
        rec = {"iter": it, "time_pred": _time.perf_counter() - t0}
        if extra:
            rec.update(extra)
        if cfg.task == TASK_REGRESSION:
            rmse, mae = evaluate_regression(scores, self.test_target_np,
                                            cfg.min_target, cfg.max_target)
            rmse_file.append(rmse)
            rec.update(rmse=rmse, mae=mae)
            if verbose:
                if "rmse_train" in rec:  # SGDA prints Train= (adapt_reg.h:306)
                    print(f"#Iter={it:3d}\tTrain={rec['rmse_train']:.6g}"
                          f"\tTest={rmse:.6g}")
                else:
                    print(f"#Iter={it:3d}\tTest={rmse:.6g}")
        else:
            prob = 1.0 / (1.0 + np.exp(-scores))
            acc, ll = evaluate_classification(2 * prob - 1 + 1e-12, 2 * (self.test_target_np > 0) - 1.0)
            acc = float(np.mean((scores >= 0) == (self.test_target_np > 0)))
            rmse_file.append(acc)
            rec.update(accuracy=acc)
            if verbose:
                print(f"#Iter={it:3d}\tTest={acc:.6g}")
        history.append(rec)

    def _state_shardings(self, state):
        """Replicated placement for restored states (grad caches sharded in
        SGDA's override)."""
        from jax.sharding import NamedSharding, PartitionSpec
        rep = NamedSharding(self.mesh, PartitionSpec())
        return jax.tree.map(lambda _: rep, state)

    def _ckpt_restore(self, ckpt, state):
        """Returns (state, start_iter); replays nothing by default."""
        restored = ckpt.restore_latest(state)
        if restored is None:
            return state, 0
        blob, it0, _meta = restored
        return jax.device_put(blob, self._state_shardings(blob)), it0

    def _replay_rng(self, epochs: int) -> None:
        """Advance any host-side RNG used per epoch (overridden by the
        streaming learner) so resumed runs reproduce uninterrupted ones."""

    def run(self, state=None, num_iter: Optional[int] = None, verbose: bool = True,
            ckpt=None, ckpt_every: int = 10):
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        it0 = 0
        if ckpt is not None:
            state, it0 = self._ckpt_restore(ckpt, state)
            self._replay_rng(it0)
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                                   self.write_files and it0 == 0)
        history = []
        import time as _time
        for it in range(it0, num_iter):
            t0 = _time.perf_counter()
            state = self._run_epoch(state, it)
            jax.block_until_ready(state)  # informational epoch timing
            self._eval_iter(state, it, rmse_file, history, verbose,
                            extra={"time_learn": _time.perf_counter() - t0})
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, history[-1], state)
            if ckpt is not None and ((it + 1 - it0) % ckpt_every == 0
                                     or it + 1 >= num_iter):
                ckpt.save(jax.tree.map(np.asarray, state), it + 1,
                          {"method": self.method})
        return state, history

    def _run_epoch(self, state, it: int):
        return self._epoch(state, self.train_row)


class SGDALearner(SGDLearner):
    """Adaptive-regularization SGD (method 'sgda', WSDM'12)."""

    method = "sgda"

    def __init__(self, cfg: FMConfig, train: SparseDataset, test: SparseDataset,
                 validation: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh=None, out_dir: str = ".", write_files: bool = True):
        self.validation = validation
        super().__init__(cfg, train, test, meta, mesh, out_dir, write_files)
        self.val_row, self.val_n = build_row_data(self.mesh, validation)
        self._build_sgda_jits()

    def _build_sgda_jits(self):
        cfg = self.cfg
        nb = self.num_batches
        attr_group = jnp.asarray(self.meta.attr_group)
        rep = P()
        sspec = SGDAState(w0=rep, w=rep, v=rep, key=rep, reg_w=rep, reg_v=rep,
                          grad_w=P(DATA_AXIS), grad_v=P(DATA_AXIS))

        def make(do_lambda):
            def epoch_fn(state, row, val_row):
                return sgda_epoch(state, row, val_row, cfg, nb, attr_group,
                                  do_lambda)
            return jax.jit(jax.shard_map(
                epoch_fn, mesh=self.mesh,
                in_specs=(sspec, _row_specs(), _row_specs()),
                out_specs=sspec))

        self._epoch_warm = make(False)  # iter 0: no lambda steps
        self._epoch_full = make(True)

    def init_state(self, key: Optional[jax.Array] = None) -> SGDAState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev)
        G, K, D = cfg.num_groups, cfg.num_factor, cfg.num_attributes
        # SGDA starts from w = 0 and zero regularization (adapt_reg.h:269-281)
        return SGDAState(
            w0=params.w0, w=jnp.zeros((D,), jnp.float32), v=params.v, key=key,
            reg_w=jnp.zeros((G,), jnp.float32),
            reg_v=jnp.zeros((G, K), jnp.float32),
            grad_w=jnp.zeros((self.mesh.devices.size, D), jnp.float32),
            grad_v=jnp.zeros((self.mesh.devices.size, K, D), jnp.float32))

    def _state_shardings(self, state):
        from jax.sharding import NamedSharding, PartitionSpec as PS
        rep = NamedSharding(self.mesh, PS())
        shd = NamedSharding(self.mesh, PS(DATA_AXIS))
        sh = jax.tree.map(lambda _: rep, state)
        return sh.replace(grad_w=shd, grad_v=shd)

    def _run_epoch(self, state, it: int):
        # iter 0 skips the lambda steps (adapt_reg.h warm-up)
        epoch = self._epoch_warm if it == 0 else self._epoch_full
        return epoch(state, self.train_row, self.val_row)

    def _row_scores(self, state, row, n: int) -> np.ndarray:
        s = self._scores(state.w0, state.w, state.v, row.ids, row.vals)
        return np.asarray(s)[:n]

    def _eval_iter(self, state, it, rmse_file, history, verbose, extra=None):
        # the reference evaluates train AND validation every iteration and
        # logs rmse_train/rmse_val (adapt_reg.h:300-341)
        cfg = self.cfg
        ex = dict(extra or {})
        if cfg.task == TASK_REGRESSION:
            for name, row, n in (("rmse_train", self.train_row, self.train_n),
                                 ("rmse_val", self.val_row, self.val_n)):
                scores = self._row_scores(state, row, n)
                target = np.asarray(row.target)[:n]
                ex[name] = evaluate_regression(scores, target, cfg.min_target,
                                               cfg.max_target)[0]
        super()._eval_iter(state, it, rmse_file, history, verbose, extra=ex)


class SGDOnlineLearner(SGDLearner):
    """Streaming SGD over chunked epochs (method 'sgd_online').

    The reference splits the training *file* into ``num_batch`` on-disk
    chunks each epoch and SGD-sweeps each chunk
    (``fm_learn_sgd_online.h:73-131``).  Here the epoch iterates over host
    chunks of the dataset (a callable yielding SparseDatasets — from memory
    or a file reader), ships each chunk to device, and runs the same
    compiled minibatch scan; chunk order is reshuffled every epoch.
    """

    method = "sgd_online"

    def __init__(self, cfg: FMConfig, train: SparseDataset, test: SparseDataset,
                 meta: Optional[DataMetaInfo] = None, mesh=None,
                 out_dir: str = ".", write_files: bool = True):
        super().__init__(cfg, train, test, meta, mesh, out_dir, write_files)
        self.train_ds = train
        self.rng = np.random.default_rng(cfg.seed)

    @classmethod
    def from_reader(cls, cfg, reader, test: SparseDataset, meta=None,
                    mesh=None, out_dir: str = ".", write_files: bool = True):
        """Out-of-core construction from a BinaryChunkReader: only one chunk
        of training data is resident at a time (the reference's disk-chunked
        epochs, fm_learn_sgd_online.h:78-131)."""
        self = cls.__new__(cls)
        first = next(iter(
            __import__("svbfm.data.stream", fromlist=["stream_chunks"])
            .stream_chunks(reader, max(1, cfg.num_batches))))
        SGDLearner.__init__(self, cfg, first, test, meta, mesh, out_dir,
                            write_files)
        self.train_ds = None
        self.reader = reader
        self.rng = np.random.default_rng(cfg.seed)
        return self

    def _chunks(self) -> Iterator[SparseDataset]:
        """Shuffled chunks (fm_learn_sgd_online.h:78-101): row-permutation
        split when in memory; shuffled-order row windows when streaming
        from a binary file reader."""
        nb = max(1, self.cfg.num_batches)
        if getattr(self, "reader", None) is not None:
            from svbfm.data.stream import stream_chunks
            order = self.rng.permutation(min(nb, self.reader.num_rows))
            for ds in stream_chunks(self.reader, len(order), order=order):
                if self.cfg.task == TASK_CLASSIFICATION:  # libfm.cpp:337-350
                    ds.target = np.where(ds.target > 0, 1.0, -1.0).astype(
                        np.float32)
                yield ds
            return
        ds = self.train_ds
        n = ds.num_rows
        perm = self.rng.permutation(n)
        for part in np.array_split(perm, min(nb, max(1, n))):
            yield SparseDataset(
                ids=ds.ids[part], vals=ds.vals[part], target=ds.target[part],
                num_rows=len(part), num_features=ds.num_features,
                min_target=ds.min_target, max_target=ds.max_target,
                row_nnz=ds.row_nnz[part])

    def _replay_rng(self, epochs: int) -> None:
        """Replay the per-epoch chunk-order permutations consumed by
        completed epochs so a resumed run matches an uninterrupted one."""
        nb = max(1, self.cfg.num_batches)
        for _ in range(epochs):
            if getattr(self, "reader", None) is not None:
                self.rng.permutation(min(nb, self.reader.num_rows))
            else:
                self.rng.permutation(self.train_ds.num_rows)

    def _run_epoch(self, state, it: int):
        cfg = self.cfg
        # One compiled epoch fn per chunk shape (chunks padded to equal
        # size).  Single-slot prefetch: a worker reads + ships chunk i+1
        # while the device runs chunk i's sweeps — disk + transfer overlap
        # compute, the dominant cost of out-of-core epochs.  Device
        # residency is bounded at TWO chunks: before dispatching chunk i we
        # block on chunk i-1's output state, so its row buffers are already
        # freed when chunk i+1 starts shipping.  Exceptions on either side
        # propagate (fut.result / the finally) instead of wedging a thread.
        from concurrent.futures import ThreadPoolExecutor

        chunks = self._chunks()

        def fetch():
            try:
                chunk = next(chunks)
            except StopIteration:
                return None
            row, _n = build_row_data(self.mesh, chunk)
            return row

        prefetch = ThreadPoolExecutor(1)
        try:
            fut = prefetch.submit(fetch)
            pending = None  # state whose compute consumes the previous chunk
            while True:
                row = fut.result()
                if row is None:
                    break
                if pending is not None:
                    jax.block_until_ready(pending)
                nb = max(1, row.ids.shape[0] // max(1, (cfg.batch_size or 1024)))
                state = self._chunk_epoch(nb, row.ids.shape[1])(state, row)
                pending = state
                fut = prefetch.submit(fetch)
                del row
        finally:
            prefetch.shutdown(wait=False)
        return state

    def _chunk_epoch(self, nb: int, pad: int):
        key = (nb, pad)
        cache = getattr(self, "_chunk_cache", None)
        if cache is None:
            cache = self._chunk_cache = {}
        if key not in cache:
            cfg = self.cfg
            rep = P()

            def epoch_fn(state, row):
                return sgd_epoch(state, row, cfg, nb)

            cache[key] = jax.jit(jax.shard_map(
                epoch_fn, mesh=self.mesh,
                in_specs=(SGDState(w0=rep, w=rep, v=rep, key=rep), _row_specs()),
                out_specs=SGDState(w0=rep, w=rep, v=rep, key=rep)))
        return cache[key]
