"""Feature-sharded (tensor-parallel) SGD-family training over a
``(data, feature)`` mesh.

The SGD learners keep ``w [D]`` and ``v [K, D]`` replicated per device;
at very large D (the axis OVBFM/KDD-style datasets grow without bound)
those tables wall a chip.  Here they shard over the ``feature`` mesh
axis exactly like :mod:`svbfm.parallel.tp_vb` shards the variational
tables, while minibatch rows shard over ``data``:

* Scores: per-shard partial sums of ``w·x`` and the per-factor ``s_f``;
  one stacked psum over FEATURE before the pairwise square
  (:func:`svbfm.parallel.tp_vb.tp_scores` — the FM analogue of
  tensor-parallel matmul partial sums).
* Gradients: each feature shard scatter-adds ONLY its own columns'
  entries (``gw``/``gv``/``cnt`` local, psum over DATA only — a column
  lives on exactly one shard, so no feature collective is needed for
  the table update).  ``w0``'s scalar update is computed identically on
  every shard from DATA-psum'd sums.

Semantics: identical to the replicated
:func:`svbfm.learners.sgd.sgd_minibatch_update` (same damped
relaxation of the reference's sequential per-example steps,
``fm_sgd.h:33-51`` / ``fm_learn_sgd_element.h:79-85``) up to f32
reassociation of the partial sums — trajectories match the replicated
learner at the same data-shard count (tests/test_tp_sgd.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    ROW_QUANTUM,
    _ROW_QUANTUM_MIN_ROWS,
    FMConfig,
    RowData,
)
from svbfm.learners.sgd import (
    SGDLearner,
    _multiplier,
    _shuffled_batches,
)
from svbfm.models.fm import init_fm_params
from svbfm.ops.segment import take_cols
from svbfm.parallel.mesh import DATA_AXIS, FEATURE_AXIS
from svbfm.parallel.tp_vb import tp_scores
from svbfm.utils.pytree import pytree_dataclass


def _psum_d(x):
    return jax.lax.psum(x, DATA_AXIS)


@pytree_dataclass
class TPSGDState:
    """SGD state with feature-sharded tables (global views [D_pad] /
    [K, D_pad] sharded on the feature axis; w0/key replicated)."""

    w0: jax.Array
    w: jax.Array  # [D_pad] feature-sharded
    v: jax.Array  # [K, D_pad] feature-sharded (last dim)
    key: jax.Array


def _state_specs():
    return TPSGDState(w0=P(), w=P(FEATURE_AXIS), v=P(None, FEATURE_AXIS),
                      key=P())


def _row_specs():
    dsh = P(DATA_AXIS)
    return RowData(ids=dsh, vals=dsh, target=dsh, valid=dsh)


def tp_sgd_minibatch_update(w0, w_l, v_l, ids, vals, y, valid, cfg: FMConfig,
                            lr, reg0, regw_l, regv_l, D_loc):
    """One TP minibatch step (inside shard_map over (data, feature)).

    Mirrors :func:`svbfm.learners.sgd.sgd_minibatch_update` term for
    term; ``w_l``/``v_l``/``regw_l``/``regv_l`` are the local feature
    shard ([D_loc] / [K, D_loc]).  ids are GLOBAL; entries outside the
    shard's [lo, lo+D_loc) range are masked out of the local scatters.
    """
    p = tp_scores(w0, w_l, v_l, ids, vals, D_loc, cfg.k0, cfg.k1)
    mult = _multiplier(p, y, cfg) * valid

    rate = jnp.minimum(lr, 1.0)

    def damp(c):
        return 1.0 - (1.0 - rate) ** c

    if cfg.k0:
        n_eff = _psum_d(jnp.sum(valid))
        g0 = _psum_d(jnp.sum(mult))
        w0 = (w0 * (1.0 - lr * reg0) ** n_eff
              - damp(n_eff) * g0 / jnp.maximum(n_eff, 1.0))

    dtype = vals.dtype
    lo = jax.lax.axis_index(FEATURE_AXIS) * D_loc
    lid = ids - lo
    inr = ((lid >= 0) & (lid < D_loc)).astype(dtype)  # [B, P] ownership
    lidc = jnp.clip(lid, 0, D_loc - 1)

    mask = (vals != 0).astype(dtype) * valid[:, None] * inr
    cnt = _psum_d(jnp.zeros((D_loc,), w_l.dtype).at[lidc].add(mask))
    cnt1 = jnp.maximum(cnt, 1.0)

    grad_w_entries = mult[:, None] * vals * inr
    if cfg.k1:
        gw = _psum_d(jnp.zeros((D_loc,), w_l.dtype).at[lidc]
                     .add(grad_w_entries))
        w_l = (w_l * jnp.maximum(1.0 - lr * regw_l, 0.0) ** cnt
               - damp(cnt) * gw / cnt1)

    K = v_l.shape[0]
    if K:
        vg = take_cols(v_l, lidc) * inr[None]  # [K, B, P] local entries
        s = jax.lax.psum((vg * vals[None]).sum(-1), FEATURE_AXIS)  # [K, B]
        grad_v_entries = mult[None, :, None] * (
            s[:, :, None] * vals[None] - vg * (vals * vals)[None]) * inr[None]
        gv = _psum_d(jnp.zeros((K, D_loc), v_l.dtype).at[:, lidc]
                     .add(grad_v_entries))
        v_l = (v_l * jnp.maximum(1.0 - lr * regv_l, 0.0) ** cnt[None, :]
               - damp(cnt)[None, :] * gv / cnt1[None, :])
    return w0, w_l, v_l


def tp_sgd_epoch(state: TPSGDState, row: RowData, cfg: FMConfig,
                 num_batches: int):
    """One TP SGD epoch = shuffle + scan over minibatches (inside
    shard_map).  The shuffle key folds in the DATA axis index only, so
    every feature shard of a data shard sees the same permutation and
    the batch membership matches the replicated learner at the same
    data-shard count."""
    key, sub = jax.random.split(state.key)
    ids_b, vals_b, y_b, valid_b = _shuffled_batches(sub, row, num_batches)
    D_loc = state.w.shape[0]
    regw_l = jnp.full_like(state.w, cfg.regw)
    regv_l = jnp.full_like(state.v, cfg.regv)

    def batch_step(carry, xs):
        w0, w_l, v_l = carry
        ids, vals, y, valid = xs
        w0, w_l, v_l = tp_sgd_minibatch_update(
            w0, w_l, v_l, ids, vals, y, valid, cfg, cfg.learn_rate,
            cfg.reg0, regw_l, regv_l, D_loc)
        return (w0, w_l, v_l), None

    (w0, w_l, v_l), _ = jax.lax.scan(
        batch_step, (state.w0, state.w, state.v),
        (ids_b, vals_b, y_b, valid_b))
    return TPSGDState(w0=w0, w=w_l, v=v_l, key=key)


class TPSGDLearner(SGDLearner):
    """Minibatch SGD trainer with feature-sharded tables over a
    (data, feature) mesh (``-method sgd -feature_shards N``).

    Inherits the run loop/eval/trajectory files from
    :class:`svbfm.learners.sgd.SGDLearner`; numerics match the
    replicated learner at the same data-shard count."""

    method = "sgd"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh=None, out_dir: str = ".", write_files: bool = False):
        from svbfm.parallel.mesh import make_mesh2d
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh2d(n_feature=1)
        assert self.mesh.axis_names == (DATA_AXIS, FEATURE_AXIS)
        Sd, Sf = self.mesh.devices.shape
        self.Sd, self.Sf = Sd, Sf
        self.meta = (meta if meta is not None
                     else DataMetaInfo(cfg.num_attributes))
        D = cfg.num_attributes
        self.D_loc = -(-D // Sf)
        self.D_pad = self.D_loc * Sf

        def put_row(ds: SparseDataset):
            # pad exactly like base.build_row_data at Sd devices so the
            # per-shard shuffle (and hence the trajectory) matches the
            # replicated learner on a Sd-device data mesh
            if ds.num_rows >= _ROW_QUANTUM_MIN_ROWS:
                ds = ds.padded_to(Sd * ROW_QUANTUM)
            ds = ds.padded_to(Sd)
            valid = (np.arange(ds.ids.shape[0]) < ds.num_rows).astype(
                np.float32)
            dsh = NamedSharding(self.mesh, P(DATA_AXIS))
            return RowData(
                ids=jax.device_put(ds.ids, dsh),
                vals=jax.device_put(ds.vals, dsh),
                target=jax.device_put(ds.target, dsh),
                valid=jax.device_put(valid, dsh)), ds.num_rows

        self.train_row, self.train_n = put_row(train)
        self.test_row, self.test_n = put_row(test)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.out_dir = out_dir
        self.write_files = write_files
        bs = cfg.batch_size if cfg.batch_size > 0 else 1024
        per_shard = self.train_row.ids.shape[0] // Sd
        self.num_batches = max(1, per_shard // max(1, bs // Sd))
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        nb = self.num_batches
        D_loc = self.D_loc

        def epoch_fn(state, row):
            return tp_sgd_epoch(state, row, cfg, nb)

        self._epoch = jax.jit(jax.shard_map(
            epoch_fn, mesh=self.mesh,
            in_specs=(_state_specs(), _row_specs()),
            out_specs=_state_specs(),
        ))

        def fwd(w0, w_l, v_l, ids, vals):
            return tp_scores(w0, w_l, v_l, ids, vals, D_loc, cfg.k0, cfg.k1)

        self._fwd = jax.jit(jax.shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(), P(FEATURE_AXIS), P(None, FEATURE_AXIS),
                      P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=P(DATA_AXIS),
        ))

    def init_state(self, key: Optional[jax.Array] = None) -> TPSGDState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev)

        def padf(a):
            a = np.asarray(a)
            pad = self.D_pad - a.shape[-1]
            if pad <= 0:
                return a
            widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
            return np.pad(a, widths)

        shardings = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                                 _state_specs())
        state = TPSGDState(w0=params.w0, w=padf(params.w), v=padf(params.v),
                           key=key)
        return jax.device_put(state, shardings)

    def predict_test_scores(self, state) -> np.ndarray:
        s = self._fwd(state.w0, state.w, state.v,
                      self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]

    def _state_shardings(self, state):
        return jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                            _state_specs())
