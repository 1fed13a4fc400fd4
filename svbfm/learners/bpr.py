"""Pairwise (BPR-style) SGD for implicit-feedback ranking.

The equivalent of the reference's ``fm_pairSGD``
(``src/fm_core/fm_sgd.h:68-131``) — the one kernel libFM ships but whose
CLI never calls (no learner wraps it).  Exposed here as ``-method bpr``
(documented extension) so the capability is actually reachable.

Reference semantics preserved per pair (x_pos, x_neg):
  - w0 is only regularized (its pairwise gradient cancels; ``fm_sgd.h:61``).
  - per-attribute gradients COMBINE the positive and negative rows'
    contributions and each attribute is stepped ONCE per pair (the
    ``grad_visited`` dedup): an attribute shared by both rows (the user
    one-hot) gets the net gradient, which cancels for w and reduces to
    ``(sum_pos - sum_neg) * x`` for v.
  - step: ``theta -= lr * (mult * grad + reg * theta)``.

The multiplier is the BPR logistic loss -ln sigmoid(d), d = yhat_pos -
yhat_neg: ``mult = -sigmoid(-d)`` (the reference leaves the multiplier to
the caller).  Negatives are sampled uniformly on-device from the item
field each epoch; the serial per-pair loop becomes minibatch pair SGD
under ``shard_map`` with the same per-occurrence regularization damping
as :func:`svbfm.learners.sgd.sgd_minibatch_update`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from svbfm.data.dataset import SparseDataset, detect_field_bins
from svbfm.data.meta import DataMetaInfo
from svbfm.learners.base import (
    FMConfig,
    RowData,
    TrajectoryFile,
    build_row_data,
)
from svbfm.models.fm import init_fm_params
from svbfm.ops.forward import fm_scores
from svbfm.ops.segment import take_cols
from svbfm.parallel.mesh import DATA_AXIS, make_mesh
from svbfm.utils.pytree import pytree_dataclass


def _psum(x):
    return jax.lax.psum(x, DATA_AXIS)


@pytree_dataclass
class BPRState:
    w0: jax.Array
    w: jax.Array  # [D]
    v: jax.Array  # [K, D]
    key: jax.Array


def _pair_scores_sums(w0, w, v, ids, vals, cfg):
    p = fm_scores(w0, w, v, ids, vals, k0=cfg.k0, k1=cfg.k1)
    vg = take_cols(v, ids)  # [K, B, P]
    s = (vg * vals[None]).sum(-1)  # [K, B]
    return p, s, vg


def bpr_pair_update(w0, w, v, ids, vals, ids_n, vals_n, neg_pos_mask, valid,
                    cfg: FMConfig, lr):
    """One minibatch of pairs (inside shard_map).  ``ids_n/vals_n`` is the
    negative row (equal to the positive except at the sampled item
    position); ``neg_pos_mask`` [B, P] marks that position."""
    p_pos, s_pos, vg_pos = _pair_scores_sums(w0, w, v, ids, vals, cfg)
    p_neg, s_neg, vg_neg = _pair_scores_sums(w0, w, v, ids_n, vals_n, cfg)
    d = p_pos - p_neg
    mult = -jax.nn.sigmoid(-d) * valid  # d/dd of -ln sigmoid(d)

    D = w.shape[0]
    n_eff = _psum(jnp.sum(valid))
    if cfg.k0:
        # fm_pairSGD: w0 -= reg0 * w0 per pair (gradient cancels)
        w0 = w0 * jnp.maximum(1.0 - cfg.reg0, 0.0) ** n_eff

    # per-pair occurrence counts with the grad_visited dedup: every
    # positive-row entry counts once; the negative row adds only the
    # sampled item when it differs from the positive one
    touch_pos = (vals != 0).astype(w.dtype) * valid[:, None]
    diff_item = (ids_n != ids).astype(w.dtype) * neg_pos_mask * valid[:, None]
    cnt = _psum(jnp.zeros((D,), w.dtype).at[ids].add(touch_pos)
                .at[ids_n].add(diff_item))
    cnt1 = jnp.maximum(cnt, 1.0)
    rate = jnp.minimum(lr, 1.0)
    damp = (1.0 - (1.0 - rate) ** cnt) / 1.0

    if cfg.k1:
        gw = _psum(jnp.zeros((D,), w.dtype)
                   .at[ids].add(mult[:, None] * vals)
                   .at[ids_n].add(-mult[:, None] * vals_n))
        w = (w * jnp.maximum(1.0 - lr * cfg.regw, 0.0) ** cnt
             - damp * gw / cnt1)

    K = v.shape[0]
    if K > 0:
        ge_pos = mult[None, :, None] * (
            s_pos[:, :, None] * vals[None] - vg_pos * (vals * vals)[None])
        ge_neg = -mult[None, :, None] * (
            s_neg[:, :, None] * vals_n[None]
            - vg_neg * (vals_n * vals_n)[None])
        gv = _psum(jnp.zeros((K, D), v.dtype)
                   .at[:, ids].add(ge_pos).at[:, ids_n].add(ge_neg))
        v = (v * jnp.maximum(1.0 - lr * cfg.regv, 0.0) ** cnt[None, :]
             - damp[None, :] * gv / cnt1[None, :])
    return w0, w, v


class BPRLearner:
    """Implicit-feedback pairwise ranking trainer (``fm_pairSGD``).

    Training rows are the POSITIVE examples (one-hot user + item fields);
    each epoch samples one uniform negative item per row from the item
    field (``neg_field``: field index, default the last field) and runs
    shuffled minibatch pair updates.  Eval reports pairwise ranking
    accuracy P(yhat_pos > yhat_neg) on the test rows against seeded
    negatives (written to the ``test_rmse_*_bpr`` trajectory file)."""

    method = "bpr"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh=None, neg_field: int = -1, out_dir: str = ".",
                 write_files: bool = True):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.meta = meta if meta is not None else DataMetaInfo(
            cfg.num_attributes)
        coo = train.to_coo()
        color = detect_field_bins(coo, cfg.num_attributes)
        if color is None:
            raise ValueError("bpr needs one-hot field data (to sample "
                             "negative items from a field)")
        fields = int(color.max()) + 1
        f = fields + neg_field if neg_field < 0 else neg_field
        in_f = np.where(color == f)[0]
        self.neg_lo, self.neg_hi = int(in_f.min()), int(in_f.max()) + 1
        self.train_row, self.train_n = build_row_data(self.mesh, train)
        self.test_row, self.test_n = build_row_data(self.mesh, test)
        self.out_dir = out_dir
        self.write_files = write_files
        self._build_jits()

    def _build_jits(self):
        cfg = self.cfg
        lo, hi = self.neg_lo, self.neg_hi
        nb = max(1, cfg.num_batches)

        def negate(key, ids, vals):
            # replace the neg-field position's id with a uniform item
            mask = (ids >= lo) & (ids < hi)  # [B, P]
            neg = jax.random.randint(key, (ids.shape[0],), lo, hi)
            ids_n = jnp.where(mask, neg[:, None], ids)
            return ids_n, vals, mask.astype(vals.dtype)

        def epoch(state, row):
            key, kperm, kneg = jax.random.split(state.key, 3)
            n_loc = row.ids.shape[0]
            kperm = jax.random.fold_in(kperm, jax.lax.axis_index(DATA_AXIS))
            kneg = jax.random.fold_in(kneg, jax.lax.axis_index(DATA_AXIS))
            perm = jax.random.permutation(kperm, n_loc)
            bl = max(1, n_loc // nb)
            take = bl * nb
            ids = row.ids[perm[:take]].reshape(nb, bl, -1)
            vals = row.vals[perm[:take]].reshape(nb, bl, -1)
            valid = row.valid[perm[:take]].reshape(nb, bl)
            negs = jax.random.split(kneg, nb)

            def step(carry, xs):
                w0, w, v = carry
                ids_b, vals_b, valid_b, kb = xs
                ids_n, vals_n, mask = negate(kb, ids_b, vals_b)
                w0, w, v = bpr_pair_update(
                    w0, w, v, ids_b, vals_b, ids_n, vals_n, mask, valid_b,
                    cfg, cfg.learn_rate)
                return (w0, w, v), None

            (w0, w, v), _ = jax.lax.scan(
                step, (state.w0, state.w, state.v),
                (ids, vals, valid, negs))
            return BPRState(w0=w0, w=w, v=v, key=key)

        def eval_pairs(state, trow, kneg):
            kneg = jax.random.fold_in(kneg, jax.lax.axis_index(DATA_AXIS))
            ids_n, vals_n, _ = negate(kneg, trow.ids, trow.vals)
            p_pos = fm_scores(state.w0, state.w, state.v, trow.ids,
                              trow.vals, k0=cfg.k0, k1=cfg.k1)
            p_neg = fm_scores(state.w0, state.w, state.v, ids_n, vals_n,
                              k0=cfg.k0, k1=cfg.k1)
            hits = _psum(jnp.sum((p_pos > p_neg) * trow.valid))
            loss = _psum(jnp.sum(-jnp.log(
                jax.nn.sigmoid(p_pos - p_neg) + 1e-12) * trow.valid))
            nt = jnp.asarray(float(self.test_n), p_pos.dtype)
            return hits / nt, loss / nt

        sspec = BPRState(w0=P(), w=P(), v=P(), key=P())
        rspec = RowData(ids=P(DATA_AXIS), vals=P(DATA_AXIS),
                        target=P(DATA_AXIS), valid=P(DATA_AXIS))
        self._epoch = jax.jit(jax.shard_map(
            epoch, mesh=self.mesh, in_specs=(sspec, rspec),
            out_specs=sspec))
        self._eval = jax.jit(jax.shard_map(
            eval_pairs, mesh=self.mesh, in_specs=(sspec, rspec, P()),
            out_specs=(P(), P())))

    def init_state(self, key: Optional[jax.Array] = None) -> BPRState:
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        key, kinit = jax.random.split(key)
        params = init_fm_params(kinit, cfg.num_attributes, cfg.num_factor,
                                init_stdev=cfg.init_stdev,
                                init_w_normal=False)
        return BPRState(w0=params.w0, w=params.w, v=params.v, key=key)

    def run(self, state: Optional[BPRState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            chunk=None, ckpt=None, ckpt_every: int = 10):
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        traj = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                              self.write_files)
        history = []
        keval = jax.random.PRNGKey(cfg.seed + 17)  # fixed eval negatives
        import time as _time
        for it in range(num_iter):
            t0 = _time.perf_counter()
            state = self._epoch(state, self.train_row)
            acc, loss = self._eval(state, self.test_row, keval)
            acc, loss = float(acc), float(loss)
            rec = {"iter": it, "accuracy": acc, "pair_loss": loss,
                   "time_learn": _time.perf_counter() - t0,
                   "time_pred": 0.0}
            traj.append(acc)
            if verbose:
                print(f"#Iter={it:3d}\tPairAcc={acc:.6g}\tLoss={loss:.6g}")
            from svbfm.utils.rlog_schema import stream_row
            stream_row(self, rec)
            history.append(rec)
        return state, history

    def predict_test_scores(self, state: BPRState) -> np.ndarray:
        s = jax.jit(lambda st, ids, vals: fm_scores(
            st.w0, st.w, st.v, ids, vals, k0=self.cfg.k0,
            k1=self.cfg.k1))(state, self.test_row.ids, self.test_row.vals)
        return np.asarray(s)[: self.test_n]
