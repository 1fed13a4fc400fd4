"""Production batch scoring (serving) for trained FM models.

The reference's serving path is ``fm_learn::predict`` calling
``fm_model::predict`` one row at a time (``fm_model.h:103-130``; the
``-out`` dump at ``libfm.cpp:514-519``) — a pointer-chasing scalar loop.
The design here is a **fixed-shape compiled scoring program** over the
padded row layout:

- rows shard over the ``(data,)`` mesh axis; parameters replicate (the
  default, right up to D*K tables that fit one device), or
- parameters shard over the feature axis (``parallel/tp.py``) for models
  whose tables outgrow one device's HBM — pass ``feature_sharded=True``.

Batches are dispatched asynchronously with a bounded in-flight window, so
host→device transfer of batch k+1 overlaps scoring of batch k, and results
are fetched with one ``device_get`` per batch.

Output-space transforms ride inside the compiled program, matching the
reference's final-prediction semantics: regression scores clamp to
``[min_target, max_target]`` (``fm_learn_sgd.h:74-77``), classification
scores map through the probit link Φ(s) (``fm_learn_mcmc.h:367-375``
uses the accumulated posterior mean for its own test set; for *new* data
the reference, like us, can only score the current parameters).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svbfm.data.libfm_text import COOData
from svbfm.learners.base import (TASK_CLASSIFICATION, TASK_REGRESSION,
                                 ref_cdf_gaussian)
from svbfm.ops.forward import fm_scores
from svbfm.parallel.mesh import DATA_AXIS, make_mesh


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class BatchScorer:
    """Compiled fixed-shape FM batch scorer.

    Parameters are device-put once at construction; every ``score_*`` call
    reuses the same compiled program per (batch_rows, row_pad) shape, so the
    steady-state cost is one input transfer + one fused gather pass per
    batch.

    Args:
      w0, w, v: trained parameters (scalars/[D]/[K, D]; any learner's
        point estimate — ``state.w0/w/v`` or VB's ``mu_w``-family means).
      task: TASK_REGRESSION (clamped scores) or TASK_CLASSIFICATION
        (probit probabilities).
      min_target/max_target: regression clamp range (reference semantics).
      batch_rows: rows per compiled call; inputs are cut into batches of
        exactly this many rows (last batch zero-padded).
      row_pad: fixed nnz-per-row padding width; ``None`` sizes it from each
        input (one compiled program per distinct width).
      mesh: optional ``jax.sharding.Mesh``; defaults to all local devices.
      feature_sharded: shard w/V over the feature axis instead of
        replicating (for D*K beyond one device's HBM); rows then replicate
        per call (``parallel/tp.py``).
      inflight: max dispatched-but-unfetched batches (bounds device memory
        while still overlapping transfer with compute).
    """

    def __init__(self, w0, w, v, *, k0: bool = True, k1: bool = True,
                 task: int = TASK_REGRESSION,
                 min_target: float = -np.inf, max_target: float = np.inf,
                 batch_rows: int = 1 << 20, row_pad: Optional[int] = None,
                 mesh: Optional[Mesh] = None, feature_sharded: bool = False,
                 inflight: int = 2):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.k0, self.k1 = bool(k0), bool(k1)
        self.task = task
        self.min_target, self.max_target = float(min_target), float(max_target)
        self.n_dev = int(np.prod(self.mesh.devices.shape))
        self.batch_rows = _ceil_to(batch_rows, self.n_dev)
        self.row_pad = row_pad
        self.inflight = max(1, inflight)
        self.feature_sharded = feature_sharded
        w0 = jnp.asarray(w0, jnp.float32)
        w = jnp.asarray(w, jnp.float32)
        v = jnp.asarray(v, jnp.float32)
        self.num_factor = int(v.shape[0])
        if feature_sharded:
            from svbfm.parallel.tp import (pad_feature_dim,
                                           shard_params_by_feature)
            d_pad = _ceil_to(max(int(w.shape[0]), 1), self.n_dev)
            self._D = d_pad
            self.w0, self.w, self.v = shard_params_by_feature(
                self.mesh, w0, pad_feature_dim(np.asarray(w), d_pad),
                pad_feature_dim(np.asarray(v), d_pad))
        else:
            rep = NamedSharding(self.mesh, P())
            self._D = int(w.shape[0])
            self.w0 = jax.device_put(w0, rep)
            self.w = jax.device_put(w, rep)
            self.v = jax.device_put(v, rep)
        self._fns = {}

    @classmethod
    def from_state(cls, state, cfg, **kw):
        """Build from a learner state + its FMConfig.  Uses the state's
        point parameters: ``w0/w/v`` for SGD/MCMC/exp states, the
        variational means ``mu_0/mu_w/mu_v`` for VB/OVB states."""
        get = lambda *names: next(getattr(state, n) for n in names
                                  if hasattr(state, n))
        kw.setdefault("k0", cfg.k0)
        kw.setdefault("k1", cfg.k1)
        kw.setdefault("task", cfg.task)
        kw.setdefault("min_target", cfg.min_target)
        kw.setdefault("max_target", cfg.max_target)
        return cls(get("w0", "mu_0"), get("w", "mu_w"), get("v", "mu_v"),
                   **kw)

    # ------------------------------------------------------------------

    def _scorer(self, P_row: int):
        key = P_row
        if key in self._fns:
            return self._fns[key]
        if self.feature_sharded:
            from svbfm.parallel.tp import make_tp_scorer
            base, _ = make_tp_scorer(self.mesh, self._D, k0=self.k0,
                                     k1=self.k1)

            def fn(w0, w, v, ids, vals):
                return self._transform(base(w0, w, v, ids, vals))
            self._fns[key] = jax.jit(fn)
        else:
            def scorefn(w0, w, v, ids, vals):
                return self._transform(
                    fm_scores(w0, w, v, ids, vals, k0=self.k0, k1=self.k1))
            shd = P(DATA_AXIS)
            self._fns[key] = jax.jit(jax.shard_map(
                scorefn, mesh=self.mesh,
                in_specs=(P(), P(), P(), shd, shd), out_specs=shd))
        return self._fns[key]

    def _transform(self, s):
        if self.task == TASK_CLASSIFICATION:
            return ref_cdf_gaussian(s)
        lo, hi = self.min_target, self.max_target
        if np.isfinite(lo):
            s = jnp.maximum(s, lo)
        if np.isfinite(hi):
            s = jnp.minimum(s, hi)
        return s

    def _batches(self, ids: np.ndarray, vals: np.ndarray):
        """Cut [N, P] inputs into fixed [batch_rows, row_pad] batches."""
        N, P_in = ids.shape
        P_row = self.row_pad if self.row_pad is not None else max(P_in, 1)
        if P_in > P_row:
            raise ValueError(f"rows have {P_in} nnz > row_pad={P_row}")
        B = self.batch_rows
        for lo in range(0, max(N, 1), B):
            n = min(B, N - lo) if N else 0
            bi = np.zeros((B, P_row), np.int32)
            bv = np.zeros((B, P_row), np.float32)
            bi[:n, :P_in] = ids[lo:lo + n]
            bv[:n, :P_in] = vals[lo:lo + n]
            yield bi, bv, n

    def score_rows(self, ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """Score padded rows ids/vals [N, P] -> predictions [N] (numpy).

        Dispatches up to ``inflight`` batches before fetching, overlapping
        host→device transfer and compute with the result round-trips."""
        ids = np.ascontiguousarray(ids, np.int32)
        vals = np.ascontiguousarray(vals, np.float32)
        N = ids.shape[0]
        fn = self._scorer(self.row_pad or max(ids.shape[1], 1))
        out = np.empty((N,), np.float32)
        window = []  # (device result, lo, n)
        lo = 0

        def drain(slot):
            res, start, n = slot
            out[start:start + n] = np.asarray(res)[:n]

        for bi, bv, n in self._batches(ids, vals):
            # drain BEFORE dispatching so at most `inflight` batches are
            # ever dispatched-but-unfetched (the documented bound)
            if len(window) >= self.inflight:
                drain(window.pop(0))
            res = fn(self.w0, self.w, self.v, bi, bv)  # async dispatch
            window.append((res, lo, n))
            lo += n
        for slot in window:
            drain(slot)
        return out[:N]

    def score_coo(self, coo: COOData) -> np.ndarray:
        """Score a COO dataset (pads rows to its max nnz)."""
        from svbfm.data.dataset import SparseDataset
        ds = SparseDataset.from_coo(coo, self._D if not self.feature_sharded
                                    else coo.num_features)
        return self.score_rows(ds.ids[: coo.num_rows],
                               ds.vals[: coo.num_rows])
