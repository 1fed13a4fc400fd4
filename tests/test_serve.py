"""Serving path (svbfm.serve.BatchScorer).

The reference serves one row at a time through fm_model::predict
(fm_model.h:103-130); here a fixed-shape compiled program scores padded
batches.  These tests pin the scorer to the learners' own predict paths.
"""

import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import (FMConfig, TASK_CLASSIFICATION)
from svbfm.parallel.mesh import make_mesh
from svbfm.serve import BatchScorer


def _trained(task=0):
    from svbfm.learners.mcmc import ALSLearner
    coo = make_movielens_like(num_users=40, num_items=25, num_ratings=1500,
                              rank=2, noise=0.3, seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 40])
    cfg = FMConfig(num_attributes=D, num_factor=4, num_groups=2, seed=5,
                   task=task, min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()))
    if task == TASK_CLASSIFICATION:
        thr = float(np.median(tr.target))
        tr.target = np.where(tr.target >= thr, 1.0, -1.0).astype(np.float32)
        te.target = np.where(te.target >= thr, 1.0, -1.0).astype(np.float32)
    l = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                   SparseDataset.from_coo(te, D), meta, mesh=make_mesh(2),
                   write_files=False)
    state, _ = l.run(num_iter=3, verbose=False)
    return l, state, cfg, te, D


def test_scorer_matches_learner_predictions():
    l, state, cfg, te, D = _trained()
    scorer = BatchScorer.from_state(state, cfg, mesh=make_mesh(2))
    got = scorer.score_coo(te)
    want = np.clip(l.predict_test_scores(state), cfg.min_target,
                   cfg.max_target)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_scorer_batching_and_inflight_window():
    """Small batch_rows forces many batches through the bounded in-flight
    window; results must be identical to one-shot scoring."""
    l, state, cfg, te, D = _trained()
    one = BatchScorer.from_state(state, cfg, mesh=make_mesh(2))
    many = BatchScorer.from_state(state, cfg, mesh=make_mesh(2),
                                  batch_rows=64, inflight=2)
    np.testing.assert_allclose(many.score_coo(te), one.score_coo(te),
                               rtol=1e-6, atol=1e-7)


def test_scorer_classification_probit():
    from svbfm.learners.base import ref_cdf_gaussian
    import jax.numpy as jnp
    l, state, cfg, te, D = _trained(task=TASK_CLASSIFICATION)
    scorer = BatchScorer.from_state(state, cfg, mesh=make_mesh(2))
    got = scorer.score_coo(te)
    raw = l.predict_test_scores(state)
    want = np.asarray(ref_cdf_gaussian(jnp.asarray(raw)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got >= 0).all() and (got <= 1).all()


def test_scorer_feature_sharded_matches_replicated():
    l, state, cfg, te, D = _trained()
    rep = BatchScorer.from_state(state, cfg, mesh=make_mesh(2))
    tp = BatchScorer.from_state(state, cfg, mesh=make_mesh(4),
                                feature_sharded=True, batch_rows=128)
    np.testing.assert_allclose(tp.score_coo(te), rep.score_coo(te),
                               rtol=1e-5, atol=1e-6)


def test_scorer_row_pad_and_empty():
    l, state, cfg, te, D = _trained()
    s = BatchScorer.from_state(state, cfg, mesh=make_mesh(2), row_pad=6)
    got = s.score_coo(te)
    assert got.shape == (te.num_rows,)
    # rows wider than row_pad are rejected
    with pytest.raises(ValueError):
        s.score_rows(np.zeros((4, 9), np.int32), np.zeros((4, 9), np.float32))


def test_scorer_inflight_bound(monkeypatch):
    """At most `inflight` batches are dispatched-but-unfetched at any time
    (the docstring's bound; drain happens BEFORE each dispatch)."""
    sc = BatchScorer(0.0, np.zeros(10, np.float32),
                     np.zeros((2, 10), np.float32), batch_rows=4,
                     inflight=2, mesh=make_mesh(1))
    events = []
    counter = [0]

    class FakeRes:
        def __init__(self, i, n):
            self.i, self.n = i, n

        def __array__(self, dtype=None, copy=None):
            events.append(("drain", self.i))
            return np.zeros(self.n, np.float32)

    def fake_scorer(P_row):
        def fn(w0, w, v, bi, bv):
            i = counter[0]
            counter[0] += 1
            events.append(("dispatch", i))
            return FakeRes(i, bi.shape[0])
        return fn

    monkeypatch.setattr(sc, "_scorer", fake_scorer)
    ids = np.zeros((20, 1), np.int32)
    vals = np.ones((20, 1), np.float32)
    out = sc.score_rows(ids, vals)
    assert out.shape == (20,)
    outstanding = 0
    for ev, _ in events:
        outstanding += 1 if ev == "dispatch" else -1
        assert 0 <= outstanding <= 2
    # drains happen in dispatch order
    drains = [i for ev, i in events if ev == "drain"]
    assert drains == sorted(drains) and len(drains) == counter[0] == 5
