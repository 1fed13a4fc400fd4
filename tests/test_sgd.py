import numpy as np
import pytest

from svbfm.data.dataset import SparseDataset
from svbfm.data.meta import DataMetaInfo
from svbfm.data.synth import make_movielens_like, train_test_split
from svbfm.learners.base import FMConfig, TASK_CLASSIFICATION
from svbfm.learners.sgd import SGDALearner, SGDLearner, SGDOnlineLearner
from svbfm.parallel.mesh import make_mesh


def _setup(num_rows=2000, num_users=30, num_items=25, K=4, n_dev=1, seed=3,
           task=0, **cfg_kw):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    if task == TASK_CLASSIFICATION:
        thresh = np.median(tr.target)
        tr.target = np.where(tr.target > thresh, 1.0, -1.0).astype(np.float32)
        te.target = np.where(te.target > thresh, 1.0, -1.0).astype(np.float32)
    cfg = FMConfig(num_attributes=D, num_factor=K, task=task,
                   min_target=float(tr.target.min()), max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, learn_rate=0.05,
                   regw=0.01, regv=0.01, batch_size=128, **cfg_kw)
    mesh = make_mesh(n_dev)
    return (SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            cfg, meta, mesh, tr, te)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sgd_regression_converges(n_dev):
    tr_ds, te_ds, cfg, meta, mesh, tr, te = _setup(n_dev=n_dev)
    learner = SGDLearner(cfg, tr_ds, te_ds, meta, mesh=mesh, write_files=False)
    state, history = learner.run(num_iter=15, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0


def test_sgd_classification_learns():
    tr_ds, te_ds, cfg, meta, mesh, tr, te = _setup(task=TASK_CLASSIFICATION,
                                                   num_rows=3000)
    learner = SGDLearner(cfg, tr_ds, te_ds, meta, mesh=mesh, write_files=False)
    state, history = learner.run(num_iter=15, verbose=False)
    assert history[-1]["accuracy"] > 0.6


def test_sgd_sharding_invariance():
    tr_ds, te_ds, cfg, meta, mesh1, *_ = _setup(n_dev=1, num_rows=512)
    *_ignore, mesh8 = _setup(n_dev=8, num_rows=512)[:5] + (make_mesh(8),)
    l1 = SGDLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(1), write_files=False)
    l8 = SGDLearner(cfg, tr_ds, te_ds, meta, mesh=make_mesh(8), write_files=False)
    s1, h1 = l1.run(num_iter=3, verbose=False)
    s8, h8 = l8.run(num_iter=3, verbose=False)
    # different shard-local shuffles -> not bitwise equal, but same
    # optimization trajectory statistically
    assert abs(h1[-1]["rmse"] - h8[-1]["rmse"]) < 0.08


def test_sgda_adapts_regularization():
    tr_ds, te_ds, cfg, meta, mesh, tr, te = _setup(num_rows=3000)
    # carve validation out of train
    val_ds = SparseDataset(
        ids=tr_ds.ids[:400], vals=tr_ds.vals[:400], target=tr_ds.target[:400],
        num_rows=400, num_features=tr_ds.num_features,
        min_target=tr_ds.min_target, max_target=tr_ds.max_target,
        row_nnz=tr_ds.row_nnz[:400])
    learner = SGDALearner(cfg, tr_ds, te_ds, val_ds, meta, mesh=mesh,
                          write_files=False)
    state, history = learner.run(num_iter=10, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    # regs were adapted away from 0 at some point
    assert np.all(np.asarray(state.reg_w) >= 0)


def test_sgd_online_matches_sgd_quality():
    tr_ds, te_ds, cfg, meta, mesh, tr, te = _setup(num_rows=3000)
    import dataclasses
    cfg_o = dataclasses.replace(cfg, num_batches=4)
    learner = SGDOnlineLearner(cfg_o, tr_ds, te_ds, meta, mesh=mesh,
                               write_files=False)
    state, history = learner.run(num_iter=10, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0


def test_sgda_steps_match_oracle():
    """Per-example theta+lambda steps vs the float64 SGDAOracle
    (adapt_reg.h:123-236): at batch size 1 the damped minibatch kernel and
    the lambda step reduce exactly to the reference per-example updates."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from oracle import SGDAOracle
    from svbfm.learners.sgd import sgd_minibatch_update, sgda_lambda_update
    from svbfm.models.fm import init_fm_params

    coo = make_movielens_like(num_users=8, num_items=6, num_ratings=80,
                              rank=2, noise=0.4, seed=5)
    tr, va = train_test_split(coo, 0.4, seed=6)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 8])
    G, K = meta.num_attr_groups, 3
    lr = 0.05
    cfg = FMConfig(num_attributes=D, num_factor=K, task=0,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=G, learn_rate=lr)
    mesh = make_mesh(1)
    attr_group = jnp.asarray(meta.attr_group)

    params = init_fm_params(jax.random.PRNGKey(1), D, K, init_stdev=0.1)
    w0, w, v = float(params.w0), np.zeros(D, np.float32), np.asarray(params.v)
    orc = SGDAOracle(D, K, G, meta.attr_group, lr, cfg.min_target,
                     cfg.max_target)
    orc.init(w0, w, v)

    rep = P()
    specs = (rep,) * 7 + (rep,) * 6

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=specs, out_specs=(rep,) * 7)
    def step(w0, w, v, reg_w, reg_v, grad_w, grad_v, ids, vals, y,
             vids, vvals, vy):
        valid = jnp.ones(y.shape, vals.dtype)
        regw_d = 2.0 * jnp.take(reg_w, attr_group)
        regv_d = 2.0 * jnp.take(reg_v, attr_group, axis=0).T
        w0, w, v, gw_e, gv_e = sgd_minibatch_update(
            w0, w, v, ids, vals, y, valid, cfg, lr, 0.0, regw_d, regv_d,
            mult_scale=2.0)
        mask = vals != 0
        ids_sc = jnp.where(mask, ids, D)
        grad_w = grad_w.at[ids_sc].set(gw_e, mode="drop")
        grad_v = grad_v.at[:, ids_sc].set(gv_e, mode="drop")
        reg_w, reg_v = sgda_lambda_update(
            w0, w, v, reg_w, reg_v, grad_w, grad_v, vids, vvals, vy, valid,
            cfg, attr_group)
        return w0, w, v, reg_w, reg_v, grad_w, grad_v

    def row_of(coo_sub, i):
        sel = coo_sub.row == i
        return coo_sub.col[sel].astype(np.int32), \
            coo_sub.val[sel].astype(np.float32)

    carry = (jnp.asarray(w0), jnp.asarray(w), jnp.asarray(v),
             jnp.zeros((G,), jnp.float32), jnp.zeros((G, K), jnp.float32),
             jnp.zeros((D,), jnp.float32), jnp.zeros((K, D), jnp.float32))
    n_steps = min(12, tr.num_rows, va.num_rows)
    for i in range(n_steps):
        ti, tx = row_of(tr, i)
        vi, vx = row_of(va, i)
        carry = step(*carry, ti[None], tx[None],
                     jnp.asarray(tr.target[i:i + 1]),
                     vi[None], vx[None], jnp.asarray(va.target[i:i + 1]))
        orc.theta_step(ti, tx, float(tr.target[i]))
        orc.lambda_step(vi, vx, float(va.target[i]))

    w0_j, w_j, v_j, reg_w_j, reg_v_j, grad_w_j, grad_v_j = \
        [np.asarray(a) for a in carry]
    np.testing.assert_allclose(w0_j, orc.w0, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(w_j, orc.w, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(v_j, orc.v, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(reg_w_j, orc.reg_w, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(reg_v_j, orc.reg_v, rtol=2e-3, atol=1e-7)
    # the adapted regs must have actually moved off zero at least once
    assert float(np.abs(reg_v_j).sum()) + float(np.abs(reg_w_j).sum()) > 0
