"""Reference-parity RLog schemas and per-iteration streaming.

The reference registers a learner-specific column set up front and streams
one TSV row per iteration:

- base fields (``fm_learn.h:78-95``): rmse/mae (task r) or accuracy
  (task c), time_pred, time_learn, time_learn2, time_learn4;
- the MCMC family (``fm_learn_mcmc.h:1120-1150``, ``fm_learn_vb.h:714-742``,
  ``fm_learn_vb_online.h:765-790``, ``exp_fm_learn_sgd.h:469-498``) adds
  alpha, rmse_mcmc_this/_all (+``_all_but5`` for mcmc/exp) or the
  acc_/ll_ classification variants, then per-group ``wmu[g]``/``wlambda[g]``
  and per-(group,factor) ``vmu[g,f]``/``vlambda[g,f]``;
- SGDA (``fm_learn_sgd_element_adapt_reg.h:85-118``) adds rmse_train,
  rmse_val, wmean, wvar, ``vmean{f}``/``vvar{f}``, ``regw[g]``,
  ``regv[g,f]``.

Values are a documented superset of the reference where our state carries
real numbers the reference leaves NaN (e.g. VB's precision columns — the
reference registers wlambda/vlambda for VB but never logs them; we stream
sigma_w/sigma_v.  Likewise time_pred: the reference only logs it from
``fm_learn.h::evaluate`` (:179,:259), which the MCMC/VB loops never call;
we stream the host-visible eval segment — the blocking metrics fetch of
the fused program whose test eval runs on device — for every learner).
time_learn2/time_learn4 stay NaN (they are CPU-clock duplicates of
time_learn in the reference).
"""

from __future__ import annotations

import numpy as np

from svbfm.learners.base import TASK_REGRESSION

_MCMC_FAMILY = {"mcmc", "vb", "vb_online", "exp_sgd", "exp_sgd_stoc"}
_BUT5 = {"mcmc", "exp_sgd", "exp_sgd_stoc"}  # register *_all_but5 for task r


def register_for(learner, rlog) -> None:
    """Register the reference column set for ``learner`` and write the
    header.  Call once, before ``learner.run``; also sets
    ``learner.rlog = rlog`` so the run loop streams rows."""
    cfg = learner.cfg
    task_r = cfg.task == TASK_REGRESSION
    G, K = cfg.num_groups, cfg.num_factor
    m = learner.method

    # fm_learn.h:78-95
    if task_r:
        rlog.add_field("rmse")
        rlog.add_field("mae")
    else:
        rlog.add_field("accuracy")
    for f in ("time_pred", "time_learn", "time_learn2", "time_learn4"):
        rlog.add_field(f)

    if m in _MCMC_FAMILY:
        rlog.add_field("alpha")
        if task_r:
            rlog.add_field("rmse_mcmc_this")
            rlog.add_field("rmse_mcmc_all")
            if m in _BUT5:
                rlog.add_field("rmse_mcmc_all_but5")
            # held-back remainder eval when num_eval_cases < test rows
            # (documented superset: the reference computes these but its
            # log lines are commented out, fm_learn_mcmc_simultaneous.h:
            # 252-258, fm_learn_vb_simultaneous.h:227-232)
            if getattr(learner, "_rest_valid", None) is not None:
                rlog.add_field("rmse_mcmc_test2_this")
                if m == "mcmc":
                    rlog.add_field("rmse_mcmc_test2_all")
        else:
            rlog.add_field("acc_mcmc_this")
            rlog.add_field("acc_mcmc_all")
            if m in _BUT5:
                rlog.add_field("acc_mcmc_all_but5")
            rlog.add_field("ll_mcmc_this")
            rlog.add_field("ll_mcmc_all")
            rlog.add_field("ll_mcmc_all_but5")
        for g in range(G):
            rlog.add_field(f"wmu[{g}]")
            rlog.add_field(f"wlambda[{g}]")
            for f in range(K):
                rlog.add_field(f"vmu[{g},{f}]")
                rlog.add_field(f"vlambda[{g},{f}]")
    elif m == "sgda":
        rlog.add_field("rmse_train")
        rlog.add_field("rmse_val")
        rlog.add_field("wmean")
        rlog.add_field("wvar")
        for f in range(K):
            rlog.add_field(f"vmean{f}")
            rlog.add_field(f"vvar{f}")
        for g in range(G):
            rlog.add_field(f"regw[{g}]")
            for f in range(K):
                rlog.add_field(f"regv[{g},{f}]")
    # plain sgd/sgd_online: base fields only (fm_learn_sgd_element.h:104-106)

    rlog.init()
    learner.rlog = rlog


def _log_if(rlog, name, value) -> None:
    if value is not None and rlog.has_field(name):
        rlog.log(name, float(value))


def _log_groups(rlog, G, K, wmu=None, wlam=None, vmu=None, vlam=None) -> None:
    """fm_learn_mcmc.h:429-430,503-504 per-iteration hyperparameter dump."""
    for g in range(G):
        if wmu is not None:
            _log_if(rlog, f"wmu[{g}]", wmu[g])
        if wlam is not None:
            _log_if(rlog, f"wlambda[{g}]", wlam[g])
        for f in range(K):
            if vmu is not None:
                _log_if(rlog, f"vmu[{g},{f}]", vmu[g][f])
            if vlam is not None:
                _log_if(rlog, f"vlambda[{g},{f}]", vlam[g][f])


def stream_row(learner, rec, state=None) -> None:
    """Stream one iteration's row from a history record (plus state for the
    learners whose hyperparameters are not in the per-iteration metrics).
    No-op when the learner has no rlog attached."""
    rlog = getattr(learner, "rlog", None)
    if rlog is None:
        return
    cfg = learner.cfg
    G, K = cfg.num_groups, cfg.num_factor
    m = learner.method

    for name in ("rmse", "mae", "accuracy", "time_pred", "time_learn"):
        _log_if(rlog, name, rec.get(name))

    if m in _MCMC_FAMILY:
        alpha = rec.get("alpha")
        if alpha is None and state is not None and hasattr(state, "alpha"):
            alpha = np.asarray(state.alpha)
        _log_if(rlog, "alpha", alpha)
        if cfg.task == TASK_REGRESSION:
            _log_if(rlog, "rmse_mcmc_this", rec.get("rmse_this", rec.get("rmse")))
            _log_if(rlog, "rmse_mcmc_test2_this", rec.get("rmse_test2_this"))
            _log_if(rlog, "rmse_mcmc_test2_all", rec.get("rmse_test2_all"))
            if m == "mcmc":  # posterior-mean accumulators exist
                _log_if(rlog, "rmse_mcmc_all", rec.get("rmse"))
                _log_if(rlog, "rmse_mcmc_all_but5", rec.get("rmse_all_but5"))
        else:
            _log_if(rlog, "acc_mcmc_this", rec.get("acc_this", rec.get("accuracy")))
            _log_if(rlog, "ll_mcmc_this", rec.get("ll_this", rec.get("loglik")))
            if m == "mcmc":
                _log_if(rlog, "acc_mcmc_all", rec.get("accuracy"))
                _log_if(rlog, "ll_mcmc_all", rec.get("loglik"))
        if m == "mcmc":
            _log_groups(rlog, G, K, wmu=rec.get("w_mu"), wlam=rec.get("w_lambda"),
                        vmu=rec.get("v_mu"), vlam=rec.get("v_lambda"))
        else:  # vb / vb_online: precision columns from sigma_w/sigma_v
            sw = rec.get("sigma_w")
            sv = rec.get("sigma_v")
            if sw is None and state is not None and hasattr(state, "sigma_w"):
                sw = np.asarray(state.sigma_w)
            if sv is None and state is not None and hasattr(state, "sigma_v"):
                sv = np.asarray(state.sigma_v)
            _log_groups(rlog, G, K, wlam=sw, vlam=sv)
    elif m == "sgda" and state is not None:
        w = np.asarray(state.w, np.float64)
        v = np.asarray(state.v, np.float64)  # [K, D]
        _log_if(rlog, "wmean", w.mean())
        _log_if(rlog, "wvar", (w * w).mean() - w.mean() ** 2)
        for f in range(K):
            _log_if(rlog, f"vmean{f}", v[f].mean())
            _log_if(rlog, f"vvar{f}", (v[f] * v[f]).mean() - v[f].mean() ** 2)
        reg_w = np.asarray(state.reg_w)
        reg_v = np.asarray(state.reg_v)  # [G, K]
        for g in range(G):
            _log_if(rlog, f"regw[{g}]", reg_w[g])
            for f in range(K):
                _log_if(rlog, f"regv[{g},{f}]", reg_v[g, f])
        _log_if(rlog, "rmse_train", rec.get("rmse_train"))
        _log_if(rlog, "rmse_val", rec.get("rmse_val"))

    rlog.new_line()
