"""Serial float64 NumPy oracles for the coordinate-sweep learners.

Straightforward (slow) implementations of the update equations, written
directly from the math: Gauss-Seidel column order 0..D-1, incremental
residual maintenance.  Used to validate that the binned sweeps are
exactly equivalent on conflict-free data.
"""

from __future__ import annotations

import numpy as np


class SparseCols:
    """CSC view: for each column, (row indices, values)."""

    def __init__(self, row, col, val, num_rows, num_cols):
        order = np.argsort(col, kind="stable")
        self.r = row[order]
        self.x = val[order].astype(np.float64)
        counts = np.bincount(col, minlength=num_cols)
        self.ptr = np.zeros(num_cols + 1, dtype=np.int64)
        np.cumsum(counts, out=self.ptr[1:])
        self.num_rows = num_rows
        self.num_cols = num_cols

    def col(self, i):
        lo, hi = self.ptr[i], self.ptr[i + 1]
        return self.r[lo:hi], self.x[lo:hi]


def fm_scores_dense(w0, w, v, row, col, val, num_rows):
    """Pairwise-trick forward, per-row, float64."""
    K = v.shape[0]
    lin = np.full(num_rows, w0, dtype=np.float64)
    np.add.at(lin, row, w[col] * val)
    for f in range(K):
        s = np.zeros(num_rows)
        s2 = np.zeros(num_rows)
        np.add.at(s, row, v[f, col] * val)
        np.add.at(s2, row, (v[f, col] * val) ** 2)
        lin += 0.5 * (s * s - s2)
    return lin


def t_terms_dense(sigma_0_dash, sigma_w_dash, mu_v, sigma_v_dash, row, col, val, num_rows):
    K = mu_v.shape[0]
    x2 = val.astype(np.float64) ** 2
    t = np.full(num_rows, sigma_0_dash, dtype=np.float64)
    np.add.at(t, row, sigma_w_dash[col] * x2)
    for f in range(K):
        q2 = np.zeros(num_rows)
        z = np.zeros(num_rows)
        neg = np.zeros(num_rows)
        np.add.at(q2, row, (mu_v[f, col] * val) ** 2)
        np.add.at(z, row, sigma_v_dash[f, col] * x2)
        np.add.at(neg, row, mu_v[f, col] ** 2 * x2 * x2 * sigma_v_dash[f, col]
                  + 0.5 * x2 * x2 * sigma_v_dash[f, col] ** 2)
        t += 0.5 * z * z + z * q2 - neg
    return t


class VBOracle:
    """Batch VBFM, serial Gauss-Seidel, float64."""

    def __init__(self, row, col, val, y, D, K, groups=None, k0=True, k1=True):
        self.N = len(y)
        self.D, self.K = D, K
        self.k0, self.k1 = k0, k1
        self.row, self.col, self.val = row, col, val.astype(np.float64)
        self.y = y.astype(np.float64)
        self.cols = SparseCols(row, col, val, self.N, D)
        self.groups = groups if groups is not None else np.zeros(D, dtype=np.int32)
        self.G = int(self.groups.max()) + 1
        self.gcount = np.bincount(self.groups, minlength=self.G).astype(np.float64)

    def init(self, mu_0, sigma_0_dash, mu_w, sigma_w_dash, mu_v, sigma_v_dash):
        self.mu_0 = float(mu_0)
        self.sigma_0_dash = float(sigma_0_dash)
        self.mu_w = mu_w.astype(np.float64).copy()
        self.sigma_w_dash = sigma_w_dash.astype(np.float64).copy()
        self.mu_v = mu_v.astype(np.float64).copy()
        self.sigma_v_dash = sigma_v_dash.astype(np.float64).copy()
        self.alpha = 1.0
        self.sigma_0 = 1.0
        self.sigma_w = np.ones(self.G)
        self.sigma_v = np.ones((self.G, self.K))
        yhat = fm_scores_dense(self.mu_0 if self.k0 else 0.0,
                               self.mu_w if self.k1 else np.zeros(self.D),
                               self.mu_v, self.row, self.col, self.val, self.N)
        self.e = self.y - yhat
        self.t = t_terms_dense(self.sigma_0_dash if self.k0 else 0.0,
                               self.sigma_w_dash if self.k1 else np.zeros(self.D),
                               self.mu_v, self.sigma_v_dash,
                               self.row, self.col, self.val, self.N)

    def iterate(self):
        N, alpha = self.N, self.alpha
        # w0
        if self.k0:
            sig_old = self.sigma_0_dash
            self.sigma_0_dash = 1.0 / (self.sigma_0 + N * alpha)
            w0_temp = np.sum(self.e + self.mu_0)
            mu_new = self.sigma_0_dash * alpha * w0_temp
            self.e += self.mu_0 - mu_new
            self.t += self.sigma_0_dash - sig_old
            self.mu_0 = mu_new
        # w sweep
        if self.k1:
            for i in range(self.D):
                r, x = self.cols.col(i)
                if len(r) == 0:
                    self.sigma_w_dash[i] = 1.0 / self.sigma_w[self.groups[i]]
                    self.mu_w[i] = 0.0
                    continue
                mu_old, sig_old = self.mu_w[i], self.sigma_w_dash[i]
                w_mean = np.sum(x * (self.e[r] + x * mu_old))
                sx2 = np.sum(x * x)
                sig = 1.0 / (self.sigma_w[self.groups[i]] + alpha * sx2)
                mu = sig * alpha * w_mean
                self.sigma_w_dash[i], self.mu_w[i] = sig, mu
                self.e[r] += x * (mu_old - mu)
                self.t[r] += x * x * (sig - sig_old)
        # v sweeps
        for f in range(self.K):
            q = np.zeros(N)
            tq = np.zeros(N)
            tz = np.zeros(N)
            np.add.at(q, self.row, self.mu_v[f, self.col] * self.val)
            np.add.at(tq, self.row, self.sigma_v_dash[f, self.col] * self.val ** 2)
            np.add.at(tz, self.row, self.mu_v[f, self.col] ** 2 * self.val ** 2)
            for i in range(self.D):
                r, x = self.cols.col(i)
                g = self.groups[i]
                if len(r) == 0:
                    self.sigma_v_dash[f, i] = 1.0 / self.sigma_v[g, f]
                    self.mu_v[f, i] = 0.0
                    continue
                mu_old, sig_old = self.mu_v[f, i], self.sigma_v_dash[f, i]
                h = q[r] - x * mu_old
                h1 = tq[r] - x * x * sig_old
                v_mean = np.sum(x * h * (self.e[r] + x * mu_old * h))
                v_sig = np.sum(x * x * h * h + x * x * h1)
                sig = 1.0 / (self.sigma_v[g, f] + alpha * v_sig)
                mu = sig * alpha * v_mean
                self.sigma_v_dash[f, i], self.mu_v[f, i] = sig, mu
                he = x * (q[r] - x * mu_old)
                h1e = x * x * (tq[r] - x * x * sig_old)
                h2e = x * x * (tz[r] - x * x * mu_old * mu_old)
                q[r] += x * (mu - mu_old)
                tq[r] += x * x * (sig - sig_old)
                tz[r] += x * x * (mu * mu - mu_old * mu_old)
                self.e[r] += he * (mu_old - mu)
                self.t[r] += (h1e + h2e) * (sig - sig_old) + h1e * (mu * mu - mu_old * mu_old)
        # hypers
        alpha_temp = np.sum(self.e ** 2 + self.t)
        self.alpha = N / alpha_temp
        self.sigma_0 = 1.0 / (self.mu_0 ** 2 + self.sigma_0_dash)
        for g in range(self.G):
            m = self.groups == g
            self.sigma_w[g] = self.gcount[g] / np.sum(self.mu_w[m] ** 2 + self.sigma_w_dash[m])
            for f in range(self.K):
                self.sigma_v[g, f] = self.gcount[g] / np.sum(
                    self.mu_v[f, m] ** 2 + self.sigma_v_dash[f, m])
        return self.free_energy(alpha_temp)

    def free_energy(self, alpha_temp):
        fe = -0.5 * self.alpha * alpha_temp - 0.5 * self.N * np.log(2 * 3.14 / self.alpha)
        fe += (-0.5 * self.sigma_0 * (self.mu_0 ** 2 + self.sigma_0_dash)
               + 0.5 * np.log(self.sigma_0_dash * self.sigma_0) + 0.5)
        sw = self.sigma_w[self.groups]
        fe += np.sum(-0.5 * sw * (self.mu_w ** 2 + self.sigma_w_dash)
                     + 0.5 * np.log(self.sigma_w_dash * sw) + 0.5)
        sv = self.sigma_v[self.groups, :].T  # [K, D]
        fe += np.sum(-0.5 * sv * (self.mu_v ** 2 + self.sigma_v_dash)
                     + 0.5 * np.log(self.sigma_v_dash * sv) + 0.5)
        return fe


class ALSOracle:
    """Deterministic ALS (MCMC with do_sample=False, do_multilevel=False),
    serial Gauss-Seidel, float64.  Mirrors the conditional means of
    fm_learn_mcmc.h:628-899 with alpha=1, w_mu=0, fixed lambdas."""

    def __init__(self, row, col, val, y, D, K, groups=None, k0=True, k1=True,
                 reg0=0.0, regw=0.0, regv=0.0):
        self.N = len(y)
        self.D, self.K = D, K
        self.k0, self.k1 = k0, k1
        self.row, self.col, self.val = row, col, val.astype(np.float64)
        self.y = y.astype(np.float64)
        self.cols = SparseCols(row, col, val, self.N, D)
        self.groups = groups if groups is not None else np.zeros(D, dtype=np.int32)
        self.G = int(self.groups.max()) + 1
        self.reg0, self.regw, self.regv = reg0, regw, regv
        self.alpha = 1.0

    def init(self, w0, w, v):
        self.w0 = float(w0)
        self.w = w.astype(np.float64).copy()
        self.v = v.astype(np.float64).copy()
        yhat = fm_scores_dense(self.w0 if self.k0 else 0.0,
                               self.w if self.k1 else np.zeros(self.D),
                               self.v, self.row, self.col, self.val, self.N)
        self.e = yhat - self.y  # MCMC sign convention

    def iterate(self):
        alpha = self.alpha
        if self.k0:
            acc = np.sum(self.e - self.w0)
            s2 = 1.0 / (self.reg0 + alpha * self.N)
            new_w0 = -s2 * (alpha * acc - 0.0 * self.reg0)
            self.e -= self.w0 - new_w0
            self.w0 = new_w0
        if self.k1:
            for i in range(self.D):
                r, x = self.cols.col(i)
                if len(r) == 0:
                    self.w[i] = 0.0  # prior mean (mu_g = 0)
                    continue
                sx2 = np.sum(x * x)
                w_mean = np.sum(x * self.e[r]) - self.w[i] * sx2
                s2 = 1.0 / (self.regw + alpha * sx2)
                new_w = -s2 * (alpha * w_mean - 0.0 * self.regw)
                self.e[r] -= x * (self.w[i] - new_w)
                self.w[i] = new_w
        for f in range(self.K):
            q = np.zeros(self.N)
            np.add.at(q, self.row, self.v[f, self.col] * self.val)
            for i in range(self.D):
                r, x = self.cols.col(i)
                if len(r) == 0:
                    self.v[f, i] = 0.0
                    continue
                vv = self.v[f, i]
                h = x * (q[r] - x * vv)
                sh2 = np.sum(h * h)
                v_mean = np.sum(h * self.e[r]) - vv * sh2
                s2 = 1.0 / (self.regv + alpha * sh2)
                new_v = -s2 * (alpha * v_mean - 0.0 * self.regv)
                dv = vv - new_v
                q[r] -= x * dv
                self.e[r] -= h * dv
                self.v[f, i] = new_v
        # full re-predict, e := yhat - y
        yhat = fm_scores_dense(self.w0 if self.k0 else 0.0,
                               self.w if self.k1 else np.zeros(self.D),
                               self.v, self.row, self.col, self.val, self.N)
        self.e = yhat - self.y
        return self.e


class OVBOracle:
    """Online VBFM (natural-gradient chunked updates), serial float64.

    Mirrors fm_learn_vb_online.h's *code* semantics: per-chunk e/T rebuild,
    natural-parameter interpolation with per-coordinate Robbins-Monro rates
    (t0+t)^-0.5, col_count full-data scaling, exponentially smoothed
    hyperparameters, early-abort on bad alpha.
    """

    def __init__(self, row, col, val, y, D, K, col_count, n_full,
                 groups=None, k0=True, k1=True):
        self.N = len(y)
        self.D, self.K = D, K
        self.k0, self.k1 = k0, k1
        self.row, self.col, self.val = row, col, val.astype(np.float64)
        self.y = y.astype(np.float64)
        self.groups = groups if groups is not None else np.zeros(D, dtype=np.int32)
        self.G = int(self.groups.max()) + 1
        self.gcount = np.bincount(self.groups, minlength=self.G).astype(np.float64)
        self.col_count = col_count.astype(np.float64)
        self.n_full = float(n_full)

    def init(self, mu_0, sigma_0_dash, mu_w, sigma_w_dash, mu_v, sigma_v_dash):
        self.mu_0 = float(mu_0)
        self.sigma_0_dash = float(sigma_0_dash)
        self.mu_w = mu_w.astype(np.float64).copy()
        self.sigma_w_dash = sigma_w_dash.astype(np.float64).copy()
        self.mu_v = mu_v.astype(np.float64).copy()
        self.sigma_v_dash = sigma_v_dash.astype(np.float64).copy()
        self.n_mu_0 = self.mu_0 / 0.02
        self.n_sig_0 = 1.0 / self.sigma_0_dash
        self.n_mu_w = self.mu_w / 0.02
        self.n_sig_w = 1.0 / self.sigma_w_dash
        self.n_mu_v = self.mu_v / 0.02
        self.n_sig_v = 1.0 / self.sigma_v_dash
        self.alpha = 1.0
        self.sigma_0 = 1.0
        self.sigma_w = np.ones(self.G)
        self.sigma_v = np.ones((self.G, self.K))
        self.t_w0 = 0.0
        self.t_wj = np.zeros(self.D)
        self.t_vj = np.zeros(self.D)

    def chunk_update(self, rows_idx):
        """Process the chunk consisting of global row ids rows_idx."""
        sel = np.isin(self.row, rows_idx)
        remap = -np.ones(self.N, dtype=np.int64)
        remap[rows_idx] = np.arange(len(rows_idx))
        r = remap[self.row[sel]]
        c = self.col[sel]
        x = self.val[sel]
        yb = self.y[rows_idx]
        nb = len(rows_idx)
        rho0 = (1.0 + self.t_w0) ** -0.5

        yhat = fm_scores_dense(self.mu_0 if self.k0 else 0.0,
                               self.mu_w if self.k1 else np.zeros(self.D),
                               self.mu_v, r, c, x, nb)
        e = yb - yhat
        t = t_terms_dense(self.sigma_0_dash if self.k0 else 0.0,
                          self.sigma_w_dash if self.k1 else np.zeros(self.D),
                          self.mu_v, self.sigma_v_dash, r, c, x, nb)
        cols_chunk = SparseCols(r.astype(np.int64), c, x, nb, self.D)

        if self.k0:
            mu_old, sig_old = self.mu_0, self.sigma_0_dash
            w0_temp = np.mean(e) + self.mu_0
            self.n_sig_0 = (1 - rho0) * self.n_sig_0 + rho0 * (
                self.sigma_0 + self.n_full * self.alpha)
            self.n_mu_0 = (1 - rho0) * self.n_mu_0 + rho0 * (
                self.n_full * self.alpha * w0_temp)
            self.mu_0 = self.n_mu_0 / self.n_sig_0
            self.sigma_0_dash = 1.0 / self.n_sig_0
            e += mu_old - self.mu_0
            t += self.sigma_0_dash - sig_old

        if self.k1:
            for i in range(self.D):
                ri, xi = cols_chunk.col(i)
                if len(ri) == 0:
                    continue
                g = self.groups[i]
                rho = (1.0 + self.t_wj[i]) ** -0.5
                mu_old, sig_old = self.mu_w[i], self.sigma_w_dash[i]
                mean1 = np.mean(xi * (e[ri] + xi * mu_old))
                msx2 = np.mean(xi * xi)
                self.n_sig_w[i] = (1 - rho) * self.n_sig_w[i] + rho * (
                    self.sigma_w[g] + self.alpha * self.col_count[i] * msx2)
                self.n_mu_w[i] = (1 - rho) * self.n_mu_w[i] + rho * (
                    self.col_count[i] * self.alpha * mean1)
                self.t_wj[i] += len(ri)
                self.mu_w[i] = self.n_mu_w[i] / self.n_sig_w[i]
                self.sigma_w_dash[i] = 1.0 / self.n_sig_w[i]
                e[ri] += xi * (mu_old - self.mu_w[i])
                t[ri] += xi * xi * (self.sigma_w_dash[i] - sig_old)

        rho_v = (1.0 + self.t_vj) ** -0.5
        for f in range(self.K):
            q = np.zeros(nb)
            tq = np.zeros(nb)
            tz = np.zeros(nb)
            np.add.at(q, r, self.mu_v[f, c] * x)
            np.add.at(tq, r, self.sigma_v_dash[f, c] * x * x)
            np.add.at(tz, r, self.mu_v[f, c] ** 2 * x * x)
            for i in range(self.D):
                ri, xi = cols_chunk.col(i)
                if len(ri) == 0:
                    continue
                g = self.groups[i]
                mu_old, sig_old = self.mu_v[f, i], self.sigma_v_dash[f, i]
                h = q[ri] - xi * mu_old
                h1 = tq[ri] - xi * xi * sig_old
                v_mean = np.mean(xi * h * (e[ri] + xi * mu_old * h))
                v_sig = np.mean(xi * xi * h * h + xi * xi * h1)
                self.n_sig_v[f, i] = (1 - rho_v[i]) * self.n_sig_v[f, i] + \
                    rho_v[i] * (self.sigma_v[g, f]
                                + self.alpha * self.col_count[i] * v_sig)
                self.n_mu_v[f, i] = (1 - rho_v[i]) * self.n_mu_v[f, i] + \
                    rho_v[i] * self.col_count[i] * self.alpha * v_mean
                mu_n = self.n_mu_v[f, i] / self.n_sig_v[f, i]
                sig_n = 1.0 / self.n_sig_v[f, i]
                he = xi * (q[ri] - xi * mu_old)
                h1e = xi * xi * (tq[ri] - xi * xi * sig_old)
                h2e = xi * xi * (tz[ri] - xi * xi * mu_old * mu_old)
                q[ri] += xi * (mu_n - mu_old)
                tq[ri] += xi * xi * (sig_n - sig_old)
                tz[ri] += xi * xi * (mu_n * mu_n - mu_old * mu_old)
                e[ri] -= he * (mu_n - mu_old)
                t[ri] += (h1e + h2e) * (sig_n - sig_old) + \
                    h1e * (mu_n * mu_n - mu_old * mu_old)
                self.mu_v[f, i] = mu_n
                self.sigma_v_dash[f, i] = sig_n
        for i in range(self.D):
            ri, _ = cols_chunk.col(i)
            self.t_vj[i] += len(ri)

        # hypers (smoothed with rho0; early-abort semantics on bad alpha)
        alpha_temp = np.sum(e * e + t)
        alpha_cand = (1 - rho0) * self.alpha + rho0 * (nb / alpha_temp)
        if not np.isfinite(alpha_cand):
            return e, t
        self.alpha = alpha_cand
        self.sigma_0 = (1 - rho0) * self.sigma_0 + rho0 * (
            1.0 / (self.mu_0 ** 2 + self.sigma_0_dash))
        for g in range(self.G):
            m = self.groups == g
            self.sigma_w[g] = (1 - rho0) * self.sigma_w[g] + rho0 * (
                self.gcount[g] / np.sum(self.mu_w[m] ** 2 + self.sigma_w_dash[m]))
            for f in range(self.K):
                self.sigma_v[g, f] = (1 - rho0) * self.sigma_v[g, f] + rho0 * (
                    self.gcount[g] / np.sum(self.mu_v[f, m] ** 2
                                            + self.sigma_v_dash[f, m]))
        self.t_w0 += 1.0
        return e, t


class SGDAOracle:
    """float64 per-example SGDA (fm_learn_sgd_element_adapt_reg.h:123-236):
    theta steps on train rows with last-seen gradient caches, lambda steps
    on validation rows against the forecasted-parameter loss."""

    def __init__(self, D, K, G, groups, lr, min_target, max_target,
                 task=0, k0=True, k1=True):
        self.D, self.K, self.G = D, K, G
        self.groups = np.asarray(groups, dtype=np.int64)
        self.lr = float(lr)
        self.min_t, self.max_t = float(min_target), float(max_target)
        self.task, self.k0, self.k1 = task, k0, k1
        self.reg0 = 0.0
        self.grad_w = np.zeros(D)
        self.grad_v = np.zeros((K, D))
        self.reg_w = np.zeros(G)
        self.reg_v = np.zeros((G, K))

    def init(self, w0, w, v):
        self.w0 = float(w0)
        self.w = np.asarray(w, np.float64).copy()
        self.v = np.asarray(v, np.float64).copy()

    def _grad_loss(self, p, y):
        if self.task == 0:
            p = min(self.max_t, max(self.min_t, p))
            return 2.0 * (p - y)
        return y * (1.0 / (1.0 + np.exp(-y * p)) - 1.0)

    def theta_step(self, idx, x, y):
        """adapt_reg.h:123-157 (grads use the pre-update sums)."""
        x = np.asarray(x, np.float64)
        sum_f = self.v[:, idx] @ x  # [K]
        p = 0.0
        if self.k0:
            p += self.w0
        if self.k1:
            p += self.w[idx] @ x
        d = self.v[:, idx] * x
        p += 0.5 * float((sum_f ** 2 - (d * d).sum(-1)).sum())
        mult = self._grad_loss(p, y)
        if self.k0:
            self.w0 -= self.lr * (mult + 2 * self.reg0 * self.w0)
        if self.k1:
            for j, i in enumerate(idx):
                g = self.groups[i]
                self.grad_w[i] = mult * x[j]
                self.w[i] -= self.lr * (self.grad_w[i]
                                        + 2 * self.reg_w[g] * self.w[i])
        for f in range(self.K):
            for j, i in enumerate(idx):
                g = self.groups[i]
                vv = self.v[f, i]
                self.grad_v[f, i] = mult * (x[j] * sum_f[f] - vv * x[j] * x[j])
                self.v[f, i] -= self.lr * (self.grad_v[f, i]
                                           + 2 * self.reg_v[g, f] * vv)

    def lambda_step(self, idx, x, y):
        """adapt_reg.h:159-236 (predict_scaled with forecasted theta')."""
        x = np.asarray(x, np.float64)
        lr = self.lr
        g_of = self.groups[idx]
        w_dash = self.w[idx] - lr * (self.grad_w[idx]
                                     + 2 * self.reg_w[g_of] * self.w[idx])
        rv = self.reg_v[g_of, :].T  # [K, P]
        v_dash = self.v[:, idx] - lr * (self.grad_v[:, idx]
                                        + 2 * rv * self.v[:, idx])
        p = 0.0
        if self.k0:
            p += self.w0
        if self.k1:
            p += float(w_dash @ x)
        d = v_dash * x
        p += 0.5 * float((d.sum(-1) ** 2 - (d * d).sum(-1)).sum())
        grad_loss = self._grad_loss(p, y)

        if self.k1:
            lam_w = np.zeros(self.G)
            np.add.at(lam_w, g_of, x * self.w[idx])
            lam_w *= -2.0 * lr
            self.reg_w = np.maximum(self.reg_w - lr * grad_loss * lam_w, 0.0)
        for f in range(self.K):
            sum_f_dash = float(v_dash[f] @ x)
            sum_f = np.zeros(self.G)
            sum_fdf = np.zeros(self.G)
            np.add.at(sum_f, g_of, self.v[f, idx] * x)
            np.add.at(sum_fdf, g_of, v_dash[f] * x * self.v[f, idx] * x)
            lam_v = -2.0 * lr * (sum_f_dash * sum_f - sum_fdf)
            self.reg_v[:, f] = np.maximum(
                self.reg_v[:, f] - lr * grad_loss * lam_v, 0.0)


class ExpSGDOracle:
    """float64 per-coordinate exponential-family SGD
    (exp_fm_learn_sgd.h:267-455): full-batch coordinate gradient steps over
    the transpose with incremental e/q patches, natural column order; e is
    recomputed from scratch each iteration (the simultaneous driver's
    re-predict, exp_fm_learn_sgd_simultaneous.h:35,107)."""

    def __init__(self, row, col, val, y, D, K, lr, stdev=1.0,
                 reg0=0.0, regw=0.0, regv=0.0, k0=True, k1=True):
        self.row = np.asarray(row)
        self.col = np.asarray(col)
        self.val = np.asarray(val, np.float64)
        self.y = np.asarray(y, np.float64)
        self.n = int(self.y.shape[0])
        self.D, self.K = D, K
        self.lr, self.stdev = float(lr), float(stdev)
        self.reg0, self.regw, self.regv = float(reg0), float(regw), float(regv)
        self.k0, self.k1 = k0, k1
        self.cols = SparseCols(self.row, self.col, self.val, self.n, D)

    def init(self, w0, w, v):
        self.w0 = float(w0)
        self.w = np.asarray(w, np.float64).copy()
        self.v = np.asarray(v, np.float64).copy()

    def iterate(self):
        n = float(self.n)
        yhat = fm_scores_dense(self.w0, self.w, self.v, self.row, self.col,
                               self.val, self.n)
        e = self.stdev * yhat - self.y
        lr = self.lr
        if self.k0:
            w0_old = self.w0
            self.w0 -= lr * (e.sum() + self.reg0 * self.w0) / n
            e -= (w0_old - self.w0)
        if self.k1:
            for j in range(self.D):
                ri, x = self.cols.col(j)
                w_old = self.w[j]
                self.w[j] -= lr * ((x * e[ri]).sum()
                                   + self.regw * self.w[j]) / n
                e[ri] -= x * (w_old - self.w[j])
        for f in range(self.K):
            q = np.zeros(self.n)
            np.add.at(q, self.row, self.v[f, self.col] * self.val)
            for j in range(self.D):
                ri, x = self.cols.col(j)
                v_old = self.v[f, j]
                h = x * (q[ri] - x * v_old)
                self.v[f, j] -= lr * ((h * e[ri]).sum()
                                      + self.regv * self.v[f, j]) / n
                q[ri] -= x * (v_old - self.v[f, j])
                e[ri] -= h * (v_old - self.v[f, j])


class BinOrderALSOracle(ALSOracle):
    """ALSOracle with the blocked sweep's coordinate ordering: conflict-free
    bins outermost, then factors, then the bin's columns (learners.mcmc
    ._v_blocked_sweep).  Within a bin all columns have disjoint row sets, so
    only the bin->factor nesting differs from the reference's factor-major
    chain; this oracle pins the closed-form cross-factor corrections
    (she_f -= sum_{f'<f} dv_f' M[f',f]) to exact serial Gauss-Seidel."""

    def __init__(self, *args, color=None, factor_block=0, **kw):
        super().__init__(*args, **kw)
        assert color is not None  # plan.color: bin id per column
        self.color = np.asarray(color)
        self.F = factor_block if factor_block > 0 else self.K

    def iterate(self):
        alpha = self.alpha
        bins = [np.flatnonzero(self.color == b)
                for b in range(int(self.color.max()) + 1)]
        if self.k0:
            acc = np.sum(self.e - self.w0)
            s2 = 1.0 / (self.reg0 + alpha * self.N)
            new_w0 = -s2 * alpha * acc
            self.e -= self.w0 - new_w0
            self.w0 = new_w0
        if self.k1:
            for cols_b in bins:
                for i in cols_b:
                    r, x = self.cols.col(i)
                    if len(r) == 0:
                        self.w[i] = 0.0
                        continue
                    sx2 = np.sum(x * x)
                    w_mean = np.sum(x * self.e[r]) - self.w[i] * sx2
                    s2 = 1.0 / (self.regw + alpha * sx2)
                    new_w = -s2 * alpha * w_mean
                    self.e[r] -= x * (self.w[i] - new_w)
                    self.w[i] = new_w
        for b0 in range(0, self.K, self.F):
            fs = range(b0, min(b0 + self.F, self.K))
            q = np.zeros((self.K, self.N))
            for f in fs:
                np.add.at(q[f], self.row, self.v[f, self.col] * self.val)
            for cols_b in bins:
                for f in fs:
                    for i in cols_b:
                        r, x = self.cols.col(i)
                        if len(r) == 0:
                            self.v[f, i] = 0.0
                            continue
                        vv = self.v[f, i]
                        h = x * (q[f][r] - x * vv)
                        sh2 = np.sum(h * h)
                        v_mean = np.sum(h * self.e[r]) - vv * sh2
                        s2 = 1.0 / (self.regv + alpha * sh2)
                        new_v = -s2 * alpha * v_mean
                        dv = vv - new_v
                        q[f][r] -= x * dv
                        self.e[r] -= h * dv
                        self.v[f, i] = new_v
        yhat = fm_scores_dense(self.w0 if self.k0 else 0.0,
                               self.w if self.k1 else np.zeros(self.D),
                               self.v, self.row, self.col, self.val, self.N)
        self.e = yhat - self.y
        return self.e


class BSBlockedALSOracle(ALSOracle):
    """ALSOracle with the factor-blocked BLOCK-STRUCTURE coordinate order
    (learners.mcmc_bs blocked path): per factor-block B of size F —
    main bins outermost with factors inner (matching _v_blocked_sweep),
    then each relation in turn, ALSO bins outer / factors inner (the
    round-3 bin-major relation sweep).  Every conditional is computed
    naively from the expanded design matrix, so it independently pins the
    blocked BS path's aggregate-level cross-factor corrections (we/weq
    updates via wc/wcc moments and the per-bin triangular solve)."""

    def __init__(self, *args, main_bins=None, rel_bins=None, factor_block=0,
                 **kw):
        super().__init__(*args, **kw)
        self.main_bins = [np.asarray(b) for b in (main_bins or [])]
        self.rel_bins = [[np.asarray(b) for b in rb] for rb in (rel_bins or [])]
        self.F = factor_block if factor_block > 0 else self.K

    def _upd_col(self, f, i, q):
        r, x = self.cols.col(i)
        if len(r) == 0:
            self.v[f, i] = 0.0
            return
        vv = self.v[f, i]
        h = x * (q[f][r] - x * vv)
        sh2 = np.sum(h * h)
        v_mean = np.sum(h * self.e[r]) - vv * sh2
        s2 = 1.0 / (self.regv + self.alpha * sh2)
        new_v = -s2 * self.alpha * v_mean
        dv = vv - new_v
        q[f][r] -= x * dv
        self.e[r] -= h * dv
        self.v[f, i] = new_v

    def iterate(self):
        alpha = self.alpha
        if self.k0:
            acc = np.sum(self.e - self.w0)
            s2 = 1.0 / (self.reg0 + alpha * self.N)
            new_w0 = -s2 * alpha * acc
            self.e -= self.w0 - new_w0
            self.w0 = new_w0
        if self.k1:
            all_bins = list(self.main_bins) + [b for rb in self.rel_bins
                                               for b in rb]
            for cols_b in all_bins:
                for i in cols_b:
                    r, x = self.cols.col(i)
                    if len(r) == 0:
                        self.w[i] = 0.0
                        continue
                    sx2 = np.sum(x * x)
                    w_mean = np.sum(x * self.e[r]) - self.w[i] * sx2
                    s2 = 1.0 / (self.regw + alpha * sx2)
                    new_w = -s2 * alpha * w_mean
                    self.e[r] -= x * (self.w[i] - new_w)
                    self.w[i] = new_w
        for b0 in range(0, self.K, self.F):
            fs = range(b0, min(b0 + self.F, self.K))
            q = np.zeros((self.K, self.N))
            for f in fs:
                np.add.at(q[f], self.row, self.v[f, self.col] * self.val)
            # main block: bins outer, factors inner (_v_blocked_sweep order)
            for cols_b in self.main_bins:
                for f in fs:
                    for i in cols_b:
                        self._upd_col(f, i, q)
            # relations: the relation's bins outer, factors inner (within a
            # bin columns have disjoint row sets, so (f, i) interleaving
            # across columns is immaterial; factors per column sequential)
            for rbins in self.rel_bins:
                for cols_b in rbins:
                    for f in fs:
                        for i in cols_b:
                            self._upd_col(f, i, q)
        yhat = fm_scores_dense(self.w0 if self.k0 else 0.0,
                               self.w if self.k1 else np.zeros(self.D),
                               self.v, self.row, self.col, self.val, self.N)
        self.e = yhat - self.y
        return self.e
