"""Deviation-score math on numpy arrays (counterpart of infer/deviation.py;
utils_vae.py:147-174):
  * reconstruction_deviation        per-subject MSE over ROIs (:147-148)
  * reconstruction_deviation_roi    elementwise (x - x_hat)^2 (:151-152)
  * latent_deviation                mean |z-score| over latent dims against
                                    the train-cohort latent distribution
                                    (:155-157)
  * separate_latent_deviation       per-dim latent z-score (:159-161)
  * latent_pvalues                  OLS/Logit p-value per latent dim (:163-174)
"""
from __future__ import annotations

import numpy as np
import pandas as pd


def reconstruction_deviation(x, x_pred):
    x = np.asarray(x)
    x_pred = np.asarray(x_pred)
    return np.sum((x - x_pred) ** 2, axis=1) / x.shape[1]


def reconstruction_deviation_roi(x, x_pred):
    return (np.asarray(x) - np.asarray(x_pred)) ** 2


def latent_deviation(mu_train, mu_sample, var_sample):
    mu_train = np.asarray(mu_train)
    mu_sample = np.asarray(mu_sample)
    var_sample = np.asarray(var_sample)
    var = np.var(mu_train, axis=0)
    return np.sum(
        np.abs(mu_sample - np.mean(mu_train, axis=0)) / np.sqrt(var + var_sample),
        axis=1,
    ) / mu_sample.shape[1]


def separate_latent_deviation(mu_train, mu_sample, var_sample):
    mu_train = np.asarray(mu_train)
    var = np.var(mu_train, axis=0)
    return (np.asarray(mu_sample) - np.mean(mu_train, axis=0)) / np.sqrt(
        var + np.asarray(var_sample)
    )


def _ols_pvalues(y, X):
    """Two-sided t-test p-values for OLS coefficients (statsmodels OLS
    semantics)."""
    from scipy import stats

    n, k = X.shape
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    # statsmodels uses df_resid = n - rank(X), not n - k: a rank-deficient
    # design (e.g. a posterior-collapsed constant latent dim) keeps the
    # residual dof of the effective model
    dof = n - np.linalg.matrix_rank(X)
    if dof <= 0:
        return np.full(k, np.nan)
    sigma2 = resid @ resid / dof
    # pinv, not inv: statsmodels OLS is pinv-based, so a rank-deficient
    # design yields finite statistics instead of raising LinAlgError
    cov = sigma2 * np.linalg.pinv(X.T @ X)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_stat = beta / np.sqrt(np.diag(cov))
    return 2.0 * stats.t.sf(np.abs(t_stat), dof)


def _logit_pvalues(y, X, max_iter: int = 100, tol: float = 1e-8):
    """Wald-test p-values from Newton-Raphson logistic regression
    (statsmodels Logit semantics)."""
    from scipy import stats
    from scipy.special import expit

    # statsmodels Logit raises for non-binary targets ('endog must be in
    # the unit interval'); without this the Newton iteration would happily
    # run on e.g. raw DIA labels {1, 2} and return meaningless p-values
    if not np.isin(y, (0.0, 1.0)).all():
        raise ValueError(
            f'logit target must be binary 0/1, got values '
            f'{sorted(set(np.asarray(y).tolist()))[:6]}')

    beta = np.zeros(X.shape[1])
    for _ in range(max_iter):
        p = expit(X @ beta)  # overflow-safe sigmoid (perfect separation)
        w = p * (1.0 - p)
        hessian = X.T @ (X * w[:, None])
        grad = X.T @ (y - p)
        step = np.linalg.solve(hessian + 1e-10 * np.eye(X.shape[1]), grad)
        beta = beta + step
        if np.max(np.abs(step)) < tol:
            break
    p = expit(X @ beta)
    w = p * (1.0 - p)
    cov = np.linalg.inv(X.T @ (X * w[:, None]) + 1e-10 * np.eye(X.shape[1]))
    z = beta / np.sqrt(np.diag(cov))
    return 2.0 * stats.norm.sf(np.abs(z))


def latent_pvalues(latent, target, type):
    """Per-latent-dim regression p-values (OLS for continuous targets, Logit
    otherwise), matching utils_vae.py:163-174 including the output frame
    layout (rows 'const'/'latent', one column per latent dim). Uses
    statsmodels when available; otherwise a native scipy implementation with
    the same test statistics."""
    try:
        import statsmodels.api as sm
    except ImportError:
        sm = None

    latent = np.asarray(latent)
    target = np.asarray(target, dtype=float)
    pval_df = pd.DataFrame({"labels": ["const", "latent"]})
    for i in range(latent.shape[1]):
        column = np.column_stack([np.ones(len(latent)), latent[:, i]])
        if sm is not None:
            if type == "continuous":
                fit = sm.OLS(target, column).fit()
            else:
                fit = sm.Logit(target, column).fit(disp=0)
            pvals = list(np.asarray(fit.pvalues))
        elif type == "continuous":
            pvals = list(_ols_pvalues(target, column))
        else:
            pvals = list(_logit_pvalues(target, column))
        pval_df[f"latent {i}"] = pvals
    return pval_df
