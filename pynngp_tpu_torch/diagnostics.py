"""MCMC diagnostics (numpy copy of ``pynngp_tpu.diagnostics``): effective
sample size (Geyer initial monotone sequence over an FFT autocovariance),
split R-hat and the per-parameter summary.  Host-side post-processing of the
draws."""

from __future__ import annotations

import numpy as np

__all__ = ["ess", "split_rhat", "summarize"]


def _autocov(x):
    n = len(x)
    x = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / n


def ess(chains) -> float:
    """Effective sample size.  ``chains``: (n_draws,) or (n_chains, n_draws)."""
    x = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    c, n = x.shape
    if n < 4:
        return float(c * n)
    acov = np.stack([_autocov(row) for row in x])
    mean_var = acov[:, 0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    # Geyer initial monotone positive sequence over pair sums
    # P_k = rho[2k] + rho[2k+1]; tau = -1 + 2 * sum_k P_k.
    tau = -1.0
    prev_pair = np.inf
    for t in range(0, n - 1, 2):
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)  # enforce monotonicity
        tau += 2.0 * pair
        prev_pair = pair
    # capped at the draw count: an estimator reporting ESS > n_draws is not
    # credible for a headline ESS/sec metric
    tau = max(tau, 1.0)
    return float(c * n / tau)


def split_rhat(chains) -> float:
    """Split-R-hat (Gelman-Rubin with split chains)."""
    x = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    c, n = x.shape
    half = n // 2
    if half < 2:
        return np.nan
    splits = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    m, n2 = splits.shape
    chain_means = splits.mean(axis=1)
    chain_vars = splits.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = n2 * chain_means.var(ddof=1)
    var_plus = (n2 - 1.0) / n2 * w + b / n2
    return float(np.sqrt(var_plus / w)) if w > 0 else np.nan


def summarize(draws: dict, params=None) -> dict:
    """Posterior mean / sd / 2.5-50-97.5% quantiles / ESS / R-hat of each
    scalar parameter: every draw array of at most two axes ((draws,) or
    (chains, draws)) unless ``params`` names them."""
    out = {}
    params = params or [k for k, v in draws.items() if np.asarray(v).ndim <= 2]
    for name in params:
        v = np.asarray(draws[name], dtype=np.float64)
        flat = v.reshape(-1)
        out[name] = {
            "mean": float(flat.mean()),
            "sd": float(flat.std(ddof=1)) if flat.size > 1 else 0.0,
            "q2.5": float(np.percentile(flat, 2.5)),
            "q50": float(np.percentile(flat, 50.0)),
            "q97.5": float(np.percentile(flat, 97.5)),
            "ess": ess(v),
            "rhat": split_rhat(v) if v.ndim == 2 and v.shape[0] > 1 else np.nan,
        }
    return out
