"""The port's prediction (``pynngp_tpu_torch.predict``) against the
reference's (``pynngp_tpu.predict``), float64 on the CPU.

The prediction tables must agree bit for bit; ``mean`` and ``var`` at rtol
1e-8 on the same tables and draws, for the response and the latent model,
fixed effects, the residual conditioning, the noiseless target, a sampled
nu, the dot-product metric and either batching.  The samples are held to
their standardized moments, and full-neighbor kriging to the dense GP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import kernels as jkernels
from pynngp_tpu import predict as jpredict
from pynngp_tpu.gold.dense_gp import dense_krig_predict
from pynngp_tpu_torch import kernels, predict

S, N, N0, P = 11, 120, 9, 2


def _draws(rng, s=S, nu=False):
    out = {"sigma2": rng.uniform(0.5, 1.5, s), "tau2": rng.uniform(0.05, 0.2, s),
           "phi": rng.uniform(0.2, 0.5, s)}
    if nu:
        out["nu"] = rng.uniform(0.6, 2.2, s)
    return out


def _tables(coords, new, m, metric="euclidean"):
    return (predict.build_prediction_table(coords, new, m, metric=metric,
                                           dtype=torch.float64, device="cpu"),
            jpredict.build_prediction_table(coords, new, m, metric=metric,
                                            dtype=jnp.float64))


@pytest.mark.parametrize("metric,d,m", [("euclidean", 2, 10), ("euclidean", 3, 1),
                                        ("dotproduct", 3, 10), ("dotproduct", 5, 7)])
def test_prediction_table_matches_the_reference(metric, d, m):
    rng = np.random.default_rng(1)
    coords, new = rng.standard_normal((N, d)), rng.standard_normal((N0, d))
    ours, ref = _tables(coords, new, m, metric)
    for field in ours._fields:
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert ours.nn_idx.dtype == torch.int64 and ours.nn_dist.shape == (N0, m)


CASES = {
    "response": dict(),
    "latent": dict(latent=True),
    "response_x0_beta": dict(x0=True),
    "response_x_train": dict(x0=True, x_train=True),
    "latent_x0_beta": dict(latent=True, x0=True),
    "noiseless_target": dict(noise_on_target=False),
    "sampled_nu": dict(kernel="matern_sampled"),
    "static_nu": dict(kernel="matern_0.8"),
    "dotproduct": dict(metric="dotproduct"),
    "batch_1": dict(batch_draws=1),
    "batch_all": dict(batch_draws=64),
}


def _kernels(name):
    if name == "matern_sampled":
        return kernels.Matern(), jkernels.Matern()
    if name == "matern_0.8":
        return kernels.Matern(nu=0.8), jkernels.Matern(nu=0.8)
    return kernels.get_kernel(name), jkernels.get_kernel(name)


@pytest.mark.parametrize("case", list(CASES))
def test_predict_draws_matches_the_reference(case):
    spec = CASES[case]
    rng = np.random.default_rng(2)
    metric = spec.get("metric", "euclidean")
    d = 3 if metric == "dotproduct" else 2
    coords, new = rng.uniform(-1, 1, (N, d)), rng.uniform(-1, 1, (N0, d))
    ours_t, ref_t = _tables(coords, new, 8, metric)
    kern, jkern = _kernels(spec.get("kernel", "exponential"))
    draws = _draws(rng, nu=spec.get("kernel") == "matern_sampled")
    y = rng.standard_normal(N)
    kw = dict(noise_on_target=spec.get("noise_on_target", True),
              batch_draws=spec.get("batch_draws", 8))
    if spec.get("latent"):
        kw["values_draws"] = rng.standard_normal((S, N))
    if spec.get("x0"):
        kw["x0"] = rng.standard_normal((N0, P))
        kw["beta_draws"] = rng.standard_normal((S, P))
    if spec.get("x_train"):
        kw["x_train"] = rng.standard_normal((N, P))
    values = None if spec.get("latent") else y
    ours = predict.predict_draws(kern, ours_t, values, draws, **kw)
    ref = jpredict.predict_draws(jkern, ref_t, values, draws, **kw)
    for key in ("mean", "var"):
        assert ours[key].shape == (S, N0)
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-8, atol=1e-14, err_msg=key)
    assert "samples" not in ours


def test_batching_does_not_change_the_result():
    rng = np.random.default_rng(3)
    table, _ = _tables(rng.uniform(size=(80, 2)), rng.uniform(size=(6, 2)), 10)
    draws = _draws(rng, s=7)
    y = torch.as_tensor(rng.standard_normal(80))
    a = predict.predict_draws(kernels.SqExp(), table, y, draws, batch_draws=1)
    b = predict.predict_draws(kernels.SqExp(), table, y, draws, batch_draws=8)
    for key in ("mean", "var"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-12, atol=0.0)


def test_samples_have_the_predictive_moments():
    """(samples - mean) / sqrt(var) over 400 draws x 50 sites: standard
    normal within Monte Carlo error (mean within 4.5 standard errors,
    variance within 4.5 of its own)."""
    rng = np.random.default_rng(4)
    table, _ = _tables(rng.uniform(size=(200, 2)), rng.uniform(size=(50, 2)), 10)
    draws = _draws(rng, s=400)
    gen = torch.Generator().manual_seed(0)
    out = predict.predict_draws(kernels.Exponential(), table,
                                rng.standard_normal(200), draws, generator=gen)
    z = ((out["samples"] - out["mean"]) / torch.sqrt(out["var"])).numpy().ravel()
    k = z.size
    assert abs(z.mean()) < 4.5 / np.sqrt(k)
    assert abs(z.var() - 1.0) < 4.5 * np.sqrt(2.0 / k)
    # the same generator state draws the same normals, whatever the values
    again = predict.predict_draws(kernels.Exponential(), table,
                                  rng.standard_normal(200), draws,
                                  generator=torch.Generator().manual_seed(0))
    assert not torch.equal(again["mean"], out["mean"])
    torch.testing.assert_close(again["samples"] - again["mean"],
                               out["samples"] - out["mean"], rtol=1e-9, atol=1e-15)


def test_full_neighbor_kriging_equals_dense():
    """With m = n training neighbors NNGP kriging is exact GP kriging (the
    reference test's check against the gold dense GP)."""
    rng = np.random.default_rng(1234)
    n, n0 = 50, 12
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    new = rng.uniform(size=(n0, 2))
    sigma2, phi, tau2 = 1.2, 0.4, 0.15
    table = predict.build_prediction_table(coords, new, m=n, dtype=torch.float64,
                                           device="cpu")
    out = predict.predict_draws(
        kernels.SqExp(), table, torch.as_tensor(y),
        {"sigma2": np.array([sigma2]), "tau2": np.array([tau2]),
         "phi": np.array([phi])}, jitter=0.0)
    mean_gold, var_gold = dense_krig_predict(y, coords, new, "sqexp", sigma2, phi, tau2)
    np.testing.assert_allclose(out["mean"][0].numpy(), mean_gold, rtol=1e-8)
    np.testing.assert_allclose(out["var"][0].numpy(), var_gold, rtol=1e-7)


def test_refusals_have_the_references_words():
    rng = np.random.default_rng(5)
    table, _ = _tables(rng.uniform(size=(40, 2)), rng.uniform(size=(3, 2)), 5)
    draws = _draws(rng, s=2)
    x = rng.standard_normal((40, P))
    with pytest.raises(ValueError, match="latent model conditions on w; do not pass x_train"):
        predict.predict_draws(kernels.SqExp(), table, None, draws,
                              values_draws=rng.standard_normal((2, 40)), x_train=x,
                              beta_draws=rng.standard_normal((2, P)))
    with pytest.raises(ValueError, match="x_train requires beta_draws"):
        predict.predict_draws(kernels.SqExp(), table, rng.standard_normal(40),
                              draws, x_train=x)


def test_a_failed_factor_gives_nan_not_an_error():
    """Two training sites at one place and no nugget or jitter: C_N is
    singular; the result is NaN at the sites that condition on both, as the
    reference's factor gives, and finite elsewhere."""
    coords = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [2.0, 2.0]])
    new = np.array([[0.01, 0.0], [2.0, 2.1]])
    table = predict.build_prediction_table(coords, new, 2, dtype=torch.float64,
                                           device="cpu")
    draws = {"sigma2": np.ones(1), "tau2": np.zeros(1), "phi": np.ones(1)}
    out = predict.predict_draws(kernels.Exponential(), table, np.ones(4), draws,
                                jitter=0.0)
    assert torch.isnan(out["mean"][0, 0]) and torch.isfinite(out["mean"][0, 1])
