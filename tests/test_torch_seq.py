"""The port's SeqNNGP facade (``pynngp_tpu_torch.models.seq``) against the
reference's (``pynngp_tpu.models.seq``), float64 on the CPU; ``summarize``;
the console smoke and the two examples in subprocesses.

Given the same draws, both facades' ``predict`` is deterministic and must
agree at rtol 1e-8; the reference tests' whole workflows (construct ->
sample -> predict) are held to those tests' own bounds."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import diagnostics as jdiagnostics
from pynngp_tpu.models.seq import SeqNNGP as JaxSeqNNGP
from pynngp_tpu_torch import SeqNNGP, diagnostics
from tests.conftest import simulate_gp_field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, N0, C, S = 150, 12, 2, 9


@pytest.fixture(scope="module", autouse=True)
def _single_torch_thread():
    """Long loops of small tensor ops: more intra-op threads buy nothing and,
    beside other test workers, cost a great deal."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(31)
    coords, _, y = simulate_gp_field(rng, n=N + N0, name="exponential",
                                     sigma2=1.0, phi=0.3, tau2=0.1)
    x = np.column_stack([np.ones(N + N0), rng.standard_normal(N + N0)])
    return coords, y + x @ np.array([0.5, -1.0]), x


def _fake_draws(rng, model, p):
    """(C, S) parameter draws, (C, S, p) beta and, for the latent model,
    (C, S, n) w in the users' site order, as ``sample`` returns them."""
    draws = {"sigma2": rng.uniform(0.6, 1.4, (C, S)), "tau2": rng.uniform(0.05, 0.2, (C, S)),
             "phi": rng.uniform(0.2, 0.4, (C, S)), "loglik": rng.standard_normal((C, S))}
    if p:
        draws["beta"] = rng.standard_normal((C, S, p))
    if model == "latent":
        draws["w"] = rng.standard_normal((C, S, N))
    return draws


@pytest.mark.parametrize("covariates", [False, True], ids=["no_x0", "x0"])
@pytest.mark.parametrize("model", ["latent", "response"])
def test_facade_predict_on_given_draws_matches_the_reference(field, model, covariates):
    coords, y, x = field
    xt = x[:N] if covariates else None
    ours = SeqNNGP(y[:N], coords[:N], m=8, model=model, x=xt, dtype=torch.float64,
                   device="cpu")
    ref = JaxSeqNNGP(y[:N], coords[:N], m=8, model=model, x=xt, dtype=jnp.float64)
    draws = _fake_draws(np.random.default_rng(5), model, 2 if covariates else 0)
    x0 = x[N:] if covariates else None
    got = ours.predict(coords[N:], x0=x0, draws=draws, thin=2)
    want = ref.predict(coords[N:], x0=x0, draws=draws, thin=2)
    for key in ("mean", "var"):
        assert got[key].shape == (-(-C * S // 2), N0)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-8, err_msg=key)


@pytest.mark.parametrize("model", ["latent", "response"])
def test_facade_takes_the_references_backend(field, model):
    """SeqNNGP passes the reference's ``backend`` to the model, which takes
    it and ignores it: the model is the reference facade's (the same
    log-likelihood pieces, rtol 1e-8)."""
    coords, y, _ = field
    ours = SeqNNGP(y[:N], coords[:N], m=8, model=model, dtype=torch.float64,
                   device="cpu", backend="xla")
    ref = JaxSeqNNGP(y[:N], coords[:N], m=8, model=model, dtype=jnp.float64,
                     backend="xla")
    if model == "response":
        u = np.array([0.1, -0.3, -2.0])
        got = ours._model.full_loglik(torch.as_tensor(u)[None])[0]
        want = ref._model.full_loglik(jnp.asarray(u))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-8)
        return
    w = np.random.default_rng(4).standard_normal(N)
    got = ours._model._suffstats(ours._model._unconstrained(0.3)[None],
                                 torch.as_tensor(w)[None])
    want = ref._model._suffstats(ref._model._unconstrained(0.3), jnp.asarray(w))
    np.testing.assert_allclose([float(got[2][0]), float(got[3][0])],
                               [float(want[2]), float(want[3])], rtol=1e-8)


def test_summarize_is_the_references():
    rng = np.random.default_rng(6)
    draws = {"phi": rng.standard_normal((3, 200)), "tau2": rng.gamma(2.0, size=400),
             "w": rng.standard_normal((3, 200, 5)), "one": np.ones(1)}
    assert diagnostics.summarize(draws) == jdiagnostics.summarize(draws)
    ours = diagnostics.summarize(draws, params=["phi"])
    assert list(ours) == ["phi"] and ours == jdiagnostics.summarize(draws, ["phi"])


def test_latent_workflow_end_to_end():
    """The reference test's latent workflow and bounds (n = 200 + 20,
    exponential, m = 8, 300 + 300)."""
    rng = np.random.default_rng(1234)
    coords, _, y = simulate_gp_field(rng, n=220, name="exponential", sigma2=1.0,
                                     phi=0.3, tau2=0.05)
    train, test = slice(0, 200), slice(200, 220)
    gp = SeqNNGP(y[train], coords[train], m=8, cov_model="exponential",
                 model="latent", dtype=torch.float64, device="cpu")
    gp.sample(n_samples=300, n_burn=300, seed=9)
    assert set(gp.summary()) >= {"sigma2", "tau2", "phi"}
    pred = gp.predict(coords[test], generator=torch.Generator().manual_seed(1))
    assert pred["mean"].shape == (300, 20) and pred["samples"].shape == (300, 20)
    pm = pred["mean"].mean(0).numpy()
    assert np.corrcoef(pm, y[test])[0, 1] > 0.7
    assert np.sqrt(np.mean((pm - y[test]) ** 2)) < np.std(y[train])


def test_response_workflow_end_to_end():
    rng = np.random.default_rng(1234)
    coords, _, y = simulate_gp_field(rng, n=220, name="sqexp", sigma2=1.0, phi=0.3,
                                     tau2=0.1)
    train, test = slice(0, 200), slice(200, 220)
    gp = SeqNNGP(y[train], coords[train], m=10, cov_model="sqexp", model="response",
                 dtype=torch.float64, device="cpu")
    gp.sample(n_samples=300, n_burn=300, seed=10)
    pm = gp.predict(coords[test])["mean"].mean(0).numpy()
    assert np.sqrt(np.mean((pm - y[test]) ** 2)) < np.std(y[train])


def test_multichain_facade_predict_thins_the_flattened_draws():
    rng = np.random.default_rng(1234)
    coords, _, y = simulate_gp_field(rng, n=120, name="exponential")
    gp = SeqNNGP(y, coords, m=6, cov_model="exponential", model="response",
                 dtype=torch.float64, device="cpu")
    gp.sample(n_samples=100, n_burn=100, n_chains=2, seed=3)
    assert gp.predict(coords[:5], thin=4)["mean"].shape == (50, 5)


def test_facade_predict_with_covariates():
    """The reference test's bound: with x0 the predictive mean follows
    x0 @ beta (correlation above 0.9)."""
    rng = np.random.default_rng(1234)
    n, p = 120, 2
    coords = rng.uniform(size=(n, 2))
    x = rng.standard_normal((n, p))
    beta_true = np.array([2.0, -1.0])
    y = x @ beta_true + 0.5 * rng.standard_normal(n)
    gp = SeqNNGP(y, coords, m=6, cov_model="sqexp", model="response", x=x,
                 device="cpu")
    gp.sample(30, n_burn=30, seed=0)
    new, x0 = rng.uniform(size=(4, 2)), rng.standard_normal((4, p))
    out = gp.predict(new, x0=x0)
    assert out["mean"].shape[1] == 4 and torch.isfinite(out["mean"]).all()
    assert np.corrcoef(out["mean"].mean(0).numpy(), x0 @ beta_true)[0, 1] > 0.9


def test_refusals(field):
    """predict before sample, x0 without fixed effects, and latent draws
    whose w was kept every w_every-th draw only (the reference's predict
    fails on their shapes; the port names the cause)."""
    coords, y, _ = field
    gp = SeqNNGP(y[:N], coords[:N], m=5, model="latent", dtype=torch.float64,
                 device="cpu")
    with pytest.raises(ValueError, match="sample"):
        gp.predict(coords[N:])
    with pytest.raises(ValueError, match="sample"):
        gp.summary()
    draws = gp.sample(8, n_burn=4, n_chains=2, seed=0, w_every=4)
    assert draws["w"].shape == (2, 2, N) and draws["phi"].shape == (2, 8)
    with pytest.raises(ValueError, match="w_every"):
        gp.predict(coords[N:])
    with pytest.raises(ValueError, match="x0 given"):
        gp.predict(coords[N:], x0=np.ones((N0, 1)))
    with pytest.raises(ValueError, match="model must be"):
        SeqNNGP(y[:N], coords[:N], model="spatial", device="cpu")


def _run(args, timeout=240):
    """Run ``python args`` from the repo root on the CPU; one intra-op thread,
    as beside other test workers more only contend."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYNNGP_NEIGHBOR_CACHE": "0",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def test_console_smoke_runs_on_the_cpu():
    out = _run(["-m", "pynngp_tpu_torch.smoke", "--device", "cpu"])
    assert "smoke OK (device=cpu" in out


def test_spatial_example_runs_on_the_cpu():
    out = _run(["examples/torch_spatial_regression.py", "--device", "cpu",
                "--n", "300", "--samples", "50", "--burn", "50"])
    assert "held-out: RMSE=" in out and "95% coverage=" in out


def test_image_example_runs_on_the_cpu():
    pytest.importorskip("sklearn", reason="the image example reads scikit-learn's china.jpg")
    out = _run(["examples/torch_image_kriging.py", "--device", "cpu",
                "--n-train", "300", "--n-test", "50", "--samples", "50",
                "--burn", "50"])
    assert "90% interval coverage=" in out
