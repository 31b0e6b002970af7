"""The port's distances (``pynngp_tpu_torch.distance``) against the
reference's (``pynngp_tpu.distance``), and the dot-product distance through
both models, float64 on the CPU.

The numpy methods are copies and must agree bit for bit; the response model
on dot-product tables must give the reference's value and gradient at rtol
1e-8.  Above ``NON_EUCLIDEAN_MAX_SITES`` sites the latent model refuses a
non-Euclidean metric, as the reference's does (tested with the constant
lowered)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import distance as jdistance
from pynngp_tpu.models.latent import LatentNNGP as JaxLatentNNGP
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import distance
from pynngp_tpu_torch.models import latent as latent_mod
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP

U_POINTS = [(0.1, -1.0, -2.0), (-0.3, 0.5, -1.2)]


def sphere_field(n, seed):
    """n unit vectors in R^3 and a smooth field of them plus N(0, 0.09)."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3))
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    y = np.sin(3.0 * xyz[:, 0]) * np.cos(2.0 * xyz[:, 2]) + 0.3 * rng.standard_normal(n)
    return xyz, y


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("shape", [(40, 3), (5, 7, 4)], ids=["flat", "batched"])
def test_dotproduct_numpy_methods_are_the_references(normalize, shape):
    rng = np.random.default_rng(11)
    a = rng.standard_normal(shape)
    b = rng.standard_normal(shape[:-2] + (9, shape[-1]))
    # rows of zero norm take the eps floor
    a[..., 0, :] = 0.0
    ours = distance.DotProduct(normalize=normalize)
    ref = jdistance.DotProduct(normalize=normalize)
    np.testing.assert_array_equal(ours.pairwise_np(a, b), ref.pairwise_np(a, b))
    x = a[..., 1, :]
    np.testing.assert_array_equal(ours.one_to_many_np(x, b), ref.one_to_many_np(x, b))
    if normalize:  # the cosine dissimilarity lies in [0, 2]
        d = ours.pairwise_np(a, b)
        assert d.min() >= 0.0 and d.max() <= 2.0


def test_get_distance_resolves_names_and_passes_instances():
    assert isinstance(distance.get_distance("dotproduct"), distance.DotProduct)
    assert isinstance(distance.get_distance("Euclidean"), distance.Euclidean)
    inst = distance.DotProduct(normalize=False)
    assert distance.get_distance(inst) is inst
    with pytest.raises(KeyError):
        distance.get_distance("manhattan")


@pytest.fixture(scope="module")
def sphere_models():
    coords, y = sphere_field(300, seed=5)
    jm = JaxResponseNNGP(coords, y, kernel="exponential", m=6, backend="xla",
                         distance="dotproduct", dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="exponential", m=6, device="cpu",
                      distance="dotproduct", dtype=torch.float64)
    return jm, tm


def test_dotproduct_response_model_takes_the_dist_layout(sphere_models):
    _, tm = sphere_models
    assert tm.lane_layout == "dist"
    # distances read by the kernels are dissimilarities, not chords
    assert float(tm.tables.tab_a.max()) <= 2.0


@pytest.mark.parametrize("u", U_POINTS)
def test_dotproduct_response_value_and_gradient_match(sphere_models, u):
    jm, tm = sphere_models
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u, jnp.float64))
    ut = torch.tensor(u, dtype=torch.float64, requires_grad=True)
    tv = tm.full_logpost(ut)
    (tg,) = torch.autograd.grad(tv, ut)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8)


def test_dotproduct_latent_model_kriging_weights_match():
    """The latent model's B/F and Vecchia log-density of w on dot-product
    tables, against the reference's at the same state."""
    coords, y = sphere_field(200, seed=6)
    jm = JaxLatentNNGP(coords, y, kernel="exponential", m=5, backend="xla",
                       distance="dotproduct", dtype=jnp.float64)
    tm = LatentNNGP(coords, y, kernel="exponential", m=5, device="cpu",
                    distance="dotproduct", dtype=torch.float64)
    np.testing.assert_array_equal(tm.table.nn_idx, jm.data.table.nn_idx)
    init = {"phi": 0.4, "sigma2": 1.2, "tau2": 0.1}
    js = jm.init_state(jax.random.PRNGKey(0), init)
    ts = tm.init_state(1, init)
    w = np.random.default_rng(1).standard_normal(200)  # ordered sites
    jv, jaux = jm._theta_logpost(js.theta_u, jnp.asarray(w), js.sigma2)
    tv, taux = tm._theta_logpost(ts.theta_u, torch.as_tensor(w)[None], ts.sigma2)
    for key in ("logdet", "quad"):
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]), rtol=1e-8)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)


def test_latent_model_refuses_a_non_euclidean_metric_above_its_threshold(monkeypatch):
    coords, y = sphere_field(120, seed=7)
    monkeypatch.setattr(latent_mod, "NON_EUCLIDEAN_MAX_SITES", 100)
    with pytest.raises(ValueError, match=r"'dotproduct'.*100 sites.*n=120"):
        LatentNNGP(coords, y, m=5, distance="dotproduct", device="cpu",
                   dtype=torch.float64)
    # Euclidean at the same size, and the metric at the threshold, build
    LatentNNGP(coords, y, m=5, device="cpu", dtype=torch.float64)
    LatentNNGP(coords[:100], y[:100], m=5, distance="dotproduct", device="cpu",
               dtype=torch.float64)
    assert latent_mod.NON_EUCLIDEAN_MAX_SITES == 100
    # tables made from the coordinates would be Euclidean: refused
    with pytest.raises(ValueError, match="precompute_distances"):
        LatentNNGP(coords[:100], y[:100], m=5, distance="dotproduct", device="cpu",
                   precompute_distances=False)
