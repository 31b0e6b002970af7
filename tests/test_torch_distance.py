"""The port's distances (``pynngp_tpu_torch.distance``) against the
reference's (``pynngp_tpu.distance``), and the dot-product distance through
both models, float64 on the CPU.

The numpy methods are copies and must agree bit for bit, the tensor methods
agree with the JAX ones at rtol 1e-12; the response model on dot-product
tables must give the reference's value and gradient at rtol 1e-8.  Without
precomputed tables the metric reaches ``vecchia_bf``, ``make_site_tables``
and both models, as in the reference (its tests/test_distance_threading.py).
Above ``NON_EUCLIDEAN_MAX_SITES`` sites the latent model refuses a
non-Euclidean metric, as the reference's does (tested with the constant
lowered)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import distance as jdistance
from pynngp_tpu import kernels as jkernels
from pynngp_tpu import vecchia as jvecchia
from pynngp_tpu.models.latent import LatentNNGP as JaxLatentNNGP
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu.ops import pallas_bf as pb
from pynngp_tpu_torch import convert, distance, kernels, vecchia
from pynngp_tpu_torch.models import latent as latent_mod
from pynngp_tpu_torch.ops import site_tables
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


METRICS = {"euclidean": lambda mod: mod.Euclidean(),
           "normalized": lambda mod: mod.DotProduct(normalize=True),
           "raw": lambda mod: mod.DotProduct(normalize=False)}


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("shape", [(40, 3), (5, 7, 4)], ids=["flat", "batched"])
def test_tensor_methods_match_the_jax_methods(metric, shape):
    """pairwise, pairwise_sq and one_to_many on float64 tensors against the
    reference's jnp methods, a zero row (the eps floor) included."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal(shape)
    b = rng.standard_normal(shape[:-2] + (9, shape[-1]))
    a[..., 0, :] = 0.0
    x = a[..., 1, :]
    ours, ref = METRICS[metric](distance), METRICS[metric](jdistance)
    ta, tb, tx = (torch.as_tensor(v) for v in (a, b, x))
    for name, args, jargs in (("pairwise", (ta, tb), (a, b)),
                              ("pairwise_sq", (ta, tb), (a, b)),
                              ("one_to_many", (tx, tb), (x, b))):
        got = getattr(ours, name)(*args)
        want = np.asarray(getattr(ref, name)(*(jnp.asarray(v) for v in jargs)))
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0, err_msg=name)


def embed_data(n, d=5, seed=21):
    """Unit-norm embeddings, the dot product's home (the reference test's)."""
    x = np.random.default_rng(seed).standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_vecchia_bf_takes_the_metric_without_tables():
    """vecchia_bf(dist_fn=DotProduct()) on data without tables equals the
    reference's recompute and the precomputed tables (the reference's
    test_vecchia_bf_dotproduct_precompute_parity); the Euclidean default
    does not."""
    coords = embed_data(60)
    kern, jkern = kernels.Exponential(), jkernels.Exponential()
    kw = dict(distance="dotproduct", dtype=torch.float64, device="cpu")
    pre, tab = vecchia.make_vecchia_data(coords, 8, **kw)
    rec, _ = vecchia.make_vecchia_data(coords, 8, precompute_distances=False,
                                       table=tab, **kw)
    assert rec.nn_dist is None and rec.nn_cross_dist is None
    jrec, _ = jvecchia.make_vecchia_data(coords, 8, distance="dotproduct",
                                         dtype=jnp.float64,
                                         precompute_distances=False, table=tab)
    params = {"phi": 0.7}
    b1, f1 = vecchia.vecchia_bf(kern, params, pre, alpha=0.1, jitter=0.0)
    b2, f2 = vecchia.vecchia_bf(kern, params, rec, alpha=0.1, jitter=0.0,
                                dist_fn=distance.DotProduct())
    jb, jf = jvecchia.vecchia_bf(jkern, {"phi": jnp.asarray(0.7)}, jrec, alpha=0.1,
                                 jitter=0.0, dist_fn=jdistance.DotProduct())
    for got, want in ((b2, b1), (f2, f1), (b2, jb), (f2, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    y = torch.as_tensor(np.random.default_rng(2).standard_normal(60))
    ll = vecchia.vecchia_loglik(kern, params, rec, y, 1.3, alpha=0.1, jitter=0.0,
                                dist_fn=distance.DotProduct())
    jll = jvecchia.vecchia_loglik(jkern, {"phi": jnp.asarray(0.7)}, jrec,
                                  jnp.asarray(y.numpy()), 1.3, alpha=0.1,
                                  jitter=0.0, dist_fn=jdistance.DotProduct())
    np.testing.assert_allclose(ll.item(), float(jll), rtol=1e-9)
    b3, _ = vecchia.vecchia_bf(kern, params, rec, alpha=0.1, jitter=0.0)
    assert not np.allclose(b3.numpy(), b1.numpy())


@pytest.mark.parametrize("block_elems", [1 << 23, 6000], ids=["one block", "blocks"])
def test_site_tables_take_the_metric_without_tables(block_elems, monkeypatch):
    """make_site_tables(dist_fn=) on data without tables against
    make_lane_cache(dist_fn=) carried across by convert (the reference's
    test_lane_cache_dotproduct_recompute_parity, at its tolerance), in one
    block of sites and in several; the Euclidean default differs."""
    monkeypatch.setattr(site_tables, "_RECOMPUTE_ELEMS", block_elems)
    coords = embed_data(300)
    # float64 coordinates on both sides: both compute in float64 and round
    # the planes once to float32
    jdata, tab = jvecchia.make_vecchia_data(coords, 5, distance="dotproduct",
                                            dtype=jnp.float64,
                                            precompute_distances=False)
    cache = pb.make_lane_cache(jdata, dist_fn=jdistance.DotProduct(), layout="dist")
    want = convert.site_tables_from_lane_cache(
        np.asarray(cache.tab_a), np.asarray(cache.tab_b), np.asarray(cache.nn_idx),
        300)
    data, _ = vecchia.make_vecchia_data(coords, 5, distance="dotproduct",
                                        dtype=torch.float64,
                                        precompute_distances=False, table=tab,
                                        device="cpu")
    got = site_tables.make_site_tables(data, device="cpu",
                                       dist_fn=distance.DotProduct())
    assert got.n_pad == want.n_pad and got.layout == "dist"
    for plane in ("tab_a", "tab_b"):
        np.testing.assert_allclose(getattr(got, plane).numpy(),
                                   getattr(want, plane).numpy(), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got.nn_idx, want.nn_idx, rtol=0, atol=0)
    euclid = site_tables.make_site_tables(data, device="cpu")
    assert not np.allclose(euclid.tab_b.numpy(), got.tab_b.numpy())


@pytest.fixture(scope="module")
def embedded_models():
    """The reference's models (XLA backend) and the port's on the dot
    product, both without precomputed tables, and the port's with them."""
    coords = embed_data(50, seed=31)
    y = np.random.default_rng(32).standard_normal(50)
    kw = dict(kernel="exponential", m=6, distance="dotproduct")
    out = {}
    for name, jcls, tcls in (("response", JaxResponseNNGP, ResponseNNGP),
                             ("latent", JaxLatentNNGP, LatentNNGP)):
        out[name] = (
            jcls(coords, y, backend="xla", dtype=jnp.float64,
                 precompute_distances=False, **kw),
            tcls(coords, y, device="cpu", dtype=torch.float64,
                 precompute_distances=False, **kw),
            tcls(coords, y, device="cpu", dtype=torch.float64, **kw))
    return out


@pytest.mark.parametrize("model", ["response", "latent"])
def test_models_take_the_metric_without_tables(model, embedded_models):
    """Both models with distance="dotproduct", precompute_distances=False
    build (the port refused them before) and give the reference's
    likelihood pieces at rtol 1e-9 (its test_response_model_dotproduct_paths
    and test_latent_model_dotproduct_paths); their tables are the
    precomputed model's."""
    jm, tm, pre = embedded_models[model]
    assert tm.lane_layout == tm.tables.layout == "dist"
    np.testing.assert_array_equal(tm.table.nn_idx, jm.data.table.nn_idx)
    torch.testing.assert_close(tm.tables.tab_a, pre.tables.tab_a, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(tm.tables.tab_b, pre.tables.tab_b, rtol=1e-12, atol=1e-15)
    if model == "response":
        u = [0.0, -1.0, -2.0]
        np.testing.assert_allclose(
            tm.full_loglik(torch.tensor(u, dtype=torch.float64)).item(),
            float(jm.full_loglik(jnp.asarray(u, jnp.float64))), rtol=1e-9)
        aux = tm._suffstats(tm._unconstrained(0.5, 0.2)[None])
        _, _, jld, jq = jm._suffstats(jm._unconstrained(0.5, 0.2),
                                      jnp.zeros((1,), jnp.float64))
        got = (aux["logdet"].item(), aux["quad"].item())
    else:
        w = np.random.default_rng(33).standard_normal(50)
        _, _, ld, q = tm._suffstats(tm._unconstrained(0.5)[None],
                                    torch.as_tensor(w)[None])
        _, _, jld, jq = jm._suffstats(jm._unconstrained(0.5), jnp.asarray(w))
        got = (ld.item(), q.item())
    np.testing.assert_allclose(got, (float(jld), float(jq)), rtol=1e-9)


@pytest.mark.parametrize("entry", ["make_vecchia_data", "make_site_tables"])
def test_the_entry_points_run_on_the_card_unless_asked(entry, monkeypatch):
    """The default device is the card: without one, each raises
    RuntimeError, and runs on the host when device="cpu" is passed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coords = np.random.default_rng(4).uniform(size=(40, 2))
    data, _ = vecchia.make_vecchia_data(coords, 4, device="cpu")
    call = ((lambda **kw: vecchia.make_vecchia_data(coords, 4, **kw))
            if entry == "make_vecchia_data"
            else (lambda **kw: site_tables.make_site_tables(data, **kw)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    out = call(device="cpu")
    out = out[0].coords if entry == "make_vecchia_data" else out.tab_a
    assert out.device.type == "cpu"
    # float64 stays allowed on the host
    assert vecchia.make_vecchia_data(coords, 4, dtype=torch.float64,
                                     device="cpu")[0].coords.dtype == torch.float64


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
    # at the threshold, tables computed from the coordinates take the metric:
    # the precomputed model's
    pre = LatentNNGP(coords[:100], y[:100], m=5, distance="dotproduct",
                     device="cpu", dtype=torch.float64)
    rec = LatentNNGP(coords[:100], y[:100], m=5, distance="dotproduct",
                     device="cpu", dtype=torch.float64, precompute_distances=False)
    torch.testing.assert_close(rec.tables.tab_a, pre.tables.tab_a, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(rec.tables.tab_b, pre.tables.tab_b, rtol=1e-12, atol=1e-15)
