"""Both models with ``mesh=`` (a mesh of "cpu" devices) against the
reference's mesh models (``pynngp_tpu``, XLA, float64, meshes of the
conftest's virtual devices) and against the port's unsharded models:
full_loglik and its gradient with and without fixed effects (rtol 1e-8),
the latent model's B/F and sums (rtol 1e-8), the first MWG steps and one
latent step equal to the unsharded model's from the same seed (rtol 1e-8),
SMC's particles split over the chains axis, and a mesh MWG posterior within
4 Monte Carlo standard errors + 2% of the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pynngp_tpu.models.latent import LatentNNGP as JaxLatentNNGP
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import diagnostics
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops.site_tables import ShardedTables
from pynngp_tpu_torch.parallel import make_mesh

N = 240
U_POINTS = np.array([[0.1, -1.0, -2.0], [-0.3, 0.5, -1.2], [0.0, -2.5, -3.0]])
INIT = {"phi": 0.3, "alpha": 0.1, "sigma2": 1.0}


def _mesh(shape):
    return make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _jax_mesh(shape):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return JaxMesh(devs, axis_names=("chains", "sites"))


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
    rng = np.random.default_rng(21)
    coords = rng.uniform(size=(N, 2))
    y = np.sin(6.0 * coords[:, 0]) * np.cos(4.0 * coords[:, 1])
    y = y + 0.3 * rng.standard_normal(N)
    x = np.column_stack([np.ones(N), rng.standard_normal(N)])
    return coords, y, x


@pytest.mark.parametrize("with_x", [False, True], ids=["no_x", "x"])
def test_mesh_full_loglik_and_gradient_match_the_reference(field, with_x):
    coords, y, x = field
    x = x if with_x else None
    yy = y + (0.0 if x is None else x @ np.array([0.5, -1.0]))
    ref = JaxResponseNNGP(coords, yy, kernel="sqexp", m=6, x=x, dtype=jnp.float64,
                          backend="xla", mesh=_jax_mesh((1, 2)))
    ours = ResponseNNGP(coords, yy, kernel="sqexp", m=6, x=x, dtype=torch.float64,
                        device="cpu", mesh=_mesh((1, 2)))
    assert isinstance(ours.tables, ShardedTables)
    u = np.column_stack([U_POINTS] + ([np.tile([0.4, -0.9], (3, 1))] if with_x else []))
    ut = torch.tensor(u, requires_grad=True)
    got = ours.full_loglik(ut)
    g = torch.autograd.grad(got.sum(), ut)[0]
    got = got.detach()
    vg = jax.jit(jax.value_and_grad(ref.full_loglik))
    for c in range(3):
        want, g_want = vg(jnp.asarray(u[c]))
        np.testing.assert_allclose(float(got[c]), float(want), rtol=1e-8)
        np.testing.assert_allclose(g[c].numpy(), np.asarray(g_want), rtol=1e-8,
                                   atol=1e-8)


def test_mesh_latent_suffstats_match_the_reference(field):
    """The latent model's B/F (kernel 3 a shard) and its sums on a (1, 2)
    mesh against the reference's mesh model (``make_sharded_bf``)."""
    coords, y, _ = field
    ref = JaxLatentNNGP(coords, y, kernel="exponential", m=6, dtype=jnp.float64,
                        backend="xla", mesh=_jax_mesh((1, 2)))
    ours = LatentNNGP(coords, y, kernel="exponential", m=6, dtype=torch.float64,
                      device="cpu", mesh=_mesh((1, 2)))
    w = np.random.default_rng(5).standard_normal(N)
    b, f, ld, q = ours._suffstats(ours._unconstrained(0.3)[None],
                                  torch.as_tensor(w)[None])
    b_r, f_r, ld_r, q_r = ref._suffstats(ref._unconstrained(0.3), jnp.asarray(w))
    np.testing.assert_allclose([float(ld[0]), float(q[0])], [float(ld_r), float(q_r)],
                               rtol=1e-8)
    np.testing.assert_allclose(b[0, :, :N].T.numpy(), np.asarray(b_r), rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(f[0, :N].numpy(), np.asarray(f_r), rtol=1e-8)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mesh_steps_equal_the_unsharded_port(field, shape):
    """From the same seed a mesh model's first MWG draws (with and without
    fixed effects) and one latent step equal the unsharded model's, rtol
    1e-8: the chains split over the mesh's rows, the sites over its
    columns."""
    coords, y, x = field
    mesh = _mesh(shape)
    for xx in (None, x):
        kw = dict(kernel="sqexp", m=6, x=xx, dtype=torch.float64, device="cpu")
        one, many = ResponseNNGP(coords, y, **kw), ResponseNNGP(coords, y, mesh=mesh, **kw)
        a = one.sample(4, n_burn=2, n_chains=3, seed=7, init=INIT)
        b = many.sample(4, n_burn=2, n_chains=3, seed=7, init=INIT)
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=1e-8, err_msg=key)
    kw = dict(kernel="exponential", m=6, dtype=torch.float64, device="cpu")
    one, many = LatentNNGP(coords, y, **kw), LatentNNGP(coords, y, mesh=mesh, **kw)
    init = {"phi": 0.3, "sigma2": 1.0, "tau2": 0.1}
    s1 = one.step(torch.Generator().manual_seed(11), one.init_state(3, init))
    s2 = many.step(torch.Generator().manual_seed(11), many.init_state(3, init))
    for name, a in s1._asdict().items():
        np.testing.assert_allclose(getattr(s2, name).numpy(), a.numpy(), rtol=1e-8,
                                   atol=1e-11, err_msg=name)


def test_mesh_smc_splits_the_particles_over_the_chains_axis(field):
    """SMC on a (2, 1) mesh: every evaluation of the particles is one launch
    a chain row, and the run is the unsharded one's."""
    coords, y, _ = field
    kw = dict(kernel="exponential", m=6, dtype=torch.float64, device="cpu")
    one = ResponseNNGP(coords, y, **kw)
    many = ResponseNNGP(coords, y, mesh=_mesh((2, 1)), **kw)
    a, info_a = one.sample_smc(n_particles=32, n_move=2, seed=3, max_stages=4)
    b, info_b = many.sample_smc(n_particles=32, n_move=2, seed=3, max_stages=4)
    assert len(info_a) == len(info_b)
    np.testing.assert_allclose(b["log_z"], a["log_z"], rtol=1e-8)
    for key in ("sigma2", "phi", "tau2", "logw"):
        np.testing.assert_allclose(b[key], a[key], rtol=1e-8, atol=1e-10, err_msg=key)


def test_mesh_mwg_posterior_agrees_with_the_reference(field):
    """A (2, 2) mesh MWG run and the reference's mesh MWG run (4 chains x
    500 draws after 200 each) target the same posterior: the means of
    sigma2, phi and tau2 agree within 4 combined Monte Carlo standard errors
    (sd / sqrt(ESS) each) plus 2% of the reference's."""
    coords, y, _ = field
    ours = ResponseNNGP(coords, y, kernel="sqexp", m=6, dtype=torch.float64,
                        device="cpu", mesh=_mesh((2, 2)))
    ref = JaxResponseNNGP(coords, y, kernel="sqexp", m=6, dtype=jnp.float64,
                          backend="xla", mesh=_jax_mesh((2, 2)))
    a = ours.sample(500, n_burn=200, n_chains=4, seed=1, init=INIT)
    b = ref.sample(500, n_burn=200, n_chains=4, seed=0, init=INIT)
    for key in ("sigma2", "phi", "tau2"):
        pa, pb = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
        se2 = pa.var() / diagnostics.ess(pa) + pb.var() / diagnostics.ess(pb)
        assert abs(pa.mean() - pb.mean()) <= 4.0 * np.sqrt(se2) + 0.02 * abs(pb.mean()), (
            key, pa.mean(), pb.mean(), np.sqrt(se2))
