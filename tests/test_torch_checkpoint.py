"""Checkpoint / resume, the config sidecar and run metrics of the port
(``pynngp_tpu_torch.utils.checkpoint``, ``config``, ``utils.metrics`` and the
checkpoints of ``models.base.run_chains_chunked``) against the reference's
(``pynngp_tpu.utils``, ``pynngp_tpu.config``), float64 on the CPU.

Every random number of a port run comes from one ``torch.Generator``, whose
state the checkpoint holds: a run stopped mid-chunk and resumed gives the
draws of the uninterrupted run bit for bit (the reference's own resume test,
tests/test_resume.py, can only compare the restored draws)."""

import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import neighbors as jneighbors
from pynngp_tpu.config import NNGPConfig as JaxNNGPConfig
from pynngp_tpu.utils.metrics import chain_health as jax_chain_health
from pynngp_tpu_torch.config import NNGPConfig
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.samplers.hmc import make_hmc_kernel
from pynngp_tpu_torch.samplers.nuts import make_nuts_kernel
from pynngp_tpu_torch.utils.checkpoint import load_state, save_state
from pynngp_tpu_torch.utils.metrics import MetricsLogger, chain_health
from tests.conftest import simulate_gp_field


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
    return simulate_gp_field(np.random.default_rng(1234), n=100)


@pytest.fixture(scope="module")
def response(field):
    coords, _, y = field
    return ResponseNNGP(coords, y, kernel="sqexp", m=5, dtype=torch.float64,
                        device="cpu")


@pytest.fixture(scope="module")
def latent(field):
    coords, _, y = field
    return LatentNNGP(coords, y, kernel="exponential", m=5, dtype=torch.float64,
                      device="cpu")


def _states(kind, response, latent):
    """A state of each kind, a few steps in, so that no leaf is at its
    initial value by accident."""
    gen = torch.Generator().manual_seed(3)
    if kind == "response":
        state = response.init_state(3)
        for _ in range(3):
            state = response.step(gen, state)
        return state, response.init_state(3)
    if kind == "latent":
        state = latent.init_state(2)
        for _ in range(3):
            state = latent.step(gen, state)
        return state, latent.init_state(2)
    if kind == "generator":
        torch.randn(17, generator=gen)
        return gen.get_state(), torch.Generator().manual_seed(0).get_state()
    make = make_nuts_kernel if kind == "nuts" else make_hmc_kernel
    init, step = make(response.full_value_and_grad, 10)
    u0 = response._warm_init_u(response._full_init_u(), None, 2, gen, 0.1)
    state = step(gen, init(gen, u0))
    return state, init(gen, u0 + 1.0)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for child in tree for leaf in _leaves(child)]


@pytest.mark.parametrize("kind", ["response", "latent", "nuts", "hmc", "generator"])
def test_save_load_round_trip_is_bit_for_bit(kind, response, latent, tmp_path):
    state, template = _states(kind, response, latent)
    path = str(tmp_path / "ckpt")
    save_state(path, state, extra={"iteration": 3})
    restored = load_state(path, template)
    assert type(restored) is type(state)
    a, b = _leaves(state), _leaves(restored)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.device == y.device and x.shape == y.shape
        assert torch.equal(x, y)
    with open(path + ".json") as fh:
        meta = json.load(fh)
    assert meta["n_leaves"] == len(a) and meta["extra"] == {"iteration": 3}


def test_a_restored_generator_repeats_its_stream(tmp_path):
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    save_state(str(tmp_path / "g"), (gen.get_state(),))
    want = torch.randn(8, generator=gen)
    other = torch.Generator().manual_seed(0)
    (state,) = load_state(str(tmp_path / "g"), (other.get_state(),))
    other.set_state(state)
    assert torch.equal(torch.randn(8, generator=other), want)


@pytest.mark.parametrize("fault", ["leaf count", "leaf shape", "config"])
def test_load_state_refuses_a_different_run(fault, response, tmp_path):
    path = str(tmp_path / "ckpt")
    state = response.init_state(3)
    cfg = NNGPConfig(model="response", kernel="sqexp", m=5, n_chains=3)
    save_state(path, state, config=cfg)
    if fault == "leaf count":
        with pytest.raises(ValueError, match="leaves"):
            load_state(path, state[:-1])
    elif fault == "leaf shape":
        with pytest.raises(ValueError, match="shape"):
            load_state(path, response.init_state(4))
    else:
        with pytest.raises(ValueError, match="n_chains"):
            load_state(path, state, config=dataclasses.replace(cfg, n_chains=4))
        load_state(path, state, config=cfg)  # the same config loads


def test_the_reference_resume_scenario(response, tmp_path):
    """tests/test_resume.py on the port: a checkpointed run, then the same
    call again, which resumes from its final checkpoint; here the draws are
    equal bit for bit, all of them."""
    ck = str(tmp_path / "run")
    kw = dict(n_samples=120, n_burn=60, seed=7, chunk=20, checkpoint_path=ck,
              checkpoint_every=1)
    full = response.sample(**kw)
    assert os.path.exists(ck + ".npz")
    resumed = response.sample(**kw)
    assert resumed.keys() == full.keys()
    for key in full:
        assert np.array_equal(resumed[key], full[key])
    assert np.isfinite(resumed["loglik"]).all()


class _Stop(Exception):
    pass


class _Calls:
    """Counts the calls of ``obj.name`` and, once ``limit`` is set, raises
    on the call after it: a run stopped mid-chunk."""

    def __init__(self, obj, name):
        self.obj, self.name, self.orig = obj, name, getattr(obj, name)
        self.calls, self.limit = 0, None
        setattr(obj, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.limit is not None and self.calls > self.limit:
            raise _Stop
        return self.orig(*args, **kwargs)

    def restore(self):
        delattr(self.obj, self.name)


def _run(kind, response, latent, **kw):
    if kind == "response":
        return response.sample(n_samples=40, n_burn=20, n_chains=3, seed=5,
                               chunk=10, **kw)
    if kind == "latent":
        return latent.sample(n_samples=30, n_burn=10, n_chains=2, seed=5,
                             chunk=10, w_every=4, **kw)
    if kind == "hmc":
        return response.sample_hmc(n_samples=20, n_burn=20, n_chains=2, seed=5,
                                   n_leapfrog=8, chunk=10, **kw)
    return response.sample_nuts(n_samples=20, n_burn=20, n_chains=2, seed=5,
                                max_depth=4, chunk=10, **kw)


@pytest.mark.parametrize("kind", ["response", "latent", "nuts", "hmc"])
def test_interrupted_and_resumed_run_equals_the_uninterrupted_run(
        kind, response, latent, tmp_path):
    """The run is stopped five calls of its step (of NUTS's or HMC's value
    and gradient) before its end, inside its last chunk of ten draws and so
    past a checkpoint of draws, then resumed by the same call."""
    model = latent if kind == "latent" else response
    gradient = kind in ("nuts", "hmc")
    calls = _Calls(model, "full_value_and_grad" if gradient else "step")
    try:
        want = _run(kind, response, latent)
        calls.calls, calls.limit = 0, calls.calls - 5
        ck = str(tmp_path / "run")
        with pytest.raises(_Stop):
            _run(kind, response, latent, checkpoint_path=ck, checkpoint_every=1)
    finally:
        calls.restore()
    with open(ck + ".json") as fh:
        assert json.load(fh)["extra"]["draws_done"] > 0
    got = _run(kind, response, latent, checkpoint_path=ck, checkpoint_every=1)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("change", ["collect_every", "thin", "n_chains", "config"])
def test_a_resume_with_another_run_description_raises(change, latent, tmp_path):
    ck = str(tmp_path / "run")
    cfg = NNGPConfig(model="latent", m=5, n_chains=2, n_samples=8, n_burn=4)
    kw = dict(n_samples=8, n_burn=4, n_chains=2, seed=1, chunk=4, w_every=2,
              checkpoint_path=ck, checkpoint_every=1, config=cfg)
    latent.sample(**kw)
    with open(ck + ".config.json") as fh:
        assert json.load(fh) == dataclasses.asdict(cfg)
    other = {"collect_every": dict(w_every=4), "thin": dict(thin=2),
             "n_chains": dict(n_chains=3),
             "config": dict(config=dataclasses.replace(cfg, seed=9))}[change]
    with pytest.raises(ValueError, match="seed" if change == "config" else change):
        latent.sample(**{**kw, **other})


def test_metrics_lines_carry_the_health_fields(response):
    buf = io.StringIO()
    health = lambda s: {"sigma2": s.sigma2, "value": s.value.mean()}
    response.sample(n_samples=6, n_burn=4, n_chains=2, chunk=2, seed=0,
                    metrics=MetricsLogger(stream=buf, run_id="r1"), health_fn=health)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [rec["event"] for rec in lines] == ["burn"] * 2 + ["sample"] * 3
    for rec in lines:
        assert rec["run"] == "r1" and len(rec["sigma2"]) == 2
        assert np.isfinite(rec["value"])


def test_metrics_logger_matches_the_reference_format():
    buf = io.StringIO()
    log = MetricsLogger(stream=buf, run_id="t1")
    log.log("chunk", phase="sample", it=10, accept=np.float32(0.44))
    rec = json.loads(buf.getvalue().strip().split("\n")[0])
    assert rec["event"] == "chunk" and rec["run"] == "t1"
    assert abs(rec["accept"] - 0.44) < 1e-6


def test_chain_health_matches_the_reference():
    rng = np.random.default_rng(5)
    draws = {"sigma2": rng.standard_normal((4, 200)) + 5,
             "phi": rng.standard_normal((1, 150)),
             "diverging": rng.uniform(size=(4, 200)) < 0.05,
             "beta": rng.standard_normal((4, 200, 2))}
    got, want = chain_health(draws), jax_chain_health(draws)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["sigma2"]["ess"], want["sigma2"]["ess"], rtol=1e-12)
    np.testing.assert_allclose(got["sigma2"]["rhat"], want["sigma2"]["rhat"], rtol=1e-12)
    assert np.isnan(got["phi"]["rhat"]) and np.isnan(want["phi"]["rhat"])
    assert got["divergence_rate"] == want["divergence_rate"]


def _config_fields():
    return dict(model="latent", kernel="matern", matern_nu=1.5, m=7,
                ordering="coordinate", sampler="smc", n_particles=512,
                n_chains=2, seed=3, checkpoint_path="/tmp/x", checkpoint_every=2)


def test_a_reference_config_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "cfg.json")
    JaxNNGPConfig(**_config_fields()).save(path)
    got = NNGPConfig.load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(JaxNNGPConfig(**_config_fields()))
    assert got == NNGPConfig(**_config_fields())


def test_a_port_config_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "cfg.json")
    NNGPConfig(**_config_fields()).save(path)
    got = JaxNNGPConfig.load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(NNGPConfig(**_config_fields()))
    assert [f.name for f in dataclasses.fields(NNGPConfig)] == \
        [f.name for f in dataclasses.fields(JaxNNGPConfig)]
    assert NNGPConfig() == NNGPConfig(**dataclasses.asdict(JaxNNGPConfig()))


@pytest.mark.parametrize("model", ["response", "latent"])
def test_build_model_gives_the_configured_model(model, field):
    coords, _, y = field
    cfg = NNGPConfig(model=model, kernel="matern", matern_nu=1.5, m=7)
    built = cfg.build_model(coords, y, dtype=torch.float64, device="cpu")
    assert type(built).__name__ == {"response": "ResponseNNGP",
                                    "latent": "LatentNNGP"}[model]
    assert built.tables.m == 7 and built.kernel.static_nu == 1.5
    assert built.device.type == "cpu" and built.dtype == torch.float64
    # the reference's build_model gives the same class
    ref = JaxNNGPConfig(**dataclasses.asdict(cfg)).build_model(coords, y,
                                                               dtype=jnp.float64)
    assert type(ref).__name__ == type(built).__name__


@pytest.mark.parametrize("change,exc", [
    # mesh_chains and mesh_sites are carried and not read, as in the
    # reference's build_model: the model is unsharded
    (dict(mesh_chains=2), None), (dict(mesh_sites=4), None),
    # the max-min and natural orderings are ported: the model builds on them
    (dict(ordering="maxmin"), None), (dict(ordering="none"), None),
], ids=["change0", "change1", "change2", "change3"])
def test_build_model_raises_on_what_is_not_ported(change, exc, field):
    coords, _, y = field
    if exc is None:
        built = NNGPConfig(**change).build_model(coords, y, dtype=torch.float64,
                                                 device="cpu")
        if "ordering" in change:
            ref = jneighbors.build_neighbor_table(coords, built.tables.m, cache=False,
                                                  **change)
            np.testing.assert_array_equal(built.table.order, ref.order)
            return
        # the reference's build_model builds the same unsharded model
        ref = JaxNNGPConfig(**change).build_model(coords, y, dtype=jnp.float64)
        assert built.mesh is None and ref.mesh is None
        assert type(built).__name__ == type(ref).__name__
        np.testing.assert_array_equal(built.table.order, ref.table.order)
        u = np.array([0.1, -0.3, -2.0])
        want = float(ref.full_loglik(jnp.asarray(u)))
        got = float(built.full_loglik(torch.as_tensor(u)[None])[0])
        np.testing.assert_allclose(got, want, rtol=1e-8)
        return
    with pytest.raises(exc):
        NNGPConfig(**change).build_model(coords, y, dtype=torch.float64, device="cpu")
