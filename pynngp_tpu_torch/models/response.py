"""Response NNGP model: y ~ NNGP(0, sigma2 (rho_phi + alpha I)) with
alpha = tau2/sigma2 (counterpart of ``pynngp_tpu.models.response``).

Ported: homogeneous and heterogeneous noise (``noise``: per-site variance
tau2 v_i with known weights v, so that the relative nugget is alpha v), one
device or a (chains, sites) mesh of them (``mesh``, ``parallel.make_mesh``),
both table layouts (``lane_layout``:
"dist", distance planes; "coords", coordinate planes with the distances
recomputed in the kernels, Euclidean only; "auto", the default, coords above
``site_tables.COORDS_LAYOUT_MIN_SITES`` sites), every kernel of
:mod:`pynngp_tpu_torch.kernels`, the general and the sampled-nu Matern among
them; fixed effects (``x=``) on every path; every ordering ("coordinate",
"maxmin", "none") and both distances (Euclidean; "dotproduct", whose
dissimilarities the kernels read from dist-layout tables).  ``backend`` is
taken and ignored: the port has one.  Every other option of the reference
raises.

On a mesh the site tables are cut over its sites axis
(``ops.site_tables.shard_site_tables``) and every kernel launch of the model
becomes one launch a mesh cell, the chains split over its chain rows; the
sums add up, and B/F and the y cotangent's planes are gathered, on the
mesh's first device, where the model's state and data live.  With fixed
effects the gradient samplers run on the kernels too (the y cotangent runs
over the gathered planes), where the reference's mesh falls back to XLA
(``pynngp_tpu/models/response.py:117-122``).

Sampler (Metropolis-within-Gibbs, batched over C chains):
  - theta = (phi, alpha) block, (phi, alpha, nu) with ``Matern()``: Metropolis on unconstrained coordinates
    against the sigma2-collapsed marginal (``collapsed=True``, the default)
    or the sigma2-conditioned target; componentwise, joint, correlated-joint
    or pilot-fitted independence-mixture proposals.  Every proposal is one
    fused suffstats launch for all chains (kernel 1), or with fixed effects
    one B/F build (kernel 3, ``ops/bf.py``) whose weights the beta draw
    reuses;
  - sigma2: conjugate inverse-gamma draw;
  - beta: conjugate Gaussian draw through the whitened design (I - B) X;
  - step sizes adapt (Robbins-Monro) during burn-in.
``fit_map`` runs Adam on ``full_logpost`` and a Laplace fit through the
differentiable suffstats (kernel 2 on the GPU).

``sample_nuts`` and ``sample_hmc`` sample the joint unconstrained posterior
u = [log sigma2, logit phi, log tau2, (logit nu,) beta...] of all chains at
once (logit nu with ``Matern()`` only): every
leapfrog step is one ``full_logpost`` value and gradient, one launch of
kernel 2 for all chains.  With fixed effects the residual y - X beta_c
differs by chain and its gradient flows back through the y cotangent of the
differentiable suffstats (the EMIT_Y instances of kernel 2).

Where u lives.  ``full_logpost`` runs its transforms and priors on the device
of the u it is given; only (phi, alpha, nu) and, with fixed effects, beta cross to
the card, and the (C,) sums come back.  ``fit_map``, ``sample_nuts`` and
``sample_hmc`` keep u, a few numbers per chain, on the host: the tree, the
warmup and the priors are then host arithmetic instead of hundreds of tiny
kernel launches per leapfrog step, and the card runs kernel 2 (and the
y-cotangent gather).  The MWG sampler's state stays on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pynngp_tpu_torch.distance import Euclidean, get_distance
from pynngp_tpu_torch.kernels import get_kernel
from pynngp_tpu_torch.models.base import (
    check_device,
    default_priors,
    prepare_spatial_data,
    run_chains_chunked,
)
from pynngp_tpu_torch.noise import get_noise
from pynngp_tpu_torch.ops.bf import bf_planes, plane_suffstats
from pynngp_tpu_torch.ops.diff_suffstats import diff_suffstats
from pynngp_tpu_torch.ops.geometry import check_card_m
from pynngp_tpu_torch.ops.site_tables import (
    choose_layout,
    make_site_tables,
    shard_site_tables,
    with_children,
)
from pynngp_tpu_torch.ops.suffstats import noise_plane, suffstats
from pynngp_tpu_torch.priors import log_transform, logit_transform
from pynngp_tpu_torch.samplers.hmc import make_hmc_kernel
from pynngp_tpu_torch.samplers.mapfit import map_fit, value_and_grad
from pynngp_tpu_torch.samplers.mwg import (
    adapt_log_step,
    mh_indep_mix,
    rw_joint,
    rw_joint_corr,
    rw_sweep,
    sample_gaussian_precision,
    sample_inverse_gamma,
)
from pynngp_tpu_torch.samplers.nuts import make_nuts_kernel
from pynngp_tpu_torch.samplers.smc import smc_sample
from pynngp_tpu_torch.samplers.vi import advi_fit, advi_sample
from pynngp_tpu_torch.vecchia import LOG_2PI

__all__ = ["ResponseNNGP", "ResponseState"]


class ResponseState(NamedTuple):
    """Batched sampler state; every field has a leading chain axis C."""

    theta_u: torch.Tensor  # (C, k) unconstrained (logit phi, log alpha[, logit nu])
    sigma2: torch.Tensor  # (C,)
    beta: torch.Tensor  # (C, max(p, 1)) fixed effects
    value: torch.Tensor  # (C,) cached theta-block log-posterior
    logdet: torch.Tensor  # (C,)
    quad: torch.Tensor  # (C,)
    b: torch.Tensor  # (C, m, n_pad) plane-major weights; (C, 1, 1) at p = 0
    f: torch.Tensor  # (C, n_pad); (C, 1) at p = 0
    log_steps: torch.Tensor  # (C, k) RW proposal scales
    accept: torch.Tensor  # (C, k) running acceptance-probability sums
    iteration: torch.Tensor  # (C,) int32


def _numpy(x):
    return torch.as_tensor(x).detach().cpu().numpy()


class ResponseNNGP:
    """User-facing response-model API.

    ``device`` is "cuda" (the fused CUDA kernels, float32 only) or "cpu"
    (their plain PyTorch versions, any float dtype); there is no automatic
    choice, and "cuda" without a card raises.

    ``lane_layout`` is the reference's: "auto" takes the coords table layout
    above ``site_tables.COORDS_LAYOUT_MIN_SITES`` sites and the dist layout
    at or below; "coords" with a metric other than Euclidean falls back to
    dist.  On the coords layout no distance table is made;
    ``precompute_distances=False`` leaves the dist layout to compute its
    tables from the float64 ordered coordinates under the model's metric,
    in blocks of sites, so that no (n, m, m) array is made.

    ``mesh``: a (chains, sites) mesh (``parallel.make_mesh``) to shard the
    sites and chains over; the model then lives on its first device, whose
    type ``device`` names."""

    def __init__(
        self,
        coords,
        y,
        kernel="sqexp",
        m: int = 15,
        x=None,
        ordering: str = "coordinate",
        distance: str = "euclidean",
        priors: Optional[dict] = None,
        dtype=torch.float32,
        jitter: float = 1e-6,
        joint_theta: bool = False,
        collapsed: bool = True,
        precompute_distances: bool = True,
        backend: str = "auto",
        lane_layout: str = "auto",
        mesh=None,
        noise="homogeneous",
        device="cuda",
    ):
        self.mesh = mesh
        self.noise = get_noise(noise)
        self.device = device = check_device(device, dtype, mesh)
        self.kernel = get_kernel(kernel)
        self.dtype = dtype
        self.jitter = jitter
        self.joint_theta = joint_theta
        # the theta block targets the sigma2-collapsed marginal by default
        # (same joint posterior, far better mixing on the (sigma2, phi) ridge)
        self.collapsed = collapsed

        coords = np.asarray(coords)
        self.dist_fn = dist_fn = get_distance(distance)
        euclidean = isinstance(dist_fn, Euclidean)
        self.lane_layout = choose_layout(lane_layout, coords.shape[0], euclidean)
        on_coords = self.lane_layout == "coords"
        sd = prepare_spatial_data(
            coords, y, m, x=x, ordering=ordering, distance=distance, dtype=dtype,
            device=device, precompute_distances=precompute_distances and not on_coords)
        self.table = sd.table
        self.n = sd.y.shape[0]
        self.y, self.x = sd.y, sd.x
        self.p = 0 if sd.x is None else sd.x.shape[1]
        # the coords layout and the dist layout's recompute take the float64
        # ordered coordinates
        self.tables = make_site_tables(
            sd.vecchia, dtype=dtype, device=device, layout=self.lane_layout,
            coords_host=coords[sd.table.order], dist_fn=dist_fn,
            shards=1 if mesh is None else mesh.shape["sites"])
        if device.type == "cuda":
            check_card_m(self.tables.n_pad, self.tables.m)
        # heterogeneous noise: the weights v permuted into ordered site space
        # (the reference's response.py:159-165) and padded for the kernels;
        # the relative nugget becomes alpha v
        self._noise_v = None
        if self.noise.name == "heterogeneous":
            v = np.asarray(self.noise.v.cpu(), dtype=np.float64)
            if v.shape != (self.n,):
                raise ValueError(f"the noise weights v must have shape ({self.n},), "
                                 f"got {v.shape}")
            self._noise_v = noise_plane(self.tables, v[sd.table.order])
        if self.p:
            # (m, n) neighbor ids, plane-major like B, and X at the neighbors
            self._nbr = torch.as_tensor(sd.table.nn_idx.T.astype(np.int64),
                                        device=device)
            self._x_nbr = self.x[self._nbr]  # (m, n, p)
            # reverse neighbor index, for the y cotangent of full_loglik
            self.tables = with_children(self.tables)
        if mesh is not None:
            self.tables = shard_site_tables(self.tables, mesh)

        self.priors = default_priors(coords, y, priors)
        # Metropolis block layout: [phi, alpha(, nu)]
        self._sample_nu = self.kernel.samples_nu
        self.theta_names = ("phi", "alpha") + (("nu",) if self._sample_nu else ())
        pp = self.priors["phi"]
        self._t_phi = logit_transform(pp.lo, pp.hi)
        self._t_alpha = log_transform
        if self._sample_nu:
            pn = self.priors["nu"]
            self._t_nu = logit_transform(pn.lo, pn.hi)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # ---- parameter plumbing -------------------------------------------
    def _natural(self, theta_u):
        out = {"phi": self._t_phi.forward(theta_u[..., 0]),
               "alpha": self._t_alpha.forward(theta_u[..., 1])}
        if self._sample_nu:
            out["nu"] = self._t_nu.forward(theta_u[..., 2])
        return out

    def _unconstrained(self, phi, alpha, nu=None):
        vals = [self._t_phi.inverse(self._tensor(phi)),
                self._t_alpha.inverse(self._tensor(alpha))]
        if self._sample_nu:
            vals.append(self._t_nu.inverse(self._tensor(nu)))
        return torch.stack(vals)

    def _log_prior_nu(self, nu, nu_u):
        """Prior + Jacobian of a sampled nu; 0 for a kernel that samples none."""
        if not self._sample_nu:
            return 0.0
        return self.priors["nu"].logpdf(nu) + self._t_nu.log_jac(nu_u)

    def _log_prior_theta(self, theta_u, nat, sigma2):
        """Prior + Jacobian of the Metropolis block given sigma2 (tau2 =
        alpha sigma2 carries the IG tau2 prior, Jacobian d tau2/d alpha =
        sigma2)."""
        lp = (self.priors["phi"].logpdf(nat["phi"])
              + self._t_phi.log_jac(theta_u[..., 0]))
        tau2 = nat["alpha"] * sigma2
        lp = lp + (self.priors["tau2"].logpdf(tau2) + torch.log(sigma2)
                   + self._t_alpha.log_jac(theta_u[..., 1]))
        return lp + self._log_prior_nu(nat.get("nu"), theta_u[..., -1])

    # ---- likelihood pieces --------------------------------------------
    def _suffstats(self, theta_u, beta=None):
        """Per-chain likelihood pieces as an aux dict.  Without fixed effects
        {logdet, quad} from one fused forward launch; with them the residual
        y - X beta differs per chain, so B/F are built explicitly (kernel 3)
        and kept: {b, f, logdet, quad}."""
        nat = self._natural(theta_u)
        if self.p == 0:
            logdet, quad, _, _ = suffstats(self.kernel, self.tables, nat["phi"],
                                           nat["alpha"], self.y, self.jitter,
                                           nat.get("nu"), self._noise_v)
            return {"logdet": logdet, "quad": quad}
        b, f = bf_planes(self.kernel, self.tables, nat["phi"], nat["alpha"],
                         self.jitter, nat.get("nu"), self._noise_v)
        logdet, quad, _ = plane_suffstats(b, f, self.y - beta @ self.x.T,
                                          self._nbr)
        return {"b": b, "f": f, "logdet": logdet, "quad": quad}

    def _theta_logpost(self, theta_u, sigma2, beta=None):
        aux = self._suffstats(theta_u, beta)
        logdet, quad = aux["logdet"], aux["quad"]
        nat = self._natural(theta_u)
        if self.collapsed:
            value = self._collapsed_value(theta_u, nat, logdet, quad)
        else:
            value = -0.5 * (logdet + quad / sigma2) + self._log_prior_theta(
                theta_u, nat, sigma2)
        return value, aux

    def _collapsed_value(self, theta_u, nat, logdet, quad):
        """Metropolis target with sigma2 integrated out analytically.

        p(y, sigma2, phi, alpha) carries sigma2 only as
        (sigma2)^{-(A+1)} exp(-B/sigma2) with A = a_s + a_t + n/2 and
        B = b_s + b_t/alpha + quad/2, so the integral is Gamma(A) B^{-A};
        the conjugate sigma2 | theta draw afterwards is exact, so the joint
        stationary distribution is unchanged (partially collapsed Gibbs)."""
        a_big = self.priors["sigma2"].a + self.priors["tau2"].a + 0.5 * self.n
        b_big = (self.priors["sigma2"].b + self.priors["tau2"].b / nat["alpha"]
                 + 0.5 * quad)
        lp = (self.priors["phi"].logpdf(nat["phi"])
              + self._t_phi.log_jac(theta_u[..., 0])
              - (self.priors["tau2"].a + 1.0) * torch.log(nat["alpha"])
              + self._t_alpha.log_jac(theta_u[..., 1])
              + self._log_prior_nu(nat.get("nu"), theta_u[..., -1]))
        return -0.5 * logdet - a_big * torch.log(b_big) + lp

    def loglik(self, state: ResponseState):
        return -0.5 * (self.n * (LOG_2PI + torch.log(state.sigma2))
                       + state.logdet + state.quad / state.sigma2)

    # ---- sampler -------------------------------------------------------
    def init_state(self, n_chains: int = 1, init: Optional[dict] = None):
        """The same starting state for every chain."""
        init = init or {}
        var_y = torch.var(self.y, unbiased=False)
        pp = self.priors["phi"]
        theta_u = self._unconstrained(init.get("phi", 0.5 * (pp.lo + pp.hi)),
                                      init.get("alpha", 0.1), init.get("nu", 1.0))
        k = len(self.theta_names)
        theta_u = theta_u.expand(n_chains, k).clone()
        sigma2 = self._tensor(init.get("sigma2", 0.9 * var_y)).expand(n_chains).clone()
        beta = torch.zeros((n_chains, max(self.p, 1)), dtype=self.dtype,
                           device=self.device)
        if self.p and "beta" in init:
            beta = self._tensor(init["beta"]).expand(n_chains, self.p).clone()
        value, aux = self._theta_logpost(theta_u, sigma2, beta)
        if self.p == 0:  # B and F are never materialised without fixed effects
            aux["b"] = torch.zeros((n_chains, 1, 1), dtype=self.dtype,
                                   device=self.device)
            aux["f"] = torch.ones((n_chains, 1), dtype=self.dtype,
                                  device=self.device)
        return ResponseState(
            theta_u=theta_u,
            sigma2=sigma2,
            beta=beta,
            value=value,
            logdet=aux["logdet"],
            quad=aux["quad"],
            b=aux["b"],
            f=aux["f"],
            log_steps=torch.full((n_chains, k), math.log(0.1), dtype=self.dtype,
                                 device=self.device),
            accept=torch.zeros((n_chains, k), dtype=self.dtype, device=self.device),
            iteration=torch.zeros(n_chains, dtype=torch.int32, device=self.device),
        )

    def step(self, gen, state: ResponseState, n_adapt: int = 10**9,
             prop_chol=None, prop_center=None):
        """One MWG iteration of every chain."""
        # 1. Metropolis block on (phi, alpha) | sigma2, beta.  With fixed
        # effects the aux carries (b, f): the accepted pair is kept per chain
        # by torch.where over the whole (C, m, n_pad) tensor.
        logpost = lambda u: self._theta_logpost(u, state.sigma2, state.beta)
        aux = {"logdet": state.logdet, "quad": state.quad}
        if self.p:
            aux.update(b=state.b, f=state.f)
        if prop_center is not None:
            # independence-MH mixture from a pilot-fitted t proposal
            theta_u, value, aux, aprobs = mh_indep_mix(
                gen, state.theta_u, state.value, aux, logpost, prop_center,
                prop_chol, state.log_steps[:, 0], target=0.3,
            )
        elif prop_chol is not None:
            theta_u, value, aux, aprobs = rw_joint_corr(
                gen, state.theta_u, state.value, aux, logpost,
                state.log_steps[:, 0], prop_chol,
            )
        else:
            sweep = rw_joint if self.joint_theta else rw_sweep
            theta_u, value, aux, aprobs = sweep(
                gen, state.theta_u, state.value, aux, logpost, state.log_steps
            )
        nat = self._natural(theta_u)

        # 2. sigma2 | theta: conjugate IG; the IG(a_t, b_t) prior on
        # tau2 = alpha sigma2 contributes (a_t, b_t/alpha)
        pr_s, pr_t = self.priors["sigma2"], self.priors["tau2"]
        sigma2 = sample_inverse_gamma(
            gen, pr_s.a + pr_t.a + 0.5 * self.n,
            pr_s.b + pr_t.b / nat["alpha"] + 0.5 * aux["quad"],
        )

        # 3. beta | theta, sigma2: conjugate Gaussian via the whitened design
        beta, quad = state.beta, aux["quad"]
        if self.p:
            eps = torch.randn(state.beta.shape, generator=gen, dtype=self.dtype,
                              device=self.device)
            beta, quad = self._draw_beta(aux["b"], aux["f"], sigma2, eps)[:2]

        # 4. refresh the cached theta-block value for the new (sigma2, beta)
        if self.collapsed:
            value = self._collapsed_value(theta_u, nat, aux["logdet"], quad)
        else:
            value = -0.5 * (aux["logdet"] + quad / sigma2) + \
                self._log_prior_theta(theta_u, nat, sigma2)

        # 5. adaptation (multivariate proposals target ~0.3)
        target = 0.3 if prop_chol is not None else 0.44
        log_steps = adapt_log_step(state.log_steps, aprobs, state.iteration,
                                   n_adapt, target=target)
        return ResponseState(
            theta_u=theta_u,
            sigma2=sigma2,
            beta=beta,
            value=value,
            logdet=aux["logdet"],
            quad=quad,
            b=aux.get("b", state.b),
            f=aux.get("f", state.f),
            log_steps=log_steps,
            accept=state.accept + aprobs,
            iteration=state.iteration + 1,
        )

    def _draw_beta(self, b, f, sigma2, eps):
        """beta | theta, sigma2 from standard normals ``eps`` (C, p), through
        the whitened design X~ = (I - B) X and y~ = (I - B) y with weights
        1 / (sigma2 F).  Returns (beta, refreshed quad, mean, Cholesky factor
        of the precision)."""
        n = self.n
        b = b[:, :, :n]
        x_t = self.x - torch.einsum("cmn,mnp->cnp", b, self._x_nbr)  # (C, n, p)
        y_t = self.y - (b * self.y[self._nbr]).sum(1)  # (C, n)
        f = f[:, :n]
        d_inv = 1.0 / (sigma2[:, None] * f)
        eye = torch.eye(self.p, dtype=self.dtype, device=self.device)
        prec = (x_t.mT @ (x_t * d_inv[..., None])
                + eye / self.priors["beta_scale"] ** 2)
        rhs = (x_t.mT @ (y_t * d_inv)[..., None])[..., 0]
        beta, mean, chol = sample_gaussian_precision(prec, rhs, eps)
        resid = y_t - (x_t @ beta[..., None])[..., 0]
        quad = (resid * resid / f).sum(-1, dtype=torch.float64).to(f.dtype)
        return beta, quad, mean, chol

    def collect(self, state: ResponseState):
        nat = self._natural(state.theta_u)
        out = {
            "sigma2": state.sigma2,
            "tau2": nat["alpha"] * state.sigma2,
            "phi": nat["phi"],
            "loglik": self.loglik(state),
        }
        if self._sample_nu:
            out["nu"] = nat["nu"]
        if self.p:
            out["beta"] = state.beta
        return out

    # ---- the joint posterior (MAP / Laplace / NUTS / HMC) ---------------
    # u = [log sigma2, logit phi, log tau2, (logit nu,) beta...]; a
    # (B, full_dim) batch of points is a batch of chains in the fused kernels.
    def _unpack_full(self, u):
        """(natural parameters, beta (..., p)) of u (..., full_dim)."""
        nat = {"sigma2": torch.exp(u[..., 0]),
               "phi": self._t_phi.forward(u[..., 1]),
               "tau2": torch.exp(u[..., 2])}
        if self._sample_nu:
            nat["nu"] = self._t_nu.forward(u[..., 3])
        first = self.full_dim() - self.p
        return nat, u[..., first:first + self.p]

    def full_dim(self) -> int:
        return 3 + int(self._sample_nu) + self.p

    def full_loglik(self, u):
        """log p(y | u) per point of u (..., full_dim)."""
        nat, beta = self._unpack_full(u)
        sigma2, phi = nat["sigma2"], nat["phi"]
        alpha = nat["tau2"] / sigma2
        y = self.y
        if self.p:
            # per-point residual (B, n): its beta gradient, -dy' X, is this
            # product's own backward; dy comes from the kernel's EMIT_Y outputs
            y = self.y - beta.reshape(-1, self.p).to(self.device) @ self.x.T
        nu = nat["nu"].reshape(-1) if self._sample_nu else None
        logdet, quad = diff_suffstats(self.kernel, self.tables, phi.reshape(-1),
                                      alpha.reshape(-1), y, self.jitter, nu,
                                      self._noise_v)
        logdet, quad = logdet.reshape(phi.shape), quad.reshape(phi.shape)
        return -0.5 * (self.n * (LOG_2PI + torch.log(sigma2)) + logdet
                       + quad / sigma2)

    def full_logprior(self, u):
        """log p(u): priors + transform Jacobians on the unconstrained vector."""
        nat, beta = self._unpack_full(u)
        lp = self.priors["sigma2"].logpdf(nat["sigma2"]) + u[..., 0]
        lp = lp + self.priors["phi"].logpdf(nat["phi"]) + self._t_phi.log_jac(u[..., 1])
        lp = lp + self.priors["tau2"].logpdf(nat["tau2"]) + u[..., 2]
        if self._sample_nu:
            lp = lp + self._log_prior_nu(nat["nu"], u[..., 3])
        if self.p:
            lp = lp - 0.5 * ((beta / self.priors["beta_scale"]) ** 2).sum(-1)
        return lp

    def full_logpost(self, u):
        """log p(u | y) up to a constant, the NUTS/HMC/MAP target;
        differentiable through kernel 2."""
        return self.full_loglik(u) + self.full_logprior(u)

    def full_value_and_grad(self, u):
        """(log p(u | y) (C,), its gradient (C, full_dim)) at the points u
        (C, full_dim), on u's device: one launch of kernel 2 for all of them."""
        return value_and_grad(self.full_logpost, u)

    def _full_init_u(self, init: Optional[dict] = None):
        init = init or {}
        var_y = torch.var(self.y, unbiased=False)
        pp = self.priors["phi"]
        vals = [
            torch.log(self._tensor(init.get("sigma2", 0.9 * var_y))),
            self._t_phi.inverse(self._tensor(init.get("phi", 0.5 * (pp.lo + pp.hi)))),
            torch.log(self._tensor(init.get("tau2", 0.1 * var_y))),
        ]
        if self._sample_nu:
            vals.append(self._t_nu.inverse(self._tensor(init.get("nu", 1.0))))
        u = torch.stack(vals)
        if self.p:
            beta = self._tensor(init.get("beta", 0.0)).expand(self.p)
            u = torch.cat([u, beta])
        return u

    def _warm_init_u(self, init_u, init_inv_mass, n_chains, gen, init_jitter):
        """Per-chain starts (C, full_dim) around a point, dispersed by
        ``init_jitter`` posterior standard deviations per coordinate (the
        diagonal of a dense Laplace metric; 1 without a metric)."""
        host = lambda a: torch.as_tensor(a, dtype=self.dtype).to(gen.device)
        u = host(init_u)
        if init_inv_mass is None:
            scale = torch.ones_like(u)
        else:
            im = host(init_inv_mass)
            scale = torch.sqrt(torch.diagonal(im) if im.dim() == 2 else im)
        eps = torch.randn((n_chains, u.shape[0]), generator=gen, dtype=self.dtype,
                          device=gen.device)
        return u + init_jitter * scale * eps

    def fit_map(self, n_steps: int = 300, learning_rate: float = 5e-2,
                init: Optional[dict] = None, seed: int = 0):
        """Adam MAP + Laplace approximation on the joint unconstrained
        posterior (samplers/mapfit.py); u and the result live on the host.
        ``seed`` is the reference's and changes nothing: the start is
        deterministic (its ``_full_init_u(..., jitter=0.0)``)."""
        return map_fit(self.full_logpost, self._full_init_u(init).cpu(),
                       n_steps=n_steps, learning_rate=learning_rate)

    def _collect_full(self, state, info_keys=()):
        nat, beta = self._unpack_full(state.z)
        out = dict(nat)
        out["logpost"] = state.value
        out["diverging"] = state.info.diverging
        for key in info_keys:
            out[key] = getattr(state.info, key)
        if self.p:
            out["beta"] = beta
        return out

    def _sample_gradient(self, make_kernel, info_keys, n_samples, n_burn, thin,
                         n_chains, seed, init, init_u, init_inv_mass,
                         init_jitter, driver_kwargs):
        """The shared body of sample_nuts and sample_hmc: per-chain starts,
        the sampler's (init, step) pair on full_value_and_grad, and
        run_chains_chunked; ``info_keys`` names the sampler's own per-draw
        diagnostics.  The sampler's state and its generator are on the host."""
        gen = torch.Generator().manual_seed(seed)
        if init_inv_mass is not None:
            init_inv_mass = torch.as_tensor(init_inv_mass, dtype=self.dtype).cpu()
        init_kernel, step_kernel = make_kernel(self.full_value_and_grad,
                                               init_inv_mass)

        def init_fn(chains):
            if init_u is not None:
                u0 = self._warm_init_u(init_u, init_inv_mass, chains, gen,
                                       init_jitter)
            else:  # a cold start: a small jitter for overdispersed chains
                u0 = self._warm_init_u(self._full_init_u(init), None, chains,
                                       gen, 0.1)
            return init_kernel(gen, u0)

        collect = lambda state: self._collect_full(state, info_keys)
        _, draws = run_chains_chunked(gen, init_fn, step_kernel, collect,
                                      n_chains, n_samples, n_burn, thin,
                                      **driver_kwargs)
        if n_chains == 1:
            draws = {k: v[0] for k, v in draws.items()}
        return draws

    def sample_nuts(self, n_samples: int, n_burn: int = 500, thin: int = 1,
                    n_chains: int = 1, seed: int = 0, max_depth: int = 8,
                    target_accept: float = 0.8, init: Optional[dict] = None,
                    init_u=None, init_inv_mass=None, init_jitter: float = 1.0,
                    **driver_kwargs):
        """NUTS over the joint hyperparameter (+ fixed-effect) posterior;
        returns numpy draws (n_chains, n_samples) of sigma2, phi, tau2, nu
        when it is sampled, logpost, diverging, the tree's depth and n_leapfrog, and beta with
        fixed effects.

        Warm start (``fit_map``): ``init_u`` starts every chain at that
        unconstrained point, dispersed by ``init_jitter`` posterior standard
        deviations (``sqrt(init_inv_mass)`` per coordinate);
        ``init_inv_mass`` also seeds the inverse metric: a (d,) diagonal
        that warmup refines, or a dense (d, d) matrix frozen through warmup
        (e.g. ``fit_map().laplace_cov``)."""
        make = lambda vg, im: make_nuts_kernel(vg, n_burn, max_depth,
                                               target_accept, init_inv_mass=im)
        return self._sample_gradient(make, ("depth", "n_leapfrog"), n_samples,
                                     n_burn, thin, n_chains, seed, init, init_u,
                                     init_inv_mass, init_jitter, driver_kwargs)

    def sample_hmc(self, n_samples: int, n_burn: int = 500, thin: int = 1,
                   n_chains: int = 1, seed: int = 0, n_leapfrog: int = 32,
                   target_accept: float = 0.8, init: Optional[dict] = None,
                   init_u=None, init_inv_mass=None, init_jitter: float = 1.0,
                   **driver_kwargs):
        """Fixed-length (jittered) HMC over the joint posterior, with the
        warm-start options of :meth:`sample_nuts`; its draws carry
        accept_prob in place of the tree's diagnostics."""
        make = lambda vg, im: make_hmc_kernel(vg, n_burn, n_leapfrog,
                                              target_accept, init_inv_mass=im)
        return self._sample_gradient(make, ("accept_prob",), n_samples, n_burn,
                                     thin, n_chains, seed, init, init_u,
                                     init_inv_mass, init_jitter, driver_kwargs)

    def sample_prior_u(self, gen: torch.Generator, n: int):
        """n unconstrained vectors (n, full_dim) from the prior, on ``gen``'s
        device (SMC's initial particles): sigma2 and tau2 inverse-gamma (as
        scale / Gamma(shape) draws from ``gen``), phi and nu uniform inside
        their bounds by 1e-6, beta N(0, (0.1 beta_scale)^2)."""
        like = dict(dtype=self.dtype, device=gen.device)
        pr_s, pr_t = self.priors["sigma2"], self.priors["tau2"]
        sigma2 = sample_inverse_gamma(gen, pr_s.a, torch.full((n,), pr_s.b, **like))
        tau2 = sample_inverse_gamma(gen, pr_t.a, torch.full((n,), pr_t.b, **like))

        def uniform(prior):
            lo, hi = prior.lo + 1e-6, prior.hi - 1e-6
            return lo + (hi - lo) * torch.rand((n,), generator=gen, **like)

        cols = [torch.log(sigma2), self._t_phi.inverse(uniform(self.priors["phi"])),
                torch.log(tau2)]
        if self._sample_nu:
            cols.append(self._t_nu.inverse(uniform(self.priors["nu"])))
        u = torch.stack(cols, dim=1)
        if self.p:
            beta = 0.1 * self.priors["beta_scale"] * torch.randn(
                (n, self.p), generator=gen, **like)
            u = torch.cat([u, beta], dim=1)
        return u

    def _draws_of(self, u) -> dict:
        """Numpy draws of the natural parameters (and beta) of points u."""
        nat, beta = self._unpack_full(u)
        draws = {k: _numpy(v) for k, v in nat.items()}
        if self.p:
            draws["beta"] = _numpy(beta)
        return draws

    def sample_smc(self, n_particles: int = 1024, n_move: int = 5, seed: int = 0,
                   verbose: bool = False, **kwargs):
        """Adaptive tempered SMC over the joint posterior
        (``samplers/smc.py``).  Returns (draws: per-particle natural
        parameters, beta with fixed effects, 'logw' and 'log_z'; the list of
        per-stage info dicts).  The particles and the generator live on the
        host; the initial evaluation and every move evaluate all particles in
        one launch of kernel 1 (on a mesh one a cell: the particles split
        over its chains axis).  ``kwargs`` go to ``smc_sample``
        (target_ess_frac, resample_ess_frac, max_stages)."""
        gen = torch.Generator().manual_seed(seed)
        state, infos = smc_sample(self.full_logprior, self.full_loglik,
                                  self.sample_prior_u, gen, n_particles=n_particles,
                                  n_move=n_move, verbose=verbose, **kwargs)
        draws = self._draws_of(state.u)
        draws["logw"] = _numpy(state.logw)
        draws["log_z"] = float(state.log_z)
        return draws, infos

    def fit_advi(self, n_steps: int = 2000, n_mc: int = 8, learning_rate: float = 1e-2,
                 full_rank: bool = False, n_draws: int = 1000, seed: int = 0):
        """ADVI over the joint posterior (``samplers/vi.py``), from the
        default start plus 0.1 N(0, 1) per coordinate; returns (numpy draws
        of ``n_draws`` points of q, ADVIResult).  The variational parameters
        and the generator live on the host; a step is one launch of kernel 2
        for its ``n_mc`` points."""
        gen = torch.Generator().manual_seed(seed)
        u0 = self._full_init_u().cpu()
        u0 = u0 + 0.1 * torch.randn(u0.shape, generator=gen, dtype=self.dtype)
        res = advi_fit(self.full_logpost, self.full_dim(), gen, n_steps=n_steps,
                       n_mc=n_mc, learning_rate=learning_rate, full_rank=full_rank,
                       init_mu=u0, dtype=self.dtype)
        return self._draws_of(advi_sample(res, gen, n_draws)), res

    def theta_proposal_cov(self, laplace_cov):
        """Project the full-u Laplace covariance onto the Metropolis theta
        block (logit phi, log alpha = log tau2 - log sigma2(, logit nu))."""
        c = _numpy(laplace_cov)
        t = np.zeros((len(self.theta_names), c.shape[0]))  # beta columns: 0
        t[0, 1] = 1.0
        t[1, 0], t[1, 2] = -1.0, 1.0
        if self._sample_nu:
            t[2, 3] = 1.0
        return t @ c @ t.T

    def theta_proposal_center(self, u_map):
        """Project the full-u MAP point onto the Metropolis theta block."""
        u = _numpy(u_map)
        out = [u[1], u[2] - u[0]]  # beta entries dropped
        if self._sample_nu:
            out.append(u[3])
        return np.asarray(out)

    def sample(
        self,
        n_samples: int,
        n_burn: int = 500,
        thin: int = 1,
        n_chains: int = 1,
        seed: int = 0,
        init: Optional[dict] = None,
        proposal_cov=None,
        proposal_center=None,
        **driver_kwargs,
    ):
        """Run the sampler; returns a dict of numpy draws with leading axes
        (n_chains, n_samples) (chain axis dropped when n_chains=1).

        ``proposal_cov``: (k, k) theta-block covariance (theta_proposal_cov)
        switching to correlated joint proposals.  ``proposal_center`` (with
        ``proposal_cov``): theta-block center switching to the
        independence-MH mixture (mwg.mh_indep_mix)."""
        if proposal_center is not None and proposal_cov is None:
            raise ValueError("proposal_center requires proposal_cov")
        prop_chol = (None if proposal_cov is None else
                     self._tensor(np.linalg.cholesky(np.asarray(proposal_cov))))
        prop_center = (None if proposal_center is None
                       else self._tensor(np.asarray(proposal_center)))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        step = lambda g, s: self.step(g, s, n_adapt=n_burn, prop_chol=prop_chol,
                                      prop_center=prop_center)
        _, draws = run_chains_chunked(
            gen, lambda c: self.init_state(c, init), step, self.collect,
            n_chains, n_samples, n_burn, thin, **driver_kwargs,
        )
        if n_chains == 1:
            draws = {k: v[0] for k, v in draws.items()}
        return draws
