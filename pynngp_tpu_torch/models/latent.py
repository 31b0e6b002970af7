"""Latent-w NNGP model: y_i = x_i'beta + w_i + eps_i, eps_i ~ N(0, tau2 v_i),
w ~ NNGP(0, sigma2 rho_phi) (counterpart of ``pynngp_tpu.models.latent``);
v = 1 under homogeneous noise, known per-site weights under
``HeterogeneousNoise(v)``.

Ported: every ordering, the Euclidean and (up to
:data:`NON_EUCLIDEAN_MAX_SITES` sites) the dot-product distance,
homogeneous and heterogeneous noise, one device or a (chains, sites) mesh
of them (``mesh``), every kernel of :mod:`pynngp_tpu_torch.kernels` (with
``Matern()`` the theta block is (phi, nu), otherwise phi alone).
``backend`` is taken and ignored: the port has one.  Every other option of
the reference raises.

On a mesh (the reference's latent.py:173-210) the B/F build runs one launch
of kernel 3 a mesh cell on the tables cut over its sites axis, and the w
sweep is ``parallel.make_sharded_chromatic``: each cell updates its
round-robin share of every colour (``parallel.shard_color_tables``) and the
deltas add up on the first device, where the state lives.  A mesh needs
``w_update='chromatic'``, as in the reference.

One departure from the reference: under heterogeneous noise the beta | w,
tau2 update is weighted by V^-1 = diag(1/v), the exact conditional
(precision X' V^-1 X / tau2 + I / s^2, right-hand side X' V^-1 (y - w) /
tau2).  The reference's (``pynngp_tpu/models/latent.py:654-661``) leaves out
the weights; with v = 1 the two agree exactly.

Sampler (Metropolis-within-Gibbs, batched over C chains):
  - w: site-by-site Gibbs, two implementations with the same stationary law:
      * ``w_update='chromatic'`` (default): sites are coloured on the moral
        graph once, on the host; all sites of one colour are conditionally
        independent given the rest and update together, so a sweep is one
        pass per colour instead of n sequential steps;
      * ``w_update='sequential'``: the reference's site-by-site scan, a
        Python loop over sites kept as the semantics oracle (CPU sizes);
  - tau2: conjugate inverse-gamma from the measurement residuals, each
    weighted by 1/v_i;
  - beta: conjugate Gaussian linear model on y - w, weighted by 1/v;
  - phi (and nu): random-walk Metropolis, one B/F rebuild per proposal (kernel 3,
    ``ops/bf.py``), against the sigma2-collapsed marginal
    (``collapsed=True``, the default) or the sigma2-conditioned target;
  - sigma2: conjugate inverse-gamma from the Vecchia quadratic form of w.

The per-site conditional of w_i (tau2 below is tau2 v_i under
heterogeneous noise):
  v_i  = [ 1/tau2 + 1/(s2 F_i) + sum_j B_{j,l}^2/(s2 F_j) ]^{-1}
  mu_i = v_i [ (y_i - x_i'b)/tau2 + B_i.w_{N(i)}/(s2 F_i)
               + sum_j B_{j,l} (w_j - sum_{k != l} B_{j,k} w_{N(j)_k})/(s2 F_j) ]
where j ranges over the children of i (the sites that condition on i) and l
is i's slot in N(j).

B and F live in the state plane-major, ``b`` (C, m, n_pad) and ``f``
(C, n_pad), exactly as kernel 3 writes them: a child's weight B_{j,l} is the
flat element ``l * n_pad + j``, and padded sites hold B = 0, F = 1.  A
proposal builds a second (b, f) pair and ``torch.where`` keeps the accepted
one per chain, C * (m + 1) * n_pad * 4 bytes read twice and written once.
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
from pynngp_tpu_torch.neighbors import (
    build_children_table,
    color_child_pairs,
    color_moral_graph,
    color_site_table,
)
from pynngp_tpu_torch.noise import get_noise
from pynngp_tpu_torch.ops.bf import bf_planes, plane_suffstats
from pynngp_tpu_torch.ops.geometry import check_card_m
from pynngp_tpu_torch.ops.site_tables import (
    choose_layout,
    make_site_tables,
    shard_site_tables,
)
from pynngp_tpu_torch.parallel.sharded import (
    make_sharded_chromatic,
    shard_color_tables,
)
from pynngp_tpu_torch.priors import logit_transform
from pynngp_tpu_torch.samplers.mwg import (
    adapt_log_step,
    rw_sweep,
    sample_gaussian_precision,
    sample_inverse_gamma,
)
from pynngp_tpu_torch.vecchia import LOG_2PI

__all__ = ["LatentNNGP", "LatentState", "NON_EUCLIDEAN_MAX_SITES"]

# Above this many sites the reference's latent model forces the coords
# layout (pynngp_tpu/models/latent.py:161), which refuses a non-Euclidean
# metric (pynngp_tpu/ops/pallas_bf.py:216-217); the port refuses the same.
NON_EUCLIDEAN_MAX_SITES = 200_000


class LatentState(NamedTuple):
    """Batched sampler state; every field has a leading chain axis C."""

    theta_u: torch.Tensor  # (C, k) unconstrained (phi[, nu])
    sigma2: torch.Tensor  # (C,)
    tau2: torch.Tensor  # (C,)
    beta: torch.Tensor  # (C, max(p, 1))
    w: torch.Tensor  # (C, n) latent surface, ordered sites
    value: torch.Tensor  # (C,) cached theta-block log-posterior
    logdet: torch.Tensor  # (C,) unit-process sum log F
    quad_w: torch.Tensor  # (C,) sum (w_i - B_i w_N)^2 / F_i
    b: torch.Tensor  # (C, m, n_pad) plane-major kriging weights
    f: torch.Tensor  # (C, n_pad)
    log_steps: torch.Tensor  # (C, k)
    accept: torch.Tensor  # (C, k)
    iteration: torch.Tensor  # (C,) int32


def _site_sum(x):
    """Sum over the site axis, accumulated in float64 (n terms feed a
    Metropolis ratio or a conjugate scale) and cast back."""
    return x.sum(-1, dtype=torch.float64).to(x.dtype)


class LatentNNGP:
    """User-facing latent-model API.

    ``device`` is "cuda" (kernel 3 for B/F, float32 only) or "cpu" (its plain
    PyTorch version, any float dtype); there is no automatic choice, and
    "cuda" without a card raises.

    The table layout follows n, as in the reference: coords (distances
    recomputed in the kernel, no distance table made) above
    ``site_tables.COORDS_LAYOUT_MIN_SITES`` sites, dist at or below;
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
        kernel="exponential",
        m: int = 15,
        x=None,
        ordering: str = "coordinate",
        distance: str = "euclidean",
        priors: Optional[dict] = None,
        dtype=torch.float32,
        jitter: float = 1e-6,
        w_update: str = "chromatic",
        precompute_distances: bool = True,
        backend: str = "auto",
        noise="homogeneous",
        mesh=None,
        collapsed: bool = True,
        device="cuda",
    ):
        if w_update not in ("chromatic", "sequential"):
            raise ValueError("w_update must be 'chromatic' or 'sequential', "
                             f"got {w_update!r}")
        if mesh is not None and w_update == "sequential":
            raise ValueError("mesh sharding requires w_update='chromatic' (the "
                             "sequential scan is the single-device semantics "
                             "oracle)")
        self.mesh = mesh
        self.noise = get_noise(noise)
        self.device = device = check_device(device, dtype, mesh)
        self.kernel = get_kernel(kernel)
        self.dtype = dtype
        self.jitter = jitter
        self.w_update = w_update
        # the theta block targets the sigma2-collapsed marginal by default
        # (see _collapsed_value); collapsed=False keeps the reference
        # sampler's sigma2-conditioned update
        self.collapsed = collapsed

        # the table layout by n alone, as the reference chooses it
        # (pynngp_tpu/models/latent.py:155-163); the coords layout needs no
        # distance tables, so none are made for it
        coords = np.asarray(coords)
        self.dist_fn = dist_fn = get_distance(distance)
        euclidean = isinstance(dist_fn, Euclidean)
        if not euclidean and coords.shape[0] > NON_EUCLIDEAN_MAX_SITES:
            raise ValueError(
                f"the latent model takes distance {dist_fn.name!r} up to "
                f"{NON_EUCLIDEAN_MAX_SITES} sites, got n={coords.shape[0]}: "
                "above that the reference forces the coords layout, which "
                "needs the Euclidean metric")
        self.lane_layout = choose_layout("auto", coords.shape[0], euclidean)
        on_coords = self.lane_layout == "coords"
        sd = prepare_spatial_data(
            coords, y, m, x=x, ordering=ordering, distance=distance, dtype=dtype,
            device=device, precompute_distances=precompute_distances and not on_coords)
        self.table = tab = sd.table
        self.y, self.x = sd.y, sd.x
        self.n = sd.y.shape[0]
        self.p = 0 if sd.x is None else sd.x.shape[1]
        self.tables = make_site_tables(
            sd.vecchia, dtype=dtype, device=device, layout=self.lane_layout,
            coords_host=coords[tab.order], dist_fn=dist_fn,
            shards=1 if mesh is None else mesh.shape["sites"])
        self.m = self.tables.m
        if device.type == "cuda":
            check_card_m(self.tables.n_pad, self.m)
        # heterogeneous measurement noise tau2 v_i: the weights in ordered
        # site space (the reference's latent.py:123-130), None for v = 1.
        # Kernel 3 runs the latent process at alpha = 0 and never sees them.
        self._noise_w = None
        if self.noise.name == "heterogeneous":
            v = np.asarray(self.noise.v.cpu(), dtype=np.float64)
            if v.shape != (self.n,):
                raise ValueError(f"the noise weights v must have shape ({self.n},), "
                                 f"got {v.shape}")
            self._noise_w = self._tensor(v[tab.order])
        if self.p:
            # X' V^-1 (the weighted beta update; X' without weights)
            self._xt_vinv = (self.x if self._noise_w is None
                             else self.x / self._noise_w[:, None]).T
            self._xtx = self._xt_vinv @ self.x

        # static structure of the sweeps, built once on the host
        ch = build_children_table(tab.nn_idx, tab.nn_mask)
        self.colors = color_moral_graph(tab.nn_idx, tab.nn_mask)  # host numpy
        self.n_colors = int(self.colors.max()) + 1
        sites, smask = color_site_table(self.colors)
        pairs = color_child_pairs(self.colors, sites, smask, ch.child_idx,
                                  ch.child_mask)
        n_pad = self.tables.n_pad
        index = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        flag = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self._nbr = index(tab.nn_idx.T)  # (m, n) neighbor ids, plane-major
        self.child_idx = index(ch.child_idx)  # (n, max_c)
        self.child_mask = flag(ch.child_mask)
        # flat position of B_{j, l} in b.reshape(C, m * n_pad)
        self._child_flat = index(ch.child_slot.astype(np.int64) * n_pad
                                 + ch.child_idx)
        self.color_sites = index(sites)  # (n_colors, max_sz)
        self.color_smask = flag(smask)
        # pair tables with one extra, always-empty column P: the slot that
        # the padding of _pair_gather points at
        pad = lambda a: np.pad(a, ((0, 0), (0, 1)))
        pp, pc, pf, pm = (pad(a) for a in pairs)
        self._pp, self._pc, self._pf = index(pp), index(pc), index(pf)
        self._pm = flag(pm)
        gather = _pair_gather_table(pp, pm, sites.shape[1], ch.max_children)
        self._gather_shape = gather.shape[1:]  # (max_sz, max_c)
        self._pair_gather = index(gather.reshape(gather.shape[0], -1))
        if mesh is not None:
            self.tables = shard_site_tables(self.tables, mesh)
            # each site shard's round-robin share of every colour
            csites, csmask = shard_color_tables(self.colors, mesh.shape["sites"])
            self._csites, self._csmask = index(csites), flag(csmask)
            self._sh_chrom = make_sharded_chromatic(mesh, self.n_colors)

        self.priors = default_priors(coords, y, priors)
        self._sample_nu = self.kernel.samples_nu
        self.theta_names = ("phi",) + (("nu",) if self._sample_nu else ())
        prior_phi = self.priors["phi"]
        self._t_phi = logit_transform(prior_phi.lo, prior_phi.hi)
        if self._sample_nu:
            prior_nu = self.priors["nu"]
            self._t_nu = logit_transform(prior_nu.lo, prior_nu.hi)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # ---- parameter plumbing -------------------------------------------
    def _natural(self, theta_u):
        out = {"phi": self._t_phi.forward(theta_u[..., 0])}
        if self._sample_nu:
            out["nu"] = self._t_nu.forward(theta_u[..., 1])
        return out

    def _unconstrained(self, phi, nu=None):
        vals = [self._t_phi.inverse(self._tensor(phi))]
        if self._sample_nu:
            vals.append(self._t_nu.inverse(self._tensor(nu)))
        return torch.stack(vals)

    def _log_prior_theta(self, theta_u, nat):
        lp = (self.priors["phi"].logpdf(nat["phi"])
              + self._t_phi.log_jac(theta_u[..., 0]))
        if self._sample_nu:
            lp = lp + (self.priors["nu"].logpdf(nat["nu"])
                       + self._t_nu.log_jac(theta_u[..., 1]))
        return lp

    def _mean(self, beta):
        """x'beta per chain, (C, n); 0 without fixed effects."""
        return 0.0 if self.p == 0 else beta @ self.x.T

    def _noise_var(self, tau2):
        """The measurement-noise variance per chain: tau2 (C, 1), or tau2 v_i
        (C, n) under heterogeneous noise."""
        tau2 = tau2[:, None]
        return tau2 if self._noise_w is None else tau2 * self._noise_w

    def _weighted_sq(self, r):
        """sum_i r_i^2 / v_i per chain (v = 1 under homogeneous noise)."""
        sq = r * r
        return _site_sum(sq if self._noise_w is None else sq / self._noise_w)

    # ---- w full-conditional pieces ------------------------------------
    def _child_terms(self, b, fprec):
        """Per (site, child slot): B_{j,l} and 1/(s2 F_j) of child j, both
        (C, n, max_c) and zero in empty child slots."""
        b_child = b.reshape(b.shape[0], -1)[:, self._child_flat] * self.child_mask
        fp_child = fprec[:, self.child_idx] * self.child_mask
        return b_child, fp_child

    def _own_mean(self, w, b):
        """B_i . w_N(i) per site, (C, n).  B is 0 in invalid slots."""
        return (b[:, :, :self.n] * w[:, self._nbr]).sum(1)

    def conditional_moments(self, w, b, f, sigma2, tau2, beta):
        """Vectorized (mu_i, v_i) of every site's full conditional given the
        current w, each (C, n)."""
        fprec = 1.0 / (sigma2[:, None] * f[:, :self.n])
        mu_own = self._own_mean(w, b)
        resid = w - mu_own  # full residual of every site
        b_child, fp_child = self._child_terms(b, fprec)
        # child j's residual without i's own contribution
        resid_excl = resid[:, self.child_idx] + b_child * w[:, :, None]
        tau2 = self._noise_var(tau2)
        prec = 1.0 / tau2 + fprec + (b_child * b_child * fp_child).sum(-1)
        rhs = ((self.y - self._mean(beta)) / tau2 + mu_own * fprec
               + (b_child * fp_child * resid_excl).sum(-1))
        v = 1.0 / prec
        return v * rhs, v

    def _update_w_chromatic(self, eps, w, b, f, sigma2, tau2, beta):
        """Exact chromatic Gibbs sweep, one colour class at a time, from the
        standard normals ``eps`` (C, n).

        Everything that does not depend on w, the whole conditional precision
        included, is computed once and gathered into colour-major layout
        before the loop.  The residual r_j = w_j - B_j . w_N(j) is kept up to
        date incrementally, so B_i . w_N(i) = w_i - r_i needs no neighbor
        gather, and the child work runs on the packed (parent, child) pair
        tables.  The loop over colours is a Python loop of small tensor ops.

        Scatters.  Pad slots of the site and pair tables all point at site 0
        with a zero update, so the updates of w and r must accumulate
        (``index_add_``); a plain indexed assignment would let a pad slot
        overwrite site 0.  The live indices of one colour are distinct (a
        proper moral-graph colouring: no two sites of a colour share a child
        or condition on one another), so the atomic adds of a CUDA
        ``index_add_`` change no value with their order and a run is
        reproducible.  The one sum with repeated targets, a parent's sum over
        its children, is a gather through ``_pair_gather`` and a dense sum."""
        n = self.n
        fprec = 1.0 / (sigma2[:, None] * f[:, :n])
        tau2 = self._noise_var(tau2)
        ytil = (self.y - self._mean(beta)) / tau2
        b_child, fp_child = self._child_terms(b, fprec)
        prec = 1.0 / tau2 + fprec + (b_child * b_child * fp_child).sum(-1)
        v = 1.0 / prec
        # w_i' = v_i (ytil_i + fprec_i B_i.w_N(i) + child sum) + sqrt(v_i) eps_i
        fixed = v * ytil + torch.sqrt(v) * eps
        own = v * fprec
        w = w.clone()  # updated in place below; the caller's state is kept
        resid = w - self._own_mean(w, b)

        chains = w.shape[0]
        cs = self.color_sites
        bcp = b_child.reshape(chains, -1)[:, self._pf] * self._pm  # B_{j,l}
        coef = bcp * fp_child.reshape(chains, -1)[:, self._pf]  # B_{j,l}/(s2 F_j)
        # per-site vectors gathered colour-major, (C, n_colors, max_sz), once
        rows = zip(cs, self.color_smask, self._pp, self._pc, self._pair_gather,
                   bcp.unbind(1), coef.unbind(1), v[:, cs].unbind(1),
                   fixed[:, cs].unbind(1), own[:, cs].unbind(1))
        shape = (chains,) + self._gather_shape
        for (sites, smask, pp_c, pc_c, gather_c, bcp_c, coef_c, v_s, fixed_s,
             own_s) in rows:
            w_s = w.index_select(1, sites)
            # B_i . w_N(i) under the current w is w_i - r_i
            mu_own = w_s - resid.index_select(1, sites)
            # child term: sum over i's pairs of B_{j,l}/(s2 F_j) (r_j + B_{j,l} w_i)
            rexcl = torch.addcmul(resid.index_select(1, pc_c), bcp_c,
                                  w_s.index_select(1, pp_c))
            child_sum = (coef_c * rexcl).index_select(1, gather_c).view(shape).sum(-1)
            w_new = torch.addcmul(torch.addcmul(fixed_s, own_s, mu_own), v_s,
                                  child_sum)
            delta = (w_new - w_s) * smask  # pad slots add 0
            w.index_add_(1, sites, delta)
            resid.index_add_(1, sites, delta)
            resid.index_add_(1, pc_c, -bcp_c * delta.index_select(1, pp_c))
        return w

    def _update_w_chromatic_sharded(self, eps, w, b, f, sigma2, tau2, beta):
        """The chromatic sweep over the mesh (``make_sharded_chromatic``):
        the same conditional moments as :meth:`_update_w_chromatic`, each
        cell updating its share of every colour from the same pre-colour
        state; equal to the single-device sweep up to rounding."""
        fprec = 1.0 / (sigma2[:, None] * f[:, :self.n])
        tau2 = self._noise_var(tau2)
        ytil = (self.y - self._mean(beta)) / tau2
        b_child, fp_child = self._child_terms(b, fprec)
        v = 1.0 / (1.0 / tau2 + fprec + (b_child * b_child * fp_child).sum(-1))
        resid = w - self._own_mean(w, b)
        return self._sh_chrom(self._csites, self._csmask, w, resid, eps,
                              self.child_idx, b_child, fp_child, v, torch.sqrt(v),
                              ytil, fprec)

    def _update_w_sequential(self, eps, w, b, f, sigma2, tau2, beta):
        """The reference sampler's semantics: sites in order, each from its
        full conditional given the latest w.  A Python loop over n sites,
        for CPU-sized problems and tests."""
        n = self.n
        fprec = 1.0 / (sigma2[:, None] * f[:, :n])
        tau2 = self._noise_var(tau2)
        ytil = (self.y - self._mean(beta)) / tau2
        b_child, fp_child = self._child_terms(b, fprec)
        prec = 1.0 / tau2 + fprec + (b_child * b_child * fp_child).sum(-1)
        v = 1.0 / prec
        noise = torch.sqrt(v) * eps
        b_n = b[:, :, :n]
        w = w.clone()
        for i in range(n):
            mu_own = (b_n[:, :, i] * w[:, self._nbr[:, i]]).sum(-1)
            cj = self.child_idx[i]  # (max_c,) children (pads: site 0, B = 0)
            # child residuals recomputed from the current w, without i
            resid_child = w[:, cj] - (b_n[:, :, cj] * w[:, self._nbr[:, cj]]).sum(1)
            resid_excl = resid_child + b_child[:, i] * w[:, i, None]
            rhs = (ytil[:, i] + mu_own * fprec[:, i]
                   + (b_child[:, i] * fp_child[:, i] * resid_excl).sum(-1))
            w[:, i] = v[:, i] * rhs + noise[:, i]
        return w

    # ---- likelihood pieces --------------------------------------------
    def _suffstats(self, theta_u, w):
        """(b, f, logdet, quad) of w under the unit-variance process at
        theta: one B/F build for all chains."""
        nat = self._natural(theta_u)
        b, f = bf_planes(self.kernel, self.tables, nat["phi"], 0.0, self.jitter,
                         nat.get("nu"))
        logdet, quad, _ = plane_suffstats(b, f, w, self._nbr)
        return b, f, logdet, quad

    def _theta_logpost(self, theta_u, w, sigma2):
        b, f, logdet, quad = self._suffstats(theta_u, w)
        nat = self._natural(theta_u)
        if self.collapsed:
            value = self._collapsed_value(theta_u, nat, logdet, quad)
        else:
            value = (-0.5 * (logdet + quad / sigma2)
                     + self._log_prior_theta(theta_u, nat))
        return value, {"b": b, "f": f, "logdet": logdet, "quad": quad}

    def _collapsed_value(self, theta_u, nat, logdet, quad):
        """Metropolis target for theta with sigma2 integrated out.

        p(w | phi, sigma2) p(sigma2) carries sigma2 only as
        sigma2^{-(a_s + n/2 + 1)} exp(-(b_s + quad_phi(w)/2) / sigma2), so the
        marginal over the IG(a_s, b_s) prior is Gamma(A) B^{-A} with
        A = a_s + n/2, B = b_s + quad/2.  Walking phi against this marginal
        instead of the sigma2-conditioned target removes the (sigma2, phi)
        ridge; redrawing sigma2 ~ IG(A, B) from the post-theta quad
        afterwards makes the (phi, sigma2) pair one exact joint conditional
        draw (partially collapsed Gibbs, same stationary distribution)."""
        a_big = self.priors["sigma2"].a + 0.5 * self.n
        b_big = self.priors["sigma2"].b + 0.5 * quad
        return (-0.5 * logdet - a_big * torch.log(b_big)
                + self._log_prior_theta(theta_u, nat))

    def loglik(self, state: LatentState):
        """Per-chain record: log p(y | w, tau2) + log p(w | theta, sigma2);
        under heterogeneous noise log p(y | w, tau2) sums log(tau2 v_i), as
        the reference's (``latent.py:563-567``)."""
        r = self.y - self._mean(state.beta) - state.w
        if self._noise_w is None:
            ll_y = -0.5 * (self.n * (LOG_2PI + torch.log(state.tau2))
                           + _site_sum(r * r) / state.tau2)
        else:
            nvar = self._noise_var(state.tau2)
            ll_y = -0.5 * (self.n * LOG_2PI + _site_sum(torch.log(nvar))
                           + _site_sum(r * r / nvar))
        ll_w = -0.5 * (self.n * (LOG_2PI + torch.log(state.sigma2))
                       + state.logdet + state.quad_w / state.sigma2)
        return ll_y + ll_w

    # ---- sampler -------------------------------------------------------
    def init_state(self, n_chains: int = 1, init: Optional[dict] = None):
        """The same starting state for every chain."""
        init = init or {}
        var_y = torch.var(self.y, unbiased=False)
        pp = self.priors["phi"]
        chain = lambda v: self._tensor(v).expand(n_chains).clone()
        k = len(self.theta_names)
        theta_u = self._unconstrained(init.get("phi", 0.5 * (pp.lo + pp.hi)),
                                      init.get("nu", 1.0))
        theta_u = theta_u.expand(n_chains, k).clone()
        sigma2 = chain(init.get("sigma2", 0.5 * var_y))
        tau2 = chain(init.get("tau2", 0.1 * var_y))
        beta = torch.zeros((n_chains, max(self.p, 1)), dtype=self.dtype,
                           device=self.device)
        if self.p and "beta" in init:
            beta = self._tensor(init["beta"]).expand(n_chains, self.p).clone()
        w = self._tensor(init.get("w", np.zeros(self.n)))
        w = w.expand(n_chains, self.n).clone()
        b, f, logdet, quad = self._suffstats(theta_u, w)
        value = (-0.5 * (logdet + quad / sigma2)
                 + self._log_prior_theta(theta_u, self._natural(theta_u)))
        if not bool(torch.isfinite(value).all()):
            # every proposal is compared with this value: a chain that starts
            # at a non-finite one accepts nothing finite again
            raise ValueError(
                "the initial state has a non-finite log-density: the Vecchia "
                "factorization broke down at the initial (phi, nu).  The "
                f"latent process has no nugget, so jitter={self.jitter:g} is "
                "all that keeps the conditional variance of a site that "
                "nearly repeats a neighbor above 0; in float32 a smooth "
                "kernel needs about jitter=1e-4.  Pass a larger jitter, or an "
                "`init` with another phi or nu.")
        return LatentState(
            theta_u=theta_u, sigma2=sigma2, tau2=tau2, beta=beta, w=w,
            value=value, logdet=logdet, quad_w=quad, b=b, f=f,
            log_steps=torch.full((n_chains, k), math.log(0.1), dtype=self.dtype,
                                 device=self.device),
            accept=torch.zeros((n_chains, k), dtype=self.dtype,
                               device=self.device),
            iteration=torch.zeros(n_chains, dtype=torch.int32,
                                  device=self.device),
        )

    def step(self, gen, state: LatentState, n_adapt: int = 10**9, eps=None):
        """One MWG iteration of every chain.  ``eps`` (C, n) are the sweep's
        standard normals, drawn from ``gen`` when not given."""
        chains = state.w.shape[0]
        if eps is None:
            eps = torch.randn((chains, self.n), generator=gen, dtype=self.dtype,
                              device=self.device)

        # 1. w | rest
        if self.mesh is not None:
            sweep = self._update_w_chromatic_sharded
        elif self.w_update == "chromatic":
            sweep = self._update_w_chromatic
        else:
            sweep = self._update_w_sequential
        w = sweep(eps, state.w, state.b, state.f, state.sigma2, state.tau2,
                  state.beta)

        # 2. sigma2 | w, theta from the quad of w under the current B/F.  In
        # collapsed mode sigma2 is drawn after the theta sweep instead, from
        # the post-theta quad (see _collapsed_value).
        _, quad_w, _ = plane_suffstats(state.b, state.f, w, self._nbr)
        pr_s = self.priors["sigma2"]
        sigma2 = state.sigma2
        if not self.collapsed:
            sigma2 = sample_inverse_gamma(gen, pr_s.a + 0.5 * self.n,
                                          pr_s.b + 0.5 * quad_w)

        # 3. tau2 | w, beta
        tau2 = sample_inverse_gamma(gen, *self._tau2_conditional(w, state.beta))

        # 4. beta | w, tau2: conjugate linear model on y - w (weighted by 1/v)
        beta = state.beta
        if self.p:
            beta, _, _ = self._draw_beta(
                w, tau2, torch.randn((chains, self.p), generator=gen,
                                     dtype=self.dtype, device=self.device))

        # 5. theta | w: random-walk Metropolis, one B/F build per proposal
        nat = self._natural(state.theta_u)
        if self.collapsed:
            value = self._collapsed_value(state.theta_u, nat, state.logdet,
                                          quad_w)
        else:
            value = (-0.5 * (state.logdet + quad_w / sigma2)
                     + self._log_prior_theta(state.theta_u, nat))
        aux = {"b": state.b, "f": state.f, "logdet": state.logdet,
               "quad": quad_w}
        logpost = lambda u: self._theta_logpost(u, w, sigma2)
        theta_u, value, aux, aprobs = rw_sweep(gen, state.theta_u, value, aux,
                                               logpost, state.log_steps)
        if self.collapsed:
            # the exact conjugate draw from the post-theta quad completes the
            # joint (theta, sigma2) conditional
            sigma2 = sample_inverse_gamma(gen, pr_s.a + 0.5 * self.n,
                                          pr_s.b + 0.5 * aux["quad"])

        log_steps = adapt_log_step(state.log_steps, aprobs, state.iteration,
                                   n_adapt)
        return LatentState(
            theta_u=theta_u, sigma2=sigma2, tau2=tau2, beta=beta, w=w,
            value=value, logdet=aux["logdet"], quad_w=aux["quad"], b=aux["b"],
            f=aux["f"], log_steps=log_steps, accept=state.accept + aprobs,
            iteration=state.iteration + 1,
        )

    def _tau2_conditional(self, w, beta):
        """(shape, scale) of the inverse-gamma tau2 | w, beta: the prior's
        plus n/2 and half the sum of squared residuals, each weighted by
        1/v_i under heterogeneous noise (the reference's latent.py:642-650)."""
        pr_t = self.priors["tau2"]
        r = self.y - self._mean(beta) - w
        return pr_t.a + 0.5 * self.n, pr_t.b + 0.5 * self._weighted_sq(r)

    def _draw_beta(self, w, tau2, eps):
        """beta | w, tau2 from standard normals ``eps`` (C, p): precision
        X' V^-1 X / tau2 + I / s^2 and right-hand side X' V^-1 (y - w) / tau2,
        V = diag(v) (the identity under homogeneous noise).  Returns (beta,
        mean, Cholesky factor of the precision)."""
        eye = torch.eye(self.p, dtype=self.dtype, device=self.device)
        prec = (self._xtx / tau2[:, None, None]
                + eye / self.priors["beta_scale"] ** 2)
        rhs = ((self.y - w) @ self._xt_vinv.T) / tau2[:, None]
        return sample_gaussian_precision(prec, rhs, eps)

    def collect(self, state: LatentState, collect_w: bool = False):
        nat = self._natural(state.theta_u)
        out = {
            "sigma2": state.sigma2,
            "tau2": state.tau2,
            "phi": nat["phi"],
            "loglik": self.loglik(state),
        }
        if self._sample_nu:
            out["nu"] = nat["nu"]
        if self.p:
            out["beta"] = state.beta
        if collect_w:
            out["w"] = state.w
        return out

    def sample(
        self,
        n_samples: int,
        n_burn: int = 500,
        thin: int = 1,
        n_chains: int = 1,
        seed: int = 0,
        init: Optional[dict] = None,
        collect_w: bool = True,
        w_every: int = 1,
        **run_kwargs,
    ):
        """Run the sampler; returns a dict of numpy draws with leading axes
        (n_chains, n_samples) (chain axis dropped when n_chains=1).

        ``w_every=k`` keeps every k-th draw of the (n,)-sized latent surface
        while the hyperparameter draws stay per-iteration: the w chain
        dominates storage (n floats per draw and chain).  The kept rows are
        identical to an unthinned run's: the generator and the state are
        untouched, only the recording is thinned.  ``draws["w"]`` then has
        ceil(n_samples / k) rows per chain, in the user's site order."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        step = lambda g, s: self.step(g, s, n_adapt=n_burn)
        collect = lambda s: self.collect(s, collect_w=collect_w)
        _, draws = run_chains_chunked(
            gen, lambda c: self.init_state(c, init), step, collect, n_chains,
            n_samples, n_burn, thin,
            collect_every={"w": w_every} if collect_w and w_every > 1 else None,
            **run_kwargs,
        )
        if collect_w:
            draws["w"] = draws["w"][..., self.table.inverse_order]
        if n_chains == 1:
            draws = {k: v[0] for k, v in draws.items()}
        return draws


def _pair_gather_table(pp, pm, max_sz, max_c):
    """(n_colors, max_sz, max_c) positions in a colour's pair row of each
    parent's pairs, padded with the row's last (always empty) column.

    A colour's pair row lists the pairs parent by parent, so parent t's pairs
    are one run of the row; gathering a per-pair quantity through this table
    and summing the last axis is the parent's sum over its children, with no
    scatter and in a fixed order."""
    n_colors, width = pp.shape
    table = np.full((n_colors, max_sz, max_c), width - 1, np.int64)
    for c in range(n_colors):
        live = np.arange(int(pm[c].sum()))  # live pairs fill the row's head
        parent = pp[c, live]
        if np.any(np.diff(parent) < 0):
            raise ValueError("pair rows must be in parent order")
        # rank of each pair within its parent's run
        rank = live - np.searchsorted(parent, parent, side="left")
        table[c, parent, rank] = live
    return table
