"""SeqNNGP: the reference's workflow object, construct -> sample -> predict
(counterpart of ``pynngp_tpu.models.seq``), over :class:`ResponseNNGP` or
:class:`LatentNNGP`.  ``model="latent"`` is the reference's latent sampler,
``model="response"`` its collapsed response variant."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pynngp_tpu_torch.diagnostics import summarize
from pynngp_tpu_torch.kernels import get_kernel
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.predict import build_prediction_table, predict_draws

__all__ = ["SeqNNGP"]


class SeqNNGP:
    """Sequential-NNGP workflow object (construct -> sample -> predict).

    ``device`` is the model's ("cuda" or "cpu"); prediction runs there too.
    ``kwargs`` go to the model's constructor."""

    def __init__(
        self,
        y,
        coords,
        m: int = 15,
        cov_model="exponential",
        model: str = "latent",
        x=None,
        distance: str = "euclidean",
        ordering: str = "coordinate",
        priors: Optional[dict] = None,
        dtype=torch.float32,
        device="cuda",
        **kwargs,
    ):
        if model not in ("latent", "response"):
            raise ValueError(f"model must be 'latent' or 'response', got {model!r}")
        self.kernel = get_kernel(cov_model)
        self.model_kind = model
        cls = LatentNNGP if model == "latent" else ResponseNNGP
        self._model = cls(coords, y, kernel=self.kernel, m=m, x=x,
                          distance=distance, ordering=ordering, priors=priors,
                          dtype=dtype, device=device, **kwargs)
        self.m = m
        self.distance = distance
        self.dtype = dtype
        # the ordered training coordinates, rounded to the model's dtype as
        # the model holds them (the reference reads them from its data)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self._train_coords = np.asarray(coords)[self._model.table.order].astype(np_dtype)
        self._draws = None

    @property
    def model(self):
        return self._model

    def sample(self, n_samples: int, n_burn: int = 500, thin: int = 1,
               n_chains: int = 1, seed: int = 0, **kwargs):
        """Run the model's MCMC; the draws are kept on the object and
        returned."""
        self._draws = self._model.sample(n_samples, n_burn=n_burn, thin=thin,
                                         n_chains=n_chains, seed=seed, **kwargs)
        return self._draws

    def summary(self):
        if self._draws is None:
            raise ValueError("call sample() first")
        return summarize(self._draws)

    def predict(self, coords0, x0=None, generator: torch.Generator = None,
                noise_on_target: bool = True, draws: Optional[dict] = None,
                thin: int = 1, batch_draws: int = 8):
        """Neighbor-conditioned kriging at new sites for every stored
        posterior draw (or every draw of ``draws``, chains flattened, one in
        ``thin``), on the model's device.

        ``x0`` (n0, p): covariates at the new sites; the model must have been
        fit with covariates (beta draws present).  The predictive mean then
        includes x0 @ beta per draw, and the response model conditions on
        the per-draw residuals y - X beta.  With ``generator`` the result
        holds one predictive sample per (draw, site).  Returns
        :func:`~pynngp_tpu_torch.predict.predict_draws`'s dict of (S, n0)
        tensors.
        """
        draws = draws if draws is not None else self._draws
        if draws is None:
            raise ValueError("call sample() first")
        flat = {}
        for k, v in draws.items():
            v = np.asarray(v)
            flat[k] = v.reshape(-1, *v.shape[2:]) if v.ndim > 1 + (k in ("w", "beta")) else v
        sel = slice(None, None, thin)
        ptable = build_prediction_table(
            self._train_coords, np.asarray(coords0), self.m, metric=self.distance,
            dtype=self.dtype, device=self._model.device)
        param_draws = {k: flat[k][sel] for k in ("sigma2", "tau2", "phi", "nu")
                       if k in flat}
        beta_draws = None
        if x0 is not None:
            if "beta" not in flat:
                raise ValueError("x0 given but the model has no fixed-effect "
                                 "draws; construct with x= and re-sample")
            beta_draws = flat["beta"][sel]
        common = dict(generator=generator, x0=x0, beta_draws=beta_draws,
                      noise_on_target=noise_on_target, batch_draws=batch_draws)
        if self.model_kind == "latent":
            if "w" not in flat:
                raise ValueError("latent prediction needs collect_w=True draws")
            w = flat["w"][sel]
            n_params = len(param_draws["sigma2"])
            if w.shape[0] != n_params:
                raise ValueError(
                    f"{w.shape[0]} draws of w against {n_params} parameter "
                    "draws: draws sampled with w_every > 1 keep w at only "
                    "every w_every-th draw; predict needs one w per draw "
                    "(sample with w_every=1)")
            # w draws are in the users' site order; map them to ordered space
            return predict_draws(self.kernel, ptable, None, param_draws,
                                 values_draws=w[..., self._model.table.order],
                                 **common)
        # the response model with covariates conditions on y - X beta per draw
        x_train = self._model.x if beta_draws is not None else None
        return predict_draws(self.kernel, ptable, self._model.y, param_draws,
                             x_train=x_train, **common)
