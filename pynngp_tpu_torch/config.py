"""Typed run configuration (counterpart of ``pynngp_tpu.config``): one
dataclass covering model, kernel, sampler and sharding choices, serialized
beside checkpoints.  The field names and defaults are the reference's, so
that a JSON file written by either package loads in the other field for
field.

``backend`` is passed to the models, which take it and ignore it: the port
has one backend.  The device is the caller's argument to
:meth:`NNGPConfig.build_model`, as it is to the models; ``mesh_chains`` and
``mesh_sites`` are carried and, as in the reference, not read."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

import torch

from pynngp_tpu_torch.kernels import get_kernel
from pynngp_tpu_torch.models.latent import LatentNNGP
from pynngp_tpu_torch.models.response import ResponseNNGP

__all__ = ["NNGPConfig"]


@dataclass
class NNGPConfig:
    # model
    model: str = "response"  # "response" | "latent"
    kernel: str = "exponential"  # sqexp | exponential | matern | spherical
    matern_nu: Optional[float] = None  # None => sampled nu (matern only)
    m: int = 15
    ordering: str = "coordinate"  # coordinate | maxmin | none
    distance: str = "euclidean"  # euclidean | dotproduct
    jitter: float = 1e-6
    backend: str = "auto"  # auto | pallas | xla (the reference's; the port has one)
    # sampler
    sampler: str = "mwg"  # mwg | nuts | hmc | smc | advi
    n_samples: int = 1000
    n_burn: int = 500
    thin: int = 1
    n_chains: int = 1
    seed: int = 0
    max_depth: int = 8  # nuts
    n_leapfrog: int = 32  # hmc
    n_particles: int = 1024  # smc
    target_accept: float = 0.8
    w_update: str = "chromatic"  # latent model
    # sharding
    mesh_chains: int = 1
    mesh_sites: int = 1
    # checkpointing
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # chunks; 0 = off

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "NNGPConfig":
        data = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "NNGPConfig":
        with open(path) as fh:
            return cls.from_json(fh.read())

    def build_model(self, coords, y, x=None, priors=None, dtype=None,
                    device="cuda"):
        """Instantiate the configured model on data, on ``device``, as the
        reference's ``build_model`` does: an unsharded model whatever
        ``mesh_chains`` and ``mesh_sites`` say (a mesh is passed to the
        model's constructor, ``parallel.make_mesh``), with ``backend``
        passed on and ignored."""
        kern = (get_kernel(self.kernel, nu=self.matern_nu)
                if self.kernel == "matern" else get_kernel(self.kernel))
        common = dict(kernel=kern, m=self.m, x=x, ordering=self.ordering,
                      distance=self.distance, priors=priors,
                      dtype=dtype or torch.float32, jitter=self.jitter,
                      backend=self.backend, device=device)
        if self.model == "response":
            return ResponseNNGP(coords, y, **common)
        if self.model == "latent":
            return LatentNNGP(coords, y, w_update=self.w_update, **common)
        raise ValueError(self.model)
