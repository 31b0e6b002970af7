"""Distances (counterpart of ``pynngp_tpu.distance``): Euclidean, and the
dot-product (cosine) dissimilarity for embedding spaces.

Each distance has two sets of methods.  The numpy ``*_np`` methods, in
float64 on the host, serve the one-time precompute of the distance tables,
the neighbor search and the prediction tables; the kernels read what they
computed.  ``pairwise``, ``pairwise_sq`` and ``one_to_many`` take tensors of
any device and dtype and batch over leading axes, for callers that hold a
distance object (the plain Vecchia path of :mod:`pynngp_tpu_torch.vecchia`
on data made without tables)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Euclidean", "DotProduct", "get_distance"]


class Euclidean:
    """Euclidean (L2) distance: dist(x, y) = ||x - y||."""

    name = "euclidean"

    def pairwise(self, a, b):
        """Distance matrix between rows of ``a (..., p, d)`` and ``b (..., q, d)``."""
        return torch.sqrt(self.pairwise_sq(a, b))

    def pairwise_sq(self, a, b):
        """Squared distances (..., p, q)."""
        diff = a[..., :, None, :] - b[..., None, :, :]
        return (diff * diff).sum(-1)

    def one_to_many(self, x, b):
        """Distances from one point ``x (..., d)`` to rows of ``b (..., q, d)``."""
        diff = x[..., None, :] - b
        return torch.sqrt((diff * diff).sum(-1))

    def pairwise_np(self, a, b):
        """:meth:`pairwise` in float64 numpy."""
        diff = a[..., :, None, :] - b[..., None, :, :]
        return np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))

    def one_to_many_np(self, x, b):
        """:meth:`one_to_many` in float64 numpy."""
        diff = x[..., None, :] - b
        return np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))


class DotProduct:
    """Similarity-based 'distance' for embedding spaces:
    d(x, y) = 1 - <x, y> / (||x|| ||y||), the cosine dissimilarity, in [0, 2].

    With ``normalize=False`` it is ``1 - <x, y>`` (pure dot-product
    similarity, for inputs already of unit norm).  Kernels treat the value
    exactly like a distance: zero at parallel inputs, larger when less
    similar."""

    name = "dotproduct"

    def __init__(self, normalize: bool = True, eps: float = 1e-12):
        self.normalize = normalize
        self.eps = eps

    def _maybe_normalize(self, x):
        if not self.normalize:
            return x
        nrm = torch.sqrt((x * x).sum(-1, keepdim=True))
        return x / torch.clamp(nrm, min=self.eps)

    def pairwise(self, a, b):
        """Dissimilarity matrix between rows of ``a (..., p, d)`` and ``b (..., q, d)``.

        The similarity is a sum of elementwise products, never a matmul: a
        float32 matmul may run in TF32 on the GPU, whose 10-bit mantissa
        loses ~1e-3 of 1 - sim near sim = 1, exactly where neighbors lie
        (the reference asks for "highest" precision, ``pynngp_tpu/distance.py:80-86``)."""
        a = self._maybe_normalize(a)
        b = self._maybe_normalize(b)
        sim = (a[..., :, None, :] * b[..., None, :, :]).sum(-1)
        return torch.clamp(1.0 - sim, min=0.0)

    def pairwise_sq(self, a, b):
        """Squared dissimilarities (..., p, q)."""
        d = self.pairwise(a, b)
        return d * d

    def one_to_many(self, x, b):
        """Dissimilarities from one point ``x (..., d)`` to rows of ``b (..., q, d)``."""
        x = self._maybe_normalize(x)
        b = self._maybe_normalize(b)
        sim = (x[..., None, :] * b).sum(-1)
        return torch.clamp(1.0 - sim, min=0.0)

    def _normalize_np(self, x):
        if not self.normalize:
            return x
        nrm = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.maximum(nrm, self.eps)

    def pairwise_np(self, a, b):
        """:meth:`pairwise` in float64 numpy."""
        a = self._normalize_np(np.asarray(a, np.float64))
        b = self._normalize_np(np.asarray(b, np.float64))
        sim = np.einsum("...pd,...qd->...pq", a, b)
        return np.maximum(1.0 - sim, 0.0)

    def one_to_many_np(self, x, b):
        """:meth:`one_to_many` in float64 numpy."""
        x = self._normalize_np(np.asarray(x, np.float64))
        b = self._normalize_np(np.asarray(b, np.float64))
        sim = (x[..., None, :] * b).sum(-1)
        return np.maximum(1.0 - sim, 0.0)


_REGISTRY = {
    "euclidean": Euclidean,
    "dotproduct": DotProduct,
}


def get_distance(name_or_obj):
    """Resolve a distance from a name or pass an instance through."""
    if isinstance(name_or_obj, str):
        return _REGISTRY[name_or_obj.lower()]()
    return name_or_obj
