"""Distances for the one-time host precompute of the distance tables, the
neighbor search and the prediction tables (the numpy ``*_np`` methods of
``pynngp_tpu.distance``): Euclidean, and the dot-product (cosine)
dissimilarity for embedding spaces.  Every distance the port uses is
computed on the host in float64; the kernels read it from the tables."""

from __future__ import annotations

import numpy as np

__all__ = ["Euclidean", "DotProduct", "get_distance"]


class Euclidean:
    """Euclidean (L2) distance: dist(x, y) = ||x - y||."""

    name = "euclidean"

    def pairwise_np(self, a, b):
        """Distance matrix between rows of ``a (..., p, d)`` and ``b (..., q, d)``."""
        diff = a[..., :, None, :] - b[..., None, :, :]
        return np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))

    def one_to_many_np(self, x, b):
        """Distances from one point ``x (..., d)`` to rows of ``b (..., q, d)``."""
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

    def _normalize_np(self, x):
        if not self.normalize:
            return x
        nrm = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.maximum(nrm, self.eps)

    def pairwise_np(self, a, b):
        """Dissimilarity matrix between rows of ``a (..., p, d)`` and ``b (..., q, d)``."""
        a = self._normalize_np(np.asarray(a, np.float64))
        b = self._normalize_np(np.asarray(b, np.float64))
        sim = np.einsum("...pd,...qd->...pq", a, b)
        return np.maximum(1.0 - sim, 0.0)

    def one_to_many_np(self, x, b):
        """Dissimilarities from one point ``x (..., d)`` to rows of ``b (..., q, d)``."""
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
