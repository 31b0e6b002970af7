"""Euclidean distance for the one-time host precompute of the distance
tables (the numpy ``*_np`` methods of ``pynngp_tpu.distance``; the
dot-product distance is not ported yet)."""

from __future__ import annotations

import numpy as np

__all__ = ["Euclidean", "get_distance"]


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


def get_distance(name_or_obj):
    """Resolve a distance from a name or pass an instance through."""
    if isinstance(name_or_obj, str):
        if name_or_obj.lower() == "euclidean":
            return Euclidean()
        raise NotImplementedError(
            f"distance {name_or_obj!r} is not ported yet (only 'euclidean')"
        )
    if not isinstance(name_or_obj, Euclidean):
        raise NotImplementedError(
            f"distance {name_or_obj!r} is not ported yet (only Euclidean)"
        )
    return name_or_obj
