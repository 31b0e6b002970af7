"""The port's neighbor tables (``pynngp_tpu_torch.neighbors``) against the
reference's (``pynngp_tpu.neighbors``): the max-min order on each of its
three paths (the dense sweep up to 4,096 sites, the native order for d <= 3,
the lazy-heap path), the natural order, the dot-product metric's blocked
brute force at two block sizes, and the on-disk cache, whose files either
package loads from the other.  Tables are compared bit for bit; the models
on the max-min and natural orders give the reference's value and gradient
at rtol 1e-8 (float64 on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynngp_tpu import neighbors as jneighbors
from pynngp_tpu.models.response import ResponseNNGP as JaxResponseNNGP
from pynngp_tpu_torch import native, neighbors
from pynngp_tpu_torch.models.response import ResponseNNGP


def _same_table(a, b):
    for field in ("order", "inverse_order", "nn_idx", "nn_mask"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def _both(coords, m, **kw):
    kw.setdefault("cache", False)
    return (neighbors.build_neighbor_table(coords, m, **kw),
            jneighbors.build_neighbor_table(coords, m, **kw))


@pytest.mark.parametrize("use_native", ["auto", "never"])
@pytest.mark.parametrize("ordering", ["maxmin", "none", "coordinate"])
def test_orderings_dense_and_natural_match_the_reference(ordering, use_native):
    """n = 900 <= 4,096: the max-min order takes the dense sweep."""
    coords = np.random.default_rng(3).uniform(size=(900, 2))
    ours, ref = _both(coords, 10, ordering=ordering, use_native=use_native,
                      block_size=256)
    _same_table(ours, ref)
    if ordering == "none":
        np.testing.assert_array_equal(ours.order, np.arange(900))


def test_maxmin_native_path_matches_the_reference():
    """n = 6,000 in d = 2: the native max-min order, the same as the
    reference's, a true permutation with a nonincreasing max-min profile."""
    if not native.native_available():
        pytest.skip("the native host library needs g++")
    coords = np.random.default_rng(4).uniform(size=(6000, 2))
    order = neighbors.order_maxmin(coords)
    np.testing.assert_array_equal(order, jneighbors.order_maxmin(coords))
    np.testing.assert_array_equal(np.sort(order), np.arange(6000))
    ours, ref = _both(coords, 12, ordering="maxmin")
    _same_table(ours, ref)


def _maxmin_profile(coords, order):
    """d_i = min over j < i of |x_order[i] - x_order[j]| (Euclidean)."""
    pts = coords[order]
    best = np.full(len(order), np.inf)
    prof = np.empty(len(order))
    prof[0] = np.inf
    for i in range(1, len(order)):
        best = np.minimum(best, np.sqrt(((pts - pts[i - 1]) ** 2).sum(1)))
        prof[i] = best[i]
    return prof


def test_maxmin_heap_path_matches_the_reference():
    """n = 6,000: the lazy-heap order bit for bit (d = 2, called directly;
    d = 4 through order_maxmin, where the native order refuses d > 3), and
    its max-min profile equals the dense sweep's."""
    rng = np.random.default_rng(5)
    coords2 = rng.uniform(size=(6000, 2))
    heap = neighbors._order_maxmin_heap(coords2)
    np.testing.assert_array_equal(heap, jneighbors._order_maxmin_heap(coords2))
    coords4 = rng.uniform(size=(6000, 4))
    np.testing.assert_array_equal(neighbors.order_maxmin(coords4),
                                  jneighbors.order_maxmin(coords4))
    ours, ref = _both(coords4, 8, ordering="maxmin")
    _same_table(ours, ref)
    small = coords2[:1500]
    np.testing.assert_allclose(
        _maxmin_profile(small, neighbors._order_maxmin_heap(small, batch=64)),
        _maxmin_profile(small, neighbors._order_maxmin_dense(small)), rtol=1e-12)


@pytest.mark.parametrize("block_size", [256, 2048])
@pytest.mark.parametrize("ordering", ["coordinate", "maxmin"])
def test_dotproduct_tables_match_the_reference(block_size, ordering):
    """The blocked brute-force search of the cosine dissimilarity on
    embedding-like vectors (n = 3,000, d = 8)."""
    coords = np.random.default_rng(6).standard_normal((3000, 8))
    ours, ref = _both(coords, 10, ordering=ordering, metric="dotproduct",
                      block_size=block_size)
    _same_table(ours, ref)
    # brute force by hand at a few sites: the m most similar predecessors
    pts = coords[ours.order]
    unit = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    for i in (11, 700, 2999):
        d = 1.0 - unit[:i] @ unit[i]
        want = np.sort(d)[:10]
        got = np.sort(1.0 - unit[ours.nn_idx[i]] @ unit[i])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_unknown_ordering_and_metric_raise():
    coords = np.random.default_rng(7).uniform(size=(50, 2))
    with pytest.raises(ValueError, match="ordering"):
        neighbors.build_neighbor_table(coords, 5, ordering="hilbert", cache=False)
    with pytest.raises(ValueError, match="metric"):
        neighbors.build_neighbor_table(coords, 5, metric="manhattan", cache=False)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_cached_table_loads_in_the_other_package(writer, tmp_path, monkeypatch):
    """Same key, same file: a table stored by one package is loaded (not
    rebuilt) by the other."""
    monkeypatch.setenv("PYNNGP_NEIGHBOR_CACHE", str(tmp_path))
    coords = np.random.default_rng(8).uniform(size=(700, 2))
    kw = dict(ordering="maxmin", metric="euclidean", seed=3)
    build, reader, read_mod = (
        (neighbors.build_neighbor_table, jneighbors.build_neighbor_table, jneighbors)
        if writer == "port" else
        (jneighbors.build_neighbor_table, neighbors.build_neighbor_table, neighbors))
    stored = build(coords, 9, **kw)
    files = os.listdir(tmp_path)
    key = neighbors._table_cache_key(coords, 9, "maxmin", "euclidean", 3)
    assert files == [f"nn-{key}.npz"]
    assert key == jneighbors._table_cache_key(coords, 9, "maxmin", "euclidean", 3)

    def no_build(*args, **kwargs):
        raise AssertionError("the cached table was rebuilt")

    monkeypatch.setattr(read_mod, "_build_neighbor_table_impl", no_build)
    _same_table(reader(coords, 9, **kw), stored)


def test_cache_off_corrupt_file_and_another_key(tmp_path, monkeypatch):
    coords = np.random.default_rng(9).uniform(size=(400, 2))
    monkeypatch.setenv("PYNNGP_NEIGHBOR_CACHE", "0")
    neighbors.build_neighbor_table(coords, 6)
    monkeypatch.setenv("PYNNGP_NEIGHBOR_CACHE", str(tmp_path))
    assert os.listdir(tmp_path) == []
    want = neighbors.build_neighbor_table(coords, 6, cache=False)
    path = tmp_path / f"nn-{neighbors._table_cache_key(coords, 6, 'coordinate', 'euclidean', 0)}.npz"
    path.write_bytes(b"not a table")
    _same_table(neighbors.build_neighbor_table(coords, 6), want)  # rebuilt
    _same_table(neighbors._table_cache_load(str(path)), want)  # and stored anew
    # another m is another key
    assert neighbors.build_neighbor_table(coords, 4).nn_idx.shape == (400, 4)
    assert len(os.listdir(tmp_path)) == 2


@pytest.mark.parametrize("ordering", ["maxmin", "none"])
def test_response_model_on_the_orderings_matches(ordering):
    rng = np.random.default_rng(21)
    coords = rng.uniform(size=(300, 2))
    y = np.sin(6.0 * coords[:, 0]) * np.cos(4.0 * coords[:, 1]) + 0.3 * rng.standard_normal(300)
    jm = JaxResponseNNGP(coords, y, kernel="sqexp", m=6, backend="xla",
                         ordering=ordering, dtype=jnp.float64)
    tm = ResponseNNGP(coords, y, kernel="sqexp", m=6, device="cpu",
                      ordering=ordering, dtype=torch.float64)
    np.testing.assert_array_equal(tm.table.order, jm.data.table.order)
    u = (0.1, -1.0, -2.0)
    jv, jg = jax.value_and_grad(jm.full_logpost)(jnp.asarray(u, jnp.float64))
    ut = torch.tensor(u, dtype=torch.float64, requires_grad=True)
    tv = tm.full_logpost(ut)
    (tg,) = torch.autograd.grad(tv, ut)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8)
