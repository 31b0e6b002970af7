"""Explicit kriging weights B and conditional variances F — the counterpart
of ``pallas_bf`` (``pynngp_tpu/ops/pallas_bf.py:991-1048``).

:func:`bf_planes` launches kernel 3 (``csrc/vecchia_bf.cu``) for CUDA tensors
and runs :func:`bf_reference`, its plain PyTorch version, for CPU tensors.
Chains are an explicit leading axis: ``phi`` and ``alpha`` are (C,) tensors,
the tables are shared by all chains.  The general-nu Matern (``Matern()``
with a (C,) ``nu``, or ``Matern(nu=0.8)``) launches the kernel's GENERAL
instances (``csrc/vecchia_bf_nu.cu``), counted in ``COUNT_NU``.  Tables in the
coords layout launch the COORDS instances of either set
(``csrc/vecchia_bf_coords.cu``, ``csrc/vecchia_bf_nu_coords.cu``), counted in
``COUNT_COORDS`` and ``COUNT_NU_COORDS``.

Layout.  B comes out plane-major, ``(C, m, n_pad)``, and F as ``(C, n_pad)``:
the layout the kernel stores coalesced and the one the models consume (the
neighbor gather ``w[:, nbr]`` with ``nbr`` (m, n) lands in the same shape, and
a child's weight is one flat index ``slot * n_pad + site``), so nothing is
transposed on the way.  :func:`bf` returns the ``(C, n, m)`` / ``(C, n)``
views in the reference's row-major layout, for tests and callers that want it.

Heterogeneous noise (``noise_v``, the reference's ``pallas_bf(...,
noise_v=)``, ``pallas_bf.py:1036``): the relative nugget alpha v at the
neighbors and at the site; the same instances with a pointer to v (gathered
in the kernel through ``nn_idx``), counted under ``<instance>_hetero``.  The
latent model passes alpha = 0 and no v, as the reference does.

Padded sites (site >= n) hold B = 0 and F = 1, from the kernel and from the
plain version alike: their table entries are zero, so with alpha = 0 their
system would be the singular all-ones matrix.  A consumer may take log F or
1/F over all n_pad sites; sums over sites still run over ``[:n]``.

Shards (the reference's ``make_sharded_pallas_bf``, ``pallas_bf.py:1346``):
on :class:`~.site_tables.ShardedTables` :func:`bf_planes` makes one launch a
mesh cell and concatenates the shards' planes along the sites on the mesh's
first device, the reference's all_gather.
"""

from __future__ import annotations

import torch

from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops.site_tables import ShardedTables, SiteTables, unpack_distances
from pynngp_tpu_torch.ops.suffstats import (
    count_team,
    cuda_args,
    entry_name,
    family_arg,
    global_sites,
    instance,
    kernel_nu,
    launch_geometry,
    map_cells,
    noise_plane,
    noise_terms,
    params_array,
    plain_nu,
    pointer,
    shape_args,
)
from pynngp_tpu_torch.vecchia import conditional_system

__all__ = ["COUNT", "COUNT_NU", "COUNT_COORDS", "COUNT_NU_COORDS", "bf",
           "bf_planes", "bf_reference", "plane_suffstats"]

COUNT = _build.LaunchCount("vecchia_bf")
COUNT_NU = _build.LaunchCount("vecchia_bf_nu")  # the GENERAL instances
COUNT_COORDS = _build.LaunchCount("vecchia_bf_coords")  # COORDS
COUNT_NU_COORDS = _build.LaunchCount("vecchia_bf_nu_coords")
COUNTS = _build.with_variant_counts(COUNT, COUNT_NU, COUNT_COORDS, COUNT_NU_COORDS)


def bf_reference(kernel, tables: SiteTables, params, noise_v=None):
    """Plain PyTorch version of kernel 3: batched ``torch.linalg.cholesky``
    over (C, n_pad) systems and two triangular solves.  Returns B
    (C, m, n_pad) and F (C, n_pad) in the tables' dtype.  ``noise_v``:
    per-site noise weights, (n,) or padded, or None."""
    d_in, d_nn = unpack_distances(tables)
    site = global_sites(tables)
    valid = site < tables.n
    # slot k of site i is a real neighbor iff i > k; a padded site has none
    mask = (site[:, None] > torch.arange(tables.m, device=tables.device)) & valid[:, None]
    phi, alpha, jitter = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    alpha_nbr, alpha_own = noise_terms(tables, alpha, noise_plane(tables, noise_v))
    c_mat, c_vec = conditional_system(kernel, phi, alpha, jitter, d_in, d_nn,
                                      mask, nu=plain_nu(kernel, params),
                                      fused=True, alpha_nbr=alpha_nbr)
    low = torch.linalg.cholesky(c_mat)  # (C, n_pad, m, m)
    u = torch.linalg.solve_triangular(low, c_vec[..., None], upper=False)
    b = torch.linalg.solve_triangular(low.mT, u, upper=True)[..., 0]
    f = 1.0 + alpha_own - (u[..., 0] * u[..., 0]).sum(-1)
    f = torch.where(valid, f, torch.ones((), dtype=f.dtype, device=f.device))
    return b.transpose(1, 2).contiguous(), f


def _launch(kernel, tables: SiteTables, params, noise_v, sharded=False):
    params, _, v = cuda_args(tables, params, noise_v=noise_v)
    chains = params.shape[0]
    dev = tables.device
    _, geo_args, scratch = launch_geometry("vecchia_bf", kernel, tables, chains, None, v)
    b = torch.empty((chains, tables.m, tables.n_pad), dtype=torch.float32,
                    device=dev)
    f = torch.empty((chains, tables.n_pad), dtype=torch.float32, device=dev)
    head = (params.data_ptr(), tables.tab_a.data_ptr(), tables.tab_b.data_ptr(),
            tables.nn_idx.data_ptr(), pointer(v), *shape_args(tables), chains,
            *family_arg(kernel), *geo_args)
    tail = (b.data_ptr(), f.data_ptr(), _build.stream_handle(dev))
    entry = entry_name("vecchia_bf", kernel, tables)
    with torch.cuda.device(dev):
        _build.check(getattr(_build.library(), entry + "_f32")(*head, *tail), entry)
    del scratch  # the launch is enqueued: the allocator orders any reuse after it
    COUNTS[instance("vecchia_bf", kernel, tables, hetero=v is not None,
                    sharded=sharded)].launches += 1
    count_team("vecchia_bf", kernel, tables, chains, sharded=sharded)
    return b, f


def _one(kernel, tables: SiteTables, params, noise_v, sharded=False):
    """Kernel 3 on CUDA tables, its plain version on CPU tables."""
    if tables.device.type == "cuda":
        return _launch(kernel, tables, params, noise_v, sharded)
    if tables.device.type != "cpu":
        raise ValueError(f"no kernel for device {tables.device}")
    COUNTS[instance("vecchia_bf", kernel, tables, hetero=noise_v is not None,
                    sharded=sharded)].plain += 1
    return bf_reference(kernel, tables, params, noise_v)


def bf_planes(kernel, tables: SiteTables, phi, alpha, jitter=1e-6, nu=None,
              noise_v=None):
    """Plane-major (B (C, m, n_pad), F (C, n_pad)) of the unit-variance
    Vecchia factorization, per chain.

    Args:
      kernel: a kernel of :mod:`pynngp_tpu_torch.kernels`.
      tables: :class:`SiteTables` of the dataset.
      phi, alpha: (C,) per-chain range and relative nugget (scalars give
        C = 1); alpha is 0 for the latent process.
      nu: (C,) per-chain smoothness, for a kernel that samples it only.
      noise_v: per-site noise weights v, (n,) or padded (n_pad,): the
        relative nugget becomes alpha v.
    B is 0 in invalid slots; padded sites hold B = 0, F = 1.  CUDA tensors
    launch kernel 3; CPU tensors run :func:`bf_reference`.
    :class:`ShardedTables` make one launch a mesh cell; B and F come back
    whole on the first device.
    """
    params = params_array(phi, alpha, jitter, tables.n, tables.dtype,
                          tables.device, kernel_nu(kernel, nu), tables.off)
    if isinstance(tables, ShardedTables):
        return tuple(map_cells(
            tables, params, None, noise_v,
            lambda t, p, _, v_c, several: _one(kernel, t, p, v_c, several), (2, 1)))
    return _one(kernel, tables, params, noise_v)


def bf(kernel, tables: SiteTables, phi, alpha, jitter=1e-6, nu=None, noise_v=None):
    """(B (C, n, m), F (C, n)): :func:`bf_planes` as row-major views over the
    true sites, the layout ``pallas_bf`` returns.  No copy is made."""
    b, f = bf_planes(kernel, tables, phi, alpha, jitter, nu, noise_v)
    return b[:, :, :tables.n].transpose(1, 2), f[:, :tables.n]


def plane_suffstats(b, f, y, nbr):
    """(logdet, quad, resid) of y under plane-major B/F: sum_i log F_i,
    sum_i r_i^2 / F_i and r_i = y_i - B_i . y_N(i), per chain.

    ``b`` is (C, m, n_pad), ``f`` (C, n_pad), ``y`` (n,) or (C, n), and
    ``nbr`` the (m, n) int64 neighbor ids.  No slot mask is needed: B is 0 in
    invalid slots.  The sums accumulate in float64 and are cast back."""
    n = nbr.shape[1]
    f = f[:, :n]
    resid = y - (b[:, :, :n] * y[..., nbr]).sum(-2)
    logdet = torch.log(f).sum(-1, dtype=torch.float64).to(f.dtype)
    quad = (resid * resid / f).sum(-1, dtype=torch.float64).to(f.dtype)
    return logdet, quad, resid
