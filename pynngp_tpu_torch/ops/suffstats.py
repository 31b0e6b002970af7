"""Fused forward Vecchia sufficient statistics — the counterpart of
``pallas_suffstats`` / ``pallas_loglik`` (``pynngp_tpu/ops/pallas_bf.py:598-640``).

:func:`suffstats` launches kernel 1 (``csrc/vecchia_suffstats.cu``) for CUDA
tensors and runs :func:`suffstats_reference`, its plain PyTorch version, for
CPU tensors.  Chains are an explicit leading axis: ``phi`` and ``alpha`` are
(C,) tensors, the tables are shared by all chains, and y is either (n,),
shared, or (C, n), one row per chain (the residual y - X beta with fixed
effects).  The general-nu Matern (``kernel.family == 6``: ``Matern()`` with a
(C,) ``nu`` per chain, or ``Matern(nu=0.8)``) launches the kernel's GENERAL
instances (``csrc/vecchia_suffstats_nu.cu``), counted in ``COUNT_NU``.  Tables
in the coords layout launch the COORDS instances of either set
(``csrc/vecchia_suffstats_coords.cu``, ``csrc/vecchia_suffstats_nu_coords.cu``),
counted in ``COUNT_COORDS`` and ``COUNT_NU_COORDS``; :func:`instance` names
the instance a launch runs, and every wrapper counts a launch under it.

Heterogeneous noise (``noise_v``, the reference's ``noise_v`` of
``pallas_suffstats``, ``pallas_bf.py:598``): per-site weights v in ordered
site space make the relative nugget alpha v, at the neighbors on the
diagonal of C and at the site in F.  The same instances run, with a pointer
to v (:func:`noise_plane`) where homogeneous calls pass a null one; such
launches count under the instance's name with ``_hetero``.

Any m >= 1 runs on the card: a call with m <= 20 launches the smallest
built instance M >= m (:func:`cuda_instance_m`), whose slots k >= m are
identity rows, 20 < m <= 32 the rolled instance, whose loops run to m, and
m > 32 the large-m instances.  Up to m = 32 the three kernels launch in the
tile geometry of :mod:`.geometry` (a block is a group of chains that share
one staged tile of sites); above it each kernel runs a warp a (site, chain)
system in shared memory up to its limit (``geometry.M_SMEM`` for kernels 1
and 3, ``geometry.M_SMEM_GRAD`` for kernel 2); above that each kernel runs
a thread-block cluster a system up to ``geometry.CLUSTER_M`` (``M_CLUSTER``
for kernels 1 and 3, ``M_CLUSTER_GRAD`` for kernel 2; such launches count
under ``_large_cluster``), and above their last limit the
kernels run one thread a (site, chain) with its state in a scratch buffer
(:func:`launch_geometry`); such launches count under ``_large_scratch``.

At M = 20 (15 < m <= 20) the closed-form coords instance runs a team body
(``geometry.team_body``: a few lanes a (site, chain) system); such launches
also count in :data:`COUNTS_M20` (``<entry>_m20``, and ``<entry>_m20_4_chains``
for those of exactly four chains, one block's group; ``_sharded`` for a call
over several cells), beside the instance's count.

Shards.  Tables of one site shard (``SiteTables.off`` > 0) launch the same
instances with ``off`` in the params row; :class:`~.site_tables.ShardedTables`
make one launch a cell of their mesh (:func:`map_cells`: the chains split
over the chain rows, every site shard of a row on its device), and the
per-shard float64 partial sums add up on the mesh's first device, where the
per-site outputs are concatenated along the sites: the reference's
``make_sharded_diff_suffstats`` forward (``pallas_bf.py:1195``), its psum a
sum on one device.  A launch of a call with more than one cell counts under
the instance's name with ``_sharded``.
"""

from __future__ import annotations

import torch

from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops.geometry import (
    CUDA_M,
    cluster_geometry,
    cluster_slot_bytes,
    cuda_instance_m,
    geometry,
    large,
    large_body,
    large_geometry,
    smem_geometry,
    team_body,
)
from pynngp_tpu_torch.ops.site_tables import (
    BLOCK,
    MAX_SITE_INDEX,
    ShardedTables,
    SiteTables,
    chain_groups,
    unpack_distances,
)
from pynngp_tpu_torch.vecchia import LOG_2PI, conditional_system

__all__ = ["COUNT", "COUNT_NU", "COUNT_COORDS", "COUNT_NU_COORDS", "COUNTS_M20", "CUDA_M",
           "GENERAL_FAMILY", "cuda_instance_m", "entry_name", "instance", "kernel_nu",
           "count_team", "launch_geometry",
           "map_cells", "noise_plane", "params_array", "suffstats",
           "suffstats_reference", "loglik"]

COUNT = _build.LaunchCount("vecchia_suffstats")
COUNT_NU = _build.LaunchCount("vecchia_suffstats_nu")  # the GENERAL instances
COUNT_COORDS = _build.LaunchCount("vecchia_suffstats_coords")  # COORDS
COUNT_NU_COORDS = _build.LaunchCount("vecchia_suffstats_nu_coords")
COUNTS = _build.with_variant_counts(COUNT, COUNT_NU, COUNT_COORDS, COUNT_NU_COORDS)
GENERAL_FAMILY = 6  # kMaternGeneral of csrc/vecchia_common.cuh
# the C entries whose M = 20 instance runs a team body, and their launches
# there (every call of the entry at 15 < m <= 20, with or without weights;
# _4_chains: those of four chains)
TEAM_ENTRIES = ("vecchia_suffstats_coords", "vecchia_grad", "vecchia_grad_coords",
                "vecchia_grad_y", "vecchia_grad_y_coords", "vecchia_bf_coords")
COUNTS_M20 = {name + "_m20" + four + sfx: _build.LaunchCount(name + "_m20" + four + sfx)
              for name in TEAM_ENTRIES for four in ("", "_4_chains")
              for sfx in ("", "_sharded")}


def entry_name(base: str, kernel, tables: SiteTables, emit_y: bool = False) -> str:
    """The C entry (less ``_f32``) a launch of ``base`` calls: ``_y`` for the
    EMIT_Y instances, ``_nu`` for the general-nu Matern, ``_coords`` for
    tables in the coords layout."""
    return (base + ("_y" if emit_y else "")
            + ("_nu" if kernel.family == GENERAL_FAMILY else "")
            + ("_coords" if tables.layout == "coords" else ""))


def instance(base: str, kernel, tables: SiteTables, emit_y: bool = False,
             hetero: bool = False, sharded: bool = False) -> str:
    """The kernel instance a launch of ``base`` runs, named as its launch
    count: its C entry (:func:`entry_name`), ``_large`` for m > 32 (the
    large-m instance of the same entry), ``_large_cluster`` on the cluster
    body and ``_large_scratch`` on the scratch body, above the kernel's
    shared-memory limit (``geometry.large_body``), ``_hetero`` for a launch
    with noise weights and ``_sharded`` for one of a call over several mesh
    cells (the same entry again)."""
    body = large_body(base, tables.m) if large(tables.m) else None
    return (entry_name(base, kernel, tables, emit_y)
            + ("_large" if body else "")
            + ("_" + body if body in ("cluster", "scratch") else "")
            + ("_hetero" if hetero else "")
            + ("_sharded" if sharded else ""))


def count_team(base: str, kernel, tables: SiteTables, chains: int, emit_y: bool = False,
               sharded: bool = False) -> None:
    """Add one to the M = 20 team count of a launch of ``chains`` chains that
    ran a team body, and to its four-chain count if it had four."""
    dim = tables.dim if tables.layout == "coords" else 0
    if team_body(base, tables.m, tables.layout, dim, kernel.family == GENERAL_FAMILY):
        name = entry_name(base, kernel, tables, emit_y) + "_m20"
        sfx = "_sharded" if sharded else ""
        COUNTS_M20[name + sfx].launches += 1
        if chains == 4:
            COUNTS_M20[name + "_4_chains" + sfx].launches += 1


def noise_plane(tables: SiteTables, noise_v):
    """The per-site noise weights v as the kernels read them, whole on every
    shard: (max(n, reach),) in the tables' dtype and on their device, padded
    with 1 (the reference's ``_noise_planes``, ``pallas_bf.py:510-518``: F
    stays positive at padded sites); None for homogeneous noise.  ``noise_v``
    is (n,) in ordered site space, or already padded past n to at least the
    tables' reach (off + n_pad; (n_pad,) for unsharded tables)."""
    if noise_v is None:
        return None
    v = torch.as_tensor(noise_v, dtype=tables.dtype, device=tables.device)
    if v.dim() == 1 and v.shape[0] > tables.n and v.shape[0] >= tables.reach:
        return v.contiguous()
    if v.shape != (tables.n,):
        raise ValueError(f"noise_v must have shape ({tables.n},) or "
                         f"({max(tables.reach, tables.n + 1)},), got "
                         f"{tuple(v.shape)}")
    return torch.nn.functional.pad(v, (0, max(0, tables.reach - tables.n)),
                                   value=1.0)


def own_plane(tables: SiteTables, v):
    """The weights of the tables' own sites, v[off:off + n_pad], or None."""
    return None if v is None else v[tables.off:tables.reach]


def kernel_nu(kernel, nu=None):
    """The value of the params row's nu slot (``_kernel_nu``,
    ``pallas_bf.py:347``): the caller's per-chain ``nu`` for a kernel that
    samples it, the static nu of a general Matern, 0 for every kernel that
    reads none."""
    if kernel.samples_nu:
        if nu is None:
            raise ValueError(f"{kernel!r} samples nu: pass nu per chain")
        return nu
    if nu is not None:
        raise ValueError(f"{kernel!r} takes no nu")
    return kernel.static_nu if kernel.family == GENERAL_FAMILY else 0.0


def params_array(phi, alpha, jitter, n, dtype, device=None, nu=0.0, off=0):
    """(C, 6) per-chain parameter rows [phi, alpha, jitter, n, nu, off] in
    ``dtype``, mirroring ``_params_vec`` (``pallas_bf.py:496``): n the global
    site count, off the global index of the launch's first site (0 but for
    a site shard).  Differentiable in phi, alpha and nu."""
    phi = torch.atleast_1d(torch.as_tensor(phi, dtype=dtype, device=device))
    full = lambda v: torch.full_like(phi, float(v))
    # a Python number becomes a fill on phi's device: as_tensor would copy it
    # from the host and wait for the stream, once per call
    column = lambda v: (v.to(dtype=dtype, device=phi.device).expand_as(phi)
                        if isinstance(v, torch.Tensor) else full(v))
    return torch.stack([phi, column(alpha), full(jitter), full(n), column(nu),
                        full(off)], dim=-1)


def map_cells(sharded: ShardedTables, params, y, noise_v, launch, site_axes):
    """Run a call over ``sharded``: one ``launch(tables, params, y, v,
    several)`` for every chain row g with chains and every site shard of it,
    on the shard's device, with the row's params rows carrying the shard's
    off, and y ((n,) or the row's rows of (C, n)) and the global noise
    weights (:func:`noise_plane`) held whole on every shard; ``several`` says
    the call has more than one cell.  The outputs are joined on the mesh's
    first device: element i, a tuple element of every launch's output (or
    the output itself), is concatenated along the sites (dim
    ``site_axes[i]``) or, where that is None, its float64 sums added over the
    shards; then the rows are concatenated along the chains (dim 0; the last
    dim for sums)."""
    v = noise_plane(sharded, noise_v)
    several = sharded.n_cells > 1
    dev = sharded.device
    rows = []
    for g, chains in chain_groups(params.shape[0], len(sharded.cells)):
        outs = []
        for tables in sharded.cells[g]:
            cell = tables.device
            p = params[chains].to(cell)
            p = torch.cat([p[:, :5], torch.full_like(p[:, 5:], float(tables.off))], 1)
            y_c = None if y is None else (y if y.dim() == 1 else y[chains]).to(cell)
            out = launch(tables, p, y_c, None if v is None else v.to(cell), several)
            outs.append(out if isinstance(out, tuple) else (out,))
        rows.append([torch.cat([o[i].to(dev) for o in outs], axis) if axis is not None
                     else torch.stack([o[i].to(dev) for o in outs]).sum(0)
                     for i, axis in enumerate(site_axes)])
    return [torch.cat([r[i] for r in rows], 0 if axis is not None else -1)
            for i, axis in enumerate(site_axes)]


def global_sites(tables: SiteTables):
    """(n_pad,) global index of each of the tables' sites, site + off."""
    return torch.arange(tables.off, tables.reach, device=tables.device)


def _plain_inputs(tables: SiteTables, y):
    """Site-major distances, slot masks, y_N and y_own for the plain
    versions; y is (n,) or (C, n).  The masks, the validity and y_own go by
    the global site index, as the kernels'."""
    d_in, d_nn = unpack_distances(tables)
    site = global_sites(tables)
    mask = site[:, None] > torch.arange(tables.m, device=tables.device)[None, :]
    y_nbr = y[..., tables.nn_idx.T.long()] * mask.to(y.dtype)  # (..., n_pad, m)
    y_own = torch.nn.functional.pad(y, (0, max(0, tables.reach - tables.n)))
    y_own = y_own[..., tables.off:tables.reach]
    valid = site < tables.n
    return d_in, d_nn, mask, y_nbr, y_own, valid


def plain_nu(kernel, params):
    """The (C, 1) nu column of the params rows for the plain versions, or
    None for a kernel that reads none."""
    return params[:, 4:5] if kernel.family == GENERAL_FAMILY else None


def noise_terms(tables: SiteTables, alpha, v):
    """(relative nugget at each neighbor slot (C, n_pad, m), the site's own
    (C, n_pad)) under the weights ``v`` (:func:`noise_plane`), for the plain
    versions; (None, alpha) for homogeneous noise."""
    if v is None:
        return None, alpha
    return alpha[..., None] * v[tables.nn_idx.T.long()], alpha * own_plane(tables, v)


def _factor(kernel, tables, params, y, v=None):
    """Batched factorization shared by the plain versions of both kernels;
    ``v`` the (n_pad,) noise weights or None."""
    d_in, d_nn, mask, y_nbr, y_own, valid = _plain_inputs(tables, y)
    phi, alpha, jitter = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    alpha_nbr, alpha_own = noise_terms(tables, alpha, v)
    c_mat, c_vec = conditional_system(kernel, phi, alpha, jitter, d_in, d_nn,
                                      mask, nu=plain_nu(kernel, params),
                                      fused=True, alpha_nbr=alpha_nbr)
    # a system that is not positive definite (a chain at a non-finite or
    # absurd point) gives NaN, as the kernels do, and raises nothing: the
    # gradient samplers treat a NaN energy as a divergence
    low, info = torch.linalg.cholesky_ex(c_mat)  # (C, n_pad, m, m)
    low = torch.where(info[..., None, None] > 0, torch.nan, low)
    u = torch.linalg.solve_triangular(low, c_vec[..., None], upper=False)
    w = torch.linalg.solve_triangular(low, y_nbr[..., None], upper=False)
    u, w = u[..., 0], w[..., 0]
    f = 1.0 + alpha_own - (u * u).sum(-1)  # (C, n_pad)
    return dict(d_in=d_in, d_nn=d_nn, mask=mask, valid=valid, low=low, u=u,
                w=w, f=f, y_own=y_own)


def _reference64(kernel, tables: SiteTables, params, y, noise_v=None):
    """:func:`suffstats_reference` with its sums left in float64."""
    fac = _factor(kernel, tables, params, y, noise_plane(tables, noise_v))
    f, valid = fac["f"], fac["valid"]
    resid = fac["y_own"] - (fac["u"] * fac["w"]).sum(-1)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    logdet = torch.where(valid, torch.log(f), zero).sum(-1, dtype=torch.float64)
    quad = torch.where(valid, resid * resid / f, zero).sum(-1, dtype=torch.float64)
    return logdet, quad, f, resid


def suffstats_reference(kernel, tables: SiteTables, params, y, noise_v=None):
    """Plain PyTorch version of kernel 1: batched ``torch.linalg.cholesky``
    over (C, n_pad) systems.  Returns (logdet (C,), quad (C,), f (C, n_pad),
    resid (C, n_pad)), sums accumulated in float64 and cast to the tables'
    dtype.  Differentiable in ``params``.  ``noise_v``: per-site noise
    weights, (n,) or padded (:func:`noise_plane`), or None."""
    logdet, quad, f, resid = _reference64(kernel, tables, params, y, noise_v)
    return logdet.to(f.dtype), quad.to(f.dtype), f, resid


def cuda_args(tables: SiteTables, params, y=None, noise_v=None):
    """Validate the inputs of a CUDA launch; returns (params, y, v) as
    contiguous float32 tensors (y stays None for a kernel that reads none, v
    for homogeneous noise).  y is (n,), shared by all chains, or (C, n):
    :func:`y_stride` of it is the kernels' chain stride.  ``params`` may live
    on the host (a sampler that keeps its few parameters there): the (C, 6)
    rows are copied to the card."""
    cuda_instance_m(tables.m)
    if tables.n_pad % BLOCK:
        raise ValueError(f"n_pad={tables.n_pad} is not a multiple of {BLOCK}")
    if tables.n >= MAX_SITE_INDEX or tables.reach > MAX_SITE_INDEX:
        # n and off ride the float32 params row, exact below 2^24
        raise ValueError(f"n={tables.n} sites, global site indices up to "
                         f"off + n_pad - 1 = {tables.reach - 1}: the kernels "
                         f"take them below 2^24 = {MAX_SITE_INDEX}")
    for name, t in (("tab_a", tables.tab_a), ("tab_b", tables.tab_b)):
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
    if tables.layout == "coords" and tables.tab_b.shape[0] != tables.m * tables.dim:
        raise ValueError(f"coords tables need m d neighbor planes, got "
                         f"{tuple(tables.tab_a.shape)}, {tuple(tables.tab_b.shape)}")
    if tables.nn_idx.dtype != torch.int32 or not tables.nn_idx.is_contiguous():
        raise ValueError("nn_idx must be a contiguous int32 tensor")
    if y is not None:
        if y.dtype != torch.float32 or y.device != tables.device:
            raise ValueError("y must be a float32 tensor on the tables' device")
        if y.shape not in ((tables.n,), (params.shape[0], tables.n)):
            raise ValueError(f"y must have shape ({tables.n},) or "
                             f"({params.shape[0]}, {tables.n}), got "
                             f"{tuple(y.shape)}")
        y = y.detach().contiguous()
    if params.dim() != 2 or params.shape[-1] != 6:
        raise ValueError("params must be (C, 6)")
    params = params.detach().to(device=tables.device,
                                dtype=torch.float32).contiguous()
    v = noise_plane(tables, noise_v)
    return params, y, None if v is None else v.detach()


def pointer(t):
    """A tensor's address for a C entry, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


def y_stride(y) -> int:
    """Elements between two chains' y: 0 for a shared (n,) y."""
    return 0 if y.dim() == 1 else y.shape[-1]


def shape_args(tables: SiteTables) -> tuple:
    """(n_pad, m), and d for the coords layout: the arguments every C entry
    takes after its tables (and nn_idx and y), before the chain count."""
    coords = (tables.dim,) if tables.layout == "coords" else ()
    return (tables.n_pad, tables.m, *coords)


def family_arg(kernel) -> tuple:
    """The closed-form entries take the family; the general-nu ones none."""
    return () if kernel.family == GENERAL_FAMILY else (kernel.family,)


def launch_geometry(base: str, kernel, tables: SiteTables, chains: int, y, v):
    """(grid_x, the four C arguments group, grid_x, shared bytes and scratch
    pointer, the scratch tensor or None) of a launch of kernel ``base``;
    ``y`` is None for kernel 3.  m <= 32: the tile geometry
    (:func:`.geometry.geometry`), no scratch; 32 < m <= the kernel's limit
    (``geometry.SMEM_M``): the shared-memory body
    (:func:`.geometry.smem_geometry`), no scratch; up to the kernel's
    ``geometry.CLUSTER_M``: the cluster body (:func:`.geometry.cluster_geometry`:
    group the cluster's blocks, grid_x its clusters a chain) and its
    hand-off buffer as the scratch tensor (``geometry.cluster_slot_bytes``);
    above: the scratch body (:func:`.geometry.large_geometry`): group 1, no
    shared bytes, and a scratch buffer.  The caller keeps a scratch tensor
    until the launch is enqueued."""
    body = large_body(base, tables.m) if large(tables.m) else None
    if body == "smem":
        geo = smem_geometry(tables.n_pad, tables.m, chains, base)
        return geo.grid[0], (geo.group, geo.grid[0], geo.smem_bytes, None), None
    if body == "cluster":
        geo = cluster_geometry(tables.n_pad, tables.m, chains, base)
        slots = torch.empty(cluster_slot_bytes(tables.m) // 8, dtype=torch.float64,
                            device=tables.device)
        return geo.grid[0], (geo.group, geo.grid[0], geo.smem_bytes, slots.data_ptr()), slots
    if body == "scratch":
        geo = large_geometry(tables.n_pad, tables.m, chains)
        scratch = torch.empty(geo.scratch_bytes // 8, dtype=torch.float64,
                              device=tables.device)
        return geo.grid[0], (1, geo.grid[0], 0, scratch.data_ptr()), scratch
    geo = geometry(tables.n_pad, tables.m, chains, tables.layout,
                   tables.dim if tables.layout == "coords" else 0,
                   y_shared=y is None or y.dim() == 1, hetero=v is not None,
                   general=kernel.family == GENERAL_FAMILY, with_y=y is not None)
    return geo.grid[0], (geo.group, geo.grid[0], geo.smem_bytes, None), None


def _launch(kernel, tables: SiteTables, params, y, noise_v, sharded=False):
    """One launch of kernel 1; its sums in float64."""
    params, y, v = cuda_args(tables, params, y, noise_v)
    chains = params.shape[0]
    dev = tables.device
    grid_x, geo_args, scratch = launch_geometry("vecchia_suffstats", kernel, tables, chains,
                                                y, v)
    f = torch.empty((chains, tables.n_pad), dtype=torch.float32, device=dev)
    resid = torch.empty_like(f)
    part = torch.empty((2, chains, grid_x), dtype=torch.float32, device=dev)
    head = (params.data_ptr(), tables.tab_a.data_ptr(), tables.tab_b.data_ptr(),
            tables.nn_idx.data_ptr(), y.data_ptr(), y_stride(y), pointer(v),
            *shape_args(tables), chains, *family_arg(kernel), *geo_args)
    tail = (f.data_ptr(), resid.data_ptr(), part.data_ptr(),
            _build.stream_handle(dev))
    entry = entry_name("vecchia_suffstats", kernel, tables)
    with torch.cuda.device(dev):
        _build.check(getattr(_build.library(), entry + "_f32")(*head, *tail), entry)
    del scratch  # the launch is enqueued: the allocator orders any reuse after it
    COUNTS[instance("vecchia_suffstats", kernel, tables, hetero=v is not None,
                    sharded=sharded)].launches += 1
    count_team("vecchia_suffstats", kernel, tables, chains, sharded=sharded)
    sums = part.sum(-1, dtype=torch.float64)
    return sums[0], sums[1], f, resid


def _one(kernel, tables: SiteTables, params, y, noise_v, sharded=False):
    """Kernel 1 on CUDA tables, its plain version on CPU tables; sums in
    float64."""
    if tables.device.type == "cuda":
        return _launch(kernel, tables, params, y, noise_v, sharded)
    if tables.device.type != "cpu":
        raise ValueError(f"no kernel for device {tables.device}")
    COUNTS[instance("vecchia_suffstats", kernel, tables,
                    hetero=noise_v is not None, sharded=sharded)].plain += 1
    return _reference64(kernel, tables, params, y, noise_v)


def suffstats(kernel, tables: SiteTables, phi, alpha, y, jitter=1e-6, nu=None,
              noise_v=None):
    """(logdet, quad, f, resid) of the unit-variance Vecchia factorization,
    per chain.

    Args:
      kernel: a kernel of :mod:`pynngp_tpu_torch.kernels`.
      tables: :class:`SiteTables` of the dataset.
      phi, alpha: (C,) per-chain range and relative nugget (scalars give C=1).
      y: (n,) ordered values shared by all chains, or (C, n) per chain.
      nu: (C,) per-chain smoothness, for a kernel that samples it only.
      noise_v: per-site noise weights v in ordered site space, (n,) or padded
        (:func:`noise_plane`): the relative nugget becomes alpha v.
    Returns logdet, quad as (C,) and f, resid as (C, n_pad); padded sites are
    excluded from the sums.  CUDA tensors launch kernel 1; CPU tensors run
    :func:`suffstats_reference`.  :class:`ShardedTables` make one launch a
    mesh cell, and f, resid come back whole on the first device.
    """
    params = params_array(phi, alpha, jitter, tables.n, tables.dtype,
                          tables.device, kernel_nu(kernel, nu), tables.off)
    if isinstance(tables, ShardedTables):
        logdet, quad, f, resid = map_cells(
            tables, params, y, noise_v,
            lambda t, p, y_c, v_c, several: _one(kernel, t, p, y_c, v_c, several),
            (None, None, 1, 1))
    else:
        logdet, quad, f, resid = _one(kernel, tables, params, y, noise_v)
    return logdet.to(f.dtype), quad.to(f.dtype), f, resid


def loglik(kernel, tables: SiteTables, phi, y, sigma2, alpha, jitter=1e-6,
           nu=None, noise_v=None):
    """Response-model Vecchia log-likelihood per chain (``pallas_loglik``)."""
    logdet, quad, _, _ = suffstats(kernel, tables, phi, alpha, y, jitter, nu,
                                   noise_v)
    sigma2 = torch.as_tensor(sigma2, dtype=logdet.dtype, device=logdet.device)
    return -0.5 * (tables.n * (LOG_2PI + torch.log(sigma2)) + logdet
                   + quad / sigma2)
