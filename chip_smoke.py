"""Smoke run of pynngp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``pynngp_tpu_torch/csrc``, holds each against
its plain PyTorch version, times both, then drives the main path once (the
response NNGP at n=100,000, m=15, sqexp, as ``bench.py``'s ``bench_ess`` MWG
branch runs it) and checks that it went through the kernels.  Any failure
exits non-zero.  Without a CUDA device it exits 1 and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pynngp_tpu_torch import diagnostics
from pynngp_tpu_torch.kernels import Exponential, SqExp
from pynngp_tpu_torch.models.response import ResponseNNGP
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import diff_suffstats as diff_ops
from pynngp_tpu_torch.ops import suffstats as fwd_ops
from pynngp_tpu_torch.ops.site_tables import make_site_tables
from pynngp_tpu_torch.vecchia import make_vecchia_data

N_MAIN, M_MAIN, CHAINS = 100_000, 15, 16
TAU2_TRUE = 0.09  # the generator's noise variance, 0.3^2
KERNEL_ROWS = {
    "vecchia_suffstats": ("pynngp_tpu_torch/csrc/vecchia_suffstats.cu",
                          "pynngp_tpu/ops/pallas_bf.py:409", fwd_ops.COUNT),
    "vecchia_grad": ("pynngp_tpu_torch/csrc/vecchia_grad.cu",
                     "pynngp_tpu/ops/pallas_bf.py:727", diff_ops.COUNT),
}


class SmokeFailure(RuntimeError):
    pass


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bench_field(n: int, seed: int = 0):
    """bench.py's bench_ess generator: an RFF draw from a sqexp GP with
    lengthscale ~0.07 on the unit square plus N(0, 0.3^2) noise."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    n_feat = 256
    freqs = rng.normal(scale=20.0, size=(n_feat, 2))
    phases = rng.uniform(0, 2 * np.pi, n_feat)
    w = np.sqrt(2 / n_feat) * np.cos(coords @ freqs.T + phases).sum(axis=1)
    y = w + 0.3 * rng.standard_normal(n)
    return coords, y


def ptxas_summary(ptxas: str, m: int) -> str:
    """'<kernel>: R regs, S/L bytes spill stores/loads' for the m instances."""
    out = []
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or f"ILi{m}E" not in line:
            continue
        name = "suffstats" if "suffstats_kernel" in line else "grad"
        spill = regs = "?"
        for nxt in lines[i + 1:i + 4]:
            if "spill stores" in nxt:
                parts = nxt.split(",")
                spill = "/".join(p.split()[0] for p in parts[1:3])
            if "registers" in nxt:
                regs = nxt.split("Used")[1].split("registers")[0].strip()
        out.append(f"{name}<{m}> {regs} regs spill {spill} B")
    return "; ".join(out)


class Case:
    """Site tables, y and per-chain parameters of one parity case, in float32
    for the kernels and the same values in float64 for the oracle."""

    def __init__(self, n, m, kernel, chains, seed, dev):
        coords, y = bench_field(n, seed)
        data, table = make_vecchia_data(coords, m, dtype=torch.float64)
        self.n, self.m, self.kernel = n, m, kernel
        self.tab32 = make_site_tables(data, dtype=torch.float32, device=dev)
        self.tab64 = self.tab32._replace(d_in=self.tab32.d_in.double(),
                                         d_tri=self.tab32.d_tri.double())
        self.y32 = torch.as_tensor(y[table.order], dtype=torch.float32, device=dev)
        self.y64 = self.y32.double()
        self.phi = torch.linspace(0.05, 0.2, chains, device=dev)
        self.alpha = torch.linspace(0.05, 0.3, chains, device=dev)
        self.jitter = 1e-6

    def params64(self, sl, requires_grad=False):
        phi = self.phi[sl].double().requires_grad_(requires_grad)
        alpha = self.alpha[sl].double().requires_grad_(requires_grad)
        pr = fwd_ops.params_array(phi, alpha, np.float32(self.jitter), self.n,
                                  torch.float64, phi.device)
        return phi, alpha, pr

    def chunks(self, size=4):
        return [slice(i, i + size) for i in range(0, self.phi.shape[0], size)]


def _rel(a, b):
    return float(((a - b).abs() / b.abs()).max())


def _allclose_ratio(a, b, rtol, atol):
    """Worst |a-b| / (atol + rtol |b|): <= 1 passes, as numpy's allclose."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def check_forward(case: Case, label: str) -> dict:
    """Kernel 1 against its plain version (float64 on the card, chunked over
    chains); tolerances of tests/test_pallas.py:62-70."""
    logdet, quad, f, r = fwd_ops.suffstats(case.kernel, case.tab32, case.phi,
                                           case.alpha, case.y32, case.jitter)
    torch.cuda.synchronize()
    ref = [fwd_ops.suffstats_reference(case.kernel, case.tab64,
                                       case.params64(sl)[2], case.y64)
           for sl in case.chunks()]
    ld_ref, q_ref, f_ref, r_ref = (torch.cat(x) for x in zip(*ref))
    n = case.n
    f, r = f[:, :n].double(), r[:, :n].double()
    f_ref, r_ref = f_ref[:, :n], r_ref[:, :n]
    res = {
        "logdet_rel": _rel(logdet.double(), ld_ref),
        "quad_rel": _rel(quad.double(), q_ref),
        "f_ratio": _allclose_ratio(f, f_ref, 1e-4, 1e-6),
        "r_ratio": _allclose_ratio(r, r_ref, 2e-3, 1e-4),
        "f_max_abs_err": float((f - f_ref).abs().max()),
    }
    print(f"forward parity [{label}]: " + json.dumps(res), flush=True)
    _require(res["logdet_rel"] <= 3e-4 and res["quad_rel"] <= 3e-4,
             f"kernel 1 logdet/quad disagree [{label}]")
    _require(res["f_ratio"] <= 1.0 and res["r_ratio"] <= 1.0,
             f"kernel 1 F/r disagree [{label}]")
    return res


def check_grad(case: Case, label: str, grad_rtol: float) -> dict:
    """Kernel 2 against autograd through the plain float64 version."""
    sums = diff_ops.value_and_grad_sums(case.kernel, case.tab32, case.phi,
                                        case.alpha, case.y32, case.jitter)
    torch.cuda.synchronize()
    refs = []
    for sl in case.chunks():
        phi, alpha, pr = case.params64(sl, requires_grad=True)
        ld, q, _, _ = fwd_ops.suffstats_reference(case.kernel, case.tab64, pr,
                                                  case.y64)
        dld = torch.autograd.grad(ld.sum(), (phi, alpha), retain_graph=True)
        dq = torch.autograd.grad(q.sum(), (phi, alpha))
        refs.append(torch.stack([ld.detach(), q.detach(), dld[0], dq[0],
                                 dld[1], dq[1]]))
    ref = torch.cat(refs, dim=1)
    got = sums.double()
    res = {
        "value_rel": _rel(got[:2], ref[:2]),
        "dphi_rel": _rel(got[2:4], ref[2:4]),
        "dalpha_rel": _rel(got[4:6], ref[4:6]),
        "max_abs_err": float((got - ref).abs().max()),
    }
    print(f"grad parity [{label}]: " + json.dumps(res), flush=True)
    _require(res["value_rel"] <= 5e-4, f"kernel 2 values disagree [{label}]")
    _require(res["dphi_rel"] <= grad_rtol and res["dalpha_rel"] <= grad_rtol,
             f"kernel 2 gradients disagree [{label}]")
    return res


def _time_ms(fn, warm: int, reps: int) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_kernels(case: Case) -> dict:
    """Per-call times of both kernels and of their float32 plain versions."""
    k, t, y = case.kernel, case.tab32, case.y32
    params = fwd_ops.params_array(case.phi, case.alpha, case.jitter, case.n,
                                  torch.float32, case.phi.device)
    times = {
        "vecchia_suffstats": _time_ms(
            lambda: fwd_ops.suffstats(k, t, case.phi, case.alpha, y, case.jitter),
            20, 200),
        "vecchia_grad": _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, case.phi, case.alpha, y,
                                                 case.jitter), 20, 200),
        "vecchia_suffstats_plain": _time_ms(
            lambda: fwd_ops.suffstats_reference(k, t, params, y), 2, 5),
        "vecchia_grad_plain": _time_ms(
            lambda: diff_ops.grad_reference(k, t, params, y), 2, 5),
    }
    chains = case.phi.shape[0]
    tag = f"n{case.n}_m{case.m}"
    print("kernel times: " + json.dumps({
        **{f"{name}_ms": ms for name, ms in times.items()},
        f"vecchia_loglik_evals_per_sec_{tag}": chains * 1e3 / times["vecchia_suffstats"],
        "grad_evals_per_sec": chains * 1e3 / times["vecchia_grad"],
        "chains": chains,
    }), flush=True)
    return times


def _chain_stats(draws):
    """(min-ESS, max split-R-hat) over the (sigma2, phi, tau2) marginals."""
    min_ess, max_rhat = np.inf, 0.0
    for key in ("phi", "sigma2", "tau2"):
        min_ess = min(min_ess, diagnostics.ess(draws[key]))
        max_rhat = max(max_rhat, diagnostics.split_rhat(draws[key]))
    return float(min_ess), float(max_rhat)


def main_path(dev) -> dict:
    """bench.py's bench_ess MWG branch on the port: the same generator and
    seed, fit_map(250), a 16 x 1200 correlated-RW pilot with 800 burn-in,
    then 16 x 6000 independence-mixture draws with 500 burn-in."""
    coords, y = bench_field(N_MAIN, seed=0)
    for count in (fwd_ops.COUNT, diff_ops.COUNT):
        count.reset()
    t0 = time.perf_counter()
    model = ResponseNNGP(coords, y, kernel="sqexp", m=M_MAIN, device=dev)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mp = model.fit_map(n_steps=250)
    u0 = mp.u.cpu().numpy()
    map_s = time.perf_counter() - t0
    sig0, tau0 = float(np.exp(u0[0])), float(np.exp(u0[2]))
    init = {
        "sigma2": sig0,
        "phi": float(model._t_phi.forward(torch.as_tensor(u0[1]))),
        "alpha": tau0 / sig0,
    }

    t0 = time.perf_counter()
    pilot = model.sample(1200, n_burn=800, n_chains=CHAINS, init=init, seed=101,
                         proposal_cov=model.theta_proposal_cov(mp.laplace_cov))
    u_pilot = np.stack([
        model._t_phi.inverse(torch.as_tensor(pilot["phi"])).numpy().ravel(),
        np.log(pilot["tau2"] / pilot["sigma2"]).ravel(),
    ], axis=1)
    emp_cov = np.cov(u_pilot.T) * 1.2  # slight inflation: tail safety
    emp_mean = u_pilot.mean(axis=0)
    pilot_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    draws = model.sample(6000, n_burn=500, n_chains=CHAINS, init=init, seed=0,
                         proposal_cov=emp_cov, proposal_center=emp_mean)
    run_s = time.perf_counter() - t0
    min_ess, max_rhat = _chain_stats(draws)
    launches = {name: row[2].launches for name, row in KERNEL_ROWS.items()}
    plain = {name: row[2].plain for name, row in KERNEL_ROWS.items()}
    means = {k: float(np.mean(draws[k])) for k in ("sigma2", "phi", "tau2")}
    res = {
        "setup_s": setup_s, "map_s": map_s, "pilot_s": pilot_s, "run_s": run_s,
        f"min_ess_per_sec_n{N_MAIN}_m{M_MAIN}": min_ess / (run_s + pilot_s + map_s),
        "min_ess": min_ess, "rhat_max": max_rhat, "map_value": float(mp.value),
        "posterior_mean": means, "launches": launches, "plain_calls": plain,
        "draws_shape": list(draws["phi"].shape),
    }
    print("main path: " + json.dumps(res), flush=True)
    _require(all(v > 0 for v in launches.values()),
             f"a kernel was not launched on the main path: {launches}")
    _require(all(v == 0 for v in plain.values()),
             f"the main path reached a plain version: {plain}")
    _require(all(np.isfinite(v).all() for v in draws.values()),
             "non-finite draws")
    _require(draws["phi"].shape == (CHAINS, 6000), "draws have the wrong shape")
    _require(TAU2_TRUE / 2 <= means["tau2"] <= TAU2_TRUE * 2,
             f"posterior mean tau2 {means['tau2']} is not within 2x of 0.09")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # full float32 in any matrix product of the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    info = _build.build_info()
    print(f"build: {info['seconds']:.1f} s (cached={info['cached']}), "
          f"{info['nvcc']}, torch {torch.__version__} cuda {torch.version.cuda}, "
          f"ptxas m={M_MAIN}: {ptxas_summary(info['ptxas'], M_MAIN)}", flush=True)

    main_case = Case(N_MAIN, M_MAIN, SqExp(), CHAINS, seed=0, dev=dev)
    small_case = Case(1500, 7, Exponential(), CHAINS, seed=3, dev=dev)
    fwd = check_forward(main_case, "n100000 m15 sqexp")
    check_forward(small_case, "n1500 m7 exponential")
    grad = check_grad(main_case, "n100000 m15 sqexp", grad_rtol=2e-3)
    check_grad(small_case, "n1500 m7 exponential", grad_rtol=2e-4)
    times = time_kernels(main_case)
    main_path(dev)

    errs = {"vecchia_suffstats": fwd["f_max_abs_err"],
            "vecchia_grad": grad["max_abs_err"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": count.launches, "max_abs_err": errs[name],
         "ms": times[name], "plain_ms": times[name + "_plain"]}
        for name, (src, tpu, count) in KERNEL_ROWS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
