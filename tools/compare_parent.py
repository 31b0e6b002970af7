"""Registers and kernel times of two trees of pynngp_tpu_torch on one card,
in turns (parent, change, change, parent), so that a change can be held to
its parent within one machine's noise.

    rm -rf parent_check && mkdir parent_check \
        && git archive <parent commit> | tar -x -C parent_check
    python3 tools/compare_parent.py          # from the root of the change

``parent_check/`` is git-ignored.  Each round runs in a process of its own
from the tree's root, so that it imports and builds that tree's package
(``build/pynngp_tpu_torch/`` under each root), and prints the tree's
``ptxas -v`` summary by m, the closed-form kernel times of
``chip_smoke.time_kernels`` (dist) and ``chip_smoke.time_layout_kernels``
(coords) at n=100,000, m=15 and n=500,000, m=20 (config 5), and the
general-nu ones of ``chip_smoke.time_kernels_nu`` at n=25,000, m=10 on either
layout, 16 chains each; kernel 2 also at 4 chains (the NUTS recipe's launch)
and 2 (config 3's), and kernel 1 at 1 chain (config 5's probe).  Kernel 3
also with noise weights (n=100,000, m=15 on both layouts, the general-nu
instances at n=25,000, m=10), at config 2's launch (n=10,000, m=15,
exponential, 8 chains, alpha = 0) and at config 5's latent run's (n=500,000,
m=20, exponential, 8 chains, alpha = 0; both layouts).  Both trees
are timed by the same function (this script's, put in place of each tree's
``chip_smoke._time_ms``): card time, a sleep kernel ahead of the timed calls
covering the host's enqueueing.  The last line, ``PARENT_CHECK [...]``, holds the four rounds as JSON.

    python3 tools/compare_parent.py --large

times the large-m rows alone, in the same four rounds: kernels 1, 2,
2-EMIT_Y (one y row a chain, as ``chip_smoke.time_instances`` times it) and 3
at n=10,000, m=64, 16 chains, sqexp, on both layouts with and without noise
weights, and their general-nu instances (sampled nu) at m=40
on 4 of the 16 chains, the rows of PERF.md's table.

    python3 tools/compare_parent.py --m20

times the M = 20 rows alone (config 5's n=500,000, m=20, sqexp), in the
same four rounds: kernels 1, 2, 2-EMIT_Y (one y row a chain) and 3 on both
layouts, with and without noise weights, at 16 and 4 chains, kernel 1 at 1
chain (config 5's probe) and kernel 3 at path 14's launch (exponential, 8
chains, alpha = 0); chain 0's logdet, dlogdet/dphi and the sums of kernel
2-EMIT_Y's and kernel 3's B as checks that both trees compute the same
function; and each tree's ptxas summary of its M = 20 kernels.

    python3 tools/compare_parent.py --cluster

times kernels 1 and 3 above geometry.M_SMEM, in the same four rounds: at
m = 237, 300, 400 and 600, n=2,000 (n_pad 2,048), 4 chains, sqexp, on both
layouts (the parent's scratch body against the change's cluster body).  A
launch whose first call takes more than half a second is timed by that one
call (the scratch body: seconds to a minute a launch); the others after a
warm call, over five.  A tree whose chip_smoke.py has ``factor_only`` also
times the float32 plain versions (one call), the factor-only yardstick
(``torch.linalg.cholesky_ex`` on the same float64 batch) and prints the
bounds (``kernel_bounds``) and each kernel's registers; chain 0's logdet
and the sum of kernel 3's B check that both trees compute the same
function.

    python3 tools/compare_parent.py --cluster grad

times kernel 2 and its EMIT_Y instance (one y row a chain) the same way
at the same shapes (the parent's scratch body against the change's cluster
body, above geometry.M_SMEM_GRAD), with chain 0's logdet, dlogdet/dphi and
the sum of B as checks, and in a tree whose chip_smoke.py has
``cluster_map_run`` the float32 plain versions (one call), the bounds and
the factor-only yardstick.
"""
import json
import os
import subprocess
import sys

ROUND = r'''
import json, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import bf as bf_ops
from pynngp_tpu_torch.ops import diff_suffstats as diff_ops
from pynngp_tpu_torch.ops import suffstats as fwd_ops
dev = torch.device("cuda", 0)


def _time_ms(fn, warm, reps):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


cs._time_ms = _time_ms
info = _build.build_info()
out = {"build_s": info["seconds"],
       "ptxas": {m: cs.ptxas_summary(info["ptxas"], m) for m in (7, 10, 15, 20)}}
case = cs.Case(100000, 15, cs.SqExp(), 16, seed=0, dev=dev)
out["closed"] = {k: v for k, v in cs.time_kernels(case).items()
                 if not k.endswith("_plain")}
k, t, y = case.kernel, case.tab32, case.y32
out["closed"]["vecchia_grad_4_chains"] = cs._time_ms(lambda: diff_ops.value_and_grad_sums(
    k, t, case.phi[:4], case.alpha[:4], y, case.jitter), 20, 200)
out["closed"]["vecchia_suffstats_1_chain"] = cs._time_ms(lambda: fwd_ops.suffstats(
    k, t, case.phi[:1], case.alpha[:1], y, case.jitter), 20, 200)


def bf_ms(case, kernel, chains, hetero=False, zero_alpha=False, warm=20, reps=200, nu=None):
    # kernel 3 on the case's tables under `kernel`, its first `chains`
    # chains, with its noise weights or alpha = 0 if asked
    phi, alpha = case.phi[:chains], case.alpha[:chains]
    alpha = torch.zeros_like(alpha) if zero_alpha else alpha
    v = case.with_noise(cs.noise_weights(case.n)).v32 if hetero else None
    return cs._time_ms(lambda: bf_ops.bf_planes(kernel, case.tab32, phi, alpha, case.jitter,
                                                nu=nu, noise_v=v), warm, reps)


out["bf"] = {"vecchia_bf_hetero": bf_ms(case, case.kernel, 16, hetero=True)}
del case
case = cs.Case(100000, 15, cs.SqExp(), 16, seed=0, dev=dev, layout="coords")
out["closed"].update(cs.time_layout_kernels(case, 20, 200))
out["bf"]["vecchia_bf_coords_hetero"] = bf_ms(case, case.kernel, 16, hetero=True)
del case
c2 = cs.Case(10000, 15, cs.Exponential(), 8, seed=0, dev=dev)
out["bf"]["vecchia_bf_config2_8_chains_alpha0"] = bf_ms(c2, c2.kernel, 8, zero_alpha=True)
del c2
for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    nu = cs.Case(25000, 10, cs.Matern(), 16, seed=5, dev=dev, nu=cs.nu_spread(16),
                 layout=layout)
    out["nu"] = {**out.get("nu", {}), **cs.time_kernels_nu(nu, plain=False)}
    out["bf"][f"vecchia_bf_nu{sfx}_hetero"] = bf_ms(nu, nu.kernel, 16, hetero=True, warm=5,
                                                    reps=50, nu=nu.nu)
    del nu
    big = cs.Case(500000, 20, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
    out["m20"] = {**out.get("m20", {}), **cs.time_layout_kernels(big, 3, 10)}
    out["m20"]["vecchia_suffstats_1_chain" + sfx] = (
        cs._time_ms(lambda: fwd_ops.suffstats(big.kernel, big.tab32, big.phi[:1],
                                              big.alpha[:1], big.y32, big.jitter), 5, 50))
    out["bf"][f"vecchia_bf{sfx}_path14_8_chains_alpha0"] = bf_ms(
        big, cs.Exponential(), 8, zero_alpha=True, warm=3, reps=20)
    del big
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''

ROUND_LARGE = ROUND[:ROUND.index("cs._time_ms = _time_ms")] + r'''
cs._time_ms = _time_ms
out = {"build_s": _build.build_info()["seconds"]}
for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    case = cs.Case(10000, 64, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
    for c in (case, case.with_noise(cs.noise_weights(10000))):
        h = "_hetero" if c.v32 is not None else ""
        k, t, v = c.kernel, c.tab32, c.v32
        out[f"vecchia_suffstats{sfx}_large{h}"] = _time_ms(lambda: fwd_ops.suffstats(
            k, t, c.phi, c.alpha, c.y32, c.jitter, noise_v=v), 2, 10)
        out[f"vecchia_bf{sfx}_large{h}"] = _time_ms(lambda: bf_ops.bf_planes(
            k, t, c.phi, c.alpha, c.jitter, noise_v=v), 2, 10)
        out[f"vecchia_grad{sfx}_large{h}"] = _time_ms(lambda: diff_ops.value_and_grad_sums(
            k, t, c.phi, c.alpha, c.y32, c.jitter, noise_v=v), 2, 10)
        out[f"vecchia_grad_y{sfx}_large{h}"] = _time_ms(lambda: diff_ops.value_and_grad_sums(
            k, t, c.phi, c.alpha, c.y32_chains, c.jitter, emit_y=True, noise_v=v), 2, 10)
    nu = cs.Case(10000, 40, cs.Matern(), 16, seed=0, dev=dev, nu=cs.nu_spread(16),
                 layout=layout).subset(slice(0, 4))
    for c in (nu, nu.with_noise(cs.noise_weights(10000))):
        h = "_hetero" if c.v32 is not None else ""
        k, t, v = c.kernel, c.tab32, c.v32
        out[f"vecchia_suffstats_nu{sfx}_large{h}"] = _time_ms(lambda: fwd_ops.suffstats(
            k, t, c.phi, c.alpha, c.y32, c.jitter, nu=c.nu, noise_v=v), 2, 10)
        out[f"vecchia_bf_nu{sfx}_large{h}"] = _time_ms(lambda: bf_ops.bf_planes(
            k, t, c.phi, c.alpha, c.jitter, nu=c.nu, noise_v=v), 2, 10)
        out[f"vecchia_grad_nu{sfx}_large{h}"] = _time_ms(lambda: diff_ops.value_and_grad_sums(
            k, t, c.phi, c.alpha, c.y32, c.jitter, nu=c.nu, noise_v=v), 2, 10)
        out[f"vecchia_grad_y_nu{sfx}_large{h}"] = _time_ms(
            lambda: diff_ops.value_and_grad_sums(k, t, c.phi, c.alpha, c.y32_chains, c.jitter,
                                                 emit_y=True, nu=c.nu, noise_v=v), 2, 10)
    del case, nu
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


ROUND_M20 = ROUND[:ROUND.index("cs._time_ms = _time_ms")] + r'''
cs._time_ms = _time_ms
info = _build.build_info()
out = {"build_s": info["seconds"], "ptxas": cs.ptxas_summary(info["ptxas"], 20)}
for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    case = cs.Case(500000, 20, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
    for c in (case, case.with_noise(cs.noise_weights(500000))):
        h = "_hetero" if c.v32 is not None else ""
        k, t, v = c.kernel, c.tab32, c.v32
        for chains in (16, 4):
            ch = "" if chains == 16 else "_4_chains"
            phi, alpha, ys = c.phi[:chains], c.alpha[:chains], c.y32_chains[:chains]
            out[f"vecchia_suffstats{sfx}{h}{ch}"] = _time_ms(lambda: fwd_ops.suffstats(
                k, t, phi, alpha, c.y32, c.jitter, noise_v=v), 3, 10)
            out[f"vecchia_grad{sfx}{h}{ch}"] = _time_ms(lambda: diff_ops.value_and_grad_sums(
                k, t, phi, alpha, c.y32, c.jitter, noise_v=v), 3, 10)
            out[f"vecchia_grad_y{sfx}{h}{ch}"] = _time_ms(
                lambda: diff_ops.value_and_grad_sums(k, t, phi, alpha, ys, c.jitter,
                                                     emit_y=True, noise_v=v), 3, 10)
            out[f"vecchia_bf{sfx}{h}{ch}"] = _time_ms(lambda: bf_ops.bf_planes(
                k, t, phi, alpha, c.jitter, noise_v=v), 3, 10)
    k, t = case.kernel, case.tab32
    out[f"vecchia_suffstats{sfx}_1_chain"] = _time_ms(lambda: fwd_ops.suffstats(
        k, t, case.phi[:1], case.alpha[:1], case.y32, case.jitter), 5, 50)
    zero = torch.zeros_like(case.alpha[:8])
    out[f"vecchia_bf{sfx}_path14_8_chains_alpha0"] = _time_ms(lambda: bf_ops.bf_planes(
        cs.Exponential(), t, case.phi[:8], zero, case.jitter), 3, 10)
    out[f"check_sum_b3{sfx}"] = float(bf_ops.bf_planes(
        k, t, case.phi, case.alpha, case.jitter)[0].double().sum())
    sums = diff_ops.value_and_grad_sums(k, t, case.phi, case.alpha, case.y32, case.jitter)
    out[f"check_logdet_chain0{sfx}"] = float(fwd_ops.suffstats(
        k, t, case.phi, case.alpha, case.y32, case.jitter)[0][0])
    out[f"check_dlogdet_dphi_chain0{sfx}"] = float(sums[2][0])
    out[f"check_sum_b{sfx}"] = float(diff_ops.value_and_grad_sums(
        k, t, case.phi, case.alpha, case.y32_chains, case.jitter, emit_y=True)[1].double().sum())
    del case, c, t, sums
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


ROUND_CLUSTER = ROUND[:ROUND.index("cs._time_ms = _time_ms")] + r'''
import time
cs._time_ms = _time_ms
info = _build.build_info()
out = {"build_s": info["seconds"]}
lines = info["ptxas"].splitlines()
out["ptxas"] = [l.strip()[-60:] + " " + " ".join(x.split("info    :")[-1].strip()
                                                for x in lines[i + 2:i + 4])
                for i, l in enumerate(lines)
                if "Compiling entry function" in l and ("cluster_kernel" in l or "large_kernel" in l)
                and ("suffstats" in l or "_bf_" in l) and "ILb0ELb0E" in l]
change = hasattr(cs, "factor_only")


def timed(fn):
    # one call between events; if it took more than 0.5 s, that is the time
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(stop)
    return first if first > 500.0 else _time_ms(fn, 1, 5)


for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    for m in (237, 300, 400, 600):
        c = cs.Case(2000, m, cs.SqExp(), 4, seed=0, dev=dev, layout=layout)
        k, t = c.kernel, c.tab32
        row = f"m{m}{sfx}"
        out[f"vecchia_suffstats_{row}"] = timed(lambda: fwd_ops.suffstats(
            k, t, c.phi, c.alpha, c.y32, c.jitter))
        out[f"vecchia_bf_{row}"] = timed(lambda: bf_ops.bf_planes(
            k, t, c.phi, c.alpha, c.jitter))
        out[f"check_logdet_chain0_{row}"] = float(fwd_ops.suffstats(
            k, t, c.phi, c.alpha, c.y32, c.jitter)[0][0])
        out[f"check_sum_b3_{row}"] = float(bf_ops.bf_planes(
            k, t, c.phi, c.alpha, c.jitter)[0].double().sum())
        if change:
            params = fwd_ops.params_array(c.phi, c.alpha, c.jitter, c.n, torch.float32, dev)
            out[f"vecchia_suffstats_{row}_plain"] = _time_ms(
                lambda: fwd_ops.suffstats_reference(k, t, params, c.y32), 0, 1)
            out[f"vecchia_bf_{row}_plain"] = _time_ms(
                lambda: bf_ops.bf_reference(k, t, params), 0, 1)
            out[f"bounds_{row}"] = {name: b for name, b in cs.kernel_bounds(c).items()
                                    if not name.startswith("vecchia_grad")}
            if layout == "dist":
                out[f"factor_only_{row}"] = cs.factor_only(c, 1, 3)
        del c, t
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


ROUND_CLUSTER_GRAD = ROUND_CLUSTER[:ROUND_CLUSTER.index("for layout in")].replace(
    '("suffstats" in l or "_bf_" in l) and "ILb0ELb0E" in l',
    '"grad" in l and ("ILb0ELb0ELb0E" in l or "ILb1ELb0ELb0E" in l)').replace(
    'hasattr(cs, "factor_only")', 'hasattr(cs, "cluster_map_run")') + r'''
for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    for m in (237, 300, 400, 600):
        c = cs.Case(2000, m, cs.SqExp(), 4, seed=0, dev=dev, layout=layout)
        k, t = c.kernel, c.tab32
        row = f"m{m}{sfx}"
        # each launch's first call gives its checks (a scratch-body launch
        # takes up to a minute)
        sums = []
        out[f"vecchia_grad_{row}"] = timed(lambda: sums.append(diff_ops.value_and_grad_sums(
            k, t, c.phi, c.alpha, c.y32, c.jitter)))
        out[f"vecchia_grad_y_{row}"] = timed(lambda: sums.append(diff_ops.value_and_grad_sums(
            k, t, c.phi, c.alpha, c.y32_chains, c.jitter, emit_y=True)[:2]))
        y_first = next(i for i, x in enumerate(sums) if isinstance(x, tuple))
        out[f"check_logdet_chain0_{row}"] = float(sums[0][0][0])
        out[f"check_dlogdet_dphi_chain0_{row}"] = float(sums[0][2][0])
        out[f"check_sum_b_{row}"] = float(sums[y_first][1].double().sum())
        if change:
            params = fwd_ops.params_array(c.phi, c.alpha, c.jitter, c.n, torch.float32, dev)
            out[f"vecchia_grad_{row}_plain"] = _time_ms(
                lambda: diff_ops.grad_reference(k, t, params, c.y32), 0, 1)
            out[f"vecchia_grad_y_{row}_plain"] = _time_ms(
                lambda: diff_ops.grad_reference(k, t, params, c.y32_chains, emit_y=True), 0, 1)
            out[f"bounds_{row}"] = {name: b for name, b in cs.kernel_bounds(c).items()
                                    if name.startswith("vecchia_grad")}
            if layout == "dist":
                out[f"factor_only_{row}"] = cs.factor_only(c, 1, 3)
        del c, t, sums
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


def main(args) -> int:
    root = os.getcwd()
    code = {"--large": ROUND_LARGE, "--m20": ROUND_M20,
            "--cluster": ROUND_CLUSTER}.get(args[0] if args else "", ROUND)
    if args[:2] == ["--cluster", "grad"]:
        code = ROUND_CLUSTER_GRAD
    results = []
    for tree in ("parent_check", ".", ".", "parent_check"):
        run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, cwd=os.path.join(root, tree))
        print(tree, run.returncode, run.stderr[-2000:] if run.returncode else "",
              flush=True)
        found = [line for line in run.stdout.splitlines() if line.startswith("RESULT ")]
        if not found:
            return 1
        results.append((tree, json.loads(found[0][len("RESULT "):])))
        print(tree, json.dumps(results[-1][1]), flush=True)
    print("PARENT_CHECK " + json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
