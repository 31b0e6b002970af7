"""Kernel times and resource use of several trees of pynngp_tpu_torch on one
card, in turns, so that variants of the kernels can be held to each other
within one machine's noise.

    mkdir -p archive_check/A && git archive HEAD | tar -x -C archive_check/A
    # ... edit archive_check/A/pynngp_tpu_torch/csrc, make B, C likewise ...
    python3 tools/time_trees.py A B C        # from the root of the checkout

``archive_check/`` is git-ignored and copied to the card's machine.  Each tree
runs in a process of its own from its root (so that it builds and imports its
own package), in the order given and then reversed.  A round prints the
tree's ``ptxas -v`` summary by m and the times of ``chip_smoke``'s
``time_layout_kernels`` (kernels 1, 2, 2-EMIT_Y, 3 and kernel 2 at 4 chains)
at n=100,000, m=15 on both layouts, of ``time_kernels_nu`` at n=25,000, m=10,
and, where the tree takes it, of m=12 on the M=15 instances.  At the end the
mean of each time by tree, and ``cuobjdump -res-usage`` (registers and stack)
of each tree's m=15 and m=20 kernels.  Dropping the M = 7 and 20 launch cases
from a variant's bodies builds it in under a minute.

    python3 tools/time_trees.py --m15 A B C

times only what trees built for M = 15 alone can run: kernels 1, 2,
2-EMIT_Y and 3 at n=100,000, m=15 on both layouts at 16 chains, and kernels
1 and 2 at 4 chains, with chain 0's logdet as a check that a variant still
computes the same function.

    python3 tools/time_trees.py --bf A B C

times kernel 3 alone: both layouts at n=100,000, m=15 and 20, 16 and 8
chains (16 also with noise weights), its general-nu instances at n=25,000,
m=10, and the launches of config 2 (n=10,000, 8 chains) and of config 5's
latent run (n=500,000, m=20, coords, 8 chains), both at alpha = 0.

    python3 tools/time_trees.py --large A B C

times the three kernels on their large-m shared-memory bodies (kernel 2 with
and without EMIT_Y): both layouts at n=10,000, m=64 and 128, 16 chains (m=64
also with noise weights), the general-nu instances (sampled nu) at m=40 on 4
chains, with chain 0's logdet, its dlogdet/dphi and the sum of B as checks
that a variant computes the same function.

    python3 tools/time_trees.py --m20 A B C

times the M = 20 rows (n=500,000, m=20, sqexp, config 5's shape) on both
layouts: kernels 2 and 2-EMIT_Y (one y row a chain) at 16 and 4 chains,
kernel 1 at 16 chains and 1 (config 5's probe), kernel 3 at 16 (also with
noise weights) and at path 14's launch (exponential, 8 chains, alpha = 0),
with chain 0's logdet, dlogdet/dphi, dquad/dphi and the sums of kernel
2-EMIT_Y's and kernel 3's B as checks that a variant computes the same
function, and each tree's registers, stack and spills of its M = 20 kernels
(``ptxas -v``, the team kernels by name); it chose the team sizes of
csrc/vecchia_team.cuh.

    python3 tools/time_trees.py --cluster A B C

times kernels 1 and 3 on their cluster body (geometry.M_SMEM < m <=
geometry.M_CLUSTER) at m = 237, 300, 400 and 600, n=2,000, 4 chains, sqexp,
on the coords layout (whose tables build in a second at these m), with chain
0's logdet and the sum of kernel 3's B as checks, and each tree's
registers, stack and spills of its cluster kernels; it split the cluster
body's time into its phases (variants with a phase deleted) and chose its
update's arithmetic (PERF.md).
"""
import json
import os
import subprocess
import sys

ROUND = r'''
import json, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
dev = torch.device("cuda", 0)
info = _build.build_info()
out = {"build_s": info["seconds"], "lib": info["lib"],
       "ptxas": {m: cs.ptxas_summary(info["ptxas"], m) for m in (7, 10, 15, 20)}}
for layout in ("dist", "coords"):
    case = cs.Case(100000, 15, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
    out.update(cs.time_layout_kernels(case, 20, 200))
    del case
    nu = cs.Case(25000, 10, cs.Matern(), 16, seed=5, dev=dev, nu=cs.nu_spread(16),
                 layout=layout)
    out.update(cs.time_kernels_nu(nu, plain=False))
    del nu
    try:  # m = 12 on the M = 15 instances, in trees that take it
        case = cs.Case(100000, 12, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
        out.update({k + "_m12": ms for k, ms in cs.time_layout_kernels(case, 20, 200).items()})
        del case
    except (ValueError, RuntimeError) as err:
        out["m12_error"] = str(err)[:200]
print("RESULT " + json.dumps(out), flush=True)
'''

# trees built for M = 15 only
ROUND_M15 = r'''
import json, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import suffstats as fwd_ops
dev = torch.device("cuda", 0)
info = _build.build_info()
out = {"build_s": info["seconds"], "lib": info["lib"],
       "ptxas": {15: cs.ptxas_summary(info["ptxas"], 15)}}
for layout in ("dist", "coords"):
    case = cs.Case(100000, 15, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
    sfx = "_coords" if layout == "coords" else ""
    out.update(cs.time_layout_kernels(case, 20, 200))
    k, t, y = case.kernel, case.tab32, case.y32
    out["vecchia_suffstats_4_chains" + sfx] = cs._time_ms(
        lambda: fwd_ops.suffstats(k, t, case.phi[:4], case.alpha[:4], y, case.jitter), 20, 200)
    out["logdet_chain0" + sfx] = float(
        fwd_ops.suffstats(k, t, case.phi, case.alpha, y, case.jitter)[0][0])
    del case
print("RESULT " + json.dumps(out), flush=True)
'''

# kernel 3 alone: both layouts at n=100,000, m=15 and 20, 16 and 8 chains,
# with noise weights at 16; the general-nu instances at config 3's shape;
# config 2's launch (n=10,000, m=15, exponential, 8 chains, alpha = 0) and
# path 14's (n=500,000, m=20, exponential, 8 chains, coords, alpha = 0);
# the sum of B as a check that a variant computes the same function
ROUND_BF = r'''
import json, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import bf as bf_ops
dev = torch.device("cuda", 0)
info = _build.build_info()
out = {"build_s": info["seconds"], "lib": info["lib"],
       "ptxas": {m: cs.ptxas_summary(info["ptxas"], m) for m in (10, 15, 20)}}


def bf_ms(case, chains, hetero=False, zero_alpha=False, warm=10, reps=100):
    k, t = case.kernel, case.tab32
    phi, alpha = case.phi[:chains], case.alpha[:chains]
    alpha = torch.zeros_like(alpha) if zero_alpha else alpha
    v = case.with_noise(cs.noise_weights(case.n)).v32 if hetero else None
    return cs._time_ms(lambda: bf_ops.bf_planes(k, t, phi, alpha, case.jitter, noise_v=v),
                       warm, reps)


for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    for m in (15, 20):
        case = cs.Case(100000, m, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
        for chains in (16, 8):
            out[f"bf{sfx}_m{m}_{chains}_chains"] = bf_ms(case, chains)
        out[f"bf{sfx}_m{m}_16_chains_hetero"] = bf_ms(case, 16, hetero=True)
        out[f"sum_b{sfx}_m{m}"] = float(bf_ops.bf_planes(
            case.kernel, case.tab32, case.phi, case.alpha, case.jitter)[0].double().sum())
        del case
    nu = cs.Case(25000, 10, cs.Matern(), 16, seed=5, dev=dev, nu=cs.nu_spread(16),
                 layout=layout)
    out[f"bf_nu{sfx}_m10_16_chains"] = cs._time_ms(lambda: bf_ops.bf_planes(
        nu.kernel, nu.tab32, nu.phi, nu.alpha, nu.jitter, nu=nu.nu), 5, 50)
    del nu
c2 = cs.Case(10000, 15, cs.Exponential(), 8, seed=0, dev=dev)
out["bf_config2_8_chains_alpha0"] = bf_ms(c2, 8, zero_alpha=True)
del c2
p14 = cs.Case(500000, 20, cs.Exponential(), 8, seed=0, dev=dev, layout="coords")
out["bf_coords_path14_8_chains_alpha0"] = bf_ms(p14, 8, zero_alpha=True, warm=3, reps=20)
print("RESULT " + json.dumps(out), flush=True)
'''


# the three kernels on the large-m shared-memory bodies
ROUND_LARGE = r'''
import json, re, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import bf as bf_ops
from pynngp_tpu_torch.ops import diff_suffstats as diff_ops
from pynngp_tpu_torch.ops import suffstats as fwd_ops
dev = torch.device("cuda", 0)
info = _build.build_info()
lines = info["ptxas"].splitlines()
# each shared-memory kernel's registers, stack and spills, by name and flags
out = {"build_s": info["seconds"], "lib": info["lib"], "ptxas": {
    "".join(re.search(r"(suffstats|bf|grad)_smem_kernelI((?:Lb[01]E)+)", line).groups()):
        " ".join(nxt.strip() for nxt in lines[i + 1:i + 3])
    for i, line in enumerate(lines)
    if "Compiling entry function" in line and "_smem_kernel" in line}}
for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    for m in (64, 128):
        case = cs.Case(10000, m, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
        cases = (case, case.with_noise(cs.noise_weights(10000))) if m == 64 else (case,)
        for c in cases:
            h = "_hetero" if c.v32 is not None else ""
            k, t, v = c.kernel, c.tab32, c.v32
            out[f"suffstats{sfx}_m{m}{h}"] = cs._time_ms(lambda: fwd_ops.suffstats(
                k, t, c.phi, c.alpha, c.y32, c.jitter, noise_v=v), 2, 10)
            out[f"bf{sfx}_m{m}{h}"] = cs._time_ms(lambda: bf_ops.bf_planes(
                k, t, c.phi, c.alpha, c.jitter, noise_v=v), 2, 10)
            out[f"grad{sfx}_m{m}{h}"] = cs._time_ms(lambda: diff_ops.value_and_grad_sums(
                k, t, c.phi, c.alpha, c.y32, c.jitter, noise_v=v), 2, 10)
            out[f"grad_y{sfx}_m{m}{h}"] = cs._time_ms(lambda: diff_ops.value_and_grad_sums(
                k, t, c.phi, c.alpha, c.y32_chains, c.jitter, emit_y=True, noise_v=v), 2, 10)
        out[f"logdet_chain0{sfx}_m{m}"] = float(fwd_ops.suffstats(
            case.kernel, case.tab32, case.phi, case.alpha, case.y32, case.jitter)[0][0])
        out[f"dlogdet_dphi_chain0{sfx}_m{m}"] = float(diff_ops.value_and_grad_sums(
            case.kernel, case.tab32, case.phi, case.alpha, case.y32, case.jitter)[2][0])
        out[f"sum_b{sfx}_m{m}"] = float(bf_ops.bf_planes(
            case.kernel, case.tab32, case.phi, case.alpha, case.jitter)[0].double().sum())
        del case, cases
    nu = cs.Case(10000, 40, cs.Matern(), 16, seed=0, dev=dev, nu=cs.nu_spread(16),
                 layout=layout).subset(slice(0, 4))
    out[f"suffstats_nu{sfx}_m40_4_chains"] = cs._time_ms(lambda: fwd_ops.suffstats(
        nu.kernel, nu.tab32, nu.phi, nu.alpha, nu.y32, nu.jitter, nu=nu.nu), 2, 10)
    out[f"bf_nu{sfx}_m40_4_chains"] = cs._time_ms(lambda: bf_ops.bf_planes(
        nu.kernel, nu.tab32, nu.phi, nu.alpha, nu.jitter, nu=nu.nu), 2, 10)
    out[f"grad_nu{sfx}_m40_4_chains"] = cs._time_ms(lambda: diff_ops.value_and_grad_sums(
        nu.kernel, nu.tab32, nu.phi, nu.alpha, nu.y32, nu.jitter, nu=nu.nu), 2, 10)
    out[f"grad_y_nu{sfx}_m40_4_chains"] = cs._time_ms(lambda: diff_ops.value_and_grad_sums(
        nu.kernel, nu.tab32, nu.phi, nu.alpha, nu.y32_chains, nu.jitter, emit_y=True,
        nu=nu.nu), 2, 10)
    out[f"dlogdet_dnu_chain0_nu{sfx}_m40"] = float(diff_ops.value_and_grad_sums(
        nu.kernel, nu.tab32, nu.phi, nu.alpha, nu.y32, nu.jitter, nu=nu.nu)[6][0])
    del nu
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


# the M = 20 rows at config 5's shape
ROUND_M20 = r'''
import json, re, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import bf as bf_ops
from pynngp_tpu_torch.ops import diff_suffstats as diff_ops
from pynngp_tpu_torch.ops import suffstats as fwd_ops
dev = torch.device("cuda", 0)
info = _build.build_info()
lines = info["ptxas"].splitlines()
out = {"build_s": info["seconds"], "lib": info["lib"], "ptxas": {
    "".join(re.search(r"\d+([a-z_]+_kernel)(I(?:Li\d+E|Lb[01]E)+E)", line).groups()):
        " ".join(nxt.strip() for nxt in lines[i + 2:i + 4])
    for i, line in enumerate(lines)
    if "Compiling entry function" in line and ("ILi20E" in line or "team" in line)}}
for layout in ("dist", "coords"):
    sfx = "_coords" if layout == "coords" else ""
    c = cs.Case(500000, 20, cs.SqExp(), 16, seed=0, dev=dev, layout=layout)
    k, t, y, ys = c.kernel, c.tab32, c.y32, c.y32_chains
    for chains in (16, 4):
        phi, alpha = c.phi[:chains], c.alpha[:chains]
        out[f"grad{sfx}_{chains}_chains"] = cs._time_ms(lambda: diff_ops.value_and_grad_sums(
            k, t, phi, alpha, y, c.jitter), 3, 10)
        out[f"grad_y{sfx}_{chains}_chains"] = cs._time_ms(lambda: diff_ops.value_and_grad_sums(
            k, t, phi, alpha, ys[:chains], c.jitter, emit_y=True), 3, 10)
    for chains in (16, 1):
        phi, alpha = c.phi[:chains], c.alpha[:chains]
        out[f"suffstats{sfx}_{chains}_chains"] = cs._time_ms(lambda: fwd_ops.suffstats(
            k, t, phi, alpha, y, c.jitter), 3, 10)
    out[f"bf{sfx}_16_chains"] = cs._time_ms(lambda: bf_ops.bf_planes(
        k, t, c.phi, c.alpha, c.jitter), 3, 10)
    v = c.with_noise(cs.noise_weights(c.n)).v32
    out[f"bf{sfx}_16_chains_hetero"] = cs._time_ms(lambda: bf_ops.bf_planes(
        k, t, c.phi, c.alpha, c.jitter, noise_v=v), 3, 10)
    zero = torch.zeros_like(c.alpha[:8])
    out[f"bf{sfx}_path14_8_chains_alpha0"] = cs._time_ms(lambda: bf_ops.bf_planes(
        cs.Exponential(), t, c.phi[:8], zero, c.jitter), 3, 10)
    out[f"sum_b3{sfx}"] = float(bf_ops.bf_planes(k, t, c.phi, c.alpha, c.jitter)[0].double().sum())
    del v
    sums = diff_ops.value_and_grad_sums(k, t, c.phi, c.alpha, y, c.jitter)
    out[f"logdet_chain0{sfx}"] = float(fwd_ops.suffstats(k, t, c.phi, c.alpha, y, c.jitter)[0][0])
    out[f"grad_logdet_chain0{sfx}"] = float(sums[0][0])
    out[f"dlogdet_dphi_chain0{sfx}"] = float(sums[2][0])
    out[f"dquad_dphi_chain0{sfx}"] = float(sums[3][0])
    out[f"sum_b{sfx}"] = float(diff_ops.value_and_grad_sums(
        k, t, c.phi, c.alpha, ys, c.jitter, emit_y=True)[1].double().sum())
    del c, t, y, ys, sums
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


ROUND_CLUSTER = r'''
import json, re, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import bf as bf_ops
from pynngp_tpu_torch.ops import suffstats as fwd_ops
dev = torch.device("cuda", 0)
info = _build.build_info()
lines = info["ptxas"].splitlines()
out = {"build_s": info["seconds"], "lib": info["lib"], "ptxas": {
    re.search(r"\d+([a-z_]+_kernel)", line).group(1): " ".join(
        nxt.strip() for nxt in lines[i + 2:i + 4])
    for i, line in enumerate(lines)
    if "Compiling entry function" in line and "cluster_kernel" in line and "ILb0ELb1E" in line}}
for m in (237, 300, 400, 600):
    c = cs.Case(2000, m, cs.SqExp(), 4, seed=0, dev=dev, layout="coords")
    k, t = c.kernel, c.tab32
    out[f"suffstats_m{m}"] = cs._time_ms(lambda: fwd_ops.suffstats(
        k, t, c.phi, c.alpha, c.y32, c.jitter), 1, 3)
    out[f"bf_m{m}"] = cs._time_ms(lambda: bf_ops.bf_planes(k, t, c.phi, c.alpha, c.jitter), 1, 3)
    out[f"logdet_chain0_m{m}"] = float(fwd_ops.suffstats(
        k, t, c.phi, c.alpha, c.y32, c.jitter)[0][0])
    out[f"sum_b3_m{m}"] = float(bf_ops.bf_planes(k, t, c.phi, c.alpha, c.jitter)[0].double().sum())
    del c, t
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


def main() -> int:
    root = os.getcwd()
    trees = sys.argv[1:]
    code = ROUND
    if trees[:1] == ["--m15"]:
        trees, code = trees[1:], ROUND_M15
    elif trees[:1] == ["--bf"]:
        trees, code = trees[1:], ROUND_BF
    elif trees[:1] == ["--large"]:
        trees, code = trees[1:], ROUND_LARGE
    elif trees[:1] == ["--m20"]:
        trees, code = trees[1:], ROUND_M20
    elif trees[:1] == ["--cluster"]:
        trees, code = trees[1:], ROUND_CLUSTER
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    results = []
    for tree in trees + trees[::-1]:
        run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=os.path.join(root, "archive_check", tree))
        found = [line for line in run.stdout.splitlines() if line.startswith("RESULT ")]
        if not found:  # a tree that fails is reported and left out of the means
            print(tree, run.returncode, run.stderr[-3000:], flush=True)
            continue
        results.append((tree, json.loads(found[0][len("RESULT "):])))
        print(tree, "build", results[-1][1]["build_s"], flush=True)
    names = sorted({k for _, r in results for k, v in r.items()
                    if isinstance(v, float) and k != "build_s"})
    for name in names:
        row = {}
        for tree, r in results:
            if name in r:
                row.setdefault(tree, []).append(r[name])
        print(f"{name:40s} " + "  ".join(f"{t} {sum(v) / len(v):.4f}" for t, v in row.items()),
              flush=True)
    for tree, r in {tree: r for tree, r in results}.items():
        print(tree, json.dumps(r["ptxas"]), flush=True)
        usage = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-res-usage", r["lib"]],
                               capture_output=True, text=True).stdout.splitlines()
        for name, res in zip(usage, usage[1:]):
            if "Function" in name and ("ILi15E" in name or "ILi20E" in name
                                       or "smem_kernel" in name or "team" in name
                                       or "cluster_kernel" in name):
                print(tree, name.split()[-1][:90], res.split("SHARED")[0].strip(), flush=True)
    print("TIME_TREES " + json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
