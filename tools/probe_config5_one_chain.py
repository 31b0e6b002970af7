"""Kernel 1-coords at 1 chain, n=500,000, m=20 (config 5's probe launch) in the
parent and the change, and the SASS of its M = 20 instance in both.

    rm -rf parent_check && mkdir parent_check \
        && git archive <parent commit> | tar -x -C parent_check
    python3 tools/probe_config5_one_chain.py     # from the root of the change

Each tree runs in a process of its own from its root, in turns (parent,
change, parent, change), and times the launch three times each with
``chip_smoke._time_ms`` at 50 and 200 calls and with CUDA events alone; then
``cuobjdump -sass`` of both built libraries is compared instruction by
instruction for ``suffstats_kernel<20, closed form, coords>``.
``tools/compare_parent.py`` times this launch after other work in the same
process; this script times it alone.

    python3 tools/probe_config5_one_chain.py --small

does the same for the two shortest launches of ``compare_parent.py``'s
default rows: kernel 1 at 1 chain (n=100,000, m=15, dist) and kernel 3 at
config 2's launch (n=10,000, m=15, exponential, 8 chains, alpha = 0), with
the SASS of both M = 15 dist instances.
"""
import json
import os
import re
import subprocess
import sys

ROUND = r'''
import json, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import suffstats as fwd_ops
dev = torch.device("cuda", 0)
info = _build.build_info()
big = cs.Case(500000, 20, cs.SqExp(), 16, seed=0, dev=dev, layout="coords")


def one():
    return fwd_ops.suffstats(big.kernel, big.tab32, big.phi[:1], big.alpha[:1], big.y32,
                             big.jitter)


times = {"ms_50_calls": [], "ms_200_calls": [], "ms_events_alone": []}
for _ in range(3):
    times["ms_50_calls"].append(cs._time_ms(one, 5, 50))
    times["ms_200_calls"].append(cs._time_ms(one, 5, 200))
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(50):
        one()
    stop.record()
    torch.cuda.synchronize()
    times["ms_events_alone"].append(start.elapsed_time(stop) / 50)
print("RESULT " + json.dumps({"lib": info["lib"], **times}), flush=True)
'''
KERNEL = r"suffstats_kernelILi20ELb0ELb1ELb0E"  # M = 20, closed form, coords, tile

ROUND_SMALL = r'''
import json, torch
import chip_smoke as cs
from pynngp_tpu_torch.ops import _build
from pynngp_tpu_torch.ops import bf as bf_ops
from pynngp_tpu_torch.ops import suffstats as fwd_ops
dev = torch.device("cuda", 0)
info = _build.build_info()
main = cs.Case(100000, 15, cs.SqExp(), 16, seed=0, dev=dev)
c2 = cs.Case(10000, 15, cs.Exponential(), 8, seed=0, dev=dev)
zero = torch.zeros_like(c2.alpha)
calls = {
    "suffstats_1_chain": lambda: fwd_ops.suffstats(main.kernel, main.tab32, main.phi[:1],
                                                   main.alpha[:1], main.y32, main.jitter),
    "bf_config2_8_chains_alpha0": lambda: bf_ops.bf_planes(c2.kernel, c2.tab32, c2.phi, zero,
                                                           c2.jitter),
}
times = {name: [] for name in calls}
for _ in range(3):
    for name, fn in calls.items():
        times[name].append(cs._time_ms(fn, 20, 200))
print("RESULT " + json.dumps({"lib": info["lib"], **times}), flush=True)
'''
KERNELS_SMALL = (r"suffstats_kernelILi15ELb0ELb0ELb0E", r"bf_kernelILi15ELb0ELb0ELb0ELb0E")


def sass(lib: str, kernel: str = KERNEL) -> list:
    """The instructions of ``kernel`` in ``lib``, addresses and encodings
    dropped."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", out):
        if re.search(kernel, func.split("\n", 1)[0]):
            lines = [line.strip() for line in func.split("\n")[1:]]
            return [re.sub(r"\s+", " ", re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0])
                    for line in lines if line.startswith("/*")]
    raise SystemExit(f"{kernel} not found in {lib}")


def main(args) -> int:
    root = os.getcwd()
    small = args == ["--small"]
    libs = {}
    for tree in ("parent_check", ".", "parent_check", "."):
        run = subprocess.run([sys.executable, "-c", ROUND_SMALL if small else ROUND],
                             capture_output=True, text=True,
                             cwd=os.path.join(root, tree))
        found = [line for line in run.stdout.splitlines() if line.startswith("RESULT ")]
        if not found:
            print(tree, run.stderr[-3000:], flush=True)
            return 1
        result = json.loads(found[0][len("RESULT "):])
        libs[tree] = result.pop("lib")
        print(tree, json.dumps(result), flush=True)
    for kernel in KERNELS_SMALL if small else (KERNEL,):
        parent, change = sass(libs["parent_check"], kernel), sass(libs["."], kernel)
        differ = sum(a != b for a, b in zip(parent, change)) + abs(len(parent) - len(change))
        print(f"SASS {kernel}: {differ} of {len(parent)} / {len(change)} instructions differ",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
