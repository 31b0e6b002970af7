"""Run some of ``chip_smoke.py``'s paths alone on the card, with their gates:

    python3 tools/smoke_paths.py [large] [config4] [advi] [resume] [prediction]
                                 [facade] [orderings] [dotproduct]
                                 [offset] [mesh] [processes]

(all eleven when none is named): ``large``, the large-m phase (the
shared-memory and cluster bodies' resources, every kernel at m = 40 and 64
against its plain version and timed, the factor-only yardstick, the three
kernels on their cluster body at the first m of each cluster size and at
M_CLUSTER against their plain versions and timed, each kernel on the
scratch body at the first m it runs there) and path 19, both models at
m = 40 and the response model's MAP at m = 240; path 20, ``bench.py``'s config 4 with
tempered SMC; path 21, ADVI on the main path's model (its MWG means are not
run here); path 22, interrupt and resume of MWG, NUTS and the latent model;
path 23, prediction from the main path's draws (the main path runs first);
path 24, the facade's defaults; path 25, the max-min and natural orderings;
path 26, the dot-product distance and the neighbor-table cache; path 27,
the shard offset on meshes of one card (config 3's field is made first);
path 28, config 5 on a 1 x 4 mesh of one card; path 29, two processes on
gloo on one card.  A quicker
check of those paths than the whole script; it builds the kernels first,
and fails as the script does."""

import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from pynngp_tpu_torch.ops import _build  # noqa: E402

PATHS = ("large", "config4", "advi", "resume", "prediction", "facade", "orderings",
         "dotproduct", "offset", "mesh", "processes")


def main(names) -> int:
    if not torch.cuda.is_available():
        print("smoke_paths: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["PYNNGP_NEIGHBOR_CACHE"] = "0"  # cold set-ups, as chip_smoke.py
    os.makedirs(os.path.dirname(_build.BUILD_DIR), exist_ok=True)
    dev = torch.device("cuda", 0)
    print(f"build: {_build.build_info()['seconds']:.1f} s", flush=True)
    for name in names or PATHS:
        t0 = time.perf_counter()
        if name == "large":
            cs.tile_resources(_build.build_info())
            cs.large_m_kernels(dev)
            cs.large_m_path(dev)
        elif name == "config4":
            cs.config4_path(dev)
        elif name == "advi":
            cs.advi_path(dev, {})
        elif name == "resume":
            with tempfile.TemporaryDirectory(dir=os.path.dirname(_build.BUILD_DIR)) as tmp:
                cs.resume_path(dev, tmp)
        elif name == "prediction":
            cs.prediction_path(dev, cs.main_path(dev)[1])
        elif name == "facade":
            cs.facade_path(dev)
        elif name == "orderings":
            cs.orderings_path(dev)
        elif name == "dotproduct":
            with tempfile.TemporaryDirectory(dir=os.path.dirname(_build.BUILD_DIR)) as tmp:
                cs.dotproduct_path(dev, tmp)
        elif name == "offset":
            cs.shard_offset_path(dev, cs.config3_field(cs.N_NU, cs.M_NU))
        elif name == "mesh":
            cs.config5_mesh_path(dev)
        elif name == "processes":
            cs.processes_path()
        else:
            raise SystemExit(f"unknown path {name!r}; choose from {PATHS}")
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
