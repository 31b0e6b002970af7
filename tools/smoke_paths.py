"""Run some of ``chip_smoke.py``'s paths alone on the card, with their gates:

    python3 tools/smoke_paths.py [config4] [advi] [resume]

(all three when none is named): path 20, ``bench.py``'s config 4 with
tempered SMC; path 21, ADVI on the main path's model (its MWG means are not
run here); path 22, interrupt and resume of MWG, NUTS and the latent model.
A quicker check of those paths than the whole script; it builds the
kernels first, and fails as the script does."""

import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from pynngp_tpu_torch.ops import _build  # noqa: E402

PATHS = ("config4", "advi", "resume")


def main(names) -> int:
    if not torch.cuda.is_available():
        print("smoke_paths: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"build: {_build.build_info()['seconds']:.1f} s", flush=True)
    for name in names or PATHS:
        t0 = time.perf_counter()
        if name == "config4":
            cs.config4_path(dev)
        elif name == "advi":
            cs.advi_path(dev, {})
        elif name == "resume":
            os.makedirs(os.path.dirname(_build.BUILD_DIR), exist_ok=True)
            with tempfile.TemporaryDirectory(dir=os.path.dirname(_build.BUILD_DIR)) as tmp:
                cs.resume_path(dev, tmp)
        else:
            raise SystemExit(f"unknown path {name!r}; choose from {PATHS}")
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
