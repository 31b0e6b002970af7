"""Console smoke entry (``pynngp-torch-smoke``): a tiny end-to-end
response-model run proving that the installed port works on a device.

    python -m pynngp_tpu_torch.smoke [--device cuda|cpu]

``cuda`` (the default) builds and runs the CUDA kernels and raises without a
card; ``cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import platform
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pynngp-torch-smoke")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import pynngp_tpu_torch as pt
    from pynngp_tpu_torch import native

    rng = np.random.default_rng(0)
    n = 400
    coords = rng.uniform(size=(n, 2))
    w = np.sin(4 * coords[:, 0]) * np.cos(4 * coords[:, 1])
    y = w + 0.3 * rng.standard_normal(n)
    model = pt.ResponseNNGP(coords, y, kernel="sqexp", m=8, device=args.device)
    draws = model.sample(50, n_burn=50, seed=0)
    ok = all(np.isfinite(np.asarray(v)).all() for v in draws.values())
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else platform.processor() or platform.machine())
    print(
        f"pynngp_tpu_torch smoke {'OK' if ok else 'FAILED'} "
        f"(device={args.device}: {name}, native={native.native_available()}): "
        f"phi_mean={float(np.mean(draws['phi'])):.3f} "
        f"sigma2_mean={float(np.mean(draws['sigma2'])):.3f}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
