"""NNGP kriging of a real spatial field on the PyTorch + CUDA port.

Dataset: the luminance channel of scikit-learn's bundled photograph
``china.jpg`` (427 x 640, sample data installed with scikit-learn; nothing is
downloaded).  A natural image is a measured 2-D field with nonstationary
structure, sharp edges and texture.  The workflow is construct -> sample ->
predict -> summarize:

  1. sample n_train pixel locations as observations of the field,
  2. fit a response NNGP with an exponential kernel by MCMC,
  3. krige n_test held-out pixels from the posterior draws,
  4. report RMSE / 90% interval coverage, and compare against exact dense
     kriging on a small subregion.

Run: python examples/torch_image_kriging.py [--n-train 20000] [--sampler mwg]
     [--device cpu]

Needs scikit-learn for the image; without it the example says so and exits.
"""

import os
import sys

# runnable as `python examples/<name>.py` from anywhere without an
# installed package: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def load_luminance():
    """China photo -> (h, w) luminance field in [0, 1]."""
    try:
        from sklearn.datasets import load_sample_images
    except ImportError:
        sys.exit("torch_image_kriging: this example reads china.jpg from "
                 "scikit-learn's sample data, and scikit-learn is not installed")
    img = load_sample_images().images[0].astype(np.float64)  # (427, 640, 3)
    return img @ np.array([0.2126, 0.7152, 0.0722]) / 255.0


def dense_krig_mean(y, coords, new, sigma2, phi, tau2):
    """Exact kriging mean under sigma2 exp(-d / phi) + tau2 I (float64)."""
    dist = lambda a, b: np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    c = sigma2 * np.exp(-dist(coords, coords) / phi) + tau2 * np.eye(len(coords))
    c0 = sigma2 * np.exp(-dist(new, coords) / phi)
    return c0 @ np.linalg.solve(c, y)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=20_000)
    ap.add_argument("--n-test", type=int, default=2_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--burn", type=int, default=400)
    ap.add_argument("--sampler", default="mwg", choices=["mwg", "nuts"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    lum = load_luminance()

    import torch

    import pynngp_tpu_torch as pt

    h, w = lum.shape
    yy, xx = np.mgrid[0:h, 0:w]
    # coords in a ~unit box (aspect preserved); values standardized
    scale = max(h, w)
    coords_all = np.stack([xx.ravel() / scale, yy.ravel() / scale], axis=1)
    vals_all = lum.ravel()
    z_all = (vals_all - vals_all.mean()) / vals_all.std()

    rng = np.random.default_rng(0)
    perm = rng.permutation(coords_all.shape[0])
    tr = perm[: args.n_train]
    te = perm[args.n_train : args.n_train + args.n_test]
    print(f"china.jpg luminance field: {h}x{w} px; "
          f"n_train={len(tr)} n_test={len(te)} m={args.m}")

    t0 = time.time()
    model = pt.SeqNNGP(z_all[tr], coords_all[tr], m=args.m,
                       cov_model="exponential", model="response",
                       device=args.device)
    print(f"model built in {time.time()-t0:.1f}s (device={args.device})")

    t0 = time.time()
    if args.sampler == "nuts":
        mp = model.model.fit_map(n_steps=200)
        draws = model.model.sample_nuts(args.samples, n_burn=args.burn, n_chains=2,
                                        init_u=mp.u, init_inv_mass=mp.laplace_cov)
        model._draws = {k: v.reshape(-1) if v.ndim == 2 else v
                        for k, v in draws.items()}
    else:
        model.sample(args.samples, n_burn=args.burn, seed=1)
    print(f"sampling done in {time.time()-t0:.1f}s")

    print("posterior summary (standardized scale):")
    summary = model.summary()
    for k, row in summary.items():
        print(f"  {k:7s} mean={row['mean']:8.4f} sd={row['sd']:.4f} "
              f"q2.5={row['q2.5']:8.4f} q97.5={row['q97.5']:8.4f}")

    # --- predict held-out pixels ---------------------------------------
    t0 = time.time()
    gen = torch.Generator(device=args.device).manual_seed(7)
    pred = model.predict(coords_all[te], generator=gen, thin=4)
    mean = pred["mean"].mean(0).cpu().numpy()
    samples = pred["samples"].cpu().numpy()
    lo = np.quantile(samples, 0.05, axis=0)
    hi = np.quantile(samples, 0.95, axis=0)
    truth = z_all[te]
    rmse = float(np.sqrt(np.mean((mean - truth) ** 2)))
    cover = float(np.mean((truth >= lo) & (truth <= hi)))
    base = float(np.sqrt(np.mean(truth**2)))  # predict-the-mean baseline
    print(f"kriging {len(te)} held-out pixels in {time.time()-t0:.1f}s:")
    print(f"  RMSE={rmse:.4f} (constant-mean baseline {base:.4f}), "
          f"90% interval coverage={cover:.3f}")
    if not np.isfinite(samples).all():
        sys.exit("non-finite predictions")

    # --- exact kriging on a small subregion ------------------------------
    sub = (coords_all[tr][:, 0] < 0.25) & (coords_all[tr][:, 1] < 0.25)
    sub_te = (coords_all[te][:, 0] < 0.25) & (coords_all[te][:, 1] < 0.25)
    if sub.sum() > 50 and sub_te.sum() > 10:
        mean_d = dense_krig_mean(
            z_all[tr][sub], coords_all[tr][sub], coords_all[te][sub_te],
            summary["sigma2"]["mean"], summary["phi"]["mean"],
            summary["tau2"]["mean"])
        agree = float(np.sqrt(np.mean((mean[sub_te] - mean_d) ** 2)))
        rmse_d = float(np.sqrt(np.mean((mean_d - truth[sub_te]) ** 2)))
        print(f"  subregion ({int(sub.sum())} train / {int(sub_te.sum())} "
              f"test px): exact dense kriging RMSE={rmse_d:.4f}, "
              f"NNGP-vs-dense mean discrepancy={agree:.4f}")


if __name__ == "__main__":
    main()
