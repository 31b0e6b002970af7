"""End-to-end spatial-regression walkthrough on the PyTorch + CUDA port:
simulate a field, fit a latent or response NNGP with one of five sampler
families, predict held-out sites.

Run: python examples/torch_spatial_regression.py [--n 2000] [--sampler nuts]
     [--device cpu]

``--device cuda`` (the default) runs the CUDA kernels and needs a card;
``--device cpu`` runs their plain PyTorch versions.
"""

import os
import sys

# runnable as `python examples/<name>.py` from anywhere without an
# installed package: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def sqexp_cov(coords, sigma2, phi):
    """Dense sigma2 exp(-(d / phi)^2) covariance of ``coords``."""
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    return sigma2 * np.exp(-d2 / phi**2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--sampler", default="mwg",
                    choices=["mwg", "nuts", "hmc", "smc", "advi"])
    ap.add_argument("--model", default="response", choices=["response", "latent"])
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--burn", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import torch

    import pynngp_tpu_torch as pt

    # --- simulate (2D grid + exact GP draw) ------------------------------
    rng = np.random.default_rng(0)
    sigma2, phi, tau2 = 1.0, 0.2, 0.1
    n_total = args.n + 200
    side = int(np.ceil(np.sqrt(n_total)))
    grid = np.stack(
        np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side)), -1
    ).reshape(-1, 2)[:n_total]
    coords = grid + rng.uniform(0, 1e-4, grid.shape)
    if n_total <= 4000:
        c = sqexp_cov(coords, sigma2, phi)
        w = np.linalg.cholesky(c + 1e-8 * np.eye(n_total)) @ rng.standard_normal(n_total)
    else:  # spectral approximation for big n
        freqs = rng.normal(scale=1 / phi, size=(512, 2))
        ph = rng.uniform(0, 2 * np.pi, 512)
        w = np.sqrt(2 * sigma2 / 512) * np.cos(coords @ freqs.T + ph).sum(1)
    y = w + np.sqrt(tau2) * rng.standard_normal(n_total)
    train, test = slice(0, args.n), slice(args.n, n_total)

    # --- fit --------------------------------------------------------------
    gp = pt.SeqNNGP(y[train], coords[train], m=args.m, cov_model="sqexp",
                    model=args.model, device=args.device)
    t0 = time.time()
    if args.sampler == "mwg":
        gp.sample(args.samples, n_burn=args.burn, seed=1)
    elif args.model != "response":
        sys.exit(f"--sampler {args.sampler} targets the response model")
    elif args.sampler in ("nuts", "hmc"):
        fn = gp.model.sample_nuts if args.sampler == "nuts" else gp.model.sample_hmc
        gp._draws = fn(args.samples, n_burn=args.burn, seed=1)
    elif args.sampler == "smc":
        draws, _ = gp.model.sample_smc(n_particles=1024, seed=1, verbose=True)
        # resample to unweighted draws for the common downstream API
        w_ = np.exp(draws["logw"] - np.logaddexp.reduce(draws["logw"]))
        idx = rng.choice(len(w_), size=args.samples, p=w_ / w_.sum())
        gp._draws = {k: v[idx] for k, v in draws.items()
                     if k not in ("logw", "log_z")}
        print(f"SMC evidence log Z = {draws['log_z']:.2f}")
    else:  # advi
        draws, _ = gp.model.fit_advi(n_steps=2000, n_draws=args.samples, seed=1)
        gp._draws = draws
    dt = time.time() - t0
    print(f"\nfit ({args.sampler}, {args.model}) on {args.device} in {dt:.1f}s")
    for k, v in pt.summarize(gp._draws, params=[p for p in ("sigma2", "phi", "tau2")
                                                if p in gp._draws]).items():
        print(f"  {k:8s} mean={v['mean']:.3f} sd={v['sd']:.3f} "
              f"95% CI=({v['q2.5']:.3f}, {v['q97.5']:.3f}) ess={v['ess']:.0f}")
    print(f"  truth: sigma2={sigma2} phi={phi} tau2={tau2}")

    # --- predict ----------------------------------------------------------
    gen = torch.Generator(device=args.device).manual_seed(2)
    pred = gp.predict(coords[test], generator=gen)
    pm = pred["mean"].mean(0).cpu().numpy()
    samples = pred["samples"].cpu().numpy()
    rmse = float(np.sqrt(np.mean((pm - y[test]) ** 2)))
    cover = float(np.mean((y[test] >= np.percentile(samples, 2.5, axis=0))
                          & (y[test] <= np.percentile(samples, 97.5, axis=0))))
    print(f"\nheld-out: RMSE={rmse:.3f} (noise sd={np.sqrt(tau2):.3f}), "
          f"95% coverage={cover:.2f}")
    if not (np.isfinite(pm).all() and np.isfinite(samples).all()):
        sys.exit("non-finite predictions")


if __name__ == "__main__":
    main()
