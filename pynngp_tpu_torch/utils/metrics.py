"""JSON-lines metrics (counterpart of ``pynngp_tpu.utils.metrics``): one line
per event, e.g. one per driver chunk with its throughput and sampler health,
and a cross-chain health summary of a run's draws."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

import numpy as np
import torch

from pynngp_tpu_torch.diagnostics import ess, split_rhat

__all__ = ["MetricsLogger", "chain_health"]


class MetricsLogger:
    """Emit one JSON line per event to a stream (default stderr) and keep an
    in-memory history; ``run_id``, when set, tags every line as ``run``.
    Tensor and numpy fields are written as numbers or lists."""

    def __init__(self, stream: Optional[IO] = None, run_id: str = ""):
        self.stream = stream if stream is not None else sys.stderr
        self.run_id = run_id
        self.history = []
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"t": round(time.time() - self._t0, 3), "event": event}
        if self.run_id:
            rec["run"] = self.run_id
        for key, val in fields.items():
            if isinstance(val, torch.Tensor):
                val = val.detach().cpu().tolist()
            elif isinstance(val, (np.generic, np.ndarray)):
                val = np.asarray(val).tolist()
            rec[key] = val
        self.history.append(rec)
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
        return rec


def chain_health(draws: dict, params=None) -> dict:
    """Cross-chain diagnostics of numpy draws (n_chains, n_draws): ESS and
    split R-hat per parameter (R-hat NaN for a single chain), and the
    divergence rate where the draws carry ``diverging``."""
    out = {}
    params = params or [
        k for k in draws if k not in ("diverging", "w", "beta", "loglik", "logpost")
    ]
    for name in params:
        v = np.asarray(draws[name], np.float64)
        out[name] = {
            "ess": ess(v),
            "rhat": split_rhat(v) if v.ndim == 2 and v.shape[0] > 1 else float("nan"),
        }
    if "diverging" in draws:
        out["divergence_rate"] = float(np.asarray(draws["diverging"]).mean())
    return out
