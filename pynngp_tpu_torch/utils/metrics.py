"""JSON-lines metrics (counterpart of ``pynngp_tpu.utils.metrics``): one line
per event, e.g. one per driver chunk with its throughput and sampler health."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Emit one JSON line per event to a stream (default stderr) and keep an
    in-memory history."""

    def __init__(self, stream: Optional[IO] = None):
        self.stream = stream if stream is not None else sys.stderr
        self.history = []
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"t": round(time.time() - self._t0, 3), "event": event, **fields}
        self.history.append(rec)
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
        return rec
