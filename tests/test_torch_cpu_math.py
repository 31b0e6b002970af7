"""torch's vectorized CPU math after ``import pynngp_tpu_torch``: the first
float64 exp and log of a fresh process, run on eight threads at once, equal
numpy's to 1e-14 (relative).

Without a serial call first, torch's first vectorized exp of a process came
out up to 3.3e-9 off over one thread's share of the elements in 3 of 120
fresh processes on a loaded host: the plain versions, held to the reference
at rtol 1e-8, then missed now and then (tests/test_torch_bf.py).  The
package makes that serial call at import (``_settle_cpu_math``).  Eight
processes start together, as a test run's workers do; each checks its first
calls."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIRST_CALLS = """
import numpy as np
import torch
import pynngp_tpu_torch
torch.set_num_threads(8)
x = torch.linspace(0.01, 3.0, 2_000_003, dtype=torch.float64)
errs = []
for fn, ref_fn, arg in ((torch.exp, np.exp, -x), (torch.log, np.log, x)):
    got = fn(arg)
    ref = torch.from_numpy(ref_fn(arg.numpy()))
    errs.append(float(((got - ref).abs() / ref.abs()).max()))
print(max(errs))
"""


def test_first_parallel_exp_and_log_after_import_match_numpy():
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", FIRST_CALLS], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(8)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    errs = [float(out.split()[-1]) for out, _ in outs]
    assert max(errs) <= 1e-14, errs
