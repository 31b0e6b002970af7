"""torch.profiler over the config-5 model's value and gradient, in a fresh
process, in windows of several shapes.

    PYTHONPATH=. python3 tools/profile_window.py

Builds ``ResponseNNGP`` on ``chip_smoke.bench_field`` at n=500,000, m=20
(sqexp, the coords layout by default), fits its MAP point (60 steps), then
profiles ``full_value_and_grad`` at 4 chains started around it: in a fresh
window, with 0.5 s of padding on both sides, after ``chip_smoke.profile_nuts``
(which profiles NUTS transitions and then the value and gradient alone), with
20 calls, with a synchronise after each call, with a small operation first,
and at n=100,000, m=15.  Each line gives the wall ms a call, the device
events recorded, the kernel-2 launches among them, the device-busy ms a call,
and the spans of the host and device events (us from the window's start).
"""
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from pynngp_tpu_torch.ops import _build

dev = torch.device("cuda", 0)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout, flush=True)
print("torch", torch.__version__, torch.version.cuda, flush=True)
print("build", _build.build_info()["seconds"], flush=True)

coords, y = cs.bench_field(cs.N_C5, seed=0)
model = cs.ResponseNNGP(coords, y, kernel="sqexp", m=cs.M_C5, device=dev)
mp = model.fit_map(n_steps=60)
gen = torch.Generator().manual_seed(7)
u = model._warm_init_u(mp.u, mp.laplace_cov, 4, gen, 2.0)


def window(tag, steps=5, pad=0.0, sync_each=False, tiny=False):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if tiny:
            (torch.zeros(8, device=dev) + 1).sum().item()
        time.sleep(pad)
        t0 = time.perf_counter()
        for _ in range(steps):
            model.full_value_and_grad(u)
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        time.sleep(pad)
    ev = prof.events()
    cuda = [e for e in ev if e.device_type == DeviceType.CUDA]
    cpu = [e for e in ev if e.device_type == DeviceType.CPU]
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {"wall_ms": wall, "n_cuda_events": len(cuda), "n_cpu_events": len(cpu),
           "n_grad_kernels": sum("grad_kernel" in e.name for e in cuda),
           "busy_ms_per_step": sum(e.self_device_time_total for e in rows) / 1e3 / steps,
           "cpu_span_us": [min(e.time_range.start for e in cpu),
                           max(e.time_range.end for e in cpu)] if cpu else None,
           "cuda_span_us": [min(e.time_range.start for e in cuda),
                            max(e.time_range.end for e in cuda)] if cuda else None,
           "cuda_names": sorted({e.name[:40] for e in cuda})[:8]}
    print(tag, json.dumps(out), flush=True)


window("fresh")
window("fresh pad", pad=0.5)
print("profile_nuts", json.dumps(cs.profile_nuts(model, mp, 4, 6, warm=5, wall_steps=5)),
      flush=True)
window("after nuts")
window("after nuts pad", pad=0.5)
window("after nuts 20 steps", steps=20)
window("after nuts sync each", sync_each=True)
window("after nuts tiny op first", tiny=True)
window("after nuts again")
model = cs.ResponseNNGP(*cs.bench_field(100_000, seed=0), kernel="sqexp", m=15, device=dev)
window("n100000 after all")
sys.exit(0)
