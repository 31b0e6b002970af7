"""Two processes on ``torch.distributed`` (gloo over localhost, the CPU):
the port's counterpart of tests/test_distributed.py.

The file is its own worker: ``python tests/test_torch_distributed.py
worker PORT RANK CKPT_DIR``.  Each process brings up the group with
``initialize_distributed``, takes its share of a (chains=2, sites=2) mesh of
"cpu" devices from ``global_mesh`` (the chains axis across the processes)
and checks what the reference's worker checks:

  1. the site-sharded log-likelihood of the response model equals the
     process-local unsharded value;
  2. a chain-sharded reduction (``all_reduce`` of each process's sum over
     its chains) equals the sum over all chains computed locally;

and that ``process_chain_slice`` and ``host_local_to_global`` give each
process its own chains on its mesh's first device.

The same pair then runs the reference's per-process checkpoints (its
save / kill / resume): each rank samples its own chains with its own
generator, uninterrupted, then stopped inside its last chunk and resumed
from ``<path>.p<rank>.*``; the resumed draws must be its uninterrupted
run's bit for bit."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240  # each process's own limit
CHAINS = 4  # over both processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(port: int, rank: int, ckpt_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from pynngp_tpu_torch.models.response import ResponseNNGP
    from pynngp_tpu_torch.parallel import (global_mesh, host_local_to_global,
                                           initialize_distributed, process_chain_slice)

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")  # no-op
    mesh = global_mesh(2, 2, devices=["cpu", "cpu"])
    assert mesh.shape == {"chains": 1, "sites": 2}, mesh.shape

    rng = np.random.default_rng(0)
    n, m = 160, 6
    coords = rng.uniform(size=(n, 2))
    y = rng.standard_normal(n)
    kw = dict(kernel="exponential", m=m, dtype=torch.float64, device="cpu")
    local = ResponseNNGP(coords, y, **kw)
    model = ResponseNNGP(coords, y, mesh=mesh, **kw)
    # u = [log sigma2, logit phi, log tau2] of every chain, the same in both
    # processes; each process takes its own rows
    u_all = np.column_stack([np.log(np.linspace(0.8, 1.4, CHAINS)),
                             np.linspace(-1.0, 1.0, CHAINS),
                             np.log(np.linspace(0.1, 0.3, CHAINS))])
    mine = process_chain_slice(CHAINS)
    assert mine == slice(rank * CHAINS // 2, (rank + 1) * CHAINS // 2)
    u = host_local_to_global(mesh, ("chains",), u_all[mine])
    assert u.shape == (CHAINS // 2, 3) and u.device == mesh.first

    with torch.no_grad():
        got = model.full_loglik(u)
        want = local.full_loglik(u)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
        total = got.sum()
        dist.all_reduce(total)
        every = local.full_loglik(torch.as_tensor(u_all)).sum()
        np.testing.assert_allclose(float(total), float(every), rtol=1e-10)
    print(f"DIST OK rank={rank} loglik={float(got.sum()):.6f} "
          f"total={float(total):.6f}", flush=True)
    _checkpoint_worker(local, rank, ckpt_dir)
    dist.barrier()
    dist.destroy_process_group()


class _Stop(Exception):
    pass


def _checkpoint_worker(model, rank: int, ckpt_dir: str) -> None:
    """An uninterrupted, a stopped and a resumed checkpointed MWG run of this
    rank's chains, each rank with its own seed; the resume must give the
    uninterrupted draws bit for bit."""
    ck = os.path.join(ckpt_dir, "run")
    n_burn, n_samples = 10, 20
    kw = dict(n_samples=n_samples, n_burn=n_burn, n_chains=2, seed=11 + rank,
              chunk=5, config={"model": "response", "m": model.tables.m})
    want = model.sample(**kw)
    calls = [0]
    step = model.step

    def stopping_step(*args, **kwargs):
        calls[0] += 1
        if calls[0] > n_burn + n_samples - 3:  # inside the last chunk
            raise _Stop
        return step(*args, **kwargs)

    model.step = stopping_step
    try:
        model.sample(checkpoint_path=ck, checkpoint_every=1, **kw)
        raise AssertionError("the run was not stopped")
    except _Stop:
        pass
    finally:
        del model.step
    for suffix in (".npz", ".json", ".draws.npz"):
        assert os.path.exists(f"{ck}.p{rank}{suffix}"), suffix
    got = model.sample(checkpoint_path=ck, checkpoint_every=1, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    print(f"CKPT OK rank={rank} draws={want['phi'].shape}", flush=True)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One pair of gloo worker processes, run to their end: each one's
    (rc, stdout, stderr), and the checkpoint directory they share."""
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(port), str(rank),
         ckpt_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True, cwd=ROOT)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, ckpt_dir


def test_two_process_distributed(pair):
    outs, _ = pair
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-3000:]}"
        assert "DIST OK" in out, f"missing OK line:\n{out}\n{err[-2000:]}"


def test_two_process_checkpoints_resume_per_rank(pair):
    """Each rank resumed its own run bit for bit from its own files
    ``<path>.p<rank>.npz / .json / .draws.npz``; no single-process file was
    written, the two ranks' states differ, and ``<path>.config.json`` is one
    file, rank 0's."""
    outs, ckpt_dir = pair
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-3000:]}"
        assert "CKPT OK" in out, f"missing OK line:\n{out}\n{err[-2000:]}"
    ck = os.path.join(ckpt_dir, "run")
    states = []
    for rank in range(2):
        with np.load(f"{ck}.p{rank}.npz") as z:
            states.append({k: z[k] for k in z.files})
    assert states[0].keys() == states[1].keys()
    assert any(not np.array_equal(states[0][k], states[1][k]) for k in states[0])
    assert os.path.exists(ck + ".config.json")
    for suffix in (".npz", ".json", ".draws.npz"):
        assert not os.path.exists(ck + suffix), suffix


if __name__ == "__main__" and len(sys.argv) == 5 and sys.argv[1] == "worker":
    sys.path.insert(0, ROOT)
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
