"""Helpers of the mesh tests (``test_torch_mesh_*.py``): a test's ranks as
processes over gloo, and the reference on fake XLA devices.

:func:`run_ranks` starts ``world`` processes of a test file (``python
tests/test_torch_mesh_x.py --rank R WORLD STORE OUT CHECK``), each joining
one gloo group through a file store under the test's ``tmp_path`` (no
fixed port: several test workers run at once), with one thread each.  The
file's ``__main__`` calls :func:`rank_main`, which runs the named check
(given the directory of the test's inputs) and has rank 0 write what it
returns.  A rank that fails stops the others
and fails the test with its log; so does the time limit.

:func:`run_py` is ``tests/test_multidevice.py:run_py``: the reference in a
child process that sees ``devices`` forced host devices.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
RANK_TIMEOUT = 240  # seconds a spawned check may take, all ranks


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_ranks(script, world: int, tmp_path: Path, check: str,
              timeout: float = RANK_TIMEOUT) -> dict:
    """Run ``check`` of ``script`` on ``world`` gloo ranks; returns what
    rank 0's check returned."""
    import torch
    tmp_path.mkdir(parents=True, exist_ok=True)
    store, out = tmp_path / f"{check}.store", tmp_path / f"{check}.pt"
    logs = [tmp_path / f"{check}.rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), "--rank", str(r), str(world),
                 str(store), str(out), check],
                env=_env(), stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = (bad[0], f"rank {bad[0]} exited with "
                          f"{procs[bad[0]].returncode}")
                break
            if time.monotonic() > deadline:
                failed = (0, f"the ranks ran past {timeout} s")
                break
            time.sleep(0.1)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = (bad[0], f"rank {bad[0]} exited with "
                          f"{procs[bad[0]].returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed is not None:
        r, what = failed
        raise AssertionError(f"{check}: {what}\n" +
                             logs[r].read_text()[-4000:])
    return torch.load(out, weights_only=False)


def rank_main(checks: dict):
    """The ``__main__`` of a mesh test file run as one rank: the check is
    called with the test's directory (where the test left its inputs)."""
    import torch
    import torch.distributed as dist
    rank, world = int(sys.argv[2]), int(sys.argv[3])
    store, out, check = sys.argv[4], sys.argv[5], sys.argv[6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = checks[check](Path(out).parent)
        dist.barrier()
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def run_py(code: str, devices: int = 4, timeout: int = 480) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-3000:]}"
    return out.stdout
