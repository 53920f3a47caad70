"""Gloo worlds of CPU ranks for the port's parallel tests.

``run_world(n, argv, tmp_path)`` runs ``argv`` (a script and its
arguments, or ``-m module ...``) as an ``n``-rank world the way the docs
launch one: ``torchrun --standalone --nproc-per-node n`` (as
``python -m torch.distributed.run``), which picks a free port itself,
so xdist workers cannot collide.  Each rank's standard output and error
go to files under ``tmp_path`` (torchrun's ``--redirects``).  The world
has its own time limit (``JOIN_S``, so a hang costs little of the
suite's limit); a world that hangs or fails is killed whole and the
test fails with every rank's output.  ``run_job`` runs one job of
``tests/_torch_mesh_worker.py`` and returns each rank's result.
"""

import glob
import os
import signal
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mesh_worker.py")
JOIN_S = 120   # the world's time limit


def _rank_log(logs, r, stream):
    found = glob.glob(os.path.join(logs, "*", "attempt_0", str(r),
                                   f"{stream}.log"))
    if not found:
        return f"(no {stream}.log for rank {r})"
    with open(found[0]) as f:
        return f.read()


def run_world(n, argv, tmp_path):
    """Run ``argv`` as an ``n``-rank world; returns each rank's stdout."""
    logs = os.path.join(str(tmp_path), f"logs-{time.monotonic_ns()}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "RANK", "LOCAL_RANK",
                                "WORLD_SIZE", "LOCAL_WORLD_SIZE"))}
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "--log-dir", logs, "--redirects", "3",
         *argv], cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True)
    try:
        agent = p.communicate(timeout=JOIN_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        agent = p.communicate()[0]
        hung = True
    else:
        hung = False
    outs = [_rank_log(logs, r, "stdout") for r in range(n)]
    if hung or p.returncode != 0:
        raise AssertionError(
            (f"a world of {n} hung past {JOIN_S} s" if hung else
             f"a world of {n} failed (torchrun exited {p.returncode})")
            + f":\n{agent[-4000:]}\n" + "\n".join(
                f"--- rank {r}\n{outs[r]}\n{_rank_log(logs, r, 'stderr')}"
                for r in range(n)))
    return outs


def run_job(n, job, tmp_path):
    """Each rank's result of ``_torch_mesh_worker.py``'s ``job``."""
    out = os.path.join(str(tmp_path), f"job-{job}")
    os.makedirs(out, exist_ok=True)
    run_world(n, [WORKER, job, out], tmp_path)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]
