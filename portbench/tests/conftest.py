"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``cuda`` need a card and skip here with the reason; the
``card`` fixture decides, at run time and never at import.  The CPU
rehearsals run in a copy of the benchmark that holds tiny cells
(``rehearse.py``), as subprocesses on the program's plain versions.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.rehearse import copy_bench, tiny_cells

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark's files with the tiny cells added."""
    root = copy_bench(REPO, tmp_path_factory.mktemp("bench"))
    tiny_cells(root)
    return root


def rehearse(root: Path, cell: str, seed: int, seconds: float = 1.0,
             trace: int = 0, extra_path: Path | None = None,
             timeout: float = 600) -> tuple:
    """Run ``portbench.tests.rehearse`` in ``root``: (result, forbidden
    modules, the whole output)."""
    import json
    env = dict(os.environ, OMP_NUM_THREADS="2")
    paths = ([str(extra_path)] if extra_path else []) + [str(root),
                                                         str(REPO)]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    r = subprocess.run(
        [sys.executable, "-m", "portbench.tests.rehearse", "--workload",
         cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=root, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    forbidden = json.loads(lines[-1].split(":", 1)[1])
    return json.loads(lines[-2]), forbidden, r.stdout + r.stderr
