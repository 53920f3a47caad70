"""What every run shares: the environment set before torch loads, the
cell's files found by name, the per-layer readers, the statistics, the
checks and the result line.

Nothing here imports torch at module level, so a run can set its caches
first.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vqvae_tpu")


def prepare_env() -> None:
    """Fixed cache directories inside the checkout, before torch loads:
    bytecode (the card's machine writes none by default, and importing
    torch takes 16-17 s without it, 9-10 s from it), the program's nvcc
    and g++ libraries, and Triton's cache."""
    build = ROOT / "build"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(build / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["VQVAE_TORCH_BUILD_DIR"] = str(build / "vqvae_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start() -> float:
    """``time.monotonic()`` at this process's start (its start time in
    /proc, on the boot clock); the harness's own import time where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        age = -1.0
    if not 0.0 <= age < 600.0:
        return _IMPORTED
    return time.monotonic() - age


_IMPORTED = time.monotonic()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, the
    configuration's file, the traffic's file, its limits and the
    metrics it reports."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    confs = {c["name"]: c for c in man["configs"]}
    conf = load_json(root / confs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits_path = HERE / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return SimpleNamespace(name=name, chips=w["chips"], config=conf,
                           traffic=traffic, limits=limits, end_to_end=e2e,
                           per_layer=per_layer)


def reader(metric: str):
    """The ``read(obs)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_csrc() -> Path:
    """The program's CUDA sources, where the run imports it from."""
    import vqvae_tpu_torch
    return Path(vqvae_tpu_torch.__file__).resolve().parent / "csrc"


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({k.split(".", 1)[0] for k in sys.modules
                   if k.split(".", 1)[0] in FORBIDDEN})


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def power_limit_w() -> Optional[float]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        return float(r.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def checks_pass(checks: Dict[str, dict]) -> bool:
    """Every compared number is present and at or under its limit."""
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in checks.values())


def emit(result: dict) -> None:
    """The checks as the last lines on standard error, then the result
    as the last line of standard output, its ``checks`` key last."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if result.get("breakdown"):
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    print(json.dumps(line), flush=True)
