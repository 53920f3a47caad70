"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` straight from ``csrc/`` into
``build/vqvae_tpu_torch/`` (or ``$VQVAE_TORCH_BUILD_DIR``), named by a
hash of its sources and flags, so an edited source rebuilds and a
second process reuses the first one's build.  The sources have a plain
C interface (no PyTorch headers), which keeps a build to seconds; the
libraries are loaded with ``ctypes``.  Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"path", "seconds", "log"} of the builds this process made
builds: dict = {}


def build_dir() -> Path:
    env = os.environ.get("VQVAE_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "vqvae_tpu_torch"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are compiled from csrc/ at first use")


def build(name: str, sources: list[str]) -> Path:
    """Path of ``lib<name>-<hash>.so`` built from ``csrc/<sources>``
    (the hash covers the shared headers ``csrc/*.cuh`` too)."""
    srcs = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.read_bytes())
    out_dir = build_dir()
    out = out_dir / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    builds[name] = {"path": str(out),
                    "seconds": time.monotonic() - t0,
                    "log": proc.stderr}
    return out
