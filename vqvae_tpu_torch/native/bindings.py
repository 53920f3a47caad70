"""ctypes bindings for the port's native audio library (``native/audio.cpp``;
counterpart of ``vqvae_tpu/native/bindings.py``).

The library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first
use, never at import, into ``kernels/build.py::build_dir()`` (the
CUDA builds' directory, gitignored), as ``libvqa_audio-<hash>.so`` with
the hash taken over the source and the flags.  The build is written to a
temporary file and moved into place with ``os.replace``, so parallel
processes share one build and none loads half a file.  ``available()``
is False when no compiler is present or the build fails, and
``audio/wav_io.py`` then decodes through scipy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vqvae_tpu_torch.kernels.build import build_dir

SRC = Path(__file__).resolve().parent / "audio.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
MULAW_MODES = {"round": 0, "chainer": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def so_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return build_dir() / f"libvqa_audio-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    return True


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vqa_load_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(f32p),
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.vqa_load_wav.restype = ctypes.c_int
    lib.vqa_free.argtypes = [f32p]
    lib.vqa_free.restype = None
    lib.vqa_mulaw_encode.argtypes = [f32p, ctypes.c_int64, ctypes.c_int,
                                     i32p]
    lib.vqa_mulaw_encode.restype = None
    lib.vqa_mulaw_encode_mode.argtypes = [f32p, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int, i32p]
    lib.vqa_mulaw_encode_mode.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        out = so_path()
        if not out.exists() and not _build(out):
            _failed = True
            return None
        try:
            _lib = _declare(ctypes.CDLL(str(out)))
        except OSError:
            _failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise ImportError("native audio library unavailable (g++ missing "
                          "or the build failed)")
    return lib


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode to (mono float32 in [-1, 1], the file's sample rate)."""
    lib = _require()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.vqa_load_wav(os.fsencode(path), ctypes.byref(out),
                          ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"native wav decode failed (code {rc}): {path}")
    try:
        wav = (np.ctypeslib.as_array(out, shape=(n.value,)).copy()
               if n.value else np.zeros(0, np.float32))
    finally:
        lib.vqa_free(out)
    return wav, sr.value


def mulaw_encode(x: np.ndarray, mu: int = 256,
                 mode: str = "round") -> np.ndarray:
    """Host-side mu-law ids, as ``audio/mu_law.py::mu_law_encode`` gives
    them in the same ``mode`` ("round", or the reference's "chainer"
    binning)."""
    lib = _require()
    if mode not in MULAW_MODES:
        raise ValueError(f"unknown mu-law mode {mode!r}")
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int32)
    lib.vqa_mulaw_encode_mode(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size, mu,
        MULAW_MODES[mode], out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
