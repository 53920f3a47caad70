"""The port's native audio library (vqvae_tpu_torch/native) against the
JAX package's library built from its own source (vqvae_tpu/native/
audio.cpp), against scipy and against the port's mu-law.

One case for each of tests/test_native.py's tests; the JAX library is
compiled here into the test's own directory (never into
vqvae_tpu/native/), so this file builds nothing in the JAX package.
"""

import ctypes
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vqvae_tpu_torch.audio import wav_io
from vqvae_tpu_torch.audio.mu_law import mu_law_encode
from vqvae_tpu_torch.native import bindings as nat

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler on this machine")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(ROOT, "vqvae_tpu", "native", "audio.cpp")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's audio.cpp, built with its own flags into a
    private directory and bound as vqvae_tpu/native/bindings.py binds it."""
    out = str(tmp_path_factory.mktemp("jax_native") / "libjax_audio.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o",
                    out, JAX_SRC], check=True, capture_output=True,
                   timeout=120)
    return nat._declare(ctypes.CDLL(out))


def jax_load_wav(lib, path):
    out = ctypes.POINTER(ctypes.c_float)()
    n, sr = ctypes.c_int64(), ctypes.c_int()
    rc = lib.vqa_load_wav(path.encode(), ctypes.byref(out), ctypes.byref(n),
                          ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"native wav decode failed (code {rc}): {path}")
    try:
        wav = (np.ctypeslib.as_array(out, shape=(n.value,)).copy()
               if n.value else np.zeros(0, np.float32))
    finally:
        lib.vqa_free(out)
    return wav, sr.value


def _tone(sr=16000, secs=0.3):
    t = np.arange(int(sr * secs)) / sr
    return (0.5 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)


def _write(tmp_path, name, sr, data):
    p = str(tmp_path / name)
    wavfile.write(p, sr, data)
    return p


def _both(jax_lib, p):
    """The port's decode, held bit for bit against JAX's library's."""
    assert nat.available()
    got, sr = nat.load_wav(p)
    want, jsr = jax_load_wav(jax_lib, p)
    assert sr == jsr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    return got, sr


def test_native_decode_int16_mono(tmp_path, jax_lib):
    wav = _tone()
    p = _write(tmp_path, "a.wav", 16000, (wav * 32767).astype(np.int16))
    out, sr = _both(jax_lib, p)
    assert sr == 16000 and out.shape == wav.shape
    assert np.max(np.abs(out - wav)) < 2e-4
    # scipy's path gives the same bits on mono int16 (/32768 is exact)
    _, data = wavfile.read(p)
    np.testing.assert_array_equal(out, data.astype(np.float32) / 32768.0)


def test_native_decode_stereo_downmix(tmp_path, jax_lib):
    wav = _tone()
    stereo = np.stack([wav, 0.5 * wav], 1)
    p = _write(tmp_path, "s.wav", 16000, (stereo * 32767).astype(np.int16))
    out, _ = _both(jax_lib, p)
    assert np.max(np.abs(out - 0.75 * wav)) < 3e-4


def test_native_decode_float32(tmp_path, jax_lib):
    wav = _tone()
    p = _write(tmp_path, "f.wav", 22050, wav)
    out, sr = _both(jax_lib, p)
    assert sr == 22050
    assert np.max(np.abs(out - wav)) < 1e-6


def test_native_decode_int32(tmp_path, jax_lib):
    wav = _tone()
    p = _write(tmp_path, "i32.wav", 16000,
               (wav * 2147483000).astype(np.int32))
    out, _ = _both(jax_lib, p)
    assert np.max(np.abs(out - wav)) < 1e-5


def test_native_serves_wav_io_pipeline(tmp_path):
    """wav_io.load_wav decodes through the native library when it builds
    (the decoder counter says so) and equals the scipy path."""
    wav = _tone()
    p = str(tmp_path / "w.wav")
    wav_io.save_wav(p, wav, 16000)
    before = dict(wav_io.decoders)
    via_pipeline = wav_io.load_wav(p, 16000)
    assert wav_io.decoders["native"] == before["native"] + 1
    assert wav_io.decoders["scipy"] == before["scipy"]
    _, data = wavfile.read(p)
    np.testing.assert_array_equal(via_pipeline,
                                  data.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("mode,seed", [("round", 0), ("chainer", 1)])
def test_native_mulaw_matches_port_mu_law(mode, seed):
    x = np.random.default_rng(seed).uniform(-1.2, 1.2, 5000) \
        .astype(np.float32)
    want = mu_law_encode(torch.from_numpy(x), 256, mode).numpy()
    got = nat.mulaw_encode(x, 256, mode=mode)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if mode == "chainer":   # the two modes differ (companding constant)
        assert (nat.mulaw_encode(x, 256) != got).any()


def test_native_mulaw_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        nat.mulaw_encode(np.zeros(4, np.float32), 256, mode="nope")


def test_native_bad_file(tmp_path):
    p = str(tmp_path / "bad.wav")
    with open(p, "wb") as f:
        f.write(b"not a wav file at all, definitely not")
    with pytest.raises(ValueError):
        nat.load_wav(p)


def test_native_decoder_rejects_malformed_files(tmp_path, jax_lib):
    """Malformed inputs come back as error codes (ValueError), the same
    code in both libraries, never a crash or a garbage buffer."""

    def attempt(name, payload):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(payload)
        errs = []
        for load in (nat.load_wav, lambda q: jax_load_wav(jax_lib, q)):
            try:
                load(p)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]
        return errs[0]

    assert attempt("short.wav", b"RIFF") is not None
    assert attempt("garbage.wav", bytes(range(100)) * 2) is not None
    assert attempt("empty.wav", b"RIFF" + struct.pack("<I", 36) + b"WAVE"
                   + b"\x00" * 64) is not None
    fmt = struct.pack("<HHIIHH", 2, 1, 16000, 16000, 1, 8)   # ADPCM
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 4) + b"\x00" * 4)
    assert attempt("adpcm.wav",
                   b"RIFF" + struct.pack("<I", len(body)) + body) is not None
    # a data chunk longer than the file: the clamped prefix decodes
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 1 << 20) + b"\x00" * 64)
    p = str(tmp_path / "trunc.wav")
    with open(p, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    wav, sr = _both(jax_lib, p)
    assert sr == 16000 and len(wav) == 32
    assert np.all(np.isfinite(wav))


def test_build_lands_in_build_dir_only(tmp_path):
    """A fresh process builds the library under build_dir() (here
    $VQVAE_TORCH_BUILD_DIR) and writes nothing anywhere else: every file
    it opens for writing and the compiler's output lie under that
    directory, none under vqvae_tpu/native/."""
    bdir = tmp_path / "build"
    wav = str(tmp_path / "t.wav")
    wavfile.write(wav, 16000, (_tone() * 32767).astype(np.int16))
    code = (
        "import sys, json\n"
        "seen = []\n"
        "def hook(ev, args):\n"
        "    if ev == 'open' and args[1] and any(c in str(args[1])\n"
        "                                       for c in 'wax+'):\n"
        "        seen.append(('open', str(args[0])))\n"
        "    elif ev in ('os.mkdir', 'os.rename'):\n"
        "        seen.append((ev, str(args[1] if ev == 'os.rename'\n"
        "                             else args[0])))\n"
        "    elif ev == 'subprocess.Popen' and '-o' in args[1]:\n"
        "        a = [str(x) for x in args[1]]\n"
        "        seen.append(('cc', a[a.index('-o') + 1]))\n"
        "sys.addaudithook(hook)\n"
        "from vqvae_tpu_torch.native import bindings as b\n"
        "from vqvae_tpu_torch.audio import wav_io\n"
        f"wav_io.load_wav({wav!r})\n"
        "print(json.dumps([str(b.so_path()), wav_io.decoders, seen]))\n")
    env = dict(os.environ, VQVAE_TORCH_BUILD_DIR=str(bdir),
               PYTHONDONTWRITEBYTECODE="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    so, decoders, seen = json.loads(r.stdout.strip().splitlines()[-1])
    assert os.path.dirname(so) == str(bdir) and os.path.isfile(so)
    assert decoders == {"native": 1, "scipy": 0}
    assert any(kind == "cc" for kind, _ in seen), seen
    jax_native = os.path.join(ROOT, "vqvae_tpu", "native")
    for kind, path in seen:
        path = os.path.abspath(path)
        if path == os.devnull:     # the compiler's stdin
            continue
        assert not path.startswith(jax_native), (kind, path)
        assert path.startswith(str(bdir)), (kind, path)
