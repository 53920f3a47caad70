"""Host-side wav decode / resample / silence trim (port of
``vqvae_tpu/audio/wav_io.py``).

Decoding goes through the port's native C++ decoder
(``vqvae_tpu_torch/native``, built with g++ at first use) when it
builds, and through ``scipy.io.wavfile`` otherwise, as the JAX
package's does.  ``decoders`` counts the loads each one served in this
process.  The two agree bit for bit on mono int16 (``x / 32768`` is
exact either way); on a stereo file the native downmix averages in
double, scipy's in the file's dtype or float64.  Resampling is polyphase
(``scipy.signal.resample_poly``); trimming is the energy gate of
``librosa.effects.trim`` with ``top_db``.
"""

from __future__ import annotations

import threading

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from vqvae_tpu_torch.native import bindings as _native

# loads served by each decoder in this process (the loader's threads
# share it, hence the lock)
decoders = {"native": 0, "scipy": 0}
_decoders_lock = threading.Lock()


def load_wav(path: str, sr: int = 16000) -> np.ndarray:
    """Load a wav file as mono float32 in [-1, 1] at sample rate ``sr``."""
    if _native.available():
        data, file_sr = _native.load_wav(path)
        served = "native"
    else:
        file_sr, data = wavfile.read(path)
        served = "scipy"
    with _decoders_lock:
        decoders[served] += 1
    wav = _to_float_mono(data)
    if file_sr != sr:
        g = np.gcd(int(file_sr), int(sr))
        wav = resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
    return np.clip(wav, -1.0, 1.0)


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    if data.ndim == 2:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    return wav


def save_wav(path: str, wav: np.ndarray, sr: int = 16000) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    pcm = np.clip(np.asarray(wav, dtype=np.float64), -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))


def trim_silence(wav: np.ndarray, top_db: float = 20.0,
                 frame_length: int = 2048, hop_length: int = 512
                 ) -> np.ndarray:
    """Trim leading and trailing silence as ``librosa.effects.trim``
    does: drop the frames whose RMS power is more than ``top_db`` below
    the loudest frame's."""
    if wav.size == 0:
        return wav
    n = 1 + max(0, (len(wav) - frame_length)) // hop_length
    if n <= 1:
        return wav
    idx = np.arange(frame_length)[None, :] + \
        hop_length * np.arange(n)[:, None]
    frames = wav[np.minimum(idx, len(wav) - 1)]
    rms = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return wav
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    keep = np.nonzero(db > -top_db)[0]
    if keep.size == 0:
        return wav
    start = keep[0] * hop_length
    end = min(len(wav), keep[-1] * hop_length + frame_length)
    return wav[start:end]
