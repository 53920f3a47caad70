"""Python client for the ``vqvae-torch-serve`` codec daemon (the port's
own copy of ``vqvae_tpu/client.py``: the same API and wire protocol,
with no import of JAX or of the JAX package, so it runs where JAX is
not installed).

The daemon (``cli/serve.py``) speaks newline-delimited JSON with base64
int16 PCM audio over a UNIX socket or TCP; this wraps that wire
protocol in a numpy in/out API so applications never touch it:

    from vqvae_tpu_torch.client import CodecClient

    with CodecClient(socket_path="/tmp/codec.sock") as c:
        info  = c.ping()                      # sr, hop, K, n_speakers...
        codes = c.encode(wav)                 # float32 [T] -> int32 [T/hop]
        out   = c.decode(codes, speaker=3)    # int32 [n]   -> float32 [n*hop]
        out, codes = c.reconstruct(wav, seed=7)

Served outputs equal the library's one-shot engines up to the int16 PCM
transport (+-1/32767).  One request at a time per client; open several
clients for pipelined use: the daemon serves connections concurrently
and serializes device work itself.  The daemon answers either package's
client.
"""

from __future__ import annotations

import base64
import json
import socket

import numpy as np


def _encode_pcm16(wav: np.ndarray) -> str:
    pcm = np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode("ascii")


def _decode_pcm16(b64: str) -> np.ndarray:
    pcm = np.frombuffer(base64.b64decode(b64), "<i2")
    return pcm.astype(np.float32) / 32767.0


class ServerError(RuntimeError):
    """The daemon answered ``{"ok": false, ...}``."""


class CodecClient:
    """One connection to a running ``vqvae-torch-serve`` (or
    ``vqvae-serve``) daemon."""

    def __init__(self, socket_path: str | None = None,
                 tcp: str | None = None, timeout: float = 600.0):
        if bool(socket_path) == bool(tcp):
            raise ValueError("exactly one of socket_path/tcp required")
        if tcp:
            host, port = tcp.rsplit(":", 1)
            self._sock = socket.create_connection(
                (host, int(port)), timeout=timeout)
        else:
            self._sock = socket.socket(socket.AF_UNIX,
                                       socket.SOCK_STREAM)
            self._sock.settimeout(timeout)
            self._sock.connect(socket_path)
        self._f = self._sock.makefile("rwb")

    def _request(self, req: dict) -> dict:
        self._f.write(json.dumps(req).encode() + b"\n")
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("daemon closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ServerError(resp.get("error", repr(resp)))
        return resp

    def ping(self) -> dict:
        """Model/config info: sr, hop, K, mu, n_speakers, preset, chunk."""
        return self._request({"op": "ping"})

    def encode(self, wav: np.ndarray) -> np.ndarray:
        """float32 waveform ``[T]`` in [-1, 1] -> int32 code ids
        ``[T // hop]`` (input is hop-trimmed, as the one-shot CLI)."""
        r = self._request({"op": "encode",
                           "pcm16": _encode_pcm16(np.asarray(wav))})
        return np.asarray(r["codes"], np.int32)

    def decode(self, codes, speaker: int = 0, seed: int = 0,
               temperature: float = 1.0,
               greedy: bool = False) -> np.ndarray:
        """int32 code ids ``[n]`` -> float32 waveform ``[n * hop]``."""
        r = self._request({
            "op": "decode",
            "codes": np.asarray(codes, np.int32).tolist(),
            "speaker": int(speaker), "seed": int(seed),
            "temperature": float(temperature), "greedy": bool(greedy),
        })
        return _decode_pcm16(r["pcm16"])

    def reconstruct(self, wav: np.ndarray, speaker: int = 0,
                    seed: int = 0, temperature: float = 1.0,
                    greedy: bool = False):
        """encode + decode in one request -> (waveform, code ids)."""
        r = self._request({
            "op": "reconstruct",
            "pcm16": _encode_pcm16(np.asarray(wav)),
            "speaker": int(speaker), "seed": int(seed),
            "temperature": float(temperature), "greedy": bool(greedy),
        })
        return _decode_pcm16(r["pcm16"]), np.asarray(r["codes"],
                                                     np.int32)

    def stats(self) -> dict:
        """Daemon accounting: uptime, connection counts, per-op
        request/error counts and latency percentiles (ms)."""
        return self._request({"op": "stats"})

    def open_stream(self, mode: str = "codes", speaker: int = 0,
                    seed: int = 0, temperature: float = 1.0,
                    greedy: bool = False) -> "StreamHandle":
        """Open a live decode stream (mode='codes') or full-duplex
        codec stream (mode='pcm'): audio comes back push by push, so
        time-to-first-audio is one push rather than a whole request.
        The concatenated stream output is bit-identical to the
        one-shot decode of the same codes at equal seed."""
        r = self._request({
            "op": "stream_open", "mode": mode, "speaker": int(speaker),
            "seed": int(seed), "temperature": float(temperature),
            "greedy": bool(greedy)})
        return StreamHandle(self, r)

    def shutdown(self) -> None:
        """Ask the daemon to exit (it confirms, then stops)."""
        self._request({"op": "shutdown"})

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "CodecClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StreamHandle:
    """One live stream on a client connection (``open_stream``).

    >>> with c.open_stream(greedy=True) as s:
    ...     pieces = [s.push_codes(chunk) for chunk in chunks]
    ...     pieces.append(s.close())
    >>> np.concatenate(pieces)   # == one-shot decode
    """

    def __init__(self, client: CodecClient, opened: dict):
        self._c = client
        self.session = opened["session"]
        self.mode = opened["mode"]
        # encoder lookahead (pcm mode) and decode emission granularity,
        # both in samples — the stream's structural latency floor
        self.lookahead_samples = opened["lookahead_samples"]
        self.granularity_samples = opened["granularity_samples"]
        self._open = True

    def push_codes(self, codes) -> np.ndarray:
        """codes-mode push: int32 ids ``[n]`` -> newly finalized
        float32 waveform (may be empty while a kernel slice fills)."""
        r = self._c._request({
            "op": "stream_push", "session": self.session,
            "codes": np.asarray(codes, np.int32).tolist()})
        return _decode_pcm16(r["pcm16"])

    def push_pcm(self, wav: np.ndarray) -> np.ndarray:
        """pcm-mode push: float32 waveform in -> finalized waveform
        out (runs the exact streaming encoder daemon-side)."""
        r = self._c._request({
            "op": "stream_push", "session": self.session,
            "pcm16": _encode_pcm16(np.asarray(wav))})
        return _decode_pcm16(r["pcm16"])

    def close(self) -> np.ndarray:
        """Flush: the final samples the stream was holding back."""
        self._open = False
        r = self._c._request({"op": "stream_close",
                              "session": self.session})
        return _decode_pcm16(r["pcm16"])

    def __enter__(self) -> "StreamHandle":
        return self

    def __exit__(self, *exc) -> None:
        if self._open:
            try:
                self.close()
            except (ServerError, ConnectionError, OSError):
                pass
