"""Serving daemon: a persistent codec process over a UNIX socket, TCP or
HTTP (port of ``vqvae_tpu/cli/serve.py``; console script
``vqvae-torch-serve``).

The wire protocol is the JAX daemon's, byte for byte, so
``vqvae_tpu/client.py::CodecClient`` talks to this daemon unchanged:
newline-delimited JSON, one request per line, answered in order per
connection; audio crosses as base64 int16 PCM at the model rate.

  {"op": "ping"}                          -> model/config info
  {"op": "encode", "pcm16": B64}          -> {"codes": [...]}
  {"op": "decode", "codes": [...], "speaker": 0, "seed": 0,
   "temperature": 1.0, "greedy": false}   -> {"pcm16": B64}
  {"op": "reconstruct", "pcm16": B64, ...decode args}
                                          -> {"pcm16": B64, "codes"}
  {"op": "stats"}                         -> uptime, per-op counters +
                                             latency percentiles
  {"op": "stream_open", "mode": "codes"|"pcm", ...decode args}
  {"op": "stream_push", "session": id, "codes": [...] | "pcm16": B64}
  {"op": "stream_close", "session": id}
  {"op": "shutdown"}

Decode runs through one of two engines (``--engine``), both on the
resumable fused CUDA decode kernel:

- ``kernel`` (the default, and what ``auto`` picks;
  ``infer/kernel_stream``): one kernel call per request, and per session
  push over the condition that push finalized;
- ``stream`` (the JAX daemon's ``stream`` engine): a
  ``StreamingSynthesizer`` (``infer/streaming``) per request or session
  on the weights and upsampler table the daemon packed once, fed
  ``--chunk``-frame pushes and then 1-frame pushes for the tail (a
  session's ``granularity_samples`` is ``chunk * hop``), so a request
  is several kernel calls.

Both run the same kernel, with the same Philox noise indexed by absolute
step, over the same per-code upsampler table, so the two engines'
requests and sessions, and one-shot ``infer/fastgen.decode_from_codes``,
give the same waveform bit for bit, greedy and sampled.  The ``stream``
engine lifts none of the decode kernel's width checks
(``kernels/decode_cuda.py::check_widths``): a model the kernel refuses is
refused by both engines, never routed to a plain decoder on the card.
``ping`` and ``stats`` also report ``engine`` and ``kernel_launches``,
the decode kernel's launch count in this process.  The request's
``seed`` is the kernel's Philox key.

Each connection is answered on a thread of its own and, on a CUDA
device, runs its device work on a CUDA stream of its own.  The session
ops (``stream_open``, ``stream_push``, ``stream_close``) touch only
their session's state and the weights and table nobody writes, so they
take no lock: the pushes of different connections decode side by side
on the card, each row on its own 16-block cluster.  ``encode``,
``decode`` and ``reconstruct`` share the engine's upsampler and take the
daemon's lock.

``--spans`` turns the program's tracing on (``utils/profiling.py``):
every request's spans (``serve.recv``, ``serve.parse``,
``serve.lock_wait`` for the ops that lock, ``serve.handle``,
``stream.*``, ``serve.respond``) share a request id, and ``stats`` gains
``spans`` (per name: count, total ms, p50 and p95 over the span ring)
and ``counters`` (requests by op, pushes, frames in, samples out, lock
acquisitions and waits, ``stream.overlapped``: the pushes and closes
whose decode began while another connection's was under way, spans
dropped, kernel launches).

``--device cuda`` (the default) fails at startup without a GPU; the
daemon never moves to the CPU by itself.  ``--device cpu`` runs the
kernel's plain PyTorch version (for tests and development).
"""

from __future__ import annotations

import argparse
import base64
import itertools
import json
import os
import signal
import socket
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from vqvae_tpu_torch.cli.common import add_config_args, add_device_arg, \
    codec_config, load_params, resolve_device
from vqvae_tpu_torch.infer.enc_streaming import StreamingEncoder
from vqvae_tpu_torch.infer.kernel_stream import (
    KernelStreamDecoder,
    _check_codes,
)
from vqvae_tpu_torch.infer.streaming import StreamingSynthesizer
from vqvae_tpu_torch.kernels import decode_cuda
from vqvae_tpu_torch.utils import profiling
from vqvae_tpu_torch.utils.profiling import counter, overlap, span

ENGINES = ("kernel", "stream")


def pcm16_to_float(b64: str) -> np.ndarray:
    pcm = np.frombuffer(base64.b64decode(b64), "<i2")
    return (pcm.astype(np.float32) / 32767.0).clip(-1.0, 1.0)


def float_to_pcm16(wav: np.ndarray) -> str:
    pcm = np.round(wav.clip(-1.0, 1.0) * 32767.0).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode("ascii")


class Codec:
    """The warm engines behind the socket loop: the streaming encoder
    and the decode engine (``kernel`` or ``stream``), on one device."""

    def __init__(self, params, cfg, chunk: int = 16, engine: str = "kernel",
                 device: str = "cuda"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg, self.chunk, self.engine = cfg, chunk, engine
        self.realtime_x = None           # measure_realtime()
        self.session_realtime_x = None   # measure_session_realtime()
        # weight repack and the upsampler's table, once per daemon
        self._dec = KernelStreamDecoder(self.params, cfg.model)

    def encode(self, wav: np.ndarray) -> np.ndarray:
        # a fresh encoder per request: no state leaks between requests
        enc = StreamingEncoder(self.params, self.cfg.model, self.device)
        pieces = [enc.push(wav[None]), enc.flush()]
        return np.concatenate(pieces, axis=1)[0]

    def decode(self, codes: np.ndarray, speaker: int = 0, seed: int = 0,
               temperature: float = 1.0, greedy: bool = False) -> np.ndarray:
        codes = np.asarray(codes, np.int64)
        if codes.ndim != 1 or codes.size == 0:
            raise ValueError("codes must be a non-empty 1-D id list")
        K = self.cfg.model.K
        if codes.min() < 0 or codes.max() >= K:
            raise ValueError(f"code ids must be in [0, {K})")
        if self.engine == "stream":
            s = self._session_decoder(speaker, seed, temperature, greedy)
            return np.concatenate([s.push(codes[None]), s.close()],
                                  axis=1)[0]
        return self._dec.decode(codes[None], [speaker], seed, temperature,
                                greedy)[0]

    def _session_decoder(self, speaker: int, seed: int, temperature: float,
                         greedy: bool):
        """A fresh decode session on the engine's warm weights."""
        if self.engine == "stream":
            dec = self._dec
            syn = StreamingSynthesizer.from_parts(
                self.cfg.model, dec.gp, dec._prep([speaker]),
                dec._ups.fork(), seed, temperature, greedy)
            return _SynthSession(syn, self.chunk, self.cfg.model.K,
                                 self.device)
        return self._dec.session([speaker], seed, temperature, greedy)

    def measure_realtime(self, reps: int = 3) -> float:
        """Warm decode throughput as a realtime factor (audio seconds
        per wall second, best of ``reps``) on a 2*chunk+1-frame request.
        Below 1.0, live streaming clients will stutter."""
        codes = np.zeros(2 * self.chunk + 1, np.int64)
        audio_s = len(codes) * self.cfg.model.hop / self.cfg.data.sr
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.monotonic()
            self.decode(codes, greedy=True)
            best = min(best, time.monotonic() - t0)
        self.realtime_x = round(audio_s / best, 2)
        return self.realtime_x

    def measure_session_realtime(self, n_push: int = 8) -> float:
        """Sustained session throughput as a realtime factor: p50 wall
        time of a steady ``chunk``-frame push against the audio it
        carries."""
        s = self._session_decoder(0, 0, 1.0, True)
        w = max(1, self.chunk)
        codes = np.zeros((1, w), np.int64)
        audio_s = w * self.cfg.model.hop / self.cfg.data.sr
        push_s = []
        for i in range(n_push + 2):
            t0 = time.monotonic()
            s.push(codes)
            if i >= 2:          # skip fill/warm pushes
                push_s.append(time.monotonic() - t0)
        s.close()
        self.session_realtime_x = round(
            audio_s / float(np.percentile(push_s, 50)), 2)
        return self.session_realtime_x

    def warmup(self) -> None:
        """Build the decode kernel (first CUDA call) and run the request
        and session paths once, greedy and sampled, before accepting
        connections."""
        hop, C = self.cfg.model.hop, self.chunk
        for greedy in (True, False):
            self.decode(np.zeros(2 * C + 1, np.int64), greedy=greedy)
            self.decode(np.zeros(1, np.int64), greedy=greedy)
            s = self._session_decoder(0, 0, 1.0, greedy)
            s.push(np.zeros((1, 2 * C + 1), np.int64))
            s.close()
        self.encode(np.zeros(3 * C * hop + hop + 37, np.float32))


class Stats:
    """Request accounting for the ``stats`` op: per-op counts, error
    counts and latency percentiles over the last 512 requests per op.
    Thread-safe."""

    def __init__(self) -> None:
        self.started = time.monotonic()
        self._lock = threading.Lock()
        self._ops: dict = {}   # op -> [count, errors, deque(ms)]
        self.conn_total = 0
        self.conn_active = 0

    def connection(self, delta: int) -> None:
        with self._lock:
            self.conn_active += delta
            if delta > 0:
                self.conn_total += delta

    def record(self, op: str, ok: bool, ms: float) -> None:
        with self._lock:
            row = self._ops.setdefault(op, [0, 0, deque(maxlen=512)])
            row[0] += 1
            row[1] += 0 if ok else 1
            row[2].append(ms)

    def snapshot(self) -> dict:
        with self._lock:
            ops = {}
            for op, (count, errors, lats) in self._ops.items():
                arr = np.sort(np.asarray(lats))
                q = lambda p: round(  # noqa: E731
                    float(arr[min(len(arr) - 1,
                                  int(p * (len(arr) - 1) + 0.5))]), 2)
                ops[op] = {"count": count, "errors": errors,
                           "ms": {"p50": q(0.50), "p90": q(0.90),
                                  "p99": q(0.99),
                                  "max": round(float(arr[-1]), 2)}}
            out = {"ok": True,
                   "uptime_s": round(time.monotonic() - self.started, 1),
                   "connections": {"active": self.conn_active,
                                   "total": self.conn_total},
                   "kernel_launches": decode_cuda.launches,
                   "ops": ops}
        if profiling.tracing():
            out["spans"] = profiling.span_stats()
            out["counters"] = profiling.counters()
        return out


class _SynthSession:
    """Incremental decode on the ``stream`` engine: each push is host-
    sliced into ``chunk``-frame pushes, then 1-frame pushes for the
    tail, through one ``StreamingSynthesizer`` (as the JAX daemon's
    ``stream`` engine slices); its noise is indexed by absolute step, so
    the concatenated output equals one-shot decode whatever the slicing.
    """

    def __init__(self, syn: StreamingSynthesizer, chunk: int, K: int,
                 device: torch.device):
        self.syn, self.chunk, self.K, self.device = syn, chunk, K, device

    def push(self, codes: np.ndarray) -> np.ndarray:
        codes = torch.from_numpy(_check_codes(codes, self.K)).to(self.device)
        C, n = self.chunk, codes.shape[1]
        steady = n - n % C
        bounds = [(i, i + C) for i in range(0, steady, C)]
        bounds += [(i, i + 1) for i in range(steady, n)]
        pieces = [self.syn.push(codes[:, a:b]) for a, b in bounds]
        if not pieces:
            return np.zeros((codes.shape[0], 0), np.float32)
        return torch.cat(pieces, dim=1).cpu().numpy()

    def close(self) -> np.ndarray:
        return self.syn.flush().cpu().numpy()


class StreamSession:
    """One live codec stream: codes (or PCM through the exact streaming
    encoder) in, waveform out as it finalizes.  Owned by the connection
    that opened it, whose thread and CUDA stream run all its work: it
    writes only its own state (encoder, upsampler carry, decode state)
    and reads the shared weights and table, so it takes no lock and
    decodes beside other connections' sessions."""

    def __init__(self, codec: Codec, mode: str, speaker: int, seed: int,
                 temperature: float, greedy: bool):
        if mode not in ("codes", "pcm"):
            raise ValueError(f"unknown stream mode {mode!r}")
        self.codec, self.mode = codec, mode
        self.enc = None
        if mode == "pcm":
            self.enc = StreamingEncoder(codec.params, codec.cfg.model,
                                        codec.device)
        self.dec = codec._session_decoder(speaker, seed, temperature, greedy)

    @property
    def lookahead_samples(self) -> int:
        """Encoder-side latency floor (0 in codes mode)."""
        return self.enc.lookahead if self.enc is not None else 0

    @property
    def granularity_samples(self) -> int:
        """Decode emission granularity: on the ``kernel`` engine every
        push returns the audio of the code frames it finalized (one frame
        = ``hop`` samples); the ``stream`` engine decodes ``chunk``
        frames at a time."""
        hop = self.codec.cfg.model.hop
        return self.codec.chunk * hop if self.codec.engine == "stream" \
            else hop

    def push(self, req: dict) -> np.ndarray:
        if self.mode == "pcm":
            if "pcm16" not in req:
                raise ValueError("pcm-mode stream_push needs pcm16")
            codes = self.enc.push(pcm16_to_float(req["pcm16"])[None])
        else:
            if "codes" not in req:
                raise ValueError("codes-mode stream_push needs codes")
            codes = np.asarray(req["codes"], np.int64).reshape(1, -1)
        with overlap("stream.overlapped"):
            wav = self.dec.push(codes)
        counter("stream.pushes")
        counter("stream.frames_in", codes.shape[1])
        counter("stream.samples_out", wav.shape[1])
        return wav

    def close(self) -> np.ndarray:
        pieces = []
        with overlap("stream.overlapped"):
            if self.enc is not None:
                tail = self.enc.flush()
                if tail.size:
                    pieces.append(self.dec.push(tail))
            pieces.append(self.dec.close())
        return np.concatenate(pieces, axis=1)


MAX_SESSIONS = 4   # per connection: bounds per-client device state


def _speaker(codec: Codec, req: dict) -> int:
    """Validated speaker id, checked on the host before any device
    indexing (an out-of-range gather on the card is a device assert)."""
    s = int(req.get("speaker", 0))
    n = codec.cfg.model.n_speakers
    if not 0 <= s < n:
        raise ValueError(f"speaker {s} out of range [0, {n})")
    return s


_session_ids = itertools.count(1)


def _stream_ops(codec: Codec, op: str, req: dict, sessions: dict) -> dict:
    """stream_open / stream_push / stream_close.  A push/close that
    raises reaps its session; the error still reaches the client."""
    if op == "stream_open":
        if len(sessions) >= MAX_SESSIONS:
            raise ValueError(
                f"connection already holds {MAX_SESSIONS} sessions")
        s = StreamSession(
            codec, req.get("mode", "codes"), _speaker(codec, req),
            int(req.get("seed", 0)), float(req.get("temperature", 1.0)),
            bool(req.get("greedy", False)))
        sid = str(next(_session_ids))
        sessions[sid] = s
        return {"ok": True, "session": sid, "mode": s.mode,
                "lookahead_samples": s.lookahead_samples,
                "granularity_samples": s.granularity_samples}
    sid = str(req.get("session"))
    s = sessions.get(sid)
    if s is None:
        raise ValueError(f"unknown session {sid!r}")
    try:
        wav = s.push(req) if op == "stream_push" else s.close()
    except Exception:
        sessions.pop(sid, None)
        raise
    if op == "stream_close":
        sessions.pop(sid, None)
    with span("stream.pcm_encode"):
        pcm = float_to_pcm16(wav[0])
    return {"ok": True, "pcm16": pcm, "samples": int(wav.shape[1])}


def handle(codec: Codec, req: dict, stats: Stats | None = None,
           sessions: dict | None = None) -> dict:
    op = req.get("op")
    if op in ("stream_open", "stream_push", "stream_close"):
        if sessions is None:
            return {"ok": False, "error_kind": "client",
                    "error": "streaming requires a socket transport "
                             "(--socket/--tcp), not HTTP"}
        return _stream_ops(codec, op, req, sessions)
    if op == "ping":
        m = codec.cfg.model
        return {"ok": True, "sr": codec.cfg.data.sr, "hop": m.hop,
                "K": m.K, "mu": m.mu, "n_speakers": m.n_speakers,
                "preset": codec.cfg.name, "chunk": codec.chunk,
                "engine": codec.engine, "device": str(codec.device),
                "realtime_x": codec.realtime_x,
                "session_realtime_x": codec.session_realtime_x,
                "kernel_launches": decode_cuda.launches}
    if op == "stats":
        return ({**stats.snapshot(), "engine": codec.engine}
                if stats is not None
                else {"ok": False, "error": "stats unavailable"})
    if op == "encode":
        codes = codec.encode(pcm16_to_float(req["pcm16"]))
        return {"ok": True, "codes": codes.tolist()}
    if op == "decode":
        wav = codec.decode(
            np.asarray(req["codes"], np.int64), _speaker(codec, req),
            int(req.get("seed", 0)), float(req.get("temperature", 1.0)),
            bool(req.get("greedy", False)))
        return {"ok": True, "pcm16": float_to_pcm16(wav),
                "samples": len(wav)}
    if op == "reconstruct":
        codes = codec.encode(pcm16_to_float(req["pcm16"]))
        wav = codec.decode(
            codes, _speaker(codec, req), int(req.get("seed", 0)),
            float(req.get("temperature", 1.0)),
            bool(req.get("greedy", False)))
        return {"ok": True, "pcm16": float_to_pcm16(wav),
                "codes": codes.tolist(), "samples": len(wav)}
    return {"ok": False, "error": f"unknown op {op!r}"}


# ops that take no lock: ping and stats touch no device state, and a
# session op writes only its own session's (StreamSession)
LOCKFREE_OPS = ("ping", "stats", "stream_open", "stream_push",
                "stream_close")


def answer(codec: Codec, req: dict, lock, stats: Stats,
           sessions: dict | None = None) -> dict:
    """One request -> one response, shared by every transport: anything
    a request raises becomes an error response, the ops that use the
    engine's shared upsampler (``encode``, ``decode``, ``reconstruct``)
    are serialized by ``lock``, and wall time (queueing included) lands
    in ``stats``.  ``error_kind`` is 'client' for a bad request and
    'internal' for an engine or device fault.  Its spans are
    ``serve.lock_wait`` (the ops that lock) and ``serve.handle``."""
    t0 = time.monotonic()
    op = req.get("op")
    if profiling.tracing():
        counter(f"serve.requests.{op}")
    try:
        if op in LOCKFREE_OPS:
            with span("serve.handle", op=op):
                resp = handle(codec, req, stats, sessions)
        else:
            with span("serve.lock_wait"):
                if not lock.acquire(blocking=False):
                    counter("serve.lock_waits")
                    lock.acquire()
            counter("serve.lock_acquisitions")
            try:
                with span("serve.handle", op=op):
                    resp = handle(codec, req, stats, sessions)
            finally:
                lock.release()
    except (ValueError, KeyError, TypeError) as exc:
        resp = {"ok": False, "error": repr(exc), "error_kind": "client"}
    except Exception as exc:  # noqa: BLE001 — a bad request
        # must not kill the daemon
        resp = {"ok": False, "error": repr(exc), "error_kind": "internal"}
    stats.record(str(op), bool(resp.get("ok")),
                 (time.monotonic() - t0) * 1e3)
    return resp


MAX_REQUEST_BYTES = 64 << 20   # cap a request line / HTTP body


def _connection_stream(device: torch.device):
    """The CUDA stream of one connection's device work (None off CUDA).
    A pool stream does not wait for the legacy default stream, so it
    waits once here for what start-up queued there (the weights and the
    upsampler's table).  Everything a connection's sessions allocate is
    allocated, used and freed on its stream."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.default_stream(device))
    return stream


def _client_loop(codec: Codec, conn, lock, stop, stats: Stats) -> None:
    """One connection: read lines, answer in order, on the connection's
    own CUDA stream.  Its spans are ``serve.recv`` (waiting for the
    line), ``serve.parse`` and ``serve.respond``, with a new request id
    each line."""
    stats.connection(+1)
    sessions: dict = {}   # this connection's live streams
    stream = _connection_stream(codec.device)
    try:
        with conn, conn.makefile("rwb") as f:
            while True:
                profiling.begin_request()
                with span("serve.recv"):
                    line = f.readline(MAX_REQUEST_BYTES + 1)
                if not line:
                    break
                if len(line) > MAX_REQUEST_BYTES:
                    f.write(json.dumps(
                        {"ok": False,
                         "error": "request exceeds "
                                  f"{MAX_REQUEST_BYTES} bytes"}
                    ).encode() + b"\n")
                    f.flush()
                    return
                if not line.strip():
                    continue
                try:
                    with span("serve.parse"):
                        req = json.loads(line)
                except ValueError as exc:
                    resp = {"ok": False, "error": repr(exc)}
                else:
                    if req.get("op") == "shutdown":
                        f.write(b'{"ok": true}\n')
                        f.flush()
                        stop.set()
                        return
                    with torch.cuda.stream(stream):
                        resp = answer(codec, req, lock, stats, sessions)
                with span("serve.respond"):
                    f.write(json.dumps(resp).encode() + b"\n")
                    f.flush()
    except OSError:
        return  # idle timeout or client went away mid-line
    finally:
        stats.connection(-1)


def _bind(path: str | None, tcp: str | None):
    """A listening socket: UNIX at ``path`` or TCP at ``host:port``."""
    if tcp:
        host, port = tcp.rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "127.0.0.1", int(port)))
        return srv, f"tcp://{host or '127.0.0.1'}:{port}", None
    if os.path.exists(path):
        # only remove a STALE socket: a live daemon keeps it
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.connect(path)
        except OSError:
            os.unlink(path)
        else:
            raise SystemExit(f"a daemon is already listening on {path}")
        finally:
            probe.close()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    return srv, path, path


def serve(codec: Codec, path: str | None, idle_timeout: float = 300.0,
          tcp: str | None = None) -> None:
    srv, label, unlink = _bind(path, tcp)
    srv.listen(16)
    srv.settimeout(0.2)   # wake up to notice a shutdown
    lock, stop, stats = threading.Lock(), threading.Event(), Stats()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    print(f"ready on {label}", flush=True)
    try:
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(idle_timeout)
            threading.Thread(target=_client_loop,
                             args=(codec, conn, lock, stop, stats),
                             daemon=True).start()
    finally:
        srv.close()
        if unlink and os.path.exists(unlink):
            os.unlink(unlink)


def serve_http(codec: Codec, hostport: str,
               idle_timeout: float = 300.0) -> None:
    """The same ops over HTTP/1.1: GET /ping /stats /healthz, POST
    /encode /decode /reconstruct /shutdown with JSON bodies."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock, stats = threading.Lock(), Stats()
    host, port = hostport.rsplit(":", 1)
    host = host or "127.0.0.1"

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = idle_timeout

        def log_message(self, *args):   # latency lives in /stats
            pass

        def setup(self):
            super().setup()
            stats.connection(+1)

        def finish(self):
            stats.connection(-1)
            super().finish()

        def _send(self, status: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self, op: str, req: dict) -> None:
            if op == "shutdown":
                self._send(200, {"ok": True})
                threading.Thread(target=httpd.shutdown, daemon=True).start()
                return
            req["op"] = op
            profiling.begin_request()
            resp = answer(codec, req, lock, stats)
            status = (200 if resp.get("ok")
                      else 500 if resp.get("error_kind") == "internal"
                      else 400)
            self._send(status, resp)

        def do_GET(self):
            op = self.path.lstrip("/").split("?")[0]
            if op == "healthz":
                op = "ping"
            if op not in ("ping", "stats"):
                self._send(404, {"ok": False,
                                 "error": f"unknown path {self.path!r}"})
                return
            self._dispatch(op, {})

        def do_POST(self):
            op = self.path.lstrip("/").split("?")[0]
            if op not in ("encode", "decode", "reconstruct", "ping",
                          "stats", "shutdown"):
                self._send(404, {"ok": False,
                                 "error": f"unknown path {self.path!r}"})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                if n < 0:
                    self._send(400, {"ok": False,
                                     "error": "negative Content-Length"})
                    self.close_connection = True
                    return
                if n > MAX_REQUEST_BYTES:
                    self._send(413, {"ok": False,
                                     "error": "request exceeds "
                                              f"{MAX_REQUEST_BYTES} bytes"})
                    self.close_connection = True
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as exc:
                self._send(400, {"ok": False, "error": repr(exc)})
                return
            self._dispatch(op, req)

    httpd = ThreadingHTTPServer((host, int(port)), Handler)
    httpd.daemon_threads = True
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    print(f"ready on http://{host}:{int(port)}", flush=True)
    try:
        httpd.serve_forever(poll_interval=0.2)
    finally:
        httpd.server_close()


def main() -> None:
    p = argparse.ArgumentParser(
        description="Persistent VQ-VAE codec daemon on PyTorch/CUDA "
                    "(UNIX socket, TCP or HTTP)")
    add_config_args(p)
    p.add_argument("-m", "--model", required=True,
                   help="weights-only .npz (export_weights of either "
                        "package) or a port training run dir")
    p.add_argument("--socket", help="UNIX socket path to listen on")
    p.add_argument("--tcp", metavar="HOST:PORT",
                   help="listen on TCP instead of a UNIX socket")
    p.add_argument("--http", metavar="HOST:PORT",
                   help="serve the same ops over HTTP/1.1 instead")
    add_device_arg(p)
    p.add_argument("--chunk", type=int, default=16,
                   help="code frames of the realtime probes (a "
                        "2*chunk+1-frame request and chunk-frame session "
                        "pushes) and of the stream engine's pushes")
    p.add_argument("--engine", choices=("auto",) + ENGINES, default="auto",
                   help="decode engine: 'kernel' = one resumable fused "
                        "CUDA decode kernel call per request or push "
                        "('auto' picks it); 'stream' = a streaming "
                        "synthesizer on the same kernel, --chunk frames "
                        "a push")
    p.add_argument("--idle-timeout", type=float, default=300.0,
                   help="disconnect a client after this many idle seconds")
    p.add_argument("--spans", action="store_true",
                   help="record the program's spans and counters, "
                        "reported by the stats op")
    args = p.parse_args()
    if sum(map(bool, (args.socket, args.tcp, args.http))) != 1:
        p.error("exactly one of --socket, --tcp or --http is required")

    device = resolve_device(args.device)   # fail before loading weights
    cfg = codec_config(args, "vqvae-torch-serve")
    params = load_params(args.model, cfg, device)
    engine = "kernel" if args.engine == "auto" else args.engine
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"decode engine: {engine} on {device} ({name})", flush=True)
    codec = Codec(params, cfg, args.chunk, engine, device)
    print("warming serving shapes...", flush=True)
    codec.warmup()
    rt = codec.measure_realtime()
    srt = codec.measure_session_realtime()
    print(f"decode realtime factor: {rt}x, sustained session pushes: "
          f"{srt}x at {codec.chunk} frames/push "
          f"(engine={engine}, device={name})", flush=True)
    if rt < 1.0:
        print(f"WARNING: decode is below realtime ({rt}x) — live "
              "streaming clients will stutter", flush=True)
    if srt < 1.0:
        print(f"WARNING: sustained session pushes are below realtime "
              f"({srt}x at {codec.chunk} frames) — live streams "
              "will stutter", flush=True)
    profiling.set_tracing(args.spans)
    if args.http:
        serve_http(codec, args.http, args.idle_timeout)
    else:
        serve(codec, args.socket, args.idle_timeout, args.tcp)


if __name__ == "__main__":
    main()
