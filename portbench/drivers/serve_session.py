"""Streaming-session traffic: clients of the program's daemon
(``vqvae-torch-serve --engine kernel``, started by ``drivers/daemon.py``
in its own process) stream sessions of codes through
``client.py::StreamHandle.push_codes`` as live streams do: a client's
codes arrive at ``rate_x`` times realtime, so push i of its schedule is
due ``i * push_frames * hop / sr / rate_x`` seconds after the window
opens, and is sent at its due time or, where the previous push has not
returned yet, when it returns (one request at a time on a connection).
A push's time runs from its due time, so the wait a late answer imposes
on the pushes after it counts.  A session's close and the next one's
open follow at once.

Every seed gives each client the same set of session lengths in another
order; speakers, codes and the sampled sessions' noise keys come from
the seed.  Every ``greedy_every``-th session of a client, the first
included, decodes greedily: the reference judges those sessions' served
audio after the run.
"""

from __future__ import annotations

import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np

from portbench import harness, trace
from portbench.drivers.train import summarize

READY_S = 1200.0    # the first start in a checkout builds the kernel


def plans(traffic: dict, m: dict, sr: int, seed: int) -> list:
    """Each client's sessions, in order: (frames, speaker, greedy, key,
    codes)."""
    hop = m["enc_stride"] ** m["enc_layers"]
    lo, hi = traffic["session_seconds"]
    n = traffic["sessions_per_client"]
    lengths = np.linspace(lo, hi, n)
    out = []
    for c in range(traffic["clients"]):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 11, c]))
        sessions = []
        for i, sec in enumerate(rng.permutation(lengths)):
            frames = int(round(sec * sr / hop))
            sessions.append(SimpleNamespace(
                frames=frames, greedy=i % traffic["greedy_every"] == 0,
                speaker=int(rng.integers(m["n_speakers"])),
                key=int(rng.integers(1 << 31)),
                codes=rng.integers(0, m["K"], frames)))
        out.append(sessions)
    return out


class Client:
    """One connection working through its sessions; records every push
    and close with its send and receive times."""

    def __init__(self, where: dict, sessions: list, push: int, temp: float,
                 hop: int, period: float = 0.0):
        from vqvae_tpu_torch.client import CodecClient
        self.c = CodecClient(**where)
        self.sessions, self.push, self.temp, self.hop = \
            sessions, push, temp, hop
        self.period, self.due = period, None
        self.i, self.at, self.h = 0, 0, None
        self.pushes: list = []     # (due, t_recv, samples, expected)
        self.closes: list = []     # (t_send, t_recv, samples)
        self.served: dict = {}     # session index -> [pcm16 pieces]
        self.errors = 0

    def _open(self) -> None:
        s = self.sessions[self.i % len(self.sessions)]
        self.h = self.c.open_stream(speaker=s.speaker, seed=s.key,
                                    temperature=self.temp, greedy=s.greedy)
        self.at = 0
        self.served.setdefault(self.i, [])

    def one(self) -> None:
        """The next request: a push, or a close at a session's end."""
        from vqvae_tpu_torch.client import ServerError
        if self.h is None:
            self._open()
        s = self.sessions[self.i % len(self.sessions)]
        t0 = time.perf_counter()
        try:
            if self.at < s.frames:
                due, self.due = self.due, self.due + self.period
                if due > t0:
                    time.sleep(due - t0)
                codes = s.codes[self.at:self.at + self.push]
                wav = self.h.push_codes(codes)
                exp = len(codes) * self.hop - (self.hop // 2
                                              if self.at == 0 else 0)
                self.pushes.append((due, time.perf_counter(), len(wav), exp))
                self.at += len(codes)
            else:
                wav = self.h.close()
                self.closes.append((t0, time.perf_counter(), len(wav)))
                self.h, self.i = None, self.i + 1
        except (ServerError, ConnectionError, OSError):
            self.errors += 1
            self.h, self.i = None, self.i + 1
            return
        self.served[self.i - (self.h is None)].append(wav)

    def until(self, start: float, deadline: float) -> None:
        """Requests until ``deadline``, the schedule starting at
        ``start``; a push due at or after the deadline is not sent."""
        self.due = start
        while time.perf_counter() < deadline and self.due < deadline:
            self.one()


def window_rates(pushes, closes, t0: float, sr: int):
    """(seconds of audio returned over the window's seconds, the 95th
    percentile of the push times in ms) over every push and close sent
    in the window; the window runs from ``t0`` to the last answer, so a
    stall anywhere in it counts in both.  A push is (due, receive,
    samples, ...), a close (send, receive, samples), on one clock."""
    t_end = max(p[1] for p in list(pushes) + list(closes))
    samples = sum(p[2] for p in pushes) + sum(p[2] for p in closes)
    return (samples / sr / (t_end - t0),
            harness.p95([1e3 * (p[1] - p[0]) for p in pushes]))


def _all(clients, start: float, deadline: float) -> None:
    """Every client on a thread of its own until ``deadline``; a client
    that raised raises here."""
    errors: list = []

    def work(c):
        try:
            c.until(start, deadline)
        except BaseException as exc:  # re-raised below, in the caller
            errors.append(exc)
    ts = [threading.Thread(target=work, args=(c,)) for c in clients]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]


class Daemon:
    """The daemon process and the lines it prints."""

    def __init__(self, ctx, tmp: str):
        conf_path = os.path.join(tmp, "config.json")
        with open(conf_path, "w") as f:
            import json
            json.dump(ctx.config, f)
        self.weights = os.path.join(tmp, "weights.npz")
        sock = os.path.join(tmp, "d.sock")
        if len(sock) < 100:
            self.where, flag = {"socket_path": sock}, ["--socket", sock]
        else:                       # a UNIX socket path has 108 bytes
            import socket
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            tcp = f"127.0.0.1:{port}"
            self.where, flag = {"tcp": tcp}, ["--tcp", tcp]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(harness.ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.drivers.daemon", "--config",
             conf_path, "--seed", str(ctx.seed), "--weights", self.weights,
             "--device", ctx.device, *flag],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=str(harness.ROOT), env=env)
        self.lines: queue.Queue = queue.Queue()
        self.tail: list = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.tail = (self.tail + [line.rstrip()])[-40:]
            self.lines.put(line.rstrip())
        self.lines.put(None)

    def wait_for(self, prefix: str, timeout: float) -> str:
        end = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                raise RuntimeError("daemon: no line starting "
                                   f"{prefix!r}; its last lines:\n"
                                   + "\n".join(self.tail))
            if line.startswith(prefix):
                return line

    def command(self, cmd: str, timeout: float = 120.0) -> str:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self.wait_for("portbench: ", timeout)[len("portbench: "):]

    def stop(self, client) -> None:
        try:
            client.shutdown()
        except (OSError, ConnectionError):
            pass
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def run(ctx) -> dict:
    tr, m = ctx.traffic, ctx.config["model"]
    sr = ctx.config["data"]["sr"]
    hop = m["enc_stride"] ** m["enc_layers"]
    tmp = tempfile.mkdtemp(prefix="pb-", dir=ctx.tmp)
    daemon = None
    try:
        daemon = Daemon(ctx, tmp)
        work = plans(tr, m, sr, ctx.seed)
        daemon.wait_for("ready on", READY_S)
        warm = [Client(daemon.where, [SimpleNamespace(
            frames=tr["warm_pushes"] * tr["push_frames"], greedy=g,
            speaker=0, key=1, codes=np.zeros(tr["warm_pushes"]
                                             * tr["push_frames"], np.int64))
            for g in (True, False)], tr["push_frames"], tr["temperature"],
            hop) for _ in work]
        for c in warm:                 # both kinds of session, on each link
            c.due = time.perf_counter()
            while c.i < 2:
                c.one()
            c.c.close()
        period = tr["push_frames"] * hop / sr / tr["rate_x"]
        clients = [Client(daemon.where, s, tr["push_frames"],
                          tr["temperature"], hop, period) for s in work]
        daemon.command("reset_mem")
        t0 = time.perf_counter()
        setup_s = time.monotonic() - ctx.t_start
        _all(clients, t0, t0 + ctx.seconds)
        pushes = [p for c in clients for p in c.pushes]
        closes = [p for c in clients for p in c.closes]
        realtime_x, p95_ms = window_rates(pushes, closes, t0, sr)
        stats = clients[0].c.stats()["ops"].get("stream_push", {})
        obs = {"kind": "serve",
               "daemon_push_ms": stats.get("ms", {}).get("p50"),
               "client_push_ms": float(np.median(
                   [1e3 * (b - a) for a, b, _, _ in pushes]))}
        capture = None
        if ctx.trace:
            capture = _capture(daemon, clients, tr["trace_seconds"], tmp)
            obs["capture"] = capture
        peak = int(daemon.command("mem"))
        daemon.stop(clients[0].c)
        for c in clients:
            c.c.close()
        wrong = sum(p[2] != p[3] for p in pushes)
        failed = wrong + sum(c.errors for c in clients)
        gap, control = _reference(ctx, daemon.weights, clients, hop)
        from portbench import compare
        checks = compare.checks({"logit_gap": gap,
                                 "failed_pushes": float(failed)},
                                {**ctx.limits, "failed_pushes": 0.0})
        return {"correct": harness.checks_pass(checks),
                "attempted": len(pushes), "failed": failed,
                "e2e": {"decode_realtime_x": realtime_x,
                        "push_p95_ms": p95_ms, "setup_s": setup_s},
                "obs": obs, "peak_bytes": peak, "capture": capture,
                "checks": checks, "control": control}
    finally:
        if daemon is not None and daemon.proc.poll() is None:
            daemon.proc.kill()
            daemon.proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _capture(daemon: Daemon, clients, seconds: float, tmp: str) -> dict:
    """The traffic goes on for ``seconds`` under a profiler in the
    daemon's process; the samples of the requests answered inside it
    divide the decode kernel's time.  The device serves one request at a
    time, so at each edge at most one request is counted whose kernel
    lies outside, or left out whose kernel lies inside."""
    path = os.path.join(tmp, "daemon_trace.json")
    daemon.command(f"trace_start {path}")
    a = time.perf_counter()
    _all(clients, a, a + seconds)
    b = time.perf_counter()
    daemon.command("trace_stop", timeout=300.0)
    cap = summarize(trace.load(path), 1)
    cap["samples"] = sum(p[2] for c in clients for p in c.pushes + c.closes
                         if a <= p[1] <= b)
    return cap


def _reference(ctx, weights_path: str, clients, hop: int):
    """(the widest logit gap of the greedy sessions' served ids, or None
    where no greedy audio was served; with ``ctx.control``, the
    control's widest gap and an altered token's median gap, else None).
    """
    import torch

    from portbench.reference import model as ref
    from portbench.reference import serve as rs

    ref.strict_float32()
    dev = torch.device(ctx.device)
    with np.load(weights_path) as z:
        p = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
    m = ctx.config["model"]
    control = getattr(ctx, "control", False)
    gaps, fp8, altered = [], [], []
    for c in clients:
        for i, pieces in c.served.items():
            s = c.sessions[i % len(c.sessions)]
            pcm = np.round(np.concatenate(pieces or [np.zeros(0)])
                           * 32767.0).astype(np.int16)
            if not s.greedy or not len(pcm):
                continue
            ids = torch.from_numpy(rs.pcm16_ids(pcm, m["mu"])).to(dev)
            codes = s.codes[:-(-(len(ids) + hop // 2) // hop)]
            lg = rs.logits_for(p, m, codes, s.speaker, ids.cpu().numpy())
            gaps.append(rs.widest_gap(lg, ids))
            if control:
                lc = rs.logits_for(p, m, codes, s.speaker,
                                   ids.cpu().numpy(), ref.Prec("fp8"))
                fp8.append(rs.widest_gap(lg, lc.argmax(-1)))
                alt = (ids + m["mu"] // 2) % m["mu"]
                best = lg.max(-1).values
                altered.append(float((best - lg.gather(
                    -1, alt[:, None])[:, 0]).median()))
    gap = max(gaps) if gaps else None
    if not control:
        return gap, None
    return gap, {"fp8": max(fp8) if fp8 else None,
                 "altered": float(np.median(altered)) if altered else None}
