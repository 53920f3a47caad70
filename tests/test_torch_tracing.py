"""The program's spans and counters (``vqvae_tpu_torch/utils/profiling.py``)
on the CPU: inert with tracing off, parents and request ids across the
daemon's connection threads, the ring's bound, the anchor that puts a
thread the profiler does not record on the trace's clock, the kernel
launch counters read through the same registry, and every span of a
training step."""

import collections
import dataclasses
import json
import os
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.utils import profiling
from vqvae_tpu_torch.utils.profiling import counter, span

torch.set_num_threads(1)

PHASES = ["train.frame", "train.zero_grad", "train.forward",
          "train.backward", "train.optimizer", "train.codebook"]


@pytest.fixture(autouse=True)
def clean():
    profiling.set_tracing(False)
    profiling.reset()
    yield
    profiling.set_tracing(False)
    profiling.reset()


def by_name(rows):
    out = collections.defaultdict(list)
    for r in rows:
        out[r["name"]].append(r)
    return out


def test_tracing_off_records_nothing_and_allocates_nothing():
    assert not profiling.tracing()
    assert span("a") is span("b") is profiling.NO_SPAN
    for _ in range(100):                      # warm any lazy state
        with span("x"):
            counter("c")
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    for _ in range(20000):
        with span("x"):
            counter("c", 3)
        profiling.begin_request()
    grown = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert grown < 4096
    assert profiling.spans() == []
    assert profiling.counters()["spans.dropped"] == 0
    assert "c" not in profiling.counters()


def test_tracing_on_records_name_times_thread_and_parent():
    profiling.set_tracing(True)
    with span("outer"):
        with span("inner", op="x"):
            time.sleep(0.002)
        counter("n")
        counter("n", 4)
    rows = by_name(profiling.spans())
    (o,), (i,) = rows["outer"], rows["inner"]
    assert i["parent"] == o["id"] and o["parent"] is None
    assert o["start_ns"] <= i["start_ns"] < i["end_ns"] <= o["end_ns"]
    assert i["end_ns"] - i["start_ns"] >= 2e6
    assert i["op"] == "x" and i["thread"] == threading.get_native_id()
    assert profiling.counters()["n"] == 5
    st = profiling.span_stats()["inner"]
    assert st["count"] == 1 and st["p95_ms"] >= 2.0


def test_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=8))
    profiling.set_tracing(True)
    for i in range(20):
        with span(f"s{i}"):
            pass
    rows = profiling.spans()
    assert [r["name"] for r in rows] == [f"s{i}" for i in range(12, 20)]
    assert profiling.counters()["spans.dropped"] == 12
    assert profiling.export()["dropped"] == 12


def test_threads_lose_no_count_and_no_span(monkeypatch):
    """More threads than cores, switching every microsecond: every
    counter update and every span is kept or counted as dropped."""
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=1000))
    profiling.set_tracing(True)

    def work():
        for i in range(5000):
            counter("c")
            if i % 10 == 0:
                with span("s"):
                    pass
    ts = [threading.Thread(target=work) for _ in range(os.cpu_count() + 2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    got = profiling.counters()
    assert got["c"] == 5000 * len(ts)
    assert len(profiling.spans()) + got["spans.dropped"] == 500 * len(ts)


def test_overlap_counts_blocks_entered_while_another_is_under_way():
    """``overlap(name)``: blocks one after another count nothing; of two
    threads inside at once the later counts once; many threads switching
    every microsecond leave none under way; tracing off, it is inert."""
    assert profiling.overlap("o") is profiling.NO_SPAN
    profiling.set_tracing(True)
    for _ in range(3):
        with profiling.overlap("o"):
            pass
    assert "o" not in profiling.counters()
    meet = threading.Barrier(2, timeout=10)

    def pair():
        with profiling.overlap("o"):
            meet.wait()

    def churn():
        for _ in range(2000):
            with profiling.overlap("o"):
                pass
    for work, n in ((pair, 2), (churn, os.cpu_count() + 2)):
        ts = [threading.Thread(target=work) for _ in range(n)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in ts)
        if work is pair:
            assert profiling.counters()["o"] == 1
    got = profiling.counters()["o"]
    assert got <= 1 + 2000 * (os.cpu_count() + 2)
    with profiling.overlap("o"):   # nothing is left under way
        pass
    assert profiling.counters()["o"] == got


def test_launch_counts_read_the_registry_and_the_kernel_modules(
        monkeypatch, codec):
    from vqvae_tpu_torch.cli import common
    from vqvae_tpu_torch.kernels import decode_cuda, embed_cuda, vq_cuda
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    keys = ["decode", "encoder_fwd", "encoder_bwd", "chunk_fwd", "chunk_bwd",
            "chunk_bwd_rec", "chunk_bwd_win", "head_ce_fwd", "head_ce_bwd",
            "vq_argmin", "take_rows_bwd"]
    assert list(common.launch_counts()) == keys
    monkeypatch.setattr(decode_cuda, "launches", 7)
    monkeypatch.setattr(vq_cuda, "launches", 3)
    monkeypatch.setattr(wt, "launches_bwd_rec", 5)
    monkeypatch.setitem(embed_cuda.launches, "take_rows_bwd", 2)
    got = common.launch_counts()
    assert (got["decode"], got["vq_argmin"], got["chunk_bwd_rec"],
            got["take_rows_bwd"]) == (7, 3, 5, 2)
    assert profiling.counters()["launches"] == got
    from vqvae_tpu_torch.cli.serve import Stats, handle
    assert Stats().snapshot()["kernel_launches"] == 7
    assert handle(codec, {"op": "ping"})["kernel_launches"] == 7


def test_stats_reply_is_unchanged_with_tracing_off_and_grows_with_it():
    from vqvae_tpu_torch.cli.serve import Stats
    st = Stats()
    st.record("stream_push", True, 4.0)
    off = st.snapshot()
    assert set(off) == {"ok", "uptime_s", "connections", "kernel_launches",
                        "ops"}
    profiling.set_tracing(True)
    with span("serve.handle"):
        counter("stream.pushes")
    on = st.snapshot()
    assert on["spans"]["serve.handle"]["count"] == 1
    assert on["counters"]["stream.pushes"] == 1
    assert "launches" in on["counters"]
    assert {k: v for k, v in on.items() if k not in ("spans", "counters",
                                                      "uptime_s")} == \
        {k: v for k, v in off.items() if k != "uptime_s"}


@pytest.fixture(scope="module")
def codec():
    from vqvae_tpu_torch.cli.serve import Codec
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.models import init_model
    cfg = get_config("tiny")
    params = init_model(cfg.model, torch.Generator().manual_seed(3))
    return Codec(params, cfg, chunk=2, engine="kernel", device="cpu")


def _daemon(codec, tmp_path):
    from vqvae_tpu_torch.cli.serve import serve
    sock = str(tmp_path / "d.sock")
    th = threading.Thread(target=serve, args=(codec, sock), daemon=True)
    th.start()
    deadline = time.time() + 60
    while not os.path.exists(sock):
        assert time.time() < deadline and th.is_alive()
        time.sleep(0.02)
    return sock, th


def test_request_ids_and_parents_across_connection_threads(codec, tmp_path):
    """Two clients stream at once through the daemon's socket loop and
    each sends one whole-request ``decode``: each request's spans, on its
    connection's thread, share one request id; the engine's spans nest
    in ``serve.handle``; a push takes no lock (no ``serve.lock_wait``),
    and the lock counters count the ``decode`` requests alone."""
    from vqvae_tpu_torch.client import CodecClient
    profiling.set_tracing(True)
    sock, th = _daemon(codec, tmp_path)
    pushed = []

    def client(seed):
        with CodecClient(socket_path=sock) as c:
            h = c.open_stream(speaker=1, seed=seed, greedy=True)
            for i in range(2):
                pushed.append(len(h.push_codes([seed, i + 1])))
            h.close()
            c.decode([seed, 3], speaker=1, greedy=True)
    ts = [threading.Thread(target=client, args=(s,)) for s in (5, 9)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    with CodecClient(socket_path=sock) as c:
        stats = c.stats()
        c.shutdown()
    th.join(timeout=30)
    rows = [r for r in profiling.spans()
            if not r["name"].startswith(profiling.ANCHOR)]
    handles = [r for r in rows if r["name"] == "serve.handle"]
    pushes = [h for h in handles if h["op"] == "stream_push"]
    assert len(pushes) == 4
    per_request = collections.defaultdict(list)
    for r in rows:
        per_request[r["request"]].append(r)
    want = {"serve.recv", "serve.parse", "serve.handle",
            "stream.upload", "stream.upsample", "stream.decode",
            "stream.readback", "stream.pcm_encode", "serve.respond"}
    threads = set()
    for h in pushes:
        req = per_request[h["request"]]
        assert {r["name"] for r in req} == want
        assert len({r["thread"] for r in req}) == 1
        threads.add(h["thread"])
        for r in req:
            if r["name"].startswith("stream."):
                assert r["parent"] == h["id"], r
            else:
                assert r["parent"] is None, r
    assert len(threads) == 2 and threading.get_native_id() not in threads
    assert len({h["request"] for h in handles}) == len(handles)
    cnt = profiling.counters()
    assert cnt["serve.requests.stream_push"] == 4
    assert cnt["serve.requests.stream_open"] == 2
    assert cnt["stream.pushes"] == 4 and cnt["stream.frames_in"] == 8
    assert cnt["stream.samples_out"] == sum(pushed)
    locked = cnt["serve.requests.decode"]
    assert locked == 2
    assert cnt["serve.lock_acquisitions"] == locked
    assert 0 <= cnt.get("serve.lock_waits", 0) <= locked
    waits = [r for r in rows if r["name"] == "serve.lock_wait"]
    assert len(waits) == locked
    assert {h["op"] for h in handles
            if h["request"] in {r["request"] for r in waits}} == {"decode"}
    # pushes + closes + decodes
    assert stats["spans"]["stream.decode"]["count"] >= 8
    assert stats["counters"]["launches"]["decode"] == 0   # the plain version


def _profile(**kw):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU], **kw)


def test_export_places_an_unrecorded_threads_spans_between_their_neighbours(
        tmp_path):
    """A thread the profiler does not record: its spans are written into
    the trace on their own thread, between the main thread's spans that
    came before and after them, within 50 µs."""
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait()
        with span("t.other"):
            torch.ones(256).sum()
        done.set()
    th = threading.Thread(target=other, name="second")
    th.start()
    with _profile() as prof:
        profiling.set_tracing(True)
        with span("t.before"):
            torch.ones(256).sum()
        go.set()
        done.wait()
        with span("t.after"):
            torch.ones(256).sum()
        profiling.set_tracing(False)
    th.join()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    out = profiling.export(path)
    assert out["clock"]["anchors"] == 2 * profiling.ANCHORS
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    named = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("t.")}
    before, other_ev, after = (named[n] for n in ("t.before", "t.other",
                                                  "t.after"))
    assert other_ev["tid"] == th.native_id != before["tid"]
    assert before["ts"] + before["dur"] - 50 <= other_ev["ts"]
    assert other_ev["ts"] + other_ev["dur"] <= after["ts"] + 50
    assert {"name": "second"} in [e.get("args") for e in events
                                  if e.get("ph") == "M"
                                  and e.get("tid") == th.native_id]
    # the main thread's spans are the profiler's own events, annotated
    assert before["args"]["span"] == by_name(out["spans"])["t.before"][0]["id"]


def test_a_second_threads_exported_spans_start_within_50us_of_the_profilers(
        tmp_path):
    """Where the profiler records every thread, the spans it recorded on
    the second thread and the ring's, placed by the anchors, agree: each
    placed span lies inside the profiler's event of it, within 50 µs at
    both ends (the profiler's event brackets the span's clock reads), and
    the starts differ by under 50 µs at the median."""
    from torch._C._profiler import _ExperimentalConfig
    go = threading.Event()

    def other():
        go.wait()
        for _ in range(20):
            with span("t.other"):
                torch.ones(256).sum()
            time.sleep(0.0005)
    th = threading.Thread(target=other)
    th.start()
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with _profile(experimental_config=cfg) as prof:
        profiling.set_tracing(True)
        go.set()
        th.join()
        profiling.set_tracing(False)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    mine = {r["id"]: r for r in profiling.export(path)["spans"]
            if r["name"] == "t.other"}
    with open(path) as f:
        theirs = [e for e in json.load(f)["traceEvents"]
                  if e.get("name") == "t.other"]
    assert len(mine) == len(theirs) == 20
    starts = []
    for e in theirs:
        r = mine[e["args"]["span"]]
        assert r["thread"] == e["tid"] == th.native_id
        assert e["ts"] - 50 <= r["ts"]
        assert r["ts"] + r["dur"] <= e["ts"] + e["dur"] + 50
        starts.append(r["ts"] - e["ts"])
    assert abs(float(np.median(starts))) < 50


def test_profile_trace_carries_the_spans_of_its_block(tmp_path):
    with profiling.profile_trace(str(tmp_path / "p"), "cpu"):
        with span("t.block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not profiling.tracing()
    (name,) = os.listdir(tmp_path / "p")
    with open(tmp_path / "p" / name) as f:
        events = json.load(f)["traceEvents"]
    (blk,) = [e for e in events if e.get("name") == "t.block"]
    assert blk["cat"] == "user_annotation" and "span" in blk["args"]


def test_loader_wait_is_a_span():
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.audio.loader import BatchLoader
    from vqvae_tpu_torch.configs import get_config
    loader = BatchLoader(SineDataset(get_config("tiny").data), 2, seed=1)
    try:
        profiling.set_tracing(True)
        for _ in range(3):
            next(loader)
    finally:
        loader.close()
    assert [r["name"] for r in profiling.spans()] == ["data.wait"] * 3


@pytest.mark.parametrize("kernels", ["plain", "chunk_and_head"])
def test_a_cpu_train_step_records_its_phases_and_layers(kernels):
    """``tiny`` with the EMA codebook and restarts: ``train.step`` holds
    its six phases in order, ``train.forward`` the forward's layers, and
    the custom Functions' backwards (on the calling thread here; on the
    card autograd's device thread runs them) their ``.bwd`` spans under
    ``train.backward``."""
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    cfg = get_config("tiny")
    m = dict(ema=True, code_restart_threshold=1e-3)
    if kernels == "chunk_and_head":
        m.update(decoder_kernel="pallas_sg", head_kernel="pallas")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **m))
    state = create_train_state(cfg)
    rng = np.random.default_rng(1)
    wav = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, 1025)).astype(
        np.float32))
    profiling.set_tracing(True)
    train_step(state, wav, torch.tensor([0, 1]), cfg)
    rows = profiling.spans()
    names = by_name(rows)
    (step,) = names["train.step"]
    kids = [r for r in rows if r["parent"] == step["id"]]
    assert [r["name"] for r in sorted(kids, key=lambda r: r["start_ns"])] \
        == PHASES
    fwd = names["train.forward"][0]["id"]
    layers = ["model.encoder", "model.vq", "model.upsample",
              "model.decoder_stack", "model.head"]
    assert [r["name"] for r in rows if r["parent"] == fwd] == layers
    bwd = [r["name"] for r in rows
           if r["parent"] == names["train.backward"][0]["id"]]
    if kernels == "plain":
        assert bwd == []
    else:
        assert bwd == ["model.head.bwd", "model.decoder_stack.bwd"]
    assert {r["request"] for r in rows} == {None}
