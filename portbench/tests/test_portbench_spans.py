"""The program's spans as ``spans.py`` reads them: idle gaps charged to
the span that launched the kernel after them, on hand-built traces with
known answers; the daemon's host and codec time a push; no span in the
timed window; and, on the card, the spans' own attribution of the
decoder stack against the file names', and the daemon's connection
threads in its capture."""

import json
import os
import threading
import time

import pytest

from portbench import spans, trace


def ev(name, ts, dur, cat, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid, "args": args}


def kernel(ts, dur, corr):
    return ev(f"k{corr}", ts, dur, "kernel", tid=7, correlation=corr)


def launch(ts, corr, tid=1):
    return ev("cudaLaunchKernel", ts, 1.0, "cuda_runtime", tid=tid,
              correlation=corr)


def span(name, ts, dur, tid=1, **args):
    return ev(name, ts, dur, "user_annotation", tid=tid, **args)


def train_trace():
    """A 100 µs capture of one step.  Kernels [10, 20), [30, 40),
    [60, 70); gaps [0, 10) (ended by k1, launched in ``model.encoder``),
    [20, 30) (k2, launched by thread 2, which has no span then: the
    innermost span of any thread is ``train.backward``), [40, 60) (k3,
    in ``train.optimizer``), [70, 100) (no kernel ends it)."""
    return {"traceEvents": [
        ev(trace.CAPTURE, 0.0, 100.0, "user_annotation"),
        span("train.step", 0.5, 95.0),
        span("train.forward", 1.0, 21.0),
        span("model.encoder", 2.0, 6.0),
        span("train.backward", 22.0, 28.0),
        span("train.optimizer", 50.0, 8.0),
        span("portbench.train_step", 0.0, 96.0),     # not the program's
        kernel(10.0, 10.0, 1), launch(5.0, 1),
        kernel(30.0, 10.0, 2), launch(25.0, 2, tid=2),
        kernel(60.0, 10.0, 3), launch(55.0, 3)]}


def test_a_gap_is_charged_to_the_span_that_launched_the_kernel_after_it():
    got = spans.idle_by_phase(train_trace(), steps=1)
    assert got["forward"] == pytest.approx(0.010)
    assert got["backward"] == pytest.approx(0.010)
    assert got["update"] == pytest.approx(0.020)
    assert got["rest"] == pytest.approx(0.030)
    assert got["by_span"] == pytest.approx(
        {"model.encoder": 0.010, "train.backward": 0.010,
         "train.optimizer": 0.020, "no span": 0.030})


def test_the_phases_and_the_rest_add_up_to_the_idle_time():
    tr = train_trace()
    # the autograd thread's own span takes its launch
    tr["traceEvents"].append(span("model.decoder_stack.bwd", 24.0, 4.0,
                                  tid=2))
    got = spans.idle_by_phase(tr, steps=2)
    (lo, hi), = trace.spans(tr, trace.CAPTURE)
    ks = trace.kernels(tr, lo, hi)
    busy = trace.union_s([(k["ts"], k["ts"] + k["dur"]) for k in ks], lo, hi)
    idle_ms = ((hi - lo) / 1e6 - busy) * 1e3 / 2
    assert got["idle"] == pytest.approx(idle_ms)
    assert sum(got[p] for p in spans.PHASES) == pytest.approx(idle_ms)
    assert got["by_span"]["model.decoder_stack.bwd"] == pytest.approx(0.005)
    assert got["backward"] == pytest.approx(0.005)


@pytest.mark.parametrize("name,phase", [
    ("train.forward", "forward"), ("model.vq", "forward"),
    ("model.head.bwd", "backward"), ("train.backward", "backward"),
    ("train.zero_grad", "update"), ("train.codebook", "update"),
    ("train.frame", "rest"), ("data.wait", "rest"), ("train.step", "rest"),
    (None, "rest")])
def test_phase_of_a_span(name, phase):
    assert spans.phase(name) == phase


def test_span_kernel_seconds_follow_the_launching_span():
    tr = train_trace()
    tr["traceEvents"].append(span("model.decoder_stack.bwd", 24.0, 4.0,
                                  tid=2))
    assert spans.span_kernel_s(tr, "model.decoder_stack") == \
        pytest.approx(10e-6)
    assert spans.span_kernel_s(tr, "model.") == pytest.approx(20e-6)


def serve_trace():
    """Two pushes on two connection threads and an open; the second
    push's respond falls outside the capture, so it is not counted."""
    evs = [ev(trace.CAPTURE, 0.0, 1000.0, "user_annotation")]
    for rid, tid, t, op in ((1, 11, 0.0, "stream_push"),
                            (2, 12, 100.0, "stream_open"),
                            (3, 12, 930.0, "stream_push")):
        evs += [span("serve.recv", t, 10.0, tid, request=rid),
                span("serve.parse", t + 10, 2.0, tid, request=rid),
                span("serve.lock_wait", t + 12, 3.0, tid, request=rid),
                span("serve.handle", t + 15, 60.0, tid, request=rid, op=op),
                span("serve.respond", t + 80, 4.0, tid, request=rid)]
        if op == "stream_push":
            evs += [span("stream.upload", t + 16, 1.0, tid, request=rid),
                    span("stream.readback", t + 20, 50.0, tid, request=rid),
                    span("stream.pcm_encode", t + 71, 3.0, tid,
                         request=rid)]
    evs.append(span("serve.parse", 500.0, 5.0, 13))    # no request id
    return {"traceEvents": evs}


def test_push_host_and_codec_time_from_hand_made_spans():
    got = spans.push_ms(serve_trace())
    assert got["pushes"] == 1
    assert got["host"] == pytest.approx((60.0 - 50.0) / 1e3)
    assert got["codec"] == pytest.approx((2.0 + 3.0 + 4.0) / 1e3)
    assert spans.push_ms({"traceEvents": [
        ev(trace.CAPTURE, 0.0, 1.0, "user_annotation")]})["host"] is None


def test_the_timed_window_records_no_span(tmp_path):
    """Steps as the training window takes them (``drivers/train.py``):
    the program's tracing stays off and its ring empty."""
    from portbench.drivers import train as dt
    from portbench.tests.conftest import REPO
    from portbench.tests.rehearse import TINY_MODEL
    from vqvae_tpu_torch.utils import profiling
    base = json.loads((REPO / "portbench/configs/vctk-multi.json")
                      .read_text())
    conf = dict(base, preset="tiny", vq_impl="lax", model=TINY_MODEL,
                data=dict(base["data"], length=1024, n_speakers=4))
    traffic = {"batch": 2, "corpus": {"speakers": 4,
                                      "utterances_per_speaker": 1,
                                      "seconds": [0.3, 0.4],
                                      "silence_s": 0.05}}
    profiling.reset()
    s = dt.build(conf, traffic, 2 ** 31 + 5, "cpu", str(tmp_path))
    try:
        for _ in range(2):
            dt.step(s)
    finally:
        s.loader.close()
    assert not profiling.tracing()
    assert profiling.spans() == []


@pytest.mark.cuda
def test_the_stacks_span_time_equals_its_files_time_on_the_card(card,
                                                                 tmp_path):
    """``vctk-multi`` B=16 steps under the profiler with the program's
    tracing on: the device time of the kernels launched inside the chunk
    calls' spans (``model.decoder_stack.fwd``, ``.bwd``) equals
    ``wavenet_train.cu``'s by kernel name within 1%, and no idle gap of
    a step lies outside a program span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import harness
    from portbench.drivers import train as dt
    from vqvae_tpu_torch.utils import profiling
    spec = harness.cell_spec("vctk-multi.train.b16")
    s = dt.build(spec.config, spec.traffic, 2 ** 31 + 77, "cuda",
                 str(tmp_path))
    try:
        for _ in range(3):
            dt.step(s)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiling.set_tracing(True)
            with record_function(trace.CAPTURE):
                for _ in range(3):
                    dt.step(s)
                torch.cuda.synchronize()
            profiling.set_tracing(False)
    finally:
        s.loader.close()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert profiling.export(path)["clock"] is not None
    tr = trace.load(path)
    # the profiler repeats some ranges on the device's row
    tr["traceEvents"] = [e for e in tr["traceEvents"]
                         if e.get("cat") != "gpu_user_annotation"]
    by_file = dt.summarize(tr, 3)["by_file"]["wavenet_train.cu"]
    got = spans.span_kernel_s(tr, ("model.decoder_stack.fwd",
                                   "model.decoder_stack.bwd"))
    assert got == pytest.approx(by_file, rel=0.01)
    idle = spans.idle_by_phase(tr, 3)
    assert idle["by_span"].get("no span", 0.0) <= 0.01 * idle["idle"]


@pytest.mark.cuda
def test_the_daemons_capture_holds_its_connection_threads_spans(card,
                                                                 tmp_path):
    """A capture started on another thread than the connections': their
    ``serve.*`` spans land in the trace on their own threads."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, weights
    from portbench.drivers.train import program_config
    from vqvae_tpu_torch.cli.common import load_params
    from vqvae_tpu_torch.cli.serve import Codec, serve
    from vqvae_tpu_torch.client import CodecClient
    from vqvae_tpu_torch.utils import profiling
    conf = harness.cell_spec("vctk-multi.serve.s1").config
    cfg = program_config(conf, 1)
    flat = weights.make(conf["model"], 2 ** 31 + 9, torch.device("cuda"))
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **{k: v.cpu().numpy() for k, v in flat.items()})
    params = load_params(npz, cfg, torch.device("cuda"))
    codec = Codec(params, cfg, 16, "kernel", "cuda")
    sock = str(tmp_path / "d.sock")
    th = threading.Thread(target=serve, args=(codec, sock), daemon=True)
    th.start()
    while not os.path.exists(sock):
        time.sleep(0.05)

    def client(seed):
        with CodecClient(socket_path=sock) as c:
            h = c.open_stream(speaker=3, seed=seed)
            for i in range(3):
                h.push_codes(np.arange(16) + seed + i)
            h.close()
    client(1)                                  # builds the kernel
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiling.set_tracing(True)
        with torch.profiler.record_function(trace.CAPTURE):
            ts = [threading.Thread(target=client, args=(s,))
                  for s in (2, 3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        profiling.set_tracing(False)
    with CodecClient(socket_path=sock) as c:
        c.shutdown()
    prof.export_chrome_trace(path)
    profiling.export(path)
    tr = trace.load(path)
    serve_threads = {s["tid"] for s in spans.program_spans(tr)
                     if s["name"].startswith("serve.")}
    assert len(serve_threads) == 2
    assert threading.get_native_id() not in serve_threads
    assert spans.push_ms(tr)["pushes"] == 6
