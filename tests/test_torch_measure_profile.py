"""``measure/train_step_profile.py``'s attribution on the CPU: a
hand-built Chrome trace with known answers (kernels launched inside
port frames, one through ctypes with no ATen op, one from an autograd
node followed to its forward op, two that overlap, idle gaps across
host work of every kind), and an end-to-end ``--device cpu`` run at
``tiny``."""

import ast
import json
import os

import pytest

from vqvae_tpu_torch.measure import train_step_profile as tsp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN, WORKER, HOST, DEV = 10, 20, 1, 0


def _x(cat, name, tid, ts, dur, pid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _py(mod, func, tid, ts, dur):
    return _x("python_function", f"{mod}(1): {func}", tid, ts, dur)


def _launch(tid, ts, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, tid, ts, 10, correlation=corr)


def _kernel(name, ts, dur, corr, stream=7):
    return _x("kernel", name, stream, ts, dur, pid=DEV, correlation=corr)


P = "vqvae_tpu_torch/"
GEMM = "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn"


def hand_trace():
    """One step in a 1000 us window (see the docstring of each part)."""
    ev = [
        _x("user_annotation", tsp.WINDOW, MAIN, 0, 1000),
        _py(P + "measure/train_roofline.py", "step", MAIN, 0, 1000),
        _py(P + "train/step.py", "train_step", MAIN, 10, 940),
        # framing: a plain op's kernel
        _py(P + "audio/framing.py", "frame_batch", MAIN, 20, 60),
        _x("cpu_op", "aten::mul", MAIN, 30, 20),
        _launch(MAIN, 35, 1),
        # the head's product, whose backward runs on the autograd thread
        _py(P + "models/vqvae.py", "forward", MAIN, 100, 300),
        _py(P + "models/wavenet.py", "_head", MAIN, 110, 100),
        _x("cpu_op", "aten::mm", MAIN, 120, 30, **{"Sequence number": 5}),
        _launch(MAIN, 125, 2),
        # a chunk kernel launched through ctypes: no ATen op around it
        _py(P + "kernels/wavenet_train_cuda.py", "fwd_kernel", MAIN, 250,
            60),
        _launch(MAIN, 260, 3, "cudaLaunchKernelExC"),
        # the main thread waits in backward
        _py("torch/_tensor.py", "backward", MAIN, 450, 300),
        _py("torch/autograd/graph.py", "_engine_run_backward", MAIN, 455,
            290),
        # Adam
        _py("torch/optim/adam.py", "step", MAIN, 800, 150),
        _x("user_annotation", "Optimizer.step#Adam.step", MAIN, 800, 150),
        _x("cpu_op", "aten::_foreach_add_", MAIN, 810, 40),
        _launch(MAIN, 820, 5),
        _x("cuda_runtime", "cudaDeviceSynchronize", MAIN, 955, 45),
        # the autograd thread: the chunk's backward kernel, then mm's
        _py(P + "kernels/wavenet_train_cuda.py", "backward", WORKER, 460,
            40),
        _py(P + "kernels/wavenet_train_cuda.py", "bwd_kernel", WORKER, 462,
            33),
        _launch(WORKER, 465, 6),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           WORKER, 505, 55, **{"Sequence number": 5}),
        _x("cpu_op", "MmBackward0", WORKER, 507, 48,
           **{"Sequence number": 5}),
        _x("cpu_op", "aten::mm", WORKER, 510, 30),
        _launch(WORKER, 515, 4),
        {"ph": "s", "id": 1, "pid": HOST, "tid": MAIN, "ts": 120,
         "cat": "fwdbwd", "name": "fwdbwd"},
        {"ph": "f", "id": 1, "pid": HOST, "tid": WORKER, "ts": 507,
         "cat": "fwdbwd", "name": "fwdbwd", "bp": "e"},
        # the card
        _kernel("void at::native::vectorized_elementwise_kernel<4>(int)",
                50, 40, 1),
        _kernel(GEMM, 140, 100, 2),
        _kernel("void fwd_layer<__nv_bfloat16, 64>(int, int)", 280, 200, 3),
        _kernel("void bwd_layer_tc<64>(int)", 490, 210, 6, stream=8),
        _kernel(GEMM, 530, 60, 4),
        _kernel("void at::native::multi_tensor_apply_kernel<3>(int)", 900,
                50, 5),
    ]
    return {"traceEvents": ev}


def _ms(table):
    return {k: round(v["ms_per_step"] * 1e3, 6) for k, v in table.items()}


def test_hand_built_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(hand_trace()))
    rec = tsp.main(["--trace", str(path), "--steps", "1", "--gap-us", "45"])
    # phases in us: the overlap of the mm backward and the chunk backward
    # (530-590) goes half to each
    assert _ms(rec["phases"]) == {"framing": 40, "head_ce": 130,
                                  "fwd_kernel": 200, "bwd_kernel": 180,
                                  "adam_ema": 50}
    assert _ms(rec["idle_by_host"]) == {
        "harness": 15, "dispatch:adam_ema": 75, "data": 20, "launch": 30,
        "dispatch:head_ce": 20, "dispatch:loss": 10, "short_gaps": 50,
        "autograd": 45, "optimizer": 90, "sync": 45, "log": 0}
    assert rec["device_busy_ms_per_step"] == pytest.approx(0.6)
    assert rec["profiled_wall_ms_per_step"] == pytest.approx(1.0)
    assert rec["accounted_pct"] == pytest.approx(100.0)
    assert rec["kernel_share_pct"] == pytest.approx(100 * 380 / 600)
    assert rec["kernels_matched"] and rec["kernels_by_name"] == 0
    assert rec["borrowed_idle_ms_per_step"] == 0
    # by device time, a kernel's whole intervals (overlaps not split)
    assert [(k["name"][:12], k["count"]) for k in rec["top_kernels"]] == [
        ("void bwd_lay", 1), ("void fwd_lay", 1), (GEMM[:12], 2),
        ("void at::nat", 1), ("void at::nat", 1)]
    assert rec["top_kernels"][2]["ms_per_step"] == pytest.approx(0.16)
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[0])["phases"] == rec["phases"]
    assert "| host during the card's idle gaps |" in out


def plain_of(trace, scale=0.5):
    """``trace`` as a capture without Python stacks sees it, with every
    time scaled by ``scale`` (a faster host and card)."""
    ev = []
    for e in trace["traceEvents"]:
        if e.get("cat") != "python_function":
            ev.append(dict(e, ts=e["ts"] * scale,
                           **({"dur": e["dur"] * scale} if "dur" in e
                              else {})))
    return {"traceEvents": ev}


def test_plain_pass_sizes_the_buckets(tmp_path):
    """Times and the runtime and optimizer buckets come from the capture
    without stacks; the rest of each gap is split as the stacked capture
    splits the same gap."""
    plain = plain_of(hand_trace())
    sync = next(e for e in plain["traceEvents"]
                if e["name"] == "cudaDeviceSynchronize")
    sync.update(ts=476, dur=24)     # the last gap (475-500): 24 us sync
    paths = []
    for name, trace in (("stack", hand_trace()), ("plain", plain)):
        paths.append(tmp_path / f"{name}.json")
        paths[-1].write_text(json.dumps(trace))
    rec = tsp.main(["--trace", *map(str, paths), "--steps", "1",
                    "--gap-us", "22.5"])
    assert _ms(rec["phases"]) == {"framing": 20, "head_ce": 65,
                                  "fwd_kernel": 100, "bwd_kernel": 90,
                                  "adam_ema": 25}
    # half the stacked capture's buckets, but the last gap: 24 us sync
    # measured, and its 1 us left over labelled as the stacked capture's
    # non-runtime time there (the harness)
    assert _ms(rec["idle_by_host"]) == {
        "harness": 6, "dispatch:adam_ema": 37.5, "data": 10, "launch": 15,
        "dispatch:head_ce": 10, "dispatch:loss": 5, "short_gaps": 25,
        "autograd": 22.5, "optimizer": 45, "sync": 24, "log": 0}
    assert rec["profiled_wall_ms_per_step"] == pytest.approx(0.5)
    assert rec["stacked_wall_ms_per_step"] == pytest.approx(1.0)
    assert rec["stacked_busy_ms_per_step"] == pytest.approx(0.6)
    assert rec["kernels_matched"] and rec["kernels_by_name"] == 0
    assert rec["accounted_pct"] == pytest.approx(100.0)
    borrowed = sum(rec["idle_by_host"][k]["ms_per_step"] for k in (
        "harness", "dispatch:adam_ema", "data", "dispatch:head_ce",
        "dispatch:loss", "autograd"))
    assert rec["borrowed_idle_ms_per_step"] == pytest.approx(borrowed)


def test_runtime_only_gap_lends_its_caller():
    """Where the stacked capture spends a whole gap in a runtime call,
    the other capture's dispatch there goes to the work that made the
    call (here the encoder)."""
    kernels = [_kernel("k_a", 0, 10, 1), _kernel("k_b", 50, 10, 2)]
    stacked = kernels + [
        _x("user_annotation", tsp.WINDOW, MAIN, 0, 100),
        _py(P + "models/encoder.py", "apply_encoder", MAIN, 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", MAIN, 10, 40)]
    plain = [_kernel("k_a", 0, 10, 1), _kernel("k_b", 40, 20, 2),
             _x("user_annotation", tsp.WINDOW, MAIN, 0, 100),
             _x("cpu_op", "aten::convolution", MAIN, 10, 20),
             _x("cuda_runtime", "cudaLaunchKernel", MAIN, 30, 10)]
    rec = tsp.decompose(stacked, 1, 5.0, plain)
    assert rec["kernels_matched"]
    assert _ms(rec["idle_by_host"]) == {
        "dispatch:encoder": 60, "launch": 10, "data": 0, "optimizer": 0,
        "sync": 0, "log": 0}
    assert rec["borrowed_idle_ms_per_step"] == pytest.approx(0.06)


def test_unmatched_passes_are_reported():
    """Where the two captures ran different kernels, nothing is borrowed:
    the capture without stacks labels itself, and its hand kernels are
    known only by name."""
    plain = plain_of(hand_trace())
    plain["traceEvents"] = [e for e in plain["traceEvents"]
                            if "multi_tensor" not in e["name"]]
    rec = tsp.decompose(hand_trace()["traceEvents"], 1, 22.5,
                        plain["traceEvents"])
    assert not rec["kernels_matched"]
    assert rec["kernels_by_name"] == 2        # fwd_layer, bwd_layer_tc
    assert rec["borrowed_idle_ms_per_step"] == 0
    assert rec["phases"]["other"]["ms_per_step"] > 0


def test_kernels_count_by_their_launch():
    """A capture holds the kernels launched inside its window, whatever
    their mapped times: one launched before the window but run inside it
    stays out, one launched inside but stamped before it (the card's
    clock mapped onto the host's) stays in and widens the window."""
    stacked = hand_trace()
    stacked["traceEvents"] += [_launch(MAIN, -50, 9),
                               _kernel("k_before", 5, 10, 9)]
    plain = plain_of(hand_trace())
    first = next(e for e in plain["traceEvents"]
                 if e.get("cat") == "kernel" and e["args"]["correlation"] == 1)
    first.update(ts=-10)                 # 20 us long: ends at 10
    rec = tsp.decompose(stacked["traceEvents"], 1, 22.5,
                        plain["traceEvents"])
    assert rec["kernels_matched"] and rec["kernels_by_name"] == 0
    assert rec["kernels_mismatch"] is None
    assert rec["profiled_wall_ms_per_step"] == pytest.approx(0.51)
    assert rec["stacked_busy_ms_per_step"] == pytest.approx(0.6)
    assert rec["device_busy_ms_per_step"] == pytest.approx(0.3)
    assert rec["accounted_pct"] == pytest.approx(100.0)
    assert _ms(rec["phases"])["framing"] == 20


def test_unmatched_pair_is_taken_again(monkeypatch, tmp_path):
    """A pair of captures that ran different kernels is dropped and
    taken again; the record says where the dropped pair parted."""
    real, calls = tsp.decompose, []

    def decompose(*a, **k):
        rec = real(*a, **k)
        calls.append(1)
        if len(calls) == 1:
            rec.update(kernels_matched=False, kernels_mismatch={"at": 3})
        return rec
    monkeypatch.setattr(tsp, "decompose", decompose)
    rec = tsp.main(["--preset", "tiny", "--batch", "2", "--steps", "1",
                    "--device", "cpu", "--out", str(tmp_path)])
    assert len(calls) == 2 and rec["kernels_matched"]
    assert rec["pairs_missed"] == [{"at": 3}]


def test_first_mismatch_names_the_parting():
    got = tsp._first_mismatch(["a", "b", "c"], ["a", "x", "c", "d"])
    assert got == {"plain_n": 3, "stacked_n": 4, "at": 1,
                   "plain": ["b", "c"], "stacked": ["x", "c", "d"]}
    assert tsp._first_mismatch(["a"], ["a", "b"])["at"] == 1


def test_hand_kernels_come_from_csrc():
    hk = tsp.hand_kernels()
    for name, src in (("fwd_layer", "wavenet_train.cu"),
                      ("bwd_layer_tc", "wavenet_train.cu"),
                      ("atb_part_tc", "train_common.cuh"),
                      ("head_fwd_tc", "head_ce.cu"), ("vq_search", "vq.cu"),
                      ("enc_layer", "encoder.cu"),
                      ("take_rows_parts", "embed.cu")):
        assert hk[name] == src
    assert tsp.kernel_base("void ns::fwd_layer<__nv_bfloat16, 64>(int)") \
        == "fwd_layer"


def test_every_autograd_function_is_mapped():
    """Each custom autograd Function of the port has its backward node
    in CUSTOM_NODES, pointing at the module that defines it."""
    found = {}
    pkg = os.path.join(ROOT, "vqvae_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.ClassDef) and any(
                        ast.unparse(b).endswith("autograd.Function")
                        for b in node.bases):
                    found[node.name + "Backward"] = os.path.relpath(path,
                                                                    pkg)
    assert found and {k: v[0] for k, v in tsp.CUSTOM_NODES.items()} == found


def test_cpu_run_accounts_for_the_window(tmp_path):
    rec = tsp.main(["--preset", "tiny", "--batch", "2", "--steps", "1",
                    "--device", "cpu", "--out", str(tmp_path)])
    total = sum(v["ms_per_step"] for v in rec["phases"].values())
    assert rec["idle_by_host"] == {}
    assert abs(total - rec["profiled_wall_ms_per_step"]) <= \
        0.01 * rec["profiled_wall_ms_per_step"]
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    for phase in ("fwd_kernel", "bwd_kernel", "head_ce", "encoder", "vq",
                  "adam_ema", "upsampler", "input_embed", "framing"):
        assert rec["phases"][phase]["ms_per_step"] > 0, phase
    assert rec["phases"].get("other", {"pct": 0})["pct"] < 10
    assert rec["wall_ms_per_step"] > 0
