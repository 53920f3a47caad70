"""Reading a Chrome trace: kernels, their owners, busy and idle time."""

import pytest

from portbench import harness, trace
from portbench.drivers.train import summarize


def ev(name, ts, dur, cat="kernel", corr=0, **kw):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "args": {"correlation": corr}, **kw}


def hand_trace():
    """A 100 µs capture: kernels cover [10, 30) (two overlapping) and
    [50, 60); the rest, 70 µs, is idle; a host op spans the first gap."""
    return {"traceEvents": [
        ev(trace.CAPTURE, 0.0, 100.0, cat="user_annotation"),
        ev("void (anonymous namespace)::fwd_layer<2>(Args)", 10.0, 15.0,
           corr=1),
        ev("vqt::atb_part_tc<64>(int)", 20.0, 10.0, corr=2),
        ev("head_fwd_tc(HeadArgs)", 50.0, 10.0, corr=3),
        ev("aten::mm", 1.0, 8.0, cat="cpu_op"),
        ev("aten::zeros", 2.0, 3.0, cat="cpu_op"),
        ev("outside", 150.0, 5.0, corr=4)]}


def test_idle_share_of_a_hand_built_trace():
    tr = hand_trace()
    (lo, hi), = trace.spans(tr, trace.CAPTURE)
    ks = trace.kernels(tr, lo, hi)
    assert [trace.base_name(k["name"]) for k in ks] == \
        ["fwd_layer", "atb_part_tc", "head_fwd_tc"]
    busy = trace.union_s([(k["ts"], k["ts"] + k["dur"]) for k in ks], lo, hi)
    assert busy == pytest.approx(30e-6)
    obs = {"kind": "train", "capture": summarize(tr, 1)}
    share = harness.reader("device_idle_share.train")(obs)
    assert share == pytest.approx(70.0)
    assert harness.reader("device_idle_share.serve")(obs) is None


def test_gaps_and_breakdown():
    tr = hand_trace()
    ks = trace.kernels(tr, 0.0, 100.0)
    spans = [(k["ts"], k["ts"] + k["dur"]) for k in ks]
    assert trace.gaps(spans, 0.0, 100.0) == [(0.0, 10.0), (30.0, 50.0),
                                             (60.0, 100.0)]
    bd = trace.breakdown(tr, ks, 0.0, 100.0)
    assert bd["device_ops"][0] == ["fwd_layer", pytest.approx(15e-6)]
    # the first gap's middle (5 µs) lies in aten::mm, not in aten::zeros
    gaps = dict((n, s) for n, s in bd["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["no host event"] == pytest.approx(60e-6)


def test_kernel_names_of_the_program_sources():
    src = trace.Sources(harness.program_csrc())
    for name, file in [("fwd_layer", "wavenet_train.cu"),
                       ("head_fwd_tc", "head_ce.cu"),
                       ("head_bwd_tc", "head_ce.cu"),
                       ("embed_grad_part", "wavenet_train.cu"),
                       ("cond_bwd_reduce", "upsample.cu")]:
        assert src.defined[name] == [file], name
    assert src.defined["atb_part"] == ["train_common.cuh"]
    assert "train_common.cuh" in src.includes["head_ce.cu"]


def test_a_header_kernel_belongs_to_the_source_before_it():
    src = trace.Sources(harness.program_csrc())
    names = ["fwd_layer<1>", "vqt::atb_part_tc<2>", "head_bwd_tc",
             "vqt::atb_part_tc<2>", "unknown_kernel", "vqt::atb_part_tc<2>"]
    owners = src.owners([{"name": n} for n in names])
    assert owners == ["wavenet_train.cu", "wavenet_train.cu", "head_ce.cu",
                      "head_ce.cu", None, "head_ce.cu"]


@pytest.mark.parametrize("name,base", [
    ("(anonymous namespace)::fwd_layer<2, true>(Args)", "fwd_layer"),
    ("vqt::atb_part_tc<64>(int, float*)", "atb_part_tc"),
    ("void (anonymous namespace)::bwd_layer_tc<(bool)1, 64>(BwdArgs)",
     "bwd_layer_tc"),
    ("void vqt::atb_part_tc<64, 128>(int, vqt::RowMap, float const*)",
     "atb_part_tc"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)",
     "vectorized_elementwise_kernel"),
    ("ampere_sgemm_128x64_tn", "ampere_sgemm_128x64_tn")])
def test_base_name(name, base):
    assert trace.base_name(name) == base
