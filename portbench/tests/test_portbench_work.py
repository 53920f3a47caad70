"""The frozen work counts, pinned to numbers worked out by hand."""

import json
from pathlib import Path

import pytest

from portbench.work import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


# per sample and layer: 2*64*128 + 64*128 + 64*64 + 64*256 = 45056 MACs
LAYER_MACS = 45056


def test_train_step_flops_vctk_multi_b16():
    # decoder 30 * 45056 = 1351680, head 256*256 + 256*256 = 131072,
    # embedding 128, encoder 32000 + projection 128, upsampler 8192,
    # VQ 512: 1523712 MACs a sample; 2 FLOP a MAC, 3x for the backward
    want = 3 * 2 * 1523712 * 16 * 7680
    assert counts.train_step_flops(model("vctk-multi"), 7680, 16) == want
    assert want == pytest.approx(1.1234e12, rel=1e-4)


def test_train_step_flops_stretch_b64():
    want = 3 * 2 * 1523712 * 64 * 7680
    assert counts.train_step_flops(model("stretch"), 7680, 64) == want


@pytest.mark.parametrize("name,B,flops,ms", [
    ("vctk-multi", 16, 3 * 2 * 16 * 7680 * 30 * LAYER_MACS, 1.00773),
    ("stretch", 64, 3 * 2 * 64 * 7680 * 30 * LAYER_MACS, 4.03092)])
def test_stack_work(name, B, flops, ms):
    f, nbytes = counts.stack_work(model(name), B, 7680)
    assert f == flops
    # compute-bound: the bytes take far less than the operations
    assert nbytes / counts.PEAK_BYTES < 0.2 * f / counts.PEAK_BF16
    assert 1e3 * counts.bound_s(f, nbytes) == pytest.approx(ms, rel=1e-4)


def test_head_work_stretch():
    f, nbytes = counts.head_work(model("stretch"), 64, 7680)
    assert f == 3 * 2 * 491520 * (256 * 256 + 256 * 256)
    assert 1e3 * counts.bound_s(f, nbytes) == pytest.approx(0.39081,
                                                            rel=1e-4)


@pytest.mark.parametrize("switches", [
    {"decoder_kernel": "xla"}, {"decoder_kernel": "pallas_sg"},
    {"decoder_kernel": "pallas", "bwd_time_windows": 4},
    {"head_kernel": "pallas", "embed_in_kernel": True, "remat": True}])
def test_counts_ignore_the_implementation(switches):
    base = model("vctk-multi")
    other = dict(base, **switches)
    for f in (counts.stack_work, counts.head_work):
        assert f(base, 16, 7680) == f(other, 16, 7680)
    assert counts.train_step_flops(base, 7680, 16) == \
        counts.train_step_flops(other, 7680, 16)
