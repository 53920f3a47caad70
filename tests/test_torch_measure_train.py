"""The training tools of ``vqvae_tpu_torch/measure`` on the CPU at
``tiny``: the roofline's analytic count against the JAX package's, the
embedding-in-kernel parity, the step bench, the session sweep's
plumbing, and the card line and device rules every tool shares."""

import json

import numpy as np
import pytest
import torch

from vqvae_tpu import configs as jcfg
from vqvae_tpu.utils.flops import train_step_flops as jax_flops
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.measure import _common as mc
from vqvae_tpu_torch.measure import (
    embed_kernel_bench,
    session_sweep,
    step_bench,
    train_roofline,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("B", [16, 64])
@pytest.mark.parametrize("name", sorted(jcfg.presets.PRESETS))
def test_analytic_tflops_equal_jax(name, B):
    assert train_roofline.analytic_step_tflops(get_config(name), B) == \
        jax_flops(jcfg.get_config(name), B) / 1e12


def test_seeded_batch_is_the_scripts():
    cfg = get_config("tiny")
    wav, spk = mc.make_batch(cfg, 6, "cpu")
    rng = np.random.default_rng(0)
    want = rng.uniform(-0.9, 0.9, (6, cfg.data.length + 1)).astype(np.float32)
    np.testing.assert_array_equal(wav.numpy(), want)
    np.testing.assert_array_equal(spk.numpy(), np.arange(6) % 4)


def test_roofline_rows(tmp_path, capsys):
    rows = train_roofline.main(["--preset", "tiny", "--batches", "2,3",
                                "--steps", "1", "--device", "cpu",
                                "--profile-batch", "3", "--out",
                                str(tmp_path)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == rows and [r["batch"] for r in rows] == [2, 3]
    for r in rows:
        assert r["mfu"] is None and r["peak_gib"] is None
        assert r["device"] == "cpu" and r["power_limit_w"] is None
        assert r["counted_step_tflops"] > 0 and np.isfinite(r["loss"])
        assert r["utt_per_s"] == pytest.approx(r["batch"] * 1e3
                                               / r["ms_per_step"])
    assert len(list(tmp_path.glob("trace_*.json"))) == 1


def test_embed_in_kernel_keeps_loss_and_params():
    rec = embed_kernel_bench.main(["--preset", "tiny", "--batch", "2",
                                   "--runs", "1", "--reps", "1", "--device",
                                   "cpu"])
    assert rec["loss3_rel_delta"] <= 1e-5
    assert rec["param_norm3_rel_delta"] <= 1e-5
    assert rec["off"]["loss3"] > 0 and rec["on"]["param_norm3"] > 0


def test_step_bench_line(capsys):
    rec = step_bench.main(["2", "1", "1", "--preset", "tiny", "--device",
                           "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("B=2: ") and "utt/s, loss=" in out[0]
    assert json.loads(out[1]) == rec
    assert rec["peak_gib"] is None and np.isfinite(rec["loss0"])


def test_session_sweep_plumbing():
    cfg = get_config("tiny")
    dec = session_sweep.make_decoder(cfg, torch.device("cpu"))
    rows = session_sweep.sweep_raw(cfg, dec, [2], n_push=2)
    assert rows[0]["width"] == 2 and rows[0]["pushes_to_first_audio"] == 1
    assert rows[0]["audio_ms_per_push"] == 2 * cfg.model.hop / 16.0
    split = session_sweep.decompose(cfg, dec, 2, torch.device("cpu"), n=2)
    assert set(split) == {"width", "upload_ms", "upsampler_ms", "kernel_ms",
                          "readback_ms"}
    assert all(v >= 0 for v in split.values()) and split["kernel_ms"] > 0


def test_card_line_and_device_rules():
    assert mc.card("cpu") == {"device": "cpu", "power_limit_w": None}
    assert mc._watts("700.00 W") == 700.0 and mc._watts("[N/A]") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            step_bench.main(["2", "1", "1", "--preset", "tiny"])
