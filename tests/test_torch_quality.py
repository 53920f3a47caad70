"""Port against JAX: the quality check's metric functions, held-out
tones and encode (``scripts/quality_check.py``, loaded by path here
only); inside the port, the decode engines it witnesses give one
waveform, the record has the JAX script's keys, ``quality_gate`` holds
the conditions of ``tests/test_quality.py``, and the demo writes what
``scripts/make_demo.py`` writes.  Clips are cut to 0.04 s (640 decode
steps) where the plain decode loop would otherwise take minutes."""

import contextlib
import functools
import importlib.util
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.audio.mu_law import mu_law_round_trip_jit
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.models.encoder import apply_encoder as jax_apply_encoder
from vqvae_tpu_torch.cli.serve import Codec
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.quality import make_demo
from vqvae_tpu_torch.quality import quality_check as qc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
SHORT = 0.04            # seconds: 10 frames of tiny's hop 64
# the JAX run's recorded values: docs/demo/metrics.json, the README's
# usage and served-engine numbers, tests/test_quality.py's matrix
JAX_RECORD = {
    "band_spectral_correlation": 1.0, "harmonic_energy_ratio": 0.9954,
    "train_codebook_usage": 0.6,
    "engines": {"lax": {"band_spectral_correlation": 1.0,
                        "harmonic_energy_ratio": 0.9954},
                "pallas-stream": {"band_spectral_correlation": 1.0,
                                  "harmonic_energy_ratio": 0.994}},
    "speaker_matrix": {"engine": "pallas-stream", "diag_mean": 0.82,
                       "offdiag_mean": 0.15, "target_offdiag_mean": 0.78},
}


@pytest.fixture(scope="module")
def jq():
    """The JAX script, loaded by path (it is not a package module)."""
    spec = importlib.util.spec_from_file_location(
        "jax_quality_check", os.path.join(ROOT, "scripts",
                                          "quality_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny init and the port's copy of it."""
    jcfg = jax_config("tiny")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg.model)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)))
    return qc.tiny_config(), jcfg, jparams, params


def _short(orig):
    return functools.partial(orig, seconds=SHORT)


@contextlib.contextmanager
def _quiet():
    """0.04 s clips leave the lowest of the 64 bands empty: their means
    are NaN, with numpy's RuntimeWarnings."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_functions_equal_the_jax_scripts(jq, seed):
    rng = np.random.default_rng(seed)
    n = (8000, 7999, 4096)[seed]
    t = np.arange(n) / SR
    wav = (0.5 * np.sin(2 * np.pi * (110 + 50 * seed) * t)
           + 0.2 * rng.standard_normal(n)).astype(np.float32)
    for log in (False, True):
        got = qc.band_power(wav, SR, log=log)
        want = jq.band_power(wav, SR, log=log)
        assert got.tobytes() == want.tobytes()
    for f0 in (110.0, 220.0, 333.3):
        for n_harm in (2, 4):
            assert qc.harmonic_ratio(wav, SR, f0, n_harm) == \
                jq.harmonic_ratio(wav, SR, f0, n_harm)


@pytest.mark.parametrize("f0,phase,seconds", [
    (110.0, 1.234, 0.5), (220.0, 0.7, 0.5), (440.0, 1.3, 0.25),
    (137.0, 0.4, 0.04)])
def test_held_out_tone_equals_the_jax_scripts(jq, f0, phase, seconds):
    got = qc._held_out_tone(SR, f0, phase, seconds)
    want = jq._held_out_tone(SR, f0, phase, seconds)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("s", [None, 0, 1, 2, 3])
def test_held_out_codes_equal_jax_above_the_margin(jq, tiny, s):
    """The eval tone (``s=None``) and each speaker's matrix tone."""
    cfg, jcfg, jparams, params = tiny
    wav = (qc._held_out_tone(SR, 110.0) if s is None else
           qc._held_out_tone(SR, 110.0 * (s + 1), phase=0.4 + 0.3 * s))
    got = qc._encode(params, cfg, wav)
    want = jq._encode(jparams, jcfg, wav)
    assert got.shape == want.shape == (1, len(wav) // cfg.model.hop)
    x = mu_law_round_trip_jit(jnp.asarray(wav[None]), jcfg.model.mu,
                              jcfg.model.mulaw_mode)
    z = np.asarray(jax_apply_encoder(jparams["encoder"], jcfg.model, x),
                   np.float64)
    cb = np.asarray(jparams["vq"]["codebook"], np.float64)
    scores = 2 * z @ cb.T - (cb ** 2).sum(-1)
    top = np.sort(scores, axis=-1)[..., -2:]
    clear = (top[..., 1] - top[..., 0]) > 1e-4 * np.abs(scores).max()
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])


def test_the_engines_give_one_waveform(tiny):
    """lax, pallas, pallas-stream and the daemon's stream engine
    (4-frame then 1-frame pushes), sampled at 0.8 from one seed."""
    cfg, _, _, params = tiny
    codes = qc._encode(params, cfg, qc._held_out_tone(SR, 220.0,
                                                      seconds=SHORT))
    outs = {e: qc._decode(params, cfg, codes, [1], 5, 0.8, e)
            for e in qc.ENGINES}
    codec = Codec(params, cfg, chunk=4, engine="stream", device="cpu")
    outs["stream"] = codec.decode(codes[0], 1, 5, 0.8)[None]
    want = outs["lax"]
    assert want.shape == (1, codes.shape[1] * cfg.model.hop)
    assert np.isfinite(want).all() and len(np.unique(want)) > 4
    for name, got in outs.items():
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), \
            name


def _jax_record(jq, tiny, monkeypatch, **kw):
    """The JAX script's own record on JAX's tiny init, its training and
    decode replaced by stand-ins (its keys do not depend on either)."""
    _, jcfg, jparams, _ = tiny
    rng = np.random.default_rng(0)

    def decode(params, cfg, codes, speakers, seed, temperature, engine):
        n = np.asarray(codes).shape[1] * cfg.model.hop
        return (0.1 * rng.standard_normal((len(speakers), n))).astype(
            np.float32)
    monkeypatch.setattr(jq, "_held_out_tone", _short(jq._held_out_tone))
    monkeypatch.setattr(jq, "_decode", decode)
    monkeypatch.setattr(jq, "train_tiny", lambda *a: (
        jparams, jcfg, {"codebook_usage": 0.5, "loss1": 1.0}))
    with _quiet():
        return jq.run_quality_check(**kw)


def _keys(rec):
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in rec.items()}


@pytest.fixture(scope="module")
def quality_run(tmp_path_factory):
    """``run_quality_check`` for 2 steps on the CPU, short clips."""
    out = str(tmp_path_factory.mktemp("quality"))
    with pytest.MonkeyPatch.context() as mp, _quiet():
        mp.setattr(qc, "_held_out_tone", _short(qc._held_out_tone))
        rec = qc.run_quality_check(
            steps=2, batch_size=2, out_dir=out, device="cpu",
            engines=("lax", "pallas-stream"), speaker_matrix=True)
    return out, rec


def test_run_quality_check_writes_the_run_and_jax_keys(jq, tiny,
                                                       quality_run,
                                                       monkeypatch):
    out, rec = quality_run
    assert os.path.isfile(os.path.join(out, "config.json"))
    rows = [json.loads(ln) for ln in open(os.path.join(out, "log.jsonl"))]
    assert [r["iteration"] for r in rows] == [1, 2]
    assert os.listdir(os.path.join(out, "checkpoints")) == ["step_2.pt"]
    want = _jax_record(jq, tiny, monkeypatch, steps=2, batch_size=2,
                       engines=("lax", "pallas-stream"),
                       speaker_matrix=True)
    assert _keys(rec) == _keys(want)
    assert rec["steps"] == 2 and rec["K"] == 128 and rec["vq"] == "ema"
    assert rec["train_codebook_usage"] == round(rows[-1]["codebook_usage"],
                                                4)
    # lax and pallas-stream decode the same waveform (NaN in the empty
    # bands of a short clip, hence compared as text)
    same = [json.dumps({k: v for k, v in rec["engines"][e].items()
                        if k != "engine"}) for e in ("lax", "pallas-stream")]
    assert same[0] == same[1]


def test_speaker_matrix_shape_and_jax_keys(jq, tiny, quality_run,
                                           monkeypatch):
    _, rec = quality_run
    m = rec["speaker_matrix"]
    S = tiny[0].model.n_speakers
    assert m["engine"] == "pallas-stream" and m["n_speakers"] == S == 4
    for k in ("harmonic_ratio", "target_ratio"):
        assert isinstance(m[k], list) and len(m[k]) == S
        assert all(isinstance(r, list) and len(r) == S for r in m[k])
        assert all(0.0 <= v <= 1.0 for r in m[k] for v in r)
    monkeypatch.setattr(jq, "_held_out_tone", _short(jq._held_out_tone))
    monkeypatch.setattr(jq, "_decode", lambda p, c, codes, spk, *a: np.zeros(
        (len(spk), np.asarray(codes).shape[1] * 64), np.float32))
    want = jq.eval_speaker_matrix(tiny[2], tiny[1], "pallas-stream")
    assert _keys(m) == _keys(want)


def test_main_prints_the_record_then_the_launch_counts(tmp_path,
                                                       monkeypatch, capsys):
    """The CLI as ``chip_smoke.py`` reads it: the record, then the kernel
    launches last; the run directory on stderr."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(qc, "_held_out_tone", _short(qc._held_out_tone))
    with _quiet():
        qc.main(["--steps", "1", "--batch-size", "2", "--device", "cpu",
                 "--engine", "lax", "--engine", "pallas-stream"])
    got = capsys.readouterr()
    out = got.out.strip().splitlines()
    rec = json.loads(out[-2])
    assert set(rec["engines"]) == {"lax", "pallas-stream"}
    assert rec["steps"] == 1 and "speaker_matrix" not in rec
    assert out[-1].startswith("kernel launches: ")
    assert json.loads(out[-1].split(": ", 1)[1])["decode"] == 0  # the CPU
    run = got.err.split("run directory: ")[1].split()[0]
    assert os.path.dirname(run) == str(tmp_path)
    assert os.path.isfile(os.path.join(run, "config.json"))
    assert "quality gate: " in got.err


def test_quality_gate_passes_the_jax_runs_values():
    assert qc.quality_gate(JAX_RECORD) == []


def _set(rec, path, value):
    node = rec
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


@pytest.mark.parametrize("path,value,needle", [
    (("band_spectral_correlation",), 0.8999, "band_spectral_correlation"),
    (("harmonic_energy_ratio",), 0.4999, "harmonic_energy_ratio"),
    (("train_codebook_usage",), 0.4999, "train_codebook_usage"),
    (("engines", "pallas-stream", "band_spectral_correlation"), 0.8999,
     "pallas-stream band_spectral_correlation"),
    (("engines", "pallas-stream", "harmonic_energy_ratio"), 0.4999,
     "pallas-stream harmonic_energy_ratio"),
    (("speaker_matrix", "engine"), "lax", "speaker_matrix engine"),
    (("speaker_matrix", "diag_mean"), 0.4999, "diag_mean 0.4999 < 0.5"),
    (("speaker_matrix", "offdiag_mean"), 0.4101, "< 2 x offdiag_mean"),
    (("speaker_matrix", "target_offdiag_mean"), 0.3999,
     "target_offdiag_mean"),
])
def test_quality_gate_fails_each_condition_alone(path, value, needle):
    rec = json.loads(json.dumps(JAX_RECORD))
    _set(rec, path, value)
    failed = qc.quality_gate(rec)
    assert len(failed) == 1 and needle in failed[0], failed


def test_quality_gate_needs_the_served_engine_and_matrix():
    rec = json.loads(json.dumps(JAX_RECORD))
    del rec["engines"]["pallas-stream"], rec["speaker_matrix"]
    assert len(qc.quality_gate(rec)) == 6


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_make_demo_writes_the_jax_demos_files(quality_run, tmp_path,
                                              monkeypatch, capsys,
                                              with_matplotlib):
    run, rec = quality_run
    monkeypatch.setattr(qc, "_held_out_tone", _short(qc._held_out_tone))
    if not with_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "demo"
    with _quiet():
        make_demo.main(["-m", run, "-o", str(out), "--device", "cpu"])
    with open(os.path.join(ROOT, "docs", "demo", "metrics.json")) as f:
        jax_metrics = json.load(f)
    with open(out / "metrics.json") as f:
        metrics = json.load(f)
    assert set(metrics) == set(jax_metrics)
    wavs = ["input.wav", "mulaw_ceiling.wav", "reconstruction.wav"]
    png = ["spectrogram_triptych.png"] if with_matplotlib else []
    assert metrics["files"] == sorted(wavs + png)
    assert metrics["sr"] == SR and metrics["samples"] == 640
    # the demo's decode is eval_quality's lax decode at seed 0
    lax = rec["engines"]["lax"]
    for k in ("harmonic_energy_ratio", "harmonic_energy_ratio_ceiling"):
        assert metrics[k] == lax[k]
    said = capsys.readouterr().out
    assert ("matplotlib is not installed" in said) != with_matplotlib


def test_make_demo_refuses_docs_demo(quality_run):
    before = sorted(os.listdir(os.path.join(ROOT, "docs", "demo")))
    for out in ("docs/demo", os.path.join(ROOT, "docs", "demo"),
                "docs/demo/sub"):
        with pytest.raises(SystemExit, match="docs/demo holds the JAX"):
            make_demo.main(["-m", quality_run[0], "-o", out,
                            "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(ROOT, "docs", "demo"))) == before
