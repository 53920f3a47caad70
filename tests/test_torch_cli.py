"""The port's codec CLIs (``vqvae-torch-{encode,decode,generate,stream,
score,export}``) as a user calls them, on the CPU (``--device cpu``)
with seeded ``tiny`` weights, mirroring ``tests/test_cli.py``: round
trips, the exactness contracts at the CLI (stream == decode, lowmem ==
one-shot, live encode == one-shot encode), export from a port training
run, deterministic scoring, codes against the JAX ``vqvae-encode``, and
the flags that wait for ROADMAP A8."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu_torch.audio.wav_io import load_wav, save_wav
from vqvae_tpu_torch.cli import decode, encode, export, generate, score, \
    stream
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.models import init_model
from vqvae_tpu_torch.train.checkpoint import export_weights

torch.set_num_threads(1)

SR = 16000
BASE = ["--preset", "tiny", "--device", "cpu"]


def _tone(path, n, f, amp=0.5):
    save_wav(str(path), amp * np.sin(2 * np.pi * f * np.arange(n) / SR), SR)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded tiny weights with non-zero biases, as a weights .npz."""
    d = tmp_path_factory.mktemp("w")
    params = init_model(get_config("tiny").model,
                        torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in params.state_dict().items():
            if k.endswith(".b"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.3)
    path = str(d / "w.npz")
    export_weights(path, params)
    return path


def _launches(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("kernel launches")]
    assert len(line) == 1
    return json.loads(line[0].split(": ", 1)[1])


def test_encode_decode_round_trip(weights, tmp_path, capsys):
    wav_in = _tone(tmp_path / "in.wav", 800, 220)
    codes = str(tmp_path / "c.npy")
    encode.main(BASE + ["-i", wav_in, "-o", codes, "-m", weights,
                        "--no-trim"])
    c = np.load(codes)
    assert c.dtype == np.int32 and c.shape == (768 // 64,)
    assert _launches(capsys.readouterr().out)["encoder_fwd"] == 0   # CPU
    out = str(tmp_path / "dec.wav")
    decode.main(BASE + ["-i", codes, "-o", out, "-m", weights, "-s", "0",
                        "--greedy"])
    w = load_wav(out, SR)
    assert len(w) == 768 and np.all(np.isfinite(w))


def test_encode_multi_and_stack(weights, tmp_path):
    """Several inputs: one .npy each (stems de-duplicated across
    directories), and ``--stack`` -> ``[B, T_lat]`` whose rows equal the
    per-file codes."""
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    paths = [_tone(tmp_path / "a" / "x.wav", 800, 330),
             _tone(tmp_path / "b" / "x.wav", 800, 220)]
    outdir = str(tmp_path / "codes")
    encode.main(BASE + ["-i", *paths, "-o", outdir, "-m", weights,
                        "--no-trim", "--set", "model.encoder_kernel=pallas"])
    assert sorted(os.listdir(outdir)) == ["x.npy", "x_1.npy"]
    per_file = [np.load(os.path.join(outdir, n)) for n in ("x.npy",
                                                           "x_1.npy")]
    stacked = str(tmp_path / "stack.npy")
    encode.main(BASE + ["-i", *paths, "-o", stacked, "-m", weights,
                        "--no-trim", "--stack"])
    s = np.load(stacked)
    assert s.shape == (2, 12)
    for i in range(2):
        np.testing.assert_array_equal(s[i], per_file[i])


def _decode(weights, codes, out, *extra):
    decode.main(BASE + ["-i", codes, "-o", out, "-m", weights, "-s", "1",
                        "--seed", "5", *extra])
    return load_wav(out, SR)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_decode_lowmem_equals_one_shot(weights, tmp_path, greedy):
    codes = str(tmp_path / "c.npy")
    np.save(codes, (np.arange(20) * 7 % 128).astype(np.int32))
    g = ["--greedy"] if greedy else []
    one = _decode(weights, codes, str(tmp_path / "one.wav"), *g)
    low = _decode(weights, codes, str(tmp_path / "low.wav"), *g,
                  "--gen-impl", "lowmem")
    np.testing.assert_array_equal(one, low)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_stream_codes_equals_decode(weights, tmp_path, greedy, capsys):
    codes = str(tmp_path / "c.npy")
    np.save(codes, np.random.default_rng(3).integers(0, 128, 12).astype(
        np.int32))
    g = ["--greedy"] if greedy else []
    one = _decode(weights, codes, str(tmp_path / "one.wav"), *g)
    capsys.readouterr()
    out = str(tmp_path / "chunked.wav")
    stream.main(BASE + ["-i", codes, "-o", out, "-m", weights, "-s", "1",
                        "--seed", "5", "--chunk-frames", "5", *g])
    printed = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in printed.splitlines()
            if ln.startswith("chunk ")] == ["chunk 0", "chunk 1", "chunk 2"]
    np.testing.assert_array_equal(one, load_wav(out, SR))


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_stream_live_encode_equals_encode_then_decode(weights, tmp_path,
                                                      kernel):
    """``--encode-chunk``: the streaming encoder feeding the streaming
    decoder gives the waveform of one-shot encode + decode (sampled),
    with either encoder."""
    wav_in = _tone(tmp_path / "in.wav", 1000, 330)
    sw = ["--set", f"model.encoder_kernel={kernel}"]
    codes = str(tmp_path / "c.npy")
    encode.main(BASE + ["-i", wav_in, "-o", codes, "-m", weights,
                        "--no-trim", *sw])
    one = _decode(weights, codes, str(tmp_path / "one.wav"))
    live = str(tmp_path / "live.wav")
    stream.main(BASE + ["-i", wav_in, "-o", live, "-m", weights, "-s", "1",
                        "--seed", "5", "--chunk-frames", "4",
                        "--encode-chunk", "160", *sw])
    np.testing.assert_array_equal(one, load_wav(live, SR))


def test_generate_multi_file_names_and_solo_row(weights, tmp_path):
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    paths = [_tone(tmp_path / "a" / "x.wav", 800, 330),
             _tone(tmp_path / "b" / "x.wav", 512, 220)]
    outdir = str(tmp_path / "gen")
    generate.main(BASE + ["-i", *paths, "-o", outdir, "-m", weights,
                          "-s", "1", "2", "--no-trim", "--greedy"])
    assert generate._output_names(paths) == ["x_gen.wav", "x_1_gen.wav"]
    w0 = load_wav(os.path.join(outdir, "x_gen.wav"), SR)
    w1 = load_wav(os.path.join(outdir, "x_1_gen.wav"), SR)
    assert len(w0) == 768 and len(w1) == 512
    # the longest file's row carries no padding: it equals a solo run
    solo = str(tmp_path / "solo.wav")
    generate.main(BASE + ["-i", paths[0], "-o", solo, "-m", weights,
                          "-s", "1", "--no-trim", "--greedy"])
    np.testing.assert_array_equal(w0, load_wav(solo, SR))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Two tiny training steps through ``vqvae-torch-train`` on the CPU."""
    from vqvae_tpu_torch.cli import train
    out = str(tmp_path_factory.mktemp("run"))
    train.main(["--preset", "tiny", "--dataset", "sine", "--steps", "2",
                "--batch-size", "2", "--device", "cpu", "--out", out])
    return out


def test_export_from_a_port_run_equals_its_weights_npz(port_run, tmp_path):
    npz = str(tmp_path / "exported.npz")
    export.main(BASE + ["-m", port_run, "-o", npz])
    with np.load(npz) as got, \
            np.load(os.path.join(port_run, "weights.npz")) as want:
        assert set(got.files) == set(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the run directory itself loads, as the .npz does
    codes = str(tmp_path / "c.npy")
    np.save(codes, np.arange(6, dtype=np.int32))
    a = _decode(port_run, codes, str(tmp_path / "a.wav"))
    b = _decode(npz, codes, str(tmp_path / "b.wav"))
    np.testing.assert_array_equal(a, b)


def test_score_is_deterministic(port_run, capsys):
    def run():
        score.main(["-m", port_run, "--dataset", "sine", "--batch-size",
                    "2", "--eval-batches", "1", "--json", "--device", "cpu"])
        out = capsys.readouterr().out
        return json.loads([ln for ln in out.splitlines()
                           if ln.startswith("{")][-1])
    a, b = run(), run()
    assert a == b
    assert a["windows"] == 2 and np.isfinite(a["val_loss1"])


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_codes_match_jax_encode_on_clear_frames(tmp_path, monkeypatch,
                                                kernel):
    """The port's encode on a JAX-exported .npz equals JAX
    ``vqvae-encode`` on every frame whose top-2 score margin exceeds
    1e-4 of the largest score."""
    from vqvae_tpu.audio.mu_law import mu_law_round_trip_jit
    from vqvae_tpu.cli.encode import main as jax_encode
    from vqvae_tpu.configs import get_config as jax_config
    from vqvae_tpu.models import init_model as jax_init
    from vqvae_tpu.models.encoder import apply_encoder
    from vqvae_tpu.train.checkpoint import export_weights as jax_export
    jcfg = jax_config("tiny").model
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(4)
    for layer in params["encoder"]["layers"] + [params["encoder"]["proj"]]:
        layer["b"] = jnp.asarray(rng.normal(0, 0.3, layer["b"].shape),
                                 jnp.float32)
    npz = str(tmp_path / "jax.npz")
    jax_export(npz, params)
    noise = 0.3 * rng.standard_normal(2048)
    wav_in = str(tmp_path / "in.wav")
    save_wav(wav_in, np.clip(noise, -1, 1), SR)
    want_path = str(tmp_path / "want.npy")
    monkeypatch.setattr(sys, "argv", ["prog", "--preset", "tiny", "-i",
                                      wav_in, "-o", want_path, "-m", npz,
                                      "--no-trim"])
    jax_encode()
    got_path = str(tmp_path / "got.npy")
    encode.main(BASE + ["-i", wav_in, "-o", got_path, "-m", npz,
                        "--no-trim", "--set",
                        f"model.encoder_kernel={kernel}"])
    want, got = np.load(want_path), np.load(got_path)
    x = mu_law_round_trip_jit(jnp.asarray(load_wav(wav_in, SR)), jcfg.mu,
                              jcfg.mulaw_mode)
    z = np.asarray(apply_encoder(params["encoder"], jcfg, x[None]),
                   np.float64)[0]
    cb = np.asarray(params["vq"]["codebook"], np.float64)
    s = 2 * z @ cb.T - (cb ** 2).sum(-1)
    top = np.sort(s, axis=-1)[:, -2:]
    clear = (top[:, 1] - top[:, 0]) > 1e-4 * np.abs(s).max()
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("cli,args,why", [
    (decode, ["-i", "c.npy", "--mesh-data", "2", "--device", "cuda"],
     "--mesh-data 2: only 1 CUDA device here"),
    (score, ["--dataset", "sine", "--mesh-model", "2"],
     "--mesh-model=2 asks for a mesh of 2 ranks, but the world has 1 "
     "process: .* torchrun --nproc-per-node 2"),
    (score, ["--dataset", "sine", "--mesh-seq", "2"],
     "--mesh-seq=2 asks for a mesh of 2 ranks, but the world has 1 "
     "process: .* torchrun --nproc-per-node 2"),
], ids=["decode-mesh-data", "score-mesh-model", "score-mesh-seq"])
def test_parallel_flags_exit_naming_a8(weights, cli, args, why,
                                       monkeypatch):
    """A mesh larger than what there is stops before anything loads: more
    shards than cards (one card here), a mesh of ranks in one process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=why):
        cli.main(BASE + ["-m", weights, *args])


@pytest.mark.parametrize("cli,args", [
    (encode, ["-i", "in.wav"]), (decode, ["-i", "c.npy"]),
    (generate, ["-i", "in.wav"]), (stream, ["-i", "c.npy"]),
    (score, ["--dataset", "sine"]), (export, []),
], ids=["encode", "decode", "generate", "stream", "score", "export"])
def test_cli_defaults_to_the_card(weights, cli, args, monkeypatch):
    """Without ``--device`` every CLI runs on the card: with no GPU it
    stops before loading anything, never moving to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--preset", "tiny", "-m", weights, *args])


def test_load_params_refuses_a_directory_without_port_checkpoints(
        tmp_path):
    from vqvae_tpu_torch.cli.common import load_params
    os.makedirs(tmp_path / "checkpoints" / "4")   # an orbax-style step dir
    with pytest.raises(SystemExit, match="vqvae-export"):
        load_params(str(tmp_path), get_config("tiny"))
