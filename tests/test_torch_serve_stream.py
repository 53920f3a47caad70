"""The port's serving daemon on the ``stream`` engine
(``vqvae-torch-serve --engine stream``, vqvae_tpu_torch/cli/serve.py) on
the CPU, driven by the JAX package's client as tests/test_torch_serve.py
drives the ``kernel`` engine: its requests and sessions equal the
``kernel`` engine's and the library's one-shot decode bit for bit,
greedy and sampled, and its greedy ids equal the JAX daemon's ``stream``
engine's up to the first near-tie."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.client import CodecClient, ServerError
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.train.checkpoint import export_weights as jax_export
from vqvae_tpu_torch.cli.serve import Codec, float_to_pcm16, pcm16_to_float
from vqvae_tpu_torch.configs import get_config

torch.set_num_threads(1)

SR, HOP, CHUNK = 16000, 64, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KWS = {"greedy": {"greedy": True},
       "sampled": {"seed": 9, "temperature": 0.9}}


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """Seeded JAX weights (nonzero encoder biases) -> .npz -> the port's
    daemon with --engine stream on a UNIX socket, --device cpu."""
    root = tmp_path_factory.mktemp("torch_serve_stream")
    jparams = jax_init(jax.random.PRNGKey(11), jax_config("tiny").model)
    rng = np.random.default_rng(0)
    for layer in jparams["encoder"]["layers"] + [jparams["encoder"]["proj"]]:
        layer["b"] = jnp.asarray(rng.normal(0, 0.3, layer["b"].shape),
                                 jnp.float32)
    npz = str(root / "tiny.npz")
    jax_export(npz, jparams)
    sock = str(root / "codec.sock")
    log_path = str(root / "server.log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.serve", "--preset",
         "tiny", "-m", npz, "--socket", sock, "--device", "cpu", "--chunk",
         str(CHUNK), "--engine", "stream"],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    deadline = time.time() + 300
    while not os.path.exists(sock):
        assert proc.poll() is None, open(log_path).read()[-3000:]
        assert time.time() < deadline, "server did not come up"
        time.sleep(0.2)
    yield {"sock": sock, "npz": npz, "jparams": jparams, "log": log_path}
    if proc.poll() is None:
        try:
            with CodecClient(socket_path=sock) as c:
                c.shutdown()
        except (OSError, ServerError, ConnectionError):
            proc.terminate()
    proc.wait(timeout=60)
    log.close()


@pytest.fixture(scope="module")
def codecs(server):
    """The same weights behind both engines, in this process."""
    from vqvae_tpu_torch.cli.common import load_params
    cfg = get_config("tiny")
    params = load_params(server["npz"], cfg)
    return {e: Codec(params, cfg, CHUNK, e, "cpu")
            for e in ("kernel", "stream")}


def _wire(wav):
    """What the int16 PCM transport makes of a waveform."""
    return pcm16_to_float(float_to_pcm16(wav))


def _tone(n, f=220.0):
    t = np.arange(n) / SR
    wav = 0.5 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(2 * np.pi * 1370 * t)
    return (np.round(wav * 32767) / 32767).astype(np.float32)


def test_ping_and_stats_report_the_stream_engine(server):
    with CodecClient(socket_path=server["sock"]) as c:
        r = c.ping()
        st = c.stats()
    assert r["engine"] == "stream" and r["device"] == "cpu"
    assert r["chunk"] == CHUNK and r["hop"] == HOP
    assert r["realtime_x"] > 0 and r["session_realtime_x"] > 0
    assert r["kernel_launches"] == 0   # CPU: the plain version only
    assert st["engine"] == "stream" and st["kernel_launches"] == 0
    log = open(server["log"]).read()
    assert "decode engine: stream on cpu" in log


@pytest.mark.parametrize("mode", sorted(KWS))
def test_decode_equals_kernel_engine_and_one_shot(server, codecs, mode):
    from vqvae_tpu_torch.infer.fastgen import decode_from_codes
    kw = KWS[mode]
    codes = np.random.default_rng(5).integers(0, 128, 11)   # 2 chunks + 3
    with CodecClient(socket_path=server["sock"]) as c:
        got = c.decode(codes, speaker=1, **kw)
    stream = codecs["stream"].decode(codes, 1, **kw)
    kernel = codecs["kernel"].decode(codes, 1, **kw)
    one_shot = decode_from_codes(
        codecs["kernel"].params, get_config("tiny").model,
        torch.from_numpy(codes)[None], torch.tensor([1]),
        **kw)[0].numpy()
    assert got.shape == (11 * HOP,)
    assert np.array_equal(stream, kernel)
    assert np.array_equal(stream, one_shot)
    assert np.array_equal(got, _wire(kernel))


@pytest.mark.parametrize("mode", sorted(KWS))
def test_codes_session_equals_one_shot(server, mode):
    kw = KWS[mode]
    codes = np.random.default_rng(21).integers(0, 128, 23)
    with CodecClient(socket_path=server["sock"]) as c:
        want = c.decode(codes, speaker=2, **kw)
        with c.open_stream(speaker=2, **kw) as s:
            assert s.granularity_samples == CHUNK * HOP
            assert s.lookahead_samples == 0
            pieces = [s.push_codes(codes[:5]), s.push_codes(codes[5:6]),
                      s.push_codes(codes[6:20]), s.push_codes(codes[20:])]
            pieces.append(s.close())
    assert [len(p) for p in pieces[:4]] == [5 * HOP - HOP // 2, HOP,
                                           14 * HOP, 3 * HOP]
    assert np.array_equal(np.concatenate(pieces), want)


def test_pcm_session_equals_reconstruct(server):
    wav = _tone(1100)
    with CodecClient(socket_path=server["sock"]) as c:
        want, _ = c.reconstruct(wav, greedy=True)
        with c.open_stream(mode="pcm", greedy=True) as s:
            assert s.lookahead_samples > 0
            assert s.granularity_samples == CHUNK * HOP
            pieces = [s.push_pcm(wav[:300]), s.push_pcm(wav[300:301]),
                      s.push_pcm(wav[301:900]), s.push_pcm(wav[900:])]
            pieces.append(s.close())
    assert np.array_equal(np.concatenate(pieces), want)


def test_bad_ids_are_client_errors(server):
    with CodecClient(socket_path=server["sock"]) as c:
        with pytest.raises(ServerError, match="code ids"):
            c.decode([0, 999])
        st = c.open_stream()
        with pytest.raises(ServerError, match="code ids"):
            st.push_codes([0, -1])
        assert c.ping()["ok"] is True   # the daemon is still up


def test_unknown_engine_is_refused(codecs):
    cfg = get_config("tiny")
    with pytest.raises(ValueError, match="engine"):
        Codec(codecs["kernel"].params, cfg, CHUNK, "pallas", "cpu")


def test_greedy_ids_match_jax_stream_engine(server, codecs):
    """Greedy ids of the port's stream engine against the JAX daemon's
    stream engine on the same weights, up to the first step whose top-2
    margin on JAX's own path is under 1e-4 (ROADMAP "Near-ties")."""
    from vqvae_tpu.cli.serve import Codec as JaxCodec
    from vqvae_tpu.infer.fastgen import teacher_forced_scan_logits
    from vqvae_tpu.models.wavenet import upsample_cond
    from vqvae_tpu_torch.audio.mu_law import mu_law_decode
    jp, jcfg = server["jparams"], jax_config("tiny")
    m = jcfg.model
    codes = np.random.default_rng(3).integers(0, 128, 9)
    want_wav = np.asarray(JaxCodec(jp, jcfg, chunk=CHUNK, engine="stream")
                          .decode(codes, speaker=1, greedy=True))
    got_wav = codecs["stream"].decode(codes, 1, greedy=True)
    table = mu_law_decode(torch.arange(m.mu), m.mu,
                          mode=m.mulaw_mode).numpy()

    def ids(w):
        return np.abs(w[:, None] - table[None]).argmin(1)

    want, got = ids(want_wav), ids(got_wav)
    assert np.abs(table[want] - want_wav).max() < 1e-6
    cond = upsample_cond(jp["decoder"], m,
                         jp["vq"]["codebook"][jnp.asarray(codes)][None])
    x_in = np.concatenate([[m.mu // 2], want[:-1]])[None].astype(np.int32)
    lg = np.asarray(teacher_forced_scan_logits(
        jp, m, jnp.asarray(x_in), cond, jnp.asarray([1])))[0]
    top = np.sort(lg, axis=-1)[:, -2:]
    tight = (top[:, 1] - top[:, 0]) < 1e-4
    n = int(np.argmax(tight)) if tight.any() else len(want)
    assert n >= 256, n
    np.testing.assert_array_equal(got[:n], want[:n])
