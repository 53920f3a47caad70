"""The port's serving daemon (vqvae_tpu_torch/cli/serve.py) on the CPU,
driven by the JAX package's own client (vqvae_tpu.client.CodecClient)
to prove the wire protocol is unchanged; results held against the JAX
daemon's encoder and the port's one-shot decode."""

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

torch.set_num_threads(1)

SR = 16000


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """Seeded JAX weights (nonzero encoder biases) -> .npz -> the port's
    daemon on a UNIX socket, --device cpu."""
    root = tmp_path_factory.mktemp("torch_serve")
    jcfg = jax_config("tiny").model
    jparams = jax_init(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(0)
    for layer in jparams["encoder"]["layers"] + [jparams["encoder"]["proj"]]:
        layer["b"] = jnp.asarray(rng.normal(0, 0.3, layer["b"].shape),
                                 jnp.float32)
    npz = str(root / "tiny.npz")
    jax_export(npz, jparams)
    sock = str(root / "codec.sock")
    log_path = str(root / "server.log")
    log = open(log_path, "w")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vqvae_tpu_torch.cli.serve", "--preset",
         "tiny", "-m", npz, "--socket", sock, "--device", "cpu",
         "--chunk", "4"],
        stdout=log, stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
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
def port_params(server):
    from vqvae_tpu_torch.cli.common import load_params
    from vqvae_tpu_torch.configs import get_config
    return load_params(server["npz"], get_config("tiny"))


def _tone(n, f=220.0):
    t = np.arange(n) / SR
    wav = 0.5 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(2 * np.pi * 1370 * t)
    # what the int16 PCM transport carries
    return (np.round(wav * 32767) / 32767).astype(np.float32)


def test_ping_reports_kernel_engine(server):
    with CodecClient(socket_path=server["sock"]) as c:
        r = c.ping()
    assert r["engine"] == "kernel" and r["device"] == "cpu"
    assert r["sr"] == SR and r["hop"] == 64 and r["n_speakers"] == 4
    assert r["realtime_x"] > 0 and r["session_realtime_x"] > 0
    assert r["kernel_launches"] == 0   # CPU: the plain version only


def test_encode_matches_jax_codec(server):
    from vqvae_tpu.audio.mu_law import mu_law_round_trip_jit
    from vqvae_tpu.cli.serve import Codec as JaxCodec
    from vqvae_tpu.models.encoder import apply_encoder
    jcfg = jax_config("tiny")
    wav = _tone(3000)
    with CodecClient(socket_path=server["sock"]) as c:
        got = c.encode(wav)
    jp = server["jparams"]
    want = JaxCodec(jp, jcfg, chunk=4).encode(wav)
    assert got.shape == want.shape == (3000 // 64,)
    T = 3000 // 64 * 64
    x = mu_law_round_trip_jit(jnp.asarray(wav[None, :T]), 256, "round")
    z = np.asarray(apply_encoder(jp["encoder"], jcfg.model, x), np.float64)[0]
    cb = np.asarray(jp["vq"]["codebook"], np.float64)
    scores = 2 * z @ cb.T - (cb ** 2).sum(-1)
    top = np.sort(scores, -1)[:, -2:]
    clear = (top[:, 1] - top[:, 0]) > 1e-4 * np.abs(scores).max()
    assert clear.mean() > 0.8, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])


def test_decode_matches_port_library(server, port_params):
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.infer.fastgen import decode_from_codes
    codes = np.random.default_rng(5).integers(0, 128, 11)
    with CodecClient(socket_path=server["sock"]) as c:
        got = c.decode(codes, speaker=1, greedy=True)
    want = decode_from_codes(port_params, get_config("tiny").model,
                             torch.from_numpy(codes)[None],
                             torch.tensor([1]), greedy=True)[0].numpy()
    assert got.shape == (11 * 64,)
    np.testing.assert_allclose(got, want, atol=1.0 / 32767)


def test_codes_session_equals_one_shot(server):
    codes = np.random.default_rng(21).integers(0, 128, 23)
    with CodecClient(socket_path=server["sock"]) as c:
        for kw in ({"greedy": True}, {"seed": 9, "temperature": 0.9}):
            want = c.decode(codes, speaker=2, **kw)
            with c.open_stream(speaker=2, **kw) as s:
                assert s.granularity_samples == 64
                pieces = [s.push_codes(codes[:5]), s.push_codes(codes[5:6]),
                          s.push_codes(codes[6:20]), s.push_codes(codes[20:])]
                pieces.append(s.close())
            got = np.concatenate(pieces)
            assert np.array_equal(got, want), kw


def test_pcm_session_equals_reconstruct(server):
    wav = _tone(1100)
    with CodecClient(socket_path=server["sock"]) as c:
        want, _ = c.reconstruct(wav, greedy=True)
        with c.open_stream(mode="pcm", greedy=True) as s:
            assert s.lookahead_samples > 0
            pieces = [s.push_pcm(wav[:300]), s.push_pcm(wav[300:301]),
                      s.push_pcm(wav[301:900]), s.push_pcm(wav[900:])]
            pieces.append(s.close())
    assert np.array_equal(np.concatenate(pieces), want)


def test_bad_ids_are_client_errors(server):
    import json
    import socket
    sk = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sk.connect(server["sock"])
    reqs = [{"op": "decode", "codes": [1, 128, 3]},
            {"op": "decode", "codes": [-1, 2]},
            {"op": "decode", "codes": [1, 2], "speaker": 4},
            {"op": "stream_open", "speaker": -1},
            {"op": "ping"}]
    with sk, sk.makefile("rwb") as f:
        out = []
        for r in reqs:
            f.write(json.dumps(r).encode() + b"\n")
            f.flush()
            out.append(json.loads(f.readline()))
    for r in out[:-1]:
        assert r["ok"] is False and r["error_kind"] == "client", r
    assert out[-1]["ok"] is True   # the daemon is still up
    with CodecClient(socket_path=server["sock"]) as c:
        st = c.open_stream()
        with pytest.raises(ServerError, match="code ids"):
            st.push_codes([0, 999])
        assert c.stats()["ops"]["decode"]["errors"] >= 3


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from vqvae_tpu_torch.cli.serve import Codec
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.models import init_model
    cfg = get_config("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        Codec(init_model(cfg.model), cfg, device="cuda")


def test_port_client_round_trip_matches_jax_client(server):
    """The port's own client (vqvae_tpu_torch.client) against the same
    daemon: ping, encode, decode, reconstruct and a codes-mode session
    give the JAX client's answers."""
    from vqvae_tpu_torch.client import CodecClient as PortClient
    from vqvae_tpu_torch.client import ServerError as PortServerError
    wav = _tone(2000)
    codes = np.random.default_rng(8).integers(0, 128, 13)
    answers = []
    for client in (PortClient, CodecClient):
        with client(socket_path=server["sock"]) as c:
            ping = c.ping()
            enc = c.encode(wav)
            dec = [c.decode(codes, speaker=1, greedy=True),
                   c.decode(codes, speaker=1, seed=4, temperature=0.9)]
            rec, rcodes = c.reconstruct(wav, greedy=True)
            with c.open_stream(speaker=1, greedy=True) as s:
                pieces = [s.push_codes(codes[:4]), s.push_codes(codes[4:])]
                pieces.append(s.close())
            answers.append((ping, enc, dec, rec, rcodes,
                            np.concatenate(pieces)))
    port, jax_ = answers
    assert port[0] == jax_[0]
    assert port[1].dtype == np.int32 and np.array_equal(port[1], jax_[1])
    for a, b in zip(port[2], jax_[2]):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(port[3], jax_[3])
    assert np.array_equal(port[4], jax_[4]) and np.array_equal(port[4],
                                                               port[1])
    assert np.array_equal(port[5], port[2][0])
    with PortClient(socket_path=server["sock"]) as c:
        with pytest.raises(PortServerError, match="code ids"):
            c.decode([0, 999])


def test_port_client_loads_without_jax():
    """``import vqvae_tpu_torch.client`` loads neither JAX nor the JAX
    package (``import vqvae_tpu.client`` does, through the package)."""
    import subprocess
    import sys
    code = ("import sys, vqvae_tpu_torch.client\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vqvae_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stdout + r.stderr


def test_session_rate_guard(server, port_params, monkeypatch):
    """The session-rate guard: ``measure_session_realtime`` is the audio
    of one ``chunk``-frame push over the median push time, the fill and
    warm pushes left out; the daemon reports it in ``ping`` as
    ``session_realtime_x`` and warns at startup when it is below 1."""
    from types import SimpleNamespace

    import vqvae_tpu_torch.cli.serve as serve_mod
    from vqvae_tpu_torch.configs import get_config
    cfg = get_config("tiny")
    clock = [100.0]
    pushes = [9.0, 9.0, 0.1, 0.3, 0.2, 0.4, 0.25, 0.15, 0.35, 0.05]

    class FakeSession:
        def push(self, codes):
            assert codes.shape == (1, 4)
            clock[0] += pushes.pop(0)

        def close(self):
            pass

    codec = serve_mod.Codec(port_params, cfg, chunk=4, device="cpu")
    monkeypatch.setattr(codec, "_session_decoder", lambda *a: FakeSession())
    monkeypatch.setattr(serve_mod, "time",
                        SimpleNamespace(monotonic=lambda: clock[0]))
    got = codec.measure_session_realtime(n_push=8)
    audio_s = 4 * 64 / 16000
    assert got == codec.session_realtime_x == round(audio_s / 0.225, 2)
    assert not pushes
    # the running daemon: ping carries its startup measurement, and the
    # startup warning appears exactly when it is below realtime
    with CodecClient(socket_path=server["sock"]) as c:
        srt = c.ping()["session_realtime_x"]
    log = open(server["log"]).read()
    assert f"sustained session pushes: {srt}x at 4 frames/push" in log
    assert ("WARNING: sustained session pushes are below realtime" in log) \
        == (srt < 1.0)
