"""Port against JAX: the strided-conv encoder and the nearest-code
search; inside the port, the streaming encoder equals one-shot encode
bit for bit (the contract of tests/test_enc_streaming.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.infer.fastgen import encode_to_codes as jax_encode
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.models.encoder import apply_encoder as jax_apply_encoder
from vqvae_tpu_torch.audio.mu_law import mu_law_round_trip
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.infer.enc_streaming import StreamingEncoder, _support
from vqvae_tpu_torch.infer.fastgen import encode_to_codes
from vqvae_tpu_torch.models.encoder import apply_encoder
from vqvae_tpu_torch.models.vq import quantize

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """Tiny model with NONZERO encoder biases (the regime where stream
    boundary padding matters, as in tests/test_enc_streaming.py)."""
    cfg = get_config("tiny").model
    jparams = jax_init(jax.random.PRNGKey(0), jax_config("tiny").model)
    rng = np.random.default_rng(42)
    enc = jparams["encoder"]
    for layer in enc["layers"] + [enc["proj"]]:
        layer["b"] = jnp.asarray(rng.normal(0.0, 0.5, layer["b"].shape),
                                 layer["b"].dtype)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)))
    return cfg, jparams, params


def _wav(seed, B, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)) * 0.3).astype(np.float32).clip(-1, 1)


def test_apply_encoder_matches_jax(setup):
    cfg, jparams, params = setup
    wav = _wav(0, 2, 9 * cfg.hop)
    want = np.asarray(jax_apply_encoder(jparams["encoder"],
                                        jax_config("tiny").model,
                                        jnp.asarray(wav)))
    got = apply_encoder(params.encoder, cfg, torch.from_numpy(wav)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_codes_match_jax_on_clear_frames(setup):
    cfg, jparams, params = setup
    wav = _wav(1, 3, 40 * cfg.hop)
    want = np.asarray(jax_encode(jparams, jax_config("tiny").model,
                                 jnp.asarray(wav)))
    got = encode_to_codes(params, cfg, torch.from_numpy(wav)).numpy()
    # frames whose top-2 score margin is clear of float rounding
    z = np.asarray(jax_apply_encoder(jparams["encoder"],
                                     jax_config("tiny").model,
                                     jnp.asarray(wav)), np.float64)
    cb = np.asarray(jparams["vq"]["codebook"], np.float64)
    scores = 2 * z @ cb.T - (cb ** 2).sum(-1)
    top = np.sort(scores, axis=-1)[..., -2:]
    clear = (top[..., 1] - top[..., 0]) > 1e-4 * np.abs(scores).max()
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])
    # quantize picks the same rows and returns them
    zt = apply_encoder(params.encoder, cfg, torch.from_numpy(wav))
    e_st, e, idx = quantize(params.vq, zt)
    assert torch.equal(idx, torch.from_numpy(got))
    assert torch.equal(e, params.vq.codebook[idx])
    assert torch.equal(e_st, zt + (e - zt))   # the straight-through value


def _one_shot(params, cfg, wav):
    T = wav.shape[1] - wav.shape[1] % cfg.hop
    x = mu_law_round_trip(torch.from_numpy(wav[:, :T]), cfg.mu,
                          cfg.mulaw_mode)
    return encode_to_codes(params, cfg, x).numpy()


def _stream(params, cfg, wav, sizes):
    enc = StreamingEncoder(params, cfg)
    pieces, i = [], 0
    while i < wav.shape[1]:
        n = sizes[len(pieces) % len(sizes)]
        pieces.append(enc.push(wav[:, i:i + n]))
        i += n
    pieces.append(enc.flush())
    return np.concatenate(pieces, axis=1)


@pytest.mark.parametrize("sizes", [[37], [1000], [64], [13, 200, 1],
                                   [4096]])
def test_streaming_encoder_equals_one_shot(setup, sizes):
    cfg, _, params = setup
    wav = _wav(1, 2, 9 * cfg.hop + 17)
    np.testing.assert_array_equal(_stream(params, cfg, wav, sizes),
                                  _one_shot(params, cfg, wav))


def test_streaming_encoder_short_stream_and_support(setup):
    cfg, _, params = setup
    from vqvae_tpu.infer.enc_streaming import _support as jax_support
    A, B = _support(cfg)
    assert (A, B) == jax_support(jax_config("tiny").model)
    wav = _wav(2, 1, min(B, 2 * cfg.hop))
    enc = StreamingEncoder(params, cfg)
    mid = enc.push(wav)
    assert mid.shape[1] == 0   # stream <= lookahead: push holds all
    out = np.concatenate([mid, enc.flush()], axis=1)
    np.testing.assert_array_equal(out, _one_shot(params, cfg, wav))
