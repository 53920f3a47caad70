"""The fused encoder (``encoder_kernel="pallas"``) against the JAX
package.

The port's plain versions (``kernels/encoder_cuda.py`` on CPU tensors)
run beside the JAX package's Pallas encoder kernel in interpret mode, as
``tests/test_kernels.py`` runs it: the whole encoder's z and every
encoder-leaf gradient in float32; in both dtypes the kernel pair itself
(layers 2..L and the projection: z and every gradient through the
``autograd.Function`` against ``jax.vjp`` through the ``custom_vjp``, on
the same first-layer output).  The whole encoder's gradients are not
compared in bfloat16: the first layer runs on each package's plain conv,
and JAX rounds each tap group's bf16 product while the port rounds one
float64 sum, so its bf16 output differs by an ulp here and there, and
the ReLU masks and gradients downstream with it.  Then the training
forward with the switch, and the streaming encoder's exactness under
it.  The CUDA kernels are held against these plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.audio.framing import frame_batch as jax_frame_batch
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.kernels.encoder_pallas import _enc_stack, _pack_wq
from vqvae_tpu.models import forward as jax_forward
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.models.encoder import apply_encoder as jax_apply_encoder
from vqvae_tpu_torch.audio.framing import frame_batch
from vqvae_tpu_torch.audio.mu_law import mu_law_round_trip
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree
from vqvae_tpu_torch.infer.enc_streaming import StreamingEncoder
from vqvae_tpu_torch.infer.fastgen import encode_to_codes
from vqvae_tpu_torch.kernels import encoder_cuda as ec
from vqvae_tpu_torch.models import forward
from vqvae_tpu_torch.models.encoder import apply_encoder

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype, **kw):
    """(JAX, port) tiny model configs (Ce=32, d=16, 6 encoder layers)
    with the fused encoder."""
    kw = dict(encoder_kernel="pallas", compute_dtype=dtype, **kw)
    return (dataclasses.replace(jax_config("tiny").model, **kw),
            dataclasses.replace(get_config("tiny").model, **kw))


def _jax_params(jcfg, seed=3):
    """JAX-initialised weights with NONZERO biases (init zeroes them,
    which would hide bias bugs)."""
    params = jax_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    enc = params["encoder"]
    for layer in enc["layers"] + [enc["proj"]]:
        layer["b"] = jnp.asarray(rng.normal(0.0, 0.3, layer["b"].shape),
                                 jnp.float32)
    return params


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_encoder_matches_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    jparams = _jax_params(jcfg)
    rng = np.random.default_rng(0)
    wav = rng.uniform(-0.9, 0.9, (2, 512)).astype(np.float32)
    cot = rng.standard_normal((2, 512 // cfg.hop, cfg.d)).astype(np.float32)

    def f(p):
        z = jax_apply_encoder(p["encoder"], jcfg, jnp.asarray(wav))
        return jnp.sum(z * cot), z
    (_, zj), gj = jax.value_and_grad(f, has_aux=True)(jparams)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)),
                             trainable=True)
    z = apply_encoder(params.encoder, cfg, torch.from_numpy(wav))
    assert z.dtype == torch.float32 and tuple(z.shape) == zj.shape
    assert _rel(z.detach(), zj) <= TOL[dtype]
    if dtype != "float32":   # see the module note
        return
    (z * torch.from_numpy(cot)).sum().backward()
    want = flatten(jax.tree_util.tree_map(np.asarray, gj))
    for k, p in params.encoder.named_parameters():
        w = want["encoder/" + k.replace(".", "/")]
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_kernel_pair_matches_jax_vjp(dtype):
    """The stack behind the first layer: z and (dh0, dW, db, dWp, dbp)
    through ``EncoderStack`` against ``_enc_stack``'s custom VJP."""
    rng = np.random.default_rng(1)
    B, M0, C, d, L = 2, 256, 32, 16, 5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    h = np.array(jnp.asarray(np.maximum(
        rng.standard_normal((B, M0, C)), 0), jdt).astype(jnp.float32))
    wr = (rng.standard_normal((L, 4, C, C)) / np.sqrt(4 * C)).astype(
        np.float32)
    br = rng.normal(0, 0.3, (L, C)).astype(np.float32)
    wp = (rng.standard_normal((C, d)) / np.sqrt(C)).astype(np.float32)
    bp = rng.normal(0, 0.3, d).astype(np.float32)
    dz = rng.standard_normal((B, M0 >> L, d)).astype(np.float32)

    def f(h, wr, br, wp, bp):
        wq = jnp.stack([_pack_wq(w, 2) for w in wr])
        return _enc_stack((2, 4, L, dtype), True, h, wq, br, wp, bp)
    zj, vjp = jax.vjp(f, jnp.asarray(h, jdt), *map(jnp.asarray,
                                                   (wr, br, wp, bp)))
    gj = vjp(jnp.asarray(dz))

    args = [torch.from_numpy(a).requires_grad_() for a in (wr, br, wp, bp)]
    ht = torch.from_numpy(h).to(TORCH_DT[dtype]).requires_grad_()
    z = ec.EncoderStack.apply(2, ht, *args)
    z.backward(torch.from_numpy(dz))
    assert _rel(z.detach(), zj) <= TOL[dtype]
    tol = 1e-4 if dtype == "float32" else TOL[dtype]
    assert ht.grad.dtype == ht.dtype
    for name, got, want in zip(("dh0", "dwr", "dbr", "dwp", "dbp"),
                               [ht.grad] + [a.grad for a in args], gj):
        assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) \
            <= tol, name


def test_forward_with_the_switch_matches_jax():
    """The training forward with ``encoder_kernel="pallas"``: loss,
    metrics and every gradient leaf, at test_torch_train_model.py's
    tolerances."""
    jcfg, cfg = _cfgs("float32", n_loop=1, n_layer=2)
    jparams = _jax_params(jcfg, seed=0)
    rng = np.random.default_rng(0)
    wav = rng.uniform(-0.9, 0.9, (2, 129)).astype(np.float32)
    spk = np.array([0, 3], np.int32)

    def jloss(p):
        batch = jax_frame_batch(jnp.asarray(wav), jnp.asarray(spk), jcfg.mu)
        loss, (metrics, _) = jax_forward(p, jcfg, batch)
        return loss, metrics
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)),
                             trainable=True)
    loss, (metrics, _) = forward(params, cfg, frame_batch(
        torch.from_numpy(wav), torch.from_numpy(spk), cfg.mu))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("loss1", "loss2", "loss3", "codebook_usage"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    want = flatten(jax.tree_util.tree_map(np.asarray, jg))
    for k, p in params.named_parameters():
        w = want[k.replace(".", "/")]
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(w).max()) + 1e-9
        np.testing.assert_allclose(got, w, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-8, err_msg=k)


@pytest.fixture(scope="module")
def switched():
    jcfg, cfg = _cfgs("float32")
    return cfg, from_numpy_tree(flatten(jax.tree_util.tree_map(
        np.asarray, _jax_params(jcfg, seed=5))))


@pytest.mark.parametrize("sizes", [[37], [64], [13, 200, 1], [1000]])
def test_streaming_encoder_under_the_switch_equals_one_shot(switched, sizes):
    cfg, params = switched
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal((2, 9 * cfg.hop + 17)) * 0.3).astype(
        np.float32).clip(-1, 1)
    enc = StreamingEncoder(params, cfg)
    pieces, i = [], 0
    while i < wav.shape[1]:
        n = sizes[len(pieces) % len(sizes)]
        pieces.append(enc.push(wav[:, i:i + n]))
        i += n
    pieces.append(enc.flush())
    T = wav.shape[1] - wav.shape[1] % cfg.hop
    x = mu_law_round_trip(torch.from_numpy(wav[:, :T]), cfg.mu,
                          cfg.mulaw_mode)
    np.testing.assert_array_equal(np.concatenate(pieces, axis=1),
                                  encode_to_codes(params, cfg, x).numpy())


def test_one_layer_encoder_needs_no_kernel(switched):
    """``enc_layers == 1``: the first layer and the projection only, the
    plain encoder's arithmetic (JAX ``encoder_pallas`` :298-301)."""
    cfg, _ = switched
    one = dataclasses.replace(cfg, enc_layers=1)
    from vqvae_tpu_torch.models import init_model
    params = init_model(one, torch.Generator().manual_seed(0))
    wav = torch.rand(2, 6 * one.hop) - 0.5
    before = ec.launches_fwd
    z = apply_encoder(params.encoder, one, wav)
    plain = apply_encoder(params.encoder,
                          dataclasses.replace(one, encoder_kernel="xla"), wav)
    assert torch.equal(z, plain) and ec.launches_fwd == before


@pytest.mark.parametrize("change,needle", [
    (dict(s=3), "stride 2"),
    (dict(k=3), "kernel 4"),
    (dict(C=160), "C <= 128"),
    (dict(M0=36), "halve"),
    (dict(C=48), "multiple of 32"),
])
def test_kernel_wrapper_refuses_shapes_it_does_not_take(change, needle):
    p = dict(s=2, k=4, C=32, M0=64, L=3)
    p.update(change)
    h = torch.zeros(1, p["M0"], p["C"])
    wr = torch.zeros(p["L"], p["k"], p["C"], p["C"])
    with pytest.raises(ValueError, match=needle):
        ec._Args(p["s"], h, wr, torch.zeros(p["L"], p["C"]),
                 torch.zeros(p["C"], 16), torch.zeros(16))


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values rounded to ``dtype`` (nearest even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(TORCH_DT[dtype]).float().numpy()


def _kernel_order_product(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """``x @ w`` in float64 as the card sums it: K in chunks of 16 (one
    ``mma.sync`` m16n8k16 ``.f64`` each), each chunk's partial added to one
    running sum per output, in ascending K; rounded once to float32."""
    acc = np.zeros(x.shape[:-1] + (w.shape[1],))
    for k0 in range(0, x.shape[-1], 16):
        acc += x[..., k0:k0 + 16] @ w[k0:k0 + 16]
    return acc.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_sum_order_rounds_as_the_plain_version(dtype):
    """The argument the FP64 tensor-core forward rests on: each layer's
    taps summed in float64 in the kernel's order (tap by tap, 16-channel
    chunk partials, one running sum), rounded once to float32, then the
    float32 bias, ReLU and cdt rounding, give the plain version's layers
    and z (a float64 DGEMM in its own order) bit for bit at vctk-multi's
    widths."""
    rng = np.random.default_rng(7)
    B, M0, C, d, L = 2, 1024, 128, 64, 5
    h = _round(np.maximum(rng.standard_normal((B, M0, C)), 0), dtype)
    wr = _round(rng.standard_normal((L, 4, C, C)) / np.sqrt(4 * C), dtype)
    br = rng.normal(0, 0.3, (L, C)).astype(np.float32)
    wp = _round(rng.standard_normal((C, d)) / np.sqrt(C), dtype)
    bp = rng.normal(0, 0.3, d).astype(np.float32)

    x, want = h, []
    for i in range(L):
        Mo = x.shape[1] // 2
        xp = np.pad(x, ((0, 0), (1, 1), (0, 0))).astype(np.float64)
        # output row m reads x[2m + j - 1], tap j, one K of 4C in tap order
        win = np.concatenate([xp[:, j:j + 2 * Mo:2] for j in range(4)], -1)
        pre = _kernel_order_product(win, wr[i].reshape(4 * C, C).astype(
            np.float64)) + br[i]
        x = _round(np.maximum(pre, 0), dtype)
        want.append(x)
    z = _kernel_order_product(x.astype(np.float64),
                              wp.astype(np.float64)) + bp

    dt = TORCH_DT[dtype]
    args = [torch.from_numpy(a) for a in (wr, br, wp, bp)]
    ht = torch.from_numpy(h).to(dt)
    layers = ec._layers(ht, args[0].to(dt), args[1], 2)
    for i, (got, w) in enumerate(zip(layers, want)):
        np.testing.assert_array_equal(got.float().numpy(), w,
                                      err_msg=f"layer {i + 2}")
    np.testing.assert_array_equal(ec.fwd_plain(ht, *args).numpy(), z)
