"""``ops/embed.py::take_rows`` and ``ops/conv.py::causal_conv_apply``
against the JAX package (``vqvae_tpu/ops/embed.py``,
``vqvae_tpu/ops/conv.py``), on the same numpy-seeded inputs.

The gather's forward must be equal; its gradient (JAX's one-hot
contraction through ``jax.vjp`` against the port's autograd, whose CPU
backward is the kernel's plain version) within 1e-6 of max in float32,
and within one bf16 ulp of max in bfloat16: the two frameworks sum each
id's rows in different orders before the one rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models.wavenet import embed_inputs as jax_embed_inputs
from vqvae_tpu.ops.conv import causal_conv_apply as jax_causal_conv
from vqvae_tpu.ops.embed import take_rows as jax_take_rows
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.kernels import embed_cuda
from vqvae_tpu_torch.models.wavenet import embed_inputs
from vqvae_tpu_torch.ops.conv import causal_conv_apply
from vqvae_tpu_torch.ops.embed import take_rows

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    """float64 numpy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want):
    a, b = _np(got), _np(want)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _bf16_ulp_of_max(want):
    """One bf16 ulp at max |want| (8 bits of mantissa)."""
    m = float(np.abs(_np(want)).max())
    return float(np.exp2(np.floor(np.log2(max(m, 1e-30))) - 7))


def _close(got, want, dtype):
    if dtype == "float32":
        assert _rel(got, want) <= 1e-6
    else:
        err = float(np.abs(_np(got) - _np(want)).max())
        assert err <= _bf16_ulp_of_max(want), err


def _both_ways(w, ids, g, dtype):
    """(forward, gradient) of take_rows in JAX (jax.vjp) and in the port
    (autograd), on the same numpy inputs in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    jw = jnp.asarray(w, jdt)
    out, vjp = jax.vjp(lambda w_: jax_take_rows(w_, jnp.asarray(ids)), jw)
    (jdw,) = vjp(jnp.asarray(g, jdt))
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    tout = take_rows(tw, torch.from_numpy(ids))
    tout.backward(torch.from_numpy(g).to(tdt))
    return (out, jdw), (tout, tw.grad)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(3, 5), (2, 7680)])
@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("V", [16, 256])
def test_take_rows_matches_jax(V, C, shape, dtype):
    rng = np.random.default_rng(V + C + shape[1])
    w = rng.standard_normal((V, C)).astype(np.float32)
    ids = rng.integers(0, V, shape).astype(np.int32)
    g = rng.standard_normal(shape + (C,)).astype(np.float32)
    (jout, jdw), (tout, tdw) = _both_ways(w, ids, g, dtype)
    assert tout.dtype == DTYPES[dtype][1] and tuple(tout.shape) == jout.shape
    np.testing.assert_array_equal(_np(tout), _np(jout))
    assert tdw.dtype == DTYPES[dtype][1] and tuple(tdw.shape) == (V, C)
    _close(tdw, jdw, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_take_rows_repeated_ids_and_unused_rows(dtype):
    """Ids drawn from a few table rows, each many times: the rows no id
    names get exactly zero, the others JAX's sums."""
    V, C = 256, 64
    rng = np.random.default_rng(7)
    w = rng.standard_normal((V, C)).astype(np.float32)
    used = np.array([0, 3, 17, 200, 255])
    ids = used[rng.integers(0, len(used), (2, 7680))].astype(np.int32)
    g = rng.standard_normal((2, 7680, C)).astype(np.float32)
    (_, jdw), (_, tdw) = _both_ways(w, ids, g, dtype)
    unused = np.setdiff1d(np.arange(V), used)
    assert not tdw[torch.from_numpy(unused)].any()
    assert tdw[torch.from_numpy(used)].abs().min() > 0
    _close(tdw, jdw, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_take_rows_every_id_the_same(dtype):
    """Every row adds into one table row (the scatter's worst case)."""
    V, C = 16, 8
    rng = np.random.default_rng(11)
    w = rng.standard_normal((V, C)).astype(np.float32)
    ids = np.full((2, 7680), 9, np.int32)
    g = rng.standard_normal((2, 7680, C)).astype(np.float32)
    (_, jdw), (_, tdw) = _both_ways(w, ids, g, dtype)
    assert not torch.cat([tdw[:9], tdw[10:]]).any()
    _close(tdw, jdw, dtype)


def test_take_rows_plain_gives_out_of_range_ids_nothing():
    """JAX's one_hot gives an id outside [0, V) a zero row, so it adds
    nothing; the plain version does the same."""
    rng = np.random.default_rng(2)
    V, C = 16, 8
    ids = np.array([[0, 16, 3, -1, 3, 100]], np.int32)
    g = rng.standard_normal((1, 6, C)).astype(np.float32)
    onehot = jax.nn.one_hot(jnp.asarray(ids.reshape(-1)), V)
    want = onehot.T @ jnp.asarray(g.reshape(6, C))
    got = embed_cuda.take_rows_bwd(torch.from_numpy(ids),
                                   torch.from_numpy(g), V, torch.float32)
    assert _rel(got, want) <= 1e-6
    assert not torch.cat([got[1:3], got[4:]]).any()


def test_take_rows_on_cpu_launches_no_kernel():
    before = dict(embed_cuda.launches)
    w = torch.randn(16, 8, requires_grad=True)
    take_rows(w, torch.randint(0, 16, (3, 5))).sum().backward()
    assert w.grad is not None and embed_cuda.launches == before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_inputs_matches_jax(dtype):
    """The decoder's input layer at vctk-multi widths (mu 256, R 64),
    T = 96: the value, and the gradients of emb/w and emb/b for a seeded
    cotangent.  In bfloat16 emb/b's gradient is a plain sum of the
    cotangent over B·T rows, outside take_rows, which XLA on the CPU
    accumulates in bfloat16 (0.52 off the exact sum at a max of 33 for
    this seed, two ulps) and PyTorch in float32: there it is held
    against the exact sum of the same bf16 cotangent, rounded once."""
    jcfg = dataclasses.replace(jax_config("vctk-multi").model,
                               compute_dtype=dtype)
    cfg = dataclasses.replace(get_config("vctk-multi").model,
                              compute_dtype=dtype)
    mu, R, B, T = cfg.mu, cfg.residual_channels, 2, 96
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((2, mu, R)) / np.sqrt(2)).astype(np.float32)
    b = (0.1 * rng.standard_normal(R)).astype(np.float32)
    ids = rng.integers(0, mu, (B, T)).astype(np.int32)
    g = rng.standard_normal((B, T, R)).astype(np.float32)
    cdt = DTYPES[dtype][0]

    def jf(w_, b_):
        return jax_embed_inputs({"emb": {"w": w_, "b": b_}}, jcfg,
                                jnp.asarray(ids))
    jh, vjp = jax.vjp(jf, jnp.asarray(w), jnp.asarray(b))
    jdw, jdb = vjp(jnp.asarray(g, cdt))
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    th = embed_inputs({"emb": {"w": tw, "b": tb}}, cfg, torch.from_numpy(ids))
    th.backward(torch.from_numpy(g).to(cfg.cdtype))
    assert th.dtype == cfg.cdtype and tuple(th.shape) == jh.shape
    np.testing.assert_array_equal(_np(th), _np(jh))
    _close(tw.grad, jdw, dtype)
    if dtype == "float32":
        _close(tb.grad, jdb, dtype)
    else:
        gb = jnp.asarray(g, cdt).astype(jnp.float32)
        exact = np.asarray(gb, np.float64).sum((0, 1))
        _close(tb.grad, jnp.asarray(exact, cdt), dtype)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dilation", [1, 4])
@pytest.mark.parametrize("k", [2, 3])
def test_causal_conv_apply_matches_jax(k, dilation, bias):
    rng = np.random.default_rng(k * 10 + dilation)
    B, T, Ci, Co = 2, 37, 12, 20
    x = rng.standard_normal((B, T, Ci)).astype(np.float32)
    p = {"w": (rng.standard_normal((k, Ci, Co)) / np.sqrt(k * Ci)).astype(
        np.float32)}
    if bias:
        p["b"] = (0.1 * rng.standard_normal(Co)).astype(np.float32)
    want = jax_causal_conv({n: jnp.asarray(a) for n, a in p.items()},
                           jnp.asarray(x), dilation)
    got = causal_conv_apply({n: torch.from_numpy(a) for n, a in p.items()},
                            torch.from_numpy(x), dilation)
    assert tuple(got.shape) == want.shape == (B, T, Co)
    assert _rel(got, want) <= 1e-5
    # causal: output t does not read input t+1 or later
    x2 = x.copy()
    x2[:, 20:] = 0.0
    got2 = causal_conv_apply({n: torch.from_numpy(a) for n, a in p.items()},
                             torch.from_numpy(x2), dilation)
    np.testing.assert_array_equal(got2[:, :20].numpy(), got[:, :20].numpy())
