"""The probes' plain versions (``vqvae_tpu_torch/kernels/upsample_cuda.py``,
``decode_chain_cuda.py``) against the JAX probe scripts, at the scripts'
own shapes, on the same numpy-seeded inputs.

The JAX side runs as the scripts run it, on the CPU: the upsampler's
Pallas bodies (imported from ``scripts/cond_inkernel_probe.py``) and the
decode-chain bodies (taken out of ``scripts/decode_int8_micro.py`` with
``ast``: the script times at import) through ``pl.pallas_call(...,
interpret=True)``; the dot and reshape probes' references
(``jnp.einsum``, ``jnp.reshape``, ``jnp.pad``) directly.  The probe
modules run here with ``--device cpu`` (checks, no times).
"""

import ast
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vqvae_tpu.ops.conv import upsample_apply as jax_upsample_apply
from vqvae_tpu_torch.kernels import decode_chain_cuda as chn
from vqvae_tpu_torch.kernels import upsample_cuda as uc
from vqvae_tpu_torch.ops.conv import upsample_apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---- the upsampler: scripts/cond_inkernel_probe.py -------------------------

HOP, D, TL, B, G = 64, 64, 16, 4, 2


@pytest.fixture(scope="module")
def cond_case():
    """The script's data and its Pallas bodies' outputs (interpret mode,
    the script's grid and blocks)."""
    spec = importlib.util.spec_from_file_location(
        "cond_inkernel_probe", os.path.join(SCRIPTS, "cond_inkernel_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    K, T = 2 * HOP, TL * HOP
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((K, D, D)) * 0.1).astype(np.float32)
    bb = (rng.standard_normal((D,)) * 0.1).astype(np.float32)
    e = rng.standard_normal((B, TL, D)).astype(np.float32)
    dcond = rng.standard_normal((B, T, D)).astype(np.float32)
    uwk = np.ascontiguousarray(
        np.transpose(w[::-1], (1, 0, 2)).reshape(D, K * D))
    ub = bb.reshape(1, D)
    grid = (B // G,)

    def gspec(*s):
        return pl.BlockSpec((G,) + s, lambda b: (b,) + (0,) * len(s))

    def cspec(*s):
        return pl.BlockSpec(s, lambda b: (0,) * len(s))
    out = pl.pallas_call(
        functools.partial(probe._cond_fwd_body, HOP, T), grid=grid,
        in_specs=[gspec(TL, D), cspec(D, K * D), cspec(1, D)],
        out_specs=gspec(T, D),
        out_shape=jax.ShapeDtypeStruct((B, T, D), jnp.float32),
        interpret=True)(e, uwk, ub)
    de, duw, dub = pl.pallas_call(
        functools.partial(probe._cond_bwd_body, HOP, T), grid=grid,
        in_specs=[gspec(T, D), gspec(TL, D), cspec(D, K * D)],
        out_specs=[gspec(TL, D), cspec(D, K * D), cspec(1, D)],
        out_shape=[jax.ShapeDtypeStruct((B, TL, D), jnp.float32),
                   jax.ShapeDtypeStruct((D, K * D), jnp.float32),
                   jax.ShapeDtypeStruct((1, D), jnp.float32)],
        interpret=True)(dcond, e, uwk)
    return dict(w=w, b=bb, e=e, dcond=dcond, uwk=uwk, ub=ub,
                pallas=(np.asarray(out), np.asarray(de), np.asarray(duw),
                        np.asarray(dub)))


def test_cond_forward_plain_matches_pallas_body(cond_case):
    """The plain forward against the Pallas body to 1e-5 of max (both
    sum in float32, in other orders)."""
    c = cond_case
    got = uc.cond_fwd_plain(_t(c["e"]), _t(c["uwk"]), _t(c["ub"]), HOP)
    assert _rel(got, c["pallas"][0]) <= 1e-5


def test_cond_forward_plain_matches_upsample_apply(cond_case):
    """... and against both packages' upsample_apply (1e-5 of max)."""
    c = cond_case
    got = uc.cond_fwd_plain(_t(c["e"]), _t(c["uwk"]), _t(c["ub"]), HOP)
    want_jax = jax_upsample_apply({"w": jnp.asarray(c["w"]),
                                   "b": jnp.asarray(c["b"])},
                                  jnp.asarray(c["e"]), HOP)
    want_port = upsample_apply({"w": _t(c["w"]), "b": _t(c["b"])},
                               _t(c["e"]), HOP)
    assert _rel(got, want_jax) <= 1e-5
    assert _rel(got, want_port) <= 1e-5


def test_cond_backward_plain_matches_pallas_body(cond_case):
    """de, duw and dub against the Pallas body's (1e-5 of max)."""
    c = cond_case
    de, duw, dub = uc.cond_bwd_plain(_t(c["dcond"]), _t(c["e"]),
                                     _t(c["uwk"]), HOP)
    _, pde, pduw, pdub = c["pallas"]
    assert _rel(de, pde) <= 1e-5
    assert _rel(duw, pduw) <= 1e-5
    assert _rel(dub, pdub[0]) <= 1e-5


def test_cond_upsample_autograd_matches_jax_vjp(cond_case):
    """The autograd Function's gradients (CPU: the plain versions)
    against jax.vjp of upsample_apply through the probe's packing
    (1e-5 of max)."""
    c = cond_case
    K = 2 * HOP

    def f(e_, uwk_, ub_):
        w_ = jnp.transpose(uwk_.reshape(D, K, D), (1, 0, 2))[::-1]
        return jax_upsample_apply({"w": w_, "b": ub_[0]}, e_, HOP)
    _, vjp = jax.vjp(f, jnp.asarray(c["e"]), jnp.asarray(c["uwk"]),
                     jnp.asarray(c["ub"]))
    want = vjp(jnp.asarray(c["dcond"]))
    e, uwk, ub = (_t(c[k]).clone().requires_grad_(True)
                  for k in ("e", "uwk", "ub"))
    y = uc.cond_upsample(e, uwk, ub, HOP)
    y.backward(_t(c["dcond"]))
    for got, ref in ((e.grad, want[0]), (uwk.grad, want[1]),
                     (ub.grad, want[2])):
        assert got.shape == ref.shape
        assert _rel(got, ref) <= 1e-5


def test_cond_bf16_plain_rounds_once_against_upsample_apply(cond_case):
    """In bf16 the plain forward (one rounding) stays within 3e-2 of max
    of upsample_apply (which rounds the taps' sum, then adds the bias in
    bf16)."""
    c = cond_case
    bf = torch.bfloat16
    got = uc.cond_fwd_plain(_t(c["e"]).to(bf), _t(c["uwk"]).to(bf),
                            _t(c["ub"]), HOP)
    want = upsample_apply({"w": _t(c["w"]).to(bf), "b": _t(c["b"])},
                          _t(c["e"]).to(bf), HOP)
    assert got.dtype == bf and _rel(got.float(), want.float()) <= 3e-2


# ---- the dot probe: scripts/mosaic_dot_probe.py ----------------------------

N = 32


@pytest.fixture(scope="module")
def dot_case():
    rng = np.random.default_rng(0)
    return dict(ef=rng.standard_normal((N, D)).astype(np.float32),
                W=(rng.standard_normal((HOP, D, D)) * 0.1).astype(np.float32),
                dp=rng.standard_normal((N, HOP, D)).astype(np.float32),
                big=rng.standard_normal((N * HOP, D)).astype(np.float32))


@pytest.mark.parametrize("eq", ["nd,rde->nre", "nrd,rde->ne", "nd,nre->dre"])
def test_dot_contractions_match_jnp_einsum(dot_case, eq):
    """Each contraction against jnp.einsum (the probe's reference) to
    1e-5 of max."""
    c = dot_case
    ef, W, dp = _t(c["ef"]), _t(c["W"]), _t(c["dp"])
    got = {"nd,rde->nre": lambda: uc.tap_product(ef, W),
           "nrd,rde->ne": lambda: uc.tap_adjoint(dp, W),
           "nd,nre->dre": lambda: uc.tap_wgrad(ef, dp)}[eq]()
    args = {"nd,rde->nre": ("ef", "W"), "nrd,rde->ne": ("dp", "W"),
            "nd,nre->dre": ("ef", "dp")}[eq]
    want = jnp.einsum(eq, *(jnp.asarray(c[a]) for a in args),
                      preferred_element_type=jnp.float32)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-5


def test_dot_split_and_overlap_add_exact(dot_case):
    """The leading-dim split equals jnp.reshape and the time-axis
    pad/add/slice equals the probe's jnp.pad expression, bit for bit."""
    big = dot_case["big"]
    got = uc.relayout(_t(big), (N, HOP, D))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.reshape(big, (N, HOP, D))))
    x = jnp.asarray(big)
    T = N * HOP
    want = (jnp.pad(x, ((0, HOP), (0, 0)))
            + jnp.pad(x, ((HOP, 0), (0, 0))))[HOP // 2: HOP // 2 + T]
    np.testing.assert_array_equal(uc.overlap_add(_t(big), HOP).numpy(),
                                  np.asarray(want))


# ---- the reshape probe: scripts/mosaic_reshape_probe.py --------------------

@pytest.mark.parametrize("src,dst", [
    ((N, HOP * D), (N * HOP, D)), ((N, HOP, D), (N * HOP, D)),
    ((N, HOP * D), (N, HOP, D)), ((HOP * D, N), (HOP, D, N)),
    ((HOP, D, N), (HOP * D, N))])
def test_reshapes_match_jnp_reshape(src, dst):
    x = np.random.default_rng(0).standard_normal(src).astype(np.float32)
    got = uc.relayout(_t(x), dst)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.reshape(x, dst)))


def test_composition_matches_jax():
    """((x @ w).reshape(N·hop, d)) @ v against the probe's XLA
    reference, 1e-5 of max."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, HOP * D)) * 0.1).astype(np.float32)
    v = (rng.standard_normal((D, 128)) * 0.1).astype(np.float32)
    want = (jnp.asarray(x) @ jnp.asarray(w)).reshape(N * HOP, D) @ \
        jnp.asarray(v)
    got = uc.compose(_t(x), _t(w), _t(v), HOP)
    assert tuple(got.shape) == want.shape and _rel(got, want) <= 1e-5


def _comp_body():
    """The script's ``comp`` Pallas body, from the source of its ``main``
    (never imported: it would run the probe), with the script's N, hop
    and d."""
    path = os.path.join(SCRIPTS, "mosaic_reshape_probe.py")
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in main.body
                if isinstance(n, ast.FunctionDef) and n.name == "comp")
    ns = {"jnp": jnp, "N": N, "hop": HOP, "d": D}
    exec(compile(ast.Module([node], []), path, "exec"), ns)
    return ns["comp"]


def test_composition_plain_matches_pallas_body():
    """The script's ``comp`` body run by ``pl.pallas_call(...,
    interpret=True)`` on its own data (numpy seed 1) against
    ``compose_plain``, within 1e-5 of max."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, HOP * D)) * 0.1).astype(np.float32)
    v = (rng.standard_normal((D, 128)) * 0.1).astype(np.float32)
    want = pl.pallas_call(
        _comp_body(),
        out_shape=jax.ShapeDtypeStruct((N * HOP, 128), jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(v))
    got = uc.compose_plain(_t(x), _t(w), _t(v), HOP)
    assert tuple(got.shape) == want.shape and _rel(got, want) <= 1e-5
    assert np.abs(np.asarray(want)).max() > 0


def test_compose_kernel_refuses_a_stage_past_shared_memory():
    """The kernel stages w's [d, d] slice and v [d, E]: past 227 KB a
    block the wrapper raises before any launch (no fallback)."""
    assert uc.compose_smem(64, 128) == 57344
    with pytest.raises(ValueError, match="shared memory"):
        uc.compose_kernel(torch.zeros(2, 128), torch.zeros(128, 128),
                          torch.zeros(128, 512), 1)


# ---- the decode chain: scripts/decode_int8_micro.py ------------------------


def _micro_bodies(L, STEPS):
    """body_bf16 and body_int8 from the script's source (never imported:
    it times at import), with L and STEPS overridden."""
    path = os.path.join(SCRIPTS, "decode_int8_micro.py")
    tree = ast.parse(open(path).read())
    ns = {"jax": jax, "jnp": jnp, "L": L, "STEPS": STEPS}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in (
                "body_bf16", "body_int8"):
            exec(compile(ast.Module([node], []), path, "exec"), ns)
    return ns["body_bf16"], ns["body_int8"]


def _micro_data(L):
    """The script's draws (numpy seed 0) at L layers, B=64, 2R=128."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(64, 128)), jnp.bfloat16)
    w16 = jnp.asarray(rng.normal(size=(L, 128, 128)) / 16, jnp.bfloat16)
    w8 = jnp.asarray(rng.integers(-127, 127, (L, 128, 128)), jnp.int8)
    sc = jnp.full((L, 1, 1), 1 / 127.0 / 16, jnp.float32)
    return x, w16, w8, sc


@pytest.mark.parametrize("L,steps", [(2, 1), (2, 2)])
def test_decode_chain_plain_matches_pallas_bodies(L, steps):
    """int8: equal to the Pallas body bit for bit; bf16: within one bf16
    ulp of it; both outputs not all zero."""
    body16, body8 = _micro_bodies(L, steps)
    x, w16, w8, sc = _micro_data(L)
    shape = jax.ShapeDtypeStruct((64, 128), jnp.bfloat16)
    j16 = np.asarray(pl.pallas_call(body16, out_shape=shape,
                                    interpret=True)(x, w16), np.float32)
    j8 = np.asarray(pl.pallas_call(body8, out_shape=shape,
                                   interpret=True)(x, w8, sc), np.float32)
    tx, t16, t8, tsc = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                        for a in (x, w16, w8, sc))
    got8 = chn.chain(tx.to(torch.bfloat16), t8.to(torch.int8), steps, tsc)
    got16 = chn.chain(tx.to(torch.bfloat16), t16.to(torch.bfloat16), steps)
    assert np.abs(j8).max() > 0 and np.abs(j16).max() > 0
    np.testing.assert_array_equal(got8.float().numpy(), j8)
    # one bf16 ulp of each element (8 bits of mantissa)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(j16), 1e-30))) - 7)
    assert np.all(np.abs(got16.float().numpy() - j16) <= ulp)


def test_decode_chain_int8_plain_matches_pallas_body_at_depth():
    """At the timed L=30, with the probe's held scales (one per layer,
    which keep the chain from zero), the int8 plain version equals the
    Pallas body bit for bit on outputs that are not all zero."""
    from vqvae_tpu_torch.probes.decode_int8_micro import held_scales
    L = 30
    _, body8 = _micro_bodies(L, 1)
    x, _, w8, _ = _micro_data(L)
    tsc = held_scales(L, torch.device("cpu"))
    sc = jnp.asarray(tsc.numpy())
    shape = jax.ShapeDtypeStruct((64, 128), jnp.bfloat16)
    j8 = np.asarray(pl.pallas_call(body8, out_shape=shape,
                                   interpret=True)(x, w8, sc), np.float32)
    tx, t8 = (torch.from_numpy(np.array(a.astype(jnp.float32)))
              for a in (x, w8))
    got8 = chn.chain(tx.to(torch.bfloat16), t8.to(torch.int8), 1, tsc)
    assert np.abs(j8).max() > 0
    np.testing.assert_array_equal(got8.float().numpy(), j8)


# ---- the probe modules ------------------------------------------------------


@pytest.mark.parametrize("name", ["cond_inkernel", "dot", "reshape",
                                  "decode_int8_micro"])
def test_probe_module_runs_its_checks_on_cpu(name, capsys):
    """``python -m vqvae_tpu_torch.probes.<name> --device cpu``: every
    check within its tolerance, the JSON line last, no times."""
    mod = importlib.import_module(f"vqvae_tpu_torch.probes.{name}")
    mod.main(["--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(last)
    assert rec["probe"] == name and rec["device"] == "cpu"
    assert rec["checks"] and not rec["failed"]
    assert "launches" not in rec
