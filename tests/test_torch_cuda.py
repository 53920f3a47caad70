"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these skip on a machine without a GPU.  On the card
(which has no JAX, so without this directory's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.kernels import decode_cuda as dc
from vqvae_tpu_torch.models import init_model
from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params

pytestmark = pytest.mark.cuda

CONFIGS = {
    "tiny-f32": get_config("tiny").model,
    "flagship4-bf16": dataclasses.replace(get_config("vctk-multi").model,
                                          n_loop=1, n_layer=4),
    "flagship4-f32": dataclasses.replace(get_config("vctk-multi").model,
                                         n_loop=1, n_layer=4,
                                         compute_dtype="float32"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(cfg, B, T, dev):
    g = torch.Generator().manual_seed(0)
    params = init_model(cfg, g, dev)
    gp = make_gen_params(params.decoder, cfg)
    cond = torch.randn(B, T, cfg.d, generator=g).to(dev)
    gcond = global_cond(params.decoder, cfg,
                        torch.arange(B, device=dev) % cfg.n_speakers)
    ids = torch.randint(0, cfg.mu, (B, T), generator=g,
                        dtype=torch.int32).to(dev)
    return gp, cond, gcond, ids


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_teacher_logits_kernel_vs_plain(cuda, name):
    cfg = CONFIGS[name]
    gp, cond, gcond, ids = _setup(cfg, 2, 200, cuda)
    before = dc.launches
    got = dc.teacher_logits(gp, cfg, ids, cond, gcond)
    assert dc.launches == before + 1
    want = dc._plain(gp, cfg, dc.TEACHER, cond, gcond, 0, 1.0,
                     dc.init_decode_state(cfg, 2, gp.wff.dtype, cuda),
                     ids)[0]
    tol = 3e-2 if cfg.compute_dtype == "bfloat16" else 1e-4
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("greedy", [True, False])
def test_kernel_resume_any_split_equals_one_call(cuda, greedy):
    cfg = CONFIGS["flagship4-bf16"]
    gp, cond, gcond, _ = _setup(cfg, 3, 300, cuda)
    one = dc.generate_ids(gp, cfg, cond, gcond, 5, 0.8, greedy)
    st = dc.init_decode_state(cfg, 3, gp.wff.dtype, cuda)
    pieces, i = [], 0
    for w in (1, 127, 0, 172):
        x, st = dc.generate_ids_resume(gp, cfg, cond[:, i:i + w], gcond, 5,
                                       0.8, st, greedy)
        pieces.append(x)
        i += w
    assert torch.equal(torch.cat(pieces, 1), one)
    assert st.t0 == 300


@pytest.mark.parametrize("name", ["flagship4-bf16", "flagship4-f32"])
def test_teacher_logits_from_resumed_state_kernel_vs_plain(cuda, name):
    cfg = CONFIGS[name]
    gp, cond, gcond, ids = _setup(cfg, 2, 300, cuda)
    _, st = dc.generate_ids_resume(
        gp, cfg, cond[:, :130], gcond, 5, 0.8,
        dc.init_decode_state(cfg, 2, gp.wff.dtype, cuda))
    got = dc.teacher_logits(gp, cfg, ids[:, 130:], cond[:, 130:], gcond, st)
    want = dc._plain(gp, cfg, dc.TEACHER, cond[:, 130:], gcond, 0, 1.0, st,
                     ids[:, 130:])[0]
    tol = 3e-2 if cfg.compute_dtype == "bfloat16" else 1e-4
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_kernel_rejects_bad_inputs(cuda):
    cfg = CONFIGS["tiny-f32"]
    gp, cond, gcond, ids = _setup(cfg, 2, 10, cuda)
    with pytest.raises(ValueError, match="gcond"):
        dc.generate_ids(gp, cfg, cond, gcond[:, :1])
    with pytest.raises(ValueError, match="ids_in"):
        dc.teacher_logits(gp, cfg, ids + cfg.mu, cond, gcond)
    with pytest.raises(TypeError):
        dc.generate_ids(gp._replace(wff=gp.wff.half()), cfg, cond, gcond)


# ---- the training kernels (csrc/wavenet_train.cu, csrc/head_ce.cu) ----

from vqvae_tpu_torch.kernels import head_ce_cuda as hc          # noqa: E402
from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt    # noqa: E402

TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / (
        float(want.float().abs().max()) + 1e-30)


def _chunk_inputs(mode, cdt, dev, B=2, T=300, R=64, S=256, d=64, mu=256,
                  dils=(1, 2, 4, 8, 16), seed=0):
    """Seeded chunk inputs with non-zero biases, on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    nl = len(dils)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, cdt)
    w = dict(cond=rn(B, T, d), gc=rn(B, nl, 2 * R, scale=0.3),
             wff=rn(nl, 2 * R, 2 * R, scale=0.1),
             vc=rn(nl, d, 2 * R, scale=0.1), wr=rn(nl, R, R, scale=0.1),
             br=rn(nl, R, scale=0.1), ws=rn(nl, R, S, scale=0.1))
    wemb = bemb = None
    if mode == wt.EMBED:
        x = torch.randint(0, mu, (B, T), generator=g,
                          dtype=torch.int32).to(dev)
        wemb, bemb, tail = rn(2, mu, R, scale=0.5), rn(R, scale=0.1), \
            rn(S, scale=0.1)
    else:
        x = rn(B, T, R, scale=0.5)
        tail = rn(B, T, S, scale=0.3) if mode == wt.ACC else rn(S, scale=0.1)
    cots = (rn(B, T, R, scale=0.1), rn(B, T, S, scale=0.1))
    return (tuple(dils), mode, x, wemb, bemb, *w.values(), tail), cots


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [wt.SEED, wt.ACC, wt.EMBED])
def test_chunk_kernel_vs_plain(cuda, mode, cdt):
    args, (dh, dsk) = _chunk_inputs(mode, cdt, cuda)
    dils, _, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws, tail = args
    before = (wt.launches_fwd, wt.launches_bwd)
    got = wt.fwd_kernel(*args)
    h0 = wt.embed_h(x, wemb, bemb) if mode == wt.EMBED else x
    want = wt.fwd_plain(dils, h0, cond, gc, wff, vc, wr, br, ws, tail,
                        mode == wt.ACC)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]
    gall = want[2]
    got = wt.bwd_kernel(*args[:-1], gall, dh, dsk)
    want = wt.bwd_plain(dils, h0, cond, gc, wff, vc, wr, br, ws, gall, dh,
                        dsk)
    if mode == wt.EMBED:
        want = (None,) + want[1:] + wt.embed_grads_plain(x, want[0], cdt,
                                                         wemb.shape[1])
    for a, b in zip(got, want):
        if b is not None:
            assert _rel_err(a, b) <= TRAIN_TOL[cdt]
    assert (wt.launches_fwd, wt.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_head_ce_kernel_vs_plain(cuda, cdt):
    g = torch.Generator().manual_seed(1)
    N, S, mu = 1000, 256, 256     # N is not a multiple of the row tile

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(cuda, cdt)
    args = (rn(N, S), torch.randint(0, mu, (N,), generator=g,
                                    dtype=torch.int32).to(cuda),
            rn(S, S, scale=0.1), rn(S, scale=0.1), rn(S, mu, scale=0.1),
            (torch.randn(mu, generator=g) * 0.1).to(cuda))
    lk, lp = hc.fwd_kernel(*args), hc.fwd_plain(*args)
    assert abs(float(lk) - float(lp)) <= TRAIN_TOL[cdt] * abs(float(lp))
    gg = torch.tensor(1.3, device=cuda)
    for a, b in zip(hc.bwd_kernel(*args, gg), hc.bwd_plain(*args, gg)):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]


def test_chunk_kernel_rejects_bad_inputs(cuda):
    args, _ = _chunk_inputs(wt.EMBED, torch.float32, cuda, T=40)
    bad = list(args)
    bad[2] = args[2] + 256                 # ids outside the table
    with pytest.raises(ValueError, match="ids"):
        wt.fwd_kernel(*bad)
    bad = list(args)
    bad[6] = args[6][:, :1]                # gc of the wrong layer count
    with pytest.raises(ValueError, match="gc"):
        wt.fwd_kernel(*bad)


# ---- the recompute and windowed backwards and the VQ search (csrc/vq.cu) --

from vqvae_tpu_torch.kernels import vq_cuda                     # noqa: E402


def _want_rec(args, cots):
    dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws, _ = args
    h0 = wt.embed_h(x, wemb, bemb) if mode == wt.EMBED else x
    want = wt.bwd_rec_plain(dils, h0, cond, gc, wff, vc, wr, br, ws, *cots)
    if mode == wt.EMBED:
        return (None,) + want[1:] + wt.embed_grads_plain(
            x, want[0], wemb.dtype, wemb.shape[1])
    return want


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [wt.SEED, wt.ACC, wt.EMBED])
def test_recompute_backward_kernel_vs_plain(cuda, mode, cdt):
    args, cots = _chunk_inputs(mode, cdt, cuda)
    before = wt.launches_bwd_rec
    got = wt.bwd_rec_kernel(*args[:-1], *cots)
    assert wt.launches_bwd_rec == before + 1
    for a, b in zip(got, _want_rec(args, cots)):
        if b is not None:
            assert _rel_err(a, b) <= TRAIN_TOL[cdt]
    h, _, gall = wt.fwd_kernel(*args, save_gates=False)
    assert gall is None and bool(torch.isfinite(h).all())


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,windows", [(wt.SEED, 2), (wt.ACC, 4)])
def test_windowed_backward_kernel_vs_plain(cuda, mode, windows, cdt):
    args, cots = _chunk_inputs(mode, cdt, cuda, T=320)
    dils, _, x, _, _, cond, gc, wff, vc, wr, br, ws, _ = args
    w = (cond, gc, wff, vc, wr, br, ws)
    before = wt.launches_bwd_win
    got = wt.bwd_win_kernel(dils, windows, x, *w, *cots)
    assert wt.launches_bwd_win == before + 1
    want = wt.bwd_win_plain(dils, windows, x, *w, *cots)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]
    with pytest.raises(ValueError, match="bwd_windows"):
        wt.bwd_win_kernel(dils, 3, x, *w, *cots)


@pytest.mark.parametrize("N", [1920, 1000])
def test_vq_kernel_vs_plain(cuda, N):
    """Ids equal wherever the two best scores differ by more than 1e-4
    of the largest score."""
    g = torch.Generator().manual_seed(N)
    z = torch.randn(N, 64, generator=g).to(cuda)
    cb = torch.randn(512, 64, generator=g).to(cuda)
    before = vq_cuda.launches
    got = vq_cuda.vq_argmin(z, cb)
    assert vq_cuda.launches == before + 1 and got.dtype == torch.int32
    s = 2 * (z.double() @ cb.double().T) - (cb.double() ** 2).sum(-1)
    top = s.topk(2, -1).values
    far = (top[:, 0] - top[:, 1]) > 1e-4 * float(s.abs().max())
    want = vq_cuda.vq_argmin_plain(z, cb)
    assert bool((got == want)[far].all())


# ---- the fused encoder (csrc/encoder.cu) ----------------------------------

from vqvae_tpu_torch.kernels import encoder_cuda as ec          # noqa: E402


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_encoder_kernels_vs_plain(cuda, cdt):
    """The fused encoder's forward and recompute backward at vctk-multi
    widths (C=128, d=64, 5 layers, non-zero biases): z and every
    gradient within 1e-4 (float32) / 3e-2 (bfloat16) of its max."""
    g = torch.Generator().manual_seed(0)
    B, M0, C, d, L = 2, 1024, 128, 64, 5

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale
    h = torch.relu(rn(B, M0, C)).to(cuda, cdt)
    w = [t.to(cuda) for t in (rn(L, 4, C, C, scale=(4 * C) ** -0.5),
                              rn(L, C, scale=0.3), rn(C, d, scale=C ** -0.5),
                              rn(d, scale=0.3))]
    dz = rn(B, M0 >> L, d).to(cuda)
    before = (ec.launches_fwd, ec.launches_bwd)
    z = ec.encoder_stack_forward(h, *w)
    grads = ec.encoder_stack_backward(h, *w, dz)
    assert (ec.launches_fwd, ec.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)
    assert grads[0].dtype == cdt and z.dtype == torch.float32
    assert _rel_err(z, ec.fwd_plain(h, *w)) <= TRAIN_TOL[cdt]
    for a, b in zip(grads, ec.bwd_plain(h, *w, dz)):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]


def test_streaming_encoder_with_the_kernel_equals_one_shot(cuda):
    """``encoder_kernel="pallas"`` on the card: the streaming encoder's
    windows give the one-shot codes bit for bit (each output row sums in
    one fixed order, whatever the window)."""
    import numpy as np
    from vqvae_tpu_torch.audio.mu_law import mu_law_round_trip
    from vqvae_tpu_torch.infer.enc_streaming import StreamingEncoder
    from vqvae_tpu_torch.infer.fastgen import encode_to_codes
    cfg = dataclasses.replace(get_config("vctk-multi").model,
                              encoder_kernel="pallas")
    params = init_model(cfg, torch.Generator().manual_seed(1), cuda)
    with torch.no_grad():
        for k, v in params.encoder.state_dict().items():
            if k.endswith(".b"):
                v.copy_(torch.randn(v.shape) * 0.3)
    rng = np.random.default_rng(0)
    wav = (0.3 * rng.standard_normal((1, 40 * cfg.hop + 9))).astype(
        np.float32)
    T = wav.shape[1] // cfg.hop * cfg.hop
    with torch.no_grad():
        want = encode_to_codes(params, cfg, mu_law_round_trip(
            torch.from_numpy(wav[:, :T]), cfg.mu, cfg.mulaw_mode).to(
                cuda)).cpu().numpy()
    for width in (700, 4096):
        enc = StreamingEncoder(params, cfg)
        pieces = [enc.push(wav[:, i:i + width])
                  for i in range(0, wav.shape[1], width)]
        pieces.append(enc.flush())
        np.testing.assert_array_equal(np.concatenate(pieces, 1), want)


# ---- the upsampler and the probes (csrc/upsample.cu) ----------------------

from vqvae_tpu_torch.kernels import upsample_cuda as uc        # noqa: E402
from vqvae_tpu_torch.kernels import decode_chain_cuda as chn   # noqa: E402


def _cond_inputs(cdt, dev, B, Tl, hop=64, d=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(2 * hop, d, d, generator=g) * 0.1
    b = torch.randn(d, generator=g) * 0.1
    uwk, ub = uc.pack_upsampler(w, b)
    e = torch.randn(B, Tl, d, generator=g)
    dcond = torch.randn(B, Tl * hop, d, generator=g)
    return (e.to(dev, cdt), uwk.to(dev, cdt), ub.to(dev), dcond.to(dev))


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tl", [(4, 16), (3, 121)])
def test_cond_upsample_kernels_vs_plain(cuda, cdt, B, Tl):
    """The upsampler's forward and backward kernels: cond and the three
    gradients within 1e-4 (float32) / 3e-2 (bfloat16) of their max, at
    the probe's shape and at a ragged one (Tl+1 frames not a multiple of
    the 64-frame tile)."""
    e, uwk, ub, dcond = _cond_inputs(cdt, cuda, B, Tl)
    before = dict(uc.launches)
    got = uc.cond_forward(e, uwk, ub, 64)
    grads = uc.cond_backward(dcond, e, uwk, 64)
    assert uc.launches["cond_fwd"] == before["cond_fwd"] + 1
    assert uc.launches["cond_bwd"] == before["cond_bwd"] + 1
    assert got.dtype == cdt
    assert _rel_err(got, uc.cond_fwd_plain(e, uwk, ub, 64)) <= TRAIN_TOL[cdt]
    for a, b in zip(grads, uc.cond_bwd_plain(dcond, e, uwk, 64)):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]


@pytest.mark.parametrize("B", [16, 64])
def test_cond_backward_scratch_follows_the_split_policy(cuda, B):
    """The backward's scratch at vctk-multi width (T=7680) comes from the
    kernel library's split policy: a few split-K copies of duw, not one
    per possible split."""
    part = uc._scratch("cond_bwd", B, 120, 64, 64, device=cuda)
    duw = 64 * 2 * 64 * 64
    assert duw <= part.numel() <= 8 * duw


def test_cond_upsample_equals_upsample_apply(cuda):
    """The kernel's cond equals the port's upsample_apply (float32)."""
    from vqvae_tpu_torch.ops.conv import upsample_apply
    g = torch.Generator().manual_seed(3)
    w = torch.randn(128, 64, 64, generator=g) * 0.1
    b = torch.randn(64, generator=g) * 0.1
    e = torch.randn(2, 30, 64, generator=g)
    uwk, ub = uc.pack_upsampler(w, b)
    got = uc.cond_upsample(e.to(cuda), uwk.to(cuda), ub.to(cuda), 64)
    want = upsample_apply({"w": w, "b": b}, e, 64)
    assert _rel_err(got.cpu(), want) <= 1e-4


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_dot_probe_kernels_vs_plain(cuda, cdt):
    """nd,rde->nre, nrd,rde->ne and nd,nre->dre within 1e-4 / 3e-2 of
    max; the time-axis overlap-add within float32 rounding (bit-equal in
    float32) and the leading-dim split bit-equal."""
    g = torch.Generator().manual_seed(0)
    N, hop, d = 32, 64, 64
    ef = torch.randn(N, d, generator=g).to(cuda, cdt)
    W = (torch.randn(hop, d, d, generator=g) * 0.1).to(cuda, cdt)
    dp = torch.randn(N, hop, d, generator=g).to(cuda)
    before = uc.launches["probe_dot"]
    pairs = [(uc.tap_product_kernel(ef, W), uc.tap_product_plain(ef, W)),
             (uc.tap_adjoint_kernel(dp, W), uc.tap_adjoint_plain(dp, W)),
             (uc.tap_wgrad_kernel(ef, dp), uc.tap_wgrad_plain(ef, dp))]
    for a, b in pairs:
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]
    big = torch.randn(N * hop, d, generator=g).to(cuda)
    assert torch.equal(uc.overlap_add_kernel(big, hop),
                       uc.overlap_add_plain(big, hop))
    assert torch.equal(uc.relayout_kernel(big, (N, hop, d), "probe_dot"),
                       big.reshape(N, hop, d))
    assert uc.launches["probe_dot"] == before + 5


def test_reshape_probe_kernels_exact(cuda):
    """The five reshapes are exact copies; the composition within 1e-4
    of max."""
    g = torch.Generator().manual_seed(1)
    N, hop, d = 32, 64, 64
    for src, dst in (((N, hop * d), (N * hop, d)), ((N, hop, d), (N * hop, d)),
                     ((N, hop * d), (N, hop, d)), ((hop * d, N), (hop, d, N)),
                     ((hop, d, N), (hop * d, N))):
        x = torch.randn(*src, generator=g).to(cuda)
        assert torch.equal(uc.relayout_kernel(x, dst), x.reshape(dst))
    x = torch.randn(N, d, generator=g).to(cuda)
    w = (torch.randn(d, hop * d, generator=g) * 0.1).to(cuda)
    v = (torch.randn(d, 128, generator=g) * 0.1).to(cuda)
    before = uc.launches["probe_compose"]
    got = uc.compose_kernel(x, w, v, hop)
    assert uc.launches["probe_compose"] == before + 1
    assert _rel_err(got, uc.compose_plain(x, w, v, hop)) <= 1e-4


def _chain_inputs(L, dev):
    """The micro-benchmark's data (numpy seed 0) at L layers; past L=2
    the int8 scales that keep that chain from zero, one per layer."""
    from vqvae_tpu_torch.probes import decode_int8_micro as dim
    x, w16, w8, sc = dim.script_data(L, dev)
    return x, w16, w8, (sc if L <= 2 else dim.held_scales(L, dev))


@pytest.mark.parametrize("L,steps", [(2, 1), (2, 2), (30, 1), (30, 2)])
def test_decode_chain_kernels_vs_plain(cuda, L, steps):
    """int8 bit-equal to its plain version, bf16 within 3e-2 of max, on
    outputs that are not all zero, at L=2 and at the timed L=30, where
    the weight layer and scale a product reads differ from the parity of
    the buffer it streams into."""
    x, w16, w8, sc = _chain_inputs(L, cuda)
    got8 = chn.chain_kernel(x, w8, steps, sc)
    want8 = chn.chain_int8_plain(x, w8, sc, steps)
    assert float(want8.float().abs().max()) > 0
    assert torch.equal(got8, want8)
    got16 = chn.chain_kernel(x, w16, steps)
    want16 = chn.chain_bf16_plain(x, w16, steps)
    assert float(want16.float().abs().max()) > 0
    assert _rel_err(got16, want16) <= 3e-2
