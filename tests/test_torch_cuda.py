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
