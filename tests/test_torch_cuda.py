"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these skip on a machine without a GPU.  On the card
(which has no JAX, so without this directory's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import collections
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


@pytest.mark.parametrize("dtype", ["flagship4-bf16", "flagship4-f32"])
def test_kernel_row0_draws_the_rows_of_the_whole_batch(cuda, dtype):
    """Sampled rows r0.. of a batch equal, bit for bit, a launch over
    those rows with row0=r0, one call and resumed (the sharded decode's
    noise); without it the rows draw rows 0..'s noise."""
    cfg = CONFIGS[dtype]
    gp, cond, gcond, _ = _setup(cfg, 5, 200, cuda)
    full = dc.generate_ids(gp, cfg, cond, gcond, 9, 0.8)
    for r0, r1 in ((0, 2), (2, 5), (4, 5)):
        part = dc.generate_ids(gp, cfg, cond[r0:r1], gcond[:, r0:r1], 9,
                               0.8, row0=r0)
        assert torch.equal(part, full[r0:r1]), (r0, r1)
        st = dc.init_decode_state(cfg, r1 - r0, gp.wff.dtype, cuda)
        a, st = dc.generate_ids_resume(gp, cfg, cond[r0:r1, :77],
                                       gcond[:, r0:r1], 9, 0.8, st,
                                       row0=r0)
        b, _ = dc.generate_ids_resume(gp, cfg, cond[r0:r1, 77:],
                                      gcond[:, r0:r1], 9, 0.8, st, row0=r0)
        assert torch.equal(torch.cat([a, b], 1), full[r0:r1])
    # without row0 the rows draw rows 0..'s noise: another stream
    assert not torch.equal(dc.generate_ids(gp, cfg, cond[2:5],
                                           gcond[:, 2:5], 9, 0.8),
                           full[2:5])


# ---- the cluster split: more rows than clusters fit, widths, the query ----


@pytest.mark.parametrize("name", ["flagship4-bf16", "flagship4-f32"])
def test_teacher_logits_kernel_vs_plain_nine_rows(cuda, name):
    # B=9 launches nine 16-block clusters: more than the card runs at
    # once, so some queue behind the others
    cfg = CONFIGS[name]
    gp, cond, gcond, ids = _setup(cfg, 9, 160, cuda)
    got = dc.teacher_logits(gp, cfg, ids, cond, gcond)
    want = dc._plain(gp, cfg, dc.TEACHER, cond, gcond, 0, 1.0,
                     dc.init_decode_state(cfg, 9, gp.wff.dtype, cuda),
                     ids)[0]
    tol = 3e-2 if cfg.compute_dtype == "bfloat16" else 1e-4
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("greedy", [True, False])
def test_kernel_resume_nine_rows_equals_one_call(cuda, greedy):
    cfg = CONFIGS["flagship4-bf16"]
    gp, cond, gcond, _ = _setup(cfg, 9, 640, cuda)
    st0 = dc.init_decode_state(cfg, 9, gp.wff.dtype, cuda)
    one, st1 = dc.generate_ids_resume(gp, cfg, cond, gcond, 11, 0.8, st0,
                                      greedy)
    st, pieces, i = st0, [], 0
    for w in (1, 63, 576):
        x, st = dc.generate_ids_resume(gp, cfg, cond[:, i:i + w], gcond, 11,
                                       0.8, st, greedy)
        pieces.append(x)
        i += w
    assert torch.equal(torch.cat(pieces, 1), one)
    assert st.t0 == st1.t0 == 640
    for a, b in zip(st[1:], st1[1:]):
        assert torch.equal(a, b)


def test_kernel_rejects_widths_the_cluster_does_not_split(cuda):
    cfg = dataclasses.replace(CONFIGS["tiny-f32"], residual_channels=40)
    gp, cond, gcond, ids = _setup(cfg, 2, 10, cuda)
    before = dc.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        dc.generate_ids(gp, cfg, cond, gcond)
    with pytest.raises(ValueError, match="multiple of 16"):
        dc.teacher_logits(gp, cfg, ids, cond, gcond)
    assert dc.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cluster_info_at_the_flagship_width(cuda, dtype):
    info = dc.cluster_info(get_config("vctk-multi").model, dtype)
    assert info["cluster"] == 16
    # the bf16 slices are resident in shared memory; float32 reads L1/L2
    assert info["resident"] == (dtype == torch.bfloat16)
    assert 0 < info["smem_bytes"] <= 232448
    assert info["max_active_clusters"] >= 1


def _thread_sessions(dec, codes, speaker, seed, push=16):
    """A greedy and then a sampled session of ``codes`` through
    ``KernelStreamSession``, ``push`` frames a push: [(waveform, final
    decode state)] for each."""
    import numpy as np
    out = []
    for greedy in (True, False):
        s = dec.session([speaker], seed, 1.0, greedy)
        pieces = [s.push(codes[None, a:a + push])
                  for a in range(0, codes.size, push)]
        pieces.append(s.close())
        out.append((np.concatenate(pieces, 1), s._syn.state))
    return out


def test_sessions_on_four_streams_equal_one_after_another(cuda):
    """Four threads, each on a CUDA stream of its own as the daemon's
    connections are, run a greedy and a sampled 2 s session of the
    flagship model at once: their waveforms (the ids through mu-law,
    one to one) and final decode states equal the same sessions run one
    after another, bit for bit, and the four threads take under 1.6x one
    thread's sessions alone, so the rows' clusters run side by side."""
    import threading
    import time

    import numpy as np

    from vqvae_tpu_torch.infer.kernel_stream import KernelStreamDecoder
    cfg = get_config("vctk-multi").model
    params = init_model(cfg, torch.Generator().manual_seed(0), cuda)
    dec = KernelStreamDecoder(params, cfg)
    rng = np.random.default_rng(4)
    frames = 2 * 16000 // cfg.hop
    work = [(rng.integers(0, cfg.K, frames), 7 * i % cfg.n_speakers, 90 + i)
            for i in range(4)]
    _thread_sessions(dec, work[0][0][:40], 0, 1)   # builds, allocates
    alone, want = [], []
    for w in work:
        t0 = time.perf_counter()
        want.append(_thread_sessions(dec, *w))
        alone.append(time.perf_counter() - t0)
    got, errors = [None] * 4, []

    def run(i):
        try:
            stream = torch.cuda.Stream(cuda)
            stream.wait_stream(torch.cuda.default_stream(cuda))
            with torch.cuda.stream(stream):
                got[i] = _thread_sessions(dec, *work[i])
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    together = time.perf_counter() - t0
    assert not any(t.is_alive() for t in ts)
    if errors:
        raise errors[0]
    for g, w in zip(got, want):
        for (wav_g, st_g), (wav_w, st_w) in zip(g, w):
            assert np.array_equal(wav_g, wav_w)
            assert st_g.t0 == st_w.t0 == frames * cfg.hop
            for a, b in zip(st_g[1:], st_w[1:]):
                assert torch.equal(a, b)
    one = float(np.median(alone))
    print(f"four threads together {together:.3f} s, one alone {one:.3f} s "
          f"({together / one:.3f}x)")
    assert together < 1.6 * one, (together, alone)


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


def _head_inputs(cuda, cdt, N, S=256, mu=256, seed=1):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(cuda, cdt)
    return (rn(N, S), torch.randint(0, mu, (N,), generator=g,
                                    dtype=torch.int32).to(cuda),
            rn(S, S, scale=0.1), rn(S, scale=0.1), rn(S, mu, scale=0.1),
            (torch.randn(mu, generator=g) * 0.1).to(cuda))


# under one 32-row tile, ragged, and more tiles than the card has SMs, so
# that every persistent block of the bf16 kernels walks several tiles
HEAD_ROWS = [1, 31, 1000, 132 * 64 + 37]
HEAD_LOSS_TOL = 1e-4


@pytest.mark.parametrize("N", HEAD_ROWS)
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_head_ce_kernel_vs_plain(cuda, cdt, N):
    args = _head_inputs(cuda, cdt, N)
    lk, lp = hc.fwd_kernel(*args), hc.fwd_plain(*args)
    # x1 is the plain version's to the bit, only the float32 sums of the
    # logits and of the rows differ in order: 1e-4 of the loss (a tile
    # computed wrong moves it by far more), tighter than TRAIN_TOL
    assert abs(float(lk) - float(lp)) <= HEAD_LOSS_TOL * abs(float(lp))
    gg = torch.tensor(1.3, device=cuda)
    for a, b in zip(hc.bwd_kernel(*args, gg), hc.bwd_plain(*args, gg)):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_head_ce_kernels_repeat_bit_equal(cuda, cdt):
    """A second call of each head kernel gives the same bits, and each
    call adds one to its launch count."""
    args = _head_inputs(cuda, cdt, 132 * 64 + 37)
    gg = torch.tensor(0.7, device=cuda)
    before = (hc.launches_fwd, hc.launches_bwd)
    l1, l2 = hc.fwd_kernel(*args), hc.fwd_kernel(*args)
    assert (hc.launches_fwd, hc.launches_bwd) == (before[0] + 2, before[1])
    g1 = hc.bwd_kernel(*args, gg)
    g2 = hc.bwd_kernel(*args, gg)
    assert (hc.launches_fwd, hc.launches_bwd) == (before[0] + 2,
                                                  before[1] + 2)
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


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


# ---- the chunk kernels at a wide shape: many persistent tiles, split-K ----

WIDE_DILS = tuple(2 ** i for i in range(10))      # 1 .. 512


def _wide_case(kind, cdt, R, cuda):
    """(kernel outputs, plain outputs) of one chunk kernel at B=4 and a
    length ragged against every row tile (T=3001; the windowed backward
    takes T=3000 in 3 windows of 1000), the 10 dilations 1..512."""
    T = 3000 if kind == "windowed" else 3001
    args, cots = _chunk_inputs(wt.ACC, cdt, cuda, B=4, T=T, R=R,
                               dils=WIDE_DILS, seed=R)
    dils, _, x, _, _, cond, gc, wff, vc, wr, br, ws, tail = args
    w = (cond, gc, wff, vc, wr, br, ws)
    if kind == "forward":
        return (wt.fwd_kernel(*args),
                wt.fwd_plain(dils, x, *w, tail, True))
    if kind == "save-gates":
        gall = wt.fwd_plain(dils, x, *w, tail, True)[2]
        return (wt.bwd_kernel(*args[:-1], gall, *cots),
                wt.bwd_plain(dils, x, *w, gall, *cots))
    if kind == "recompute":
        return (wt.bwd_rec_kernel(*args[:-1], *cots),
                wt.bwd_rec_plain(dils, x, *w, *cots))
    return (wt.bwd_win_kernel(dils, 3, x, *w, *cots),
            wt.bwd_win_plain(dils, 3, x, *w, *cots))


CHUNK_KINDS = ["forward", "save-gates", "recompute", "windowed"]


@pytest.mark.parametrize("kind", CHUNK_KINDS)
@pytest.mark.parametrize("R", [64, 32])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_chunk_kernels_wide_vs_plain(cuda, kind, R, cdt):
    """Outputs and every gradient within 1e-4 (float32) / 3e-2 (bf16)
    of max of the plain version, at a shape that spreads the products
    over many split-K blocks and each persistent block over many
    tiles."""
    got, want = _wide_case(kind, cdt, R, cuda)
    for a, b in zip(got, want):
        if b is not None:
            assert _rel_err(a, b) <= TRAIN_TOL[cdt]


@pytest.mark.parametrize("kind", CHUNK_KINDS)
def test_chunk_kernels_repeat_bit_equal(cuda, kind):
    """Two calls on the same inputs give bit-equal outputs and
    gradients: every cross-block sum is taken in a fixed order."""
    one, _ = _wide_case(kind, torch.bfloat16, 64, cuda)
    two, _ = _wide_case(kind, torch.bfloat16, 64, cuda)
    for a, b in zip(one, two):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_chunk_forward_gates_do_not_change_h_or_skips(cuda, cdt):
    """fwd_kernel with and without save_gates: bit-equal h and skips."""
    args, _ = _chunk_inputs(wt.EMBED, cdt, cuda, B=4, T=3001,
                            dils=WIDE_DILS)
    h1, s1, g1 = wt.fwd_kernel(*args, save_gates=True)
    h2, s2, g2 = wt.fwd_kernel(*args, save_gates=False)
    assert g1 is not None and g2 is None
    assert torch.equal(h1, h2) and torch.equal(s1, s2)


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


def _vq_far(z, cb):
    s = 2 * (z.double() @ cb.double().T) - (cb.double() ** 2).sum(-1)
    top = s.topk(min(2, cb.shape[0]), -1).values
    if cb.shape[0] == 1:
        return torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    return (top[:, 0] - top[:, 1]) > 1e-4 * float(s.abs().max())


@pytest.mark.parametrize("K,d", [(512, 64), (128, 16)])
@pytest.mark.parametrize("N", [1, 31, 1000, 1920, 7680])
def test_vq_kernel_shapes_repeat_and_one_launch(cuda, N, K, d):
    """Every preset's (K, d): ids equal to the plain version's above the
    1e-4 margin, the same ids from a second call, one launch counted."""
    g = torch.Generator().manual_seed(N + K)
    z = torch.randn(N, d, generator=g).to(cuda)
    cb = torch.randn(K, d, generator=g).to(cuda)
    before = vq_cuda.launches
    got = vq_cuda.vq_argmin(z, cb)
    assert vq_cuda.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (N,)
    assert torch.equal(got, vq_cuda.vq_argmin(z, cb))
    want = vq_cuda.vq_argmin_plain(z, cb)
    assert bool((got == want)[_vq_far(z, cb)].all())


@pytest.mark.parametrize("first,second", [(100, 300), (5, 37), (5, 6),
                                          (3, 127), (200, 511)])
def test_vq_kernel_ties_go_to_the_first_index(cuda, first, second):
    """A code duplicated at two ids, in two slices, one lane or two
    lanes: rows nearest to it take the lower id."""
    g = torch.Generator().manual_seed(7)
    cb = torch.randn(512, 64, generator=g)
    cb[second] = cb[first]
    z = cb[first][None] * (0.8 + 0.4 * torch.rand(300, 1, generator=g)) + \
        0.01 * torch.randn(300, 64, generator=g)
    got = vq_cuda.vq_argmin(z.to(cuda), cb.to(cuda))
    assert bool((got == first).all())


@pytest.mark.parametrize("N,K,d,offset", [(300, 512, 256, 0),
                                          (300, 100, 18, 0),
                                          (300, 3072, 64, 0),
                                          (300, 1100, 20, 0),
                                          (300, 513, 64, 1),
                                          (5, 1, 8, 0), (77, 3, 4, 0)])
def test_vq_kernel_other_sizes_and_layouts(cuda, N, K, d, offset):
    """One z stage (d 256), widths that are not multiples of 4 (zero
    padded), the largest codebook at d 64 (5 passes a slice),
    z and the codebook 4 bytes off a 16-byte boundary (the copies then
    go a value at a time), one code, three: the plain version's ids
    above the margin."""
    g = torch.Generator().manual_seed(K + d)
    zb = torch.randn(N * d + offset, generator=g).to(cuda)
    cbb = torch.randn(K * d + offset, generator=g).to(cuda)
    z, cb = zb[offset:].view(N, d), cbb[offset:].view(K, d)
    got = vq_cuda.vq_argmin(z, cb)
    want = vq_cuda.vq_argmin_plain(z, cb)
    assert bool((got == want)[_vq_far(z, cb)].all())


def test_vq_kernel_refuses_what_does_not_fit(cuda):
    """A quarter of the codebook must fit in shared memory, d <= 256:
    the wrapper raises with the limit."""
    for K, d in ((4096, 64), (512, 300)):
        with pytest.raises(ValueError, match="limit is 232448"):
            vq_cuda.vq_argmin_kernel(torch.zeros(4, d, device=cuda),
                                     torch.zeros(K, d, device=cuda))


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


def _enc_inputs(dev, cdt, B, M0, C=128, d=64, L=5, seed=0):
    """Seeded inputs of the fused encoder at vctk-multi widths (non-zero
    biases), as test_encoder_kernels_vs_plain makes them."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale
    h = torch.relu(rn(B, M0, C)).to(dev, cdt)
    w = [t.to(dev) for t in (rn(L, 4, C, C, scale=(4 * C) ** -0.5),
                             rn(L, C, scale=0.3), rn(C, d, scale=C ** -0.5),
                             rn(d, scale=0.3))]
    return h, w, rn(B, M0 >> L, d).to(dev)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_encoder_kernels_vs_plain_codec_shape(cuda, cdt):
    """The codec's 1 s encode (B=1, M0=8000: 4000 .. 250 rows a layer,
    the small grids the tiles must spread over the card): z and every
    gradient within 1e-4 (float32) / 3e-2 (bfloat16) of its max."""
    h, w, dz = _enc_inputs(cuda, cdt, 1, 8000)
    assert _rel_err(ec.fwd_kernel(h, *w), ec.fwd_plain(h, *w)) \
        <= TRAIN_TOL[cdt]
    for a, b in zip(ec.bwd_kernel(h, *w, dz), ec.bwd_plain(h, *w, dz)):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_encoder_forward_rows_do_not_depend_on_batch_or_length(cuda, cdt):
    """Row b of a B=16 call equals a B=1 call on that row, and the first
    half of the length gives the first rows of z (all but its last, whose
    window reaches past the half), bit for bit: each output sums in one
    order whatever tile the grid picks."""
    h, w, _ = _enc_inputs(cuda, cdt, 16, 3840, seed=2)
    z = ec.fwd_kernel(h, *w)
    for b in range(16):
        assert torch.equal(ec.fwd_kernel(h[b:b + 1].contiguous(), *w)[0],
                           z[b]), b
    zh = ec.fwd_kernel(h[:, :1920].contiguous(), *w)
    assert torch.equal(zh[:, :-1], z[:, :zh.shape[1] - 1])


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_encoder_kernels_repeat_bit_equal(cuda, cdt):
    h, w, dz = _enc_inputs(cuda, cdt, 16, 3840, seed=3)
    assert torch.equal(ec.fwd_kernel(h, *w), ec.fwd_kernel(h, *w))
    for a, b in zip(ec.bwd_kernel(h, *w, dz), ec.bwd_kernel(h, *w, dz)):
        assert torch.equal(a, b)


def test_encoder_dmma_one_tile_layout(cuda):
    """One tile (B=1, 32 rows, one layer): the float64 mma.sync fragments
    of the layer and of the projection against a float64 torch.matmul, on
    small integers, where every sum is exact: z must be equal."""
    g = torch.Generator().manual_seed(4)
    C, d = 128, 64
    h = torch.randint(0, 4, (1, 32, C), generator=g).float()
    wr = torch.randint(-2, 3, (1, 4, C, C), generator=g).float()
    br = torch.randint(-8, 9, (1, C), generator=g).float()
    wp = torch.randint(-2, 3, (C, d), generator=g).float()
    bp = torch.randint(-8, 9, (d,), generator=g).float()
    y = torch.relu(torch.matmul(ec._windows(h, 4, 2).double(),
                                wr[0].reshape(4 * C, C).double()) + br[0])
    want = torch.matmul(y, wp.double()) + bp
    got = ec.fwd_kernel(*(t.to(cuda) for t in (h, wr, br, wp, bp)))
    assert torch.equal(got.cpu().double(), want)


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
    kernel library's split policy (``upsample_cuda.bwd_split`` mirrors
    it): the runs' dW slices and column sums and the column groups' X,
    under dcond's own size."""
    part = uc._scratch("cond_bwd", B, 120, 64, 64, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert part.numel() == uc.bwd_scratch(B, 120, 64, 64, sms)
    assert part.numel() < B * 120 * 64 * 64


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("Tl", [1, 17, 120])
@pytest.mark.parametrize("d", [16, 64])
def test_cond_kernels_grid_vs_plain(cuda, cdt, B, Tl, d):
    """Both upsampler kernels against their plain versions within 1e-4
    (float32) / 3e-2 (bfloat16) of max, at frame counts that are not
    multiples of the 64-row tile (Tl + 1 = 2, 18, 121), one batch row,
    and d = 16 (eight slices, two clusters) as well as 64; a second call
    gives the same bits."""
    e, uwk, ub, dcond = _cond_inputs(cdt, cuda, B, Tl, d=d)
    got = uc.cond_fwd_kernel(e, uwk, ub, 64)
    grads = uc.cond_bwd_kernel(dcond, e, uwk, 64)
    assert _rel_err(got, uc.cond_fwd_plain(e, uwk, ub, 64)) <= TRAIN_TOL[cdt]
    for a, b in zip(grads, uc.cond_bwd_plain(dcond, e, uwk, 64)):
        assert _rel_err(a, b) <= TRAIN_TOL[cdt]
    assert torch.equal(uc.cond_fwd_kernel(e, uwk, ub, 64), got)
    for a, b in zip(uc.cond_bwd_kernel(dcond, e, uwk, 64), grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hop,d", [(6, 32), (2, 16), (8, 48)])
def test_cond_kernels_partial_slices_vs_plain(cuda, hop, d):
    """hop·d not a multiple of the 128-column slice (192, 32, 384 columns;
    a cluster of 2, 1 and 3 blocks), bfloat16 and float32."""
    for cdt in (torch.float32, torch.bfloat16):
        e, uwk, ub, dcond = _cond_inputs(cdt, cuda, 3, 21, hop=hop, d=d)
        got = uc.cond_fwd_kernel(e, uwk, ub, hop)
        assert _rel_err(got, uc.cond_fwd_plain(e, uwk, ub, hop)) <= \
            TRAIN_TOL[cdt]
        for a, b in zip(uc.cond_bwd_kernel(dcond, e, uwk, hop),
                        uc.cond_bwd_plain(dcond, e, uwk, hop)):
            assert _rel_err(a, b) <= TRAIN_TOL[cdt]


def test_cond_backward_split_ms_times_both_launches(cuda):
    """The backward's split by CUDA events names its two launches, each
    timed, and does not count as a launch."""
    e, uwk, _, dcond = _cond_inputs(torch.bfloat16, cuda, 16, 120)
    before = uc.launches["cond_bwd"]
    ms = uc.cond_bwd_split_ms(dcond, e, uwk, 64)
    assert set(ms) == {"tiles", "reduce"} and min(ms.values()) > 0
    assert uc.launches["cond_bwd"] == before


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


def _dot_bodies(cdt, dev, N=32, hop=64, d=64, seed=0):
    """(name, kernel call, plain call) of the dot probe's three
    contractions and its overlap-add on seeded inputs."""
    g = torch.Generator().manual_seed(seed)
    ef = torch.randn(N, d, generator=g).to(dev, cdt)
    W = (torch.randn(hop, d, d, generator=g) * 0.1).to(dev, cdt)
    dp = torch.randn(N, hop, d, generator=g).to(dev)
    x = torch.randn(N * hop, d, generator=g).to(dev, cdt)
    return [("nre", lambda: uc.tap_product_kernel(ef, W),
             lambda: uc.tap_product_plain(ef, W)),
            ("ne", lambda: uc.tap_adjoint_kernel(dp, W),
             lambda: uc.tap_adjoint_plain(dp, W)),
            ("dre", lambda: uc.tap_wgrad_kernel(ef, dp),
             lambda: uc.tap_wgrad_plain(ef, dp)),
            ("ola", lambda: uc.overlap_add_kernel(x, hop),
             lambda: uc.overlap_add_plain(x, hop))]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_dot_probe_kernels_repeat_one_launch_no_scratch(cuda, cdt):
    """At the probe's shape each body allocates nothing but its output,
    counts one launch, and gives the same bits twice."""
    for name, kern, _ in _dot_bodies(cdt, cuda):
        first = kern()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        count = uc.launches["probe_dot"]
        second = kern()
        torch.cuda.synchronize()
        assert uc.launches["probe_dot"] == count + 1, name
        grown = torch.cuda.max_memory_allocated(cuda) - before
        assert grown == second.numel() * second.element_size(), name
        assert torch.equal(first, second), name


def test_vq_and_dot_kernels_run_one_device_kernel_a_call(cuda):
    """Under torch.profiler (one session: CUDA events went missing from
    later sessions in a long test process), each call of the VQ search
    (both presets' (K, d)) and of the dot probe's four bodies (both
    dtypes) runs exactly one device kernel, its own: no transpose, cast,
    scratch fill or second reduction launch."""
    from torch.autograd import DeviceType
    g = torch.Generator().manual_seed(5)
    calls = []
    for N, K, d in ((1920, 512, 64), (31, 128, 16)):
        z = torch.randn(N, d, generator=g).to(cuda)
        cb = torch.randn(K, d, generator=g).to(cuda)
        calls.append(("vq_search",
                      lambda z=z, cb=cb: vq_cuda.vq_argmin(z, cb)))
    names = {"nre": "dot_nre", "ne": "dot_ne", "dre": "dot_dre", "ola": "ola"}
    for cdt in (torch.float32, torch.bfloat16):
        calls += [(names[n], k) for n, k, _ in _dot_bodies(cdt, cuda)]
    for _, fn in calls:   # builds, first-call attributes
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _, fn in calls:
            fn()
            torch.cuda.synchronize()
    got = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(got) == len(calls), got
    want = collections.Counter(k for k, _ in calls)
    assert collections.Counter(
        next((k for k in want if k in name), name) for name in got) == want


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,hop,d", [(1, 6, 8), (33, 20, 24), (100, 64, 64),
                                     (7, 130, 136), (40, 2, 256)])
def test_dot_probe_kernels_grid_vs_plain(cuda, cdt, N, hop, d):
    """Other shapes (row, column and K tiles cut short, several K stages
    a rank): within 1e-4 / 3e-2 of max of the plain versions; the
    overlap-add bit-equal in float32."""
    for name, kern, plain in _dot_bodies(cdt, cuda, N, hop, d, seed=N + d):
        got, want = kern(), plain()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "ola" and cdt == torch.float32:
            assert torch.equal(got, want)
        else:
            assert _rel_err(got, want) <= TRAIN_TOL[cdt], name


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_overlap_add_kernel_odd_widths_and_offsets(cuda, cdt):
    """A width that is not a multiple of 8 and an x 4 bytes off a
    16-byte boundary take the kernel's value-at-a-time path; float32
    stays bit-equal."""
    g = torch.Generator().manual_seed(3)
    for T, d, off in ((100, 12, 0), (64, 64, 1), (9, 8, 0)):
        base = torch.randn(T * d + off, generator=g).to(cuda, cdt)
        x = base[off:].view(T, d)
        for hop in (2, 6, 64):
            got, want = uc.overlap_add_kernel(x, hop), \
                uc.overlap_add_plain(x, hop)
            if cdt == torch.float32:
                assert torch.equal(got, want)
            else:
                assert _rel_err(got, want) <= TRAIN_TOL[cdt]


def test_dot_kernels_refuse_widths(cuda):
    e = torch.zeros(4, 12, device=cuda)
    with pytest.raises(ValueError, match="widths 8..256"):
        uc.tap_product_kernel(e, torch.zeros(3, 12, 12, device=cuda))


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


@pytest.mark.parametrize("L,steps", [(2, 1), (2, 2), (30, 1), (30, 2),
                                     (1, 1), (3, 5), (7, 3), (31, 2)])
def test_decode_chain_kernels_vs_plain(cuda, L, steps):
    """int8 bit-equal to its plain version, bf16 within 3e-2 of max, on
    outputs that are not all zero, at L=2 and at the timed L=30, where
    the weight layer and scale a product reads differ from the ring
    stage it streams into, and at depths below, at and not a multiple of
    the ring's (6 stages bf16, 12 int8)."""
    x, w16, w8, sc = _chain_inputs(L, cuda)
    got8 = chn.chain_kernel(x, w8, steps, sc)
    want8 = chn.chain_int8_plain(x, w8, sc, steps)
    assert float(want8.float().abs().max()) > 0
    assert torch.equal(got8, want8)
    got16 = chn.chain_kernel(x, w16, steps)
    want16 = chn.chain_bf16_plain(x, w16, steps)
    assert float(want16.float().abs().max()) > 0
    assert _rel_err(got16, want16) <= 3e-2


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_chain_kernels_repeat_bit_equal(cuda, int8):
    """Two calls of the chain give the same bits (L=30, 2 steps)."""
    x, w16, w8, sc = _chain_inputs(30, cuda)
    def run():
        return chn.chain_kernel(x, w8, 2, sc) if int8 else \
            chn.chain_kernel(x, w16, 2)
    assert torch.equal(run(), run())


def test_relayout_odd_sizes_and_offsets(cuda):
    """The flat copy is exact where numel is not a multiple of 4 and
    where x starts 1-3 floats past a 16-byte boundary (a contiguous view
    at an odd storage offset, which .contiguous() keeps): its scalar head
    and tail, and float stores where y is aligned otherwise than x."""
    g = torch.Generator().manual_seed(2)
    base = torch.randn(3 * 37 * 37 + 8, generator=g).to(cuda)
    before = uc.launches["probe_reshape"]
    calls = 0
    for src, dst in (((37, 111), (111, 37)), ((37, 111), (3, 37, 37)),
                     ((3, 37, 37), (37, 111)), ((1, 3), (3, 1)),
                     ((2, 2, 2), (4, 2)), ((32, 64), (2048, 1))):
        n = 1
        for s in src:
            n *= s
        for off in range(4):
            x = base[off:off + n].view(src)
            assert x.is_contiguous() and x.storage_offset() == off
            got = uc.relayout_kernel(x, dst)
            calls += 1
            assert got.shape == torch.Size(dst)
            assert torch.equal(got, x.reshape(dst))
    assert uc.launches["probe_reshape"] == before + calls


def test_relayout_and_chain_capture_in_a_cuda_graph(cuda):
    """Both wrappers launch inside a CUDA graph capture (the probes time
    their replays), and a replay gives the eager outputs."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(32, 64 * 64, generator=g).to(cuda)
    xc, w16, w8, sc = _chain_inputs(3, cuda)
    eager = (uc.relayout_kernel(x, (32, 64, 64)),
             chn.chain_kernel(xc, w16, 2), chn.chain_kernel(xc, w8, 2, sc))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (uc.relayout_kernel(x, (32, 64, 64)),
               chn.chain_kernel(xc, w16, 2), chn.chain_kernel(xc, w8, 2, sc))
    for o in out:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


# ---- the composition (upsample.cu::compose) --------------------------------


@pytest.mark.parametrize("E", [32, 128])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("hop", [1, 63, 64])
@pytest.mark.parametrize("N", [1, 7])
def test_compose_kernel_ragged_shapes_vs_plain(cuda, N, hop, d, E):
    """Runs of latent rows cut short, every hop row a block: within 1e-4
    of max of the plain version; each call one launch."""
    g = torch.Generator().manual_seed(N * 1000 + hop * 10 + d + E)
    x = torch.randn(N, d, generator=g).to(cuda)
    w = (torch.randn(d, hop * d, generator=g) * 0.1).to(cuda)
    v = (torch.randn(d, E, generator=g) * 0.1).to(cuda)
    before = uc.launches["probe_compose"]
    got = uc.compose_kernel(x, w, v, hop)
    assert uc.launches["probe_compose"] == before + 1
    want = uc.compose_plain(x, w, v, hop)
    assert got.shape == want.shape == (N * hop, E)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("N,hop,d,E,off", [(33, 5, 30, 30, 0),
                                           (20, 3, 64, 128, 1),
                                           (17, 2, 7, 129, 0)])
def test_compose_kernel_odd_widths_and_offsets(cuda, N, hop, d, E, off):
    """Widths that are not multiples of 4, or an x 4 bytes off a 16-byte
    boundary, take the value-by-value stage: within 1e-4 of max."""
    g = torch.Generator().manual_seed(N + d + E)
    x = torch.randn(N * d + off, generator=g).to(cuda)[off:].view(N, d)
    w = (torch.randn(d, hop * d, generator=g) * 0.1).to(cuda)
    v = (torch.randn(d, E, generator=g) * 0.1).to(cuda)
    got = uc.compose_kernel(x, w, v, hop)
    assert _rel_err(got, uc.compose_plain(x, w, v, hop)) <= 1e-4


def test_compose_kernel_repeats_and_mirrors_its_stage_size(cuda):
    """Two calls give the same bits; ``compose_smem`` is the library's
    own size; a stage past shared memory raises."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(32, 64, generator=g).to(cuda)
    w = (torch.randn(64, 64 * 64, generator=g) * 0.1).to(cuda)
    v = (torch.randn(64, 128, generator=g) * 0.1).to(cuda)
    assert torch.equal(uc.compose_kernel(x, w, v, 64),
                       uc.compose_kernel(x, w, v, 64))
    lib = uc._library()
    for d, E in ((64, 128), (30, 30), (7, 129), (128, 256)):
        assert lib.vqvae_compose_smem(d, E) == uc.compose_smem(d, E)
    with pytest.raises(ValueError, match="shared memory"):
        uc.compose_kernel(torch.zeros(2, 128, device=cuda),
                          torch.zeros(128, 128, device=cuda),
                          torch.zeros(128, 512, device=cuda), 1)


# ---- the embedding gather's backward (csrc/embed.cu) -----------------------

from vqvae_tpu_torch.kernels import embed_cuda as ebc        # noqa: E402


def _take_rows_inputs(cuda, cdt, idt, shape, V, C, seed=0, ids=None):
    g = torch.Generator().manual_seed(seed)
    if ids is None:
        ids = torch.randint(0, V, shape, generator=g)
    cot = torch.randn(*shape, C, generator=g)
    return ids.to(cuda, idt), cot.to(cuda, cdt)


@pytest.mark.parametrize("idt", [torch.int32, torch.int64])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,V,C", [((16, 7680), 256, 64),
                                       ((3, 5), 16, 8),
                                       ((2, 1000), 100, 48)])
def test_take_rows_kernel_vs_plain_repeat_bits(cuda, shape, V, C, cdt, idt):
    """vctk-multi's shape and small ones: within 1e-4 / 3e-2 of max of the
    plain version; a second call gives the same bits; one launch a
    call."""
    ids, g = _take_rows_inputs(cuda, cdt, idt, shape, V, C, seed=V + C)
    before = ebc.launches["take_rows_bwd"]
    got = ebc.take_rows_bwd_kernel(ids, g, V, cdt)
    assert ebc.launches["take_rows_bwd"] == before + 1
    want = ebc.take_rows_bwd_plain(ids, g, V, cdt)
    assert got.shape == want.shape and got.dtype == cdt
    assert _rel_err(got, want) <= TRAIN_TOL[cdt]
    assert torch.equal(ebc.take_rows_bwd_kernel(ids, g, V, cdt), got)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_take_rows_kernel_skewed_and_out_of_range_ids(cuda, cdt):
    """Every id the same (the scatter's worst case), and ids outside
    [0, V) that add nothing: the other rows stay exactly zero."""
    B, T, V, C = 16, 7680, 256, 64
    same = torch.full((B, T), 37, dtype=torch.int64)
    ids, g = _take_rows_inputs(cuda, cdt, torch.int32, (B, T), V, C, ids=same)
    got = ebc.take_rows_bwd_kernel(ids, g, V, cdt)
    want = ebc.take_rows_bwd_plain(ids, g, V, cdt)
    assert _rel_err(got, want) <= TRAIN_TOL[cdt]
    assert not torch.cat([got[:37], got[38:]]).any()
    assert torch.equal(ebc.take_rows_bwd_kernel(ids, g, V, cdt), got)
    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, V, (4, 999), generator=gen)
    raw[0, ::7] = -1
    raw[1, ::5] = V
    raw[2, ::3] = 2 ** 40
    raw[raw == 11] = 12   # row 11 only through out-of-range ids: none
    ids, g = _take_rows_inputs(cuda, cdt, torch.int64, (4, 999), V, C,
                               ids=raw)
    got = ebc.take_rows_bwd_kernel(ids, g, V, cdt)
    assert _rel_err(got, ebc.take_rows_bwd_plain(ids, g, V, cdt)) <= \
        TRAIN_TOL[cdt]
    assert not got[11].any()


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_take_rows_kernel_odd_widths_and_offsets(cuda, cdt):
    """A width whose rows are not 16-byte pieces, a g 2 or 4 bytes off a
    16-byte boundary and a large table take the value-by-value stage or
    shorter chunks: within tolerance, the same bits twice; the library's
    shared-memory size is ``kernel_smem``'s."""
    gen = torch.Generator().manual_seed(4)
    for V, C, off in ((50, 7, 0), (256, 64, 1), (3000, 16, 0)):
        M = 4097
        ids = torch.randint(0, V, (M,), generator=gen).to(cuda, torch.int32)
        base = torch.randn(M * C + off, generator=gen).to(cuda, cdt)
        g = base[off:].view(M, C)
        got = ebc.take_rows_bwd_kernel(ids, g, V, cdt)
        assert _rel_err(got, ebc.take_rows_bwd_plain(ids, g, V, cdt)) <= \
            TRAIN_TOL[cdt]
        assert torch.equal(ebc.take_rows_bwd_kernel(ids, g, V, cdt), got)
    import ctypes
    from vqvae_tpu_torch.kernels.build import build
    lib = ctypes.CDLL(str(build("vqvae_embed", ["embed.cu"])))
    lib.vqvae_take_rows_smem.argtypes = [ctypes.c_int] * 4
    lib.vqvae_take_rows_smem.restype = ctypes.c_longlong
    for V, C, es, isz in ((256, 64, 2, 4), (256, 64, 4, 8), (50, 7, 2, 4),
                          (3000, 16, 4, 4), (1000, 64, 4, 8)):
        assert lib.vqvae_take_rows_smem(V, C, es, isz) == \
            ebc.kernel_smem(V, C, es, isz)
    with pytest.raises(ValueError, match="shared memory"):
        ebc.take_rows_bwd_kernel(ids, g, 100000, cdt)


def test_embed_inputs_backward_runs_the_kernel_not_the_scatter(cuda):
    """vctk-multi's input layer on the card: two kernel calls in its
    backward, within 3e-2 of the plain backward, and no
    indexing_backward_kernel in the profile."""
    from torch.autograd import DeviceType
    from vqvae_tpu_torch.models.wavenet import embed_inputs
    cfg = get_config("vctk-multi").model
    gen = torch.Generator().manual_seed(6)
    w = torch.randn(2, cfg.mu, cfg.residual_channels, generator=gen).to(cuda)
    b = torch.zeros(cfg.residual_channels, device=cuda)
    ids = torch.randint(0, cfg.mu, (16, 7680), generator=gen).to(
        cuda, torch.int32)
    cot = torch.randn(16, 7680, cfg.residual_channels, generator=gen).to(
        cuda, cfg.cdtype)
    w.requires_grad_(True)
    embed_inputs({"emb": {"w": w, "b": b}}, cfg, ids).backward(cot)
    torch.cuda.synchronize()
    w.grad = None
    before = ebc.launches["take_rows_bwd"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        embed_inputs({"emb": {"w": w, "b": b}}, cfg, ids).backward(cot)
        torch.cuda.synchronize()
    assert ebc.launches["take_rows_bwd"] == before + 2
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("take_rows_parts" in n for n in names), names
    assert not any("indexing_backward" in n for n in names), names
    c1 = ebc.take_rows_bwd_plain(ids, cot, cfg.mu, cfg.cdtype).float()
    c0 = ebc.take_rows_bwd_plain(ids[:, :-1], cot[:, 1:], cfg.mu,
                                 cfg.cdtype).float()
    assert _rel_err(w.grad[1], c1) <= 3e-2 and _rel_err(w.grad[0], c0) <= 3e-2


def test_reconstruction_quality_cuda(cuda, tmp_path):
    """tests/test_quality.py on the card: tiny trained 6000 steps with the
    EMA codebook and dead-code restart, its held-out tone reconstructed
    through the one-shot engine (lax) and the daemon's (pallas-stream),
    the speaker-conditioning matrix through the daemon's, held to every
    condition of the JAX gate (``quality_gate``).  Minutes of card time
    (about 3 on an H100)."""
    from vqvae_tpu_torch.quality.quality_check import (
        quality_gate,
        run_quality_check,
    )
    rec = run_quality_check(steps=6000, out_dir=str(tmp_path),
                            engines=("lax", "pallas-stream"),
                            speaker_matrix=True, device=cuda)
    assert quality_gate(rec) == [], rec
