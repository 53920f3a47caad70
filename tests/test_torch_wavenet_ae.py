"""NSynth's WaveNet autoencoder in the port (``models/wavenet_ae.py``)
against its plain reference (``portbench/reference/wavenet_ae.py``) on
seeded random weights at a small size on the CPU, the equations checked
directly, its training through the port's normal path, and the codec
tools refusing it.

The small size: width 32, skip 32, encoder width 16, 2 stages x 2
layers on both sides, filter 3, a 64-sample hop, a 4-channel
bottleneck, 3 rows of 256 samples (4 frames).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.audio.framing import frame_scalar
from vqvae_tpu_torch.audio.mu_law import mu_law_floor
from vqvae_tpu_torch.configs import WaveNetAEConfig, get_config, load_config
from vqvae_tpu_torch.models import wavenet_ae as W
from vqvae_tpu_torch.models.params import ParamTree
from vqvae_tpu_torch.train import step as step_mod
from vqvae_tpu_torch.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from vqvae_tpu_torch.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from _ae_layers import per_op_layers  # noqa: E402
from portbench import weights, weights_ae  # noqa: E402
from portbench.reference import wavenet_ae as ref  # noqa: E402

torch.set_num_threads(1)

SMALL = WaveNetAEConfig(width=32, skip_width=32, num_stages=2, num_layers=4,
                        ae_num_stages=2, ae_num_layers=4, ae_width=16,
                        ae_bottleneck_width=4, ae_hop_length=64,
                        compute_dtype="float32")
T = 256


def _weights(seed=5, cfg=SMALL):
    return weights_ae.make(dataclasses.asdict(cfg), seed, "cpu")


def _slices(seed=1, B=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(B, T + 1, generator=g) * 1.8 - 0.9


def _program(p0, cfg=SMALL):
    return ParamTree(weights.nest({k: v.clone() for k, v in p0.items()}),
                     trainable=True)


def _grads(loss, named):
    loss.backward()
    return {k: p.grad.clone() for k, p in named}


def test_framing_is_magentas_mu_law():
    x = torch.tensor([-1.0, -0.5, -1e-4, 0.0, 1e-4, 0.25, 0.999, 1.0])
    ids = mu_law_floor(x)
    q = torch.floor(128 * torch.sign(x) * torch.log1p(255 * x.abs())
                    / np.log(256.0)).clamp(-128, 127)
    assert ids.tolist() == (q + 128).long().tolist()
    assert ids.min() >= 0 and ids.max() == 255     # x = 1 clipped to 127
    b = frame_scalar(torch.stack([x, -x]))
    assert torch.equal(b.targets[0], ids[1:])
    assert torch.equal(b.xs[0], (ids[1:] - 128).float() / 128)
    assert torch.equal(b.xs_prev[0], (ids[:-1] - 128).float() / 128)
    xp, xs, tg = ref.frame(torch.stack([x, -x]), 256)
    assert torch.equal(xp, b.xs_prev) and torch.equal(xs, b.xs)
    assert torch.equal(tg, b.targets.long())


def test_logits_loss_and_every_gradient_equal_the_reference():
    """Float32 on both sides: the program takes each k-tap conv as one
    product over the shifted copies, the reference one product a tap,
    and the pool before the bottleneck's 1x1, so the sums run in other
    orders; 2e-5 of the largest magnitude bounds float32 round-off over
    these depths (the worst seen is 5e-7)."""
    p0 = _weights()
    slices = _slices()
    params = _program(p0)
    batch = frame_scalar(slices)
    lg = W.apply(params, SMALL, batch)
    loss, _ = W.forward(params, SMALL, batch)
    got = _grads(loss, ((k.replace(".", "/"), p)
                        for k, p in params.named_parameters()))

    pr = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    m = dataclasses.asdict(SMALL)
    xp, xs, tg = ref.frame(slices, 256)
    want_lg = ref.logits(pr, m, xp, xs)
    want_loss = ref.loss(pr, m, slices)
    want = _grads(want_loss, pr.items())

    assert lg.dtype == torch.float32 and lg.shape == (3, T, 256)
    torch.testing.assert_close(lg, want_lg, rtol=0,
                               atol=2e-5 * float(want_lg.detach().abs().max()))
    torch.testing.assert_close(loss, want_loss, rtol=2e-6, atol=0)
    assert got.keys() == want.keys() and len(got) == 26
    for k, g in want.items():
        torch.testing.assert_close(got[k], g, rtol=0,
                                   atol=2e-5 * float(g.abs().max()),
                                   msg=k)


def test_bf16_compute_stays_near_the_reference():
    """bf16 activations and products (8 bits of mantissa, ~4e-3 a
    rounding) through 4 + 4 layers: the logits within 3% of their
    largest magnitude and the loss (a mean, whose roundings average
    out) within 2e-3 relative; seen: 0.7% and 1.9e-4.  A float32
    program is held 1000x tighter above."""
    cfg = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    p0 = _weights()
    slices = _slices()
    params = _program(p0, cfg)
    batch = frame_scalar(slices)
    m = dataclasses.asdict(cfg)
    xp, xs, _ = ref.frame(slices, 256)
    with torch.no_grad():
        lg = W.apply(params, cfg, batch)
        want = ref.logits(p0, m, xp, xs)
        loss = float(W.forward(params, cfg, batch)[0])
        want_loss = float(ref.loss(p0, m, slices))
    assert lg.dtype == torch.float32
    assert float((lg - want).abs().max()) < 0.03 * float(want.abs().max())
    assert abs(loss - want_loss) < 2e-3 * want_loss


def _decode(params, cfg, xs_prev, z):
    cond, hc = W.cond_maps(params["decoder"], cfg, z)
    s = W.decoder_stack(params["decoder"], cfg, xs_prev, cond)
    return W.head_logits(params["decoder"]["head"], cfg, s, hc)


def test_an_input_sample_moves_only_later_logits():
    """With the latent held, changing the decoder's input at t (the
    sample before target t) moves the logits at t and after only."""
    params = _program(_weights())
    batch = frame_scalar(_slices())
    z = W.bottleneck(params["encoder"]["bottleneck"], SMALL,
                     W.encoder(params["encoder"], SMALL, batch.xs))
    base = _decode(params, SMALL, batch.xs_prev, z)
    for t0 in (0, 37, 130, T - 1):
        xp = batch.xs_prev.clone()
        xp[:, t0] += 0.5
        out = _decode(params, SMALL, xp, z)
        assert torch.equal(out[:, :t0], base[:, :t0]), t0
        assert (out[:, t0] - base[:, t0]).abs().max() > 1e-4, t0


def test_a_frames_latent_moves_only_its_samples_condition():
    """A change to frame f's latent moves each layer's condition (and so
    the first layer's gate input) on frame f's 64 samples alone; the
    logits before the frame stay, and those inside it move (later ones
    move too, through the causal stack)."""
    params = _program(_weights())
    batch = frame_scalar(_slices())
    z = W.bottleneck(params["encoder"]["bottleneck"], SMALL,
                     W.encoder(params["encoder"], SMALL, batch.xs))
    hop, B = SMALL.hop, z.shape[0]
    base = _decode(params, SMALL, batch.xs_prev, z)
    c0, h0 = W.cond_maps(params["decoder"], SMALL, z)
    zero = torch.zeros(B, T, 2 * SMALL.width)
    for f in (0, 2, 3):
        z2 = z.clone()
        z2[:, f] += 0.7
        c2, h2 = W.cond_maps(params["decoder"], SMALL, z2)
        for i in range(SMALL.num_layers):
            moved = (W._tile(zero, c2[i], hop) - W._tile(zero, c0[i], hop))
            rows = moved.abs().amax((0, 2)) > 0
            assert rows.nonzero().flatten().tolist() == \
                list(range(f * hop, (f + 1) * hop))
        out = _decode(params, SMALL, batch.xs_prev, z2)
        assert torch.equal(out[:, :f * hop], base[:, :f * hop])
        assert (out[:, f * hop:(f + 1) * hop]
                - base[:, f * hop:(f + 1) * hop]).abs().amax(-1).min() > 0


def test_the_encoder_is_not_causal():
    """The encoder's output at t moves with the input at t + 1 (its
    first conv's tap) and at t + d of a dilated layer."""
    params = _program(_weights())
    xs = frame_scalar(_slices()).xs
    base = W.encoder(params["encoder"], SMALL, xs)
    for t0 in (10, 100):
        x2 = xs.clone()
        x2[:, t0 + 1] += 0.5
        out = W.encoder(params["encoder"], SMALL, x2)
        assert (out[:, t0] - base[:, t0]).abs().max() > 1e-4
        # nothing outside the reach on either side: the first conv's 1,
        # then each dilated layer's d
        reach = 1 + sum(SMALL.ae_dilations)
        lo, hi = max(t0 + 1 - reach, 0), t0 + 2 + reach
        assert lo > 0 and torch.equal(out[:, :lo], base[:, :lo])
        assert torch.equal(out[:, hi:], base[:, hi:])
        assert (out[:, lo] - base[:, lo]).abs().max() > 0


def test_the_gate_takes_the_sigmoid_of_the_first_half():
    """With every product zeroed but the skips' (an identity), each
    layer adds ``sigmoid(a) tanh(b)`` for the condition's halves a, b."""
    cfg = dataclasses.replace(SMALL, skip_width=SMALL.width)
    p0 = {k: torch.zeros_like(v) for k, v in _weights(cfg=cfg).items()}
    R, L = cfg.width, cfg.num_layers
    p0["decoder/layers/bf"][:, :R] = 2.0          # a
    p0["decoder/layers/bf"][:, R:] = 0.5          # b
    p0["decoder/layers/ws"][:] = torch.eye(R)
    params = _program(p0, cfg)
    xp = frame_scalar(_slices()).xs_prev
    cond, _ = W.cond_maps(params["decoder"], cfg, torch.zeros(3, 4, 4))
    s = W.decoder_stack(params["decoder"], cfg, xp, cond)
    want = L * torch.sigmoid(torch.tensor(2.0)) * torch.tanh(
        torch.tensor(0.5))
    torch.testing.assert_close(s, torch.full_like(s, float(want)))


def _tiny_preset():
    cfg = get_config("nsynth-h512")
    return cfg.replace(model=SMALL,
                       data=dataclasses.replace(cfg.data, length=T),
                       train=dataclasses.replace(cfg.train, batch_size=3))


def test_train_step_and_state_take_the_autoencoder():
    cfg = _tiny_preset()
    state = create_train_state(cfg, "cpu")
    assert state.vq_state is None and len(state.opt.param_groups) == 1
    w0 = {k: v.detach().clone() for k, v in state.params.named_parameters()}
    slices = _slices()
    losses = [float(step_mod.train_step(state, slices, torch.zeros(3),
                                        cfg)["loss"]) for _ in range(3)]
    assert state.step == 3 and losses[2] < losses[0]
    for k, v in state.params.named_parameters():
        assert not torch.equal(v, w0[k]), k
    with pytest.raises(ValueError, match="one device"):
        create_train_state(cfg, "cpu", mesh=object())


def test_the_step_returns_each_crops_loss():
    """``crop_loss`` holds each crop's own loss (the reference's, both in
    float32: rtol 1e-5 for sums taken in other orders), and the loss is
    their mean."""
    cfg = _tiny_preset()
    state = create_train_state(cfg, "cpu")
    p0 = {k.replace(".", "/"): v.detach().clone()
          for k, v in state.params.named_parameters()}
    slices = _slices(seed=4)
    met = step_mod.train_step(state, slices, torch.zeros(3), cfg)
    assert met["crop_loss"].shape == (3,) and met["loss"].dim() == 0
    torch.testing.assert_close(met["loss"], met["crop_loss"].mean())
    want = torch.stack([ref.loss(p0, dataclasses.asdict(SMALL),
                                 slices[i:i + 1]) for i in range(3)])
    torch.testing.assert_close(met["crop_loss"], want, rtol=1e-5, atol=0)
    assert set(step_mod.eval_step(state.params, slices, torch.zeros(3),
                                  cfg)) == {"loss"}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dil", [1, 3, 40])
def test_tap_conv_and_its_gradients_equal_shifted_sums(causal, dil):
    """``_TapConv`` against ``sum_j x[t + o_j] @ w[j]`` in float64, with
    taps that reach past both ends (``dil`` 40 on 30 samples) and a
    gradient that arrives as a strided view."""
    g = torch.Generator().manual_seed(dil)
    x = torch.randn(2, 30, 5, generator=g, dtype=torch.float64)
    w = torch.randn(3, 5, 7, generator=g, dtype=torch.float64)
    offs = W.causal_offsets(3, dil) if causal else W.same_offsets(3, dil)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = W.tap_conv(xa, wa, offs)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = sum(ref._shifted(xb, o) @ wb[j] for j, o in enumerate(offs))
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    gy = torch.randn(2, 7, 30, generator=g, dtype=torch.float64)
    (y * gy.transpose(1, 2)).sum().backward()
    (want * gy.transpose(1, 2)).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-12, atol=1e-12)


def _per_op_decoder_stack(p, cfg, xs_prev, cond):
    """``W.decoder_stack`` as separate ops (``per_op_layers``)."""
    cdt, R, k = cfg.cdtype, cfg.width, cfg.filter_length
    B, T = xs_prev.shape
    lay = p["layers"]
    l = W.tap_conv(xs_prev[..., None].to(cdt), p["start"]["w"].to(cdt),
                   W.causal_offsets(k, 1)) + p["start"]["b"].to(cdt)
    s = torch.addmm(p["skip_start"]["b"].to(cdt), l.view(B * T, R),
                    p["skip_start"]["w"].to(cdt))
    return per_op_layers(l, s, cond, *(lay[n].to(cdt) for n in
                                       ("wf", "wr", "br", "ws", "bs")),
                         cfg.dilations, cfg.hop)


@pytest.mark.parametrize("k,dils", [(3, (1, 5, 20, 30)), (2, (7, 50, 3))])
def test_gated_stack_equals_the_per_op_layers(k, dils):
    """``GatedStack`` (off the card: its plain gates and frame sums)
    against the layers as separate ops, in float32 at B=3, T=48, hop 12:
    the skips and the gradients of l0, s0, the conditions and every
    weight and bias.  Taps reach up to 60 samples back, past the start
    of each crop into the one before, which the padding must hide; the
    last layer's residual is not computed, so its ``wr``, ``br`` get
    zeros.  Float32 sums in other orders: 1e-5 of the largest
    magnitude."""
    from vqvae_tpu_torch.kernels import wavenet_ae_cuda as ae
    g = torch.Generator().manual_seed(len(dils) * 10 + k)
    B, T, hop, R, S, L = 3, 48, 12, 8, 6, len(dils)
    shapes = {"l0": (B, T, R), "s0": (B * T, S), "cond": (L, B, 4, 2 * R),
              "wf": (L, k, R, 2 * R), "wr": (L, R, R), "br": (L, R),
              "ws": (L, R, S), "bs": (L, S)}
    leaves = {n: (torch.randn(sh, generator=g) * 0.5).requires_grad_()
              for n, sh in shapes.items()}
    gs = torch.randn(B * T, S, generator=g)
    x = leaves
    got = ae.gated_stack(x["l0"], x["s0"] + x["bs"].sum(0), x["cond"],
                         x["wf"], x["wr"], x["br"], x["ws"], dils, hop)
    (got * gs).sum().backward()
    mine = {n: t.grad.clone() for n, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
    want = per_op_layers(*(x[n] for n in shapes), dils, hop)
    (want * gs).sum().backward()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.detach().abs().max()))
    for n, t in leaves.items():
        torch.testing.assert_close(mine[n], t.grad, rtol=0,
                                   atol=1e-5 * float(t.grad.abs().max()),
                                   msg=n)
    assert not mine["wr"][L - 1].any() and not mine["br"][L - 1].any()
    assert mine["wr"][L - 2].abs().max() > 0


def test_decoder_stack_equals_the_per_op_stack():
    """The model's ``decoder_stack`` against the same stack as separate
    ops, float32, 6 layers of dilations 1..32 on crops of 32 samples (4
    frames of 8): the skips, the conditions' gradient and every decoder
    leaf's."""
    cfg = dataclasses.replace(SMALL, num_layers=6, num_stages=6,
                              ae_hop_length=8)
    g = torch.Generator().manual_seed(11)
    xp = torch.rand(2, 32, generator=g) * 1.8 - 0.9
    out = []
    for fn in (W.decoder_stack, _per_op_decoder_stack):
        params = _program(_weights(seed=3, cfg=cfg), cfg)
        dec = params["decoder"]
        z = torch.randn(2, 4, cfg.ae_bottleneck_width, generator=
                        torch.Generator().manual_seed(2))
        cond = W.cond_maps(dec, cfg, z)[0].detach().requires_grad_()
        s = fn(dec, cfg, xp, cond)
        (s * torch.linspace(-1, 1, s.numel()).view(s.shape)).sum().backward()
        grads = {k: p.grad for k, p in params.named_parameters()
                 if k.startswith("decoder.") and p.grad is not None}
        out.append((s.detach(), cond.grad, grads))
    (s1, c1, g1), (s2, c2, g2) = out
    assert len(g1) == len(g2) == 9     # no head; cond is a leaf
    torch.testing.assert_close(s1, s2, rtol=0, atol=1e-5 * float(
        s2.abs().max()))
    torch.testing.assert_close(c1, c2, rtol=0, atol=1e-5 * float(
        c2.abs().max()))
    for k, v in g2.items():
        torch.testing.assert_close(g1[k], v, rtol=0,
                                   atol=1e-5 * float(v.abs().max()), msg=k)


def test_checkpoint_round_trip_without_vq_state(tmp_path):
    cfg = _tiny_preset()
    state = create_train_state(cfg, "cpu")
    step_mod.train_step(state, _slices(), torch.zeros(3), cfg)
    save_checkpoint(str(tmp_path), state)
    fresh = create_train_state(cfg.replace(train=dataclasses.replace(
        cfg.train, seed=9)), "cpu")
    restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 1 and fresh.vq_state is None
    for (k, a), (_, b) in zip(state.params.named_parameters(),
                              fresh.params.named_parameters()):
        assert torch.equal(a, b), k
    a = step_mod.train_step(state, _slices(2), torch.zeros(3), cfg)["loss"]
    b = step_mod.train_step(fresh, _slices(2), torch.zeros(3), cfg)["loss"]
    assert float(a) == float(b)


def test_the_train_cli_trains_the_preset(tmp_path, capsys):
    from vqvae_tpu_torch.cli import train as cli
    out = tmp_path / "run"
    sets = ["model.width=32", "model.skip_width=32", "model.num_stages=2",
            "model.num_layers=2", "model.ae_num_stages=2",
            "model.ae_num_layers=2", "model.ae_width=16",
            "model.ae_bottleneck_width=4", "model.ae_hop_length=64",
            "data.length=128", "train.log_every=1"]
    args = ["--preset", "nsynth-h512", "--dataset", "sine", "--steps", "2",
            "--batch-size", "2", "--device", "cpu", "--out", str(out)]
    cli.main(args + [a for s in sets for a in ("--set", s)])
    cfg = load_config(str(out))
    assert isinstance(cfg.model, WaveNetAEConfig) and cfg.model.width == 32
    assert json.loads((out / "config.json").read_text())["arch"] == \
        "wavenet_ae"
    logs = [json.loads(x) for x in (out / "log.jsonl").read_text()
            .splitlines()]
    assert [r["iteration"] for r in logs] == [1, 2]
    assert (out / "weights.npz").exists()
    cli.main(args[:5] + ["3"] + args[6:] + ["-r"]
             + [a for s in sets for a in ("--set", s)])
    assert json.loads((out / "log.jsonl").read_text().splitlines()[-1])[
        "iteration"] == 3
    with pytest.raises(SystemExit, match="plain stack"):
        cli.main(args + ["--decoder-kernel", "pallas"])


@pytest.mark.parametrize("tool", ["encode", "decode", "generate", "stream",
                                  "score"])
def test_codec_tools_refuse_the_autoencoder(tool, tmp_path):
    import importlib
    mod = importlib.import_module(f"vqvae_tpu_torch.cli.{tool}")
    argv = ["--preset", "nsynth-h512", "-m", str(tmp_path), "--device",
            "cpu"]
    if tool != "score":
        argv += ["-i", str(tmp_path / "x.wav")]
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    msg = str(e.value)
    assert f"vqvae-torch-{tool}" in msg and "wavenet_ae model" in msg
    assert "\n" not in msg


def test_serve_refuses_the_autoencoder(tmp_path, monkeypatch):
    from vqvae_tpu_torch.cli import serve
    monkeypatch.setattr(sys, "argv", [
        "vqvae-torch-serve", "--preset", "nsynth-h512", "-m", str(tmp_path),
        "--socket", str(tmp_path / "s"), "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        serve.main()
    assert "vqvae-torch-serve" in str(e.value)
    assert "wavenet_ae model" in str(e.value) and "\n" not in str(e.value)


def _tiny_vqvae(**model):
    cfg = get_config("tiny")
    return cfg.replace(model=dataclasses.replace(cfg.model, **model),
                       data=dataclasses.replace(cfg.data, length=256),
                       train=dataclasses.replace(cfg.train, batch_size=2))


@pytest.mark.parametrize("switches", [
    {},
    {"decoder_kernel": "pallas"},
    {"ema": True, "code_restart_threshold": 1e-3,
     "decoder_kernel": "pallas_sg", "head_kernel": "pallas",
     "embed_in_kernel": True},
], ids=["tiny", "vctk-multi", "stretch"])
def test_a_vqvae_step_never_enters_the_autoencoder(switches, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the VQ-VAE step entered the autoencoder")
    monkeypatch.setattr(step_mod, "_wavenet_ae_step", boom)
    for name in ("forward", "apply", "encoder", "decoder_stack"):
        monkeypatch.setattr(W, name, boom)
    cfg = _tiny_vqvae(**switches)
    state = create_train_state(cfg, "cpu")
    met = step_mod.train_step(state, _slices(B=2), torch.arange(2), cfg)
    assert np.isfinite(float(met["loss"])) and state.vq_state is not None
