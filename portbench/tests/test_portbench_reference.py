"""The plain reference against the port at tiny sizes on the CPU, and
the control (the reference in float8 operands) caught by the limits."""

import base64
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, weights
from portbench.reference import model as rm
from portbench.reference import serve as rs
from portbench.reference import train as rt
from portbench.tests.rehearse import TINY_MODEL
from vqvae_tpu_torch.audio.mu_law import mu_law_decode
from vqvae_tpu_torch.cli.serve import float_to_pcm16
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.infer.kernel_stream import KernelStreamDecoder
from vqvae_tpu_torch.models import init_model
from vqvae_tpu_torch.models.params import ParamTree, flat_state
from vqvae_tpu_torch.train.state import create_train_state
from vqvae_tpu_torch.train.step import train_step

REPO = Path(__file__).resolve().parents[2]
EMA = {"ema": True, "code_restart_threshold": 1e-3,
       "decoder_kernel": "pallas_sg", "head_kernel": "pallas",
       "embed_in_kernel": True}


def tiny(dtype="float32", **kw):
    cfg = get_config("tiny")
    kw = {"decoder_kernel": "pallas", **kw}
    return cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype=dtype, **kw))


def picks(step, n, K, device="cpu"):
    g = torch.Generator().manual_seed(1000 + step)
    return torch.randint(0, n, (K,), generator=g).to(device)


def program_steps(cfg, flat, batches):
    params = ParamTree(weights.nest({k: v.clone() for k, v in flat.items()}),
                       trainable=True)
    st = create_train_state(cfg, "cpu", params=params)
    named = {k.replace(".", "/"): p for k, p in params.named_parameters()}
    losses, grad1 = [], {}
    for i, (w, s) in enumerate(batches):
        losses.append(float(train_step(st, w, s, cfg, picks=picks)["loss"]))
        if i == 0:
            grad1 = {k: float((st.opt.state[p]["exp_avg"] / 0.1).double()
                              .norm())
                     for k, p in named.items() if p in st.opt.state}
    change = {k: float((p.detach() - flat[k]).double().norm())
              for k, p in named.items()}
    return {"loss": losses, "grad1": grad1, "change": change}


def batches(seed, B, T, n_spk):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(np.clip(0.5 * rng.standard_normal((B, T + 1)),
                                      -1, 1).astype(np.float32)),
             torch.from_numpy(rng.integers(0, n_spk, B))) for _ in range(3)]


def test_weights_have_the_program_layout():
    cfg = get_config("vctk-multi")
    m = dataclasses.asdict(cfg.model)
    tmpl = flat_state(init_model(cfg.model, device="meta"))
    shapes = {n: s for n, s, _ in weights.leaves(m)}
    assert shapes == {k: tuple(v.shape) for k, v in tmpl.items()}
    a = weights.make(dataclasses.asdict(tiny().model), 2 ** 31 + 9, "cpu")
    b = weights.make(dataclasses.asdict(tiny().model), 2 ** 31 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("ema", [False, True])
def test_reference_training_follows_the_port(ema):
    cfg = tiny(**(EMA if ema else {}))
    m, tr = dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.train)
    flat = weights.make(m, 31, "cpu")
    bs = batches(5, 3, cfg.data.length, m["n_speakers"])
    prog = program_steps(cfg, flat, bs)
    ref = rt.first_steps(flat, m, tr, bs, picks, block=2)
    n = compare.train_numbers(prog, ref)
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-5, n
    assert n["change_gap"] < 1e-3, n


def test_pcm16_gives_back_every_mu_law_id():
    ids = torch.arange(256)
    wav = mu_law_decode(ids, 256).numpy()
    pcm = np.frombuffer(base64.b64decode(float_to_pcm16(wav)), "<i2")
    assert (rs.pcm16_ids(pcm, 256) == ids.numpy()).all()


def served(cfg, flat, codes, spk, greedy=True):
    dec = KernelStreamDecoder(ParamTree(weights.nest(
        {k: v.clone() for k, v in flat.items()})), cfg.model)
    s = dec.session([spk], seed=3, greedy=greedy)
    out = [s.push(codes[None, i:i + 4])[0] for i in range(0, len(codes), 4)]
    out.append(s.close()[0])
    pcm = np.frombuffer(base64.b64decode(float_to_pcm16(
        np.concatenate(out))), "<i2")
    return rs.pcm16_ids(pcm, cfg.model.mu)


@pytest.mark.parametrize("dtype,most", [("float32", 1e-5),
                                        ("bfloat16", 0.05)])
def test_reference_logits_judge_the_ports_greedy_sessions(dtype, most):
    cfg = tiny(dtype)
    m = dataclasses.asdict(cfg.model)
    flat = weights.make(m, 5, "cpu")
    codes = np.random.default_rng(1).integers(0, m["K"], 12)
    ids = served(cfg, flat, codes, 2)
    assert len(ids) == 12 * 64
    lg = rs.logits_for(flat, m, codes, 2, ids)
    assert rs.widest_gap(lg, torch.from_numpy(ids)) <= most


def test_the_control_fails_the_tiny_limits():
    """The control: the reference in float8 operands in the program's
    place, against the limits of the tiny bf16 cells (rehearse.py)."""
    cfg = tiny("bfloat16")
    m, tr = dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.train)
    flat = weights.make(m, 41, "cpu")
    codes = np.random.default_rng(2).integers(0, m["K"], 12)
    ids = served(cfg, flat, codes, 1)
    lg = rs.logits_for(flat, m, codes, 1, ids)
    lc = rs.logits_for(flat, m, codes, 1, ids, rm.Prec("fp8"))
    assert rs.widest_gap(lg, torch.from_numpy(ids)) <= 0.1
    assert rs.widest_gap(lg, lc.argmax(-1)) > 0.1
    bs = batches(6, 2, cfg.data.length, m["n_speakers"])
    ref = rt.first_steps(flat, m, tr, bs, picks)
    limits = {"loss_gap": 2.5e-4, "grad_gap": 0.1, "change_gap": 0.1}
    prog = compare.train_numbers(program_steps(cfg, flat, bs), ref)
    ctl = compare.train_numbers(
        rt.first_steps(flat, m, tr, bs, picks, rm.Prec("fp8")), ref)
    assesses = lambda n: all(n[k] <= v for k, v in limits.items())  # noqa
    assert assesses(prog), prog
    assert not assesses(ctl), ctl


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, torch\n"
        "from portbench.reference import model, serve, train\n"
        "from portbench import weights, compare, trace, corpus\n"
        "from portbench.work import counts\n"
        f"m = {TINY_MODEL!r}\n"
        "p = weights.make(m, 3, 'cpu')\n"
        "lg = serve.logits_for(p, m, [1, 2, 3], 0, [128] * 100)\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules} & "
        "{'vqvae_tpu_torch', 'vqvae_tpu', 'jax', 'jaxlib', 'flax'})\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1].replace("'", '"')) \
        == []
