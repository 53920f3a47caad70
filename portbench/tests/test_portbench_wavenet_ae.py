"""The WaveNet autoencoder's cell on the CPU at a tiny size: its
rehearsal correct, its planted faults and its float8 control not
correct, its weights in the program's layout, its work counts against
hand-worked numbers, and its reference free of the program; on the card,
the control and the faults against the cell's own limits."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import compare, harness, weights, weights_ae
from portbench.drivers import train_ae
from portbench.reference import model as rm
from portbench.reference import wavenet_ae as ra
from portbench.tests.conftest import REPO, rehearse
from portbench.tests.rehearse import copy_bench
from portbench.work import wavenet_ae as work
from vqvae_tpu_torch.configs import Config, DataConfig, TrainConfig, \
    WaveNetAEConfig
from vqvae_tpu_torch.models.params import ParamTree, flat_state
from vqvae_tpu_torch.models.wavenet_ae import init_wavenet_ae
from vqvae_tpu_torch.train.state import create_train_state
from vqvae_tpu_torch.train.step import train_step

CELL = "tiny-ae.train.t2"
TINY_AE = {"mu": 256, "num_stages": 2, "num_layers": 4, "filter_length": 3,
           "width": 32, "skip_width": 32, "ae_num_stages": 2,
           "ae_num_layers": 4, "ae_filter_length": 3, "ae_width": 16,
           "ae_bottleneck_width": 4, "ae_hop_length": 64,
           "compute_dtype": "bfloat16", "param_dtype": "float32"}
# the tiny bf16 cell's limits, from 12 seeds and the rehearsal on the
# CPU: above the program's largest readings (loss 6.9e-4, change 2.7e-2:
# leaves of 4 to 32 values whose Adam steps bf16 flips, first gradient
# whole 6.7e-2, a crop's first loss 7.8e-4) and under the float8
# control's least whole first gradient (9.0e-2) and the half batch's
# least loss (1.35e-3), whole first gradient (0.27) and crop (6.4e-3)
LIMITS = {"loss_gap": 1e-3, "change_gap": 0.05, "grad_vec_gap": 0.07,
          "crop_gap": 2.5e-3}


def tiny_ae_cell(root):
    """Add the tiny autoencoder's configuration, traffic, limits and cell
    to the benchmark under ``root`` by new files and new entries."""
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "nsynth-h512.json").read_text())
    conf.update(name="tiny-ae", model=TINY_AE,
                data=dict(conf["data"], length=256))
    (pb / "configs" / "tiny-ae.json").write_text(json.dumps(conf))
    (pb / "traffic" / "train.ae.t2.json").write_text(json.dumps({
        "driver": "train_ae", "batch": 2, "warm_steps": 1, "trace_steps": 2,
        "corpus": {"speakers": 3, "utterances_per_speaker": 2,
                   "seconds": [0.3, 0.3], "silence_s": 0.05}}))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-ae", "source": "test",
                           "file": "portbench/configs/tiny-ae.json",
                           "reduced": [], "why": "CPU rehearsal"})
    man["workloads"].append({"name": CELL, "config": "tiny-ae",
                             "traffic": "train.ae.t2", "chips": 1,
                             "why": "CPU rehearsal"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "nsynth-h512.train.b48" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


@pytest.fixture(scope="module")
def ae_root(tmp_path_factory):
    root = copy_bench(REPO, tmp_path_factory.mktemp("bench-ae"))
    tiny_ae_cell(root)
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_the_rehearsal_is_correct(ae_root, trace):
    res, forbidden, out = rehearse(ae_root, CELL, 2 ** 31 + 611, 1.0, trace)
    assert res["correct"] is True and forbidden == [], out[-3000:]
    got = set(res["metrics"])
    if trace:
        assert {"train_mfu.nsynth", "batch_wait_ms"} <= got, got
        assert "train_mfu" not in got and "decoder_stack_roofline" not in got
    else:
        assert got == {"train_audio_s_per_s", "setup_s"}


FAULTS = {
    "unchanged": """
import vqvae_tpu_torch.train.step as st
def train_step(state, wav, speaker, cfg, picks=None, impl="lax"):
    state.step += 1
    return st.eval_step(state.params, wav, speaker, cfg, impl)
st.train_step = train_step
""",
    "half_batch": """
import vqvae_tpu_torch.train.step as st
_orig = st.train_step
def train_step(state, wav, speaker, cfg, picks=None, impl="lax"):
    n = max(1, wav.shape[0] // 2)
    return _orig(state, wav[:n], speaker[:n], cfg, picks=picks, impl=impl)
st.train_step = train_step
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(ae_root, tmp_path, fault):
    (tmp_path / "sitecustomize.py").write_text(FAULTS[fault])
    res, _, out = rehearse(ae_root, CELL, 2 ** 31 + 612, 1.0, 0,
                           extra_path=tmp_path)
    assert res["correct"] is False, out[-3000:]


def _cfg(dtype="bfloat16"):
    return Config(data=DataConfig(length=256, n_speakers=1),
                  model=WaveNetAEConfig(**dict(TINY_AE,
                                               compute_dtype=dtype)),
                  train=TrainConfig(batch_size=4), name="tiny-ae")


def _batches(seed, B=4, T=256):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(np.clip(0.4 * rng.standard_normal((B, T + 1)),
                                      -1, 1).astype(np.float32)), None)
            for _ in range(3)]


def _program(cfg, flat, bs):
    params = ParamTree(weights.nest({k: v.clone() for k, v in flat.items()}),
                       trainable=True)
    st = create_train_state(cfg, "cpu", params=params)
    named = {k.replace(".", "/"): p for k, p in params.named_parameters()}
    losses, vec, crops = [], {}, []
    for i, (w, _) in enumerate(bs):
        met = train_step(st, w, torch.zeros(len(w)), cfg)
        losses.append(float(met["loss"]))
        if i == 0:
            vec = {k: st.opt.state[p]["exp_avg"] / 0.1
                   for k, p in named.items()}
            crops = met["crop_loss"].tolist()
    change = {k: float((p.detach() - flat[k]).double().norm())
              for k, p in named.items()}
    return {"loss": losses, "crop_loss1": crops, "change": change,
            "grad1_vec": vec,
            "grad1": {k: float(v.double().norm()) for k, v in vec.items()}}


def test_reference_training_follows_the_port_in_float32():
    cfg = _cfg("float32")
    m, tr = dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.train)
    flat = weights_ae.make(m, 31, "cpu")
    bs = _batches(5)
    prog = _program(cfg, flat, bs)
    ref = ra.first_steps(flat, m, tr, bs, block=3, vectors=True)
    n = train_ae.numbers(prog, ref)
    assert n["loss_gap"] < 1e-6 and n["crop_gap"] < 1e-6, n
    assert compare.train_numbers(prog, ref)["grad_gap"] < 1e-5
    assert n["grad_vec_gap"] < 1e-5 and n["change_gap"] < 1e-3, n


@pytest.mark.parametrize("seed", [41, 43])
def test_the_control_and_the_faults_fail_the_tiny_limits(seed):
    """bf16 program against the float32 reference passes ``LIMITS``; the
    reference with float8 operands, and with half the batch (its first
    half twice) or no Adam step, in the program's place does not."""
    cfg = _cfg()
    m, tr = dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.train)
    flat = weights_ae.make(m, seed, "cpu")
    bs = _batches(seed)

    def numbers(x):
        return train_ae.numbers(x, ref)

    def follow(**kw):
        return ra.first_steps(flat, m, kw.pop("tr", tr), kw.pop("bs", bs),
                              vectors=True, **kw)
    ref = follow()
    passes = lambda n: all(n[k] <= v for k, v in LIMITS.items())  # noqa
    prog = numbers(_program(cfg, flat, bs))
    assert passes(prog), prog
    ctl = numbers(follow(prec=rm.Prec("fp8")))
    assert not passes(ctl) and ctl["grad_vec_gap"] > LIMITS["grad_vec_gap"]
    half = numbers(follow(bs=[(torch.cat([w[:2]] * 2), k) for w, k in bs]))
    assert half["crop_gap"] > LIMITS["crop_gap"], half
    assert half["grad_vec_gap"] > LIMITS["grad_vec_gap"], half
    still = numbers(follow(tr=dict(tr, lr=0.0)))
    assert not passes(still) and still["change_gap"] == 1.0, still


def test_weights_have_the_program_layout():
    m = json.loads((REPO / "portbench" / "configs" / "nsynth-h512.json")
                   .read_text())["model"]
    tmpl = flat_state(init_wavenet_ae(WaveNetAEConfig(**m), device="meta"))
    assert {n: s for n, s, _ in weights_ae.leaves(m)} == \
        {k: tuple(v.shape) for k, v in tmpl.items()}
    assert sum(np.prod(s) for _, s, _ in weights_ae.leaves(m)) == 61804048


def test_work_counts_by_hand():
    m = json.loads((REPO / "portbench" / "configs" / "nsynth-h512.json")
                   .read_text())["model"]
    f = work.forward_flops(m)
    # a layer: 3 x 512 x 1024 + 512 x 256 (+ 512 x 512 but in the last)
    assert f["stack"] == 2 * (3 * 512 + 512 * 256 + 30 * (3 * 512 * 1024
                              + 512 * 256) + 29 * 512 * 512) == 117705728
    assert f["encoder"] == 2 * (3 * 128 + 30 * (3 * 128 * 128 + 128 * 128)
                                + 128 * 16) == 3937024
    assert f["head"] == 2 * (256 * 256 + 256 * 256)
    assert f["cond"] == 2 * (30 * 16 * 1024 + 16 * 256) / 512
    step = work.train_step_flops(m, 6144, 48)
    assert step == pytest.approx(107.855e12, rel=1e-5)
    flops, nbytes = work.stack_fwd_work(m, 48, 6144)
    assert flops == f["stack"] * 48 * 6144
    # the float32 input, 30 layers' frame-rate conditions, the bf16
    # weights and the bf16 skips
    w = (3 * 512 + 512 + 512 * 256 + 256 + 30 * (3 * 512 * 1024 + 1024
                                                 + 512 * 256 + 256)
         + 29 * (512 * 512 + 512))
    assert nbytes == 4 * 294912 + 2 * (30 * 576 * 1024 + w + 294912 * 256)
    obs = {"kind": "train", "arch": "wavenet_ae", "model": m, "batch": 48,
           "T": 6144, "step_s": 0.5,
           "capture": {"steps": 4, "stack_fwd_s": 4 * 0.1}}
    assert harness.reader("train_mfu.nsynth")(obs) == pytest.approx(
        100 * step / (0.5 * 989e12))
    assert harness.reader("stack_fwd_roofline.nsynth")(obs) == \
        pytest.approx(100 * (flops / 989e12) / 0.1)
    assert harness.reader("train_mfu.nsynth")(dict(obs, arch=None)) is None


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, torch\n"
        "from portbench.reference import wavenet_ae as ra\n"
        "from portbench import weights_ae\n"
        "from portbench.work import wavenet_ae\n"
        f"m = {TINY_AE!r}\n"
        "p = weights_ae.make(m, 3, 'cpu')\n"
        "ra.loss(p, m, torch.zeros(2, 129))\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules} & "
        "{'vqvae_tpu_torch', 'vqvae_tpu', 'jax', 'jaxlib', 'flax'})\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_control_and_faults_fail_the_cell_on_the_card(card):
    """At the cell's own size the program passes its limits, and the
    float8 control, half of the batch left out and a state left
    unchanged fail them."""
    from portbench import control_ae
    spec = harness.cell_spec("nsynth-h512.train.b48")
    out = control_ae.train_seed(spec, 2 ** 31 + 707, True, "cuda")

    def passes(n):
        return all(n[k] <= v for k, v in spec.limits.items())
    assert passes(out["program"]), out["program"]
    for bad in ("control", "half_batch", "unchanged"):
        assert not passes(out[bad]), (bad, out[bad])
    assert out["half_batch"]["crop_gap"] > spec.limits["crop_gap"]
