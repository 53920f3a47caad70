#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``vqvae_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root; needs no install, no network and no JAX.
Phases, each printing one line with its wall time; any failure exits
nonzero:

1. device  — the card's name and power limit (nvidia-smi); CUDA must be
             available; TF32 off for the plain references.
2. build   — compile the port's eight CUDA sources
             (``vqvae_tpu_torch/csrc/*.cu``), one nvcc each, side by side,
             and the native audio library (``native/audio.cpp``, g++).
3. kernel  — the decode kernel (one 16-block cluster per row) against
             its plain PyTorch version at
             vctk-multi width (seeded random weights), B in {1, 3},
             T = 640, float32 and bfloat16: teacher-forced logits within
             1e-4 (f32) / 3e-2 (bf16) of max|logits|; greedy and sampled
             ids step by step against the plain pick on the kernel's own
             history, a mismatch allowed only at a near-tie; the teacher
             logits timed (CUDA events) beside the plain version and the
             bound.
4. resume  — resumed kernel pushes equal one kernel call, bit for bit.
5. serve   — the daemon (``python3 -m vqvae_tpu_torch.cli.serve``) on
             the exported seeded weights, driven over its UNIX socket by
             the port's own client (``vqvae_tpu_torch.client``): ping,
             encode, decode (greedy, sampled), reconstruct, codes-mode
             sessions (equal to one-shot decode, greedy and sampled), a
             pcm-mode session (equal to reconstruct), an out-of-range id
             (refused), stats, shutdown.  The daemon's kernel launch
             count must rise across the requests.  Then a second daemon
             on the same weights with ``--engine stream``: decode (greedy,
             sampled) and reconstruct equal the first daemon's bit for
             bit, a codes-mode session cut at (37, 1, 100, rest) its own
             one-shot decode, a pcm-mode session its reconstruct; its
             launch count must rise; its realtime factors printed.
6. request — one 1 s decode request as the daemon makes it (B=1, bf16,
             one kernel call over 16000 steps): its kernel time; the kernel
             against the plain version over a tenth of it (1600 steps: the
             plain loop takes ~8 ms a step); and at B=1 from the state
             after a first push of 4096 steps (t0 > 0, as in a session),
             over the next 1024 steps, teacher-forced logits within 3e-2
             of max|logits| of the plain version and the sampled picks
             against the plain pick.  It prints the kernel's cluster
             size, shared memory per block, whether the weight slices are
             resident, cudaOccupancyMaxActiveClusters, and what it costs
             a 16-block cluster to agree once: a cluster barrier with
             release/acquire, and the kernel's st.async + mbarrier
             exchange.

7. train-kernels — the training kernels (chunk forward; the save-gates,
             recompute and time-windowed backwards, the last at 2 and 4
             windows; in the bias-seeded, chained and embed variants
             where they apply; head + CE forward and backward) against
             their plain PyTorch versions at stretch width (B=2, T=7680,
             10 layers, seeded weights with non-zero biases): every output
             and every gradient within 1e-4 (float32) / 3e-2 (bfloat16) of
             its max.  The VQ search at N = 1920 and 7680 (K=512, d=64):
             ids equal to the plain version's on every row whose two best
             scores differ by more than 1e-4 of the largest score; the rows
             left out are counted.
8. train-cli — ``python3 -m vqvae_tpu_torch.cli.train --preset stretch
             --dataset sine --steps 3 --profile 2`` as a subprocess (B=64,
             T=7680, bf16): exits 0, finite losses in log.jsonl, one
             torch.profiler trace under <out>/profile holding the card's
             kernels, weights.npz loads
             through ``cli/common.py::load_params``, and the launch counts
             it prints show the kernels of its path launched (chunk
             forward, save-gates backward, head + CE).
9. train-time — stretch at B=64: step time on the host clock around
             synchronised steps, the device's busy share and the split by
             kernel (torch.profiler), peak memory; each training kernel
             against its plain version again at the main path's B=64 shapes
             (embed and acc chunks, head + CE; bfloat16, 3e-2 of max), so
             the split-K partitioning the path runs is the one checked;
             each kernel's time (CUDA events) beside its plain version's
             and its bound; a second call of each chunk kernel bit-equal
             to the first; the backwards' weight-gradient product alone
             at the dwff shape (h(t - dil) [B*T, 64] against du [B*T,
             128], bf16) beside torch.matmul(A.T, B), its library
             yardstick; and the step
             with the plain decoder and head (decoder_kernel=xla,
             head_kernel=xla).
10. train-cli-vctk — a synthetic VCTK-layout tree under build/ (4
             speakers x 5 utterances, 48 kHz int16 tones between silences,
             so trimming and resampling run), then ``python3 -m
             vqvae_tpu_torch.cli.train --preset vctk-multi --dataset vctk
             --root <tree> --impl pallas --eval-every 2`` (B=16, T=7680,
             bf16, checkpoint_every=2): 4 steps straight; 2 steps and
             ``--resume`` to 4, whose weights.npz must equal the straight
             run's at rtol 1e-6; 2 steps with ``--bwd-windows 4``; 2 steps
             with ``--loader grain --tensorboard``, whose step 1 and 2
             losses must equal the straight run's at rtol 1e-6 and whose
             <out>/tb must hold one event file with log.jsonl's (tag,
             step, value) triples (read by ``train/metrics.py::
             read_events``).  Each exits 0 with finite losses and val_
             keys in log.jsonl, and its launch counts show the recompute
             (or windowed) backward, the VQ kernel and the embedding's
             take_rows backward launched.
11. host-data — on a synthetic VCTK tree of its own with vctk-multi's
             data config: every file
             decodes through the native library (``vqvae_tpu_torch/
             native``, g++ at first use; ``wav_io.decoders`` counts no
             scipy load), equal to scipy's decode bit for bit (mono
             int16); ``GrainBatchLoader(num_workers=2)`` gives
             BatchLoader's first 8 batches bit for bit, from batch 0 and
             from batch 5, and ``close()`` leaves no child process; each
             decoder's ms a file and each loader's ms a batch (host
             numbers, beside the card's name and power limit).
12. train-time-vctk — vctk-multi at its preset B=16, T=7680, bf16 with
             the VQ kernel: step time and peak memory with the recompute
             backward, the windowed backward (4 windows), saved gates and
             the plain decoder; the recompute step's busy share and split
             by kernel; the recompute and windowed backwards and the VQ
             search against their plain versions at these shapes, each
             timed beside its plain version and its bound (the VQ search
             at N = 1920 and 7680, per call and by CUDA-graph replay);
             the recompute step's profile must show the embedding's
             take_rows kernel twice a step and at most the two scatters
             JAX keeps plain (speaker, codebook); the take_rows backward
             (``kernels/embed_cuda.py``) against its plain version at
             B=16, T=7680, V=256, C=64, float32 (1e-4) and bfloat16
             (3e-2), uniform ids and every id the same, a second call the
             same bits, timed per call and by graph replay beside its
             bound, the plain version, index_add_ and autograd's scatter;
             and the step with the fused encoder (encoder_kernel=pallas).
13. enc-kernel — the fused encoder's forward and recompute backward
             against their plain versions at vctk-multi width (C=128, d=64,
             5 layers, non-zero biases) at B=2 and at the training shape
             B=16, T=7680, float32 and bfloat16: z and every gradient within
             1e-4 / 3e-2 of its max; the streaming encoder with the switch
             equal to one-shot encode bit for bit at two push widths; each
             kernel timed beside its plain version, its bound and the time
             of its float64 products alone at the FP64 tensor-core rate, at
             B=16 and at a 1 s encode (B=1, T=16000), with the backward's
             split by CUDA events (recompute, the projection's and the
             layers' input gradients, the weight and bias gradients), the
             count of z elements whose bits differ from the plain
             version's, and the layers' float64 torch.matmul calls on
             pre-built windows (a yardstick of several library calls).
14. cli-codec — the codec CLIs as subprocesses on vctk-multi: 2 steps of
             ``vqvae-torch-train --dataset vctk --set
             model.encoder_kernel=pallas`` (B=16, T=7680; the encoder's
             backward kernel), ``vqvae-torch-export`` of that run (equal to
             its weights.npz), ``vqvae-torch-encode`` of a 3 s wav with and
             without the switch (codes equal above a 1e-4 top-2 margin),
             ``vqvae-torch-decode`` and ``vqvae-torch-stream`` of those codes
             (equal, greedy and sampled), ``--gen-impl lowmem`` (equal to
             one-shot), ``vqvae-torch-generate`` and ``vqvae-torch-score`` on
             the synthetic VCTK tree; each exits 0, and their launch counts
             show the encoder's two kernels and the decode kernel launched.
15. probes — the four probe modules as subprocesses
             (``python3 -m vqvae_tpu_torch.probes.<name>``): the upsampler's
             forward and backward kernels against upsample_apply and its
             autograd at the probe's shapes, and against their plain
             versions at vctk-multi width, B=16 and B=64, float32 and
             bfloat16 (1e-4 / 3e-2 of max; a second call the same
             bits), timed per call and by CUDA-graph replay, each as a
             share of its bound, the backward's two launches apart (CUDA
             events), beside the plain versions, conv_transpose1d and the
             cost of reading [B, T, d];
             the dot probe's three contractions (1e-4 of max), leading-dim
             split and pad/add/slice (bit-equal), each body timed per call
             and by CUDA-graph replay beside einsum; the reshape probe's five
             layouts (bit-equal; the flat copy timed per call and by
             CUDA-graph replay beside clone, both ways) and its fused
             composition (1e-4; timed per call and by graph replay beside
             its bound and one einsum, both ways); the bf16 and int8 decode chains at L=2
             and L=30, 1 and 2 steps (int8 bit-equal, bf16 3e-2 of max,
             outputs not zero), timed at L=30, STEPS=128: each chain's ns
             a layer and their int8/bf16 ratio beside the decode kernel's
             ns a layer from the request phase.  Each probe's launches
             come from its timed run (a graph capture counts once per
             captured call, its replays not at all).
16. mesh    — the parallel layer: a sampled B=4 decode split by rows
             (``row0``, and over [cuda:0, cuda:0]) equal to the one call;
             ``torchrun`` worlds of this script's ``--mesh-worker``: an
             NCCL world of one and two gloo ranks sharing the card (DP 2
             and model 2 on stretch, seq 2 on vctk-multi) held to one
             process.
17. quality — the port's quality check (``vqvae_tpu_torch/quality``):
             20 tiny steps timed alone (B=16, T=1024, float32, plain
             stack, EMA codebook with restarts), then ``python3 -m
             vqvae_tpu_torch.quality.quality_check --steps 6000
             --batch-size 16 --speaker-matrix --engine lax --engine
             pallas-stream`` on the card as a subprocess, beside phases 10
             and 14; its record held to every condition of
             tests/test_quality.py (``quality_gate``), its launch counts,
             training wall time and steps a second printed.  On the
             trained weights (loaded as the daemon loads them) the
             held-out tone's decode at temperature
             0.8 from seed 0: lax == pallas and pallas-stream == the
             daemon's stream engine (``cli/serve.Codec``, 16-frame then
             1-frame pushes) == lax, bit for bit; the decode kernel at
             tiny's float32 widths against its plain version (B=1 and
             B=4, T=640: logits within 1e-4 of max, sampled picks off
             only at near-ties), timed over the tone and a tenth of it
             beside the plain loop and its bound; ``make_demo -m <run>``
             into a temporary directory, whose metrics.json must equal
             eval_quality's lax numbers (speaker 0, seed 0).

They run in the order 1-9, 12, 13, 15, 17's timing and start, 10 and
14 beside the quality check, 17's checks, 11, 16: every phase that
times the card runs alone on it.
The train-time phases also print each step's share of the bf16 peak by
``utils/flops.py::train_step_flops``.  Then one JSON line of per-kernel results and, last, the device line.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESET = "vctk-multi"
TRAIN_PRESET = "stretch"
VQ_MARGIN = 1e-4        # near-tie margin of the VQ id check, of max|score|
PEAK_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_F32 = 67e12        # H100 SXM float32 rate outside the tensor cores
PEAK_F64_TC = 67e12     # H100 SXM float64 tensor-core rate (DMMA)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
T_CHECK = 640
TEMP = 0.9
FIRST_PUSH = 4096   # steps before the resumed check of the request phase
RESUMED = 1024      # steps the resumed check holds (plain loop: ~8 ms each)
QUALITY_STEPS = 6000  # the converged point tests/test_quality.py gates
QUALITY_BATCH = 16
QUALITY_ENGINES = ("lax", "pallas-stream")


def say(phase, t0, msg):
    print(f"[{phase}] {time.monotonic() - t0:7.1f}s  {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError as exc:
        fail(f"nvidia-smi: {exc}")
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def setup_model(cfg, device, seed=0):
    import torch
    from vqvae_tpu_torch.models import init_model
    return init_model(cfg, torch.Generator().manual_seed(seed), device)


def pick_mismatches(dc, lp, got, greedy, seed, t0, margin_tol):
    """Kernel ids ``got`` [B, T] against the plain pick from plain
    logits ``lp`` [B, T, mu] taken on the kernel's own history, from
    absolute step ``t0``: (mismatches, mismatches away from a near-tie,
    i.e. where the two best plain scores differ by ``margin_tol`` or
    more)."""
    import torch
    y = lp
    if not greedy:
        B, T, mu = lp.shape
        y = lp / TEMP + dc.gumbel_noise(seed, t0, T, B, mu,
                                        lp.device).transpose(0, 1)
    pick = y.argmax(-1).to(torch.int32)
    top = y.topk(2, -1).values
    near = (top[..., 0] - top[..., 1]) < margin_tol
    bad = pick != got
    return int(bad.sum()), int((bad & ~near).sum())


def kernel_phase(dc, flag, device):
    """Kernel against plain: teacher logits and AR picks."""
    import dataclasses
    import torch
    from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params
    worst, teacher = {}, {}
    for dt, rel_tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
        cfg = dataclasses.replace(flag, compute_dtype=dt)
        params = setup_model(cfg, device)
        gp = make_gen_params(params.decoder, cfg)
        for B in (1, 3):
            t0 = time.monotonic()
            g = torch.Generator().manual_seed(B)
            cond = torch.randn(B, T_CHECK, cfg.d, generator=g).to(device)
            spk = torch.tensor([0, 5, 108][:B], device=device) % cfg.n_speakers
            gcond = global_cond(params.decoder, cfg, spk)
            ids = torch.randint(0, cfg.mu, (B, T_CHECK), generator=g,
                                dtype=torch.int32).to(device)
            state0 = dc.init_decode_state(cfg, B, gp.wff.dtype, device)

            def plain_logits(x):
                return dc._plain(gp, cfg, dc.TEACHER, cond, gcond, 0, 1.0,
                                 state0, x)[0]

            lk = dc.teacher_logits(gp, cfg, ids, cond, gcond)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            lp = plain_logits(ids)
            e1.record()
            torch.cuda.synchronize()
            plain_ms = e0.elapsed_time(e1)
            ms = cuda_ms(lambda: dc.teacher_logits(gp, cfg, ids, cond, gcond))
            bms, bby = bound(*teacher_work(cfg, B, T_CHECK))
            teacher[(dt, B)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=bby)
            scale = float(lp.abs().max())
            err = float((lk - lp).abs().max())
            check(torch.isfinite(lk).all(), "non-finite kernel logits")
            check(err <= rel_tol * scale,
                  f"{dt} B={B}: teacher logits off by {err} "
                  f"(max|logits| {scale}, tol {rel_tol})")
            worst[(dt, B)] = err
            # a pick may differ from the plain pick only where the two
            # best plain scores are closer than twice the logit tolerance
            margin_tol = 2 * rel_tol * scale / TEMP
            lines = []
            for greedy in (True, False):
                got = dc.generate_ids(gp, cfg, cond, gcond, 1234, TEMP,
                                      greedy)
                x_in = torch.cat([torch.full((B, 1), cfg.mu // 2,
                                             dtype=torch.int32,
                                             device=device),
                                  got[:, :-1]], 1)
                n_bad, n_far = pick_mismatches(
                    dc, plain_logits(x_in), got, greedy, 1234, 0, margin_tol)
                check(n_far == 0, f"{dt} B={B} greedy={greedy}: {n_far} "
                      "kernel picks differ from the plain pick away from a "
                      "near-tie")
                lines.append(f"{'greedy' if greedy else 'sampled'} "
                             f"near-tie mismatches {n_bad}/{B * T_CHECK}")
            say("kernel", t0, f"{dt} B={B} T={T_CHECK}: logits max|d| "
                f"{err:.3g} <= {rel_tol}*max|logits| = "
                f"{rel_tol * scale:.3g}; "
                + "; ".join(lines) + f"; teacher logits kernel {ms:.2f} ms, "
                f"plain {plain_ms:.1f} ms, bound {bms:.4f} ms ({bby})")
    return worst, teacher


def resume_phase(dc, flag, device):
    import torch
    from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params
    params = setup_model(flag, device)
    gp = make_gen_params(params.decoder, flag)
    for B in (1, 3):
        t0 = time.monotonic()
        g = torch.Generator().manual_seed(10 + B)
        cond = torch.randn(B, T_CHECK, flag.d, generator=g).to(device)
        gcond = global_cond(params.decoder, flag,
                            torch.arange(B, device=device))
        for greedy in (True, False):
            one, st1 = dc.generate_ids_resume(
                gp, flag, cond, gcond, 77, TEMP,
                dc.init_decode_state(flag, B, gp.wff.dtype, device), greedy)
            for split in ([640], [128, 512], [64, 1, 575]):
                st = dc.init_decode_state(flag, B, gp.wff.dtype, device)
                pieces, i = [], 0
                for w in split:
                    x, st = dc.generate_ids_resume(
                        gp, flag, cond[:, i:i + w], gcond, 77, TEMP, st,
                        greedy)
                    pieces.append(x)
                    i += w
                check(torch.equal(torch.cat(pieces, 1), one),
                      f"B={B} greedy={greedy} split {split}: ids differ")
                check(st.t0 == st1.t0 and all(
                    torch.equal(a, b) for a, b in zip(st[1:], st1[1:])),
                      f"B={B} greedy={greedy} split {split}: state differs")
        say("resume", t0, f"{flag.compute_dtype} B={B}: splits [640] "
            "[128,512] [64,1,575] "
            "== one call (ids and state), greedy and sampled")


class Daemon:
    """The serving daemon as a subprocess, driven through the port's own
    client (``vqvae_tpu_torch.client.CodecClient``)."""

    def __init__(self, npz, workdir, engine="kernel"):
        from vqvae_tpu_torch.client import CodecClient
        self.sock = os.path.join(workdir, f"codec_{engine}.sock")
        self.log_path = os.path.join(workdir, f"serve_{engine}.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vqvae_tpu_torch.cli.serve", "--preset",
             PRESET, "-m", npz, "--socket", self.sock, "--engine", engine],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=ROOT)
        deadline = time.monotonic() + 300
        while not os.path.exists(self.sock):
            if self.proc.poll() is not None:
                self.fail("daemon exited during startup")
            if time.monotonic() > deadline:
                self.fail("daemon did not come up in 300 s")
            time.sleep(0.2)
        self.client = CodecClient(socket_path=self.sock, timeout=300)

    def fail(self, msg):
        self.close()
        with open(self.log_path) as f:
            print(f.read()[-4000:], flush=True)
        fail(msg)

    def close(self):
        if getattr(self, "client", None) is not None:
            self.client.close()
            self.client = None
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def serve_phase(flag, cfg_all, device, dc):
    from vqvae_tpu_torch.client import ServerError
    from vqvae_tpu_torch.train.checkpoint import export_weights
    t0 = time.monotonic()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(ROOT, "build"))
    npz = os.path.join(work, "weights.npz")
    export_weights(npz, setup_model(flag, "cpu"))
    d = Daemon(npz, work)
    say("serve", t0, f"daemon up on {d.sock}")
    try:
        c = d.client
        sr, hop = cfg_all.data.sr, flag.hop
        dc.launches = 0   # this process's count; the daemon's is below
        t0 = time.monotonic()
        ping = c.ping()
        check(ping["engine"] == "kernel"
              and ping["device"].startswith(device.type),
              f"daemon not on the kernel engine on {device.type}: {ping}")
        before = ping["kernel_launches"]
        t = np.arange(sr) / sr
        tone = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        codes = c.encode(tone)
        check(codes.shape == (sr // hop,) and codes.min() >= 0
              and codes.max() < flag.K, "bad encode output")
        outs = {}
        for name, kw in (("greedy", {"greedy": True}),
                         ("sampled", {"seed": 7, "temperature": TEMP})):
            outs[name] = c.decode(codes, speaker=3, **kw)
        wav, rcodes = c.reconstruct(tone, greedy=True)
        check(np.array_equal(rcodes, codes),
              "reconstruct codes differ from encode")
        outs["reconstruct"] = wav
        for name, wav in outs.items():
            check(wav.shape == (len(codes) * hop,), f"{name}: length "
                  f"{wav.shape}")
            check(np.isfinite(wav).all() and np.abs(wav).max() <= 1.0,
                  f"{name}: audio not finite in [-1, 1]")
        for name, kw in (("greedy", {"greedy": True}),
                         ("sampled", {"seed": 7, "temperature": TEMP})):
            with c.open_stream("codes", speaker=3, **kw) as s:
                pieces, i = [], 0
                for w in (37, 1, 100, len(codes) - 138):
                    pieces.append(s.push_codes(codes[i:i + w]))
                    i += w
                pieces.append(s.close())
            check(np.array_equal(np.concatenate(pieces), outs[name]),
                  f"{name} codes-mode session != one-shot decode")
        # a pcm-mode session (streaming encoder in front) == reconstruct
        with c.open_stream("pcm", greedy=True) as s:
            pieces = [s.push_pcm(tone[a:b]) for a, b in
                      ((0, 300), (300, 301), (301, 9000), (9000, sr))]
            pieces.append(s.close())
        check(np.array_equal(np.concatenate(pieces), outs["reconstruct"]),
              "pcm-mode session != one-shot reconstruct")
        try:
            c.decode([flag.K], greedy=True)
            fail("the daemon took an out-of-range code id")
        except ServerError:
            pass
        stats = c.stats()
        launched = stats["kernel_launches"] - before
        check(launched > 0, "the daemon's requests launched no kernel")
        check(dc.launches == 0, "this process launched during the serve run")
        ops = stats["ops"]
        say("serve", t0, "through vqvae_tpu_torch.client: ping, encode, "
            "decode (greedy, sampled), reconstruct, 2 codes-mode sessions "
            "(== one-shot decode) and a pcm-mode session (== reconstruct), "
            "bit for bit, an out-of-range id refused; "
            f"{launched} kernel launches; realtime {ping['realtime_x']}x"
            f", session {ping['session_realtime_x']}x at "
            f"{ping['chunk']} frames/push; decode p50 "
            f"{ops['decode']['ms']['p50']} ms for {len(codes)} frames "
            f"({len(codes) * hop / sr:.2f} s of audio)")
        c.shutdown()
        d.proc.wait(timeout=60)
        d.close()
        stream_phase(npz, work, codes, tone, outs, flag)
    finally:
        d.close()
        shutil.rmtree(work, ignore_errors=True)
    return launched


def stream_phase(npz, work, codes, tone, outs, flag):
    """A second daemon on the same weights with ``--engine stream``: its
    decode (greedy, sampled) equals the kernel engine's ``outs`` for the
    same codes bit for bit, a codes-mode session equals its own one-shot
    decode, a pcm-mode session its reconstruct; its kernel launch count
    must rise."""
    t0 = time.monotonic()
    d = Daemon(npz, work, engine="stream")
    try:
        c = d.client
        say("serve", t0, f"stream-engine daemon up on {d.sock}")
        t0 = time.monotonic()
        ping = c.ping()
        check(ping["engine"] == "stream",
              f"daemon not on the stream engine: {ping}")
        before = ping["kernel_launches"]
        for name, kw in (("greedy", {"greedy": True}),
                         ("sampled", {"seed": 7, "temperature": TEMP})):
            wav = c.decode(codes, speaker=3, **kw)
            check(np.array_equal(wav, outs[name]), f"stream engine {name} "
                  "decode != the kernel engine's, bit for bit")
            with c.open_stream("codes", speaker=3, **kw) as s:
                check(s.granularity_samples == ping["chunk"] * flag.hop,
                      f"stream engine granularity {s.granularity_samples}")
                pieces, i = [], 0
                for w in (37, 1, 100, len(codes) - 138):
                    pieces.append(s.push_codes(codes[i:i + w]))
                    i += w
                pieces.append(s.close())
            check(np.array_equal(np.concatenate(pieces), wav),
                  f"stream engine {name} codes-mode session != its one-shot "
                  "decode")
        sr = len(tone)
        rec, _ = c.reconstruct(tone, greedy=True)
        check(np.array_equal(rec, outs["reconstruct"]),
              "stream engine reconstruct != the kernel engine's")
        with c.open_stream("pcm", greedy=True) as s:
            pieces = [s.push_pcm(tone[a:b]) for a, b in
                      ((0, 300), (300, 301), (301, 9000), (9000, sr))]
            pieces.append(s.close())
        check(np.array_equal(np.concatenate(pieces), rec),
              "stream engine pcm-mode session != its reconstruct")
        stats = c.stats()
        launched = stats["kernel_launches"] - before
        check(stats["engine"] == "stream" and launched > 0,
              f"the stream engine's requests launched no kernel: {stats}")
        say("serve", t0, "--engine stream: decode (greedy, sampled) == the "
            "kernel engine's, codes-mode sessions (37, 1, 100, rest) == "
            "one-shot, reconstruct == the kernel engine's, a pcm-mode "
            f"session == reconstruct, bit for bit; {launched} kernel "
            f"launches; realtime {ping['realtime_x']}x, session "
            f"{ping['session_realtime_x']}x at {ping['chunk']} frames/push;"
            f" decode p50 {stats['ops']['decode']['ms']['p50']} ms")
        c.shutdown()
        d.proc.wait(timeout=60)
    finally:
        d.close()


def request_phase(dc, flag, device, sr):
    """One 1 s decode request as the daemon makes it: B=1, one kernel
    call over sr steps from t0 = 0.  Times it (CUDA events) against the
    plain version over a tenth of it, then holds the kernel against the
    plain version over RESUMED steps from the state after a first push of
    FIRST_PUSH steps."""
    import torch
    from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params
    t0 = time.monotonic()
    params = setup_model(flag, device)
    gp = make_gen_params(params.decoder, flag)
    T = sr // flag.hop * flag.hop
    cond = torch.randn(1, T, flag.d, generator=torch.Generator().manual_seed(
        3)).to(device, flag.cdtype)
    gcond = global_cond(params.decoder, flag, torch.zeros(1, dtype=torch.long,
                                                          device=device))
    st0 = dc.init_decode_state(flag, 1, gp.wff.dtype, device)
    ids, _ = dc.generate_ids_resume(gp, flag, cond, gcond, 1, TEMP, st0)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 3
    e0.record()
    for _ in range(reps):
        dc.generate_ids_resume(gp, flag, cond, gcond, 1, TEMP, st0)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    # the plain loop takes ~9 ms a step: time both over a tenth
    T10 = T // 10
    ms10 = cuda_ms(lambda: dc.generate_ids_resume(gp, flag, cond[:, :T10],
                                                  gcond, 1, TEMP, st0))
    e0.record()
    dc._plain(gp, flag, dc.SAMPLE, cond[:, :T10], gcond, 1, TEMP, st0, None)
    e1.record()
    torch.cuda.synchronize()
    plain10 = e0.elapsed_time(e1)
    say("request", t0, f"one 1 s request B=1 T={T} {flag.compute_dtype}: "
        f"kernel {ms:.2f} ms ({1e3 * ms / T:.2f} us/step); over its first "
        f"{T10} steps kernel {ms10:.2f} ms, plain {plain10:.1f} ms "
        f"({1e3 * plain10 / T10:.1f} us/step)")
    info = dc.cluster_info(flag, gp.wff.dtype)
    barrier_ns = dc.cluster_agree_ns(device, 0)
    exchange_ns = dc.cluster_agree_ns(device, 1)
    check(info["max_active_clusters"] >= 1, f"no cluster fits: {info}")
    say("request", t0, f"cluster of {info['cluster']} blocks a row, "
        f"{info['smem_bytes']} B shared memory a block, weight slices "
        f"{'resident' if info['resident'] else 'read through L1/L2'}, "
        f"cudaOccupancyMaxActiveClusters {info['max_active_clusters']}; "
        f"one cluster barrier (release/acquire) {barrier_ns:.1f} ns, one "
        f"st.async + mbarrier exchange {exchange_ns:.1f} ns")

    t0 = time.monotonic()
    _, st1 = dc.generate_ids_resume(gp, flag, cond[:, :FIRST_PUSH], gcond, 1,
                                    TEMP, st0)
    check(torch.equal(st1.x_last, ids[:, FIRST_PUSH - 1]),
          "the first push does not end where the one call passes")
    end = FIRST_PUSH + RESUMED
    x_in, rest = ids[:, FIRST_PUSH - 1:end - 1], cond[:, FIRST_PUSH:end]
    lk = dc.teacher_logits(gp, flag, x_in, rest, gcond, st1)
    lp = dc._plain(gp, flag, dc.TEACHER, rest, gcond, 0, 1.0, st1, x_in)[0]
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    check(torch.isfinite(lk).all(), "non-finite kernel logits")
    check(err <= 3e-2 * scale, f"request shape: teacher logits off by {err} "
          f"(max|logits| {scale}, tol 0.03)")
    n_bad, n_far = pick_mismatches(dc, lp, ids[:, FIRST_PUSH:end], False, 1,
                                   FIRST_PUSH, 2 * 3e-2 * scale / TEMP)
    check(n_far == 0, f"request shape: {n_far} sampled kernel picks differ "
          "from the plain pick away from a near-tie")
    say("request", t0, f"steps {FIRST_PUSH}..{end} resumed from a first "
        f"push: "
        f"logits max|d| {err:.3g} <= 0.03*max|logits| = "
        f"{0.03 * scale:.3g}; "
        f"sampled near-tie mismatches {n_bad}/{RESUMED}")
    return ms10, plain10, T10, err


def bound(flops, nbytes, peak=PEAK_FLOPS):
    """(least card time in ms, what binds it) for the given work at the
    given operation rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def decode_work(cfg, B, T, es=2):
    """(flops, bytes) of the decode loop for B rows x T steps: each
    step's products (the layers' [past|h]@wff and z@[wr|ws], the
    condition projection of every layer, the head) and, once, the
    weights, the condition and the output ids (``es`` bytes an element:
    2 for bf16, 4 for float32)."""
    R, S, d, mu, L = (cfg.residual_channels, cfg.skip_channels, cfg.d,
                      cfg.mu, cfg.n_layers_total)
    flops = 2 * B * T * (L * (2 * R * 2 * R + R * (R + S)) + d * L * 2 * R
                         + S * S + S * mu)
    weights = es * (L * (4 * R * R + R * (R + S) + R + S) + d * L * 2 * R
                    + 2 * mu * R + S * S + S) + 4 * (S * mu + mu)
    nbytes = (weights + es * B * T * d + 4 * B * T
              + es * sum(cfg.dilations) * R)
    return flops, nbytes


def teacher_work(cfg, B, T):
    """(flops, bytes) of teacher-forced logits: the decode loop's, with
    the float32 logits [B, T, mu] written as well."""
    flops, nbytes = decode_work(cfg, B, T)
    return flops, nbytes + 4 * B * T * cfg.mu


def enc_work(B, M0, C, d, L, backward):
    """(flops, bytes) of the fused encoder (bf16) on h [B, M0, C]: every
    real tap of the L layers (2·4·C·C per output row) and the projection;
    h, the weights and z once.  Backward: the recompute, the weight
    gradients and the input gradient (each as many operations as the
    forward's taps) and the projection's two products; h, dz and the
    weights read, dh0 and the float32 gradients written."""
    rows = sum(B * (M0 >> (i + 1)) for i in range(L))
    taps = 2 * 4 * C * C * rows
    Nz = B * (M0 >> L)
    weights = 2 * (L * 4 * C * C + C * d) + 4 * (L * C + d)
    if not backward:
        return taps + 2 * Nz * C * d, 2 * B * M0 * C + weights + 4 * Nz * d
    grads = 4 * (L * 4 * C * C + L * C + C * d + d)
    return (3 * taps + 2 * 2 * Nz * C * d,
            2 * B * M0 * C + weights + 4 * Nz * d + 2 * B * M0 * C + grads)


def enc_exact_ms(B, M0, C, d, L, backward):
    """The FP64 tensor-core time (ms) of the products the encoder keeps
    in float64: the forward's taps and projection, the backward's
    recompute (its taps)."""
    rows = sum(B * (M0 >> (i + 1)) for i in range(L))
    flops = 2 * 4 * C * C * rows
    if not backward:
        flops += 2 * B * (M0 >> L) * C * d
    return 1e3 * flops / PEAK_F64_TC


def enc_dgemm_ms(h, wr, br, L):
    """The layers' products as float64 torch.matmul calls (one a layer)
    on windows built beforehand from the plain version's layer inputs:
    a yardstick of several library calls, not one."""
    import torch
    from vqvae_tpu_torch.kernels import encoder_cuda as ec
    ins = [h] + ec._layers(h, wr.to(h.dtype), br, 2)[:-1]
    wins = [ec._windows(x, 4, 2).double() for x in ins]
    ws = [wr[i].reshape(-1, wr.shape[-1]).double() for i in range(L)]
    ms = cuda_ms(lambda: [torch.matmul(a, b) for a, b in zip(wins, ws)],
                 reps=5)
    del ins, wins, ws
    return ms


def upsample_work(B, Tl, hop, d, es, backward):
    """(flops, bytes) of the upsampler on e [B, Tl, d] (es bytes an
    element): forward, every real tap (2·d products for each of the
    B·T·d outputs); e, uwk and the bias read once, cond written once.
    Backward: de and duw (each 2·B·Tl·2hop·d·d) and dub's adds; dcond
    (float32), e and uwk read, de, duw and dub (float32) written."""
    T = Tl * hop
    uwk = d * 2 * hop * d
    if not backward:
        return (2 * B * T * d * 2 * d,
                es * (B * Tl * d + uwk + B * T * d) + 4 * d)
    return (2 * 2 * B * Tl * 2 * hop * d * d + B * T * d,
            4 * B * T * d + es * (B * Tl * d + uwk)
            + 4 * (B * Tl * d + uwk + d))


def dot_work(N, hop, d):
    """(flops, bytes) of the dot probe's three contractions, float32:
    nd,rde->nre, nrd,rde->ne and nd,nre->dre, each 2·N·hop·d·d
    operations; each one's inputs read and output written once."""
    W, dp, e = hop * d * d, N * hop * d, N * d
    return (3 * 2 * N * hop * d * d,
            4 * ((e + W + dp) + (dp + W + e) + (e + dp + W)))


def compose_work(N, hop, d, E):
    """(flops, bytes) of ((x @ w).reshape(N·hop, d)) @ v, float32."""
    return (2 * N * d * hop * d + 2 * N * hop * d * E,
            4 * (N * d + d * hop * d + d * E + N * hop * E))


def take_rows_work(M, V, C, es, isz):
    """(flops, bytes) of the take_rows backward: one float32 add for each
    of the M·C values of g; g (es bytes a value) and the ids (isz bytes)
    read once, dw [V, C] (es bytes) written once."""
    return M * C, M * C * es + M * isz + V * C * es


def chain_work(L, steps, rows, width, int8):
    """(flops, bytes) of the decode chain: L·steps products of
    [rows, width] x [width, width]; x0, the weights (and the int8
    scales) read once, the bf16 output written once.  The products
    depend on each other one after the other, so the chain is bound by
    their latency, far above this."""
    flops = 2 * rows * width * width * L * steps
    w = L * width * width * (1 if int8 else 2) + (4 * L if int8 else 0)
    return flops, 2 * rows * width + w + 2 * rows * width


def chunk_work(mode, B, T, R, S, d, nl, mu, backward):
    """(flops, bytes) of one chunk call, bf16: every product of the
    layer chain (and, backward, the residual replay, the row-local chain
    and the weight gradients); each input read once, each output written
    once (the saved gates dominate)."""
    N = B * T
    per_row_layer = 2 * (2 * R * 2 * R + d * 2 * R + R * R + R * S)
    flops = N * nl * per_row_layer
    weights = 2 * nl * (4 * R * R + 2 * d * R + R * R + R + R * S)
    lead = 4 * N + 2 * (2 * mu * R + R) if mode == 2 else 2 * N * R
    gall = 2 * N * nl * 2 * R
    if not backward:
        tail = 2 * N * S if mode == 1 else 2 * S
        nbytes = (lead + 2 * N * d + 2 * B * nl * 2 * R + weights + tail
                  + 2 * N * R + 2 * N * S + gall)
    else:
        flops = 2 * flops + N * nl * 2 * R * R
        dlead = 2 * (2 * mu * R + R) if mode == 2 else 2 * N * R
        nbytes = (lead + 2 * N * d + 2 * B * nl * 2 * R + weights + gall
                  + 2 * N * R + 2 * N * S + dlead + 2 * N * d
                  + 2 * B * nl * 2 * R + weights)
    return flops, nbytes


def rec_work(mode, B, T, R, S, d, nl, mu, expand=1.0):
    """(flops, bytes) of one recompute backward, bf16: the save-gates
    backward's products plus pass 1's u products (the residual replay is
    in both), pass 1 over ``expand`` times the rows (the windowed
    backward's halo: (Tc + A) / Tc); no saved gates are read."""
    flops, nbytes = chunk_work(mode, B, T, R, S, d, nl, mu, True)
    N = B * T
    replay = N * nl * 2 * R * R
    pass1 = N * nl * 2 * (2 * R * 2 * R + d * 2 * R + R * R)
    return (flops - replay + expand * pass1,
            nbytes - 2 * N * nl * 2 * R)


def vq_work(N, K, d):
    """(flops, bytes) of the VQ search: 2·N·K·d float32 products plus the
    scale and norm per score; z, the codebook and the ids once."""
    return 2 * N * K * d + 2 * N * K, 4 * (N * d + K * d + N)


def head_exact_ms(N, S):
    """The float32-FMA time (ms) of x0 @ w1 alone, which both head kernels
    sum in k order on the CUDA cores (the backward in its recompute)."""
    return 1e3 * 2 * N * S * S / PEAK_F32


def head_work(N, S, mu, backward):
    flops = 2 * N * (S * S + S * mu) * (3 if backward else 1)
    nbytes = 2 * N * S + 4 * N + 2 * (S * S + S) + 2 * S * mu + 4 * mu
    if backward:
        nbytes += 2 * N * S + 4 * (S * S + S + S * mu + mu)
    return flops, nbytes


def chunk_inputs(mode, cdt, device, B, T, cfg, seed=0):
    """Seeded inputs of one 10-layer chunk at the model's widths, with
    non-zero biases (init zeroes them, which would hide bias bugs)."""
    import torch
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    R, S, d, mu = cfg.residual_channels, cfg.skip_channels, cfg.d, cfg.mu
    dils = cfg.dilations[:wt.MAX_CHUNK_LAYERS]
    nl = len(dils)
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device, cdt)
    w = (rn(B, T, d), rn(B, nl, 2 * R, scale=0.3),
         rn(nl, 2 * R, 2 * R, scale=(2 * R) ** -0.5),
         rn(nl, d, 2 * R, scale=d ** -0.5), rn(nl, R, R, scale=R ** -0.5),
         rn(nl, R, scale=0.1), rn(nl, R, S, scale=R ** -0.5))
    wemb = bemb = None
    if mode == wt.EMBED:
        x = torch.randint(0, mu, (B, T), generator=g,
                          dtype=torch.int32).to(device)
        wemb, bemb, tail = rn(2, mu, R, scale=0.7), rn(R, scale=0.1), \
            rn(S, scale=0.1)
    else:
        x = rn(B, T, R)
        tail = rn(B, T, S, scale=0.5) if mode == wt.ACC else rn(S, scale=0.1)
    cots = (rn(B, T, R, scale=0.01), rn(B, T, S, scale=0.01))
    return (tuple(dils), mode, x, wemb, bemb, *w, tail), cots


def head_inputs(cdt, device, N, cfg, seed=0):
    import torch
    S, mu = cfg.skip_channels, cfg.mu
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device, cdt)
    return (rn(N, S), torch.randint(0, mu, (N,), generator=g,
                                    dtype=torch.int32).to(device),
            rn(S, S, scale=S ** -0.5), rn(S, scale=0.1),
            rn(S, mu, scale=S ** -0.5),
            (torch.randn(mu, generator=g) * 0.1).to(device))


def chunk_plain(args, cots=None, gall=None):
    """The chunk's plain version: forward, or with cots the float32
    gradients (embedding-table gradients included)."""
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws, tail = args
    h0 = wt.embed_h(x, wemb, bemb) if mode == wt.EMBED else x
    if cots is None:
        return wt.fwd_plain(dils, h0, cond, gc, wff, vc, wr, br, ws, tail,
                            mode == wt.ACC)
    out = wt.bwd_plain(dils, h0, cond, gc, wff, vc, wr, br, ws, gall, *cots)
    if mode != wt.EMBED:
        return out + (None, None)
    return (None,) + out[1:] + wt.embed_grads_plain(x, out[0], h0.dtype,
                                                    wemb.shape[1])


def chunk_rec_plain(args, cots, windows=0):
    """The recompute (windows > 1: time-windowed) backward's plain
    version: float32 gradients, embedding-table gradients included."""
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws, tail = args
    w = (cond, gc, wff, vc, wr, br, ws)
    if windows > 1:
        return wt.bwd_win_plain(dils, windows, x, *w, *cots) + (None, None)
    h0 = wt.embed_h(x, wemb, bemb) if mode == wt.EMBED else x
    out = wt.bwd_rec_plain(dils, h0, *w, *cots)
    if mode != wt.EMBED:
        return out + (None, None)
    return (None,) + out[1:] + wt.embed_grads_plain(x, out[0], h0.dtype,
                                                    wemb.shape[1])


def chunk_rec_kernel(args, cots, windows=0):
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    dils, mode, x, wemb, bemb, cond, gc, wff, vc, wr, br, ws, tail = args
    if windows > 1:
        return wt.bwd_win_kernel(dils, windows, x, cond, gc, wff, vc, wr, br,
                                 ws, *cots)
    return wt.bwd_rec_kernel(*args[:-1], *cots)


def vq_check(N, device, errs, seed=0):
    """The VQ kernel against its plain version on seeded z [N, 64] and a
    codebook [512, 64]: ids equal on every row whose two best float64
    scores differ by more than VQ_MARGIN of the largest; the worst score
    gap between the two picks is recorded.  Returns (inputs, rows left
    out, mismatches)."""
    import torch
    from vqvae_tpu_torch.kernels import vq_cuda
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(N, 64, generator=g).to(device)
    cb = torch.randn(512, 64, generator=g).to(device)
    got = vq_cuda.vq_argmin_kernel(z, cb).long()
    want = vq_cuda.vq_argmin_plain(z, cb).long()
    s = 2 * (z.double() @ cb.double().T) - (cb.double() ** 2).sum(-1)
    top = s.topk(2, -1).values
    far = (top[:, 0] - top[:, 1]) > VQ_MARGIN * float(s.abs().max())
    bad = got != want
    check(not bool((bad & far).any()), f"vq N={N}: {int((bad & far).sum())}"
          " ids differ from the plain search away from a near-tie")
    gap = float((s.gather(1, got[:, None]) - s.gather(1, want[:, None]))
                .abs().max())
    errs["vq_argmin"] = max(errs.get("vq_argmin", 0.0), gap)
    return (z, cb), int((~far).sum()), int(bad.sum())


def compare(name, got, want, tol, errs):
    """Each tensor pair within tol * max|want|; records the worst
    absolute error under ``name``; returns the worst relative one."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            continue
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        check(bool(a.isfinite().all()), f"{name}: output {i} not finite")
        check(err <= tol * scale, f"{name}: output {i} off by {err} "
              f"(max {scale}, tol {tol})")
        errs[name] = max(errs.get(name, 0.0), err)
        worst = max(worst, err / (scale + 1e-30))
    return worst


def train_kernel_phase(cfg_all, device):
    """The training kernels against their plain versions at stretch
    width, B=2, T=7680: outputs and every gradient; the VQ search."""
    import torch
    from vqvae_tpu_torch.kernels import head_ce_cuda as hc
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    cfg = cfg_all.model
    B, T = 2, cfg_all.data.length
    errs = {}
    for cdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for mode, mname in ((wt.SEED, "seed"), (wt.ACC, "acc"),
                            (wt.EMBED, "embed")):
            t0 = time.monotonic()
            args, cots = chunk_inputs(mode, cdt, device, B, T, cfg, mode)
            fk = wt.fwd_kernel(*args)
            fp = chunk_plain(args)
            rf = compare("chunk_fwd", fk, fp, tol, errs)
            bk = wt.bwd_kernel(*args[:-1], fp[2], *cots)
            bp = chunk_plain(args, cots, fp[2])
            rb = compare("chunk_bwd", bk, bp, tol, errs)
            del fk, fp, bk, bp
            fk = wt.fwd_kernel(*args, save_gates=False)
            check(fk[2] is None, "the recompute forward wrote gates")
            rn = compare("chunk_fwd", fk[:2], chunk_plain(args)[:2], tol,
                         errs)
            rr = compare("chunk_bwd_rec", chunk_rec_kernel(args, cots),
                         chunk_rec_plain(args, cots), tol, errs)
            rw = []
            if mode != wt.EMBED:
                for nT in (2, 4):
                    rw.append(compare("chunk_bwd_win",
                                      chunk_rec_kernel(args, cots, nT),
                                      chunk_rec_plain(args, cots, nT), tol,
                                      errs))
            torch.cuda.synchronize()
            say("train-kernels", t0, f"chunk {mname} {str(cdt)[6:]} B={B} "
                f"T={T}: forward (h, skips, gates) max rel err {rf:.3g} "
                f"(without gates {rn:.3g}), save-gates backward (every "
                f"gradient) {rb:.3g}, recompute backward {rr:.3g}"
                + (f", windowed backward (2, 4 windows) {rw[0]:.3g}, "
                   f"{rw[1]:.3g}" if rw else "") + f" <= {tol}")
        t0 = time.monotonic()
        args = head_inputs(cdt, device, B * T, cfg)
        g = torch.tensor(1.0, device=device)
        rf = compare("head_ce_fwd", [hc.fwd_kernel(*args)],
                     [hc.fwd_plain(*args)], tol, errs)
        rb = compare("head_ce_bwd", hc.bwd_kernel(*args, g),
                     hc.bwd_plain(*args, g), tol, errs)
        say("train-kernels", t0, f"head+CE {str(cdt)[6:]} N={B * T}: loss "
            f"rel err {rf:.3g}, gradients {rb:.3g} <= {tol}")
    for N in (1920, 7680):
        t0 = time.monotonic()
        _, left_out, bad = vq_check(N, device, errs, seed=N)
        say("train-kernels", t0, f"vq N={N} K=512 d=64: ids equal to the "
            f"plain search on every row above the margin; {left_out} of "
            f"{N} rows within {VQ_MARGIN} of max|score| left out, {bad} "
            f"ids differ in all; worst score gap {errs['vq_argmin']:.3g}")
    return errs


def train_cli_phase():
    """vqvae-torch-train --preset stretch --dataset sine --steps 3 as a
    user runs it; returns its kernel launch counts."""
    from vqvae_tpu_torch.cli.common import load_params
    from vqvae_tpu_torch.configs import get_config
    t0 = time.monotonic()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_train_",
                           dir=os.path.join(ROOT, "build"))
    try:
        r = subprocess.run(
            [sys.executable, "-m", "vqvae_tpu_torch.cli.train", "--preset",
             TRAIN_PRESET, "--dataset", "sine", "--steps", "3", "--out", out,
             "--profile", "2"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
            fail(f"the trainer exited with {r.returncode}")
        recs = [json.loads(ln) for ln in open(os.path.join(out,
                                                           "log.jsonl"))]
        check(bool(recs) and all(np.isfinite(rec[k]) for rec in recs
                                 for k in ("loss", "loss1", "loss2",
                                           "loss3")),
              f"non-finite or missing losses in log.jsonl: {recs}")
        params = load_params(os.path.join(out, "weights.npz"),
                             get_config(TRAIN_PRESET))
        check(all(bool(np.isfinite(v.detach().numpy()).all())
                  for v in params.state_dict().values()),
              "the exported weights are not finite")
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("kernel launches: ")]
        check(len(line) == 1, "the trainer printed no launch counts")
        counts = json.loads(line[0].split(": ", 1)[1])
        traces = [os.path.join(out, "profile", f) for f in
                  os.listdir(os.path.join(out, "profile"))]
        check(len(traces) == 1 and os.path.getsize(traces[0]) > 0,
              f"--profile 2 left no trace: {traces}")
        with open(traces[0]) as f:
            events = json.load(f).get("traceEvents", [])
        n_dev = sum(1 for ev in events if ev.get("cat") == "kernel")
        check(n_dev > 0, "the --profile trace holds no kernel of the card")
        path = ("chunk_fwd", "chunk_bwd", "head_ce_fwd", "head_ce_bwd")
        check(all(counts[k] > 0 for k in path),
              f"a kernel of the stretch path was not launched: {counts}")
        say("train-cli", t0, f"{TRAIN_PRESET}, 3 steps with --profile 2: "
            f"exit 0; trace {os.path.basename(traces[0])} "
            f"{os.path.getsize(traces[0])} bytes, {n_dev} card kernels; step 1 "
            f"loss1 {recs[0]['loss1']:.4f} loss2 {recs[0]['loss2']:.4f} "
            f"loss3 {recs[0]['loss3']:.4f}; weights.npz loads; launches "
            f"{counts}")
        return counts
    finally:
        shutil.rmtree(out, ignore_errors=True)


def cuda_ms(fn, reps=3):
    """Mean ms per call of fn on the card (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profile_step(step, n):
    """(wall ms, device-busy ms, top kernels by device time) over n
    steps under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows


def train_time_phase(cfg_all, device, errs):
    """stretch at B=64, T=7680, bf16: step time, busy share, split by
    kernel, peak memory, each kernel against its plain version (worst
    absolute errors added to ``errs``) and timed beside it and its bound,
    and the plain-decoder step.  Returns the per-kernel timing entries."""
    import dataclasses
    import torch
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.audio.loader import BatchLoader
    from vqvae_tpu_torch.kernels import head_ce_cuda as hc
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    from vqvae_tpu_torch.utils.flops import train_step_flops
    cfg = cfg_all
    B, T = cfg.train.batch_size, cfg.data.length
    loader = BatchLoader(SineDataset(cfg.data), B, seed=0)
    batches = [tuple(torch.from_numpy(a).to(device) for a in next(loader))
               for _ in range(2)]
    loader.close()

    def stepper(c):
        state = create_train_state(c, device)
        it = [0]

        def step():
            wav, spk = batches[it[0] % 2]
            it[0] += 1
            return train_step(state, wav, spk, c)
        return state, step

    t0 = time.monotonic()
    state, step = stepper(cfg)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    n = 3
    for _ in range(n):
        m = step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1) / n
    peak = torch.cuda.max_memory_allocated(device)
    check(np.isfinite(float(m["loss"])), "non-finite loss at B=64")
    wall, busy, rows = profile_step(step, 2)
    mfu = train_step_flops(cfg, B) / (step_ms / 1e3) / PEAK_FLOPS
    say("train-time", t0, f"{TRAIN_PRESET} B={B} T={T} bf16: "
        f"{step_ms:.1f} ms/step ({B * T / step_ms * 1e3 / 16000:.2f} s of "
        f"audio per s; {100 * mfu:.2f}% of 989 TFLOP/s by "
        f"train_step_flops), peak memory {peak / 2**30:.2f} GiB; device busy "
        f"{busy:.1f} of {wall:.1f} ms over 2 steps "
        f"({100 * busy / wall:.1f}%)")
    for ms_, key, count in rows[:14]:
        print(f"    {100 * ms_ / busy:5.1f}%  {ms_ / 2:9.3f} ms/step  "
              f"x{count // 2:<4d} {key[:90]}", flush=True)
    del state, step

    # each kernel at B=64, the main path's split-K partitioning, against
    # its plain version (outputs and every gradient, 3e-2 of max), then
    # timed beside the plain version and its bound
    t0 = time.monotonic()
    mc = cfg.model
    R, S, d, mu = mc.residual_channels, mc.skip_channels, mc.d, mc.mu
    nl = wt.MAX_CHUNK_LAYERS
    per = {"chunk_fwd": {}, "chunk_bwd": {}}
    n_chunks = mc.n_layers_total // nl
    for mode in (wt.EMBED, wt.ACC):
        args, cots = chunk_inputs(mode, torch.bfloat16, device, B, T, mc)
        fp = chunk_plain(args)
        fk = wt.fwd_kernel(*args)
        rf = compare("chunk_fwd", fk, fp, 3e-2, errs)
        gall = fp[2]
        del fp
        bk = wt.bwd_kernel(*args[:-1], gall, *cots)
        rb = compare("chunk_bwd", bk, chunk_plain(args, cots, gall), 3e-2,
                     errs)
        # a second call on the same inputs gives the same bits
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(fk, wt.fwd_kernel(*args)))
        same = same and all(a is None or torch.equal(a, b_) for a, b_ in
                            zip(bk, wt.bwd_kernel(*args[:-1], gall, *cots)))
        mname = "embed" if mode == wt.EMBED else "acc"
        check(same, f"chunk {mname} B={B}: a second call differs")
        del fk, bk
        say("train-time", t0, f"chunk {mname} bfloat16 B={B} T={T}: forward "
            f"max rel err {rf:.3g}, backward {rb:.3g} <= 0.03; a second "
            f"call of each is bit-equal")
        ms_f = cuda_ms(lambda: wt.fwd_kernel(*args))
        ms_b = cuda_ms(lambda: wt.bwd_kernel(*args[:-1], gall, *cots))
        pf = cuda_ms(lambda: chunk_plain(args), reps=1)
        pb = cuda_ms(lambda: chunk_plain(args, cots, gall), reps=1)
        per["chunk_fwd"][mode] = (ms_f, pf, chunk_work(mode, B, T, R, S, d,
                                                       nl, mu, False))
        per["chunk_bwd"][mode] = (ms_b, pb, chunk_work(mode, B, T, R, S, d,
                                                       nl, mu, True))
        del args, cots, gall
        torch.cuda.empty_cache()
    out = {}
    weights = {wt.EMBED: 1, wt.ACC: n_chunks - 1}   # launches per step
    for name, by_mode in per.items():
        k = sum(weights.values())
        ms_ = sum(w * by_mode[m][0] for m, w in weights.items()) / k
        plain = sum(w * by_mode[m][1] for m, w in weights.items()) / k
        fl = sum(w * by_mode[m][2][0] for m, w in weights.items()) / k
        by = sum(w * by_mode[m][2][1] for m, w in weights.items()) / k
        bms, bby = bound(fl, by)
        out[name] = dict(ms=ms_, plain_ms=plain, bound_ms=bms, bound_by=bby)
        say("train-time", t0, f"{name} per launch (embed x1, acc x"
            f"{n_chunks - 1} averaged): kernel {ms_:.2f} ms, plain "
            f"{plain:.2f} ms, bound {bms:.3f} ms ({bby}); embed "
            f"{by_mode[wt.EMBED][0]:.2f} ms, acc {by_mode[wt.ACC][0]:.2f} ms")
    # the backwards' weight-gradient product alone, at the dwff shape:
    # h(t - dil) [B*T, R] against du [B*T, 2R], beside one matmul
    gen = torch.Generator().manual_seed(5)
    dil = mc.dilations[wt.MAX_CHUNK_LAYERS - 1]
    a = torch.randn(B * T, R, generator=gen).to(device, torch.bfloat16)
    b = (torch.randn(B * T, 2 * R, generator=gen) * 0.01).to(
        device, torch.bfloat16)
    want = wt.atb_plain(a, b, T, dil)
    before = wt.launches_atb
    got = wt.atb_kernel(a, b, T, dil)
    check(wt.launches_atb == before + 1, "atb_kernel did not launch")
    ratb = compare("atb", [got], [want], 1e-4, errs)
    ash = wt._shift_right(a.reshape(B, T, R), dil).reshape(B * T, R)
    ms_ = cuda_ms(lambda: wt.atb_kernel(a, b, T, dil), reps=10)
    lms = cuda_ms(lambda: torch.matmul(ash.T, b), reps=10)
    pms = cuda_ms(lambda: wt.atb_plain(a, b, T, dil), reps=3)
    bms, bby = bound(2 * B * T * R * 2 * R,
                     2 * B * T * (R + 2 * R) + 4 * R * 2 * R)
    out["atb"] = dict(ms=ms_, plain_ms=pms, bound_ms=bms, bound_by=bby,
                      library_ms=lms)
    say("train-time", t0, f"weight-gradient product alone (dwff: h(t-{dil})"
        f" [{B * T}, {R}]^T du [{B * T}, {2 * R}], bf16): kernel "
        f"{ms_:.3f} ms, torch.matmul(A.T, B) {lms:.3f} ms, plain (float32) "
        f"{pms:.3f} ms, bound {bms:.4f} ms ({bby}); max rel err {ratb:.3g}"
        f" <= 1e-4")
    del a, b, ash, want, got
    torch.cuda.empty_cache()
    args = head_inputs(torch.bfloat16, device, B * T, mc)
    g = torch.tensor(1.0, device=device)
    lk, gk = hc.fwd_kernel(*args), hc.bwd_kernel(*args, g)
    rf = compare("head_ce_fwd", [lk], [hc.fwd_plain(*args)], 3e-2, errs)
    rb = compare("head_ce_bwd", gk, hc.bwd_plain(*args, g), 3e-2, errs)
    # a second call on the same inputs gives the same bits
    same = torch.equal(lk, hc.fwd_kernel(*args)) and all(
        torch.equal(a, b_) for a, b_ in zip(gk, hc.bwd_kernel(*args, g)))
    check(same, f"head+CE B={B}: a second call differs")
    # x1 equals the plain version's, so only float32 sum orders move the
    # loss: a tile computed wrong would move it past 1e-4
    check(rf <= 1e-4, f"head+CE B={B}: loss rel err {rf:.3g} > 1e-4")
    del gk
    say("train-time", t0, f"head+CE bfloat16 N={B * T}: loss rel err "
        f"{rf:.3g} <= 1e-4, gradients {rb:.3g} <= 0.03; a second call of "
        f"each is bit-equal")
    x1_ms = head_exact_ms(B * T, S)
    for name, kern, plain, bwd in (
            ("head_ce_fwd", lambda: hc.fwd_kernel(*args),
             lambda: hc.fwd_plain(*args), False),
            ("head_ce_bwd", lambda: hc.bwd_kernel(*args, g),
             lambda: hc.bwd_plain(*args, g), True)):
        ms_, pms = cuda_ms(kern), cuda_ms(plain, reps=1)
        bms, bby = bound(*head_work(B * T, S, mu, bwd))
        out[name] = dict(ms=ms_, plain_ms=pms, bound_ms=bms, bound_by=bby)
        say("train-time", t0, f"{name}: kernel {ms_:.3f} ms, plain "
            f"{pms:.2f} ms, bound {bms:.3f} ms ({bby}, bf16 rate); x0 @ w1 "
            f"alone at the float32 FMA rate {x1_ms:.3f} ms")
    del args
    torch.cuda.empty_cache()

    # the step with the plain decoder and head, at the largest B that fits
    t0 = time.monotonic()
    plain_cfg = cfg.replace(model=dataclasses.replace(
        mc, decoder_kernel="xla", head_kernel="xla", embed_in_kernel=False))
    for b in (B, B // 2, B // 4):
        try:
            c = plain_cfg.replace(train=dataclasses.replace(
                plain_cfg.train, batch_size=b))
            batches[:] = [(w[:b], s_[:b]) for w, s_ in batches]
            state, step = stepper(c)
            step()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(2):
                m = step()
            torch.cuda.synchronize()
            pms = 1e3 * (time.perf_counter() - t1) / 2
            check(np.isfinite(float(m["loss"])), "plain step: non-finite")
            say("train-time", t0, f"plain decoder + head step "
                f"(decoder_kernel=xla, head_kernel=xla) at B={b}: "
                f"{pms:.1f} ms/step" + ("" if b == B else
                                        f" (B={B} did not fit)"))
            break
        except torch.cuda.OutOfMemoryError:
            state = step = None
            torch.cuda.empty_cache()
    else:
        say("train-time", t0, "plain decoder + head step: did not fit at "
            f"B={B // 4}")
    return out


def write_vctk_tree(root, speakers=4, utts=5, sr=48000):
    """A VCTK-layout tree ``<root>/wav48/p<N>/p<N>_<k>.wav``: int16
    harmonic tones of 1.0-1.4 s between 0.3 s of near-silence, at 48 kHz
    (the loader resamples to 16 kHz and trims the silence)."""
    from scipy.io import wavfile
    rng = np.random.default_rng(0)
    for s_ in range(speakers):
        spk = f"p{225 + s_}"
        d = os.path.join(root, "wav48", spk)
        os.makedirs(d, exist_ok=True)
        for u in range(utts):
            n = int(sr * (1.0 + 0.1 * u))
            t = np.arange(n) / sr
            f = 110.0 * (s_ + 1) * (1 + 0.05 * u)
            tone = 0.5 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(
                4 * np.pi * f * t)
            pad = np.zeros(int(0.3 * sr))
            x = np.concatenate([pad, tone, pad])
            x += 1e-4 * rng.standard_normal(x.shape)
            wavfile.write(os.path.join(d, f"{spk}_{u:03d}.wav"), sr,
                          (x * 32767).astype(np.int16))


def train_vctk(tree, out, steps, *extra):
    """One ``vqvae-torch-train --preset vctk-multi --dataset vctk`` run
    as a user runs it: (launch counts, log records)."""
    args = [sys.executable, "-m", "vqvae_tpu_torch.cli.train", "--preset",
            "vctk-multi", "--dataset", "vctk", "--root", tree, "--impl",
            "pallas", "--eval-every", "2", "--steps", str(steps), "--out",
            out, "--set", "train.checkpoint_every=2", *extra]
    r = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
        fail(f"the vctk-multi trainer exited with {r.returncode}: "
             f"{' '.join(args[2:])}")
    recs = [json.loads(ln) for ln in open(os.path.join(out, "log.jsonl"))]
    check(bool(recs) and all(np.isfinite(rec[k]) for rec in recs
                             for k in ("loss", "loss1", "loss2", "loss3")),
          f"non-finite or missing losses in {out}/log.jsonl: {recs}")
    check(any("val_loss1" in rec and np.isfinite(rec["val_loss1"])
              for rec in recs), f"no val_ keys in {out}/log.jsonl: {recs}")
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("kernel launches: ")]
    check(len(line) == 1, "the trainer printed no launch counts")
    return json.loads(line[0].split(": ", 1)[1]), recs


def train_cli_vctk_phase():
    """vctk-multi through the CLI on a synthetic VCTK tree: a straight
    4-step run, 2 steps plus a resume to 4 (equal weights), 2 steps of
    the windowed backward and 2 with ``--loader grain --tensorboard``,
    the four side by side (independent processes; their checks hold
    values, not times).  Returns (counts of the straight run, counts of
    the windowed run)."""
    t0 = time.monotonic()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_vctk_",
                            dir=os.path.join(ROOT, "build"))
    try:
        tree = os.path.join(work, "VCTK")
        write_vctk_tree(tree)
        a, b, c, g = (os.path.join(work, x) for x in ("straight", "resumed",
                                                       "windowed", "grain"))

        def resumed():
            train_vctk(tree, b, 2)
            return train_vctk(tree, b, 4, "--resume")
        with ThreadPoolExecutor(max_workers=4) as pool:
            runs = [pool.submit(train_vctk, tree, a, 4), pool.submit(resumed),
                    pool.submit(train_vctk, tree, c, 2, "--bwd-windows", "4"),
                    pool.submit(train_vctk, tree, g, 2, "--loader", "grain",
                                "--tensorboard")]
            (counts, recs), (rcounts, rrecs), (wcounts, wrecs), grain = (
                f.result() for f in runs)
        say("train-cli-vctk", t0, "5 trainer processes, 4 side by side "
            "(straight; 2 then --resume; --bwd-windows 4; --loader grain "
            "--tensorboard): exit 0")
        path = ("chunk_fwd", "chunk_bwd_rec", "vq_argmin", "take_rows_bwd")
        check(all(counts[k] > 0 for k in path) and counts["chunk_bwd"] == 0
              and counts["chunk_bwd_win"] == 0,
              f"vctk-multi did not run the recompute path: {counts}")
        say("train-cli-vctk", t0, f"vctk-multi --dataset vctk --impl pallas,"
            f" 4 steps: step 1 loss1 {recs[0]['loss1']:.4f} loss2 "
            f"{recs[0]['loss2']:.4f}; val_loss1 at steps "
            f"{[r['iteration'] for r in recs if 'val_loss1' in r]}; "
            f"launches {counts}")
        check([r["iteration"] for r in rrecs][-1] == 4 and
              rcounts["chunk_bwd_rec"] > 0, f"the resume did not reach step "
              f"4 through the recompute path: {rcounts}")
        worst, bad = 0.0, []
        with np.load(os.path.join(a, "weights.npz")) as wa, \
                np.load(os.path.join(b, "weights.npz")) as wb:
            check(set(wa.files) == set(wb.files), "weights.npz keys differ")
            for k in wa.files:
                x, y = wa[k].astype(np.float64), wb[k].astype(np.float64)
                worst = max(worst, float(np.abs(x - y).max()))
                if not np.allclose(y, x, rtol=1e-6, atol=1e-7):
                    bad.append(k)
        check(not bad, f"resumed weights differ from the straight run's "
              f"beyond rtol 1e-6: {bad} (max |d| {worst})")
        say("train-cli-vctk", t0, f"2 steps + --resume to 4 == 4 straight "
            f"steps (weights.npz max |d| {worst:.3g}, rtol 1e-6); resumed "
            f"run's launches {rcounts}")
        check(wcounts["chunk_bwd_win"] > 0 and wcounts["vq_argmin"] > 0
              and wcounts["take_rows_bwd"] > 0,
              f"--bwd-windows 4 did not run the windowed backward: {wcounts}")
        say("train-cli-vctk", t0, f"--bwd-windows 4, 2 steps: step 1"
            f" loss1 {wrecs[0]['loss1']:.4f}; launches {wcounts}")
        grain_tb_check(g, grain, recs)
        return counts, wcounts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def grain_tb_check(out, run, straight):
    """The 2-step ``--loader grain --tensorboard`` run in ``out`` (its
    ``train_vctk`` result ``run``): the recompute path, the straight
    run's step 1 and 2 losses (rtol 1e-6: the loader is the only
    difference), and one event file in <out>/tb whose (tag, step, value)
    triples equal log.jsonl's, read by the port's own reader."""
    from vqvae_tpu_torch.train.metrics import read_events
    t0 = time.monotonic()
    gcounts, grecs = run
    path = ("chunk_fwd", "chunk_bwd_rec", "vq_argmin", "take_rows_bwd")
    check(all(gcounts[k] > 0 for k in path),
          f"--loader grain did not run the recompute path: {gcounts}")
    want = {r["iteration"]: r for r in straight}
    got = {r["iteration"]: r for r in grecs}
    check(set(got) == {1, 2} and {1, 2} <= set(want),
          f"log rows: grain {sorted(got)}, straight {sorted(want)}")
    worst = 0.0
    for step in (1, 2):
        for k in ("loss", "loss1", "loss2", "loss3"):
            a, b = got[step][k], want[step][k]
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
            check(np.isclose(a, b, rtol=1e-6, atol=0),
                  f"--loader grain step {step} {k} {a} != straight {b}")
    files = os.listdir(os.path.join(out, "tb"))
    check(len(files) == 1 and files[0].startswith("events.out.tfevents."),
          f"<out>/tb holds {files}")
    events = read_events(os.path.join(out, "tb", files[0]))
    check(events[0]["file_version"] == "brain.Event:2",
          "the event file does not start with its file_version")
    triples = [(ev["step"], tag, v) for ev in events[1:]
               for tag, v in ev["scalars"]]
    logged = [(r["iteration"], k, float(np.float32(v))) for r in grecs
              for k, v in r.items() if k != "iteration"]
    check(triples == logged, "TensorBoard scalars != log.jsonl: "
          f"{triples[:6]} against {logged[:6]}")
    say("train-cli-vctk", t0, f"--loader grain --tensorboard, 2 steps: "
        f"losses at steps 1, 2 == the straight run's (max rel |d| "
        f"{worst:.3g}, rtol 1e-6); {len(triples)} scalars in "
        f"{files[0]} == log.jsonl; launches {gcounts}")


def host_data_phase():
    """``host_data`` on a synthetic VCTK tree of its own under build/."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_host_",
                            dir=os.path.join(ROOT, "build"))
    try:
        tree = os.path.join(work, "VCTK")
        write_vctk_tree(tree)
        host_data(tree)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def host_data(tree):
    """The host side on the synthetic VCTK tree with vctk-multi's data
    config: the native decoder serves every load (no scipy load) and
    equals scipy bit for bit (mono int16); GrainBatchLoader with 2 worker
    processes gives BatchLoader's first 8 batches bit for bit, from
    batch 0 and from batch 5, and close() leaves no child process; each
    loader's ms a batch and each decoder's ms a file (host numbers)."""
    import multiprocessing
    from scipy.io import wavfile
    from vqvae_tpu_torch.audio import wav_io
    from vqvae_tpu_torch.audio.datasets import WavDataset, scan_vctk
    from vqvae_tpu_torch.audio.grain_loader import GrainBatchLoader
    from vqvae_tpu_torch.audio.loader import BatchLoader
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.native import bindings
    t0 = time.monotonic()
    cfg = get_config(PRESET)
    paths, ids, _ = scan_vctk(tree)
    check(bindings.available(), "the native audio library did not build")
    before = dict(wav_io.decoders)
    ms = {}
    t = time.perf_counter()
    for p in paths:
        wav_io.load_wav(p, cfg.data.sr)
    ms["load_wav (native, 48 -> 16 kHz)"] = \
        1e3 * (time.perf_counter() - t) / len(paths)
    check(wav_io.decoders["scipy"] == before["scipy"]
          and wav_io.decoders["native"] == before["native"] + len(paths),
          f"decoders {before} -> {wav_io.decoders}: a load went to scipy")
    nat, sci = [], []
    t = time.perf_counter()
    for p in paths:
        nat.append(bindings.load_wav(p))
    ms["native decode"] = 1e3 * (time.perf_counter() - t) / len(paths)
    t = time.perf_counter()
    for p in paths:
        file_sr, data = wavfile.read(p)
        sci.append((data.astype(np.float32) / 32768.0, file_sr))
    ms["scipy decode"] = 1e3 * (time.perf_counter() - t) / len(paths)
    for p, (a, asr), (b, bsr) in zip(paths, nat, sci):
        check(asr == bsr and a.dtype == b.dtype and np.array_equal(a, b),
              f"{p}: native decode != scipy's")
    say("host-data", t0, f"{len(paths)} files: every load through the "
        "native library (no scipy load), its decode == scipy's bit for "
        f"bit; host ms a file ({nvidia_smi()}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    t0 = time.monotonic()
    B = cfg.train.batch_size
    children = {p.pid for p in multiprocessing.active_children()}
    lines = []
    for start in (0, 5):
        runs = {}
        for name, make in (
                ("threads", lambda ds: BatchLoader(ds, B, seed=3,
                                                   start_batch=start)),
                ("grain, 2 workers", lambda ds: GrainBatchLoader(
                    ds, B, seed=3, num_workers=2, start_batch=start))):
            ds = WavDataset(paths, ids, cfg.data)     # a cold cache each
            t = time.perf_counter()
            ld = make(ds)
            try:
                batches = [next(ld)]
                t1 = time.perf_counter()
                batches += [next(ld) for _ in range(7)]
                t2 = time.perf_counter()
            finally:
                ld.close()
            runs[name] = batches
            lines.append(f"{name} from {start}: first batch "
                         f"{1e3 * (t1 - t):.1f} ms, then "
                         f"{1e3 * (t2 - t1) / 7:.2f} ms a batch")
        for (wa, sa), (wb, sb) in zip(runs["threads"],
                                      runs["grain, 2 workers"]):
            check(wa.shape == (B, cfg.data.length + 1)
                  and np.array_equal(wa, wb) and np.array_equal(sa, sb),
                  f"GrainBatchLoader batches from {start} != BatchLoader's")
    left = {p.pid for p in multiprocessing.active_children()} - children
    check(not left, f"close() left worker processes {left}")
    say("host-data", t0, f"GrainBatchLoader(num_workers=2) == BatchLoader, "
        f"8 batches of {B} x {cfg.data.length + 1} from batch 0 and from "
        "5, "
        "bit for bit; close() left no child process; host times "
        f"({nvidia_smi()}): " + "; ".join(lines))


def train_time_vctk_phase(device, errs):
    """vctk-multi at B=16, T=7680, bf16, with the VQ kernel: step time and
    peak memory for the recompute, windowed, save-gates and plain
    decoders; the recompute step's profile; the recompute and windowed
    backwards and the VQ search against their plain versions at these
    shapes, timed beside them and their bounds."""
    import dataclasses
    import torch
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.audio.loader import BatchLoader
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.kernels import vq_cuda
    from vqvae_tpu_torch.kernels import wavenet_train_cuda as wt
    from vqvae_tpu_torch.probes._common import graph_ms
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    from vqvae_tpu_torch.utils.flops import train_step_flops
    cfg = get_config(PRESET)
    B, T = cfg.train.batch_size, cfg.data.length
    loader = BatchLoader(SineDataset(cfg.data), B, seed=0)
    batches = [tuple(torch.from_numpy(a).to(device) for a in next(loader))
               for _ in range(2)]
    loader.close()

    def stepper(kw):
        c = cfg.replace(model=dataclasses.replace(cfg.model, **kw))
        state = create_train_state(c, device)
        it = [0]

        def step():
            wav, spk = batches[it[0] % 2]
            it[0] += 1
            return train_step(state, wav, spk, c, impl="pallas")
        return step

    settings = (("recompute", dict(decoder_kernel="pallas")),
                ("windowed-4", dict(decoder_kernel="pallas",
                                    bwd_time_windows=4)),
                ("save-gates", dict(decoder_kernel="pallas_sg")),
                ("plain", dict(decoder_kernel="xla")),
                ("recompute, encoder kernel",
                 dict(decoder_kernel="pallas", encoder_kernel="pallas")))
    for name, kw in settings:
        t0 = time.monotonic()
        step = stepper(kw)
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ts = []
        for _ in range(3):
            t1 = time.perf_counter()
            m = step()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t1))
        ms = sorted(ts)[1]
        peak = torch.cuda.max_memory_allocated(device)
        check(np.isfinite(float(m["loss"])), f"{name}: non-finite loss")
        each = ", ".join(f"{t:.1f}" for t in ts)
        mfu = train_step_flops(get_config(PRESET), B) / (ms / 1e3) / PEAK_FLOPS
        say("train-time-vctk", t0, f"{PRESET} B={B} T={T} bf16, "
            f"decoder {name}: {ms:.1f} ms/step (median of {each}; "
            f"{B * T / ms * 1e3 / 16000:.2f} s of audio per s; "
            f"{100 * mfu:.2f}% of 989 TFLOP/s), peak memory "
            f"{peak / 2**30:.2f} GiB")
        del step
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    step = stepper(settings[0][1])
    step()
    wall, busy, rows = profile_step(step, 2)
    say("train-time-vctk", t0, f"recompute step: device busy {busy:.1f} of "
        f"{wall:.1f} ms over 2 steps ({100 * busy / wall:.1f}%)")
    for ms_, key, count in rows[:14]:
        print(f"    {100 * ms_ / busy:5.1f}%  {ms_ / 2:9.3f} ms/step  "
              f"x{count // 2:<4d} {key[:90]}", flush=True)
    # the input embedding's two taps run the take_rows kernel (2 a step);
    # the scatter launches left are the gathers JAX keeps plain (speaker,
    # codebook)
    taps = sum(c for _, k, c in rows if "take_rows_parts" in k)
    scat = [(k, c // 2, ms_ / 2) for ms_, k, c in rows
            if "indexing_backward" in k]
    say("train-time-vctk", t0, f"recompute step: take_rows_parts x{taps // 2}"
        f" a step; indexing_backward_kernel left (a step): " + ", ".join(
            f"{k[:60]} x{c} {m:.3f} ms" for k, c, m in scat))
    check(taps == 4, f"the embedding taps did not run the take_rows kernel "
          f"twice a step: {taps} launches in 2 steps")
    check(sum(c for _, c, _ in scat) <= 2, f"more scatter launches than the "
          f"speaker and codebook gathers: {scat}")
    del step
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    mc = cfg.model
    R, S, d, mu = mc.residual_channels, mc.skip_channels, mc.d, mc.mu
    nl = wt.MAX_CHUNK_LAYERS
    n_chunks = mc.n_layers_total // nl
    Tc, A, W = wt.window_geometry(T, 4, mc.dilations[:nl])
    per = {"chunk_bwd_rec": {}, "chunk_bwd_win": {}}
    for mode in (wt.SEED, wt.ACC):
        args, cots = chunk_inputs(mode, torch.bfloat16, device, B, T, mc)
        for name, nT, expand in (("chunk_bwd_rec", 0, 1.0),
                                 ("chunk_bwd_win", 4, W / Tc)):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            got = chunk_rec_kernel(args, cots, nT)
            torch.cuda.synchronize()
            scratch = torch.cuda.max_memory_allocated(device) - before
            r = compare(name, got, chunk_rec_plain(args, cots, nT), 3e-2,
                        errs)
            del got
            ms_ = cuda_ms(lambda: chunk_rec_kernel(args, cots, nT))
            pms = cuda_ms(lambda: chunk_rec_plain(args, cots, nT), reps=1)
            per[name][mode] = (ms_, pms, rec_work(mode, B, T, R, S, d, nl,
                                                  mu, expand))
            mname = "seed" if mode == wt.SEED else "acc"
            say("train-time-vctk", t0, f"{name} {mname} bfloat16 B={B} T={T}"
                + (f" ({nT} windows of {Tc}, halo {A})" if nT else "")
                + f": max rel err {r:.3g} <= 0.03; kernel {ms_:.2f} ms, "
                f"plain {pms:.2f} ms; one call allocates "
                f"{scratch / 2**20:.0f} MiB (scratch and gradients)")
        del args, cots
        torch.cuda.empty_cache()
    out = {}
    weights = {wt.SEED: 1, wt.ACC: n_chunks - 1}   # launches per step
    k = sum(weights.values())
    for name, by_mode in per.items():
        ms_ = sum(w * by_mode[m][0] for m, w in weights.items()) / k
        plain = sum(w * by_mode[m][1] for m, w in weights.items()) / k
        fl = sum(w * by_mode[m][2][0] for m, w in weights.items()) / k
        by = sum(w * by_mode[m][2][1] for m, w in weights.items()) / k
        bms, bby = bound(fl, by)
        out[name] = dict(ms=ms_, plain_ms=plain, bound_ms=bms, bound_by=bby)
        say("train-time-vctk", t0, f"{name} per launch (seed x1, acc x"
            f"{n_chunks - 1} averaged): kernel {ms_:.2f} ms, plain "
            f"{plain:.2f} ms, bound {bms:.3f} ms ({bby})")
    N = B * T // mc.hop
    for n in (N, 4 * N):
        (z, cb), left_out, bad = vq_check(n, device, errs, seed=1)
        ms_ = cuda_ms(lambda: vq_cuda.vq_argmin_kernel(z, cb), reps=50)
        gms = graph_ms(lambda: vq_cuda.vq_argmin_kernel(z, cb), device, 50)
        pms = cuda_ms(lambda: vq_cuda.vq_argmin_plain(z, cb), reps=50)
        bms, bby = bound(*vq_work(n, cb.shape[0], cb.shape[1]),
                         peak=PEAK_F32)
        if n == N:
            out["vq_argmin"] = dict(ms=ms_, plain_ms=pms, bound_ms=bms,
                                    bound_by=bby)
        say("train-time-vctk", t0, f"vq N={n} ({n // (T // mc.hop)} x "
            f"T/{mc.hop}) K=512 d=64: {left_out} rows within the margin "
            f"left out, {bad} ids differ; kernel {ms_ * 1e3:.2f} us a call, "
            f"{gms * 1e3:.3f} us by graph replay; plain (addmm + argmax) "
            f"{pms * 1e3:.1f} us; bound {bms * 1e3:.2f} us ({bby}, float32 "
            f"at 67 TFLOP/s: {100 * bms / gms:.1f}% of the card's time)")
    out["take_rows_bwd"] = take_rows_check(device, errs, B, T, mc.mu,
                                           mc.residual_channels)
    return out


def take_rows_check(device, errs, B, T, V, C):
    """The take_rows backward kernel (``kernels/embed_cuda.py``) against
    its plain version at vctk-multi's shape (ids int32 [B, T], g [B, T,
    C]): float32 within 1e-4 and bfloat16 within 3e-2 of max, uniform
    ids and every id the same; a second call the same bits.  Timed in
    bf16 (uniform ids) per call and by graph replay beside the plain
    version, its bound and one index_add_ (the library yardstick) and
    the scatter PyTorch's autograd ran for w[ids] (index_put_ with
    accumulate).  Returns the kernels-line fields."""
    import torch
    from vqvae_tpu_torch.kernels import embed_cuda as ebc
    from vqvae_tpu_torch.probes._common import graph_ms
    t0 = time.monotonic()
    gen = torch.Generator().manual_seed(3)
    res = None
    for cdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for skew in (False, True):
            ids = (torch.full((B, T), 37, dtype=torch.int32) if skew else
                   torch.randint(0, V, (B, T), generator=gen,
                                 dtype=torch.int32)).to(device)
            g = torch.randn(B, T, C, generator=gen).to(device, cdt)
            got = ebc.take_rows_bwd_kernel(ids, g, V, cdt)
            want = ebc.take_rows_bwd_plain(ids, g, V, cdt)
            compare("take_rows_bwd", [got], [want], tol, errs)
            check(torch.equal(ebc.take_rows_bwd_kernel(ids, g, V, cdt), got),
                  f"take_rows {cdt} skew={skew}: a second call gave other "
                  "bits")
            if skew:
                check(not torch.cat([got[:37], got[38:]]).any(),
                      "take_rows: rows no id names are not zero")
            elif cdt == torch.bfloat16:
                res = ids, g
    ids, g = res
    kern = lambda: ebc.take_rows_bwd_kernel(ids, g, V, torch.bfloat16)
    il, gf = ids.reshape(-1).long(), g.reshape(-1, C)
    lib = lambda: torch.zeros(V, C, device=device).index_add_(0, il,
                                                               gf.float())
    scatter = lambda: torch.zeros(V, C, device=device,
                                  dtype=torch.bfloat16).index_put_(
        (il,), gf, accumulate=True)
    ms_ = cuda_ms(kern, reps=20)
    gms = graph_ms(kern, device, 20)
    pms = cuda_ms(lambda: ebc.take_rows_bwd_plain(ids, g, V, torch.bfloat16),
                  reps=5)
    lms, lgms = cuda_ms(lib, reps=20), graph_ms(lib, device, 20)
    sms = cuda_ms(scatter, reps=5)
    bms, bby = bound(*take_rows_work(B * T, V, C, 2, 4), peak=PEAK_F32)
    say("train-time-vctk", t0, f"take_rows backward (ids int32 [{B}, {T}], "
        f"g bf16 [.., {C}], V={V}): f32 and bf16, uniform and one id, within "
        f"1e-4 / 3e-2, a second call the same bits; kernel {ms_ * 1e3:.2f} us "
        f"a call, {gms * 1e3:.3f} us by graph replay; bound {bms * 1e3:.2f} "
        f"us ({bby}: {100 * bms / gms:.1f}% of the card's time); plain "
        f"(one-hot matmul) {pms * 1e3:.1f} us; index_add_ {lms * 1e3:.2f} us "
        f"a call, {lgms * 1e3:.3f} by graph; autograd's scatter (index_put_ "
        f"accumulate) {sms * 1e3:.1f} us")
    return dict(ms=ms_, plain_ms=pms, bound_ms=bms, bound_by=bby,
                library_ms=lms)


def enc_inputs(cdt, device, B, M0, cfg, seed=0):
    """Seeded inputs of the fused encoder at the model's widths: h (a
    post-ReLU first-layer output), the taps, biases (non-zero) and
    projection of the other layers, and a cotangent dz."""
    import torch
    C, d, L = cfg.enc_channels, cfg.d, cfg.enc_layers - 1
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale
    h = torch.relu(rn(B, M0, C)).to(device, cdt)
    w = tuple(t.to(device) for t in (rn(L, 4, C, C, scale=(4 * C) ** -0.5),
                                      rn(L, C, scale=0.3),
                                      rn(C, d, scale=C ** -0.5),
                                      rn(d, scale=0.3)))
    return h, w, rn(B, M0 >> L, d, scale=0.01).to(device)


def enc_kernel_phase(device, errs):
    """The fused encoder's kernels against their plain versions (B=2
    and B=16 at T=7680, float32 and bfloat16), the streaming encoder
    under the switch, and each kernel's time at B=16 and at a 1 s
    encode.  Returns the per-kernel timing entries (B=16)."""
    import dataclasses
    import torch
    from vqvae_tpu_torch.audio.mu_law import mu_law_round_trip
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.infer.enc_streaming import StreamingEncoder
    from vqvae_tpu_torch.infer.fastgen import encode_to_codes
    from vqvae_tpu_torch.kernels import encoder_cuda as ec
    cfg_all = get_config(PRESET)
    mc = cfg_all.model
    T = cfg_all.data.length
    M0 = T // mc.enc_stride
    C, d, L = mc.enc_channels, mc.d, mc.enc_layers - 1
    for cdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for B in (2, 16):
            t0 = time.monotonic()
            h, w, dz = enc_inputs(cdt, device, B, M0, mc, seed=B)
            rf = compare("encoder_fwd", [ec.fwd_kernel(h, *w)],
                         [ec.fwd_plain(h, *w)], tol, errs)
            rb = compare("encoder_bwd", ec.bwd_kernel(h, *w, dz),
                         ec.bwd_plain(h, *w, dz), tol, errs)
            torch.cuda.synchronize()
            say("enc-kernel", t0, f"{str(cdt)[6:]} B={B} h [{B}, {M0}, {C}]"
                f" {L} layers d={d}: z max rel err {rf:.3g}, backward (dh0,"
                f" dW, db, dWp, dbp) {rb:.3g} <= {tol}")
            del h, w, dz
    torch.cuda.empty_cache()

    # the streaming encoder under the switch == one-shot encode
    t0 = time.monotonic()
    cfg = dataclasses.replace(mc, encoder_kernel="pallas")
    params = setup_model(cfg, device, seed=4)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():       # non-zero biases: the window edges matter
        for k, v in params.encoder.state_dict().items():
            if k.endswith(".b"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.3)
    rng = np.random.default_rng(5)
    wav = (0.3 * rng.standard_normal((2, cfg_all.data.sr + 77))).astype(
        np.float32).clip(-1, 1)
    Tw = wav.shape[1] // mc.hop * mc.hop
    ec.launches_fwd = 0
    with torch.no_grad():
        want = encode_to_codes(params, cfg, mu_law_round_trip(
            torch.from_numpy(wav[:, :Tw]), mc.mu, mc.mulaw_mode).to(
                device)).cpu().numpy()
    for width in (1000, 4096):
        enc = StreamingEncoder(params, cfg, device)
        pieces = [enc.push(wav[:, i:i + width])
                  for i in range(0, wav.shape[1], width)]
        pieces.append(enc.flush())
        check(np.array_equal(np.concatenate(pieces, 1), want),
              f"streaming encoder (switch on, {width}-sample pushes) != "
              "one-shot encode")
    check(ec.launches_fwd > 2, "the streaming encoder did not launch the "
          "encoder kernel")
    say("enc-kernel", t0, f"streaming encoder with encoder_kernel=pallas, "
        f"B=2, {wav.shape[1]} samples in 1000- and 4096-sample pushes == "
        f"one-shot encode ({want.shape[1]} frames), bit for bit; "
        f"{ec.launches_fwd} kernel launches")
    del params

    # times at the training shape (B=16) and at a 1 s encode (B=1)
    t0 = time.monotonic()
    out = {}
    for B, M in ((16, M0), (1, cfg_all.data.sr // mc.enc_stride)):
        h, w, dz = enc_inputs(torch.bfloat16, device, B, M, mc)
        z, zp = ec.fwd_kernel(h, *w), ec.fwd_plain(h, *w)
        say("enc-kernel", t0, f"bfloat16 B={B} h [{B}, {M}, {C}]: "
            f"{int((z != zp).sum())} of {z.numel()} z elements differ in "
            f"their bits from the plain version's")
        del z, zp
        for name, kern, plain, bwd in (
                ("encoder_fwd", lambda: ec.fwd_kernel(h, *w),
                 lambda: ec.fwd_plain(h, *w), False),
                ("encoder_bwd", lambda: ec.bwd_kernel(h, *w, dz),
                 lambda: ec.bwd_plain(h, *w, dz), True)):
            # 20 calls: at B=1 five would time the host's enqueue
            ms_, pms = cuda_ms(kern, reps=20), cuda_ms(plain, reps=1)
            bms, bby = bound(*enc_work(B, M, C, d, L, bwd))
            if B == 16:
                out[name] = dict(ms=ms_, plain_ms=pms, bound_ms=bms,
                                 bound_by=bby)
            say("enc-kernel", t0, f"{name} bfloat16 B={B} h [{B}, {M}, {C}]:"
                f" kernel {ms_:.4f} ms, plain {pms:.3f} ms, bound "
                f"{bms * 1e3:.2f} us ({bby}, bf16 rate); its float64 "
                f"products alone at the FP64 tensor-core rate "
                f"{enc_exact_ms(B, M, C, d, L, bwd):.4f} ms")
        split = ec.bwd_split_ms(h, *w, dz)
        say("enc-kernel", t0, f"encoder_bwd B={B} split (CUDA events): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
        say("enc-kernel", t0, f"B={B}: the {L} layers as float64 "
            f"torch.matmul on pre-built windows ({L} library calls, not "
            f"one): {enc_dgemm_ms(h, w[0], w[1], L):.4f} ms")
        del h, w, dz
    torch.cuda.empty_cache()
    return out


def run_cli(name, *args, timeout=600):
    """One ``python3 -m vqvae_tpu_torch.cli.<name>`` run as a user runs
    it: (its kernel launch counts, its stdout)."""
    cmd = [sys.executable, "-m", f"vqvae_tpu_torch.cli.{name}", *args]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
        fail(f"vqvae-torch-{name} exited with {r.returncode}: "
             f"{' '.join(cmd[3:])}")
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("kernel launches: ")]
    check(len(line) == 1, f"vqvae-torch-{name} printed no launch counts")
    return json.loads(line[0].split(": ", 1)[1]), r.stdout


def cli_codec_phase(device):
    """The codec CLIs on vctk-multi, as subprocesses; returns the launch
    counts summed over them."""
    import torch
    from scipy.io import wavfile
    from vqvae_tpu_torch.audio.mu_law import mu_law_round_trip
    from vqvae_tpu_torch.audio.wav_io import load_wav
    from vqvae_tpu_torch.cli.common import load_params
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.infer.fastgen import encode_to_codes
    from vqvae_tpu_torch.models.encoder import apply_encoder
    cfg = get_config(PRESET)
    sr, hop = cfg.data.sr, cfg.model.hop
    t0 = time.monotonic()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_",
                            dir=os.path.join(ROOT, "build"))
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return counts

    def p(*names):
        return os.path.join(work, *names)
    try:
        tree = p("VCTK")
        write_vctk_tree(tree)
        counts, recs = train_vctk(tree, p("run"), 2, "--set",
                                  "model.encoder_kernel=pallas")
        add(counts)
        check(counts["encoder_fwd"] > 0 and counts["encoder_bwd"] > 0,
              f"training with the switch did not run the encoder kernels: "
              f"{counts}")
        say("cli-codec", t0, f"vqvae-torch-train --preset {PRESET} --dataset"
            f" vctk --set model.encoder_kernel=pallas, 2 steps: exit 0; step "
            f"1 loss1 {recs[0]['loss1']:.4f}; launches {counts}")

        t0 = time.monotonic()
        npz = p("exported.npz")
        n = 3 * sr
        t = np.arange(n) / sr
        x = 0.4 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(
            2 * np.pi * 1.3 * t)) + 0.05 * np.random.default_rng(
                6).standard_normal(n)
        wav_in, one_s = p("in.wav"), p("one_s.wav")
        wavfile.write(wav_in, sr, (np.clip(x, -1, 1) * 32767).astype(
            np.int16))
        wavfile.write(one_s, sr, (np.clip(x[:sr], -1, 1) * 32767).astype(
            np.int16))
        base = ["--preset", PRESET, "-m", npz]
        # the CLIs run as independent processes, side by side on the card
        # wherever one does not need another's output
        pool = ThreadPoolExecutor(max_workers=8)
        try:
            score = pool.submit(run_cli, "score", "-m", p("run"),
                                "--dataset", "vctk", "--root", tree,
                                "--json")
            add(run_cli("export", "-m", p("run"), "-o", npz)[0])
            with np.load(npz) as a, np.load(p("run", "weights.npz")) as b:
                check(set(a.files) == set(b.files) and all(
                    np.array_equal(a[k], b[k]) for k in a.files),
                    "the exported .npz differs from the run's weights.npz")
            gen = pool.submit(run_cli, "generate", *base, "-i", one_s, "-o",
                              p("gen.wav"), "-s", "3", "--no-trim", "--set",
                              "model.encoder_kernel=pallas")
            enc = {kernel: pool.submit(
                run_cli, "encode", *base, "-i", wav_in, "-o",
                p(f"codes_{kernel}.npy"), "--no-trim", "--set",
                f"model.encoder_kernel={kernel}")
                for kernel in ("xla", "pallas")}
            codes = {}
            for kernel, f in enc.items():
                add(f.result()[0])
                codes[kernel] = np.load(p(f"codes_{kernel}.npy"))
            cpath = p("codes_pallas.npy")
            runs = {}
            for mode, extra in (("greedy", ["--greedy"]),
                                ("sampled", ["--temperature", str(TEMP)])):
                common = [*base, "-s", "3", "--seed", "7", *extra]
                runs[("decode", mode)] = pool.submit(
                    run_cli, "decode", *common, "-i", cpath, "-o",
                    p(f"dec_{mode}.wav"))
                runs[("stream", mode)] = pool.submit(
                    run_cli, "stream", *common, "-i", cpath, "-o",
                    p(f"str_{mode}.wav"), "--chunk-frames", "16")
            runs[("lowmem", "sampled")] = pool.submit(
                run_cli, "decode", *base, "-s", "3", "--seed", "7",
                "--temperature", str(TEMP), "-i", cpath, "-o", p("low.wav"),
                "--gen-impl", "lowmem")
            # frames whose two best scores differ by more than 1e-4 of the
            # largest must get the same code from both encoders
            params = load_params(npz, cfg, device)
            w = load_wav(wav_in, sr)
            xw = mu_law_round_trip(torch.from_numpy(w[:n // hop * hop])[None],
                                   cfg.model.mu, cfg.model.mulaw_mode)
            with torch.no_grad():
                z = apply_encoder(params.encoder, cfg.model,
                                  xw.to(device)).double()[0]
                check(np.array_equal(encode_to_codes(
                    params, cfg.model, xw.to(device))[0].cpu().numpy(),
                    codes["xla"]),
                    "the encode CLI's codes differ from encode_to_codes")
            cb = params.vq.codebook.double()
            sc = 2 * z @ cb.T - (cb * cb).sum(-1)
            top = sc.topk(2, -1).values
            clear = ((top[:, 0] - top[:, 1]) > 1e-4 * float(sc.abs().max())
                     ).cpu().numpy()
            same = codes["xla"] == codes["pallas"]
            check(bool(same[clear].all()), f"encode with the switch differs "
                  f"from without on {int((~same & clear).sum())} clear "
                  "frames")
            say("cli-codec", t0, f"export == the run's weights.npz; encode of"
                f" a 3 s wav: {len(codes['xla'])} frames, the switch's codes "
                f"equal on all {int(clear.sum())} frames clear of the margin "
                f"({int((~same).sum())} differ in all)")
            del params

            t0 = time.monotonic()
            outs = {key: f.result() for key, f in runs.items()}
            for key, (c, _) in outs.items():
                add(c)
            for mode in ("greedy", "sampled"):
                a = wavfile.read(p(f"dec_{mode}.wav"))[1]
                b = wavfile.read(p(f"str_{mode}.wav"))[1]
                check(a.shape == (len(codes["pallas"]) * hop,) and
                      np.array_equal(a, b), f"{mode}: stream != decode")
            pushes = [float(ln.split(" in ")[1].split(" ms")[0])
                      for ln in outs[("stream", "sampled")][1].splitlines()
                      if ln.startswith("chunk ")]
            check(np.array_equal(wavfile.read(p("low.wav"))[1],
                                 wavfile.read(p("dec_sampled.wav"))[1]),
                  "--gen-impl lowmem != one-shot decode")
            say("cli-codec", t0, f"decode == stream ({len(pushes)} pushes "
                f"of 16 frames, median "
                f"{sorted(pushes)[len(pushes) // 2]:.1f} ms a push beside 4 "
                "other decode CLIs and the quality check), greedy and "
                "sampled; lowmem == one-shot (sampled); bit for bit")

            t0 = time.monotonic()
            add(gen.result()[0])
            g = wavfile.read(p("gen.wav"))[1]
            check(g.shape == (sr // hop * hop,), f"generate: length {g.shape}")
            c, out = score.result()
            add(c)
        finally:
            pool.shutdown(wait=True)
        rec = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        check(np.isfinite(rec["val_loss1"]), f"score: {rec}")
        check(all(total[k] > 0 for k in ("encoder_fwd", "encoder_bwd",
                                         "decode")),
              f"a kernel of the codec path was not launched: {total}")
        say("cli-codec", t0, f"generate (1 s, the switch on) exit 0; score "
            f"{rec['split']} split of the synthetic tree: {rec['windows']} "
            f"windows, val_loss1 {rec['val_loss1']}; launches over the CLI "
            f"runs {total}")
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_probe(name, *args, timeout=600):
    """``python3 -m vqvae_tpu_torch.probes.<name>`` as a user runs it:
    (its JSON record, its stdout)."""
    cmd = [sys.executable, "-m", f"vqvae_tpu_torch.probes.{name}", *args]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    recs = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith('{"probe"')]
    if r.returncode != 0 or len(recs) != 1:
        print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
        fail(f"probe {name} exited with {r.returncode}")
    rec = recs[0]
    for key, row in rec["checks"].items():
        check(row.get("exact", True) and
              row.get("max_rel_err", 0.0) <= row.get("tol", 0.0),
              f"probe {name}: {key} outside its tolerance: {row}")
    check(not rec["failed"], f"probe {name}: {rec['failed']}")
    return rec, r.stdout


def probes_phase(decode_us):
    """The four probe modules as subprocesses: their kernels' checks,
    times, launches; and the kernels-line fields of the seven kernels,
    with bounds from the shapes the probes report.  decode_us: the decode
    kernel's µs per step from the request phase, for the chain's
    comparison."""
    out = {}
    t0 = time.monotonic()
    rec, _ = run_probe("cond_inkernel", "--batch", "16", "64")
    runs = {(r["batch"], r["dtype"]): r for r in rec["runs"]}
    for (B, dt), r in sorted(runs.items()):
        es = 2 if dt == "bfloat16" else 4
        peak = PEAK_FLOPS if dt == "bfloat16" else PEAK_F32
        bf = bound(*upsample_work(B, r["Tl"], r["hop"], r["d"], es, False),
                   peak)
        bb = bound(*upsample_work(B, r["Tl"], r["hop"], r["d"], es, True),
                   peak)
        sp = r["bwd_split_ms"]
        say("probes", t0, f"cond {dt} B={B}: forward {r['fwd_ms']:.4f} ms "
            f"a call, {r['fwd_graph_ms']:.4f} on the card (bound "
            f"{bf[0]:.4f}, {bf[1]}: {100 * bf[0] / r['fwd_ms']:.1f}% of a "
            f"call, {100 * bf[0] / r['fwd_graph_ms']:.1f}% of the card's "
            f"time; plain {r['plain_fwd_ms']:.4f}; conv_transpose1d "
            f"{r['library_fwd_ms']:.4f}); backward {r['bwd_ms']:.4f} ms a "
            f"call, {r['bwd_graph_ms']:.4f} on the card (bound "
            f"{bb[0]:.4f}, {bb[1]}: {100 * bb[0] / r['bwd_ms']:.1f}%, "
            f"{100 * bb[0] / r['bwd_graph_ms']:.1f}%; its two launches by "
            f"CUDA events: tiles {sp['tiles']:.4f}, reduce "
            f"{sp['reduce']:.4f}; plain {r['plain_bwd_ms']:.4f}; autograd "
            f"{r['library_bwd_ms']:.4f}); reading cond: "
            f"{r['read_bound_ms']:.4f} ms at 3.35 TB/s, copy_ "
            f"{r['copy_ms']:.4f} ms")
        if (B, dt) == (16, "bfloat16"):
            main_run, bounds = r, (bf, bb)
    errs = {k: max((row["max_abs_err"] for key, row in rec["checks"].items()
                    if key.startswith(pre)), default=0.0)
            for k, pre in (("cond_fwd", "fwd"), ("cond_bwd", "bwd"))}
    for name, key, lib in (("cond_fwd", "fwd", "library_fwd_ms"),
                           ("cond_bwd", "bwd", "library_bwd_ms")):
        bms, bby = bounds[0] if key == "fwd" else bounds[1]
        out[name] = dict(
            launches=sum(r["launches"][name] for r in runs.values()),
            max_abs_err=errs[name], ms=main_run[f"{key}_ms"],
            plain_ms=main_run[f"plain_{key}_ms"], bound_ms=bms,
            bound_by=bby, library_ms=main_run[lib])

    t0 = time.monotonic()
    rec, _ = run_probe("dot")
    t, sh = rec["times"], rec["shape"]
    contr = ("nd,rde->nre", "nrd,rde->ne", "nd,nre->dre")
    bms, bby = bound(*dot_work(sh["N"], sh["hop"], sh["d"]), PEAK_F32)
    out["probe_dot"] = dict(
        launches=rec["launches"]["probe_dot"],
        max_abs_err=max(r["max_abs_err"] for r in rec["checks"].values()),
        ms=sum(t[k]["ms"] for k in contr),
        plain_ms=sum(t[k]["plain_ms"] for k in contr), bound_ms=bms,
        bound_by=bby, library_ms=sum(t[k]["library_ms"] for k in contr))
    say("probes", t0, "dot (us a call / by graph replay): " + "; ".join(
        f"{k} {1e3 * v['ms']:.2f} / {1e3 * v['graph_ms']:.3f} (plain "
        f"{1e3 * v['plain_ms']:.2f}"
        + (f", library {1e3 * v['library_ms']:.2f} / "
           f"{1e3 * v['library_graph_ms']:.3f})" if v["library_ms"]
           else ")") for k, v in t.items())
        + f"; the contractions' bound {1e3 * bms / 3:.3f} each ({bby})")

    t0 = time.monotonic()
    rec, _ = run_probe("reshape")
    t, sh = rec["times"], rec["shape"]
    cases = [k for k in t if k != "composition"]
    nbytes = 2 * 4 * sh["N"] * sh["hop"] * sh["d"]
    bms, bby = bound(0, len(cases) * nbytes)
    out["probe_reshape"] = dict(
        launches=rec["launches"]["probe_reshape"],
        max_abs_err=max(rec["checks"][k]["max_abs_err"] for k in cases),
        ms=sum(t[k]["ms"] for k in cases),
        plain_ms=sum(t[k]["plain_ms"] for k in cases), bound_ms=bms,
        bound_by=bby, library_ms=sum(t[k]["library_ms"] for k in cases))
    bms, bby = bound(*compose_work(sh["N"], sh["hop"], sh["d"], sh["E"]),
                     PEAK_F32)
    comp = t["composition"]
    out["probe_compose"] = dict(
        launches=rec["launches"]["probe_compose"],
        max_abs_err=rec["checks"]["composition"]["max_abs_err"],
        ms=comp["ms"], plain_ms=comp["plain_ms"],
        bound_ms=bms, bound_by=bby, library_ms=comp["library_ms"])
    g_ms = sum(t[k]["graph_ms"] for k in cases)
    g_lib = sum(t[k]["library_graph_ms"] for k in cases)
    say("probes", t0, f"reshape: 5 layouts exact; flat copy "
        f"{1e3 * out['probe_reshape']['ms']:.2f} us a call in all (clone "
        f"{1e3 * out['probe_reshape']['library_ms']:.2f}), by graph replay "
        f"{1e3 * g_ms:.3f} us in all (clone {1e3 * g_lib:.3f}), "
        f"{1e3 * g_ms / len(cases):.3f} us a layout; launches "
        f"{out['probe_reshape']['launches']} (the graph capture counts "
        f"once per captured call, its replays not at all); composition "
        f"{1e3 * comp['ms']:.2f} us a call, {1e3 * comp['graph_ms']:.3f} us "
        f"by graph replay (bound {1e3 * bms:.3f} us, {bby}: "
        f"{100 * bms / comp['graph_ms']:.1f}% of the card's time; plain "
        f"{1e3 * comp['plain_ms']:.2f} us; einsum "
        f"{1e3 * comp['library_ms']:.2f} us a call, "
        f"{1e3 * comp['library_graph_ms']:.3f} us by graph replay)")

    t0 = time.monotonic()
    rec, _ = run_probe("decode_int8_micro", "--decode-us", repr(decode_us))
    sh = rec["shape"]
    for name, int8, peak in (("chain_bf16", False, PEAK_FLOPS),
                             ("chain_int8", True, 2 * PEAK_FLOPS)):
        key = "int8" if int8 else "bf16"
        bms, bby = bound(*chain_work(sh["L"], sh["STEPS"], sh["B"],
                                     sh["width"], int8), peak)
        out[name] = dict(
            launches=rec["launches"][name],
            max_abs_err=max(r["max_abs_err"] for k, r in
                            rec["checks"].items() if k.startswith(key)),
            ms=rec[f"{key}_ms"], plain_ms=rec[f"plain_{key}_ms"],
            bound_ms=bms, bound_by=bby, library_ms=None)
    say("probes", t0, f"decode chain L={sh['L']} STEPS={sh['STEPS']}: bf16 "
        f"{rec['bf16_ms']:.4f} ms, {rec['bf16_us_per_chainstep']:.3f} "
        f"us/step, {rec['per_matmul_ns_bf16']:.1f} ns a layer; int8 "
        f"{rec['int8_ms']:.4f} ms, {rec['int8_us_per_chainstep']:.3f} "
        f"us/step, {rec['per_matmul_ns_int8']:.1f} ns a layer; int8/bf16 "
        f"{rec['int8_over_bf16']:.3f}; the decode kernel "
        f"{rec['decode_kernel_ns_per_layer']:.1f} ns a layer (request "
        f"phase); bounds "
        f"{out['chain_bf16']['bound_ms']:.4f} / "
        f"{out['chain_int8']['bound_ms']:.4f} ms (operations; the "
        f"dependency makes the chain latency-bound)")
    for name, v in out.items():
        check(v["launches"] > 0, f"{name}: not launched in its probe run")
    return out


MESH_TOL = 1e-4          # losses: JAX's sharding tolerance
MESH_RTOL, MESH_ATOL = 2e-5, 2e-6   # codebook: JAX's sharding tolerance
# step-1 gradients, of each tensor's max: the repo's bf16 gate (the
# weights used in bf16 get bf16 gradients, one ulp 2^-8 of their max)
MESH_GRAD_TOL = 3e-2
MESH_JOIN_S = 240        # each world's own time limit


def mesh_batches(cfg, n):
    """``n`` batches of the seeded sine stream, whole, on the host."""
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.audio.loader import make_batch
    ds = SineDataset(cfg.data)
    return [make_batch(ds, cfg.train.batch_size, 0, i) for i in range(n)]


def mesh_steps(cfg, mesh, batches, device, save=None, resume=None):
    """Train steps over ``batches`` on ``mesh`` (None: one process): each
    step's metrics, codebook and whole EMA count (on the host), the last
    step's ms and staged bytes, the kernels' launches in these steps.
    ``resume``: start from the newest checkpoint there; ``save``: write
    a checkpoint there after the first step and go on (both collective
    on a mesh, through ``train/checkpoint.py``)."""
    import torch
    from vqvae_tpu_torch.cli.common import launch_counts
    from vqvae_tpu_torch.parallel import collectives
    from vqvae_tpu_torch.parallel.distributed import put_global_batch
    from vqvae_tpu_torch.parallel.mesh import batch_sharding
    from vqvae_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    state = create_train_state(cfg, device, mesh=mesh)
    if resume is not None:
        restore_checkpoint(resume, state)
    rows = batch_sharding(mesh).rows(cfg.train.batch_size)
    before = launch_counts()
    out = {"losses": [], "metrics": [], "codebook": [], "count": []}
    for wav, spk in batches:
        torch.cuda.synchronize()
        s0, t1 = collectives.staged_bytes, time.perf_counter()
        m = train_step(state, *put_global_batch(mesh, wav[rows], spk[rows],
                                                device=device), cfg)
        out["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        out["ms"] = 1e3 * (time.perf_counter() - t1)
        out["staged"] = collectives.staged_bytes - s0
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["codebook"].append(
            state.params["vq"]["codebook"].detach().cpu().clone())
        vq = state.vq_state if state.par is None else \
            state.par.full_vq(state.vq_state)
        out["count"].append(vq.count.cpu().clone())
        if "grads" not in out:   # the first step's, as Adam took them
            g = ({n.replace(".", "/"): p.grad for n, p in
                  state.params.named_parameters() if p.grad is not None}
                 if state.par is None else state.par.full_grads())
            out["grads"] = {k: v.cpu().clone() for k, v in g.items()}
            out["weights"] = torch.cat([p.detach().reshape(-1).float().cpu()
                                        for p in state.params.parameters()])
            if save is not None:
                save_checkpoint(save, state)
    after = launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out


def mesh_worker(job, out):
    """One rank of the mesh phase (``torchrun --nproc-per-node N
    chip_smoke.py --mesh-worker JOB OUT``, started by ``mesh_phase``).
    ``nccl1``: a world of one over NCCL, two stretch steps without a
    mesh (a checkpoint after the first) and through the mesh code, two
    without a mesh and with restarts off, and the plain-stack vctk-multi
    step the SP check holds to; ``gloo2``: two ranks sharing the card
    over gloo: DP 2 (from scratch, from the one-process checkpoint, and
    with restarts off), data=1 x model=2 (from scratch with a checkpoint
    after the first step, and from the one-process checkpoint), then
    seq=2."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.parallel.distributed import (
        initialize_from_env, rank_device, shutdown)
    from vqvae_tpu_torch.parallel.mesh import make_mesh
    initialize_from_env("cuda")   # NCCL for one rank, gloo for two
    device = rank_device("cuda")
    cfg = get_config(TRAIN_PRESET)
    no_restart = cfg.replace(model=dataclasses.replace(
        cfg.model, code_restart_threshold=0))
    batches = mesh_batches(cfg, 2)
    sp_cfg = get_config(PRESET)
    sp_cfg = sp_cfg.replace(
        model=dataclasses.replace(sp_cfg.model, decoder_kernel="xla",
                                  head_kernel="xla"),
        train=dataclasses.replace(sp_cfg.train, batch_size=2))
    sp_batches = mesh_batches(sp_cfg, 1)
    ck_one = os.path.join(out, "ck-one")
    res = {}
    if job == "nccl1":
        res["one"] = mesh_steps(cfg, None, batches, device, save=ck_one)
        res["mesh1"] = mesh_steps(cfg, make_mesh(device_type="cuda"),
                                  batches, device)
        res["one_norestart"] = mesh_steps(no_restart, None, batches, device)
        res["sp_one"] = mesh_steps(sp_cfg, None, sp_batches, device)
    else:
        dp = make_mesh(device_type="cuda")
        res["dp"] = mesh_steps(cfg, dp, batches, device)
        res["dp_from1"] = mesh_steps(cfg, dp, batches[1:], device,
                                     resume=ck_one)
        res["dp_norestart"] = mesh_steps(no_restart, dp, batches, device)
        tp = make_mesh(data=1, model=2, device_type="cuda")
        res["tp"] = mesh_steps(cfg, tp, batches, device,
                               save=os.path.join(out, "ck-tp"))
        res["tp_from1"] = mesh_steps(cfg, tp, batches[1:], device,
                                     resume=ck_one)
        res["sp"] = mesh_steps(sp_cfg, make_mesh(data=1, seq=2,
                                                 device_type="cuda"),
                               sp_batches, device)
    res["device"] = str(device)
    dist.barrier()
    torch.save(res, os.path.join(out, f"{job}-rank{dist.get_rank()}.pt"))
    shutdown()


def mesh_log(logs, r, stream):
    """Rank ``r``'s ``stream`` ('stdout', 'stderr') as torchrun's
    ``--redirects`` wrote it under ``logs``."""
    import glob
    found = glob.glob(os.path.join(logs, "*", "attempt_0", str(r),
                                   f"{stream}.log"))
    if not found:
        return f"(no {stream}.log for rank {r})"
    with open(found[0]) as f:
        return f.read()


def mesh_world(job, n, out):
    """Run ``n`` ranks of ``mesh_worker`` ``job`` under torchrun
    (``--standalone`` picks a free local port); each rank's result and
    rank 0's standard error."""
    import signal
    import torch
    logs = os.path.join(out, f"logs-{job}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "RANK", "LOCAL_RANK",
                                "WORLD_SIZE", "LOCAL_WORLD_SIZE"))}
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "--log-dir", logs, "--redirects", "3",
         os.path.abspath(__file__), "--mesh-worker", job, out],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        agent = p.communicate(timeout=MESH_JOIN_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        fail(f"mesh {job}: the world hung past {MESH_JOIN_S} s\n"
             + "\n".join(mesh_log(logs, r, "stderr")[-3000:]
                         for r in range(n)))
    check(p.returncode == 0, f"mesh {job}: torchrun exited {p.returncode}:"
          f"\n{agent[-3000:]}\n" + "\n".join(
              f"--- rank {r}\n{mesh_log(logs, r, 'stderr')[-6000:]}"
              for r in range(n)))
    return ([torch.load(os.path.join(out, f"{job}-rank{r}.pt"))
             for r in range(n)], mesh_log(logs, 0, "stderr"))


def mesh_phase(device, smi):
    """The parallel layer on the card: the decode split by rows (row0),
    a world of one over NCCL through the mesh code, two gloo ranks on the
    one card (DP 2, model 2, seq 2) held to one process."""
    import torch
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.infer.fastgen import decode_from_codes
    from vqvae_tpu_torch.infer.parallel import decode_from_codes_sharded
    from vqvae_tpu_torch.kernels import decode_cuda as dc
    t0 = time.monotonic()
    cfg = get_config(PRESET).model
    params = setup_model(cfg, device, seed=3)
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(0, cfg.K, (4, 40), generator=g).to(device)
    spk = torch.tensor([0, 7, 50, 108], device=device) % cfg.n_speakers
    n0 = dc.launches
    for impl in ("lax", "lowmem"):
        full = decode_from_codes(params, cfg, codes, spk, 21, TEMP,
                                 impl=impl)
        part = decode_from_codes(params, cfg, codes[2:], spk[2:], 21, TEMP,
                                 impl=impl, row0=2)
        check(torch.equal(part, full[2:]), f"mesh: sampled {impl} decode of "
              "rows 2:4 with row0=2 differs from rows 2:4 of the B=4 call")
        shard = decode_from_codes_sharded(params, cfg, codes, spk, 21,
                                          [device, device], TEMP, impl=impl)
        check(torch.equal(shard, full), f"mesh: the sharded {impl} decode "
              "over [cuda:0, cuda:0] differs from the one-call decode")
    say("mesh", t0, f"sampled decode B=4 x {codes.shape[1] * cfg.hop} "
        f"samples, lax and lowmem: rows 2:4 with row0=2 and the decode "
        f"sharded over [cuda:0, cuda:0] equal the one call bit for bit "
        f"({dc.launches - n0} decode launches)")
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="mesh-", dir=os.path.join(ROOT, "build"))
    try:
        one = mesh_world("nccl1", 1, out)[0][0]
        two, warned = mesh_world("gloo2", 2, out)
        # the checkpoint model 2 wrote after its first step, in the
        # one-device layout, beside the one process's
        cks = [torch.load(os.path.join(out, d, "step_1.pt"),
                          weights_only=True) for d in ("ck-one", "ck-tp")]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check("backend is gloo" in warned, "mesh: two ranks sharing the card "
          "ran over gloo without the warning of initialize_from_env")
    ref, m1 = one["one"], one["mesh1"]
    check(m1["losses"] == ref["losses"]
          and all(torch.equal(a, b) for a, b in zip(m1["codebook"],
                                                    ref["codebook"])),
          f"mesh: the NCCL world of one ({m1['losses']}) is not the "
          f"one-process step ({ref['losses']}) bit for bit")
    B = get_config(TRAIN_PRESET).train.batch_size
    thr = get_config(TRAIN_PRESET).model.code_restart_threshold
    say("mesh", t0, f"NCCL world of 1, {TRAIN_PRESET} B={B}, 2 steps "
        f"through the mesh code: losses {m1['losses']} and the codebook "
        f"equal the one-process step's bit for bit; one-process step "
        f"{ref['ms']:.1f} ms, through the mesh {m1['ms']:.1f} ms")

    def tensors(tree, path=""):
        if torch.is_tensor(tree):
            yield path, tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from tensors(v, f"{path}/{k}")
    ck_one, ck_tp = (dict(tensors({k: c[k] for k in ("params", "opt",
                                                     "vq_state")}))
                     for c in cks)
    check(ck_one.keys() == ck_tp.keys() and all(
        ck_one[k].shape == ck_tp[k].shape for k in ck_one),
        "mesh tp: its checkpoint is not in the one-device layout: "
        f"{sorted(set(ck_one) ^ set(ck_tp))[:6]}")
    worst_ck = max(float((ck_tp[k].float() - v.float()).abs().max())
                   for k, v in ck_one.items() if v.numel())

    def cb_diff(cb, want):
        """(max |d|, rows outside the codebook tolerance)."""
        far = ~torch.isclose(cb, want, rtol=MESH_RTOL,
                             atol=MESH_ATOL).all(-1)
        return float((cb - want).abs().max()), int(far.sum())

    kern = ("chunk_fwd", "chunk_bwd", "head_ce_fwd", "head_ce_bwd")
    for name in ("dp", "tp"):
        worst_l = max(abs(a - b) for r in two for a, b in zip(
            r[name]["losses"], ref["losses"]))
        check(worst_l <= MESH_TOL, f"mesh {name}: losses off the "
              f"one-process steps by {worst_l} > {MESH_TOL}")
        # the one-process step: the codebook after the first step, where
        # both runs start from the same weights
        cb, want = two[0][name]["codebook"][0], ref["codebook"][0]
        worst_c = float((cb - want).abs().max())
        check(torch.allclose(cb, want, rtol=MESH_RTOL, atol=MESH_ATOL),
              f"mesh {name}: codebook off by {worst_c} after one step "
              f"(rtol {MESH_RTOL}, atol {MESH_ATOL})")
        # the second step from the one process's own step-1 checkpoint
        # (weights, Adam's moments, the EMA state): the same start again
        fr = two[0][name + "_from1"]
        l2 = max(abs(r[name + "_from1"]["losses"][0] - ref["losses"][1])
                 for r in two)
        check(l2 <= MESH_TOL, f"mesh {name}: step 2 from the one-process "
              f"checkpoint has a loss off by {l2} > {MESH_TOL}")
        c2, rows2 = cb_diff(fr["codebook"][0], ref["codebook"][1])
        check(rows2 == 0, f"mesh {name}: step 2 from the one-process "
              f"checkpoint leaves the codebook off by {c2} on {rows2} rows "
              f"(rtol {MESH_RTOL}, atol {MESH_ATOL})")
        # the first step's gradients, each against its tensor's max: a
        # mean of the wrong scale or a lost shard is off by >= 1/2
        grads, want_g = two[0][name]["grads"], ref["grads"]
        check(grads.keys() == want_g.keys(), f"mesh {name}: gradients of "
              f"{sorted(set(grads) ^ set(want_g))} on one side only")
        worst_g, worst_k = max(
            (float((grads[k] - v).abs().max())
             / max(float(v.abs().max()), 1e-30), k)
            for k, v in want_g.items())
        check(worst_g <= MESH_GRAD_TOL, f"mesh {name}: the step-1 gradient "
              f"of {worst_k} off by {worst_g} of its max > {MESH_GRAD_TOL}")
        for i in range(len(ref["codebook"])):
            check(torch.equal(two[0][name]["codebook"][i],
                              two[1][name]["codebook"][i]),
                  f"mesh {name}: the two ranks hold different codebooks")
        for r, res in enumerate(two):
            for k in kern:
                check(res[name]["launches"][k] > 0,
                      f"mesh {name}: rank {r} launched no {k}")
        # the second step of the runs from scratch starts from weights
        # that already differ by float32 summation order: how far its
        # codebook moved, with the dead-code restart on and off
        dw = (two[0][name]["weights"] - ref["weights"]).abs()
        s2, far2 = cb_diff(two[0][name]["codebook"][1], ref["codebook"][1])
        restarted = ((two[0][name]["count"][1] == thr)
                     != (ref["count"][1] == thr))
        if name == "tp":
            # model 2 runs the whole batch on each rank: its second step
            # is the one process's too, past the checkpoint it wrote
            check(far2 == 0, f"mesh tp: codebook off by {s2} on {far2} "
                  "rows after step 2 (a checkpoint written after step 1)")
            extra = (f"its step-1 checkpoint (one-device layout) within "
                     f"{worst_ck:.3g} of the one process's")
        else:
            n2, nfar = cb_diff(two[0]["dp_norestart"]["codebook"][1],
                               one["one_norestart"]["codebook"][1])
            extra = (f"restarts off, from scratch: step 2 codebook "
                     f"{n2:.3g} on {nfar} rows past the tolerance, losses "
                     f"{two[0]['dp_norestart']['losses']} vs "
                     f"{one['one_norestart']['losses']}")
        say("mesh", t0, f"gloo {'DP 2' if name == 'dp' else 'data 1 x model 2'}"
            f" on one card ({two[0]['device']}, {two[1]['device']}), "
            f"{TRAIN_PRESET} B={B} ({B // 2 if name == 'dp' else B} a rank),"
            f" 2 steps: worst loss diff {worst_l:.3g} <= {MESH_TOL}, "
            f"step-1 gradients within {worst_g:.3g} of each tensor's max "
            f"({worst_k}), "
            f"codebook max|d| {worst_c:.3g} after step 1 (all weights "
            f"{float(dw.max()):.3g}, {int((dw > 1e-6).sum())} of "
            f"{dw.numel()} past 1e-6); step 2 from the one process's "
            f"checkpoint: loss {l2:.3g}, codebook {c2:.3g} (0 rows past the "
            f"tolerance); from scratch after step 2 {s2:.3g} on {far2} "
            f"rows past the tolerance, {int(restarted.sum())} rows "
            f"restarted in one run only, perplexity "
            f"{two[0][name]['metrics'][1]['code_perplexity']:.4f} vs "
            f"{ref['metrics'][1]['code_perplexity']:.4f}; {extra}; step "
            f"{two[0][name]['ms']:.1f} ms (one process {ref['ms']:.1f}); "
            f"staged {two[0][name]['staged']} bytes a step a rank; launches "
            "rank 0 "
            + json.dumps({k: two[0][name]['launches'][k] for k in kern})
            + ", rank 1 "
            + json.dumps({k: two[1][name]['launches'][k] for k in kern}))
    sp_ref = one["sp_one"]["losses"][0]
    worst_sp = max(abs(r["sp"]["losses"][0] - sp_ref) for r in two)
    check(worst_sp <= MESH_TOL, f"mesh sp: loss off one rank's by "
          f"{worst_sp} > {MESH_TOL}")
    say("mesh", t0, f"gloo seq 2, {PRESET} T={get_config(PRESET).data.length}"
        " B=2 (plain stack), one "
        f"step: loss {two[0]['sp']['losses'][0]:.6f} vs one rank "
        f"{sp_ref:.6f}, diff {worst_sp:.3g} <= {MESH_TOL}; step "
        f"{two[0]['sp']['ms']:.1f} ms (one rank "
        f"{one['sp_one']['ms']:.1f}); staged {two[0]['sp']['staged']} "
        f"bytes a step a rank; {smi}")


def quality_start(device, smi):
    """Phase "quality", first half: 20 tiny steps timed in this process
    (nothing else running), then ``python3 -m vqvae_tpu_torch.quality.
    quality_check --steps QUALITY_STEPS ...`` started as a user runs it,
    its run directory under a work directory of build/ (its TMPDIR).
    Returns (process, work directory, start time)."""
    import torch
    from vqvae_tpu_torch.audio.datasets import SineDataset
    from vqvae_tpu_torch.audio.loader import BatchLoader
    from vqvae_tpu_torch.quality import quality_check as qc
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    t0 = time.monotonic()
    say("quality", t0, smi)
    B = QUALITY_BATCH
    cfg = qc.tiny_config(QUALITY_STEPS, B)
    loader = BatchLoader(SineDataset(cfg.data), B, seed=0)
    batches = [tuple(torch.from_numpy(a).to(device) for a in next(loader))
               for _ in range(22)]
    loader.close()
    state = create_train_state(cfg, device)
    for wav, spk in batches[:2]:
        train_step(state, wav, spk, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for wav, spk in batches[2:]:
        m = train_step(state, wav, spk, cfg)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1) / 20
    check(np.isfinite(float(m["loss"])), "tiny: non-finite loss")
    say("quality", t0, f"tiny B={B} T={cfg.data.length} "
        f"{cfg.model.compute_dtype} (plain stack, EMA codebook, restarts): "
        f"{step_ms:.2f} ms a step over 20 steps after 2 ({1e3 / step_ms:.1f}"
        f" steps a second), alone on the card; {smi}")
    del state, batches
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_quality_",
                            dir=os.path.join(ROOT, "build"))
    cmd = [sys.executable, "-m", "vqvae_tpu_torch.quality.quality_check",
           "--steps", str(QUALITY_STEPS), "--batch-size", str(B),
           "--speaker-matrix", "--device", str(device)]
    for e in QUALITY_ENGINES:
        cmd += ["--engine", e]
    with open(os.path.join(work, "stdout"), "w") as out, \
            open(os.path.join(work, "stderr"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err,
                                env={**os.environ, "TMPDIR": work})
    say("quality", t0, f"started {' '.join(cmd[1:])}; phases train-cli-vctk "
        "and cli-codec run beside it (their checks hold values, not times)")
    return proc, work, time.monotonic()


def quality_finish(started, device, smi):
    """Phase "quality", second half: the quality check's record held to
    the gate of tests/test_quality.py; on the trained weights lax ==
    pallas and pallas-stream == the daemon's stream engine bit for bit;
    the decode kernel at tiny's float32 widths against its plain version
    and timed; the demo from the run's directory.  Returns the decode
    kernel's kernels-line entry at these widths.  The caller stops the
    process and removes the work directory."""
    import torch
    from vqvae_tpu_torch.cli.common import load_params
    from vqvae_tpu_torch.cli.serve import Codec
    from vqvae_tpu_torch.infer.streaming import CondUpsampler
    from vqvae_tpu_torch.kernels import decode_cuda as dc
    from vqvae_tpu_torch.models.wavenet import global_cond, make_gen_params
    from vqvae_tpu_torch.quality import make_demo
    from vqvae_tpu_torch.quality import quality_check as qc
    proc, work, t_start = started
    t0 = time.monotonic()
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed after 900 s"
    wall = time.monotonic() - t_start
    with open(os.path.join(work, "stdout")) as f:
        out = f.read().splitlines()
    with open(os.path.join(work, "stderr")) as f:
        err = f.read()
    if rc != 0 or len(out) < 2:
        print("\n".join(out[-20:]), err[-4000:], flush=True)
        fail(f"the quality check exited with {rc}")
    rec = json.loads(out[-2])
    launched = json.loads(out[-1].split(": ", 1)[1])["decode"]
    run = re.search(r"run directory: (\S+)", err).group(1)
    print(json.dumps(rec), flush=True)
    with open(os.path.join(run, "log.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    # each row's elapsed: wall time since the previous log row (the
    # first: since the logger opened, before step 1)
    train_s = sum(r["elapsed"] for r in rows)
    say("quality", t0, f"quality_check --steps {QUALITY_STEPS} "
        f"--batch-size {QUALITY_BATCH} --speaker-matrix on {device}: "
        f"{wall:.1f} s from its start, of which training {train_s:.1f} "
        f"s ({QUALITY_STEPS / train_s:.2f} steps a second, beside the "
        f"CLI phases), final loss1 {rec['final_loss1']}, codebook usage "
        f"{rec['train_codebook_usage']}; decode kernel launches "
        f"{launched}; {smi}")
    check(launched > 0, "the quality check launched no decode kernel")
    failed = qc.quality_gate(rec)
    check(not failed, "quality gate (tests/test_quality.py): "
          + "; ".join(failed))
    m = rec["speaker_matrix"]
    say("quality", t0, "gate met: band correlation "
        + ", ".join(f"{e} {rec['engines'][e]['band_spectral_correlation']}"
                    for e in QUALITY_ENGINES) + "; harmonic ratio "
        + ", ".join(f"{e} {rec['engines'][e]['harmonic_energy_ratio']}"
                    for e in QUALITY_ENGINES)
        + f"; matrix ({m['engine']}) diag {m['diag_mean']}, off-diagonal "
        f"{m['offdiag_mean']}, target off-diagonal "
        f"{m['target_offdiag_mean']}")

    # the trained weights as the daemon and the demo load them
    t0 = time.monotonic()
    cfg = qc.tiny_config(QUALITY_STEPS, QUALITY_BATCH)
    mc = cfg.model
    params = load_params(run, cfg, device)
    codes = qc._encode(params, cfg, qc._held_out_tone(cfg.data.sr,
                                                      110.0))
    outs = {e: qc._decode(params, cfg, codes, [0], 0, 0.8, e)
            for e in qc.ENGINES}
    codec = Codec(params, cfg, chunk=16, engine="stream",
                  device=str(device))
    outs["stream"] = codec.decode(codes[0], 0, 0, 0.8)[None]
    check(np.array_equal(outs["lax"], outs["pallas"]),
          "quality: lax != pallas on the held-out tone")
    check(np.array_equal(outs["pallas-stream"], outs["stream"]),
          "quality: pallas-stream != the daemon's stream engine")
    check(np.array_equal(outs["lax"], outs["stream"]),
          "quality: the one-shot and served decodes differ")
    say("quality", t0, f"held-out tone ({codes.shape[1]} codes, seed 0, "
        "temperature 0.8): lax == pallas, pallas-stream == the stream "
        "engine (16-frame then 1-frame pushes) == lax, bit for bit")

    # the decode kernel at the quality path's widths and rows
    t0 = time.monotonic()
    with torch.no_grad():
        gp = make_gen_params(params.decoder, mc)
        cond1 = CondUpsampler(params, mc)(torch.from_numpy(codes).to(
            device))
        T = cond1.shape[1]
        worst = 0.0
        for Bq in (1, mc.n_speakers):
            cond = cond1[:, :T_CHECK].expand(Bq, -1, -1).contiguous()
            gcond = global_cond(params.decoder, mc,
                                torch.arange(Bq, device=device))
            st0 = dc.init_decode_state(mc, Bq, gp.wff.dtype, device)
            got = dc.generate_ids(gp, mc, cond, gcond, 3, TEMP)
            x_in = torch.cat([torch.full((Bq, 1), mc.mu // 2,
                                         dtype=torch.int32,
                                         device=device), got[:, :-1]], 1)
            lk = dc.teacher_logits(gp, mc, x_in, cond, gcond)
            lp = dc._plain(gp, mc, dc.TEACHER, cond, gcond, 0, 1.0, st0,
                           x_in)[0]
            scale = float(lp.abs().max())
            err = float((lk - lp).abs().max())
            check(bool(torch.isfinite(lk).all()) and err <= 1e-4 * scale,
                  f"tiny B={Bq}: teacher logits off by {err} "
                  f"(max|logits| {scale}, tol 1e-4)")
            worst = max(worst, err)
            n_bad, n_far = pick_mismatches(dc, lp, got, False, 3, 0,
                                           2e-4 * scale / TEMP)
            check(n_far == 0, f"tiny B={Bq}: {n_far} sampled kernel picks "
                  "differ from the plain pick away from a near-tie")
            say("quality", t0, f"decode kernel, tiny float32 B={Bq} "
                f"T={T_CHECK}: logits max|d| {err:.3g} <= 1e-4*max|logits|"
                f" = {1e-4 * scale:.3g}; sampled near-tie mismatches "
                f"{n_bad}/{Bq * T_CHECK}")
        gcond = global_cond(params.decoder, mc,
                            torch.zeros(1, dtype=torch.long,
                                        device=device))
        st0 = dc.init_decode_state(mc, 1, gp.wff.dtype, device)
        ms = cuda_ms(lambda: dc.generate_ids_resume(gp, mc, cond1, gcond,
                                                    0, 0.8, st0))
        T10 = T // 10
        ms10 = cuda_ms(lambda: dc.generate_ids_resume(
            gp, mc, cond1[:, :T10], gcond, 0, 0.8, st0))
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        dc._plain(gp, mc, dc.SAMPLE, cond1[:, :T10], gcond, 0, 0.8, st0,
                  None)
        e1.record()
        torch.cuda.synchronize()
        plain10 = e0.elapsed_time(e1)
    info = dc.cluster_info(mc, gp.wff.dtype)
    where = ("resident" if info["resident"] else "read through L1/L2")
    bms, bby = bound(*decode_work(mc, 1, T10, es=4), peak=PEAK_F32)
    say("quality", t0, f"decode kernel, tiny float32 B=1: {ms:.2f} ms "
        f"for the held-out tone's {T} steps ({1e3 * ms / T:.2f} us a "
        f"step); over its first {T10} kernel {ms10:.2f} ms, plain "
        f"{plain10:.1f} ms, bound {bms:.5f} ms ({bby}); cluster of "
        f"{info['cluster']} blocks, {info['smem_bytes']} B shared memory"
        f" a block, weights {where}; {smi}")

    t0 = time.monotonic()
    demo = os.path.join(work, "demo")
    make_demo.main(["-m", run, "-o", demo, "--device", str(device)])
    with open(os.path.join(demo, "metrics.json")) as f:
        metrics = json.load(f)
    lax = rec["engines"]["lax"]
    keys = ("band_spectral_correlation", "harmonic_energy_ratio",
            "harmonic_energy_ratio_ceiling")
    check(all(metrics[k] == lax[k] for k in keys),
          f"make_demo's metrics {metrics} != eval_quality's {lax}")
    wavs = {"input.wav", "mulaw_ceiling.wav", "reconstruction.wav"}
    check(wavs <= set(metrics["files"]),
          f"make_demo wrote {metrics['files']}")
    say("quality", t0, f"make_demo -m <run>: {metrics['files']}, "
        f"metrics == eval_quality's (lax, speaker 0, seed 0)")
    return {"name": "decode_tiny", "route": "cuda",
            "source": "vqvae_tpu_torch/csrc/decode.cu",
            "replaces": "vqvae_tpu/kernels/decode_pallas.py:354",
            "launches": launched, "max_abs_err": worst, "ms": ms10,
            "plain_ms": plain10, "bound_ms": bms, "bound_by": bby,
            "library_ms": None}


def main():
    t0 = time.monotonic()
    smi = nvidia_smi()
    print(smi, flush=True)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from vqvae_tpu_torch.configs import get_config
    from vqvae_tpu_torch.kernels import build, decode_cuda as dc
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    say("device", t0, f"{kind}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    t0 = time.monotonic()
    sources = {"vqvae_decode": "decode.cu",
               "vqvae_wavenet_train": "wavenet_train.cu",
               "vqvae_head_ce": "head_ce.cu",
               "vqvae_vq": "vq.cu",
               "vqvae_encoder": "encoder.cu",
               "vqvae_upsample": "upsample.cu",
               "vqvae_decode_chain": "decode_chain.cu",
               "vqvae_embed": "embed.cu"}
    from vqvae_tpu_torch.native import bindings
    with ThreadPoolExecutor(max_workers=len(sources) + 1) as pool:
        # one nvcc per source, all started together, and g++ for the
        # native audio library beside them
        native = pool.submit(bindings.available)
        for f in [pool.submit(build.build, k, [v])
                  for k, v in sources.items()]:
            f.result()
        check(native.result(), "g++ did not build vqvae_tpu_torch/native/"
              "audio.cpp")
    say("build", t0, f"native/audio.cpp -> {bindings.so_path().name}")
    for name, src in sources.items():
        info = build.builds.get(name)
        log = (info or {}).get("log", "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                log))
        built = os.path.basename((info or {}).get("path", "cached build"))
        say("build", t0, f"{src} -> {built}"
            + (f" ({info['seconds']:.1f} s)" if info else "")
            + (f"; -Xptxas -v: {len(regs)} kernels, registers "
               f"{min(regs)}..{max(regs)}, spill stores {spills} bytes"
               if regs else ""))

    cfg_all = get_config(PRESET)
    flag = cfg_all.model
    worst, _ = kernel_phase(dc, flag, device)
    resume_phase(dc, flag, device)
    launched = serve_phase(flag, cfg_all, device, dc)
    ms, plain_ms, T_req, err = request_phase(dc, flag, device,
                                             cfg_all.data.sr)
    bms, bby = bound(*decode_work(flag, 1, T_req))
    kernels = [{
        "name": "decode",
        "route": "cuda",
        "source": "vqvae_tpu_torch/csrc/decode.cu",
        "replaces": "vqvae_tpu/kernels/decode_pallas.py:354",
        "launches": launched,
        "max_abs_err": max(err, *worst.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": bby,
        "library_ms": None,
    }]

    train_cfg = get_config(TRAIN_PRESET)
    errs = train_kernel_phase(train_cfg, device)
    counts = train_cli_phase()
    timing = train_time_phase(train_cfg, device, errs)
    timing.update(train_time_vctk_phase(device, errs))
    timing.update(enc_kernel_phase(device, errs))
    probe = probes_phase(1e3 * ms / T_req)
    # the quality check's training is host-bound and long: it runs beside
    # the CLI phases, whose checks hold values, after every phase that
    # times the card and before the rest
    started = quality_start(device, smi)
    try:
        vctk_counts, win_counts = train_cli_vctk_phase()
        codec_counts = cli_codec_phase(device)
        quality_kernel = quality_finish(started, device, smi)
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].wait()
        shutil.rmtree(started[1], ignore_errors=True)
    host_data_phase()
    # each kernel's launches come from the run of the path that uses it
    counts.update({k: vctk_counts[k] for k in ("chunk_bwd_rec",
                                                 "vq_argmin",
                                                 "take_rows_bwd")})
    counts["chunk_bwd_win"] = win_counts["chunk_bwd_win"]
    counts.update({k: codec_counts[k] for k in ("encoder_fwd",
                                                 "encoder_bwd")})
    for name, src, replaces in (
            ("chunk_fwd", "wavenet_train.cu",
             "vqvae_tpu/kernels/wavenet_train_pallas.py:586"),
            ("chunk_bwd", "wavenet_train.cu",
             "vqvae_tpu/kernels/wavenet_train_pallas.py:727"),
            ("chunk_bwd_rec", "wavenet_train.cu",
             "vqvae_tpu/kernels/wavenet_train_pallas.py:727"),
            ("chunk_bwd_win", "wavenet_train.cu",
             "vqvae_tpu/kernels/wavenet_train_pallas.py:809"),
            ("head_ce_fwd", "head_ce.cu",
             "vqvae_tpu/kernels/head_ce_pallas.py:170"),
            ("head_ce_bwd", "head_ce.cu",
             "vqvae_tpu/kernels/head_ce_pallas.py:201"),
            ("vq_argmin", "vq.cu", "vqvae_tpu/kernels/vq_pallas.py:58"),
            ("encoder_fwd", "encoder.cu",
             "vqvae_tpu/kernels/encoder_pallas.py:204"),
            ("encoder_bwd", "encoder.cu",
             "vqvae_tpu/kernels/encoder_pallas.py:240"),
            # an XLA backward (take_rows's _bwd), not a Pallas kernel
            ("take_rows_bwd", "embed.cu", "vqvae_tpu/ops/embed.py:32")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"vqvae_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], "library_ms": None,
                        **timing[name]})
    for name, src, replaces in (
            ("cond_fwd", "upsample.cu", "scripts/cond_inkernel_probe.py:91"),
            ("cond_bwd", "upsample.cu",
             "scripts/cond_inkernel_probe.py:103"),
            ("probe_reshape", "upsample.cu",
             "scripts/mosaic_reshape_probe.py:29"),
            ("probe_compose", "upsample.cu",
             "scripts/mosaic_reshape_probe.py:91"),
            ("probe_dot", "upsample.cu", "scripts/mosaic_dot_probe.py:26"),
            ("chain_bf16", "decode_chain.cu",
             "scripts/decode_int8_micro.py:44"),
            ("chain_int8", "decode_chain.cu",
             "scripts/decode_int8_micro.py:48")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"vqvae_tpu_torch/csrc/{src}",
                        "replaces": replaces, **probe[name]})
    kernels.append(quality_kernel)
    mesh_phase(device, smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(*sys.argv[2:4])
    else:
        main()
