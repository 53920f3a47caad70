"""Fused autoregressive decode: the CUDA kernel ``csrc/decode.cu`` and
its plain PyTorch version (port of ``vqvae_tpu/kernels/decode_pallas.py``).

Three entry points over one kernel body, as in the JAX package:

* ``generate_ids``         — sample ``[B, T]`` ids in one call,
* ``generate_ids_resume``  — the same loop over the next T condition
  samples, carrying ``DecodeState``; this is the serving call,
* ``teacher_logits``       — teacher-forced logits ``[B, T, mu]``, the
  parity oracle.

Tensors on the CPU run the plain version: a Python loop of
``models/wavenet.decoder_step`` with the same Philox4x32-10 Gumbel
noise written in torch integer ops.  Tensors on a CUDA device launch
the kernel, or raise; nothing falls back.  ``launches`` counts kernel
launches.  Threads may launch at once, each on its current CUDA stream
(the serving daemon's connections do).

The kernel decodes each batch row on one cluster of 16 thread blocks
(``csrc/decode.cu``), so it takes R, S and mu that are multiples of 16
(R, d <= 128, d even; S, mu <= 512; at least 2 layers); other widths
raise, as does a card that cannot schedule a 16-block cluster.
``cluster_info`` reports the launch's shape and ``cluster_agree_ns`` what
it costs the cluster to agree once on the card.

Sampling: the noise of class k, row b, absolute step t is word
``k % 4`` of Philox4x32-10 with key ``(seed, 0)`` and counter
``(k // 4, row0 + b, t_lo, t_hi)``, turned into ``u = ((w >> 8) + 0.5)·2⁻²⁴``
and ``G = -log(-log u)``; the pick is ``argmax(logits/temperature + G)``
with ties to the lowest index.  Because the noise is indexed by
absolute step, any split of a stream into resumed calls gives the same
ids as one call, at any width (the TPU kernel needed CHUNK-aligned
pushes; this one does not).  The TPU's PRNG has no counterpart here,
so sampled ids differ from the JAX package's; greedy ids agree.
``row0`` (default 0) is the global row of a call's row 0: a decode split
by rows (``infer/parallel.py``) passes each shard's first row, so the
shards draw the noise of one call over the whole batch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch

from vqvae_tpu_torch.configs import ModelConfig
from vqvae_tpu_torch.kernels.build import build
from vqvae_tpu_torch.models.wavenet import (
    GenParams,
    GenState,
    decoder_step,
    gen_params_f32,
)

launches = 0   # kernel launches in this process (plain runs not counted)
_launches_lock = threading.Lock()   # the daemon's connections launch at once

TEACHER, GREEDY, SAMPLE = 0, 1, 2
_CDTYPE = {torch.float32: 0, torch.bfloat16: 1}
_MASK = 0xFFFFFFFF


class DecodeState(NamedTuple):
    """Carried decode state: the absolute step, the packed ring buffers
    ``[sum(dilations), B, R]``, ``pe0 = emb0[x_{t-1}]`` ``[B, R]`` and
    the last sampled id ``[B]`` int32 (the JAX state carries its
    one-hot; ``convert.py`` maps between the two)."""

    t0: int
    bufs: torch.Tensor
    pe0: torch.Tensor
    x_last: torch.Tensor


def init_decode_state(cfg: ModelConfig, B: int, dtype=torch.bfloat16,
                      device="cpu") -> DecodeState:
    """State at t=0: zero buffers and pe0, last id mu//2 (digital
    silence), as ``decode_pallas.init_decode_state``."""
    R = cfg.residual_channels
    return DecodeState(
        t0=0,
        bufs=torch.zeros((sum(cfg.dilations), B, R), dtype=dtype,
                         device=device),
        pe0=torch.zeros((B, R), dtype=dtype, device=device),
        x_last=torch.full((B,), cfg.mu // 2, dtype=torch.int32,
                          device=device))


# ---------------------------------------------------------------------------
# Philox4x32-10 in torch int64 ops (values kept in [0, 2^32))
# ---------------------------------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product of the constant ``a`` and
    ``b``, from two 48-bit partial products (no int64 overflow)."""
    p1 = b * (a & 0xFFFF)
    p2 = b * (a >> 16)
    t = p1 + ((p2 & 0xFFFF) << 16)
    return ((p2 >> 16) + (t >> 32)) & _MASK, t & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counters (int64 tensors, broadcastable) under
    key (k0, k1); returns the four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK, (k1 + 0xBB67AE85) & _MASK
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel_noise(seed: int, t0: int, T: int, B: int, mu: int,
                 device="cpu", row0: int = 0) -> torch.Tensor:
    """Gumbel noise ``[T, B, mu]`` float32 for absolute steps
    ``t0 .. t0+T-1`` and rows ``row0 .. row0+B-1`` (the kernel's
    stream, see module note)."""
    kw = dict(dtype=torch.int64, device=device)
    n4 = (mu + 3) // 4
    k4 = torch.arange(n4, **kw)[None, None, :]
    b = torch.arange(row0, row0 + B, **kw)[None, :, None]
    t = torch.arange(t0, t0 + T, **kw)[:, None, None]
    words = philox4x32_10(*torch.broadcast_tensors(k4, b, t & _MASK, t >> 32),
                          seed & _MASK, 0)
    w = torch.stack(words, dim=-1).reshape(T, B, 4 * n4)[:, :, :mu]
    u = ((w >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _plain(gp: GenParams, cfg: ModelConfig, mode: int, cond, gcond,
           seed: int, temperature: float, state: DecodeState, ids_in,
           row0: int = 0):
    B, T, _ = cond.shape
    cdt = gp.wff.dtype
    f32 = gen_params_f32(gp)
    cond, gcond = cond.to(cdt), gcond.to(cdt)
    gs = GenState(state.t0, state.pe0.clone(), state.bufs.clone())
    x = state.x_last.clone()
    noise = (gumbel_noise(seed, state.t0, T, B, cfg.mu, cond.device, row0)
             if mode == SAMPLE else None)
    out = []
    for s in range(T):
        x_in = ids_in[:, s] if mode == TEACHER else x
        gs, logits = decoder_step(gp, cfg, gs, x_in, cond[:, s], gcond, f32)
        if mode == TEACHER:
            out.append(logits)
            continue
        if mode == SAMPLE:
            # an elementwise tensor divide: a Python-scalar divisor may
            # become a multiply by its reciprocal on the card
            logits = logits / torch.full_like(logits, temperature) + noise[s]
        x = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(x)
    if mode == TEACHER:
        logits = (torch.stack(out, 1) if out else
                  torch.zeros((B, 0, cfg.mu), device=cond.device))
        return logits, None
    if not out:
        return torch.zeros((B, 0), dtype=torch.int32,
                           device=cond.device), state
    return torch.stack(out, 1), DecodeState(state.t0 + T, gs.bufs,
                                            gs.prev_emb0, x)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_lib = None
CLUSTER = 16   # thread blocks per batch row
# vqvae_decode's own error codes (cudaError_t codes are positive)
_ERRORS = {
    -1: "R, S and mu must be multiples of 16 (R, d <= 128, d even; "
        "S, mu <= 512; at least 2 layers)",
    -2: "this card cannot schedule one 16-block cluster of the kernel "
        "(cudaOccupancyMaxActiveClusters is 0)",
    -3: "the weight slices do not fit in a block's shared memory",
}


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build("vqvae_decode", ["decode.cu"])))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vqvae_decode.argtypes = (
            [i, i] + [p] * 18 + [i] * 7
            + [ctypes.POINTER(i), ctypes.c_longlong, ctypes.c_uint,
               ctypes.c_float, i, p])
        lib.vqvae_decode.restype = i
        lib.vqvae_decode_info.argtypes = [i] * 7 + [ctypes.POINTER(i)]
        lib.vqvae_decode_info.restype = i
        lib.vqvae_cluster_exchange_probe.argtypes = [i, i, p]
        lib.vqvae_cluster_exchange_probe.restype = i
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           + _ERRORS.get(err, f"CUDA error {err}"))


def check_widths(cfg: ModelConfig) -> None:
    """Raise ValueError, with the reason, for widths the cluster split
    does not take."""
    R, S, d, mu = (cfg.residual_channels, cfg.skip_channels, cfg.d, cfg.mu)
    for name, v in (("R", R), ("S", S), ("mu", mu)):
        if v % CLUSTER:
            raise ValueError(
                f"the decode kernel splits each row over a {CLUSTER}-block "
                f"cluster: {name}={v} is not a multiple of {CLUSTER}")
    if (R > 128 or d > 128 or d % 2 or S > 512 or mu > 512
            or cfg.n_layers_total < 2):
        raise ValueError(f"the decode kernel takes R, d <= 128 (d even), "
                         f"S, mu <= 512 and at least 2 layers, got R={R} "
                         f"d={d} S={S} mu={mu} L={cfg.n_layers_total}")


def cluster_info(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The kernel's launch at these widths: blocks per row, shared
    memory per block, whether the weight slices are resident in shared
    memory, and ``cudaOccupancyMaxActiveClusters`` on the current card."""
    check_widths(cfg)
    out = (ctypes.c_int * 4)()
    _raise_on(_library().vqvae_decode_info(
        _CDTYPE[dtype], cfg.residual_channels, cfg.skip_channels, cfg.d,
        cfg.mu, cfg.n_layers_total, sum(cfg.dilations), out),
        "decode kernel query")
    return {"cluster": out[0], "smem_bytes": out[1],
            "resident": bool(out[2]), "max_active_clusters": out[3]}


def cluster_agree_ns(device, mode: int, iters: int = 100_000) -> float:
    """Nanoseconds for one 16-block cluster to agree once: ``mode`` 0 by
    a cluster barrier with release/acquire (``barrier.cluster``), 1 by
    the kernel's exchange (``st.async`` into every block, then a wait on
    the receiver's mbarrier).  Timed by CUDA events over ``iters``."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(lib.vqvae_cluster_exchange_probe(1000, mode, stream),
                  "cluster probe")
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        _raise_on(lib.vqvae_cluster_exchange_probe(iters, mode, stream),
                  "cluster probe")
        e1.record()
        torch.cuda.synchronize(device)
    return 1e6 * e0.elapsed_time(e1) / iters


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(gp: GenParams, cfg: ModelConfig, mode: int, cond, gcond,
            seed: int, temperature: float, state: DecodeState, ids_in,
            row0: int = 0):
    global launches
    B, T, d = cond.shape
    R, S, mu, L = (cfg.residual_channels, cfg.skip_channels, cfg.mu,
                   cfg.n_layers_total)
    cdt = gp.wff.dtype
    if cdt not in _CDTYPE:
        raise TypeError(f"decode kernel has no {cdt} instance")
    check_widths(cfg)
    dev = cond.device
    cond = cond.to(cdt).contiguous()
    gcond = gcond.to(cdt).contiguous()
    want = {"emb_w": (2, mu, R), "emb_b": (R,), "wff": (L, 2 * R, 2 * R),
            "vc_all": (d, L * 2 * R), "wrs": (L, R, R + S),
            "brs": (L, R + S), "head_h1": (S, S), "head_b1": (S,),
            "head_h2": (S, mu), "head_b2": (mu,)}
    for name, shape in want.items():
        w = getattr(gp, name)
        dt = torch.float32 if name in ("head_h2", "head_b2") else cdt
        if (tuple(w.shape) != shape or w.dtype != dt or w.device != dev
                or not w.is_contiguous()):
            raise ValueError(f"GenParams.{name}: want {shape} {dt} "
                             f"contiguous on {dev}, got "
                             f"{tuple(w.shape)} {w.dtype} on {w.device}")
    if tuple(gcond.shape) != (L, B, 2 * R):
        raise ValueError(f"gcond must be [{L}, {B}, {2 * R}]")
    bufs = state.bufs.to(dev, cdt).clone()
    pe0 = state.pe0.to(dev, cdt).clone()
    x_last = state.x_last.to(dev, torch.int32).clone()
    if (tuple(bufs.shape) != (sum(cfg.dilations), B, R)
            or tuple(pe0.shape) != (B, R) or tuple(x_last.shape) != (B,)):
        raise ValueError("decode state does not match the batch/config")
    if mode == TEACHER:
        ids_in = ids_in.to(dev, torch.int32).contiguous()
        if tuple(ids_in.shape) != (B, T):
            raise ValueError(f"ids_in must be [{B}, {T}]")
        if T and (int(ids_in.min()) < 0 or int(ids_in.max()) >= mu):
            raise ValueError(f"ids_in must lie in [0, {mu})")
        out = torch.empty((B, T, mu), dtype=torch.float32, device=dev)
        ids_out, logits_out = None, out
    else:
        ids_in = None
        out = torch.empty((B, T), dtype=torch.int32, device=dev)
        ids_out, logits_out = out, None
    if T == 0:
        return out, state
    dils = (ctypes.c_int * L)(*cfg.dilations)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().vqvae_decode(
            _CDTYPE[cdt], mode, *map(_ptr, (
                gp.emb_w, gp.emb_b, gp.wff, gp.vc_all, gp.wrs, gp.brs,
                gp.head_h1, gp.head_b1, gp.head_h2, gp.head_b2, cond, gcond,
                ids_in, ids_out, logits_out, bufs, pe0, x_last)),
            B, T, R, S, d, mu, L, dils, state.t0, seed & _MASK,
            float(temperature), row0, stream)
    _raise_on(err, "decode kernel launch")
    with _launches_lock:
        launches += 1
    if mode == TEACHER:
        return out, None
    return out, DecodeState(state.t0 + T, bufs, pe0, x_last)


def _run(gp: GenParams, cfg: ModelConfig, mode: int, cond, gcond,
         seed: int, temperature: float, state: DecodeState | None,
         ids_in=None, row0: int = 0):
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if state is None:
        state = init_decode_state(cfg, cond.shape[0], gp.wff.dtype,
                                  cond.device)
    if mode == SAMPLE and not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if cond.device.type == "cpu":
        return _plain(gp, cfg, mode, cond, gcond, seed, temperature, state,
                      ids_in, row0)
    if cond.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {cond.device}")
    return _launch(gp, cfg, mode, cond, gcond, seed, temperature, state,
                   ids_in, row0)


def generate_ids(gp: GenParams, cfg: ModelConfig, cond: torch.Tensor,
                 gcond: torch.Tensor, seed: int = 0,
                 temperature: float = 1.0, greedy: bool = False,
                 row0: int = 0) -> torch.Tensor:
    """Sample ``[B, T]`` int32 ids.  cond ``[B, T, d]``, gcond
    ``[L, B, 2R]``, seed a Python int (the Philox key), ``row0`` the
    noise's row of row 0."""
    ids, _ = _run(gp, cfg, GREEDY if greedy else SAMPLE, cond, gcond,
                  seed, temperature, None, row0=row0)
    return ids


def generate_ids_resume(gp: GenParams, cfg: ModelConfig, cond: torch.Tensor,
                        gcond: torch.Tensor, seed: int, temperature: float,
                        state: DecodeState, greedy: bool = False,
                        row0: int = 0) -> Tuple[torch.Tensor, DecodeState]:
    """Sample ids for the next T condition samples from ``state``;
    returns (ids ``[B, T]``, the new state).  Any T; the input state is
    left unchanged.  Any split of a stream into calls gives the ids and
    final state of one call, bit for bit."""
    return _run(gp, cfg, GREEDY if greedy else SAMPLE, cond, gcond, seed,
                temperature, state, row0=row0)


def teacher_logits(gp: GenParams, cfg: ModelConfig, ids_in: torch.Tensor,
                   cond: torch.Tensor, gcond: torch.Tensor,
                   state: DecodeState | None = None) -> torch.Tensor:
    """Teacher-forced logits ``[B, T, mu]`` float32, from ``state``
    (default: the start of a stream); ``ids_in[:, s]`` is the input id
    at step ``state.t0 + s``."""
    logits, _ = _run(gp, cfg, TEACHER, cond, gcond, 0, 1.0, state, ids_in)
    return logits
