// Fused gated-residual training chunk: the forward and the three
// backwards (save-gates, recompute, time-windowed recompute).
//
// Replaces the TPU kernels of vqvae_tpu/kernels/wavenet_train_pallas.py:
//   _fwd_kernel (call in _chunk_fwd_call, :586) for fused_stack_chunk,
//   fused_stack_chunk_acc and fused_stack_chunk_embed;
//   _bwd_kernel (call in _chunk_grads, :727) with save_gates=True
//   (vqvae_chunk_bwd) and with save_gates=False (vqvae_chunk_bwd_rec);
//   _bwd_kernel_windowed (call in _chunk_bwd_windowed_call, :809)
//   (vqvae_chunk_bwd_win).
// The plain PyTorch versions, with the same rounding points, are in
// vqvae_tpu_torch/kernels/wavenet_train_cuda.py (fwd_plain, bwd_plain,
// bwd_rec_plain, bwd_win_plain).
//
// What bounds it on the card: the chunk is a chain of small products
// (K = 64..256 per row) over B*T rows, about 90 kFLOP per row and
// layer in each direction, and the saved gates [B, nl, T, 2R] are the
// largest bytes.  At B=64, T=7680 the forward's products need ~0.44
// TFLOP (0.45 ms at the bf16 tensor-core peak) and its bytes ~1.9 GB
// (0.57 ms at 3.35 TB/s): bytes bind.  The backward's products need
// ~0.93 TFLOP (0.94 ms): operations bind; the recompute backwards add
// the forward's u products (pass 1) and move fewer bytes (no saved
// gates).  The forward multiplies with scalar float32 FMAs in k order
// (train_common.cuh, tile_mm): its gates and h round to bf16 and feed
// the next layer, so it keeps the plain version's summation order and
// equals it bit for bit.  The backward's bf16 products run on the
// tensor cores (wmma); it is linear in dh, so its other summation order
// moves the gradients by ~1e-3 of max.  All run far from their bounds
// (PERF.md).
//
// Design.  The TPU kernel keeps a whole [T, R] sequence and all 10
// layers of a chunk in VMEM, where each dilated shift is a static
// slice.  A block's 227 KB cannot hold that, so here every layer is
// its own launch over row tiles of TM = 32 time steps:
//  * forward (fwd_layer): h ping-pongs between two [B, T, R] buffers,
//    so h(t-dil) is simply the previous launch's output; the skip sum
//    is a float32 [B, T, S] scratch, cast to the compute dtype by the
//    last layer.  The save-gates forward also writes the gate halves.
//  * backward pass 1 stores every layer's input in hall [nl, B, T, R]:
//    the save-gates backward replays the residual chain from the saved
//    gates (one launch, bwd_replay); the recompute backward runs
//    fwd_layer again per layer without the skip sum, writing hall and
//    the gate halves into a scratch that lives only inside this call,
//    with the forward's own arithmetic, so its gates and h equal the
//    forward's bit for bit.
//  * backward pass 2 (sweep), per layer in reverse: one launch for the
//    row-local chain (dz, du, dcond, dph), a small launch for the causal
//    shift of dph_a (it crosses row tiles), and split-K products for
//    the weight gradients (atb), whose per-block slabs are summed in a
//    fixed order, so every result is the same from run to run (no
//    atomics).
//  * the windowed backward runs passes 1 and 2 per time window of Tc
//    steps, right to left.  Pass 1 recomputes the window with a halo of
//    A >= sum(dils) steps before it (zero before the sequence start,
//    where h is masked to an exact zero after every layer), so the
//    window's own rows are exact; its scratch is window-sized (hall
//    [nl, B, Tc + A, R], gates [B, nl, Tc, 2R]).  Pass 2's causal shift
//    takes the last dil rows of dph_a from the window to the right
//    through a spill carry [nl, B, Dmax, R], zero at the sequence end.
//    The weight gradients are added window by window in that fixed
//    order.
//  * the embedding-table gradient is a gather/scatter by id: block
//    (v, part) sums cdt(dh) over its rows whose id is v, then the parts
//    are summed in order.
#include "train_common.cuh"

using namespace vqt;

namespace {

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// h0[row, c] = cdt(w1[ids[t]] + w0[ids[t-1]] + b), w0 term 0 at t = 0
template <typename T>
__global__ void embed_fwd(int N, int Tn, int R, int mu,
                          const int* __restrict__ ids,
                          const T* __restrict__ wemb,
                          const T* __restrict__ bemb, T* __restrict__ h0) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (size_t)N * R) return;
  const int row = (int)(e / R), c = (int)(e % R);
  const float w1 = tof(wemb[((size_t)mu + ids[row]) * R + c]);
  const float w0 =
      (row % Tn) > 0 ? tof(wemb[(size_t)ids[row - 1] * R + c]) : 0.f;
  h0[e] = fromf<T>((w1 + w0) + tof(bemb[c]));
}

// One layer over a tile of TM rows of batch row blockIdx.y.  hin / hout
// hold Tw rows per batch row; row t is time t_off + t of the sequence
// (cond holds Tg steps per batch row and reads 0 before time 0).  The
// gate halves of rows t >= goff go to gall [B, nl, gTn, 2R] (if gall);
// with mask, h is an exact 0 at times before 0.  FWD is the forward
// (the skip sum runs, every layer writes hout); without FWD it is a
// recompute (no skip sum; without hout the residual is skipped, as in
// the last layer).  WIN = false is the whole sequence (Tw = Tg = gTn,
// t_off = goff = 0, no mask).
template <typename T, int JH, bool WIN, bool FWD>   // JH = R / 32
__global__ void fwd_layer(int Tw, int Tg, int t_off, int R, int S, int d,
                          int dil, int li, int nl, int goff, int gTn,
                          int mask, int first, int last, int acc,
                          const T* __restrict__ hin,
                          const T* __restrict__ cond,
                          const T* __restrict__ gc,
                          const T* __restrict__ wff,
                          const T* __restrict__ vc,
                          const T* __restrict__ wr,
                          const T* __restrict__ br,
                          const T* __restrict__ ws,
                          const T* __restrict__ tail, float* skf,
                          T* __restrict__ hout, T* __restrict__ skips,
                          T* __restrict__ gall) {
  const int R2 = 2 * R;
  float* ph = smem;              // [TM][2R]  [h(t-dil) | h(t)]
  float* cs = ph + TM * R2;      // [TM][d]
  float* zs = cs + TM * d;       // [TM][R]
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;
  const size_t base = (size_t)b * Tw;
  for (int e = tid; e < TM * R2; e += NT) {
    const int r = e / R2, c = e % R2, t = t0 + r;
    float v = 0.f;
    if (t < Tw) {
      if (c < R)
        v = t >= dil ? tof(hin[(base + t - dil) * R + c]) : 0.f;
      else
        v = tof(hin[(base + t) * R + c - R]);
    }
    ph[e] = v;
  }
  for (int e = tid; e < TM * d; e += NT) {
    const int r = e / d, c = e % d, t = t0 + r;
    if constexpr (WIN) {
      const int tg = t_off + t;
      cs[e] = (t < Tw && tg >= 0)
                  ? tof(cond[((size_t)b * Tg + tg) * d + c]) : 0.f;
    } else {
      cs[e] = t < Tw ? tof(cond[(base + t) * d + c]) : 0.f;
    }
  }
  __syncthreads();

  {
    // u = (ph @ wff + cond @ vc) + gc, the two products summed apart
    // and then added, as the plain version (and the TPU kernel) does
    float u[RT][4], v[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) u[i][j] = v[i][j] = 0.f;
    mac<4>(u, ph, R2, wff, R2, R2, R2, rg, cg);
    mac<4>(v, cs, d, vc, R2, d, R2, rg, cg);
    const T* gcl = gc + ((size_t)b * nl + li) * R2;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + RG * i, t = t0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= JH) continue;
        const int c = cg + 32 * j;
        const float ua = __fadd_rn(u[i][j], v[i][j]) + tof(gcl[c]);
        const float ub = __fadd_rn(u[i][j + JH], v[i][j + JH]) + tof(gcl[c + R]);
        const float ta = tanhf(ua);
        const float sb = 1.f / (1.f + expf(-ub));
        zs[r * R + c] = rnd<T>(ta * sb);
        if (gall != nullptr && t < Tw && (!WIN || t >= goff)) {
          const size_t gi = WIN
              ? (((size_t)b * nl + li) * gTn + t - goff) * R2
              : (((size_t)b * nl + li) * Tw + t) * R2;
          gall[gi + c] = fromf<T>(ta);
          gall[gi + c + R] = fromf<T>(sb);
        }
      }
    }
  }
  __syncthreads();

  if (FWD || hout != nullptr) {
    float rs[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i) rs[i][0] = rs[i][1] = 0.f;
    mac<2>(rs, zs, R, wr, R, R, R, rg, cg);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + RG * i, t = t0 + r;
      if (t >= Tw) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= JH) continue;
        const int c = cg + 32 * j;
        float h = rnd<T>(ph[r * R2 + R + c] + rnd<T>(rs[i][j]));
        h = rnd<T>(h + tof(br[c]));
        if (WIN && mask && t_off + t < 0) h = 0.f;
        hout[(base + t) * R + c] = fromf<T>(h);
      }
    }
  }
  if constexpr (FWD) {
    float sk[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sk[i][j] = 0.f;
    mac<8>(sk, zs, R, ws, S, R, S, rg, cg);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + RG * i, t = t0 + r;
      if (t >= Tw) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 32 * j;
        if (c >= S) continue;
        const size_t o = (base + t) * S + c;
        const float prev =
            first ? (acc ? tof(tail[o]) : tof(tail[c])) : skf[o];
        const float v = prev + sk[i][j];
        if (last)
          skips[o] = fromf<T>(v);
        else
          skf[o] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Save-gates pass 1: the residual chain from the saved gates,
// z = cdt(g_a * g_b); hall[li] = layer li's input.  Also dh = dhout and
// dcond = 0.
template <typename T, int JH>   // JH = R / 32
__global__ void bwd_replay(int B, int Tn, int R, int d, int nl, int mu,
                           int embed, const T* __restrict__ h0,
                           const int* __restrict__ ids,
                           const T* __restrict__ wemb,
                           const T* __restrict__ bemb,
                           const T* __restrict__ wr,
                           const T* __restrict__ br,
                           const T* __restrict__ gall,
                           const T* __restrict__ dhout, T* __restrict__ hall,
                           float* __restrict__ dh,
                           float* __restrict__ dcond) {
  float* hs = smem;            // [TM][R]
  float* zs = hs + TM * R;     // [TM][R]
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;
  const int R2 = 2 * R;
  const size_t base = (size_t)b * Tn;
  for (int e = tid; e < TM * R; e += NT) {
    const int r = e / R, c = e % R, t = t0 + r;
    float v = 0.f;
    if (t < Tn) {
      const size_t row = base + t;
      if (embed) {
        const float w1 = tof(wemb[((size_t)mu + ids[row]) * R + c]);
        const float w0 = t > 0 ? tof(wemb[(size_t)ids[row - 1] * R + c]) : 0.f;
        v = rnd<T>((w1 + w0) + tof(bemb[c]));
      } else {
        v = tof(h0[row * R + c]);
      }
      dh[row * R + c] = tof(dhout[row * R + c]);
    }
    hs[e] = v;
  }
  for (int e = tid; e < TM * d; e += NT) {
    const int t = t0 + e / d;
    if (t < Tn) dcond[(base + t) * d + e % d] = 0.f;
  }
  __syncthreads();
  for (int li = 0; li < nl; ++li) {
    for (int e = tid; e < TM * R; e += NT) {
      const int r = e / R, c = e % R, t = t0 + r;
      float z = 0.f;
      if (t < Tn) {
        hall[(((size_t)li * B + b) * Tn + t) * R + c] = fromf<T>(hs[e]);
        const size_t gi = (((size_t)b * nl + li) * Tn + t) * R2;
        z = rnd<T>(tof(gall[gi + c]) * tof(gall[gi + c + R]));
      }
      zs[e] = z;
    }
    __syncthreads();
    float rs[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i) rs[i][0] = rs[i][1] = 0.f;
    mac<2>(rs, zs, R, wr + (size_t)li * R * R, R, R, R, rg, cg);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + RG * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= JH) continue;
        const int c = cg + 32 * j;
        const float h = rnd<T>(hs[r * R + c] + rnd<T>(rs[i][j]));
        hs[r * R + c] = rnd<T>(h + tof(br[(size_t)li * R + c]));
      }
    }
    __syncthreads();
  }
}

// Pass 2, the row-local part of layer li over Tn rows per batch row
// (the whole sequence, or one time window starting at time tw0 of a
// sequence of Tg steps; dskips and dcond are indexed by time):
//   dh_c = cdt(dh); dz = dh_c @ wr^T + dskips @ ws^T
//   da = dz*sb*(1-ta^2), db = dz*ta*sb*(1-sb); du = cdt([da|db])
//   dcond += du @ vc^T; dph = du @ wff^T
//   dh_new = dh + dph_b (dph_a is added, shifted, by shift_add)
// It also writes z = cdt(ta*sb) and the float32 [da|db] for the weight
// gradients and dgc.  The products go through tile_mm (tensor cores for
// bf16); the epilogues read their results from shared memory.
template <typename T>
__global__ void bwd_layer(int Tn, int Tg, int tw0, int R, int S, int d,
                          int nl, int li, const float* __restrict__ dh,
                          const T* __restrict__ dskips,
                          const T* __restrict__ gall,
                          const T* __restrict__ wrT,
                          const T* __restrict__ wsT,
                          const T* __restrict__ vcT,
                          const T* __restrict__ wffT, T* __restrict__ zbuf,
                          float* __restrict__ dug, float* __restrict__ dcond,
                          float* __restrict__ dh_new,
                          float* __restrict__ dpha) {
  const int R2 = 2 * R;
  T* dhc = reinterpret_cast<T*>(smem);               // [TM][R]
  T* dsk = reinterpret_cast<T*>(smem + words<T>(TM * R));        // [TM][S]
  T* dus = reinterpret_cast<T*>(smem + words<T>(TM * (R + S)));  // [TM][2R]
  float* o1 = smem + words<T>(TM * (R + S + R2));    // [TM][R]
  float* o2 = o1 + TM * R;                           // [TM][2R]
  float* o3 = o2 + TM * R2;                          // [TM][d]
  const int b = blockIdx.y, t0 = blockIdx.x * TM, tid = threadIdx.x;
  const size_t base = (size_t)b * Tn;                // window rows
  const size_t gbase = (size_t)b * Tg + tw0;         // sequence rows
  for (int e = tid; e < TM * R; e += NT) {
    const int t = t0 + e / R;
    dhc[e] = fromf<T>(t < Tn ? dh[(base + t) * R + e % R] : 0.f);
  }
  for (int e = tid; e < TM * S; e += NT) {
    const int t = t0 + e / S;
    dsk[e] = t < Tn ? dskips[(gbase + t) * S + e % S] : fromf<T>(0.f);
  }
  __syncthreads();
  tile_mm<2, true>(o1, R, dhc, R, wrT, R, R, R);      // dh_c @ wr^T
  tile_mm<2, true>(o2, R, dsk, S, wsT, R, S, R);      // dskips @ ws^T
  __syncthreads();
  for (int e = tid; e < TM * R; e += NT) {
    const int r = e / R, c = e % R, t = t0 + r;
    float da = 0.f, db = 0.f;
    if (t < Tn) {
      const float dz = __fadd_rn(o1[e], o2[e]);
      const size_t gi = (((size_t)b * nl + li) * Tn + t) * R2;
      const float ta = tof(gall[gi + c]), sb = tof(gall[gi + c + R]);
      da = dz * sb * (1.f - ta * ta);
      db = dz * ta * sb * (1.f - sb);
      const size_t row = base + t;
      dug[row * R2 + c] = da;
      dug[row * R2 + c + R] = db;
      zbuf[row * R + c] = fromf<T>(ta * sb);
    }
    dus[r * R2 + c] = fromf<T>(da);
    dus[r * R2 + c + R] = fromf<T>(db);
  }
  __syncthreads();
  tile_mm<2, true>(o3, d, dus, R2, vcT, d, R2, d);    // du @ vc^T
  tile_mm<4, true>(o2, R2, dus, R2, wffT, R2, R2, R2);   // du @ wff^T
  __syncthreads();
  for (int e = tid; e < TM * d; e += NT) {
    const int t = t0 + e / d;
    if (t < Tn) dcond[(gbase + t) * d + e % d] += o3[e];
  }
  for (int e = tid; e < TM * R; e += NT) {
    const int r = e / R, c = e % R, t = t0 + r;
    if (t >= Tn) continue;
    const size_t o = (base + t) * R + c;
    dh_new[o] = dh[o] + o2[r * R2 + R + c];
    dpha[o] = o2[r * R2 + c];
  }
}

// dh[b, t] += dph_a[b, t + dil] where t + dil < Tn; past the window's
// end (windowed backward) the term is the right window's dph_a from the
// spill carry, spill[b, t + dil - Tn] ([B, Dmax, R]); without a spill
// (the whole sequence) it is 0.
__global__ void shift_add(int N, int Tn, int R, int dil,
                          const float* __restrict__ dpha,
                          const float* __restrict__ spill, int Dmax,
                          float* __restrict__ dh) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (size_t)N * R) return;
  const size_t row = e / R;
  const int t = (int)(row % Tn);
  if (t + dil < Tn) {
    dh[e] += dpha[e + (size_t)dil * R];
  } else if (spill != nullptr) {
    const size_t b = row / Tn;
    dh[e] += spill[(b * Dmax + t + dil - Tn) * R + e % R];
  }
}

// spill[b, j] = dph_a[b, j] for j < dil: this window's first rows, which
// the window to its left adds past its end
__global__ void spill_save(int B, int Tn, int R, int dil, int Dmax,
                           const float* __restrict__ dpha,
                           float* __restrict__ spill) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (size_t)B * dil * R) return;
  const int c = (int)(e % R), j = (int)((e / R) % dil);
  const size_t b = e / R / dil;
  spill[(b * Dmax + j) * R + c] = dpha[(b * Tn + j) * R + c];
}

// dst[b, doff + i] = src[b, soff + i] for i < n (C columns; src holds
// sseg rows per batch row and reads 0 outside them), converted to TD
template <typename TS, typename TD>
__global__ void copy_rows(int B, int n, int C, const TS* __restrict__ src,
                          int sseg, int soff, TD* __restrict__ dst, int dseg,
                          int doff) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (size_t)B * n * C) return;
  const int c = (int)(e % C), i = (int)((e / C) % n);
  const size_t b = e / C / n;
  const int t = soff + i;
  const float v =
      (t >= 0 && t < sseg) ? tof(src[(b * sseg + t) * C + c]) : 0.f;
  dst[(b * dseg + doff + i) * C + c] = fromf<TD>(v);
}

// part[((tap*mu + v)*P + p)*R + c] = sum of cdt(dh[row, c]) over the rows
// of part p whose key is v: key = ids[row] (tap 1) or ids[row-1] (tap 0,
// none at t = 0).  Grid (mu, P, 2); warp w scans rows w, w+8, ...
template <typename T>
__global__ void embed_grad_part(int N, int Tn, int R, int mu,
                                const int* __restrict__ ids,
                                const float* __restrict__ dh,
                                float* __restrict__ part) {
  // smem: [RG][R]
  const int v = blockIdx.x, p = blockIdx.y, tap = blockIdx.z;
  const int P = gridDim.y;
  const int chunk = (N + P - 1) / P;
  const int r0 = p * chunk, r1 = min(N, r0 + chunk);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = r0 + w; r < r1; r += RG) {
    const int key = tap ? ids[r] : ((r % Tn) > 0 ? ids[r - 1] : -1);
    if (key != v) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      if (c < R) acc[j] += rnd<T>(dh[(size_t)r * R + c]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = lane + 32 * j;
    if (c < R) smem[w * R + c] = acc[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < R; c += NT) {
    float s = 0.f;
    for (int ww = 0; ww < RG; ++ww) s += smem[ww * R + c];
    part[(((size_t)tap * mu + v) * P + p) * R + c] = s;
  }
}

template <typename TS, typename TD>
int launch_copy(int B, int n, int C, const TS* src, int sseg, int soff,
                TD* dst, int dseg, int doff, cudaStream_t st) {
  auto kern = copy_rows<TS, TD>;
  KLAUNCH(kern, cdiv((long long)B * n * C, NT), NT, 0, st, B, n, C, src,
          sseg, soff, dst, dseg, doff);
  return (int)last_error();
}

template <typename T>
int chunk_fwd(int mode, int B, int Tn, int R, int S, int d, int mu, int nl,
              const int* dils, const void* h, const int* ids,
              const void* wemb, const void* bemb, const void* cond,
              const void* gc, const void* wff, const void* vc, const void* wr,
              const void* br, const void* ws, const void* tail, void* hbuf0,
              void* hbuf1, float* skf, void* h_out, void* skips_out,
              void* gall, cudaStream_t st) {
  const int N = B * Tn, R2 = 2 * R;
  const T* h0 = (const T*)h;
  if (mode == 2) {   // embed
    KLAUNCH(embed_fwd<T>, cdiv((long long)N * R, NT), NT, 0, st, N, Tn, R,
            mu, ids, (const T*)wemb, (const T*)bemb, (T*)hbuf1);
    VQT_TRY(last_error());
    h0 = (const T*)hbuf1;
  }
  const size_t sm = (size_t)TM * (R2 + d + R) * sizeof(float);
  auto kern = R == 32 ? fwd_layer<T, 1, false, true>
                      : fwd_layer<T, 2, false, true>;
  VQT_TRY(smem_opt_in(kern, sm));
  T* bufs[2] = {(T*)hbuf0, (T*)hbuf1};
  const dim3 grid(cdiv(Tn, TM), B);
  for (int li = 0; li < nl; ++li) {
    const T* hin = li == 0 ? h0 : bufs[(li - 1) & 1];
    T* hout = li == nl - 1 ? (T*)h_out : bufs[li & 1];
    KLAUNCH(kern, grid, NT, sm, st, Tn, Tn, 0, R, S, d, dils[li], li, nl, 0,
            Tn, 0, li == 0, li == nl - 1, mode == 1, hin, (const T*)cond,
            (const T*)gc, (const T*)wff + (size_t)li * R2 * R2,
            (const T*)vc + (size_t)li * d * R2,
            (const T*)wr + (size_t)li * R * R, (const T*)br + (size_t)li * R,
            (const T*)ws + (size_t)li * R * S, (const T*)tail, skf, hout,
            (T*)skips_out, (T*)gall);
    VQT_TRY(last_error());
  }
  return 0;
}

// Recompute pass 1 over Tw rows per batch row (row t = time t_off + t of
// a sequence of Tg steps): hall[0] holds the chunk input; each layer's
// launch writes the next layer's input into hall[li + 1] and the gate
// halves of rows t >= goff into gall [B, nl, gTn, 2R].
template <typename T>
int recompute(int B, int Tw, int Tg, int t_off, int goff, int gTn, int mask,
              int R, int S, int d, int nl, const int* dils, const void* cond,
              const void* gc, const void* wff, const void* vc,
              const void* wr, const void* br, void* hall, void* gall,
              cudaStream_t st) {
  const int R2 = 2 * R;
  const size_t sm = (size_t)TM * (R2 + d + R) * sizeof(float);
  const bool win = Tw != Tg || t_off != 0 || goff != 0 || gTn != Tw || mask;
  auto kern = R == 32
      ? (win ? fwd_layer<T, 1, true, false> : fwd_layer<T, 1, false, false>)
      : (win ? fwd_layer<T, 2, true, false> : fwd_layer<T, 2, false, false>);
  VQT_TRY(smem_opt_in(kern, sm));
  const dim3 grid(cdiv(Tw, TM), B);
  const size_t layer = (size_t)B * Tw * R;
  for (int li = 0; li < nl; ++li) {
    const T* hin = (const T*)hall + li * layer;
    T* hout = li + 1 < nl ? (T*)hall + (li + 1) * layer : nullptr;
    KLAUNCH(kern, grid, NT, sm, st, Tw, Tg, t_off, R, S, d, dils[li], li,
            nl, goff, gTn, mask, 0, 0, 0, hin, (const T*)cond,
            (const T*)gc, (const T*)wff + (size_t)li * R2 * R2,
            (const T*)vc + (size_t)li * d * R2,
            (const T*)wr + (size_t)li * R * R, (const T*)br + (size_t)li * R,
            (const T*)nullptr, (const T*)nullptr, (float*)nullptr, hout,
            (T*)nullptr, (T*)gall);
    VQT_TRY(last_error());
  }
  return 0;
}

// Pass 2 over Tn rows per batch row (time tw0 on, of a sequence of Tg
// steps): hall [nl, B, Wh, R] holds each layer's input, the window's
// rows at offset hoff; dh starts in dh0 and ends in *dh_final.  With
// accumulate the weight gradients and dgc are added to (a window after
// the first); with spill the causal shift crosses into the window to
// the right (see shift_add).
template <typename T>
int sweep(int B, int Tn, int Tg, int tw0, int Wh, int hoff, int R, int S,
          int d, int nl, const int* dils, const void* hall, const void* cond,
          const void* gall, const void* dskips, const void* wffT,
          const void* vcT, const void* wrT, const void* wsT, float* dh0,
          float* dh1, float* dpha, float* dcond, void* zbuf, float* dug,
          float* part, long long part_cap, float* spill, int Dmax,
          int accumulate, float* dgc, float* dwff, float* dvc, float* dwr,
          float* dbr, float* dws, float** dh_final, cudaStream_t st) {
  const int N = B * Tn, R2 = 2 * R;
  const dim3 grid(cdiv(Tn, TM), B);
  const size_t sm = (words<T>(TM * (R + S + R2)) + TM * (R + R2 + d)) *
                    sizeof(float);
  auto layer = bwd_layer<T>;
  VQT_TRY(smem_opt_in(layer, sm));
  const RowMap hmap{Tn, Wh, hoff, Tn, 0};    // hall rows of the window
  const RowMap cmap{Tn, Tg, tw0, Tn, 0};     // cond rows of the window
  const RowMap smap{Tn, Tn, 0, Tg, tw0};     // dskips rows of the window
  float* dcur = dh0;
  float* dnext = dh1;
  for (int li = nl - 1; li >= 0; --li) {
    const int dil = dils[li];
    const T* hin = (const T*)hall + (size_t)li * B * Wh * R;
    float* spill_l = spill ? spill + (size_t)li * B * Dmax * R : nullptr;
    // the gradients of this layer that read dh before its update
    VQT_TRY(colsum(1, N, R, dcur, R, dbr + (size_t)li * R, R, part,
                   part_cap, st, accumulate));
    KLAUNCH(layer, grid, NT, sm, st, Tn, Tg, tw0, R, S, d, nl, li, dcur,
            (const T*)dskips, (const T*)gall,
            (const T*)wrT + (size_t)li * R * R,
            (const T*)wsT + (size_t)li * S * R,
            (const T*)vcT + (size_t)li * R2 * d,
            (const T*)wffT + (size_t)li * R2 * R2, (T*)zbuf, dug, dcond,
            dnext, dpha);
    VQT_TRY(last_error());
    KLAUNCH(shift_add, cdiv((long long)N * R, NT), NT, 0, st, N, Tn, R, dil,
            dpha, spill_l, Dmax, dnext);
    VQT_TRY(last_error());
    if (spill_l != nullptr) {
      KLAUNCH(spill_save, cdiv((long long)B * dil * R, NT), NT, 0, st, B, Tn,
              R, dil, Dmax, dpha, spill_l);
      VQT_TRY(last_error());
    }
    VQT_TRY((atb<T, float, T>(N, Tn, (const T*)zbuf, R, R, 0, 0, dcur, R, R,
                              dwr + (size_t)li * R * R, part, part_cap, st,
                              accumulate)));
    VQT_TRY((atb<T, T, T>(N, Tn, (const T*)zbuf, R, R, 0, 0,
                          (const T*)dskips, S, S, dws + (size_t)li * R * S,
                          part, part_cap, st, accumulate, smap)));
    float* dwff_l = dwff + (size_t)li * R2 * R2;
    VQT_TRY((atb<T, float, T>(N, Tn, hin, R, R, dil, 0, dug, R2, R2, dwff_l,
                              part, part_cap, st, accumulate, hmap)));
    VQT_TRY((atb<T, float, T>(N, Tn, hin, R, R, 0, 0, dug, R2, R2,
                              dwff_l + (size_t)R * R2, part, part_cap, st,
                              accumulate, hmap)));
    VQT_TRY((atb<T, float, T>(N, Tn, (const T*)cond, d, d, 0, 0, dug, R2, R2,
                              dvc + (size_t)li * d * R2, part, part_cap, st,
                              accumulate, cmap)));
    VQT_TRY(colsum(B, Tn, R2, dug, R2, dgc + (size_t)li * R2, nl * R2, part,
                   part_cap, st, accumulate));
    float* tmp = dcur;
    dcur = dnext;
    dnext = tmp;
  }
  *dh_final = dcur;
  return 0;
}

// the embedding-table and bias gradients from the final dh
template <typename T>
int embed_grads(int B, int Tn, int R, int mu, const int* ids,
                const float* dh, float* part, long long part_cap,
                float* dwemb, float* dbemb, cudaStream_t st) {
  const int N = B * Tn;
  const int P = std::max(1, std::min(16, N / 4096));
  if ((long long)2 * mu * P * R > part_cap) return -1;
  KLAUNCH(embed_grad_part<T>, dim3(mu, P, 2), NT,
          (size_t)RG * R * sizeof(float), st, N, Tn, R, mu, ids, dh, part);
  VQT_TRY(last_error());
  KLAUNCH(seg_reduce, 2 * mu, NT, 0, st, P, R, part, dwemb, R, 0);
  VQT_TRY(last_error());
  return colsum(1, N, R, dh, R, dbemb, R, part, part_cap, st);
}

template <typename T>
int chunk_bwd(int embed, int B, int Tn, int R, int S, int d, int mu, int nl,
              const int* dils, const void* h0, const int* ids,
              const void* wemb, const void* bemb, const void* cond,
              const void* wffT, const void* vcT, const void* wr,
              const void* wrT, const void* br, const void* wsT,
              const void* gall, const void* dhout, const void* dskips,
              void* hall, float* dh0, float* dh1, float* dpha, float* dcond,
              void* zbuf, float* dug, float* part, long long part_cap,
              float* dgc, float* dwff, float* dvc, float* dwr, float* dbr,
              float* dws, float* dwemb, float* dbemb, cudaStream_t st) {
  const dim3 grid(cdiv(Tn, TM), B);
  {
    const size_t sm = (size_t)TM * 2 * R * sizeof(float);
    auto kern = R == 32 ? bwd_replay<T, 1> : bwd_replay<T, 2>;
    VQT_TRY(smem_opt_in(kern, sm));
    KLAUNCH(kern, grid, NT, sm, st, B, Tn, R, d, nl, mu, embed,
            (const T*)h0, ids, (const T*)wemb, (const T*)bemb, (const T*)wr,
            (const T*)br, (const T*)gall, (const T*)dhout, (T*)hall, dh0,
            dcond);
    VQT_TRY(last_error());
  }
  float* dfin = nullptr;
  VQT_TRY(sweep<T>(B, Tn, Tn, 0, Tn, 0, R, S, d, nl, dils, hall, cond, gall,
                   dskips, wffT, vcT, wrT, wsT, dh0, dh1, dpha, dcond, zbuf,
                   dug, part, part_cap, nullptr, 0, 0, dgc, dwff, dvc, dwr,
                   dbr, dws, &dfin, st));
  if (embed)
    VQT_TRY(embed_grads<T>(B, Tn, R, mu, ids, dfin, part, part_cap, dwemb,
                           dbemb, st));
  return 0;
}

template <typename T>
int chunk_bwd_rec(int embed, int B, int Tn, int R, int S, int d, int mu,
                  int nl, const int* dils, const void* h0, const int* ids,
                  const void* wemb, const void* bemb, const void* cond,
                  const void* gc, const void* wff, const void* vc,
                  const void* wr, const void* br, const void* wffT,
                  const void* vcT, const void* wrT, const void* wsT,
                  const void* dhout, const void* dskips, void* hall,
                  void* gall, float* dh0, float* dh1, float* dpha,
                  float* dcond, void* zbuf, float* dug, float* part,
                  long long part_cap, float* dgc, float* dwff, float* dvc,
                  float* dwr, float* dbr, float* dws, float* dwemb,
                  float* dbemb, cudaStream_t st) {
  const int N = B * Tn;
  // hall[0] = the chunk input
  if (embed) {
    KLAUNCH(embed_fwd<T>, cdiv((long long)N * R, NT), NT, 0, st, N, Tn, R,
            mu, ids, (const T*)wemb, (const T*)bemb, (T*)hall);
    VQT_TRY(last_error());
  } else {
    VQT_TRY(cudaMemcpyAsync(hall, h0, (size_t)N * R * sizeof(T),
                            cudaMemcpyDeviceToDevice, st));
  }
  VQT_TRY(recompute<T>(B, Tn, Tn, 0, 0, Tn, 0, R, S, d, nl, dils, cond, gc,
                       wff, vc, wr, br, hall, gall, st));
  VQT_TRY((launch_copy<T, float>(B, Tn, R, (const T*)dhout, Tn, 0, dh0, Tn,
                                 0, st)));
  VQT_TRY(cudaMemsetAsync(dcond, 0, (size_t)N * d * sizeof(float), st));
  float* dfin = nullptr;
  VQT_TRY(sweep<T>(B, Tn, Tn, 0, Tn, 0, R, S, d, nl, dils, hall, cond, gall,
                   dskips, wffT, vcT, wrT, wsT, dh0, dh1, dpha, dcond, zbuf,
                   dug, part, part_cap, nullptr, 0, 0, dgc, dwff, dvc, dwr,
                   dbr, dws, &dfin, st));
  if (embed)
    VQT_TRY(embed_grads<T>(B, Tn, R, mu, ids, dfin, part, part_cap, dwemb,
                           dbemb, st));
  else if (dfin != dh0)
    VQT_TRY(cudaMemcpyAsync(dh0, dfin, (size_t)N * R * sizeof(float),
                            cudaMemcpyDeviceToDevice, st));
  return 0;
}

// the halo of the windowed backward: sum(dils) rounded up to 8
inline int halo(int nl, const int* dils) {
  int s = 0;
  for (int i = 0; i < nl; ++i) s += dils[i];
  return (s + 7) / 8 * 8;
}

inline int max_dil(int nl, const int* dils) {
  int m = 0;
  for (int i = 0; i < nl; ++i) m = std::max(m, dils[i]);
  return m;
}

template <typename T>
int chunk_bwd_win(int B, int Tn, int R, int S, int d, int nl,
                  const int* dils, int nT, const void* h0, const void* cond,
                  const void* gc, const void* wff, const void* vc,
                  const void* wr, const void* br, const void* wffT,
                  const void* vcT, const void* wrT, const void* wsT,
                  const void* dhout, const void* dskips, void* hall,
                  void* gall, float* spill, float* dh0, float* dh1,
                  float* dpha, void* zbuf, float* dug, float* part,
                  long long part_cap, float* dh, float* dcond, float* dgc,
                  float* dwff, float* dvc, float* dwr, float* dbr,
                  float* dws, cudaStream_t st) {
  const int Dmax = max_dil(nl, dils);
  if (nT < 2 || Tn % nT) return -3;
  const int Tc = Tn / nT;
  if (Tc % 8 || Tc < Dmax) return -3;
  const int A = halo(nl, dils), W = Tc + A;
  VQT_TRY(cudaMemsetAsync(spill, 0, (size_t)nl * B * Dmax * R * sizeof(float),
                          st));
  VQT_TRY(cudaMemsetAsync(dcond, 0, (size_t)B * Tn * d * sizeof(float), st));
  for (int j = 0; j < nT; ++j) {        // windows right to left
    const int tw0 = (nT - 1 - j) * Tc;
    // hall[0] = the input over [tw0 - A, tw0 + Tc), 0 before time 0
    VQT_TRY((launch_copy<T, T>(B, W, R, (const T*)h0, Tn, tw0 - A, (T*)hall,
                               W, 0, st)));
    VQT_TRY(recompute<T>(B, W, Tn, tw0 - A, A, Tc, 1, R, S, d, nl, dils,
                         cond, gc, wff, vc, wr, br, hall, gall, st));
    VQT_TRY((launch_copy<T, float>(B, Tc, R, (const T*)dhout, Tn, tw0, dh0,
                                   Tc, 0, st)));
    float* dfin = nullptr;
    VQT_TRY(sweep<T>(B, Tc, Tn, tw0, W, A, R, S, d, nl, dils, hall, cond,
                     gall, dskips, wffT, vcT, wrT, wsT, dh0, dh1, dpha, dcond,
                     zbuf, dug, part, part_cap, spill, Dmax, j > 0, dgc,
                     dwff, dvc, dwr, dbr, dws, &dfin, st));
    VQT_TRY((launch_copy<float, float>(B, Tc, R, dfin, Tc, 0, dh, Tn, tw0,
                                       st)));
  }
  return 0;
}

bool bad_widths(int cdtype, int R, int S, int d, int nl) {
  if (R % 32 || R > 64 || S > 256 || d > 64 || nl < 1) return true;
  return cdtype == 1 && (S % 16 || d % 16);   // 16x16 fragments
}

}  // namespace

extern "C" {

// mode: 0 = seed the skip sum from the bias row tail [S], 1 = from the
// running skips tail [B, T, S] (acc), 2 = embed the ids (seeded from
// tail [S]).  cdtype: 0 float32, 1 bfloat16.  gall [B, nl, T, 2R] may be
// null (the recompute path saves no gates).  Returns 0 or an error.
int vqvae_chunk_fwd(int cdtype, int mode, int B, int Tn, int R, int S, int d,
                    int mu, int nl, const int* dils, const void* h,
                    const int* ids, const void* wemb, const void* bemb,
                    const void* cond, const void* gc, const void* wff,
                    const void* vc, const void* wr, const void* br,
                    const void* ws, const void* tail, void* hbuf0,
                    void* hbuf1, float* skf, void* h_out, void* skips_out,
                    void* gall, void* stream) {
  if (R % 32 || R > 64 || S > 256 || d > 64 || nl < 1) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_fwd<float>(mode, B, Tn, R, S, d, mu, nl, dils, h, ids, wemb,
                            bemb, cond, gc, wff, vc, wr, br, ws, tail, hbuf0,
                            hbuf1, skf, h_out, skips_out, gall, st);
  return chunk_fwd<bf16>(mode, B, Tn, R, S, d, mu, nl, dils, h, ids, wemb,
                         bemb, cond, gc, wff, vc, wr, br, ws, tail, hbuf0,
                         hbuf1, skf, h_out, skips_out, gall, st);
}

// Save-gates backward: float32 gradients of one chunk from the saved
// gates; the final dh is in dh1 when nl is odd, else in dh0.  With
// embed, dwemb [2, mu, R] and dbemb [R] are written.
int vqvae_chunk_bwd(int cdtype, int embed, int B, int Tn, int R, int S, int d,
                    int mu, int nl, const int* dils, const void* h0,
                    const int* ids, const void* wemb, const void* bemb,
                    const void* cond, const void* wffT, const void* vcT,
                    const void* wr, const void* wrT, const void* br,
                    const void* wsT, const void* gall, const void* dhout,
                    const void* dskips, void* hall, float* dh0, float* dh1,
                    float* dpha, float* dcond, void* zbuf, float* dug,
                    float* part, long long part_cap, float* dgc, float* dwff,
                    float* dvc, float* dwr, float* dbr, float* dws,
                    float* dwemb, float* dbemb, void* stream) {
  if (bad_widths(cdtype, R, S, d, nl)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_bwd<float>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids,
                            wemb, bemb, cond, wffT, vcT, wr, wrT, br, wsT,
                            gall, dhout, dskips, hall, dh0, dh1, dpha, dcond,
                            zbuf, dug, part, part_cap, dgc, dwff, dvc, dwr,
                            dbr, dws, dwemb, dbemb, st);
  return chunk_bwd<bf16>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids, wemb,
                         bemb, cond, wffT, vcT, wr, wrT, br, wsT, gall, dhout,
                         dskips, hall, dh0, dh1, dpha, dcond, zbuf, dug, part,
                         part_cap, dgc, dwff, dvc, dwr, dbr, dws, dwemb, dbemb,
                         st);
}

// Recompute backward: the same gradients with no saved gates; pass 1
// recomputes every layer's input (hall [nl, B, T, R]) and gate halves
// (gall [B, nl, T, 2R], scratch of this call).  The final dh is in dh0.
int vqvae_chunk_bwd_rec(int cdtype, int embed, int B, int Tn, int R, int S,
                        int d, int mu, int nl, const int* dils,
                        const void* h0, const int* ids, const void* wemb,
                        const void* bemb, const void* cond, const void* gc,
                        const void* wff, const void* vc, const void* wr,
                        const void* br, const void* wffT, const void* vcT,
                        const void* wrT, const void* wsT, const void* dhout,
                        const void* dskips, void* hall, void* gall,
                        float* dh0, float* dh1, float* dpha, float* dcond,
                        void* zbuf, float* dug, float* part,
                        long long part_cap, float* dgc, float* dwff,
                        float* dvc, float* dwr, float* dbr, float* dws,
                        float* dwemb, float* dbemb, void* stream) {
  if (bad_widths(cdtype, R, S, d, nl)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_bwd_rec<float>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids,
                                wemb, bemb, cond, gc, wff, vc, wr, br, wffT,
                                vcT, wrT, wsT, dhout, dskips, hall, gall, dh0,
                                dh1, dpha, dcond, zbuf, dug, part, part_cap,
                                dgc, dwff, dvc, dwr, dbr, dws, dwemb, dbemb,
                                st);
  return chunk_bwd_rec<bf16>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids,
                             wemb, bemb, cond, gc, wff, vc, wr, br, wffT, vcT,
                             wrT, wsT, dhout, dskips, hall, gall, dh0, dh1,
                             dpha, dcond, zbuf, dug, part, part_cap, dgc,
                             dwff, dvc, dwr, dbr, dws, dwemb, dbemb, st);
}

// Time-windowed recompute backward over nT windows of Tc = T / nT steps
// (T % nT == 0, Tc % 8 == 0, Tc >= max(dils), else -3).  Scratch is
// window-sized: hall [nl, B, Tc + A, R], gall [B, nl, Tc, 2R], spill
// [nl, B, max(dils), R] f32, dh0/dh1/dpha [B, Tc, R] f32, zbuf [B, Tc,
// R], dug [B, Tc, 2R] f32, with A = sum(dils) rounded up to 8.  Writes
// dh [B, T, R] and dcond [B, T, d] (float32) and the weight gradients.
int vqvae_chunk_bwd_win(int cdtype, int B, int Tn, int R, int S, int d,
                        int nl, const int* dils, int nT, const void* h0,
                        const void* cond, const void* gc, const void* wff,
                        const void* vc, const void* wr, const void* br,
                        const void* wffT, const void* vcT, const void* wrT,
                        const void* wsT, const void* dhout,
                        const void* dskips, void* hall, void* gall,
                        float* spill, float* dh0, float* dh1, float* dpha,
                        void* zbuf, float* dug, float* part,
                        long long part_cap, float* dh, float* dcond,
                        float* dgc, float* dwff, float* dvc, float* dwr,
                        float* dbr, float* dws, void* stream) {
  if (bad_widths(cdtype, R, S, d, nl)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_bwd_win<float>(B, Tn, R, S, d, nl, dils, nT, h0, cond, gc,
                                wff, vc, wr, br, wffT, vcT, wrT, wsT, dhout,
                                dskips, hall, gall, spill, dh0, dh1, dpha,
                                zbuf, dug, part, part_cap, dh, dcond, dgc,
                                dwff, dvc, dwr, dbr, dws, st);
  return chunk_bwd_win<bf16>(B, Tn, R, S, d, nl, dils, nT, h0, cond, gc, wff,
                             vc, wr, br, wffT, vcT, wrT, wsT, dhout, dskips,
                             hall, gall, spill, dh0, dh1, dpha, zbuf, dug,
                             part, part_cap, dh, dcond, dgc, dwff, dvc, dwr,
                             dbr, dws, st);
}

}  // extern "C"
