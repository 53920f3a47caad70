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
// gates).  The bf16 kernels stage their weights in shared memory once
// per persistent block and take 64-row tiles.  The backward's products
// (linear in dh) and the forward's skip product (it feeds no rounding of
// the chain) run on the tensor cores (mma.sync m16n8k16,
// train_common.cuh).  The forward's u and z @ wr feed the chain's bf16
// roundings (z, h), so they keep the plain version's float32 k-order
// sums as register-blocked scalar FMAs and the forward equals the plain
// version bit for bit: summed on the tensor cores instead, some of those
// roundings flip, and over ten layers the flips moved gates by 0.037 at
// B=64 (NVIDIA H100 80GB HBM3, 700 W), past the 3e-2 gate.  float32
// keeps scalar FMAs in k order throughout (its gate is 1e-4; no TF32).
// Measured times against these bounds: PERF.md.
//
// Design.  The TPU kernel keeps a whole [T, R] sequence and all 10
// layers of a chunk in VMEM, where each dilated shift is a static
// slice.  A block's 227 KB cannot hold that, so every layer is its own
// launch over row tiles of TR = 64 time steps of one batch row (the
// float32 backward's row chain: TM = 32); those kernels are persistent,
// one block per SM walking the tiles, so the weights are staged once per
// block, and the next tile's inputs load (cp.async, or into registers)
// while the current one computes.
//  * forward (fwd_layer, both dtypes): h ping-pongs between two
//    [B, T, R] buffers, so h(t-dil) is simply the previous launch's
//    output.  Each layer writes its z = cdt(ta*sb) to a call-local
//    [nl, B*T, R] scratch, and one last launch (skip_sum_tc / skip_sum)
//    forms skips = tail + sum_l z_l @ ws_l, each layer's product summed
//    apart and added in layer order, cast once: the skip sum never
//    makes a float32 round trip through device memory per layer.  The
//    save-gates forward also writes the gate halves.
//  * backward pass 1 stores every layer's input in hall [nl, B, T, R]:
//    the save-gates backward replays the residual chain from the saved
//    gates (one launch, bwd_replay_bf16 / bwd_replay); the recompute
//    backward runs the forward's layer kernel again per layer without
//    the skip sum, writing hall and the gate halves into a scratch that
//    lives only inside this call.
//  * backward pass 2 (sweep), per layer in reverse: one launch for the
//    row-local chain (bwd_layer_tc / bwd_layer: dz, du, dcond, dph),
//    which writes du = cdt([da|db]) and cdt(dh), the operands the weight
//    gradients round to, and the float32 column sums of [da|db] (dgc)
//    and dh (dbr) of each tile; a small launch for the causal shift of
//    dph_a (it crosses row tiles); split-K products for the weight
//    gradients (atb), whose per-block slabs, like the tile column sums,
//    are summed in a fixed order, so every result is the same from run
//    to run (no atomics).
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

constexpr int TR = 64;   // rows per tile of the tensor-core (bf16) kernels

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

// Shared memory of fwd_layer (float32 word offsets): the three weights
// as float32 once per block; per tile [h(t-dil) | h(t)] and cond
// transposed (k-major), and z (rows of R + 1 words).
struct FwdSmem {
  int wff, vc, wr, ph, cs, zs, total;
  __host__ __device__ FwdSmem(int R, int d) {
    const int R2 = 2 * R;
    wff = 0;                 // [2R][2R]
    vc = wff + R2 * R2;      // [d][2R]
    wr = vc + d * R2;        // [R][R]
    ph = wr + R * R;         // [2R][TR]
    cs = ph + R2 * TR;       // [d][TR]
    zs = cs + d * TR;        // [TR][R + 1]
    total = zs + TR * (R + 1);
  }
  size_t bytes() const { return (size_t)total * sizeof(float); }
};

// 4 consecutive values as T at p (8- or 16-byte aligned)
template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c,
                                       float d) {
  if constexpr (std::is_same<T, bf16>::value)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
  else
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// One layer, persistent over the B * ceil(Tw / TR) tiles of TR rows.
// hin / hout hold Tw rows per batch row; row t is time t_off + t of the
// sequence (cond holds Tg steps per batch row and reads 0 before time
// 0).  The gate halves of rows t >= goff go to gall [B, nl, gTn, 2R]
// (if gall); with mask, h is an exact 0 at times before 0.  FWD is the
// forward (every layer writes hout and its z to zout [B*Tw, R]);
// without FWD it is a recompute (no z; without hout the residual is
// skipped, as in the last layer).  WIN = false is the whole sequence
// (Tw = Tg = gTn, t_off = goff = 0, no mask).
//
// The products feed the chain's roundings (z, cdt(z @ wr), h), so they
// keep the plain version's float32 k-order sums and the layer equals it
// bit for bit: summed in another order (the tensor cores' did), some
// bf16 roundings flip, and over ten layers the flips moved gates by
// 0.037 at B=64 on an NVIDIA H100 80GB HBM3 at 700 W, past the 3e-2
// gate.  So they are scalar FMAs, register-blocked: thread (rg, cg) owns
// rows RPT rg .. +RPT and channels 4 cg .. +4 of both gate halves, and
// per k reads one float32 vector of rows and two of weights from shared
// memory for 8 RPT FMAs (512 threads of 2 rows each ran slower on that
// card).  The weights are staged as float32 once per block; the
// next tile's rows load into registers while this one computes; the
// thread's 4 channels of gates, z and h go out from registers.  Each
// layer's z goes to zout: the skip sum runs after the last layer
// (skip_sum_tc / skip_sum).
template <typename T, int JH, bool WIN, bool FWD>   // R = 32 JH
__global__ void __launch_bounds__(NT, 1)
    fwd_layer(int B, int Tw, int Tg, int t_off, int d, int dil, int li,
              int nl, int goff, int gTn, int mask, const T* __restrict__ hin,
              const T* __restrict__ cond, const T* __restrict__ gc,
              const T* __restrict__ wff, const T* __restrict__ vc,
              const T* __restrict__ wr, const T* __restrict__ br,
              T* __restrict__ zout, T* __restrict__ hout,
              T* __restrict__ gall) {
  constexpr int R = 32 * JH, R2 = 2 * R;
  constexpr int CG = R / 4, RPT = TR * CG / NT;   // channel groups, rows
  constexpr int EP = 16 / sizeof(T);              // values a 16-byte piece
  constexpr int PCH = TR * R2 / EP / NT;          // pieces of ph a thread
  constexpr int CCH = TR * 64 / EP / NT;          // ... of cond (d <= 64)
  constexpr int LZ = R + 1;
  const FwdSmem L(R, d);
  float* Wff = smem + L.wff;
  float* Vc = smem + L.vc;
  float* Wr = smem + L.wr;
  float* Ph = smem + L.ph;
  float* Cs = smem + L.cs;
  float* Zs = smem + L.zs;
  const int tid = threadIdx.x;
  const int c0 = (tid % CG) * 4, r0 = (tid / CG) * RPT;
  const int tpr = (Tw + TR - 1) / TR, ntiles = B * tpr;
  for (int e = tid; e < R2 * R2; e += NT) Wff[e] = tof(wff[e]);
  for (int e = tid; e < d * R2; e += NT) Vc[e] = tof(vc[e]);
  for (int e = tid; e < R * R; e += NT) Wr[e] = tof(wr[e]);

  uint4 pre[PCH + CCH];
  auto fetch = [&](int tile) {
    const int b = tile / tpr, t0 = (tile - b * tpr) * TR;
    const size_t base = (size_t)b * Tw;
#pragma unroll
    for (int i = 0; i < PCH; ++i) {
      const int e = tid + i * NT, row = e % TR, kc = (e / TR) * EP;
      const int t = t0 + row;
      const bool ok = t < Tw && (kc >= R || t >= dil);
      pre[i] = ok ? *reinterpret_cast<const uint4*>(
                        hin + (base + t - (kc < R ? dil : 0)) * R + kc % R)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < CCH; ++i) {
      const int e = tid + i * NT, row = e % TR, kc = (e / TR) * EP;
      const int t = t0 + row, tg = WIN ? t_off + t : t;
      const bool ok = kc < d && t < Tw && tg >= 0;
      pre[PCH + i] =
          ok ? *reinterpret_cast<const uint4*>(
                   cond + ((size_t)b * (WIN ? Tg : Tw) + tg) * d + kc)
             : make_uint4(0, 0, 0, 0);
    }
  };
  // the fetched rows into Ph / Cs, transposed, as float32
  auto put = [&]() {
#pragma unroll
    for (int i = 0; i < PCH + CCH; ++i) {
      const int e = tid + (i < PCH ? i : i - PCH) * NT;
      const int row = e % TR, kc = (e / TR) * EP;
      if (i >= PCH && kc >= d) continue;
      float* dst = (i < PCH ? Ph : Cs) + kc * TR + row;
      const uint32_t w[4] = {pre[i].x, pre[i].y, pre[i].z, pre[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (EP == 8) {
          dst[(2 * j) * TR] = __uint_as_float(w[j] << 16);
          dst[(2 * j + 1) * TR] = __uint_as_float(w[j] & 0xffff0000u);
        } else {
          dst[j * TR] = __uint_as_float(w[j]);
        }
      }
    }
  };
  auto rows_at = [&](const float* X, float (&x)[RPT]) {
    if constexpr (RPT == 4) {
      const float4 v = *reinterpret_cast<const float4*>(X);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(X);
      x[0] = v.x;
      x[1] = v.y;
    }
  };

  if (blockIdx.x < ntiles) fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();   // the last tile's readers of Ph, Cs, Zs are done
    put();
    __syncthreads();
    if (tile + gridDim.x < ntiles) fetch(tile + gridDim.x);
    const int b = tile / tpr, t0 = (tile - b * tpr) * TR;
    const size_t base = (size_t)b * Tw;
    {
      // u = ph @ wff and v = cond @ vc, k-order float32 sums, then
      // (u + v) + gc as the plain version adds them
      float ua[RPT][4], ub[RPT][4], va[RPT][4], vb[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ua[i][j] = ub[i][j] = va[i][j] = vb[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < R2; ++k) {
        float x[RPT];
        rows_at(Ph + k * TR + r0, x);
        const float4 wa = *reinterpret_cast<const float4*>(Wff + k * R2 + c0);
        const float4 wb =
            *reinterpret_cast<const float4*>(Wff + k * R2 + R + c0);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          ua[i][0] = fmaf(x[i], wa.x, ua[i][0]);
          ua[i][1] = fmaf(x[i], wa.y, ua[i][1]);
          ua[i][2] = fmaf(x[i], wa.z, ua[i][2]);
          ua[i][3] = fmaf(x[i], wa.w, ua[i][3]);
          ub[i][0] = fmaf(x[i], wb.x, ub[i][0]);
          ub[i][1] = fmaf(x[i], wb.y, ub[i][1]);
          ub[i][2] = fmaf(x[i], wb.z, ub[i][2]);
          ub[i][3] = fmaf(x[i], wb.w, ub[i][3]);
        }
      }
#pragma unroll 4
      for (int k = 0; k < d; ++k) {
        float x[RPT];
        rows_at(Cs + k * TR + r0, x);
        const float4 wa = *reinterpret_cast<const float4*>(Vc + k * R2 + c0);
        const float4 wb = *reinterpret_cast<const float4*>(Vc + k * R2 + R + c0);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          va[i][0] = fmaf(x[i], wa.x, va[i][0]);
          va[i][1] = fmaf(x[i], wa.y, va[i][1]);
          va[i][2] = fmaf(x[i], wa.z, va[i][2]);
          va[i][3] = fmaf(x[i], wa.w, va[i][3]);
          vb[i][0] = fmaf(x[i], wb.x, vb[i][0]);
          vb[i][1] = fmaf(x[i], wb.y, vb[i][1]);
          vb[i][2] = fmaf(x[i], wb.z, vb[i][2]);
          vb[i][3] = fmaf(x[i], wb.w, vb[i][3]);
        }
      }
      const T* gcl = gc + ((size_t)b * nl + li) * R2;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i, t = t0 + r;
        float ta[4], sb[4], z[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const float xa = __fadd_rn(ua[i][j], va[i][j]) + tof(gcl[c]);
          const float xb = __fadd_rn(ub[i][j], vb[i][j]) + tof(gcl[c + R]);
          ta[j] = tanhf(xa);
          sb[j] = 1.f / (1.f + expf(-xb));
          z[j] = rnd<T>(ta[j] * sb[j]);
          Zs[r * LZ + c] = z[j];
        }
        if (t >= Tw) continue;
        if (gall != nullptr && (!WIN || t >= goff)) {
          T* g = gall + (WIN ? (((size_t)b * nl + li) * gTn + t - goff) * R2
                             : (((size_t)b * nl + li) * Tw + t) * R2);
          store4(g + c0, ta[0], ta[1], ta[2], ta[3]);
          store4(g + R + c0, sb[0], sb[1], sb[2], sb[3]);
        }
        if constexpr (FWD)
          store4(zout + (base + t) * R + c0, z[0], z[1], z[2], z[3]);
      }
    }
    if (FWD || hout != nullptr) {
      __syncthreads();
      // h = (h + cdt(z @ wr)) + br, z @ wr a k-order float32 sum
      float rs[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) rs[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < R; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(Wr + k * R + c0);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float x = Zs[(r0 + i) * LZ + k];
          rs[i][0] = fmaf(x, w.x, rs[i][0]);
          rs[i][1] = fmaf(x, w.y, rs[i][1]);
          rs[i][2] = fmaf(x, w.z, rs[i][2]);
          rs[i][3] = fmaf(x, w.w, rs[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i, t = t0 + r;
        if (t >= Tw) continue;
        float h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          h[j] = rnd<T>(Ph[(R + c) * TR + r] + rnd<T>(rs[i][j]));
          h[j] = rnd<T>(h[j] + tof(br[c]));
          if (WIN && mask && t_off + t < 0) h[j] = 0.f;
        }
        store4(hout + (base + t) * R + c0, h[0], h[1], h[2], h[3]);
      }
    }
  }
}

// skips[row] = cdt(tail + z_0 @ ws_0 + z_1 @ ws_1 + ...) (float32), each
// layer's product summed apart and added in layer order; zall [nl, N, R]
// holds every layer's z.  tail is [N, S] (acc) or [S].  float32: scalar
// k-order products over tiles of TM rows.
template <typename T>
__global__ void skip_sum(int N, int R, int S, int nl, int acc,
                         const T* __restrict__ zall, const T* __restrict__ ws,
                         const T* __restrict__ tail, T* __restrict__ skips) {
  float* zs = smem;   // [TM][R]
  const int r0 = blockIdx.x * TM;
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;
  float s[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = r0 + rg + RG * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg + 32 * j;
      s[i][j] = (row < N && c < S)
                    ? tof(acc ? tail[(size_t)row * S + c] : tail[c]) : 0.f;
    }
  }
  for (int l = 0; l < nl; ++l) {
    __syncthreads();
    for (int e = tid; e < TM * R; e += NT) {
      const int row = r0 + e / R;
      zs[e] = row < N ? tof(zall[((size_t)l * N + row) * R + e % R]) : 0.f;
    }
    __syncthreads();
    float sk[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sk[i][j] = 0.f;
    mac<8>(sk, zs, R, ws + (size_t)l * R * S, S, R, S, rg, cg);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] += sk[i][j];
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = r0 + rg + RG * i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg + 32 * j;
      if (c < S) skips[(size_t)row * S + c] = fromf<T>(s[i][j]);
    }
  }
}

// The same for bf16 on the tensor cores.  Block b takes the column half
// b % 2 of S (S/2 rounded up to 16) and, persistently, tiles of TS = 128
// rows; every layer's slice of ws for its half stays in shared memory
// for the launch (~170 KB at R = 64, S = 256), so only the z tiles
// stream in (double-buffered: the next layer's loads while this one
// multiplies).  Warp w owns rows 16 w .. +16 of a tile, its running
// float32 sum in registers.  The two blocks of a tile run side by side,
// so the second read of its z mostly hits L2.
constexpr int TS = 128;

template <int JH>
__global__ void __launch_bounds__(NT, 1)
    skip_sum_tc(int N, int S, int nl, int acc, const bf16* __restrict__ zall,
                const bf16* __restrict__ ws, const bf16* __restrict__ tail,
                bf16* __restrict__ skips) {
  constexpr int R = 32 * JH, LZ = R + SP, NJS = 16;   // S/2 <= 8 * NJS
  const int half = (S + 31) / 32 * 16, LW = half + SP;
  const int n0 = (blockIdx.x & 1) * half, ncol = min(half, S - n0);
  bf16* sm = reinterpret_cast<bf16*>(smem);
  bf16* W = sm;                     // [nl * R][half + SP]
  bf16* Zb = sm + nl * R * LW;      // 2 x [TS][R + SP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int ntiles = (N + TS - 1) / TS;
  const int first = blockIdx.x >> 1, step = gridDim.x >> 1;
  const int wc = ncol / 8;
  for (int e = tid; e < nl * R * wc; e += NT) {
    const int k = e / wc, c = (e - k * wc) * 8;   // k = l R + row of ws_l
    async_copy16(W + k * LW + c, ws + (size_t)k * S + n0 + c, true);
  }

  auto load = [&](int tile, int l, int buf) {
    for (int e = tid; e < TS * (R / 8); e += NT) {
      const int r = e / (R / 8), c = (e % (R / 8)) * 8;
      const int row = tile * TS + r;
      async_copy16(Zb + buf * TS * LZ + r * LZ + c,
                   row < N ? zall + ((size_t)l * N + row) * R + c : zall,
                   row < N);
    }
  };
  auto live = [&](int j) { return j * 8 < ncol; };

  if (first < ntiles) load(first, 0, 0);
  async_commit();
  int buf = 0;
  for (int tile = first; tile < ntiles; tile += step) {
    float s[NJS][4];
#pragma unroll
    for (int j = 0; j < NJS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = tile * TS + warp * 16 + g + 8 * (q >> 1);
        const int c = n0 + 8 * j + 2 * cq + (q & 1);
        s[j][q] = (live(j) && row < N)
                      ? tof(acc ? tail[(size_t)row * S + c] : tail[c]) : 0.f;
      }
    for (int l = 0; l < nl; ++l, buf ^= 1) {
      const int nt = l + 1 < nl ? tile : tile + step;
      if (nt < ntiles) load(nt, l + 1 < nl ? l + 1 : 0, buf ^ 1);
      async_commit();
      async_wait<1>();
      __syncthreads();
      const bf16* Wl = W + l * R * LW;
      const bf16* Z = Zb + buf * TS * LZ + warp * 16 * LZ;
      float p[NJS][4];
      zero_acc(p);
#pragma unroll
      for (int k = 0; k < R; k += 16) {
        uint32_t a[4];
        ldsm_x4(a, Z + (lane & 15) * LZ + k + ((lane >> 4) << 3));
#pragma unroll
        for (int j = 0; j < NJS; j += 2) {
          if (!live(j)) continue;
          uint32_t bb[4];
          ldsm_x4_t(bb, Wl + (k + (lane & 15)) * LW + 8 * j +
                            ((lane >> 4) << 3));
          mma_bf16(p[j], a, bb[0], bb[1]);
          mma_bf16(p[j + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJS; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] += p[j][q];
      __syncthreads();   // buffer buf is free for the step after next
    }
#pragma unroll
    for (int j = 0; j < NJS; ++j) {
      if (!live(j)) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile * TS + warp * 16 + g + 8 * h;
        const int c = n0 + 8 * j + 2 * cq;
        if (row < N)
          *reinterpret_cast<uint32_t*>(skips + (size_t)row * S + c) =
              pack_bf16(s[j][2 * h], s[j][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Save-gates pass 1 (float32): the residual chain from the saved gates,
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

// The same for bf16, persistent over tiles of TR rows, every layer's wr
// staged in shared memory (as float32) once per block; z @ wr sums in k
// order, register-blocked as in fwd_layer, so hall equals the plain
// replay's bit for bit.  The gate halves of the next (tile, layer) step
// load while this one runs.
template <int JH>
__global__ void __launch_bounds__(NT, 1)
    bwd_replay_bf16(int B, int Tn, int d, int nl, int mu, int embed,
                  const bf16* __restrict__ h0, const int* __restrict__ ids,
                  const bf16* __restrict__ wemb,
                  const bf16* __restrict__ bemb, const bf16* __restrict__ wr,
                  const bf16* __restrict__ br, const bf16* __restrict__ gall,
                  const bf16* __restrict__ dhout, bf16* __restrict__ hall,
                  float* __restrict__ dh, float* __restrict__ dcond) {
  constexpr int R = 32 * JH, R2 = 2 * R, LH = R + SP, LG = R2 + SP;
  constexpr int CG = R / 4, RPT = TR * CG / NT;
  float* Wr = smem;                                   // [nl][R][R]
  float* Zt = Wr + nl * R * R;                        // [R][TR], k-major
  bf16* Hs = reinterpret_cast<bf16*>(Zt + R * TR);    // [TR][R + SP]
  bf16* Gb = Hs + TR * LH;                            // 2 x [TR][2R + SP]
  const int tid = threadIdx.x;
  const int c0 = (tid % CG) * 4, r0 = (tid / CG) * RPT;
  const int tpr = (Tn + TR - 1) / TR, ntiles = B * tpr;

  auto load = [&](int tile, int li, int buf) {
    const int b = tile / tpr, t0 = (tile - b * tpr) * TR;
    for (int e = tid; e < TR * (R2 / 8); e += NT) {
      const int r = e / (R2 / 8), c = (e % (R2 / 8)) * 8, t = t0 + r;
      const bool ok = t < Tn;
      async_copy16(Gb + buf * TR * LG + r * LG + c,
                   ok ? gall + (((size_t)b * nl + li) * Tn + t) * R2 + c
                      : gall, ok);
    }
  };

  if (blockIdx.x < ntiles) load(blockIdx.x, 0, 0);
  async_commit();
  for (int e = tid; e < nl * R * R; e += NT) Wr[e] = tof(wr[e]);
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpr, t0 = (tile - b * tpr) * TR;
    const size_t base = (size_t)b * Tn;
    for (int e = tid; e < TR * R; e += NT) {
      const int r = e / R, c = e % R, t = t0 + r;
      float v = 0.f;
      if (t < Tn) {
        const size_t row = base + t;
        if (embed) {
          const float w1 = tof(wemb[((size_t)mu + ids[row]) * R + c]);
          const float w0 =
              t > 0 ? tof(wemb[(size_t)ids[row - 1] * R + c]) : 0.f;
          v = rnd<bf16>((w1 + w0) + tof(bemb[c]));
        } else {
          v = tof(h0[row * R + c]);
        }
        dh[row * R + c] = tof(dhout[row * R + c]);
      }
      Hs[r * LH + c] = fromf<bf16>(v);
    }
    for (int e = tid; e < TR * d; e += NT) {
      const int t = t0 + e / d;
      if (t < Tn) dcond[(base + t) * d + e % d] = 0.f;
    }
    for (int li = 0; li < nl; ++li, buf ^= 1) {
      const int nt = li + 1 < nl ? tile : tile + gridDim.x;
      if (nt < ntiles) load(nt, li + 1 < nl ? li + 1 : 0, buf ^ 1);
      async_commit();
      async_wait<1>();
      __syncthreads();
      const bf16* G = Gb + buf * TR * LG;
      for (int e = tid; e < TR * (R / 8); e += NT) {
        const int r = e / (R / 8), c = (e % (R / 8)) * 8, t = t0 + r;
        if (t < Tn)
          *reinterpret_cast<uint4*>(
              hall + (((size_t)li * B + b) * Tn + t) * R + c) =
              *reinterpret_cast<const uint4*>(Hs + r * LH + c);
      }
      for (int e = tid; e < TR * R; e += NT) {
        const int r = e % TR, c = e / TR;
        Zt[c * TR + r] = rnd<bf16>(tof(G[r * LG + c]) * tof(G[r * LG + c + R]));
      }
      __syncthreads();
      // rs = z @ wr, a k-order float32 sum
      float rs[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) rs[i][j] = 0.f;
      const float* Wl = Wr + li * R * R;
#pragma unroll 4
      for (int k = 0; k < R; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(Wl + k * R + c0);
        float x[RPT];
        if constexpr (RPT == 4) {
          const float4 v = *reinterpret_cast<const float4*>(Zt + k * TR + r0);
          x[0] = v.x;
          x[1] = v.y;
          x[2] = v.z;
          x[3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(Zt + k * TR + r0);
          x[0] = v.x;
          x[1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          rs[i][0] = fmaf(x[i], w.x, rs[i][0]);
          rs[i][1] = fmaf(x[i], w.y, rs[i][1]);
          rs[i][2] = fmaf(x[i], w.z, rs[i][2]);
          rs[i][3] = fmaf(x[i], w.w, rs[i][3]);
        }
      }
      const bf16* brl = br + (size_t)li * R;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf16* hp = Hs + (r0 + i) * LH + c0 + j;
          const float h = rnd<bf16>(tof(*hp) + rnd<bf16>(rs[i][j]));
          *hp = fromf<bf16>(h + tof(brl[c0 + j]));
        }
      __syncthreads();
    }
  }
}

// Pass 2 (float32), the row-local part of layer li over Tn rows per
// batch row (the whole sequence, or one time window starting at time tw0
// of a sequence of Tg steps; dskips and dcond are indexed by time):
//   dz = dh @ wr^T + dskips @ ws^T
//   da = dz*sb*(1-ta^2), db = dz*ta*sb*(1-sb); du = [da|db]
//   dcond += du @ vc^T; dph = du @ wff^T
//   dh_new = dh + dph_b (dph_a is added, shifted, by shift_add)
// It also writes z = ta*sb and du for the weight gradients, and the
// column sums of du (dgc) and of dh (dbr) over its TM rows into pdgc
// [B][tpr][2R] and pdbr [B][tpr][R] (tpr = ceil(Tn / TM)).
__global__ void bwd_layer(int Tn, int Tg, int tw0, int R, int S, int d,
                          int nl, int li, const float* __restrict__ dh,
                          const float* __restrict__ dskips,
                          const float* __restrict__ gall,
                          const float* __restrict__ wrT,
                          const float* __restrict__ wsT,
                          const float* __restrict__ vcT,
                          const float* __restrict__ wffT,
                          float* __restrict__ zbuf, float* __restrict__ du,
                          float* __restrict__ dcond,
                          float* __restrict__ dh_new,
                          float* __restrict__ dpha, float* __restrict__ pdbr,
                          float* __restrict__ pdgc) {
  const int R2 = 2 * R;
  float* dhc = smem;                 // [TM][R]
  float* dsk = dhc + TM * R;         // [TM][S]
  float* dus = dsk + TM * S;         // [TM][2R]
  float* o1 = dus + TM * R2;         // [TM][R]
  float* o2 = o1 + TM * R;           // [TM][2R]
  float* o3 = o2 + TM * R2;          // [TM][d]
  const int b = blockIdx.y, t0 = blockIdx.x * TM, tid = threadIdx.x;
  const size_t part = (size_t)b * gridDim.x + blockIdx.x;
  const size_t base = (size_t)b * Tn;                // window rows
  const size_t gbase = (size_t)b * Tg + tw0;         // sequence rows
  for (int e = tid; e < TM * R; e += NT) {
    const int t = t0 + e / R;
    dhc[e] = t < Tn ? dh[(base + t) * R + e % R] : 0.f;
  }
  for (int e = tid; e < TM * S; e += NT) {
    const int t = t0 + e / S;
    dsk[e] = t < Tn ? dskips[(gbase + t) * S + e % S] : 0.f;
  }
  __syncthreads();
  tile_mm<2>(o1, R, dhc, R, wrT, R, R, R);      // dh @ wr^T
  tile_mm<2>(o2, R, dsk, S, wsT, R, S, R);      // dskips @ ws^T
  __syncthreads();
  for (int e = tid; e < TM * R; e += NT) {
    const int r = e / R, c = e % R, t = t0 + r;
    float da = 0.f, db = 0.f;
    if (t < Tn) {
      const float dz = __fadd_rn(o1[e], o2[e]);
      const size_t gi = (((size_t)b * nl + li) * Tn + t) * R2;
      const float ta = gall[gi + c], sb = gall[gi + c + R];
      da = dz * sb * (1.f - ta * ta);
      db = dz * ta * sb * (1.f - sb);
      const size_t row = base + t;
      du[row * R2 + c] = da;
      du[row * R2 + c + R] = db;
      zbuf[row * R + c] = ta * sb;
    }
    dus[r * R2 + c] = da;
    dus[r * R2 + c + R] = db;
  }
  __syncthreads();
  // the tile's column sums, rows in order (rows past Tn are 0)
  for (int c = tid; c < R2; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += dus[r * R2 + c];
    pdgc[part * R2 + c] = s;
  }
  for (int c = tid; c < R; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += dhc[r * R + c];
    pdbr[part * R + c] = s;
  }
  tile_mm<2>(o3, d, dus, R2, vcT, d, R2, d);      // du @ vc^T
  tile_mm<4>(o2, R2, dus, R2, wffT, R2, R2, R2);  // du @ wff^T
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

// Shared memory of bwd_layer_tc (bf16 element offsets; fl is float32
// scratch for the tile's column sums).
struct BwdSmem {
  int wr, ws, vc, wff, dsk, gt, dhc, zt, du, fl, total;
  __host__ __device__ BwdSmem(int R, int S, int d) {
    const int R2 = 2 * R;
    wr = 0;                          // wrT [R][R + SP]
    ws = wr + R * (R + SP);          // wsT [S][R + SP]
    vc = ws + S * (R + SP);          // vcT [2R][d + SP]
    wff = vc + R2 * (d + SP);        // wffT [2R][2R + SP]
    dsk = wff + R2 * (R2 + SP);      // 2 x [TR][S + SP]
    gt = dsk + 2 * TR * (S + SP);    // [TR][2R + SP]
    dhc = gt + TR * (R2 + SP);       // [TR][R + SP]
    zt = dhc + TR * (R + SP);        // [TR][R + SP]
    du = zt + TR * (R + SP);         // [TR][2R + SP]
    fl = du + TR * (R2 + SP);        // float32 [4 NT / R][R], [4][2R]
    total = fl + 2 * (4 * NT + 4 * R2);
  }
  size_t bytes() const { return (size_t)total * sizeof(bf16); }
};

// bwd_layer for bf16 on the tensor cores, persistent over the B *
// ceil(Tn / TR) tiles, the four transposed weights staged in shared
// memory once per block.  It writes du = cdt([da|db]), cdt(dh) (dhc)
// and z = cdt(ta*sb), the operands of the weight-gradient products, and
// the tile's float32 column sums of [da|db] and of dh into pdgc
// [B][tpr][2R] and pdbr [B][tpr][R] (tpr = ceil(Tn / TR)), each summed
// in a fixed order.  dh (float32) loads 16 bytes at a time; dskips of the
// next tile and the gate halves of this one arrive by cp.async; the
// epilogues' dcond and dh load into registers before the products.
// (Folding shift_add in here, as dh(t) + dph_a(t + dil) read in this
// prologue, slowed this kernel by more than the launch it saved, on an
// NVIDIA H100 80GB HBM3 at 700 W.)
template <int JH>
__global__ void __launch_bounds__(NT, 1)
    bwd_layer_tc(int B, int Tn, int Tg, int tw0, int S, int d, int nl,
                 int li, const float* __restrict__ dh,
                 const bf16* __restrict__ dskips,
                 const bf16* __restrict__ gall, const bf16* __restrict__ wrT,
                 const bf16* __restrict__ wsT, const bf16* __restrict__ vcT,
                 const bf16* __restrict__ wffT, bf16* __restrict__ zbuf,
                 bf16* __restrict__ du, bf16* __restrict__ dhc,
                 float* __restrict__ dcond, float* __restrict__ dh_new,
                 float* __restrict__ dpha, float* __restrict__ pdbr,
                 float* __restrict__ pdgc) {
  constexpr int R = 32 * JH, R2 = 2 * R, NJ = R / 16;
  constexpr int LZ = R + SP, LG = R2 + SP;
  constexpr int Q4 = R / 4, RS = NT / Q4;   // dh: float4 per row, row step
  const int LS = S + SP, LC = d + SP;
  const BwdSmem L(R, S, d);
  bf16* sm = reinterpret_cast<bf16*>(smem);
  bf16* WrT = sm + L.wr;
  bf16* WsT = sm + L.ws;
  bf16* VcT = sm + L.vc;
  bf16* WffT = sm + L.wff;
  bf16* Gt = sm + L.gt;
  bf16* Dhc = sm + L.dhc;
  bf16* Zt = sm + L.zt;
  bf16* Du = sm + L.du;
  float* Fr = reinterpret_cast<float*>(sm + L.fl);   // [RS][R]
  float* Fg = Fr + RS * R;                            // [4][2R]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, cq = lane & 3;
  const int ca = wn * (R / 2);
  const int tpr = (Tn + TR - 1) / TR, ntiles = B * tpr;
  stage_rows(WrT, wrT, R, R, R, NT);
  stage_rows(WsT, wsT, S, R, R, NT);
  stage_rows(VcT, vcT, R2, d, d, NT);
  stage_rows(WffT, wffT, R2, R2, R2, NT);

  auto load_dsk = [&](int tile, int buf) {
    const int b = tile / tpr, t0 = (tile - b * tpr) * TR;
    const int sc = S / 8;
    for (int e = tid; e < TR * sc; e += NT) {
      const int r = e / sc, c = (e - r * sc) * 8, t = t0 + r;
      const bool ok = t < Tn;
      async_copy16(sm + L.dsk + buf * TR * LS + r * LS + c,
                   ok ? dskips + ((size_t)b * Tg + tw0 + t) * S + c : dskips,
                   ok);
    }
  };

  if (blockIdx.x < ntiles) load_dsk(blockIdx.x, 0);
  async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int b = tile / tpr, t0 = (tile - b * tpr) * TR;
    const size_t base = (size_t)b * Tn;               // window rows
    const size_t gbase = (size_t)b * Tg + tw0;        // sequence rows
    for (int e = tid; e < TR * (R2 / 8); e += NT) {
      const int r = e / (R2 / 8), c = (e % (R2 / 8)) * 8, t = t0 + r;
      const bool ok = t < Tn;
      async_copy16(Gt + r * LG + c,
                   ok ? gall + (((size_t)b * nl + li) * Tn + t) * R2 + c
                      : gall, ok);
    }
    async_commit();
    if (tile + gridDim.x < ntiles) load_dsk(tile + gridDim.x, buf ^ 1);
    async_commit();
    // this thread's dcond and (warps wn = 1) dh for the epilogues, read
    // now so that the loads overlap the products
    float2 dcv[2][2][2], dhv[2 * NJ][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + wm * 16 + g + 8 * h;
          const int c = wn * 16 + 32 * i + 8 * j + 2 * cq;
          dcv[i][j][h] = (t < Tn && wn * 16 + 32 * i < d)
              ? *reinterpret_cast<const float2*>(dcond + (gbase + t) * d + c)
              : make_float2(0.f, 0.f);
        }
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wm * 16 + g + 8 * h;
        dhv[j][h] = (wn == 1 && t < Tn)
            ? *reinterpret_cast<const float2*>(dh + (base + t) * R + 8 * j +
                                               2 * cq)
            : make_float2(0.f, 0.f);
      }
    {
      // dh -> cdt(dh) in Dhc, and this thread's column sums of dh
      const int c4 = (tid % Q4) * 4, r0 = tid / Q4;
      float cs[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = r0; r < TR; r += RS) {
        const int t = t0 + r;
        const float4 v =
            t < Tn ? *reinterpret_cast<const float4*>(dh + (base + t) * R + c4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        cs[0] += v.x;
        cs[1] += v.y;
        cs[2] += v.z;
        cs[3] += v.w;
        *reinterpret_cast<uint2*>(Dhc + r * LZ + c4) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) Fr[r0 * R + c4 + i] = cs[i];
    }
    async_wait<1>();   // all but the next tile's dskips
    __syncthreads();
    if (tid < R) {
      float s = 0.f;
      for (int i = 0; i < RS; ++i) s += Fr[i * R + tid];
      pdbr[(size_t)tile * R + tid] = s;
    }
    const bf16* Dsk = sm + L.dsk + buf * TR * LS;
    {
      // dz = cdt(dh) @ wr^T + dskips @ ws^T, then the gate's chain
      float o1[NJ][4], o2[NJ][4];
      zero_acc(o1);
      zero_acc(o2);
      warp_mm(o1, Dhc + wm * 16 * LZ, LZ, WrT, LZ, R, ca);
      warp_mm(o2, Dsk + wm * 16 * LS, LS, WsT, LZ, S, ca);
      float sa[NJ][2], sbs[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = wm * 16 + g + 8 * (q >> 1);
          const int c = ca + 8 * j + 2 * cq + (q & 1);
          float da = 0.f, db = 0.f, z = 0.f;
          if (t0 + r < Tn) {
            const float dz = __fadd_rn(o1[j][q], o2[j][q]);
            const float ta = tof(Gt[r * LG + c]), sb = tof(Gt[r * LG + c + R]);
            da = dz * sb * (1.f - ta * ta);
            db = dz * ta * sb * (1.f - sb);
            z = ta * sb;
          }
          Du[r * LG + c] = fromf<bf16>(da);
          Du[r * LG + c + R] = fromf<bf16>(db);
          Zt[r * LZ + c] = fromf<bf16>(z);
          if (q < 2) {
            sa[j][q] = da;
            sbs[j][q] = db;
          } else {
            sa[j][q - 2] += da;
            sbs[j][q - 2] += db;
          }
        }
      // column sums over the warp's 16 rows: lanes of equal l % 4
#pragma unroll
      for (int m = 4; m < 32; m <<= 1)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sa[j][h] += __shfl_xor_sync(0xffffffffu, sa[j][h], m);
            sbs[j][h] += __shfl_xor_sync(0xffffffffu, sbs[j][h], m);
          }
      if (g == 0)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = ca + 8 * j + 2 * cq + h;
            Fg[wm * R2 + c] = sa[j][h];
            Fg[wm * R2 + c + R] = sbs[j][h];
          }
    }
    __syncthreads();
    if (tid < R2)
      pdgc[(size_t)tile * R2 + tid] =
          ((Fg[tid] + Fg[R2 + tid]) + Fg[2 * R2 + tid]) + Fg[3 * R2 + tid];
    for (int e = tid; e < TR * (R2 / 8); e += NT) {
      const int r = e / (R2 / 8), c = (e % (R2 / 8)) * 8, t = t0 + r;
      if (t < Tn)
        *reinterpret_cast<uint4*>(du + (base + t) * R2 + c) =
            *reinterpret_cast<const uint4*>(Du + r * LG + c);
    }
    for (int e = tid; e < TR * (R / 8); e += NT) {
      const int r = e / (R / 8), c = (e % (R / 8)) * 8, t = t0 + r;
      if (t >= Tn) continue;
      *reinterpret_cast<uint4*>(zbuf + (base + t) * R + c) =
          *reinterpret_cast<const uint4*>(Zt + r * LZ + c);
      *reinterpret_cast<uint4*>(dhc + (base + t) * R + c) =
          *reinterpret_cast<const uint4*>(Dhc + r * LZ + c);
    }
    // dcond += du @ vc^T (d <= 64: two 32-column steps)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n0 = wn * 16 + 32 * i;
      if (n0 >= d) continue;
      float o3[2][4];
      zero_acc(o3);
      warp_mm(o3, Du + wm * 16 * LG, LG, VcT, LC, R2, n0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + wm * 16 + g + 8 * h;
          if (t >= Tn) continue;
          *reinterpret_cast<float2*>(dcond + (gbase + t) * d + n0 + 8 * j +
                                     2 * cq) =
              make_float2(dcv[i][j][h].x + o3[j][2 * h],
                          dcv[i][j][h].y + o3[j][2 * h + 1]);
        }
    }
    {
      // dph = du @ wff^T: warps wn = 0 take dph_a, wn = 1 dph_b
      float o4[2 * NJ][4];
      zero_acc(o4);
      warp_mm(o4, Du + wm * 16 * LG, LG, WffT, LG, R2, wn * R);
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + wm * 16 + g + 8 * h;
          if (t >= Tn) continue;
          const size_t o = (base + t) * R + 8 * j + 2 * cq;
          if (wn == 0) {
            *reinterpret_cast<float2*>(dpha + o) =
                make_float2(o4[j][2 * h], o4[j][2 * h + 1]);
          } else {
            *reinterpret_cast<float2*>(dh_new + o) =
                make_float2(dhv[j][h].x + o4[j][2 * h],
                            dhv[j][h].y + o4[j][2 * h + 1]);
          }
        }
    }
    __syncthreads();   // the tile's buffers are free
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

// The embedding-table gradient, part p of P (a contiguous run of rows):
// part[((tap*mu + v)*P + p)*R + c] = sum of cdt(dh[row, c]) over its rows
// whose key is v: key = ids[row] (tap 1) or ids[row-1] (tap 0, none at
// t = 0).  The block's table [2][mu][R] (float32) lives in shared memory;
// warp w takes tap w % 2 and columns 32 (w / 2) .. +32, one per lane, and
// walks the rows in order, so each table entry has one owner and one sum
// order (no atomics).  2R threads.
template <typename T>
__global__ void embed_grad_part(int N, int Tn, int R, int mu,
                                const int* __restrict__ ids,
                                const float* __restrict__ dh,
                                float* __restrict__ part) {
  constexpr int U = 16;   // rows in flight per lane
  float* tab = smem;
  const int P = gridDim.x, p = blockIdx.x, nth = blockDim.x;
  const int chunk = (N + P - 1) / P;
  const int r0 = p * chunk, r1 = min(N, r0 + chunk);
  for (int e = threadIdx.x; e < 2 * mu * R; e += nth) tab[e] = 0.f;
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tap = w & 1, c = (w >> 1) * 32 + lane;
  float* tt = tab + (size_t)tap * mu * R;
  for (int r = r0; r < r1; r += U) {
    int key[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u;
      key[u] = -1;
      v[u] = 0.f;
      if (rr < r1) {
        key[u] = tap ? ids[rr] : ((rr % Tn) > 0 ? ids[rr - 1] : -1);
        v[u] = rnd<T>(dh[(size_t)rr * R + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (key[u] >= 0) tt[key[u] * R + c] += v[u];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * mu * R; e += nth) {
    const int tp = e / (mu * R), v = (e / R) % mu;
    part[(((size_t)tp * mu + v) * P + p) * R + e % R] = tab[e];
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

// blocks of a persistent kernel over ntiles tiles: as many as the card
// runs at once (at least one), none idle
template <typename K>
int persistent_grid(K kernel, int ntiles, size_t sm) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                    sm) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  return std::max(1, std::min(ntiles, num_sms() * per_sm));
}

// One forward layer (FWD: z to zout) or recompute layer over Tw rows per
// batch row; see fwd_layer.
template <typename T, bool FWD>
int run_layer(int B, int Tw, int Tg, int t_off, int goff, int gTn, int mask,
              int R, int d, int dil, int li, int nl, const T* hin,
              const T* cond, const T* gc, const T* wff, const T* vc,
              const T* wr, const T* br, T* zout, T* hout, T* gall,
              cudaStream_t st) {
  const bool win = Tw != Tg || t_off != 0 || goff != 0 || gTn != Tw || mask;
  const size_t sm = FwdSmem(R, d).bytes();
  auto kern = R == 32
      ? (win ? fwd_layer<T, 1, true, FWD> : fwd_layer<T, 1, false, FWD>)
      : (win ? fwd_layer<T, 2, true, FWD> : fwd_layer<T, 2, false, FWD>);
  VQT_TRY_CUDA(smem_opt_in(kern, sm));
  const int grid = persistent_grid(kern, B * cdiv(Tw, TR), sm);
  KLAUNCH(kern, grid, NT, sm, st, B, Tw, Tg, t_off, d, dil, li, nl, goff, gTn,
          mask, hin, cond, gc, wff, vc, wr, br, zout, hout, gall);
  return (int)last_error();
}

// skips = cdt(tail + sum_l zall[l] @ ws[l]) over N rows
template <typename T>
int run_skip_sum(int N, int R, int S, int nl, int acc, const T* zall,
                 const T* ws, const T* tail, T* skips, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int half = (S + 31) / 32 * 16;
    const size_t sm =
        (size_t)(nl * R * (half + SP) + 2 * TS * (R + SP)) * sizeof(bf16);
    auto kern = R == 32 ? skip_sum_tc<1> : skip_sum_tc<2>;
    VQT_TRY_CUDA(smem_opt_in(kern, sm));
    // two blocks (the column halves) for each stream of tiles
    const int grid =
        2 * std::max(1, persistent_grid(kern, 2 * cdiv(N, TS), sm) / 2);
    KLAUNCH(kern, grid, NT, sm, st, N, S, nl, acc, zall, ws, tail, skips);
  } else {
    auto kern = skip_sum<T>;
    KLAUNCH(kern, cdiv(N, TM), NT, (size_t)TM * R * sizeof(float), st, N, R,
            S, nl, acc, zall, ws, tail, skips);
  }
  return (int)last_error();
}

template <typename T>
int chunk_fwd(int mode, int B, int Tn, int R, int S, int d, int mu, int nl,
              const int* dils, const void* h, const int* ids,
              const void* wemb, const void* bemb, const void* cond,
              const void* gc, const void* wff, const void* vc, const void* wr,
              const void* br, const void* ws, const void* tail, void* hbuf0,
              void* hbuf1, void* zall, void* h_out, void* skips_out,
              void* gall, cudaStream_t st) {
  const int N = B * Tn, R2 = 2 * R;
  const T* h0 = (const T*)h;
  if (mode == 2) {   // embed
    KLAUNCH(embed_fwd<T>, cdiv((long long)N * R, NT), NT, 0, st, N, Tn, R,
            mu, ids, (const T*)wemb, (const T*)bemb, (T*)hbuf1);
    VQT_TRY(last_error());
    h0 = (const T*)hbuf1;
  }
  T* bufs[2] = {(T*)hbuf0, (T*)hbuf1};
  for (int li = 0; li < nl; ++li) {
    const T* hin = li == 0 ? h0 : bufs[(li - 1) & 1];
    T* hout = li == nl - 1 ? (T*)h_out : bufs[li & 1];
    VQT_TRY((run_layer<T, true>(
        B, Tn, Tn, 0, 0, Tn, 0, R, d, dils[li], li, nl, hin, (const T*)cond,
        (const T*)gc, (const T*)wff + (size_t)li * R2 * R2,
        (const T*)vc + (size_t)li * d * R2, (const T*)wr + (size_t)li * R * R,
        (const T*)br + (size_t)li * R, (T*)zall + (size_t)li * N * R, hout,
        (T*)gall, st)));
  }
  return run_skip_sum<T>(N, R, S, nl, mode == 1, (const T*)zall,
                         (const T*)ws, (const T*)tail, (T*)skips_out, st);
}

// Recompute pass 1 over Tw rows per batch row (row t = time t_off + t of
// a sequence of Tg steps): hall[0] holds the chunk input; each layer's
// launch writes the next layer's input into hall[li + 1] and the gate
// halves of rows t >= goff into gall [B, nl, gTn, 2R].
template <typename T>
int recompute(int B, int Tw, int Tg, int t_off, int goff, int gTn, int mask,
              int R, int d, int nl, const int* dils, const void* cond,
              const void* gc, const void* wff, const void* vc,
              const void* wr, const void* br, void* hall, void* gall,
              cudaStream_t st) {
  const int R2 = 2 * R;
  const size_t layer = (size_t)B * Tw * R;
  for (int li = 0; li < nl; ++li) {
    const T* hin = (const T*)hall + li * layer;
    T* hout = li + 1 < nl ? (T*)hall + (li + 1) * layer : nullptr;
    VQT_TRY((run_layer<T, false>(
        B, Tw, Tg, t_off, goff, gTn, mask, R, d, dils[li], li, nl, hin,
        (const T*)cond, (const T*)gc, (const T*)wff + (size_t)li * R2 * R2,
        (const T*)vc + (size_t)li * d * R2, (const T*)wr + (size_t)li * R * R,
        (const T*)br + (size_t)li * R, (T*)nullptr, hout, (T*)gall, st)));
  }
  return 0;
}

// Pass 2 over Tn rows per batch row (time tw0 on, of a sequence of Tg
// steps): hall [nl, B, Wh, R] holds each layer's input, the window's
// rows at offset hoff; dh starts in dh0 and ends in *dh_final.  du
// [B*Tn, 2R] and dhc [B*Tn, R] (bf16 only) are the compute-dtype scratch
// of the weight-gradient products.  With accumulate the weight gradients
// and dgc are added to (a window after the first); with spill the causal
// shift crosses into the window to the right (see shift_add).
template <typename T>
int sweep(int B, int Tn, int Tg, int tw0, int Wh, int hoff, int R, int S,
          int d, int nl, const int* dils, const void* hall, const void* cond,
          const void* gall, const void* dskips, const void* wffT,
          const void* vcT, const void* wrT, const void* wsT, float* dh0,
          float* dh1, float* dpha, float* dcond, void* zbuf, void* du,
          void* dhc, float* part, long long part_cap, float* spill, int Dmax,
          int accumulate, float* dgc, float* dwff, float* dvc, float* dwr,
          float* dbr, float* dws, float** dh_final, cudaStream_t st) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  const int N = B * Tn, R2 = 2 * R;
  const int tpr = cdiv(Tn, tc ? TR : TM), ntiles = B * tpr;
  // the tiles' column sums, then the per-batch-row sums of dbr
  float* pdbr = part;
  float* pdgc = pdbr + (size_t)ntiles * R;
  float* bdbr = pdgc + (size_t)ntiles * R2;
  if ((long long)ntiles * (R + R2) + (long long)B * R > part_cap) return -1;
  const RowMap hmap{Tn, Wh, hoff, Tn, 0};    // hall rows of the window
  const RowMap cmap{Tn, Tg, tw0, Tn, 0};     // cond rows of the window
  const RowMap smap{Tn, Tn, 0, Tg, tw0};     // dskips rows of the window
  size_t sm;
  int grid = 0;
  if constexpr (tc) {
    sm = BwdSmem(R, S, d).bytes();
    auto kern = R == 32 ? bwd_layer_tc<1> : bwd_layer_tc<2>;
    VQT_TRY_CUDA(smem_opt_in(kern, sm));
    grid = persistent_grid(kern, ntiles, sm);
  } else {
    sm = (size_t)TM * (R + S + R2 + R + R2 + d) * sizeof(float);
    VQT_TRY_CUDA(smem_opt_in(bwd_layer, sm));
  }
  float* dcur = dh0;
  float* dnext = dh1;
  for (int li = nl - 1; li >= 0; --li) {
    const int dil = dils[li];
    const T* hin = (const T*)hall + (size_t)li * B * Wh * R;
    float* spill_l = spill ? spill + (size_t)li * B * Dmax * R : nullptr;
    const T* wr_l = (const T*)wrT + (size_t)li * R * R;
    const T* ws_l = (const T*)wsT + (size_t)li * S * R;
    const T* vc_l = (const T*)vcT + (size_t)li * R2 * d;
    const T* wff_l = (const T*)wffT + (size_t)li * R2 * R2;
    if constexpr (tc) {
      auto kern = R == 32 ? bwd_layer_tc<1> : bwd_layer_tc<2>;
      KLAUNCH(kern, grid, NT, sm, st, B, Tn, Tg, tw0, S, d, nl, li, dcur,
              (const T*)dskips, (const T*)gall, wr_l, ws_l, vc_l, wff_l,
              (T*)zbuf, (T*)du, (T*)dhc, dcond, dnext, dpha, pdbr, pdgc);
    } else {
      KLAUNCH(bwd_layer, dim3(tpr, B), NT, sm, st, Tn, Tg, tw0, R, S, d, nl,
              li, dcur, (const float*)dskips, (const float*)gall, wr_l, ws_l,
              vc_l, wff_l, (float*)zbuf, (float*)du, dcond, dnext, dpha, pdbr,
              pdgc);
    }
    VQT_TRY(last_error());
    KLAUNCH(shift_add, cdiv((long long)N * R, NT), NT, 0, st, N, Tn, R, dil,
            dpha, spill_l, Dmax, dnext);
    VQT_TRY(last_error());
    if (spill_l != nullptr) {
      KLAUNCH(spill_save, cdiv((long long)B * dil * R, NT), NT, 0, st, B, Tn,
              R, dil, Dmax, dpha, spill_l);
      VQT_TRY(last_error());
    }
    // dgc and dbr: the tiles' sums of each batch row, in order
    KLAUNCH(seg_reduce, B, NT, 0, st, tpr, R2, pdgc, dgc + (size_t)li * R2,
            nl * R2, accumulate);
    VQT_TRY(last_error());
    KLAUNCH(seg_reduce, B, NT, 0, st, tpr, R, pdbr, bdbr, R, 0);
    VQT_TRY(last_error());
    KLAUNCH(seg_reduce, 1, NT, 0, st, B, R, bdbr, dbr + (size_t)li * R, R,
            accumulate);
    VQT_TRY(last_error());
    // dwr = z^T cdt(dh): the bf16 scratch, or float32 dh itself
    if constexpr (tc)
      VQT_TRY((atb<T, T, T>(N, Tn, (const T*)zbuf, R, R, 0, 0,
                            (const T*)dhc, R, R, dwr + (size_t)li * R * R,
                            part, part_cap, st, accumulate)));
    else
      VQT_TRY((atb<T, float, T>(N, Tn, (const T*)zbuf, R, R, 0, 0, dcur, R,
                                R, dwr + (size_t)li * R * R, part, part_cap,
                                st, accumulate)));
    VQT_TRY((atb<T, T, T>(N, Tn, (const T*)zbuf, R, R, 0, 0,
                          (const T*)dskips, S, S, dws + (size_t)li * R * S,
                          part, part_cap, st, accumulate, smap)));
    float* dwff_l = dwff + (size_t)li * R2 * R2;
    VQT_TRY((atb<T, T, T>(N, Tn, hin, R, R, dil, 0, (const T*)du, R2, R2,
                          dwff_l, part, part_cap, st, accumulate, hmap)));
    VQT_TRY((atb<T, T, T>(N, Tn, hin, R, R, 0, 0, (const T*)du, R2, R2,
                          dwff_l + (size_t)R * R2, part, part_cap, st,
                          accumulate, hmap)));
    VQT_TRY((atb<T, T, T>(N, Tn, (const T*)cond, d, d, 0, 0, (const T*)du,
                          R2, R2, dvc + (size_t)li * d * R2, part, part_cap,
                          st, accumulate, cmap)));
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
  const size_t sm = (size_t)2 * mu * R * sizeof(float);
  if (sm > 232448) return -2;
  const int P = (int)std::min<long long>(std::min(num_sms(), cdiv(N, 256)),
                                         part_cap / (2LL * mu * R));
  if (P < 1) return -1;
  auto kern = embed_grad_part<T>;
  VQT_TRY_CUDA(smem_opt_in(kern, sm));
  KLAUNCH(kern, P, 2 * R, sm, st, N, Tn, R, mu, ids, dh, part);
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
              void* zbuf, void* du, void* dhc, float* part,
              long long part_cap, float* dgc, float* dwff, float* dvc,
              float* dwr, float* dbr, float* dws, float* dwemb, float* dbemb,
              cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t sm = (size_t)(nl * R * R + R * TR) * sizeof(float) +
                      (size_t)(TR * (R + SP) + 2 * TR * (2 * R + SP)) *
                          sizeof(bf16);
    auto kern = R == 32 ? bwd_replay_bf16<1> : bwd_replay_bf16<2>;
    VQT_TRY_CUDA(smem_opt_in(kern, sm));
    const int grid = persistent_grid(kern, B * cdiv(Tn, TR), sm);
    KLAUNCH(kern, grid, NT, sm, st, B, Tn, d, nl, mu, embed, (const T*)h0,
            ids, (const T*)wemb, (const T*)bemb, (const T*)wr, (const T*)br,
            (const T*)gall, (const T*)dhout, (T*)hall, dh0, dcond);
  } else {
    const size_t sm = (size_t)TM * 2 * R * sizeof(float);
    auto kern = R == 32 ? bwd_replay<T, 1> : bwd_replay<T, 2>;
    VQT_TRY_CUDA(smem_opt_in(kern, sm));
    KLAUNCH(kern, dim3(cdiv(Tn, TM), B), NT, sm, st, B, Tn, R, d, nl, mu,
            embed, (const T*)h0, ids, (const T*)wemb, (const T*)bemb,
            (const T*)wr, (const T*)br, (const T*)gall, (const T*)dhout,
            (T*)hall, dh0, dcond);
  }
  VQT_TRY(last_error());
  float* dfin = nullptr;
  VQT_TRY(sweep<T>(B, Tn, Tn, 0, Tn, 0, R, S, d, nl, dils, hall, cond, gall,
                   dskips, wffT, vcT, wrT, wsT, dh0, dh1, dpha, dcond, zbuf,
                   du, dhc, part, part_cap, nullptr, 0, 0, dgc, dwff, dvc,
                   dwr, dbr, dws, &dfin, st));
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
                  float* dcond, void* zbuf, void* du, void* dhc, float* part,
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
  VQT_TRY(recompute<T>(B, Tn, Tn, 0, 0, Tn, 0, R, d, nl, dils, cond, gc,
                       wff, vc, wr, br, hall, gall, st));
  VQT_TRY((launch_copy<T, float>(B, Tn, R, (const T*)dhout, Tn, 0, dh0, Tn,
                                 0, st)));
  VQT_TRY(cudaMemsetAsync(dcond, 0, (size_t)N * d * sizeof(float), st));
  float* dfin = nullptr;
  VQT_TRY(sweep<T>(B, Tn, Tn, 0, Tn, 0, R, S, d, nl, dils, hall, cond, gall,
                   dskips, wffT, vcT, wrT, wsT, dh0, dh1, dpha, dcond, zbuf,
                   du, dhc, part, part_cap, nullptr, 0, 0, dgc, dwff, dvc,
                   dwr, dbr, dws, &dfin, st));
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
                  float* dpha, void* zbuf, void* du, void* dhc, float* part,
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
    VQT_TRY(recompute<T>(B, W, Tn, tw0 - A, A, Tc, 1, R, d, nl, dils, cond,
                         gc, wff, vc, wr, br, hall, gall, st));
    VQT_TRY((launch_copy<T, float>(B, Tc, R, (const T*)dhout, Tn, tw0, dh0,
                                   Tc, 0, st)));
    float* dfin = nullptr;
    VQT_TRY(sweep<T>(B, Tc, Tn, tw0, W, A, R, S, d, nl, dils, hall, cond,
                     gall, dskips, wffT, vcT, wrT, wsT, dh0, dh1, dpha, dcond,
                     zbuf, du, dhc, part, part_cap, spill, Dmax, j > 0, dgc,
                     dwff, dvc, dwr, dbr, dws, &dfin, st));
    VQT_TRY((launch_copy<float, float>(B, Tc, R, dfin, Tc, 0, dh, Tn, tw0,
                                       st)));
  }
  return 0;
}

bool bad_widths(int cdtype, int R, int S, int d, int nl) {
  if (R % 32 || R > 64 || S > 256 || d > 64 || nl < 1) return true;
  return cdtype == 1 && (S % 16 || d % 16);   // 16-column fragments
}

}  // namespace

extern "C" {

// mode: 0 = seed the skip sum from the bias row tail [S], 1 = from the
// running skips tail [B, T, S] (acc), 2 = embed the ids (seeded from
// tail [S]).  cdtype: 0 float32, 1 bfloat16.  zall [nl, B, T, R] (cdt)
// is scratch: every layer's z, for the skip sum.  gall [B, nl, T, 2R]
// may be null (the recompute path saves no gates).  Returns 0 or an
// error.
int vqvae_chunk_fwd(int cdtype, int mode, int B, int Tn, int R, int S, int d,
                    int mu, int nl, const int* dils, const void* h,
                    const int* ids, const void* wemb, const void* bemb,
                    const void* cond, const void* gc, const void* wff,
                    const void* vc, const void* wr, const void* br,
                    const void* ws, const void* tail, void* hbuf0,
                    void* hbuf1, void* zall, void* h_out, void* skips_out,
                    void* gall, void* stream) {
  if (bad_widths(cdtype, R, S, d, nl)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_fwd<float>(mode, B, Tn, R, S, d, mu, nl, dils, h, ids, wemb,
                            bemb, cond, gc, wff, vc, wr, br, ws, tail, hbuf0,
                            hbuf1, zall, h_out, skips_out, gall, st);
  return chunk_fwd<bf16>(mode, B, Tn, R, S, d, mu, nl, dils, h, ids, wemb,
                         bemb, cond, gc, wff, vc, wr, br, ws, tail, hbuf0,
                         hbuf1, zall, h_out, skips_out, gall, st);
}

// Save-gates backward: float32 gradients of one chunk from the saved
// gates; the final dh is in dh1 when nl is odd, else in dh0.  du [B, T,
// 2R] and dhc [B, T, R] are compute-dtype scratch (dhc unused for
// float32).  With embed, dwemb [2, mu, R] and dbemb [R] are written.
int vqvae_chunk_bwd(int cdtype, int embed, int B, int Tn, int R, int S, int d,
                    int mu, int nl, const int* dils, const void* h0,
                    const int* ids, const void* wemb, const void* bemb,
                    const void* cond, const void* wffT, const void* vcT,
                    const void* wr, const void* wrT, const void* br,
                    const void* wsT, const void* gall, const void* dhout,
                    const void* dskips, void* hall, float* dh0, float* dh1,
                    float* dpha, float* dcond, void* zbuf, void* du,
                    void* dhc, float* part, long long part_cap, float* dgc,
                    float* dwff, float* dvc, float* dwr, float* dbr,
                    float* dws, float* dwemb, float* dbemb, void* stream) {
  if (bad_widths(cdtype, R, S, d, nl)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_bwd<float>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids,
                            wemb, bemb, cond, wffT, vcT, wr, wrT, br, wsT,
                            gall, dhout, dskips, hall, dh0, dh1, dpha, dcond,
                            zbuf, du, dhc, part, part_cap, dgc, dwff, dvc,
                            dwr, dbr, dws, dwemb, dbemb, st);
  return chunk_bwd<bf16>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids, wemb,
                         bemb, cond, wffT, vcT, wr, wrT, br, wsT, gall, dhout,
                         dskips, hall, dh0, dh1, dpha, dcond, zbuf, du, dhc,
                         part, part_cap, dgc, dwff, dvc, dwr, dbr, dws, dwemb,
                         dbemb, st);
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
                        void* zbuf, void* du, void* dhc, float* part,
                        long long part_cap, float* dgc, float* dwff,
                        float* dvc, float* dwr, float* dbr, float* dws,
                        float* dwemb, float* dbemb, void* stream) {
  if (bad_widths(cdtype, R, S, d, nl)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_bwd_rec<float>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids,
                                wemb, bemb, cond, gc, wff, vc, wr, br, wffT,
                                vcT, wrT, wsT, dhout, dskips, hall, gall, dh0,
                                dh1, dpha, dcond, zbuf, du, dhc, part,
                                part_cap, dgc, dwff, dvc, dwr, dbr, dws,
                                dwemb, dbemb, st);
  return chunk_bwd_rec<bf16>(embed, B, Tn, R, S, d, mu, nl, dils, h0, ids,
                             wemb, bemb, cond, gc, wff, vc, wr, br, wffT, vcT,
                             wrT, wsT, dhout, dskips, hall, gall, dh0, dh1,
                             dpha, dcond, zbuf, du, dhc, part, part_cap, dgc,
                             dwff, dvc, dwr, dbr, dws, dwemb, dbemb, st);
}

// Time-windowed recompute backward over nT windows of Tc = T / nT steps
// (T % nT == 0, Tc % 8 == 0, Tc >= max(dils), else -3).  Scratch is
// window-sized: hall [nl, B, Tc + A, R], gall [B, nl, Tc, 2R], spill
// [nl, B, max(dils), R] f32, dh0/dh1/dpha [B, Tc, R] f32, zbuf [B, Tc,
// R], du [B, Tc, 2R], dhc [B, Tc, R], with A = sum(dils) rounded up to 8.
// Writes dh [B, T, R] and dcond [B, T, d] (float32) and the weight
// gradients.
int vqvae_chunk_bwd_win(int cdtype, int B, int Tn, int R, int S, int d,
                        int nl, const int* dils, int nT, const void* h0,
                        const void* cond, const void* gc, const void* wff,
                        const void* vc, const void* wr, const void* br,
                        const void* wffT, const void* vcT, const void* wrT,
                        const void* wsT, const void* dhout,
                        const void* dskips, void* hall, void* gall,
                        float* spill, float* dh0, float* dh1, float* dpha,
                        void* zbuf, void* du, void* dhc, float* part,
                        long long part_cap, float* dh, float* dcond,
                        float* dgc, float* dwff, float* dvc, float* dwr,
                        float* dbr, float* dws, void* stream) {
  if (bad_widths(cdtype, R, S, d, nl)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return chunk_bwd_win<float>(B, Tn, R, S, d, nl, dils, nT, h0, cond, gc,
                                wff, vc, wr, br, wffT, vcT, wrT, wsT, dhout,
                                dskips, hall, gall, spill, dh0, dh1, dpha,
                                zbuf, du, dhc, part, part_cap, dh, dcond, dgc,
                                dwff, dvc, dwr, dbr, dws, st);
  return chunk_bwd_win<bf16>(B, Tn, R, S, d, nl, dils, nT, h0, cond, gc, wff,
                             vc, wr, br, wffT, vcT, wrT, wsT, dhout, dskips,
                             hall, gall, spill, dh0, dh1, dpha, zbuf, du, dhc,
                             part, part_cap, dh, dcond, dgc, dwff, dvc, dwr,
                             dbr, dws, st);
}

// The backward's weight-gradient product alone (bf16): out [M, N] =
// A'^T B over `rows` rows of A [rows, M] and B [rows, N], A' shifted down
// by `shift` rows inside each segment of `seg` rows (zero before the
// segment's start), through the split-K scratch part.
int vqvae_atb_bf16(int rows, int seg, const void* A, int M, int shift,
                   const void* B, int N, float* out, float* part,
                   long long part_cap, void* stream) {
  if (rows < 1 || seg < 1 || rows % seg || shift < 0) return -2;
  return atb<bf16, bf16, bf16>(rows, seg, (const bf16*)A, M, M, shift, 0,
                               (const bf16*)B, N, N, out, part, part_cap,
                               (cudaStream_t)stream);
}

}  // extern "C"
