// Fused strided-conv encoder: layers 1..L of the encoder (SAME, stride 2,
// kernel 4, ReLU) and the 1x1 latent projection, forward and the
// recompute backward.
//
// Replaces the TPU kernels of vqvae_tpu/kernels/encoder_pallas.py:
// _fwd_kernel (call in _enc_fwd_call, :204) and _bwd_kernel (call in
// _enc_vjp_bwd, :240).  The plain PyTorch versions are
// vqvae_tpu_torch/kernels/encoder_cuda.py (fwd_plain, bwd_plain).
//
// Math, per layer (x = the layer input [B, M, C], cdt = the compute
// dtype, T below):
//   y[m] = cdt(relu(f32(sum_j x[2m + j - 1] @ W[j]) + b))  j = 0..3
//   z    = f32(h_L @ Wp) + bp                              [B, M_L, d]
// with x read as 0 outside [0, M) (the SAME pad, one row each side), each
// sum taken in float64 and rounded once to float32 (the TPU kernel sums
// in float32; see Design), the bias added in float32.
// The backward (dz float32):
//   dWp = h_L^T cdt(dz), dbp = sum dz, dh_L = cdt(dz) @ Wp^T
//   per layer, last to first: dy = (y > 0) ? dh : 0 (float32),
//   db = sum dy, dW[j] = sum_m x[2m+j-1]^T cdt(dy[m]),
//   dx[2p] = cdt(dy[p]) W1^T + cdt(dy[p-1]) W3^T,
//   dx[2p+1] = cdt(dy[p+1]) W0^T + cdt(dy[p]) W2^T
// and dh0 = cdt(dx of layer 1).  Weight gradients are float32.
//
// What bounds it on the card: at vctk-multi's training shapes (B=16,
// h [16, 3840, 128] bf16, 5 layers, d=64) the forward is 7.8 GFLOP of
// real taps (2 * 4 * 128 * 128 per output row over 30720 + 15360 + ...
// + 1920 rows, plus the projection) against 16 MB of bytes (h read once,
// z written once, ~4.9 us), so operations bind.  Exactness keeps the
// forward's sums in float64 (Design), so its floor is the FP64 tensor
// cores' rate, 67 TFLOP/s: ~0.117 ms, against ~7.9 us at the bf16 rate.
// The backward does ~3x the operations (recompute, weight gradients,
// input gradient); its input gradient and weight gradients need no exact
// order and run on the bf16 tensor cores (float32 operands: float64).
//
// Design.  The TPU kernel keeps one batch group's whole activations in
// 128 MB of VMEM and walks all layers in one grid step; a Hopper block
// has 227 KB.  So each layer is one launch over tiles of BM output rows x
// BN columns of one batch row.  A block stages its 2 BM + 2 input rows in
// shared memory once, as float32; the layer's taps [4C, C] stream through
// a 3-stage ring of KC-row chunks by 16-byte cp.async, in cdt.  Both are
// widened to float64 as their fragments load (the conversions overlap the
// FP64 tensor cores; float32 rows keep a 64-row tile in 94 KB).  Each
// warp owns a 16 MI x 8 NJ tile and runs mma.sync m16n8k16 .f64 along
// K = 4C: tap by tap, channel chunk by chunk, one float64
// accumulator chain per output in one fixed order, which depends on
// neither the batch, the length, the tile shape nor the grid, so the
// streaming encoder's windows give the one-shot codes bit for bit.  Every
// product of two float32 (or bf16) values is exact in float64, so the sum
// rounds to the same float32 as a float64 sum in any other order (the
// plain version's DGEMM) but at a tie of roundings, and a pre-activation
// near 0 lands on the same side of the ReLU (a float32 sum in another
// order flipped ~1 of the 7.6 M masks at B=16 and moved a gradient by up
// to ~2% of its max).  The tile is chosen per layer from the grid it
// gives: 64 x 128 (8 warps) while that fills the card, then 32 x 64, then
// 16 x 16 (one warp), so the small layers and B=1 still spread over the
// SMs; a column split changes no output's sum.  The projection is fused
// into the last layer's launch on the same engine (its rows stay in shared
// memory; that layer's tiles keep all C columns: 64, 32 or 16 x 128).
// The backward recomputes every layer's output into scratch that lives
// only in the call, then walks the layers in reverse: the input gradient
// is a gather (each input row takes exactly two taps, no atomics) on the
// same ring: cdt(dy) rows staged once, the taps streamed in the order 1,
// 3 (the even rows), then 0, 2 (the odd rows), bf16 on mma.sync m16n8k16
// with ldmatrix (float32 sums), float32 on the float64 engine above; the
// projection's input gradient likewise.  The weight and bias gradients
// are the split-K products and column sums of train_common.cuh, reduced
// in a fixed order, so runs repeat bit for bit.  The TPU kernel's packing
// of the 4 taps into [3, 2C, C] blocks with zero blocks (for the MXU)
// does not carry over: the taps stay [4, C, C].
#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int EMAX = 128;   // widest layer / latent the kernels take
constexpr int KC = 32;      // weight rows per ring stage
constexpr int NSTAGE = 3;   // ring stages

// A block tile: warps WR x WC, each owning MI m16 tiles x NJ n8 tiles.
template <int MI_, int WR_, int WC_, int NJ_>
struct Tile {
  static constexpr int MI = MI_, WR = WR_, WC = WC_, NJ = NJ_;
  static constexpr int WN = 8 * NJ;         // columns per warp
  static constexpr int BM = 16 * MI * WR;   // rows
  static constexpr int BN = WN * WC;        // columns
  static constexpr int NTH = 32 * WR * WC;  // threads
};
using Tile64 = Tile<2, 2, 4, 4>;   // 64 x 128
using Tile32 = Tile<2, 1, 2, 4>;   // 32 x 64
using Tile16 = Tile<1, 1, 1, 2>;   // 16 x 16
using Proj32 = Tile<2, 1, 4, 4>;   // 32 x 128 (the projection keeps all C)
using Proj16 = Tile<1, 1, 8, 2>;   // 16 x 128

// The weight rows a block streams: `slots` matrices of K rows (row
// stride ldw), slot s being tap (order >> 2s) & 3 at w + tap * K * ldw.
struct Taps {
  const void* w;
  int K, ldw, slots, order;
};

// ring stage of KC rows x BN columns in T, row stride BN + 8 (16 bytes
// of pad: conflict-free fragment loads and ldmatrix rows)
template <typename T, int BN>
__device__ __forceinline__ void ring_fill(T* dst, const T* src, int ldw,
                                          int rows, int ncols, int nth) {
  constexpr int EPC = 16 / sizeof(T), CPR = BN / EPC;
  for (int e = threadIdx.x; e < KC * CPR; e += nth) {
    const int r = e / CPR, c = (e - r * CPR) * EPC;
    const bool ok = r < rows && c < ncols;
    async_copy16(dst + r * (BN + 8) + c, ok ? src + (size_t)r * ldw + c : src,
                 ok);
  }
}

// Streams the chunks of `tp` (columns n0 .. n0 + ncols, the rest zero)
// through the ring; prep() runs once the first two chunks are in flight,
// then consume(slot, k0, stage) on each landed chunk, in order.
template <typename T, int BN, int NTH, typename P, typename F>
__device__ __forceinline__ void stream(const Taps& tp, int n0, int ncols,
                                       T* ring, P&& prep, F&& consume) {
  const int cps = (tp.K + KC - 1) / KC, nq = tp.slots * cps;
  auto load = [&](int q) {
    const int sl = q / cps, k0 = (q - sl * cps) * KC;
    const int tap = (tp.order >> (2 * sl)) & 3;
    ring_fill<T, BN>(ring + (q % NSTAGE) * KC * (BN + 8),
                     static_cast<const T*>(tp.w) +
                         ((size_t)tap * tp.K + k0) * tp.ldw + n0,
                     tp.ldw, min(KC, tp.K - k0), ncols, NTH);
  };
  load(0);
  async_commit();
  if (nq > 1) load(1);
  async_commit();
  prep();
  for (int q = 0; q < nq; ++q) {
    async_wait<1>();   // chunk q has landed (q + 1 may be in flight)
    __syncthreads();   // ... for every thread; chunk q - 1 is consumed
    if (q + 2 < nq) load(q + 2);
    async_commit();
    const int sl = q / cps;
    consume(sl, (q - sl * cps) * KC, ring + (q % NSTAGE) * KC * (BN + 8));
  }
}

// acc[mi][j] += A[16 mi + .][k0 .. k0 + KC) B[KC][8 j + .] in float64 for
// the warp's rows and columns: A float32 rows in shared memory (stride
// lda; the warp's first row and column k0 at A), B a ring stage at the
// warp's first column (stride ldb), both widened as their fragments load
template <int MI, int NJ, typename T>
__device__ __forceinline__ void chunk_f64(double (&acc)[MI][NJ][4],
                                          const float* A, int lda,
                                          const T* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    double b[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[j][i] = (double)tof(B[(kk + t + 4 * i) * ldb + 8 * j + g]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      double a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = A[(16 * mi + g + 8 * (i & 1)) * lda + kk + t + 4 * (i >> 1)];
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_f64(acc[mi][j], a, b[j]);
    }
  }
}

// the same on bf16 operands, float32 sums: A bf16 rows (ldmatrix), B a
// bf16 ring stage (ldmatrix.trans)
template <int MI, int NJ>
__device__ __forceinline__ void chunk_bf16(float (&acc)[MI][NJ][4],
                                           const bf16* A, int lda,
                                           const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], A + (16 * mi + (lane & 15)) * lda + kk +
                         ((lane >> 4) << 3));
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, B + (kk + (lane & 15)) * ldb + 8 * j + ((lane >> 4) << 3));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_bf16(acc[mi][j], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][j + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

template <typename A, int MI, int NJ>
__device__ __forceinline__ void zero(A (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0;
}

template <typename S> __device__ __forceinline__ S cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 cvt<bf16>(float v) {
  return __float2bfloat16(v);
}

// dst[i][k] (row stride ldd, S) = rnd<R>(src[(row0 + i) * ld + k]) for
// rows lo <= row0 + i < hi and k < K, else 0, over nrows rows and Kpad
// columns; 16-byte loads (K and ld multiples of 16 / sizeof(TS)), SU of
// them in flight a thread
template <typename S, typename R, typename TS>
__device__ __forceinline__ void stage(S* dst, int ldd, const TS* src, int ld,
                                      int row0, int nrows, int lo, int hi,
                                      int K, int Kpad, int nth) {
  constexpr int EPC = 16 / sizeof(TS), SU = 8;
  const int cpr = Kpad / EPC, n = nrows * cpr;
  for (int e0 = threadIdx.x; e0 < n; e0 += SU * nth) {
    uint4 v[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * nth, i = e / cpr, k = (e - i * cpr) * EPC;
      const int r = row0 + i;
      v[u] = make_uint4(0, 0, 0, 0);
      if (e < n && r >= lo && r < hi && k < K)
        v[u] = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + k);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * nth, i = e / cpr, k = (e - i * cpr) * EPC;
      if (e >= n) break;
      const TS* p = reinterpret_cast<const TS*>(&v[u]);
      S* o = dst + i * ldd + k;
#pragma unroll
      for (int w = 0; w < EPC; ++w) o[w] = cvt<S>(rnd<R>(tof(p[w])));
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}
__host__ __device__ constexpr size_t maxz(size_t a, size_t b) {
  return a > b ? a : b;
}

// enc_layer's shared memory: the float32 rows xs [2 BM + 2][C + 2] (PROJ:
// then hs [BM][C + 4] over them), then the ring
template <class TL, bool PROJ>
__host__ __device__ constexpr size_t layer_rows_bytes(int C) {
  return align128(maxz((size_t)(2 * TL::BM + 2) * (C + 2),
                       PROJ ? (size_t)TL::BM * (C + 4) : 0) *
                  sizeof(float));
}

template <typename T, class TL, bool PROJ>
size_t layer_smem(int C) {
  return layer_rows_bytes<TL, PROJ>(C) +
         (size_t)NSTAGE * KC * (TL::BN + 8) * sizeof(T);
}

// One layer over a tile of BM output rows x BN columns (blockIdx.x, .z)
// of batch row blockIdx.y.  y (if not null) gets the rounded post-ReLU
// rows; with PROJ (one column tile, BN >= C) the rows also go through the
// projection into z.
template <typename T, bool PROJ, class TL>
__global__ void __launch_bounds__(TL::NTH)
    enc_layer(int Min, int C, const T* __restrict__ x,
              const T* __restrict__ w, const float* __restrict__ b,
              T* __restrict__ y, int d, const T* __restrict__ wp,
              const float* __restrict__ bp, float* __restrict__ z) {
  constexpr int MI = TL::MI, NJ = TL::NJ, WN = TL::WN, BM = TL::BM,
                BN = TL::BN, NTH = TL::NTH;
  const int Mo = Min / 2, m0 = blockIdx.x * BM, bb = blockIdx.y;
  const int n0 = blockIdx.z * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / TL::WC, wc = warp % TL::WC, g = lane >> 2,
            t = lane & 3;
  const int ldx = C + 2;   // 2 ldx = 4 (mod 32): conflict-free A loads
  char* base = reinterpret_cast<char*>(smem);
  float* xs = reinterpret_cast<float*>(base);   // [2 BM + 2][ldx]
  T* ring = reinterpret_cast<T*>(base + layer_rows_bytes<TL, PROJ>(C));
  const T* xb = x + (size_t)bb * Min * C;
  const int r_lo = 2 * m0 - 1;

  double acc[MI][NJ][4];
  zero(acc);
  // output row r reads local input rows 2r + j: A rows of stride 2 ldx,
  // tap j's rows offset by j
  const float* Aw = xs + 2 * (16 * MI * wr) * ldx;
  stream<T, BN, NTH>(
      Taps{w, C, C, 4, 0xE4}, n0, min(BN, C - n0), ring,
      [&] {
        stage<float, T>(xs, ldx, xb, C, r_lo, 2 * BM + 2, 0, Min, C, C,
                        NTH);
      },
      [&](int j, int k0, const T* st) {
        chunk_f64<MI, NJ>(acc, Aw + j * ldx + k0, 2 * ldx, st + WN * wc,
                          BN + 8);
      });

  float* hs = xs;   // [BM][C + 4] (PROJ), over xs once every warp is done
  if constexpr (PROJ) __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + WN * wc + 8 * j + 2 * t;
      if (n >= C) continue;
      const float b0 = b[n], b1 = b[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (MI * wr + mi) + g + 8 * h, m = m0 + r;
        const float v0 = rnd<T>(fmaxf((float)acc[mi][j][2 * h] + b0, 0.f));
        const float v1 =
            rnd<T>(fmaxf((float)acc[mi][j][2 * h + 1] + b1, 0.f));
        if constexpr (PROJ) {
          hs[r * (C + 4) + n] = v0;
          hs[r * (C + 4) + n + 1] = v1;
        }
        if (y != nullptr && m < Mo)
          store2(y + ((size_t)bb * Mo + m) * C + n, v0, v1);
      }
    }
  if constexpr (PROJ) {
    double za[MI][NJ][4];
    zero(za);
    const float* Hw = hs + 16 * MI * wr * (C + 4);
    stream<T, BN, NTH>(
        Taps{wp, C, d, 1, 0}, 0, min(BN, d), ring, [] {},
        [&](int, int k0, const T* st) {
          if (WN * wc < d)
            chunk_f64<MI, NJ>(za, Hw + k0, C + 4, st + WN * wc, BN + 8);
        });
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = WN * wc + 8 * j + 2 * t;
        if (n >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * (MI * wr + mi) + g + 8 * h;
          if (m < Mo)
            store2(z + ((size_t)bb * Mo + m) * d + n,
                   (float)za[mi][j][2 * h] + bp[n],
                   (float)za[mi][j][2 * h + 1] + bp[n + 1]);
        }
      }
  }
}

// Row gradients of the backward, over a tile of BM rows p x BN columns:
// mode PBWD, the projection's: dy[p] = (h[p] > 0) ? cdt(dz[p]) @ Wp^T : 0
//   over the N = B M_L latent rows (one segment), K = d;
// mode DX_MASK / DX_LAST, one layer's input gradient for the rows 2p, 2p
//   + 1 of batch row blockIdx.y (p < Mo): the taps 1, 3 (even rows), then
//   0, 2 (odd rows) of cdt(dy) rows p - 1 .. p + 1 (module note); DX_MASK
//   gives the next-lower layer's dy (masked by its output hprev > 0,
//   float32), DX_LAST dh0 in T.
// bf16 on mma.sync m16n8k16 (float32 sums); float32 in float64 on the
// FP64 tensor cores, rounded once.
enum { PBWD = 0, DX_MASK = 1, DX_LAST = 2 };

template <typename T>
using Stage = typename std::conditional<std::is_same<T, bf16>::value, bf16,
                                        float>::type;

template <typename T>
__host__ __device__ constexpr int a_ld(int Kpad) {
  // bf16: an odd multiple of 16 bytes (ldmatrix); float: 4 (mod 32)
  return Kpad + (std::is_same<T, bf16>::value ? 8 : 4);
}

// enc_rows' shared memory: the rows [BM + 2][a_ld], then the ring
template <typename T, class TL>
__host__ __device__ constexpr size_t rows_a_bytes(int Kpad) {
  return align128((size_t)(TL::BM + 2) * a_ld<T>(Kpad) * sizeof(Stage<T>));
}

template <typename T, class TL>
size_t rows_smem(int K) {
  return rows_a_bytes<T, TL>((K + KC - 1) / KC * KC) +
         (size_t)NSTAGE * KC * (TL::BN + 8) * sizeof(T);
}

template <typename T, class TL>
__global__ void __launch_bounds__(TL::NTH)
    enc_rows(int mode, int seg, int C, int K, const float* __restrict__ src,
             const T* __restrict__ w, const T* __restrict__ mask,
             float* __restrict__ out_f, T* __restrict__ out_t) {
  constexpr int MI = TL::MI, NJ = TL::NJ, WN = TL::WN, BM = TL::BM,
                BN = TL::BN, NTH = TL::NTH;
  using S = Stage<T>;
  constexpr bool TC = std::is_same<T, bf16>::value;
  using Acc = typename std::conditional<TC, float, double>::type;
  const int p0 = blockIdx.x * BM, bb = blockIdx.y, n0 = blockIdx.z * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / TL::WC, wc = warp % TL::WC, g = lane >> 2,
            t = lane & 3;
  const int Kpad = (K + KC - 1) / KC * KC, lda = a_ld<T>(Kpad);
  const int halo = mode == PBWD ? 0 : 1;
  char* base = reinterpret_cast<char*>(smem);
  S* as = reinterpret_cast<S*>(base);   // [BM + 2 halo][lda]
  T* ring = reinterpret_cast<T*>(base + rows_a_bytes<T, TL>(Kpad));
  // slot s reads local A rows p - p0 + aoff(s): the projection's single
  // tap 0; taps 1, 3, 0, 2 at offsets 1, 0, 2, 1 (rows p, p-1, p+1, p)
  const Taps tp = mode == PBWD
                      ? Taps{w, K, C, 1, 0}
                      : Taps{w, K, C, 4, 1 | 3 << 2 | 0 << 4 | 2 << 6};
  const int aoff = mode == PBWD ? 0 : 1 | 0 << 2 | 2 << 4 | 1 << 6;

  Acc acc[MI][NJ][4];
  zero(acc);
  const S* Aw = as + 16 * MI * wr * lda;
  auto flush = [&](int parity) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + WN * wc + 8 * j + 2 * t;
        if (n >= C) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + 16 * (MI * wr + mi) + g + 8 * h;
          if (p >= seg) continue;
          const size_t o =
              (mode == PBWD ? (size_t)p
                            : ((size_t)bb * seg + p) * 2 + parity) * C + n;
          const float v0 = (float)acc[mi][j][2 * h];
          const float v1 = (float)acc[mi][j][2 * h + 1];
          if (mode == DX_LAST) {
            store2(out_t + o, v0, v1);
          } else {
            store2(out_f + o, tof(mask[o]) > 0.f ? v0 : 0.f,
                   tof(mask[o + 1]) > 0.f ? v1 : 0.f);
          }
        }
      }
    zero(acc);
  };
  stream<T, BN, NTH>(
      tp, n0, min(BN, C - n0), ring,
      [&] {
        stage<S, T>(as, lda, src + (size_t)bb * seg * K, K, p0 - halo,
                    BM + 2 * halo, 0, seg, K, Kpad, NTH);
      },
      [&](int sl, int k0, const T* st) {
        const S* A = Aw + ((aoff >> (2 * sl)) & 3) * lda + k0;
        if constexpr (TC)
          chunk_bf16<MI, NJ>(acc, A, lda, st + WN * wc, BN + 8);
        else
          chunk_f64<MI, NJ>(acc, A, lda, st + WN * wc, BN + 8);
        if (k0 + KC == Kpad && (mode == PBWD || sl % 2 == 1))
          flush(sl / 2);
      });
}

// the number of blocks a tile of TL gives over nseg segments of rows rows
// and C columns
template <class TL>
long long blocks(int rows, int nseg, int C) {
  return (long long)cdiv(rows, TL::BM) * nseg * cdiv(C, TL::BN);
}

template <class TL, typename K, typename... A>
int launch(K kern, int rows, int nseg, int C, size_t sm, cudaStream_t st,
           A... args) {
  VQT_TRY(smem_opt_in(kern, sm));
  const dim3 grid(cdiv(rows, TL::BM), nseg, cdiv(C, TL::BN));
  KLAUNCH(kern, grid, TL::NTH, sm, st, args...);
  return (int)last_error();
}

// one forward layer: the largest tile whose grid fills the card, else the
// smallest (every tile sums each output in the same order)
template <typename T, bool PROJ>
int layer(int B, int Min, int C, const T* x, const T* w, const float* b,
          T* y, int d, const T* wp, const float* bp, float* z,
          cudaStream_t st) {
  const int Mo = Min / 2, nsm = num_sms();
  auto go = [&](auto tl) {
    using TL = decltype(tl);
    auto k = enc_layer<T, PROJ, TL>;
    return launch<TL>(k, Mo, B, PROJ ? 1 : C, layer_smem<T, TL, PROJ>(C), st,
                      Min, C, x, w, b, y, d, wp, bp, z);
  };
  if (blocks<Tile64>(Mo, B, C) >= nsm) return go(Tile64{});
  if constexpr (PROJ) {
    if (blocks<Proj32>(Mo, B, 1) >= nsm) return go(Proj32{});
    return go(Proj16{});
  } else {
    if (blocks<Tile32>(Mo, B, C) >= nsm) return go(Tile32{});
    return go(Tile16{});
  }
}

template <typename T>
int rows_launch(int mode, int rows, int nseg, int C, int K, const float* src,
                const T* w, const T* mask, float* out_f, T* out_t,
                cudaStream_t st) {
  const int nsm = num_sms();
  auto go = [&](auto tl) {
    using TL = decltype(tl);
    auto k = enc_rows<T, TL>;
    return launch<TL>(k, rows, nseg, C, rows_smem<T, TL>(K), st, mode, rows,
                      C, K, src, w, mask, out_f, out_t);
  };
  if (blocks<Tile64>(rows, nseg, C) >= nsm) return go(Tile64{});
  if (blocks<Tile32>(rows, nseg, C) >= nsm) return go(Tile32{});
  return go(Tile16{});
}

// the L layers from x (M0 rows per batch row) into y_of(i); the last one
// through the projection into z when z is not null
template <typename T, typename YOf>
int run_layers(int B, int M0, int C, int d, int L, const T* x, const T* wr,
               const float* br, const T* wp, const float* bp, YOf y_of,
               float* z, cudaStream_t st) {
  int M = M0;
  for (int i = 0; i < L; ++i) {
    const T* w = wr + (size_t)i * 4 * C * C;
    T* y = y_of(i);
    if (z != nullptr && i == L - 1) {
      VQT_TRY((layer<T, true>(B, M, C, x, w, br + (size_t)i * C, y, d, wp,
                              bp, z, st)));
    } else {
      VQT_TRY((layer<T, false>(B, M, C, x, w, br + (size_t)i * C, y, d, wp,
                               bp, (float*)nullptr, st)));
    }
    x = y;
    M /= 2;
  }
  return 0;
}

bool sizes_ok(int B, int M0, int C, int d, int L) {
  return B >= 1 && L >= 1 && L <= 20 && C >= KC && C <= EMAX &&
         C % KC == 0 && d >= 8 && d <= EMAX && d % 8 == 0 &&
         M0 >= (1 << L) && M0 % (1 << L) == 0;
}

template <typename T>
int enc_fwd(int B, int M0, int C, int d, int L, const T* h, const T* wr,
            const float* br, const T* wp, const float* bp, T* buf0, T* buf1,
            float* z, cudaStream_t st) {
  // intermediate layers ping-pong between buf0 and buf1; the last one
  // stays in shared memory
  auto y_of = [&](int i) -> T* {
    return i == L - 1 ? nullptr : (i % 2 ? buf1 : buf0);
  };
  return run_layers<T>(B, M0, C, d, L, h, wr, br, wp, bp, y_of, z, st);
}

template <typename T>
int enc_bwd(int B, int M0, int C, int d, int L, const T* h, const T* wr,
            const T* wrt, const float* br, const T* wp, const T* wpt,
            const float* bp, const float* dz, T* hall, float* dy0, float* dy1,
            T* dh0, float* part, long long cap, float* dwr, float* dbr,
            float* dwp, float* dbp, cudaStream_t st, void* const* ev) {
  // piece k of the call runs between events 2k and 2k + 1 (when given)
  int k = 0;
  auto mark = [&] {
    if (ev != nullptr) cudaEventRecord((cudaEvent_t)ev[k], st);
    ++k;
  };
  // pass 1: every layer's output, at hall + off(i)
  auto off = [&](int i) {
    size_t o = 0;
    for (int l = 0; l < i; ++l) o += (size_t)B * (M0 >> (l + 1)) * C;
    return o;
  };
  auto y_of = [&](int i) -> T* { return hall + off(i); };
  mark();
  VQT_TRY(run_layers<T>(B, M0, C, d, L, h, wr, br, wp, bp, y_of,
                        (float*)nullptr, st));
  mark();

  // pass 2: the projection, then the layers in reverse
  const int Mz = M0 >> L, NZ = B * Mz;
  const T* hL = hall + off(L - 1);
  mark();
  VQT_TRY((atb<T, float, T>(NZ, Mz, hL, C, C, 0, 0, dz, d, d, dwp, part, cap,
                            st)));
  VQT_TRY(colsum(1, NZ, d, dz, d, dbp, 0, part, cap, st));
  mark();
  float* dy = dy0;
  float* other = dy1;
  mark();
  VQT_TRY(rows_launch<T>(PBWD, NZ, 1, C, d, dz, wpt, hL, dy, (T*)nullptr,
                         st));
  mark();
  for (int i = L - 1; i >= 0; --i) {
    const int Mo = M0 >> (i + 1), N = B * Mo;
    const T* hin = i ? hall + off(i - 1) : h;   // folded: [N, 2C]
    float* dW = dwr + (size_t)i * 4 * C * C;
    mark();
    // taps 1 and 2: x[2m] and x[2m+1], the folded row m itself
    VQT_TRY((atb<T, float, T>(N, Mo, hin, 2 * C, 2 * C, 0, 0, dy, C, C,
                              dW + (size_t)C * C, part, cap, st)));
    // tap 0: x[2m-1], the second half of folded row m-1 (0 at m = 0)
    VQT_TRY((atb<T, float, T>(N, Mo, hin + C, 2 * C, C, 1, 0, dy, C, C, dW,
                              part, cap, st)));
    // tap 3: x[2m+2], the first half of folded row m+1 (none at the last m)
    if (Mo > 1) {
      VQT_TRY((atb<T, float, T>(B * (Mo - 1), Mo - 1, hin, 2 * C, C, 0, 0, dy,
                                C, C, dW + (size_t)3 * C * C, part, cap, st, 0,
                                RowMap{Mo - 1, Mo, 1, Mo, 0})));
    } else {
      VQT_TRY(cudaMemsetAsync(dW + (size_t)3 * C * C, 0,
                              (size_t)C * C * sizeof(float), st));
    }
    VQT_TRY(colsum(1, N, C, dy, C, dbr + (size_t)i * C, 0, part, cap, st));
    mark();
    const T* wti = wrt + (size_t)i * 4 * C * C;
    mark();
    if (i > 0) {
      VQT_TRY(rows_launch<T>(DX_MASK, Mo, B, C, C, dy, wti, hall + off(i - 1),
                             other, (T*)nullptr, st));
      float* t = dy;
      dy = other;
      other = t;
    } else {
      VQT_TRY(rows_launch<T>(DX_LAST, Mo, B, C, C, dy, wti, (const T*)nullptr,
                             (float*)nullptr, dh0, st));
    }
    mark();
  }
  return 0;
}

}  // namespace

extern "C" {

// z [B, M0 >> L, d] float32 from h [B, M0, C] (cdt 0 = float32, 1 =
// bfloat16, as are wr [L, 4, C, C] and wp [C, d]; br [L, C] and bp [d]
// float32); buf0 and buf1 hold [B, M0/2, C] of cdt each.  Returns 0, a
// CUDA error, or -2 for sizes the kernel does not take.
int vqvae_enc_fwd(int cdt, int B, int M0, int C, int d, int L, const void* h,
                  const void* wr, const float* br, const void* wp,
                  const float* bp, void* buf0, void* buf1, float* z,
                  void* stream) {
  if (!sizes_ok(B, M0, C, d, L)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdt == 0)
    return enc_fwd<float>(B, M0, C, d, L, (const float*)h, (const float*)wr,
                          br, (const float*)wp, bp, (float*)buf0,
                          (float*)buf1, z, st);
  if (cdt == 1)
    return enc_fwd<bf16>(B, M0, C, d, L, (const bf16*)h, (const bf16*)wr, br,
                         (const bf16*)wp, bp, (bf16*)buf0, (bf16*)buf1, z, st);
  return -2;
}

// The recompute backward: dh0 [B, M0, C] (cdt) and float32 dwr [L, 4, C,
// C], dbr [L, C], dwp [C, d], dbp [d] from dz [B, M0 >> L, d] float32.
// wrt [L, 4, C, C] holds each tap transposed and wpt [d, C] the
// projection transposed (cdt).  Scratch: hall (every layer's output,
// sum over l of B * (M0 >> (l+1)) * C of cdt), dy0 and dy1 ([B, M0/2,
// C] float32 each) and part (cap floats, at least 4 * C * C).  ev, when
// not null, holds 6 + 4 L CUDA events recorded in pairs around the
// call's pieces, in order: the recompute, the projection's weight and
// bias gradients, its input gradient, then per layer from the last its
// weight and bias gradients and its input gradient.
int vqvae_enc_bwd(int cdt, int B, int M0, int C, int d, int L, const void* h,
                  const void* wr, const void* wrt, const float* br,
                  const void* wp, const void* wpt, const float* bp,
                  const float* dz, void* hall, float* dy0, float* dy1,
                  void* dh0, float* part, long long cap, float* dwr,
                  float* dbr, float* dwp, float* dbp, void* stream,
                  void* const* ev) {
  if (!sizes_ok(B, M0, C, d, L) || cap < 4LL * C * C) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdt == 0)
    return enc_bwd<float>(B, M0, C, d, L, (const float*)h, (const float*)wr,
                          (const float*)wrt, br, (const float*)wp,
                          (const float*)wpt, bp, dz, (float*)hall, dy0, dy1,
                          (float*)dh0, part, cap, dwr, dbr, dwp, dbp, st, ev);
  if (cdt == 1)
    return enc_bwd<bf16>(B, M0, C, d, L, (const bf16*)h, (const bf16*)wr,
                         (const bf16*)wrt, br, (const bf16*)wp,
                         (const bf16*)wpt, bp, dz, (bf16*)hall, dy0, dy1,
                         (bf16*)dh0, part, cap, dwr, dbr, dwp, dbp, st, ev);
  return -2;
}

}  // extern "C"
