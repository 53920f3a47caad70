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
//   dx[2p+1] = cdt(dy[p+1]) W0^T + cdt(dy[p]) W2^T       (float32)
// and dh0 = cdt(dx of layer 1).  Weight gradients are float32.
//
// What bounds it on the card: at vctk-multi's training shapes (B=16,
// h [16, 3840, 128] bf16, 5 layers, d=64) the forward is 7.8 GFLOP of
// real taps (2 * 4 * 128 * 128 per output row over 30720 + 15360 + ...
// + 1920 rows, plus the projection): ~7.9 us at the bf16 tensor-core
// rate, against 16 MB of bytes (h read once, z written once, ~4.9 us),
// so operations bind; the backward does ~3x the operations (recompute,
// weight gradients, input gradient).  This first kernel keeps every
// forward product a scalar float64 FMA and every backward one a scalar
// float32 FMA (but the weight gradients: tensor cores in bf16), in a
// fixed order, and is far from that bound.
//
// Design.  The TPU kernel keeps one batch group's whole activations in
// 128 MB of VMEM and walks all layers in one grid step; a Hopper block
// has 227 KB.  So each layer is one launch over tiles of TO = 32 output
// rows x all (<= 128) channels: a block stages its 2*TO + 2 input rows in
// shared memory as float32 and sums the 4 taps x C inputs of each output
// in one fixed order (tap, then channel), which depends on neither the
// batch, the length nor the tile, so the streaming encoder's windows give
// the one-shot codes bit for bit.  The sum is float64 (exact products,
// one rounding): a float32 sum in another order than the plain version's
// (float64 products rounded once, as the port's plain encoder) lands a
// pre-activation within an ulp of 0 on the other side of the ReLU now
// and then (~1 of the 7.6 M pre-activations at B=16), flipping a mask
// and moving a gradient by up to ~2% of its max; in float64 both round
// to the same float32 but at a tie.  The projection is fused into the
// last layer's launch (its rows stay in shared memory).  The backward
// recomputes every layer's output into scratch that lives only in the
// call, then walks the layers in reverse: the input gradient is a gather
// (each input row takes exactly two taps, no atomics), the weight and
// bias gradients are the split-K products and column sums of
// train_common.cuh, reduced in a fixed order, so runs repeat bit for bit.
// The TPU kernel's packing of the 4 taps into [3, 2C, C] blocks with zero
// blocks (for the MXU) does not carry over: the taps stay [4, C, C].
#include "train_common.cuh"

using namespace vqt;

namespace {

// acc[i][j] += sum_k X[(rg + RG*i)*ldx + k] * W[k*ldw + cg + 32*j] in
// float64 (mac's layout): each float32 x float32 product is exact in
// float64, so the float32 rounding of the sum agrees with a float64 sum
// taken in any other order (the plain version's) but at a tie of
// roundings, and a pre-activation near 0 lands on the same side of the
// ReLU in both.
template <int CT, typename TW>
__device__ __forceinline__ void macd(double (&acc)[RT][CT], const float* X,
                                     int ldx, const TW* __restrict__ W,
                                     int ldw, int K, int ncols, int rg,
                                     int cg) {
  for (int k = 0; k < K; ++k) {
    double w[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = cg + 32 * j;
      w[j] = c < ncols ? (double)tof(W[(size_t)k * ldw + c]) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const double x = X[(rg + RG * i) * ldx + k];
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fma(x, w[j], acc[i][j]);
    }
  }
}

constexpr int ECT = 4;            // 32-column groups per lane
constexpr int EMAX = 32 * ECT;    // widest layer / latent the kernels take
constexpr int TO = TM;            // output rows per forward tile
constexpr int TIN = 2 * TO + 2;   // input rows a forward tile reads
constexpr int TD = TM / 2 + 2;    // dy rows an input-gradient tile reads

// One layer over a tile of TO output rows of batch row blockIdx.y.
// y (if not null) gets the rounded post-ReLU rows; with PROJ the rows
// also go through the projection into z.
template <typename T, bool PROJ>
__global__ void enc_layer(int Min, int C, const T* __restrict__ x,
                          const T* __restrict__ w, const float* __restrict__ b,
                          T* __restrict__ y, int d, const T* __restrict__ wp,
                          const float* __restrict__ bp,
                          float* __restrict__ z) {
  const int Mo = Min / 2;
  const int m0 = blockIdx.x * TO, bb = blockIdx.y;
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;
  float* xs = smem;               // [TIN][C]
  float* hs = xs + TIN * C;       // [TO][C] (PROJ)
  const T* xb = x + (size_t)bb * Min * C;
  const int r_lo = 2 * m0 - 1;
  for (int e = tid; e < TIN * C; e += NT) {
    const int r = r_lo + e / C;
    xs[e] = (r >= 0 && r < Min) ? tof(xb[(size_t)r * C + e % C]) : 0.f;
  }
  __syncthreads();
  double acc[RT][ECT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < ECT; ++j) acc[i][j] = 0.0;
  // output row r reads local input rows 2r + j: rows of stride 2C
  for (int j = 0; j < 4; ++j)
    macd<ECT>(acc, xs + j * C, 2 * C, w + (size_t)j * C * C, C, C, C, rg,
              cg);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg + RG * i, m = m0 + r;
#pragma unroll
    for (int j = 0; j < ECT; ++j) {
      const int c = cg + 32 * j;
      if (c >= C) continue;
      const float v = rnd<T>(fmaxf((float)acc[i][j] + b[c], 0.f));
      if constexpr (PROJ) hs[r * C + c] = v;
      if (y != nullptr && m < Mo)
        y[((size_t)bb * Mo + m) * C + c] = fromf<T>(v);
    }
  }
  if constexpr (PROJ) {
    __syncthreads();
    double za[RT][ECT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < ECT; ++j) za[i][j] = 0.0;
    macd<ECT>(za, hs, C, wp, d, C, d, rg, cg);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int m = m0 + rg + RG * i;
      if (m >= Mo) continue;
#pragma unroll
      for (int j = 0; j < ECT; ++j) {
        const int c = cg + 32 * j;
        if (c < d)
          z[((size_t)bb * Mo + m) * d + c] = (float)za[i][j] + bp[c];
      }
    }
  }
}

// dy[r][c] = h[r][c] > 0 ? sum_k cdt(dz[r][k]) * wpt[k][c] : 0 over the
// N rows of the latent (the projection's input gradient, masked by the
// last layer's ReLU)
template <typename T>
__global__ void enc_proj_bwd(int N, int C, int d, const float* __restrict__ dz,
                             const T* __restrict__ wpt,
                             const T* __restrict__ h, float* __restrict__ dy) {
  float* ds = smem;               // [TM][d]
  const int r0 = blockIdx.x * TM;
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;
  for (int e = tid; e < TM * d; e += NT) {
    const int r = r0 + e / d;
    ds[e] = r < N ? rnd<T>(dz[(size_t)r * d + e % d]) : 0.f;
  }
  __syncthreads();
  float acc[RT][ECT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < ECT; ++j) acc[i][j] = 0.f;
  mac<ECT>(acc, ds, d, wpt, C, d, C, rg, cg);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + rg + RG * i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < ECT; ++j) {
      const int c = cg + 32 * j;
      if (c >= C) continue;
      const size_t o = (size_t)r * C + c;
      dy[o] = tof(h[o]) > 0.f ? acc[i][j] : 0.f;
    }
  }
}

// Input gradient of one layer over a tile of TM input rows of batch row
// blockIdx.y: each row sums its two taps (module note), each a float32
// sum over the output channels in order, the two added last.  With MASK
// the result is the next-lower layer's dy (masked by its output hprev >
// 0, float32); otherwise it is dh0, rounded to T.
template <typename T, bool MASK>
__global__ void enc_dx(int Mo, int C, const float* __restrict__ dy,
                       const T* __restrict__ wt, const T* __restrict__ hprev,
                       float* __restrict__ out_f, T* __restrict__ out_t) {
  const int Min = 2 * Mo;
  const int R0 = blockIdx.x * TM, bb = blockIdx.y;
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;
  const int p_lo = R0 / 2 - 1;
  float* ds = smem;               // [TD][C]: dy rows p_lo .. p_lo + TD - 1
  for (int e = tid; e < TD * C; e += NT) {
    const int p = p_lo + e / C;
    ds[e] = (p >= 0 && p < Mo)
                ? rnd<T>(dy[((size_t)bb * Mo + p) * C + e % C]) : 0.f;
  }
  __syncthreads();
  // warp rg owns local rows rg + 8i, all of one parity; row 2q + e reads
  // dy row q + 1 (tap 1) and q (tap 3) when even, q + 2 (tap 0) and
  // q + 1 (tap 2) when odd, in local dy rows
  const int odd = rg & 1, q0 = rg >> 1;
  const T* wa = wt + (size_t)(odd ? 0 : 1) * C * C;
  const T* wb = wt + (size_t)(odd ? 2 : 3) * C * C;
  const int qa = q0 + (odd ? 2 : 1), qb = q0 + (odd ? 1 : 0);
  float A[RT][ECT], Bv[RT][ECT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < ECT; ++j) A[i][j] = Bv[i][j] = 0.f;
  for (int k = 0; k < C; ++k) {
    float va[ECT], vb[ECT];
#pragma unroll
    for (int j = 0; j < ECT; ++j) {
      const int c = cg + 32 * j;
      va[j] = c < C ? tof(wa[(size_t)k * C + c]) : 0.f;
      vb[j] = c < C ? tof(wb[(size_t)k * C + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float xa = ds[(qa + 4 * i) * C + k];
      const float xb = ds[(qb + 4 * i) * C + k];
#pragma unroll
      for (int j = 0; j < ECT; ++j) {
        A[i][j] = fmaf(xa, va[j], A[i][j]);
        Bv[i][j] = fmaf(xb, vb[j], Bv[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int R = R0 + rg + RG * i;
    if (R >= Min) continue;
#pragma unroll
    for (int j = 0; j < ECT; ++j) {
      const int c = cg + 32 * j;
      if (c >= C) continue;
      const size_t o = ((size_t)bb * Min + R) * C + c;
      const float v = A[i][j] + Bv[i][j];
      if constexpr (MASK)
        out_f[o] = tof(hprev[o]) > 0.f ? v : 0.f;
      else
        out_t[o] = fromf<T>(v);
    }
  }
}

inline size_t layer_smem(int C, bool proj) {
  return (size_t)(TIN * C + (proj ? TO * C : 0)) * sizeof(float);
}

// the L layers from x (M0 rows per batch row) into y_of(i); the last one
// through the projection into z when z is not null
template <typename T, typename YOf>
int run_layers(int B, int M0, int C, int d, int L, const T* x, const T* wr,
               const float* br, const T* wp, const float* bp, YOf y_of,
               float* z, cudaStream_t st) {
  auto plain = enc_layer<T, false>;
  auto proj = enc_layer<T, true>;
  VQT_TRY(smem_opt_in(plain, layer_smem(C, false)));
  VQT_TRY(smem_opt_in(proj, layer_smem(C, true)));
  int M = M0;
  for (int i = 0; i < L; ++i) {
    const int Mo = M / 2;
    const dim3 grid(cdiv(Mo, TO), B);
    const T* w = wr + (size_t)i * 4 * C * C;
    T* y = y_of(i);
    if (z != nullptr && i == L - 1) {
      KLAUNCH(proj, grid, NT, layer_smem(C, true), st, M, C, x, w,
              br + (size_t)i * C, y, d, wp, bp, z);
    } else {
      KLAUNCH(plain, grid, NT, layer_smem(C, false), st, M, C, x, w,
              br + (size_t)i * C, y, d, wp, bp, (float*)nullptr);
    }
    VQT_TRY(last_error());
    x = y;
    M = Mo;
  }
  return 0;
}

bool sizes_ok(int B, int M0, int C, int d, int L) {
  return B >= 1 && L >= 1 && L <= 20 && C >= 1 && C <= EMAX && d >= 1 &&
         d <= EMAX && M0 >= (1 << L) && M0 % (1 << L) == 0;
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
            float* dwp, float* dbp, cudaStream_t st) {
  // pass 1: every layer's output, at hall + off(i)
  auto off = [&](int i) {
    size_t o = 0;
    for (int l = 0; l < i; ++l) o += (size_t)B * (M0 >> (l + 1)) * C;
    return o;
  };
  auto y_of = [&](int i) -> T* { return hall + off(i); };
  VQT_TRY(run_layers<T>(B, M0, C, d, L, h, wr, br, wp, bp, y_of,
                        (float*)nullptr, st));

  // pass 2: the projection, then the layers in reverse
  const int Mz = M0 >> L, NZ = B * Mz;
  const T* hL = hall + off(L - 1);
  VQT_TRY((atb<T, float, T>(NZ, Mz, hL, C, C, 0, 0, dz, d, d, dwp, part, cap,
                            st)));
  VQT_TRY(colsum(1, NZ, d, dz, d, dbp, 0, part, cap, st));
  float* dy = dy0;
  float* other = dy1;
  KLAUNCH(enc_proj_bwd<T>, cdiv(NZ, TM), NT, (size_t)TM * d * sizeof(float),
          st, NZ, C, d, dz, wpt, hL, dy);
  VQT_TRY(last_error());
  auto dx_plain = enc_dx<T, false>;
  auto dx_mask = enc_dx<T, true>;
  const size_t dx_smem = (size_t)TD * C * sizeof(float);
  for (int i = L - 1; i >= 0; --i) {
    const int Mo = M0 >> (i + 1), N = B * Mo;
    const T* hin = i ? hall + off(i - 1) : h;   // folded: [N, 2C]
    float* dW = dwr + (size_t)i * 4 * C * C;
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
    const dim3 grid(cdiv(2 * Mo, TM), B);
    const T* wti = wrt + (size_t)i * 4 * C * C;
    if (i > 0) {
      KLAUNCH(dx_mask, grid, NT, dx_smem, st, Mo, C, dy, wti,
              hall + off(i - 1), other, (T*)nullptr);
      VQT_TRY(last_error());
      float* t = dy;
      dy = other;
      other = t;
    } else {
      KLAUNCH(dx_plain, grid, NT, dx_smem, st, Mo, C, dy, wti,
              (const T*)nullptr, (float*)nullptr, dh0);
      VQT_TRY(last_error());
    }
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
// C] float32 each) and part (cap floats, at least 4 * C * C).
int vqvae_enc_bwd(int cdt, int B, int M0, int C, int d, int L, const void* h,
                  const void* wr, const void* wrt, const float* br,
                  const void* wp, const void* wpt, const float* bp,
                  const float* dz, void* hall, float* dy0, float* dy1,
                  void* dh0, float* part, long long cap, float* dwr,
                  float* dbr, float* dwp, float* dbp, void* stream) {
  if (!sizes_ok(B, M0, C, d, L) || cap < 4LL * C * C) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (cdt == 0)
    return enc_bwd<float>(B, M0, C, d, L, (const float*)h, (const float*)wr,
                          (const float*)wrt, br, (const float*)wp,
                          (const float*)wpt, bp, dz, (float*)hall, dy0, dy1,
                          (float*)dh0, part, cap, dwr, dbr, dwp, dbp, st);
  if (cdt == 1)
    return enc_bwd<bf16>(B, M0, C, d, L, (const bf16*)h, (const bf16*)wr,
                         (const bf16*)wrt, br, (const bf16*)wp,
                         (const bf16*)wpt, bp, dz, (bf16*)hall, dy0, dy1,
                         (bf16*)dh0, part, cap, dwr, dbr, dwp, dbp, st);
  return -2;
}

}  // extern "C"
