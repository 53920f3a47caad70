// The upsampler (the stride-hop SAME transposed conv that turns latent
// frames into the decoder's audio-rate condition), forward and backward,
// and the layout and contraction probes built from the same routines.
//
// Replaces the TPU kernels of the probe scripts:
//   scripts/cond_inkernel_probe.py  _cond_fwd_body (call :91),
//                                   _cond_bwd_body (call :103)
//   scripts/mosaic_dot_probe.py     _try bodies b1..b5 (call :26)
//   scripts/mosaic_reshape_probe.py _case bodies r1..r5 (call :29) and
//                                   comp (call :91)
// The plain PyTorch versions are vqvae_tpu_torch/kernels/upsample_cuda.py.
//
// Math.  e [B, Tl, d] latent frames, uwk [d, 2*hop*d] the flipped taps
// (uwk[i, r*d + c] = w[2*hop-1-r, i, c]), ub [d], T = Tl*hop:
//   a[p, r, c] = sum_i e[p, i] uwk[i, r*d + c]            r < 2*hop
//   cond[t]    = a[p, s] + a[p-1, hop+s] + ub   with t + hop/2 = p*hop + s
// (a frame outside [0, Tl) reads as 0), summed in float32, rounded once to
// e's dtype.  The backward, dcond [B, T, d] float32:
//   da[p]  = dcond rows [p*hop - hop/2, p*hop + 3*hop/2) (0 outside [0, T)),
//            rounded to e's dtype, [2*hop*d]
//   de[p]  = da[p] @ uwk^T            duw = sum_p e[p]^T da[p]
//   dub    = sum_t dcond[t]           (de, duw, dub float32)
//
// Forward design.  The whole map is one product over "output frames"
// q in [0, Tl]: the row [e[q], e[q-1]] (K = 2d) times the packed weight
// [[uwk[:, :hop*d]], [uwk[:, hop*d:]]] gives the hop*d values of audio
// rows q*hop - hop/2 ... q*hop + hop/2 - 1, one contiguous stretch of
// cond.  So the overlap-add is the packing of K, the crop a mask on the
// rows written.  A block owns 64 output frames x 128 columns: it stages
// its frames plus the one halo frame (q0 - 1) and the weight tile in
// shared memory, multiplies (bf16: wmma 16x16x16 into float32; float32:
// scalar FMAs in k order), adds the bias and writes each value once.
// Every output is summed in one fixed order, so runs repeat bit for bit.
//
// Backward design.  da is never materialised: a row of it is a window of
// dcond, read through index math (rows_mm, atb_win).  de is a row-local
// product over K = 2*hop*d, split over K; duw a product over the B*Tl
// rows, split over them; train_common.cuh's reduce_parts adds each one's
// partial sums in a fixed order; dub is its colsum.  No atomics.
//
// What bounds it on the card (vctk-multi: hop 64, d 64, B=16, T=7680):
// the forward does 2.0 GFLOP against 15.7 MB of bf16 output, so the
// bytes bind (~4.7 us at 3.35 TB/s; ~2 us of bf16 tensor-core work); the
// backward does 4.0 GFLOP against dcond's 31.5 MB of float32 (~9.4 us),
// bytes again.  There is no ReLU after the upsampler, so the bf16 sums
// may run on the tensor cores in any order: no mask can flip.
//
// The dot probe's contractions nd,rde->nre, nrd,rde->ne and nd,nre->dre
// are the tap product, de and duw with the overlap-add off; they enter
// tap_fwd, rows_mm and atb_win through vqvae_dot_*.  The overlap-add on
// its own (the probe's pad/add/slice) is ola; the reshape probe's
// layouts are flat_copy, its matmul -> untile -> matmul composition is
// compose, whose [N, hop*d] intermediate stays in shared memory.
#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int FM = 64;     // tap_fwd: output frames per tile
constexpr int FN = 128;    // tap_fwd: columns per tile
constexpr int KMAX = 128;  // tap_fwd: widest K (2d)
constexpr int PAD = 8;     // row padding (elements) of staged tiles

// Tiles move 8 consecutive elements at a time (16 bytes of bf16, 32 of
// float32): every width here is a multiple of 16, every stride and
// offset a multiple of 8 elements, so each group of 8 lies in one row
// and is aligned.
template <typename T>
__device__ __forceinline__ void cp8(T* dst, const T* src) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
    reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
  }
}

template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = fromf<T>(0.f);
}

// 8 floats from float32 memory, rounded to T, into dst
template <typename T>
__device__ __forceinline__ void cvt8(T* dst, const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  if constexpr (sizeof(T) == 2) {
    alignas(16) T o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = fromf<T>(v[i]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = fromf<T>(v[i]);
  }
}

// B[k, n] of the tap product: W[(k % d)*sk + (k / d)*shalf + (n / d)*sr
// + n % d] (uwk packed as above, or the dot probe's W [hop, d, d])
struct TapW {
  long long sk, sr, shalf;
  __device__ __forceinline__ long long at(int k, int n, int d) const {
    return (k % d) * sk + (k / d) * shalf + (long long)(n / d) * sr + n % d;
  }
};

// Y[(g*Trows + q*hop + n/d - off)*d + n%d] = sum_k A[q, k] B[k, n] (+ bias)
// for the Q output frames q of group g = blockIdx.z, where
//   OLA:  A[q] = [e[q], e[q-1]] (K = 2d), e frames outside [0, P) are 0;
//   else: A[q] = e[q] (K = d);
// rows outside [0, Trows) are not written (the SAME crop).
template <typename T, bool OLA>
__global__ void tap_fwd(int P, int Q, int hop, int d, int off, int Trows,
                        const T* __restrict__ e, const T* __restrict__ w,
                        TapW tw, const float* __restrict__ bias,
                        T* __restrict__ y) {
  const int K = OLA ? 2 * d : d, N = hop * d;
  const int LDA = K + PAD, LDB = FN + PAD, LDC = FN + 4;
  T* As = reinterpret_cast<T*>(smem);                      // [FM][LDA]
  T* Bs = reinterpret_cast<T*>(smem + words<T>(FM * LDA)); // [K][LDB]
  float* Cs = smem + words<T>(FM * LDA) + words<T>(KMAX * LDB);  // [FM][LDC]
  const int q0 = blockIdx.x * FM, n0 = blockIdx.y * FN, g = blockIdx.z;
  const int tid = threadIdx.x;
  const T* eg = e + (size_t)g * P * d;
  for (int i = tid; i < FM * K / 8; i += NT) {
    const int r = i / (K / 8), k = (i % (K / 8)) * 8, q = q0 + r;
    const int p = (OLA && k >= d) ? q - 1 : q;
    const int col = (OLA && k >= d) ? k - d : k;
    if (q < Q && p >= 0 && p < P)
      cp8(As + r * LDA + k, eg + (size_t)p * d + col);
    else
      zero8(As + r * LDA + k);
  }
  for (int i = tid; i < K * FN / 8; i += NT) {
    const int k = i / (FN / 8), j = (i % (FN / 8)) * 8, n = n0 + j;
    if (n < N)
      cp8(Bs + k * LDB + j, w + tw.at(k, n, d));
    else
      zero8(Bs + k * LDB + j);
  }
  __syncthreads();
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = tid >> 5, wr = warp >> 1, wc = (warp & 1) * 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + wr * 16 * LDA + k, LDA);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + k * LDB + (wc + f) * 16, LDB);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
      wmma::store_matrix_sync(Cs + wr * 16 * LDC + (wc + f) * 16, acc[f],
                              LDC, wmma::mem_row_major);
  } else {
    // 16 x 16 threads, each 4 rows x 8 columns (stride 16), k in order
    const int tr = tid / 16, tc = tid % 16;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = tof(Bs[k * LDB + tc + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = tof(As[(tr * 4 + i) * LDA + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Cs[(tr * 4 + i) * LDC + tc + 16 * j] = acc[i][j];
  }
  __syncthreads();
  T* yg = y + (size_t)g * Trows * d;
  for (int i = tid; i < FM * FN / 8; i += NT) {
    const int r = i / (FN / 8), j = (i % (FN / 8)) * 8;
    const int n = n0 + j, q = q0 + r;
    if (q >= Q || n >= N) continue;
    const int t = q * hop + n / d - off;
    if (t < 0 || t >= Trows) continue;
    const int c = n % d;
    alignas(16) float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = Cs[r * LDC + j + e] + (bias ? bias[c + e] : 0.f);
    cvt8(yg + (size_t)t * d + c, v);
  }
}

// A window row: row (g, p) of the windowed operand is X[(g*Trows + p*hop
// - off)*d + k] for k < span*d, 0 where its audio row p*hop - off + k/d
// lies outside [0, Trows) (the adjoint of the overlap-add and the crop).
struct Win {
  int P, hop, off, Trows, d;
  // &X[row m, k] for a group of 8 values k..k+7 (one audio row), or
  // nullptr where that row lies outside [0, Trows)
  __device__ __forceinline__ const float* at8(const float* __restrict__ X,
                                              int m, int k) const {
    const int g = m / P, p = m - g * P;
    const int t = p * hop - off + k / d;
    if (t < 0 || t >= Trows) return nullptr;
    return X + ((size_t)g * Trows + t) * d + k % d;
  }
};

constexpr int RM = 32;   // rows_mm: rows per tile
constexpr int RN = 64;   // rows_mm: columns per tile
constexpr int RK = 64;   // rows_mm: K per stage

// part[s][m][c] = sum_k T(A[m, k]) B[k, c] over the k of split s =
// blockIdx.z (kchunk values of K = span*d each), A the window rows of X
// (float32, rounded to T as the probe casts da), B[k, c] = W[k*sk + c*sc];
// float32.  The splits are added in order by reduce_parts.
template <typename T>
__global__ void rows_mm(int M, int K, int Nout, int kchunk, Win win,
                        const float* __restrict__ X, const T* __restrict__ W,
                        long long sk, long long sc, float* __restrict__ part) {
  const int LDA = RK + PAD, LDB = RN + PAD, LDC = RN + 4;
  T* As = reinterpret_cast<T*>(smem);                       // [RM][LDA]
  T* Bs = reinterpret_cast<T*>(smem + words<T>(RM * LDA));  // [RK][LDB]
  float* Cs = smem + words<T>(RM * LDA) + words<T>(RK * LDB);  // [RM][LDC]
  const int m0 = blockIdx.x * RM, c0 = blockIdx.y * RN, tid = threadIdx.x;
  using namespace nvcuda;
  const int warp = tid >> 5, wr = warp >> 2, wc = warp & 3;  // 2 x 4 warps
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  const int tr = tid / 16, tc = tid % 16;   // scalar: 2 rows x 4 columns
  float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  for (int k0 = k_begin; k0 < k_end; k0 += RK) {
    for (int i = tid; i < RM * RK / 8; i += NT) {
      const int r = i / (RK / 8), k = (i % (RK / 8)) * 8, m = m0 + r;
      const float* src =
          (m < M && k0 + k < k_end) ? win.at8(X, m, k0 + k) : nullptr;
      if (src)
        cvt8(As + r * LDA + k, src);
      else
        zero8(As + r * LDA + k);
    }
    // groups of 8 along the unit stride (k for sk == 1, else c), so
    // either layout of B coalesces
    for (int i = tid; i < RK * RN / 8; i += NT) {
      const bool kfast = sk == 1;
      const int k = kfast ? (i % (RK / 8)) * 8 : i / (RN / 8);
      const int c = kfast ? i / (RK / 8) : (i % (RN / 8)) * 8;
      alignas(16) T v[8];
      if (k0 + k < k_end && c0 + c < Nout)
        cp8(v, W + (k0 + k) * sk + (c0 + c) * sc);
      else
        zero8(v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        Bs[(k + (kfast ? e : 0)) * LDB + c + (kfast ? 0 : e)] = v[e];
    }
    __syncthreads();
    if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
      for (int k = 0; k < RK; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, As + wr * 16 * LDA + k, LDA);
        wmma::load_matrix_sync(fb, Bs + k * LDB + wc * 16, LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    } else {
      for (int k = 0; k < RK; ++k) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a = tof(As[(tr * 2 + i) * LDA + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(a, tof(Bs[k * LDB + tc + 16 * j]), sacc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  if constexpr (std::is_same<T, bf16>::value) {
    wmma::store_matrix_sync(Cs + wr * 16 * LDC + wc * 16, acc, LDC,
                            wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(tr * 2 + i) * LDC + tc + 16 * j] = sacc[i][j];
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.z * M * Nout;
  for (int i = tid; i < RM * RN; i += NT) {
    const int r = i / RN, c = i % RN;
    if (m0 + r < M && c0 + c < Nout)
      out[(size_t)(m0 + r) * Nout + c0 + c] = Cs[r * LDC + c];
  }
}

// part[s][i][n] = sum over the rows m of split s of E[m, i] T(A[m, n]),
// A the window rows of X; a 64 x 64 tile per block, 32 rows per stage.
template <typename T>
__global__ void atb_win(int M, int d, int N, int chunk, Win win,
                        const T* __restrict__ E, const float* __restrict__ X,
                        float* __restrict__ part) {
  const int LD = AT + PAD, LDC = AT + 4;
  T* Es = reinterpret_cast<T*>(smem);                        // [AK][LD]
  T* As = reinterpret_cast<T*>(smem + words<T>(AK * LD));    // [AK][LD]
  float* Cs = smem + 2 * words<T>(AK * LD);                  // [AT][LDC]
  const int i0 = blockIdx.x * AT, n0 = blockIdx.y * AT, s = blockIdx.z;
  const int r_begin = s * chunk, r_end = min(M, r_begin + chunk);
  const int tid = threadIdx.x;
  using namespace nvcuda;
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int tm = tid / 16, tn = tid % 16;   // scalar: 4 x 4 per thread
  float sacc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sacc[a][b] = 0.f;
  for (int rb = r_begin; rb < r_end; rb += AK) {
    for (int j = tid; j < AK * AT / 8; j += NT) {
      const int k = j / (AT / 8), c = (j % (AT / 8)) * 8, m = rb + k;
      const bool ok = m < r_end;
      if (ok && i0 + c < d)
        cp8(Es + k * LD + c, E + (size_t)m * d + i0 + c);
      else
        zero8(Es + k * LD + c);
      const float* src = (ok && n0 + c < N) ? win.at8(X, m, n0 + c) : nullptr;
      if (src)
        cvt8(As + k * LD + c, src);
      else
        zero8(As + k * LD + c);
    }
    __syncthreads();
    if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
      for (int kk = 0; kk < AK; kk += 16) {
        // E^T tile: element (i, k) sits at Es[k*LD + i], i.e. column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, Es + kk * LD + wm * 16, LD);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, As + kk * LD + wn * 32 + f * 16, LD);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
    } else {
      for (int k = 0; k < AK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = tof(Es[k * LD + tm * 4 + q]);
          b[q] = tof(As[k * LD + tn * 4 + q]);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) sacc[x][y] = fmaf(a[x], b[y], sacc[x][y]);
      }
    }
    __syncthreads();
  }
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
      wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn * 32 + f * 16, acc[f],
                              LDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) Cs[(tm * 4 + x) * LDC + tn * 4 + y] = sacc[x][y];
  }
  __syncthreads();
  for (int j = tid; j < AT * AT; j += NT) {
    const int i = i0 + j / AT, n = n0 + j % AT;
    if (i < d && n < N) part[((size_t)s * d + i) * N + n] = Cs[(j / AT) * LDC + j % AT];
  }
}

// The overlap-add on its own, the dot probe's pad/add/slice on the time
// axis: y[t] = x[t + off] + x[t + off - hop] over x [Trows, d], a row
// outside [0, Trows) reading as 0, the float32 sum rounded once.  It is
// the upsampler's overlap-add with frames of hop rows (tap_fwd packs that
// sum into its K instead).
template <typename T>
__global__ void ola(int hop, int off, int Trows, int d,
                    const T* __restrict__ x, T* __restrict__ y) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)Trows * d) return;
  const int t = (int)(i / d), c = (int)(i % d), u = t + off;
  float v = 0.f;
  if (u < Trows) v += tof(x[(size_t)u * d + c]);
  if (u >= hop && u - hop < Trows) v += tof(x[(size_t)(u - hop) * d + c]);
  y[i] = fromf<T>(v);
}

// The reshape probe's five layouts (and the dot probe's leading split).
// Each is a row-major reshape of a contiguous tensor, which keeps the flat
// order, so on linear memory the function is a flat copy (on the TPU it
// needed a real relayout of Mosaic's tiles).  A grid-stride copy of
// 16-byte pieces (ld.global.nc.v4, st.global.v4): `head` floats are
// copied one by one until x is 16-byte aligned, then whole float4s, then
// the tail; y takes float4 stores where it is aligned like x (VS), else
// four float stores.  No shared memory, no index math.  Bound: the bytes
// (0.5 MB in and out a layout at the probe's shape: 0.31 us at
// 3.35 TB/s), so in practice the launch.
constexpr int FT = 128;   // flat_copy: threads a block

template <typename I, bool VS>
__global__ void __launch_bounds__(FT)
    flat_copy(I nv, int head, int tail, const float* __restrict__ x,
              float* __restrict__ y) {
  const I i0 = (I)blockIdx.x * FT + threadIdx.x, stride = (I)gridDim.x * FT;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float* yv = y + head;
  for (I v = i0; v < nv; v += stride) {
    const float4 f = __ldg(xv + v);
    if constexpr (VS) {
      reinterpret_cast<float4*>(yv)[v] = f;
    } else {
      yv[4 * v] = f.x;
      yv[4 * v + 1] = f.y;
      yv[4 * v + 2] = f.z;
      yv[4 * v + 3] = f.w;
    }
  }
  if (i0 < head) y[i0] = x[i0];
  if (i0 < tail) yv[4 * nv + i0] = x[head + 4 * nv + i0];
}

template <typename I>
int run_flat_copy(long long n, const float* x, float* y, cudaStream_t st) {
  const int head = (int)std::min<long long>(
      n, ((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / 4);
  const I nv = (I)((n - head) / 4);
  const int tail = (int)(n - head - 4 * (long long)nv);
  const int grid = (int)std::max<long long>(
      1, std::min<long long>(cdiv(nv, FT), 8LL * num_sms()));
  if (reinterpret_cast<uintptr_t>(y + head) % 16 == 0) {
    auto k = flat_copy<I, true>;
    KLAUNCH(k, grid, FT, 0, st, nv, head, tail, x, y);
  } else {
    auto k = flat_copy<I, false>;
    KLAUNCH(k, grid, FT, 0, st, nv, head, tail, x, y);
  }
  return (int)last_error();
}

// out[n*hop + r, j] = sum_c (sum_i x[n, i] w[i, r*d + c]) v[c, j]: the
// tap product, the untile [N, hop*d] -> [N*hop, d] and the row product in
// one kernel.  A block owns CRW rows r of latent row n = blockIdx.y: it
// keeps x[n] and its [CRW, d] slice of the intermediate in shared memory,
// never in device memory.  Float32, each sum in k order.
constexpr int CRW = 16;   // compose: rows r per block

__global__ void compose(int hop, int d, int E, const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ v, float* __restrict__ out) {
  float* xs = smem;            // [d]
  float* as = smem + d;        // [CRW][d]
  const int r0 = blockIdx.x * CRW, n = blockIdx.y, tid = threadIdx.x;
  const int rows = min(CRW, hop - r0);
  for (int i = tid; i < d; i += NT) xs[i] = x[(size_t)n * d + i];
  __syncthreads();
  for (int j = tid; j < rows * d; j += NT) {
    const int r = j / d, c = j % d;
    const float* wc = w + (size_t)(r0 + r) * d + c;
    float a = 0.f;
    for (int i = 0; i < d; ++i) a = fmaf(xs[i], wc[(size_t)i * hop * d], a);
    as[j] = a;
  }
  __syncthreads();
  for (int j = tid; j < rows * E; j += NT) {
    const int r = j / E, c = j % E;
    float o = 0.f;
    for (int k = 0; k < d; ++k) o = fmaf(as[r * d + k], v[(size_t)k * E + c], o);
    out[((size_t)n * hop + r0 + r) * E + c] = o;
  }
}

template <typename T>
size_t fwd_smem(int K) {
  return (size_t)(words<T>(FM * (K + PAD)) + words<T>(KMAX * (FN + PAD)) +
                  FM * (FN + 4)) * sizeof(float);
}

template <typename T>
size_t rows_smem() {
  return (size_t)(words<T>(RM * (RK + PAD)) + words<T>(RK * (RN + PAD)) +
                  RM * (RN + 4)) * sizeof(float);
}

template <typename T>
size_t atb_smem() {
  return (size_t)(2 * words<T>(AK * (AT + PAD)) + AT * (AT + 4)) *
         sizeof(float);
}

// tap product over Q output frames of G groups (see tap_fwd)
template <typename T>
int run_tap_fwd(bool ola_on, int G, int P, int Q, int hop, int d, int off,
                int Trows, const void* e, const void* w, TapW tw,
                const float* bias, void* y, cudaStream_t st) {
  const int K = ola_on ? 2 * d : d;
  if (d < 16 || d % 16 || K > KMAX || hop < 1) return -2;
  const size_t sm = fwd_smem<T>(K);
  auto k = ola_on ? tap_fwd<T, true> : tap_fwd<T, false>;
  VQT_TRY(smem_opt_in(k, sm));
  dim3 grid(cdiv(Q, FM), cdiv((long long)hop * d, FN), G);
  KLAUNCH(k, grid, NT, sm, st, P, Q, hop, d, off, Trows, (const T*)e,
          (const T*)w, tw, bias, (T*)y);
  return (int)last_error();
}

// The split-K policy of run_rows_mm and run_atb_win, about 4 blocks per
// SM, kept in one place: the K (rows) each split takes, and the float32
// scratch a call needs, which the vqvae_*_scratch entry points export so
// that callers size `part` from the same formulas.
inline int rows_kchunk(int M, int K, int Nout) {
  const int tiles = cdiv(M, RM) * cdiv(Nout, RN);
  const int n = std::max(1, std::min(cdiv(4 * 132, tiles), cdiv(K, RK)));
  return cdiv(cdiv(K, n), RK) * RK;
}
inline long long rows_scratch(int M, int K, int Nout) {
  return (long long)cdiv(K, rows_kchunk(M, K, Nout)) * M * Nout;
}
inline int atb_chunk(int M, int d, int N) {
  const int tiles = cdiv(d, AT) * cdiv(N, AT);
  const int n = std::max(1, std::min(cdiv(4 * 132, tiles), cdiv(M, 4 * AK)));
  return cdiv(M, n);
}
inline long long atb_scratch(int M, int d, int N) {
  return (long long)cdiv(M, atb_chunk(M, d, N)) * d * N;
}

// out[M, Nout] = window(X) @ B, split over K (about 4 blocks per SM)
// through the scratch part (-1 if smaller than rows_scratch), the
// splits added in order
template <typename T>
int run_rows_mm(int M, int K, int Nout, Win win, const float* X,
                const void* W, long long sk, long long sc, float* out,
                float* part, long long part_cap, cudaStream_t st) {
  if ((sk != 1 && sc != 1) || (sk % 8 && sc % 8) || win.d % 8 || K % 8 ||
      Nout % 8)
    return -2;
  const int kchunk = rows_kchunk(M, K, Nout), nsplit = cdiv(K, kchunk);
  if ((long long)nsplit * M * Nout > part_cap) return -1;
  const size_t sm = rows_smem<T>();
  auto k = rows_mm<T>;
  VQT_TRY(smem_opt_in(k, sm));
  KLAUNCH(k, dim3(cdiv(M, RM), cdiv(Nout, RN), nsplit), NT, sm, st, M, K,
          Nout, kchunk, win, X, (const T*)W, sk, sc, part);
  VQT_TRY(last_error());
  KLAUNCH(reduce_parts, cdiv((long long)M * Nout, NT), NT, 0, st, nsplit,
          M * Nout, part, out, 0);
  return (int)last_error();
}

// out[d, N] = sum_m E[m]^T window(m): split-K partials (-1 if part is
// smaller than atb_scratch), then reduce_parts adds them in split order
template <typename T>
int run_atb_win(int M, int d, int N, Win win, const void* E, const float* X,
                float* out, float* part, long long part_cap, cudaStream_t st) {
  if (d % 8 || N % 8) return -2;
  const int chunk = atb_chunk(M, d, N), nsplit = cdiv(M, chunk);
  if ((long long)nsplit * d * N > part_cap) return -1;
  const size_t sm = atb_smem<T>();
  auto k = atb_win<T>;
  VQT_TRY(smem_opt_in(k, sm));
  KLAUNCH(k, dim3(cdiv(d, AT), cdiv(N, AT), nsplit), NT, sm, st, M, d, N,
          chunk, win, (const T*)E, X, part);
  VQT_TRY(last_error());
  KLAUNCH(reduce_parts, cdiv((long long)d * N, NT), NT, 0, st, nsplit,
          d * N, part, out, 0);
  return (int)last_error();
}

// The upsampler's backward (see the header): de, duw (split-K, reduced
// in a fixed order) and dub (column sums), each through scratch `part`.
template <typename T>
int run_cond_bwd(int B, int Tl, int hop, int d, const float* dcond,
                 const void* e, const void* uwk, float* de, float* duw,
                 float* dub, float* part, long long part_cap,
                 cudaStream_t st) {
  const int Trows = Tl * hop, K = 2 * hop * d;
  const Win win{Tl, hop, hop / 2, Trows, d};
  // de[m, i] = sum_k da[m, k] uwk[i, k]: B[k, i] = uwk[i*K + k]
  VQT_TRY(run_rows_mm<T>(B * Tl, K, d, win, dcond, uwk, 1, K, de, part,
                         part_cap, st));
  VQT_TRY(run_atb_win<T>(B * Tl, d, K, win, e, dcond, duw, part, part_cap,
                         st));
  return colsum(1, B * Trows, d, dcond, d, dub, 0, part, part_cap, st);
}

template <typename F>
int by_dtype(int dtype, F f) {
  if (dtype == 0) return f(float{});
  if (dtype == 1) return f(bf16{});
  return -2;
}

}  // namespace

extern "C" {

// cond [B, Tl*hop, d] from e [B, Tl, d], uwk [d, 2*hop*d] (both dtype:
// 0 float32, 1 bfloat16) and ub [d] float32.  Returns 0, a CUDA error,
// or -2 for shapes the kernel does not take.
int vqvae_cond_fwd(int dtype, int B, int Tl, int hop, int d, const void* e,
                   const void* uwk, const float* ub, void* cond,
                   void* stream) {
  if (B < 1 || Tl < 1 || hop < 2 || hop % 2) return -2;
  const TapW tw{2LL * hop * d, d, (long long)hop * d};
  return by_dtype(dtype, [&](auto z) {
    using T = decltype(z);
    return run_tap_fwd<T>(true, B, Tl, Tl + 1, hop, d, hop / 2, Tl * hop, e,
                          uwk, tw, ub, cond, (cudaStream_t)stream);
  });
}

// The float32 scratch vqvae_cond_bwd needs: the largest of de's and duw's
// split-K partials and dub's column-sum parts.
long long vqvae_cond_bwd_scratch(int B, int Tl, int hop, int d) {
  const int M = B * Tl, K = 2 * hop * d;
  return std::max({rows_scratch(M, K, d), atb_scratch(M, d, K),
                   (long long)cdiv((long long)M * hop, CR) * d});
}

// de [B, Tl, d], duw [d, 2*hop*d], dub [d] (float32) from dcond [B, Tl*hop,
// d] float32, e and uwk (dtype); part: float32 scratch of part_cap floats
// (-1 if fewer than vqvae_cond_bwd_scratch).
int vqvae_cond_bwd(int dtype, int B, int Tl, int hop, int d,
                   const float* dcond, const void* e, const void* uwk,
                   float* de, float* duw, float* dub, float* part,
                   long long part_cap, void* stream) {
  if (B < 1 || Tl < 1 || hop < 2 || hop % 2 || d < 1) return -2;
  return by_dtype(dtype, [&](auto z) {
    return run_cond_bwd<decltype(z)>(B, Tl, hop, d, dcond, e, uwk, de, duw,
                                     dub, part, part_cap,
                                     (cudaStream_t)stream);
  });
}

// nd,rde->nre: out [N, hop, d] (dtype) = e [N, d] x W [hop, d, d]; the tap
// product with the overlap-add off
int vqvae_dot_nre(int dtype, int N, int hop, int d, const void* e,
                  const void* w, void* out, void* stream) {
  if (N < 1 || hop < 1) return -2;
  const TapW tw{d, (long long)d * d, 0};
  return by_dtype(dtype, [&](auto z) {
    return run_tap_fwd<decltype(z)>(false, 1, N, N, hop, d, 0, N * hop, e, w,
                                    tw, nullptr, out, (cudaStream_t)stream);
  });
}

// The float32 scratch of vqvae_dot_ne and of vqvae_dot_dre.
long long vqvae_dot_ne_scratch(int N, int hop, int d) {
  return rows_scratch(N, hop * d, d);
}
long long vqvae_dot_dre_scratch(int N, int hop, int d) {
  return atb_scratch(N, d, hop * d);
}

// nrd,rde->ne: out [N, d] float32 = dp [N, hop, d] (float32, rounded to
// dtype) x W [hop, d, d] (dtype); the upsampler's de with windows of hop
// rows and no overlap
int vqvae_dot_ne(int dtype, int N, int hop, int d, const float* dp,
                 const void* w, float* out, float* part, long long part_cap,
                 void* stream) {
  if (N < 1 || hop < 1 || d < 1) return -2;
  const Win win{N, hop, 0, N * hop, d};
  return by_dtype(dtype, [&](auto z) {
    return run_rows_mm<decltype(z)>(N, hop * d, d, win, dp, w, d, 1, out,
                                    part, part_cap, (cudaStream_t)stream);
  });
}

// nd,nre->dre: out [d, hop, d] float32 = sum_n e[n]^T dp[n]; the
// upsampler's duw with windows of hop rows and no overlap
int vqvae_dot_dre(int dtype, int N, int hop, int d, const void* e,
                  const float* dp, float* out, float* part,
                  long long part_cap, void* stream) {
  if (N < 1 || hop < 1 || d < 1) return -2;
  const Win win{N, hop, 0, N * hop, d};
  return by_dtype(dtype, [&](auto z) {
    return run_atb_win<decltype(z)>(N, d, hop * d, win, e, dp, out, part,
                                    part_cap, (cudaStream_t)stream);
  });
}

// The overlap-add on its own: y [Trows, d] from x [Trows, d] (see ola);
// the dot probe's pad/add/slice is off = hop/2.
int vqvae_ola(int dtype, int Trows, int hop, int off, int d, const void* x,
              void* y, void* stream) {
  if (Trows < 1 || hop < 1 || off < 0 || d < 1) return -2;
  return by_dtype(dtype, [&](auto z) {
    using T = decltype(z);
    KLAUNCH(ola<T>, cdiv((long long)Trows * d, NT), NT, 0,
            (cudaStream_t)stream, hop, off, Trows, d, (const T*)x, (T*)y);
    return (int)last_error();
  });
}

// y [n] = x [n], float32 (a reshape of contiguous x: see flat_copy); x and
// y 4-byte aligned.
int vqvae_relayout(long long n, const float* x, float* y, void* stream) {
  if (n < 1) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  return n < (1LL << 31) ? run_flat_copy<int>(n, x, y, st)
                         : run_flat_copy<long long>(n, x, y, st);
}

// out [N*hop, E] = ((x [N, d] @ w [d, hop*d]).reshape(N*hop, d)) @ v [d, E],
// float32, in one kernel
int vqvae_compose(int N, int hop, int d, int E, const float* x,
                  const float* w, const float* v, float* out, void* stream) {
  if (N < 1 || hop < 1 || d < 1 || E < 1) return -2;
  const size_t sm = (size_t)(d + CRW * d) * sizeof(float);
  if (sm > 227 * 1024) return -2;
  VQT_TRY(smem_opt_in(compose, sm));
  KLAUNCH(compose, dim3(cdiv(hop, CRW), N), NT, sm, (cudaStream_t)stream,
          hop, d, E, x, w, v, out);
  return (int)last_error();
}

}  // extern "C"
