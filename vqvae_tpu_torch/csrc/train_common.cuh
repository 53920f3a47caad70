// Shared pieces of the training kernels (wavenet_train.cu, head_ce.cu).
//
// Storage types: float or __nv_bfloat16 (the compute dtype, "cdt").
// Every product reads cdt values, multiplies in float32 and sums in
// float32, so a bf16 x bf16 product is exact and only the sum rounds,
// as on the TPU's MXU with preferred_element_type=float32.
//
// Row-tile products (mac): a block of NT = 256 threads owns TM = 32
// rows held in shared memory as float32; warp w owns rows w, w+8, w+16,
// w+24 and lane l the columns l, l+32, l+64, ...  At each k a warp
// reads one shared-memory word per row (a broadcast) and CT weights
// (32 consecutive columns per load, coalesced), then does RT*CT FMAs.
// The weights are read from global memory through L1/L2.
//
// Cross-block sums are deterministic: every block writes its partial
// sum into its own slab, and a second kernel adds the slabs in a fixed
// order (reduce_parts, seg_reduce).  No atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#ifndef KLAUNCH
#define KLAUNCH(k, g, b, s, st, ...) k<<<(g), (b), (s), (st)>>>(__VA_ARGS__)
#endif

// dynamic shared memory of every kernel (float32 words; 128-byte
// aligned for the tensor-core fragment loads)
extern __shared__ __align__(128) float smem[];

namespace vqt {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;   // threads per block
constexpr int TM = 32;    // rows per row tile
constexpr int RG = 8;     // row groups (warps)
constexpr int RT = TM / RG;

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T fromf(float x);
template <> __device__ __forceinline__ float fromf<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 fromf<bf16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch and XLA
}

// x rounded to T and back to float
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return tof(fromf<T>(x));
}

// acc[i][j] += sum_k X[(rg + RG*i)*ldx + k] * W[k*ldw + cg + 32*j]
// X: float32 rows in shared memory; W: global, row-major [K, ldw];
// columns at or beyond ncols contribute 0.
template <int CT, typename TX, typename TW>
__device__ __forceinline__ void mac(float (&acc)[RT][CT], const TX* X,
                                    int ldx, const TW* __restrict__ W,
                                    int ldw, int K, int ncols, int rg,
                                    int cg) {
  for (int k = 0; k < K; ++k) {
    float w[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = cg + 32 * j;
      w[j] = c < ncols ? tof(W[(size_t)k * ldw + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float x = tof(X[(rg + RG * i) * ldx + k]);
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
    }
  }
}

// out[r*ldo + c] = sum_k X[r*ldx + k] * W[k*ldw + c] for the TM rows of a
// tile and c < ncols, into float32 shared memory.  With TC and a bfloat16
// T it runs on the tensor cores: 16x16x16 bf16 fragments (X from shared
// memory, W straight from global memory) into float32 accumulators, one
// 16x16 output tile per warp at a time (K and ncols multiples of 16).
// Otherwise it is the scalar mac above, each output summed in k order,
// which is also the order the plain version's products sum in on the
// card: a forward product whose result is rounded to bf16 and then fed
// through a ReLU or a gate keeps that order, so the kernel's forward
// equals the plain version's bit for bit instead of flipping roundings.
template <int CT, bool TC, typename T>
__device__ __forceinline__ void tile_mm(float* out, int ldo, const T* X,
                                        int ldx, const T* __restrict__ W,
                                        int ldw, int K, int ncols) {
  const int tid = threadIdx.x;
  if constexpr (TC && std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int ntiles = (TM / 16) * (ncols / 16);
    for (int tile = tid >> 5; tile < ntiles; tile += RG) {
      const int tr = tile % (TM / 16), tc = tile / (TM / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, X + tr * 16 * ldx + k, ldx);
        wmma::load_matrix_sync(fb, W + (size_t)k * ldw + tc * 16, ldw);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(out + tr * 16 * ldo + tc * 16, acc, ldo,
                              wmma::mem_row_major);
    }
  } else {
    const int cg = tid & 31, rg = tid >> 5;
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
    mac<CT>(acc, X, ldx, W, ldw, K, ncols, rg, cg);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = cg + 32 * j;
        if (c < ncols) out[(rg + RG * i) * ldo + c] = acc[i][j];
      }
  }
}

// float32 words of shared memory that n elements of T take, rounded up
// to 32 bytes (the fragment loads' alignment)
template <typename T> __host__ __device__ constexpr int words(int n) {
  return (int)(((size_t)n * sizeof(T) + 31) / 32 * 8);
}

// ---------------------------------------------------------------------------
// C = A'^T B' summed over rows, split over blocks (split-K):
//   part[s][m][n] = sum over the rows of split s of A'[row][m] * B'[row][n]
// The rows come in segments of seg (one batch row each).  Row r of
// segment g maps to row g*aseg + aoff + r of A and g*bseg + boff + r of
// B: the identity when aseg = bseg = seg and aoff = boff = 0, and a time
// window of longer rows (the windowed backward) otherwise.
// A'[row] = A[mapped row - shift] where aoff + r >= shift, else 0 (the
// causal shift inside each batch row), optionally ReLU'd;
// B'[row] = B[mapped row] rounded to TC (a float32 B rounded to the
// compute dtype, as the TPU kernel casts its cotangents before a product).
// Tile 64x64 per block, 4x4 outputs per thread, 32 rows per stage.
// ---------------------------------------------------------------------------

struct RowMap {
  int seg, aseg, aoff, bseg, boff;
  bool identity() const {
    return aseg == seg && aoff == 0 && bseg == seg && boff == 0;
  }
  // row of A and of B for row `row` of a mapped product (the kernels
  // take their identity-map path, MAP = false, without these); the A
  // row is -1 where the causal shift reads before the segment's start
  __device__ __forceinline__ long long a_row(int row, int shift) const {
    const int g = row / seg, r = row - g * seg;
    if (aoff + r < shift) return -1;
    return (long long)g * aseg + aoff + r - shift;
  }
  __device__ __forceinline__ long long b_row(int row) const {
    const int g = row / seg;
    return (long long)g * bseg + boff + row - g * seg;
  }
};

constexpr int AT = 64;    // output tile edge
constexpr int AK = 32;    // rows per shared-memory stage

template <typename TA, typename TB, typename TC, bool MAP>
__global__ void atb_part(int rows, RowMap map, const TA* __restrict__ A,
                         int lda, int M, int shift, int relu,
                         const TB* __restrict__ B, int ldb, int N,
                         int chunk, float* __restrict__ part) {
  float* As = smem;              // [AK][AT]
  float* Bs = smem + AK * AT;    // [AK][AT]
  const int m0 = blockIdx.x * AT, n0 = blockIdx.y * AT, s = blockIdx.z;
  const int r_begin = s * chunk;
  const int r_end = min(rows, r_begin + chunk);
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int rb = r_begin; rb < r_end; rb += AK) {
    for (int e = tid; e < AK * AT; e += NT) {
      const int k = e / AT, m = e % AT, row = rb + k;
      float a = 0.f, b = 0.f;
      if (row < r_end) {
        if constexpr (MAP) {
          const long long ar = map.a_row(row, shift);
          if (m0 + m < M && ar >= 0) {
            a = tof(A[(size_t)ar * lda + m0 + m]);
            if (relu) a = fmaxf(a, 0.f);
          }
          if (n0 + m < N)
            b = rnd<TC>(tof(B[(size_t)map.b_row(row) * ldb + n0 + m]));
        } else {
          if (m0 + m < M && (shift == 0 || (row % map.seg) >= shift)) {
            a = tof(A[(size_t)(row - shift) * lda + m0 + m]);
            if (relu) a = fmaxf(a, 0.f);
          }
          if (n0 + m < N) b = rnd<TC>(tof(B[(size_t)row * ldb + n0 + m]));
        }
      }
      As[e] = a;
      Bs[e] = b;
    }
    __syncthreads();
    for (int k = 0; k < AK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * AT + tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * AT + tn * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < N) part[((size_t)s * M + m) * N + n] = acc[i][j];
    }
  }
}

// The same product on the tensor cores, for a bfloat16 compute dtype:
// A' and B' are staged in shared memory as bf16 (B' rounded there, as
// rnd<bf16> does), and each of the 8 warps multiplies a 16x32 strip of
// the 64x64 tile with 16x16x16 bf16 fragments into float32 accumulators.
// Every product of two bf16 values is exact; only the float32 sum order
// differs from atb_part.
template <typename TA, typename TB, bool MAP>
__global__ void atb_part_tc(int rows, RowMap map, const TA* __restrict__ A,
                            int lda, int M, int shift, int relu,
                            const TB* __restrict__ B, int ldb, int N,
                            int chunk, float* __restrict__ part) {
  using namespace nvcuda;
  bf16* As = reinterpret_cast<bf16*>(smem);     // [AK][AT]
  bf16* Bs = As + AK * AT;                      // [AK][AT]
  float* Cs = smem + AK * AT;                   // [AT][AT], after As, Bs
  const int m0 = blockIdx.x * AT, n0 = blockIdx.y * AT, s = blockIdx.z;
  const int r_begin = s * chunk;
  const int r_end = min(rows, r_begin + chunk);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;      // 4 x 2 warps
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int rb = r_begin; rb < r_end; rb += AK) {
    for (int e = tid; e < AK * AT; e += NT) {
      const int k = e / AT, m = e % AT, row = rb + k;
      float a = 0.f, b = 0.f;
      if (row < r_end) {
        if constexpr (MAP) {
          const long long ar = map.a_row(row, shift);
          if (m0 + m < M && ar >= 0) {
            a = tof(A[(size_t)ar * lda + m0 + m]);
            if (relu) a = fmaxf(a, 0.f);
          }
          if (n0 + m < N) b = tof(B[(size_t)map.b_row(row) * ldb + n0 + m]);
        } else {
          if (m0 + m < M && (shift == 0 || (row % map.seg) >= shift)) {
            a = tof(A[(size_t)(row - shift) * lda + m0 + m]);
            if (relu) a = fmaxf(a, 0.f);
          }
          if (n0 + m < N) b = tof(B[(size_t)row * ldb + n0 + m]);
        }
      }
      As[e] = __float2bfloat16(a);
      Bs[e] = __float2bfloat16(b);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AK; kk += 16) {
      // A'^T tile: element (m, k) sits at As[k*AT + m], i.e. column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, As + kk * AT + wm * 16, AT);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * AT + wn * 32 + f * 16, AT);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(Cs + (wm * 16) * AT + wn * 32 + f * 16, acc[f],
                            AT, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < AT * AT; e += NT) {
    const int m = m0 + e / AT, n = n0 + e % AT;
    if (m < M && n < N) part[((size_t)s * M + m) * N + n] = Cs[e];
  }
}

// out[e] (+)= sum over p of part[p][e], p = 0, 1, ... in order; with
// accumulate the sum is added to out (a later time window's share)
__global__ void reduce_parts(int nsplit, int MN, const float* __restrict__ part,
                             float* __restrict__ out, int accumulate) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= MN) return;
  float s = 0.f;
  for (int p = 0; p < nsplit; ++p) s += part[(size_t)p * MN + e];
  out[e] = accumulate ? out[e] + s : s;
}

// Column sums of a float32 [nseg * seglen, C] matrix (row stride ldx) by
// row chunks of CR rows: part[(seg*nparts + p)*C + c]; grid (nparts, nseg).
constexpr int CR = 256;

__global__ void colsum_part(int seglen, int C, const float* __restrict__ X,
                            int ldx, float* __restrict__ part) {
  const int p = blockIdx.x, seg = blockIdx.y, nparts = gridDim.x;
  const int r0 = p * CR, r1 = min(seglen, r0 + CR);
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r)
      s += X[((size_t)seg * seglen + r) * ldx + c];
    part[((size_t)seg * nparts + p) * C + c] = s;
  }
}

// out[seg*ostride + c] (+)= sum over p of part[(seg*nparts + p)*C + c]
__global__ void seg_reduce(int nparts, int C, const float* __restrict__ part,
                           float* __restrict__ out, int ostride,
                           int accumulate) {
  const int seg = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += NT) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p)
      s += part[((size_t)seg * nparts + p) * C + c];
    float* o = out + (size_t)seg * ostride + c;
    *o = accumulate ? *o + s : s;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline cudaError_t last_error() { return cudaGetLastError(); }

// allow more than 48 KB of dynamic shared memory where a kernel needs it
template <typename K>
inline cudaError_t smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// out[M, N] (+)= A'^T B' over `rows` rows (see atb_part), through the
// scratch `part` of part_cap floats; returns 0 or a CUDA error, or -1 if
// the scratch is too small.  The row map defaults to the identity over
// segments of seg rows.
template <typename TA, typename TB, typename TC>
inline int atb(int rows, int seg, const TA* A, int lda, int M, int shift,
               int relu, const TB* B, int ldb, int N, float* out, float* part,
               long long part_cap, cudaStream_t st, int accumulate = 0,
               RowMap map = RowMap{0, 0, 0, 0, 0}) {
  if (map.seg == 0) map = RowMap{seg, seg, 0, seg, 0};
  const int tiles = cdiv(M, AT) * cdiv(N, AT);
  int nsplit = cdiv(4 * 132, tiles);             // ~4 blocks per SM
  nsplit = std::max(1, std::min(nsplit, cdiv(rows, 4 * AK)));
  const long long fit = part_cap / ((long long)M * N);
  if (fit < 1) return -1;
  nsplit = (int)std::min((long long)nsplit, fit);
  const int chunk = cdiv(rows, nsplit);
  nsplit = cdiv(rows, chunk);
  dim3 grid(cdiv(M, AT), cdiv(N, AT), nsplit);
  const bool ident = map.identity();
  if constexpr (std::is_same<TC, bf16>::value) {
    // As and Bs (bf16) fill the first AK*AT floats, Cs follows
    const size_t sm = (AK * AT + AT * AT) * sizeof(float);
    auto kern = ident ? atb_part_tc<TA, TB, false> : atb_part_tc<TA, TB, true>;
    KLAUNCH(kern, grid, NT, sm, st, rows, map, A, lda, M, shift, relu, B,
            ldb, N, chunk, part);
  } else {
    const size_t sm = 2 * AK * AT * sizeof(float);
    auto kern = ident ? atb_part<TA, TB, TC, false> : atb_part<TA, TB, TC, true>;
    KLAUNCH(kern, grid, NT, sm, st, rows, map, A, lda, M, shift, relu, B,
            ldb, N, chunk, part);
  }
  cudaError_t e = last_error();
  if (e != cudaSuccess) return (int)e;
  KLAUNCH(reduce_parts, cdiv((long long)M * N, NT), NT, 0, st, nsplit, M * N,
          part, out, accumulate);
  return (int)last_error();
}

// out[seg*ostride + c] (+)= column sums of each of nseg row segments of X
inline int colsum(int nseg, int seglen, int C, const float* X, int ldx,
                  float* out, int ostride, float* part, long long part_cap,
                  cudaStream_t st, int accumulate = 0) {
  const int nparts = cdiv(seglen, CR);
  if ((long long)nseg * nparts * C > part_cap) return -1;
  KLAUNCH(colsum_part, dim3(nparts, nseg), NT, 0, st, seglen, C, X, ldx,
          part);
  cudaError_t e = last_error();
  if (e != cudaSuccess) return (int)e;
  KLAUNCH(seg_reduce, nseg, NT, 0, st, nparts, C, part, out, ostride,
          accumulate);
  return (int)last_error();
}

}  // namespace vqt

#define VQT_TRY(x)              \
  do {                          \
    int _rc = (int)(x);         \
    if (_rc != 0) return _rc;   \
  } while (0)
