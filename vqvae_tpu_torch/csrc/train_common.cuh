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
// Tensor-core products (bf16): mma.sync m16n8k16 on fragments that
// ldmatrix reads from shared memory (warp_mm), tiles arriving by 16-byte
// cp.async; the weight-gradient product (atb_part_tc) streams its rows
// through a 3-stage ring.
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

// ---- tensor-core and async-copy primitives (PTX) ----
// The bf16 tile products below run on mma.sync m16n8k16 (bf16 inputs,
// float32 accumulators) from fragments that ldmatrix reads out of shared
// memory; tiles reach shared memory by 16-byte cp.async copies.  The
// encoder's exact products run on the FP64 tensor cores (mma_f64).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global src to shared dst, asynchronously; zero-filled
// (src not read) when !valid
__device__ __forceinline__ void async_copy16(void* dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and receives row l / 4, columns 2(l % 4) .. +1 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed: lane l receives column l / 4, rows
// 2(l % 4) .. +1
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] b[16x8]: bf16 products, exact, summed in float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[16x8] += a[16x16] b[16x8] on the FP64 tensor cores (m16n8k16, sm_90):
// float64 products and sums.  Lane l, with g = l / 4 and t = l % 4, holds
// a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g] and
// d[q] = D[g + 8 (q / 2)][2 t + q % 2].
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Thread-block clusters (upsample.cu, vq.cu): the block's rank, a barrier
// over every thread of the cluster, and stores to and loads from another
// block's shared memory (distributed shared memory).
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// release/acquire: what a block wrote to its shared memory before it is
// visible to all after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// the same barrier in two halves: a block arrives early (at its start,
// say) and waits where it next needs the others (before it first writes
// to another block's shared memory, which must have started)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
// ... or after stores that the others read once they have waited
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// the address of local shared address p in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(cluster_addr(p, rank)),
               "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster(int* p, int rank, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(cluster_addr(p, rank)),
               "r"(v)
               : "memory");
}

// 16 bytes (callers load every rank before adding, so the loads issue
// together)
__device__ __forceinline__ float4 ld_cluster4(const void* p, int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}
// ---- end of PTX primitives ----

// Warp-level tile products on those primitives.  Shared-memory tiles are
// bf16 rows padded by SP elements (16 bytes), so the 8 row addresses of
// an ldmatrix fall in 8 different bank groups.  Accumulator layout
// (mma's): lane l holds acc[j][q] = C[r][c] with r = (l / 4) + 8 (q / 2),
// c = 8 j + 2 (l % 4) + (q % 2).
constexpr int SP = 8;

// acc[j] += A[16 rows][K] B[K][n0 + 8j .. +8) for j < NJ (NJ even);
// A row-major (row stride lda, the warp's first row at A), B row-major
// [K][ldb]; K a multiple of 16
template <int NJ>
__device__ __forceinline__ void warp_mm(float (&acc)[NJ][4], const bf16* A,
                                        int lda, const bf16* B, int ldb,
                                        int K, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* ap = A + (lane & 15) * lda + ((lane >> 4) << 3);
  const bf16* bp = B + (lane & 15) * ldb + n0 + ((lane >> 4) << 3);
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    ldsm_x4(a, ap + k);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, bp + (size_t)k * ldb + 8 * j);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero_acc(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
}

// copy a [rows][C] bf16 global matrix (row stride ld) into shared memory
// [rows][C + SP] by 16-byte async copies of all nthr threads (C % 8 == 0)
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int rows, int C, int ld,
                                           int nthr) {
  const int cpr = C / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += nthr) {
    const int r = e / cpr, c = (e - r * cpr) * 8;
    async_copy16(dst + r * (C + SP) + c, src + (size_t)r * ld + c, true);
  }
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
// tile and c < ncols, into float32 shared memory: the scalar mac above,
// each output summed in k order, which is also the order the plain
// version's products sum in on the card: a forward product whose result
// is rounded to bf16 and then fed through a ReLU or a gate keeps that
// order, so the kernel's forward equals the plain version's bit for bit
// instead of flipping roundings.
template <int CT, typename T>
__device__ __forceinline__ void tile_mm(float* out, int ldo, const T* X,
                                        int ldx, const T* __restrict__ W,
                                        int ldw, int K, int ncols) {
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;
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

// The same product on the tensor cores, for a bfloat16 compute dtype.
// A block of ATC_NT = 128 threads owns a 64x64 tile of one split; its 4
// warps (2 x 2) each own a 32x32 quarter.  The split's rows stream
// through a ring of ASTAGES stages of KS rows, A' [KS][64] and B'
// [KS][64] in bf16: bf16 operands arrive by 16-byte cp.async (rows that
// the causal shift or the row map leaves out are zero-filled), float32
// ones (the encoder's cotangents) are read 16 bytes at a time and rounded
// to bf16 as they are stored, where rnd<bf16> rounds them in atb_part.
// The stage that has landed feeds ldmatrix + mma.sync while the next two
// load; ReLU applies to A's fragments.  Every product of two bf16 values
// is exact; only the float32 sum order differs from atb_part.
constexpr int KS = 64;          // rows per stage
constexpr int ASTAGES = 3;
constexpr int ATC_NT = 128;
constexpr int ALD = AT + SP;    // staged row stride (elements)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// both bf16 halves of x with the sign bit set become 0
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t x) {
  return x & ~(((x >> 15) & 0x00010001u) * 0xFFFFu);
}

// src[0 .. n) (n <= 8, the rest 0) as 8 bf16 at dst (16-byte aligned);
// vec: src is 16-byte aligned and n is 0 or 8.  With n == 0, src is any
// valid address and is not read.
template <typename TS>
__device__ __forceinline__ void stage8(bf16* dst, const TS* src, int n,
                                       bool vec) {
  if constexpr (std::is_same<TS, bf16>::value) {
    if (vec) {
      async_copy16(dst, src, n > 0);
      return;
    }
  } else {
    if (vec && n == 8) {
      const float4 x = reinterpret_cast<const float4*>(src)[0];
      const float4 y = reinterpret_cast<const float4*>(src)[1];
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                     pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
      return;
    }
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack_bf16(2 * i < n ? tof(src[2 * i]) : 0.f,
                     2 * i + 1 < n ? tof(src[2 * i + 1]) : 0.f);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename TA, typename TB, bool MAP>
__global__ void __launch_bounds__(ATC_NT)
    atb_part_tc(int rows, RowMap map, const TA* __restrict__ A, int lda,
                int M, int shift, int relu, const TB* __restrict__ B,
                int ldb, int N, int chunk, int avec, int bvec,
                float* __restrict__ part) {
  bf16* ring = reinterpret_cast<bf16*>(smem);   // [ASTAGES][2][KS][ALD]
  const int m0 = blockIdx.x * AT, n0 = blockIdx.y * AT, s = blockIdx.z;
  const int r_begin = s * chunk;
  const int r_end = min(rows, r_begin + chunk);
  const int nst = (r_end - r_begin + KS - 1) / KS;
  const int ma = min(AT, M - m0), nb = min(AT, N - n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;

  auto load = [&](int st) {
    bf16* As = ring + (size_t)(st % ASTAGES) * 2 * KS * ALD;
    bf16* Bs = As + KS * ALD;
    const int rb = r_begin + st * KS;
    for (int e = tid; e < KS * (AT / 8); e += ATC_NT) {
      const int k = e / (AT / 8), c = (e % (AT / 8)) * 8, row = rb + k;
      long long ar = -1, br = -1;
      if (row < r_end) {
        if constexpr (MAP) {
          ar = map.a_row(row, shift);
          br = map.b_row(row);
        } else {
          if (shift == 0 || row % map.seg >= shift) ar = row - shift;
          br = row;
        }
      }
      const int na = ar >= 0 ? max(0, min(8, ma - c)) : 0;
      const int nn = br >= 0 ? max(0, min(8, nb - c)) : 0;
      stage8(As + k * ALD + c, na > 0 ? A + (size_t)ar * lda + m0 + c : A,
             na, avec);
      stage8(Bs + k * ALD + c, nn > 0 ? B + (size_t)br * ldb + n0 + c : B,
             nn, bvec);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) zero_acc(acc[i]);
  if (nst > 0) load(0);
  async_commit();
  if (nst > 1) load(1);
  async_commit();
  for (int st = 0; st < nst; ++st) {
    async_wait<1>();   // stage st has landed (st + 1 may be in flight)
    __syncthreads();   // ... for every thread; stage st - 1 is consumed
    if (st + 2 < nst) load(st + 2);
    async_commit();
    const bf16* As = ring + (size_t)(st % ASTAGES) * 2 * KS * ALD;
    const bf16* Bs = As + KS * ALD;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      // A'^T fragments: element (m, k) sits at As[k][m], so transposed
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4_t(a[i], As + (kk + (lane & 7) + ((lane >> 4) << 3)) * ALD +
                            wm * 32 + i * 16 + (((lane >> 3) & 1) << 3));
        if (relu)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[i][q] = relu_bf16x2(a[i][q]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b[4];
        ldsm_x4_t(b, Bs + (kk + (lane & 15)) * ALD + wn * 32 + jj * 16 +
                         ((lane >> 4) << 3));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + (lane >> 2) + 8 * h;
        const int n = n0 + wn * 32 + 8 * j + 2 * (lane & 3);
        if (m >= M) continue;
        float* o = part + ((size_t)s * M + m) * N + n;
        if (n < N) o[0] = acc[i][j][2 * h];
        if (n + 1 < N) o[1] = acc[i][j][2 * h + 1];
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

// streaming multiprocessors of the current device (persistent grids and
// the split-K policy of the tensor-core products)
inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess && v > 0)
      n = v;
    else
      n = 132;
  }
  return n;
}

// whether a [rows, ld] operand read `width` columns at a time can be
// staged in 16-byte pieces: aligned base and stride, width % 8 == 0
template <typename T>
inline int vec_ok(const T* p, int ld, int width) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
          (ld * sizeof(T)) % 16 == 0 && width % 8 == 0) ? 1 : 0;
}

#define VQT_TRY_CUDA(x)                            \
  do {                                             \
    cudaError_t _e = (x);                          \
    if (_e != cudaSuccess) return (int)_e;         \
  } while (0)

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
  constexpr bool tc = std::is_same<TC, bf16>::value;
  const int tiles = cdiv(M, AT) * cdiv(N, AT);
  // ~4 blocks per SM, each split at least 4 stages long
  int nsplit = cdiv(4 * (tc ? num_sms() : 132), tiles);
  nsplit = std::max(1, std::min(nsplit, cdiv(rows, 4 * (tc ? KS : AK))));
  const long long fit = part_cap / ((long long)M * N);
  if (fit < 1) return -1;
  nsplit = (int)std::min((long long)nsplit, fit);
  const int chunk = cdiv(rows, nsplit);
  nsplit = cdiv(rows, chunk);
  dim3 grid(cdiv(M, AT), cdiv(N, AT), nsplit);
  const bool ident = map.identity();
  if constexpr (tc) {
    const size_t sm = (size_t)ASTAGES * 2 * KS * ALD * sizeof(bf16);
    auto kern = ident ? atb_part_tc<TA, TB, false> : atb_part_tc<TA, TB, true>;
    VQT_TRY_CUDA(smem_opt_in(kern, sm));
    KLAUNCH(kern, grid, ATC_NT, sm, st, rows, map, A, lda, M, shift, relu, B,
            ldb, N, chunk, vec_ok(A, lda, M), vec_ok(B, ldb, N), part);
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
