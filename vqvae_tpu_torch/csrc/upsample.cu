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
// Frames.  Both directions are one product over "output frames": the
// flat frame row m = b*(Tl+1) + u (u in [0, Tl]) pairs
//   A[m] = [e[b, u], e[b, u-1]]          (K2 = 2d; a frame outside [0, Tl)
//                                         reads as 0)
//   D[m] = rows u*hop - hop/2 + j (j < hop) of cond or dcond, N = hop*d
//          values, one contiguous stretch (rows outside [0, T) cropped)
// and the packed weight W[k][n] = uwk[k % d, (k / d)*N + n] ([K2, N]):
//   forward   D = A W + ub          (the overlap-add is the packing of K)
//   backward  dW = A^T D            (duw = [dW[:d] | dW[d:]])
//             X = D W^T             (de[b, p] = X[m(b,p)][:d] + X[m(b,p+1)][d:])
//             dub = column sums of D folded by n % d
// D rows never overlap, so the backward reads every dcond row once.
//
// What bounds it on the card (vctk-multi: hop 64, d 64, B=16, T=7680):
// the forward does 2.0 GFLOP against 15.7 MB of bf16 output, so the
// bytes bind (~4.7 us at 3.35 TB/s; ~2 us of bf16 tensor-core work); the
// backward does 4.0 GFLOP against dcond's 31.5 MB of float32 (~9.4 us),
// bytes again.  In float32 the FMA rate binds (67 TFLOP/s; TF32 stays
// off).  There is no ReLU after the upsampler, so the bf16 sums may run
// on the tensor cores in any order: no mask can flip.
//
// Forward design (cond_fwd_mma, bf16; cond_fwd_fma, float32).  Persistent
// blocks, at most two an SM: a block owns one slice of US = 128 columns of
// W, staged once into shared memory and kept there for its life, and
// walks tiles of 64 frame rows (flat over the batch, a row's batch and
// frame from its index by a multiply-shift division, so no tile mixes
// rows across a seam).  A tile stages its 65 rows e[b, u] once (A[m] is
// two neighbouring staged rows), the next tile's by cp.async while this
// one multiplies: bf16 on mma.sync m16n8k16 into float32 (ldmatrix
// fragments); float32 as FMAs, 4 x 8 a thread, in k order.  Bias, rounding and the crop happen in registers; W's columns
// are staged permuted so that each lane's accumulators hold 8 consecutive
// columns, so every store is 16 bytes and each 128-byte line of cond is
// written once, whole.
//
// Backward design (cond_bwd_tiles, cond_bwd_reduce).  A block owns one
// column slice (W's slice resident) and a run of consecutive frame rows;
// a cluster of up to 4 blocks holds neighbouring slices of one run.  In
// a block a producer warp streams dcond by TMA bulk copies, one a row of
// the slice, two tiles ahead, counted on mbarriers (cropped columns
// zeroed); 8 consumer warps stage the tile's frame rows (cp.async), fold
// the raw values into dub's column sums, round D to e's dtype once in
// shared memory, and from that staged tile accumulate their dW slice in
// registers for the whole run and compute the partial X = D W^T, which
// the cluster adds across its slices through distributed shared memory
// after a cluster barrier (rank order; each block adds 1/4 of the tile's
// rows).  What leaves the chip: per run the dW slice and the column sums,
// per column group (4 slices) X; the second launch adds those in a fixed
// order (runs, then groups) into duw, de and dub.  No atomics: two calls
// give the same bits.
//
// The dot probe.  Its contractions nd,rde->nre, nrd,rde->ne and
// nd,nre->dre are the tap product, de and duw with the overlap-add off
// (N = 32, hop = 64, d = 64 in the probe: each moves ~1.6 MB, 0.47 us at
// 3.35 TB/s, against 17 MFLOP, so bytes bind and in practice the launch).
// Each is one launch with no scratch: dot_nre's blocks own a tap r (W[r]
// read once in all) and write 16-byte pieces; dot_ne splits its K = hop*d
// over an 8-block cluster and adds the ranks' partial sums in rank order
// through distributed shared memory; dot_dre sums its N rows in order,
// with no split, in blocks that own column slices of the [d, hop*d]
// output.  The overlap-add on its own (the probe's pad/add/slice) is ola,
// 8 values a thread by 16-byte loads and stores.  The reshape probe's
// layouts are flat_copy, its matmul -> untile -> matmul composition is
// compose, whose [N, hop*d] intermediate stays in shared memory.
#include <initializer_list>

#include "train_common.cuh"

using namespace vqt;

namespace {

// ---------------------------------------------------------------------------
// The dot probe's contractions and its overlap-add (see "The dot probe" in
// the header).  T is the dtype of e and W (float or bf16), every sum
// float32; every operand is contiguous and 16-byte aligned, d a multiple
// of 8 up to 256.
// ---------------------------------------------------------------------------

// 8 consecutive elements of T from global memory, as floats
template <typename T>
__device__ __forceinline__ void ld8(float (&v)[8], const T* p) {
  if constexpr (sizeof(T) == 2) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

// the first EP = 16 / sizeof(T) of v rounded to T, one 16-byte store
template <typename T>
__device__ __forceinline__ void st16(T* p, const float* v) {
  if constexpr (sizeof(T) == 2)
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// n consecutive elements of T from shared memory (4 or 8 bf16, 4
// floats: one load), as floats
template <typename T, int n>
__device__ __forceinline__ void lds(float (&v)[n], const T* p) {
  static_assert(n == 4 || (n == 8 && sizeof(T) == 2), "one load");
  if constexpr (sizeof(T) == 2) {
    uint32_t w[n / 2];
    if constexpr (n == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    }
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

constexpr int NR_C = 32;   // dot_nre: columns of W[r] a block

// nd,rde->nre: y[n, r, c] = sum_k e[n, k] W[r, k, c], rounded once to T.
// Block (r, column slice, row slice) stages its rows of e (as float32)
// and W[r]'s column slice (as T, by 16-byte cp.async) in shared memory
// once; each thread sums EP = 16 / sizeof(T) consecutive columns of one
// row in k order and stores them as one 16-byte piece.  A block takes
// NT / (NR_C / EP) rows: 32 in float32, 64 in bf16.
template <typename T>
__global__ void __launch_bounds__(NT)
    dot_nre(int N, int hop, int d, const T* __restrict__ e,
            const T* __restrict__ w, T* __restrict__ y) {
  constexpr int EP = 16 / sizeof(T);   // columns a thread (one store)
  constexpr int CG = NR_C / EP;        // column groups
  constexpr int RB = NT / CG;          // rows a block
  const int lde = d + 4;
  float* es = smem;                                // [RB][lde]
  T* ws = reinterpret_cast<T*>(smem + RB * lde);   // [d][NR_C]
  const int r = blockIdx.x, c0 = blockIdx.y * NR_C, n0 = blockIdx.z * RB;
  const int tid = threadIdx.x;
  for (int i = tid; i < d * CG; i += NT) {
    const int k = i / CG, c = (i - k * CG) * EP;
    const bool ok = c0 + c < d;
    async_copy16(ws + k * NR_C + c,
                 ok ? w + ((size_t)r * d + k) * d + c0 + c : w, ok);
  }
  async_commit();
  const int rows = min(RB, N - n0);
  for (int i = tid; i < rows * (d / 8); i += NT) {
    const int q = i / (d / 8), k = (i - q * (d / 8)) * 8;
    float v[8];
    ld8(v, e + (size_t)(n0 + q) * d + k);
    float4* dst = reinterpret_cast<float4*>(es + q * lde + k);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  async_wait<0>();
  __syncthreads();
  const int cg = tid % CG, q = tid / CG, c = c0 + cg * EP;
  if (q >= rows || c >= d) return;
  float acc[EP];
#pragma unroll
  for (int j = 0; j < EP; ++j) acc[j] = 0.f;
  const float* er = es + q * lde;
  const T* wc = ws + cg * EP;
  for (int k = 0; k < d; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(er + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float b[EP];
      lds<T, EP>(b, wc + (k + u) * NR_C);
#pragma unroll
      for (int j = 0; j < EP; ++j) acc[j] = fmaf(at(a, u), b[j], acc[j]);
    }
  }
  st16(y + ((size_t)(n0 + q) * hop + r) * d + c, acc);
}

constexpr int NE_CS = 8;     // dot_ne: blocks a cluster (the splits of K)
constexpr int NE_R = 8;      // dot_ne: output rows a cluster
constexpr int NE_C = 16;     // dot_ne: output columns a cluster
constexpr int NE_O = NE_R * NE_C;
constexpr int NE_KB = 512;   // dot_ne: values of K a stage
constexpr int NE_KS = 16;    // dot_ne: values of K a thread sums a stage
constexpr int NE_SUB = NE_KB / NE_KS;   // sub-ranges of a stage (32)

// nrd,rde->ne: out[n, c] = sum_k T(dp[n, k]) W[k, c] over K = hop*d
// (dp [N, K] float32, W [K, d] as T).  A cluster of NE_CS blocks owns an
// [NE_R, NE_C] tile of out; rank q sums K's range [q*kc, (q+1)*kc) in
// stages of NE_KB staged in shared memory (dp rows rounded to T once,
// W's column slice by cp.async).  In a stage, sub-range s = 4*warp + lane
// / 8 of NE_KS values is summed in k order by 8 lanes, each 4 rows x 4
// columns; a thread keeps its sums over the stages, the block adds its
// sub-ranges in order and stores that sum into slot q of rank 0's shared
// memory (distributed shared memory); after a cluster barrier rank 0 adds
// the slots in rank order and writes the tile.  One launch, no scratch,
// the same bits every call.
template <typename T>
__global__ void __launch_bounds__(NT)
    dot_ne(int N, int K, int d, int kc, const float* __restrict__ dp,
           const T* __restrict__ w, float* __restrict__ out) {
  constexpr int LDA = NE_KB + 4;
  constexpr int WP = NE_C * (int)sizeof(T) / 16;   // 16-byte pieces a row
  float* as = smem;                                      // [NE_R][LDA]
  T* ws = reinterpret_cast<T*>(as + NE_R * LDA);         // [NE_KB][NE_C]
  float* red = as + NE_R * LDA + words<T>(NE_KB * NE_C); // [NE_SUB][NE_O]
  float* gather = red + NE_SUB * NE_O;   // [NE_CS][NE_O], rank 0's
  cluster_arrive();   // this block has started (waited for before the
                      // ranks store into rank 0's gather)
  const int q = cluster_rank(), tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * NE_C, n0 = blockIdx.z * NE_R;
  const int k0 = q * kc, k1 = min(K, k0 + kc);
  const int sub = 4 * warp + (lane >> 3);
  const int rg = (lane >> 2) & 1, cq = lane & 3;   // rows 4 rg .., cols 4 cq ..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kb = k0; kb < k1; kb += NE_KB) {
    const int kn = min(NE_KB, k1 - kb);   // a multiple of 8
    for (int i = tid; i < NE_KB * WP; i += NT) {
      const int k = i / WP, c = (i - k * WP) * (16 / (int)sizeof(T));
      const bool ok = k < kn && c0 + c < d;
      async_copy16(ws + k * NE_C + c,
                   ok ? w + (size_t)(kb + k) * d + c0 + c : w, ok);
    }
    async_commit();
    for (int i = tid; i < NE_R * (NE_KB / 4); i += NT) {
      const int rr = i / (NE_KB / 4), k = (i - rr * (NE_KB / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + rr < N && k < kn)
        v = __ldg(reinterpret_cast<const float4*>(
            dp + (size_t)(n0 + rr) * K + kb + k));
      *reinterpret_cast<float4*>(as + rr * LDA + k) =
          make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
    }
    async_wait<0>();
    __syncthreads();
    for (int k = sub * NE_KS; k < (sub + 1) * NE_KS; k += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (4 * rg + i) * LDA + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float b[4];
        lds<T, 4>(b, ws + (k + u) * NE_C + 4 * cq);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(at(a[i], u), b[j], acc[i][j]);
      }
    }
    __syncthreads();   // the stage is read before the next one's copies
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[sub * NE_O + (4 * rg + i) * NE_C + 4 * cq + j] = acc[i][j];
  __syncthreads();
  cluster_wait();   // every block of the cluster has started
  if (tid < NE_O) {   // the block's sum, into rank 0's slot q
    float s = red[tid];
    for (int u = 1; u < NE_SUB; ++u) s += red[u * NE_O + tid];
    st_cluster(gather + q * NE_O + tid, 0, s);
  }
  cluster_sync();   // every rank's sum has reached rank 0
  if (q == 0 && tid < NE_O) {
    float s = gather[tid];
#pragma unroll
    for (int u = 1; u < NE_CS; ++u) s += gather[u * NE_O + tid];
    const int n = n0 + tid / NE_C, c = c0 + tid % NE_C;
    if (n < N && c < d) out[(size_t)n * d + c] = s;
  }
}

constexpr int DR_C = 32;   // dot_dre: output columns a block
constexpr int DR_I = 64;   // dot_dre: output rows (channels of e) a block
constexpr int DR_N = 64;   // dot_dre: rows of e and dp a stage

// nd,nre->dre: out[i, c] = sum_n e[n, i] T(dp[n, c]) for c < M = hop*d
// (dp [N, M] float32, out [d, M] float32).  No split: block (column
// slice, row slice) stages DR_N rows of e (as float32) and of dp's column
// slice (rounded to T) at a time and sums all N rows in order; a thread
// keeps 2 rows x 4 columns and stores them as two 16-byte pieces.
template <typename T>
__global__ void __launch_bounds__(NT)
    dot_dre(int N, int d, int M, const T* __restrict__ e,
            const float* __restrict__ dp, float* __restrict__ out) {
  float* es = smem;               // [DR_N][DR_I]
  float* ds = es + DR_N * DR_I;   // [DR_N][DR_C]
  const int c0 = blockIdx.x * DR_C, i0 = blockIdx.y * DR_I;
  const int tid = threadIdx.x, cg = tid % (DR_C / 4), ig = tid / (DR_C / 4);
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int nb = 0; nb < N; nb += DR_N) {
    const int nn = min(DR_N, N - nb);
    for (int x = tid; x < DR_N * (DR_I / 8); x += NT) {
      const int r = x / (DR_I / 8), k = (x % (DR_I / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < nn && i0 + k < d) ld8(v, e + (size_t)(nb + r) * d + i0 + k);
      float4* dst = reinterpret_cast<float4*>(es + r * DR_I + k);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    for (int x = tid; x < DR_N * (DR_C / 4); x += NT) {
      const int r = x / (DR_C / 4), k = (x % (DR_C / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nn && c0 + k < M)
        v = __ldg(reinterpret_cast<const float4*>(
            dp + (size_t)(nb + r) * M + c0 + k));
      *reinterpret_cast<float4*>(ds + r * DR_C + k) =
          make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
    }
    __syncthreads();
    for (int n = 0; n < nn; ++n) {
      const float2 a = *reinterpret_cast<const float2*>(es + n * DR_I + 2 * ig);
      const float4 b = *reinterpret_cast<const float4*>(ds + n * DR_C + 4 * cg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] = fmaf(a.x, at(b, j), acc[0][j]);
        acc[1][j] = fmaf(a.y, at(b, j), acc[1][j]);
      }
    }
    __syncthreads();   // the stage is read before the next one's stores
  }
  const int c = c0 + 4 * cg;
  if (c >= M) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + 2 * ig + i;
    if (row < d)
      *reinterpret_cast<float4*>(out + (size_t)row * M + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The overlap-add on its own, the dot probe's pad/add/slice on the time
// axis: y[t] = x[t + off] + x[t + off - hop] over x, y [Trows, d], a row
// outside [0, Trows) reading as 0, the float32 sum rounded once (a + b
// in the plain version's order, so float32 is bit-equal to it).  VEC (d
// a multiple of 8, x and y 16-byte aligned): a thread takes 8
// consecutive values of a row at a time, by 16-byte loads and stores
// (two of each in float32), over a grid-stride loop.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    ola(int Trows, int hop, int off, int d, const T* __restrict__ x,
        T* __restrict__ y) {
  constexpr int V = VEC ? 8 : 1;
  const long long n = (long long)Trows * d;
  const long long step = (long long)gridDim.x * NT * V;
  for (long long i = ((long long)blockIdx.x * NT + threadIdx.x) * V; i < n;
       i += step) {
    const int t = (int)(i / d), c = (int)(i - (long long)t * d);
    const int u = t + off;
    const bool ha = u < Trows, hb = u >= hop && u - hop < Trows;
    if constexpr (VEC) {
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float b[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ha) ld8(a, x + (size_t)u * d + c);
      if (hb) ld8(b, x + (size_t)(u - hop) * d + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] += b[j];
      st16(y + i, a);
      if constexpr (sizeof(T) == 4) st16(y + i + 4, a + 4);
    } else {
      const float a = ha ? tof(x[(size_t)u * d + c]) : 0.f;
      const float b = hb ? tof(x[(size_t)(u - hop) * d + c]) : 0.f;
      y[i] = fromf<T>(a + b);
    }
  }
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

// ---------------------------------------------------------------------------
// The upsampler's kernels (see "Frames", "Forward design" and "Backward
// design" in the header)
// ---------------------------------------------------------------------------

// ---- mbarrier and bulk-copy primitives (PTX; the cluster ones are in
// train_common.cuh) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the inits are visible before use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of a phase, which expects `bytes` more
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}"
      ::"r"(smem_addr(bar)), "r"(bytes)
      : "memory");
}

// bytes from global src to shared dst by the TMA unit, counted on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the block's earlier shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}"
      ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// the NT threads of a block's consumer warps (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}
// ---- end of the mbarrier and bulk-copy primitives ----

constexpr int US = 128;   // columns of W a block keeps (its slice)
constexpr int UK = 128;   // widest K2 = 2d
constexpr int UR = 64;    // frame rows a tile (the float32 backward: 32)
constexpr int UCS = 4;    // the backward's blocks a cluster
constexpr int NTB = NT + 32;   // the backward's block: 8 consumer warps and
                               // a producer warp

// n / d for 0 <= n < 2^31 by a multiply and a shift, the multiplier set on
// the host (Granlund and Montgomery's method, as CUTLASS's FastDivmod)
struct FastDiv {
  int d;
  unsigned mul, shr;
  static FastDiv of(int d) {
    FastDiv f{d, 0u, 0u};
    if (d > 1) {
      int l = 0;
      while ((1 << l) < d) ++l;   // ceil(log2 d)
      f.mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
      f.shr = (unsigned)(l - 1);
    }
    return f;
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

// The flat frame rows of one call (see "Frames")
struct Frames {
  int B, Tl, hop, d;
  FastDiv fr;   // by Tl + 1
  static Frames of(int B, int Tl, int hop, int d) {
    return {B, Tl, hop, d, FastDiv::of(Tl + 1)};
  }
  __host__ __device__ int N() const { return hop * d; }
  __host__ __device__ int M() const { return B * (Tl + 1); }
  // batch row b and frame u of flat row m
  __device__ __forceinline__ void split(int m, int& b, int& u) const {
    b = fr.div(m);
    u = m - b * (Tl + 1);
  }
};

// A column n of the frame rows, as a thread keeps it for its life: the
// audio row n / d inside the frame and the channel n % d
struct Col {
  int tq, c;
  __device__ __forceinline__ static Col of(const Frames& f, int n) {
    return {n / f.d, n % f.d};
  }
  // the offset in cond (dcond) of this column of frame u of batch row b,
  // or -1 where its audio row lies outside [0, T) (the SAME crop)
  __device__ __forceinline__ long long at(const Frames& f, int b,
                                          int u) const {
    const int t = u * f.hop - f.hop / 2 + tq;
    if (t < 0 || t >= f.Tl * f.hop) return -1;
    return ((long long)b * f.Tl * f.hop + t) * f.d + c;
  }
};

// W's columns n0 .. n0 + US (0 past N) into Ws [2d][ldw], W[k][n] =
// uwk[k % d, (k / d)*N + n], by 16-byte async copies
template <typename T>
__device__ __forceinline__ void stage_wslice(T* Ws, int ldw, const T* uwk,
                                             const Frames& f, int n0) {
  constexpr int EP = 16 / sizeof(T);
  const int N = f.N();
  for (int i = threadIdx.x; i < 2 * f.d * (US / EP); i += NT) {
    const int k = i / (US / EP), n = (i % (US / EP)) * EP;
    const bool ok = n0 + n < N;
    async_copy16(Ws + k * ldw + n,
                 ok ? uwk + (size_t)(k % f.d) * 2 * N + (size_t)(k / f.d) * N +
                          n0 + n
                    : uwk,
                 ok);
  }
}

// The same for bf16 with the columns permuted: column 32G + 8t + 2j + q
// goes to 32G + 8j + 2t + q, so that the mma accumulator of lane t for n8
// tile j holds column 8t + 2j + q of its 32: every lane holds 8
// consecutive columns, with no transpose.  16-byte loads into registers,
// 4-byte stores (once a block).
__device__ __forceinline__ void stage_wslice_perm(bf16* Ws, int ldw,
                                                  const bf16* uwk,
                                                  const Frames& f, int n0) {
  constexpr int Q = UK * (US / 8) / NT;   // pieces a thread at K2 = UK
  const int N = f.N(), K2 = 2 * f.d;
  uint4 v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {   // every load first, then the stores
    const int i = threadIdx.x + q * NT;
    const int k = i / (US / 8), n = (i % (US / 8)) * 8;   // 32G + 8t
    v[q] = make_uint4(0u, 0u, 0u, 0u);
    if (k < K2 && n0 + n < N)
      v[q] = __ldg(reinterpret_cast<const uint4*>(
          uwk + (size_t)(k % f.d) * 2 * N + (size_t)(k / f.d) * N + n0 + n));
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = threadIdx.x + q * NT;
    const int k = i / (US / 8), n = (i % (US / 8)) * 8;
    if (k >= K2) break;
    uint32_t* row = reinterpret_cast<uint32_t*>(Ws + k * ldw + (n & ~31));
    const int t = (n >> 3) & 3;   // pair j of this piece goes to 4j + t
    row[t] = v[q].x;
    row[4 + t] = v[q].y;
    row[8 + t] = v[q].z;
    row[12 + t] = v[q].w;
  }
}

// A tile's frame rows, staged once: Es [rows + 1][lde] row j holds e[b, u]
// of flat row m0 - 1 + j, 0 at u = Tl, before row 0 and at m >= mend.
// Then A[m] = [Es row m - m0 + 1 | Es row m - m0]: e[b, u-1] of a row is
// the previous flat row's e, and at a batch row's frame 0 that is the
// frame Tl of the row before, 0.  16-byte pieces, d / EP a row; a thread
// stages rows r0, r0 + step, ... at column k, set once.
struct EPlan {
  int r0, step, k;
};

template <typename T>
__device__ __forceinline__ EPlan e_plan(const Frames& f) {
  constexpr int EP = 16 / sizeof(T);
  const int per = f.d / EP, step = NT / per, tid = threadIdx.x;
  return {tid < step * per ? tid / per : 1 << 30, step, (tid % per) * EP};
}

template <typename T>
__device__ __forceinline__ void stage_erows(T* Es, int lde, const T* e,
                                            const Frames& f, const EPlan& p,
                                            int m0, int rows, int mend) {
  for (int j = p.r0; j <= rows; j += p.step) {
    const int m = m0 - 1 + j;
    int b = 0, u = 0;
    if (m >= 0 && m < mend) f.split(m, b, u);
    const bool ok = m >= 0 && m < mend && u < f.Tl;
    async_copy16(Es + j * lde + p.k,
                 ok ? e + ((size_t)b * f.Tl + u) * f.d + p.k : e, ok);
  }
}

// row r, column k of A from its Es: k < d from row r + 1, else row r
template <typename T>
__device__ __forceinline__ const T* a_at(const T* Es, int lde, int d, int r,
                                         int k) {
  return k < d ? Es + (r + 1) * lde + k : Es + r * lde + k - d;
}

// the bf16 forward's shared memory: the W slice, then two Es stages
struct MmaLayout {
  static constexpr int LDW = US + SP;       // Ws [UK][LDW]
  static constexpr int LDE = UK / 2 + SP;   // Es [UR + 1][LDE]
  static constexpr int ESTAGE = (UR + 1) * LDE;
  static constexpr size_t bytes =
      ((size_t)UK * LDW + 2 * (size_t)ESTAGE) * sizeof(bf16);
};

// cond from e, bf16: block (s, y) keeps W's slice s and takes the 64-row
// tiles y, y + gridDim.y, ... of the flat frame rows (see "Forward
// design"); warp (wm, wn) multiplies rows 32 wm .., columns 32 wn .. on
// mma.sync, and lane t stores columns nb .. nb + 7 of its rows
__global__ void __launch_bounds__(NT)
    cond_fwd_mma(Frames f, const bf16* __restrict__ e,
                 const bf16* __restrict__ uwk, const float* __restrict__ ub,
                 bf16* __restrict__ cond) {
  using L = MmaLayout;
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* Ab = Ws + UK * L::LDW;
  const int d = f.d, K2 = 2 * d, N = f.N(), M = f.M();
  const int ntiles = (M + UR - 1) / UR;
  const int n0 = blockIdx.x * US, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const EPlan ep = e_plan<bf16>(f);
  int tile = blockIdx.y;
  if (tile < ntiles) stage_erows(Ab, L::LDE, e, f, ep, tile * UR, UR, M);
  stage_wslice_perm(Ws, L::LDW, uwk, f, n0);
  async_commit();
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int nb = n0 + wn * 32 + 8 * t;
  const Col cb = Col::of(f, nb);
  float2 bb[4];   // the bias of this lane's columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bb[j] = nb < N ? make_float2(ub[cb.c + 2 * j], ub[cb.c + 2 * j + 1])
                   : make_float2(0.f, 0.f);
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.y) {
    async_wait<0>();   // this tile's A rows (and the slice) have landed
    __syncthreads();   // ... for every thread; the other stage is free
    if (tile + (int)gridDim.y < ntiles)
      stage_erows(Ab + ((it + 1) & 1) * L::ESTAGE, L::LDE, e, f, ep,
                  (tile + gridDim.y) * UR, UR, M);
    async_commit();
    const bf16* Es = Ab + (it & 1) * L::ESTAGE;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) zero_acc(acc[i]);
    for (int k = 0; k < K2; k += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], a_at(Es, L::LDE, d, wm * 32 + i * 16 + (lane & 15),
                           k + ((lane >> 4) << 3)));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b[4];
        ldsm_x4_t(b, Ws + (k + (lane & 15)) * L::LDW + wn * 32 + jj * 16 +
                         ((lane >> 4) << 3));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = tile * UR + wm * 32 + i * 16 + g + 8 * h;
        if (m >= M || nb >= N) continue;
        int b, u;
        f.split(m, b, u);
        const long long off = cb.at(f, b, u);
        if (off < 0) continue;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = pack_bf16(acc[i][j][2 * h] + bb[j].x,
                           acc[i][j][2 * h + 1] + bb[j].y);
        *reinterpret_cast<uint4*>(cond + off) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
  }
}

// the float32 forward's shared memory: the W slice, then two Es stages
struct FmaLayout {
  static constexpr int LDW = US + 4;       // Ws [UK][LDW]
  static constexpr int LDE = UK / 2 + 4;   // Es [UR + 1][LDE]
  static constexpr int ESTAGE = (UR + 1) * LDE;
  static constexpr size_t bytes =
      ((size_t)UK * LDW + 2 * (size_t)ESTAGE) * sizeof(float);
};

// cond from e, float32: block (s, y) keeps W's slice s and takes the
// 64-row tiles y, y + gridDim.y, ...; thread (tr, tc) sums rows 4 tr ..,
// columns 4 tc .. and 64 + 4 tc .. in k order
__global__ void __launch_bounds__(NT)
    cond_fwd_fma(Frames f, const float* __restrict__ e,
                 const float* __restrict__ uwk, const float* __restrict__ ub,
                 float* __restrict__ cond) {
  using L = FmaLayout;
  float* W = smem;
  float* Ab = W + UK * L::LDW;
  const int d = f.d, K2 = 2 * d, N = f.N(), M = f.M();
  const int ntiles = (M + UR - 1) / UR;
  const int n0 = blockIdx.x * US, tid = threadIdx.x;
  const EPlan ep = e_plan<float>(f);
  int tile = blockIdx.y;
  if (tile < ntiles) stage_erows(Ab, L::LDE, e, f, ep, tile * UR, UR, M);
  stage_wslice(W, L::LDW, uwk, f, n0);
  async_commit();
  const int tr = tid >> 4, tc = tid & 15;
  const int nf[2] = {n0 + 4 * tc, n0 + 64 + 4 * tc};
  Col cf[2];
  float4 bf[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    cf[q] = Col::of(f, nf[q]);
    const int c = cf[q].c;
    bf[q] = nf[q] < N ? make_float4(ub[c], ub[c + 1], ub[c + 2], ub[c + 3])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.y) {
    async_wait<0>();   // this tile's A rows (and the slice) have landed
    __syncthreads();   // ... for every thread; the other stage is free
    if (tile + (int)gridDim.y < ntiles)
      stage_erows(Ab + ((it + 1) & 1) * L::ESTAGE, L::LDE, e, f, ep,
                  (tile + gridDim.y) * UR, UR, M);
    async_commit();
    const float* Es = Ab + (it & 1) * L::ESTAGE;
    const int m0 = tile * UR;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < K2; k += 4) {   // k order, as the plain version
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            a_at(Es, L::LDE, d, 4 * tr + i, k));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = W + (k + kk) * L::LDW;
        const float4 w0 = *reinterpret_cast<const float4*>(wr + 4 * tc);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 64 + 4 * tc);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = kk == 0   ? a[i].x
                           : kk == 1 ? a[i].y
                           : kk == 2 ? a[i].z
                                     : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * tr + i;
      if (m >= M) continue;
      int b, u;
      f.split(m, b, u);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const long long off = nf[q] < N ? cf[q].at(f, b, u) : -1;
        if (off >= 0)
          *reinterpret_cast<float4*>(cond + off) = make_float4(
              acc[i][4 * q] + bf[q].x, acc[i][4 * q + 1] + bf[q].y,
              acc[i][4 * q + 2] + bf[q].z, acc[i][4 * q + 3] + bf[q].w);
      }
    }
  }
}

// the backward's shared memory (byte offsets): the W slice, two stages of
// frame rows (Es), (bf16) the rounded D tile, two float32 D stages, two X
// tiles, dub's row-group sums, the D stages' mbarriers
template <typename T>
struct BwdLayout {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static constexpr int RT = TC ? UR : UR / 2;      // rows a tile
  static constexpr int LDW = US + (TC ? SP : 4);   // Ws [UK][LDW] (T)
  static constexpr int LDE = UK / 2 + (TC ? SP : 4);   // Es [RT + 1][LDE]
  static constexpr int ESTAGE = (RT + 1) * LDE;
  static constexpr int LDD = US + SP;              // Ds [RT][LDD] (bf16)
  static constexpr int LDX = UK + 8;               // Xs [RT][LDX] (float)
  static constexpr size_t A = (size_t)UK * LDW * sizeof(T);
  static constexpr size_t D = A + (size_t)2 * ESTAGE * sizeof(T);
  static constexpr size_t F = D + (TC ? (size_t)RT * LDD * sizeof(bf16) : 0);
  static constexpr size_t X = F + (size_t)2 * RT * US * sizeof(float);
  static constexpr size_t S = X + (size_t)2 * RT * LDX * sizeof(float);
  static constexpr size_t MB = S + (size_t)(NT / 32) * US * sizeof(float);
  static constexpr size_t bytes = MB + 2 * sizeof(uint64_t);
};
static_assert(BwdLayout<bf16>::bytes <= 232448 &&
                  BwdLayout<float>::bytes <= 232448,
              "a backward block's shared memory");

// The backward's partials (see "Backward design"): block (x, run), rank x
// % cs of its cluster, keeps W's slice x and takes the flat frame rows
// [run*rpr, min(M, (run + 1)*rpr)) in tiles of RT.  It writes its dW
// slice to dwp [nruns][2d][N] and its column sums to dubp [nruns][N]; its
// cluster writes X of those rows to xp [ngroups][M][2d], group x / cs.
template <typename T>
__global__ void __launch_bounds__(NTB, 1)
    cond_bwd_tiles(Frames f, int cs, int rpr, const float* __restrict__ dcond,
                   const T* __restrict__ e, const T* __restrict__ uwk,
                   float* __restrict__ dwp, float* __restrict__ xp,
                   float* __restrict__ dubp) {
  using L = BwdLayout<T>;
  constexpr int RT = L::RT;
  char* base = reinterpret_cast<char*>(smem);
  T* Ws = reinterpret_cast<T*>(base);
  T* As = reinterpret_cast<T*>(base + L::A);
  bf16* Ds = reinterpret_cast<bf16*>(base + L::D);
  float* Fs = reinterpret_cast<float*>(base + L::F);
  float* Xs = reinterpret_cast<float*>(base + L::X);
  float* dubs = reinterpret_cast<float*>(base + L::S);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::MB);   // D stages
  const int d = f.d, K2 = 2 * d, N = f.N(), M = f.M();
  const int rank = cluster_rank(), group = blockIdx.x / cs;
  const int n0 = blockIdx.x * US, run = blockIdx.y;
  const int mbeg = run * rpr, mend = min(M, mbeg + rpr);
  const int ntile = (mend - mbeg + RT - 1) / RT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // this block's share of each tile's X rows: [rank rpb, + rpb)
  const int rpb = (RT + cs - 1) / cs, xper = K2 / 4, xstep = NT / xper;
  const int xc = 4 * (tid % xper);
  const int xr1 = min(RT, (rank + 1) * rpb);
  const int xr0 = tid < xstep * xper ? rank * rpb + tid / xper : xr1;
  // the producer warp's copies of tile it's float32 D into stage it & 1:
  // lane l bulk-copies rows l, l + 32 (each row's slice at once, counted
  // on full[it & 1]) and zeroes their cropped columns and rows past the run
  const int Trows = f.Tl * f.hop, ncols = min(US, N - n0);
  auto issue = [&](int it) {
    const int buf = it & 1, m0 = mbeg + it * RT;
    float* F = Fs + buf * RT * US;
    int c0[RT / 32], c1[RT / 32];
    long long src[RT / 32];
    unsigned bytes = 0;
#pragma unroll
    for (int q = 0; q < RT / 32; ++q) {
      const int m = m0 + lane + 32 * q;
      c0[q] = c1[q] = 0;
      src[q] = 0;
      if (m < mend) {
        int b, u;
        f.split(m, b, u);
        const int t0 = u * f.hop - f.hop / 2;   // audio row of column 0
        // the columns n with 0 <= t0 + (n0 + n) / d < T
        c0[q] = min(ncols, max(0, max(0, -t0) * d - n0));
        c1[q] = max(c0[q], min(ncols, (Trows - t0) * d - n0));
        src[q] = ((long long)b * Trows + t0) * d + n0;
        bytes += 4u * (c1[q] - c0[q]);
      }
    }
    // the zeros first: lane 0's arrival below publishes them
#pragma unroll
    for (int q = 0; q < RT / 32; ++q)
      if (c0[q] > 0 || c1[q] < US)
        for (int c = 0; c < US; c += 4)
          if (c < c0[q] || c >= c1[q])
            *reinterpret_cast<float4*>(F + (lane + 32 * q) * US + c) =
                make_float4(0.f, 0.f, 0.f, 0.f);
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    fence_proxy_async();   // the consumers' reads of this stage came first
    __syncwarp();
    if (lane == 0) mbar_arm(full + buf, bytes);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < RT / 32; ++q)
      if (c1[q] > c0[q])
        bulk_g2s(F + (lane + 32 * q) * US + c0[q], dcond + src[q] + c0[q],
                 4u * (c1[q] - c0[q]), full + buf);
  };
  // the consumers' frame rows of A, by cp.async into stage it & 1
  const EPlan ep = e_plan<T>(f);
  auto stage_a = [&](int it) {
    stage_erows(As + (it & 1) * L::ESTAGE, L::LDE, e, f, ep, mbeg + it * RT,
                RT, mend);
  };
  // this consumer thread sums D's columns fn .. fn + 3 of rows tid / 32 + 8 i
  const int fn = 4 * (tid & 31);

  // dW: bf16, warp (wm, wn) rows 32 wm .., columns 64 wn .. (mma layout);
  // float32, thread (tk, tn) rows 8 tk + x, columns 4 tn + y and 64 + 4 tn
  // + y, held at accw[x / 4][y][x % 4]
  float accw[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) zero_acc(accw[i]);
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};   // columns fn .. fn + 3

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init_fence();
  }
  if (tid < NT) {
    stage_wslice(Ws, L::LDW, uwk, f, n0);
    if (ntile > 0) stage_a(0);
    async_commit();
    async_wait<0>();
  }
  __syncthreads();   // the slice, tile 0's A rows and the mbarriers are set
  if (warp == NT / 32) {   // the producer: two tiles ahead of the products
    if (ntile > 0) issue(0);
    if (ntile > 1) issue(1);
    for (int it = 0; it < ntile; ++it) {
      cluster_sync();   // the consumers are done with tile it's stage
      if (it + 2 < ntile) issue(it + 2);
    }
    cluster_sync();
    return;
  }
  for (int it = 0; it < ntile; ++it) {
    // the next tile's A rows go out (their stage was last read by tile
    // it - 1, before the cluster barrier); this tile's D has landed
    if (it + 1 < ntile) stage_a(it + 1);
    async_commit();
    mbar_wait(full + (it & 1), (it >> 1) & 1);
    const T* Es = As + (it & 1) * L::ESTAGE;
    const float* F = Fs + (it & 1) * RT * US;
    float* X = Xs + (it & 1) * RT * L::LDX;
    // dub from the float32 values (rows tid / 32 + 8 i, in order); bf16:
    // D rounded once
    for (int r = tid >> 5; r < RT; r += NT / 32) {
      const int n = fn;
      const float4 v = *reinterpret_cast<const float4*>(F + r * US + n);
      dsum[0] += v.x;
      dsum[1] += v.y;
      dsum[2] += v.z;
      dsum[3] += v.w;
      if constexpr (L::TC)
        *reinterpret_cast<uint2*>(Ds + r * L::LDD + n) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    async_wait<1>();   // this tile's A rows (this thread's copies)
    consumer_sync();   // ... every thread's, and (bf16) the rounded D
    if constexpr (L::TC) {
      const int wm = warp >> 1, wn = warp & 1;
      if (wm * 32 < K2) {   // dW += A^T D
        for (int kr = 0; kr < RT; kr += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldsm_x4_t(a[i], a_at(Es, L::LDE, d,
                                 kr + (lane & 7) + ((lane >> 4) << 3),
                                 wm * 32 + i * 16 + (((lane >> 3) & 1) << 3)));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t b[4];
            ldsm_x4_t(b, Ds + (kr + (lane & 15)) * L::LDD + wn * 64 +
                             jj * 16 + ((lane >> 4) << 3));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(accw[i][2 * jj], a[i], b[0], b[1]);
              mma_bf16(accw[i][2 * jj + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
      const int xm = warp >> 2, xn = warp & 3;   // X rows 32 xm .., cols 32 xn ..
      float accx[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) zero_acc(accx[i]);
      if (xn * 32 < K2) {   // X = D W^T over the slice
        for (int k = 0; k < US; k += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldsm_x4(a[i], Ds + (xm * 32 + i * 16 + (lane & 15)) * L::LDD + k +
                              ((lane >> 4) << 3));
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t b[4];
            ldsm_x4(b, Ws + (xn * 32 + jj * 16 + (lane & 7) +
                             ((lane >> 4) << 3)) * L::LDW +
                           k + (((lane >> 3) & 1) << 3));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(accx[i][2 * jj], a[i], b[0], b[1]);
              mma_bf16(accx[i][2 * jj + 1], a[i], b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(
                  X + (xm * 32 + i * 16 + g + 8 * h) * L::LDX + xn * 32 +
                  8 * j + 2 * t) =
                  make_float2(accx[i][j][2 * h], accx[i][j][2 * h + 1]);
      }
    } else {
      const float* Ef = reinterpret_cast<const float*>(Es);
      const float* W = reinterpret_cast<const float*>(Ws);
      const int tk = tid >> 4, tn = tid & 15;
      if (8 * tk < K2) {   // dW += A^T D, rows in order
#pragma unroll 8
        for (int r = 0; r < RT; ++r) {
          const float4 a0 = *reinterpret_cast<const float4*>(
              a_at(Ef, L::LDE, d, r, 8 * tk));
          const float4 a1 = *reinterpret_cast<const float4*>(
              a_at(Ef, L::LDE, d, r, 8 * tk + 4));
          const float4 b0 =
              *reinterpret_cast<const float4*>(F + r * US + 4 * tn);
          const float4 b1 =
              *reinterpret_cast<const float4*>(F + r * US + 64 + 4 * tn);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y)
              accw[x >> 2][y][x & 3] = fmaf(av[x], bv[y], accw[x >> 2][y][x & 3]);
        }
      }
      // X = D W^T: thread (tr, tq) rows 4 tr .., columns tq + 32 j, n in order
      const int tr = tid >> 5, tq = tid & 31;
      float accx[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) accx[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < US; n += 4) {
        float4 dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dv[i] = *reinterpret_cast<const float4*>(F + (4 * tr + i) * US + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (32 * j >= K2) break;
          const float4 w =
              *reinterpret_cast<const float4*>(W + (tq + 32 * j) * L::LDW + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float s = fmaf(dv[i].x, w.x, accx[i][j]);
            s = fmaf(dv[i].y, w.y, s);
            s = fmaf(dv[i].z, w.z, s);
            accx[i][j] = fmaf(dv[i].w, w.w, s);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (32 * j < K2) X[(4 * tr + i) * L::LDX + tq + 32 * j] = accx[i][j];
    }
    cluster_sync();   // every block's X of this tile is written
    // this block's share of the tile's rows, its cluster's partials added
    // in rank order, into xp
    const int m0 = mbeg + it * RT;
    for (int rr = xr0; rr < xr1 && m0 + rr < mend; rr += xstep) {
      const float* src = X + rr * L::LDX + xc;
      float4 v[UCS];
#pragma unroll
      for (int q = 0; q < UCS; ++q)
        if (q < cs) v[q] = ld_cluster4(src, q);
      float4 a = v[0];
#pragma unroll
      for (int q = 1; q < UCS; ++q)
        if (q < cs) {
          a.x += v[q].x;
          a.y += v[q].y;
          a.z += v[q].z;
          a.w += v[q].w;
        }
      *reinterpret_cast<float4*>(xp + ((size_t)group * M + m0 + rr) * K2 +
                                 xc) = a;
    }
  }
  cluster_sync();   // no block leaves while its cluster reads its Xs

  float* dw = dwp + (size_t)run * K2 * N + n0;
  if constexpr (L::TC) {
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = wm * 32 + i * 16 + g + 8 * h;
          const int n = wn * 64 + 8 * j + 2 * t;
          if (k < K2 && n0 + n < N)
            *reinterpret_cast<float2*>(dw + (size_t)k * N + n) =
                make_float2(accw[i][j][2 * h], accw[i][j][2 * h + 1]);
        }
  } else {
    const int tk = tid >> 4, tn = tid & 15;
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = 8 * tk + x, n = 64 * q + 4 * tn;
        if (k < K2 && n0 + n < N)
          *reinterpret_cast<float4*>(dw + (size_t)k * N + n) = make_float4(
              accw[x >> 2][4 * q][x & 3], accw[x >> 2][4 * q + 1][x & 3],
              accw[x >> 2][4 * q + 2][x & 3], accw[x >> 2][4 * q + 3][x & 3]);
      }
  }
  // dub: the row groups' sums added in order
  *reinterpret_cast<float4*>(dubs + (tid >> 5) * US + 4 * (tid & 31)) =
      make_float4(dsum[0], dsum[1], dsum[2], dsum[3]);
  consumer_sync();
  if (tid < US && n0 + tid < N) {
    float s = dubs[tid];
    for (int q = 1; q < NT / 32; ++q) s += dubs[q * US + tid];
    dubp[(size_t)run * N + n0 + tid] = s;
  }
}

// duw, de and dub from the partials, each summed in one fixed order: duw
// over the runs; de over the column groups, X[m(b,p)][:d] + X[m(b,p+1)][d:];
// dub (the last d / 8 blocks, a warp a channel) by lane over the runs and
// the hop offsets j of n = j*d + c, then a fixed shuffle tree.  A thread
// adds 4 consecutive values (float4); q4 = N / 4 and d4 = d / 4 divide by
// multiply and shift.
__global__ void cond_bwd_reduce(Frames f, FastDiv q4, FastDiv d4, FastDiv tl,
                                int nruns, int ngroups,
                                const float* __restrict__ dwp,
                                const float* __restrict__ xp,
                                const float* __restrict__ dubp,
                                float* __restrict__ de,
                                float* __restrict__ duw,
                                float* __restrict__ dub) {
  const int d = f.d, K2 = 2 * d, N = f.N(), M = f.M();
  const int nw4 = K2 * q4.d, nde4 = f.B * f.Tl * d4.d;
  const int nout = (nw4 + nde4 + NT - 1) / NT;   // blocks before dub's
  if ((int)blockIdx.x >= nout) {
    const int lane = threadIdx.x & 31;
    const int c = (blockIdx.x - nout) * (NT / 32) + (threadIdx.x >> 5);
    if (c >= d) return;
    float s = 0.f;
    for (int r = 0; r < nruns; ++r)
#pragma unroll 4
      for (int j = lane; j < f.hop; j += 32)
        s += dubp[(size_t)r * N + j * d + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) dub[c] = s;
    return;
  }
  const int i = blockIdx.x * NT + threadIdx.x;
  auto add4 = [](float4& a, const float4 v) {
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  };
  if (i < nw4) {   // duw: row k of dW, columns 4 n4 ..
    const size_t nw = (size_t)K2 * N;
    const float4* src = reinterpret_cast<const float4*>(dwp) + i;
    float4 s = src[0];
#pragma unroll 8
    for (int r = 1; r < nruns; ++r) add4(s, src[(size_t)r * nw / 4]);
    const int k = q4.div(i), n = 4 * (i - k * q4.d);
    *reinterpret_cast<float4*>(duw + (size_t)(k % d) * 2 * N +
                               (size_t)(k / d) * N + n) = s;
  } else if (i < nw4 + nde4) {   // de: row (b, p), channels 4 c4 ..
    const int j = i - nw4, row = d4.div(j), c = 4 * (j - row * d4.d);
    const int b = tl.div(row), p = row - b * f.Tl;
    const size_t m = (size_t)b * (f.Tl + 1) + p;
    const float4* x = reinterpret_cast<const float4*>(xp);
    float4 s0 = x[(m * K2 + c) / 4], s1 = x[((m + 1) * K2 + d + c) / 4];
#pragma unroll 8
    for (int q = 1; q < ngroups; ++q) {
      add4(s0, x[(((size_t)q * M + m) * K2 + c) / 4]);
      add4(s1, x[(((size_t)q * M + m + 1) * K2 + d + c) / 4]);
    }
    add4(s0, s1);
    reinterpret_cast<float4*>(de)[i - nw4] = s0;
  }
}

// The forward: one launch of persistent blocks, at most two an SM
template <typename T>
int launch_fwd(void (*k)(Frames, const T*, const T*, const float*, T*),
               size_t sm, const Frames& f, const void* e, const void* uwk,
               const float* ub, void* cond, cudaStream_t st) {
  static int per_sm = 0;   // blocks an SM holds, found at the first call
  if (per_sm == 0) {
    VQT_TRY(smem_opt_in(k, sm));
    VQT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, NT, sm));
    if (per_sm < 1) return -2;
  }
  const int nslices = cdiv(f.N(), US), ntiles = cdiv(f.M(), UR);
  const int parts = std::max(
      1, std::min(ntiles, std::min(per_sm, 2) * num_sms() / nslices));
  KLAUNCH(k, dim3(nslices, parts), NT, sm, st, f, (const T*)e,
          (const T*)uwk, ub, (T*)cond);
  return (int)last_error();
}

template <typename T>
int run_cond_fwd(const Frames& f, const void* e, const void* uwk,
                 const float* ub, void* cond, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_fwd<bf16>(cond_fwd_mma, MmaLayout::bytes, f, e, uwk, ub,
                            cond, st);
  else
    return launch_fwd<float>(cond_fwd_fma, FmaLayout::bytes, f, e, uwk, ub,
                             cond, st);
}

// The backward's split, kept in one place: cs blocks a cluster over
// ngroups column groups, nruns runs of rpr rows (a multiple of 64), at
// most one block an SM and, with `clusters` the clusters the card holds
// at once, every cluster resident; and the float32 scratch its partials
// take (vqvae_cond_bwd_scratch exports it, for clusters = the SMs)
struct BwdSplit {
  int cs, ngroups, nruns, rpr;
  long long scratch(const Frames& f) const {
    const long long K2 = 2 * f.d, N = f.N();
    return nruns * K2 * N + ngroups * (long long)f.M() * K2 + nruns * N;
  }
};

inline BwdSplit bwd_split(const Frames& f, int clusters) {
  const int nslices = cdiv(f.N(), US), cs = std::min(UCS, nslices);
  const int ngroups = cdiv(nslices, cs), ntiles = cdiv(f.M(), UR);
  int nruns = std::max(1, std::min(clusters, num_sms() / cs) / ngroups);
  nruns = std::min(nruns, ntiles);
  const int per = cdiv(ntiles, nruns);
  return {cs, ngroups, cdiv(ntiles, per), per * UR};
}

cudaLaunchConfig_t cluster_config(dim3 grid, int cs, size_t smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr,
                                  int threads = NTB) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The backward: cond_bwd_tiles, then cond_bwd_reduce, through the scratch
// part (-1 if smaller than the split needs); piece k of the call runs
// between events ev[2k] and ev[2k + 1] when ev is given
template <typename T>
int run_cond_bwd(const Frames& f, const float* dcond, const void* e,
                 const void* uwk, float* de, float* duw, float* dub,
                 float* part, long long part_cap, cudaStream_t st,
                 void* const* ev) {
  const size_t sm = BwdLayout<T>::bytes;
  auto k = cond_bwd_tiles<T>;
  const int cs = std::min(UCS, cdiv(f.N(), US));
  static int clusters[UCS + 1] = {};   // resident clusters, by size
  cudaLaunchAttribute attr[1];
  if (clusters[cs] == 0) {
    VQT_TRY(smem_opt_in(k, sm));
    const cudaLaunchConfig_t cfg = cluster_config(dim3(cs), cs, sm, st, attr);
    VQT_TRY(cudaOccupancyMaxActiveClusters(&clusters[cs], k, &cfg));
    if (clusters[cs] < 1) return -3;
  }
  const BwdSplit sp = bwd_split(f, clusters[cs]);
  if (sp.scratch(f) > part_cap) return -1;
  const int K2 = 2 * f.d;
  float* dwp = part;
  float* xp = dwp + (size_t)sp.nruns * K2 * f.N();
  float* dubp = xp + (size_t)sp.ngroups * f.M() * K2;
  auto mark = [&](int i) {
    if (ev != nullptr) cudaEventRecord((cudaEvent_t)ev[i], st);
  };
  mark(0);
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(sp.ngroups * sp.cs, sp.nruns), sp.cs, sm, st, attr);
  VQT_TRY(cudaLaunchKernelEx(&cfg, k, f, sp.cs, sp.rpr, dcond, (const T*)e,
                             (const T*)uwk, dwp, xp, dubp));
  mark(1);
  mark(2);
  const long long outs4 =
      ((long long)K2 * f.N() + (long long)f.B * f.Tl * f.d) / 4;
  KLAUNCH(cond_bwd_reduce, cdiv(outs4, NT) + cdiv(f.d, NT / 32), NT, 0, st, f,
          FastDiv::of(f.N() / 4), FastDiv::of(f.d / 4), FastDiv::of(f.Tl),
          sp.nruns, sp.ngroups, dwp, xp, dubp, de, duw, dub);
  mark(3);
  return (int)last_error();
}

// nd,rde->nre (see dot_nre): one launch
template <typename T>
int run_dot_nre(int N, int hop, int d, const void* e, const void* w, void* y,
                cudaStream_t st) {
  constexpr int RB = NT / (NR_C * (int)sizeof(T) / 16);   // rows a block
  const size_t sm =
      (size_t)RB * (d + 4) * sizeof(float) + (size_t)d * NR_C * sizeof(T);
  auto k = dot_nre<T>;
  VQT_TRY(smem_opt_in(k, sm));
  KLAUNCH(k, dim3(hop, cdiv(d, NR_C), cdiv(N, RB)), NT, sm, st, N, hop, d,
          (const T*)e, (const T*)w, (T*)y);
  return (int)last_error();
}

// nrd,rde->ne (see dot_ne): one launch of 8-block clusters
template <typename T>
int run_dot_ne(int N, int hop, int d, const float* dp, const void* w,
               float* out, cudaStream_t st) {
  const int K = hop * d, kc = cdiv(cdiv(K, NE_CS), 8) * 8;
  const size_t sm = ((size_t)NE_R * (NE_KB + 4) + words<T>(NE_KB * NE_C) +
                     (NE_SUB + NE_CS) * NE_O) * sizeof(float);
  auto k = dot_ne<T>;
  static bool opted = false;
  if (!opted) {
    VQT_TRY(smem_opt_in(k, sm));
    opted = true;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(NE_CS, cdiv(d, NE_C), cdiv(N, NE_R)), NE_CS, sm,
                     st, attr, NT);
  VQT_TRY(cudaLaunchKernelEx(&cfg, k, N, K, d, kc, dp, (const T*)w, out));
  return (int)last_error();
}

// nd,nre->dre (see dot_dre): one launch
template <typename T>
int run_dot_dre(int N, int hop, int d, const void* e, const float* dp,
                float* out, cudaStream_t st) {
  const int M = hop * d;
  const size_t sm = (size_t)DR_N * (DR_I + DR_C) * sizeof(float);
  KLAUNCH(dot_dre<T>, dim3(cdiv(M, DR_C), cdiv(d, DR_I)), NT, sm, st, N, d,
          M, (const T*)e, dp, out);
  return (int)last_error();
}

// the overlap-add (see ola): 16-byte pieces where d and the pointers allow
template <typename T>
int run_ola(int Trows, int hop, int off, int d, const void* x, void* y,
            cudaStream_t st) {
  const long long n = (long long)Trows * d;
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int grid = (int)std::max<long long>(
      1, std::min<long long>(cdiv(vec ? n / 8 : n, NT), 4LL * num_sms()));
  if (vec) {
    auto k = ola<T, true>;
    KLAUNCH(k, grid, NT, 0, st, Trows, hop, off, d, (const T*)x, (T*)y);
  } else {
    auto k = ola<T, false>;
    KLAUNCH(k, grid, NT, 0, st, Trows, hop, off, d, (const T*)x, (T*)y);
  }
  return (int)last_error();
}

// the shapes the contractions take: d a multiple of 8 up to 256, every
// operand 16-byte aligned
inline bool dot_ok(int N, int hop, int d,
                   std::initializer_list<const void*> ps) {
  if (N < 1 || hop < 1 || d < 8 || d % 8 || d > 256) return false;
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
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
// or -2 for shapes the kernel does not take (d in 16..64 by 16, hop even).
int vqvae_cond_fwd(int dtype, int B, int Tl, int hop, int d, const void* e,
                   const void* uwk, const float* ub, void* cond,
                   void* stream) {
  if (B < 1 || Tl < 1 || hop < 2 || hop % 2 || d < 16 || d % 16 || d > 64)
    return -2;
  const Frames f = Frames::of(B, Tl, hop, d);
  return by_dtype(dtype, [&](auto z) {
    return run_cond_fwd<decltype(z)>(f, e, uwk, ub, cond,
                                     (cudaStream_t)stream);
  });
}

// The float32 scratch vqvae_cond_bwd needs (its split's partials, at the
// most runs any card of this many SMs gives it).
long long vqvae_cond_bwd_scratch(int B, int Tl, int hop, int d) {
  const Frames f = Frames::of(B, Tl, hop, d);
  return bwd_split(f, num_sms()).scratch(f);
}

// de [B, Tl, d], duw [d, 2*hop*d], dub [d] (float32) from dcond [B, Tl*hop,
// d] float32, e and uwk (dtype); part: float32 scratch of part_cap floats
// (-1 if fewer than vqvae_cond_bwd_scratch); ev: 4 CUDA events around its
// two launches, or null.  -3: the card cannot hold one cluster.
int vqvae_cond_bwd(int dtype, int B, int Tl, int hop, int d,
                   const float* dcond, const void* e, const void* uwk,
                   float* de, float* duw, float* dub, float* part,
                   long long part_cap, void* stream, void* const* ev) {
  if (B < 1 || Tl < 1 || hop < 2 || hop % 2 || d < 16 || d % 16 || d > 64)
    return -2;
  const Frames f = Frames::of(B, Tl, hop, d);
  return by_dtype(dtype, [&](auto z) {
    return run_cond_bwd<decltype(z)>(f, dcond, e, uwk, de, duw, dub, part,
                                     part_cap, (cudaStream_t)stream, ev);
  });
}

// nd,rde->nre: out [N, hop, d] (dtype) = e [N, d] x W [hop, d, d]; the
// tap product with the overlap-add off.  -2 for shapes the kernel does
// not take (dot_ok).
int vqvae_dot_nre(int dtype, int N, int hop, int d, const void* e,
                  const void* w, void* out, void* stream) {
  if (!dot_ok(N, hop, d, {e, w, out})) return -2;
  return by_dtype(dtype, [&](auto z) {
    return run_dot_nre<decltype(z)>(N, hop, d, e, w, out,
                                    (cudaStream_t)stream);
  });
}

// nrd,rde->ne: out [N, d] float32 = dp [N, hop, d] (float32, rounded to
// dtype) x W [hop, d, d] (dtype); the upsampler's de with windows of hop
// rows and no overlap.  One launch, no scratch.
int vqvae_dot_ne(int dtype, int N, int hop, int d, const float* dp,
                 const void* w, float* out, void* stream) {
  if (!dot_ok(N, hop, d, {dp, w, out})) return -2;
  return by_dtype(dtype, [&](auto z) {
    return run_dot_ne<decltype(z)>(N, hop, d, dp, w, out,
                                   (cudaStream_t)stream);
  });
}

// nd,nre->dre: out [d, hop, d] float32 = sum_n e[n]^T dp[n] (dp float32,
// rounded to dtype); the upsampler's duw with windows of hop rows and no
// overlap.  One launch, no scratch.
int vqvae_dot_dre(int dtype, int N, int hop, int d, const void* e,
                  const float* dp, float* out, void* stream) {
  if (!dot_ok(N, hop, d, {e, dp, out})) return -2;
  return by_dtype(dtype, [&](auto z) {
    return run_dot_dre<decltype(z)>(N, hop, d, e, dp, out,
                                    (cudaStream_t)stream);
  });
}

// The overlap-add on its own: y [Trows, d] from x [Trows, d] (see ola);
// the dot probe's pad/add/slice is off = hop/2.
int vqvae_ola(int dtype, int Trows, int hop, int off, int d, const void* x,
              void* y, void* stream) {
  if (Trows < 1 || hop < 1 || off < 0 || d < 1) return -2;
  return by_dtype(dtype, [&](auto z) {
    return run_ola<decltype(z)>(Trows, hop, off, d, x, y,
                                (cudaStream_t)stream);
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
