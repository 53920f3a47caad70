// VQ nearest-code search: per row of z, argmax_k (2 z.cb_k - |cb_k|^2),
// the first index on ties.
//
// Replaces the TPU kernel of vqvae_tpu/kernels/vq_pallas.py: _vq_kernel
// (call in vq_argmin_pallas, :58).  The plain PyTorch version is
// vqvae_tpu_torch/kernels/vq_cuda.py (vq_argmin_plain); vq_argmin_split
// there is this kernel's partition and order of comparisons in plain
// PyTorch.
//
// What bounds it on the card: 2*N*K*d float32 operations (0.13 GFLOP at
// vctk-multi B=16: N = 1920, K = 512, d = 64; 1.9 us at the 67 TFLOP/s
// float32 rate outside the tensor cores) against 0.6 MB of bytes (0.2
// us): operations bind.  The products stay float32 FMAs summed in k
// order (no TF32): the ids must agree with the float32 plain version
// except at near-ties.  On the card one block alone on an SM runs its
// tile's FMAs at under half their rate, short of warps to cover its
// shared-memory reads; where the tiles outnumber the clusters the card
// holds, two blocks share an SM and run in the time of one.  PERF.md
// lists the designs tried beside this one (split-float tf32 products on
// mma.sync; 8 x 8 lane tiles in 4-warp blocks; 16-warp blocks of 8 x 2
// lane tiles), none faster on the card.
//
// Design.  The TPU kernel keeps the transposed codebook [d, K] and its
// norms resident in VMEM across a grid over 512-row tiles and never
// writes the [N, K] scores.  Here the codebook lives on chip across a
// thread-block cluster of VQ_CS = 4 blocks: rank r owns the codes
// [r*Kr, (r+1)*Kr), Kr = ceil(K/4), stages them once from the codebook's
// own [K, d] layout into shared memory (code-major rows padded so that 8
// lanes reading 16 bytes of 8 different codes hit 8 bank groups) and
// keeps them for its life; their norms are summed in k order in the first
// tile's product loop, from the code values already in registers, and
// kept too.  The grid is as many clusters as the card holds at once
// (fewer when the row tiles are fewer), and each cluster walks tiles of
// VQ_TR = 64 rows of z, staged in shared memory by cp.async one tile
// ahead.  In a block, warp w takes 8 rows of the tile and lane l the
// codes l, l+32, l+64, l+96 of each 128-code pass of the slice: per 4
// values of k it reads its 4 codes (16 bytes each) and each row's z (a
// 16-byte broadcast) and does 8 x 4 x 4 FMAs into 32 accumulators.  Each
// lane keeps its best (score, id) per row, visiting its codes in
// increasing order (a strict > keeps the first); the warp reduces them by
// a shuffle tree that keeps the lower id on equal scores, and its lanes
// store the rows' bests into rank 0's shared memory (distributed shared
// memory).  Rank 0 takes the four ranks' bests in rank order (a strict >)
// once the cluster's split barrier says they have arrived, while the
// ranks go on with the next tile: rank r's codes all precede rank r+1's,
// so the first index wins ties across slices too.  One launch a call, no
// [N, K] scores and no transposed codebook in device memory; no atomics.
#include <math.h>

#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int VQ_CS = 4;               // blocks a cluster (code slices)
constexpr int VQ_RW = 8;               // rows a warp
constexpr int VQ_TR = RG * VQ_RW;      // rows a tile
constexpr int VQ_CL = 4;               // codes a lane and pass
constexpr int VQ_CP = 32 * VQ_CL;      // codes a pass
constexpr int VQ_SMEM = 232448;        // shared memory a block can have

// The sizes of one call, set on the host: dp = d rounded up to 4 (zero
// padded), ldc the padded code row (dp/4 + (0 or 1) odd 16-byte units),
// Kr codes a rank, Kp that rounded up to whole passes, nbuf z stages
// (2, or 1 where two do not fit), vec: 16-byte copies (d % 4 == 0 and
// both operands 16-byte aligned).
struct VqShape {
  int N, K, d, dp, ldc, Kr, Kp, nbuf, vec;

  static VqShape of(int N, int K, int d, int nbuf, bool vec) {
    VqShape s{N, K, d, (d + 3) / 4 * 4, 0, cdiv(K, VQ_CS), 0, nbuf, vec};
    s.ldc = s.dp + ((s.dp / 4) % 2 == 0 ? 4 : 0);
    s.Kp = cdiv(s.Kr, VQ_CP) * VQ_CP;
    return s;
  }
  // floats of shared memory: codes, norms, z stages, and (rank 0's) the
  // ranks' bests of a tile, two buffers of scores and ids
  size_t bytes() const {
    return ((size_t)Kp * ldc + Kp + (size_t)nbuf * VQ_TR * dp +
            4 * VQ_CS * VQ_TR) * sizeof(float);
  }
};

// z rows t*VQ_TR .. into zs [VQ_TR][dp] (0 past N and past d)
__device__ __forceinline__ void stage_z(const VqShape& s, float* zs,
                                        const float* __restrict__ z, int t) {
  const int r0 = t * VQ_TR;
  if (s.vec) {
    const int per = s.d / 4;
    for (int i = threadIdx.x; i < VQ_TR * per; i += NT) {
      const int r = i / per, k = (i - r * per) * 4;
      const bool ok = r0 + r < s.N;
      async_copy16(zs + r * s.dp + k, ok ? z + (size_t)(r0 + r) * s.d + k : z,
                   ok);
    }
  } else {
    for (int i = threadIdx.x; i < VQ_TR * s.dp; i += NT) {
      const int r = i / s.dp, k = i - r * s.dp;
      zs[i] = r0 + r < s.N && k < s.d ? z[(size_t)(r0 + r) * s.d + k] : 0.f;
    }
  }
}

// One tile's products for warp `warp`: the best (score, id) of each of
// its VQ_RW rows over the slice's nc codes, by lane (see the header).
// NORMS (the first tile): the codes' norms are summed in the same k loop,
// in k order, from the values already in registers, and kept in cbn.
template <bool NORMS>
__device__ __forceinline__ void tile_best(const VqShape& s, const float* cbs,
                                          float* cbn, const float* zw, int c0,
                                          int nc, int lane,
                                          float (&best)[VQ_RW],
                                          int (&id)[VQ_RW]) {
#pragma unroll
  for (int i = 0; i < VQ_RW; ++i) {
    best[i] = -INFINITY;
    id[i] = c0;
  }
  for (int p = 0; p < s.Kp; p += VQ_CP) {
    float acc[VQ_RW][VQ_CL], nrm[VQ_CL];
#pragma unroll
    for (int j = 0; j < VQ_CL; ++j) {
      nrm[j] = 0.f;
#pragma unroll
      for (int i = 0; i < VQ_RW; ++i) acc[i][j] = 0.f;
    }
    const float* cw = cbs + (size_t)(p + lane) * s.ldc;
#pragma unroll 2
    for (int k = 0; k < s.dp; k += 4) {
      float4 c[VQ_CL];
#pragma unroll
      for (int j = 0; j < VQ_CL; ++j) {
        c[j] = *reinterpret_cast<const float4*>(cw + 32 * j * s.ldc + k);
        if (NORMS) {
          nrm[j] = fmaf(c[j].x, c[j].x, nrm[j]);
          nrm[j] = fmaf(c[j].y, c[j].y, nrm[j]);
          nrm[j] = fmaf(c[j].z, c[j].z, nrm[j]);
          nrm[j] = fmaf(c[j].w, c[j].w, nrm[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < VQ_RW; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(zw + i * s.dp + k);
#pragma unroll
        for (int j = 0; j < VQ_CL; ++j) {
          acc[i][j] = fmaf(a.x, c[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, c[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, c[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, c[j].w, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VQ_CL; ++j) {
      const int c = p + lane + 32 * j;
      if (c >= nc) continue;
      float n;
      if (NORMS) {
        n = nrm[j];
        cbn[c] = n;
      } else {
        n = cbn[c];
      }
#pragma unroll
      for (int i = 0; i < VQ_RW; ++i) {
        const float sc = 2.f * acc[i][j] - n;
        if (sc > best[i]) {
          best[i] = sc;
          id[i] = c0 + c;
        }
      }
    }
  }
  // the warp's best per row: the higher score, the lower id on equal
  // scores (a total order, so the tree's result is the slice's first
  // best whatever the pairing)
#pragma unroll
  for (int i = 0; i < VQ_RW; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float so = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int io = __shfl_xor_sync(0xffffffffu, id[i], o);
      if (so > best[i] || (so == best[i] && io < id[i])) {
        best[i] = so;
        id[i] = io;
      }
    }
  }
}

// rank 0: tile t's ids from the ranks' bests in slot buffer b, taken in
// rank order (a strict >: rank r's codes all precede rank r+1's)
__device__ __forceinline__ void tile_ids(const VqShape& s, const float* bs,
                                         const int* bi, int b, int t,
                                         int* __restrict__ out) {
  const int tid = threadIdx.x, row = t * VQ_TR + tid;
  if (tid >= VQ_TR || row >= s.N) return;
  const float* sb = bs + b * VQ_CS * VQ_TR;
  const int* ib = bi + b * VQ_CS * VQ_TR;
  float v = sb[tid];
  int w = ib[tid];
#pragma unroll
  for (int q = 1; q < VQ_CS; ++q)
    if (sb[q * VQ_TR + tid] > v) {
      v = sb[q * VQ_TR + tid];
      w = ib[q * VQ_TR + tid];
    }
  out[row] = w;
}

__global__ void __launch_bounds__(NT)
    vq_search(VqShape s, const float* __restrict__ z,
              const float* __restrict__ cb, int* __restrict__ out) {
  float* cbs = smem;                                  // [Kp][ldc]
  float* cbn = cbs + (size_t)s.Kp * s.ldc;            // [Kp]
  float* zst = cbn + s.Kp;                            // [nbuf][VQ_TR][dp]
  float* bs = zst + (size_t)s.nbuf * VQ_TR * s.dp;    // [2][VQ_CS][VQ_TR]
  int* bi = reinterpret_cast<int*>(bs + 2 * VQ_CS * VQ_TR);   // the same
  cluster_arrive();   // this block has started: waited for before the
                      // first store into rank 0's slots
  const int rank = cluster_rank(), tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = rank * s.Kr;
  const int nc = max(0, min(s.K - c0, s.Kr));   // codes of this slice
  const int cl = blockIdx.x / VQ_CS, ncl = gridDim.x / VQ_CS;
  const int ntiles = (s.N + VQ_TR - 1) / VQ_TR;

  // the slice, once
  if (s.vec) {
    const int per = s.d / 4;
    for (int i = tid; i < nc * per; i += NT) {
      const int c = i / per, k = (i - c * per) * 4;
      async_copy16(cbs + c * s.ldc + k, cb + (size_t)(c0 + c) * s.d + k,
                   true);
    }
  } else {
    for (int i = tid; i < nc * s.dp; i += NT) {
      const int c = i / s.dp, k = i - c * s.dp;
      cbs[c * s.ldc + k] = k < s.d ? cb[(size_t)(c0 + c) * s.d + k] : 0.f;
    }
  }
  if (cl < ntiles) stage_z(s, zst, z, cl);
  async_commit();

  int it = 0;
  for (int t = cl; t < ntiles; t += ncl, ++it) {
    const int b = it & 1;
    float* zs = zst + (s.nbuf == 2 ? (size_t)b * VQ_TR * s.dp : 0);
    async_wait<0>();
    __syncthreads();   // tile t is staged; every warp is done with t - ncl
    if (s.nbuf == 2 && t + ncl < ntiles)   // the next tile, one ahead
      stage_z(s, zst + (size_t)(b ^ 1) * VQ_TR * s.dp, z, t + ncl);
    async_commit();
    float best[VQ_RW];
    int id[VQ_RW];
    const float* zw = zs + warp * VQ_RW * s.dp;
    if (it == 0)
      tile_best<true>(s, cbs, cbn, zw, c0, nc, lane, best, id);
    else
      tile_best<false>(s, cbs, cbn, zw, c0, nc, lane, best, id);
    // the ranks' bests of the tile before have reached rank 0 (and, at
    // the first tile, every block has started)
    cluster_wait();
    if (rank == 0 && it > 0) tile_ids(s, bs, bi, b ^ 1, t - ncl, out);
    if (lane < VQ_RW) {   // lane i stores row i's best into rank 0's slot
      float v = best[0];
      int w = id[0];
#pragma unroll
      for (int i = 1; i < VQ_RW; ++i)
        if (lane == i) {
          v = best[i];
          w = id[i];
        }
      const int slot = (b * VQ_CS + rank) * VQ_TR + warp * VQ_RW + lane;
      st_cluster(bs + slot, 0, v);
      st_cluster(bi + slot, 0, w);
    }
    if (s.nbuf == 1 && t + ncl < ntiles) {   // one z stage: the next tile
      __syncthreads();                       // after every warp's reads
      stage_z(s, zst, z, t + ncl);
      async_commit();
    }
    cluster_arrive_release();   // this tile's bests are stored
  }
  cluster_wait();
  if (rank == 0 && it > 0) tile_ids(s, bs, bi, (it - 1) & 1,
                                    cl + (it - 1) * ncl, out);
}

cudaLaunchConfig_t vq_config(int clusters, size_t sm, cudaStream_t st,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * VQ_CS, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = sm;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = VQ_CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the shape of a call: two z stages where they fit, else one; nbuf 0
// where neither fits
VqShape vq_shape(int N, int K, int d, bool vec) {
  VqShape s = VqShape::of(N, K, d, 2, vec);
  if (s.bytes() > VQ_SMEM) s = VqShape::of(N, K, d, 1, vec);
  if (s.bytes() > VQ_SMEM) s.nbuf = 0;
  return s;
}

}  // namespace

extern "C" {

// out[n] = argmax_k (2 z[n].cb[k] - |cb[k]|^2) for z [N, d] and the
// codebook cb [K, d], both float32; int32 ids.  Returns 0, a CUDA error,
// -2 for sizes the kernel does not take (d > 256, or a quarter of the
// codebook that does not fit in shared memory; vq_cuda.kernel_smem
// mirrors VqShape::bytes) or -3 if
// the card holds no cluster of the kernel.
int vqvae_vq_argmin(int N, int K, int d, const float* z, const float* cb,
                    int* out, void* stream) {
  if (N < 1 || K < 1 || d < 1 || d > 256) return -2;
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(z) |
                     reinterpret_cast<uintptr_t>(cb)) & 15) == 0;
  const VqShape s = vq_shape(N, K, d, vec);
  if (s.nbuf == 0) return -2;
  const size_t sm = s.bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  // the clusters the card holds at once, by the shared memory a block
  // takes (the last size asked for)
  static size_t known_sm = 0;
  static int known_clusters = 0;
  if (sm != known_sm) {
    VQT_TRY(smem_opt_in(vq_search, sm));
    cudaLaunchConfig_t cfg = vq_config(1, sm, st, attr);
    int n = 0;
    VQT_TRY(cudaOccupancyMaxActiveClusters(&n, vq_search, &cfg));
    if (n < 1) return -3;
    known_sm = sm;
    known_clusters = n;
  }
  // as many clusters as take the same number of tiles (the fewest rounds)
  const int ntiles = cdiv(N, VQ_TR);
  const int rounds = cdiv(ntiles, known_clusters);
  const cudaLaunchConfig_t cfg =
      vq_config(cdiv(ntiles, rounds), sm, st, attr);
  VQT_TRY(cudaLaunchKernelEx(&cfg, vq_search, s, z, cb, out));
  return (int)last_error();
}

}  // extern "C"
