// VQ nearest-code search: per row of z, argmax_k (2 z.cb_k - |cb_k|^2),
// the first index on ties.
//
// Replaces the TPU kernel of vqvae_tpu/kernels/vq_pallas.py: _vq_kernel
// (call in vq_argmin_pallas, :58).  The plain PyTorch version is
// vqvae_tpu_torch/kernels/vq_cuda.py (vq_argmin_plain).
//
// What bounds it on the card: 2*N*K*d float32 operations (0.13 GFLOP at
// vctk-multi B=16: N = 1920, K = 512, d = 64; 1.9 us at the 67 TFLOP/s
// float32 rate outside the tensor cores) against 0.6 MB of bytes (0.2
// us): operations bind, and at this size the launch itself (a few us)
// is most of the time.  The products stay float32 (no TF32): the ids
// must agree with the float32 plain version except at near-ties.
//
// Design.  The TPU kernel keeps the transposed codebook [d, K] and its
// norms resident in VMEM across a grid over 512-row tiles and never
// writes the [N, K] scores.  Here a block of 256 threads takes TM = 32
// rows of z in shared memory; it computes the K code norms itself into
// shared memory (each block, in k order), then sweeps the codes 512 at a
// time: lane l of warp w holds rows w, w+8, w+16, w+24 against codes
// l, l+32, ... (train_common.cuh, mac: one broadcast z word per row and
// coalesced codebook reads, summed in k order) and keeps its best code
// per row, the lowest index on ties.  The 32 lanes' candidates of a row
// are then reduced in shared memory by one thread in lane order, so the
// first index wins ties there too.  No [N, K] scores reach device
// memory.
#include <math.h>

#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int VQ_CT = 16;              // code columns per lane and pass
constexpr int VQ_CODES = 32 * VQ_CT;   // codes per pass

__global__ void vq_argmin(int N, int K, int d, const float* __restrict__ z,
                          const float* __restrict__ cbt,
                          int* __restrict__ out) {
  float* zs = smem;                                   // [TM][d]
  float* cbn = zs + TM * d;                           // [K]
  float* cs = cbn + K;                                // [TM][32]
  int* ci = reinterpret_cast<int*>(cs + TM * 32);     // [TM][32]
  const int r0 = blockIdx.x * TM, tid = threadIdx.x;
  const int cg = tid & 31, rg = tid >> 5;
  for (int e = tid; e < TM * d; e += NT) {
    const int row = r0 + e / d;
    zs[e] = row < N ? z[(size_t)row * d + e % d] : 0.f;
  }
  for (int k = tid; k < K; k += NT) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      const float w = cbt[(size_t)j * K + k];
      s = fmaf(w, w, s);
    }
    cbn[k] = s;
  }
  __syncthreads();
  float best[RT];
  int bi[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    best[i] = -INFINITY;
    bi[i] = 0;
  }
  for (int kb = 0; kb < K; kb += VQ_CODES) {
    float acc[RT][VQ_CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < VQ_CT; ++j) acc[i][j] = 0.f;
    mac<VQ_CT>(acc, zs, d, cbt + kb, K, d, K - kb, rg, cg);
#pragma unroll
    for (int j = 0; j < VQ_CT; ++j) {
      const int c = kb + cg + 32 * j;
      if (c >= K) continue;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float s = 2.f * acc[i][j] - cbn[c];
        if (s > best[i]) {
          best[i] = s;
          bi[i] = c;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg + RG * i;
    cs[r * 32 + cg] = best[i];
    ci[r * 32 + cg] = bi[i];
  }
  __syncthreads();
  if (tid < TM && r0 + tid < N) {
    float b = cs[tid * 32];
    int bidx = ci[tid * 32];
    for (int l = 1; l < 32; ++l) {
      const float s = cs[tid * 32 + l];
      const int id = ci[tid * 32 + l];
      if (s > b || (s == b && id < bidx)) {
        b = s;
        bidx = id;
      }
    }
    out[r0 + tid] = bidx;
  }
}

}  // namespace

extern "C" {

// out[n] = argmax_k (2 z[n].cb[k] - |cb[k]|^2) for z [N, d] float32 and
// the transposed codebook cbt [d, K] float32; int32 ids.  Returns 0, a
// CUDA error, or -2 for sizes the kernel does not take.
int vqvae_vq_argmin(int N, int K, int d, const float* z, const float* cbt,
                    int* out, void* stream) {
  if (N < 1 || K < 1 || d < 1 || d > 256) return -2;
  const size_t sm = ((size_t)TM * d + K + 2 * TM * 32) * sizeof(float);
  if (sm > 227 * 1024) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  VQT_TRY(smem_opt_in(vq_argmin, sm));
  KLAUNCH(vq_argmin, cdiv(N, TM), NT, sm, st, N, K, d, z, cbt, out);
  return (int)last_error();
}

}  // extern "C"
