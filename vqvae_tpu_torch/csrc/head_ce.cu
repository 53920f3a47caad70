// Fused WaveNet head + softmax cross-entropy, forward and backward.
//
// Replaces the TPU kernels of vqvae_tpu/kernels/head_ce_pallas.py:
//   _fwd_kernel (call in _fwd_call, :170) and _bwd_kernel (call in
//   _vjp_bwd, :201).  The plain PyTorch version, with the same rounding
//   points, is vqvae_tpu_torch/kernels/head_ce_cuda.py.
//
//   x0 = relu(skips); x1 = relu(cdt(x0 @ w1) + b1)      (cdt add)
//   logits = x1 @ w2 + b2   (w2 multiplies in cdt; float32 sum)
//   loss = sum over rows of (logsumexp - logits[target]) / N
//
// What bounds it on the card: two 256-wide products per row in the
// forward (0.13 TFLOP at B=64, T=7680) and four plus the recompute in
// the backward, against 0.25 GB and 0.5 GB of bytes: operations bind
// (0.13 ms and 0.39 ms at the bf16 tensor-core peak).  The forward
// products (and their recompute in the backward) are scalar float32 FMAs
// in k order, so x1 and its ReLU mask equal the plain version's; the
// backward's dx1 and dskips products and the weight gradients run on the
// tensor cores for bf16 (train_common.cuh).
//
// Design.  The float32 [N, mu] logits never reach device memory: a
// block computes a tile of TM = 32 rows end to end in shared memory.
// The loss partial of each block goes to its own slot and one more
// launch adds the slots in a fixed order.  The backward recomputes the
// tile forward, writes dskips, and keeps x1, cdt(dlogits) and cdt(dx1)
// (each [N, 256] in the compute dtype) for the weight gradients, which
// are split-K products over all rows with a fixed-order reduction, as
// are the bias gradients: the results are the same from run to run.
#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int MAXW = 256;   // S and mu at most 256 (CT = 8 column groups)

// x0 = relu(skips), x1 = relu(cdt(cdt(x0 @ w1) + b1)) (both in the
// compute dtype) and lg = x1 @ w2 + b2 (float32) for the tile's rows, in
// shared memory (rows >= N are zero in x0); u is [TM][S] float32 scratch.
// Scalar products (tile_mm's k order): x1 then equals the plain
// version's, so the backward's ReLU masks [x1 > 0] agree with it.
template <typename T>
__device__ void tile_forward(int N, int S, int mu, int r0,
                             const T* __restrict__ skips,
                             const T* __restrict__ w1,
                             const T* __restrict__ b1,
                             const T* __restrict__ w2,
                             const float* __restrict__ b2, T* x0, T* x1,
                             float* u, float* lg) {
  const int tid = threadIdx.x;
  for (int e = tid; e < TM * S; e += NT) {
    const int row = r0 + e / S;
    x0[e] = fromf<T>(
        row < N ? fmaxf(tof(skips[(size_t)row * S + e % S]), 0.f) : 0.f);
  }
  __syncthreads();
  tile_mm<8, false>(u, S, x0, S, w1, S, S, S);
  __syncthreads();
  for (int e = tid; e < TM * S; e += NT)
    x1[e] = fromf<T>(fmaxf(rnd<T>(rnd<T>(u[e]) + tof(b1[e % S])), 0.f));
  __syncthreads();
  tile_mm<8, false>(lg, mu, x1, S, w2, mu, S, mu);
  __syncthreads();
  for (int e = tid; e < TM * mu; e += NT) lg[e] += b2[e % mu];
  __syncthreads();
}

// shared memory of a tile: x0, x1 [TM][S] in T, then float32 u [TM][S],
// lg [TM][mu] and two [TM] row vectors
template <typename T> struct HeadTile {
  T *x0, *x1;
  float *u, *lg, *r0, *r1;
  __device__ HeadTile(int S, int mu) {
    x0 = reinterpret_cast<T*>(smem);
    x1 = reinterpret_cast<T*>(smem + words<T>(TM * S));
    u = smem + 2 * words<T>(TM * S);
    lg = u + TM * S;
    r0 = lg + TM * mu;
    r1 = r0 + TM;
  }
  static size_t bytes(int S, int mu) {
    return (2 * words<T>(TM * S) + TM * (S + mu) + 2 * TM) * sizeof(float);
  }
};

// part[blk] = sum over the tile's rows of (logsumexp - picked)
template <typename T>
__global__ void head_fwd(int N, int S, int mu, const T* __restrict__ skips,
                         const int* __restrict__ tgt,
                         const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2,
                         const float* __restrict__ b2,
                         float* __restrict__ part) {
  HeadTile<T> sm(S, mu);
  const int r0 = blockIdx.x * TM, tid = threadIdx.x;
  tile_forward<T>(N, S, mu, r0, skips, w1, b1, w2, b2, sm.x0, sm.x1, sm.u,
                  sm.lg);
  if (tid < TM) {
    const int row = r0 + tid;
    float v = 0.f;
    if (row < N) {
      const float* l = sm.lg + tid * mu;
      float m = l[0];
      for (int c = 1; c < mu; ++c) m = fmaxf(m, l[c]);
      float s = 0.f;
      for (int c = 0; c < mu; ++c) s += expf(l[c] - m);
      v = (logf(s) + m) - l[tgt[row]];
    }
    sm.r0[tid] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += sm.r0[r];
    part[blockIdx.x] = s;
  }
}

// loss[0] = (sum of part[0..n) in a fixed order) / N
__global__ void loss_reduce(int n, int N, const float* __restrict__ part,
                            float* __restrict__ loss) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) s += part[i];
  smem[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < NT; ++i) t += smem[i];
    loss[0] = t / (float)N;
  }
}

// Backward of one tile.  dlogits = (softmax - onehot) * g / N (float32):
// its column sums go to pdb2, cdt(dlogits) to dlg; dx1 = (cdt(dlogits) @
// w2^T) * [x1 > 0]: column sums to pdb1, cdt(dx1) to dx1g; x1 to x1g;
// dskips = cdt((cdt(dx1) @ w1^T) * [x0 > 0]).  cdt(dx1) takes x1's place
// once x1 is written out and its signs are kept.
template <typename T>
__global__ void head_bwd(int N, int S, int mu, const T* __restrict__ skips,
                         const int* __restrict__ tgt,
                         const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2,
                         const float* __restrict__ b2,
                         const T* __restrict__ w1T,
                         const T* __restrict__ w2T,
                         const float* __restrict__ g, T* __restrict__ x1g,
                         T* __restrict__ dlg, T* __restrict__ dx1g,
                         T* __restrict__ dskips, float* __restrict__ pdb1,
                         float* __restrict__ pdb2) {
  HeadTile<T> sm(S, mu);
  float* dx = sm.lg + TM * mu + 2 * TM;          // [TM][S] float32
  T* dlc = reinterpret_cast<T*>(dx + TM * S);    // [TM][mu] cdt(dlogits)
  const int r0 = blockIdx.x * TM, blk = blockIdx.x, tid = threadIdx.x;
  tile_forward<T>(N, S, mu, r0, skips, w1, b1, w2, b2, sm.x0, sm.x1, sm.u,
                  sm.lg);
  for (int e = tid; e < TM * S; e += NT) {
    const int row = r0 + e / S;
    if (row < N) x1g[(size_t)row * S + e % S] = sm.x1[e];
  }
  if (tid < TM) {
    const float* l = sm.lg + tid * mu;
    float m = l[0];
    for (int c = 1; c < mu; ++c) m = fmaxf(m, l[c]);
    float s = 0.f;
    for (int c = 0; c < mu; ++c) s += expf(l[c] - m);
    sm.r0[tid] = m;
    sm.r1[tid] = s;
  }
  __syncthreads();
  const float scale = g[0] / (float)N;
  for (int e = tid; e < TM * mu; e += NT) {
    const int r = e / mu, c = e % mu, row = r0 + r;
    float v = 0.f;
    if (row < N) {
      const float p = expf(sm.lg[e] - sm.r0[r]) / sm.r1[r];
      v = (p - (c == tgt[row] ? 1.f : 0.f)) * scale;
    }
    sm.lg[e] = v;
  }
  __syncthreads();
  for (int c = tid; c < mu; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += sm.lg[r * mu + c];
    pdb2[(size_t)blk * mu + c] = s;
  }
  // x1 is out (x1g) and only its signs are needed from here on
  for (int e = tid; e < TM * S; e += NT) dx[e] = tof(sm.x1[e]) > 0.f;
  __syncthreads();
  for (int e = tid; e < TM * mu; e += NT) {
    dlc[e] = fromf<T>(sm.lg[e]);
    const int row = r0 + e / mu;
    if (row < N) dlg[(size_t)row * mu + e % mu] = dlc[e];
  }
  __syncthreads();
  tile_mm<8, true>(sm.u, S, dlc, mu, w2T, S, mu, S);       // cdt(dlogits) @ w2^T
  __syncthreads();
  for (int e = tid; e < TM * S; e += NT) dx[e] = dx[e] > 0.f ? sm.u[e] : 0.f;
  __syncthreads();
  for (int c = tid; c < S; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += dx[r * S + c];
    pdb1[(size_t)blk * S + c] = s;
  }
  T* dxc = sm.x1;
  __syncthreads();
  for (int e = tid; e < TM * S; e += NT) {
    dxc[e] = fromf<T>(dx[e]);
    const int row = r0 + e / S;
    if (row < N) dx1g[(size_t)row * S + e % S] = dxc[e];
  }
  __syncthreads();
  tile_mm<8, true>(sm.u, S, dxc, S, w1T, S, S, S);         // cdt(dx1) @ w1^T
  __syncthreads();
  for (int e = tid; e < TM * S; e += NT) {
    const int row = r0 + e / S;
    if (row < N)
      dskips[(size_t)row * S + e % S] =
          fromf<T>(tof(sm.x0[e]) > 0.f ? sm.u[e] : 0.f);
  }
}

template <typename T>
int fwd(int N, int S, int mu, const void* skips, const int* tgt,
        const void* w1, const void* b1, const void* w2, const float* b2,
        float* part, long long part_cap, float* loss, cudaStream_t st) {
  const int nblk = cdiv(N, TM);
  if (nblk > part_cap) return -1;
  const size_t sm = HeadTile<T>::bytes(S, mu);
  auto kern = head_fwd<T>;
  VQT_TRY(smem_opt_in(kern, sm));
  KLAUNCH(kern, nblk, NT, sm, st, N, S, mu, (const T*)skips, tgt,
          (const T*)w1, (const T*)b1, (const T*)w2, b2, part);
  VQT_TRY(last_error());
  KLAUNCH(loss_reduce, 1, NT, NT * sizeof(float), st, nblk, N, part, loss);
  return (int)last_error();
}

template <typename T>
int bwd(int N, int S, int mu, const void* skips, const int* tgt,
        const void* w1, const void* b1, const void* w2, const float* b2,
        const void* w1T, const void* w2T, const float* g, void* x1g,
        void* dlg, void* dx1g, void* dskips, float* part, long long part_cap,
        float* dw1, float* db1, float* dw2, float* db2, cudaStream_t st) {
  const int nblk = cdiv(N, TM);
  if ((long long)nblk * (S + mu) > part_cap) return -1;
  float* pdb1 = part;
  float* pdb2 = part + (size_t)nblk * S;
  const size_t sm = HeadTile<T>::bytes(S, mu) +
                    (TM * S + words<T>(TM * mu)) * sizeof(float);
  auto kern = head_bwd<T>;
  VQT_TRY(smem_opt_in(kern, sm));
  KLAUNCH(kern, nblk, NT, sm, st, N, S, mu, (const T*)skips, tgt,
          (const T*)w1, (const T*)b1, (const T*)w2, b2, (const T*)w1T,
          (const T*)w2T, g, (T*)x1g, (T*)dlg, (T*)dx1g, (T*)dskips, pdb1,
          pdb2);
  VQT_TRY(last_error());
  KLAUNCH(seg_reduce, 1, NT, 0, st, nblk, S, pdb1, db1, S, 0);
  VQT_TRY(last_error());
  KLAUNCH(seg_reduce, 1, NT, 0, st, nblk, mu, pdb2, db2, mu, 0);
  VQT_TRY(last_error());
  // the slabs of the products reuse the scratch once the sums are taken
  VQT_TRY((atb<T, T, T>(N, N, (const T*)x1g, S, S, 0, 0, (const T*)dlg, mu,
                        mu, dw2, part, part_cap, st)));
  VQT_TRY((atb<T, T, T>(N, N, (const T*)skips, S, S, 0, 1, (const T*)dx1g, S,
                        S, dw1, part, part_cap, st)));
  return 0;
}

}  // namespace

extern "C" {

// loss[0] = mean softmax-CE of the head over N rows.  cdtype: 0 float32,
// 1 bfloat16 (skips, w1, b1, w2); b2 is float32.  Returns 0 or an error.
int vqvae_head_ce_fwd(int cdtype, int N, int S, int mu, const void* skips,
                      const int* tgt, const void* w1, const void* b1,
                      const void* w2, const float* b2, float* part,
                      long long part_cap, float* loss, void* stream) {
  if (S > MAXW || mu > MAXW || N < 1) return -2;
  if (cdtype == 1 && (S % 16 || mu % 16)) return -2;   // 16x16 fragments
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return fwd<float>(N, S, mu, skips, tgt, w1, b1, w2, b2, part, part_cap,
                      loss, st);
  return fwd<bf16>(N, S, mu, skips, tgt, w1, b1, w2, b2, part, part_cap, loss,
                   st);
}

// Gradients for the loss cotangent g[0]: dskips (cdtype) and float32
// dw1 [S, S], db1 [S], dw2 [S, mu], db2 [mu].
int vqvae_head_ce_bwd(int cdtype, int N, int S, int mu, const void* skips,
                      const int* tgt, const void* w1, const void* b1,
                      const void* w2, const float* b2, const void* w1T,
                      const void* w2T, const float* g, void* x1g, void* dlg,
                      void* dx1g, void* dskips, float* part,
                      long long part_cap, float* dw1, float* db1, float* dw2,
                      float* db2, void* stream) {
  if (S > MAXW || mu > MAXW || N < 1) return -2;
  if (cdtype == 1 && (S % 16 || mu % 16)) return -2;   // 16x16 fragments
  cudaStream_t st = (cudaStream_t)stream;
  if (cdtype == 0)
    return bwd<float>(N, S, mu, skips, tgt, w1, b1, w2, b2, w1T, w2T, g, x1g,
                      dlg, dx1g, dskips, part, part_cap, dw1, db1, dw2, db2,
                      st);
  return bwd<bf16>(N, S, mu, skips, tgt, w1, b1, w2, b2, w1T, w2T, g, x1g,
                   dlg, dx1g, dskips, part, part_cap, dw1, db1, dw2, db2, st);
}

}  // extern "C"
