// Fused WaveNet head + softmax cross-entropy, forward and backward.
//
// Replaces the TPU kernels of vqvae_tpu/kernels/head_ce_pallas.py:
//   _fwd_kernel (call in _fwd_call, :170) and _bwd_kernel (call in
//   _vjp_bwd, :201).  The plain PyTorch version, with the same rounding
//   points, is vqvae_tpu_torch/kernels/head_ce_cuda.py.
//
//   x0 = relu(skips); x1 = relu(cdt(cdt(x0 @ w1) + b1))
//   logits = x1 @ w2 + b2   (w2 multiplies in cdt; float32 sum)
//   loss = sum over rows of (logsumexp - logits[target]) / N
//   backward: dlogits = (softmax - onehot) g / N;
//     dx1 = (cdt(dlogits) @ w2^T) [x1 > 0];
//     dskips = cdt((cdt(dx1) @ w1^T) [x0 > 0]);
//     dw1 = x0^T cdt(dx1), dw2 = x1^T cdt(dlogits), db1, db2 (float32)
//
// What bounds it on the card (B=64, T=7680: N = 491,520 rows, S = mu =
// 256).  x0 @ w1 is rounded to bf16 and gated by a ReLU whose mask
// [x1 > 0] gates dx1: summed in another order than the plain version's
// (k-order float32 FMAs, as cuBLAS's float32 product sums each output),
// some roundings flip and masks with them.  So it stays k-order float32
// FMAs: 32.2 G FMAs a launch, 0.96 ms at the card's 67 TFLOP/s float32
// rate, the floor of both kernels (the backward recomputes it).  Every
// other product feeds no rounding that a mask or a gate reads, so in
// bf16 they run on the tensor cores (mma.sync m16n8k16): the logits
// (0.065 ms at 989 TFLOP/s), and in the backward the logits again,
// dx1, dskips and the two weight gradients (0.33 ms together).  Bytes:
// the forward reads skips (0.25 GB, 0.075 ms at 3.35 TB/s); the backward
// also writes dskips and the bf16 operands of the weight gradients, x1,
// cdt(dlogits), cdt(dx1), which the weight-gradient products read back.
//
// Design (bf16).  One persistent block of 256 threads per SM walks row
// tiles of TM = 32 rows, blk, blk + grid, ...; w1 is staged once per
// block as bf16 [S][S + SP] (135 KB at S = 256) and both its uses read
// that copy.  Per tile:
//  * skips arrive in registers during the previous tile (16 bytes x 4 a
//    thread) and go to shared memory transposed, ReLU'd, as float32 x0T
//    [S][TM], so a thread reads its 8 rows at k as two broadcast float4;
//  * x0 @ w1: thread (rg, cg) owns rows 8 rg .. +8 and columns 4 cg .. +4
//    and per k reads 8 rows of x0T and 4 bf16 of w1 (8 bytes, a warp's
//    lanes on consecutive columns), converts the 4 weights exactly to
//    float32 and does 32 FMAs in k order: 3 shared-memory loads and 4
//    conversions per 32 FMAs.  It rounds its own outputs (cdt, + b1,
//    cdt, ReLU) into the bf16 x1 tile [TM][S + SP]; u never reaches
//    shared memory.  x1 equals the plain version's bit for bit;
//  * the logits x1 @ w2 on mma.sync: warp w owns columns 32 w .. +32 of
//    all 32 rows, its accumulators in registers, its A fragments from
//    the x1 tile by ldmatrix and its B fragments straight from global
//    memory (L2): pack_w2 lays w2 out once per call in the order a warp
//    reads it (one coalesced 16-byte load a lane per 16 x 16 block), and
//    the warp keeps 4 k-steps of them in flight, so the products need no
//    shared-memory ring and no barrier (a 3-stage cp.async ring of w2
//    slabs spent more in barriers and in issuing copies than in its
//    products, on an H100 at 700 W).  Row max and sum of exponentials:
//    a shuffle butterfly over the 4 lanes of a row, then the 8 warps
//    through a [TM][8] scratch in warp order; the loss keeps one partial
//    per tile, added in row order, and loss_reduce adds the tiles in
//    order: the loss bits do not depend on the grid size;
//  * the backward recomputes the tile forward through the same code (x1
//    and the logits are the same bits as in the forward), forms dlogits
//    in registers (column sums into the tile's slab pdb2; cdt(dlogits)
//    into the x1 tile's place and dlg), then dx1 = cdt(dlogits) @ w2^T on
//    mma.sync from w2's second packed layout, masked by x1 > 0 (a bitmask
//    that the x0 @ w1 epilogue made by warp ballots), column sums into
//    pdb1, cdt(dx1) into shared memory and dx1g; then dskips = cdt(dx1) @
//    w1^T on mma.sync from the resident w1 (ldmatrix without .trans: w1's
//    rows are w1^T's columns), masked by x0 > 0 and written through
//    shared memory in 16-byte pieces.  Column sums: a warp's 32 rows by a
//    shuffle butterfly, every column in one warp, each tile its own slab,
//    the slabs added in tile order by colsum (blocks of CR tiles, then the
//    blocks in order): the results do not depend on the grid;
//  * the weight gradients are the split-K products of train_common.cuh
//    (atb: a cp.async ring on mma.sync) over x1g / dlg and skips / dx1g.
// Shared memory at S = mu = 256: w1 135,168 B + x0T 32,768 + the x1 /
// cdt(dlogits) / dskips tile 16,896 + cdt(dx1) 16,896 + 3.2 KB of row
// scratch and the mask: 204,928 B, one block an SM.  Measured times
// against these bounds: PERF.md.
//
// float32 keeps one block per 32-row tile with scalar k-order products
// (tile_mm) for all four products, w1^T and w2^T read from global memory
// (its gate is 1e-4; no TF32).
#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int MAXW = 256;   // S and mu at most 256

// ---------------------------------------------------------------------------
// bfloat16: persistent blocks, w1 resident in shared memory
// ---------------------------------------------------------------------------

constexpr int XP = 4;   // 16-byte pieces of a skips tile a thread
constexpr int PD = 4;   // k-steps of w2 fragments in flight a warp

// shared-memory layout (byte offsets) and strides (elements)
struct HeadSmem {
  int LS, LM;
  int w1, x0t, tile, dx, smax, ssum, srow, mask, total;
  __host__ __device__ HeadSmem(int S, int mu) {
    LS = S + SP;
    LM = mu + SP;
    w1 = 0;                                    // bf16 [S][LS]
    x0t = w1 + S * LS * 2;                     // float [S][TM]
    tile = x0t + S * TM * 4;                   // bf16 [TM][max(S, mu) + SP]
    dx = tile + TM * ((S > mu ? S : mu) + SP) * 2;   // bf16 [TM][LS]
    smax = dx + TM * LS * 2;                   // float [TM][RG]
    ssum = smax + TM * RG * 4;                 // float [TM][RG]
    srow = ssum + TM * RG * 4;                 // float [TM]
    mask = srow + TM * 4;                      // uint32 [TM][8]
    total = mask + TM * 8 * 4;
  }
};

struct HeadArgs {
  int N, S, mu;
  const bf16* skips;
  const int* tgt;
  const bf16 *w1, *b1;
  const uint4 *w2lg, *w2dx;            // w2's packed fragments (pack_w2)
  const float *b2, *g;
  float* part;                         // forward: loss partial per tile
  bf16 *x1g, *dlg, *dx1g, *dskips;     // backward outputs
  float *pdb1, *pdb2;                  // backward: column sums per tile
};

// w2's B fragments of mma.sync m16n8k16, in the order a warp reads them:
// entry ((cb * nk + ks) * 32 + lane) of a layout is lane (g, q)'s uint4
// {b0, b1} of n-tile 16 cb + 0 .. 8, then of 16 cb + 8 .. 16, at k-step
// ks; b0 holds B[16 ks + 2q .. +1][n], b1 B[16 ks + 8 + 2q .. +1][n],
// n = that n-tile's column g.  The logits' layout (first) has B = w2
// (k over S, n over mu); dx1's (second, with both) B = w2^T (k over mu,
// n over S).  Each is S * mu * 2 bytes.
__global__ void pack_w2(int S, int mu, int both, const bf16* __restrict__ w2,
                        uint4* __restrict__ out) {
  const int n1 = S * mu / 8;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= (both ? 2 * n1 : n1)) return;
  const uint16_t* w = reinterpret_cast<const uint16_t*>(w2);
  const int lane = i & 31, g = lane >> 2, q = lane & 3;
  const bool lg = i < n1;
  const int e = (lg ? i : i - n1) >> 5, nk = (lg ? S : mu) / 16;
  const int cb = e / nk, ks = e - cb * nk;
  uint32_t v[4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 16 * cb + 8 * nt + g, k = 16 * ks + 8 * h + 2 * q;
      // B[k][n] = w2[k][n] (logits) or w2[n][k] (dx1)
      const size_t a0 = lg ? (size_t)k * mu + n : (size_t)n * mu + k;
      const size_t a1 = lg ? a0 + mu : a0 + 1;
      v[2 * nt + h] = (uint32_t)w[a0] | ((uint32_t)w[a1] << 16);
    }
  out[i] = make_uint4(v[0], v[1], v[2], v[3]);
}

// rows r0 .. of a [TM][ld] bf16 tile in shared memory to global rows of
// C elements (rows >= N left out), 16 bytes a thread at a time
__device__ __forceinline__ void tile_out(bf16* __restrict__ dst,
                                         const bf16* src, int ld, int C,
                                         int r0, int N) {
  const int pr = C / 8;
  for (int e = threadIdx.x; e < TM * pr; e += NT) {
    const int r = e / pr, c = (e - r * pr) * 8;
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// acc[m][j] += A[16 m .. +16][0 .. 16 nk) B[..][16 cb0 + 8 j .. +8] for the
// warp's 32 rows and column blocks cb0, cb0 + 1 (< ncb).  A: bf16 rows
// in shared memory (stride lda).  B: a packed layout (pack_w2), read
// from global memory (L2) straight into registers PD k-steps ahead.
__device__ __forceinline__ void mm_packed(float (&acc)[2][4][4],
                                          const bf16* A, int lda,
                                          const uint4* __restrict__ Bp,
                                          int nk, int cb0, int ncb) {
  const int lane = threadIdx.x & 31;
  const bool live[2] = {cb0 < ncb, cb0 + 1 < ncb};
  const uint4* bp[2] = {Bp + ((size_t)cb0 * nk) * 32 + lane,
                        Bp + ((size_t)(cb0 + 1) * nk) * 32 + lane};
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 b[PD][2];
#pragma unroll
  for (int d = 0; d < PD; ++d)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      b[d][p] = live[p] && d < nk ? __ldg(bp[p] + d * 32) : zero;
  for (int k0 = 0; k0 < nk; k0 += PD) {
#pragma unroll
    for (int d = 0; d < PD; ++d) {
      const int ks = k0 + d;
      if (ks >= nk) break;
      uint4 c[2] = {b[d][0], b[d][1]};
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (live[p] && ks + PD < nk) b[d][p] = __ldg(bp[p] + (ks + PD) * 32);
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4(a[m], A + (16 * m + (lane & 15)) * lda + 16 * ks +
                          ((lane >> 4) << 3));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (!live[p]) continue;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][2 * p], a[m], c[p].x, c[p].y);
          mma_bf16(acc[m][2 * p + 1], a[m], c[p].z, c[p].w);
        }
      }
    }
  }
}

// acc[m][j] += A[16 m .. +16][0 .. K) W[n0 + 8 j + n][0 .. K), W in shared
// memory (stride ldw), read by ldmatrix as the col-major B operand:
// A W^T, for the warp's 32 rows and columns n0 .. +32 (< ncols)
__device__ __forceinline__ void mm_smem_t(float (&acc)[2][4][4],
                                          const bf16* A, int lda,
                                          const bf16* W, int ldw, int K,
                                          int n0, int ncols) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int k = 0; k < K; k += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      ldsm_x4(a[m], A + (16 * m + (lane & 15)) * lda + k + ((lane >> 4) << 3));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (n0 + 16 * p >= ncols) continue;
      uint32_t b[4];
      ldsm_x4(b, W + (n0 + 16 * p + (lane & 7) + ((lane >> 4) << 3)) * ldw +
                     k + (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(acc[m][2 * p], a[m], b[0], b[1]);
        mma_bf16(acc[m][2 * p + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// column sums of the warp's 32 rows: lane (g, q) holds rows g, g + 8,
// g + 16, g + 24 of columns 8 j + 2 q + e; added in that row order, then
// over g by a butterfly, which leaves every lane of a q the same bits
__device__ __forceinline__ void col_sums(const float (&v)[2][4][4],
                                         float (&cs)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = ((v[0][j][e] + v[0][j][2 + e]) + v[1][j][e]) + v[1][j][2 + e];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      cs[j][e] = s;
    }
}

// The forward (BWD = false: the loss partial of each tile) or the
// backward of the head over the row tiles blk, blk + grid, ...; see the
// header note.
template <bool BWD>
__device__ __forceinline__ void head_tiles(const HeadArgs& a) {
  const int N = a.N, S = a.S, mu = a.mu;
  const HeadSmem L(S, mu);
  const int LS = L.LS, LM = L.LM;
  char* base = reinterpret_cast<char*>(smem);
  bf16* W1 = reinterpret_cast<bf16*>(base + L.w1);
  float* X0t = reinterpret_cast<float*>(base + L.x0t);
  bf16* Tb = reinterpret_cast<bf16*>(base + L.tile);
  bf16* Dx = reinterpret_cast<bf16*>(base + L.dx);
  float* Smax = reinterpret_cast<float*>(base + L.smax);
  float* Ssum = reinterpret_cast<float*>(base + L.ssum);
  float* Srow = reinterpret_cast<float*>(base + L.srow);
  uint32_t* Mask = reinterpret_cast<uint32_t*>(base + L.mask);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rg = tid >> 6, cg = tid & 63;   // x0 @ w1: rows 8 rg, cols 4 cg
  const bool xcol = 4 * cg < S;
  const int n0 = 32 * warp;                 // tensor-core products' columns
  const int ntiles = (N + TM - 1) / TM;
  const float NEG_INF = -__int_as_float(0x7f800000);

  stage_rows(W1, a.w1, S, S, S, NT);
  async_commit();

  uint4 pre[XP];
  auto fetch = [&](int tile) {
#pragma unroll
    for (int i = 0; i < XP; ++i) {
      const int e = tid + i * NT, r = e & (TM - 1), c = (e >> 5) * 8;
      const int row = tile * TM + r;
      pre[i] = (e < TM * (S / 8) && row < N)
                   ? *reinterpret_cast<const uint4*>(a.skips +
                                                     (size_t)row * S + c)
                   : make_uint4(0, 0, 0, 0);
    }
  };

  if (blockIdx.x < ntiles) fetch(blockIdx.x);
  async_wait<0>();   // w1 (visible after the loop's first barrier)
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * TM;
    __syncthreads();   // the last tile's readers of every buffer are done
    // the fetched rows into x0T: relu, float32, k-major
#pragma unroll
    for (int i = 0; i < XP; ++i) {
      const int e = tid + i * NT, r = e & (TM - 1), c = (e >> 5) * 8;
      if (e >= TM * (S / 8)) continue;
      const uint32_t w[4] = {pre[i].x, pre[i].y, pre[i].z, pre[i].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        X0t[(c + 2 * t) * TM + r] = fmaxf(__uint_as_float(w[t] << 16), 0.f);
        X0t[(c + 2 * t + 1) * TM + r] =
            fmaxf(__uint_as_float(w[t] & 0xffff0000u), 0.f);
      }
    }
    if (tile + gridDim.x < ntiles) fetch(tile + gridDim.x);
    int tg[2][2];   // targets of this thread's rows 16 m + 8 h + g
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * m + 8 * h + g;
        tg[m][h] = row < N ? a.tgt[row] : -1;
      }
    __syncthreads();   // x0T

    // x1 = relu(cdt(cdt(x0 @ w1) + b1)): k-order float32 FMAs
    {
      float u[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
      if (xcol) {
        const float* xp = X0t + 8 * rg;
        const bf16* wp = W1 + 4 * cg;
#pragma unroll 8
        for (int k = 0; k < S; ++k) {
          const float4 xa = *reinterpret_cast<const float4*>(xp + k * TM);
          const float4 xb = *reinterpret_cast<const float4*>(xp + k * TM + 4);
          const uint2 wv = *reinterpret_cast<const uint2*>(wp + k * LS);
          const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
          const float w[4] = {__uint_as_float(wv.x << 16),
                              __uint_as_float(wv.x & 0xffff0000u),
                              __uint_as_float(wv.y << 16),
                              __uint_as_float(wv.y & 0xffff0000u)};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) u[i][j] = fmaf(x[i], w[j], u[i][j]);
        }
      }
      float bb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = xcol ? tof(a.b1[4 * cg + j]) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * rg + i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = fmaxf(rnd<bf16>(rnd<bf16>(u[i][j]) + bb[j]), 0.f);
        if (xcol) {
          const uint2 p = make_uint2(pack_bf16(v[0], v[1]),
                                     pack_bf16(v[2], v[3]));
          *reinterpret_cast<uint2*>(Tb + r * LS + 4 * cg) = p;
          if (BWD && r0 + r < N)
            *reinterpret_cast<uint2*>(a.x1g + (size_t)(r0 + r) * S +
                                      4 * cg) = p;
        }
        if constexpr (BWD) {
          // bit l of word (r, 4 (warp & 1) + j): column 4 (32 (warp & 1)
          // + l) + j of row r is > 0
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t bits = __ballot_sync(0xffffffffu,
                                                xcol && v[j] > 0.f);
            if (lane == 0) Mask[r * 8 + (warp & 1) * 4 + j] = bits;
          }
        }
      }
    }
    __syncthreads();   // x1 in Tb

    // logits = x1 @ w2 + b2 on the tensor cores
    float acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) zero_acc(acc[m]);
    mm_packed(acc, Tb, LS, a.w2lg, S / 16, 2 * warp, mu / 16);
    float mx[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[m][h] = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + 8 * j >= mu) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv = a.b2[n0 + 8 * j + 2 * q + e];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[m][j][2 * h + e] += bv;
            mx[m][h] = fmaxf(mx[m][h], acc[m][j][2 * h + e]);
          }
      }
    }
    // row max and sum of exponentials: the 4 lanes of a row, then the 8
    // warps in order
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = mx[m][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (q == 0) Smax[(16 * m + 8 * h + g) * RG + warp] = v;
      }
    __syncthreads();   // also: every warp is done with x1 in Tb
    float se[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* sm = Smax + (16 * m + 8 * h + g) * RG;
        float v = sm[0];
        for (int w = 1; w < RG; ++w) v = fmaxf(v, sm[w]);
        mx[m][h] = v;
        se[m][h] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + 8 * j >= mu) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            se[m][h] += expf(acc[m][j][2 * h + e] - mx[m][h]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = se[m][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) Ssum[(16 * m + 8 * h + g) * RG + warp] = v;
      }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* ss = Ssum + (16 * m + 8 * h + g) * RG;
        float v = ss[0];
        for (int w = 1; w < RG; ++w) v += ss[w];
        se[m][h] = v;
      }

    if constexpr (!BWD) {
      // the row's loss from the thread that holds its target's logit
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = 16 * m + 8 * h + g, t = tg[m][h];
          if (t < 0) {
            if (warp == 0 && q == 0) Srow[rr] = 0.f;
            continue;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n0 + 8 * j + 2 * q + e == t)
                Srow[rr] = (logf(se[m][h]) + mx[m][h]) - acc[m][j][2 * h + e];
        }
      __syncthreads();
      if (tid == 0) {
        float s = 0.f;
        for (int r = 0; r < TM; ++r) s += Srow[r];
        a.part[tile] = s;
      }
    } else {
      // dlogits = (softmax - onehot) g / N, in place of the logits
      const float scale = a.g[0] / (float)N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = n0 + 8 * j + 2 * q + e, t = tg[m][h];
              float v = 0.f;
              if (t >= 0 && c < mu)
                v = (expf(acc[m][j][2 * h + e] - mx[m][h]) / se[m][h] -
                     (c == t ? 1.f : 0.f)) * scale;
              acc[m][j][2 * h + e] = v;
            }
      // column sums into the tile's slab pdb2; cdt(dlogits) into Tb
      // (x1's place) and dlg
      float cs[4][2];
      col_sums(acc, cs);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * q;
        if (c >= mu) continue;
        if (g == 0) {
          a.pdb2[(size_t)tile * mu + c] = cs[j][0];
          a.pdb2[(size_t)tile * mu + c + 1] = cs[j][1];
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(Tb + (16 * m + 8 * h + g) * LM + c) =
                pack_bf16(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
      }
      __syncthreads();   // cdt(dlogits) in Tb
      tile_out(a.dlg, Tb, LM, mu, r0, N);

      // dx1 = (cdt(dlogits) @ w2^T) [x1 > 0]: column sums into pdb1,
      // cdt(dx1) into Dx and dx1g
#pragma unroll
      for (int m = 0; m < 2; ++m) zero_acc(acc[m]);
      mm_packed(acc, Tb, LM, a.w2dx, mu / 16, 2 * warp, S / 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * j + 2 * q + e;
          const int word = (c >> 7) * 4 + (c & 3), bit = (c >> 2) & 31;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rr = 16 * m + 8 * h + g;
              if (c >= S || !((Mask[rr * 8 + word] >> bit) & 1u))
                acc[m][j][2 * h + e] = 0.f;
            }
        }
      col_sums(acc, cs);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * q;
        if (c >= S) continue;
        if (g == 0) {
          a.pdb1[(size_t)tile * S + c] = cs[j][0];
          a.pdb1[(size_t)tile * S + c + 1] = cs[j][1];
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(Dx + (16 * m + 8 * h + g) * LS + c) =
                pack_bf16(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
      }
      __syncthreads();   // cdt(dx1) in Dx; every warp is done with Tb
      tile_out(a.dx1g, Dx, LS, S, r0, N);

      // dskips = cdt((cdt(dx1) @ w1^T) [x0 > 0]) from the resident w1,
      // out through Tb
#pragma unroll
      for (int m = 0; m < 2; ++m) zero_acc(acc[m]);
      mm_smem_t(acc, Dx, LS, W1, LS, S, n0, S);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * q;
        if (c >= S) continue;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = 16 * m + 8 * h + g;
            const float v0 = X0t[c * TM + rr] > 0.f ? acc[m][j][2 * h] : 0.f;
            const float v1 =
                X0t[(c + 1) * TM + rr] > 0.f ? acc[m][j][2 * h + 1] : 0.f;
            *reinterpret_cast<uint32_t*>(Tb + rr * LS + c) = pack_bf16(v0, v1);
          }
      }
      __syncthreads();   // dskips in Tb
      tile_out(a.dskips, Tb, LS, S, r0, N);
    }
  }
}

__global__ void __launch_bounds__(NT, 1) head_fwd_tc(HeadArgs a) {
  head_tiles<false>(a);
}

__global__ void __launch_bounds__(NT, 1) head_bwd_tc(HeadArgs a) {
  head_tiles<true>(a);
}

// ---------------------------------------------------------------------------
// float32: one block per 32-row tile, scalar k-order products
// ---------------------------------------------------------------------------

// x0 = relu(skips), x1 = relu(x0 @ w1 + b1) and lg = x1 @ w2 + b2 for the
// tile's rows, in shared memory (rows >= N are zero in x0); u is [TM][S]
// scratch.
__device__ void tile_forward(int N, int S, int mu, int r0,
                             const float* __restrict__ skips,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2, float* x0,
                             float* x1, float* u, float* lg) {
  const int tid = threadIdx.x;
  for (int e = tid; e < TM * S; e += NT) {
    const int row = r0 + e / S;
    x0[e] = row < N ? fmaxf(skips[(size_t)row * S + e % S], 0.f) : 0.f;
  }
  __syncthreads();
  tile_mm<8>(u, S, x0, S, w1, S, S, S);
  __syncthreads();
  for (int e = tid; e < TM * S; e += NT) x1[e] = fmaxf(u[e] + b1[e % S], 0.f);
  __syncthreads();
  tile_mm<8>(lg, mu, x1, S, w2, mu, S, mu);
  __syncthreads();
  for (int e = tid; e < TM * mu; e += NT) lg[e] += b2[e % mu];
  __syncthreads();
}

// shared memory of a tile: x0, x1, u [TM][S], lg [TM][mu], two [TM] rows
struct F32Tile {
  float *x0, *x1, *u, *lg, *r0, *r1;
  __device__ F32Tile(int S, int mu) {
    x0 = smem;
    x1 = x0 + TM * S;
    u = x1 + TM * S;
    lg = u + TM * S;
    r0 = lg + TM * mu;
    r1 = r0 + TM;
  }
  static size_t bytes(int S, int mu) {
    return (size_t)(3 * TM * S + TM * mu + 2 * TM) * sizeof(float);
  }
};

// part[blk] = sum over the tile's rows of (logsumexp - picked)
__global__ void head_fwd_f32(int N, int S, int mu,
                             const float* __restrict__ skips,
                             const int* __restrict__ tgt,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             float* __restrict__ part) {
  F32Tile sm(S, mu);
  const int r0 = blockIdx.x * TM, tid = threadIdx.x;
  tile_forward(N, S, mu, r0, skips, w1, b1, w2, b2, sm.x0, sm.x1, sm.u,
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

// Backward of one tile.  dlogits = (softmax - onehot) * g / N: its
// column sums go to pdb2, dlogits to dlg; dx1 = (dlogits @ w2^T) *
// [x1 > 0]: column sums to pdb1, dx1 to dx1g; x1 to x1g;
// dskips = (dx1 @ w1^T) * [x0 > 0].
__global__ void head_bwd_f32(int N, int S, int mu,
                             const float* __restrict__ skips,
                             const int* __restrict__ tgt,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             const float* __restrict__ w1T,
                             const float* __restrict__ w2T,
                             const float* __restrict__ g,
                             float* __restrict__ x1g, float* __restrict__ dlg,
                             float* __restrict__ dx1g,
                             float* __restrict__ dskips,
                             float* __restrict__ pdb1,
                             float* __restrict__ pdb2) {
  F32Tile sm(S, mu);
  float* dx = sm.r1 + TM;   // [TM][S]
  const int r0 = blockIdx.x * TM, blk = blockIdx.x, tid = threadIdx.x;
  tile_forward(N, S, mu, r0, skips, w1, b1, w2, b2, sm.x0, sm.x1, sm.u,
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
    if (row < N) dlg[(size_t)row * mu + c] = v;
  }
  __syncthreads();
  for (int c = tid; c < mu; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += sm.lg[r * mu + c];
    pdb2[(size_t)blk * mu + c] = s;
  }
  tile_mm<8>(sm.u, S, sm.lg, mu, w2T, S, mu, S);   // dlogits @ w2^T
  __syncthreads();
  for (int e = tid; e < TM * S; e += NT)
    dx[e] = sm.x1[e] > 0.f ? sm.u[e] : 0.f;
  __syncthreads();
  for (int c = tid; c < S; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += dx[r * S + c];
    pdb1[(size_t)blk * S + c] = s;
  }
  for (int e = tid; e < TM * S; e += NT) {
    const int row = r0 + e / S;
    if (row < N) dx1g[(size_t)row * S + e % S] = dx[e];
  }
  tile_mm<8>(sm.u, S, dx, S, w1T, S, S, S);        // dx1 @ w1^T
  __syncthreads();
  for (int e = tid; e < TM * S; e += NT) {
    const int row = r0 + e / S;
    if (row < N)
      dskips[(size_t)row * S + e % S] = sm.x0[e] > 0.f ? sm.u[e] : 0.f;
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

// w2's packed fragments (pack_w2) at wp, 16-byte aligned: the logits'
// layout, and dx1's with both
int pack(int S, int mu, int both, const void* w2, float* wp,
         cudaStream_t st) {
  const int n = (both ? 2 : 1) * S * mu / 8;
  KLAUNCH(pack_w2, cdiv(n, NT), NT, 0, st, S, mu, both, (const bf16*)w2,
          reinterpret_cast<uint4*>(wp));
  return (int)last_error();
}

int fwd(int cdtype, int N, int S, int mu, const void* skips, const int* tgt,
        const void* w1, const void* b1, const void* w2, const float* b2,
        float* part, long long part_cap, float* loss, cudaStream_t st) {
  const int ntiles = cdiv(N, TM);
  if (cdtype == 1) {
    // the tiles' loss partials, then w2's packed fragments
    const long long off = (ntiles + 3) / 4 * 4;
    if (off + (long long)S * mu / 2 > part_cap) return -1;
    VQT_TRY(pack(S, mu, 0, w2, part + off, st));
    const uint4* w2p = reinterpret_cast<const uint4*>(part + off);
    const HeadArgs a{N, S, mu, (const bf16*)skips, tgt, (const bf16*)w1,
                     (const bf16*)b1, w2p, nullptr, b2, nullptr, part,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
    const size_t sm = HeadSmem(S, mu).total;
    VQT_TRY(smem_opt_in(head_fwd_tc, sm));
    KLAUNCH(head_fwd_tc, std::min(num_sms(), ntiles), NT, sm, st, a);
  } else {
    if (ntiles > part_cap) return -1;
    const size_t sm = F32Tile::bytes(S, mu);
    VQT_TRY(smem_opt_in(head_fwd_f32, sm));
    KLAUNCH(head_fwd_f32, ntiles, NT, sm, st, N, S, mu, (const float*)skips,
            tgt, (const float*)w1, (const float*)b1, (const float*)w2, b2,
            part);
  }
  VQT_TRY(last_error());
  KLAUNCH(loss_reduce, 1, NT, NT * sizeof(float), st, ntiles, N, part, loss);
  return (int)last_error();
}

template <typename T>
int weight_grads(int N, int S, int mu, const void* skips, const void* x1g,
                 const void* dlg, const void* dx1g, float* part,
                 long long part_cap, float* dw1, float* dw2,
                 cudaStream_t st) {
  VQT_TRY((atb<T, T, T>(N, N, (const T*)x1g, S, S, 0, 0, (const T*)dlg, mu,
                        mu, dw2, part, part_cap, st)));
  return atb<T, T, T>(N, N, (const T*)skips, S, S, 0, 1, (const T*)dx1g, S,
                      S, dw1, part, part_cap, st);
}

int bwd(int cdtype, int N, int S, int mu, const void* skips, const int* tgt,
        const void* w1, const void* b1, const void* w2, const float* b2,
        const void* w1T, const void* w2T, const float* g, void* x1g,
        void* dlg, void* dx1g, void* dskips, float* part, long long part_cap,
        float* dw1, float* db1, float* dw2, float* db2, cudaStream_t st) {
  // scratch: the tiles' column sums pdb1 [ntiles][S] and pdb2
  // [ntiles][mu], (bf16) w2's packed fragments, then colsum's partials;
  // the weight-gradient products reuse it from its start
  const int ntiles = cdiv(N, TM);
  const long long slabs = (long long)ntiles * (S + mu);
  const long long packed = cdtype == 1 ? (long long)S * mu : 0;
  if (slabs + packed > part_cap) return -1;
  float* pdb1 = part;
  float* pdb2 = part + (size_t)ntiles * S;
  if (cdtype == 1) {
    float* wp = part + slabs;   // 16-byte aligned: S + mu is even x 8
    VQT_TRY(pack(S, mu, 1, w2, wp, st));
    const uint4* w2p = reinterpret_cast<const uint4*>(wp);
    const HeadArgs a{N, S, mu, (const bf16*)skips, tgt, (const bf16*)w1,
                     (const bf16*)b1, w2p, w2p + S * mu / 8, b2, g, nullptr,
                     (bf16*)x1g, (bf16*)dlg, (bf16*)dx1g, (bf16*)dskips,
                     pdb1, pdb2};
    const size_t sm = HeadSmem(S, mu).total;
    VQT_TRY(smem_opt_in(head_bwd_tc, sm));
    KLAUNCH(head_bwd_tc, std::min(num_sms(), ntiles), NT, sm, st, a);
  } else {
    const size_t sm = F32Tile::bytes(S, mu) + TM * S * sizeof(float);
    VQT_TRY(smem_opt_in(head_bwd_f32, sm));
    KLAUNCH(head_bwd_f32, ntiles, NT, sm, st, N, S, mu, (const float*)skips,
            tgt, (const float*)w1, (const float*)b1, (const float*)w2, b2,
            (const float*)w1T, (const float*)w2T, g, (float*)x1g,
            (float*)dlg, (float*)dx1g, (float*)dskips, pdb1, pdb2);
  }
  VQT_TRY(last_error());
  // the tiles' slabs added in tile order, CR tiles a block, then the
  // blocks' sums in order (colsum)
  float* rest = part + slabs + packed;
  const long long rest_cap = part_cap - slabs - packed;
  VQT_TRY(colsum(1, ntiles, S, pdb1, S, db1, S, rest, rest_cap, st));
  VQT_TRY(colsum(1, ntiles, mu, pdb2, mu, db2, mu, rest, rest_cap, st));
  if (cdtype == 1)
    return weight_grads<bf16>(N, S, mu, skips, x1g, dlg, dx1g, part,
                              part_cap, dw1, dw2, st);
  return weight_grads<float>(N, S, mu, skips, x1g, dlg, dx1g, part, part_cap,
                             dw1, dw2, st);
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
  if (cdtype == 1 && (S % 16 || mu % 16)) return -2;   // 16-wide fragments
  return fwd(cdtype, N, S, mu, skips, tgt, w1, b1, w2, b2, part, part_cap,
             loss, (cudaStream_t)stream);
}

// Gradients for the loss cotangent g[0]: dskips (cdtype) and float32
// dw1 [S, S], db1 [S], dw2 [S, mu], db2 [mu].  w1T and w2T (w1 and w2
// transposed) are read by the float32 kernel only; bfloat16 takes null.
int vqvae_head_ce_bwd(int cdtype, int N, int S, int mu, const void* skips,
                      const int* tgt, const void* w1, const void* b1,
                      const void* w2, const float* b2, const void* w1T,
                      const void* w2T, const float* g, void* x1g, void* dlg,
                      void* dx1g, void* dskips, float* part,
                      long long part_cap, float* dw1, float* db1, float* dw2,
                      float* db2, void* stream) {
  if (S > MAXW || mu > MAXW || N < 1) return -2;
  if (cdtype == 1 && (S % 16 || mu % 16)) return -2;   // 16-wide fragments
  if (cdtype == 0 && (w1T == nullptr || w2T == nullptr)) return -2;
  return bwd(cdtype, N, S, mu, skips, tgt, w1, b1, w2, b2, w1T, w2T, g, x1g,
             dlg, dx1g, dskips, part, part_cap, dw1, db1, dw2, db2,
             (cudaStream_t)stream);
}

}  // extern "C"
