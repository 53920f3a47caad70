/*
 * Fused autoregressive WaveNet decode for Hopper (sm_90a): one
 * 16-block thread-block cluster per batch row.
 *
 * Replaces vqvae_tpu/kernels/decode_pallas.py::_body, and with it the
 * three Pallas entry points built on it: generate_ids_pallas (one-shot
 * sampling), generate_ids_pallas_resume (the serving call, resumable
 * from carried ring-buffer state) and teacher_logits_pallas (the
 * teacher-forced parity oracle).  Everything _body computes stays in
 * this kernel: the input embedding (a row gather here, not the TPU's
 * one-hot matmul), c_t @ vc_all for all layers, per layer
 * [past | h] @ wff + cproj + gcond, the gate and z @ [wr | ws] + brs,
 * the head relu -> @h1+b1 -> relu -> @h2+b2 (h2 in float32), and the
 * greedy or Gumbel-max pick.
 *
 * What bounds it on this card: one step of one row is a chain of 30
 * dependent layers of small products (at vctk-multi about 1.5 M
 * multiply-adds and 3.1 MB of bf16 weights a step).  Steps are strictly
 * sequential, so the kernel is bound by latency, not by FLOP/s or HBM
 * bandwidth: how long a layer's few dependent products take and how
 * long the SMs take to exchange their vectors.  One block per row (the
 * first port of this kernel) read the 3.1 MB from L2 on one SM, left
 * the other 131 SMs idle and took 159 us a step.
 *
 * The design: C = 16 blocks of one cluster decode one row.  Block r
 * owns R/C channels (ch0 = r*R/C onwards) of h, of z and of the ring
 * buffers, and the gate columns (j, R + j) of those channels, so the
 * tanh and sigmoid halves of its entries of z sit in one block.  A
 * layer is two exchanges through distributed shared memory:
 *
 *   A. u partials.  Block r multiplies its channels of h and of the
 *      layer's past tap into a partial of all 2R columns of
 *      [past | h] @ wff and sends each owner its 2R/C columns.  The
 *      owner adds the 16 partials in a fixed order to c @ vc_all + gcond
 *      (computed a step ahead, off the chain) and applies the gate.
 *   B. rs partials.  Block r multiplies its entries of z into a partial
 *      of all R + S columns of z @ [wr | ws] and sends the channel
 *      owners their residual partials and the skip owners (S/C columns
 *      each) theirs.  Each owner adds the 16 in a fixed order and rounds
 *      as _body does: rs, then h or the skip sum.
 *
 * Each exchange moves 16-byte pieces with st.async, which counts its
 * bytes on the receiving block's mbarrier; the receiver waits on that
 * mbarrier.  Nothing fences: on an H100 a cluster barrier with
 * release/acquire costs about 0.6 us, an exchange round about 0.2 us
 * (chip_smoke.py's request phase measures both), and a step needs 60
 * exchanges.  Each value has one owner, which alone computes it,
 * so no two blocks need to agree on a sum's bits.  Buffers and
 * mbarriers alternate by layer parity;
 * one __syncthreads per layer keeps a block from sending into a buffer
 * that a slower block of its own has not read.  A block keeps its own
 * channels of the ring buffers, in shared memory for the launch (read
 * from the state at the start, written back at the end: 24 KiB a block
 * at vctk-multi in bf16), so no ring value crosses blocks and a layer
 * touches no global memory.
 * The head all-gathers the skip sums, then xa = relu(skips @ h1 + b1)
 * (S/C columns a block), computes mu/C logits a block and agrees on the
 * Gumbel-max pick by an all-gather of one (value, index) pair per
 * block, ties to the lowest index.
 *
 * Warps: warp 0 runs the chain (h, the ring, exchange A); warps 0-3
 * compute the gate and send exchange B, each lane one 16-byte piece;
 * warps 4-6 compute the next step's c @ vc_all; warp 7 keeps the
 * block's skip sums, each a layer late, when its exchange has long
 * completed.  A layer is a chain of a few hundred dependent
 * instructions on one warp, so everything that does not change from
 * layer to layer (which piece a lane sends where, the remote
 * addresses) is worked out once, before the first step, and the
 * flagship's widths are compiled in as constants.
 *
 * Two stages, picked by the dtype: the bf16 instance copies its weight
 * slices into shared memory once per launch (about 189 KiB a block at
 * vctk-multi) and reads them from there every step; the float32
 * instance (its slices would need twice that) reads them from global
 * memory, through L1.
 *
 * Rounding follows _body: h, pe0, z, rs and the skip sum are rounded to
 * the compute dtype; u, cproj and the logits are float32.  Sampling
 * draws Philox4x32-10 with key (seed, 0) and counter
 * (k / 4, row0 + b, t_lo, t_hi) at absolute step t, word k % 4, so any
 * split of a stream into resumed launches draws the same noise as one
 * launch, and a launch over rows [row0, row0 + B) of a batch (a shard of
 * a decode split by rows) draws those rows' noise.
 * Every sum runs in a fixed order, so a launch repeats bit for bit.
 *
 * Built by vqvae_tpu_torch/kernels/build.py with
 *   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
 * and bound with ctypes in vqvae_tpu_torch/kernels/decode_cuda.py.
 */

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kCluster = 16;   // blocks per batch row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChainWarps = 4;  // the gate and exchange B
constexpr int kCondWarp0 = 4;   // warps 4-6: the next step's c @ vc_all
constexpr int kSkipWarp = 7;
constexpr int kMaxLayers = 64;
constexpr int kMaxRc = 8;       // channels a block: R <= 128
constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;
enum Mode { kTeacher = 0, kGreedy = 1, kSample = 2 };
// vqvae_decode's own errors (cudaError_t codes are positive)
constexpr int kErrShape = -1;     // a width the cluster split does not take
constexpr int kErrCluster = -2;   // the card cannot schedule one cluster
constexpr int kErrSmem = -3;      // the resident slices do not fit
// mbarriers: exchange A and B by layer parity, then the head's three
constexpr int kBarA = 0, kBarB = 2, kBarSkips = 4, kBarXa = 5, kBarPick = 6;
constexpr int kBars = 7;

struct Shape {
  int B, T, R, S, d, mu, L;
  int row0;  // the noise's row of batch row 0 (a shard's first global row)
  int dil[kMaxLayers];
  int off[kMaxLayers];
};

template <typename T>
struct Ptrs {
  const T *emb_w, *emb_b, *wff, *vc_all, *wrs, *brs, *h1, *b1;
  const float *h2, *b2;
  const T *cond, *gcond;
  const int* ids_in;
  int* ids_out;
  float* logits_out;
  T *bufs, *pe0;
  int* x_last;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to the compute dtype (identity for float32)
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// ---- cluster primitives (PTX) ----

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// a full cluster barrier with release/acquire: only at the start and end
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of local shared object p in block `rank` of the cluster
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// the inits are visible to the cluster's complete_tx before it starts
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one local arrival of a phase, which expects `bytes` more
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}"
      ::"r"(smem_u32(bar)), "r"(bytes)
      : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}"
      ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

// a store into another block's shared memory that, once performed,
// counts its bytes on that block's mbarrier `bar`
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t bar,
                                         float v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint32_t bar,
                                         float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}



__device__ __forceinline__ void st_async(uint32_t addr, uint32_t bar,
                                         uint2 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(bar)
      : "memory");
}

using Addr = decltype(remote(static_cast<const void*>(nullptr), 0));

// ---- end of the cluster primitives ----

__device__ __forceinline__ int ring_slot(long long t, int dil) {
  return (dil & (dil - 1)) == 0 ? (int)(t & (long long)(dil - 1))
                                : (int)(t % dil);
}

// Philox4x32-10 (Salmon et al., SC'11; the Random123 reference rounds)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Gumbel noise for class k of row b at absolute step t
__device__ __forceinline__ float gumbel(uint32_t seed, int k, int b,
                                        long long t) {
  const unsigned long long ut = (unsigned long long)t;
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)(k >> 2), (uint32_t)b, (uint32_t)ut,
                 (uint32_t)(ut >> 32)),
      make_uint2(seed, 0u));
  const int q = k & 3;
  const uint32_t bits = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
  // 24 bits, centred: u in (0, 1), the scheme of decode_pallas.py
  const float u = ((float)(bits >> 8) + 0.5f) * 5.9604644775390625e-08f;
  return -logf(-logf(u));
}

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// weights: one element, or four consecutive ones (16-byte aligned
// float, 8-byte bf16), from shared memory (resident) or through L1
template <bool kSmem, typename W>
__device__ __forceinline__ float ldw(const W* p) {
  if constexpr (kSmem)
    return to_f(*p);
  else
    return to_f(__ldg(p));
}

__device__ __forceinline__ float4 ld_quad(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

// (float32 weights are never resident, bf16 ones always)
template <typename W>
__device__ __forceinline__ float4 ldw4(const W* p) {
  if constexpr (std::is_same<W, float>::value)
    return __ldg(reinterpret_cast<const float4*>(p));
  else
    return ld_quad(p);
}

// out[v] = sum over k < n of x[k] * w(k)[v], v < len: the rows w(k) of
// `len` consecutive columns, four at a time where `quad` says the
// columns are aligned for it
template <bool kSmem, typename W, typename Row>
__device__ __forceinline__ void row_products(const float* x, int n, Row w,
                                             int len, bool quad,
                                             float (&out)[4]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) out[v] = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxRc; ++k) {
    if (k < n) {
      const W* row = w(k);
      if (quad) {
        const float4 q = ldw4(row);
        out[0] = fmaf(x[k], q.x, out[0]);
        out[1] = fmaf(x[k], q.y, out[1]);
        out[2] = fmaf(x[k], q.z, out[2]);
        out[3] = fmaf(x[k], q.w, out[3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < len) out[v] = fmaf(x[k], ldw<kSmem>(row + v), out[v]);
      }
    }
  }
}

// len values to remote address `dst` (mbarrier `bar`), one 16-byte
// st.async where aligned
__device__ __forceinline__ void send_at(Addr dst, Addr bar,
                                        const float (&v)[4], int len,
                                        bool quad) {
  if (quad) {
    st_async(dst, bar, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < len) st_async(dst + 4 * i, bar, v[i]);
  }
}

// len values to `dst` in block q
__device__ __forceinline__ void send(float* dst, int q, uint64_t* bar,
                                     const float (&v)[4], int len,
                                     bool quad) {
  send_at(remote(dst, q), remote(bar, q), v, len, quad);
}

// partial [sl*n + j] = sum over rows of slice sl of in[i] * w[i*ldw + j]
// (slices of the K rows over the block's threads, n columns)
template <bool kSmem, typename W, bool kRelu>
__device__ __forceinline__ void head_part(const float* in, const W* w,
                                          int ldw_, int K, int n,
                                          float* part) {
  const int nsl = kThreads / n, tid = threadIdx.x;
  if (tid >= nsl * n) return;
  const int j = tid % n, sl = tid / n;
  const int per = (K + nsl - 1) / nsl;
  const int i0 = sl * per, i1 = min(K, i0 + per);
  float acc = 0.f;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const float x = kRelu ? fmaxf(in[i], 0.f) : in[i];
    acc = fmaf(x, ldw<kSmem>(w + (size_t)i * ldw_ + j), acc);
  }
  part[sl * n + j] = acc;
}

// the 16 partials src[q * stride], one from each block, in a fixed
// order: even and odd blocks as two chains, then their sum
__device__ __forceinline__ float sum16(const float* src, int stride) {
  float e = src[0], o = src[stride];
#pragma unroll
  for (int q = 2; q < kCluster; q += 2) {
    e += src[q * stride];
    o += src[(q + 1) * stride];
  }
  return e + o;
}

__device__ __forceinline__ float head_sum(const float* part, int n, int j) {
  const int nsl = kThreads / n;
  float s = part[j];
  for (int sl = 1; sl < nsl; ++sl) s += part[sl * n + j];
  return s;
}

// n values of the block (in vec) to the n-column slot of every block's
// `gat` (offset r*n), four at a time where aligned, by threads
// [t0, t0 + nt) of the block
__device__ __forceinline__ void all_gather(const float* vec, int n, float* gat,
                                           int r, uint64_t* bar, int t0,
                                           int nt) {
  const int nch = (n + 3) / 4;
  for (int it = threadIdx.x - t0; it >= 0 && it < kCluster * nch; it += nt) {
    const int q = it / nch, c = 4 * (it % nch), len = min(4, n - c);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < len ? vec[c + i] : 0.f;
    send(gat + r * n + c, q, bar, v, len, n % 4 == 0 && len == 4);
  }
}

// shared-memory carve, in bytes from the start
struct Layout {
  size_t xa, xb, xs, cb, gc, ring, rbuf, sgat, xgat, part, vec, pick, bar;
  size_t wa, wc, wrs, h1, h2;   // the resident slices
  size_t bytes;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// rows: sum(dils), the rows of the ring buffers
__host__ __device__ inline Layout make_layout(int R, int S, int d, int mu,
                                              int L, int rows, bool resident,
                                              int elt) {
  Layout o;
  const int Rc = R / kCluster, Sc = S / kCluster, Mc = mu / kCluster;
  const int G = 2 * Rc;
  size_t at = 0;
  o.xa = at;   at = align16(at + 4 * (size_t)2 * kCluster * G);
  o.xb = at;   at = align16(at + 4 * (size_t)2 * kCluster * Rc);
  o.xs = at;   at = align16(at + 4 * (size_t)2 * kCluster * Sc);
  o.cb = at;   at = align16(at + 4 * (size_t)2 * L * G);
  o.gc = at;   at = align16(at + 4 * (size_t)L * G);
  o.ring = at; at = align16(at + 4 * (size_t)2 * L);
  o.rbuf = at; at = align16(at + (size_t)elt * rows * Rc);
  o.sgat = at; at = align16(at + 4 * (size_t)S);
  o.xgat = at; at = align16(at + 4 * (size_t)S);
  o.part = at; at = align16(at + 4 * (size_t)kThreads);
  o.vec = at;  at = align16(at + 4 * (size_t)(Sc > 32 ? Sc : 32));
  o.pick = at; at = align16(at + 8 * (size_t)kCluster);
  o.bar = at;  at = align16(at + 8 * (size_t)kBars);
  o.wa = o.wc = o.wrs = o.h1 = o.h2 = at;
  if (resident) {
    o.wa = at;  at = align16(at + (size_t)elt * L * G * 2 * R);
    o.wc = at;  at = align16(at + (size_t)elt * L * G * d);
    o.wrs = at; at = align16(at + (size_t)elt * L * Rc * (R + S));
    o.h1 = at;  at = align16(at + (size_t)elt * S * Sc);
    o.h2 = at;  at = align16(at + 4 * (size_t)S * Mc);
  }
  o.bytes = at;
  return o;
}

// the bytes a block receives in exchange B of launch layer n: residual
// partials (not for a step's last layer, whose residual nobody reads)
// and skip partials, 16 senders each
__device__ __forceinline__ unsigned bytes_b(int n, int L, int Rc, int Sc) {
  return 4u * kCluster * ((n % L < L - 1 ? Rc : 0) + Sc);
}

// kRC, kSC: R/C and S/C compiled in, or 0 to read them from the shape
template <typename T, int kRC, int kSC>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(const Ptrs<T> a, const Shape sh, long long t0,
                  uint32_t seed, float temperature, int mode) {
  // the dtype picks the stage: bf16 slices live in shared memory
  constexpr bool kSmem = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = sh.R, S = sh.S, d = sh.d, mu = sh.mu, L = sh.L;
  const int B = sh.B, n_steps = sh.T, n_layers = n_steps * L;
  const int R2 = 2 * R, RS = R + S;
  const int Rc = kRC ? kRC : R / kCluster, Sc = kSC ? kSC : S / kCluster;
  const int Mc = mu / kCluster;
  const int G = 2 * Rc;   // the block's gate columns
  const int r = cluster_rank(), b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch0 = r * Rc;  // the block's channels [ch0, ch0 + Rc)

  const int rows = sh.off[L - 1] + sh.dil[L - 1];   // sum(dils)
  const Layout lay = make_layout(R, S, d, mu, L, rows, kSmem, sizeof(T));
  float* xa_s = reinterpret_cast<float*>(smem_raw + lay.xa);  // [2][C][G]
  float* xb_s = reinterpret_cast<float*>(smem_raw + lay.xb);  // [2][C][Rc]
  float* xs_s = reinterpret_cast<float*>(smem_raw + lay.xs);  // [2][C][Sc]
  float* cb_s = reinterpret_cast<float*>(smem_raw + lay.cb);  // [2][L][G]
  float* gc_s = reinterpret_cast<float*>(smem_raw + lay.gc);  // [L][G]
  // the block's channels of the ring buffers, [sum(dils)][Rc], in
  // shared memory for the launch; ring_s [2][L]: each layer's row of it
  // this step
  T* rbuf = reinterpret_cast<T*>(smem_raw + lay.rbuf);
  int* ring_s = reinterpret_cast<int*>(smem_raw + lay.ring);
  float* sgat = reinterpret_cast<float*>(smem_raw + lay.sgat);  // [S]
  float* xgat = reinterpret_cast<float*>(smem_raw + lay.xgat);  // [S]
  float* part = reinterpret_cast<float*>(smem_raw + lay.part);  // [threads]
  float* vec_s = reinterpret_cast<float*>(smem_raw + lay.vec);
  uint2* pick_s = reinterpret_cast<uint2*>(smem_raw + lay.pick);  // [C]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bar);

  // the block's gate column of value v < G: tanh columns, then sigmoid
  auto col = [&](int v) { return v < Rc ? ch0 + v : R + ch0 + v - Rc; };

  // ---- weight slices: resident (bf16) or read in place ----
  // A rows (l, k): k < Rc the h row R + ch0 + k of wff[l], else the
  // past row ch0 + k - Rc; 2R columns
  auto a_row = [&](int l, int k) -> const T* {
    if constexpr (kSmem)
      return reinterpret_cast<const T*>(smem_raw + lay.wa) +
             ((size_t)l * G + k) * R2;
    else
      return a.wff +
             ((size_t)l * R2 + (k < Rc ? R + ch0 + k : ch0 + k - Rc)) * R2;
  };
  // c @ vc_all weight of input i for value v of layer l
  auto c_w = [&](int l, int v, int i) -> float {
    if constexpr (kSmem)
      return to_f(reinterpret_cast<const T*>(smem_raw + lay.wc)
                      [((size_t)l * G + v) * d + i]);
    else
      return to_f(__ldg(a.vc_all + (size_t)i * L * R2 + (size_t)l * R2 +
                        col(v)));
  };
  // z row jj of layer l: [wr | ws][ch0 + jj], R + S columns
  auto rs_row = [&](int l, int jj) -> const T* {
    if constexpr (kSmem)
      return reinterpret_cast<const T*>(smem_raw + lay.wrs) +
             ((size_t)l * Rc + jj) * RS;
    else
      return a.wrs + ((size_t)l * R + ch0 + jj) * RS;
  };
  const T* h1;
  const float* h2;
  int ld_h1, ld_h2;
  if constexpr (kSmem) {
    T* swa = reinterpret_cast<T*>(smem_raw + lay.wa);
    T* swc = reinterpret_cast<T*>(smem_raw + lay.wc);
    T* swrs = reinterpret_cast<T*>(smem_raw + lay.wrs);
    T* sh1 = reinterpret_cast<T*>(smem_raw + lay.h1);
    float* sh2 = reinterpret_cast<float*>(smem_raw + lay.h2);
    for (int idx = tid; idx < L * G * R2; idx += kThreads) {
      const int l = idx / (G * R2), k = idx / R2 % G;
      const int row = k < Rc ? R + ch0 + k : ch0 + k - Rc;
      swa[idx] = a.wff[((size_t)l * R2 + row) * R2 + idx % R2];
    }
    for (int idx = tid; idx < L * G * d; idx += kThreads) {
      const int l = idx / (G * d), v = idx / d % G;
      swc[idx] = a.vc_all[(size_t)(idx % d) * L * R2 + (size_t)l * R2 +
                          col(v)];
    }
    for (int idx = tid; idx < L * Rc * RS; idx += kThreads) {
      const int l = idx / (Rc * RS), jj = idx / RS % Rc;
      swrs[idx] = a.wrs[((size_t)l * R + ch0 + jj) * RS + idx % RS];
    }
    for (int idx = tid; idx < S * Sc; idx += kThreads)
      sh1[idx] = a.h1[(size_t)(idx / Sc) * S + r * Sc + idx % Sc];
    for (int idx = tid; idx < S * Mc; idx += kThreads)
      sh2[idx] = a.h2[(size_t)(idx / Mc) * mu + r * Mc + idx % Mc];
    h1 = sh1;
    ld_h1 = Sc;
    h2 = sh2;
    ld_h2 = Mc;
  } else {
    h1 = a.h1 + r * Sc;
    ld_h1 = S;
    h2 = a.h2 + r * Mc;
    ld_h2 = mu;
  }
  for (int idx = tid; idx < L * G; idx += kThreads)
    gc_s[idx] = to_f(a.gcond[((size_t)(idx / G) * B + b) * R2 +
                             col(idx % G)]);
  for (int idx = tid; idx < rows * Rc; idx += kThreads)
    rbuf[idx] = a.bufs[((size_t)(idx / Rc) * B + b) * R + ch0 + idx % Rc];

  // warp w: the ring rows of step s into table half s & 1
  auto ring_table = [&](int s) {
    for (int l = lane; l < L; l += 32)
      ring_s[(s & 1) * L + l] =
          (sh.off[l] + ring_slot(t0 + s, sh.dil[l])) * Rc;
  };
  // warp 0: the block's ring channels of layer l, table half sp
  float tap[kMaxRc];
  auto load_taps = [&](int l, int sp) {
    const T* src = rbuf + ring_s[sp * L + l];
    if constexpr (sizeof(T) == 2) {
      if (Rc == 4) {   // the four bf16 channels in one 8-byte load
        const float4 f = ld_quad(src);
        tap[0] = f.x;
        tap[1] = f.y;
        tap[2] = f.z;
        tap[3] = f.w;
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxRc; ++i) tap[i] = i < Rc ? to_f(src[i]) : 0.f;
  };
  // warps w0.. (nw of them): cb[l][v] = c_{step} @ vc_all + gcond for
  // the outputs o in [o0, o1) of layer-major index o = l * G + v
  float cnd[kMaxD / 32];
  auto load_cond = [&](int s) {
#pragma unroll
    for (int k = 0; k < kMaxD / 32; ++k) {
      const int i = lane + 32 * k;
      cnd[k] = i < d ? to_f(__ldg(a.cond + ((size_t)b * n_steps + s) * d + i))
                     : 0.f;
    }
  };
  auto cond_base = [&](float* cb, int o0, int o1, int w0, int nw) {
    for (int o = o0 + warp - w0; o < o1; o += nw) {
      const int l = o / G, v = o % G;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxD / 32; ++k) {
        const int i = lane + 32 * k;
        if (i < d) acc = fmaf(cnd[k], c_w(l, v, i), acc);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(kFull, acc, m);
      if (lane == 0) cb[o] = acc + gc_s[o];
    }
  };

  if (tid == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i);
    mbar_init_fence();
    // the first phase of each mbarrier
    for (int n = 0; n < 2 && n < n_layers; ++n) {
      mbar_arm(bars + kBarA + n, 4u * kCluster * G);
      mbar_arm(bars + kBarB + n, bytes_b(n, L, Rc, Sc));
    }
    mbar_arm(bars + kBarSkips, 4u * S);
    mbar_arm(bars + kBarXa, 4u * S);
    if (mode != kTeacher) mbar_arm(bars + kBarPick, 8u * kCluster);
  }
  __syncthreads();   // gc_s, rbuf and the resident slices are in place
  if (n_steps > 0) {
    load_cond(0);
    cond_base(cb_s, 0, L * G, 0, kWarps);
    if (warp == 0) ring_table(0);
    __syncwarp();
    if (warp == 0) load_taps(0, 0);
  }
  // cb_s is in place and the first taps are read before any lane
  // writes the ring
  __syncthreads();
  // every block of the cluster runs, its mbarriers set, before any
  // remote access
  cluster_sync();

  // warp 0 keeps the block's channels of h and pe0
  // brs[2][]: the residual bias of the block's channels, by layer
  // parity, each loaded a layer before its use
  float h[kMaxRc], pe0[kMaxRc], brs[2][kMaxRc], z[kMaxRc];
#pragma unroll
  for (int i = 0; i < kMaxRc; ++i) {
    pe0[i] = i < Rc ? to_f(a.pe0[(size_t)b * R + ch0 + i]) : 0.f;
    brs[0][i] = i < Rc ? to_f(__ldg(a.brs + ch0 + i)) : 0.f;
    h[i] = brs[1][i] = z[i] = 0.f;
  }
  int x = a.x_last[b];
  float sk = 0.f, brs_s = 0.f;   // warp 7, lane k < Sc: skip column k
  // warp 7: the skip sum += the 16 partials in exchange buffer `par`
  auto skip_sum = [&](int par) {
    if (lane < Sc) {
      const float acc = sum16(xs_s + (size_t)par * kCluster * Sc + lane, Sc);
      sk = rnd<T>(sk + rnd<T>(rnd<T>(acc) + brs_s));
    }
  };

  // exchange A (warp 0): lane j sends owner j % 16 its tanh (j < 16)
  // or sigmoid columns, a_c0 onwards, of [past | h] @ wff
  const int a_q = lane & 15, a_c0 = (lane >> 4) * R + a_q * Rc;
  const bool a_quad = Rc == 4;
  Addr a_dst[2], a_bar[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    a_dst[p] = remote(xa_s + ((size_t)p * kCluster + r) * G + (lane >> 4) * Rc,
                      a_q);
    a_bar[p] = remote(bars + kBarA + p, a_q);
  }
  // exchange B (warps 0-3): the pieces of z @ [wr | ws] a lane sends,
  // at most two, the same every layer: residual pieces (Rc columns an
  // owner, four at a time) first, then skip pieces (Sc an owner)
  struct Piece {
    int c0, len;
    bool valid, res, quad;
    Addr dst[2], bar[2];
  } pc[2];
  {
    const int ncr = (Rc + 3) / 4, ncs = (Sc + 3) / 4;
    const int n_res = kCluster * ncr, n_all = n_res + kCluster * ncs;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int it = tid + 32 * kChainWarps * k;
      Piece& c = pc[k];
      c.valid = warp < kChainWarps && it < n_all;
      c.res = it < n_res;
      const int kk = c.res ? it : it - n_res, nch = c.res ? ncr : ncs;
      const int q = c.valid ? kk / nch : 0, off = 4 * (kk % nch);
      const int w = c.res ? Rc : Sc;
      c.len = min(4, w - off);
      c.c0 = c.res ? q * Rc + off : R + q * Sc + off;
      c.quad = w % 4 == 0 && c.len == 4;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        c.dst[p] = remote(c.res ? xb_s + ((size_t)p * kCluster + r) * Rc + off
                                : xs_s + ((size_t)p * kCluster + r) * Sc + off,
                          q);
        c.bar[p] = remote(bars + kBarB + p, q);
      }
    }
  }

  for (int s = 0; s < n_steps; ++s) {
    const long long t = t0 + s;
    if (mode == kTeacher) x = a.ids_in[(size_t)b * n_steps + s];
    if (warp == 0) {
      // the input embedding: h = emb1[x] + emb0[x_prev] + b
      const T* e1 = a.emb_w + ((size_t)mu + x) * R + ch0;
      const T* e0 = a.emb_w + (size_t)x * R + ch0;
#pragma unroll
      for (int i = 0; i < kMaxRc; ++i) {
        if (i < Rc) {
          h[i] = rnd<T>(rnd<T>(to_f(__ldg(e1 + i)) + pe0[i]) +
                        to_f(__ldg(a.emb_b + ch0 + i)));
          pe0[i] = to_f(__ldg(e0 + i));
        }
      }
    }
    const bool next_cond = s + 1 < n_steps && warp >= kCondWarp0 &&
                           warp < kSkipWarp;
    if (next_cond) load_cond(s + 1);
    sk = 0.f;
    const float* cb = cb_s + (size_t)(s & 1) * L * G;

    for (int l = 0; l < L; ++l) {
      const int n = s * L + l, par = n & 1;
      const unsigned ph = (n >> 1) & 1;
      const bool last = l == L - 1;   // its residual is never read
      uint64_t* bar_a = bars + kBarA + par;
      uint64_t* bar_b = bars + kBarB + par;
      if (warp == 0) {
        // the ring keeps the block's channels of h
        T* ring = rbuf + ring_s[(s & 1) * L + l];
        if (lane < Rc) {
#pragma unroll
          for (int i = 0; i < kMaxRc; ++i)
            if (i == lane) ring[i] = from_f<T>(h[i]);
        }
        // exchange A: this block's channels of h and of the tap times
        // the lane's columns of wff
        float acc[4], acc2[4];
        row_products<kSmem, T>(
            h, Rc, [&](int k) { return a_row(l, k) + a_c0; }, min(Rc, 4),
            a_quad, acc);
        row_products<kSmem, T>(
            tap, Rc, [&](int k) { return a_row(l, Rc + k) + a_c0; },
            min(Rc, 4), a_quad, acc2);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] += acc2[v];
        const Addr ad = par ? a_dst[1] : a_dst[0], ab = par ? a_bar[1] : a_bar[0];
        send_at(ad, ab, acc, min(Rc, 4), a_quad);
        if (Rc > 4) {   // the next Rc - 4 columns
          row_products<kSmem, T>(
              h, Rc, [&](int k) { return a_row(l, k) + a_c0 + 4; }, Rc - 4,
              false, acc);
          row_products<kSmem, T>(
              tap, Rc, [&](int k) { return a_row(l, Rc + k) + a_c0 + 4; },
              Rc - 4, false, acc2);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += acc2[v];
          send_at(ad + 16, ab, acc, Rc - 4, false);
        }
      }
      if (warp == kSkipWarp && l > 0) {
        // the skip sum of layer l-1: its exchange completed a layer ago
        mbar_wait(bars + kBarB + (par ^ 1), ((n - 1) >> 1) & 1);
        skip_sum(par ^ 1);
      }
      if (warp == kSkipWarp && lane < Sc)
        brs_s = to_f(__ldg(a.brs + (size_t)l * RS + R + r * Sc + lane));

      if (warp < kChainWarps) {
        mbar_wait(bar_a, ph);
        if (tid == 0 && n + 2 < n_layers) mbar_arm(bar_a, 4u * kCluster * G);
        // the gate: u of value v = cb + the 16 partials
        float u = 0.f;
        if (lane < G)
          u = sum16(xa_s + (size_t)par * kCluster * G + lane, G) +
              cb[l * G + lane];
        // lanes 0-15 take tanh of value lane % Rc, lanes 16-31 the
        // sigmoid of the same channel
        const int jj = (lane & 15) % Rc;
        const float uu = __shfl_sync(kFull, u, lane < 16 ? jj : Rc + jj);
        const float act = lane < 16 ? tanhf(uu) : 1.f / (1.f + expf(-uu));
        const float zl = rnd<T>(act * __shfl_xor_sync(kFull, act, 16));
#pragma unroll
        for (int i = 0; i < kMaxRc; ++i)
          if (i < Rc) z[i] = __shfl_sync(kFull, zl, i);

        // exchange B: the split-K partials of z @ [wr | ws], residual
        // pieces to the channel owners, skip pieces to the skip owners
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const Piece& c = pc[k];
          if (c.valid && !(last && c.res)) {
            float acc[4];
            row_products<kSmem, T>(
                z, Rc, [&](int jr) { return rs_row(l, jr) + c.c0; }, c.len,
                c.quad, acc);
            send_at(par ? c.dst[1] : c.dst[0], par ? c.bar[1] : c.bar[0], acc,
                    c.len, c.quad);
          }
        }
        if (warp == 0) {
          // while exchange B is in flight: the next layer's ring taps
          // and residual bias
          if (n + 1 < n_layers) load_taps(last ? 0 : l + 1, (s + last) & 1);
          const T* bn = a.brs + (size_t)(last ? 0 : l + 1) * RS + ch0;
#pragma unroll
          for (int i = 0; i < kMaxRc; ++i) {
            if (i < Rc) {
              if (par)
                brs[0][i] = to_f(__ldg(bn + i));
              else
                brs[1][i] = to_f(__ldg(bn + i));
            }
          }
        }
      }

      if (warp == 0) {
        mbar_wait(bar_b, ph);
        if (tid == 0 && n + 2 < n_layers)
          mbar_arm(bar_b, bytes_b(n + 2, L, Rc, Sc));
        if (!last) {
          // h += rs[:R] for the block's channels
          const float* src = xb_s + (size_t)par * kCluster * Rc;
          float acc[kMaxRc];
          if (Rc == 4) {   // 16-byte rows, the four sums side by side,
                           // in sum16's order
            float4 e = *reinterpret_cast<const float4*>(src);
            float4 o = *reinterpret_cast<const float4*>(src + 4);
#pragma unroll
            for (int q = 2; q < kCluster; q += 2) {
              const float4 we = *reinterpret_cast<const float4*>(src + 4 * q);
              const float4 wo =
                  *reinterpret_cast<const float4*>(src + 4 * (q + 1));
              e.x += we.x;
              e.y += we.y;
              e.z += we.z;
              e.w += we.w;
              o.x += wo.x;
              o.y += wo.y;
              o.z += wo.z;
              o.w += wo.w;
            }
            acc[0] = e.x + o.x;
            acc[1] = e.y + o.y;
            acc[2] = e.z + o.z;
            acc[3] = e.w + o.w;
          } else {
#pragma unroll
            for (int i = 0; i < kMaxRc; ++i)
              acc[i] = i < Rc ? sum16(src + i, Rc) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kMaxRc; ++i) {
            if (i < Rc) {
              const float bias = par ? brs[1][i] : brs[0][i];
              h[i] = rnd<T>(h[i] + rnd<T>(rnd<T>(acc[i]) + bias));
            }
          }
        }
      }
      // off the chain: the next step's ring table, and its
      // c @ vc_all + gcond of layer l
      if (next_cond && warp == kCondWarp0 && l == 0) ring_table(s + 1);
      if (next_cond)
        cond_base(cb_s + (size_t)((s + 1) & 1) * L * G, l * G, (l + 1) * G,
                  kCondWarp0, kSkipWarp - kCondWarp0);
      // every thread is done with this layer's buffers before the block
      // sends into the next one's
      __syncthreads();
    }

    // ---- the head ----
    const unsigned hp = s & 1;   // the phase of the head's mbarriers
    if (warp == kSkipWarp) {
      const int n = s * L + L - 1;
      mbar_wait(bars + kBarB + (n & 1), (n >> 1) & 1);
      skip_sum(n & 1);
      if (lane < Sc) vec_s[lane] = sk;
      __syncwarp();
      all_gather(vec_s, Sc, sgat, r, bars + kBarSkips, 32 * kSkipWarp, 32);
    }
    mbar_wait(bars + kBarSkips, hp);
    if (tid == 0 && s + 1 < n_steps) mbar_arm(bars + kBarSkips, 4u * S);
    // xa = relu(relu(skips) @ h1 + b1), the block's S/C columns
    head_part<kSmem, T, true>(sgat, h1, ld_h1, S, Sc, part);
    __syncthreads();
    if (tid < Sc)
      vec_s[tid] = rnd<T>(fmaxf(
          head_sum(part, Sc, tid) + to_f(__ldg(a.b1 + r * Sc + tid)), 0.f));
    __syncthreads();
    all_gather(vec_s, Sc, xgat, r, bars + kBarXa, 0, kThreads);
    mbar_wait(bars + kBarXa, hp);
    if (tid == 0 && s + 1 < n_steps) mbar_arm(bars + kBarXa, 4u * S);
    // logits = xa @ h2 + b2, the block's mu/C columns
    head_part<kSmem, float, false>(xgat, h2, ld_h2, S, Mc, part);
    __syncthreads();
    if (warp == 0) {
      const int j = r * Mc + lane;
      float best = -CUDART_INF_F;
      int best_i = INT_MAX;
      if (lane < Mc) {
        const float logit = head_sum(part, Mc, lane) + __ldg(a.b2 + j);
        if (mode == kTeacher) {
          a.logits_out[((size_t)b * n_steps + s) * mu + j] = logit;
        } else {
          best = mode == kGreedy ? logit
                                 : logit / temperature +
                                       gumbel(seed, j, sh.row0 + b, t);
          best_i = j;
        }
      }
      if (mode != kTeacher) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          better(best, best_i, __shfl_xor_sync(kFull, best, o),
                 __shfl_xor_sync(kFull, best_i, o));
        if (lane < kCluster)
          st_async(remote(pick_s + r, lane), remote(bars + kBarPick, lane),
                   make_uint2(__float_as_uint(best), (unsigned)best_i));
      }
    }
    if (mode != kTeacher) {
      mbar_wait(bars + kBarPick, hp);
      if (tid == 0 && s + 1 < n_steps) mbar_arm(bars + kBarPick, 8u * kCluster);
      // every block agrees on the pick: the candidates in block order
      float best = __uint_as_float(pick_s[0].x);
      int best_i = (int)pick_s[0].y;
#pragma unroll
      for (int q = 1; q < kCluster; ++q)
        better(best, best_i, __uint_as_float(pick_s[q].x), (int)pick_s[q].y);
      x = best_i;
      if (r == 0 && tid == 0) a.ids_out[(size_t)b * n_steps + s] = x;
    }
  }

  if (warp == 0 && lane < Rc) {
#pragma unroll
    for (int i = 0; i < kMaxRc; ++i)
      if (i == lane) a.pe0[(size_t)b * R + ch0 + i] = from_f<T>(pe0[i]);
  }
  // the ring buffers back to the state (the last layer's writes were
  // ordered by the head's __syncthreads)
  for (int idx = tid; idx < rows * Rc; idx += kThreads)
    a.bufs[((size_t)(idx / Rc) * B + b) * R + ch0 + idx % Rc] = rbuf[idx];
  if (r == 0 && tid == 0 && mode != kTeacher) a.x_last[b] = x;
  // no block leaves while another may still address its shared memory
  cluster_sync();
}

/*
 * The two ways a cluster can agree, for the request phase to time:
 * mode 0 passes `iters` cluster barriers (barrier.cluster with release
 * and acquire); mode 1 runs `iters` exchanges of the decode kernel's
 * kind (each block st.async's one word to every block, then waits on
 * its mbarrier, a __syncthreads between rounds).
 */
__global__ void __launch_bounds__(kThreads, 1)
    exchange_probe(int iters, int mode) {
  __shared__ uint64_t bars[2];
  __shared__ float box[2][kCluster];
  const int tid = threadIdx.x, r = cluster_rank();
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_init_fence();
    mbar_arm(bars, 4u * kCluster);
    mbar_arm(bars + 1, 4u * kCluster);
  }
  __syncthreads();
  cluster_sync();
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) {
      cluster_sync();
      continue;
    }
    const int par = i & 1;
    __syncthreads();
    if (tid < kCluster)
      st_async(remote(&box[par][r], tid), remote(bars + par, tid), (float)i);
    mbar_wait(bars + par, (i >> 1) & 1);
    if (tid == 0 && i + 2 < iters) mbar_arm(bars + par, 4u * kCluster);
  }
  cluster_sync();
}

int check_shape(int R, int S, int d, int mu, int L) {
  if (R <= 0 || S <= 0 || mu <= 0 || d <= 0 || R % kCluster ||
      S % kCluster || mu % kCluster || R > kCluster * kMaxRc || d > kMaxD ||
      S > 32 * kCluster || mu > 32 * kCluster || L < 2 || L > kMaxLayers)
    return kErrShape;
  return 0;
}

cudaLaunchConfig_t cluster_config(int B, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// sets the kernel's attributes and returns how many of its clusters fit
// on the card at once (0: none)
template <typename K>
int prepare(K kernel, size_t smem, bool resident, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    // float32 reads its weights through L1: leave L1 the most room
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             resident ? 100 : 0);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, smem, nullptr, attr);
  e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return (int)e;
}

template <typename T>
int launch(int mode, const void* emb_w, const void* emb_b, const void* wff,
           const void* vc_all, const void* wrs, const void* brs,
           const void* h1, const void* b1, const float* h2, const float* b2,
           const void* cond, const void* gcond, const int* ids_in,
           int* ids_out, float* logits_out, void* bufs, void* pe0,
           int* x_last, const Shape& sh, long long t0, uint32_t seed,
           float temperature, cudaStream_t stream, int* info) {
  constexpr bool kResident = std::is_same<T, __nv_bfloat16>::value;
  const Layout lay =
      make_layout(sh.R, sh.S, sh.d, sh.mu, sh.L,
                  sh.off[sh.L - 1] + sh.dil[sh.L - 1], kResident, sizeof(T));
  if (lay.bytes > 232448) return kErrSmem;
  // the flagship's widths compiled in, any other through the shape
  auto kernel = sh.R == 4 * kCluster && sh.S == 16 * kCluster
                    ? decode_kernel<T, 4, 16>
                    : decode_kernel<T, 0, 0>;
  // the occupancy query runs once per instance and size.  Host threads
  // launch at once (the daemon's connections, each on its own stream),
  // so the cache and the launch hold one mutex: no other size's
  // shared-memory attribute lands between this prepare and this launch
  static std::mutex mutex;
  static decltype(kernel) last_kernel = nullptr;
  static size_t last_smem = 0;
  static int last_clusters = 0;
  const std::lock_guard<std::mutex> hold(mutex);
  if (kernel != last_kernel || lay.bytes != last_smem) {
    int n = 0;
    const int e = prepare(kernel, lay.bytes, kResident, &n);
    if (e != 0) return e;
    last_kernel = kernel;
    last_smem = lay.bytes;
    last_clusters = n;
  }
  if (info) {
    info[0] = kCluster;
    info[1] = (int)lay.bytes;
    info[2] = kResident;
    info[3] = last_clusters;
    return 0;
  }
  if (last_clusters < 1) return kErrCluster;
  Ptrs<T> p;
  p.emb_w = static_cast<const T*>(emb_w);
  p.emb_b = static_cast<const T*>(emb_b);
  p.wff = static_cast<const T*>(wff);
  p.vc_all = static_cast<const T*>(vc_all);
  p.wrs = static_cast<const T*>(wrs);
  p.brs = static_cast<const T*>(brs);
  p.h1 = static_cast<const T*>(h1);
  p.b1 = static_cast<const T*>(b1);
  p.h2 = h2;
  p.b2 = b2;
  p.cond = static_cast<const T*>(cond);
  p.gcond = static_cast<const T*>(gcond);
  p.ids_in = ids_in;
  p.ids_out = ids_out;
  p.logits_out = logits_out;
  p.bufs = static_cast<T*>(bufs);
  p.pe0 = static_cast<T*>(pe0);
  p.x_last = x_last;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(sh.B, lay.bytes, stream, attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, p, sh, t0, seed, temperature, mode);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int dispatch(int cdtype, int mode, const void* emb_w, const void* emb_b,
             const void* wff, const void* vc_all, const void* wrs,
             const void* brs, const void* h1, const void* b1, const float* h2,
             const float* b2, const void* cond, const void* gcond,
             const int* ids_in, int* ids_out, float* logits_out, void* bufs,
             void* pe0, int* x_last, const Shape& sh, long long t0,
             uint32_t seed, float temperature, cudaStream_t st, int* info) {
  if (cdtype == 0)
    return launch<float>(mode, emb_w, emb_b, wff, vc_all, wrs, brs, h1, b1,
                         h2, b2, cond, gcond, ids_in, ids_out, logits_out,
                         bufs, pe0, x_last, sh, t0, seed, temperature, st,
                         info);
  if (cdtype == 1)
    return launch<__nv_bfloat16>(mode, emb_w, emb_b, wff, vc_all, wrs, brs,
                                 h1, b1, h2, b2, cond, gcond, ids_in,
                                 ids_out, logits_out, bufs, pe0, x_last, sh,
                                 t0, seed, temperature, st, info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// cdtype: 0 = float32, 1 = bfloat16.  mode: 0 teacher-forced logits,
// 1 greedy ids, 2 Gumbel-max sampled ids.  bufs/pe0/x_last are the
// decode state, updated in place.  row0 (>= 0) is the noise's row of
// batch row 0: 0 for a whole batch, a shard's first row of it otherwise.
// Returns 0, a cudaError_t code, or
// -1 (R, S or mu not a multiple of 16, or past the kernel's limits),
// -2 (the card cannot schedule one 16-block cluster), -3 (the resident
// slices do not fit in shared memory).
extern "C" int vqvae_decode(
    int cdtype, int mode, const void* emb_w, const void* emb_b,
    const void* wff, const void* vc_all, const void* wrs, const void* brs,
    const void* h1, const void* b1, const float* h2, const float* b2,
    const void* cond, const void* gcond, const int* ids_in, int* ids_out,
    float* logits_out, void* bufs, void* pe0, int* x_last, int B, int T,
    int R, int S, int d, int mu, int L, const int* dils, long long t0,
    unsigned int seed, float temperature, int row0, void* stream) {
  if (L <= 0 || L > kMaxLayers || B <= 0 || B > 65535 || T < 0 || mode < 0 ||
      mode > 2 || row0 < 0)
    return (int)cudaErrorInvalidValue;
  if (check_shape(R, S, d, mu, L)) return kErrShape;
  if (T == 0) return 0;
  Shape sh;
  sh.B = B;
  sh.T = T;
  sh.R = R;
  sh.S = S;
  sh.d = d;
  sh.mu = mu;
  sh.L = L;
  sh.row0 = row0;
  int acc = 0;
  for (int l = 0; l < L; ++l) {
    if (dils[l] <= 0) return (int)cudaErrorInvalidValue;
    sh.dil[l] = dils[l];
    sh.off[l] = acc;
    acc += dils[l];
  }
  (void)cudaGetLastError();  // report only this launch's error
  return dispatch(cdtype, mode, emb_w, emb_b, wff, vc_all, wrs, brs, h1, b1,
                  h2, b2, cond, gcond, ids_in, ids_out, logits_out, bufs,
                  pe0, x_last, sh, t0, seed, temperature,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// What a launch at these widths, with `rows` = sum(dilations) ring rows,
// would use: out[0] the cluster size,
// out[1] shared memory per block in bytes, out[2] 1 if the weight
// slices are resident in shared memory, out[3] the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters).  Returns as
// vqvae_decode does.
extern "C" int vqvae_decode_info(int cdtype, int R, int S, int d, int mu,
                                 int L, int rows, int* out) {
  if (check_shape(R, S, d, mu, L)) return kErrShape;
  Shape sh = {};
  sh.B = 1;
  sh.R = R;
  sh.S = S;
  sh.d = d;
  sh.mu = mu;
  sh.L = L;
  sh.dil[L - 1] = rows;   // the layout reads sum(dils) as off + dil
  return dispatch(cdtype, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, sh, 0, 0, 1.f, nullptr, out);
}

// One 16-block cluster of the decode kernel's width that only agrees,
// `iters` times: mode 0 by cluster barrier (release/acquire), mode 1 by
// the decode kernel's st.async + mbarrier exchange.  The caller times it.
extern "C" int vqvae_cluster_exchange_probe(int iters, int mode,
                                            void* stream) {
  if (iters < 0 || mode < 0 || mode > 1) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();
  cudaError_t e = cudaFuncSetAttribute(
      exchange_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(1, 0, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, exchange_probe, iters, mode);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
