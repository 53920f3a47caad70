// The gates of the WaveNet autoencoder's decoder stack (NSynth,
// models/wavenet_ae.py), forward and backward, around the cuBLAS products
// of kernels/wavenet_ae_cuda.py::GatedStack.
//
// Replaces no TPU kernel: the JAX package has no autoencoder; the plain
// path left the gate to PyTorch's elementwise kernels (the condition's
// tile add, sigmoid, tanh, their product, and in the backward the split's
// cats, the activations' backwards and the tile's frame sums).  The plain
// PyTorch versions are kernels/wavenet_ae_cuda.py (gate_fwd_plain,
// gate_bwd_plain).
//
// Layout.  A layer's tap conv reads its input once padded, as rows:
// crop b's time t is row b*(T+P) + t of the conv's output u [*, 2R]
// (P = the taps' reach; the P rows after each crop straddle two crops and
// are read by nothing).  cond [B, F, 2R] is the layer's frame-rate
// condition with its bias, one row a frame of hop samples (T = F*hop).
// E, the storage type, is float or bf16; all arithmetic is float32.
//
//   forward   v = u[row(b, t)] + cond[b, t / hop]
//             z[b*T + t, c] = E(sigmoid(v[c]) * tanh(v[R + c]))     c < R
//   backward  a = sigmoid(v[c]), h = tanh(v[R + c]), g = gz[b*T + t, c]
//             G[row(b, t), c]     = E(g * h * a * (1 - a))
//             G[row(b, t), R + c] = E(g * a * (1 - h * h))
//             G's P straddle rows after every crop = 0 (G has B*(T+P)
//             rows)
//             z recomputed, bit for bit the forward's
//             gcond[b, f, :] = the float32 sum over the frame's hop rows
//                              of the unrounded G values (fixed order)
//
// What bounds it on the card (nsynth-h512: B=48, T=6144, R=512, bf16):
// the forward reads u (2 x 302 MB) and writes z (302 MB), 0.27 ms at
// 3.35 TB/s; the backward reads gz and u and writes G and z (1.8 GB),
// 0.54 ms.  ~20 float operations an element: bytes bind.
//
// Design: one block of 256 threads for each (crop, frame, slice of CS =
// 64 channels); a thread owns one 16-byte vector of channels c (and the
// paired c + R) and walks the frame's rows with its row lane, so every
// load and store is 16 bytes, neighbouring threads on neighbouring
// addresses.  The frame's condition for the thread's channels is loaded
// once, into registers.  The backward keeps each thread's frame sums in
// registers, then the block adds its row lanes in a fixed order through
// shared memory (no atomics: two calls give the same bits), and also
// zeroes its share of the straddle rows after its crop, so G is whole
// for the conv's input-gradient products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;   // threads a block
constexpr int CS = 64;    // channels of each gate half a block

struct GateShape {
  int B, T, P, hop, F, R;
};

// ---- 16-byte vectors as float32 ----

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);   // nearest even
  *reinterpret_cast<uint4*>(p) = q;
}

// ---- the gate: one definition for both kernels, so the backward's z
// has the forward's bits ----

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// 1 - 2 / (1 + e^(2x)): exact limits, no overflow (e^(2x) = inf gives 1)
__device__ __forceinline__ float tanh_f(float x) {
  return __fmaf_rn(-2.f, __fdividef(1.f, 1.f + __expf(2.f * x)), 1.f);
}

// the block's (crop, frame, slice) and the thread's channel and row lane
template <int V>
struct Place {
  static constexpr int NV = CS / V;   // vectors a row's slice
  static constexpr int RL = NT / NV;  // rows walked side by side
  int b, f, c, rl, vi;
  __device__ Place(const GateShape& s) {
    const int nslice = (s.R + CS - 1) / CS;
    int blk = blockIdx.x;
    const int sl = blk % nslice;
    blk /= nslice;
    f = blk % s.F;
    b = blk / s.F;
    vi = threadIdx.x % NV;
    rl = threadIdx.x / NV;
    c = sl * CS + vi * V;
  }
};

template <typename E>
__global__ void __launch_bounds__(NT)
    ae_gate_fwd(GateShape s, const E* __restrict__ u,
                const E* __restrict__ cond, E* __restrict__ z) {
  constexpr int V = 16 / sizeof(E);
  const Place<V> p(s);
  if (p.c >= s.R) return;
  const size_t R2 = 2 * (size_t)s.R;
  float ca[V], cb[V];
  const E* cr = cond + ((size_t)p.b * s.F + p.f) * R2 + p.c;
  load_vec(cr, ca);
  load_vec(cr + s.R, cb);
  const size_t urow = (size_t)p.b * (s.T + s.P) + (size_t)p.f * s.hop;
  const size_t zrow = (size_t)p.b * s.T + (size_t)p.f * s.hop;
#pragma unroll 4
  for (int r = p.rl; r < s.hop; r += Place<V>::RL) {
    const E* up = u + (urow + r) * R2 + p.c;
    float va[V], vb[V], out[V];
    load_vec(up, va);
    load_vec(up + s.R, vb);
#pragma unroll
    for (int k = 0; k < V; ++k)
      out[k] = sigmoid_f(va[k] + ca[k]) * tanh_f(vb[k] + cb[k]);
    store_vec(z + (zrow + r) * s.R + p.c, out);
  }
}

template <typename E>
__global__ void __launch_bounds__(NT)
    ae_gate_bwd(GateShape s, const E* __restrict__ gz,
                const E* __restrict__ u, const E* __restrict__ cond,
                E* __restrict__ G, E* __restrict__ z,
                float* __restrict__ gcond) {
  constexpr int V = 16 / sizeof(E);
  constexpr int NV = Place<V>::NV, RL = Place<V>::RL;
  __shared__ float part[2 * V][NT];   // row lanes' frame sums
  const Place<V> p(s);
  const bool live = p.c < s.R;
  const size_t R2 = 2 * (size_t)s.R;
  float sa[V], sb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sa[k] = sb[k] = 0.f;
  if (live) {
    float ca[V], cb[V];
    const E* cr = cond + ((size_t)p.b * s.F + p.f) * R2 + p.c;
    load_vec(cr, ca);
    load_vec(cr + s.R, cb);
    const size_t urow = (size_t)p.b * (s.T + s.P) + (size_t)p.f * s.hop;
    const size_t zrow = (size_t)p.b * s.T + (size_t)p.f * s.hop;
#pragma unroll 2
    for (int r = p.rl; r < s.hop; r += RL) {
      const E* up = u + (urow + r) * R2 + p.c;
      float va[V], vb[V], g[V], ga[V], gb[V], zz[V];
      load_vec(up, va);
      load_vec(up + s.R, vb);
      load_vec(gz + (zrow + r) * s.R + p.c, g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float a = sigmoid_f(va[k] + ca[k]);
        const float h = tanh_f(vb[k] + cb[k]);
        zz[k] = a * h;
        ga[k] = g[k] * h * (a * (1.f - a));
        gb[k] = g[k] * a * (1.f - h * h);
        sa[k] += ga[k];
        sb[k] += gb[k];
      }
      E* gp = G + (urow + r) * R2 + p.c;
      store_vec(gp, ga);
      store_vec(gp + s.R, gb);
      store_vec(z + (zrow + r) * s.R + p.c, zz);
    }
    // this block's share of the straddle rows after crop b
    if (s.P > 0) {
      const int share = (s.P + s.F - 1) / s.F;
      const int lo = p.f * share, hi = min(s.P, lo + share);
      float zero[V];
#pragma unroll
      for (int k = 0; k < V; ++k) zero[k] = 0.f;
      const size_t srow = (size_t)p.b * (s.T + s.P) + s.T;
      for (int r = lo + p.rl; r < hi; r += RL) {
        E* gp = G + (srow + r) * R2 + p.c;
        store_vec(gp, zero);
        store_vec(gp + s.R, zero);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    part[k][threadIdx.x] = sa[k];
    part[V + k][threadIdx.x] = sb[k];
  }
  __syncthreads();
  // thread j < 2*CS sums one channel over the row lanes, in lane order
  const int j = threadIdx.x;
  if (j < 2 * NV * V) {
    const int half = j / (NV * V), w = j % (NV * V);
    const int vi = w / V, k = w % V;
    const int c = (blockIdx.x % ((s.R + CS - 1) / CS)) * CS + vi * V + k;
    if (c < s.R) {
      float acc = 0.f;
      for (int l = 0; l < RL; ++l) acc += part[half * V + k][l * NV + vi];
      gcond[((size_t)p.b * s.F + p.f) * R2 + (size_t)half * s.R + c] = acc;
    }
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool shape_ok(const GateShape& s, int es) {
  const int V = 16 / es;
  return s.B >= 1 && s.T >= 1 && s.P >= 0 && s.hop >= 1 && s.R >= 1 &&
         s.T % s.hop == 0 && s.R % V == 0;
}

GateShape shape(int B, int T, int P, int hop, int R) {
  return GateShape{B, T, P, hop, hop > 0 ? T / hop : 0, R};
}

unsigned blocks(const GateShape& s) {
  return (unsigned)s.B * s.F * ((s.R + CS - 1) / CS);
}

}  // namespace

extern "C" {

// z [B*T, R] from u (rows b*(T+P) + t, [B*(T+P) - P, 2R]) and cond
// [B, T/hop, 2R], all of one type (0 float32, 1 bf16), contiguous and
// 16-byte aligned.  Returns 0, a CUDA error, or -2 for what it does not
// take (T not a multiple of hop, R not a multiple of a 16-byte vector,
// an unaligned pointer).
int vqvae_ae_gate_fwd(int dtype, int B, int T, int P, int hop, int R,
                      const void* u, const void* cond, void* z,
                      void* stream) {
  const GateShape s = shape(B, T, P, hop, R);
  const int es = dtype == 1 ? 2 : 4;
  if (!shape_ok(s, es) || !aligned(u) || !aligned(cond) ||
      !aligned(z))
    return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    ae_gate_fwd<bf16><<<blocks(s), NT, 0, st>>>(
        s, (const bf16*)u, (const bf16*)cond, (bf16*)z);
  else
    ae_gate_fwd<float><<<blocks(s), NT, 0, st>>>(
        s, (const float*)u, (const float*)cond, (float*)z);
  return (int)cudaGetLastError();
}

// G (u's rows and the P after the last crop, [B*(T+P), 2R]), z [B*T, R]
// and the float32 gcond
// [B, T/hop, 2R] from gz [B*T, R], u and cond: as vqvae_ae_gate_fwd.
int vqvae_ae_gate_bwd(int dtype, int B, int T, int P, int hop, int R,
                      const void* gz, const void* u, const void* cond,
                      void* G, void* z, float* gcond, void* stream) {
  const GateShape s = shape(B, T, P, hop, R);
  const int es = dtype == 1 ? 2 : 4;
  if (!shape_ok(s, es) || !aligned(gz) || !aligned(u) ||
      !aligned(cond) || !aligned(G) || !aligned(z))
    return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    ae_gate_bwd<bf16><<<blocks(s), NT, 0, st>>>(
        s, (const bf16*)gz, (const bf16*)u, (const bf16*)cond, (bf16*)G,
        (bf16*)z, gcond);
  else
    ae_gate_bwd<float><<<blocks(s), NT, 0, st>>>(
        s, (const float*)gz, (const float*)u, (const float*)cond, (float*)G,
        (float*)z, gcond);
  return (int)cudaGetLastError();
}

}  // extern "C"
