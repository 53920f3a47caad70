// A chain of dependent matrix products at the decode kernel's widths, in
// bf16 and in int8: the measurement of whether int8 weights would halve
// the bytes of the decode kernel's latency-bound layer chain without
// slowing it.
//
// Replaces the TPU kernels of scripts/decode_int8_micro.py: body_bf16
// (call :44) and body_int8 (call :48).  The plain PyTorch versions are
// vqvae_tpu_torch/kernels/decode_chain_cuda.py.
//
// Math, x [64, 128], w [L, 128, 128], STEPS steps of L layers each:
//   bf16:  per layer x = bf16(f32(x @ w[l])); per step end x = bf16(x*0.125)
//   int8:  x = f32(x0); per layer xi = int8(trunc(clip(x*127, -127, 127))),
//          acc = xi @ w8[l] (int32), x = f32(acc) * scale[l] * 0.0078125
//          (the two products in that order); out = bf16(x)
// The int8 chain is exact integer arithmetic and two float32 roundings
// per element in a fixed order, so it equals its plain version bit for
// bit; the bf16 chain's float32 sums run in the tensor cores' order.
//
// Design.  The chain is serial, so it runs in one block (as on the TPU's
// single core).  x lives in shared memory for the whole call.  The
// weights (L x 32 KB in bf16, L x 16 KB in int8: more than the 227 KB of
// shared memory at L=30) stream from device memory / L2 one layer at a
// time into two shared-memory buffers with cp.async: layer l+2's copy is
// started as soon as layer l's products are done, so one copy is always in
// flight behind the products.  The products are wmma fragments: bf16
// m16n16k16 into float32, signed char m16n16k16 into int32; each of the 8
// warps owns a 16 x 64 strip of the 64 x 128 result.
//
// What bounds it: at L=30, STEPS=128 the chain is 8.05 GFLOP (8.1 us at
// the bf16 tensor-core rate, 4.1 us at the int8 rate) over 0.98 MB of
// bf16 weights, but its 3840 products depend on each other one after the
// other, so the dependency (each product's latency, the block barriers
// between layers) bounds it, not the rate or the bytes.
#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int CB = 64;     // rows of x
constexpr int CW = 128;    // width (2R)
constexpr int LDX = CW + 8;     // bf16 x / weight rows (elements)
constexpr int LDC = CW + 4;     // float32 / int32 result rows
constexpr int KB = 16;          // int8 tiles: 16-column blocks of 16 bytes

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start the copy of layer `layer`'s weights into buf (always commits a
// group, empty past the chain's end, so the group count stays in step).
//   bf16: buf [CW][LDX] row-major;
//   int8: buf [CW/KB][CW][KB], column block b holding w[:, 16b..16b+16),
//         so every fragment pointer is 32-byte aligned.
template <bool INT8>
__device__ __forceinline__ void fetch(void* buf, const void* w, int layer,
                                      int total, int L) {
  if (layer < total) {
    const int l = layer % L;
    if constexpr (INT8) {
      const signed char* src = (const signed char*)w + (size_t)l * CW * CW;
      signed char* dst = (signed char*)buf;
      for (int c = threadIdx.x; c < CW * CW / 16; c += NT) {
        const int k = c / (CW / 16), b = c % (CW / 16);
        cp_async16(dst + ((size_t)b * CW + k) * KB, src + k * CW + b * 16);
      }
    } else {
      const bf16* src = (const bf16*)w + (size_t)l * CW * CW;
      bf16* dst = (bf16*)buf;
      for (int c = threadIdx.x; c < CW * CW / 8; c += NT) {
        const int k = c / (CW / 8), j = c % (CW / 8);
        cp_async16(dst + k * LDX + j * 8, src + k * CW + j * 8);
      }
    }
  }
  cp_commit();
}

__device__ __forceinline__ signed char quant(float x) {
  // clip(x*127, -127, 127) then truncation toward zero, as astype(int8)
  const float v = fminf(fmaxf(x * 127.0f, -127.0f), 127.0f);
  return (signed char)(int)v;
}

template <bool INT8>
__global__ void chain(int L, int steps, const bf16* __restrict__ x0,
                      const void* __restrict__ w,
                      const float* __restrict__ scale,
                      bf16* __restrict__ out) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp >> 1, wc = (warp & 1) * 4;   // 16 rows x 64 columns
  constexpr int WBYTES = INT8 ? CW * CW : CW * LDX * 2;
  constexpr int XBYTES = INT8 ? CB * CW : CB * LDX * 2;
  char* base = reinterpret_cast<char*>(smem);
  char* wbuf[2] = {base, base + WBYTES};
  char* xbuf = base + 2 * WBYTES;                       // x (bf16) or xi
  float* cs = reinterpret_cast<float*>(xbuf + XBYTES);  // [CB][LDC]
  int* ci = reinterpret_cast<int*>(cs);
  const int total = L * steps;
  fetch<INT8>(wbuf[0], w, 0, total, L);
  fetch<INT8>(wbuf[1], w, 1, total, L);
  for (int i = tid; i < CB * CW; i += NT) {
    const int r = i / CW, c = i % CW;
    if constexpr (INT8) {
      xbuf[((c / KB) * CB + r) * KB + c % KB] =
          quant(__bfloat162float(x0[i]));
      cs[r * LDC + c] = __bfloat162float(x0[i]);
    } else {
      reinterpret_cast<bf16*>(xbuf)[r * LDX + c] = x0[i];
    }
  }
  for (int layer = 0; layer < total; ++layer) {
    const int l = layer % L;
    cp_wait_one();
    __syncthreads();   // layer's weights and the last layer's x visible
    const char* wb = wbuf[layer & 1];
    if constexpr (INT8) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0);
      const signed char* xs = (const signed char*)xbuf;
      const signed char* ws = (const signed char*)wb;
#pragma unroll
      for (int kb = 0; kb < CW / KB; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, xs + ((size_t)kb * CB + wr * 16) * KB, KB);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fb, ws + ((size_t)(wc + f) * CW + kb * KB) * KB,
                                 KB);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      __syncthreads();   // every warp has read xi and this buffer
      fetch<INT8>(wbuf[layer & 1], w, layer + 2, total, L);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        wmma::store_matrix_sync(ci + wr * 16 * LDC + (wc + f) * 16, acc[f],
                                LDC, wmma::mem_row_major);
      __syncthreads();
      const float sc = scale[l];
      signed char* xq = (signed char*)xbuf;
      for (int i = tid; i < CB * CW; i += NT) {
        const int r = i / CW, c = i % CW;
        float x = (float)ci[r * LDC + c] * sc;
        x = x * 0.0078125f;
        cs[r * LDC + c] = x;     // the same word: this thread's own
        xq[((c / KB) * CB + r) * KB + c % KB] = quant(x);
      }
    } else {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);
      const bf16* xs = (const bf16*)xbuf;
      const bf16* ws = (const bf16*)wb;
#pragma unroll
      for (int k = 0; k < CW; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, xs + wr * 16 * LDX + k, LDX);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, ws + k * LDX + (wc + f) * 16, LDX);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      __syncthreads();   // every warp has read x and this buffer
      fetch<INT8>(wbuf[layer & 1], w, layer + 2, total, L);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        wmma::store_matrix_sync(cs + wr * 16 * LDC + (wc + f) * 16, acc[f],
                                LDC, wmma::mem_row_major);
      __syncthreads();
      const bool step_end = l == L - 1;
      bf16* xb = (bf16*)xbuf;
      for (int i = tid; i < CB * CW; i += NT) {
        const int r = i / CW, c = i % CW;
        bf16 v = __float2bfloat16(cs[r * LDC + c]);
        if (step_end) v = __float2bfloat16(__bfloat162float(v) * 0.125f);
        xb[r * LDX + c] = v;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < CB * CW; i += NT) {
    const int r = i / CW, c = i % CW;
    if constexpr (INT8)
      out[i] = __float2bfloat16(cs[r * LDC + c]);
    else
      out[i] = reinterpret_cast<const bf16*>(xbuf)[r * LDX + c];
  }
}

template <bool INT8>
constexpr size_t chain_smem() {
  return INT8 ? 2 * CW * CW + CB * CW + CB * LDC * 4
              : 2 * CW * LDX * 2 + CB * LDX * 2 + CB * LDC * 4;
}

}  // namespace

extern "C" {

// out [64, 128] bf16 after `steps` steps of L layers from x0 [64, 128]
// bf16.  int8 = 0: w [L, 128, 128] bf16, scale unused; int8 = 1: w int8
// and scale [L] float32.  Width and rows are fixed (rows, width must be
// 64, 128).  Returns 0, a CUDA error, or -2.
int vqvae_decode_chain(int int8, int rows, int width, int L, int steps,
                       const void* x0, const void* w, const float* scale,
                       void* out, void* stream) {
  if (rows != CB || width != CW || L < 1 || steps < 1) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (int8) {
    auto k = chain<true>;
    VQT_TRY(smem_opt_in(k, chain_smem<true>()));
    KLAUNCH(k, 1, NT, chain_smem<true>(), st, L, steps, (const bf16*)x0, w,
            scale, (bf16*)out);
  } else {
    auto k = chain<false>;
    VQT_TRY(smem_opt_in(k, chain_smem<false>()));
    KLAUNCH(k, 1, NT, chain_smem<false>(), st, L, steps, (const bf16*)x0, w,
            scale, (bf16*)out);
  }
  return (int)last_error();
}

}  // extern "C"
