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
// single core): one warpgroup of four compute warps and a producer warp.
// - x never leaves the registers.  Compute warp w owns rows 16w..16w+15
//   and all 128 columns.  The products are wgmma (m64nNk16 bf16 into
//   float32, m64nNk32 int8 into int32) with A, x, from registers: a
//   warp's accumulator fragments of layer l are exactly the rows of its
//   A fragments for layer l+1, so no barrier ever orders x and x never
//   passes through shared memory.  bf16: the float32 accumulators of
//   n-tiles 2j and 2j+1, rounded and packed in pairs, are the A fragment
//   of k-block j (same thread, rows, columns).  int8: a thread's
//   accumulator columns 8j + 2t, +1 do not line up with its A positions
//   4t..4t+3, 16+4t..; the host packs each layer's rows in the k-order
//   (kperm) that makes a thread's values of n-tiles 4kb..4kb+3 its A
//   registers of k-block kb.  Integer sums are exact in any order (|acc|
//   <= 128 * 127 * 128 < 2^22), so the chain stays bit-equal.  A layer is
//   two wgmma chains of 64 columns: the first half's epilogue (round,
//   scale, quantise, in registers on the FP32 and integer pipes, not the
//   conversion unit: see i2f, quant8) runs while the second half's
//   products are in the tensor cores.
// - The weights stream.  All L layers do not fit in shared memory (32 KB
//   a bf16 layer, 16 KB int8, against 227 KB); they do not depend on x,
//   so the producer warp runs ahead: one cp.async.bulk (TMA 1-D) copy a
//   layer into a ring of as many stages as shared memory holds (7 bf16,
//   14 int8), "full" mbarriers counting the bytes in, "empty" ones
//   counting the four compute warps out.  The layer loop has no
//   __syncthreads.  The wrapper packs the layers once per call in
//   wgmma's K-major layout without swizzle (core matrices of 8 n-rows x
//   16 bytes of k, 128 contiguous bytes each), so a stage is one
//   contiguous copy and the tensor cores read each weight once a layer.
//
// What bounds it: at L=30, STEPS=128 the chain is 8.05 GFLOP (8.1 us at
// the bf16 tensor-core rate, 4.1 us at the int8 rate) over 0.98 MB of
// bf16 weights, but its 3840 products depend on each other one after the
// other.  A layer's products take ~0.28 us at the bf16 rate on one SM,
// half that in int8; the int8 epilogue (~10 FP32/integer instructions a
// value, 64 values a thread, issued after the products it waits for)
// takes longer than its products, so there int8 is the slower chain.
#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int CB = 64;       // rows of x
constexpr int CW = 128;      // width (2R)
constexpr int NCW = CB / 16; // compute warps (one warpgroup), 16 rows each
constexpr int NTHREADS = 32 * (NCW + 1);   // and the producer warp
constexpr int HN = CW / 2;   // columns of one wgmma chain (a half layer)
constexpr size_t SMEM_CAP = 227 * 1024;

template <bool INT8>
struct Ring {
  // A packed layer: k-blocks of 32 bytes of k (16 bf16, 32 int8), each
  // [CW / 8 n-blocks][2 halves of 16 bytes of k][8 n][16 bytes]: the
  // core matrices of wgmma's K-major layout without swizzle, LBO bytes
  // apart along k and SBO bytes apart along n.
  static constexpr int KB = INT8 ? CW / 32 : CW / 16;   // k-blocks
  static constexpr int KBBYTES = CW * 32;
  static constexpr int WBYTES = KB * KBBYTES;           // CW * CW * esize
  static constexpr int LBO = 128, SBO = 256;
  static constexpr int STAGES = (int)((SMEM_CAP - 256) / WBYTES);
  static constexpr size_t SMEM =
      (size_t)STAGES * WBYTES + 2 * STAGES * sizeof(uint64_t);
  static_assert(STAGES >= 4, "the ring holds at least 4 layers");
};

// ---- mbarrier, bulk-copy and wgmma primitives (PTX) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the inits are visible to the async proxy (the bulk copies) before use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// the producer's arrival on a phase that expects `bytes` more
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}"
      ::"r"(smem_addr(bar)), "r"(bytes)
      : "memory");
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

// bytes from global src to shared dst by the TMA unit, counted on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A register the compiler must treat as read and written here: orders
// the reads of an asynchronous wgmma's accumulators after its wait, and
// keeps its A registers from being reused while it may still read them.
__device__ __forceinline__ void hold(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void hold(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void hold(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d[64 x 64] (+)= a[64 x 16] b[16 x 64], bf16 into float32, a from
// registers, b by descriptor (K-major).  Lane l of warp w, g = l / 4,
// t = l % 4: a[0] = A[16w + g][2t..], a[1] = A[16w + g + 8][2t..],
// a[2] = A[16w + g][8 + 2t..], a[3] = A[16w + g + 8][8 + 2t..];
// d[4j + q] = D[16w + g + 8 (q / 2)][8j + 2t + q % 2].
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// the same for int8 into int32, k 32: a[0] = A[16w + g][4t..4t+3],
// a[1] = A[16w + g + 8][4t..], a[2] = A[16w + g][16 + 4t..], a[3] =
// A[16w + g + 8][16 + 4t..]; d as above.
__device__ __forceinline__ void wgmma_s8(int (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// ---- end of the PTX primitives ----

// the shared-memory matrix descriptor of K-major B without swizzle at
// shared address addr (16-byte aligned): start, LBO and SBO in 16-byte
// units, layout type 0
template <bool INT8>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  using R = Ring<INT8>;
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)(R::LBO >> 4) << 16) | ((uint64_t)(R::SBO >> 4) << 32);
}

// float(acc) for |acc| < 2^22 without the conversion unit: acc added to
// the mantissa of 1.5 * 2^23 (whose units bit is the mantissa's lowest)
__device__ __forceinline__ float i2f(int acc) {
  return __int_as_float(acc + 0x4B400000) - 12582912.0f;
}

// int8(trunc(clip(x * 127, -127, 127))) in the low byte: |v| clipped to
// 127 and truncated by a round-toward-zero add of 1.5 * 2^23, then the
// sign applied in two's complement
__device__ __forceinline__ int quant8(float x) {
  const float v = x * 127.0f;
  const int k = __float_as_int(__fadd_rz(fminf(fabsf(v), 127.0f),
                                         12582912.0f));
  const int s = __float_as_int(v) >> 31;
  return (k ^ s) - s;
}

// the same on the conversion unit (F2I): the epilogue issues one value in
// four this way, which runs beside quant8's issue slots; all of them that
// way would queue on the unit (an eighth of the FP32 rate)
__device__ __forceinline__ int quant8_cvt(float x) {
  return __float2int_rz(fminf(fmaxf(x * 127.0f, -127.0f), 127.0f));
}

// the low bytes of b0..b3 as one register, b0 lowest
__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// bf16(lo), bf16(hi) packed, lo in the low half (one F2FP)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the same, each then scaled by 0.125 and rounded again (a step's end)
__device__ __forceinline__ uint32_t pack2_end(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return pack2(__low2float(v) * 0.125f, __high2float(v) * 0.125f);
}

// The producer warp's lane 0: layer i of the chain (weights i % L) into
// stage i % STAGES once the compute warps have released it.
template <bool INT8>
__device__ void produce(int L, int total, const char* wp, char* ring,
                        uint64_t* full, uint64_t* empty) {
  using R = Ring<INT8>;
  int s = 0, l = 0;
  unsigned ph = 0;
  for (int i = 0; i < total; ++i) {
    mbar_wait(empty + s, ph ^ 1);   // a fresh barrier passes parity 1
    mbar_arm(full + s, R::WBYTES);
    bulk_g2s(ring + s * R::WBYTES, wp + (size_t)l * R::WBYTES, R::WBYTES,
             full + s);
    if (++l == L) l = 0;
    if (++s == R::STAGES) s = 0, ph ^= 1;
  }
}

// The products of one half layer (columns n0 .. n0 + 63) into d, from x's
// A fragments a and the layer at shared address base; the first k-block
// overwrites d.
template <bool INT8, typename Acc>
__device__ __forceinline__ void issue(Acc (&d)[32],
                                      const uint32_t (&a)[Ring<INT8>::KB][4],
                                      uint32_t base, int n0) {
  using R = Ring<INT8>;
#pragma unroll
  for (int kb = 0; kb < R::KB; ++kb) {
    const uint64_t desc =
        b_desc<INT8>(base + kb * R::KBBYTES + (n0 / 8) * R::SBO);
    if constexpr (INT8)
      wgmma_s8(d, a[kb], desc, kb);
    else
      wgmma_bf16(d, a[kb], desc, kb);
  }
}

// bf16 epilogue of half h of a layer: its n-tiles 2p, 2p + 1 become
// k-block 4h + p of x (rounded, and scaled by 0.125 at a step's END; the
// caller branches on END once a layer, so the other layers carry none of
// the rescaling)
template <bool END>
__device__ __forceinline__ void epi_bf16(uint32_t (&nx)[8][4],
                                         const float (&d)[32], int h) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      nx[4 * h + p][q] = END ? pack2_end(d[8 * p + 2 * q], d[8 * p + 2 * q + 1])
                             : pack2(d[8 * p + 2 * q], d[8 * p + 2 * q + 1]);
}

// int8 A fragment f of one k-block from the values v[4 w + q] of its four
// n-tiles w < 4 in accumulator layout (D[g + 8 (q / 2)][8 j + 2t + q % 2]):
// register 2 (w / 2) + q / 2 holds byte 2 (w % 2) + q % 2.  The host's
// kperm puts weight row 8 j + 2t + q % 2 at that A position.
__device__ __forceinline__ void quant_block(uint32_t (&f)[4],
                                            const float* v) {
  int b[16];
#pragma unroll
  for (int e = 0; e < 16; ++e)
    b[e] = (e & 3) == 3 ? quant8_cvt(v[e]) : quant8(v[e]);
  f[0] = pack4(b[0], b[1], b[4], b[5]);
  f[1] = pack4(b[2], b[3], b[6], b[7]);
  f[2] = pack4(b[8], b[9], b[12], b[13]);
  f[3] = pack4(b[10], b[11], b[14], b[15]);
}

// int8 epilogue of half h of a layer: x = f32(acc) * scale, then * 2^-7
// (two roundings, in that order), quantised into k-blocks 2h, 2h + 1 of
// the next layer's A; after the last layer, stored as bf16
__device__ __forceinline__ void epi_int8(uint32_t (&nx)[4][4],
                                         const int (&d)[32], int h, float sc,
                                         bool last, bf16* out, int r0) {
  float v[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) v[e] = (i2f(d[e]) * sc) * 0.0078125f;
  if (last) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    uint32_t* ow = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = HN * h + 8 * j + 2 * t;
      ow[((r0 + g) * CW + c) / 2] = pack2(v[4 * j], v[4 * j + 1]);
      ow[((r0 + g + 8) * CW + c) / 2] = pack2(v[4 * j + 2], v[4 * j + 3]);
    }
  } else {
    quant_block(nx[2 * h], v);
    quant_block(nx[2 * h + 1], v + 16);
  }
}

// A compute warp: rows r0 .. r0 + 15 of x as A fragments a.  bf16: a[kb]
// (16 of k) holds rows r0 + g, r0 + g + 8 at columns 16 kb + 2t (+1) and
// 16 kb + 8 + 2t (+1); int8: a[kb] (32 of k) holds kperm's positions.
// A layer issues its two halves (two commit groups); the first half's
// epilogue runs while the second's products are in the tensor cores.
template <bool INT8>
__device__ void compute(int L, int total, const bf16* x0, const float* scale,
                        char* ring, uint64_t* full, uint64_t* empty,
                        bf16* out) {
  using R = Ring<INT8>;
  using Acc = typename std::conditional<INT8, int, float>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  uint32_t a[R::KB][4], nx[R::KB][4];
#pragma unroll
  for (int kb = 0; kb < R::KB; ++kb) {
    if constexpr (INT8) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int w = e >> 2, q = e & 3;
        v[e] = __bfloat162float(x0[(r0 + g + 8 * (q >> 1)) * CW +
                                   8 * (4 * kb + w) + 2 * t + (q & 1)]);
      }
      quant_block(a[kb], v);
    } else {
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(x0);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[kb][q] = xw[((r0 + g + 8 * (q & 1)) * CW + 16 * kb + 8 * (q >> 1) +
                       2 * t) / 2];
    }
  }
  Acc d0[32], d1[32];   // the two halves' accumulators
#pragma unroll
  for (int e = 0; e < 32; ++e) d0[e] = d1[e] = 0;
  const uint32_t ring_addr = smem_addr(ring);
  int s = 0, l = 0;
  unsigned ph = 0;
  for (int i = 0; i < total; ++i) {
    const bool last = i == total - 1, end = l == L - 1;
    float sc = 0.f;
    if constexpr (INT8) sc = __ldg(scale + l);
    mbar_wait(full + s, ph);
    __syncwarp();
    const uint32_t base = ring_addr + s * R::WBYTES;
    wg_fence();
    issue<INT8>(d0, a, base, 0);
    wg_commit();
    issue<INT8>(d1, a, base, HN);
    wg_commit();
    wg_wait<1>();
#pragma unroll
    for (int e = 0; e < 32; ++e) hold(d0[e]);
    if constexpr (INT8)
      epi_int8(nx, d0, 0, sc, last, out, r0);
    else if (end)
      epi_bf16<true>(nx, d0, 0);
    else
      epi_bf16<false>(nx, d0, 0);
    wg_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) hold(d1[e]);
#pragma unroll
    for (int kb = 0; kb < R::KB; ++kb)
#pragma unroll
      for (int q = 0; q < 4; ++q) hold(a[kb][q]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);   // this warp is done with s
    if constexpr (INT8)
      epi_int8(nx, d1, 1, sc, last, out, r0);
    else if (end)
      epi_bf16<true>(nx, d1, 1);
    else
      epi_bf16<false>(nx, d1, 1);
#pragma unroll
    for (int kb = 0; kb < R::KB; ++kb)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[kb][q] = nx[kb][q];
    if (++l == L) l = 0;
    if (++s == R::STAGES) s = 0, ph ^= 1;
  }
  if constexpr (!INT8) {   // the int8 chain stored its last layer already
    uint32_t* ow = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int kb = 0; kb < R::KB; ++kb)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ow[((r0 + g + 8 * (q & 1)) * CW + 16 * kb + 8 * (q >> 1) + 2 * t) /
           2] = a[kb][q];
  }
}

template <bool INT8>
__global__ void __launch_bounds__(NTHREADS, 1)
    chain(int L, int total, const bf16* __restrict__ x0,
          const char* __restrict__ wp, const float* __restrict__ scale,
          bf16* __restrict__ out) {
  using R = Ring<INT8>;
  char* ring = reinterpret_cast<char*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::WBYTES);
  uint64_t* empty = full + R::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();   // the block's one barrier: the mbarriers are set
  if (threadIdx.x >= 32 * NCW) {
    if (threadIdx.x == 32 * NCW)
      produce<INT8>(L, total, wp, ring, full, empty);
    return;
  }
  compute<INT8>(L, total, x0, scale, ring, full, empty, out);
}

template <bool INT8>
int launch(int L, int total, const void* x0, const void* wp,
           const float* scale, void* out, cudaStream_t st) {
  using R = Ring<INT8>;
  auto k = chain<INT8>;
  static bool opted = false;   // once, so that a graph capture may launch
  if (!opted) {
    VQT_TRY(smem_opt_in(k, R::SMEM));
    opted = true;
  }
  KLAUNCH(k, 1, NTHREADS, R::SMEM, st, L, total, (const bf16*)x0,
          (const char*)wp, scale, (bf16*)out);
  return (int)last_error();
}

}  // namespace

extern "C" {

// out [64, 128] bf16 after `steps` steps of L layers from x0 [64, 128]
// bf16.  wp: the layers as the wrapper's pack_weights lays them out
// ([L, 128 * 128] bf16, or int8 in kperm's k-order, in core matrices);
// scale [L] float32 (int8 only).  Returns 0, a CUDA error, or -2.
int vqvae_decode_chain(int int8, int L, int steps, const void* x0,
                       const void* wp, const float* scale, void* out,
                       void* stream) {
  if (L < 1 || steps < 1 || (long long)L * steps > 0x7fffffff) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  return int8 ? launch<true>(L, L * steps, x0, wp, scale, out, st)
              : launch<false>(L, L * steps, x0, wp, scale, out, st);
}

// the bytes of one packed layer
int vqvae_decode_chain_layer_bytes(int int8) {
  return int8 ? Ring<true>::WBYTES : Ring<false>::WBYTES;
}

}  // extern "C"
