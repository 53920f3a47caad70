// The backward of the decoder-input embedding's row gathers: for a table
// w [V, C] gathered as w[ids], dw[v, :] = the sum of g[m, :] over the rows
// m whose id is v, summed in float32 and rounded once to w's dtype.
//
// Replaces no TPU kernel: it is the backward of vqvae_tpu/ops/embed.py's
// take_rows (_bwd, :32), which the JAX package leaves to XLA as a one-hot
// contraction.  PyTorch's own backward of w[ids] is a scatter
// (indexing_backward_kernel, a library kernel that sorts the ids); this
// kernel takes its place in models/wavenet.py::embed_inputs.  The plain
// PyTorch version is vqvae_tpu_torch/kernels/embed_cuda.py
// (take_rows_bwd_plain, JAX's own formula).
//
// What bounds it on the card (vctk-multi: B=16, T=7680, V=256, C=64,
// bf16 g, int32 ids): it reads g (15.7 MB) and the ids (0.5 MB) once and
// writes 32 KB, against 7.9 M float32 adds: bytes bind (4.9 us at 3.35
// TB/s).  Two calls a training step (the two taps of the input conv).
//
// Design: a fixed-order per-id sum with no atomics, so two calls give the
// same bits.  A block owns a part of contiguous rows (one part an SM) and
// streams them through a ring of EB_NS chunk stages: a chunk's g rows and
// ids are contiguous in device memory, so thread 0 fetches each with one
// TMA bulk copy (cp.async.bulk) counted on the stage's mbarrier, up to
// EB_NS chunks ahead.  The block keeps one float32 table [V, C] in shared
// memory, and each entry has one owner: warp w owns the ids v with
// v % Q == w % Q and the column groups w / Q, w / Q + NW / Q, ... (NW =
// 16 warps; Q the largest power of 2 with Q groups <= NW), lane l of
// group g the two columns 2 (32 g + l) + {0, 1} (one where C is odd),
// read as one word.  Each chunk is first sorted by id class, in row order
// within a class (eb_bin: a rank from __match_any_sync a 32-row window, a
// scan of the windows' counts), so that a warp reads only its own rows;
// then each warp adds its rows EB_BATCH at a time: the batch's values and
// table entries are loaded together, a batch of distinct ids adds each
// row to its entry, and otherwise a later row of the same id adds to the
// earlier row's sum in registers, so a batch costs one shared-memory
// round trip and keeps row order.  The block then writes its table as
// its part's float32 partial, and a second launch adds the parts in a
// fixed order (four lanes an entry, each a quarter of the parts in order,
// the quarters in order) and rounds once.  An id outside [0, V) adds
// nothing.  What holds it on the card is instruction issue in the
// per-row loop, not bytes: hence one sort a chunk for the whole block,
// two columns a lane and sixteen warps sharing one table.
#include "train_common.cuh"

using namespace vqt;

namespace {

constexpr int EB_NW = 16;      // warps a block
constexpr int EB_NS = 4;       // chunk stages in the ring
constexpr int EB_BATCH = 4;    // owned rows a warp adds together
constexpr int EB_RCMAX = 256;  // rows a chunk at most
constexpr int EB_SMEM = 232448;

// ---- mbarrier and bulk-copy primitives (PTX) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the inits are visible to the async proxy before use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of a phase (release: the arriving thread's earlier
// shared-memory writes are seen by the waiters), which expects `bytes`
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

// the block's earlier generic shared-memory accesses before later bulk
// copies into the same bytes
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
// ---- end of the mbarrier and bulk-copy primitives ----

// The shape of a call; sizes in elements unless they say bytes
struct EbShape {
  int M, V, C;
  int tsz;      // floats of the table: V*C rounded up to 4
  int rc;       // rows a chunk (a multiple of 32)
  int gbytes;   // bytes of a chunk's g rows (rc x C x es, rounded to 16)
  int ibytes;   // bytes of a chunk's ids (rc x is, rounded to 16)
  int rpp;      // rows a part (a multiple of 16)
  int CG, Q;    // column groups of 32 lanes; id classes (a power of 2)
  __host__ __device__ size_t stage_bytes() const {
    return (size_t)gbytes + ibytes;
  }
  // the table, the ring, its EB_NS mbarriers, the sorted list and its
  // counts
  size_t bytes() const {
    return (size_t)tsz * 4 + EB_NS * stage_bytes() + 8 * EB_NS +
           8 * EB_RCMAX + 4 * (EB_RCMAX / 32 + 2) * EB_NW;
  }
  static EbShape of(int M, int V, int C, int es, int is, int rc) {
    EbShape s;
    s.M = M, s.V = V, s.C = C, s.rc = rc;
    s.tsz = (int)(((long long)V * C + 3) / 4 * 4);
    s.gbytes = (int)(((long long)rc * C * es + 15) / 16 * 16);
    s.ibytes = (rc * is + 15) / 16 * 16;
    s.rpp = 0;
    const int np = C % 2 == 0 ? 2 : 1;   // columns a lane (PAIR)
    s.CG = (C + 32 * np - 1) / (32 * np);
    s.Q = 1;   // the largest power of 2 with Q * CG <= EB_NW
    while (2 * s.Q * s.CG <= EB_NW) s.Q *= 2;
    return s;
  }
};

// the largest chunk (256, 128, 64 or 32 rows) whose stages fit beside the
// table; rc 0 where none does
EbShape eb_shape(int M, int V, int C, int es, int is) {
  EbShape s = EbShape::of(M, V, C, es, is, 256);
  while (s.rc > 32 && s.bytes() > (size_t)EB_SMEM)
    s = EbShape::of(M, V, C, es, is, s.rc / 2);
  if (s.bytes() > (size_t)EB_SMEM) s.rc = 0;
  return s;
}

// a lane's NP = 2 (PAIR) or 1 consecutive values of a staged chunk from
// element i, as floats (PAIR: one 4- or 8-byte load)
template <typename T, bool PAIR>
__device__ __forceinline__ void eb_vals(float (&x)[2], const T* gs, int i) {
  if constexpr (PAIR) {
    if constexpr (sizeof(T) == 2) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(gs + i);
      x[0] = __uint_as_float(u << 16);
      x[1] = __uint_as_float(u & 0xffff0000u);
    } else {
      const float2 f = *reinterpret_cast<const float2*>(gs + i);
      x[0] = f.x, x[1] = f.y;
    }
  } else {
    x[0] = tof(gs[i]);
    x[1] = 0.f;
  }
}

// Sort the n rows of a staged chunk by id class (v % Q) into list, each
// class's rows in row order: rows [32 w, 32 w + 32) are warp w's window;
// a lane's rank among the window's rows of its class comes from
// __match_any_sync, the windows' counts go to cnt[w][class], and warp 0
// turns them into each window's offset in its class's run of the list
// (off, start[Q] and total[Q] after the counts).  Three block barriers.
template <typename I>
__device__ __forceinline__ void eb_bin(const EbShape& s, const I* is, int n,
                                       int2* list, int* cnt) {
  constexpr int W = EB_RCMAX / 32;   // windows a chunk at most
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1;
  int* start = cnt + W * EB_NW;
  int* total = start + EB_NW;
  for (int e = tid; e < W * EB_NW; e += EB_NW * 32) cnt[e] = 0;
  __syncthreads();
  int cls = -1, id = -1, rank = 0;
  if (w < W) {   // warp-uniform
    if (tid < n) {
      const I v = is[tid];
      if (v >= 0 && v < (I)s.V) id = (int)v, cls = id & (s.Q - 1);
    }
    const unsigned same = __match_any_sync(full, cls);
    rank = __popc(same & below);
    if (cls >= 0 && rank == 0) cnt[w * EB_NW + cls] = __popc(same);
  }
  __syncthreads();
  if (w == 0) {   // lane c < Q: class c's run and its windows' offsets
    int tot = 0;
    if (lane < s.Q)
      for (int k = 0; k < W; ++k) tot += cnt[k * EB_NW + lane];
    int st = tot;   // inclusive scan over the classes, then exclusive
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(full, st, o);
      if (lane >= o) st += y;
    }
    st -= tot;
    if (lane < s.Q) {
      start[lane] = st, total[lane] = tot;
      for (int k = 0; k < W; ++k) {
        const int c = cnt[k * EB_NW + lane];
        cnt[k * EB_NW + lane] = st;
        st += c;
      }
    }
  }
  __syncthreads();
  if (cls >= 0) list[cnt[w * EB_NW + cls] + rank] = make_int2(tid * s.C, id);
  __syncthreads();
}

// add a staged chunk, sorted by eb_bin, into the table (see the header);
// lane l of a warp owns the NP columns NP * (32 g + l) + [0, NP) of each
// of its column groups g
template <typename T, bool PAIR>
__device__ __forceinline__ void eb_chunk(const EbShape& s, float* table,
                                         const T* gs, const int2* list,
                                         const int* cnt) {
  constexpr int NP = PAIR ? 2 : 1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = w & (s.Q - 1), g0 = w / s.Q, gstep = EB_NW / s.Q;
  if (g0 >= s.CG) return;   // no column group left for this warp
  const int* start = cnt + (EB_RCMAX / 32) * EB_NW;   // then total
  const int l0 = start[q], l1 = l0 + start[EB_NW + q];
  const int C = s.C;
  for (int b0 = l0; b0 < l1; b0 += EB_BATCH) {
    int ro[EB_BATCH], v[EB_BATCH];   // row offsets in the stage, ids
#pragma unroll
    for (int k = 0; k < EB_BATCH; ++k) {
      const int2 e = b0 + k < l1 ? list[b0 + k] : make_int2(0, -1);
      ro[k] = e.x;
      v[k] = e.y;   // -1: no row (adds nothing)
    }
    bool distinct = true;
#pragma unroll
    for (int b = 1; b < EB_BATCH; ++b)
#pragma unroll
      for (int a = 0; a < b; ++a)
        distinct = distinct && (v[a] != v[b] || v[b] < 0);
    for (int cg = g0; cg < s.CG; cg += gstep) {
      const int c = NP * (cg * 32 + lane);
      if (c >= C) continue;
      float t[EB_BATCH][2], gv[EB_BATCH][2];
#pragma unroll
      for (int k = 0; k < EB_BATCH; ++k) {
        eb_vals<T, PAIR>(gv[k], gs, ro[k] + c);
        const float* e = table + max(v[k], 0) * C + c;
        if constexpr (PAIR) {
          const float2 f = *reinterpret_cast<const float2*>(e);
          t[k][0] = f.x, t[k][1] = f.y;
        } else {
          t[k][0] = *e, t[k][1] = 0.f;
        }
      }
      if (distinct) {
#pragma unroll
        for (int k = 0; k < EB_BATCH; ++k)
#pragma unroll
          for (int h = 0; h < NP; ++h) t[k][h] += gv[k][h];
      } else {
        // row order: a later row of the same id adds to the latest
        // earlier row's sum, else to the table's value
#pragma unroll
        for (int k = 0; k < EB_BATCH; ++k)
#pragma unroll
          for (int h = 0; h < NP; ++h) {
            float b = t[k][h];
#pragma unroll
            for (int i = 0; i < k; ++i)
              if (v[i] == v[k]) b = t[i][h];
            t[k][h] = b + gv[k][h];
          }
      }
#pragma unroll
      for (int k = 0; k < EB_BATCH; ++k) {
        if (v[k] < 0) continue;   // not stored: no row
        float* e = table + v[k] * C + c;
        if constexpr (PAIR)
          *reinterpret_cast<float2*>(e) = make_float2(t[k][0], t[k][1]);
        else
          *e = t[k][0];
      }
    }
  }
}

// chunk rows [r0, r0 + n) into a stage.  TMA: thread 0 alone, one bulk
// copy of the g rows and one of the ids (their whole 16-byte pieces; the
// last partial piece's ids stored directly, before the arrival that
// releases them), counted on bar.  Otherwise every thread, value by value
// (the caller synchronises).
template <typename T, typename I, bool TMA>
__device__ __forceinline__ void eb_stage(const EbShape& s,
                                         const I* __restrict__ ids,
                                         const T* __restrict__ g, int r0,
                                         int n, unsigned char* buf,
                                         uint64_t* bar) {
  T* gs = reinterpret_cast<T*>(buf);
  I* is = reinterpret_cast<I*>(buf + s.gbytes);
  if constexpr (TMA) {
    constexpr int IP = 16 / sizeof(I);
    const int nip = n / IP * IP;
    for (int r = nip; r < n; ++r) is[r] = ids[r0 + r];
    const unsigned gb = (unsigned)((size_t)n * s.C * sizeof(T));
    const unsigned ib = (unsigned)(nip * sizeof(I));
    fence_proxy_async();   // the stage's earlier generic reads
    mbar_arm(bar, gb + ib);
    bulk_g2s(gs, g + (size_t)r0 * s.C, gb, bar);
    if (ib) bulk_g2s(is, ids + r0, ib, bar);
  } else {
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t ne = (size_t)n * s.C;
    for (size_t e = tid; e < ne; e += nt) gs[e] = g[(size_t)r0 * s.C + e];
    for (int r = tid; r < n; r += nt) is[r] = ids[r0 + r];
  }
}

// Block p: the float32 partial part[p][V*C] of its rows
template <typename T, typename I, bool TMA, bool PAIR>
__global__ void __launch_bounds__(EB_NW * 32, 1)
take_rows_parts(EbShape s, const I* __restrict__ ids,
                const T* __restrict__ g, float* __restrict__ part) {
  float* table = smem;
  unsigned char* stages = reinterpret_cast<unsigned char*>(smem + s.tsz);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages +
                                               EB_NS * s.stage_bytes());
  int2* list = reinterpret_cast<int2*>(bars + EB_NS);
  int* cnt = reinterpret_cast<int*>(list + EB_RCMAX);
  const int stride = (int)s.stage_bytes();
  const int tid = threadIdx.x, nt = EB_NW * 32, p = blockIdx.x;
  const long long p0 = (long long)p * s.rpp;
  const int m0 = (int)(p0 < s.M ? p0 : s.M);
  const int m1 = (int)(p0 + s.rpp < s.M ? p0 + s.rpp : s.M);
  const int nchunks = (m1 - m0 + s.rc - 1) / s.rc;
  if constexpr (TMA) {
    if (tid == 0) {
      for (int i = 0; i < EB_NS; ++i) mbar_init(bars + i, 1);
      mbar_init_fence();
      for (int i = 0; i < EB_NS && i < nchunks; ++i) {
        const int r0 = m0 + i * s.rc;
        eb_stage<T, I, true>(s, ids, g, r0, min(s.rc, m1 - r0),
                             stages + i * stride, bars + i);
      }
    }
  }
  for (int e = tid; e < s.tsz / 4; e += nt)
    reinterpret_cast<float4*>(table)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();   // the barriers are set, the table is zero
  for (int i = 0; i < nchunks; ++i) {
    const int r0 = m0 + i * s.rc, n = min(s.rc, m1 - r0);
    const unsigned char* buf;
    if constexpr (TMA) {
      buf = stages + (i % EB_NS) * stride;
      mbar_wait(bars + i % EB_NS, (i / EB_NS) & 1);
    } else {
      buf = stages;
      eb_stage<T, I, false>(s, ids, g, r0, n, stages, nullptr);
      __syncthreads();
    }
    eb_bin<I>(s, reinterpret_cast<const I*>(buf + s.gbytes), n, list, cnt);
    eb_chunk<T, PAIR>(s, table, reinterpret_cast<const T*>(buf), list, cnt);
    __syncthreads();   // every warp is done with stage i % EB_NS
    if constexpr (TMA) {
      const int q = i + EB_NS;   // into the stage just freed
      if (tid == 0 && q < nchunks) {
        const int rq = m0 + q * s.rc;
        eb_stage<T, I, true>(s, ids, g, rq, min(s.rc, m1 - rq),
                             stages + (i % EB_NS) * stride, bars + i % EB_NS);
      }
    }
  }
  float* out = part + (size_t)p * s.V * s.C;
  for (int e = tid; e < s.V * s.C; e += nt) out[e] = table[e];
}

// out[e] = T(sum over parts p in order of part[p][e]), e < V*C: EB_SQ
// lanes an output each add a quarter of the parts in order, and the
// quarters are added in order (a fixed tree)
constexpr int EB_SQ = 4;

template <typename T>
__global__ void __launch_bounds__(NT)
take_rows_sum(int nparts, int n, const float* __restrict__ part,
              T* __restrict__ out) {
  const int t = blockIdx.x * NT + threadIdx.x;
  const int e = t / EB_SQ, q = t % EB_SQ;
  const int per = (nparts + EB_SQ - 1) / EB_SQ;
  const int p0 = min(nparts, q * per), p1 = min(nparts, p0 + per);
  const bool in = e < n;
  const float* src = part + (in ? e : 0);
  float s = 0.f;
  int p = p0;
  for (; p + 8 <= p1; p += 8) {   // 8 loads in flight, then 8 adds
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = src[(size_t)(p + i) * n];
#pragma unroll
    for (int i = 0; i < 8; ++i) s = p + i == p0 ? x[i] : s + x[i];
  }
  for (; p < p1; ++p) s = p == p0 ? src[(size_t)p * n] : s + src[(size_t)p * n];
  // the quarters in order: lanes q = 0..3 of an output are neighbours
  float sum = __shfl_sync(0xffffffffu, s, 0, EB_SQ);
#pragma unroll
  for (int i = 1; i < EB_SQ; ++i) {
    const float o = __shfl_sync(0xffffffffu, s, i, EB_SQ);
    if (i * per < nparts) sum += o;
  }
  if (in && q == 0) out[e] = fromf<T>(sum);
}

// the parts of a call: one block an SM, at least 16 rows a part
// (kernels/embed_cuda.py::parts mirrors it)
int eb_parts(int M) { return std::max(1, std::min(num_sms(), cdiv(M, 16))); }

template <typename T, typename I, bool TMA, bool PAIR>
int run_take_rows(EbShape s, const I* ids, const T* g, float* part,
                  long long part_cap, T* out, cudaStream_t st) {
  auto k = take_rows_parts<T, I, TMA, PAIR>;
  const size_t sm = s.bytes();
  static size_t opted = 0;   // the opt-in above 48 KB, once a size
  if (sm > opted) {
    VQT_TRY(smem_opt_in(k, sm));
    opted = sm;
  }
  const int nparts = eb_parts(s.M);
  s.rpp = cdiv(cdiv(s.M, nparts), 16) * 16;
  const int n = s.V * s.C;
  if ((long long)nparts * n > part_cap) return -1;
  KLAUNCH(k, nparts, EB_NW * 32, sm, st, s, ids, g, part);
  VQT_TRY(last_error());
  auto r = take_rows_sum<T>;
  KLAUNCH(r, cdiv((long long)n * EB_SQ, NT), NT, 0, st, nparts, n, part,
          out);
  return (int)last_error();
}

template <typename T, typename I>
int take_rows_typed(int M, int V, int C, const void* ids, const void* g,
                    float* part, long long part_cap, void* out,
                    cudaStream_t st) {
  const EbShape s = eb_shape(M, V, C, sizeof(T), sizeof(I));
  if (s.rc == 0) return -2;
  const bool tma = (C * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(ids) |
                     reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  const I* ip = static_cast<const I*>(ids);
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  if (C % 2 == 0)
    return tma ? run_take_rows<T, I, true, true>(s, ip, gp, part, part_cap,
                                                 op, st)
               : run_take_rows<T, I, false, true>(s, ip, gp, part, part_cap,
                                                  op, st);
  return tma ? run_take_rows<T, I, true, false>(s, ip, gp, part, part_cap, op,
                                                st)
             : run_take_rows<T, I, false, false>(s, ip, gp, part, part_cap,
                                                 op, st);
}

}  // namespace

extern "C" {

// Bytes of shared memory a block needs for a table of V ids, g's element
// size es and the ids' size is (4 or 8), or 0 where it does not fit
// (kernels/embed_cuda.py::kernel_smem mirrors it).
long long vqvae_take_rows_smem(int V, int C, int es, int is) {
  const EbShape s = eb_shape(1, V, C, es, is);
  return s.rc == 0 ? 0 : (long long)s.bytes();
}

// out [V, C] (dtype: 0 float32, 1 bfloat16) = the per-id sums of g [M, C]
// (the same dtype) by ids [M] (id64: int64, else int32); part: float32
// scratch of part_cap floats.  Returns 0, a CUDA error, -1 if the scratch
// is too small, -2 for sizes the kernel does not take (the table and four
// stages of 32 rows do not fit in shared memory).
int vqvae_take_rows_bwd(int dtype, int id64, int M, int V, int C,
                        const void* ids, const void* g, float* part,
                        long long part_cap, void* out, void* stream) {
  if (M < 1 || V < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return id64 ? take_rows_typed<float, long long>(M, V, C, ids, g, part,
                                                    part_cap, out, st)
                : take_rows_typed<float, int>(M, V, C, ids, g, part,
                                              part_cap, out, st);
  return id64 ? take_rows_typed<bf16, long long>(M, V, C, ids, g, part,
                                                 part_cap, out, st)
              : take_rows_typed<bf16, int>(M, V, C, ids, g, part, part_cap,
                                           out, st);
}

}  // extern "C"
