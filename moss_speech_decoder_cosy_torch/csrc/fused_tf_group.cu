// Fused causal-resnet + transformer-group block of the KV wavefront for
// Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   moss_speech_decoder_cosy_tpu/ops/pallas_block.py::_kernel
//   (entry fused_tf_group).
//
// What it computes, for every wavefront row (the TPU kernel's numerics, not
// its blocking):
//   prologue: xf = [cc1 ; x] -> conv3 -> LayerNorm -> mish -> + (mt W_mlp +
//   b) -> hf = [cc2 ; h] -> conv3 -> LayerNorm -> mish -> + (x W_res + b);
//   the last two frames of xf and hf are the new conv caches;
//   then for each of the L layers: LayerNorm -> q | k | v = h W_qkv -> the
//   chunk's [k | v] written into the layer's ring at slot (off + f) % rp
//   (enabled rows only) -> for each head, scores of the query chunk against
//   every ring slot, slot s valid iff (s - rot) % rp < nd -> softmax over
//   the slots -> A V -> + out-proj -> LayerNorm -> exact-GELU FF -> + .
//   Products accumulate in f32 and round to the compute dtype T at the TPU
//   kernel's cast points; scores round before and after the head_dim^-0.5
//   scale; masked scores are -1e10; the softmax runs in f32 on the rounded
//   scores and rounds once; LayerNorm, mish and GELU run in f32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): a steady mid-group
// launch of the full model (20 rows, cf 20, ch 256, 8x64 heads, ring 160,
// L 4) must read the ring slots it attends to (up to 4 x 6.55 MB) and
// ~9.8 MB of weights and write the chunk K/V: ~37 MB, 11 us; its ~4.3 GFLOP
// take 4.3 us on tensor cores.  So it is bound by bytes in bf16 (in f32, by
// operations on CUDA cores: ~64 us).
//
// Design: one thread-block cluster of CS CTAs per wavefront row (CS = 4 at
// full width: 80 CTAs of 256 threads, one per SM, one wave on the 132 SMs;
// 8 when the shared memory of 4 does not fit, as in f32; clusters of 8 in
// bf16 measured slower on an H100, PERF.md).  Rows never synchronise with each other; only the
// weights are shared, through L2.  Inside a cluster:
//   - every CTA holds the row's resident activation (cf x ch, in T) and the
//     inputs of each product in shared memory, and computes one column
//     slice of each product: conv3 taps, 1x1 residual, time MLP, out-proj,
//     FF1, FF2 split into CS contiguous slices, QKV split by heads;
//   - bf16 products run on tensor cores: mma.sync m16n8k16, A = the row's
//     frames as m16 tiles (ldmatrix from shared memory), B = weight tiles of
//     128 rows x 64 columns of the (in, out) layout streamed through a
//     3-stage cp.async ring (ldmatrix.trans), f32 accumulators; the 8 warps
//     split each tile's k16 steps in two halves that meet once per 64-column
//     chunk.  f32 products run on CUDA cores, split the same way;
//   - each CTA writes its output slice into its own copy, then copies the
//     slice into the other CTAs' copies through distributed shared memory
//     (cluster.map_shared_rank, 16-byte stores), and the cluster meets at
//     cluster.sync(); LayerNorm, mish and GELU then run locally on the whole
//     row.  20 cluster barriers at L 4;
//   - attention: the heads are dealt over the cluster (head h to rank
//     h % CS).  A CTA cp.asyncs its heads' ring slices (K and V, every
//     slot) into shared memory while the LayerNorm runs, writes the chunk's
//     new K/V both into that copy and into the ring in global memory
//     (enabled rows only), then computes Q K^T and A V on tensor cores in
//     bf16 (CUDA cores in f32) from shared memory, with the scores and the
//     softmax weights in one buffer.  The CTA that writes a head's ring
//     slots is the one that reads them, from its own shared copy, so no read
//     of the ring can see a stale or half-written slot.
// Hot loops keep their indices as cursors (an integer division is some 25
// dependent instructions) and index register arrays with constants only.
//
// Limits beyond the wrapper's checks (cudaErrorInvalidValue otherwise):
// head_dim % 4 == 0, cf <= 32 in bf16 (two m16 tiles), and a shared-memory
// layout that fits a cluster of 4 or 8 (fused_tf_group_cluster).
//
// Per-launch scalars (n_done + cf, rot and enable per row, the shared
// write offset) are read from device memory, so one captured launch serves
// every wavefront iteration of a CUDA graph.
//
// What still holds it back (about 0.33 ms a mid launch on an H100, against
// the 11 us bound): one CTA of 8 warps per SM, so every phase runs as a few
// long dependent chains per warp, and more warps (16, at 128 registers)
// did not help; every row's CTAs stream the same weight slices from L2
// (20 x 9.8 MB a launch); 20 cluster barriers; mma.sync, not wgmma.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <initializer_list>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKT = 128;               // weight rows per pipeline tile
constexpr int kNT = 64;                // weight columns per chunk
constexpr int kWPitch = kNT + 8;       // tile row pitch (elements)
constexpr int kWStages = 3;            // weight-tile ring depth
constexpr int kRB = 4;                 // rows per f32 register tile
constexpr float kNeg = -1.0e10f;
constexpr int kMaxSmem = 232448;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to T's precision (the TPU kernel's cast points)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float mish(float v) {
  const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return v * tanhf(sp);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// async copy of 16 or 8 bytes; ok == false writes zeros (src is not read)
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a / b for 0 <= a < 2^20 and 1 <= b < 2^11, with inv = 1.f / b: the
// product's error stays far below the distance to the next integer
__device__ __forceinline__ int fdiv(int a, float inv) {
  return (int)((a + 0.5f) * inv);
}

// copies rows [0, rows) x columns [c0, c0 + ncol) of this CTA's buf into
// the other CTAs of the cluster, 16 or 8 bytes a store (ncol and c0 are
// multiples of 4); the caller has synchronised the block after writing it
template <typename E>
__device__ void bcast(E* buf, int pitch, int rows, int c0, int ncol, int cs) {
  if (ncol <= 0 || cs == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row_bytes = ncol * (int)sizeof(E);
  const bool wide = row_bytes % 16 == 0 && (c0 * sizeof(E)) % 16 == 0;
  const int per_row = row_bytes / (wide ? 16 : 8);
  const int items = rows * per_row;
  for (int k = 1; k < cs; ++k) {
    const int peer = rank + k < cs ? rank + k : rank + k - cs;
    for (int i = threadIdx.x; i < items; i += kThreads) {
      const int r = i / per_row, q = i - r * per_row;
      char* src = reinterpret_cast<char*>(buf + r * pitch + c0) +
                  q * (wide ? 16 : 8);
      char* dst = cluster.map_shared_rank(src, peer);
      if (wide)
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      else
        *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
    }
  }
}

template <typename T>
struct Params {
  const T *x, *mt, *cc1, *cc2;
  const T *b1k, *b1b, *b1ls, *b1lb, *mlpk, *mlpb;
  const T *b2k, *b2b, *b2ls, *b2lb, *resk, *resb;
  const T *n1s, *n1b, *qkvk, *outk, *outb, *n3s, *n3b;
  const T *ffpk, *ffpb, *ffok, *ffob;
  T* rings;
  T *x_out, *cc1_out, *cc2_out;
  const int* scal;    // (3, rows): nd_mask, rot, enable
  const int* offset;  // (1,): the shared write offset, read on the device
  int rows, cf, cin, ch, tdim, heads, dk, ff, n_layers, rp, shared;
  int cs;                 // cluster size
  int mp, dkp, rpp;       // padded rows, head dim, ring slots
  int pc, pin, pi, pf, pd, pr;  // row pitches (elements)
  int vec;                // elements per weight / ring copy
  // byte offsets into shared memory
  int o_xres, o_hbuf, o_q, o_o, o_u1, o_ks, o_vs, o_sc, o_xf, o_hf, o_wst,
      o_sp, o_mean, o_inv, o_mt, o_red, smem_bytes;
  float scale;
};

// ------------------------------------------------------------- products
// out(r, j, acc, b), acc = sum_t sum_k A[(r + t) * lda + k] W[t][k][col(j)]
// and b = bias[col(j)] (0 without a bias) for rows r < m and local columns
// j < ncols.  A in shared memory (lda 0
// repeats one row), W in global memory with row pitch ldw and tap pitch
// K * ldw; col(j) is contiguous over every run of p.vec columns.  The loops
// keep their indices as cursors: no integer division in the hot loop.
//
// bf16: tensor cores, rows m <= 32 (two m16 tiles).  Warp w takes columns
// 16 (w % 4) .. + 15 of each 64-column chunk, both m16 tiles, and every
// other k16 step of each weight tile (w / 4 picks which); the two halves
// meet in `red` at the chunk's end and are added in a fixed order.  A's
// columns K..Kp (Kp = K rounded up to 16) must hold finite values; the
// weight tile rows past K are zero-filled.  Each thread copies the same
// column of every weight tile, so its source address only moves.
template <typename ColMap, typename Epi>
__device__ void product(const Params<bf16>& p, int m, const bf16* A, int lda,
                        int taps, int K, const bf16* W, int ldw, int ncols,
                        ColMap col, const bf16* bias, bf16* wst, float* red,
                        Epi epi) {
  const int nchunks = (ncols + kNT - 1) / kNT;
  if (nchunks == 0) return;
  const int ktiles = (K + kKT - 1) / kKT;
  const int kp = (K + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ng = warp & 3, kg = warp >> 2, mi = lane >> 3;

  // load cursor: this thread copies column ld_c of rows ld_r + i * ld_step
  const int vec = p.vec, bytes = 2 * vec, cpr = kNT / vec;
  const int ld_step = kThreads / cpr, nld = kKT / ld_step;
  const int ld_r = tid / cpr, ld_c = (tid % cpr) * vec;
  bf16* const l_dst = wst + ld_r * kWPitch + ld_c;
  int l_left = nchunks * taps * ktiles, l_k0 = 0, l_tap = 0, l_chunk = 0;
  int l_stage = 0;
  bool l_ok = ld_c < ncols;
  const bf16* l_base = W + (l_ok ? col(ld_c) : 0) + ld_r * ldw;
  const bf16* l_src = l_base;
  auto issue = [&]() {
    if (l_left > 0) {
      bf16* dst = l_dst + l_stage * (kKT * kWPitch);
      const int rows_left = K - l_k0 - ld_r;
      if (l_ok && rows_left >= kKT && bytes == 16) {
        constexpr int kStep = kThreads / (kNT / 8);  // rows per pass
#pragma unroll
        for (int i = 0; i < kKT / kStep; ++i)
          cp_async(dst + i * kStep * kWPitch, l_src + i * kStep * ldw, 16,
                   true);
      } else {
#pragma unroll
        for (int i = 0; i < kKT / 16; ++i) {
          if (i < nld) {
            const bool ok = l_ok && i * ld_step < rows_left;
            cp_async(dst + i * ld_step * kWPitch,
                     ok ? l_src + i * ld_step * ldw : W, bytes, ok);
          }
        }
      }
      --l_left;
      l_k0 += kKT;
      if (l_k0 < K) {
        l_src += kKT * ldw;
      } else {
        l_k0 = 0;
        if (++l_tap < taps) {
          l_src = l_base + l_tap * K * ldw;
        } else {
          l_tap = 0;
          const int j = ++l_chunk * kNT + ld_c;
          l_ok = j < ncols;
          l_base = l_src = W + (l_ok ? col(j) : 0) + ld_r * ldw;
        }
      }
    }
    cp_async_commit();
    l_stage = l_stage + 1 == kWStages ? 0 : l_stage + 1;
  };

  // fragments: the second m16 tile repeats the first when m <= 16 (its
  // rows are never stored)
  const bf16* const a_base =
      A + ((mi & 1) * 8 + (lane & 7)) * lda + (mi >> 1) * 8 + kg * 16;
  const int a_m1 = m > 16 ? 16 * lda : 0;
  const bf16* const b_base = wst + ((mi & 1) * 8 + (lane & 7) + kg * 16) *
                                       kWPitch + ng * 16 + (mi >> 1) * 8;
  float acc[2][2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) issue();
  int chunk = 0, tap = 0, k0 = 0, stage = 0;
  const bf16* a_tap = a_base;
  float bv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // this thread's chunk biases
  while (chunk < nchunks) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();
    issue();
    if (bias && k0 == 0 && tap == 0) {
      // fetched now, used at the chunk's end: the latency hides
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = chunk * kNT + ng * 16 + n * 8 + (lane & 3) * 2 + e;
          bv[n][e] = j < ncols ? to_f<bf16>(bias[col(j)]) : 0.f;
        }
    }
    const bf16* bt = b_base + stage * (kKT * kWPitch);
    const bf16* at = a_tap + k0;
#pragma unroll
    for (int ks = 0; ks < kKT; ks += 32) {
      if (k0 + kg * 16 + ks < kp) {
        uint32_t a[4], b[4];
        ldmatrix_x4_trans(b, bt + ks * kWPitch);
        ldmatrix_x4(a, at + ks);
        mma_bf16(acc[0][0], a, b[0], b[1]);
        mma_bf16(acc[0][1], a, b[2], b[3]);
        ldmatrix_x4(a, at + a_m1 + ks);
        mma_bf16(acc[1][0], a, b[0], b[1]);
        mma_bf16(acc[1][1], a, b[2], b[3]);
      }
    }
    stage = stage + 1 == kWStages ? 0 : stage + 1;
    k0 += kKT;
    if (k0 < K) continue;
    k0 = 0;
    if (++tap < taps) {
      a_tap += lda;
      continue;
    }
    tap = 0;
    a_tap = a_base;
    // the chunk's end: the two k halves swap partial sums, so warps kg
    // finish m16 tile kg (a + b == b + a: the order does not matter)
    {
      float4* give = reinterpret_cast<float4*>(red) +
                     ((kg * 4 + ng) * 32 + lane) * 2;
      const float4* take = reinterpret_cast<const float4*>(red) +
                           (((1 - kg) * 4 + ng) * 32 + lane) * 2;
      // (selects, not acc[1 - kg]: a runtime index would put acc in local
      // memory)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        give[n] = kg ? make_float4(acc[0][n][0], acc[0][n][1], acc[0][n][2],
                                   acc[0][n][3])
                     : make_float4(acc[1][n][0], acc[1][n][1], acc[1][n][2],
                                   acc[1][n][3]);
      __syncthreads();
      const int r = kg * 16 + (lane >> 2);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float4 o = take[n];
        const float other[4] = {o.x, o.y, o.z, o.w};
        const int j = chunk * kNT + ng * 16 + n * 8 + (lane & 3) * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int re = r + (e >> 1) * 8, je = j + (e & 1);
          const float v = (kg ? acc[1][n][e] : acc[0][n][e]) + other[e];
          if (re < m && je < ncols) epi(re, je, v, bv[n][e & 1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][n][e] = 0.f;
    ++chunk;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// f32: CUDA cores.  A thread owns one local column and kRB rows at a time,
// reading W straight from global memory (coalesced over the columns) and A
// as float4 rows (broadcast across the warp).
template <typename ColMap, typename Epi>
__device__ void product(const Params<float>& p, int m, const float* A,
                        int lda, int taps, int K, const float* W, int ldw,
                        int ncols, ColMap col, const float* bias,
                        float* /*wst*/, float* /*red*/, Epi epi) {
  // nothing of this product is asynchronous; pending copies (the ring) land
  // before any epilogue writes next to them
  cp_async_wait<0>();
  __syncthreads();
  if (ncols == 0) return;
  // item = (row block, column), walked with a cursor
  int j = threadIdx.x, r0 = 0;
  while (j >= ncols) j -= ncols, r0 += kRB;
  const int jstep = kThreads % ncols, rstep = kThreads / ncols * kRB;
  for (; r0 < m; r0 += rstep, j += jstep) {
    if (j >= ncols) j -= ncols, r0 += kRB;
    if (r0 >= m) break;
    const int c = col(j);
    const float b = bias ? bias[c] : 0.f;
    float acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = 0.f;
    for (int t = 0; t < taps; ++t) {
      const float* a0 = A + (r0 + t) * lda;
      const float* w0 = W + (size_t)t * K * ldw + c;
#pragma unroll 2
      for (int k = 0; k < K; k += 4) {
        const float w_0 = w0[(size_t)(k + 0) * ldw];
        const float w_1 = w0[(size_t)(k + 1) * ldw];
        const float w_2 = w0[(size_t)(k + 2) * ldw];
        const float w_3 = w0[(size_t)(k + 3) * ldw];
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(a0 + r * lda + k);
          acc[r] = fmaf(a.x, w_0, acc[r]);
          acc[r] = fmaf(a.y, w_1, acc[r]);
          acc[r] = fmaf(a.z, w_2, acc[r]);
          acc[r] = fmaf(a.w, w_3, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r)
      if (r0 + r < m) epi(r0 + r, j, acc[r], b);
  }
  __syncthreads();
}

// ------------------------------------------------------------ attention
// Every head this CTA owns, in one pass each: sc[hi][r][s] holds the scores
// of head hi as the TPU kernel rounds them (masked slots hold the rounded
// -1e10), then, in place, the softmax weights; A V goes to this CTA's ob.
// bf16 work items are (head, m16 tile, 16-slot block); mtiles is 1 or 2.
template <typename Valid>
__device__ void scores(const Params<bf16>& p, int hc, const bf16* qb,
                       const bf16* ks, bf16* sc, Valid valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3;
  const int mtiles = p.mp / 16, per_head = mtiles * (p.rpp / 16);
  for (int it = warp; it < hc * per_head; it += kWarps) {
    int hi = 0, rem = it;
    while (rem >= per_head) rem -= per_head, ++hi;
    const int mt = mtiles == 2 ? rem & 1 : 0;
    const int nb = mtiles == 2 ? rem >> 1 : rem;
    const bf16* qh = qb + (hi * p.cf + mt * 16) * p.pd;
    const bf16* kh = ks + (hi * p.rpp + nb * 16) * p.pd;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < p.dkp; kk += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qh + ((mi & 1) * 8 + (lane & 7)) * p.pd + kk +
                         (mi >> 1) * 8);
      ldmatrix_x4(b, kh + ((mi >> 1) * 8 + (lane & 7)) * p.pd + kk +
                         (mi & 1) * 8);
      mma_bf16(c[0], a, b[0], b[1]);
      mma_bf16(c[1], a, b[2], b[3]);
    }
    bf16* sh = sc + hi * p.cf * p.pr;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int sl = nb * 16 + n * 8 + (lane & 3) * 2 + (e & 1);
        if (r < p.cf && sl < p.rp)
          sh[r * p.pr + sl] = __float2bfloat16_rn(
              valid(sl) ? rnd<bf16>(c[n][e]) * p.scale : kNeg);
      }
  }
}

template <typename Valid>
__device__ void scores(const Params<float>& p, int hc, const float* qb,
                       const float* ks, float* sc, Valid valid) {
  const int nrb = (p.cf + kRB - 1) / kRB;
  for (int item = threadIdx.x; item < hc * p.rp * nrb; item += kThreads) {
    const int sl = item % p.rp, rest = item / p.rp;
    const int hi = rest / nrb, r0 = (rest % nrb) * kRB;
    const float* qh = qb + hi * p.cf * p.pd;
    const float* kh = ks + hi * p.rpp * p.pd;
    float acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = 0.f;
    for (int d = 0; d < p.dk; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kh + sl * p.pd + d);
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(qh + (r0 + r) * p.pd + d);
        acc[r] = fmaf(q4.x, k4.x, acc[r]);
        acc[r] = fmaf(q4.y, k4.y, acc[r]);
        acc[r] = fmaf(q4.z, k4.z, acc[r]);
        acc[r] = fmaf(q4.w, k4.w, acc[r]);
      }
    }
    const bool ok = valid(sl);
    float* sh = sc + hi * p.cf * p.pr;
#pragma unroll
    for (int r = 0; r < kRB; ++r)
      if (r0 + r < p.cf)
        sh[(r0 + r) * p.pr + sl] = ok ? acc[r] * p.scale : kNeg;
  }
}

// softmax over the ring slots of each (head, query row), one warp per row,
// in f32 on the rounded scores, rounded once, in place; invalid and padding
// slots get 0
template <typename T, typename Valid>
__device__ void softmax_rows(const Params<T>& p, int hc, T* sc, Valid valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < hc * p.cf; rr += kWarps) {
    int hi = 0, r = rr;
    while (r >= p.cf) r -= p.cf, ++hi;
    T* s = sc + (hi * p.cf + r) * p.pr;
    float mx = -INFINITY;
    for (int j = lane; j < p.rp; j += 32) mx = fmaxf(mx, to_f<T>(s[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < p.rp; j += 32) sum += expf(to_f<T>(s[j]) - mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < p.rpp; j += 32) {
      float pr = 0.f;
      if (j < p.rp && valid(j)) pr = expf(to_f<T>(s[j]) - mx) / sum;
      s[j] = from_f<T>(pr);
    }
  }
}

// o[r][head * dk + d] = rnd(sum_s P[r][s] V[s][d]) into this CTA; bf16
// work items (head, m16 tile, n8 column tile)
__device__ void attend_v(const Params<bf16>& p, int hc, int rank,
                         const bf16* pb, const bf16* vs, bf16* ob) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3;
  const int mtiles = p.mp / 16, per_head = mtiles * ((p.dk + 7) / 8);
  for (int it = warp; it < hc * per_head; it += kWarps) {
    int hi = 0, rem = it;
    while (rem >= per_head) rem -= per_head, ++hi;
    const int mt = mtiles == 2 ? rem & 1 : 0;
    const int nt = mtiles == 2 ? rem >> 1 : rem;
    const bf16* ph = pb + (hi * p.cf + mt * 16) * p.pr;
    const bf16* vh = vs + hi * p.rpp * p.pd + nt * 8;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < p.rpp; kk += 16) {
      uint32_t a[4], b[2];
      ldmatrix_x4(a, ph + ((mi & 1) * 8 + (lane & 7)) * p.pr + kk +
                         (mi >> 1) * 8);
      ldmatrix_x2_trans(b, vh + (kk + (lane & 7) + (mi & 1) * 8) * p.pd);
      mma_bf16(c, a, b[0], b[1]);
    }
    const int col = (rank + hi * p.cs) * p.dk;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mt * 16 + (lane >> 2) + (e >> 1) * 8;
      const int d = nt * 8 + (lane & 3) * 2 + (e & 1);
      if (r < p.cf && d < p.dk)
        ob[r * p.pi + col + d] = __float2bfloat16_rn(c[e]);
    }
  }
}

__device__ void attend_v(const Params<float>& p, int hc, int rank,
                         const float* pb, const float* vs, float* ob) {
  const int nrb = (p.cf + kRB - 1) / kRB;
  for (int item = threadIdx.x; item < hc * p.dk * nrb; item += kThreads) {
    const int d = item % p.dk, rest = item / p.dk;
    const int hi = rest / nrb, r0 = (rest % nrb) * kRB;
    const float* ph = pb + hi * p.cf * p.pr;
    const float* vh = vs + hi * p.rpp * p.pd;
    float acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = 0.f;
    for (int sl = 0; sl < p.rp; ++sl) {
      const float v = vh[sl * p.pd + d];
#pragma unroll
      for (int r = 0; r < kRB; ++r)
        acc[r] = fmaf(ph[(r0 + r) * p.pr + sl], v, acc[r]);
    }
    const int col = (rank + hi * p.cs) * p.dk;
#pragma unroll
    for (int r = 0; r < kRB; ++r)
      if (r0 + r < p.cf) ob[(r0 + r) * p.pi + col + d] = acc[r];
  }
}

// flax LayerNorm statistics of rows < rows over n features: f32, fast
// variance clipped at 0, eps 1e-5; one warp per row
template <typename T>
__device__ void row_stats(const T* in, int pitch, int rows, int n,
                          float* mean, float* inv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float v = to_f<T>(in[r * pitch + c]);
      s += v;
      s2 += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      const float m = s / n;
      mean[r] = m;
      inv[r] = 1.f / sqrtf(fmaxf(s2 / n - m * m, 0.f) + 1e-5f);
    }
  }
}

// LayerNorm of rows < rows, output rounded to T
// scale and bias pass through `stage` (2 n floats of shared memory), so no
// warp waits on global memory per element
template <typename T>
__device__ void stage_vectors(float* stage, const T* a, const T* b, int n) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    stage[c] = to_f<T>(a[c]);
    stage[n + c] = to_f<T>(b[c]);
  }
  __syncthreads();
}

template <typename T>
__device__ void layer_norm(const T* in, int pin, T* out, int pout, int rows,
                           int n, const T* scale, const T* bias,
                           float* stage) {
  stage_vectors(stage, scale, bias, n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float v = to_f<T>(in[r * pin + c]);
      s += v;
      s2 += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / n;
    const float inv = 1.f / sqrtf(fmaxf(s2 / n - mean * mean, 0.f) + 1e-5f);
    for (int c = lane; c < n; c += 32)
      out[r * pout + c] = from_f<T>(
          (to_f<T>(in[r * pin + c]) - mean) * (inv * stage[c]) + stage[n + c]);
  }
}

// ---------------------------------------------------------------- kernel
// Phases, each closed by cluster.sync(): a phase writes into other CTAs'
// shared memory only buffers that no CTA touches locally in that phase.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_tf_group_kernel(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs, rank = (int)cluster.block_rank();
  const int row = blockIdx.x / cs, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cf = p.cf, ch = p.ch, cin = p.cin, rp = p.rp, dk = p.dk;
  const int inner = p.heads * dk, d2 = 2 * inner, ff = p.ff;

  T* xres = reinterpret_cast<T*>(smem + p.o_xres);  // resident activation
  T* hbuf = reinterpret_cast<T*>(smem + p.o_hbuf);  // LayerNorm output
  T* qb = reinterpret_cast<T*>(smem + p.o_q);       // this CTA's heads' q
  T* ob = reinterpret_cast<T*>(smem + p.o_o);       // attention output
  // one region, three lives: the prologue's xf | hf, the attention's
  // K | V | scores | P, the FF hidden layer
  T* ks = reinterpret_cast<T*>(smem + p.o_ks);
  T* vs = reinterpret_cast<T*>(smem + p.o_vs);
  T* sc = reinterpret_cast<T*>(smem + p.o_sc);
  T* fb = reinterpret_cast<T*>(smem + p.o_u1);
  T* xf = reinterpret_cast<T*>(smem + p.o_xf);
  T* hf = reinterpret_cast<T*>(smem + p.o_hf);
  T* wst = reinterpret_cast<T*>(smem + p.o_wst);
  // LayerNorm parameters pass through the weight ring between products
  float* s_stage = reinterpret_cast<float*>(smem + p.o_wst);
  float* s_p = reinterpret_cast<float*>(smem + p.o_sp);
  float* s_mean = reinterpret_cast<float*>(smem + p.o_mean);
  float* s_inv = reinterpret_cast<float*>(smem + p.o_inv);
  T* s_mt = reinterpret_cast<T*>(smem + p.o_mt);
  float* s_red = reinterpret_cast<float*>(smem + p.o_red);

  // every buffer starts at zero: padding columns stay finite
  for (int i = tid; i < p.smem_bytes / 16; i += kThreads)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  cluster.sync();

  const int nd = p.scal[row];
  const int rot = p.scal[p.rows + row];
  const bool en = p.scal[2 * p.rows + row] != 0;
  // the shared offset comes from device memory (the TPU kernel's scalar
  // prefetch), so a captured launch reads each replay's value; any int is
  // taken modulo rp
  int off = (p.shared ? *p.offset : nd - cf) % rp;
  if (off < 0) off += rp;
  int rot_m = rot % rp;
  if (rot_m < 0) rot_m += rp;
  auto valid = [=](int slot) {  // slot in [0, rp)
    const int m = slot - rot_m;
    return (m < 0 ? m + rp : m) < nd;
  };
  // this CTA's contiguous slice [n0, n0 + count) of an n-column product
  auto slice = [&](int n, int& first) {
    const int w = ((n + cs - 1) / cs + 7) & ~7;
    first = rank * w;
    return max(0, min(w, n - first));
  };
  const int hc = p.heads > rank ? (p.heads - rank + cs - 1) / cs : 0;
  int n0;
  const int nc = slice(ch, n0);
  auto cslice = [=](int j) { return n0 + j; };

  // ------------------------------------------ prologue 1: conv1, time MLP
  {
    const T* xg = p.x + (size_t)row * cf * cin;
    const T* c1 = p.cc1 + (size_t)row * 2 * cin;
    for (int r = warp; r < cf + 2; r += kWarps)
      for (int c = lane; c < cin; c += 32)
        xf[r * p.pin + c] = r < 2 ? c1[r * cin + c] : xg[(r - 2) * cin + c];
    for (int c = tid; c < p.tdim; c += kThreads)
      s_mt[c] = p.mt[(size_t)row * p.tdim + c];
    __syncthreads();
    if (rank == 0)
      for (int r = 0; r < 2; ++r)
        for (int c = tid; c < cin; c += kThreads)
          p.cc1_out[((size_t)row * 2 + r) * cin + c] = xf[(cf + r) * p.pin + c];
    product(p, cf, xf, p.pin, 3, cin, p.b1k, ch, nc, cslice, p.b1b, wst,
            s_red, [&](int r, int j, float acc, float b) {
              xres[r * p.pc + n0 + j] = from_f<T>(rnd<T>(acc) + b);
            });
    bcast(xres, p.pc, cf, n0, nc, cs);
    // time-MLP projection of this row: one row (lda 0) through the same
    // product
    product(p, 1, s_mt, 0, 1, p.tdim, p.mlpk, ch, nc, cslice, p.mlpb, wst,
            s_red, [&](int, int j, float acc, float b) {
              s_p[n0 + j] = rnd<T>(rnd<T>(acc) + b);
            });
    bcast(s_p, 0, 1, n0, nc, cs);
  }
  cluster.sync();

  // ----------------------------- prologue 2: LN -> mish -> + t, conv2
  {
    row_stats(xres, p.pc, cf, ch, s_mean, s_inv);
    stage_vectors(s_stage, p.b1ls, p.b1lb, ch);
    const T* c2 = p.cc2 + (size_t)row * 2 * ch;
    for (int r = warp; r < cf + 2; r += kWarps)
      for (int c = lane; c < ch; c += 32) {
        float v;
        if (r < 2) {
          v = to_f<T>(c2[r * ch + c]);
        } else {
          const int q = r - 2;
          const float y = rnd<T>((to_f<T>(xres[q * p.pc + c]) - s_mean[q]) *
                                     (s_inv[q] * s_stage[c]) +
                                 s_stage[ch + c]);
          v = rnd<T>(rnd<T>(mish(y)) + s_p[c]);
        }
        hf[r * p.pc + c] = from_f<T>(v);
      }
    __syncthreads();
    if (rank == 0)
      for (int r = 0; r < 2; ++r)
        for (int c = tid; c < ch; c += kThreads)
          p.cc2_out[((size_t)row * 2 + r) * ch + c] = hf[(cf + r) * p.pc + c];
    product(p, cf, hf, p.pc, 3, ch, p.b2k, ch, nc, cslice, p.b2b, wst, s_red,
            [&](int r, int j, float acc, float b) {
              hbuf[r * p.pc + n0 + j] = from_f<T>(rnd<T>(acc) + b);
            });
    bcast(hbuf, p.pc, cf, n0, nc, cs);
  }
  cluster.sync();

  // ------------------------- prologue 3: LN -> mish, + 1x1 residual of x
  // (hbuf takes no remote writes in this phase, so LN and mish run in place)
  row_stats(hbuf, p.pc, cf, ch, s_mean, s_inv);
  stage_vectors(s_stage, p.b2ls, p.b2lb, ch);
  for (int r = warp; r < cf; r += kWarps)
    for (int c = lane; c < ch; c += 32) {
      T& h = hbuf[r * p.pc + c];
      const float y =
          rnd<T>((to_f<T>(h) - s_mean[r]) * (s_inv[r] * s_stage[c]) +
                 s_stage[ch + c]);
      h = from_f<T>(mish(y));
    }
  __syncthreads();
  product(p, cf, xf + 2 * p.pin, p.pin, 1, cin, p.resk, ch, nc, cslice,
          p.resb, wst, s_red, [&](int r, int j, float acc, float b) {
            const int n = n0 + j;
            const float res = rnd<T>(rnd<T>(acc) + b);
            xres[r * p.pc + n] = from_f<T>(to_f<T>(hbuf[r * p.pc + n]) + res);
          });
  bcast(xres, p.pc, cf, n0, nc, cs);
  cluster.sync();

  // ------------------------------------------------------------ layers
  const int hd = hc * dk;
  const float inv_hd = 1.f / hd, inv_dk = 1.f / dk;
  int f0;
  const int nfc = slice(ff, f0);
  // a residual epilogue: x = rnd(rnd(x + rnd(acc)) + b)
  auto residual = [&](int r, int j, float acc, float b) {
    T& x = xres[r * p.pc + n0 + j];
    x = from_f<T>(rnd<T>(to_f<T>(x) + rnd<T>(acc)) + b);
  };
  for (int l = 0; l < p.n_layers; ++l) {
    T* ring = p.rings + ((size_t)l * p.rows + row) * rp * d2;

    // 1: this CTA's heads' ring slices -> shared memory (async, under the
    // LayerNorm and the QKV product), LN1, QKV, ring write, attention
    {
      // (slot row over every head's rpp rows, copy within the row) walked
      // with a cursor
      const int per = p.dkp / p.vec, nrow = hc * p.rpp;
      int sr = tid / per, d = (tid % per) * p.vec;
      const int sstep = kThreads / per, dstep = (kThreads % per) * p.vec;
      const int bytes = p.vec * (int)sizeof(T);
      for (; sr < nrow; sr += sstep, d += dstep) {
        if (d >= p.dkp) d -= p.dkp, ++sr;
        if (sr >= nrow) break;
        int hi = 0, s = sr;
        while (s >= p.rpp) s -= p.rpp, ++hi;
        const bool ok = s < rp && d < dk;
        const T* src = ring + (size_t)(ok ? s : 0) * d2 +
                       (rank + hi * cs) * dk + (ok ? d : 0);
        const int at = sr * p.pd + d;
        cp_async(ks + at, src, bytes, ok);
        cp_async(vs + at, src + inner, bytes, ok);
      }
      cp_async_commit();
    }
    layer_norm(xres, p.pc, hbuf, p.pc, cf, ch, p.n1s + l * ch,
               p.n1b + l * ch, s_stage);
    __syncthreads();
    // local column j = (kind, head hi, d): kind 0 q, 1 k, 2 v
    auto qkv_split = [=](int j, int& kind, int& hi) {
      kind = fdiv(j, inv_hd);
      const int jh = j - kind * hd;
      hi = fdiv(jh, inv_dk);
      return jh - hi * dk;
    };
    product(p, cf, hbuf, p.pc, 1, ch, p.qkvk + (size_t)l * ch * 3 * inner,
            3 * inner, 3 * hd,
            [=](int j) {
              int kind, hi;
              const int d = qkv_split(j, kind, hi);
              return kind * inner + (rank + hi * cs) * dk + d;
            },
            static_cast<const T*>(nullptr), wst, s_red,
            [&](int r, int j, float acc, float) {
              int kind, hi;
              const int d = qkv_split(j, kind, hi);
              const T v = from_f<T>(acc);
              if (kind == 0) {
                qb[(hi * cf + r) * p.pd + d] = v;
              } else if (en) {
                int slot = off + r;
                if (slot >= rp) slot -= rp;
                (kind == 1 ? ks : vs)[(hi * p.rpp + slot) * p.pd + d] = v;
                ring[(size_t)slot * d2 + (kind - 1) * inner +
                     (rank + hi * cs) * dk + d] = v;
              }
            });
    cp_async_wait<0>();
    __syncthreads();
    if (hc > 0) {
      scores(p, hc, qb, ks, sc, valid);
      __syncthreads();
      softmax_rows(p, hc, sc, valid);
      __syncthreads();
      attend_v(p, hc, rank, sc, vs, ob);
      __syncthreads();
      for (int hi = 0; hi < hc; ++hi)
        bcast(ob, p.pi, cf, (rank + hi * cs) * dk, dk, cs);
    }
    cluster.sync();

    // 2: out-proj + residual
    product(p, cf, ob, p.pi, 1, inner, p.outk + (size_t)l * inner * ch, ch,
            nc, cslice, p.outb + l * ch, wst, s_red, residual);
    bcast(xres, p.pc, cf, n0, nc, cs);
    cluster.sync();

    // 3: LN3, FF1 + GELU
    layer_norm(xres, p.pc, hbuf, p.pc, cf, ch, p.n3s + l * ch,
               p.n3b + l * ch, s_stage);
    {
      // the FF hidden layer's padding columns (the region held attention
      // data): zero, so the padded products stay finite
      const int kpad = p.pf - ff - (sizeof(T) == 2 ? 8 : 4);
      for (int r = warp; r < cf; r += kWarps)
        for (int c = lane; c < kpad; c += 32)
          fb[r * p.pf + ff + c] = from_f<T>(0.f);
    }
    __syncthreads();
    product(p, cf, hbuf, p.pc, 1, ch, p.ffpk + (size_t)l * ch * ff, ff, nfc,
            [=](int j) { return f0 + j; }, p.ffpb + (size_t)l * ff, wst,
            s_red, [&](int r, int j, float acc, float b) {
              fb[r * p.pf + f0 + j] = from_f<T>(gelu(rnd<T>(rnd<T>(acc) + b)));
            });
    bcast(fb, p.pf, cf, f0, nfc, cs);
    cluster.sync();

    // 4: FF2 + residual
    product(p, cf, fb, p.pf, 1, ff, p.ffok + (size_t)l * ff * ch, ch, nc,
            cslice, p.ffob + l * ch, wst, s_red, residual);
    bcast(xres, p.pc, cf, n0, nc, cs);
    cluster.sync();
  }

  T* xo = p.x_out + (size_t)row * cf * ch;
  for (int r = warp; r < cf; r += kWarps)
    for (int j = lane; j < nc; j += 32)
      xo[r * ch + n0 + j] = xres[r * p.pc + n0 + j];
}

// ---------------------------------------------------------------- launch
constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared-memory limit once per device and dtype.
template <typename T>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(fused_tf_group_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

int round_up(int x, int a) { return (x + a - 1) / a * a; }

// Lays out shared memory for cluster size cs; returns its bytes.
template <typename T>
int layout(Params<T>& p, int cs) {
  const int e = sizeof(T);
  p.cs = cs;
  const int hc = (p.heads + cs - 1) / cs;  // heads per CTA, at most
  int o = 0;
  auto take = [&](int bytes) {
    const int at = o;
    o += round_up(bytes, 128);
    return at;
  };
  // Row buffers hold cf rows (cf + 2 with the conv caches).  A product or
  // attention reads whole m16 tiles (or kRB-row blocks): the rows past cf
  // come from whatever follows in shared memory, are finite or not, and
  // only reach output rows that are never stored.
  const int rows = p.cf;
  p.o_xres = take(rows * p.pc * e);
  p.o_hbuf = take(rows * p.pc * e);
  p.o_q = take(hc * rows * p.pd * e);
  p.o_o = take(rows * p.pi * e);
  const int u1 = o;
  p.o_u1 = p.o_ks = p.o_xf = u1;
  p.o_vs = p.o_ks + round_up(hc * p.rpp * p.pd * e, 128);
  p.o_sc = p.o_vs + round_up(hc * p.rpp * p.pd * e, 128);
  // (the weight ring, at least 48 KB in bf16, follows the last row buffer)
  const int att_end = p.o_sc + round_up(hc * rows * p.pr * e, 128);
  const int ffn_end = u1 + round_up(rows * p.pf * e, 128);
  p.o_hf = p.o_xf + round_up((rows + 2) * p.pin * e, 128);
  const int pro_end = p.o_hf + round_up((rows + 2) * p.pc * e, 128);
  o = std::max(att_end, std::max(ffn_end, pro_end));
  p.o_wst = take(std::max(e == 2 ? kWStages * kKT * kWPitch * e : 0,
                          2 * p.ch * 4));
  p.o_sp = take(p.ch * 4);
  p.o_mean = take(p.mp * 4);
  p.o_inv = take(p.mp * 4);
  p.o_mt = take(round_up(p.tdim, 16) * e);
  // the k-split products' partial sums: 4 column groups x 32 lanes x 16
  p.o_red = take(e == 2 ? 4 * 32 * 16 * 4 : 0);
  p.smem_bytes = o;
  return o;
}

// Sets the padded sizes and row pitches of p from its dimensions.
template <typename T>
void set_pitches(Params<T>& p) {
  const bool bf = sizeof(T) == 2;
  // bf16 pads K to the mma depth (16) and rows to m16 tiles; f32 pads
  // rows to its 4-row register tile and K to float4
  const int al = bf ? 16 : 4, pad = bf ? 8 : 4;
  const int inner = p.heads * p.dk;
  p.mp = round_up(p.cf, bf ? 16 : kRB);
  p.dkp = round_up(p.dk, al);
  p.rpp = bf ? round_up(p.rp, 16) : p.rp;
  p.pc = round_up(p.ch, al) + pad;
  p.pin = round_up(p.cin, al) + pad;
  p.pi = round_up(inner, al) + pad;
  p.pf = round_up(p.ff, al) + pad;
  p.pd = p.dkp + pad;
  p.pr = p.rpp + pad;
}

// The smallest cluster (4, then 8 CTAs) whose shared memory fits, with p
// laid out for it; 0 when neither fits.
template <typename T>
int pick_cluster(Params<T>& p) {
  for (int cand : {4, 8})
    if (layout(p, cand) <= kMaxSmem) return cand;
  return 0;
}

template <typename T>
int launch(void* const* ptrs, int rows, int cf, int cin, int ch, int tdim,
           int heads, int dk, int ff, int n_layers, int rp, int shared,
           cudaStream_t stream) {
  const bool bf = sizeof(T) == 2;
  if (dk % 4 || (bf && cf > 32)) return (int)cudaErrorInvalidValue;
  Params<T> p;
  const T** in[] = {&p.x, &p.mt, &p.cc1, &p.cc2, &p.b1k, &p.b1b, &p.b1ls,
                    &p.b1lb, &p.mlpk, &p.mlpb, &p.b2k, &p.b2b, &p.b2ls,
                    &p.b2lb, &p.resk, &p.resb, &p.n1s, &p.n1b, &p.qkvk,
                    &p.outk, &p.outb, &p.n3s, &p.n3b, &p.ffpk, &p.ffpb,
                    &p.ffok, &p.ffob};
  const int n_in = sizeof(in) / sizeof(in[0]);
  for (int i = 0; i < n_in; ++i) *in[i] = static_cast<const T*>(ptrs[i]);
  p.rings = static_cast<T*>(ptrs[n_in]);
  p.x_out = static_cast<T*>(ptrs[n_in + 1]);
  p.cc1_out = static_cast<T*>(ptrs[n_in + 2]);
  p.cc2_out = static_cast<T*>(ptrs[n_in + 3]);
  p.scal = static_cast<const int*>(ptrs[n_in + 4]);
  p.offset = static_cast<const int*>(ptrs[n_in + 5]);
  p.rows = rows; p.cf = cf; p.cin = cin; p.ch = ch; p.tdim = tdim;
  p.heads = heads; p.dk = dk; p.ff = ff; p.n_layers = n_layers; p.rp = rp;
  p.shared = shared;
  p.scale = 1.f / sqrtf((float)dk);
  set_pitches(p);
  const int inner = heads * dk;
  p.vec = (bf && cin % 8 == 0 && ch % 8 == 0 && tdim % 8 == 0 &&
           inner % 8 == 0 && ff % 8 == 0 && dk % 8 == 0) ? 8 : 4;
  const int cs = pick_cluster(p);
  if (!cs) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_tf_group_kernel<T>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: x, mt, cc1, cc2, the 12 resnet weights, the 11 stacked transformer
// weights (fused_block.py's RES_KEYS and TF_KEYS order), rings, x_out,
// cc1_out, cc2_out, scal, offset (one int32, read only when shared).  dtype:
// 0 = float32, 1 = bfloat16.  The cluster is the smallest of 4 and 8 CTAs
// whose shared memory fits.  Returns 0 on success, else a cudaError_t code.
extern "C" int fused_tf_group(void* const* ptrs, int dtype, int rows, int cf,
                              int cin, int ch, int tdim, int heads,
                              int head_dim, int ff, int n_layers, int rp,
                              int shared, void* stream) {
  if (rows <= 0 || cf <= 0 || cf > rp || cin % 4 || ch % 4 || tdim % 4 ||
      (heads * head_dim) % 4 || ff % 4 || n_layers <= 0 || heads <= 0 ||
      head_dim <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ptrs, rows, cf, cin, ch, tdim, heads, head_dim, ff,
                         n_layers, rp, shared, s);
  if (dtype == 1)
    return launch<bf16>(ptrs, rows, cf, cin, ch, tdim, heads, head_dim, ff,
                        n_layers, rp, shared, s);
  return (int)cudaErrorInvalidValue;
}

// The cluster size the launcher picks for this geometry (4 or 8 CTAs), or 0
// when the shared memory of neither fits (the launcher then refuses it).
// fused_block.py's cluster_size computes the same from the same layout.
extern "C" int fused_tf_group_cluster(int dtype, int cf, int cin, int ch,
                                      int tdim, int heads, int head_dim,
                                      int ff, int rp) {
  if (dtype == 0) {
    Params<float> p;
    p.cf = cf; p.cin = cin; p.ch = ch; p.tdim = tdim; p.heads = heads;
    p.dk = head_dim; p.ff = ff; p.rp = rp;
    set_pitches(p);
    return pick_cluster(p);
  }
  if (dtype == 1) {
    Params<bf16> p;
    p.cf = cf; p.cin = cin; p.ch = ch; p.tdim = tdim; p.heads = heads;
    p.dk = head_dim; p.ff = ff; p.rp = rp;
    set_pitches(p);
    return pick_cluster(p);
  }
  return 0;
}
