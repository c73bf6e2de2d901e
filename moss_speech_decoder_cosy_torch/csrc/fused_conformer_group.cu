// Fused conformer-layer group of the KV session's encoder hop for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   moss_speech_decoder_cosy_tpu/ops/pallas_conformer.py::_kernel
//   (entry fused_conformer_group).
//
// What it computes, at batch 1 over a chunk of C frames (the TPU kernel's
// numerics, not its blocking), for each of the L layers:
//   h = LayerNorm(x) (eps 1e-12) -> q | k | v = h W_qkv + b -> pk = pe W_pos
//   -> for each head, scores ((q + u) k^T + (q + v) p^T) dk^-0.5 over the Rt
//   ring slots and the C chunk frames, ring slot s valid iff s < n_tok ->
//   softmax -> A V -> x += out-proj -> x += W_2 swish(W_1 LayerNorm(x))
//   -> the chunk's [k | v] and pk written into the layer's rings, frame f at
//   slot (n_tok + f) % Rt.
//   Cast points (compute dtype T): each product accumulates in f32 and
//   rounds; each bias and residual add rounds, left to right; s1 and s2
//   round, then their sum, then the scaled sum (dk^-0.5 taken in T); masked
//   scores are -1e10; the softmax rounds x - max, exp and the f32 sum, then
//   the quotient, and zeroes masked weights; LayerNorm statistics and swish
//   run in f32.
//
// Bound on an H100 SXM (3.35 TB/s): a layer holds 3.42 M parameters, so the
// blocks group (L 6, C 5, Rt 35) must read about 41 MB of bf16 weights and
// the up group (L 4, C 20, Rt 140) about 27 MB, plus their rings: 12.5 us
// and 8.7 us.  Their 0.2-0.3 GFLOP are a few us even on f32 CUDA cores, so
// a group is bound by bytes in both dtypes, and at B = 1 the weights are
// nearly all of the bytes.
//
// What bounds it in practice is latency, not bytes: every phase of a layer
// is a short chain of dependent L2 / HBM reads (rows to stage, LayerNorm
// parameters, a weight tile, the epilogue's bias and residual) between
// grid barriers: on an H100 the blocks group took 47 us a layer in the
// first port and takes 39 us here, against the 2 us its bytes need.
// The structure is the first port's; what is redesigned is how the operands
// reach the arithmetic, so that the reads of a step are in flight together
// instead of one after another.
//
// Structure: one cooperative launch whose grid is no larger than the blocks
// the card holds at once.  It walks the layers phase by phase with a
// grid-wide barrier between phases, and every phase splits its work over
// all blocks:
//   1. LayerNorm + QKV and the position projection: work items are 16-column
//      tiles of W_qkv and W_pos;
//   2. attention: one (head, query row) per work item;
//   3. the ring writes of the layer (all of its ring reads are behind the
//      barrier of phase 2) and the out-projection with the residual;
//   4. LayerNorm + W_1 + swish;  5. W_2 with the residual.
// In a product each thread owns one 16-byte vector of a column tile and a
// strided share of the k rows, with 8 query rows of accumulators; the
// k-shares meet through warp shuffles and shared memory in a fixed order.
// The query rows (LayerNorm'd where the layer asks) are staged in shared
// memory as f32 holding T-rounded values.  The activation, q | k | v, pk,
// the attention output and the FF hidden layer live in a scratch buffer in
// global memory (L2); data written inside the launch is read with __ldcg or
// cp.async.cg, past L1.  Everything runs on CUDA cores in f32.
//
// Operand delivery:
//   - staged rows: 16-byte loads, kStageVecs in flight per lane; a
//     LayerNorm's scale and bias copied into shared memory by cp.async
//     while the rows arrive;
//   - products: the weight vectors 4 k rows at a time, as before; the
//     epilogue's bias and residual copied into shared memory by cp.async
//     when the item starts, so they have landed when its sum is done;
//   - attention: each slot's k and p rows of the head as 16-byte loads,
//     kScoreVecs of each in flight, and kAvSlots V loads in flight in A V.
// Every sum keeps the first port's order, so the outputs are the same bits.
// A cp.async ring that streamed each block's weight tiles ahead across the
// grid barriers measured slower than reading them in place, at every depth
// and slab size tried (PERF.md), and is not used.  Fewer barriers, tensor
// cores and a split of the score work across lanes are later work.

#include <atomic>
#include <cmath>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;  // query rows per register tile, one warp each
constexpr int kCols = 16;      // output columns per product work item
constexpr float kNeg = -1.0e10f;
constexpr int kMaxSmem = 232448;
constexpr int kStageVecs = 8;  // 16-byte loads in flight per lane, staging
constexpr int kScoreVecs = 8;  // per row and slot thread, scores
constexpr int kAvSlots = 8;    // per thread, A V

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to T's precision (the TPU kernel's cast points)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// load of a value that may have been written earlier in this launch (by
// another block, before a grid barrier): through L2, never a stale L1 line
template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

template <typename T> __device__ __forceinline__ void copy_bits(T* dst, const T* src);
template <> __device__ __forceinline__ void copy_bits<float>(float* dst, const float* src) {
  *dst = __ldcg(src);
}
template <> __device__ __forceinline__ void copy_bits<__nv_bfloat16>(
    __nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<unsigned short*>(dst) =
      __ldcg(reinterpret_cast<const unsigned short*>(src));
}

// One 16-byte vector of T: V consecutive values as f32.  ldcg() reads a
// vector written earlier in the launch (through L2, as ld), unpack() turns
// one in registers or in shared memory into f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const float4 v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ float4 ldcg(const float* p) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const uint4 v, float* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: the lower column first
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 ldcg(const __nv_bfloat16* p) {
    return __ldcg(reinterpret_cast<const uint4*>(p));
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// async copy of 16 bytes into shared memory; ok == false writes zeros (src
// is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct Params {
  const T *x_in, *pe;
  const T *nms, *nmb, *qkvk, *qkvb, *posk, *pbu, *pbv, *outk, *outb;
  const T *nfs, *nfb, *w1k, *w1b, *w2k, *w2b;
  T *ring_kv, *ring_pk;  // read, then written, inside the launch
  T* x_out;              // the resident activation (C x D)
  T *qkv, *pk, *att, *ffh;  // scratch: C x 3D, C x D, C x D, C x FF
  const int* n_tok;      // (1,): frames written so far, read on the device
  int C, D, heads, dk, FF, L, Rt, kmax;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by an earlier reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Rows r0 .. r0 + kRows - 1 of src (C x K) into As (kRows x K, f32), one
// warp per row: flax LayerNorm (f32 statistics, fast variance clipped at 0,
// eps 1e-12, rounded to T) when scale is given, else as they are.  Rows past
// C are zeros.  The warp reads its row as 16-byte vectors, lane l taking
// vectors l, l + 32, ..., kStageVecs of them in flight before any is stored;
// a LayerNorm's scale and bias are copied into lnp (2 x K values) with
// cp.async meanwhile.  The statistics sum As with the lane-to-k mapping
// k = l, l + 32, ..., so warp_sum meets the same partial sums as a scalar
// walk of the row.
template <typename T>
__device__ void stage_rows(float* As, T* lnp, const T* src, int C, int K,
                           int r0, const T* scale, const T* bias) {
  constexpr int V = Vec<T>::V;
  using Raw = typename Vec<T>::Raw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = r0 + warp;
  const int nv = K / V;  // K is a multiple of 8: rows start on 16 bytes
  float* a = As + warp * K;
  if (scale != nullptr) {
    for (int v = threadIdx.x; v < 2 * nv; v += kThreads)
      cp_async16(lnp + v * V, v < nv ? scale + v * V : bias + (v - nv) * V,
                 true);
    cp_async_commit();
  }
  if (r >= C) {
    for (int k = lane; k < K; k += 32) a[k] = 0.f;
  } else {
    const Raw* row = reinterpret_cast<const Raw*>(src + (size_t)r * K);
    for (int v0 = lane; v0 < nv; v0 += 32 * kStageVecs) {
      Raw buf[kStageVecs];
#pragma unroll
      for (int i = 0; i < kStageVecs; ++i)
        if (v0 + 32 * i < nv) buf[i] = __ldcg(row + v0 + 32 * i);
#pragma unroll
      for (int i = 0; i < kStageVecs; ++i) {
        if (v0 + 32 * i >= nv) break;
        float f[V];
        Vec<T>::unpack(buf[i], f);
        float4* dst = reinterpret_cast<float4*>(a + (v0 + 32 * i) * V);
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          dst[j] = make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2],
                               f[4 * j + 3]);
      }
    }
  }
  if (scale != nullptr) {
    float mean = 0.f, inv = 0.f;
    if (r < C) {
      __syncwarp();
      float s = 0.f, s2 = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = a[k];
        s += v;
        s2 += v * v;
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      mean = s / K;
      const float var = fmaxf(s2 / K - mean * mean, 0.f);
      inv = 1.f / sqrtf(var + 1e-12f);
    }
    cp_async_wait<0>();
    __syncthreads();  // lnp has landed for every thread
    if (r < C)
      for (int k = lane; k < K; k += 32)
        a[k] = rnd<T>((a[k] - mean) * (inv * to_f<T>(lnp[k])) +
                      to_f<T>(lnp[K + k]));
  }
  __syncthreads();
}

// The epilogue's operands of one product item: the layer's bias (indexed
// by column) and the residual, rows r0 .. r0 + kRows - 1 of a C x N
// activation written earlier in the launch; either may be null.
template <typename T>
struct EpiSrc {
  const T *bias, *resid;
  int r0, C;
};

// One product work item: epi(r, n, acc, b, x) with acc = sum_k As[r][k]
// W[k][n] for the kRows staged rows and the kCols columns from col0 of W
// (K x N, row-major; N a multiple of the vector width), b the bias of
// column n and x the residual of (r, n) from src (0 where src has none).
// b and x are copied into eps ((kRows + 1) x kCols values) with cp.async at
// the start, so they arrive while the product runs.  A thread owns one
// 16-byte column vector and the k rows kg, kg + KG, ...; the k-groups'
// partial sums meet through warp shuffles, then through red (kWarps x
// kRows x kCols) in a fixed order.  epi is called for every (r, n) of the
// tile: it checks the bounds.
template <typename T, typename Epi>
__device__ __forceinline__ void tile_product(const float* As, int K,
                                             const T* W, int N, int col0,
                                             float* red, T* eps,
                                             EpiSrc<T> src, Epi epi) {
  constexpr int V = Vec<T>::V;
  constexpr int NV = kCols / V;       // vectors across the tile
  constexpr int KG = kThreads / NV;   // k-groups
  if (threadIdx.x < (kRows + 1) * NV) {  // vector q: bias, then row q / NV - 1
    const int row = (int)threadIdx.x / NV - 1;
    const int c = col0 + (int)threadIdx.x % NV * V;
    const T* from = row < 0 ? src.bias : src.resid;
    const bool ok = from != nullptr && c < N && src.r0 + row < src.C;
    cp_async16(eps + threadIdx.x * V,
               !ok ? W : row < 0 ? from + c
                                 : from + (size_t)(src.r0 + row) * N + c,
               ok);
  }
  cp_async_commit();
  const int cv = threadIdx.x % NV, kg = threadIdx.x / NV;
  const int n0 = col0 + cv * V;
  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  if (n0 < N) {
    const T* w = W + n0;
#pragma unroll 4
    for (int k = kg; k < K; k += KG) {
      float wv[V];
      Vec<T>::unpack(__ldg(reinterpret_cast<const typename Vec<T>::Raw*>(
                         w + (size_t)k * N)),
                     wv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = As[r * K + k];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = fmaf(a, wv[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int o = NV; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < NV) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j)
        red[(warp * kRows + r) * kCols + lane * V + j] = acc[r][j];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < kRows * kCols) {
    const int r = threadIdx.x / kCols, c = threadIdx.x % kCols;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + r) * kCols + c];
    epi(r, col0 + c, s, to_f<T>(eps[c]), to_f<T>(eps[(r + 1) * kCols + c]));
  }
  __syncthreads();
}

// Attention of query row r, head h, layer l over [ring ++ chunk], ring slots
// below n_tok valid; writes the head's dk outputs into att.  sm: Tk + 2 dk +
// kThreads + kWarps floats.
template <typename T>
__device__ void attend(const Params<T>& p, int l, int h, int r, int n_tok,
                       float* sm) {
  constexpr int V = Vec<T>::V;
  using Raw = typename Vec<T>::Raw;
  const int D = p.D, dk = p.dk, Rt = p.Rt, Tk = Rt + p.C, D3 = 3 * D;
  float* sc = sm;             // Tk scores, then weights
  float* qs = sc + Tk;        // q + u | q + v
  float* part = qs + 2 * dk;  // kThreads partial A V sums
  float* red = part + kThreads;
  const float scale = rnd<T>(p.scale);
  const size_t lD = (size_t)l * D;
  for (int d = threadIdx.x; d < dk; d += kThreads) {
    const float q = ld<T>(p.qkv + (size_t)r * D3 + h * dk + d);
    qs[d] = rnd<T>(q + to_f<T>(p.pbu[lD + h * dk + d]));
    qs[dk + d] = rnd<T>(q + to_f<T>(p.pbv[lD + h * dk + d]));
  }
  __syncthreads();
  const T* ring_kv = p.ring_kv + (size_t)l * Rt * 2 * D + h * dk;
  const T* ring_pk = p.ring_pk + (size_t)l * Rt * D + h * dk;
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < Tk; s += kThreads) {
    float v = rnd<T>(kNeg);
    if (s >= Rt || s < n_tok) {
      const T* kr = s < Rt ? ring_kv + (size_t)s * 2 * D
                           : p.qkv + (size_t)(s - Rt) * D3 + D + h * dk;
      const T* pr = s < Rt ? ring_pk + (size_t)s * D
                           : p.pk + (size_t)(s - Rt) * D + h * dk;
      float s1 = 0.f, s2 = 0.f;
      // the vector prefix: kScoreVecs vectors of the k row and of the p row
      // in flight, then the two fmaf chains over them in d order
      const int dv = aligned16(kr) && aligned16(pr) ? dk / V * V : 0;
      for (int d = 0; d < dv; d += kScoreVecs * V) {
        const int nv = min(kScoreVecs, (dv - d) / V);
        Raw kb[kScoreVecs], pb[kScoreVecs];
#pragma unroll
        for (int i = 0; i < kScoreVecs; ++i)
          if (i < nv) {
            kb[i] = Vec<T>::ldcg(kr + d + i * V);
            pb[i] = Vec<T>::ldcg(pr + d + i * V);
          }
#pragma unroll
        for (int i = 0; i < kScoreVecs; ++i) {
          if (i >= nv) break;
          float kf[V], pf[V];
          Vec<T>::unpack(kb[i], kf);
          Vec<T>::unpack(pb[i], pf);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s1 = fmaf(qs[d + i * V + j], kf[j], s1);
            s2 = fmaf(qs[dk + d + i * V + j], pf[j], s2);
          }
        }
      }
      for (int d = dv; d < dk; ++d) {  // a row off 16 bytes, or dk's tail
        s1 = fmaf(qs[d], ld<T>(kr + d), s1);
        s2 = fmaf(qs[dk + d], ld<T>(pr + d), s2);
      }
      v = rnd<T>(rnd<T>(rnd<T>(s1) + rnd<T>(s2)) * scale);
    }
    sc[s] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int s = threadIdx.x; s < Tk; s += kThreads) {
    const float e = rnd<T>(expf(rnd<T>(sc[s] - mx)));
    sc[s] = e;
    sum += e;
  }
  sum = rnd<T>(block_sum(sum, red));
  for (int s = threadIdx.x; s < Tk; s += kThreads)
    sc[s] = (s >= Rt || s < n_tok) ? rnd<T>(sc[s] / sum) : 0.f;
  __syncthreads();
  // A V: thread (g, d) sums the slots g, g + G, ... of feature d
  const int G = kThreads / dk;
  const int g = threadIdx.x / dk, d = threadIdx.x % dk;
  if (g < G) {
    auto vrow = [&](int s) {
      return s < Rt ? ring_kv + (size_t)s * 2 * D + D
                    : p.qkv + (size_t)(s - Rt) * D3 + 2 * D + h * dk;
    };
    // kAvSlots loads in flight, then the acc chain in slot order
    float acc = 0.f;
    int s = g;
    for (; s + (kAvSlots - 1) * G < Tk; s += kAvSlots * G) {
      float v[kAvSlots];
#pragma unroll
      for (int i = 0; i < kAvSlots; ++i) v[i] = ld<T>(vrow(s + i * G) + d);
#pragma unroll
      for (int i = 0; i < kAvSlots; ++i) acc = fmaf(sc[s + i * G], v[i], acc);
    }
    for (; s < Tk; s += G) acc = fmaf(sc[s], ld<T>(vrow(s) + d), acc);
    part[g * dk + d] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < dk; e += kThreads) {
    float o = 0.f;
    for (int j = 0; j < G; ++j) o += part[j * dk + e];
    p.att[(size_t)r * D + h * dk + e] = from_f<T>(o);
  }
  __syncthreads();
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_conformer_group_kernel(const Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, D = p.D, D3 = 3 * D, FF = p.FF;
  float* As = smem;                   // kRows x (D or FF), staged rows
  float* red = As + kRows * p.kmax;   // kWarps x kRows x kCols
  // the epilogue's operands ((kRows + 1) x kCols) and a LayerNorm's scale
  // and bias (2 x D), as T, in areas sized for f32
  T* eps = reinterpret_cast<T*>(red + kWarps * kRows * kCols);
  T* lnp = reinterpret_cast<T*>(red + kWarps * kRows * kCols +
                                (kRows + 1) * kCols);
  const int nq = cdiv(D3, kCols), nd = cdiv(D, kCols), nf = cdiv(FF, kCols);
  // n_tok from device memory (the TPU kernel's scalar prefetch), so a
  // captured launch reads each replay's value; a negative count is 0
  const int n_tok = max(__ldg(p.n_tok), 0);
  const int off = n_tok % p.Rt;

  for (int l = 0; l < p.L; ++l) {
    const T* xsrc = l == 0 ? p.x_in : p.x_out;
    const size_t lD = (size_t)l * D, lF = (size_t)l * FF;

    // 1. LayerNorm -> q | k | v (+ bias); the chunk's projected positions
    for (int it = blockIdx.x; it < nq + nd; it += gridDim.x) {
      const bool pos = it >= nq;
      const int col0 = (pos ? it - nq : it) * kCols;
      for (int r0 = 0; r0 < C; r0 += kRows) {
        if (pos) {
          stage_rows<T>(As, lnp, p.pe, C, D, r0, nullptr, nullptr);
          tile_product<T>(As, D, p.posk + lD * D, D, col0, red, eps,
                          EpiSrc<T>{nullptr, nullptr, r0, C},
                          [&](int r, int n, float acc, float, float) {
                            if (r0 + r < C && n < D)
                              p.pk[(size_t)(r0 + r) * D + n] = from_f<T>(acc);
                          });
        } else {
          stage_rows<T>(As, lnp, xsrc, C, D, r0, p.nms + lD, p.nmb + lD);
          tile_product<T>(As, D, p.qkvk + lD * D3, D3, col0, red, eps,
                          EpiSrc<T>{p.qkvb + (size_t)l * D3, nullptr, r0, C},
                          [&](int r, int n, float acc, float b, float) {
                            if (r0 + r < C && n < D3)
                              p.qkv[(size_t)(r0 + r) * D3 + n] =
                                  from_f<T>(rnd<T>(acc) + b);
                          });
        }
      }
    }
    grid.sync();

    // 2. attention, one (head, query row) per work item
    for (int it = blockIdx.x; it < p.heads * C; it += gridDim.x)
      attend<T>(p, l, it % p.heads, it / p.heads, n_tok, smem);
    grid.sync();

    // 3. the chunk's [k | v] and pk into the layer's rings (every read of
    //    them is behind the barrier above), then x += out-proj
    {
      T* rk = p.ring_kv + (size_t)l * p.Rt * 2 * D;
      T* rp = p.ring_pk + (size_t)l * p.Rt * D;
      for (int e = blockIdx.x * kThreads + threadIdx.x; e < C * D3;
           e += gridDim.x * kThreads) {
        const int f = e / D3, j = e % D3;
        const int slot = (off + f) % p.Rt;
        if (j < 2 * D)
          copy_bits<T>(rk + (size_t)slot * 2 * D + j,
                       p.qkv + (size_t)f * D3 + D + j);
        else
          copy_bits<T>(rp + (size_t)slot * D + (j - 2 * D),
                       p.pk + (size_t)f * D + (j - 2 * D));
      }
    }
    for (int it = blockIdx.x; it < nd; it += gridDim.x) {
      for (int r0 = 0; r0 < C; r0 += kRows) {
        stage_rows<T>(As, lnp, p.att, C, D, r0, nullptr, nullptr);
        tile_product<T>(As, D, p.outk + lD * D, D, it * kCols, red, eps,
                        EpiSrc<T>{p.outb + lD, xsrc, r0, C},
                        [&](int r, int n, float acc, float b, float x) {
                          if (r0 + r < C && n < D) {
                            const float y = rnd<T>(x + rnd<T>(acc));
                            p.x_out[(size_t)(r0 + r) * D + n] =
                                from_f<T>(y + b);
                          }
                        });
      }
    }
    grid.sync();

    // 4. LayerNorm -> W_1 (+ bias) -> swish
    for (int it = blockIdx.x; it < nf; it += gridDim.x) {
      for (int r0 = 0; r0 < C; r0 += kRows) {
        stage_rows<T>(As, lnp, p.x_out, C, D, r0, p.nfs + lD, p.nfb + lD);
        tile_product<T>(As, D, p.w1k + lD * FF, FF, it * kCols, red, eps,
                        EpiSrc<T>{p.w1b + lF, nullptr, r0, C},
                        [&](int r, int n, float acc, float b, float) {
                          if (r0 + r < C && n < FF) {
                            const float v = rnd<T>(rnd<T>(acc) + b);
                            p.ffh[(size_t)(r0 + r) * FF + n] =
                                from_f<T>(v * (1.f / (1.f + expf(-v))));
                          }
                        });
      }
    }
    grid.sync();

    // 5. x += W_2 (+ bias)
    for (int it = blockIdx.x; it < nd; it += gridDim.x) {
      for (int r0 = 0; r0 < C; r0 += kRows) {
        stage_rows<T>(As, lnp, p.ffh, C, FF, r0, nullptr, nullptr);
        tile_product<T>(As, FF, p.w2k + lF * D, D, it * kCols, red, eps,
                        EpiSrc<T>{p.w2b + lD, p.x_out, r0, C},
                        [&](int r, int n, float acc, float b, float x) {
                          if (r0 + r < C && n < D) {
                            const float y = rnd<T>(x + rnd<T>(acc));
                            p.x_out[(size_t)(r0 + r) * D + n] =
                                from_f<T>(y + b);
                          }
                        });
      }
    }
    if (l + 1 < p.L) grid.sync();
  }
}

// Per device and dtype: the dynamic shared-memory limit raised once, and
// the device's multiprocessor count.
constexpr int kMaxDevices = 64;

template <typename T>
cudaError_t device_setup(int* sms) {
  static std::atomic<int> sm_count[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    const int n = sm_count[dev].load(std::memory_order_acquire);
    if (n > 0) {
      *sms = n;
      return cudaSuccess;
    }
  }
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_conformer_group_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices)
    sm_count[dev].store(*sms, std::memory_order_release);
  return err;
}

// Dynamic shared memory of a launch: the staged rows, red, the epilogue's
// operands and a LayerNorm's scale and bias (products), or the attention's
// scratch, whichever is larger.
size_t smem_bytes(int C, int D, int dk, int kmax, int Rt) {
  const size_t prod = (size_t)kRows * kmax + (size_t)kWarps * kRows * kCols +
                      (size_t)(kRows + 1) * kCols + 2 * (size_t)D;
  const size_t attn = (size_t)(Rt + C) + 2 * dk + kThreads + kWarps;
  return sizeof(float) * (prod > attn ? prod : attn);
}

// The launch's grid and shared memory: no more blocks than the card holds
// at once, nor than the largest phase has work items.
template <typename T>
int plan(int C, int D, int heads, int dk, int FF, int Rt, int* grid,
         size_t* smem) {
  *smem = smem_bytes(C, D, dk, D > FF ? D : FF, Rt);
  if (*smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_setup<T>(&sms);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_conformer_group_kernel<T>, kThreads, *smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int items = cdiv(3 * D, kCols) + cdiv(D, kCols);
  if (heads * C > items) items = heads * C;
  if (cdiv(FF, kCols) > items) items = cdiv(FF, kCols);
  *grid = per_sm * sms < items ? per_sm * sms : items;
  return 0;
}

template <typename T>
int launch(void* const* ptrs, int C, int D, int heads, int dk, int FF, int L,
           int Rt, cudaStream_t stream) {
  Params<T> p;
  const T** in[] = {&p.x_in, &p.pe,  &p.nms, &p.nmb, &p.qkvk, &p.qkvb,
                    &p.posk, &p.pbu, &p.pbv, &p.outk, &p.outb, &p.nfs,
                    &p.nfb,  &p.w1k, &p.w1b, &p.w2k,  &p.w2b};
  const int n_in = sizeof(in) / sizeof(in[0]);
  for (int i = 0; i < n_in; ++i) *in[i] = static_cast<const T*>(ptrs[i]);
  p.ring_kv = static_cast<T*>(ptrs[n_in]);
  p.ring_pk = static_cast<T*>(ptrs[n_in + 1]);
  p.x_out = static_cast<T*>(ptrs[n_in + 2]);
  p.qkv = static_cast<T*>(ptrs[n_in + 3]);
  p.pk = p.qkv + (size_t)C * 3 * D;
  p.att = p.pk + (size_t)C * D;
  p.ffh = p.att + (size_t)C * D;
  p.n_tok = static_cast<const int*>(ptrs[n_in + 4]);
  p.C = C; p.D = D; p.heads = heads; p.dk = dk; p.FF = FF; p.L = L;
  p.Rt = Rt;
  p.kmax = D > FF ? D : FF;
  p.scale = 1.f / sqrtf((float)dk);

  int grid = 0;
  size_t smem = 0;
  const int rc = plan<T>(C, D, heads, dk, FF, Rt, &grid, &smem);
  if (rc) return rc;
  // a cooperative launch (the grid barrier needs every block resident; the
  // grid is no larger than the card holds) through cudaLaunchKernelEx, which
  // stream capture records as a cooperative graph node
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fused_conformer_group_kernel<T>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_shape(int C, int D, int heads, int head_dim, int FF, int L, int Rt) {
  return C <= 0 || C > Rt || heads <= 0 || head_dim <= 0 ||
         head_dim > kThreads || heads * head_dim != D || D % 8 || FF <= 0 ||
         FF % 8 || L <= 0;
}

}  // namespace

// ptrs: x, pos_emb, the 15 stacked layer weights (fused_conformer.py's
// CONF_KEYS order), ring_kv, ring_pk, x_out, scratch (C * (5 D + FF)
// elements), n_tok (one int32: frames written so far; a negative value
// counts as 0).  dtype: 0 = float32, 1 = bfloat16.  The rings are updated in
// place.  Returns 0 on success, else a cudaError_t code.
extern "C" int fused_conformer_group(void* const* ptrs, int dtype, int C,
                                     int D, int heads, int head_dim, int FF,
                                     int L, int Rt, void* stream) {
  if (bad_shape(C, D, heads, head_dim, FF, L, Rt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ptrs, C, D, heads, head_dim, FF, L, Rt, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ptrs, C, D, heads, head_dim, FF, L, Rt, s);
  return (int)cudaErrorInvalidValue;
}

// The launcher's choice for this shape, without a launch: out[0] the grid,
// out[1] the dynamic shared memory of a block in bytes.  Returns what a
// launch would return before launching (cudaErrorInvalidValue for a shape
// the kernel refuses, its shared memory included).
extern "C" int fused_conformer_group_config(int dtype, int C, int D,
                                            int heads, int head_dim, int FF,
                                            int L, int Rt, int* out) {
  out[0] = out[1] = 0;
  if (bad_shape(C, D, heads, head_dim, FF, L, Rt))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0)
    rc = plan<float>(C, D, heads, head_dim, FF, Rt, &out[0], &smem);
  else if (dtype == 1)
    rc = plan<__nv_bfloat16>(C, D, heads, head_dim, FF, Rt, &out[0], &smem);
  out[1] = (int)smem;
  return rc;
}
