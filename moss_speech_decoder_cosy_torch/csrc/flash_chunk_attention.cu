// Flash chunk-causal attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels
//   moss_speech_decoder_cosy_tpu/ops/pallas_attention.py::_attn_kernel
//   (entry flash_chunk_attention, (B,H,T,dk)) and ::_attn_kernel_fl
//   (entry flash_chunk_attention_fl, (B,T,H*dk)).
// One kernel serves both layouts: it takes element strides for
// (batch, head, time); the feature stride is 1.
//
// What it computes (the TPU kernel's numerics, not its blocking):
//   q is scaled in its own dtype, scores are accumulated in f32, a key k is
//   visible to query i iff k < valid_len and (chunk == 0 or
//   k/chunk <= i/chunk), masked scores are -1e30, the softmax is online
//   (m, l, acc in f32), p is rounded to v's dtype before P*V, and the
//   output is acc / max(l, 1e-20) rounded to the input dtype.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32,
// 3.35 TB/s): at the offline shape (B,H,T,dk) = (2,8,1000,64), chunk 0, the
// work is 4*T^2*dk*B*H = 4.1 GFLOP over 8.2 MB (bf16: q, k, v read, o
// written), so the bound is the arithmetic: ~4.1 us in bf16 on tensor
// cores, ~61 us in f32 on CUDA cores.  The windowed shape (2,8,160,64),
// chunk 50, is bound by its 1.3 MB of bytes: ~0.4 us.
//
// bf16 design (FlashAttention-2 on mma.sync): one CTA per (batch*head,
// 64-row query tile), 4 warps of 16 query rows each (128-row tiles of 8
// warps measured slower on an H100; PERF.md).  Q is loaded once by cp.async, scaled
// in bf16 and kept in registers as m16n8k16 A fragments (ldmatrix).  K/V
// tiles of 64 keys stream as bf16 through a 3-stage shared-memory ring of
// cp.async copies (16 B per copy, XOR-swizzled 128 B rows, so ldmatrix is
// conflict-free); the copy of tile i+2 overlaps the math of tile i, with one
// __syncthreads per tile.  S = Q K^T runs on tensor cores with f32
// accumulation; the mask is applied analytically and only on tiles that
// straddle valid_len or a chunk edge; tiles wholly in the future are never
// read.  The online softmax stays in registers (row max through quad
// shuffles, m/l/acc in f32); P is rounded to bf16 straight into A
// fragments (the m16n8 C-fragment / m16n8k16 A-fragment identity) and
// O += P V takes V through ldmatrix.trans.
//
// f32 design (CUDA cores; TF32 would break the 2e-5 tolerance): one CTA of
// 128 threads per 64-row query tile; K/V tiles of 64 keys double-buffered by
// cp.async; each thread owns an 8x4 register tile of the scores (float4
// reads along dk) and of the output (float4 reads along the head dim);
// the 16 threads of a half-warp share a row block, so the softmax reduces
// with shuffles and P passes through shared memory within the half-warp.
//
// What still holds it back: mma.sync, not wgmma, and one CTA's 4 warps both
// load and compute (no warp specialisation); at these sizes (16-256 CTAs)
// launch latency and the per-tile barrier are a large share of the time.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDk = 64;       // head dim, compile-time
constexpr int kBk = 64;       // keys per tile
constexpr int kStages = 3;    // bf16 K/V ring depth
constexpr int kWarps = 4;     // bf16: 16 query rows per warp
constexpr float kNeg = -1.0e30f;

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; ok == false writes zeros (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
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

// c += a b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of 16-byte chunk c (0..7) of row r in a 64-wide bf16 tile
// whose chunks are XOR-swizzled by the row
__device__ __forceinline__ int swz(int r, int c) {
  return r * kDk + ((c ^ (r & 7)) << 3);
}

// ------------------------------------------------------------------ bf16
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  int heads, int t_len, Strides qs, Strides ks, Strides vs,
                  Strides os, int chunk, int valid_len, float scale) {
  constexpr int kRows = kWarps * 16;
  constexpr int kThr = kWarps * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // kRows x 64
  bf16* s_kv = s_q + kRows * kDk;                  // kStages x (K, V)

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  const int last_q = min(q0 + kRows, t_len) - 1;
  int kv_end = valid_len;
  if (chunk > 0) kv_end = min(kv_end, (last_q / chunk + 1) * chunk);
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  auto load_kv = [&](int tile, int stage) {
    bf16* sk = s_kv + stage * 2 * kBk * kDk;
    bf16* sv = sk + kBk * kDk;
    for (int c = tid; c < kBk * 8; c += kThr) {
      const int r = c >> 3, cc = c & 7;
      const int kj = tile * kBk + r;
      const bool ok = kj < t_len;
      const long long rk = ok ? kj : 0;
      cp_async16(sk + swz(r, cc), kb + rk * ks.t + cc * 8, ok);
      cp_async16(sv + swz(r, cc), vb + rk * vs.t + cc * 8, ok);
    }
  };

  for (int c = tid; c < kRows * 8; c += kThr) {
    const int r = c >> 3, cc = c & 7;
    const int qi = q0 + r;
    const bool ok = qi < t_len;
    cp_async16(s_q + swz(r, cc), qb + (long long)(ok ? qi : 0) * qs.t + cc * 8,
               ok);
  }
  load_kv(0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  const int g = lane >> 2, qd = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, +8
  uint32_t qa[4][4];
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it == 0) {
      // Q fragments, scaled in bf16 (the TPU kernel's cast point)
      const int mi = lane >> 3;
      const int r = warp * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(qa[kk], s_q + swz(r, kk * 2 + (mi >> 1)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<__nv_bfloat162*>(&qa[kk][e]));
          qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
    }
    const int nxt = it + kStages - 1;
    if (nxt < n_tiles) load_kv(nxt, nxt % kStages);
    cp_async_commit();

    const bf16* sk = s_kv + (it % kStages) * 2 * kBk * kDk;
    const bf16* sv = sk + kBk * kDk;
    const int k0 = it * kBk;

    // S = Q K^T
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    {
      const int mi = lane >> 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j * 16 + (mi >> 1) * 8 + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sk + swz(key, kk * 2 + (mi & 1)));
          mma_bf16(s[2 * j], qa[kk], bk[0], bk[1]);
          mma_bf16(s[2 * j + 1], qa[kk], bk[2], bk[3]);
        }
      }
    }

    // the mask, only where the tile straddles valid_len or a chunk edge
    const bool need_mask =
        k0 + kBk > valid_len ||
        (chunk > 0 && (k0 + kBk - 1) / chunk > q0 / chunk);
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + n * 8 + qd * 2 + (e & 1);
          const int qi = row_a + (e >> 1) * 8;
          bool allow = kj < valid_len;
          if (chunk > 0) allow = allow && (kj / chunk <= qi / chunk);
          if (!allow) s[n][e] = kNeg;
        }
    }

    // online softmax in registers; rows row_a (e = 0, 1) and row_a + 8
    uint32_t pa[4][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      const float alpha = __expf(m_run[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = __expf(s[n][2 * hr] - m_new);
        const float p1 = __expf(s[n][2 * hr + 1] - m_new);
        sum += p0 + p1;
        // p in v's dtype, straight into the A fragments of P V
        pa[n >> 1][(n & 1) * 2 + hr] = pack_bf16(p0, p1);
        acc[n][2 * hr] *= alpha;
        acc[n][2 * hr + 1] *= alpha;
      }
      l_run[hr] = l_run[hr] * alpha + sum;  // this thread's share of the row
      m_run[hr] = m_new;
    }

    // O += P V
    {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sv + swz(key, j * 2 + (mi >> 1)));
          mma_bf16(acc[2 * j], pa[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * j + 1], pa[kk], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = row_a + hr * 8;
    if (qi >= t_len) continue;
    const float inv = 1.f / fmaxf(l, 1e-20f);
    bf16* orow = ob + (long long)qi * os.t + qd * 2;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * hr] * inv, acc[n][2 * hr + 1] * inv);
  }
}

// ------------------------------------------------------------------- f32
constexpr int kF32Rows = 64;
constexpr int kF32Threads = 128;
constexpr int kLd = kDk + 4;  // padded row pitch (floats), 16-byte aligned

__global__ void __launch_bounds__(kF32Threads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int heads, int t_len, Strides qs, Strides ks, Strides vs,
                 Strides os, int chunk, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_q = reinterpret_cast<float*>(smem_raw);  // 64 x kLd, scaled q
  float* s_p = s_q + kF32Rows * kLd;                // 64 x kLd, p
  float* s_kv = s_p + kF32Rows * kLd;               // 2 x (K, V) 64 x kLd

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  const int last_q = min(q0 + kF32Rows, t_len) - 1;
  int kv_end = valid_len;
  if (chunk > 0) kv_end = min(kv_end, (last_q / chunk + 1) * chunk);
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  auto load_kv = [&](int tile, int stage) {
    float* sk = s_kv + stage * 2 * kBk * kLd;
    float* sv = sk + kBk * kLd;
    for (int c = tid; c < kBk * 16; c += kF32Threads) {
      const int r = c >> 4, cc = c & 15;
      const int kj = tile * kBk + r;
      const bool ok = kj < t_len;
      const long long rk = ok ? kj : 0;
      cp_async16(sk + r * kLd + cc * 4, kb + rk * ks.t + cc * 4, ok);
      cp_async16(sv + r * kLd + cc * 4, vb + rk * vs.t + cc * 4, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  for (int e = tid; e < kF32Rows * kDk; e += kF32Threads) {
    const int r = e / kDk, c = e % kDk;
    const int qi = q0 + r;
    s_q[r * kLd + c] = qi < t_len ? qb[(long long)qi * qs.t + c] * scale : 0.f;
  }

  // rows ty + 8 i; score columns tx + 16 j; output columns 4 tx + j
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m_run[i] = kNeg, l_run[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    const float* sk = s_kv + (it & 1) * 2 * kBk * kLd;
    const float* sv = sk + kBk * kLd;
    const int k0 = it * kBk;

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kDk; d += 4) {
      float4 kv4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(s_q + (ty + 8 * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a.x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, kv4[j].w, s[i][j]);
        }
      }
    }

    const bool need_mask =
        k0 + kBk > valid_len ||
        (chunk > 0 && (k0 + kBk - 1) / chunk > q0 / chunk);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + ty + 8 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (need_mask) {
          const int kj = k0 + tx + 16 * j;
          bool allow = kj < valid_len;
          if (chunk > 0) allow = allow && (kj / chunk <= qi / chunk);
          if (!allow) s[i][j] = kNeg;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s_p[(ty + 8 * i) * kLd + tx + 16 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a half-warp reads only the rows it wrote

#pragma unroll 2
    for (int kk = 0; kk < kBk; kk += 4) {
      float4 vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = *reinterpret_cast<const float4*>(sv + (kk + u) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p =
            *reinterpret_cast<const float4*>(s_p + (ty + 8 * i) * kLd + kk);
        const float pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pu[u], vv[u].x, acc[i][0]);
          acc[i][1] = fmaf(pu[u], vv[u].y, acc[i][1]);
          acc[i][2] = fmaf(pu[u], vv[u].z, acc[i][2]);
          acc[i][3] = fmaf(pu[u], vv[u].w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int qi = q0 + ty + 8 * i;
    if (qi >= t_len) continue;
    const float inv = 1.f / fmaxf(l, 1e-20f);
    *reinterpret_cast<float4*>(ob + (long long)qi * os.t + 4 * tx) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                    acc[i][3] * inv);
  }
}

// ---------------------------------------------------------------- launch
// Raises a kernel's dynamic shared-memory limit once per device.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, int heads, int t_len, Strides qs, Strides ks,
                Strides vs, Strides os, int chunk, int valid_len, float scale,
                cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  constexpr int rows = kWarps * 16;
  const int smem = (int)sizeof(bf16) * (rows * kDk + kStages * 2 * kBk * kDk);
  cudaError_t err = allow_smem(flash_bf16_kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + rows - 1) / rows, batch * heads);
  flash_bf16_kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), heads, t_len, qs,
      ks, vs, os, chunk, valid_len, scale);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int heads, int t_len, Strides qs, Strides ks,
               Strides vs, Strides os, int chunk, int valid_len, float scale,
               cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const int smem = (int)sizeof(float) * kLd * (2 * kF32Rows + 4 * kBk);
  cudaError_t err = allow_smem(flash_f32_kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + kF32Rows - 1) / kF32Rows, batch * heads);
  flash_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, t_len, qs,
      ks, vs, os, chunk, valid_len, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, const Strides& s, int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (s.b * elem) % 16 == 0 && (s.h * elem) % 16 == 0 &&
         (s.t * elem) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; every row
// must start on a 16-byte boundary.  Returns 0 on success, else a
// cudaError_t code.
extern "C" int flash_chunk_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int t_len, int head_dim,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int chunk, int valid_len, float scale, void* stream) {
  if (head_dim != kDk || t_len <= 0 || valid_len <= 0 || valid_len > t_len ||
      chunk < 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  const int elem = dtype == 0 ? 4 : 2;
  if (!aligned16(q, qs, elem) || !aligned16(k, ks, elem) ||
      !aligned16(v, vs, elem) || !aligned16(o, os, elem))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, o, batch, heads, t_len, qs, ks, vs, os, chunk,
                      valid_len, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_bf16(q, k, v, o, batch, heads, t_len, qs, ks, vs, os, chunk,
                     valid_len, scale, s);
}
