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
// work is 4*T^2*dk*B*H = 4.1 GFLOP over 8.2 MB (bf16), so the bound is the
// arithmetic: ~4 us in bf16 on tensor cores, ~61 us in f32 on CUDA cores.
//
// Design (simple and correct first): one thread block per
// (batch*head, 64-row query tile); 256 threads; the query tile and one
// 64-key K/V tile at a time are staged in shared memory as f32; each thread
// owns a 4x4 register tile of the scores and of the output accumulator
// (rows ty+16i, columns tx+16j, so shared-memory reads are broadcast or
// conflict-free with the 65-float row pitch); four threads share one row
// for the online softmax.  The key loop stops at valid_len and, for
// chunk > 0, at the end of the last query row's chunk, so wholly-future
// key tiles are never read.  The arithmetic runs on CUDA cores in f32 for
// both dtypes: the kernel sits well above its tensor-core bound in bf16.

#include <atomic>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kDk = 64;       // head dim, compile-time
constexpr int kBq = 64;       // query rows per block
constexpr int kBk = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kLd = kDk + 1;  // padded pitch of Q/K rows (floats)
constexpr int kLdp = kBk + 1; // padded pitch of score rows (floats)
constexpr float kNeg = -1.0e30f;

constexpr size_t kSmemBytes =
    sizeof(float) * (kBq * kLd + kBk * kLd + kBk * kDk + kBq * kLdp + 2 * kBq);

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
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

struct Strides {
  long long b, h, t;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             int heads, int t_len, Strides qs, Strides ks,
                             Strides vs, Strides os, int chunk, int valid_len,
                             float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                  // kBq x kLd, scaled q
  float* s_k = s_q + kBq * kLd;       // kBk x kLd
  float* s_v = s_k + kBk * kLd;       // kBk x kDk
  float* s_p = s_v + kBk * kDk;       // kBq x kLdp, scores then p
  float* s_alpha = s_p + kBq * kLdp;  // kBq, per-row rescale of this tile
  float* s_l = s_alpha + kBq;         // kBq, final row sums

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBq;
  const int tid = threadIdx.x;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  // query tile, scaled in T
  for (int e = tid; e < kBq * kDk; e += kThreads) {
    const int r = e / kDk, c = e % kDk;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < t_len) x = round_to<T>(to_f<T>(qb[qi * qs.t + c]) * scale);
    s_q[r * kLd + c] = x;
  }

  // keys this tile of queries can see
  const int last_q = min(q0 + kBq, t_len) - 1;
  int kv_end = valid_len;
  if (chunk > 0) kv_end = min(kv_end, (last_q / chunk + 1) * chunk);

  // register tiles: rows ty + 16 i, columns tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // softmax ownership: row sm_row, columns sm_part*16 .. +15
  const int sm_row = tid >> 2, sm_part = tid & 3;
  const int sm_q = q0 + sm_row;
  float m_run = kNeg, l_run = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBk) {
    __syncthreads();  // previous tile's readers are done
    for (int e = tid; e < kBk * kDk; e += kThreads) {
      const int r = e / kDk, c = e % kDk;
      const int kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < t_len) {
        kx = to_f<T>(kb[kj * ks.t + c]);
        vx = to_f<T>(vb[kj * vs.t + c]);
      }
      s_k[r * kLd + c] = kx;
      s_v[r * kDk + c] = vx;
    }
    __syncthreads();

    // scores S = (q * scale) K^T, f32 accumulation
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kDk; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_q[(ty + 16 * i) * kLd + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = s_k[(tx + 16 * j) * kLd + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s_p[(ty + 16 * i) * kLdp + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // online softmax, four threads per row
    {
      float* row = s_p + sm_row * kLdp + sm_part * 16;
      float sv[16];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int kj = k0 + sm_part * 16 + c;
        bool allow = kj < valid_len;
        if (chunk > 0) allow = allow && (kj / chunk <= sm_q / chunk);
        sv[c] = allow ? row[c] : kNeg;
        mx = fmaxf(mx, sv[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(sv[c] - m_new);
        sum += p;
        row[c] = round_to<T>(p);  // p in v's dtype for P*V
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sm_part == 0) s_alpha[sm_row] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= al;
    }
#pragma unroll 8
    for (int kk = 0; kk < kBk; ++kk) {
      float p[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_p[(ty + 16 * i) * kLdp + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = s_v[kk * kDk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (sm_part == 0) s_l[sm_row] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= t_len) continue;
    const float inv = 1.f / fmaxf(s_l[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      ob[qi * os.t + c] = from_f<T>(acc[i][j] * inv);
    }
  }
}

// Raises the kernel's dynamic shared-memory limit once per device and dtype
// rather than on every launch.
constexpr int kMaxDevices = 64;

template <typename T>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(flash_chunk_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int t_len, Strides qs, Strides ks, Strides vs,
           Strides os, int chunk, int valid_len, float scale,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + kBq - 1) / kBq, batch * heads);
  flash_chunk_attention_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, t_len, qs, ks, vs,
      os, chunk, valid_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
// Returns 0 on success, else a cudaError_t code.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, batch, heads, t_len, qs, ks, vs, os,
                         chunk, valid_len, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, batch, heads, t_len, qs, ks, vs,
                                 os, chunk, valid_len, scale, s);
  return (int)cudaErrorInvalidValue;
}
