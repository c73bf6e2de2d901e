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
// Design (simple and correct first): one thread block per wavefront row,
// since rows are independent through all L layers.  The row's activation
// (cf x ch), the LayerNorm output, q and the attention output (or the FF
// hidden layer, or the prologue's inputs) live in shared memory as f32
// holding T-rounded values.  Each weight is read from global memory (it
// stays in the 50 MB L2 while the rows' blocks read it): a thread owns one
// output column at a time and keeps 20 rows of its accumulators in
// registers, so one pass over W serves 20 query rows.  The chunk's K/V go
// straight to the ring in global memory; a __syncthreads() then makes them
// visible to the block's own reads of the ring.  K and V are staged through
// shared memory in 64-slot tiles.  Everything runs on CUDA cores in f32:
// twenty blocks leave most of the 132 SMs idle, which a later PR addresses
// (clusters splitting the columns, wgmma, TMA).

#include <atomic>
#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 20;       // query rows per register tile (cf is padded)
constexpr int kTile = 64;     // ring slots per K/V tile
constexpr float kNeg = -1.0e10f;
constexpr int kMaxSmem = 232448;

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

template <typename T>
struct Params {
  const T *x, *mt, *cc1, *cc2;
  const T *b1k, *b1b, *b1ls, *b1lb, *mlpk, *mlpb;
  const T *b2k, *b2b, *b2ls, *b2lb, *resk, *resb;
  const T *n1s, *n1b, *qkvk, *outk, *outb, *n3s, *n3b;
  const T *ffpk, *ffpb, *ffok, *ffob;
  T* rings;  // read after written by the same block: no __restrict__, no ld.nc
  T *x_out, *cc1_out, *cc2_out;
  const int* scal;  // (3, rows): nd_mask, rot, enable
  int rows, cf, cfp, cin, ch, tdim, heads, dk, ff, n_layers, rp, shared,
      offset, big, smem_floats;
  float scale;
};

// out(r, n, acc) with acc = sum_t sum_k A[(r + t) * lda + k] W[t][k][n]
// (W row pitch ldw, tap pitch K * ldw) for rows r < rows (a multiple of
// kRB) and columns n < N.  A lies in shared memory (f32), W in global
// memory (T).  K and lda are multiples of 4.
template <typename T, typename Epi>
__device__ __forceinline__ void matmul(const float* A, int lda, int rows,
                                       const T* W, int K, int ldw, int N,
                                       int taps, Epi epi) {
  for (int n = threadIdx.x; n < N; n += kThreads) {
    for (int r0 = 0; r0 < rows; r0 += kRB) {
      float acc[kRB];
#pragma unroll
      for (int r = 0; r < kRB; ++r) acc[r] = 0.f;
      for (int t = 0; t < taps; ++t) {
        const float* a0 = A + (r0 + t) * lda;
        const T* w0 = W + (size_t)t * K * ldw + n;
#pragma unroll 2
        for (int k = 0; k < K; k += 4) {
          const float w_0 = to_f<T>(w0[(size_t)(k + 0) * ldw]);
          const float w_1 = to_f<T>(w0[(size_t)(k + 1) * ldw]);
          const float w_2 = to_f<T>(w0[(size_t)(k + 2) * ldw]);
          const float w_3 = to_f<T>(w0[(size_t)(k + 3) * ldw]);
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
      for (int r = 0; r < kRB; ++r) epi(r0 + r, n, acc[r]);
    }
  }
}

// flax LayerNorm over rows of n features: f32 statistics, fast variance
// clipped at 0, eps 1e-5, output rounded to T; in may equal out.
template <typename T>
__device__ void layer_norm(const float* in, float* out, int rows, int n,
                           const T* scale, const T* bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const float* x = in + r * n;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float v = x[c];
      s += v;
      s2 += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    const float inv = 1.f / sqrtf(var + 1e-5f);
    for (int c = lane; c < n; c += 32)
      out[r * n + c] =
          rnd<T>((x[c] - mean) * (inv * to_f<T>(scale[c])) + to_f<T>(bias[c]));
  }
}

template <typename T>
__device__ void mish_inplace(float* x, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const float v = x[i];
    const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    x[i] = rnd<T>(v * tanhf(sp));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_tf_group_kernel(const Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int cf = p.cf, cfp = p.cfp, ch = p.ch, cin = p.cin, rp = p.rp;
  const int dk = p.dk, inner = p.heads * dk, d2 = 2 * inner, ff = p.ff;
  const int sp = cfp + 1;  // score pitch (odd: conflict-free columns)
  const int tp = dk + 1;   // K/V tile pitch

  float* s_x = smem;                    // cfp x ch, the resident activation
  float* s_h = s_x + cfp * ch;          // cfp x ch, LayerNorm output
  float* s_big = s_h + cfp * ch;        // q | attention out, FF hidden, or
                                        // the prologue's xf | hf
  float* s_s = s_big + p.big;           // rp x sp scores / weights
  float* s_t = s_s + rp * sp;           // kTile x tp K or V tile
  float* s_p = s_t + kTile * tp;        // ch, time-MLP projection

  // every buffer starts at zero, so the padded rows (cf..cfp) stay finite
  for (int e = tid; e < p.smem_floats; e += kThreads) smem[e] = 0.f;
  __syncthreads();

  const int nd = p.scal[row];
  const int rot = p.scal[p.rows + row];
  const bool en = p.scal[2 * p.rows + row] != 0;
  int off = p.shared ? p.offset : (nd - cf) % rp;
  if (off < 0) off += rp;
  auto valid = [&](int slot) {
    int m = (slot - rot) % rp;
    if (m < 0) m += rp;
    return m < nd;
  };

  // ---------------------------------------------------------- prologue
  {
    float* xf = s_big;                  // (cfp + 2) x cin
    float* hf = s_big + (cfp + 2) * cin;  // (cfp + 2) x ch
    const T* xg = p.x + (size_t)row * cf * cin;
    const T* c1 = p.cc1 + (size_t)row * 2 * cin;
    for (int e = tid; e < (cfp + 2) * cin; e += kThreads) {
      const int r = e / cin, c = e % cin;
      float v = 0.f;
      if (r < 2) v = to_f<T>(c1[r * cin + c]);
      else if (r - 2 < cf) v = to_f<T>(xg[(r - 2) * cin + c]);
      xf[e] = v;
    }
    __syncthreads();
    for (int e = tid; e < 2 * cin; e += kThreads)
      p.cc1_out[(size_t)row * 2 * cin + e] = from_f<T>(xf[cf * cin + e]);

    matmul<T>(xf, cin, cfp, p.b1k, cin, ch, ch, 3,
              [&](int r, int n, float acc) {
                s_h[r * ch + n] = rnd<T>(rnd<T>(acc) + to_f<T>(p.b1b[n]));
              });
    // time-MLP projection of this row
    const T* mt = p.mt + (size_t)row * p.tdim;
    for (int n = tid; n < ch; n += kThreads) {
      float acc = 0.f;
      for (int k = 0; k < p.tdim; ++k)
        acc = fmaf(to_f<T>(mt[k]), to_f<T>(p.mlpk[(size_t)k * ch + n]), acc);
      s_p[n] = rnd<T>(rnd<T>(acc) + to_f<T>(p.mlpb[n]));
    }
    __syncthreads();
    layer_norm<T>(s_h, s_h, cfp, ch, p.b1ls, p.b1lb);
    __syncthreads();
    mish_inplace<T>(s_h, cfp * ch);
    __syncthreads();
    const T* c2 = p.cc2 + (size_t)row * 2 * ch;
    for (int e = tid; e < (cfp + 2) * ch; e += kThreads) {
      const int r = e / ch, c = e % ch;
      hf[e] = r < 2 ? to_f<T>(c2[r * ch + c])
                    : rnd<T>(s_h[(r - 2) * ch + c] + s_p[c]);
    }
    __syncthreads();
    for (int e = tid; e < 2 * ch; e += kThreads)
      p.cc2_out[(size_t)row * 2 * ch + e] = from_f<T>(hf[cf * ch + e]);
    matmul<T>(hf, ch, cfp, p.b2k, ch, ch, ch, 3,
              [&](int r, int n, float acc) {
                s_x[r * ch + n] = rnd<T>(rnd<T>(acc) + to_f<T>(p.b2b[n]));
              });
    __syncthreads();
    layer_norm<T>(s_x, s_x, cfp, ch, p.b2ls, p.b2lb);
    __syncthreads();
    mish_inplace<T>(s_x, cfp * ch);
    __syncthreads();
    // 1x1 residual of the group input (xf without its two cache frames)
    matmul<T>(xf + 2 * cin, cin, cfp, p.resk, cin, ch, ch, 1,
              [&](int r, int n, float acc) {
                const float res = rnd<T>(rnd<T>(acc) + to_f<T>(p.resb[n]));
                s_x[r * ch + n] = rnd<T>(s_x[r * ch + n] + res);
              });
    __syncthreads();
  }

  // ------------------------------------------------------------ layers
  float* s_q = s_big;                 // cfp x inner
  float* s_a = s_big + cfp * inner;   // cfp x inner
  float* s_f = s_big;                 // cfp x ff
  for (int l = 0; l < p.n_layers; ++l) {
    const T* qkvk = p.qkvk + (size_t)l * ch * 3 * inner;
    T* ring = p.rings + ((size_t)l * p.rows + row) * rp * d2;

    layer_norm<T>(s_x, s_h, cfp, ch, p.n1s + l * ch, p.n1b + l * ch);
    __syncthreads();
    matmul<T>(s_h, ch, cfp, qkvk, ch, 3 * inner, inner, 1,
              [&](int r, int n, float acc) { s_q[r * inner + n] = rnd<T>(acc); });
    matmul<T>(s_h, ch, cfp, qkvk + inner, ch, 3 * inner, d2, 1,
              [&](int r, int n, float acc) {
                if (en && r < cf) {
                  int slot = off + r;
                  if (slot >= rp) slot -= rp;
                  ring[(size_t)slot * d2 + n] = from_f<T>(acc);
                }
              });
    __syncthreads();  // the chunk's ring writes are visible to the block

    for (int h = 0; h < p.heads; ++h) {
      // scores: s_s[slot][q] for every ring slot
      for (int t0 = 0; t0 < rp; t0 += kTile) {
        const int nt = min(kTile, rp - t0);
        __syncthreads();
        for (int e = tid; e < nt * dk; e += kThreads) {
          const int j = e / dk, d = e % dk;
          s_t[j * tp + d] = to_f<T>(ring[(size_t)(t0 + j) * d2 + h * dk + d]);
        }
        __syncthreads();
        for (int e = tid; e < cf * kTile; e += kThreads) {
          const int q = e / kTile, j = e % kTile;
          if (j >= nt) continue;
          const float* qr = s_q + q * inner + h * dk;
          const float* kr = s_t + j * tp;
          float acc = 0.f;
          for (int d = 0; d < dk; ++d) acc = fmaf(qr[d], kr[d], acc);
          const int slot = t0 + j;
          s_s[slot * sp + q] = valid(slot) ? rnd<T>(rnd<T>(acc) * p.scale)
                                           : rnd<T>(kNeg);
        }
      }
      __syncthreads();
      // softmax over the slots, one warp per query column
      {
        const int warp = tid / 32, lane = tid % 32;
        for (int q = warp; q < cf; q += kWarps) {
          float mx = -INFINITY;
          for (int s = lane; s < rp; s += 32) mx = fmaxf(mx, s_s[s * sp + q]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          float sum = 0.f;
          for (int s = lane; s < rp; s += 32) sum += expf(s_s[s * sp + q] - mx);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          for (int s = lane; s < rp; s += 32) {
            const float pr = rnd<T>(expf(s_s[s * sp + q] - mx) / sum);
            s_s[s * sp + q] = valid(s) ? pr : 0.f;
          }
        }
      }
      // A V, accumulated in f32 in s_a across the V tiles
      for (int e = tid; e < cf * dk; e += kThreads)
        s_a[(e / dk) * inner + h * dk + e % dk] = 0.f;
      for (int t0 = 0; t0 < rp; t0 += kTile) {
        const int nt = min(kTile, rp - t0);
        __syncthreads();
        for (int e = tid; e < nt * dk; e += kThreads) {
          const int j = e / dk, d = e % dk;
          s_t[j * tp + d] =
              to_f<T>(ring[(size_t)(t0 + j) * d2 + inner + h * dk + d]);
        }
        __syncthreads();
        for (int e = tid; e < cf * dk; e += kThreads) {
          const int q = e / dk, d = e % dk;
          float* o = s_a + q * inner + h * dk + d;
          float acc = *o;
          for (int j = 0; j < nt; ++j)
            acc = fmaf(s_s[(t0 + j) * sp + q], s_t[j * tp + d], acc);
          *o = acc;
        }
      }
      for (int e = tid; e < cf * dk; e += kThreads) {
        float* o = s_a + (e / dk) * inner + h * dk + e % dk;
        *o = rnd<T>(*o);
      }
    }
    __syncthreads();

    matmul<T>(s_a, inner, cfp, p.outk + (size_t)l * inner * ch, inner, ch, ch,
              1, [&](int r, int n, float acc) {
                float* x = s_x + r * ch + n;
                *x = rnd<T>(rnd<T>(*x + rnd<T>(acc)) +
                            to_f<T>(p.outb[l * ch + n]));
              });
    __syncthreads();
    layer_norm<T>(s_x, s_h, cfp, ch, p.n3s + l * ch, p.n3b + l * ch);
    __syncthreads();
    matmul<T>(s_h, ch, cfp, p.ffpk + (size_t)l * ch * ff, ch, ff, ff, 1,
              [&](int r, int n, float acc) {
                const float v = rnd<T>(rnd<T>(acc) +
                                       to_f<T>(p.ffpb[(size_t)l * ff + n]));
                s_f[r * ff + n] =
                    rnd<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
              });
    __syncthreads();
    matmul<T>(s_f, ff, cfp, p.ffok + (size_t)l * ff * ch, ff, ch, ch, 1,
              [&](int r, int n, float acc) {
                float* x = s_x + r * ch + n;
                *x = rnd<T>(rnd<T>(*x + rnd<T>(acc)) +
                            to_f<T>(p.ffob[l * ch + n]));
              });
    __syncthreads();
  }

  T* xo = p.x_out + (size_t)row * cf * ch;
  for (int e = tid; e < cf * ch; e += kThreads) xo[e] = from_f<T>(s_x[e]);
}

// Raises the kernel's dynamic shared-memory limit once per device and dtype.
constexpr int kMaxDevices = 64;

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

template <typename T>
int launch(void* const* ptrs, int rows, int cf, int cin, int ch, int tdim,
           int heads, int dk, int ff, int n_layers, int rp, int shared,
           int offset, cudaStream_t stream) {
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
  const int inner = heads * dk;
  const int cfp = (cf + kRB - 1) / kRB * kRB;
  int big = 2 * cfp * inner;
  if (cfp * ff > big) big = cfp * ff;
  if ((cfp + 2) * (cin + ch) > big) big = (cfp + 2) * (cin + ch);
  big = (big + 3) / 4 * 4;
  p.rows = rows; p.cf = cf; p.cfp = cfp; p.cin = cin; p.ch = ch;
  p.tdim = tdim; p.heads = heads; p.dk = dk; p.ff = ff;
  p.n_layers = n_layers; p.rp = rp; p.shared = shared; p.offset = offset;
  p.big = big;
  p.scale = 1.f / sqrtf((float)dk);
  const size_t smem = sizeof(float) * ((size_t)2 * cfp * ch + big +
                                       (size_t)rp * (cfp + 1) +
                                       (size_t)kTile * (dk + 1) + ch);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  p.smem_floats = (int)(smem / sizeof(float));
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return (int)err;
  fused_tf_group_kernel<T><<<rows, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: x, mt, cc1, cc2, the 12 resnet weights, the 11 stacked transformer
// weights (fused_block.py's RES_KEYS and TF_KEYS order), rings, x_out,
// cc1_out, cc2_out, scal.  dtype: 0 = float32, 1 = bfloat16.
// Returns 0 on success, else a cudaError_t code.
extern "C" int fused_tf_group(void* const* ptrs, int dtype, int rows, int cf,
                              int cin, int ch, int tdim, int heads,
                              int head_dim, int ff, int n_layers, int rp,
                              int shared, int offset, void* stream) {
  if (rows <= 0 || cf <= 0 || cf > rp || cin % 4 || ch % 4 || tdim % 4 ||
      (heads * head_dim) % 4 || ff % 4 || n_layers <= 0 || offset < 0 ||
      offset >= rp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ptrs, rows, cf, cin, ch, tdim, heads, head_dim, ff,
                         n_layers, rp, shared, offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ptrs, rows, cf, cin, ch, tdim, heads,
                                 head_dim, ff, n_layers, rp, shared, offset, s);
  return (int)cudaErrorInvalidValue;
}
