// Paged decode attention over pool pages, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/paged_attention.py,
// paged_attention (_paged_kernel): one new token per sequence attends over
// its KV pages in the pool [slots, T, kv, hd], page p of sequence b at pool
// slot page_table[b, p].  Only tokens below (length // T) * T count (the
// tail page lives in the caller's write buffer); a -1 entry reads slot 0 and
// a slot past the pool reads the last slot, as the TPU kernel and its
// oracle (jnp indexing clamps) do.  GQA: head h reads kv head h / (H / kv).
// The output is acc / max(l, 1e-30) in q's dtype, so a sequence with no
// flushed page gives zeros.
//
// What bounds it: bytes.  Per flushed page a block reads T x hd of k and of
// v for its kv head and does 4 x g x T x hd float32 operations on them: at
// the serving decode shapes (T 16, hd 128, g 4) under 2 operations per
// byte, far below the card's ridge.  At batch 8 with ragged lengths a call
// moves a few MB at most, so it is bound by launch latency first.
//
// Design (adapted from csrc/bridge_attention.cu).  One block per
// (sequence, kv head) for its g = H / kv query heads.  The TPU's scalar
// prefetch of the page table becomes the block's own read of its table row
// and length from device memory (no host copy); the TPU grid's page axis
// becomes a loop over the flushed pages only, in page order: a page at or
// past the flushed count is wholly masked in the TPU kernel and leaves
// (m, l, acc) exactly as they were, so the skip changes no result.  Per
// page: one warp per score (lanes split hd, shuffle reduction), one warp per
// query row for max, exponentials and sum, then every thread folds p @ v
// into its (row, hd) accumulators, all in float32 in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void paged_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ table,
                             const int* __restrict__ lengths,
                             T* __restrict__ out, int h, int kvh, int slots,
                             int t, int hd, int max_pages, float scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int g = h / kvh;
  const int h0 = kh * g;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;

  extern __shared__ float smem[];
  float* q_s = smem;            // [g, hd]
  float* acc = q_s + g * hd;    // [g, hd]
  float* s_s = acc + g * hd;    // [g, t] scores, then probabilities
  float* m_s = s_s + g * t;     // [g]
  float* l_s = m_s + g;         // [g]
  float* a_s = l_s + g;         // [g] rescale of the old state

  const long long row0 = static_cast<long long>(b) * h + h0;
  for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x) {
    q_s[idx] = to_f32(q[row0 * hd + idx]);
    acc[idx] = 0.f;
  }
  for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
    m_s[gi] = kNegInf;
    l_s[gi] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  const int pages = length > 0 ? min(length / t, max_pages) : 0;
  const long long tok = static_cast<long long>(kvh) * hd;  // token stride
  for (int p = 0; p < pages; ++p) {
    int slot = table[static_cast<long long>(b) * max_pages + p];
    slot = slot < 0 ? 0 : min(slot, slots - 1);
    const T* kp = k_pool + static_cast<long long>(slot) * t * tok + kh * hd;
    const T* vp = v_pool + static_cast<long long>(slot) * t * tok + kh * hd;

    for (int e = warp; e < g * t; e += nwarps) {
      const int gi = e / t;
      const T* kr = kp + (e % t) * tok;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += q_s[gi * hd + d] * to_f32(kr[d]);
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) s_s[e] = dot * scale;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += nwarps) {
      float mx = -INFINITY;
      for (int tt = lane; tt < t; tt += 32) mx = fmaxf(mx, s_s[gi * t + tt]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int tt = lane; tt < t; tt += 32) {
        const float e = expf(s_s[gi * t + tt] - m_new);
        s_s[gi * t + tt] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x) {
      const int gi = idx / hd;
      const int d = idx % hd;
      float pv = 0.f;
      for (int tt = 0; tt < t; ++tt)
        pv += s_s[gi * t + tt] * to_f32(vp[tt * tok + d]);
      acc[idx] = acc[idx] * a_s[gi] + pv;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x)
    store(out + row0 * hd + idx, acc[idx] / fmaxf(l_s[idx / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* lengths, void* out, int b, int h,
           int kvh, int slots, int t, int hd, int max_pages, float scale,
           cudaStream_t stream) {
  const int g = h / kvh;
  const size_t smem = sizeof(float) * (2 * g * hd + g * t + 3 * g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_kernel<T><<<dim3(b, kvh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, lengths, static_cast<T*>(out), h,
      kvh, slots, t, hd, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments: dtype (0 = float32, 1 = bfloat16; q, the pools and out
// share it), q, k_pool, v_pool, table, lengths, out, b, h, kvh, slots, t,
// hd, max_pages, scale, stream.
extern "C" int repro_paged_attention(const char* packed) {
  const PackedArgs a{packed};
  const int dtype = a.i32(0);
  const void* q = a.ptr<const void>(1);
  const void* k_pool = a.ptr<const void>(2);
  const void* v_pool = a.ptr<const void>(3);
  const int* table = a.ptr<const int>(4);
  const int* lengths = a.ptr<const int>(5);
  void* out = a.ptr<void>(6);
  const int b = a.i32(7), h = a.i32(8), kvh = a.i32(9), slots = a.i32(10),
            t = a.i32(11), hd = a.i32(12), max_pages = a.i32(13);
  const float scale = a.f32(14);
  void* stream = a.ptr<void>(15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvh < 1 || h % kvh != 0 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, lengths, out, b, h, kvh,
                         slots, t, hd, max_pages, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, b,
                                 h, kvh, slots, t, hd, max_pages, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
