// Streaming decode attention over one round of landed KV pages, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/bridge_attention.py,
// stream_decode_accumulate (_stream_kernel): fold one round of W landed
// pages [W, T, kv, hd] into the per-sequence float32 online-softmax state
// (m, l, acc).  Lane i updates sequence seq_ids[i] when live[i] is set,
// lanes visited in landing order; GQA, every token of a landed page counts.
//
// What bounds it: bytes.  Per live lane a block reads T x hd of k and of v
// for its kv head and does 4 x g x T x hd float32 operations on them: at the
// decode path's T = 16, hd = 128, g = 4 that is under 2 operations per byte,
// far below the card's float32 ridge.  At W = 8 lanes a launch moves half a
// MiB, so it is bound by launch latency first.
//
// Design.  One block per (sequence b, kv head): the TPU's sequential W grid
// dimension becomes a loop over the lanes inside the block, in landing
// order, so the update order is the reference's and no reduction crosses
// blocks.  The block keeps its g = H / kv query rows and their accumulators
// in shared memory in float32; for each lane it owns it computes the g x T
// scores (one warp per score, lanes split hd, shuffle reduction), then one
// warp per query row takes the row's max, exponentials and sum, then every
// thread folds p @ v into its (row, hd) accumulators.  Lanes of other
// sequences are skipped on a block-uniform test, so the barriers stay safe.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ seq_ids,
                              const int* __restrict__ live,
                              const float* __restrict__ m_in,
                              const float* __restrict__ l_in,
                              const float* __restrict__ o_in,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out,
                              float* __restrict__ o_out, int w, int h, int kvh,
                              int t, int hd, float scale) {
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
    acc[idx] = o_in[row0 * hd + idx];
  }
  for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
    m_s[gi] = m_in[row0 + gi];
    l_s[gi] = l_in[row0 + gi];
  }
  __syncthreads();

  const long long tok = static_cast<long long>(kvh) * hd;  // token stride
  for (int i = 0; i < w; ++i) {
    if (seq_ids[i] != b || live[i] == 0) continue;  // uniform over the block
    const T* kp = k + static_cast<long long>(i) * t * tok + kh * hd;
    const T* vp = v + static_cast<long long>(i) * t * tok + kh * hd;

    for (int p = warp; p < g * t; p += nwarps) {
      const int gi = p / t;
      const T* kr = kp + (p % t) * tok;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += q_s[gi * hd + d] * to_f32(kr[d]);
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) s_s[p] = dot * scale;
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
    o_out[row0 * hd + idx] = acc[idx];
  for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
    m_out[row0 + gi] = m_s[gi];
    l_out[row0 + gi] = l_s[gi];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* seq_ids,
           const int* live, const float* m_in, const float* l_in,
           const float* o_in, float* m_out, float* l_out, float* o_out, int b,
           int h, int kvh, int w, int t, int hd, float scale,
           cudaStream_t stream) {
  const int g = h / kvh;
  const size_t smem = sizeof(float) * (2 * g * hd + g * t + 3 * g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stream_kernel<T><<<dim3(b, kvh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seq_ids, live, m_in, l_in, o_in, m_out, l_out,
      o_out, w, h, kvh, t, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments: dtype (0 = float32, 1 = bfloat16; q, k and v share
// it), q, k, v, seq_ids, live, m_in, l_in, o_in, m_out, l_out, o_out, b, h,
// kvh, w, t, hd, scale, stream.
extern "C" int repro_stream_decode_accumulate(const char* packed) {
  const PackedArgs a{packed};
  const int dtype = a.i32(0);
  const void* q = a.ptr<const void>(1);
  const void* k = a.ptr<const void>(2);
  const void* v = a.ptr<const void>(3);
  const int* seq_ids = a.ptr<const int>(4);
  const int* live = a.ptr<const int>(5);
  const float* m_in = a.ptr<const float>(6);
  const float* l_in = a.ptr<const float>(7);
  const float* o_in = a.ptr<const float>(8);
  float* m_out = a.ptr<float>(9);
  float* l_out = a.ptr<float>(10);
  float* o_out = a.ptr<float>(11);
  const int b = a.i32(12), h = a.i32(13), kvh = a.i32(14), w = a.i32(15),
            t = a.i32(16), hd = a.i32(17);
  const float scale = a.f32(18);
  void* stream = a.ptr<void>(19);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, seq_ids, live, m_in, l_in, o_in, m_out,
                         l_out, o_out, b, h, kvh, w, t, hd, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, seq_ids, live, m_in, l_in, o_in,
                                 m_out, l_out, o_out, b, h, kvh, w, t, hd,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
