// Flash attention, forward, float32, on the CUDA cores (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py,
// flash_attention (_flash_fwd_kernel), for float32 inputs: blockwise
// online-softmax attention of q [B, Sq, H, hd] over k, v [B, Sk, kv, hd]
// with GQA (head h reads kv head h / (H / kv)), masks on absolute positions
// (q_pos = row + q_offset; k_pos < Sk; causal: k_pos <= q_pos; window > 0:
// q_pos - k_pos < window), the softmax state (m, l, acc) in float32,
// acc / max(l, 1e-30) at the end and the output in q's dtype.  As in the
// TPU kernel (flash_attention.py lines 44-46) every product is a float32
// product: the reference's float32 limit (2e-5) is beyond TF32 or bf16
// tensor-core tiles, so float32 stays on the CUDA cores.  bf16 inputs take
// the tensor-core kernel of flash_attention_wgmma.cu.
//
// What bounds it: operations.  At the sequence forward's shapes (B 8,
// S 1024, H 32, kv 8, hd 128, causal) the two products take
// 4 B H hd S(S+1)/2 = 68.8 GFLOP on 168 MB of q, k, v and out: against
// bf16 tensor cores (989 TFLOP/s) that is 0.070 ms, and the bytes give
// 0.050 ms.  In float32 on the CUDA cores (67 TFLOP/s at most) the same
// work takes 1.0 ms at best.
//
// Design.  One block per (batch, kv head, tile of 64 query rows), where the
// rows of a kv head are its g = H / kv query heads at every position,
// flattened position-major (row = pos * g + head in group): the 64 rows are
// 64 / g positions of all g heads, so every K/V tile staged in shared
// memory serves the g heads that read it.  The TPU grid's innermost axis
// (key blocks, carrying (m, l, acc) in VMEM) becomes a loop over key tiles
// of 32 inside the block, in increasing order.  Tiles that lie wholly
// above the causal diagonal or wholly below the window of every row of the
// block are skipped: in the TPU kernel such a tile leaves (m, l, acc)
// exactly as they were, so the skip changes no result.  The ragged edges
// (Sq * g and Sk not multiples of the tiles) are masked here, nothing is
// padded.  256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i
// (i < 4), the score columns tx + 16 j (j < 2) and the output columns
// tx + 16 j (j < NJ = ceil(hd / 16)); its rows' m and l live in its
// registers (each held by the 16 threads of a half-warp, reduced with
// shuffles), its 4 x NJ accumulators too.  Q (64 x hd), K (32 x hd) and
// V (32 x hd) tiles are staged in shared memory with 16-byte vector loads
// from device memory; the score loop reads them as float4.
// At hd = 256 the block takes 141 KB of shared memory (hence the opt-in
// above 48 KB).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int kRows = 64;      // query rows (position, head) per block
constexpr int kKeys = 32;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;  // elements in 16 bytes
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// One 16-byte vector of T at src (16-byte aligned), widened into dst.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i) dst[i] = to_f32(e[i]);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int sq,
                     int sk, int h, int kvh, int hd, int causal, int window,
                     int q_offset, float scale) {
  constexpr int kVN = Vec<T>::kN;
  const int g = h / kvh;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_total = sq * g;
  const int r0 = blockIdx.x * kRows;
  const int stride = hd + 4;  // Q and K rows: floats, 16-byte aligned
  const int vecs = hd / kVN;  // 16-byte vectors per row

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][stride]
  float* ks = qs + kRows * stride;              // [kKeys][stride]
  float* vs = ks + kKeys * stride;              // [kKeys][hd]
  float* ps = vs + kKeys * hd;                  // [kRows][kKeys + 1]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int idx = tid; idx < kRows * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int d = (idx % vecs) * kVN;
    const int row = r0 + r;
    float* dst = qs + r * stride + d;
    if (row < rows_total) {
      const long long at =
          (static_cast<long long>(b) * sq + row / g) * h + kh * g + row % g;
      load16(q + at * hd + d, dst);
    } else {
#pragma unroll
      for (int i = 0; i < kVN; ++i) dst[i] = 0.f;
    }
  }

  int qpos[4];
  bool live[4];
  float m_r[4], l_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    live[i] = row < rows_total;
    qpos[i] = row / g + q_offset;
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Key tiles with any visible (row, key) pair of this block.
  const int last = min(r0 + kRows, rows_total) - 1;
  const int p_lo = r0 / g + q_offset;
  const int p_hi = last / g + q_offset;
  const int k_end = causal ? min(sk, p_hi + 1) : sk;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kKeys * vecs; idx += kThreads) {
      const int c = idx / vecs;
      const int d = (idx % vecs) * kVN;
      const int key = k0 + c;
      float* kd = ks + c * stride + d;
      float* vd = vs + c * hd + d;
      if (key < sk) {
        const long long at =
            ((static_cast<long long>(b) * sk + key) * kvh + kh) * hd + d;
        load16(k + at, kd);
        load16(v + at, vd);
      } else {
#pragma unroll
        for (int i = 0; i < kVN; ++i) kd[i] = vd[i] = 0.f;
      }
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * stride + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * stride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax, one row at a time over the 16 threads that hold it.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool vis[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        bool ok = live[i] && key < sk;
        if (causal) ok = ok && key <= qpos[i];
        if (window > 0) ok = ok && qpos[i] - key < window;
        vis[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kKeys; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (kKeys + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < hd ? vs[c * hd + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int row = r0 + ty + 16 * i;
    const long long at =
        (static_cast<long long>(b) * sq + row / g) * h + kh * g + row % g;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(o + at * hd + d, acc[i][j] / l);
    }
  }
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o, int b,
              int sq, int sk, int h, int kvh, int hd, int causal, int window,
              int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kRows + kKeys) * (hd + 4) +
                                       kKeys * hd + kRows * (kKeys + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int g = h / kvh;
  const dim3 grid((sq * g + kRows - 1) / kRows, kvh, b);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kvh, hd,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kvh, int hd, int causal, int window,
           int q_offset, float scale, cudaStream_t s) {
  const int nj = (hd + 15) / 16;
  if (nj <= 2)
    return launch_nj<T, 2>(q, k, v, o, b, sq, sk, h, kvh, hd, causal, window,
                           q_offset, scale, s);
  if (nj <= 4)
    return launch_nj<T, 4>(q, k, v, o, b, sq, sk, h, kvh, hd, causal, window,
                           q_offset, scale, s);
  if (nj <= 8)
    return launch_nj<T, 8>(q, k, v, o, b, sq, sk, h, kvh, hd, causal, window,
                           q_offset, scale, s);
  if (nj <= 12)
    return launch_nj<T, 12>(q, k, v, o, b, sq, sk, h, kvh, hd, causal,
                            window, q_offset, scale, s);
  if (nj <= 16)
    return launch_nj<T, 16>(q, k, v, o, b, sq, sk, h, kvh, hd, causal,
                            window, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Packed arguments: q, k, v, o (float32, every pointer 16-byte aligned),
// b, sq, sk, h, kvh, hd (a multiple of 8 up to 256), causal, window,
// q_offset, scale, stream.
extern "C" int repro_flash_attention_f32(const char* packed) {
  const PackedArgs a{packed};
  const void* q = a.ptr<const void>(0);
  const void* k = a.ptr<const void>(1);
  const void* v = a.ptr<const void>(2);
  void* o = a.ptr<void>(3);
  const int b = a.i32(4), sq = a.i32(5), sk = a.i32(6), h = a.i32(7),
            kvh = a.i32(8), hd = a.i32(9), causal = a.i32(10),
            window = a.i32(11), q_offset = a.i32(12);
  const float scale = a.f32(13);
  void* stream = a.ptr<void>(14);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd < 8 || hd > 256 || kvh < 1 || h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(q, k, v, o, b, sq, sk, h, kvh, hd, causal, window,
                       q_offset, scale, s);
}
