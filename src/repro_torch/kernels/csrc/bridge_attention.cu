// Streaming decode attention over one round of landed KV pages, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/bridge_attention.py,
// stream_decode_accumulate (_stream_kernel): fold one round of W landed
// pages [W, T, kv, hd] into the per-sequence float32 online-softmax state
// (m, l, acc).  Lane i updates sequence seq_ids[i] when live[i] is set,
// lanes in landing order; GQA, every token of a landed page counts.
//
// What bounds it: latency.  Per live lane a block reads T x hd of k and of
// v for its kv head and does 4 x g x T x hd float32 operations on them:
// at the decode path's T = 16, hd = 128, g = 4 under 2 operations a byte,
// far below the card's float32 ridge.  A 1-node round (W = 8 lanes, all of
// one sequence) moves half a MiB, an 8-node round (W = 64, 8 sequences) 4
// MiB; at 3.35 TB/s that is 0.2-1.4 us, so the launch and the round trips
// to memory set the time.  And most rounds fold nothing: in the decode
// path a round's lanes belong to few sequences, and a round past every
// sequence's flushed pages is all FREE.
//
// Design.  One block per (kv head, sequence), 8 warps.  A block
//   1. issues the copy of its state rows (o: 16-byte cp.async; m, l) and,
//      beside it, reads seq_ids and live once, each warp all of them (64 a
//      trip) with a ballot that finds the block's own lanes in landing
//      order, so no barrier stands before the exit of step 2;
//   2. with no lane of its own writes the state back and exits: it never
//      reads q or a page;
//   3. else gives its lanes to its warps, one lane a warp (lanes past the
//      8th loop in batches of 8), each warp issuing its page's K and V
//      slices while the block loads q, and folding the page into its
//      partial with the shared fold (csrc/decode_fold.cuh);
//   4. merges the batch's partials into the state in landing order
//      (merge_partials) and, after the last batch, writes (m, l, o) once.
// The grid is every (kv head, sequence) pair and each block finds its own
// lanes, so no host work depends on the round's ids: the launch stays a
// runtime-input launch that a CUDA graph can replay.  The landing-order
// merge keeps a sequence's lanes in one block; a block of 4 warps was
// measured a little faster on all-FREE rounds and much slower on a round
// of 8 live lanes, so the block has 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "decode_fold.cuh"
#include "packed_args.cuh"

namespace {

using namespace decode_fold;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// The lanes of [0, w) that fold into sequence b (seq_ids[i] == b and
// live[i] != 0); returns how many.  Every warp reads all the ids itself, 64
// a trip, and ballots its way through them, so no barrier is needed: in
// landing order, the block's own lane j goes to warp j % nwarps in batch
// j / nwarps, and the warp's lane 0 writes its lanes into mine[batch].
__device__ int own_lanes(const int* __restrict__ seq_ids,
                         const int* __restrict__ live, int w, int b,
                         int* mine) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int total = 0;
  for (int base = 0; base < w; base += 64) {
    int s[2] = {-1, -1}, lv[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = base + 32 * h + lane;
      if (i < w) {
        s[h] = __ldg(seq_ids + i);
        lv[h] = __ldg(live + i);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned mask = __ballot_sync(0xffffffffu, s[h] == b && lv[h]);
      const int count = __popc(mask);
      // this warp's lanes j = warp + k * nwarps in [total, total + count)
      int k = total <= warp ? 0 : (total - warp + nwarps - 1) / nwarps;
      for (int j = warp + k * nwarps; j < total + count; j += nwarps, ++k)
        if (lane == 0)
          mine[k] = base + 32 * h + __fns(mask, 0, j - total + 1);
      total += count;
    }
  }
  __syncwarp();
  return total;
}

// A warp's share of the block's lanes, in batches.
__host__ __device__ constexpr int batches(int w, int nwarps) {
  return (w + nwarps - 1) / nwarps;
}

// Floats of the block's shared memory before the warps' parts: the state
// record, a second (m, l) for the merges to write, q as float32, then each
// warp's lane list (ints; nwarps lists of batches(w, nwarps) fit in
// w + kWarps).
__host__ __device__ constexpr int head_floats(int g, int hd, int w) {
  return record_floats(g, hd) + pad4(2 * g) + g * hd + pad4(w + kWarps);
}

// kG: the query rows of a kv head for the decode path's pages (T 16, hd
// 128, g = kG: csrc/decode_fold.cuh, fold_page16), or 0 for any shape
// (fold_page).
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads, 1)
    stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ seq_ids,
                  const int* __restrict__ live, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ o_in, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ o_out, int w,
                  int h, int kvh, int t, int hd, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / kvh;
  const int gh = g * hd;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ __align__(16) float smem[];
  float* state = smem;                              // record [o][m][l]
  float* ml_alt = state + record_floats(g, hd);     // [m][l]
  float* q_s = ml_alt + pad4(2 * g);                // [g, hd]
  int* mine = reinterpret_cast<int*>(q_s + gh) + warp * batches(w, nwarps);
  float* parts = smem + head_floats(g, hd, w);      // a warp's part each
  const int stride = warp_floats(g, hd, t, sizeof(T), 1);
  float* rec = parts + warp * stride;
  float* s_w = rec + record_floats(g, hd);
  T* kb = reinterpret_cast<T*>(s_w + pad4(g * t + 2 * g));
  T* vb = kb + t * hd;

  // 1. the state rows, in flight while the ids are read
  const long long row0 = static_cast<long long>(b) * h + kh * g;
  for (int i = threadIdx.x; i < gh / 4; i += blockDim.x)
    cp_async16(state + 4 * i, o_in + row0 * hd + 4 * i);
  for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
    cp_async4(state + gh + gi, m_in + row0 + gi);
    cp_async4(state + gh + g + gi, l_in + row0 + gi);
  }
  cp_async_commit();
  const int n_live = own_lanes(seq_ids, live, w, b, mine);

  float* ml = state + gh;                           // the state's (m, l)
  if (n_live > 0) {
    // 3. a lane a warp: the page in flight while q loads, then the fold
    const long long tok = static_cast<long long>(kvh) * hd;
    const long long page = static_cast<long long>(t) * tok;
    for (int base = 0; base < n_live; base += nwarps) {
      const int nb = min(nwarps, n_live - base);
      if (warp < nb) {
        const long long off = mine[base / nwarps] * page + kh * hd;
        issue_page(kb, vb, k + off, v + off, t, hd, tok, lane);
        cp_async_commit();
      }
      if (base == 0) load_rows(q_s, q + row0 * hd, gh);
      cp_async_wait<0>();
      __syncthreads();
      if (warp < nb) {
        if constexpr (kG > 0)
          fold_page16<T, kG>(q_s, kb, vb, s_w, rec, scale, true, lane);
        else
          fold_page<T>(q_s, kb, vb, s_w, rec, g, t, hd, scale, true, lane);
      }
      __syncthreads();
      // 4. the batch's partials into the state, in landing order
      float* ml_next = ml == ml_alt ? state + gh : ml_alt;
      merge_partials(state, ml, ml + g, ml_next, ml_next + g, parts, stride,
                     nb, g, hd);
      ml = ml_next;
    }
  } else {
    cp_async_wait<0>();   // 2. each thread writes back what it copied
  }
  for (int i = threadIdx.x; i < gh / 4; i += blockDim.x)
    reinterpret_cast<float4*>(o_out + row0 * hd)[i] =
        reinterpret_cast<const float4*>(state)[i];
  for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
    m_out[row0 + gi] = ml[gi];
    l_out[row0 + gi] = ml[g + gi];
  }
}

template <typename T, int kG>
int launch_shape(const void* q, const void* k, const void* v,
                 const int* seq_ids, const int* live, const float* m_in,
                 const float* l_in, const float* o_in, float* m_out,
                 float* l_out, float* o_out, int b, int h, int kvh, int w,
                 int t, int hd, float scale, cudaStream_t stream) {
  const int g = h / kvh;
  const size_t head = sizeof(float) * head_floats(g, hd, w);
  const size_t per_warp = sizeof(float) * warp_floats(g, hd, t, sizeof(T), 1);
  if (head + per_warp > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(
      std::min<size_t>(kWarps, (kSmemLimit - head) / per_warp));
  const size_t smem = head + warps * per_warp;
  static size_t allowed = 0;
  const cudaError_t err = allow_smem(stream_kernel<T, kG>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_kernel<T, kG><<<dim3(kvh, b), 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seq_ids, live, m_in, l_in, o_in, m_out, l_out,
      o_out, w, h, kvh, t, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* seq_ids,
           const int* live, const float* m_in, const float* l_in,
           const float* o_in, float* m_out, float* l_out, float* o_out, int b,
           int h, int kvh, int w, int t, int hd, float scale,
           cudaStream_t stream) {
  if (t == 16 && hd == 128 && h == 4 * kvh)
    return launch_shape<T, 4>(q, k, v, seq_ids, live, m_in, l_in, o_in,
                              m_out, l_out, o_out, b, h, kvh, w, t, hd, scale,
                              stream);
  return launch_shape<T, 0>(q, k, v, seq_ids, live, m_in, l_in, o_in, m_out,
                            l_out, o_out, b, h, kvh, w, t, hd, scale, stream);
}

}  // namespace

// Packed arguments: dtype (0 = float32, 1 = bfloat16; q, k and v share
// it), q, k, v, seq_ids, live, m_in, l_in, o_in, m_out, l_out, o_out, b, h,
// kvh, w, t, hd, scale, stream.  q, k, v and o 16-byte aligned, hd x the
// element size a multiple of 16 bytes (the wrapper checks both).
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
  if (kvh < 1 || h % kvh != 0 || h == 0 || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, seq_ids, live, m_in, l_in, o_in, m_out,
                         l_out, o_out, b, h, kvh, w, t, hd, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, seq_ids, live, m_in, l_in, o_in,
                                 m_out, l_out, o_out, b, h, kvh, w, t, hd,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
