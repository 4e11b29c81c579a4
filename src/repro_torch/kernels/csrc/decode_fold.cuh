// The per-page decode-attention fold shared by the two decode kernels, for
// Hopper (sm_90a): csrc/bridge_attention.cu (stream_decode_accumulate, one
// round of landed pages) and csrc/paged_attention.cu (paged_attention, a
// sequence's pool pages).
//
// A page is T tokens of K and of V; for one kv head its slices are T x hd
// each (4 KiB each at granite-3-8b's T 16, hd 128, bf16), token rows
// kv x hd elements apart.  One warp folds one page for the g = H / kv
// query rows of that kv head:
//   * issue_page: every 16-byte vector of the page's K and V slices is
//     issued with cp.async into shared memory before the first score, so a
//     page costs one round trip to memory, and a caller can keep the next
//     page's loads in flight while it computes on this one;
//   * fold_page16 (the decode path's pages: T 16, hd 128, g 4) keeps its
//     chunk of q in registers and reduces the partial dots across lanes by
//     shuffles; fold_page (any T, hd and g) reads q from shared memory, a
//     lane a (row, token) score.  Both take scores, max, exponentials and
//     sums in float32, accumulate p @ v in registers and merge the page
//     into the warp's running state (m, l, acc) in shared memory;
//   * merge_partials: a whole block merges partial states into a state in a
//     fixed order, m = max(m, m_k) and each side rescaled by exp(its m - m),
//     the arithmetic of kvbridge._merge.  A partial is the record
//     [acc g*hd][m g][l g] (record_floats: acc stays 16-byte aligned), in
//     shared memory or in device memory alike.
//
// A page's partial is its fold into the empty state: exp(-1e30 - m) is 0 and
// exp(0) is 1, so it is the page's (max, sum, p @ v) exactly.  The empty
// state is (kNegInf, 0, 0), never -inf: exp(-inf - -inf) would be NaN, so
// merging an empty state into an empty state stays empty.
//
// Tensor cores are not used.  A page gives g <= 8 query rows (4 for
// granite-3-8b) against T = 16 tokens: products of 8 x 16 x 128 at most,
// far below wgmma's 64-row tile, and under 2 float32 operations a byte of K
// and V read, so the fold is bound by memory and latency, not arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_fold {

constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr int kRowsPerPass = 8;      // query rows a lane accumulates at once
constexpr int kMaxMerge = 8;         // partials merge_partials takes a call

template <typename T>
struct Vec16;                        // elements in 16 bytes
template <>
struct Vec16<float> {
  static constexpr int n = 4;
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Floats of one partial record [acc g*hd][m g][l g], 16-byte aligned.
__host__ __device__ constexpr int record_floats(int g, int hd) {
  return g * hd + pad4(2 * g);
}

// Floats of one warp's shared memory: its partial record, the g x T
// scores (then probabilities) with two per-row factors, and `buffers` K and
// V page buffers of T x hd elements of `elem` bytes.
__host__ __device__ constexpr int warp_floats(int g, int hd, int t, int elem,
                                              int buffers) {
  return record_floats(g, hd) + pad4(g * t + 2 * g) +
         buffers * 2 * (t * hd * elem / 4);
}

// ---------------------------------------------------------------------------
// Loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T as floats.
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 4 elements of T as floats.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  load16(p, f);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// 4 floats stored as T.
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x.x, x.y),
                         __floats2bfloat162_rn(x.z, x.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// The n = g x hd query elements at q (device memory, T) into q_s as float32;
// the whole block, 16-byte vectors.
template <typename T>
__device__ __forceinline__ void load_rows(float* q_s, const T* q, int n) {
  constexpr int V = Vec16<T>::n;
  for (int i = threadIdx.x; i < n / V; i += blockDim.x) {
    float f[V];
    load16(q + i * V, f);
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(q_s + i * V + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// Issue one page's K and V slices of one kv head (kp, vp: its first token;
// tok: elements between tokens) into kb, vb [T][hd] in shared memory, 16
// bytes a cp.async; the caller commits and waits.  One warp.
template <typename T>
__device__ __forceinline__ void issue_page(T* kb, T* vb, const T* kp,
                                           const T* vp, int t, int hd,
                                           long long tok, int lane) {
  constexpr int V = Vec16<T>::n;
  const int per_row = hd / V;
  for (int i = lane; i < t * per_row; i += 32) {
    const int r = i / per_row;
    const long long off = r * tok + (i - r * per_row) * V;
    cp_async16(kb + i * V, kp + off);
    cp_async16(vb + i * V, vp + off);
  }
}

// ---------------------------------------------------------------------------
// The fold
// ---------------------------------------------------------------------------

// Fold one landed page (kb, vb [T][hd], shared) into the warp's running
// state `rec` (a partial record, shared) for the g query rows q_s [g][hd]
// (float32, shared).  With `first` the state is empty and is overwritten
// with the page's partial.  s_w: the warp's g*T + 2g floats of scratch.
// One warp, every lane; ends with __syncwarp.  Any T and hd: a lane a
// (row, token) score, a lane a row's max and sum, a lane 4 columns of p @ v.
template <typename T>
__device__ void fold_page(const float* q_s, const T* kb, const T* vb,
                          float* s_w, float* rec, int g, int t, int hd,
                          float scale, bool first, int lane) {
  constexpr int V = Vec16<T>::n;
  const int per_row = hd / V;
  float* acc_r = rec;
  float* m_r = rec + g * hd;
  float* l_r = m_r + g;
  float* f_old = s_w + g * t;          // [g] page max, then old state's factor
  float* f_page = f_old + g;           // [g] the page's factor

  // scores: lane (row gi, token tt), dot over hd in 16-byte chunks starting
  // at chunk tt, so a quarter warp's lanes read distinct banks of K
  for (int idx = lane; idx < g * t; idx += 32) {
    const int gi = idx / t;
    const int tt = idx - gi * t;
    const float* qr = q_s + gi * hd;
    const T* kr = kb + tt * hd;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    const int c0 = tt % per_row;
#pragma unroll 8
    for (int j = 0; j < per_row; ++j) {
      int c = c0 + j;
      if (c >= per_row) c -= per_row;
      float kf[V];
      load16(kr + c * V, kf);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + c * V + e);
        dot[0] = fmaf(qv.x, kf[e], dot[0]);
        dot[1] = fmaf(qv.y, kf[e + 1], dot[1]);
        dot[2] = fmaf(qv.z, kf[e + 2], dot[2]);
        dot[3] = fmaf(qv.w, kf[e + 3], dot[3]);
      }
    }
    s_w[idx] = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale;
  }
  __syncwarp();
  for (int gi = lane; gi < g; gi += 32) {
    float mx = s_w[gi * t];
#pragma unroll
    for (int tt = 1; tt < t; ++tt) mx = fmaxf(mx, s_w[gi * t + tt]);
    f_old[gi] = mx;
  }
  __syncwarp();
  for (int idx = lane; idx < g * t; idx += 32)
    s_w[idx] = expf(s_w[idx] - f_old[idx / t]);
  __syncwarp();
  for (int gi = lane; gi < g; gi += 32) {
    float sum = 0.f;
#pragma unroll
    for (int tt = 0; tt < t; ++tt) sum += s_w[gi * t + tt];
    const float mp = f_old[gi];
    if (first) {
      m_r[gi] = mp;
      l_r[gi] = sum;
    } else {
      const float mo = m_r[gi];
      const float mn = fmaxf(mo, mp);
      const float a = expf(mo - mn);
      const float b = expf(mp - mn);
      m_r[gi] = mn;
      l_r[gi] = l_r[gi] * a + sum * b;
      f_old[gi] = a;
      f_page[gi] = b;
    }
  }
  __syncwarp();

  // p @ v: a lane accumulates 4 columns of up to 8 rows in registers
  for (int g0 = 0; g0 < g; g0 += kRowsPerPass) {
    const int rows = min(kRowsPerPass, g - g0);
    for (int d0 = lane * 4; d0 < hd; d0 += 128) {
      float acc[kRowsPerPass][4];
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 16
      for (int tt = 0; tt < t; ++tt) {
        float vf[4];
        load4(vb + tt * hd + d0, vf);
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r) {
          if (r < rows) {
            const float p = s_w[(g0 + r) * t + tt];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        if (r < rows) {
          float4* o = reinterpret_cast<float4*>(acc_r + (g0 + r) * hd + d0);
          if (first) {
            *o = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          } else {
            const float a = f_old[g0 + r];
            const float b = f_page[g0 + r];
            float4 x = *o;
            x.x = x.x * a + acc[r][0] * b;
            x.y = x.y * a + acc[r][1] * b;
            x.z = x.z * a + acc[r][2] * b;
            x.w = x.w * a + acc[r][3] * b;
            *o = x;
          }
        }
      }
    }
  }
  __syncwarp();
}

// Reduce-scatter of a lane's list of N values over the lanes that differ in
// the bits M, M/2, ..., 1 of the lane index: at mask m a lane with bit m
// set keeps the upper half of its list (the lower half without it) and adds
// its partner's copy of that half.  After the last step a lane with bits c
// holds the sums of list entries (N / (2M)) * c .. + N / (2M) - 1 in
// part[0 ..].  One level a template, so every index is a constant.
template <int M, int N>
__device__ __forceinline__ void reduce_scatter(float* part, int lane) {
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? part[i] : part[i + N / 2];
    const float keep = upper ? part[i + N / 2] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > 1) reduce_scatter<M / 2, N / 2>(part, lane);
}

// The same fold for the decode path's pages: T = 16 tokens, hd = 128, G
// query rows, q in registers.  Lane (c, grp) takes 16-byte chunk c of a
// row (L = 16 chunks in bf16, 32 in float32) and the tokens grp + R * j
// (R = 32 / L groups, J = 16 / R tokens a lane):
//   * scores: its chunk of q's G rows (registers) against its J tokens'
//     chunks of K, G x J partial dots, then a reduce-scatter over the L
//     lanes of a row (log2 L shuffle steps, each halving the list a lane
//     keeps): lane c ends with the F = G * J / L full scores F*c .. F*c+F-1
//     of the list (row gi, token j) = gi * J + j;
//   * max and sum: over the lanes of a row by xor shuffles;
//   * p @ v: lane (c, grp) accumulates chunk c of rows grp * G/R .. for all
//     16 tokens in registers (p from the warp's scratch, [T][G]).
// Shared memory carries K and V once each and p; the scores read no q from
// it, where the general fold reads each q row once for every token.
template <typename T, int G>
__device__ void fold_page16(const float* q_s, const T* kb, const T* vb,
                            float* s_w, float* rec, float scale, bool first,
                            int lane) {
  constexpr int V = Vec16<T>::n;
  constexpr int HD = 128;
  constexpr int TT = 16;
  constexpr int L = HD / V;            // lanes over a row's chunks
  constexpr int R = 32 / L;            // token groups
  constexpr int J = TT / R;            // tokens a lane
  constexpr int N = G * J;             // partial dots a lane
  constexpr int F = N / L;             // full scores a lane after the reduce
  constexpr int GR = G / R;            // rows a lane accumulates in p @ v
  static_assert(N % L == 0 && G % R == 0 && F >= 1, "fold_page16 shape");
  const int c = lane % L;
  const int grp = lane / L;
  float* acc_r = rec;
  float* m_r = rec + G * HD;
  float* l_r = m_r + G;
  float* p_s = s_w;                    // [TT][G] probabilities
  float* f_old = s_w + TT * G;         // [G] the old state's factor
  float* f_page = f_old + G;           // [G] the page's factor

  float qf[G][V];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(q_s + gi * HD + c * V + e);
      qf[gi][e] = x.x;
      qf[gi][e + 1] = x.y;
      qf[gi][e + 2] = x.z;
      qf[gi][e + 3] = x.w;
    }
  float part[N];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float kf[V];
    load16(kb + (grp + R * j) * HD + c * V, kf);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        d0 = fmaf(qf[gi][e], kf[e], d0);
        d1 = fmaf(qf[gi][e + 1], kf[e + 1], d1);
      }
      part[gi * J + j] = d0 + d1;
    }
  }
  reduce_scatter<L / 2, N>(part, lane);
  // this lane's scores: list entries F*c + i, row gi, tokens grp + R * j
  const int gi = F * c / J;
  float mx = part[0] * scale;
#pragma unroll
  for (int i = 1; i < F; ++i) mx = fmaxf(mx, part[i] * scale);
#pragma unroll
  for (int m = 1; m < L / G; m *= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
#pragma unroll
  for (int m = L; m < 32; m *= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const float p = expf(part[i] * scale - mx);
    sum += p;
    p_s[(grp + R * ((F * c + i) % J)) * G + gi] = p;
  }
#pragma unroll
  for (int m = 1; m < L / G; m *= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
#pragma unroll
  for (int m = L; m < 32; m *= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (grp == 0 && c % (L / G) == 0) {  // one lane a row keeps its state
    if (first) {
      m_r[gi] = mx;
      l_r[gi] = sum;
    } else {
      const float mo = m_r[gi];
      const float mn = fmaxf(mo, mx);
      const float a = expf(mo - mn);
      const float b = expf(mx - mn);
      m_r[gi] = mn;
      l_r[gi] = l_r[gi] * a + sum * b;
      f_old[gi] = a;
      f_page[gi] = b;
    }
  }
  __syncwarp();

  // p @ v: chunk c of rows grp * GR .. grp * GR + GR - 1, every token
  float acc[GR][V];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    float vf[V];
    load16(vb + tt * HD + c * V, vf);
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const float p = p_s[tt * G + grp * GR + r];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int row = grp * GR + r;
    float a = 0.f, b = 1.f;
    if (!first) {
      a = f_old[row];
      b = f_page[row];
    }
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      float4* o = reinterpret_cast<float4*>(acc_r + row * HD + c * V + e);
      if (first) {
        *o = make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                         acc[r][e + 3]);
      } else {
        float4 x = *o;
        x.x = x.x * a + acc[r][e] * b;
        x.y = x.y * a + acc[r][e + 1] * b;
        x.z = x.z * a + acc[r][e + 2] * b;
        x.w = x.w * a + acc[r][e + 3] * b;
        *o = x;
      }
    }
  }
  __syncwarp();
}

// Merge the n <= kMaxMerge partial records parts[k * stride] (shared or
// device memory), in order k = 0, 1, ..., into a state (shared): acc [g][hd]
// at o_s, its m and l read from m_in, l_in and written to m_out, l_out
// (other words, so no thread reads an m another has rewritten):
// m' = max(m, m_k), l = l * exp(m - m') + l_k * exp(m_k - m'), acc likewise.
// A thread a 4-vector of acc takes its row's steps itself, every step's
// max first (each is what the steps one by one give), then the exps, which
// no longer wait on each other, then the chain of products; the thread of
// a row's first vector writes its m and l.  One pass with no barrier in it:
// the whole block calls it after a barrier (parts and state written) and
// it ends with one.
__device__ inline void merge_partials(float* o_s, const float* m_in,
                                      const float* l_in, float* m_out,
                                      float* l_out, const float* parts,
                                      long long stride, int n, int g,
                                      int hd) {
  for (int i = threadIdx.x; i < g * hd / 4; i += blockDim.x) {
    const int gi = i * 4 / hd;
    float mk[kMaxMerge], lk[kMaxMerge], mx[kMaxMerge + 1];
    float4 x[kMaxMerge];
    mx[0] = m_in[gi];
#pragma unroll
    for (int k = 0; k < kMaxMerge; ++k) {
      if (k < n) {
        const float* rec = parts + k * stride;
        x[k] = reinterpret_cast<const float4*>(rec)[i];
        mk[k] = rec[g * hd + gi];
        lk[k] = rec[g * hd + g + gi];
        mx[k + 1] = fmaxf(mx[k], mk[k]);
      }
    }
    float4 o = reinterpret_cast<const float4*>(o_s)[i];
    float l = l_in[gi];
#pragma unroll
    for (int k = 0; k < kMaxMerge; ++k) {
      if (k < n) {
        const float a = expf(mx[k] - mx[k + 1]);
        const float b = expf(mk[k] - mx[k + 1]);
        o.x = o.x * a + x[k].x * b;
        o.y = o.y * a + x[k].y * b;
        o.z = o.z * a + x[k].z * b;
        o.w = o.w * a + x[k].w * b;
        l = l * a + lk[k] * b;
      }
    }
    reinterpret_cast<float4*>(o_s)[i] = o;
    if (i * 4 == gi * hd) {
      float m = mx[0];
#pragma unroll
      for (int k = 0; k < kMaxMerge; ++k)
        if (k < n) m = mx[k + 1];
      m_out[gi] = m;
      l_out[gi] = l;
    }
  }
  __syncthreads();
}

// Set a kernel's dynamic shared memory limit to `bytes` the first time a
// launch needs more than the default 48 KiB (or than an earlier limit).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

constexpr size_t kSmemLimit = 227 * 1024;   // a block's shared memory, H100

}  // namespace decode_fold
