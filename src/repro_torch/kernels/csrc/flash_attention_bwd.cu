// Flash attention, backward, float32 at hd 136 to 256, on the CUDA cores
// (sm_90a).  The wrapper's bwd_variant table sends float32 up to hd 128 to
// flash_attention_bwd_tf32.cu and bf16 to flash_attention_bwd_wgmma.cu
// (up to hd 128) and flash_attention_bwd_wgmma256.cu (above), all on the
// tensor cores.
//
// The counterpart of the reference's custom VJP of its chunked flash
// attention (src/repro/models/flash.py, _flash_bwd), which the TPU runs in
// XLA ops, not in a Pallas kernel.  Given q [B, Sq, H, hd], k, v
// [B, Sk, kv, hd], the forward's output o and the float32 log-sum-exp
// lse [B, H, Sq] of its scores (either forward kernel writes it when asked)
// and the output's gradient do, it returns dq, dk and dv, with the
// forward's masks (absolute positions q_pos = row + q_offset; k_pos < Sk;
// causal: k_pos <= q_pos; window > 0: q_pos - k_pos < window) and GQA
// (head h reads kv head h / (H / kv); dk and dv sum over the group).
//
// Arithmetic, the reference's: delta = sum over hd of o do in float32;
// s = (q k) scale; p = exp(s - lse), 0 where masked; dv += p do and
// dp = do v; ds = p (dp - delta) scale before dq += ds k and dk += ds q.
// Every product is one float32 FMA, every sum a float32 accumulator.  A
// row that sees no key has p = 0 everywhere (its lse, -1e30, is never
// exponentiated: masked probabilities are selected, not multiplied), so its
// gradients are zero.
//
// Design: three kernels, no atomics, so two calls give the same bits.
//  - flash_bwd_delta: one warp a (batch, position, head) row reduces
//    o do over hd by a fixed butterfly.
//  - flash_bwd_dkdv: one block a (batch, kv head, tile of 32 keys) holds
//    its K and V tile in shared memory, walks the group's g heads and, for
//    each, the tiles of 32 query rows that can see one of its keys (the
//    causal diagonal and the window bound the range, as _live_chunk_range
//    does), and accumulates dk and dv in registers over both: the sum over
//    the group is this loop, in a fixed order.
//  - flash_bwd_dq: one block a (batch, head, tile of 32 query rows) walks
//    the key tiles its rows can see and accumulates dq in registers; the
//    latest (heaviest, under a causal mask) row tiles launch first.
//  Both recompute s and dp for a (query tile, key tile) pair the same way
//  (pair_scores): a thread owns a 2 x 2 block of the 32 x 32 pair,
//  reading Q, dO, K and V from shared memory (rows padded to an odd number
//  of floats, so the 16 key rows a warp reads fall in 16 banks), and
//  leaves p and ds in shared memory for the products over hd, in which a
//  thread owns 4 rows (one each 8) by hd / 32 columns (one each 32).
//  hd is padded with zeros to a multiple of 64 (HDP: 192 or 256), so
//  loops are fixed at compile time.
//
// The products run on the CUDA cores, not the tensor cores: a simple
// kernel whose arithmetic is the reference's.  Its bound is the
// backward's operations (5 products over the visible pairs, 2.5 times the
// forward's) at the card's peak for float32; it recomputes s
// and dp once more for dq (7 products).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBQ = 32;        // query rows a tile
constexpr int kBK = 32;        // keys a tile
constexpr int kPS = kBK + 1;   // floats a row of the pair tiles p, ds

// Shared memory of a block, in floats: K and V tiles, Q and dO tiles (rows
// of HDP + 1), the pair tiles p and ds, and the query rows' lse and delta.
template <int HDP>
struct Smem {
  static constexpr int HDS = HDP + 1;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBK * HDS;
  static constexpr int kQ = kV + kBK * HDS;
  static constexpr int kDO = kQ + kBQ * HDS;
  static constexpr int kP = kDO + kBQ * HDS;
  static constexpr int kDS = kP + kBQ * kPS;
  static constexpr int kLse = kDS + kBQ * kPS;
  static constexpr int kDelta = kLse + kBQ;
  static constexpr int kFloats = kDelta + kBQ;
};

// 32 rows of hd values, row r at src + r * stride, into
// dst [32][HDP + 1]; rows past n_rows and columns past hd are zeros.
template <int HDP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int n_rows,
                                           int hd) {
  constexpr int HDS = HDP + 1;
  for (int idx = threadIdx.x; idx < 32 * HDP; idx += kThreads) {
    const int r = idx / HDP;
    const int d = idx % HDP;
    float x = 0.f;
    if (r < n_rows && d < hd) x = src[r * stride + d];
    dst[r * HDS + d] = x;
  }
}

// The 32 query rows' lse and delta of head hq from row i0 on (0 past Sq).
__device__ __forceinline__ void stage_row_stats(float* lse_s, float* delta_s,
                                                const float* lse,
                                                const float* delta,
                                                long long base, int i0,
                                                int sq) {
  if (threadIdx.x < kBQ) {
    const int i = i0 + threadIdx.x;
    lse_s[threadIdx.x] = i < sq ? lse[base + i] : 0.f;
    delta_s[threadIdx.x] = i < sq ? delta[base + i] : 0.f;
  }
}

// s and dp of query rows i0.. against keys k0.. (both tiles staged), then
// p into ps (when WANT_P) and ds into dss.
// A thread owns rows ty, ty + 16 and keys tx, tx + 16 of the pair.
template <int HDP, bool WANT_P>
__device__ __forceinline__ void pair_scores(float* smem, int i0, int k0,
                                            int sq, int sk, int causal,
                                            int window, int q_offset,
                                            float scale) {
  using S = Smem<HDP>;
  constexpr int HDS = S::HDS;
  const float* ks = smem + S::kK;
  const float* vs = smem + S::kV;
  const float* qs = smem + S::kQ;
  const float* dos = smem + S::kDO;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
  for (int d = 0; d < HDP; ++d) {
    const float q0 = qs[ty * HDS + d], q1 = qs[(ty + 16) * HDS + d];
    const float o0 = dos[ty * HDS + d], o1 = dos[(ty + 16) * HDS + d];
    const float k0v = ks[tx * HDS + d], k1v = ks[(tx + 16) * HDS + d];
    const float v0 = vs[tx * HDS + d], v1 = vs[(tx + 16) * HDS + d];
    s[0][0] = fmaf(q0, k0v, s[0][0]);
    s[0][1] = fmaf(q0, k1v, s[0][1]);
    s[1][0] = fmaf(q1, k0v, s[1][0]);
    s[1][1] = fmaf(q1, k1v, s[1][1]);
    dp[0][0] = fmaf(o0, v0, dp[0][0]);
    dp[0][1] = fmaf(o0, v1, dp[0][1]);
    dp[1][0] = fmaf(o1, v0, dp[1][0]);
    dp[1][1] = fmaf(o1, v1, dp[1][1]);
  }
  const float* lse_s = smem + S::kLse;
  const float* delta_s = smem + S::kDelta;
  float* ps = smem + S::kP;
  float* dss = smem + S::kDS;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = ty + 16 * r;
      const int j = tx + 16 * c;
      const int row = i0 + i;
      const int key = k0 + j;
      const int pos = row + q_offset;
      const bool ok = row < sq && key < sk && (!causal || key <= pos) &&
                      (window <= 0 || pos - key < window);
      // s rounded before lse is taken off (no fused multiply-add), as the
      // reference rounds its scaled scores
      const float p = ok ? expf(__fmul_rn(s[r][c], scale) - lse_s[i]) : 0.f;
      const float ds = p * (dp[r][c] - delta_s[i]) * scale;
      if (WANT_P) ps[i * kPS + j] = p;
      dss[i * kPS + j] = ds;
    }
}

// delta[b, h, i] = sum over hd of o do, one warp a row of o [B, Sq, H, hd].
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta(const float* __restrict__ o,
                    const float* __restrict__ dout,
                    float* __restrict__ delta, long long rows, int sq, int h,
                    int hd) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* a = o + row * hd;
  const float* c = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(a[d], c[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / (static_cast<long long>(sq) * h);
    const int rem = static_cast<int>(row % (static_cast<long long>(sq) * h));
    delta[(b * h + rem % h) * sq + rem / h] = acc;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int sq, int sk, int h, int kvh,
                   int hd, int causal, int window, int q_offset,
                   float scale) {
  using S = Smem<HDP>;
  constexpr int HDS = S::HDS;
  constexpr int NC = HDP / 32;  // columns a thread: lane + 32 m
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kBK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kvh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const long long kv_row = static_cast<long long>(kvh) * hd;
  const long long k_at = (static_cast<long long>(b) * sk + k0) * kv_row +
                         static_cast<long long>(kh) * hd;
  const int n_keys = min(kBK, sk - k0);
  stage_rows<HDP>(smem + S::kK, k + k_at, kv_row, n_keys, hd);
  stage_rows<HDP>(smem + S::kV, v + k_at, kv_row, n_keys, hd);

  // Query rows that see a key of this tile.
  const int k_last = k0 + n_keys - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(sq, k_last + window - q_offset) : sq;

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < NC; ++m) dk_acc[r][m] = dv_acc[r][m] = 0.f;

  const long long q_row = static_cast<long long>(h) * hd;
  const float* qs = smem + S::kQ;
  const float* dos = smem + S::kDO;
  const float* ps = smem + S::kP;
  const float* dss = smem + S::kDS;
  for (int gi = 0; gi < g; ++gi) {
    const int hq = kh * g + gi;
    for (int i0 = i_lo; i0 < i_hi; i0 += kBQ) {
      __syncthreads();  // the previous pair's tiles are read
      const long long q_at = (static_cast<long long>(b) * sq + i0) * q_row +
                             static_cast<long long>(hq) * hd;
      const int n_rows = min(kBQ, sq - i0);
      stage_rows<HDP>(smem + S::kQ, q + q_at, q_row, n_rows, hd);
      stage_rows<HDP>(smem + S::kDO, dout + q_at, q_row, n_rows, hd);
      stage_row_stats(smem + S::kLse, smem + S::kDelta, lse, delta,
                      (static_cast<long long>(b) * h + hq) * sq, i0, sq);
      __syncthreads();
      pair_scores<HDP, true>(smem, i0, k0, sq, sk, causal, window,
                             q_offset, scale);
      __syncthreads();
      // dv += p^T do, dk += ds^T q: a thread owns keys warp + 8 r and
      // columns lane + 32 m.
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float pr[4], dr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = ps[i * kPS + warp + 8 * r];
          dr[r] = dss[i * kPS + warp + 8 * r];
        }
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const float dov = dos[i * HDS + lane + 32 * m];
          const float qv = qs[i * HDS + lane + 32 * m];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv_acc[r][m] = fmaf(pr[r], dov, dv_acc[r][m]);
            dk_acc[r][m] = fmaf(dr[r], qv, dk_acc[r][m]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = warp + 8 * r;
    if (j >= n_keys) continue;
    const long long at = k_at + j * kv_row;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = lane + 32 * m;
      if (d < hd) {
        dk[at + d] = dk_acc[r][m];
        dv[at + d] = dv_acc[r][m];
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int sq, int sk, int h, int kvh, int hd, int causal,
                 int window, int q_offset, float scale) {
  using S = Smem<HDP>;
  constexpr int HDS = S::HDS;
  constexpr int NC = HDP / 32;
  extern __shared__ float smem[];
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kvh;
  const int kh = hq / g;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const long long q_row = static_cast<long long>(h) * hd;
  const long long q_at = (static_cast<long long>(b) * sq + i0) * q_row +
                         static_cast<long long>(hq) * hd;
  const int n_rows = min(kBQ, sq - i0);
  stage_rows<HDP>(smem + S::kQ, q + q_at, q_row, n_rows, hd);
  stage_rows<HDP>(smem + S::kDO, dout + q_at, q_row, n_rows, hd);
  stage_row_stats(smem + S::kLse, smem + S::kDelta, lse, delta,
                  (static_cast<long long>(b) * h + hq) * sq, i0, sq);

  // Keys that a row of this tile sees.
  const int p_lo = i0 + q_offset;
  const int p_hi = i0 + n_rows - 1 + q_offset;
  const int k_end = causal ? min(sk, p_hi + 1) : sk;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[r][m] = 0.f;

  const long long kv_row = static_cast<long long>(kvh) * hd;
  const float* ks = smem + S::kK;
  const float* dss = smem + S::kDS;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous key tile is read
    const long long k_at = (static_cast<long long>(b) * sk + k0) * kv_row +
                           static_cast<long long>(kh) * hd;
    const int n_keys = min(kBK, sk - k0);
    stage_rows<HDP>(smem + S::kK, k + k_at, kv_row, n_keys, hd);
    stage_rows<HDP>(smem + S::kV, v + k_at, kv_row, n_keys, hd);
    __syncthreads();
    pair_scores<HDP, false>(smem, i0, k0, sq, sk, causal, window,
                            q_offset, scale);
    __syncthreads();
    // dq += ds k: a thread owns rows warp + 8 r and columns lane + 32 m.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float dr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dr[r] = dss[(warp + 8 * r) * kPS + j];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float kv = ks[j * HDS + lane + 32 * m];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][m] = fmaf(dr[r], kv, acc[r][m]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = warp + 8 * r;
    if (i >= n_rows) continue;
    const long long at = q_at + i * q_row;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = lane + 32 * m;
      if (d < hd) dq[at + d] = acc[r][m];
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int sq, int sk, int h, int kvh, int hd,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  constexpr size_t smem = sizeof(float) * Smem<HDP>::kFloats;
  static_assert(smem <= 232448, "more shared memory than a block can have");
  auto dkdv = flash_bwd_dkdv<HDP>;
  auto dqk = flash_bwd_dq<HDP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = static_cast<long long>(b) * sq * h;
  if (rows > 0) {
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_delta<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const float*>(o), tdo, delta, rows, sq, h, hd);
  }
  if (sk > 0 && b > 0)
    dkdv<<<dim3((sk + kBK - 1) / kBK, kvh, b), kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv),
        sq, sk, h, kvh, hd, causal, window, q_offset, scale);
  if (sq > 0 && b > 0)
    dqk<<<dim3((sq + kBQ - 1) / kBQ, h, b), kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), sq, sk, h, kvh,
        hd, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments: q, k, v, o, do (float32, contiguous), lse (float32
// [B, H, Sq], the forward's), delta (float32 [B, H, Sq] scratch), dq, dk,
// dv (float32 outputs), b, sq, sk, h, kvh, hd (a multiple of 8 from 136
// to 256), hd_pad (hd rounded up to a multiple of 64), causal, window,
// q_offset, scale, stream.  Every element of dk and dv is written (zeros
// for keys no row sees), and of dq.
extern "C" int repro_flash_attention_bwd(const char* packed) {
  const PackedArgs a{packed};
  const void* q = a.ptr<const void>(0);
  const void* k = a.ptr<const void>(1);
  const void* v = a.ptr<const void>(2);
  const void* o = a.ptr<const void>(3);
  const void* dout = a.ptr<const void>(4);
  const float* lse = a.ptr<const float>(5);
  float* delta = a.ptr<float>(6);
  void* dq = a.ptr<void>(7);
  void* dk = a.ptr<void>(8);
  void* dv = a.ptr<void>(9);
  const int b = a.i32(10), sq = a.i32(11), sk = a.i32(12), h = a.i32(13),
            kvh = a.i32(14), hd = a.i32(15), hd_pad = a.i32(16),
            causal = a.i32(17), window = a.i32(18), q_offset = a.i32(19);
  const float scale = a.f32(20);
  cudaStream_t s = static_cast<cudaStream_t>(a.ptr<void>(21));
  if (hd % 8 != 0 || hd <= 128 || hd > 256 || kvh < 1 || h % kvh != 0 ||
      hd_pad != (hd + 63) / 64 * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd_pad == 192)
    return launch<192>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, h,
                       kvh, hd, causal, window, q_offset, scale, s);
  return launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, h,
                     kvh, hd, causal, window, q_offset, scale, s);
}
