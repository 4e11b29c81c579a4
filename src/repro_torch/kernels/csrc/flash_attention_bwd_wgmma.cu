// Flash attention, backward, bf16, on Hopper's tensor cores (sm_90a).
//
// The counterpart of the reference's custom VJP of its chunked flash
// attention (src/repro/models/flash.py, _flash_bwd), which the TPU runs in
// XLA ops, not in a Pallas kernel, for bfloat16 inputs with hd up to 128
// (the wrapper's bwd_variant table; bf16 beyond hd 128 takes
// flash_attention_bwd_wgmma256.cu, float32 flash_attention_bwd_tf32.cu and
// flash_attention_bwd_tf32_256.cu).  Given q [B, Sq, H, hd], k, v
// [B, Sk, kv, hd], the forward's output o and float32 log-sum-exp lse
// [B, H, Sq] and the output's gradient do, it returns dq, dk and dv in
// bf16, with the forward's masks (absolute positions q_pos = row +
// q_offset; k_pos < Sk; causal: k_pos <= q_pos; window > 0: q_pos - k_pos <
// window) and GQA (dk and dv sum over the group).
//
// Arithmetic, the reference's, on the tensor cores: every product is bf16 x
// bf16 with float32 accumulation (exact products, so only the order of the
// float32 sums differs); delta = sum over hd of o do in float32; p =
// exp2(s scale log2e - lse log2e), selected to 0 where masked; p rounded
// to bf16 before dv += p^T do; ds = p (dp - delta) scale rounded to bf16
// before dq += ds k and dk += ds^T q; dq, dk, dv rounded to bf16 once, at
// the end.  A row that sees no key has p = 0 everywhere (its lse, -1e30,
// only reaches masked probabilities, which are selected), so its gradients
// are zero.
//
// What bounds it: operations.  At the training shapes (B 4, S 1024, H 32,
// kv 8, hd 128, causal) the five products over the visible pairs take 10
// B H hd S(S+1)/2 = 86.0 GFLOP, 0.087 ms at the bf16 tensor cores' 989
// TFLOP/s; q, k, v, o, do and the gradients, 0.2 GB, take 0.06 ms at
// 3.35 TB/s.  The design computes s and dp in both passes (7 products), so
// that no sum needs atomics and two calls give the same bits.
//
// Rows.  A kv head's query rows are its g = H / kv heads at every
// position, flattened position-major (row = position * hb + head), as the
// forward's wgmma kernel takes them: a tile is 64 rows, hb (the largest
// divisor of g up to 64) heads at P = 64 / hb positions, so one K/V tile
// serves every head that reads it.  Rows past P hb (when hb does not
// divide 64) and positions past Sq carry the lse sentinel +inf, which
// makes their p exactly 0.
//
// Three kernels, one stream, no atomics:
//  - flash_bwd_wgmma_delta: half a warp a row of a tile writes (lse log2e,
//    delta) into a tile-major scratch, 64 rows a tile, so that either pass
//    copies a tile's row statistics with one 512-byte bulk copy.
//  - flash_bwd_wgmma_dkdv: one block a (batch, kv head, 128 keys), two
//    consumer warpgroups of 64 keys and a producer warpgroup (setmaxnreg:
//    24 / 240 registers).  K and V of the block are loaded once; the
//    producer streams the group's row tiles that see one of its keys (head
//    blocks outer, position tiles inner: a fixed order) through a ring of
//    up to 4 stages of Q, dO and the row statistics.  In the transposed
//    orientation every operand is laid out as wgmma reads it: S^T = K Q^T
//    and dP^T = V dO^T with both operands K-major in shared memory;
//    P^T = exp2(...) and dS^T = P^T (dP^T - delta) scale in registers,
//    converted to bf16 A fragments (the accumulator layout is the fragment
//    layout); dV += P^T dO and dK += dS^T Q with dO and Q under the
//    transpose bit, as the forward reads V.  dK and dV stay in float32
//    registers (64 + 64 a thread at hd 128) and go out once through shared
//    memory and TMA stores.  Blocks launch heaviest (earliest keys, under
//    a causal mask) first.
//  - flash_bwd_wgmma_dq: one block a (batch, kv head, head block, two row
//    tiles), one tile a consumer warpgroup; the producer streams the key
//    tiles (128 keys) that one of the rows sees through a ring of K and V.
//    S = Q K^T and dP = dO V^T (SS), dS in registers, dQ += dS K (RS, K
//    under the transpose bit); dQ goes out through the tile's Q buffer.
//    The latest row tiles, under a causal mask, launch first.
//  Tiles wholly outside the mask are skipped; only tiles that straddle an
//  edge (the diagonal, the window, Sk) are masked, each row or key by its
//  own range, as the forward masks.  TMA boxes reaching past hd, Sk or Sq
//  fill with zeros, so hd 120 is padded to 128 in shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "packed_args.cuh"

namespace {

constexpr int kTile = 64;       // query rows a tile
constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16
constexpr int kStatBytes = kTile * 8;  // a tile's (lse log2e, delta) pairs
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSmem = 232448;       // shared memory a block may take
constexpr int kSlack = 1024 + 256;  // alignment, then the barriers

// dK/dV pass: K and V of 128 keys, then a ring of stages, each a Q tile, a
// dO tile and the tile's row statistics (1,024 bytes kept, so that every
// tile starts on a 1,024-byte boundary).
template <int HD>
struct DkdvLayout {
  static constexpr int kCols = HD / 64;
  static constexpr int kKeys = 128;
  static constexpr int kKV = kCols * kKeys * kRowBytes;
  static constexpr int kTileBytes = kCols * kTile * kRowBytes;
  static constexpr int kStage = 2 * kTileBytes + 1024;
  static constexpr int kFit = (kSmem - kSlack - 2 * kKV) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kK0 = 0;
  static constexpr int kV0 = kKV;
  static constexpr int kS0 = 2 * kKV;
  static constexpr int kBars = kS0 + kStages * kStage;
  static constexpr int kBytes = kBars + kSlack;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// dQ pass: the two warpgroups' Q tiles, their dO tiles, then a ring of
// stages, each a K tile and a V tile of 128 keys.
template <int HD>
struct DqLayout {
  static constexpr int kCols = HD / 64;
  static constexpr int kKeys = 128;
  static constexpr int kTileBytes = kCols * kTile * kRowBytes;
  static constexpr int kKeyBytes = kCols * kKeys * kRowBytes;  // K or V
  static constexpr int kQ0 = 0;
  static constexpr int kDO0 = 2 * kTileBytes;
  static constexpr int kKV0 = 4 * kTileBytes;
  static constexpr int kStage = 2 * kKeyBytes;
  static constexpr int kFit = (kSmem - kSlack - kKV0) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBars = kKV0 + kStages * kStage;
  static constexpr int kBytes = kBars + kSlack;
  static_assert(kStages >= 2, "a ring needs two stages");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 16 K float32 accumulator as bf16 A fragments, 16 columns a
// product: the accumulator layout two 8-column groups at a time.
template <int K>
__device__ __forceinline__ void pack_frags(const float (&x)[8 * K],
                                           uint32_t (&f)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// A thread's part of a 64 x HD float32 accumulator, its rows r0 and r0 + 8,
// as bf16 into a swizzled tile whose 64-column blocks lie `block_bytes`
// apart, in the layout TMA reads.
template <int HD>
__device__ __forceinline__ void store_rows(uint8_t* tile, int block_bytes,
                                           int r0, const float (&acc)[HD / 2],
                                           int quad) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      *reinterpret_cast<__nv_bfloat162*>(
          tile + (n / 8) * block_bytes + r * kRowBytes +
          (((n % 8) ^ (r % 8)) * 16) + quad * 4) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
}

// (lse log2e, delta) of every row of every tile: row r of tile (b, kv head
// kh, head block hc, position tile t) at stats[((b kvh + kh) nhc + hc)
// tiles + t) 64 + r], position t P + r / hb, head kh g + hc hb + r % hb;
// rows past P hb or Sq get (+inf, 0).  Half a warp a row, 8 columns (16
// bytes) a lane (hd <= 128), reduced by a fixed butterfly.
__global__ void __launch_bounds__(256)
    flash_bwd_wgmma_delta(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float2* __restrict__ stats, long long n_rows,
                          int sq, int h, int kvh, int hd, int hb, int tiles) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 16 + threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  const int g = h / kvh;
  const int nhc = g / hb;
  const int pos_per = kTile / hb;
  const int r = static_cast<int>(row % kTile);
  long long rest = row / kTile;
  const int t = static_cast<int>(rest % tiles);
  rest /= tiles;
  const int hc = static_cast<int>(rest % nhc);
  rest /= nhc;
  const int kh = static_cast<int>(rest % kvh);
  const long long b = rest / kvh;
  const int pos = t * pos_per + r / hb;
  const int head = kh * g + hc * hb + r % hb;
  const bool valid = row < n_rows && r < pos_per * hb && pos < sq;
  float acc = 0.f;
  if (valid && lane * 8 < hd) {
    const long long at = ((b * sq + pos) * h + head) * hd + lane * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(c2[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0 && row < n_rows)
    stats[row] = valid ? make_float2(lse[(b * h + head) * sq + pos] * kLog2e,
                                     acc)
                       : make_float2(INFINITY, 0.f);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wgmma_dkdv(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap dkmap,
                         const __grid_constant__ CUtensorMap dvmap,
                         const float2* __restrict__ stats, int batch, int sq,
                         int sk, int kvh, int g, int hb, int tiles,
                         int causal, int window, int q_offset, float scale,
                         float scale_log2) {
  using L = DkdvLayout<HD>;
  constexpr int kCols = L::kCols;
  constexpr int kStages = L::kStages;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;         // [kStages] each
  uint64_t* empty = full + kStages;

  const int pos_per = kTile / hb;    // positions a tile
  const int rows = pos_per * hb;     // rows a tile (<= 64)
  const int nhc = g / hb;            // head blocks a kv head
  // The item: key blocks in order (under a causal mask the earliest keys
  // are seen by the most rows), then (batch, kv head).
  const int kb = blockIdx.x / (batch * kvh);
  const int kh = blockIdx.x % kvh;
  const int b = (blockIdx.x / kvh) % batch;
  const int k0 = kb * L::kKeys;
  // The positions whose rows see one of the block's keys, as position
  // tiles [t_lo, t_lo + nt).
  const int k_last = min(k0 + L::kKeys, sk) - 1;
  const int pos_lo = causal ? max(0, k0 - q_offset) : 0;
  const int pos_hi = window > 0 ? min(sq, k_last + window - q_offset) : sq;
  int t_lo = 0, nt = 0;
  if (pos_hi > pos_lo) {
    t_lo = pos_lo / pos_per;
    nt = (pos_hi + pos_per - 1) / pos_per - t_lo;
  }
  const int steps = nt * nhc;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hopper::mbar_fence_init();
  }
  // TMA writes the first `rows` rows of a Q or dO tile; the rest stay zero.
  if (rows < kTile) {
    const int per = (kTile - rows) * (kRowBytes / 16);
    for (int i = threadIdx.x; i < kStages * 2 * kCols * per; i += kThreads) {
      const int blk = i / per;
      *reinterpret_cast<uint4*>(
          smem + L::kS0 + (blk / (2 * kCols)) * L::kStage +
          (blk % (2 * kCols)) * kTile * kRowBytes + rows * kRowBytes +
          (i % per) * 16) = make_uint4(0, 0, 0, 0);
    }
    hopper::fence_async();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(kv_full, 2 * L::kKV);
      for (int c = 0; c < kCols; ++c) {
        hopper::tma_load_4d(smem + L::kK0 + c * L::kKeys * kRowBytes, &kmap,
                            kv_full, 64 * c, kh, k0, b);
        hopper::tma_load_4d(smem + L::kV0 + c * L::kKeys * kRowBytes, &vmap,
                            kv_full, 64 * c, kh, k0, b);
      }
      for (int i = 0; i < steps; ++i) {
        const int hc = i / nt, t = t_lo + i % nt, s = i % kStages;
        uint8_t* stage = smem + L::kS0 + s * L::kStage;
        hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s],
                               2 * kCols * rows * kRowBytes + kStatBytes);
        for (int c = 0; c < kCols; ++c) {
          hopper::tma_load_4d(stage + c * kTile * kRowBytes, &qmap, &full[s],
                              64 * c, kh * g + hc * hb, t * pos_per, b);
          hopper::tma_load_4d(stage + L::kTileBytes + c * kTile * kRowBytes,
                              &domap, &full[s], 64 * c, kh * g + hc * hb,
                              t * pos_per, b);
        }
        hopper::bulk_load(
            stage + 2 * L::kTileBytes,
            stats + ((static_cast<long long>(b) * kvh + kh) * nhc + hc) *
                        tiles * kTile + static_cast<long long>(t) * kTile,
            kStatBytes, &full[s]);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int kr = 16 * warp + lane / 4;  // the thread's keys: kr, kr + 8
    const int kw = k0 + 64 * wg;          // the warpgroup's first key
    const uint32_t k_base =
        hopper::smem_addr(smem + L::kK0) + wg * 64 * kRowBytes;
    const uint32_t v_base =
        hopper::smem_addr(smem + L::kV0) + wg * 64 * kRowBytes;

    // dk[4 n + e], dv[4 n + e]: key kr + 8 (e / 2), column 8 n + 2 quad +
    // e % 2.
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dk[e] = dv[e] = 0.f;
    hopper::mbar_wait(kv_full, 0);

    for (int i = 0; i < steps; ++i) {
      const int t = t_lo + i % nt, s = i % kStages;
      uint8_t* stage = smem + L::kS0 + s * L::kStage;
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
      const int p0 = t * pos_per;
      const int qa = p0 + q_offset;                         // first row's
      const int qb = min(p0 + pos_per, sq) - 1 + q_offset;  // last row's
      const bool none =
          kw >= sk || (causal && kw > qb) ||
          (window > 0 && qa - min(kw + 63, sk - 1) >= window);
      if (!none) {
        const bool masked = kw + 64 > sk || (causal && kw + 63 > qa) ||
                            (window > 0 && qb - kw >= window);
        const uint32_t q_s = hopper::smem_addr(stage);
        const uint32_t do_s = q_s + L::kTileBytes;
        const float4* st4 =
            reinterpret_cast<const float4*>(stage + 2 * L::kTileBytes);
        // st[4 n + e], dpt[4 n + e]: key kr + 8 (e / 2), row 8 n + 2 quad +
        // e % 2 of the tile.
        float st[32], dpt[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < kCols; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss(
                st,
                hopper::desc_sw128(
                    k_base + c * L::kKeys * kRowBytes + kk * 32, 16, 1024),
                hopper::desc_sw128(q_s + c * kTile * kRowBytes + kk * 32, 16,
                                   1024),
                c + kk > 0);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss(
                dpt,
                hopper::desc_sw128(
                    v_base + c * L::kKeys * kRowBytes + kk * 32, 16, 1024),
                hopper::desc_sw128(do_s + c * kTile * kRowBytes + kk * 32, 16,
                                   1024),
                c + kk > 0);
        hopper::wgmma_commit();
        // The rows each of the thread's keys sees, [clo, chi) of the tile
        // (rows are position-major, so a range of positions is one of rows).
        int clo[2] = {0, 0}, chi[2] = {kTile, kTile};
        if (masked) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kpos = kw + kr + 8 * j;
            const int lo = causal ? kpos - qa : 0;
            const int hi = window > 0 ? kpos - qa + window : pos_per;
            clo[j] = min(max(lo, 0), pos_per) * hb;
            chi[j] = kpos < sk ? min(max(hi, 0), pos_per) * hb : 0;
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        // P^T: masked probabilities are 0, not exp2 of a masked score.
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 sv = st4[4 * n + quad];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * quad + e % 2;
            float p = ex2(fmaf(st[4 * n + e], scale_log2,
                               -(e % 2 ? sv.z : sv.x)));
            if (masked && (col < clo[e / 2] || col >= chi[e / 2])) p = 0.f;
            st[4 * n + e] = p;
          }
        }
        uint32_t pf[4][4];
        pack_frags(st, pf);
        // dS^T = P^T (dP^T - delta) scale, from the unrounded p.
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 sv = st4[4 * n + quad];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * n + e] = st[4 * n + e] *
                             (dpt[4 * n + e] - (e % 2 ? sv.w : sv.y)) * scale;
        }
        uint32_t dsf[4][4];
        pack_frags(dpt, dsf);
        // dV += P^T dO and dK += dS^T Q, issued together.
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        hopper::fence_regs(pf);
        hopper::fence_regs(dsf);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs(dv, pf[kk],
                           hopper::desc_sw128(do_s + kk * 16 * kRowBytes,
                                              kTile * kRowBytes, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs(dk, dsf[kk],
                           hopper::desc_sw128(q_s + kk * 16 * kRowBytes,
                                              kTile * kRowBytes, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        hopper::fence_regs(pf);
        hopper::fence_regs(dsf);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // dk and dv as bf16 over the warpgroup's own K and V rows (only its own
    // products read them), then one TMA store a 64-column block, which
    // leaves out the keys past Sk and the columns past hd.
    if (kw < sk) {
      store_rows<HD>(smem + L::kK0, L::kKeys * kRowBytes, 64 * wg + kr, dk,
                     quad);
      store_rows<HD>(smem + L::kV0, L::kKeys * kRowBytes, 64 * wg + kr, dv,
                     quad);
      hopper::fence_async();
      hopper::named_bar_sync(1 + wg, 128);
      if (tid == 0) {
        for (int c = 0; c < kCols; ++c) {
          const int at = c * L::kKeys * kRowBytes + wg * 64 * kRowBytes;
          hopper::tma_store_4d(&dkmap, smem + L::kK0 + at, 64 * c, kh, kw, b);
          hopper::tma_store_4d(&dvmap, smem + L::kV0 + at, 64 * c, kh, kw, b);
        }
        hopper::tma_store_commit_and_wait_read();
        hopper::tma_store_wait_all();
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wgmma_dq(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap dqmap,
                       const float2* __restrict__ stats, int batch, int sq,
                       int sk, int kvh, int g, int hb, int tiles, int causal,
                       int window, int q_offset, float scale,
                       float scale_log2) {
  using L = DqLayout<HD>;
  constexpr int kCols = L::kCols;
  constexpr int kStages = L::kStages;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* qd_full = bars;          // [2]: a warpgroup's Q and dO
  uint64_t* full = bars + 2;         // [kStages] each
  uint64_t* empty = full + kStages;

  const int pos_per = kTile / hb;
  const int rows = pos_per * hb;
  const int nhc = g / hb;
  // The item: pairs of row tiles, the latest first under a causal mask (they
  // see the most keys), then (batch, kv head, head block).
  const int per_pair = batch * kvh * nhc;
  const int pairs = (tiles + 1) / 2;
  int pair = blockIdx.x / per_pair;
  if (causal) pair = pairs - 1 - pair;
  const int id = blockIdx.x % per_pair;
  const int hc = id % nhc;
  const int kh = (id / nhc) % kvh;
  const int b = id / (nhc * kvh);
  // The keys one of the pair's rows sees, as key tiles from k_begin.
  const int pa = 2 * pair * pos_per;
  const int pb = min(pa + 2 * pos_per, sq) - 1;
  const int k_end = causal ? min(sk, pb + q_offset + 1) : sk;
  const int k_begin = window > 0 ? max(0, pa + q_offset - window + 1) : 0;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + L::kKeys - 1) / L::kKeys : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&qd_full[0], 1);
    hopper::mbar_init(&qd_full[1], 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      for (int w = 0; w < 2; ++w) {
        const int p0 = (2 * pair + w) * pos_per;
        if (p0 >= sq) {  // no such tile: nothing to wait for
          hopper::mbar_arrive(&qd_full[w]);
          continue;
        }
        hopper::mbar_expect_tx(&qd_full[w], 2 * kCols * rows * kRowBytes);
        for (int c = 0; c < kCols; ++c) {
          hopper::tma_load_4d(
              smem + L::kQ0 + w * L::kTileBytes + c * kTile * kRowBytes,
              &qmap, &qd_full[w], 64 * c, kh * g + hc * hb, p0, b);
          hopper::tma_load_4d(
              smem + L::kDO0 + w * L::kTileBytes + c * kTile * kRowBytes,
              &domap, &qd_full[w], 64 * c, kh * g + hc * hb, p0, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        uint8_t* stage = smem + L::kKV0 + s * L::kStage;
        hopper::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * kCols * L::kKeys * kRowBytes);
        for (int c = 0; c < kCols; ++c) {
          hopper::tma_load_4d(stage + c * L::kKeys * kRowBytes, &kmap,
                              &full[s], 64 * c, kh, k_begin + j * L::kKeys,
                              b);
          hopper::tma_load_4d(
              stage + L::kKeyBytes + c * L::kKeys * kRowBytes, &vmap,
              &full[s], 64 * c, kh, k_begin + j * L::kKeys, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int r0 = 16 * warp + lane / 4;  // the thread's rows: r0, r0 + 8
    const int t = 2 * pair + wg;
    const int p0 = t * pos_per;
    const bool live = p0 < sq;
    const int qa = p0 + q_offset;
    const int qb = min(p0 + pos_per, sq) - 1 + q_offset;
    uint8_t* q_tile = smem + L::kQ0 + wg * L::kTileBytes;
    const uint32_t q_s = hopper::smem_addr(q_tile);
    const uint32_t do_s = hopper::smem_addr(smem + L::kDO0 +
                                            wg * L::kTileBytes);
    float lse2[2] = {INFINITY, INFINITY}, dlt[2] = {0.f, 0.f};
    int lo[2], hi[2];  // row i sees the keys in [lo[i], hi[i])
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (live) {
        const float2 sv =
            stats[((static_cast<long long>(b) * kvh + kh) * nhc + hc) *
                      tiles * kTile + static_cast<long long>(t) * kTile + r];
        lse2[i] = sv.x;
        dlt[i] = sv.y;
      }
      const int qpos = p0 + r / hb + q_offset;
      hi[i] = causal ? min(sk, qpos + 1) : sk;
      lo[i] = window > 0 ? qpos - window + 1 : 0;
    }
    // dq[4 n + e]: row r0 + 8 (e / 2), column 8 n + 2 quad + e % 2.
    float dq[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dq[e] = 0.f;
    if (live) hopper::mbar_wait(&qd_full[wg], 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int kt = k_begin + j * L::kKeys;
      hopper::mbar_wait(&full[s], (j / kStages) & 1);
      const bool none =
          !live || (causal && kt > qb) ||
          (window > 0 && qa - min(kt + L::kKeys - 1, sk - 1) >= window);
      if (!none) {
        const bool masked = kt + L::kKeys > sk ||
                            (causal && kt + L::kKeys - 1 > qa) ||
                            (window > 0 && qb - kt >= window);
        const uint32_t k_s =
            hopper::smem_addr(smem + L::kKV0 + s * L::kStage);
        const uint32_t v_s = k_s + L::kKeyBytes;
        // sc[4 n + e], dp[4 n + e]: row r0 + 8 (e / 2), key kt + 8 n + 2
        // quad + e % 2.
        float sc[L::kKeys / 2], dp[L::kKeys / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < kCols; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss(
                sc,
                hopper::desc_sw128(q_s + c * kTile * kRowBytes + kk * 32, 16,
                                   1024),
                hopper::desc_sw128(k_s + c * L::kKeys * kRowBytes + kk * 32,
                                   16, 1024),
                c + kk > 0);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss(
                dp,
                hopper::desc_sw128(do_s + c * kTile * kRowBytes + kk * 32, 16,
                                   1024),
                hopper::desc_sw128(v_s + c * L::kKeys * kRowBytes + kk * 32,
                                   16, 1024),
                c + kk > 0);
        hopper::wgmma_commit();
        int klo[2], khi[2];  // the row's visible keys, relative to the quad's
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          klo[i] = lo[i] - kt - 2 * quad;
          khi[i] = hi[i] - kt - 2 * quad;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
#pragma unroll
        for (int n = 0; n < L::kKeys / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * n + e % 2;
            float p = ex2(fmaf(sc[4 * n + e], scale_log2, -lse2[e / 2]));
            if (masked && (key < klo[e / 2] || key >= khi[e / 2])) p = 0.f;
            dp[4 * n + e] = p * (dp[4 * n + e] - dlt[e / 2]) * scale;
          }
        uint32_t dsf[L::kKeys / 16][4];
        pack_frags(dp, dsf);
        hopper::fence_regs(dq);
        hopper::fence_regs(dsf);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::kKeys / 16; ++kk)
          hopper::wgmma_rs(dq, dsf[kk],
                           hopper::desc_sw128(k_s + kk * 16 * kRowBytes,
                                              L::kKeys * kRowBytes, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq);
        hopper::fence_regs(dsf);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // dq as bf16 over the warpgroup's own Q tile (its S products are done),
    // then one TMA store a 64-column block, which leaves out the rows past
    // P hb and past Sq and the columns past hd.
    if (live) {
      store_rows<HD>(q_tile, kTile * kRowBytes, r0, dq, quad);
      hopper::fence_async();
      hopper::named_bar_sync(1 + wg, 128);
      if (tid == 0) {
        for (int c = 0; c < kCols; ++c)
          hopper::tma_store_4d(&dqmap, q_tile + c * kTile * kRowBytes, 64 * c,
                               kh * g + hc * hb, p0, b);
        hopper::tma_store_commit_and_wait_read();
        hopper::tma_store_wait_all();
      }
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled is a driver function; fetched through the
// runtime so that the library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 tensor [n3, n2, n1, hd] (row-major) in boxes of
// [1, box2, box1, 64], 128-byte swizzled.
CUresult make_map(CUtensorMap* map, const void* ptr, int hd, int n1, int n2,
                  int n3, int box1, int box2) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2),
                              static_cast<cuuint64_t>(n3)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * n1, row * n1 * n2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box1),
                             static_cast<cuuint32_t>(box2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float2* stats, void* dq,
           void* dk, void* dv, int b, int sq, int sk, int h, int kvh, int hd,
           int hb, int tiles, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  using LK = DkdvLayout<HD>;
  using LQ = DqLayout<HD>;
  auto dkdv = flash_bwd_wgmma_dkdv<HD>;
  auto dqk = flash_bwd_wgmma_dq<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, LK::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = h / kvh;
  const int nhc = g / hb;
  const int pos_per = kTile / hb;
  const long long n_rows =
      static_cast<long long>(b) * kvh * nhc * tiles * kTile;
  const long long kv_items =
      static_cast<long long>((sk + LK::kKeys - 1) / LK::kKeys) * b * kvh;
  const long long q_items = static_cast<long long>((tiles + 1) / 2) * b *
                            kvh * nhc;
  if ((n_rows + 15) / 16 > 0x7fffffffLL || kv_items > 0x7fffffffLL ||
      q_items > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // With Sq or Sk = 0 no tile of that side is read; the maps still need an
  // extent and an address.
  const int sq_map = sq > 0 ? sq : 1;
  const int sk_map = sk > 0 ? sk : 1;
  const void* qp = sq > 0 ? q : k;
  const void* dop = sq > 0 ? dout : k;
  const void* kp = sk > 0 ? k : q;
  const void* vp = sk > 0 ? v : q;
  static_assert(LK::kKeys == LQ::kKeys, "both passes read 128-key boxes");
  CUtensorMap qmap{}, domap{}, dqmap{}, kmap{}, vmap{}, dkmap{}, dvmap{};
  CUresult r = make_map(&qmap, qp, hd, h, sq_map, b, hb, pos_per);
  if (r == CUDA_SUCCESS) r = make_map(&domap, dop, hd, h, sq_map, b, hb,
                                      pos_per);
  if (r == CUDA_SUCCESS) r = make_map(&kmap, kp, hd, kvh, sk_map, b, 1,
                                      LK::kKeys);
  if (r == CUDA_SUCCESS) r = make_map(&vmap, vp, hd, kvh, sk_map, b, 1,
                                      LK::kKeys);
  if (sk > 0) {
    if (r == CUDA_SUCCESS) r = make_map(&dkmap, dk, hd, kvh, sk, b, 1, 64);
    if (r == CUDA_SUCCESS) r = make_map(&dvmap, dv, hd, kvh, sk, b, 1, 64);
  }
  if (sq > 0 && r == CUDA_SUCCESS)
    r = make_map(&dqmap, dq, hd, h, sq, b, hb, pos_per);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  const float scale_log2 = scale * kLog2e;
  if (n_rows > 0)
    flash_bwd_wgmma_delta<<<static_cast<unsigned>((n_rows + 15) / 16), 256,
                            0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), lse, stats, n_rows, sq, h,
        kvh, hd, hb, tiles);
  if (kv_items > 0)
    dkdv<<<static_cast<unsigned>(kv_items), kThreads, LK::kBytes, stream>>>(
        qmap, domap, kmap, vmap, dkmap, dvmap, stats, b, sq, sk, kvh, g,
        hb, tiles, causal, window, q_offset, scale, scale_log2);
  if (q_items > 0)
    dqk<<<static_cast<unsigned>(q_items), kThreads, LQ::kBytes, stream>>>(
        qmap, domap, kmap, vmap, dqmap, stats, b, sq, sk, kvh, g, hb,
        tiles, causal, window, q_offset, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments: q, k, v, o, do (bf16, contiguous, 16-byte aligned), lse
// (float32 [B, H, Sq], the forward's), stats (float32 scratch of
// B kv (g / hb) tiles 64 (lse, delta) pairs), dq, dk, dv (bf16 outputs),
// b, sq, sk, h, kvh, hd (a multiple of 8 up to 128), hd_pad (64 or 128),
// hb (the largest divisor of H / kv up to 64), tiles (Sq over 64 / hb,
// rounded up), causal, window, q_offset, scale, stream.  hd_pad, hb and
// tiles are the wrapper's bwd_variant and bwd_tiles; this entry point
// checks them.  Every element of dq, dk and dv is written.  Returns a
// cudaError_t, or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int repro_flash_attention_bwd_wgmma(const char* packed) {
  const PackedArgs a{packed};
  const void* q = a.ptr<const void>(0);
  const void* k = a.ptr<const void>(1);
  const void* v = a.ptr<const void>(2);
  const void* o = a.ptr<const void>(3);
  const void* dout = a.ptr<const void>(4);
  const float* lse = a.ptr<const float>(5);
  float2* stats = a.ptr<float2>(6);
  void* dq = a.ptr<void>(7);
  void* dk = a.ptr<void>(8);
  void* dv = a.ptr<void>(9);
  const int b = a.i32(10), sq = a.i32(11), sk = a.i32(12), h = a.i32(13),
            kvh = a.i32(14), hd = a.i32(15), hd_pad = a.i32(16),
            hb = a.i32(17), tiles = a.i32(18), causal = a.i32(19),
            window = a.i32(20), q_offset = a.i32(21);
  const float scale = a.f32(22);
  cudaStream_t s = static_cast<cudaStream_t>(a.ptr<void>(23));
  if (hd % 8 != 0 || hd < 8 || hd > hd_pad || hd_pad - hd >= 64 || kvh < 1 ||
      h % kvh != 0 || hb < 1 || hb > kTile || (h / kvh) % hb != 0 ||
      tiles != (sq + kTile / hb - 1) / (kTile / hb))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd_pad == 64)
    return launch<64>(q, k, v, o, dout, lse, stats, dq, dk, dv, b, sq, sk, h,
                      kvh, hd, hb, tiles, causal, window, q_offset, scale, s);
  if (hd_pad == 128)
    return launch<128>(q, k, v, o, dout, lse, stats, dq, dk, dv, b, sq, sk,
                       h, kvh, hd, hb, tiles, causal, window, q_offset, scale,
                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}
