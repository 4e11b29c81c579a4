// Flash attention, backward, float32 at hd 136 to 256, on Hopper's TF32
// tensor cores with a three-term split (sm_90a).  The wrapper's
// bwd_variant table sends float32 above hd 128 here; float32 up to hd 128
// takes flash_attention_bwd_tf32.cu, bf16 flash_attention_bwd_wgmma.cu (up
// to hd 128) and flash_attention_bwd_wgmma256.cu (above).
//
// The counterpart of the reference's custom VJP of its chunked flash
// attention (src/repro/models/flash.py, _flash_bwd), which the TPU runs in
// XLA ops, not in a Pallas kernel.  Given q [B, Sq, H, hd], k, v
// [B, Sk, kv, hd], the forward's output o, its float32 log-sum-exp lse
// [B, H, Sq] and the output's gradient do, it returns dq, dk and dv in
// float32 with the forward's masks (absolute positions q_pos = position +
// q_offset; k_pos < Sk; causal: k_pos <= q_pos; window > 0: q_pos - k_pos <
// window) and GQA (head h reads kv head h / (H / kv); dk and dv sum over
// the group).  Arithmetic, the reference's: delta = sum over hd of o do;
// s = (q k) scale; p = exp(s - lse), 0 where masked; dv += p do; dp = do v;
// ds = p (dp - delta) scale; dq += ds k; dk += ds q.  A masked p is
// selected to 0 before the exponential (its argument becomes -inf), so the
// lse of a row that sees no key (-1e30) is never exponentiated and the
// row's gradients are zero.
//
// Numerics, those of flash_attention_bwd_tf32.cu.  Each operand x is split
// into hi, x rounded to TF32 (cvt.rna.tf32.f32's rule), and lo = x - hi,
// which the mma reads as TF32; a product a b is taken as hi_a lo_b + lo_a
// hi_b + hi_a hi_b, three mma.sync.m16n8k8 TF32 products into one float32
// accumulator, the small terms first.  S^T and dP^T (S and dP) are summed
// by chunks of 32 columns of hd, each in a fresh accumulator added in
// float32 in a fixed order: the first half of the chunks and the second
// apart, then the two sums; each tile's share of dk, dv and dq is taken in
// a fresh accumulator and added in float32 registers, in a fixed order.
// p = 2^(s scale log2e - lse log2e) by the SFU's ex2.approx.
// tests/test_torch_flash_bwd_tf32.py transcribes this arithmetic and these
// tiles and holds them to jax.vjp of the reference on the CPU (2e-4); one
// TF32 product there misses the limit.
//
// What bounds it: operations.  At gemma3-12b's heads (B 4, S 1024, H 16,
// kv 8, hd 256, causal) the backward's five products over the visible
// pairs take 10 B H hd pairs = 85.98 GFLOP; three TF32 products of them at
// the TF32 tensor cores' 495 TFLOP/s take 0.5211 ms.  This design takes
// seven: the dq pass computes s and dp again, so that no sum needs
// atomics; its floor is 7 / 5 of the bound, 0.7296 ms.
//
// Why not flash_attention_bwd_tf32.cu at these head dims: there a warp
// owns 16 keys over the whole head dim, and dK and dV of them at hd 256
// take 256 float32 registers a thread (at hd 128 they take 128 and the
// kernel sits at 255 registers); K and V of its 128 resident keys in rows
// of hd_pad + 4 floats take 266,240 bytes, over the 232,448 a block may
// have.  Here a block holds 64 keys (or rows), and two warps share each 16
// of them, splitting the head dim: each holds dK and dV (dQ) of its own
// columns, at most 128 floats a thread.
//
// Design: three kernels, no atomics, so two calls give the same bits.
//  - flash_bwd_tf32x3_256_delta: one warp a (batch, position, head) row
//    sums o do over hd, 16 bytes a lane, by a fixed butterfly.
//  - flash_bwd_tf32x3_256_dkdv: a block is (batch, kv head, 64 keys), 8
//    warps, 4 pairs of 16 keys, K and V resident in shared memory.  It
//    walks the group's g heads' query rows flattened position-major (row =
//    position g + head, as the forward's blocks), in tiles of 16 from the
//    first row that can see one of its keys to the last: the sum over the
//    group is this walk, in a fixed order.  Key-major products: S^T = K
//    Q^T and dP^T = V dO^T, then P^T and dS^T = P^T (dP^T - delta) scale
//    feed dV += P^T dO and dK += dS^T Q from the accumulators.
//  - flash_bwd_tf32x3_256_dq: a block is (batch, kv head, 64 flattened
//    query rows), 8 warps, 4 pairs of 16 rows, Q and dO resident; it walks
//    key tiles of 16 and takes S = Q K^T, dP = dO V^T, dS, then dQ += dS K;
//    the blocks of the latest (heaviest, under a causal mask) rows launch
//    first.
//  - The pair (design (b), exchange).  Each warp of a pair takes half the
//    32-column chunks of S^T and dP^T (S and dP) over the tile, both
//    write their partial tiles into the staging tile (free between the
//    tile's split and the next tile's copies), and each adds the other's
//    to its own: the first half's sum plus the second's, the same bits in
//    both warps.  Then each takes the tile's product over its own columns:
//    the first warp the first 128, the second the rest (128 at hd 256, 64
//    at hd 192), a block of 64 columns never split.  The recompute of
//    design (a), each warp of the pair computing S^T and dP^T whole (nine
//    products, as flash_attention_bwd_wgmma256.cu does), was tried first
//    and ran slower than SDPA's float32 backward: each warp then read the
//    resident and streamed tiles of the whole hd from shared memory every
//    tile (128 KB a warp a tile in dk/dv at hd 256, against 84 KB here),
//    and the time followed those bytes.
//  Both passes are one template (bwd_pass): resident rows A1, A2 (K, V or
//  Q, dO) against streamed tiles B1, B2 (Q, dO or K, V).
//  - Loads and splits, flash_attention_bwd_tf32.cu's.  The resident rows
//    come once by 16-byte cp.async (rows of hd_pad + 4 floats, zero-filled
//    past hd and past the last row); a warp reads its A fragments by
//    ldmatrix and splits them in registers.  A streamed tile comes by
//    cp.async into a staging tile; after a barrier the block splits it
//    once into hi and lo halves, after a second barrier the warps compute
//    their partials, and once the pairs have exchanged them the next
//    tile's copies start (under the tile's product).
//  - Each half of B1 and B2 is read two ways: as the B operand of S or
//    S^T (16 bytes of a row a lane, by ldmatrix) and as the B operand of
//    the tile's product (one float a lane).  The halves are stored with
//    rows of hd_pad floats and the 16-byte chunks of row r XORed by
//    ((r & 3) << 3) | (r & 4) floats, which keeps both reads free of bank
//    conflicts without a transposed copy.
//  - The key permutation: S's (S^T's) B fragment reads item n / 2 + 4 (n %
//    2) into column n, so the accumulator's columns 2 t and 2 t + 1 hold
//    items t and t + 4, which are the A fragment's columns of P (P^T) and
//    dS (dS^T) in the tile's product; no shuffle.
//  - Tiles that lie wholly outside the mask for a pair are skipped (they
//    would add exact zeros); only a pair's edge tiles are masked.
//  - Why not wgmma: TF32 wgmma reads B from shared memory only K-major
//    (flash_attention.cu's header), and the products here read each
//    operand both ways.
//
// Shared memory: 4 (2 * 64 (hd_pad + 4) + 2 * 16 (hd_pad + 4) +
// 4 * 16 hd_pad + 64) bytes: 232,192 at hd_pad 256 (256 to spare of a
// block's 232,448; no room for a second stage or a buffer of its own for
// the partials), 174,848 at 192; one block of 8 warps an SM.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8, on the card's machine):
// at hd_pad 256, dk/dv 255 registers with 12 bytes of spill stores (12 of
// loads), dq 255 with 16 (24); at 192, dk/dv 255 with 20 (20), dq 244 with
// none; delta 42.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRes = 16 * kWarps / 2;  // resident keys or rows a block
constexpr int kTile = 16;              // streamed rows or keys a tile
constexpr int kOwn = 16;  // 8-column tiles of hd the first warp of a pair owns

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 4 float32 matrices from shared memory, each lane giving one row
// address (lanes 8 i to 8 i + 7 the rows of matrix i): lane 4 r + c gets
// element (r, c) of matrix i in x[i], the tf32 mma's fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&x)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(addr));
}

// x = hi + lo.  hi is x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds, in two integer operations);
// lo = x - hi is exact in float32, and the mma reads it as TF32 by dropping
// its low 13 bits.
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi,
                                      uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// 2^x by the SFU (ex2.approx: at most 2 ulp from 2^x; 2^-inf is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a b, one m16n8k8 TF32 product with float32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, one m16n8k8 TF32 product, the accumulator's input zero.
__device__ __forceinline__ void mma_zero(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d (+)= a b in three TF32 products, the small terms first; FIRST: d = a b.
template <bool FIRST>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint32_t b_hi0,
                                     uint32_t b_hi1, uint32_t b_lo0,
                                     uint32_t b_lo1) {
  if (FIRST)
    mma_zero(d, a_hi, b_lo0, b_lo1);
  else
    mma(d, a_hi, b_lo0, b_lo1);
  mma(d, a_lo, b_hi0, b_hi1);
  mma(d, a_hi, b_hi0, b_hi1);
}

// The XOR (in floats, a multiple of 4) that moves the 16-byte chunks of
// row r of a half: row r's chunk at column c is stored at column c ^ swz(r).
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

// Shared memory of a block, in floats: the resident rows A1, A2 as loaded
// ([2][64][hd_pad + 4]); the streamed tile B1, B2 as loaded
// ([2][16][hd_pad + 4]), which also carries the warps' partial X and Y
// ([8][16][32 lanes]) once the tile is split; the halves of B1 and B2,
// swizzled ([B1 hi, B1 lo, B2 hi, B2 lo][16][hd_pad]); the dk/dv pass's row
// statistics (lse, delta) as loaded and in use ([2][2][16]).
template <int HDP>
struct Smem {
  static constexpr int RS = HDP + 4;
  static constexpr int kStage = kRes * 2 * RS;
  static constexpr int kHalves = kStage + 2 * kTile * RS;
  static constexpr int kHalf = kTile * HDP;
  static constexpr int kStats = kHalves + 4 * kHalf;
  static constexpr int kFloats = kStats + 4 * kTile;
};

// The float offset of the item (key or flattened query row) in k, v or in
// q, do: keys [B, Sk, kv, hd], rows [B, Sq, H, hd] with row = position g +
// head of the group.
struct Layout {
  int b, sq, sk, h, kvh, kh, g, hd;
  __device__ __forceinline__ long long key(int j) const {
    return ((static_cast<long long>(b) * sk + j) * kvh + kh) * hd;
  }
  __device__ __forceinline__ long long row(int r) const {
    return ((static_cast<long long>(b) * sq + r / g) * h + kh * g + r % g) *
           hd;
  }
  __device__ __forceinline__ long long stat(int r) const {  // lse, delta
    return (static_cast<long long>(b) * h + kh * g + r % g) * sq + r / g;
  }
};

// DKDV: the resident items are 64 keys (A1 = K, A2 = V) and the streamed
// ones the group's flattened query rows (B1 = Q, B2 = dO); out1 is dk, out2
// dv.  Else the resident items are 64 flattened rows (A1 = Q, A2 = dO), the
// streamed ones keys (B1 = K, B2 = V), out1 is dq.  Both warps of a pair
// take the pair's 16 resident items against all 16 items of a tile: each
// its half of the chunks of X and Y, then each its own columns.
template <int HDP, bool DKDV>
__device__ __forceinline__ void bwd_pass(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ out1, float* __restrict__ out2, int sq, int sk, int h,
    int kvh, int hd, int causal, int window, int q_offset, float scale) {
  using S = Smem<HDP>;
  constexpr int NT = HDP / 8;    // 8-column tiles of hd
  constexpr int NCW = NT / 8;    // 32-column chunks a warp takes of X, Y
  constexpr int RS = S::RS;
  constexpr int VECS = HDP / 4;  // 16-byte vectors a row
  constexpr int kHalf = S::kHalf;
  constexpr unsigned kF = sizeof(float);
  static_assert(NT > kOwn && NT <= 2 * kOwn && NT % 8 == 0,
                "hd_pad 192 or 256");
  static_assert(kWarps * 16 * 32 <= 2 * kTile * RS,
                "the partials fit the staging tile");
  const int g = h / kvh;
  // One block a (batch, kv head, resident block), the resident block
  // slowest: the heaviest under a causal mask (the first keys, the last
  // rows) for every head launch first, which balances the SMs' loads.
  const int rows_total = sq * g;
  const int n_res = DKDV ? sk : rows_total;
  const int n_str = DKDV ? rows_total : sk;
  const int n_blk = (n_res + kRes - 1) / kRes;
  const int heads = static_cast<int>(gridDim.x) / n_blk;  // B kv
  const int blk = static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;
  const Layout at{bh / kvh, sq, sk, h, kvh, bh % kvh, g, hd};
  const int res0 = (DKDV ? blk : n_blk - 1 - blk) * kRes;
  const float scale2 = scale * kLog2e;  // scores in log2 units

  extern __shared__ float4 smem4[];
  float* res = reinterpret_cast<float*>(smem4);  // [A1, A2][kRes][RS]
  float* stage = res + S::kStage;                // [B1, B2][kTile][RS]
  float* halves = res + S::kHalves;              // [4][kTile][HDP]
  float* st_stage = res + S::kStats;             // [lse, delta][kTile]
  float* st_cur = st_stage + 2 * kTile;          // [lse log2e, delta][kTile]
  const uint32_t* hv = reinterpret_cast<const uint32_t*>(halves);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int t4 = lane % 4;
  const int grp = warp / 2;   // the pair: 16 resident items
  const int half = warp % 2;  // its chunks of X, Y and its columns
  // The partials of X and Y in the staging tile, [warp][16][32 lanes].
  float* mine = stage + warp * 16 * 32 + lane;
  const float* other = stage + (warp ^ 1) * 16 * 32 + lane;

  // The streamed items that can meet a resident one of this block.
  int s_begin, s_end;
  if (DKDV) {
    const int k_last = min(res0 + kRes, sk) - 1;
    const int p_lo = causal ? max(0, res0 - q_offset) : 0;
    const int p_end = window > 0 ? min(sq, k_last + window - q_offset) : sq;
    s_begin = p_lo * g;
    s_end = p_end * g;
  } else {
    const int last = min(res0 + kRes, rows_total) - 1;
    s_end = causal ? min(sk, last / g + q_offset + 1) : sk;
    s_begin = window > 0 ? max(0, res0 / g + q_offset - window + 1) : 0;
  }
  const int tiles = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile
                                    : 0;

  // This pair's resident items; this warp's columns (8-column tiles c0 to
  // c0 + ncol: the first warp the first 128 columns, the second the rest).
  const int w0 = res0 + 16 * grp;
  const bool w_any = w0 < n_res;
  const bool w_full = w0 + 15 < n_res;
  const int w_last = min(w0 + 15, n_res - 1);
  const int c0 = kOwn * half;
  const int ncol = min(kOwn, NT - c0);

  const float* a1 = DKDV ? k : q;
  const float* a2 = DKDV ? v : dout;
  const float* b1 = DKDV ? q : k;
  const float* b2 = DKDV ? dout : v;

  // The resident rows, once; items past n_res and columns past hd are 0.
  if (tiles > 0) {
#pragma unroll 4
    for (int it = 0; it < kRes * VECS / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / VECS;
      const int d = (idx % VECS) * 4;
      const int item = res0 + r;
      const bool ok = item < n_res && d < hd;
      const long long off =
          ok ? (DKDV ? at.key(item) : at.row(item)) + d : 0;
      cp_async16(res + r * RS + d, a1 + off, ok);
      cp_async16(res + (kRes + r) * RS + d, a2 + off, ok);
    }
  }

  auto load_tile = [&](int j0) {
    static_assert(kTile * VECS % kThreads == 0, "whole loads a thread");
#pragma unroll
    for (int it = 0; it < kTile * VECS / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / VECS;
      const int d = (idx % VECS) * 4;
      const int item = j0 + r;
      const bool ok = item < n_str && d < hd;
      const long long off =
          ok ? (DKDV ? at.row(item) : at.key(item)) + d : 0;
      cp_async16(stage + r * RS + d, b1 + off, ok);
      cp_async16(stage + (kTile + r) * RS + d, b2 + off, ok);
    }
    if (DKDV && tid < 2 * kTile) {
      const int item = j0 + tid % kTile;
      const bool ok = item < rows_total;
      const long long off = ok ? at.stat(item) : 0;
      cp_async4(st_stage + tid, (tid < kTile ? lse : delta) + off, ok);
    }
  };

  // Split the loaded tile once for the block into the swizzled halves (and
  // take the rows' lse to log2 units).
  auto split_tile = [&]() {
#pragma unroll
    for (int it = 0; it < 2 * kTile * VECS / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int which = idx / (kTile * VECS);
      const int rem = idx % (kTile * VECS);
      const int r = rem / VECS;
      const int c = (rem % VECS) * 4;
      const float4 x = *reinterpret_cast<const float4*>(
          stage + (which * kTile + r) * RS + c);
      const float xe[4] = {x.x, x.y, x.z, x.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__float_as_uint(xe[e]), hi[e], lo[e]);
      float* dst = halves + 2 * which * kHalf + r * HDP + (c ^ swz(r));
      *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + kHalf) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (DKDV && tid < 2 * kTile)
      st_cur[tid] = tid < kTile ? st_stage[tid] * kLog2e : st_stage[tid];
  };

  if (tiles > 0) load_tile(s_begin);
  cp_async_commit();

  float acc1[kOwn][4], acc2[DKDV ? kOwn : 1][4];
#pragma unroll
  for (int n = 0; n < kOwn; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[n][e] = 0.f;
      if constexpr (DKDV) acc2[n][e] = 0.f;
    }

  // The dq pass's rows: lane (gid, t4) holds rows gid and gid + 8 of the
  // pair's 16, their positions, lse in log2 units and delta.
  int rpos[2] = {0, 0};
  bool rlive[2] = {false, false};
  float rlse[2] = {0.f, 0.f}, rdelta[2] = {0.f, 0.f};
  if (!DKDV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w0 + gid + 8 * i;
      rlive[i] = row < rows_total;
      rpos[i] = row / g + q_offset;
      if (rlive[i] && tiles > 0) {
        rlse[i] = lse[at.stat(row)] * kLog2e;
        rdelta[i] = delta[at.stat(row)];
      }
    }
  }

  // ldmatrix row addresses (lane 8 i + r gives row r of matrix i), at the
  // warp's first chunk.  A (resident, rows of RS floats): (rows 0-7 | 8-15)
  // x (columns 0-3 | 4-7) of an 8-column step.  B1, B2 halves for S:
  // (columns 0-3 | 4-7) x (items 0-7 | 8-15), column n of an 8-item tile
  // reading item n / 2 + 4 (n % 2), at column step kk & 3 of each 32 (the
  // swizzle).
  const int mi = lane / 8;
  const int mr = lane % 8;
  const unsigned chunk0 = 32 * NCW * half * kF;
  const unsigned a_addr =
      smem_addr(res + (16 * grp + mr + 8 * (mi & 1)) * RS + 4 * (mi >> 1)) +
      chunk0;
  constexpr unsigned kA2 = kRes * RS * kF;  // A1 -> A2
  unsigned b_addr[4];
  {
    const int r = 8 * (mi >> 1) + (mr >> 1) + 4 * (mr & 1);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      b_addr[s] =
          smem_addr(halves + r * HDP + ((8 * s + 4 * (mi & 1)) ^ swz(r))) +
          chunk0;
  }
  // One float a lane for the tile's product: B(k = item t4 (+ 4), n =
  // column gid) of an 8-column tile at column step n & 3 of each 32, at
  // the warp's first column.
  int p_b0[4], p_b1[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    p_b0[s] = t4 * HDP + 8 * c0 + ((8 * s + gid) ^ swz(t4));
    p_b1[s] = (t4 + 4) * HDP + 8 * c0 + ((8 * s + gid) ^ swz(t4 + 4));
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's halves are free
    const int j0 = s_begin + t * kTile;
    split_tile();
    __syncthreads();  // tile t's halves are in place, the staging tile free

    // The pairs' key and position ranges: skip a tile wholly outside the
    // mask (both warps of a pair alike), mask only an edge tile.
    const int j_last = min(j0 + kTile - 1, n_str - 1);
    const bool full = w_full && j0 + kTile - 1 < n_str;
    const int k_lo = DKDV ? w0 : j0;
    const int k_hi = DKDV ? w_last : j_last;
    const int pos_lo = (DKDV ? j0 : w0) / g + q_offset;
    const int pos_hi = (DKDV ? j_last : w_last) / g + q_offset;
    const bool live = w_any && !((causal && k_lo > pos_hi) ||
                                 (window > 0 && pos_lo - k_hi >= window));
    const bool edge = !full || (causal && k_hi > pos_lo) ||
                      (window > 0 && pos_hi - k_lo >= window);

    // X = A1 B1^T and Y = A2 B2^T over the tile's 16 items (two 8-item
    // tiles), this warp's chunks of 32 columns of hd, each added in
    // float32; the pair adds its two partials through the staging tile.
    float x[2][4], y[2][4];
    if (live) {
#pragma unroll
      for (int c = 0; c < 4 * NCW; c += 4) {
        float px[2][4], py[2][4];
#pragma unroll
        for (int kk = c; kk < c + 4; ++kk) {
          uint32_t r1[4], r2[4], a1h[4], a1l[4], a2h[4], a2l[4];
          ldmatrix_x4(r1, a_addr + 8 * kk * kF);
          ldmatrix_x4(r2, a_addr + kA2 + 8 * kk * kF);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split(r1[e], a1h[e], a1l[e]);
            split(r2[e], a2h[e], a2l[e]);
          }
          const unsigned ba = b_addr[kk & 3] + 32 * (kk >> 2) * kF;
          uint32_t b1h[4], b1l[4], b2h[4], b2l[4];
          ldmatrix_x4(b1h, ba);
          ldmatrix_x4(b1l, ba + kHalf * kF);
          ldmatrix_x4(b2h, ba + 2 * kHalf * kF);
          ldmatrix_x4(b2l, ba + 3 * kHalf * kF);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (kk == c) {
              mma3<true>(px[j], a1h, a1l, b1h[2 * j], b1h[2 * j + 1],
                         b1l[2 * j], b1l[2 * j + 1]);
              mma3<true>(py[j], a2h, a2l, b2h[2 * j], b2h[2 * j + 1],
                         b2l[2 * j], b2l[2 * j + 1]);
            } else {
              mma3<false>(px[j], a1h, a1l, b1h[2 * j], b1h[2 * j + 1],
                          b1l[2 * j], b1l[2 * j + 1]);
              mma3<false>(py[j], a2h, a2l, b2h[2 * j], b2h[2 * j + 1],
                          b2l[2 * j], b2l[2 * j + 1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[j][e] = c == 0 ? px[j][e] : x[j][e] + px[j][e];
            y[j][e] = c == 0 ? py[j][e] : y[j][e] + py[j][e];
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mine[32 * i] = x[i / 4][i % 4];
        mine[32 * (8 + i)] = y[i / 4][i % 4];
      }
    }
    __syncthreads();  // the partials are in place
    if (live) {
      // first half's + second half's, the same bits in both warps
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i / 4][i % 4] += other[32 * i];
        y[i / 4][i % 4] += other[32 * (8 + i)];
      }
    }
    __syncthreads();  // the staging tile is free
    if (t + 1 < tiles) load_tile(j0 + kTile);
    cp_async_commit();
    if (!live) continue;

    // P and dS in place of X and Y.  Of 8-item tile j a lane holds items
    // j0 + 8 j + t4 (elements 0, 2) and j0 + 8 j + t4 + 4 (1, 3) of its
    // resident items gid (0, 1) and gid + 8 (2, 3).
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = 8 * j + t4 + 4 * (e % 2);  // item in the tile
        const int ri = w0 + gid + 8 * (e / 2);    // resident item
        const float l2 = DKDV ? st_cur[ii] : rlse[e / 2];
        const float dl = DKDV ? st_cur[kTile + ii] : rdelta[e / 2];
        bool ok = true;
        if (edge) {
          const int item = j0 + ii;
          const int key = DKDV ? ri : item;
          const int row = DKDV ? item : ri;
          const int pos = DKDV ? row / g + q_offset : rpos[e / 2];
          ok = (DKDV ? row < rows_total : rlive[e / 2]) & (key < sk) &
               (!causal | (key <= pos)) &
               ((window <= 0) | (pos - key < window));
        }
        // a masked p is selected to 0 before the exponential
        const float p =
            exp2_approx(ok ? fmaf(x[j][e], scale2, -l2) : -INFINITY);
        x[j][e] = p;
        y[j][e] = p * (y[j][e] - dl) * scale;
      }

    // The A fragments of P and dS for the tile's product: A column t4 is
    // item t4 (elements 0 and 2), column t4 + 4 item t4 + 4 (1 and 3).
    uint32_t p_hi[2][4], p_lo[2][4], d_hi[2][4], d_lo[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split(__float_as_uint(x[j][0]), p_hi[j][0], p_lo[j][0]);
      split(__float_as_uint(x[j][2]), p_hi[j][1], p_lo[j][1]);
      split(__float_as_uint(x[j][1]), p_hi[j][2], p_lo[j][2]);
      split(__float_as_uint(x[j][3]), p_hi[j][3], p_lo[j][3]);
      split(__float_as_uint(y[j][0]), d_hi[j][0], d_lo[j][0]);
      split(__float_as_uint(y[j][2]), d_hi[j][1], d_lo[j][1]);
      split(__float_as_uint(y[j][1]), d_hi[j][2], d_lo[j][2]);
      split(__float_as_uint(y[j][3]), d_hi[j][3], d_lo[j][3]);
    }

    // The tile's product over this warp's columns, each 8-column tile in a
    // fresh accumulator added in float32: dk/dv: dV += P^T dO (B2), dK +=
    // dS^T Q (B1); dq: dQ += dS K (B1).
#pragma unroll
    for (int n = 0; n < kOwn; ++n) {
      if (n >= ncol) break;
      float pa[4], pb[4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int o0 = 8 * s * HDP + 32 * (n >> 2) + p_b0[n & 3];
        const int o1 = 8 * s * HDP + 32 * (n >> 2) + p_b1[n & 3];
        const uint32_t bh0 = hv[o0], bh1 = hv[o1];
        const uint32_t bl0 = hv[kHalf + o0], bl1 = hv[kHalf + o1];
        if (s == 0)
          mma3<true>(pa, d_hi[s], d_lo[s], bh0, bh1, bl0, bl1);
        else
          mma3<false>(pa, d_hi[s], d_lo[s], bh0, bh1, bl0, bl1);
        if constexpr (DKDV) {
          const uint32_t ch0 = hv[2 * kHalf + o0], ch1 = hv[2 * kHalf + o1];
          const uint32_t cl0 = hv[3 * kHalf + o0], cl1 = hv[3 * kHalf + o1];
          if (s == 0)
            mma3<true>(pb, p_hi[s], p_lo[s], ch0, ch1, cl0, cl1);
          else
            mma3<false>(pb, p_hi[s], p_lo[s], ch0, ch1, cl0, cl1);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc1[n][e] += pa[e];
        if constexpr (DKDV) acc2[n][e] += pb[e];
      }
    }
  }
  cp_async_wait_all();

  // Every resident item is written, its columns by the warp that owns
  // them, zeros for one that meets no streamed item.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int item = w0 + gid + 8 * i;
    if (item >= n_res) continue;
    const long long off =
        (DKDV ? at.key(item) : at.row(item)) + 8 * c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kOwn; ++n) {
      if (n >= ncol || 8 * (c0 + n) >= hd) break;
      *reinterpret_cast<float2*>(out1 + off + 8 * n) =
          make_float2(acc1[n][2 * i], acc1[n][2 * i + 1]);
      if constexpr (DKDV)
        *reinterpret_cast<float2*>(out2 + off + 8 * n) =
            make_float2(acc2[n][2 * i], acc2[n][2 * i + 1]);
    }
  }
}

// delta[b, h, i] = sum over hd of o do, one warp a row of o [B, Sq, H, hd],
// 16 bytes a lane.
__global__ void __launch_bounds__(kThreads)
    flash_bwd_tf32x3_256_delta(const float* __restrict__ o,
                               const float* __restrict__ dout,
                               float* __restrict__ delta, long long rows,
                               int sq, int h, int hd) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float4* a = reinterpret_cast<const float4*>(o + row * hd);
  const float4* c = reinterpret_cast<const float4*>(dout + row * hd);
  float acc = 0.f;
  for (int d = lane; d < hd / 4; d += 32) {
    const float4 x = a[d], y = c[d];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
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
    flash_bwd_tf32x3_256_dkdv(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int sq, int sk, int h, int kvh, int hd,
                              int causal, int window, int q_offset,
                              float scale) {
  bwd_pass<HDP, true>(q, k, v, dout, lse, delta, dk, dv, sq, sk, h, kvh, hd,
                      causal, window, q_offset, scale);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_tf32x3_256_dq(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int sq, int sk, int h,
                            int kvh, int hd, int causal, int window,
                            int q_offset, float scale) {
  bwd_pass<HDP, false>(q, k, v, dout, lse, delta, dq, nullptr, sq, sk, h, kvh,
                       hd, causal, window, q_offset, scale);
}

template <int HDP>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int b, int sq, int sk, int h, int kvh,
           int hd, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * Smem<HDP>::kFloats;
  static_assert(smem <= 232448, "more shared memory than a block can have");
  auto dkdv = flash_bwd_tf32x3_256_dkdv<HDP>;
  auto dqk = flash_bwd_tf32x3_256_dq<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = h / kvh;
  const long long rows = static_cast<long long>(b) * sq * h;
  if (rows > 0) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_tf32x3_256_delta<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(o, dout, delta, rows, sq, h, hd);
  }
  // (batch, kv head) fastest, the resident block slowest (bwd_pass).
  const long long kv_blocks =
      static_cast<long long>(b) * kvh * ((sk + kRes - 1) / kRes);
  const long long q_blocks =
      static_cast<long long>(b) * kvh * ((sq * g + kRes - 1) / kRes);
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_blocks > 0)
    dkdv<<<static_cast<unsigned>(kv_blocks), kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sq, sk, h, kvh, hd, causal, window,
        q_offset, scale);
  if (q_blocks > 0)
    dqk<<<static_cast<unsigned>(q_blocks), kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dq, sq, sk, h, kvh, hd, causal, window,
        q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments, those of repro_flash_attention_bwd_tf32: q, k, v, o, do
// (float32, contiguous, 16-byte aligned), lse (float32 [B, H, Sq], the
// forward's), delta (float32 [B, H, Sq] scratch), dq, dk, dv (float32
// outputs), b, sq, sk, h, kvh, hd (a multiple of 8 from 136 to 256), hd_pad
// (hd rounded up to a multiple of 64), dtype (0, float32: anything else is
// refused), causal, window, q_offset, scale, stream.  Every element of dq,
// dk and dv is written (zeros for keys no row sees and rows that see no
// key).
extern "C" int repro_flash_attention_bwd_tf32_256(const char* packed) {
  const PackedArgs a{packed};
  const float* q = a.ptr<const float>(0);
  const float* k = a.ptr<const float>(1);
  const float* v = a.ptr<const float>(2);
  const float* o = a.ptr<const float>(3);
  const float* dout = a.ptr<const float>(4);
  const float* lse = a.ptr<const float>(5);
  float* delta = a.ptr<float>(6);
  float* dq = a.ptr<float>(7);
  float* dk = a.ptr<float>(8);
  float* dv = a.ptr<float>(9);
  const int b = a.i32(10), sq = a.i32(11), sk = a.i32(12), h = a.i32(13),
            kvh = a.i32(14), hd = a.i32(15), hd_pad = a.i32(16),
            dtype = a.i32(17), causal = a.i32(18), window = a.i32(19),
            q_offset = a.i32(20);
  const float scale = a.f32(21);
  cudaStream_t s = static_cast<cudaStream_t>(a.ptr<void>(22));
  if (hd % 8 != 0 || hd <= 128 || hd > 256 || kvh < 1 || h % kvh != 0 ||
      hd_pad != (hd + 63) / 64 * 64 || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd_pad == 192)
    return launch<192>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, h,
                       kvh, hd, causal, window, q_offset, scale, s);
  return launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, h,
                     kvh, hd, causal, window, q_offset, scale, s);
}
