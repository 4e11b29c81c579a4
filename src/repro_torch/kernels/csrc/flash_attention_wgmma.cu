// Flash attention, forward, bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py,
// flash_attention (_flash_fwd_kernel), for bfloat16 inputs: blockwise
// online-softmax attention of q [B, Sq, H, hd] over k, v [B, Sk, kv, hd]
// with GQA (head h reads kv head h / (H / kv)), masks on absolute positions
// (q_pos = row + q_offset; k_pos < Sk; causal: k_pos <= q_pos; window > 0:
// q_pos - k_pos < window), acc / max(l, 1e-30) at the end, bf16 out.  The
// float32 path is flash_attention.cu: one TF32 product is too coarse for
// the TPU kernel's float32 limit (2e-5), three (each operand split into
// two TF32 halves) hold it.
//
// Numerics.  S = Q K^T on bf16 tiles with float32 accumulation (bf16 x bf16
// products are exact in float32, so only the order of summation differs
// from the TPU kernel).  Scale, mask, running max m, exp and the sums l and
// acc stay in float32 as _flash_fwd_kernel keeps them; masked
// probabilities are set to 0 explicitly (its jnp.where(mask, p, 0.0)), so
// a row that sees no key gives zeros.  The one new rounding: p is rounded
// to bf16 before P V (at most 2^-9 relative on each p; l sums the float32
// p).  The exponentials are exp2 of log2(e)-scaled scores.
//
// What bounds it: operations.  At the sequence forward's shapes (B 8,
// S 1024, H 32, kv 8, hd 128, causal) the two products take
// 4 B H hd S(S+1)/2 = 68.8 GFLOP, 0.070 ms at the bf16 tensor cores' 989
// TFLOP/s; the 168 MB of q, k, v and out take 0.050 ms at 3.35 TB/s.
//
// Design (the FA3 shape).  A work item is (batch, kv head, 128 query
// rows), the rows of a kv head being its g = H / kv query heads at every
// position, flattened position-major (row = position * hb + head), so each
// K/V tile staged once serves every head that reads it: hb, the heads an
// item holds, is the largest divisor of g up to 128, and an item holds
// P = 128 / hb whole positions of them (P hb <= 128 rows).  The kernel is
// persistent: one block an SM walks the items in a static round robin,
// for causal masks the latest (heaviest) row tiles first, so that the
// triangle ends evenly.  384 threads: two consumer warpgroups of 64 rows
// each and a producer warpgroup in which one thread issues every TMA load
// and another every TMA store; setmaxnreg moves registers from the
// producer (24) to the consumers (240).
//  - Loads: TMA with 128-byte swizzling, tensor maps q [B, Sq, H, hd] (box
//    [1, P, hb, 64]) and k, v [B, Sk, kv, hd] (box [1, keys, 1, 64]); the
//    head dim is cut into 64-wide column blocks (a 128-byte swizzle row),
//    and a box reaching past hd, Sk or Sq fills with zeros, so hd 8 or 120
//    is padded to 64 or 128 in shared memory and the ragged key edge reads
//    zeros.  Q is double-buffered where shared memory allows (hd <= 192),
//    so the next item's Q lands while this one runs.  K and V go through
//    rings of 2 to 4 stages with their own "full" barriers (TMA byte
//    counts) and "empty" barriers (one arrival a consumer warp): K_j is
//    free once S_j is done, V_j once P_j V_j is, and the producer loads V
//    one tile behind K, the order the consumers take them in.
//  - Products: S (64 x keys a warpgroup) by wgmma m64nNk16 with Q and K
//    from shared memory (both K-major); O += P V by one m64n(hd)k16 per 16
//    keys with P from registers (the float32 accumulator layout of S,
//    converted to bf16 pairs, is the A fragment layout) and V MN-major (the
//    transpose bit; its 64-column blocks one leading-byte offset apart).
//    Keys per tile: 128 at hd <= 128, 64 at hd 192 and 256, where O alone
//    takes 96 or 128 registers a thread.  S_{j+1} and P_j V_j are issued
//    together, and tile j+1's softmax runs while P_j V_j is on the tensor
//    cores (FA3's overlap within a warpgroup).
//  - Softmax: each row's values sit on a quad of lanes, reduced with
//    __shfl_xor_sync over offsets 1 and 2; l is kept per thread and summed
//    over the quad at the end.  Only tiles that straddle an edge (the
//    diagonal, the window, Sk) are masked, each row by its range of
//    visible keys; tiles wholly above the diagonal or below the window are
//    skipped, which is exact since such a tile leaves (m, l, acc) as they
//    were.
//  - Output: acc / max(l, 1e-30) as bf16 into the item's own Q buffer in
//    the swizzled layout, then TMA stores, which leave out the rows past Sq
//    and the columns past hd.  For the training path's backward
//    (flash_attention_bwd_wgmma*.cu) an instantiation of its own writes each
//    row's log-sum-exp, m scale + log l in float32, to lse [B, H, Sq] from
//    the lane that owns the row (-1e30 for a row that sees no key); the
//    serving forward's instantiation writes nothing more than before.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "packed_args.cuh"

namespace {

constexpr int kRows = 128;     // query rows (position, head) an item
constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr int kRowBytes = 128; // one swizzled row: 64 bf16
constexpr float kNeg = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kSmem = 232448;  // shared memory a block may take
constexpr int kSlack = 1024 + 256;  // alignment, then the barriers

// Shared memory of one block, every tile on a 1,024-byte boundary: two Q
// buffers where they fit beside two K and two V stages (else one), then
// rings of as many K and V stages as fit (at most 4).
template <int HD, int BC>
struct Layout {
  static constexpr int kCols = HD / 64;                   // column blocks
  static constexpr int kQ = kCols * kRows * kRowBytes;    // one Q tile
  static constexpr int kKV = kCols * BC * kRowBytes;      // one K or V tile
  static constexpr int kQBufs = kSmem - kSlack >= 2 * kQ + 4 * kKV ? 2 : 1;
  static constexpr int kFit = (kSmem - kSlack - kQBufs * kQ) / (2 * kKV);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kK0 = kQBufs * kQ;                 // K ring
  static constexpr int kV0 = kK0 + kStages * kKV;         // V ring
  static constexpr int kBars = kV0 + kStages * kKV;       // barriers
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

// One work item: a (batch, kv head, head block, row tile) and its keys.
struct Work {
  int b, kh, hc, p0, p_lo, p_hi, k_begin, n_tiles;
};

// Work item w.  For causal masks the row tiles run latest (heaviest)
// first, so that the static round robin over blocks ends evenly.
template <int BC>
__device__ __forceinline__ Work work_item(int w, int per_tile, int tiles,
                                          int pos_per, int nhc, int kvh,
                                          int sq, int sk, int causal,
                                          int window, int q_offset) {
  Work x;
  int t = w / per_tile;
  if (causal) t = tiles - 1 - t;
  const int id = w % per_tile;
  x.hc = id % nhc;
  x.kh = (id / nhc) % kvh;
  x.b = id / (nhc * kvh);
  x.p0 = t * pos_per;
  x.p_lo = x.p0 + q_offset;
  x.p_hi = min(x.p0 + pos_per, sq) - 1 + q_offset;
  const int k_end = causal ? min(sk, x.p_hi + 1) : sk;
  x.k_begin = window > 0 ? max(0, x.p_lo - window + 1) : 0;
  x.n_tiles = k_end > x.k_begin ? (k_end - x.k_begin + BC - 1) / BC : 0;
  return x;
}

// LSE: the instantiation that writes the log-sum-exp; the other one is
// the serving forward's, which does no more work than before lse existed.
template <int HD, int BC, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    float* __restrict__ lse, int sq, int sk, int h, int kvh,
                    int hb, int tiles, int items, int causal, int window,
                    int q_offset, float scale_log2) {
  using L = Layout<HD, BC>;
  constexpr int kCols = L::kCols;
  constexpr int kStages = L::kStages;
  constexpr int kQBufs = L::kQBufs;
  static_assert(BC == 64 || BC == 128, "keys a tile: one n64 or n128 product");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;                    // [kQBufs] each
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* o_full = q_empty + kQBufs;
  uint64_t* k_full = o_full + kQBufs;         // [kStages] each
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int g = h / kvh;
  const int pos_per = kRows / hb;             // positions an item
  const int rows = pos_per * hb;              // rows an item (<= kRows)
  const int nhc = g / hb;                     // items a position
  const int per_tile = items / tiles;         // items a row tile
  auto item = [&](int w) {
    return work_item<BC>(w, per_tile, tiles, pos_per, nhc, kvh, sq, sk,
                         causal, window, q_offset);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 1);
      hopper::mbar_init(&o_full[i], 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);  // one arrival a consumer warp
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // Warp-uniform as the compiler sees it, so that setmaxnreg applies.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int kv = 0;  // K/V tiles issued so far
      for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
        const Work x = item(w);
        const int qb = it % kQBufs;
        hopper::mbar_wait(&q_empty[qb], ((it / kQBufs) & 1) ^ 1);
        hopper::mbar_expect_tx(&q_full[qb], kCols * rows * kRowBytes);
        for (int c = 0; c < kCols; ++c)
          hopper::tma_load_4d(smem + qb * L::kQ + c * kRows * kRowBytes,
                              &qmap, &q_full[qb], 64 * c,
                              x.kh * g + x.hc * hb, x.p0, x.b);
        // V runs one tile behind K, the order the consumers take them in.
        auto load = [&](const CUtensorMap* map, uint64_t* full,
                        uint64_t* empty, int ring, int j) {
          const int s = (kv + j) % kStages;
          hopper::mbar_wait(&empty[s], (((kv + j) / kStages) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], L::kKV);
          for (int c = 0; c < kCols; ++c)
            hopper::tma_load_4d(
                smem + ring + s * L::kKV + c * BC * kRowBytes, map, &full[s],
                64 * c, x.kh, x.k_begin + j * BC, x.b);
        };
        if (x.n_tiles > 0) {
          load(&kmap, k_full, k_empty, L::kK0, 0);
          for (int j = 1; j < x.n_tiles; ++j) {
            load(&kmap, k_full, k_empty, L::kK0, j);
            load(&vmap, v_full, v_empty, L::kV0, j - 1);
          }
          load(&vmap, v_full, v_empty, L::kV0, x.n_tiles - 1);
        }
        kv += x.n_tiles;
      }
    } else if (threadIdx.x == 288) {
      // The output: once the consumers have left an item's O in its Q
      // buffer, one TMA store a 64-column block, which leaves out the rows
      // past Sq and the columns past hd; the buffer is free once read.
      for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
        const Work x = item(w);
        const int qb = it % kQBufs;
        hopper::mbar_wait(&o_full[qb], (it / kQBufs) & 1);
        for (int c = 0; c < kCols; ++c)
          hopper::tma_store_4d(&omap,
                               smem + qb * L::kQ + c * kRows * kRowBytes,
                               64 * c, x.kh * g + x.hc * hb, x.p0, x.b);
        hopper::tma_store_commit_and_wait_read();
        hopper::mbar_arrive(&q_empty[qb]);
      }
      hopper::tma_store_wait_all();
    }
  } else {
    // ---------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int r0 = 64 * wg + 16 * warp + lane / 4;  // the thread's rows: r0
                                                    // and r0 + 8

    // acc[4 n + e]: O at row e / 2, column 8 n + 2 quad + e % 2.
    float acc[HD / 2];
    float m[2], l[2];         // running max of the raw scores; this
                              // thread's part of the running sum
    float sc[BC / 2];         // one tile's scores, then probabilities
    uint32_t pf[BC / 16][4];  // the probabilities as bf16 A fragments
    int lo[2], hi[2];         // row i sees the keys in [lo[i], hi[i])
    uint32_t q_base = 0;      // the warpgroup's rows of the item's Q tile
    Work x{};
    int kv = 0;               // K/V tiles consumed so far

    // S = Q K_j^T over hd, 16 columns a product; issued, not waited for.
    auto issue_qk = [&](int j) {
      const int s = (kv + j) % kStages;
      const uint32_t k_base = hopper::smem_addr(smem + L::kK0 + s * L::kKV);
      hopper::mbar_wait(&k_full[s], ((kv + j) / kStages) & 1);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss(
              sc,
              hopper::desc_sw128(q_base + c * kRows * kRowBytes + kk * 32, 16,
                                 1024),
              hopper::desc_sw128(k_base + c * BC * kRowBytes + kk * 32, 16,
                                 1024),
              c + kk > 0);
      hopper::wgmma_commit();
    };
    // O += P_j V_j, 16 keys a product over all of hd; issued, not waited
    // for.  V's 64-column blocks lie BC rows apart.
    auto issue_pv = [&](int j) {
      const int s = (kv + j) % kStages;
      const uint32_t v_base = hopper::smem_addr(smem + L::kV0 + s * L::kKV);
      hopper::mbar_wait(&v_full[s], ((kv + j) / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        hopper::wgmma_rs(acc, pf[kk],
                         hopper::desc_sw128(v_base + kk * 16 * kRowBytes,
                                            BC * kRowBytes, 1024));
      hopper::wgmma_commit();
    };
    // A K or V stage is free once every consumer warp is done with it.
    auto release = [&](uint64_t* empty, int j) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[(kv + j) % kStages]);
    };
    // Online softmax of tile j, in the log2 domain: sc[4 n + e] is row e / 2
    // at key kt + 8 n + 2 quad + e % 2.  Leaves the probabilities in sc,
    // updates m and l, and returns in alpha the factor by which the earlier
    // acc must shrink.  Only a tile that straddles an edge is masked (the
    // test is uniform over the item).
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int kt = x.k_begin + j * BC;
      const bool masked = kt + BC > sk || (causal && kt + BC - 1 > x.p_lo) ||
                          (window > 0 && x.p_hi - kt >= window);
      int klo[2], khi[2];  // the row's visible keys, relative to the quad's
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        klo[i] = lo[i] - kt - 2 * quad;
        khi[i] = hi[i] - kt - 2 * quad;
      }
      if (masked) {
#pragma unroll
        for (int n = 0; n < BC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * n + e % 2;
            if (key < klo[e / 2] || key >= khi[e / 2]) sc[4 * n + e] = kNeg;
          }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < BC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e / 2] = fmaxf(mx[e / 2], sc[4 * n + e]);
      float ms[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = ex2((m[i] - m_new) * scale_log2);
        m[i] = m_new;
        ms[i] = m_new * scale_log2;
      }
#pragma unroll
      for (int n = 0; n < BC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale_log2, -ms[e / 2]));
      if (masked) {  // masked probabilities are 0, not exp2(-1e30 - m)
#pragma unroll
        for (int n = 0; n < BC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * n + e % 2;
            if (key < klo[e / 2] || key >= khi[e / 2]) sc[4 * n + e] = 0.f;
          }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < BC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e / 2] += sc[4 * n + e];
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
    };
    // P as bf16 A fragments, 16 keys a product: the accumulator layout of
    // S two 8-column groups at a time.
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };

    for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
      x = item(w);
      const int qb = it % kQBufs;
      uint8_t* q_tile = smem + qb * L::kQ;
      q_base = hopper::smem_addr(q_tile) + wg * 64 * kRowBytes;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = x.p0 + (r0 + 8 * i) / hb + q_offset;
        hi[i] = causal ? min(sk, qpos + 1) : sk;
        lo[i] = window > 0 ? qpos - window + 1 : 0;
        m[i] = kNeg;
        l[i] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
      hopper::mbar_wait(&q_full[qb], (it / kQBufs) & 1);

      // Tile j's softmax runs while P_{j-1} V_{j-1} is on the tensor cores.
      if (x.n_tiles > 0) {
        float alpha[2];
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_qk(0);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        release(k_empty, 0);
        softmax(0, alpha);  // acc is still 0
        pack();
        for (int j = 1; j < x.n_tiles; ++j) {
          hopper::fence_regs(acc);
          hopper::fence_regs(pf);
          hopper::wgmma_fence();
          issue_qk(j);
          issue_pv(j - 1);
          hopper::wgmma_wait<1>();
          hopper::fence_regs(sc);
          release(k_empty, j);
          softmax(j, alpha);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          hopper::fence_regs(pf);
          release(v_empty, j - 1);
#pragma unroll
          for (int e = 0; e < HD / 2; ++e) acc[e] *= alpha[(e / 2) % 2];
          pack();
        }
        hopper::fence_regs(acc);
        hopper::fence_regs(pf);
        hopper::wgmma_fence();
        issue_pv(x.n_tiles - 1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(v_empty, x.n_tiles - 1);
      }
      kv += x.n_tiles;

      // acc / max(l, 1e-30), the quad's partial sums added first, as bf16
      // over the warpgroup's own rows of the item's Q tile (its S products
      // are done) in the layout TMA reads, for the storing warp.
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        inv[i] = 1.f / fmaxf(lt, 1e-30f);
        // The row's log-sum-exp of its scaled scores, m scale + log l, for
        // the backward, from the quad's first lane; -1e30 for a row that
        // sees no key.  Rows past the item's or past Sq are not written.
        if constexpr (LSE) {
          const int r = r0 + 8 * i;
          const int pos = x.p0 + r / hb;
          if (quad == 0 && r < rows && pos < sq)
            lse[(static_cast<long long>(x.b) * h + x.kh * g + x.hc * hb +
                 r % hb) * sq + pos] =
                lt > 0.f ? m[i] * scale_log2 * kLn2 + logf(lt) : kNeg;
        }
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          *reinterpret_cast<__nv_bfloat162*>(
              q_tile + (n / 8) * kRows * kRowBytes + r * kRowBytes +
              (((n % 8) ^ (r % 8)) * 16) + quad * 4) =
              __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv[i],
                                    acc[4 * n + 2 * i + 1] * inv[i]);
        }
      hopper::fence_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&o_full[qb]);
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

// The map of a bf16 tensor [n3, n2, n1, hd] (row-major) read in boxes of
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

template <int HD, int BC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kvh, int hd, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  using L = Layout<HD, BC>;
  auto kernel = lse != nullptr ? flash_fwd_wgmma<HD, BC, true>
                               : flash_fwd_wgmma<HD, BC, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = h / kvh;
  int hb = g < kRows ? g : kRows;  // heads an item: divides g, <= kRows
  while (g % hb != 0) --hb;
  const int nhc = g / hb;          // items a position
  const int pos_per = kRows / hb;
  const int tiles = (sq + pos_per - 1) / pos_per;
  const long long items = static_cast<long long>(tiles) * nhc * kvh * b;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = items < sms ? static_cast<int>(items) : sms;
  // With Sk = 0 no key tile is read; the maps of k and v still need an
  // extent and an address.
  const int sk_map = sk > 0 ? sk : 1;
  const void* kp = sk > 0 ? k : q;
  const void* vp = sk > 0 ? v : q;
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qmap, kmap, vmap, omap;
  CUresult r = make_map(&qmap, q, hd, h, sq, b, hb, pos_per);
  if (r == CUDA_SUCCESS) r = make_map(&kmap, kp, hd, kvh, sk_map, b, 1, BC);
  if (r == CUDA_SUCCESS) r = make_map(&vmap, vp, hd, kvh, sk_map, b, 1, BC);
  if (r == CUDA_SUCCESS) r = make_map(&omap, o, hd, h, sq, b, hb, pos_per);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  kernel<<<blocks, kThreads, L::kBytes, stream>>>(
      qmap, kmap, vmap, omap, lse, sq, sk, h, kvh, hb, tiles,
      static_cast<int>(items), causal, window, q_offset,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments: q, k, v, o (bf16, contiguous, 16-byte aligned), b, sq,
// sk, h, kvh, hd (a multiple of 8 up to 256), hd_pad, key_tile, causal,
// window, q_offset, scale, stream, lse (float32 [B, H, Sq], written when
// not null).  hd_pad (hd rounded up to 64) and
// key_tile (keys per tile) name the instantiation, as the wrapper's
// variant() chooses them.  Returns a cudaError_t, or 10000 + the CUresult
// of a failed tensor-map encoding.
extern "C" int repro_flash_attention_wgmma(const char* packed) {
  const PackedArgs a{packed};
  const void* q = a.ptr<const void>(0);
  const void* k = a.ptr<const void>(1);
  const void* v = a.ptr<const void>(2);
  void* o = a.ptr<void>(3);
  const int b = a.i32(4), sq = a.i32(5), sk = a.i32(6), h = a.i32(7),
            kvh = a.i32(8), hd = a.i32(9), hd_pad = a.i32(10),
            key_tile = a.i32(11), causal = a.i32(12), window = a.i32(13),
            q_offset = a.i32(14);
  const float scale = a.f32(15);
  void* stream = a.ptr<void>(16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = a.ptr<float>(17);
  if (hd % 8 != 0 || hd < 8 || hd > hd_pad || hd_pad - hd >= 64 || kvh < 1 ||
      h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd_pad == 64 && key_tile == 128)
    return launch<64, 128>(q, k, v, o, lse, b, sq, sk, h, kvh, hd, causal,
                           window, q_offset, scale, s);
  if (hd_pad == 128 && key_tile == 128)
    return launch<128, 128>(q, k, v, o, lse, b, sq, sk, h, kvh, hd, causal,
                            window, q_offset, scale, s);
  if (hd_pad == 192 && key_tile == 64)
    return launch<192, 64>(q, k, v, o, lse, b, sq, sk, h, kvh, hd, causal,
                           window, q_offset, scale, s);
  if (hd_pad == 256 && key_tile == 64)
    return launch<256, 64>(q, k, v, o, lse, b, sq, sk, h, kvh, hd, causal,
                           window, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
