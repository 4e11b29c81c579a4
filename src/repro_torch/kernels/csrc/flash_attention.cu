// Flash attention, forward, float32, on Hopper's TF32 tensor cores with a
// three-term split (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py,
// flash_attention (_flash_fwd_kernel), for float32 inputs: blockwise
// online-softmax attention of q [B, Sq, H, hd] over k, v [B, Sk, kv, hd]
// with GQA (head h reads kv head h / (H / kv)), masks on absolute positions
// (q_pos = row + q_offset; k_pos < Sk; causal: k_pos <= q_pos; window > 0:
// q_pos - k_pos < window), the softmax state (m, l, acc) in float32,
// acc / max(l, 1e-30) at the end and the output in q's dtype.  bf16 inputs
// take the wgmma kernel of flash_attention_wgmma.cu.
//
// Numerics.  One TF32 product keeps 11 bits of each operand (2^-11
// relative), far from the reference's float32 limit (2e-5).  So each
// operand x is split into hi, x rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna.tf32.f32 rounds, in two integer operations), and
// lo = x - hi, exact in float32, which the mma reads as TF32 by dropping
// its low 13 bits; a product a b is taken as hi_a lo_b + lo_a hi_b +
// hi_a hi_b, three mma.sync.m16n8k8 TF32 products into one float32
// accumulator, the small terms first.  What is left out, lo_a lo_b and
// lo's dropped bits, is about 2^-21 relative.  The mma rounds each sum
// toward zero, so a long chain of them in one accumulator drifts (a row's
// whole P V in one chain drifted measurably from float64 attention on the
// H100): S is summed by chunks of 32 columns of hd and O by key tiles, each
// chunk added in float32 registers.  Scores are scaled to log2
// units; the running max m, p = 2^(s - m) (the SFU's ex2.approx), l and O
// stay in float32; masked probabilities are set to 0 explicitly, so a row
// that sees no key gives zeros.  tests/test_torch_flash_attention.py
// transcribes this arithmetic (attention_tf32x3) and holds it to the JAX
// kernel on the CPU; one TF32 product there misses 2e-5.
//
// What bounds it: operations.  At the sequence forward's shapes (B 8,
// S 1024, H 32, kv 8, hd 128, causal) the two products take
// 4 B H hd S(S+1)/2 = 68.8 GFLOP; three TF32 products of them at the TF32
// tensor cores' 495 TFLOP/s take 0.417 ms (one float32 product on the CUDA
// cores, 67 TFLOP/s, 1.03 ms); the 336 MB of q, k, v and out take 0.100 ms
// at 3.35 TB/s.  mma.sync does not reach wgmma's peak:
// tools/mma_sync_tf32_peak.py measures its TF32 rate, this design's floor.
//
// Design (FA2's shape on warp-level mma.sync).  A block is (batch, kv
// head, 128 query rows; 64 above hd 128), the rows of a kv head being its
// g = H / kv query heads at every position, flattened position-major
// (row = pos * g + head in group), so every K/V tile staged in shared
// memory serves the g heads that read it; the blocks of the latest
// (heaviest, under a causal mask) rows are launched first.  A warp owns 16
// rows: its S tile (16 x keys) and its O (16 x hd) live in its registers,
// in the mma accumulator layout (lane 4 gid + t holds rows gid and
// gid + 8).  hd is padded with zeros to a multiple of 64 (hd_pad), so that
// every loop and offset is fixed at compile time.
//  - Loads and splits.  Q is staged once by cp.async; a warp splits its A
//    fragments in registers at each 8-column step.  K and V come a tile of
//    32 keys (16 at hd 256) at a time by 16-byte cp.async (zero-filled past
//    Sk and hd) into one staging tile; after a barrier the block splits it
//    once into K's halves and V's halves transposed ([hd][keys]), so that
//    every B fragment, hi or lo, is one ldmatrix; after a second barrier
//    the next tile's copies start and the warps compute.  (Splitting
//    K and V in registers by every warp that reads them, 8 times over in a
//    block, was slower on the H100.)  Rows are padded against bank
//    conflicts: Q and K rows hold hd_pad + 4 floats, V's transposed rows
//    keys + 4.
//  - Tiles that lie wholly above the causal diagonal or wholly below the
//    window of every row are skipped, by the block and by each warp for
//    its own rows: in the TPU kernel such a tile leaves (m, l, acc) as
//    they were, so the skip changes no result.  Only a warp's edge tiles
//    are masked.
//  - P V takes P from S's accumulator in registers.  For m16n8k8 TF32 the
//    accumulator's columns of a lane (2t, 2t + 1) are not the A fragment's
//    (t, t + 4), so the tile's keys are permuted instead of shuffling P:
//    S's B fragment reads key n / 2 + 4 (n % 2) into column n, so that the
//    accumulator's columns 2t and 2t + 1 hold keys t and t + 4, which are
//    the A fragment's columns of P, and V's rows are read in key order.
//    The mask uses those key positions.
//  - The softmax: a row's values sit on a quad of lanes, its max reduced
//    with __shfl_xor_sync over offsets 1 and 2; l is kept per lane and
//    summed over the quad at the end.
//  - The log-sum-exp for the backward (flash_attention_bwd_tf32*.cu): an
//    instantiation of its own writes each row's m ln 2 + log l (m in log2
//    units) to lse [B, H, Sq] from the quad's first lane, -1e30 for a row
//    that sees no key; the serving instantiation writes nothing more.
//  - Why not wgmma: TF32 wgmma reads B from shared memory only K-major, so
//    V ([keys, hd], hd contiguous) would need a transposed copy, and the
//    halves of K and V would double float32 tiles that are already twice
//    bf16's, past 227 KB at two stages.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 255 registers a thread
// at hd_pad 128 with 12 bytes spilled, 175 at 64 with none; 255 at 192 and
// 256, with 272 and 140 bytes spilled.
// Shared memory: 4 (rows (hd_pad + 4) + 4 keys (hd_pad + 4) +
// 2 hd_pad (keys + 4)) bytes: 88 KB at hd_pad 64, 172 KB at 128 (one
// block of 8 warps an SM), 206 KB at 192, 174 KB at 256.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// 2^x by the SFU (ex2.approx: at most 2 ulp from 2^x; flushes subnormals).
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

// HDP: the head dim as the kernel's tiles hold it (hd padded with zeros
// to a multiple of 64); WARPS a block, 16 rows each; KEYS: keys a tile.
template <int HDP, int WARPS, int KEYS>
struct Tiles {
  static constexpr int kRows = 16 * WARPS;  // (position, head) rows
  static constexpr int QS = HDP + 4;   // Q and K rows, floats
  static constexpr int KP = KEYS + 4;  // rows of V transposed ([hd][keys])
  // Floats of shared memory: Q; K and V as loaded; K's halves; V's
  // halves, transposed.
  static constexpr int kQ = kRows * QS;
  static constexpr int kStage = 2 * KEYS * QS;
  static constexpr int kFloats = kQ + kStage + 2 * KEYS * QS + 2 * HDP * KP;
};

// NG: O's 8-column tiles that P V takes at once.  LSE: the instantiation
// that writes the log-sum-exp (the other one is the serving forward's).
template <int HDP, int WARPS, int NG, int KEYS, bool LSE>
__global__ void __launch_bounds__(32 * WARPS)
    flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int h, int kvh,
                     int hd, int causal, int window, int q_offset,
                     float scale) {
  using T = Tiles<HDP, WARPS, KEYS>;
  constexpr int NT = HDP / 8;  // 8-column tiles of hd
  constexpr int kKeyTiles = KEYS / 8;
  constexpr int kWarpRows = 16;
  constexpr int kRows = T::kRows;
  constexpr int kThreads = 32 * WARPS;
  constexpr int QS = T::QS;
  constexpr int KP = T::KP;
  constexpr int VECS = HDP / 4;  // 16-byte vectors a row
  const int g = h / kvh;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_total = sq * g;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const float scale2 = scale * kLog2e;  // scores in log2 units: p = 2^(s - m)

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* stage = qs + T::kQ;                    // [K, V][KEYS][QS]
  float* khi = stage + T::kStage;               // [KEYS][QS]
  float* klo = khi + KEYS * QS;                 // [KEYS][QS]
  float* vthi = klo + KEYS * QS;                // [HDP][KP]
  float* vtlo = vthi + HDP * KP;                // [HDP][KP]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int t4 = lane % 4;

  // Key tiles with any visible (row, key) pair of this block.
  const int last = min(r0 + kRows, rows_total) - 1;
  const int k_end = causal ? min(sk, last / g + q_offset + 1) : sk;
  const int k_begin = window > 0 ? max(0, r0 / g + q_offset - window + 1) : 0;
  const int tiles = k_end > k_begin ? (k_end - k_begin + KEYS - 1) / KEYS : 0;

  // The same for this warp's rows; a warp with no live row skips all.
  const int w_r0 = r0 + kWarpRows * warp;
  const int w_last = min(w_r0 + kWarpRows - 1, rows_total - 1);
  const int w_p_lo = w_r0 / g + q_offset;
  const int w_p_hi = w_last / g + q_offset;
  const int w_k_end = w_r0 >= rows_total ? 0
                      : causal           ? min(sk, w_p_hi + 1)
                                         : sk;
  const int w_k_begin = window > 0 ? max(0, w_p_lo - window + 1) : 0;
  const bool w_full = w_r0 + kWarpRows - 1 < rows_total;

  // Lane (gid, t4) holds rows gid and gid + 8 of the warp's 16.
  int qpos[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w_r0 + gid + 8 * i;
    live[i] = row < rows_total;
    qpos[i] = row / g + q_offset;
  }

  // 16-byte vectors past hd, and rows past Sk or Sq, are zero-filled.
  const float* k_head = k + (static_cast<long long>(b) * sk * kvh + kh) * hd;
  const float* v_head = v + (static_cast<long long>(b) * sk * kvh + kh) * hd;
  const int key_stride = kvh * hd;  // floats from one key to the next
  auto load_tile = [&](int k0) {
    float* kd = stage;
    float* vd = kd + KEYS * QS;
    static_assert(KEYS * VECS % kThreads == 0, "whole loads a thread");
#pragma unroll
    for (int it = 0; it < KEYS * VECS / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int c = idx / VECS;
      const int d = (idx % VECS) * 4;
      const int key = k0 + c;
      const bool ok = key < sk && d < hd;
      const long long at = ok ? static_cast<long long>(key) * key_stride + d
                              : 0;
      cp_async16(kd + c * QS + d, k_head + at, ok);
      cp_async16(vd + c * QS + d, v_head + at, ok);
    }
  };

  // Split a loaded tile once for the block: K into its halves, V into its
  // halves transposed, so that every B fragment is one ldmatrix.  A lane
  // takes one key of 32 consecutive ones, so the transposed stores of a
  // warp fall in 32 banks.
  auto split_tile = [&]() {
    const float* kd = stage;
    const float* vd = kd + KEYS * QS;
#pragma unroll
    for (int it = 0; it < KEYS * VECS / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int c = idx % KEYS;
      const int d = idx / KEYS * 4;
      const float4 kx = *reinterpret_cast<const float4*>(kd + c * QS + d);
      const float4 vx = *reinterpret_cast<const float4*>(vd + c * QS + d);
      const float ke[4] = {kx.x, kx.y, kx.z, kx.w};
      const float ve[4] = {vx.x, vx.y, vx.z, vx.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__float_as_uint(ke[e]), hi[e], lo[e]);
      *reinterpret_cast<uint4*>(khi + c * QS + d) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(klo + c * QS + d) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t vh, vl;
        split(__float_as_uint(ve[e]), vh, vl);
        reinterpret_cast<uint32_t*>(vthi)[(d + e) * KP + c] = vh;
        reinterpret_cast<uint32_t*>(vtlo)[(d + e) * KP + c] = vl;
      }
    }
  };

  if (tiles > 0) {
#pragma unroll 4
    for (int it = 0; it < kRows * VECS / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / VECS;
      const int d = (idx % VECS) * 4;
      const int row = r0 + r;
      const bool ok = row < rows_total && d < hd;
      const long long at =
          ok ? ((static_cast<long long>(b) * sq + row / g) * h + kh * g +
                row % g) * hd + d
             : 0;
      cp_async16(qs + r * QS + d, q + at, ok);
    }
    load_tile(k_begin);
  }
  cp_async_commit();

  float m_r[2], l_r[2], acc[NT][4];
  m_r[0] = m_r[1] = kNegInf;
  l_r[0] = l_r[1] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // ldmatrix row addresses (lane 8 i + r gives row r of matrix i).  Q:
  // (rows 0-7 | 8-15) x (columns 0-3 | 4-7) of the warp's 8-column step.
  // K: (columns 0-3 | 4-7) x (key tile j | j + 1), S's column n of a key
  // tile reading key n / 2 + 4 (n % 2) (see the header).  V transposed:
  // (keys 0-3 | 4-7) x (hi | lo) of an 8-column tile of hd.
  const int mi = lane / 8;
  const int mr = lane % 8;
  constexpr unsigned kF = sizeof(float);
  const unsigned q_addr = smem_addr(
      qs + (kWarpRows * warp + mr + 8 * (mi & 1)) * QS + 4 * (mi >> 1));
  const unsigned k_addr = smem_addr(
      khi + (8 * (mi >> 1) + (mr >> 1) + 4 * (mr & 1)) * QS + 4 * (mi & 1));
  constexpr unsigned kKLo = KEYS * QS * kF;  // khi -> klo
  const unsigned v_addr =
      smem_addr((mi < 2 ? vthi : vtlo) + mr * KP + 4 * (mi & 1));

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's halves are free
    const int k0 = k_begin + t * KEYS;
    split_tile();
    __syncthreads();  // tile t's halves are in place, the loaded tile free
    if (t + 1 < tiles) load_tile(k0 + KEYS);
    cp_async_commit();
    if (k0 >= w_k_end || k0 + KEYS <= w_k_begin) continue;

    // S = Q K^T, accumulated in float32 registers by chunks of 32 columns
    // of hd: the mma rounds each sum toward zero, so a long chain of them
    // in one accumulator drifts.
    float s[kKeyTiles][4];
#pragma unroll
    for (int c = 0; c < NT; c += 4) {
      float part[kKeyTiles][4];
#pragma unroll
      for (int kk = c; kk < c + 4; ++kk) {
        uint32_t b_hi[kKeyTiles][2], b_lo[kKeyTiles][2];
#pragma unroll
        for (int jp = 0; jp < kKeyTiles / 2; ++jp) {
          uint32_t x[4];
          ldmatrix_x4(x, k_addr + (16 * jp * QS + 8 * kk) * kF);
          b_hi[2 * jp][0] = x[0];
          b_hi[2 * jp][1] = x[1];
          b_hi[2 * jp + 1][0] = x[2];
          b_hi[2 * jp + 1][1] = x[3];
          ldmatrix_x4(x, k_addr + kKLo + (16 * jp * QS + 8 * kk) * kF);
          b_lo[2 * jp][0] = x[0];
          b_lo[2 * jp][1] = x[1];
          b_lo[2 * jp + 1][0] = x[2];
          b_lo[2 * jp + 1][1] = x[3];
        }
        uint32_t raw[4], a_hi[4], a_lo[4];
        ldmatrix_x4(raw, q_addr + 8 * kk * kF);
#pragma unroll
        for (int x = 0; x < 4; ++x) split(raw[x], a_hi[x], a_lo[x]);
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          if (kk == c)
            mma3<true>(part[j], a_hi, a_lo, b_hi[j][0], b_hi[j][1],
                       b_lo[j][0], b_lo[j][1]);
          else
            mma3<false>(part[j], a_hi, a_lo, b_hi[j][0], b_hi[j][1],
                        b_lo[j][0], b_lo[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = c == 0 ? part[j][e] : s[j][e] + part[j][e];
    }

    // Online softmax, in log2 units.  Of key tile j a lane holds keys
    // k0 + 8 j + t4 (elements 0, 2) and k0 + 8 j + t4 + 4 (1, 3) of rows
    // gid (0, 1) and gid + 8 (2, 3).
    const bool edge = !w_full || k0 + KEYS > sk ||
                      (causal && k0 + KEYS - 1 > w_p_lo) ||
                      (window > 0 && w_p_hi - k0 >= window);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    if (edge) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int key = k0 + 8 * j + t4 + 4 * (e % 2);
          const bool ok = live[i] & (key < sk) &
                          (!causal | (key <= qpos[i])) &
                          ((window <= 0) | (qpos[i] - key < window));
          s[j][e] = ok ? s[j][e] : kNegInf;
        }
    }
    float alpha[2];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = exp2_approx(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        // a masked score is kNegInf: its p is 0, as the TPU kernel sets it
        // (2^(s - m) is 1 there while the row has seen no key)
        const float e2 = exp2_approx(s[j][e] - m_r[i]);
        const float p = s[j][e] > 0.5f * kNegInf ? e2 : 0.f;
        s[j][e] = p;
        l_r[i] += p;
      }

    // O = alpha O + P V, P from S's accumulator: A column t4 is key t4
    // (elements 0 and 2) and column t4 + 4 is key t4 + 4 (1 and 3).  Each
    // 8-column tile of O sums the tile's keys in its own accumulator,
    // added to O in float32.
    uint32_t p_hi[kKeyTiles][4], p_lo[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      split(__float_as_uint(s[j][0]), p_hi[j][0], p_lo[j][0]);
      split(__float_as_uint(s[j][2]), p_hi[j][1], p_lo[j][1]);
      split(__float_as_uint(s[j][1]), p_hi[j][2], p_lo[j][2]);
      split(__float_as_uint(s[j][3]), p_hi[j][3], p_lo[j][3]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      float part[NG][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          uint32_t x[4];  // hi b0, hi b1, lo b0, lo b1
          ldmatrix_x4(x, v_addr + (8 * (n0 + n) * KP + 8 * j) * kF);
          if (j == 0)
            mma3<true>(part[n], p_hi[j], p_lo[j], x[0], x[1], x[2], x[3]);
          else
            mma3<false>(part[n], p_hi[j], p_lo[j], x[0], x[1], x[2], x[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e / 2], part[n][e]);
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!live[i]) continue;
    const int row = w_r0 + gid + 8 * i;
    const long long at =
        (static_cast<long long>(b) * sq + row / g) * h + kh * g + row % g;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    // The row's log-sum-exp of its scaled scores, m (log2 units) + log l,
    // for the backward; -1e30 for a row that sees no key.
    if (LSE && t4 == 0)
      lse[(static_cast<long long>(b) * h + kh * g + row % g) * sq + row / g] =
          l > 0.f ? m_r[i] * kLn2 + logf(l) : kNegInf;
    float* out = o + at * hd + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < hd)
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
            acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int HDP, int WARPS, int NG, int KEYS>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int b, int sq, int sk, int h, int kvh, int hd,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  using T = Tiles<HDP, WARPS, KEYS>;
  constexpr int kRows = T::kRows;
  constexpr size_t smem = sizeof(float) * T::kFloats;
  static_assert(smem <= 232448, "more shared memory than a block can have");
  auto kernel = lse != nullptr ? flash_fwd_tf32x3<HDP, WARPS, NG, KEYS, true>
                               : flash_fwd_tf32x3<HDP, WARPS, NG, KEYS, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int g = h / kvh;
  const dim3 grid((sq * g + kRows - 1) / kRows, kvh, b);
  kernel<<<grid, 32 * WARPS, smem, stream>>>(q, k, v, o, lse, sq, sk, h, kvh,
                                             hd, causal, window, q_offset,
                                             scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments: q, k, v, o (float32, every pointer 16-byte aligned),
// b, sq, sk, h, kvh, hd (a multiple of 8 up to 256), hd_pad (hd rounded up
// to a multiple of 64), key_tile, causal, window, q_offset, scale,
// stream, lse (float32 [B, H, Sq], written when not null).  A tiling that
// the wrapper names and the kernel was not built for is refused: key_tile
// is 32 up to hd_pad 192 and 16 at 256 (shared memory).
extern "C" int repro_flash_attention_tf32x3(const char* packed) {
  const PackedArgs a{packed};
  const float* q = a.ptr<const float>(0);
  const float* k = a.ptr<const float>(1);
  const float* v = a.ptr<const float>(2);
  float* o = a.ptr<float>(3);
  const int b = a.i32(4), sq = a.i32(5), sk = a.i32(6), h = a.i32(7),
            kvh = a.i32(8), hd = a.i32(9), hd_pad = a.i32(10),
            key_tile = a.i32(11), causal = a.i32(12), window = a.i32(13),
            q_offset = a.i32(14);
  const float scale = a.f32(15);
  cudaStream_t s = static_cast<cudaStream_t>(a.ptr<void>(16));
  float* lse = a.ptr<float>(17);
  if (hd % 8 != 0 || hd < 8 || hd > 256 || kvh < 1 || h % kvh != 0 ||
      hd_pad != (hd + 63) / 64 * 64 || key_tile != (hd_pad <= 192 ? 32 : 16))
    return static_cast<int>(cudaErrorInvalidValue);
  // 8 warps of 16 rows up to hd 128; above, shared memory holds 4.
  switch (hd_pad) {
    case 64:
      return launch<64, 8, 8, 32>(q, k, v, o, lse, b, sq, sk, h, kvh, hd,
                                  causal, window, q_offset, scale, s);
    case 128:
      return launch<128, 8, 16, 32>(q, k, v, o, lse, b, sq, sk, h, kvh, hd,
                                    causal, window, q_offset, scale, s);
    case 192:
      return launch<192, 4, 8, 32>(q, k, v, o, lse, b, sq, sk, h, kvh, hd,
                                   causal, window, q_offset, scale, s);
    default:
      return launch<256, 4, 8, 16>(q, k, v, o, lse, b, sq, sk, h, kvh, hd,
                                   causal, window, q_offset, scale, s);
  }
}
