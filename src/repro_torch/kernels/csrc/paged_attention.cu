// Paged decode attention over pool pages, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/paged_attention.py,
// paged_attention (_paged_kernel): one new token per sequence attends over
// its KV pages in the pool [slots, T, kv, hd], page p of sequence b at pool
// slot page_table[b, p].  Only tokens below (length // T) * T count (the
// tail page lives in the caller's write buffer), at most max_pages pages; a
// -1 entry reads slot 0 and a slot past the pool reads the last slot, as
// the TPU kernel and its oracle (jnp indexing clamps) do.  GQA: head h
// reads kv head h / (H / kv).  The output is acc / max(l, 1e-30) in q's
// dtype, so a sequence with no flushed page gives zeros.
//
// What bounds it: bytes, given enough pages in flight.  Per flushed page a
// kv head's block reads T x hd of k and of v and does 4 x g x T x hd float32
// operations on them: at the serving decode shapes (T 16, hd 128, g 4)
// under 2 operations a byte, far below the card's ridge.  At batch 8 with
// ragged lengths (up to 64 pages) a call moves about 14 MB, 4.2 us at
// 3.35 TB/s.  The first design ran one block per (sequence, kv head) that
// walked its pages serially, a page's loads issued only after the previous
// page's fold: 64 blocks for 132 SMs, and the longest sequence's 64 pages
// one after another (600 us; PERF.md, section 6).
//
// Design, flash-decoding style, with the fold of csrc/decode_fold.cuh.
//   * paged_split_kernel, grid (kv head, split, sequence): a block folds a
//     split of `split` consecutive pages (the wrapper's SPLIT_PAGES), warp
//     w the pages w, w + 4, ... of it, each warp keeping its next page's
//     loads in flight while it folds the current one (two page buffers).
//     Its lanes read the warp's table entries beside the sequence's length,
//     so a page costs one round trip after those.  A block past the
//     sequence's flushed pages exits at once.  The block merges its warps'
//     partials in warp order and writes the split's partial record to the
//     float32 scratch.
//   * paged_combine_kernel, grid (kv head, sequence): merges the sequence's
//     split partials in split order (merge_partials) and writes
//     acc / max(l, 1e-30) in q's dtype.
// Every order is fixed by the shapes, so a call is bitwise reproducible.
// A last-block ticket in place of the second kernel (each split block
// takes a ticket from a counter of its (sequence, kv head); the last merges)
// was built and measured: a little less device time in bf16, none in
// float32.  It was dropped: its counters must start at zero, so they live
// in a buffer kept across calls, which calls on two streams would share.
// Splits of 4 and 16 pages, and 8 warps a block, were measured too; 8
// pages on 4 warps was the fastest in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "decode_fold.cuh"
#include "packed_args.cuh"

namespace {

using namespace decode_fold;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBuffers = 2;          // page buffers a warp: current and next
static_assert(kWarps - 1 <= kMaxMerge, "a split's warps merge in one call");

__device__ __forceinline__ int flushed_pages(int length, int t,
                                             int max_pages) {
  return length > 0 ? min(length / t, max_pages) : 0;
}

// kG: the query rows of a kv head for the serving pages (T 16, hd 128,
// g = kG: csrc/decode_fold.cuh, fold_page16), or 0 for any shape
// (fold_page).
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads, 1)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths,
                       float* __restrict__ parts, int h, int kvh, int slots,
                       int t, int hd, int max_pages, int split, int nsplit,
                       float scale) {
  const int kh = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kvh;
  const int gh = g * hd;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int p0 = s * split;

  // lane j of warp w reads the slot of the warp's page j, page p0 + w +
  // j * nwarps, in the same trip as the length
  const int pj = p0 + warp + lane * nwarps;
  int slot = 0;
  if (lane * nwarps < split && pj < max_pages)
    slot = __ldg(table + static_cast<long long>(b) * max_pages + pj);
  const int pages = flushed_pages(__ldg(lengths + b), t, max_pages);
  if (p0 >= pages) return;           // uniform over the block
  slot = slot < 0 ? 0 : min(slot, slots - 1);
  const int in_split = min(split, pages - p0);
  const int mine = warp < in_split ? (in_split - warp + nwarps - 1) / nwarps
                                   : 0;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                    // [g, hd]
  float* ml = q_s + gh;                                 // [m][l] merged
  float* recs = ml + pad4(2 * g);                       // a warp's part each
  const int stride = warp_floats(g, hd, t, sizeof(T), kBuffers);
  float* rec = recs + warp * stride;
  float* s_w = rec + record_floats(g, hd);
  T* kb = reinterpret_cast<T*>(s_w + pad4(g * t + 2 * g));   // [2][T, hd]
  T* vb = kb + kBuffers * t * hd;                            // [2][T, hd]

  const long long tok = static_cast<long long>(kvh) * hd;
  const long long page = static_cast<long long>(t) * tok;
  auto issue = [&](int j) {          // the warp's page j into buffer j % 2
    const long long off = __shfl_sync(0xffffffffu, slot, j) * page + kh * hd;
    const int buf = (j & 1) * t * hd;
    issue_page(kb + buf, vb + buf, k_pool + off, v_pool + off, t, hd, tok,
               lane);
    cp_async_commit();
  };
  for (int j = 0; j < min(kBuffers, mine); ++j) issue(j);
  const long long row0 = static_cast<long long>(b) * h + kh * g;
  load_rows(q_s, q + row0 * hd, gh);
  __syncthreads();
  for (int j = 0; j < mine; ++j) {
    if (j + 1 < mine)
      cp_async_wait<1>();            // page j landed, page j + 1 in flight
    else
      cp_async_wait<0>();
    __syncwarp();
    const int buf = (j & 1) * t * hd;
    if constexpr (kG > 0)
      fold_page16<T, kG>(q_s, kb + buf, vb + buf, s_w, rec, scale, j == 0,
                         lane);
    else
      fold_page<T>(q_s, kb + buf, vb + buf, s_w, rec, g, t, hd, scale, j == 0,
                   lane);
    if (j + kBuffers < mine) issue(j + kBuffers);
  }
  __syncthreads();
  // the warps' partials, in warp order, into warp 0's
  const int used = min(nwarps, in_split);
  const float* ml_split = recs + gh;
  if (used > 1) {
    merge_partials(recs, recs + gh, recs + gh + g, ml, ml + g, recs + stride,
                   stride, used - 1, g, hd);
    ml_split = ml;
  }
  float* rec_out = parts + ((static_cast<long long>(b) * kvh + kh) * nsplit +
                            s) * record_floats(g, hd);
  for (int i = threadIdx.x; i < gh / 4; i += blockDim.x)
    reinterpret_cast<float4*>(rec_out)[i] =
        reinterpret_cast<const float4*>(recs)[i];
  for (int i = threadIdx.x; i < 2 * g; i += blockDim.x)
    rec_out[gh + i] = ml_split[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* __restrict__ parts,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int h, int kvh, int t, int hd, int max_pages,
                         int split, int nsplit) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / kvh;
  const int gh = g * hd;
  extern __shared__ __align__(16) float smem[];
  float* state = smem;                                  // record [o][m][l]
  float* ml_alt = state + record_floats(g, hd);         // [m][l]
  const int pages = flushed_pages(__ldg(lengths + b), t, max_pages);
  const int n = (pages + split - 1) / split;
  for (int i = threadIdx.x; i < gh / 4; i += blockDim.x)
    reinterpret_cast<float4*>(state)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
    state[gh + gi] = kNegInf;
    state[gh + g + gi] = 0.f;
  }
  __syncthreads();
  const float* mine =
      parts + (static_cast<long long>(b) * kvh + kh) * nsplit *
                  record_floats(g, hd);
  float* ml = state + gh;
  for (int base = 0; base < n; base += kMaxMerge) {
    float* ml_next = ml == ml_alt ? state + gh : ml_alt;
    merge_partials(state, ml, ml + g, ml_next, ml_next + g,
                   mine + base * record_floats(g, hd), record_floats(g, hd),
                   min(kMaxMerge, n - base), g, hd);
    ml = ml_next;
  }
  const long long row0 = static_cast<long long>(b) * h + kh * g;
  for (int i = threadIdx.x; i < gh / 4; i += blockDim.x) {
    const float l = fmaxf(ml[g + i * 4 / hd], 1e-30f);
    float4 o = reinterpret_cast<const float4*>(state)[i];
    o.x /= l;
    o.y /= l;
    o.z /= l;
    o.w /= l;
    store4(out + row0 * hd + 4 * i, o);
  }
}

template <typename T, int kG>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const int* lengths, float* parts, int b,
                 int h, int kvh, int slots, int t, int hd, int max_pages,
                 int split, int nsplit, float scale, cudaStream_t stream) {
  const int g = h / kvh;
  const size_t head = sizeof(float) * (g * hd + pad4(2 * g));
  const size_t per_warp =
      sizeof(float) * warp_floats(g, hd, t, sizeof(T), kBuffers);
  if (head + per_warp > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(
      std::min<size_t>(kWarps, (kSmemLimit - head) / per_warp));
  if (split > 32 * warps) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = head + warps * per_warp;
  static size_t allowed = 0;
  const cudaError_t err =
      allow_smem(paged_split_kernel<T, kG>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_split_kernel<T, kG>
      <<<dim3(kvh, nsplit, b), 32 * warps, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), table, lengths, parts, h, kvh,
          slots, t, hd, max_pages, split, nsplit, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* lengths, float* parts, void* out,
           int b, int h, int kvh, int slots, int t, int hd, int max_pages,
           int split, float scale, cudaStream_t stream) {
  const int g = h / kvh;
  const int nsplit = (max_pages + split - 1) / split;
  if (split < 1 || split > 32 * kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsplit > 0) {
    const int err =
        t == 16 && hd == 128 && h == 4 * kvh
            ? launch_split<T, 4>(q, k_pool, v_pool, table, lengths, parts,
                                 b, h, kvh, slots, t, hd, max_pages, split,
                                 nsplit, scale, stream)
            : launch_split<T, 0>(q, k_pool, v_pool, table, lengths, parts,
                                 b, h, kvh, slots, t, hd, max_pages, split,
                                 nsplit, scale, stream);
    if (err != 0) return err;
  }
  const size_t smem = sizeof(float) * (record_floats(g, hd) + pad4(2 * g));
  static size_t allowed = 0;
  const cudaError_t err = allow_smem(paged_combine_kernel<T>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<T><<<dim3(kvh, b), kThreads, smem, stream>>>(
      parts, lengths, static_cast<T*>(out), h, kvh, t, hd, max_pages, split,
      nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed arguments: dtype (0 = float32, 1 = bfloat16; q, the pools and out
// share it), q, k_pool, v_pool, table, lengths, parts (float32 scratch of
// b x kvh x ceil(max_pages / split) partial records), out, b, h, kvh,
// slots, t, hd, max_pages, split, scale, stream.  q, the pools, parts and
// out 16-byte aligned, hd x the element size a multiple of 16 bytes (the
// wrapper checks both).
extern "C" int repro_paged_attention(const char* packed) {
  const PackedArgs a{packed};
  const int dtype = a.i32(0);
  const void* q = a.ptr<const void>(1);
  const void* k_pool = a.ptr<const void>(2);
  const void* v_pool = a.ptr<const void>(3);
  const int* table = a.ptr<const int>(4);
  const int* lengths = a.ptr<const int>(5);
  float* parts = a.ptr<float>(6);
  void* out = a.ptr<void>(7);
  const int b = a.i32(8), h = a.i32(9), kvh = a.i32(10), slots = a.i32(11),
            t = a.i32(12), hd = a.i32(13), max_pages = a.i32(14),
            split = a.i32(15);
  const float scale = a.f32(16);
  void* stream = a.ptr<void>(17);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvh < 1 || h % kvh != 0 || slots < 1 || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, lengths, parts, out, b, h,
                         kvh, slots, t, hd, max_pages, split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, parts,
                                 out, b, h, kvh, slots, t, hd, max_pages,
                                 split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
