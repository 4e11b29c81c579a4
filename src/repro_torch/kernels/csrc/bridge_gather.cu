// The bridge datapath's page kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bridge_gather.py:
//   * gather_pages  (_gather_kernel):  out[i] = pool[reqs[i]], zeros for a
//     FREE (< 0) lane, the last row for an id past the pool (clamped);
//   * pull_commit   (_pull_commit_kernel): retire a pull round of the N-node
//     engine: per (requester, lane), choice -1 gives zeros, 0 the requester's
//     loopback row, h+1 the page home h put in the all-to-all send buffer;
//   * push_commit   (_push_commit_kernel, :244-286): retire a push round of
//     the N-node engine in place, in the grid order (channel, slot row, lane)
//     of each home, the later write winning;
//   * scatter_pages (_scatter_kernel, :289-330):
//     pool.at[slots].set(data, mode="drop"), FREE lanes dropped and, among
//     lanes with the same slot, the last wins.
//
// What bounds them: bytes, once they move enough of them.  Each moves whole
// page rows (32 KiB for a granite-3-8b page of 16 tokens x 8 kv heads x 128
// bf16) and computes nothing.  The decode path's rounds move a few dozen
// rows at most, a few MiB, so there a launch is bound by its latency long
// before the 3.35 TB/s of HBM; a full-pool flush (every slot of a 512-page
// pool written, 16 MiB in and 16 MiB out) is bound by the bytes.
//
// The N memory nodes of the ring are an axis of one device: the pool is
// [N * ppn] rows, node-major (row home * ppn + slot).  The TPU's all-to-all
// becomes an index transpose read in place: pull_commit reads
// send[h, j, lane] where the TPU reads recv[j][h, lane]; the push side's
// all-gather of data windows becomes an index: home h lands requester
// (h - k) mod N's window for slot row k.  One launch serves all N nodes.
//
// What the TPU kernels did, and what the two write kernels do instead.  The
// TPU runs its grid in order on one core, one page row a step, with the
// rows prefetched as scalars: a later step simply overwrites an earlier one
// (push's grid is (channel, slot row, lane), scatter's the lanes), and the
// off-TPU path makes that explicit with _shadow_to, a quadratic compare that
// steers every shadowed write to a pad row.  CUDA blocks run in no order,
// so a write must learn by itself whether a later one shadows it.
//
// Design: one block per write (a lane of scatter, a grid step of push).
// A block reads its slot; a dead write's block leaves at once, and most
// blocks of a decode round are dead (push's round at N = 8 has 512 grid
// steps; most decode rounds write nothing, a flush round writes 8).  A live block reads the later
// writes' slots, one a thread (scatter issues the first 256 with its own
// slot; push issues its home's with base[j]), and votes
// (__syncthreads_or) whether one holds its slot; a shadowed write's block
// leaves, a winner copies its row.  So each write is resolved once, by its
// own block, and nothing waits on another block.  The copy moves 16-byte
// vectors, each thread loading its 8 before it stores any, so a block
// keeps 32 KiB (one page) in flight; at a full flush every block is a
// winner, 512 of them for the 512-page pool.  The winners write distinct
// rows, so they can run in any order and the result is the TPU grid's, bit
// for bit.
//
// Tried and dropped for push_commit: resolving a home once and handing its
// winners to the copying blocks as a work list, either through a thread
// block cluster (the first block resolves in shared memory, the others read
// the list by distributed shared memory) or with every copying block
// resolving the home itself.  Both were slower on the card, at the decode
// path's 8 live writes and at a full flush: a block can start its copy only
// after the whole home is resolved (and, in the cluster, after a cluster
// barrier and a remote read).  Loading the home's slots with the block's
// own slot saves a round trip for a live write but costs every dead block
// 256 loads, and a decode round is mostly dead blocks.
//
// gather, redesigned.  At the 1-node decode round (W = 8 lanes of 32 KiB,
// about 6 live) it moves ~0.45 MB, so it is bound by latency: the launch,
// then two dependent round trips to memory, the lane's row id and then the
// row.  The first design ran one block a lane, 8 blocks on 132 SMs, each
// thread storing a vector before it loaded the next, so a row took eight
// round trips (1.92 us in a decode step against a 0.137 us byte bound;
// PERF.md, section 6).  Now a row is cut into chunks of
// kGatherChunk vectors (4 KiB), one block a chunk (64 blocks at W = 8),
// and each thread loads its kGatherBatch vectors before it stores any, so
// the whole round is in flight after the row ids arrive.  At the 8-node
// send buffer (W = 512 lanes, ~56 live, so mostly zero stores: 16 MiB
// written, 1.75 MiB read) it is bound by bytes; there a FREE lane's chunk
// stores zeros and reads nothing, and 4,096 blocks keep HBM busy.
//
// Tried and dropped for gather: Hopper's bulk asynchronous copy, one
// thread a chunk issuing cp.async.bulk from global into shared memory,
// completing on an mbarrier, then the bulk store back to global, at chunks
// of 2, 4, 8 and 16 KiB.  It was slower at the 1-node round at every chunk
// size (the barrier adds to the same two round trips) and no faster at
// the 8-node buffer, whose FREE chunks store zeros either way
// (development runs; PERF.md, section 6).  Chunks of 2 and 8 KiB, and
// 64 or 256 threads a block, were no faster than 4 KiB at 128 threads.
//
// pull_commit keeps one block per request lane, which reads its own row id
// (there is no scalar prefetch) and copies one row with 16-byte vector
// loads and stores.
//
// Rows are moved as raw bytes, so one kernel serves every element type; the
// wrapper checks that a row is a multiple of 16 bytes and 16-byte aligned.
// No launch allocates or synchronises, so each can be captured in a CUDA
// graph.
#include <cuda_runtime.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // 16-byte vectors a thread holds in flight
// gather: a block moves one chunk of a row, kGatherBatch vectors a thread.
constexpr int kGatherThreads = 128;
constexpr int kGatherBatch = 2;
constexpr int kGatherChunk = kGatherThreads * kGatherBatch;  // 4 KiB

// One block a chunk of kGatherChunk vectors of one lane's row: block b
// serves lane b / chunks, chunk b % chunks.  A FREE lane's chunk stores
// zeros and reads nothing; a live one loads its kGatherBatch vectors a
// thread before it stores any.
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows(const int4* __restrict__ pool, const int* __restrict__ reqs,
                int4* __restrict__ out, long long rows, long long vecs,
                int chunks) {
  const long long lane = blockIdx.x / chunks;
  const long long j0 =
      static_cast<long long>(blockIdx.x % chunks) * kGatherChunk + threadIdx.x;
  const int r = reqs[lane];
  int4* dst = out + lane * vecs;
  if (r < 0) {
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const long long j = j0 + u * kGatherThreads;
      if (j < vecs) dst[j] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  // A row id past the pool reads the last row, as the reference's fetch does.
  const long long row = r < rows ? r : rows - 1;
  const int4* src = pool + row * vecs;
  int4 v[kGatherBatch];
#pragma unroll
  for (int u = 0; u < kGatherBatch; ++u) {
    const long long j = j0 + u * kGatherThreads;
    if (j < vecs) v[u] = __ldg(src + j);
  }
#pragma unroll
  for (int u = 0; u < kGatherBatch; ++u) {
    const long long j = j0 + u * kGatherThreads;
    if (j < vecs) dst[j] = v[u];
  }
}

// Copy one row of `vecs` 16-byte vectors, or write zeros where src is null;
// blockDim.x == kThreads.  Each thread loads its kBatch vectors before it
// stores any, so the block keeps kThreads * kBatch * 16 bytes in flight.
__device__ __forceinline__ void copy_row_batched(int4* __restrict__ dst,
                                                 const int4* __restrict__ src,
                                                 long long vecs) {
  for (long long j0 = threadIdx.x; j0 < vecs;
       j0 += static_cast<long long>(kThreads) * kBatch) {
    int4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long j = j0 + u * kThreads;
      v[u] = (src != nullptr && j < vecs) ? __ldg(src + j)
                                          : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long j = j0 + u * kThreads;
      if (j < vecs) dst[j] = v[u];
    }
  }
}

// One block per lane: a live lane writes its row unless a later lane holds
// the same slot.  The block's threads read the later lanes' slots, the first
// 256 of them together with the lane's own.
__global__ void __launch_bounds__(kThreads)
    scatter_rows(int4* __restrict__ pool, const int* __restrict__ slots,
                 const int4* __restrict__ data, int w, long long rows,
                 long long vecs) {
  const int lane = blockIdx.x;
  const int first = lane + 1 + threadIdx.x;
  const int next = first < w ? slots[first] : -1;
  const int s = slots[lane];
  if (s < 0 || s >= rows) return;  // FREE or past the pool: dropped
  int later = next == s;
  for (int j = first + kThreads; j < w; j += kThreads) later |= slots[j] == s;
  if (__syncthreads_or(later)) return;  // a later lane writes this slot
  copy_row_batched(pool + static_cast<long long>(s) * vecs,
                   data + static_cast<long long>(lane) * vecs, vecs);
}

__device__ __forceinline__ void copy_row(int4* __restrict__ dst,
                                         const int4* __restrict__ src,
                                         long long vecs) {
  if (src == nullptr) {
    const int4 zero = make_int4(0, 0, 0, 0);
    for (long long j = threadIdx.x; j < vecs; j += blockDim.x) dst[j] = zero;
  } else {
    for (long long j = threadIdx.x; j < vecs; j += blockDim.x)
      dst[j] = __ldg(src + j);
  }
}

// One block per (requester j, lane).  A loopback slot past the node's
// pool reads the node's last row, as the reference's shard-local fetch does.
__global__ void pull_commit_rows(const int4* __restrict__ pool,
                                 const int4* __restrict__ send,
                                 const int* __restrict__ choice,
                                 const int* __restrict__ loop_slot,
                                 int4* __restrict__ out, long long ppn, int n,
                                 int lanes, long long vecs) {
  const long long idx = blockIdx.x;
  const int j = static_cast<int>(idx / lanes);
  const int lane = static_cast<int>(idx % lanes);
  const int c = choice[idx];
  const int4* src = nullptr;
  if (c == 0) {
    const int s = loop_slot[idx];
    if (s >= 0) src = pool + (j * ppn + (s < ppn ? s : ppn - 1)) * vecs;
  } else if (c > 0) {
    const long long h = c - 1 < n ? c - 1 : n - 1;
    src = send + ((h * n + j) * lanes + lane) * vecs;
  }
  copy_row(out + idx * vecs, src, vecs);
}

// The TPU grid's step t of the write at slot row k, lane = c * cb + b:
// t = (c * s1 + k) * cb + b.
__device__ __forceinline__ int grid_step(int k, int lane, int s1, int cb) {
  return ((lane / cb) * s1 + k) * cb + lane % cb;
}

// One block per write (home h, slot row k, lane).  Within a home the writes
// commit in grid-step order, the later winning; homes own disjoint rows.
// Row k of home h lands requester (h - k) mod N's data window, read where
// it lies: data[j, base[j] + lane], zeros past the window's end.  The block
// reads its slot first, so a dead write's block leaves after one load; a
// live one then reads base[j] and the home's slots (one a thread) together.
__global__ void __launch_bounds__(kThreads)
    push_commit_rows(int4* __restrict__ pool, const int* __restrict__ slots,
                     const int4* __restrict__ data,
                     const int* __restrict__ base, long long ppn, int n,
                     int s1, int lanes, int cb, long long d_rows,
                     long long vecs) {
  const long long idx = blockIdx.x;
  const int s = slots[idx];
  if (s < 0 || s >= ppn) return;  // FREE or past the node's pool: dropped
  const int lane = static_cast<int>(idx % lanes);
  const int k = static_cast<int>((idx / lanes) % s1);
  const int h = static_cast<int>(idx / (static_cast<long long>(lanes) * s1));
  const int j = ((h - k) % n + n) % n;
  const int steps = s1 * lanes;
  const int* home_slots = slots + static_cast<long long>(h) * steps;
  const int t = grid_step(k, lane, s1, cb);
  const int start = base[j];
  int later = 0;
  for (int i = threadIdx.x; i < steps; i += kThreads)
    later |= home_slots[i] == s && grid_step(i / lanes, i % lanes, s1, cb) > t;
  if (__syncthreads_or(later)) return;  // a later step writes this slot
  const long long di = static_cast<long long>(start) + lane;
  const int4* src =
      di < d_rows ? data + (static_cast<long long>(j) * d_rows + di) * vecs
                  : nullptr;
  copy_row_batched(pool + (static_cast<long long>(h) * ppn + s) * vecs, src,
                   vecs);
}

}  // namespace

// Packed arguments: pool, send, choice, loop_slot, out, ppn, n, lanes,
// row_bytes, stream.
extern "C" int repro_pull_commit(const char* packed) {
  const PackedArgs a{packed};
  const void* pool = a.ptr<const void>(0);
  const void* send = a.ptr<const void>(1);
  const int* choice = a.ptr<const int>(2);
  const int* loop_slot = a.ptr<const int>(3);
  void* out = a.ptr<void>(4);
  const long long ppn = a.i64(5);
  const int n = a.i32(6), lanes = a.i32(7);
  const long long row_bytes = a.i64(8);
  void* stream = a.ptr<void>(9);
  if (n == 0 || lanes == 0) return 0;
  pull_commit_rows<<<n * lanes, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(pool), static_cast<const int4*>(send), choice,
      loop_slot, static_cast<int4*>(out), ppn, n, lanes, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// Packed arguments: pool, slots, data, base, ppn, n, s1, lanes, cb,
// d_rows, row_bytes, stream.
extern "C" int repro_push_commit(const char* packed) {
  const PackedArgs a{packed};
  void* pool = a.ptr<void>(0);
  const int* slots = a.ptr<const int>(1);
  const void* data = a.ptr<const void>(2);
  const int* base = a.ptr<const int>(3);
  const long long ppn = a.i64(4);
  const int n = a.i32(5), s1 = a.i32(6), lanes = a.i32(7), cb = a.i32(8);
  const long long d_rows = a.i64(9), row_bytes = a.i64(10);
  void* stream = a.ptr<void>(11);
  if (n == 0 || s1 == 0 || lanes == 0) return 0;
  push_commit_rows<<<n * s1 * lanes, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int4*>(pool), slots, static_cast<const int4*>(data), base,
      ppn, n, s1, lanes, cb, d_rows, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// Packed arguments: pool, reqs, out, rows, w, row_bytes, stream.
extern "C" int repro_gather_pages(const char* packed) {
  const PackedArgs a{packed};
  const void* pool = a.ptr<const void>(0);
  const int* reqs = a.ptr<const int>(1);
  void* out = a.ptr<void>(2);
  const long long rows = a.i64(3);
  const int w = a.i32(4);
  const long long row_bytes = a.i64(5);
  void* stream = a.ptr<void>(6);
  if (w == 0) return 0;
  const long long vecs = row_bytes / 16;
  const long long chunks = (vecs + kGatherChunk - 1) / kGatherChunk;
  if (chunks == 0) return 0;
  if (w * chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_rows<<<static_cast<unsigned>(w * chunks), kGatherThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(pool), reqs, static_cast<int4*>(out), rows,
      vecs, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

// Packed arguments: pool, slots, data, rows, w, row_bytes, stream.
extern "C" int repro_scatter_pages(const char* packed) {
  const PackedArgs a{packed};
  void* pool = a.ptr<void>(0);
  const int* slots = a.ptr<const int>(1);
  const void* data = a.ptr<const void>(2);
  const long long rows = a.i64(3);
  const int w = a.i32(4);
  const long long row_bytes = a.i64(5);
  void* stream = a.ptr<void>(6);
  if (w == 0) return 0;
  scatter_rows<<<w, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int4*>(pool), slots, static_cast<const int4*>(data), w, rows,
      row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
