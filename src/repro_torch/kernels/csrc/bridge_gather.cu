// The bridge datapath's page kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bridge_gather.py:
//   * gather_pages  (_gather_kernel):  out[i] = pool[reqs[i]], zeros for a
//     FREE (< 0) lane, the last row for an id past the pool (clamped);
//   * pull_commit   (_pull_commit_kernel): retire a pull round of the N-node
//     engine: per (requester, lane), choice -1 gives zeros, 0 the requester's
//     loopback row, h+1 the page home h put in the all-to-all send buffer;
//   * push_commit   (_push_commit_kernel): retire a push round of the N-node
//     engine in place, in the grid order (channel, slot row, lane) of each
//     home, the later write winning;
//   * scatter_pages (_scatter_kernel): pool.at[slots].set(data, mode="drop"),
//     FREE lanes dropped and, among lanes with the same slot, the last wins.
//
// What bounds them: bytes.  Each moves whole page rows (32 KiB for a
// granite-3-8b page of 16 tokens x 8 kv heads x 128 bf16) and computes
// nothing; at the decode path's few dozen live lanes a launch moves a few
// MiB at most, so it is bound by launch latency long before the 3.35 TB/s
// of HBM.
//
// The N memory nodes of the ring are an axis of one device: the pool is
// [N * ppn] rows, node-major (row home * ppn + slot).  The TPU's all-to-all
// becomes an index transpose read in place: pull_commit reads
// send[h, j, lane] where the TPU reads recv[j][h, lane]; the push side's
// all-gather of data windows becomes an index: home h lands requester
// (h - k) mod N's window for slot row k.  One launch serves all N nodes.
//
// Design.  One block per request lane: the block reads its own row id, so
// there is no scalar prefetch, and copies one row with 16-byte vector loads
// and stores (neighbouring threads on neighbouring addresses).  The TPU's
// scatter grid runs in order, so a later lane overwrites an earlier one; CUDA
// blocks run in no order, so each scatter block first scans the lanes after
// its own and writes only if no later lane holds the same live slot.  W is a
// few dozen, so that O(W) scan is nothing beside the row copy.  The pool is
// updated in place and needs no pad row.  push_commit resolves its shadowed
// writes the same way, over the s1 x L grid steps of its home (64 at N = 8,
// budget 8), the block's threads splitting the scan; pull_commit reads its
// lane's choice and copies one row from the pool, from the send buffer or
// writes zeros.
//
// Rows are moved as raw bytes, so one kernel serves every element type; the
// wrapper checks that a row is a multiple of 16 bytes and 16-byte aligned.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows(const int4* __restrict__ pool,
                            const int* __restrict__ reqs,
                            int4* __restrict__ out, long long rows,
                            long long vecs) {
  const long long lane = blockIdx.x;
  const int r = reqs[lane];
  int4* dst = out + lane * vecs;
  if (r < 0) {
    const int4 zero = make_int4(0, 0, 0, 0);
    for (long long j = threadIdx.x; j < vecs; j += blockDim.x) dst[j] = zero;
    return;
  }
  // A row id past the pool reads the last row, as the reference's fetch does.
  const long long row = r < rows ? r : rows - 1;
  const int4* src = pool + row * vecs;
  for (long long j = threadIdx.x; j < vecs; j += blockDim.x)
    dst[j] = __ldg(src + j);
}

__global__ void scatter_rows(int4* __restrict__ pool,
                             const int* __restrict__ slots,
                             const int4* __restrict__ data, int w,
                             long long rows, long long vecs) {
  const int lane = blockIdx.x;
  const int s = slots[lane];
  if (s < 0 || s >= rows) return;
  for (int j = lane + 1; j < w; ++j)
    if (slots[j] == s) return;  // a later lane writes this slot
  const int4* src = data + static_cast<long long>(lane) * vecs;
  int4* dst = pool + static_cast<long long>(s) * vecs;
  for (long long j = threadIdx.x; j < vecs; j += blockDim.x)
    dst[j] = __ldg(src + j);
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

// One block per grid step (home h, slot row k, lane), lane = c * cb + b.
// Within a home the TPU grid writes in the order t = (c * s1 + k) * cb + b,
// the later write winning; a block writes only if no later step of its home
// holds the same live slot.  Homes own disjoint rows.  Row k of home h lands
// requester (h - k) mod N's data window, read where it lies: data[j, base[j]
// + lane], zeros past the window's end.
__global__ void push_commit_rows(int4* __restrict__ pool,
                                 const int* __restrict__ slots,
                                 const int4* __restrict__ data,
                                 const int* __restrict__ base, long long ppn,
                                 int n, int s1, int lanes, int cb,
                                 long long d_rows, long long vecs) {
  const long long idx = blockIdx.x;
  const int lane = static_cast<int>(idx % lanes);
  const int k = static_cast<int>((idx / lanes) % s1);
  const int h = static_cast<int>(idx / (static_cast<long long>(lanes) * s1));
  const int s = slots[idx];
  if (s < 0 || s >= ppn) return;  // FREE or past the node's pool: dropped
  const int t = ((lane / cb) * s1 + k) * cb + lane % cb;
  const int* home_slots = slots + static_cast<long long>(h) * s1 * lanes;
  int shadowed = 0;
  for (int i = threadIdx.x; i < s1 * lanes; i += blockDim.x) {
    const int l2 = i % lanes;
    const int t2 = ((l2 / cb) * s1 + i / lanes) * cb + l2 % cb;
    if (t2 > t && home_slots[i] == s) shadowed = 1;
  }
  if (__syncthreads_or(shadowed)) return;
  const int j = ((h - k) % n + n) % n;
  const long long di = static_cast<long long>(base[j]) + lane;
  const int4* src =
      di < d_rows ? data + (static_cast<long long>(j) * d_rows + di) * vecs
                  : nullptr;
  copy_row(pool + (static_cast<long long>(h) * ppn + s) * vecs, src, vecs);
}

}  // namespace

extern "C" int repro_pull_commit(const void* pool, const void* send,
                                 const int* choice, const int* loop_slot,
                                 void* out, long long ppn, int n, int lanes,
                                 long long row_bytes, void* stream) {
  if (n == 0 || lanes == 0) return 0;
  pull_commit_rows<<<n * lanes, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(pool), static_cast<const int4*>(send), choice,
      loop_slot, static_cast<int4*>(out), ppn, n, lanes, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_push_commit(void* pool, const int* slots,
                                 const void* data, const int* base,
                                 long long ppn, int n, int s1, int lanes,
                                 int cb, long long d_rows, long long row_bytes,
                                 void* stream) {
  if (n == 0 || s1 == 0 || lanes == 0) return 0;
  push_commit_rows<<<n * s1 * lanes, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int4*>(pool), slots, static_cast<const int4*>(data), base,
      ppn, n, s1, lanes, cb, d_rows, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gather_pages(const void* pool, const int* reqs, void* out,
                                  long long rows, int w, long long row_bytes,
                                  void* stream) {
  if (w == 0) return 0;
  gather_rows<<<w, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(pool), reqs, static_cast<int4*>(out), rows,
      row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_scatter_pages(void* pool, const int* slots,
                                   const void* data, long long rows, int w,
                                   long long row_bytes, void* stream) {
  if (w == 0) return 0;
  scatter_rows<<<w, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int4*>(pool), slots, static_cast<const int4*>(data), w, rows,
      row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
