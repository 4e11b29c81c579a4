// Page gather and page scatter of the loopback bridge, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bridge_gather.py:
//   * gather_pages  (_gather_kernel):  out[i] = pool[reqs[i]], zeros for a
//     FREE (< 0) lane, the last row for an id past the pool (clamped);
//   * scatter_pages (_scatter_kernel): pool.at[slots].set(data, mode="drop"),
//     FREE lanes dropped and, among lanes with the same slot, the last wins.
//
// What bounds them: bytes.  Each moves whole page rows (32 KiB for a
// granite-3-8b page of 16 tokens x 8 kv heads x 128 bf16) and computes
// nothing; at the decode path's W = 8 lanes a launch moves a few hundred
// KiB, so it is bound by launch latency long before the 3.35 TB/s of HBM.
//
// Design.  One block per request lane: the block reads its own row id, so
// there is no scalar prefetch, and copies one row with 16-byte vector loads
// and stores (neighbouring threads on neighbouring addresses).  The TPU's
// scatter grid runs in order, so a later lane overwrites an earlier one; CUDA
// blocks run in no order, so each scatter block first scans the lanes after
// its own and writes only if no later lane holds the same live slot.  W is a
// few dozen, so that O(W) scan is nothing beside the row copy.  The pool is
// updated in place and needs no pad row.
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

}  // namespace

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
