// STREAM copy / scale / add / triad, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/stream.py, _run with
// _copy_kernel, _scale_kernel, _add_kernel and _triad_kernel: the paper's
// STREAM passes a = c, b = q c, c = a + b and a = b + q c over 1-D arrays,
// computed in float32 and stored in the input's dtype.
//
// What bounds it: bytes, at every size the paper runs.  Each element is
// read once from each input and written once, with at most two float32
// operations: 8 to 12 bytes per element in float32, far below the card's
// ridge.  At the paper's 10,000,000 elements a pass moves 80 to 120 MB in
// float32 (40 to 60 MB in bf16), more than the 50 MB L2, so it runs at the
// rate HBM sustains for its mix of reads and writes, below the 3.35 TB/s
// of the data sheet (PyTorch's own elementwise kernels reach the same
// rate; PERF.md, section 6); at the 1,003 elements of the ragged check a
// pass is one launch's latency.
//
// Design.  One kernel, templated on the element type and the pass.  The
// TPU's (rows, 128) VMEM blocks become tiles of kThreads x kBatch 16-byte
// vectors (4 float32 or 8 bfloat16 elements), one tile a block,
// consecutive threads on consecutive vectors; each thread issues the loads
// of its kBatch vectors of every input before its first store.  The grid
// is one block a tile, so the block scheduler fills every SM as blocks
// retire (a grid-stride loop remains for a grid past 2^31 - 1 blocks).  A
// ragged tail of fewer than one vector takes a scalar loop; where a
// pointer is not 16-byte aligned the whole array does.  scale and triad
// multiply and add with __fmul_rn / __fadd_rn, so nvcc cannot contract
// b + q c into one fused multiply-add: the result is bit-identical to the
// plain PyTorch version, which rounds after each operation.  copy moves
// the bits as they are.
//
// Tried and dropped (development runs on the card; the harness was not
// kept, so PERF.md gives no numbers for them): a grid of only the blocks
// the card keeps resident (SMs x blocks an SM holds, from the occupancy
// calculator) striding over the tiles was slower than one block a tile in
// every pass; streaming cache hints (ld.global.cs / st.global.cs, and
// L1::no_allocate loads) slowed the float32 passes that read two arrays,
// and looked faster in bf16 only where the 20 MB output stayed in the L2
// from one call to the next; L2 prefetch-size hints (L2::128B, L2::256B)
// and 1, 4 or 8 vectors a thread, at 128, 256 or 512 threads a block, came
// close to this design, none faster in all eight passes.  The port's
// first design, a grid-stride loop of at most 4,096 blocks with one vector
// a thread in flight, is what this one replaces.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 2;  // 16-byte vectors of each input a thread holds
constexpr int kTile = kThreads * kBatch;

enum Pass { kCopy = 0, kScale = 1, kAdd = 2, kTriad = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x is c (copy, scale), a (add) or b (triad); y is b (add) or c (triad).
template <typename T, int PASS>
__device__ __forceinline__ T element(T x, T y, float q) {
  if constexpr (PASS == kCopy) return x;
  else if constexpr (PASS == kScale)
    return from_f32<T>(__fmul_rn(q, to_f32(x)));
  else if constexpr (PASS == kAdd)
    return from_f32<T>(__fadd_rn(to_f32(x), to_f32(y)));
  else return from_f32<T>(__fadd_rn(to_f32(x), __fmul_rn(q, to_f32(y))));
}

template <typename T, int PASS>
__device__ __forceinline__ uint4 combine(const uint4& xr, const uint4& yr,
                                        float q) {
  if constexpr (PASS == kCopy) {
    return xr;
  } else {
    constexpr int kN = 16 / sizeof(T);
    uint4 res;
    const T* xe = reinterpret_cast<const T*>(&xr);
    const T* ye = reinterpret_cast<const T*>(&yr);
    T* re = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < kN; ++e) re[e] = element<T, PASS>(xe[e], ye[e], q);
    return res;
  }
}

template <typename T, int PASS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    stream_pass_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       T* __restrict__ out, long long n, float q) {
  constexpr bool kTwo = PASS == kAdd || PASS == kTriad;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (VEC) {
    constexpr int kN = 16 / sizeof(T);
    const long long nv = n / kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long t = static_cast<long long>(blockIdx.x) * kTile +
                       threadIdx.x;
         t < nv; t += static_cast<long long>(gridDim.x) * kTile) {
      uint4 xr[kBatch], yr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long i = t + u * kThreads;
        if (i < nv) {
          xr[u] = __ldg(xv + i);
          yr[u] = kTwo ? __ldg(yv + i) : xr[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long i = t + u * kThreads;
        if (i < nv) ov[i] = combine<T, PASS>(xr[u], yr[u], q);
      }
    }
    done = nv * kN;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = element<T, PASS>(x[i], kTwo ? y[i] : x[i], q);
}

template <typename T, int PASS>
int launch_pass(const void* x, const void* y, void* out, long long n, float q,
                cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = aligned(x) && aligned(y) && aligned(out);
  const long long work = vec ? (n / (16 / sizeof(T)) + kTile - 1) / kTile
                             : (n + kThreads - 1) / kThreads;
  const long long cap = 0x7fffffffLL;   // the grid's limit; the rest strides
  const long long want = work > 0 ? work : 1;  // the tail needs one block
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (vec)
    stream_pass_kernel<T, PASS, true>
        <<<blocks, kThreads, 0, stream>>>(xt, yt, ot, n, q);
  else
    stream_pass_kernel<T, PASS, false>
        <<<blocks, kThreads, 0, stream>>>(xt, yt, ot, n, q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int pass, const void* x, const void* y, void* out, long long n,
           float q, cudaStream_t s) {
  switch (pass) {
    case kCopy: return launch_pass<T, kCopy>(x, y, out, n, q, s);
    case kScale: return launch_pass<T, kScale>(x, y, out, n, q, s);
    case kAdd: return launch_pass<T, kAdd>(x, y, out, n, q, s);
    case kTriad: return launch_pass<T, kTriad>(x, y, out, n, q, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Packed arguments: dtype (0 = float32, 1 = bfloat16), pass (0 copy,
// 1 scale, 2 add, 3 triad), x, y (null for copy and scale), out, n > 0, q,
// stream.
extern "C" int repro_stream(const char* packed) {
  const PackedArgs a{packed};
  const int dtype = a.i32(0), pass = a.i32(1);
  const void* x = a.ptr<const void>(2);
  const void* y = a.ptr<const void>(3);
  void* out = a.ptr<void>(4);
  const long long n = a.i64(5);
  const float q = a.f32(6);
  void* stream = a.ptr<void>(7);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || ((pass == kAdd || pass == kTriad) && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(pass, x, y, out, n, q, s);
  if (dtype == 1) return launch<__nv_bfloat16>(pass, x, y, out, n, q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
