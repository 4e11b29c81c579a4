// STREAM copy / scale / add / triad, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/stream.py, _run with
// _copy_kernel, _scale_kernel, _add_kernel and _triad_kernel: the paper's
// STREAM passes a = c, b = q c, c = a + b and a = b + q c over 1-D arrays,
// computed in float32 and stored in the input's dtype.
//
// What bounds it: bytes.  Each element is read once from each input and
// written once, with at most two float32 operations: 8 to 12 bytes per
// element in float32, far below the card's ridge.  At the paper's 10,000,000
// elements a pass moves 80 to 120 MB, more than the 50 MB L2.
//
// Design.  One grid-stride kernel, templated on the element type and the
// pass: the TPU's (rows, 128) VMEM blocks become 16-byte vectors per thread
// (4 float32 or 8 bfloat16 elements), consecutive threads on consecutive
// vectors, and a scalar loop for the ragged tail; where a pointer is not
// 16-byte aligned the whole array takes the scalar loop.  scale and triad
// multiply and add with __fmul_rn / __fadd_rn, so nvcc cannot contract
// b + q c into one fused multiply-add: the result is bit-identical to the
// plain PyTorch version, which rounds after each operation.  copy moves the
// bits as they are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

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

template <typename T, int PASS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    stream_pass_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ out, long long n, float q) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    constexpr int kN = 16 / sizeof(T);
    const long long nv = n / kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = first; i < nv; i += stride) {
      const uint4 xr = xv[i];
      if (PASS == kCopy) {
        ov[i] = xr;
        continue;
      }
      const uint4 yr = (PASS == kAdd || PASS == kTriad) ? yv[i] : xr;
      uint4 res;
      const T* xe = reinterpret_cast<const T*>(&xr);
      const T* ye = reinterpret_cast<const T*>(&yr);
      T* re = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < kN; ++e) re[e] = element<T, PASS>(xe[e], ye[e], q);
      ov[i] = res;
    }
    done = nv * kN;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = element<T, PASS>(x[i], (PASS == kAdd || PASS == kTriad) ? y[i]
                                                                      : x[i],
                              q);
}

template <typename T, int PASS>
int launch_pass(const void* x, const void* y, void* out, long long n, float q,
                cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = aligned(x) && aligned(y) && aligned(out);
  const long long work = vec ? n / (16 / sizeof(T)) + 1 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
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
