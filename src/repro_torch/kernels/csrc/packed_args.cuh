// The arguments of a kernel's C entry point, as its Python wrapper packs
// them (kernels/_build.py, bind): one 8-byte field each, in the order the
// entry point documents, an integer or a pointer as a 64-bit integer and a
// float as a double.  ctypes then converts one argument a call, where it
// would convert each of a dozen typed ones on the host; the fields are
// read by index, so the order in which C++ evaluates them does not matter.
#pragma once

#include <string.h>

struct PackedArgs {
  const char* p;

  long long i64(int i) const {
    long long v;
    memcpy(&v, p + 8 * i, 8);
    return v;
  }
  int i32(int i) const { return static_cast<int>(i64(i)); }
  template <typename T>
  T* ptr(int i) const {
    return reinterpret_cast<T*>(i64(i));
  }
  float f32(int i) const {
    double v;
    memcpy(&v, p + 8 * i, 8);
    return static_cast<float>(v);
  }
};
