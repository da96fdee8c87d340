// Element arithmetic, combine operators and row I/O shared by the collective
// kernels K1 (fused_collective.cu) and K2 (spmd_collective.cu), so both round
// every combine the same way and their results agree bit for bit.
//
// Every combine rounds to the leaf type (bf16/fp16 are computed in float and
// rounded to nearest even), integer sums and products wrap, MAX/MIN
// propagate NaN, and products and sums are issued as __fmul_rn / __fadd_rn so
// no multiply-add is contracted.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <cstring>

namespace collective {

enum Kind { KIND_SCAN = 0, KIND_FUSED = 1, KIND_BUTTERFLY = 2 };
enum OpCode { OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3, OP_SSD = 4, OP_FLASH = 5 };
enum DType { DT_INT32 = 0, DT_FLOAT32 = 1, DT_BFLOAT16 = 2, DT_FLOAT16 = 3, DT_INT8 = 4 };

constexpr int MAX_LEAVES = 3;

// ---- element arithmetic -------------------------------------------------

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float t(float x) { return x; }
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <> struct Num<__nv_bfloat16> {
  typedef __nv_bfloat16 T;
  static __device__ __forceinline__ float f(T x) { return __bfloat162float(x); }
  static __device__ __forceinline__ T t(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ T zero() { return __float2bfloat16_rn(0.0f); }
  static __device__ __forceinline__ T add(T a, T b) { return t(__fadd_rn(f(a), f(b))); }
  static __device__ __forceinline__ T mul(T a, T b) { return t(__fmul_rn(f(a), f(b))); }
  static __device__ __forceinline__ T sub(T a, T b) { return t(__fsub_rn(f(a), f(b))); }
};

template <> struct Num<__half> {
  typedef __half T;
  static __device__ __forceinline__ float f(T x) { return __half2float(x); }
  static __device__ __forceinline__ T t(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ T zero() { return __float2half_rn(0.0f); }
  static __device__ __forceinline__ T add(T a, T b) { return t(__fadd_rn(f(a), f(b))); }
  static __device__ __forceinline__ T mul(T a, T b) { return t(__fmul_rn(f(a), f(b))); }
  static __device__ __forceinline__ T sub(T a, T b) { return t(__fsub_rn(f(a), f(b))); }
};

template <> struct Num<int32_t> {
  typedef int32_t T;
  static __device__ __forceinline__ float f(T x) { return (float)x; }
  static __device__ __forceinline__ T zero() { return 0; }
  // wrap modulo 2^32, as both frameworks do
  static __device__ __forceinline__ T add(T a, T b) { return (T)((uint32_t)a + (uint32_t)b); }
  static __device__ __forceinline__ T mul(T a, T b) { return (T)((uint32_t)a * (uint32_t)b); }
};

template <> struct Num<int8_t> {
  typedef int8_t T;
  static __device__ __forceinline__ float f(T x) { return (float)x; }
  static __device__ __forceinline__ T zero() { return 0; }
  // wrap modulo 2^8
  static __device__ __forceinline__ T add(T a, T b) {
    return (T)(uint8_t)((uint32_t)(int32_t)a + (uint32_t)(int32_t)b);
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    return (T)(uint8_t)((uint32_t)(int32_t)a * (uint32_t)(int32_t)b);
  }
};

template <typename T> struct IsFloat { static constexpr bool value = true; };
template <> struct IsFloat<int32_t> { static constexpr bool value = false; };
template <> struct IsFloat<int8_t> { static constexpr bool value = false; };

// NaN-propagating max/min (fmaxf/fminf drop NaN; the reference keeps it):
// a if a is NaN, else b if b is NaN, else the larger (smaller). Written as
// selects, not branches: branches in the fully unrolled rounds of K1's
// register path made ptxas spill.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (IsFloat<T>::value) {
    const float fa = Num<T>::f(a), fb = Num<T>::f(b);
    T out = fa >= fb ? a : b;
    out = fb != fb ? b : out;
    return fa != fa ? a : out;
  }
  return a >= b ? a : b;
}

template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  if (IsFloat<T>::value) {
    const float fa = Num<T>::f(a), fb = Num<T>::f(b);
    T out = fa <= fb ? a : b;
    out = fb != fb ? b : out;
    return fa != fa ? a : out;
  }
  return a <= b ? a : b;
}

// ---- operators: combine(left, right) over L leaves ----------------------

template <typename T> struct OpSum {
  static constexpr int L = 1;
  static __device__ __forceinline__ void combine(const T* l, const T* r, T* o) {
    o[0] = Num<T>::add(l[0], r[0]);
  }
};

template <typename T> struct OpProd {
  static constexpr int L = 1;
  static __device__ __forceinline__ void combine(const T* l, const T* r, T* o) {
    o[0] = Num<T>::mul(l[0], r[0]);
  }
};

template <typename T> struct OpMax {
  static constexpr int L = 1;
  static __device__ __forceinline__ void combine(const T* l, const T* r, T* o) {
    o[0] = max_nan(l[0], r[0]);
  }
};

template <typename T> struct OpMin {
  static constexpr int L = 1;
  static __device__ __forceinline__ void combine(const T* l, const T* r, T* o) {
    o[0] = min_nan(l[0], r[0]);
  }
};

// (a, b): h' = a*h + b; combine = (a_r*a_l, a_r*b_l + b_r), each op rounded
template <typename T> struct OpSsd {
  static constexpr int L = 2;
  static __device__ __forceinline__ void combine(const T* l, const T* r, T* o) {
    T a = Num<T>::mul(r[0], l[0]);
    T b = Num<T>::add(Num<T>::mul(r[0], l[1]), r[1]);
    o[0] = a;
    o[1] = b;
  }
};

// (m, l, o): online-softmax partials
template <typename T> struct OpFlash {
  static constexpr int L = 3;
  static __device__ __forceinline__ T exp_(T x) { return Num<T>::t(expf(Num<T>::f(x))); }
  static __device__ __forceinline__ void combine(const T* l, const T* r, T* o) {
    T m = max_nan(l[0], r[0]);
    T c_l = exp_(Num<T>::sub(l[0], m));
    T c_r = exp_(Num<T>::sub(r[0], m));
    T s = Num<T>::add(Num<T>::mul(l[1], c_l), Num<T>::mul(r[1], c_r));
    T v = Num<T>::add(Num<T>::mul(l[2], c_l), Num<T>::mul(r[2], c_r));
    o[0] = m;
    o[1] = s;
    o[2] = v;
  }
};

// ---- row I/O: VEC contiguous elements of one (p, M) row ------------------

// an unsigned word of N bytes, the unit of one vector access
template <int N> struct Raw;
template <> struct Raw<16> { typedef uint4 type; };
template <> struct Raw<8> { typedef uint2 type; };
template <> struct Raw<4> { typedef unsigned type; };
template <> struct Raw<2> { typedef unsigned short type; };
template <> struct Raw<1> { typedef unsigned char type; };

// elements [col, col + VEC) of a row into out. aligned: the row and col
// start on VEC * sizeof(T) bytes and the whole vector lies below M (one
// vector load); otherwise element loads, zero past M.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ row, long long col, long long M,
                                         bool aligned, T (&out)[VEC]) {
  if (aligned) {
    const typename Raw<VEC * sizeof(T)>::type raw =
        *reinterpret_cast<const typename Raw<VEC * sizeof(T)>::type*>(row + col);
    memcpy(out, &raw, sizeof(raw));
    return;
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) out[v] = col + v < M ? row[col + v] : Num<T>::zero();
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* __restrict__ row, long long col, long long M,
                                          bool aligned, const T (&in)[VEC]) {
  if (aligned) {
    typename Raw<VEC * sizeof(T)>::type raw;
    memcpy(&raw, in, sizeof(raw));
    *reinterpret_cast<typename Raw<VEC * sizeof(T)>::type*>(row + col) = raw;
    return;
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    if (col + v < M) row[col + v] = in[v];
}

}  // namespace collective
