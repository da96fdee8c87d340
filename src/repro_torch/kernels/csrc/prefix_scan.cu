// K3: the on-chip block scan — an inclusive or exclusive add / max / mul
// prefix scan along the last axis of a (R, L) array.
//
// Replaces repro/kernels/prefix_scan.py::_scan_kernel (built by
// prefix_scan_pallas). The TPU kernel walks the column tiles of a row in the
// sequential grid order and carries the running prefix in VMEM scratch from
// one grid step to the next. Hopper's blocks run in no order, so here the
// walk over column tiles is a loop inside the block: one block owns one row,
// scans it tile by tile (ITEMS elements a thread, blockDim.x threads a tile)
// and keeps the carry in a register of every thread.
//
// One tile: each thread scans its ITEMS consecutive elements in registers, a
// warp scans the thread totals with shuffles, warp 0 scans the warp totals in
// shared memory, and every element is combined with (carry, warp prefix,
// thread prefix). One read and one write per element; the ragged edge is
// masked in the kernel, so nothing is padded.
//
// Bound: memory. The kernel reads R*L*itemsize bytes and writes as many; its
// least time is 2*R*L*itemsize over the card's memory bandwidth. The combine
// is one operation a byte or less. A long single row (small R, huge L) keeps
// only R blocks busy and leaves most SMs idle: a decoupled look-back across
// blocks is the cure, not taken here.
//
// REVERSE: the row is read and written from its end, so the scan runs back
// to front (y[i] combines x[i..L-1], or x[i+1..L-1] when exclusive). This is
// the backward of an add scan: the gradient of y = cumsum(x) is the reverse
// cumsum of the incoming gradient. The index is mirrored on the load and the
// store, so no flipped copy of the row is ever made. It is a template flag,
// instantiated for the add scan only: the forward instantiation indexes the
// row exactly as it did before the flag existed (a run-time flag put a
// run-time stride into every load and store and slowed the forward).
//
// Arithmetic: float32, bfloat16 and float16 carry in float32 and round once
// per output (not at every combine as the TPU's associative_scan does).
// Integer sums and products wrap (int8 is carried in 32-bit and truncated on
// the store, which is the same value modulo 2^8). max propagates NaN (fmaxf
// would drop it) and is exact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum OpCode { OP_ADD = 0, OP_MAX = 1, OP_MUL = 2 };
enum DType { DT_INT32 = 0, DT_FLOAT32 = 1, DT_BFLOAT16 = 2, DT_FLOAT16 = 3, DT_INT8 = 4 };

constexpr int ITEMS = 4;
constexpr int MAX_WARPS = 32;

// storage type T <-> carry type (float for floating types, int32 for ints)
template <typename T> struct Io;
template <> struct Io<float> {
  typedef float A;
  static __device__ __forceinline__ A in(float x) { return x; }
  static __device__ __forceinline__ float out(A x) { return x; }
};
template <> struct Io<__nv_bfloat16> {
  typedef float A;
  static __device__ __forceinline__ A in(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 out(A x) { return __float2bfloat16_rn(x); }
};
template <> struct Io<__half> {
  typedef float A;
  static __device__ __forceinline__ A in(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half out(A x) { return __float2half_rn(x); }
};
template <> struct Io<int32_t> {
  typedef int32_t A;
  static __device__ __forceinline__ A in(int32_t x) { return x; }
  static __device__ __forceinline__ int32_t out(A x) { return x; }
};
template <> struct Io<int8_t> {
  typedef int32_t A;
  static __device__ __forceinline__ A in(int8_t x) { return (int32_t)x; }
  static __device__ __forceinline__ int8_t out(A x) { return (int8_t)(uint8_t)(uint32_t)x; }
};

template <typename A, int OP> struct Op;

template <> struct Op<float, OP_ADD> {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float combine(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Op<float, OP_MUL> {
  static __device__ __forceinline__ float identity() { return 1.0f; }
  static __device__ __forceinline__ float combine(float a, float b) { return __fmul_rn(a, b); }
};
template <> struct Op<float, OP_MAX> {
  static __device__ __forceinline__ float identity() { return __int_as_float(0xff800000); }
  static __device__ __forceinline__ float combine(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a >= b ? a : b;
  }
};
template <> struct Op<int32_t, OP_ADD> {
  static __device__ __forceinline__ int32_t identity() { return 0; }
  static __device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};
template <> struct Op<int32_t, OP_MUL> {
  static __device__ __forceinline__ int32_t identity() { return 1; }
  static __device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
};
template <> struct Op<int32_t, OP_MAX> {
  static __device__ __forceinline__ int32_t identity() { return -2147483647 - 1; }
  static __device__ __forceinline__ int32_t combine(int32_t a, int32_t b) { return a >= b ? a : b; }
};

// One block per row. exclusive: the output at i is the inclusive scan at i-1
// and `fill` (the wrapper's identity: 0, 1 or the type's lowest value, each
// exact in the carry type) at 0.
template <typename T, int OP, bool REVERSE>
__global__ void k3_scan_kernel(const T* __restrict__ x, T* __restrict__ y, long long L,
                               int exclusive, double fill) {
  typedef typename Io<T>::A A;
  typedef Op<A, OP> O;
  __shared__ A warp_tot[MAX_WARPS];

  const long long row = blockIdx.x;
  const T* xr = x + row * L;
  T* yr = y + row * L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const long long tile = (long long)blockDim.x * ITEMS;

  // logical element i of the row lives at i, or at L-1-i when reversed
  auto at = [L](long long i) { return REVERSE ? L - 1 - i : i; };

  if (exclusive && tid == 0 && L > 0) yr[at(0)] = Io<T>::out((A)fill);

  A carry = O::identity();
  for (long long base = 0; base < L; base += tile) {
    const long long first = base + (long long)tid * ITEMS;
    A v[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = first + k;
      v[k] = i < L ? Io<T>::in(xr[at(i)]) : O::identity();
    }
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) v[k] = O::combine(v[k - 1], v[k]);

    // inclusive scan of the thread totals across the warp
    A tot = v[ITEMS - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      A other = __shfl_up_sync(0xffffffffu, tot, off);
      if (lane >= off) tot = O::combine(other, tot);
    }
    if (lane == 31) warp_tot[warp] = tot;
    __syncthreads();
    if (warp == 0) {
      A w = lane < nwarps ? warp_tot[lane] : O::identity();
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        A other = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w = O::combine(other, w);
      }
      if (lane < nwarps) warp_tot[lane] = w;
    }
    __syncthreads();

    // everything before this thread's first element
    A prefix = carry;
    if (warp > 0) prefix = O::combine(prefix, warp_tot[warp - 1]);
    A before = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane > 0) prefix = O::combine(prefix, before);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = first + k + (exclusive ? 1 : 0);
      if (i < L) yr[at(i)] = Io<T>::out(O::combine(prefix, v[k]));
    }
    carry = O::combine(carry, warp_tot[nwarps - 1]);
    __syncthreads();  // warp_tot is rewritten by the next tile
  }
}

template <typename T>
int launch_ops(int op, const void* x, void* y, long long R, long long L, int exclusive,
               int reverse, double fill, int threads, cudaStream_t s) {
  if (R <= 0 || L <= 0) return 0;
  if (R > 0x7fffffffLL || threads < 32 || threads > 1024 || threads % 32) return -2;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (reverse && op != OP_ADD) return -1;
  switch (op) {
    case OP_ADD:
      if (reverse)
        k3_scan_kernel<T, OP_ADD, true><<<(unsigned)R, threads, 0, s>>>(xt, yt, L, exclusive, fill);
      else
        k3_scan_kernel<T, OP_ADD, false><<<(unsigned)R, threads, 0, s>>>(xt, yt, L, exclusive, fill);
      break;
    case OP_MAX:
      k3_scan_kernel<T, OP_MAX, false><<<(unsigned)R, threads, 0, s>>>(xt, yt, L, exclusive, fill);
      break;
    case OP_MUL:
      k3_scan_kernel<T, OP_MUL, false><<<(unsigned)R, threads, 0, s>>>(xt, yt, L, exclusive, fill);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Scan every row of a contiguous (R, L) array x into y, back to front when
// reverse is set (add only). Returns cudaGetLastError() after the launch (0
// on success), -1 for an op, dtype or direction the kernel does not take, -2
// for a grid or block it cannot launch.
extern "C" int k3_prefix_scan(int op, int dtype, const void* x, void* y, long long R,
                              long long L, int exclusive, int reverse, double fill,
                              int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_FLOAT32: return launch_ops<float>(op, x, y, R, L, exclusive, reverse, fill, threads, s);
    case DT_BFLOAT16:
      return launch_ops<__nv_bfloat16>(op, x, y, R, L, exclusive, reverse, fill, threads, s);
    case DT_FLOAT16: return launch_ops<__half>(op, x, y, R, L, exclusive, reverse, fill, threads, s);
    case DT_INT32: return launch_ops<int32_t>(op, x, y, R, L, exclusive, reverse, fill, threads, s);
    case DT_INT8: return launch_ops<int8_t>(op, x, y, R, L, exclusive, reverse, fill, threads, s);
    default: return -1;
  }
}
