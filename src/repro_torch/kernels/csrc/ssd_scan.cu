// K4: the diagonal SSM recurrence h_t = a_t * h_{t-1} + b_t along time, for
// (N, T, D) operands in their natural layout.
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel (built by ssd_scan_pallas).
// The TPU kernel wants time on the lane axis, so its wrapper moves time last
// and flattens (two transposes, each a full extra pass over memory), then
// scans (decay product, state) pairs in tiles with the pair carried in VMEM
// scratch across the sequential time tiles; h0 is folded in afterwards
// through a second, multiplicative prefix scan.
//
// Here time is walked directly in the (N, T, D) layout: one thread owns one
// (n, d) column and steps through T, so the carry is the state h itself, in a
// register. Neighbouring threads own neighbouring features, so every load and
// store of a warp is one contiguous run: no transpose, and h0 simply starts
// the recurrence (one pass instead of three; the same function as the
// reference's fold up to rounding). Loads of the next UNROLL steps are
// issued before the dependent multiply-adds to keep memory busy.
//
// Bound: memory. The kernel reads a and b and writes h: 3*N*T*D*itemsize
// bytes (plus h0) over the card's memory bandwidth. Its parallelism is only
// N*D threads (12,288 at Mamba2-130m width), which a time-chunked two-pass
// form would raise; not taken here.
//
// Arithmetic: every step is __fmul_rn then __fadd_rn (no multiply-add
// contraction, also guarded by -fmad=false) in float32; bfloat16 / float16
// operands are widened on load and h is rounded once per output, the state
// itself stays float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum DType { DT_FLOAT32 = 1, DT_BFLOAT16 = 2, DT_FLOAT16 = 3 };

constexpr int UNROLL = 8;

template <typename T> struct Io;
template <> struct Io<float> {
  static __device__ __forceinline__ float in(float x) { return x; }
  static __device__ __forceinline__ float out(float x) { return x; }
};
template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 out(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Io<__half> {
  static __device__ __forceinline__ float in(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half out(float x) { return __float2half_rn(x); }
};

// one block covers blockDim.x features of one n: grid N * ceil(D / blockDim.x);
// h0 may be null (zero initial state)
template <typename T>
__global__ void k4_ssd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              const T* __restrict__ h0, T* __restrict__ h, long long T_,
                              long long D, long long blocks_per_n) {
  const long long n = blockIdx.x / blocks_per_n;
  const long long d = (blockIdx.x % blocks_per_n) * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const long long base = n * T_ * D + d;
  float state = h0 != nullptr ? Io<T>::in(h0[n * D + d]) : 0.0f;
  long long t = 0;
  for (; t + UNROLL <= T_; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long off = base + (t + k) * D;
      av[k] = Io<T>::in(a[off]);
      bv[k] = Io<T>::in(b[off]);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      state = __fadd_rn(__fmul_rn(av[k], state), bv[k]);
      h[base + (t + k) * D] = Io<T>::out(state);
    }
  }
  for (; t < T_; ++t) {
    const long long off = base + t * D;
    state = __fadd_rn(__fmul_rn(Io<T>::in(a[off]), state), Io<T>::in(b[off]));
    h[off] = Io<T>::out(state);
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* h, long long N, long long T_,
           long long D, int threads, cudaStream_t s) {
  if (N <= 0 || T_ <= 0 || D <= 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32) return -2;
  const long long per_n = (D + threads - 1) / threads;
  if (N * per_n > 0x7fffffffLL) return -2;
  k4_ssd_kernel<T><<<(unsigned)(N * per_n), threads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(h0),
      static_cast<T*>(h), T_, D, per_n);
  return (int)cudaGetLastError();
}

}  // namespace

// h[n, t, d] for contiguous (N, T, D) a, b and h; h0 is (N, D) or null.
// Returns cudaGetLastError() after the launch (0 on success), -1 for a dtype
// the kernel does not take, -2 for a grid or block it cannot launch.
extern "C" int k4_ssd_scan(int dtype, const void* a, const void* b, const void* h0, void* h,
                           long long N, long long T_, long long D, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_FLOAT32: return launch<float>(a, b, h0, h, N, T_, D, threads, s);
    case DT_BFLOAT16: return launch<__nv_bfloat16>(a, b, h0, h, N, T_, D, threads, s);
    case DT_FLOAT16: return launch<__half>(a, b, h0, h, N, T_, D, threads, s);
    default: return -1;
  }
}
