// K5: forward flash attention, online softmax over (BH, S, D) operands with
// causal, sliding-window, q_offset and ragged-Skv masks.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (built by
// flash_attention_pallas). The TPU kernel's grid is (BH, q tiles, kv tiles)
// with the kv axis sequential, so the running (m, l, acc) statistics live in
// VMEM scratch across kv steps. On Hopper the kv walk is a loop inside the
// block: one block owns (bh, a tile of 64 query rows), stages each tile of 64
// keys (32 at D = 128) of K and V in shared memory, and keeps (m, l, acc) in
// float32 registers.
//
// Thread layout (128 threads): thread (ty, tx), ty = tid / 8 in 0..15 owns the
// query rows 4*ty .. 4*ty+3, tx = tid % 8 owns the score columns tx + 8*j
// (j < BKV / 8) and the output columns tx + 8*j (j < D / 8). Row maxima and sums
// reduce over the 8 tx lanes of a row with shuffles. Q and K are staged
// transposed (d-major, rows padded by one word) so the dot-product loop reads
// shared memory without bank conflicts; P goes through shared memory for the
// P.V product. Key tiles that no query row of the block can see are skipped,
// which is exact: a skipped tile after a row's first visible key adds
// exp(-1e30 - m) = 0, and one before it is wiped by alpha = exp(-1e30 - m) = 0
// when the visible key arrives. When some row of the block sees no key at
// all, every tile is walked, as the reference does.
//
// Bound: operations for long sequences: 4*D FLOPs per visible (query, key)
// pair (QK^T and PV), against reading q, k and v once and writing o once. This first kernel runs
// the products on the CUDA cores in float32 (no mma, wgmma or TMA), so it
// sits far above the tensor cores' bound; tensor-core tiles are later work.
//
// Kept from the reference exactly: masked scores are -1e30 (not -inf), so a
// masked entry gives exp(0) until a visible key resets it through alpha;
// s = (q.k) * scale with scale = 1/sqrt(D) applied after the dot; p is cast to
// v's type before the P.V product (l sums p in float32); the denominator is
// clamped at 1e-30; the output is in q's type. Keys at or past Skv do not
// exist: their p is 0 (the reference pads them with zeros and masks them by
// kv_len instead).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum DType { DT_FLOAT32 = 1, DT_BFLOAT16 = 2, DT_FLOAT16 = 3 };

constexpr int BQ = 64;        // query rows a block
constexpr int THREADS = 128;
constexpr int ROWS = 4;       // query rows a thread
constexpr int QPAD = BQ + 1;  // padded row length of the transposed Q tile

// keys a tile: 64, or 32 at D = 128 so that three blocks fit on an SM
template <int D> struct Tile {
  static constexpr int BKV = D == 128 ? 32 : 64;
  static constexpr int KPAD = BKV + 1;  // padded row length of Kt and P
  static constexpr int COLS = BKV / 8;  // score columns a thread
  static constexpr int SMEM_FLOATS = D * QPAD + D * KPAD + BKV * D + BQ * KPAD;
};
constexpr float NEG_INF = -1e30f;

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

struct Params {
  long long Sq, Skv;
  int causal, window;
  long long q_offset;
  float scale;
};

// visible keys of query position q: [lo, hi] (empty when lo > hi)
__device__ __forceinline__ void visible_range(const Params& p, long long q, long long* lo,
                                              long long* hi) {
  long long l = 0, h = p.Skv - 1;
  if (p.causal && q < h) h = q;
  if (p.window > 0 && q - p.window + 1 > l) l = q - p.window + 1;
  *lo = l;
  *hi = h;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) k5_flash_kernel(const T* __restrict__ q,
                                                           const T* __restrict__ k,
                                                           const T* __restrict__ v,
                                                           T* __restrict__ o, Params prm) {
  constexpr int BKV = Tile<D>::BKV;
  constexpr int KPAD = Tile<D>::KPAD;
  constexpr int COLS = Tile<D>::COLS;
  constexpr int OC = D / 8;  // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [D][QPAD]
  float* Kt = Qt + D * QPAD;        // [D][KPAD]
  float* Vs = Kt + D * KPAD;        // [BKV][D]
  float* Ps = Vs + BKV * D;         // [BQ][KPAD]

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const long long bh = blockIdx.y;
  const long long q0 = (long long)blockIdx.x * BQ;
  const T* qb = q + bh * prm.Sq * D;
  const T* kb = k + bh * prm.Skv * D;
  const T* vb = v + bh * prm.Skv * D;

  // stage Q transposed; rows past Sq are zero (computed, never stored)
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qt[d * QPAD + r] = q0 + r < prm.Sq ? Io<T>::in(qb[(q0 + r) * D + d]) : 0.0f;
  }

  // the key range this block walks
  const long long qa = prm.q_offset + q0;
  const long long nq = prm.Sq - q0 < BQ ? prm.Sq - q0 : BQ;
  int empty = 0;
  for (int r = tid; r < nq; r += THREADS) {
    long long lo, hi;
    visible_range(prm, qa + r, &lo, &hi);
    empty |= lo > hi;
  }
  empty = __syncthreads_or(empty);
  long long k_begin = 0, k_end = prm.Skv;
  if (!empty) {
    long long lo, hi, lo2, hi2;
    visible_range(prm, qa, &lo, &hi);
    visible_range(prm, qa + nq - 1, &lo2, &hi2);
    k_begin = lo;     // both bounds grow with the query position
    k_end = hi2 + 1;
  }
  const long long t_begin = k_begin / BKV;
  const long long t_end = (k_end + BKV - 1) / BKV;

  float m[ROWS], l[ROWS], acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.0f;
  }

  for (long long t = t_begin; t < t_end; ++t) {
    const long long k0 = t * BKV;
    __syncthreads();  // the previous tile's Kt, Vs and Ps are consumed
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool ok = k0 + c < prm.Skv;
      Kt[d * KPAD + c] = ok ? Io<T>::in(kb[(k0 + c) * D + d]) : 0.0f;
      Vs[c * D + d] = ok ? Io<T>::in(vb[(k0 + c) * D + d]) : 0.0f;
    }
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qt[d * QPAD + ty * ROWS + i];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = Kt[d * KPAD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long qpos = qa + ty * ROWS + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const long long kpos = k0 + tx + 8 * j;
        bool vis = kpos < prm.Skv;
        if (prm.causal) vis = vis && qpos >= kpos;
        if (prm.window > 0) vis = vis && qpos - kpos < prm.window;
        s[i][j] = vis ? __fmul_rn(s[i][j], prm.scale) : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const long long kpos = k0 + tx + 8 * j;
        const float p = kpos < prm.Skv ? expf(__fsub_rn(s[i][j], m_new)) : 0.0f;
        rs = __fadd_rn(rs, p);
        // p in v's type for the P.V product
        Ps[(ty * ROWS + i) * KPAD + tx + 8 * j] = Io<T>::in(Io<T>::out(p));
      }
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 4));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[ROWS], vv[OC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(ty * ROWS + i) * KPAD + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) vv[j] = Vs[c * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long r = q0 + ty * ROWS + i;
    if (r >= prm.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < OC; ++j)
      o[(bh * prm.Sq + r) * D + tx + 8 * j] = Io<T>::out(__fdiv_rn(acc[i][j], denom));
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, long long BH,
             const Params& prm, cudaStream_t s) {
  const int smem = Tile<D>::SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(k5_flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long qtiles = (prm.Sq + BQ - 1) / BQ;
  if (qtiles > 0x7fffffffLL || BH > 65535) return -2;
  dim3 grid((unsigned)qtiles, (unsigned)BH);
  k5_flash_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), prm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, long long BH, long long D,
           const Params& prm, cudaStream_t s) {
  switch (D) {
    case 32: return launch_d<T, 32>(q, k, v, o, BH, prm, s);
    case 64: return launch_d<T, 64>(q, k, v, o, BH, prm, s);
    case 128: return launch_d<T, 128>(q, k, v, o, BH, prm, s);
    default: return -1;
  }
}

}  // namespace

// o = attention(q, k, v) for contiguous (BH, Sq, D) q and o and (BH, Skv, D)
// k and v, all of one dtype. Returns cudaGetLastError() after the launch (0
// on success), -1 for a dtype or head size the kernel does not take, -2 for a
// grid it cannot launch.
extern "C" int k5_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* o, long long BH, long long Sq, long long Skv,
                                  long long D, int causal, int window, long long q_offset,
                                  float scale, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  Params prm;
  prm.Sq = Sq;
  prm.Skv = Skv;
  prm.causal = causal;
  prm.window = window;
  prm.q_offset = q_offset;
  prm.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_FLOAT32: return launch<float>(q, k, v, o, BH, D, prm, s);
    case DT_BFLOAT16: return launch<__nv_bfloat16>(q, k, v, o, BH, D, prm, s);
    case DT_FLOAT16: return launch<__half>(q, k, v, o, BH, D, prm, s);
    default: return -1;
  }
}
