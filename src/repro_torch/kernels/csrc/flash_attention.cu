// K5: forward flash attention, online softmax over (BH, S, D) operands with
// causal, sliding-window, q_offset and ragged-Skv masks.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (built by
// flash_attention_pallas). The TPU kernel's grid is (BH, q tiles, kv tiles)
// with the kv axis sequential, so the running (m, l, acc) statistics live in
// VMEM scratch across kv steps. On Hopper the kv walk is a loop inside a
// block, and the wrapper (kernels/flash_attention.py::plan_launch) picks one
// of three paths by the query length and the dtype:
//
// decode (Sq <= 16, every dtype): k5_flash_kernel_decode, then
//   k5_flash_kernel_combine. Bound by bytes: the keys and values are read
//   once and each serves at most 16 query rows, so the work is a few FLOPs a
//   byte. The TPU shape (one block a query tile walking every key) would run
//   BH blocks on 132 SMs; here the keys of each bh are split into chunks so
//   that the grid holds at least 2 x 132 blocks where Skv allows. A block
//   stages 32- or 64-key tiles of its chunk in shared memory with 16-byte
//   cp.async copies (double-buffered), serves all Sq rows from that one read
//   on the CUDA cores (compiled for 1 or 16 rows, so a one-row step does
//   one row's work), and writes float32 partials (m, l, acc[D]) to a
//   workspace; the second, small launch rescales them by exp(m_i - M) and
//   writes o. One chunk (grid already full) writes o directly: one launch.
//
// tc (bf16/fp16, Sq > 16): k5_flash_kernel_tc. Bound by operations: 4*D
//   FLOPs per visible (query, key) pair against reading q, k, v once. Both
//   products run on the tensor cores with wgmma: a block owns 128 query rows,
//   two consumer warpgroups of 64 rows each compute S = Q K^T (m64n128k16,
//   Q and K from shared memory, S in float32 registers), the online softmax
//   in registers, and O += P V with P cast to the input type in registers as
//   the A operand and V read from shared memory through the descriptor's
//   transpose. One producer warp fills a ring of K/V stages (3, or 2 at
//   D = 128) by TMA with 128-byte swizzle (64-byte at D = 32), completion on
//   mbarriers, so copies overlap the products; setmaxnreg gives the
//   consumers 240 registers and the producer 24. At D = 64 a tile's exp2
//   work on the SFU costs as many cycles as its products, so the two must
//   overlap: the consumer warpgroups take turns to issue their products
//   (one's softmax runs under the other's wgmma), and below D = 128 the
//   next tile's S and this tile's P.V stay in flight during the softmax
//   (at D = 128 that does not fit the registers). The tensor maps are over
//   the 3-D (BH, S, D) views, so rows past Sq or Skv load as zeros, never as
//   the next head's rows. Only tiles that cut a causal diagonal, a window
//   edge or Skv are masked. Blocks run the heaviest causal query tiles first
//   (under a window, one head's tiles together, for L2 reuse of its keys).
//
// simt (float32, Sq > 16): k5_flash_kernel, the first kernel of the port,
//   kept as it was: the products on the CUDA cores in float32, since the
//   tensor cores would run float32 as TF32 (about three decimal digits)
//   against a 5e-4 tolerance.
//
// Every path keeps the per-block key range: key tiles that no query row of
// the block can see are skipped, which is exact (a skipped tile after a
// row's first visible key adds exp(-1e30 - m) = 0, one before it is wiped by
// alpha = exp(-1e30 - m) = 0 when the visible key arrives); when some row of
// the block sees no key at all, every tile is walked, as the reference does.
//
// Kept from the reference exactly: masked scores are -1e30 (not -inf), so a
// masked entry gives exp(0) until a visible key resets it through alpha;
// s = (q.k) * scale with scale = 1/sqrt(D) applied after the dot (the tc
// path folds log2(e) into the scale and uses exp2, with the -1e30 placed
// after scaling); l sums p unrounded in float32; p is cast to v's type before
// the P.V product; the denominator is clamped at 1e-30; the output is in q's
// type. Keys at or past Skv do not exist: their p is 0 (the reference pads
// them with zeros and masks them by kv_len instead).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

// What each design choice below gained on an H100 (PR 14's chip runs, bf16,
// events us a call): at SmolLM's D = 64 prefill the consumer warpgroups'
// turns (125.2-125.6 without, against 115.3-118.3) and the in-flight S /
// P.V (124.6-125.1 without); at D = 128 in-flight S / P.V took 535.8-537.2
// against 334.4-339.5 (ptxas serialized the wgmma); under a window one
// head's query tiles together gave 2-5% over the causal order; the one-row
// decode kernel took 13.8-14.1 device us against the 16-row kernel's
// 32.9-33.0.

namespace {

enum DType { DT_FLOAT32 = 1, DT_BFLOAT16 = 2, DT_FLOAT16 = 3 };
enum Path { PATH_SIMT = 0, PATH_TC = 1, PATH_DECODE = 2 };
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

// the keys some query row in [qa, qa + nq) sees: [*begin, *end), or every key
// when one of those rows sees none. Both ends of a row's visible range grow
// with its position, so only the first and last rows can see no key.
__device__ __forceinline__ void block_key_range(const Params& p, long long qa, long long nq,
                                                long long* begin, long long* end) {
  long long lo, hi, lo2, hi2;
  visible_range(p, qa, &lo, &hi);
  visible_range(p, qa + nq - 1, &lo2, &hi2);
  if (lo > hi || lo2 > hi2) {
    *begin = 0;
    *end = p.Skv;
  } else {
    *begin = lo;
    *end = hi2 + 1;
  }
}

__device__ __forceinline__ bool key_visible(const Params& p, long long qpos, long long kpos) {
  bool vis = true;
  if (p.causal) vis = vis && qpos >= kpos;
  if (p.window > 0) vis = vis && qpos - kpos < p.window;
  return vis;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---------------------------------------------------------------------------
// decode: Sq <= 16, keys split into chunks, then a combine
// ---------------------------------------------------------------------------

namespace dec {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXQ = 16;  // query rows the path takes (plan_launch's DECODE_MAX_SQ)

struct SplitParams {
  Params p;
  long long key_lo;     // first key of split 0, a multiple of TK
  long long split_len;  // keys a split, a multiple of TK
  int nsplit;           // 1: the split kernel writes o itself
};

// ROWS: the query rows a kernel is compiled for (1, or 16 for any Sq up to
// MAXQ), so that a one-row decode step does one row's work
template <typename T, int D, int ROWS> struct Cfg {
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  // keys a staged tile (plan_launch's decode tile)
  static constexpr int TK = ROW_BYTES <= 256 ? 64 : 32;
  // staged rows padded by 16 bytes: the score loop's 16-byte reads of
  // consecutive keys fall on distinct banks
  static constexpr int ROWB = ROW_BYTES + 16;
  static constexpr int VPR = ROW_BYTES / 16;  // 16-byte vectors a row
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int SLICES = THREADS / D;  // key slices of the P.V loop
  static constexpr int KV_BYTES = TK * ROWB;
  // K[2], V[2], Qs[ROWS][D], S[ROWS][TK], alpha[ROWS], m[ROWS], l[ROWS],
  // red[SLICES][ROWS][D]
  static constexpr int SMEM = 4 * KV_BYTES +
                              4 * (ROWS * D + ROWS * TK + 3 * ROWS + SLICES * ROWS * D);
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes = 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory (16 / sizeof(T) elements) into floats
template <typename T>
__device__ __forceinline__ void load16(const uint8_t* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = Io<T>::in(e[i]);
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(THREADS) k5_flash_kernel_decode(const T* __restrict__ q,
                                                                  const T* __restrict__ k,
                                                                  const T* __restrict__ v,
                                                                  T* __restrict__ o,
                                                                  float* __restrict__ part,
                                                                  SplitParams sp) {
  using C = Cfg<T, D, ROWS>;
  constexpr int TK = C::TK, VEC = C::VEC, VPR = C::VPR, SLICES = C::SLICES;
  constexpr int WROWS = (ROWS + WARPS - 1) / WARPS;  // rows a warp keeps statistics of
  const Params& prm = sp.p;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Ks = smem;                       // [2][TK][ROWB]
  uint8_t* Vs = Ks + 2 * C::KV_BYTES;       // [2][TK][ROWB]
  float* Qs = reinterpret_cast<float*>(Vs + 2 * C::KV_BYTES);  // [ROWS][D]
  float* Ss = Qs + ROWS * D;                // [ROWS][TK]: scores, then p in v's type
  float* alpha_s = Ss + ROWS * TK;          // [ROWS]
  float* m_s = alpha_s + ROWS;              // [ROWS]
  float* l_s = m_s + ROWS;                  // [ROWS]
  float* red = l_s + ROWS;                  // [SLICES][ROWS][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x / sp.nsplit;
  const int split = (int)(blockIdx.x % sp.nsplit);
  const int Sq = (int)prm.Sq;
  const long long s0 = sp.key_lo + (long long)split * sp.split_len;
  const long long s1 = s0 + sp.split_len < prm.Skv ? s0 + sp.split_len : prm.Skv;
  long long k_begin, k_end;
  block_key_range(prm, prm.q_offset, Sq, &k_begin, &k_end);
  const long long lo = s0 > k_begin ? s0 : k_begin;
  const long long hi = s1 < k_end ? s1 : k_end;
  float* pout = part + (bh * sp.nsplit + split) * (long long)Sq * (D + 2);

  if (lo >= hi && sp.nsplit > 1) {  // no row of the block sees a key of this split
    for (int i = tid; i < Sq * (D + 2); i += THREADS)
      pout[i] = i % (D + 2) == 0 ? NEG_INF : 0.0f;
    return;
  }

  const T* qb = q + bh * prm.Sq * D;
  const T* kb = k + bh * prm.Skv * D;
  const T* vb = v + bh * prm.Skv * D;
  for (int i = tid; i < Sq * D; i += THREADS) Qs[i] = Io<T>::in(qb[i]);

  const long long t_begin = lo / TK, t_end = (hi + TK - 1) / TK;
  auto stage = [&](long long t, int st) {
    const uint32_t kd = smem_u32(Ks + st * C::KV_BYTES);
    const uint32_t vd = smem_u32(Vs + st * C::KV_BYTES);
    for (int i = tid; i < TK * VPR; i += THREADS) {
      const int row = i / VPR, c = i % VPR;
      const long long key = t * TK + row;
      const bool ok = key < prm.Skv;
      const long long off = ok ? key * D + c * VEC : 0;
      cp_async16(kd + row * C::ROWB + c * 16, kb + off, ok ? 16 : 0);
      cp_async16(vd + row * C::ROWB + c * 16, vb + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // running statistics: row r = warp + WARPS * i lives in warp `warp`
  float m_r[WROWS], l_r[WROWS];
#pragma unroll
  for (int i = 0; i < WROWS; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.0f;
  }
  // P.V: thread owns column d of every row over the keys j = slice (mod SLICES)
  const int d = tid % D, slice = tid / D;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;

  stage(t_begin, 0);
  for (long long t = t_begin; t < t_end; ++t) {
    const int st = (int)((t - t_begin) & 1);
    if (t + 1 < t_end) {
      stage(t + 1, st ^ 1);  // its buffer's last reader finished before the loop's end barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* Kt = Ks + st * C::KV_BYTES;
    const uint8_t* Vt = Vs + st * C::KV_BYTES;

    // raw scores q_r . k_j
    for (int i = tid; i < Sq * TK; i += THREADS) {
      const int r = i / TK, j = i % TK;
      const float* qr = Qs + r * D;
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < VPR; ++c) {
        float kv[VEC];
        load16<T>(Kt + j * C::ROWB + c * 16, kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = __fmaf_rn(qr[c * VEC + e], kv[e], dot);
      }
      Ss[r * TK + j] = dot;
    }
    __syncthreads();

    // online softmax, one warp a row
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int r = warp + WARPS * i;
      if (r < Sq) {
        const long long qpos = prm.q_offset + r;
        float s[TK / 32];
        float mt = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < TK / 32; ++jj) {
          const int j = lane + 32 * jj;
          const long long kpos = t * TK + j;
          const float raw = Ss[r * TK + j];
          s[jj] = key_visible(prm, qpos, kpos) ? __fmul_rn(raw, prm.scale) : NEG_INF;
          if (kpos < prm.Skv) mt = fmaxf(mt, s[jj]);
        }
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
        const float m_new = fmaxf(m_r[i], mt);
        const float alpha = expf(__fsub_rn(m_r[i], m_new));
        float rs = 0.0f;
#pragma unroll
        for (int jj = 0; jj < TK / 32; ++jj) {
          const int j = lane + 32 * jj;
          const float p = t * TK + j < prm.Skv ? expf(__fsub_rn(s[jj], m_new)) : 0.0f;
          rs = __fadd_rn(rs, p);
          Ss[r * TK + j] = Io<T>::in(Io<T>::out(p));  // p in v's type for P.V
        }
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, w));
        l_r[i] = __fadd_rn(__fmul_rn(l_r[i], alpha), rs);
        m_r[i] = m_new;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < Sq) acc[r] = __fmul_rn(acc[r], alpha_s[r]);
    for (int j = slice; j < TK; j += SLICES) {
      const float vj = Io<T>::in(reinterpret_cast<const T*>(Vt + j * C::ROWB)[d]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < Sq) acc[r] = __fmaf_rn(Ss[r * TK + j], vj, acc[r]);
    }
    __syncthreads();  // K, V, S of this tile consumed
  }

  // fold the key slices, then write the partial (or o, for one split)
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r < Sq) red[(slice * ROWS + r) * D + d] = acc[r];
#pragma unroll
  for (int i = 0; i < WROWS; ++i) {
    const int r = warp + WARPS * i;
    if (r < Sq && lane == 0) {
      m_s[r] = m_r[i];
      l_s[r] = l_r[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < Sq * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float a = red[r * D + c];
#pragma unroll
    for (int sl = 1; sl < SLICES; ++sl) a = __fadd_rn(a, red[(sl * ROWS + r) * D + c]);
    if (sp.nsplit == 1) {
      o[(bh * prm.Sq + r) * D + c] = Io<T>::out(__fdiv_rn(a, fmaxf(l_s[r], 1e-30f)));
    } else {
      float* pr = pout + r * (D + 2);
      pr[2 + c] = a;
      if (c == 0) {
        pr[0] = m_s[r];
        pr[1] = l_s[r];
      }
    }
  }
}

// o[row] = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30), w_i = exp(m_i - max_i m_i),
// one warp a (bh, query row). Lane t holds the weight of split c0 + t of each
// chunk of 32 splits and hands it to the others by shuffle, so the partials
// are read in two passes (m for the maximum, then everything) instead of one
// dependent read per split and column.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) k5_flash_kernel_combine(const float* __restrict__ part,
                                                                   T* __restrict__ o,
                                                                   long long rows, long long Sq,
                                                                   int nsplit) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long bh = row / Sq, r = row % Sq;
  const long long stride = Sq * (D + 2);  // from one split's partial of this row to the next
  const float* p0 = part + (bh * nsplit * Sq + r) * (D + 2);
  float M = NEG_INF;
  for (int i = lane; i < nsplit; i += 32) M = fmaxf(M, p0[i * stride]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, w));
  float L = 0.0f, acc[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) acc[j] = 0.0f;
  for (int c0 = 0; c0 < nsplit; c0 += 32) {
    float w = 0.0f;
    if (c0 + lane < nsplit) {
      const float* pi = p0 + (c0 + lane) * stride;
      w = expf(__fsub_rn(pi[0], M));
      L = __fmaf_rn(w, pi[1], L);
    }
    const int n = nsplit - c0 < 32 ? nsplit - c0 : 32;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float wt = __shfl_sync(0xffffffffu, w, t);
      const float* pt = p0 + (c0 + t) * stride + 2;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[j] = __fmaf_rn(wt, pt[lane + 32 * j], acc[j]);
    }
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) L = __fadd_rn(L, __shfl_xor_sync(0xffffffffu, L, w));
  const float den = fmaxf(L, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 32; ++j) o[row * D + lane + 32 * j] = Io<T>::out(__fdiv_rn(acc[j], den));
}

}  // namespace dec

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

// ---------------------------------------------------------------------------
// tc: bf16/fp16 prefill on the tensor cores (wgmma, TMA, mbarriers)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;   // query rows a block: two consumer warpgroups of 64
constexpr int BKV = 128;  // keys a tile
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
// about 2 s at the H100's clock: a barrier that waits longer than this lost
// its copy, and the kernel traps rather than hanging the card
constexpr long long WAIT_CYCLES = 4000000000LL;

template <int D> struct Cfg {
  static constexpr int PW = D < 64 ? D : 64;  // elements a swizzled panel row
  static constexpr int RB = PW * 2;           // its bytes, the swizzle span: 64 or 128
  static constexpr int PANELS = D / PW;       // D = 128 is two 64-column panels
  static constexpr int LAYOUT = RB == 128 ? 1 : 2;  // wgmma descriptor: 128B or 64B swizzle
  static constexpr int KV_BYTES = BKV * D * 2;      // one stage of K (or of V)
  static constexpr int STAGES = D == 128 ? 2 : 3;   // K/V ring depth
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // 1024 bytes of slack to align the tiles to the swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

struct TcParams {
  Params p;
  long long BH;
};

template <typename T> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_CYCLES) __trap();
}

// a (PW x rows x 1) box of the 3-D (BH, S, D) tensor map at (d0, row0, bh)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int d0, int row0,
                                         int bh, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(row0), "r"(bh), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma operands across
// the fence, commit and wait
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to T, lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the wgmma instructions this kernel issues (m64nNk16, float32 accumulators):
// S = Q K^T with both operands K-major in shared memory (ss), and O += P V
// with P from registers and V transposed from shared memory (rs)
__device__ __forceinline__ void wgmma_ss_n128_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32_bf16(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128_bf16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128_f16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32_f16(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64_f16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <typename T>
__device__ __forceinline__ void mma_qk(float (&s)[BKV / 2], uint64_t da, uint64_t db,
                                       int scale_d) {
  if constexpr (IsBf16<T>::value)
    wgmma_ss_n128_bf16(s, da, db, scale_d);
  else
    wgmma_ss_n128_f16(s, da, db, scale_d);
}

template <typename T, int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (IsBf16<T>::value) {
    if constexpr (D == 32) wgmma_rs_n32_bf16(o, a, db);
    else if constexpr (D == 64) wgmma_rs_n64_bf16(o, a, db);
    else wgmma_rs_n128_bf16(o, a, db);
  } else {
    if constexpr (D == 32) wgmma_rs_n32_f16(o, a, db);
    else if constexpr (D == 64) wgmma_rs_n64_f16(o, a, db);
    else wgmma_rs_n128_f16(o, a, db);
  }
}

// One block: 128 query rows of one bh. Warps 0-7 are two consumer
// warpgroups (rows 0-63 and 64-127 of the tile), warps 8-11 the producer,
// of which one thread issues every TMA copy. Accumulator layout of
// m64nNk16 (as mma.sync's m16n8, repeated): in warp w of a group, lane l
// holds for each 8-column block j the elements (16w + l/4, 8j + 2(l%4) + e)
// in registers 4j + e and (16w + l/4 + 8, ...) in 4j + 2 + e, e in {0, 1}.
// Two such blocks of S are exactly one k16 slice of the A operand of P.V.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    k5_flash_kernel_tc(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv, T* __restrict__ o,
                       const TcParams tp) {
  using C = Cfg<D>;
  // Overlap inside a warpgroup (S of the next tile and P.V of this one in
  // flight during the softmax) needs S, P and O live at once: at D = 128
  // that exceeds the consumers' registers and ptxas serializes the wgmma
  // instead, so D = 128 issues its products one tile at a time.
  constexpr bool PIPE = D < 128;
  const Params& prm = tp.p;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;                // [STAGES][PANELS][BKV][PW]
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;   // [STAGES][PANELS][BKV][PW]
  const uint32_t bar_q = sV + C::STAGES * C::KV_BYTES;
  const uint32_t bar_k = bar_q + 8;                   // [STAGES] K landed
  const uint32_t bar_v = bar_k + 8 * C::STAGES;       // [STAGES] V landed
  const uint32_t bar_e = bar_v + 8 * C::STAGES;       // [STAGES] stage consumed

  // (bh, query tile), the tiles with the most causal keys first; under a
  // window, where the tiles cost about the same, the tiles of one head run
  // together so that its keys stay in L2
  const int nqt = (int)((prm.Sq + BQ - 1) / BQ), nbh = (int)tp.BH;
  const bool by_head = prm.window > 0;
  const int bh = by_head ? (int)blockIdx.x / nqt : (int)blockIdx.x % nbh;
  const int qt = by_head ? (int)blockIdx.x % nqt : (int)blockIdx.x / nbh;
  const long long q0 = (long long)(nqt - 1 - qt) * BQ;
  const long long nq = prm.Sq - q0 < BQ ? prm.Sq - q0 : BQ;
  const long long qa = prm.q_offset + q0;
  long long k_begin, k_end;
  block_key_range(prm, qa, nq, &k_begin, &k_end);
  const int t_begin = (int)(k_begin / BKV);
  const int ntiles = (int)((k_end + BKV - 1) / BKV) - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // producer: Q once, then K and V tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMER_THREADS) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int pn = 0; pn < C::PANELS; ++pn)
        tma_load(sQ + pn * BQ * C::RB, &tmq, pn * C::PW, (int)q0, bh, bar_q);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(bar_e + 8 * s, ((i / C::STAGES) & 1) ^ 1);
        const int key0 = (t_begin + i) * BKV;
        mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load(sK + s * C::KV_BYTES + pn * BKV * C::RB, &tmk, pn * C::PW, key0, bh,
                   bar_k + 8 * s);
        mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load(sV + s * C::KV_BYTES + pn * BKV * C::RB, &tmv, pn * C::PW, key0, bh,
                   bar_v + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int g = threadIdx.x >> 7;           // consumer warpgroup
    const int wq = (threadIdx.x >> 5) & 3;    // warp in the group
    const int lane = threadIdx.x & 31;
    const int rt = 64 * g + 16 * wq + (lane >> 2);  // tile row of registers 4j, 4j+1
    const int cq = 2 * (lane & 3);                  // column of register 4j in its block
    const long long qpos0 = qa + rt;
    const float scale2 = __fmul_rn(prm.scale, LOG2E);  // scores in log2 units
    const uint32_t sQg = sQ + 64 * g * C::RB;
    constexpr uint32_t SBO = 8 * C::RB;             // next 8-row group
    constexpr uint32_t V_LBO = BKV * C::RB;         // V: next 64-column panel

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f, a0 = 1.0f, a1 = 1.0f;
    float sc[BKV / 2];         // S of one tile, then its p (float32)
    uint32_t pa[BKV / 16][4];  // p in T: the A operand of P.V, one k16 slice each

    // S = Q K^T of tile i into sc, k16 slices along D (committed, not waited)
    auto issue_qk = [&](int i) {
      const int s = i % C::STAGES;
      mbar_wait(bar_k + 8 * s, (i / C::STAGES) & 1);
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / C::PW) * BQ * C::RB + (kk * 16 % C::PW) * 2;
        const uint32_t offk = (kk * 16 / C::PW) * BKV * C::RB + (kk * 16 % C::PW) * 2;
        mma_qk<T>(sc, make_desc(sQg + off, 16, SBO, C::LAYOUT),
                  make_desc(sK + s * C::KV_BYTES + offk, 16, SBO, C::LAYOUT), kk > 0);
      }
      wg_commit();
    };
    // the online softmax of tile i, in place: sc becomes p, (m, l) move on and
    // (a0, a1) is the rescale of what came before
    auto softmax = [&](int i) {
      // the thread's rows (qpos0 and qpos0 + 8) against the tile's keys
      const long long k0 = (long long)(t_begin + i) * BKV, dq = qpos0 - k0;
      const bool interior = prm.Skv - k0 >= BKV && (!prm.causal || dq >= BKV - 1) &&
                            (prm.window <= 0 || dq + 8 < prm.window);
      if (interior) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) sc[e] = __fmul_rn(sc[e], scale2);
      } else {
        // in 32 bits: the row's distance to the tile's first key, and the
        // keys left before Skv, clamped where no comparison can change
        const long long dk = prm.Skv - k0;
        constexpr long long LIM = 1LL << 30;
        const int base = (int)(dq < -LIM ? -LIM : dq > LIM ? LIM : dq);
        const int keys_left = (int)(dk > LIM ? LIM : dk);
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int ko = 8 * (e >> 2) + cq + (e & 1);  // key within the tile
          const int dist = base + ((e & 2) ? 8 : 0) - ko;  // qpos - kpos
          const bool vis = (!prm.causal || dist >= 0) && (prm.window <= 0 || dist < prm.window);
          const float x = vis ? __fmul_rn(sc[e], scale2) : NEG_INF;
          sc[e] = ko < keys_left ? x : -INFINITY;  // keys past Skv: p = 0
        }
      }
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        mt0 = fmaxf(mt0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mt1 = fmaxf(mt1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      a0 = ex2(__fsub_rn(m0, mn0));
      a1 = ex2(__fsub_rn(m1, mn1));
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        sc[4 * j] = ex2(__fsub_rn(sc[4 * j], mn0));
        sc[4 * j + 1] = ex2(__fsub_rn(sc[4 * j + 1], mn0));
        sc[4 * j + 2] = ex2(__fsub_rn(sc[4 * j + 2], mn1));
        sc[4 * j + 3] = ex2(__fsub_rn(sc[4 * j + 3], mn1));
        rs0 = __fadd_rn(rs0, __fadd_rn(sc[4 * j], sc[4 * j + 1]));
        rs1 = __fadd_rn(rs1, __fadd_rn(sc[4 * j + 2], sc[4 * j + 3]));
      }
      // per-thread partial row sums; the four lanes of a row add up at the end
      l0 = __fadd_rn(__fmul_rn(l0, a0), rs0);
      l1 = __fadd_rn(__fmul_rn(l1, a1), rs1);
    };

    // P of the tile in sc to T (registers 8kk..8kk+7 hold keys 16kk..16kk+15:
    // a0..a3 of slice kk), and O rescaled by the tile's alpha
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] = __fmul_rn(oacc[4 * j], a0);
        oacc[4 * j + 1] = __fmul_rn(oacc[4 * j + 1], a0);
        oacc[4 * j + 2] = __fmul_rn(oacc[4 * j + 2], a1);
        oacc[4 * j + 3] = __fmul_rn(oacc[4 * j + 3], a1);
      }
      fence_regs(oacc);
      fence_regs(pa);
      fence_regs(sc);
    };
    // O += P V of tile i, k16 slices along the keys (committed, not waited)
    auto issue_pv = [&](int i) {
      const int s = i % C::STAGES;
      mbar_wait(bar_v + 8 * s, (i / C::STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        mma_pv<T, D>(oacc, pa[kk],
                     make_desc(sV + s * C::KV_BYTES + kk * 16 * C::RB, V_LBO, SBO, C::LAYOUT));
      wg_commit();
    };

    // Two schedules keep the tensor cores busy during the softmax:
    // - ping-pong: the two warpgroups take turns to issue their products
    //   (named barriers 1 and 2 of 256 threads: one group syncs, the other
    //   arrives), so one group's softmax runs under the other's products.
    //   Group 1 lets group 0 go first, and group 0 takes group 1's last
    //   arrive after its own last turn, so every arrive meets a sync;
    // - with PIPE, S of tile i + 1 and P.V of tile i are in flight during
    //   the softmax of tile i + 1. The last tile is peeled, so every branch
    //   issues and waits alike and ptxas can follow the wgmma groups
    //   without serializing them.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + g) : "memory");
    };
    auto their_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - g) : "memory");
    };
    if (g == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    mbar_wait(bar_q, 0);
    if constexpr (PIPE) {
      my_turn();
      issue_qk(0);
      their_turn();
      wg_wait<0>();
      fence_regs(sc);
      softmax(0);
      for (int i = 0; i + 1 < ntiles; ++i) {
        pack_p();
        my_turn();
        issue_qk(i + 1);
        issue_pv(i);
        their_turn();
        wg_wait<1>();  // S of tile i + 1 (groups complete in order)
        fence_regs(sc);
        softmax(i + 1);
        wg_wait<0>();
        fence_regs(oacc);
        mbar_arrive(bar_e + 8 * (i % C::STAGES));  // K and V of tile i consumed
      }
      pack_p();
      my_turn();
      issue_pv(ntiles - 1);
      their_turn();
      wg_wait<0>();
      fence_regs(oacc);
      mbar_arrive(bar_e + 8 * ((ntiles - 1) % C::STAGES));
    } else {
      for (int i = 0; i < ntiles; ++i) {
        my_turn();
        issue_qk(i);
        their_turn();
        wg_wait<0>();
        fence_regs(sc);
        softmax(i);
        pack_p();
        issue_pv(i);
        wg_wait<0>();
        fence_regs(oacc);
        mbar_arrive(bar_e + 8 * (i % C::STAGES));
      }
    }
    if (g == 0) my_turn();

    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 1));
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 2));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 1));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 2));
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const long long row0 = q0 + rt, row1 = row0 + 8;
    T* ob = o + (long long)bh * prm.Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      if (row0 < prm.Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * D + col) =
            pack2<T>(__fdiv_rn(oacc[4 * j], d0), __fdiv_rn(oacc[4 * j + 1], d0));
      if (row1 < prm.Sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * D + col) =
            pack2<T>(__fdiv_rn(oacc[4 * j + 2], d1), __fdiv_rn(oacc[4 * j + 3], d1));
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// after a launch: its error, and one more launch in *n when there is none
int launched(int* n) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*n;
  return (int)err;
}

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* o, long long BH,
                const Params& prm, cudaStream_t s, int* n) {
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
  return launched(n);
}

template <typename T, int D, int ROWS>
int launch_decode_rows(const void* q, const void* k, const void* v, void* o, void* work,
                       long long BH, const dec::SplitParams& sp, cudaStream_t s, int* n) {
  using C = dec::Cfg<T, D, ROWS>;
  if (sp.nsplit < 1 || sp.split_len <= 0 || sp.split_len % C::TK || sp.key_lo < 0 ||
      sp.key_lo % C::TK)
    return -3;
  const long long blocks = BH * sp.nsplit;
  const long long rows = BH * sp.p.Sq;
  if (blocks > 0x7fffffffLL || (rows + dec::WARPS - 1) / dec::WARPS > 0x7fffffffLL) return -2;
  cudaError_t err = cudaFuncSetAttribute(dec::k5_flash_kernel_decode<T, D, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dec::k5_flash_kernel_decode<T, D, ROWS><<<(unsigned)blocks, dec::THREADS, C::SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(work), sp);
  const int rc = launched(n);
  if (rc != 0 || sp.nsplit == 1) return rc;
  dec::k5_flash_kernel_combine<T, D>
      <<<(unsigned)((rows + dec::WARPS - 1) / dec::WARPS), dec::THREADS, 0, s>>>(
          static_cast<const float*>(work), static_cast<T*>(o), rows, sp.p.Sq, sp.nsplit);
  return launched(n);
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, void* o, void* work,
                  long long BH, const dec::SplitParams& sp, cudaStream_t s, int* n) {
  if (sp.p.Sq == 1)
    return launch_decode_rows<T, D, 1>(q, k, v, o, work, BH, sp, s, n);
  if (sp.p.Sq <= dec::MAXQ)
    return launch_decode_rows<T, D, dec::MAXQ>(q, k, v, o, work, BH, sp, s, n);
  return -3;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 3-D (BH, S, D) view, boxes of (PW, rows, 1): rows past S read as zeros
template <typename T, int D>
int make_map(CUtensorMap* map, const void* ptr, long long BH, long long S, int rows) {
  using C = tc::Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -4;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)(S * D * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)C::PW, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tc::IsBf16<T>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

template <typename T, int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, long long BH,
              const Params& prm, cudaStream_t s, int* n) {
  using C = tc::Cfg<D>;
  const long long blocks = BH * ((prm.Sq + tc::BQ - 1) / tc::BQ);
  if (blocks > 0x7fffffffLL || prm.Sq > 0x7fffffffLL || prm.Skv > 0x7fffffffLL ||
      BH > 0x7fffffffLL)
    return -2;
  CUtensorMap mq, mk, mv;
  int rc = make_map<T, D>(&mq, q, BH, prm.Sq, tc::BQ);
  if (rc == 0) rc = make_map<T, D>(&mk, k, BH, prm.Skv, tc::BKV);
  if (rc == 0) rc = make_map<T, D>(&mv, v, BH, prm.Skv, tc::BKV);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(tc::k5_flash_kernel_tc<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  tc::TcParams tp;
  tp.p = prm;
  tp.BH = BH;
  tc::k5_flash_kernel_tc<T, D>
      <<<(unsigned)blocks, tc::THREADS, C::SMEM, s>>>(mq, mk, mv, static_cast<T*>(o), tp);
  return launched(n);
}

template <typename T, int D>
int launch_path(int path, const void* q, const void* k, const void* v, void* o, void* work,
                long long BH, const dec::SplitParams& sp, cudaStream_t s, int* n) {
  switch (path) {
    case PATH_SIMT:
      if constexpr (sizeof(T) == 4) return launch_simt<T, D>(q, k, v, o, BH, sp.p, s, n);
      return -1;
    case PATH_DECODE: return launch_decode<T, D>(q, k, v, o, work, BH, sp, s, n);
    case PATH_TC:
      if constexpr (sizeof(T) == 2) return launch_tc<T, D>(q, k, v, o, BH, sp.p, s, n);
      return -1;
    default: return -1;
  }
}

template <typename T>
int launch(int path, const void* q, const void* k, const void* v, void* o, void* work,
           long long BH, long long D, const dec::SplitParams& sp, cudaStream_t s, int* n) {
  switch (D) {
    case 32: return launch_path<T, 32>(path, q, k, v, o, work, BH, sp, s, n);
    case 64: return launch_path<T, 64>(path, q, k, v, o, work, BH, sp, s, n);
    case 128: return launch_path<T, 128>(path, q, k, v, o, work, BH, sp, s, n);
    default: return -1;
  }
}

}  // namespace

// o = attention(q, k, v) for contiguous, 16-byte aligned (BH, Sq, D) q and o
// and (BH, Skv, D) k and v, all of one dtype, by the path plan_launch chose
// (0 simt, 1 tc, 2 decode). The decode path splits the keys from key_lo on
// into nsplit chunks of split_len (multiples of its key tile) and, for more
// than one, needs a float32 workspace of BH * nsplit * Sq * (D + 2). Returns
// cudaGetLastError() after the last launch (0 on success), -1 for a dtype,
// head size or path the kernels do not take, -2 for a grid they cannot
// launch, -3 for a split they do not take, -4 when the tensor maps cannot be
// made. *launches is set to the number of kernels launched, each counted once
// cudaGetLastError() has passed its launch.
extern "C" int k5_flash_attention(int dtype, int path, const void* q, const void* k,
                                  const void* v, void* o, void* work, long long BH, long long Sq,
                                  long long Skv, long long D, int causal, int window,
                                  long long q_offset, float scale, long long key_lo,
                                  long long split_len, int nsplit, void* stream, int* launches) {
  *launches = 0;
  if (BH <= 0 || Sq <= 0) return 0;
  dec::SplitParams sp;
  sp.p.Sq = Sq;
  sp.p.Skv = Skv;
  sp.p.causal = causal;
  sp.p.window = window;
  sp.p.q_offset = q_offset;
  sp.p.scale = scale;
  sp.key_lo = key_lo;
  sp.split_len = split_len;
  sp.nsplit = nsplit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_FLOAT32: return launch<float>(path, q, k, v, o, work, BH, D, sp, s, launches);
    case DT_BFLOAT16:
      return launch<__nv_bfloat16>(path, q, k, v, o, work, BH, D, sp, s, launches);
    case DT_FLOAT16: return launch<__half>(path, q, k, v, o, work, BH, D, sp, s, launches);
    default: return -1;
  }
}
