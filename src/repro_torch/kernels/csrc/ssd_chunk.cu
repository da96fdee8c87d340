// K6: the chunk output of the chunked SSD (arXiv:2405.21060), the
// y = y_intra + y_inter of models/mamba.py::_ssd_chunked for every
// (batch, chunk, head), in one launch a Mamba2 layer.
//
// Replaces no TPU kernel: the reference computes _ssd_chunked in jnp
// (repro/models/mamba.py), and the port's eager path computed it as the
// reference writes it: the decay exp(clamp(seg_i - seg_j, -60, 0)) and the
// weights W = scores * decay * causal as (B, c, Q, Q, H) float32 tensors
// (0.81 GB a layer at Mamba2-130m's (8, 4096) prefill, 4.29 GB at
// Granite-4.0-H-Small's (2, 16384)), about six elementwise passes over each,
// then two float32 SIMT GEMMs. This kernel computes the same function and
// keeps W in registers.
//
// For chunk rows i, keys j <= i, heads h and features p (Q rows a chunk,
// P = HEAD_DIM, N = STATE):
//   W[i, j]  = s[i, j] * exp(clamp(seg[h, i] - seg[h, j], -60, 0))
//   y_intra  = sum_j W[i, j] x[j, h, p]
//   y_inter  = (sum_n C[i, n] S[h, p, n]) * exp(seg[h, i])
//   y        = y_intra + y_inter, stored once in float32
// where s = C B^T are the chunk's scores as the caller's bf16 / fp16 einsum
// rounded them (one small GEMM, (B, c, Q, Q) in the model's type: the scores
// are the eager path's bit for bit, so this kernel differs from it by
// float32 rounding alone; a score of its own would round a few in 10^4 to
// the other bf16 neighbour, 2^-7 of itself), seg the within-chunk
// cumulative log decay in K3's (B, c, H, Q) layout, x the dt-scaled inputs
// and S the chunk's incoming state (float32, after the chunk loop). Each
// sub, clamp, exp and product that makes W, the scaling by exp(seg_i) and
// the final add are the eager path's float32 operations (__fsub_rn,
// __fmul_rn, __fadd_rn, expf); the sums over j and n run in float64 and
// round once.
//
// Bound: memory, for the bytes alone. x, the scores, C, S and the decays
// read once and y written once: at Granite's layer 2.19 GB, 0.65 ms at
// 3.35 TB/s; at Mamba2-130m's 0.42 GB, 0.126 ms. The work, 2 P FLOPs a (i, j <= i, h)
// pair and 2 P N a (i, h), is 1.4e11 FLOPs a Granite layer: 2.1 ms at the
// float64 tensor cores' (and the float32 FMAs') 67 TFLOP/s, over the bound.
//
// Design:
// * The products run on the tensor cores in float64 (mma.sync m16n8k4 f64):
//   a float32 W or S times a bf16 / fp16 x or C is exact in float64 and the
//   sums round at 2^-53, so each output rounds once to float32, as closely
//   as the eager float32 GEMMs or closer. Split-tf32 products on the tf32
//   tensor cores (W = hi + lo, two tf32 parts) ran this kernel in 3.24 ms at
//   Granite's layer but were 5.6x the eager path's error against float64
//   where the decay is fast (the model's regime): the tensor cores truncate
//   each aligned product to the largest one's precision, so a near-diagonal
//   sum loses up to an ulp a term. Operands go to float64 by conversion
//   instructions: widening them by integer operations instead took 2.39 ms
//   (Mamba2-130m's layer) and 11.84 ms (Granite's) against 0.845 and 4.05,
//   and the state's term on split-tf32 (its error hardly matters where the
//   decay is fast) 1.32 and 6.23 ms (chip runs of each design, H100).
// * A block owns 64 query rows (four warps of 16 rows x all 64 features) of
//   one (batch, chunk) and HEADS heads, walked one after the other. Its
//   scores (64 x up to 256) and C rows (64 x 128) go to shared memory once
//   (cp.async) and serve every head, since both configurations have one
//   group. A warp reads only the keys its rows see (j < its last row + 1):
//   tiles above the diagonal are skipped, and the diagonal's upper half is
//   zeroed in registers.
// * No operand of a head is staged: the k index of each block of four
//   m16n8k4 steps is permuted so that a thread's four keys (or state
//   entries) are adjacent, and the n index so that a thread's eight features
//   are, hence x and S reach the fragments as 16-byte __ldg loads (the four
//   warps of a block share them through L1) and y leaves as 16-byte stores.
// * Blocks run the query tiles of one (batch, chunk, head group) next to
//   each other, heaviest first, so that their x and S reads meet in L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum DType { DT_BFLOAT16 = 2, DT_FLOAT16 = 3 };

constexpr int ROWS = 64;             // query rows a block
constexpr int WARPS = 4;             // 16 rows each
constexpr int THREADS = 32 * WARPS;
constexpr int HEAD_DIM = 64;         // P
constexpr int STATE = 128;           // N
constexpr int MAX_CHUNK = 256;       // Q at most
constexpr int HEADS = 8;             // heads a block
constexpr int KB = 16;               // keys (or state entries) of four steps
constexpr int SC_LD = MAX_CHUNK + 8; // shared row strides in 16-bit elements,
constexpr int C_LD = STATE + 8;      // padded: a warp's 8-byte reads hit 32 banks
constexpr int SMEM_BYTES = ROWS * (SC_LD + C_LD) * 2;

// the float32 bits of the low / high element of a packed pair of 16-bit
// values (exact for both types)
template <typename T>
struct Wide;

template <>
struct Wide<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t lo(uint32_t w) { return w << 16; }
  static __device__ __forceinline__ uint32_t hi(uint32_t w) { return w & 0xffff0000u; }
};

template <>
struct Wide<__half> {
  static __device__ __forceinline__ uint32_t lo(uint32_t w) {
    return __float_as_uint(__half2float(__ushort_as_half((unsigned short)(w & 0xffffu))));
  }
  static __device__ __forceinline__ uint32_t hi(uint32_t w) {
    return __float_as_uint(__half2float(__ushort_as_half((unsigned short)(w >> 16))));
  }
};

// element e (0-7) of eight packed 16-bit values
template <typename T>
__device__ __forceinline__ uint32_t element(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return (e & 1) ? Wide<T>::hi(w) : Wide<T>::lo(w);
}

// d += a b over one m16n8k4 tile in float64
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// W[i, j] from its score's bits and the two decays; 0 above the diagonal
__device__ __forceinline__ float weight(uint32_t s, float seg_i, float seg_j, bool seen) {
  const float d = fminf(fmaxf(__fsub_rn(seg_i, seg_j), -60.0f), 0.0f);
  const float w = __fmul_rn(__uint_as_float(s), expf(d));
  return seen ? w : 0.0f;
}

// Fragments (m16n8k4 f64, lane = 4 g + t): A rows g and g + 8, k slot t; B
// k slot t, column g; D rows g and g + 8, columns 2t and 2t + 1. Step s
// (0-3) of a 16-key block maps k slot t to key kb + 4t + s; n-tile nt maps
// column c to feature 8c + nt.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    k6_ssd_chunk_kernel(const T* __restrict__ scores, const float* __restrict__ seg,
                        const T* __restrict__ x, const T* __restrict__ cmat, long long ldc,
                        const float* __restrict__ state, float* __restrict__ y, int Q, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sc = reinterpret_cast<uint16_t*>(smem);  // [ROWS][SC_LD] scores
  uint16_t* cs = sc + ROWS * SC_LD;                   // [ROWS][C_LD] C rows
  using W16 = Wide<T>;

  const int tiles = Q / ROWS;
  const int groups = (H + HEADS - 1) / HEADS;
  long long blk = blockIdx.x;
  const int qt = tiles - 1 - (int)(blk % tiles);
  blk /= tiles;
  const int hg = (int)(blk % groups);
  const long long bc = blk / groups;
  const int i0 = qt * ROWS;
  const int keys = i0 + ROWS;

  const T* srow = scores + ((size_t)bc * Q + i0) * Q;
  const int sv = keys / 8;
  for (int v = threadIdx.x; v < ROWS * sv; v += THREADS) {
    const int r = v / sv, k = v - r * sv;
    cp16(sc + r * SC_LD + 8 * k, srow + (size_t)r * Q + 8 * k);
  }
  const T* crow = cmat + ((size_t)bc * Q + i0) * ldc;
  for (int v = threadIdx.x; v < ROWS * (STATE / 8); v += THREADS) {
    const int r = v / (STATE / 8), k = v - r * (STATE / 8);
    cp16(cs + r * C_LD + 8 * k, crow + (size_t)r * ldc + 8 * k);
  }
  cp_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int ra = i0 + r0 + g, rb = ra + 8;  // this thread's rows in the chunk
  const int kend = i0 + r0 + 16;           // keys the warp's rows see
  const uint16_t* sa = sc + (r0 + g) * SC_LD + 4 * t;
  const uint16_t* sb = sa + 8 * SC_LD;
  const uint16_t* ca = cs + (r0 + g) * C_LD + 4 * t;
  const uint16_t* cb = ca + 8 * C_LD;
  const size_t xrow = (size_t)H * HEAD_DIM;

  const int h_end = min(H, (hg + 1) * HEADS);
  for (int h = hg * HEADS; h < h_end; ++h) {
    const float* segh = seg + ((size_t)bc * H + h) * Q;
    const float seg_a = __ldg(segh + ra), seg_b = __ldg(segh + rb);
    double acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0;

    // y_inter: C (rows x N) times S^T (N x P)
    const float* sh = state + (((size_t)bc * H + h) * HEAD_DIM + 8 * g) * STATE + 4 * t;
#pragma unroll 2
    for (int nb = 0; nb < STATE; nb += KB) {
      const uint2 pa = *reinterpret_cast<const uint2*>(ca + nb);
      const uint2 pb = *reinterpret_cast<const uint2*>(cb + nb);
      const double c_a[4] = {__uint_as_float(W16::lo(pa.x)), __uint_as_float(W16::hi(pa.x)),
                             __uint_as_float(W16::lo(pa.y)), __uint_as_float(W16::hi(pa.y))};
      const double c_b[4] = {__uint_as_float(W16::lo(pb.x)), __uint_as_float(W16::hi(pb.x)),
                             __uint_as_float(W16::lo(pb.y)), __uint_as_float(W16::hi(pb.y))};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(sh + nt * STATE + nb));
        dmma(acc[nt], c_a[0], c_b[0], s.x);
        dmma(acc[nt], c_a[1], c_b[1], s.y);
        dmma(acc[nt], c_a[2], c_b[2], s.z);
        dmma(acc[nt], c_a[3], c_b[3], s.w);
      }
    }
    const float ea = expf(seg_a), eb = expf(seg_b);
    float inter[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        inter[nt][e] = __fmul_rn(__double2float_rn(acc[nt][e]), e < 2 ? ea : eb);
        acc[nt][e] = 0.0;
      }
    }

    // y_intra: W (rows x keys) times x (keys x P)
    const T* xh = x + ((size_t)bc * Q * H + h) * HEAD_DIM + 8 * g;
    for (int kb = 0; kb < kend; kb += KB) {
      const int j = kb + 4 * t;  // this thread's keys j .. j + 3
      const uint4 x0 = __ldg(reinterpret_cast<const uint4*>(xh + (size_t)j * xrow));
      const uint4 x1 = __ldg(reinterpret_cast<const uint4*>(xh + (size_t)(j + 1) * xrow));
      const uint4 x2 = __ldg(reinterpret_cast<const uint4*>(xh + (size_t)(j + 2) * xrow));
      const uint4 x3 = __ldg(reinterpret_cast<const uint4*>(xh + (size_t)(j + 3) * xrow));
      const float4 sj = __ldg(reinterpret_cast<const float4*>(segh + j));
      const uint2 qa = *reinterpret_cast<const uint2*>(sa + kb);
      const uint2 qb = *reinterpret_cast<const uint2*>(sb + kb);
      const double w_a[4] = {weight(W16::lo(qa.x), seg_a, sj.x, j <= ra),
                             weight(W16::hi(qa.x), seg_a, sj.y, j + 1 <= ra),
                             weight(W16::lo(qa.y), seg_a, sj.z, j + 2 <= ra),
                             weight(W16::hi(qa.y), seg_a, sj.w, j + 3 <= ra)};
      const double w_b[4] = {weight(W16::lo(qb.x), seg_b, sj.x, j <= rb),
                             weight(W16::hi(qb.x), seg_b, sj.y, j + 1 <= rb),
                             weight(W16::lo(qb.y), seg_b, sj.z, j + 2 <= rb),
                             weight(W16::hi(qb.y), seg_b, sj.w, j + 3 <= rb)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        dmma(acc[nt], w_a[0], w_b[0], __uint_as_float(element<T>(x0, nt)));
        dmma(acc[nt], w_a[1], w_b[1], __uint_as_float(element<T>(x1, nt)));
        dmma(acc[nt], w_a[2], w_b[2], __uint_as_float(element<T>(x2, nt)));
        dmma(acc[nt], w_a[3], w_b[3], __uint_as_float(element<T>(x3, nt)));
      }
    }

    // y = y_intra + y_inter: D column 2t of n-tile nt is feature 16t + nt,
    // column 2t + 1 feature 16t + 8 + nt
    float va[16], vb[16];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      va[nt] = __fadd_rn(__double2float_rn(acc[nt][0]), inter[nt][0]);
      va[8 + nt] = __fadd_rn(__double2float_rn(acc[nt][1]), inter[nt][1]);
      vb[nt] = __fadd_rn(__double2float_rn(acc[nt][2]), inter[nt][2]);
      vb[8 + nt] = __fadd_rn(__double2float_rn(acc[nt][3]), inter[nt][3]);
    }
    float* ya = y + (((size_t)bc * Q + ra) * H + h) * HEAD_DIM + 16 * t;
    float* yb = ya + 8 * xrow;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      reinterpret_cast<float4*>(ya)[q] =
          make_float4(va[4 * q], va[4 * q + 1], va[4 * q + 2], va[4 * q + 3]);
      reinterpret_cast<float4*>(yb)[q] =
          make_float4(vb[4 * q], vb[4 * q + 1], vb[4 * q + 2], vb[4 * q + 3]);
    }
  }
}

template <typename T>
int launch(const void* scores, const void* seg, const void* x, const void* c, long long ldc,
           const void* state, void* y, long long nbc, int Q, int H, cudaStream_t s, int* made) {
  const long long blocks = nbc * (Q / ROWS) * ((H + HEADS - 1) / HEADS);
  if (blocks > 0x7fffffffLL) return -2;
  cudaError_t err = cudaFuncSetAttribute(k6_ssd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  k6_ssd_chunk_kernel<T><<<(unsigned)blocks, THREADS, SMEM_BYTES, s>>>(
      static_cast<const T*>(scores), static_cast<const float*>(seg), static_cast<const T*>(x),
      static_cast<const T*>(c), ldc, static_cast<const float*>(state), static_cast<float*>(y), Q,
      H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *made += 1;
  return 0;
}

}  // namespace

// One call: scores (B c, Q, Q) and x (B c, Q, H, P) in the model's type, C
// rows (B c Q, N) of that type with row stride ldc (elements), seg (B c, H, Q)
// and S (B c, H, P, N) float32 in, y (B c, Q, H, P) float32 out; every
// pointer on 16 bytes. Returns 0 or an error code; *launches counts the
// kernels launched.
extern "C" int k6_ssd_chunk(int dtype, const void* scores, const void* seg, const void* x,
                            const void* c, long long ldc, const void* state, void* y,
                            long long nbc, int Q, int H, void* stream, int* launches) {
  *launches = 0;
  if (nbc <= 0 || H <= 0) return 0;
  if (Q <= 0 || Q % ROWS != 0 || Q > MAX_CHUNK || ldc < STATE || ldc % 8 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_BFLOAT16:
      return launch<__nv_bfloat16>(scores, seg, x, c, ldc, state, y, nbc, Q, H, s, launches);
    case DT_FLOAT16:
      return launch<__half>(scores, seg, x, c, ldc, state, y, nbc, Q, H, s, launches);
    default:
      return -1;
  }
}
