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
// Bound: memory. The function reads a and b and writes h once:
// 3 * N * T * D * itemsize bytes (plus h0) over the card's 3.35 TB/s. At
// Mamba2-130m's (8, 4096, 1536) in float32 that is 603,979,776 bytes, 180.3 us.
//
// Two paths, which kernels/ssd_scan.py::plan_launch picks per call:
//
// * chunked (k4_chunked_kernel), for T of at least two chunks. One thread
//   walking one (n, d) column through all of T gives only N * D threads
//   (12,288 at Mamba2-130m width): far too few bytes in flight for HBM.
//   Cutting time into chunks of CHUNK = STEPS * TW steps raises the
//   parallelism to N * D * T / CHUNK, and a decoupled look-back across blocks
//   keeps it to one pass: a and b are read once, h is written once.
//   - A block owns D_TILE = 32 * V * FW features of one n and one time
//     chunk, V = VEC_BYTES / itemsize values a load (4 floats or 8 bf16 /
//     fp16 in 16 bytes): 256 features in float32, 512 in half types, 64
//     steps, 256 threads. A thread holds its STEPS steps x V features of a
//     and b in registers, all loaded before any arithmetic. Staging them
//     through shared memory with cp.async instead took 255.1 us f32 and
//     152.5 bf16 against the registers' 240.7 and 138.4 at Mamba2-130m's
//     (8, 4096, 1536) (PR 17's chip runs).
//   - Phase 1: each warp folds its steps, in time order, into one
//     (decay product, state) pair a feature; the warps' pairs combine, in
//     time order, into the block's pair (A_c, B_c).
//   - Phase 2, the look-back: blocks take tile ids from an atomic ticket, so
//     a block waits only on blocks that already hold a lower ticket and are
//     running. The column (n, d-tile) varies fastest: a chunk's
//     predecessor started a few microseconds earlier and has mostly
//     published its inclusive state when it is read, and the blocks in
//     flight read whole rows of a and b; chunk-fastest tickets took 280.2 us
//     f32 and 162.4 bf16 at Mamba2-130m's shape (PR 17's chip runs). Each
//     (tile, feature warp) has a status word (not ready, aggregate,
//     inclusive); its values (A_c, B_c, then the inclusive state) are
//     stored before it, and it is stored with st.release.gpu and read with
//     ld.acquire.gpu. The last time warp publishes the aggregate while the
//     first (the look-back warp) reads the status of the 32 nearest
//     predecessors at once and folds in their aggregates, latest first, up
//     to the nearest inclusive state (chunk 0's carry-in is h0, or 0). A
//     wait past about 2 s (clock64) writes the tile into a status word and
//     traps: the kernel never hangs, and the caller's next synchronisation
//     raises. The other warps wait on a named barrier for the carry-in only.
//     The ticket and status words are zeroed by the wrapper for each call
//     (torch.zeros: one memset, counted in K4's device time) rather than
//     kept across calls under an epoch: each call, back to back or on
//     another stream, gets its own scratch from the caching allocator, so
//     no state outlives a call.
//   - Phase 3: each warp folds the block's carry-in through the earlier
//     warps' pairs, then re-walks its steps from registers with the per-step
//     arithmetic below and stores h as vectors.
//   A ragged last chunk is filled in registers with a = 1, b = 0 (no load, no
//   store). D % V != 0, or a pointer off 16-byte alignment, takes the one-value
//   instance.
// * column (k4_column_kernel, the first port's kernel), for T under two
//   chunks, where there is nothing to look back on: one thread a (n, d)
//   column walking T, the next COLUMN_UNROLL steps' loads issued first.
//
// Arithmetic: every step is __fmul_rn then __fadd_rn (no multiply-add
// contraction, also guarded by -fmad=false) in float32; bfloat16 / float16
// operands are widened on load and h is rounded once per output, the state
// itself stays float32. The chunked path combines pairs in another order
// than the column walk (only the carries differ), the same function up to
// float32 rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum DType { DT_FLOAT32 = 1, DT_BFLOAT16 = 2, DT_FLOAT16 = 3 };
enum PathCode { PATH_COLUMN = 0, PATH_CHUNKED = 1 };
enum TileState : unsigned { NOT_READY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

// the design (kernels/ssd_scan.py plans with these)
constexpr int STEPS = 16;      // time steps a warp holds
constexpr int TW = 4;          // warps along time
constexpr int FW = 2;          // warps along features: D_TILE = 32 * values a load * FW
constexpr int VEC_BYTES = 16;  // bytes a thread loads at once: 4 floats, 8 bf16 / fp16
constexpr int CHUNK = STEPS * TW;  // time steps a block
constexpr int THREADS = 32 * TW * FW;
constexpr int COLUMN_UNROLL = 8;
// scratch words before the tiles' status words: the ticket, the timeout
constexpr int HEAD_WORDS = 2;
static_assert(THREADS <= 1024, "too many threads a block");

template <typename T> struct Io;
template <> struct Io<float> {
  static __device__ __forceinline__ float in(float x) { return x; }
  static __device__ __forceinline__ float out(float x) { return x; }
  static __device__ __forceinline__ float bits_in(unsigned u) { return __uint_as_float(u); }
  static __device__ __forceinline__ unsigned bits_out(float x) { return __float_as_uint(x); }
};
template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 out(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float bits_in(unsigned u) { return __uint_as_float(u << 16); }
  static __device__ __forceinline__ unsigned bits_out(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
template <> struct Io<__half> {
  static __device__ __forceinline__ float in(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half out(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ float bits_in(unsigned u) {
    return __half2float(__ushort_as_half((unsigned short)u));
  }
  static __device__ __forceinline__ unsigned bits_out(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

// V consecutive values of type T as raw 32-bit words (16-bit types two to a
// word); loaded and stored as one vector of V * sizeof(T) bytes, streaming
// (a and b are read once, h written once: keep them out of the way of the
// look-back's scratch in L2)
template <typename T, int V>
struct Vec {
  static constexpr int BYTES = V * (int)sizeof(T);
  static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  unsigned w[WORDS];

  __device__ __forceinline__ float get(int k) const {
    if constexpr (sizeof(T) == 4) return Io<T>::bits_in(w[k]);
    else return Io<T>::bits_in((w[k >> 1] >> ((k & 1) * 16)) & 0xffffu);
  }
  // every value = x
  __device__ __forceinline__ void fill(float x) {
    const unsigned u = Io<T>::bits_out(x);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      if constexpr (sizeof(T) == 4) w[i] = u;
      else w[i] = u | (u << 16);
    }
  }
  __device__ __forceinline__ void set(const float (&x)[V]) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (sizeof(T) == 4) w[k] = Io<T>::bits_out(x[k]);
      else w[k >> 1] |= Io<T>::bits_out(x[k]) << ((k & 1) * 16);
    }
  }
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES == 16) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (BYTES == 8) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else if constexpr (BYTES == 4) {
      w[0] = __ldcs(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (BYTES == 16) {
      __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
    } else if constexpr (BYTES == 8) {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
    } else if constexpr (BYTES == 4) {
      __stcs(reinterpret_cast<unsigned*>(p), w[0]);
    } else {
      __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)w[0]);
    }
  }
};

// V floats of the look-back scratch, through L2 (ld.cg / st.cg: another SM
// wrote them, and L1 is not coherent)
template <int V>
__device__ __forceinline__ void load_floats(const float* p, float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + i));
      x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
    }
  } else if constexpr (V == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldcg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_floats(float* p, const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      __stcg(reinterpret_cast<float4*>(p + i), make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
  } else if constexpr (V == 2) {
    __stcg(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    __stcg(p, x[0]);
  }
}

// named barriers: the look-back warps arrive, the other warps wait
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// (A, B) <- (A, B) o (x, y): the map h -> A h + B applied after h -> x h + y
__device__ __forceinline__ void compose(float& A, float& B, float x, float y) {
  B = __fadd_rn(__fmul_rn(A, y), B);
  A = __fmul_rn(A, x);
}

// One block: features [dtile * D_TILE, +D_TILE) of one n over one time
// chunk, both taken from the ticket; grid = tiles = N * ceil(D / D_TILE) *
// chunks. ints: [0] the ticket, [1] the timeout status (tile + 1 of a block
// that gave up), [2 + tile * FW + feature warp] the state of that warp's
// features of the tile, all zero at launch. values: tile v's (A_c[D_TILE],
// B_c[D_TILE], inclusive state[D_TILE]). h0 may be null.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) k4_chunked_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ h0,
    T* __restrict__ h, long long T_, long long D, long long chunks, long long dtiles,
    long long tiles, unsigned* __restrict__ ints, float* __restrict__ values,
    long long timeout_cycles) {
  constexpr int DT = 32 * V * FW;
  __shared__ float s_wa[TW][DT], s_wb[TW][DT];  // each warp's pair a feature
  __shared__ float s_carry[DT];                 // the block's carry-in
  __shared__ long long s_tile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = warp / FW, fw = warp % FW;
  const int f = (fw * 32 + lane) * V;  // this thread's first feature in the tile
  unsigned* const status = ints + HEAD_WORDS;  // (tile, feature warp)
  if (threadIdx.x == 0) s_tile = (long long)atomicAdd(ints, 1u);
  __syncthreads();
  const long long tile = s_tile;
  // the tile of chunk c of column col, in ticket order: a chunk's
  // predecessors always hold lower tickets
  const long long cols = tiles / chunks;
  auto slot = [&](long long column, long long c) -> long long { return c * cols + column; };
  const long long chunk = tile / cols;
  const long long col = tile % cols;
  const long long n = col / dtiles;
  const long long d0 = col % dtiles * DT + f;
  const bool live = d0 < D;  // V > 1 only where D % V == 0: whole vectors
  const long long t0 = chunk * CHUNK + (long long)tw * STEPS;
  const long long base = (n * T_ + t0) * D + d0;
  const bool has_successor = chunk + 1 < chunks;

  // ---- loads: every step's a and b before any arithmetic ----
  Vec<T, V> ra[STEPS], rb[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (live && t0 + s < T_) {
      ra[s].load(a + base + s * D);
      rb[s].load(b + base + s * D);
    } else {
      ra[s].fill(1.0f);
      rb[s].fill(0.0f);
    }
  }

  // ---- phase 1: the warp's pair, then the block's ----
  {
    float A[V], B[V];
#pragma unroll
    for (int k = 0; k < V; ++k) { A[k] = 1.0f; B[k] = 0.0f; }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const Vec<T, V>& x = ra[s];
      const Vec<T, V>& y = rb[s];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float ak = x.get(k);
        B[k] = __fadd_rn(__fmul_rn(ak, B[k]), y.get(k));
        A[k] = __fmul_rn(ak, A[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) { s_wa[tw][f + k] = A[k]; s_wb[tw][f + k] = B[k]; }
  }
  __syncthreads();
  float* const mine = values + tile * (3 * DT) + f;
  // the block's pair (A_c, B_c): later warps apply after earlier ones
  auto block_pair = [&](float (&Ac)[V], float (&Bc)[V]) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      Ac[k] = 1.0f;
      Bc[k] = 0.0f;
      for (int v = TW - 1; v >= 0; --v) compose(Ac[k], Bc[k], s_wa[v][f + k], s_wb[v][f + k]);
    }
  };
  // the aggregate is published by the last time warp, so that the
  // look-back warp (tw == 0) starts reading at once
  if (tw == TW - 1 && chunk > 0 && has_successor) {
    float Ac[V], Bc[V];
    block_pair(Ac, Bc);
    store_floats<V>(mine, Ac);
    store_floats<V>(mine + DT, Bc);
    __syncwarp();
    if (lane == 0) store_release(status + tile * FW + fw, AGGREGATE);
  }

  // ---- phase 2: the carry-in, found by the look-back warp of each
  // feature warp alone; the other warps wait on barrier 1 for it ----
  if (tw == 0) {
    float Ac[V], Bc[V], carry[V];
    block_pair(Ac, Bc);
    if (chunk == 0) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        carry[k] = h0 != nullptr && live ? Io<T>::in(h0[n * D + d0 + k]) : 0.0f;
    } else {
      // (RA, RB): the map through every chunk from `pred` + 1 to chunk - 1
      float RA[V], RB[V];
#pragma unroll
      for (int k = 0; k < V; ++k) { RA[k] = 1.0f; RB[k] = 0.0f; }
      long long pred = chunk - 1;  // the latest chunk not yet folded in
      for (;;) {
        // lane j reads chunk pred - j; a chunk before 0 is h0: inclusive
        const long long c = pred - lane;
        const long long deadline = clock64() + timeout_cycles;
        int take;
        bool found;
        for (;;) {
          const unsigned st =
              c < 0 ? (unsigned)INCLUSIVE : load_acquire(status + slot(col, c) * FW + fw);
          const unsigned inc = __ballot_sync(0xffffffffu, st == INCLUSIVE);
          const unsigned idle = __ballot_sync(0xffffffffu, st == NOT_READY);
          const int m = inc ? __ffs(inc) - 1 : 32;   // the nearest inclusive state
          const int z = idle ? __ffs(idle) - 1 : 32;  // the nearest tile not ready
          if (m < z) { take = m; found = true; break; }
          if (z > 0) { take = z; found = false; break; }  // fold what is there, read on
          if (clock64() > deadline) {
            if (lane == 0) atomicExch(ints + 1, (unsigned)(tile + 1));
            __threadfence();
            __trap();
          }
          __nanosleep(32);
        }
        // the aggregates of chunks pred, pred - 1, ..., pred - take + 1,
        // latest first, two tiles' loads in flight at once
        if (live) {
          for (int j = 0; j < take; j += 2) {
            float xa[2][V], xb[2][V];
            const float* q = values + slot(col, pred - j) * (3 * DT) + f;
            load_floats<V>(q, xa[0]);
            load_floats<V>(q + DT, xb[0]);
            const bool two = j + 1 < take;
            if (two) {
              const float* r = values + slot(col, pred - j - 1) * (3 * DT) + f;
              load_floats<V>(r, xa[1]);
              load_floats<V>(r + DT, xb[1]);
            }
#pragma unroll
            for (int k = 0; k < V; ++k) compose(RA[k], RB[k], xa[0][k], xb[0][k]);
            if (two) {
#pragma unroll
              for (int k = 0; k < V; ++k) compose(RA[k], RB[k], xa[1][k], xb[1][k]);
            }
          }
        }
        if (found) {
          const long long cin = pred - take;
          float hin[V];
          if (cin >= 0) {
            load_floats<V>(values + slot(col, cin) * (3 * DT) + 2 * DT + f, hin);
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k)
              hin[k] = h0 != nullptr && live ? Io<T>::in(h0[n * D + d0 + k]) : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < V; ++k) carry[k] = __fadd_rn(__fmul_rn(RA[k], hin[k]), RB[k]);
          break;
        }
        pred -= take;
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) s_carry[f + k] = carry[k];
    bar_arrive(1, THREADS);  // the other warps may start phase 3
    // ---- publish the inclusive state ----
    if (has_successor) {
      float incl[V];
#pragma unroll
      for (int k = 0; k < V; ++k) incl[k] = __fadd_rn(__fmul_rn(Ac[k], carry[k]), Bc[k]);
      store_floats<V>(mine + 2 * DT, incl);
      __syncwarp();
      if (lane == 0) store_release(status + tile * FW + fw, INCLUSIVE);
    }
  } else {
    bar_sync(1, THREADS);
  }

  // ---- phase 3: the carry through the earlier warps, then the steps ----
  float hs[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    hs[k] = s_carry[f + k];
    for (int v = 0; v < tw; ++v)
      hs[k] = __fadd_rn(__fmul_rn(s_wa[v][f + k], hs[k]), s_wb[v][f + k]);
  }
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const Vec<T, V>& x = ra[s];
    const Vec<T, V>& y = rb[s];
#pragma unroll
    for (int k = 0; k < V; ++k) hs[k] = __fadd_rn(__fmul_rn(x.get(k), hs[k]), y.get(k));
    if (live && t0 + s < T_) {
      Vec<T, V> out;
      out.set(hs);
      out.store(h + base + s * D);
    }
  }
}

// one thread a (n, d) column: grid N * ceil(D / blockDim.x); h0 may be null
template <typename T>
__global__ void k4_column_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                 const T* __restrict__ h0, T* __restrict__ h, long long T_,
                                 long long D, long long blocks_per_n) {
  const long long n = blockIdx.x / blocks_per_n;
  const long long d = (blockIdx.x % blocks_per_n) * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const long long base = n * T_ * D + d;
  float state = h0 != nullptr ? Io<T>::in(h0[n * D + d]) : 0.0f;
  long long t = 0;
  for (; t + COLUMN_UNROLL <= T_; t += COLUMN_UNROLL) {
    float av[COLUMN_UNROLL], bv[COLUMN_UNROLL];
#pragma unroll
    for (int k = 0; k < COLUMN_UNROLL; ++k) {
      const long long off = base + (t + k) * D;
      av[k] = Io<T>::in(a[off]);
      bv[k] = Io<T>::in(b[off]);
    }
#pragma unroll
    for (int k = 0; k < COLUMN_UNROLL; ++k) {
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

struct Call {
  const void *a, *b, *h0;
  void* h;
  long long N, T, D, tiles;
  int d_tile, chunk;
  unsigned* ints;
  float* values;
  long long timeout_cycles;
  cudaStream_t stream;
  int* made;
};

template <typename T, int V>
int launch_chunked(const Call& c) {
  constexpr int DT = 32 * V * FW;
  if (c.d_tile != DT || c.chunk != CHUNK || (c.D % V) != 0) return -1;
  if (c.ints == nullptr || c.values == nullptr) return -1;
  const long long dtiles = (c.D + DT - 1) / DT;
  const long long chunks = (c.T + CHUNK - 1) / CHUNK;
  if (chunks < 2 || c.N * dtiles * chunks != c.tiles || c.tiles > 0x7fffffffLL) return -2;
  k4_chunked_kernel<T, V><<<(unsigned)c.tiles, THREADS, 0, c.stream>>>(
      static_cast<const T*>(c.a), static_cast<const T*>(c.b), static_cast<const T*>(c.h0),
      static_cast<T*>(c.h), c.T, c.D, chunks, dtiles, c.tiles, c.ints, c.values,
      c.timeout_cycles);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*c.made;
  return (int)err;
}

template <typename T>
int launch_column(const Call& c) {
  const int threads = c.d_tile;
  if (threads < 32 || threads > 1024 || threads % 32) return -2;
  const long long per_n = (c.D + threads - 1) / threads;
  if (c.N * per_n != c.tiles || c.tiles > 0x7fffffffLL) return -2;
  k4_column_kernel<T><<<(unsigned)c.tiles, threads, 0, c.stream>>>(
      static_cast<const T*>(c.a), static_cast<const T*>(c.b), static_cast<const T*>(c.h0),
      static_cast<T*>(c.h), c.T, c.D, per_n);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*c.made;
  return (int)err;
}

template <typename T>
int launch(int path, int vec, const Call& c) {
  if (path == PATH_COLUMN) return launch_column<T>(c);
  if (path != PATH_CHUNKED) return -1;
  constexpr int V = VEC_BYTES / (int)sizeof(T);
  if (vec == V) return launch_chunked<T, V>(c);
  if (vec == 1) return launch_chunked<T, 1>(c);
  return -1;
}

constexpr int MAX_DEVICES = 64;

// the SM clock in kHz of the current device, read once a device (2 GHz where
// the attribute is missing: the deadline stays finite either way)
int clock_khz() {
  static int cache[MAX_DEVICES];  // 0 = not read yet; racing readers write the same value
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 2000000;
  if (cache[dev] == 0) {
    int khz = 0;
    if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev) != cudaSuccess || khz <= 0)
      khz = 2000000;
    cache[dev] = khz;
  }
  return cache[dev];
}

}  // namespace

// h[n, t, d] for contiguous (N, T, D) a, b and h; h0 is (N, D) or null.
// path 1 (chunked) takes vec (VEC_BYTES / itemsize, or 1), d_tile and
// chunk as plan_launch gives them, and ints (2 + tiles * FW
// words, zero) and values (3 * d_tile * tiles floats) as scratch; path 0 (column) takes d_tile as its
// threads a block. tiles is the grid the plan counted. Returns 0 on a
// launched kernel, -1 for a dtype, path or plan that does not match the
// kernels, -2 for a grid they cannot launch, else the CUDA error of the launch;
// *launches is set to the kernels launched.
extern "C" int k4_ssd_scan(int dtype, int path, int vec, int d_tile, int chunk, const void* a,
                           const void* b, const void* h0, void* h, long long N, long long T_,
                           long long D, long long tiles, void* ints, void* values,
                           double timeout_s, void* stream, int* launches) {
  *launches = 0;
  if (N <= 0 || T_ <= 0 || D <= 0) return 0;
  Call c;
  c.a = a;
  c.b = b;
  c.h0 = h0;
  c.h = h;
  c.N = N;
  c.T = T_;
  c.D = D;
  c.tiles = tiles;
  c.d_tile = d_tile;
  c.chunk = chunk;
  c.ints = static_cast<unsigned*>(ints);
  c.values = static_cast<float*>(values);
  c.timeout_cycles = path == PATH_CHUNKED ? (long long)(timeout_s * 1e3 * (double)clock_khz()) : 0;
  c.stream = static_cast<cudaStream_t>(stream);
  c.made = launches;
  switch (dtype) {
    case DT_FLOAT32: return launch<float>(path, vec, c);
    case DT_BFLOAT16: return launch<__nv_bfloat16>(path, vec, c);
    case DT_FLOAT16: return launch<__half>(path, vec, c);
    default: return -1;
  }
}
