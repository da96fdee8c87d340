// K3: the on-chip block scan — an inclusive or exclusive add / max / mul
// prefix scan along the last axis of a (R, L) array.
//
// Replaces repro/kernels/prefix_scan.py::_scan_kernel (built by
// prefix_scan_pallas). The TPU kernel is a (block_rows, block_len) grid whose
// column tiles run in order on one core, the running prefix of each row kept
// in VMEM scratch from one grid step to the next; ops.py pads and does the
// exclusive shift. Hopper's blocks run in no order on 132 SMs, so here the
// walk over a row is a loop inside a warp or a block, or, for few long rows,
// a decoupled look-back across blocks.
//
// Bound: memory. The function reads R*L*itemsize bytes and writes as many;
// its least time is 2*R*L*itemsize over the card's 3.35 TB/s (160.3 us at
// (8192, 8192) f32). The combine is one operation an element. What keeps a
// scan from that bound is the bytes in flight: enough loads issued at once
// on every SM, each a whole 16-byte vector a lane, and no SM idle. Three
// paths, which kernels/prefix_scan.py::plan_launch picks for each call:
//
// * rows (k3_scan_kernel_rows), short rows (L * itemsize up to 8 KiB): one
//   warp scans one row, ROWS_PER_BLOCK rows a block. A segment is one vector
//   a lane; all of a batch's ROW_SEGS segments are loaded before any combine
//   (a row of up to ROW_SEGS segments in one round trip), and the next
//   batch's loads are issued before this one is scanned. Each lane scans its
//   vector serially in registers, the lane totals are scanned with shuffles,
//   and the carry across segments stays in a register: no shared memory and
//   no __syncthreads. Mamba2-130m's segment
//   scan (3072, 256) f32 is 384 blocks in one wave; its training step's
//   (768, 256), forward and reverse, is bound by the launch.
// * tiles (k3_scan_kernel_tiles), long rows and many of them (R of at least
//   two blocks an SM): one block of TILE_THREADS a row, walking tiles of
//   TILE_VECS vectors a thread. The next tile's vectors are loaded into a
//   second set of registers before the current tile is scanned, so a block
//   always has a tile of loads in flight. One barrier a tile: the warp
//   totals are double-buffered in shared memory, and every warp scans all of
//   them itself.
// * lookback (k3_scan_kernel_lookback), few long rows (the I/O offsets of
//   one large array): each row is cut into chunks of CHUNK_VECS vectors a
//   thread of a CHUNK_THREADS block, one block a chunk, so every SM works
//   on one row. A block takes
//   its chunk from an atomic ticket (never blockIdx), so the chunks it waits
//   on are already resident; it publishes its chunk's aggregate, then warp 0
//   reads the status of the 32 nearest predecessors at once and folds their
//   aggregates, in chunk order, back to the nearest inclusive prefix. A
//   status is one 64-bit word: the state (not ready, aggregate, inclusive)
//   in its high half and the 32-bit value in its low half, written and read
//   whole, so no fence orders a value against its flag. The host entry
//   zeroes the ticket and the status words with one cudaMemsetAsync a call
//   (not a kernel launch; counted in the call's device time). A wait past
//   about 2 s writes the chunk into the scratch and traps: the kernel never
//   hangs, and the caller's next synchronisation raises.
//
// On every path the loads and stores are 16-byte vectors (4 f32 or int32, 8
// bf16 or fp16, 16 int8) where the row's start and L * itemsize are 16-byte
// aligned, else one element a lane (the same code with V = 1; the plan
// picks). The ragged edge is masked in the kernel: nothing is padded.
//
// Exclusive: the output at i is the prefix of everything before i, which a
// lane already holds for each of its elements (before its vector: the carry,
// the earlier warps and lanes), so the shift costs nothing and the stores stay
// aligned vector stores; the row's element 0 takes `fill` (0, 1, or the
// type's lowest finite value for max: the plain version's scan_identity,
// each exact in the carry type).
//
// REVERSE (a template flag, add only: the backward of an add scan is the add
// scan of the gradient run back to front): logical element i of a row is
// element L-1-i. A lane loads the vector that holds its logical elements from
// the row's end and reverses it in registers; no flipped copy is made.
//
// Arithmetic: float32, bfloat16 and float16 carry in float32 and round once
// per output (not at every combine as the TPU's associative_scan does).
// Integer sums and products wrap (int8 is carried in 32-bit and truncated on
// the store, which is the same value modulo 2^8). max propagates NaN (fmaxf
// would drop it) and is exact.
//
// Why the first design (one block a row, four consecutive scalars a thread,
// three barriers a tile) ran its forward at 57-60% of the bound at
// (8192, 8192) f32 and its back-to-front instantiation at 80%: cuobjdump
// lists the same memory instructions in both (four scalar LDG.E.CONSTANT,
// five STG.E), so the gap was not in the code but in how its scalar,
// 16-byte-strided warp accesses met the memory system in each direction. With whole 16-byte vectors the
// two directions run within 0.3% of each other on an H100; with one
// coalesced element a lane a gap comes back, the other way round.
//
// What lost on an H100 (PR 24's chip runs, float32 add, forward): two or four
// rows a warp took 1.80 and 2.55 us at (768, 256) against a warp a row's
// 1.48; without the prefetch (8192, 8192) ran 0.9% slower and nothing else
// moved.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum OpCode { OP_ADD = 0, OP_MAX = 1, OP_MUL = 2 };
enum DType { DT_INT32 = 0, DT_FLOAT32 = 1, DT_BFLOAT16 = 2, DT_FLOAT16 = 3, DT_INT8 = 4 };
enum PathCode { PATH_ROWS = 0, PATH_TILES = 1, PATH_LOOKBACK = 2 };
enum ChunkState : unsigned { NOT_READY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

// the design (kernels/prefix_scan.py plans with these)
constexpr int VEC_BYTES = 16;       // bytes a lane loads at once on the vector variant
constexpr int ROW_THREADS = 256;    // threads a block of the rows path
constexpr int ROWS_PER_BLOCK = ROW_THREADS / 32;  // a warp a row
constexpr int ROW_SEGS = 2;         // segments (one vector a lane) a row loads at once
constexpr int TILE_THREADS = 256;   // threads a block of the tiles path
constexpr int TILE_VECS = 2;        // vectors a thread holds a tile
constexpr int CHUNK_THREADS = 128;  // threads a block of the lookback path
constexpr int CHUNK_VECS = 8;       // vectors a thread holds a chunk
// look-back scratch words before the chunks' status words: the ticket, the
// timeout (chunk + 1 of a block that gave up)
constexpr int HEAD_WORDS = 2;
constexpr unsigned FULL = 0xffffffffu;

// the warp totals of a tile or chunk are scanned by one warp
static_assert(TILE_VECS * TILE_THREADS <= 1024 && CHUNK_VECS * CHUNK_THREADS <= 1024,
              "a tile's warp totals must fit one warp");

// storage type T <-> carry type A (float for floating types, int32 for
// ints), element by element from and to its raw bits
template <typename T> struct Io;
template <> struct Io<float> {
  typedef float A;
  static __device__ __forceinline__ A in(unsigned u) { return __uint_as_float(u); }
  static __device__ __forceinline__ unsigned out(A x) { return __float_as_uint(x); }
};
template <> struct Io<__nv_bfloat16> {
  typedef float A;
  static __device__ __forceinline__ A in(unsigned u) { return __uint_as_float(u << 16); }
  static __device__ __forceinline__ unsigned out(A x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
template <> struct Io<__half> {
  typedef float A;
  static __device__ __forceinline__ A in(unsigned u) {
    return __half2float(__ushort_as_half((unsigned short)u));
  }
  static __device__ __forceinline__ unsigned out(A x) { return __half_as_ushort(__float2half_rn(x)); }
};
template <> struct Io<int32_t> {
  typedef int32_t A;
  static __device__ __forceinline__ A in(unsigned u) { return (int32_t)u; }
  static __device__ __forceinline__ unsigned out(A x) { return (unsigned)x; }
};
template <> struct Io<int8_t> {
  typedef int32_t A;
  static __device__ __forceinline__ A in(unsigned u) { return (int32_t)(int8_t)(uint8_t)u; }
  static __device__ __forceinline__ unsigned out(A x) { return (unsigned)x & 0xffu; }
};

// a carry as the low half of a status word, and back
__device__ __forceinline__ unsigned carry_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned carry_bits(int32_t x) { return (unsigned)x; }
template <typename A> __device__ __forceinline__ A carry_from(unsigned u);
template <> __device__ __forceinline__ float carry_from<float>(unsigned u) { return __uint_as_float(u); }
template <> __device__ __forceinline__ int32_t carry_from<int32_t>(unsigned u) { return (int32_t)u; }

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

// V consecutive elements of type T as raw 32-bit words (16-bit types two to
// a word, int8 four), loaded and stored as one vector of V * sizeof(T)
// bytes; STREAM marks data read or written once (ld.cs / st.cs)
template <typename T, int V>
struct Raw {
  static constexpr int SIZE = (int)sizeof(T);
  static constexpr int BYTES = V * SIZE;
  static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  static constexpr int PER_WORD = 4 / SIZE;
  unsigned w[WORDS];

  __device__ __forceinline__ unsigned bits(int k) const {
    if constexpr (SIZE == 4 || BYTES < 4) return w[SIZE == 4 ? k : 0];
    else return (w[k / PER_WORD] >> (8 * SIZE * (k % PER_WORD))) & ((1u << (8 * SIZE)) - 1u);
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = 0;
  }
  // after clear()
  __device__ __forceinline__ void put(int k, unsigned b) {
    if constexpr (SIZE == 4 || BYTES < 4) w[SIZE == 4 ? k : 0] = b;
    else w[k / PER_WORD] |= b << (8 * SIZE * (k % PER_WORD));
  }
  template <bool STREAM>
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES == 16) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      const uint4 v = STREAM ? __ldcs(q) : __ldg(q);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (BYTES == 8) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
      const uint2 v = STREAM ? __ldcs(q) : __ldg(q);
      w[0] = v.x; w[1] = v.y;
    } else if constexpr (BYTES == 4) {
      const unsigned* q = reinterpret_cast<const unsigned*>(p);
      w[0] = STREAM ? __ldcs(q) : __ldg(q);
    } else if constexpr (BYTES == 2) {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      w[0] = STREAM ? __ldcs(q) : __ldg(q);
    } else {
      const unsigned char* q = reinterpret_cast<const unsigned char*>(p);
      w[0] = STREAM ? __ldcs(q) : __ldg(q);
    }
  }
  template <bool STREAM>
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (BYTES == 16) {
      uint4* q = reinterpret_cast<uint4*>(p);
      const uint4 v = make_uint4(w[0], w[1], w[2], w[3]);
      if (STREAM) __stcs(q, v); else *q = v;
    } else if constexpr (BYTES == 8) {
      uint2* q = reinterpret_cast<uint2*>(p);
      const uint2 v = make_uint2(w[0], w[1]);
      if (STREAM) __stcs(q, v); else *q = v;
    } else if constexpr (BYTES == 4) {
      unsigned* q = reinterpret_cast<unsigned*>(p);
      if (STREAM) __stcs(q, w[0]); else *q = w[0];
    } else if constexpr (BYTES == 2) {
      unsigned short* q = reinterpret_cast<unsigned short*>(p);
      if (STREAM) __stcs(q, (unsigned short)w[0]); else *q = (unsigned short)w[0];
    } else {
      unsigned char* q = reinterpret_cast<unsigned char*>(p);
      if (STREAM) __stcs(q, (unsigned char)w[0]); else *q = (unsigned char)w[0];
    }
  }
};

// The vector of a row that holds logical elements [i, i + V): at i, or, back
// to front, at L - i - V (its elements in reverse order)
template <bool REVERSE, int V>
__device__ __forceinline__ long long phys(long long L, long long i) {
  return REVERSE ? L - i - V : i;
}

// One vector's part of a scan. v: its logical elements, widened to the carry
// type (the identity where the vector lies past the row's end), scanned in
// place; v[V-1] is then the vector's total.
template <typename T, int OP, bool REVERSE, int V>
struct VecScan {
  typedef typename Io<T>::A A;
  typedef Op<A, OP> O;
  A v[V];

  __device__ __forceinline__ void unpack(const Raw<T, V>& r, bool live) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      v[k] = live ? Io<T>::in(r.bits(REVERSE ? V - 1 - k : k)) : O::identity();
#pragma unroll
    for (int k = 1; k < V; ++k) v[k] = O::combine(v[k - 1], v[k]);
  }
  // the outputs, given the prefix of everything before the vector; `first`:
  // the vector starts the row (an exclusive scan puts `fill` there)
  __device__ __forceinline__ Raw<T, V> pack(A before, bool exclusive, bool first, A fill) const {
    Raw<T, V> r;
    r.clear();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      A o;
      if (exclusive) o = k == 0 ? (first ? fill : before) : O::combine(before, v[k - 1]);
      else o = O::combine(before, v[k]);
      r.put(REVERSE ? V - 1 - k : k, Io<T>::out(o));
    }
    return r;
  }
};

// inclusive scan of x over the warp
template <typename A, int OP>
__device__ __forceinline__ A warp_scan(A x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const A y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x = Op<A, OP>::combine(y, x);
  }
  return x;
}

// ---------------------------------------------------------------------------
// rows: a warp a row, ROWS_PER_BLOCK rows a block
// ---------------------------------------------------------------------------
template <typename T, int OP, bool REVERSE, int V>
__global__ void __launch_bounds__(ROW_THREADS) k3_scan_kernel_rows(
    const T* __restrict__ x, T* __restrict__ y, long long R, long long L, int exclusive,
    double fill) {
  typedef typename Io<T>::A A;
  typedef Op<A, OP> O;
  typedef VecScan<T, OP, REVERSE, V> S;
  constexpr int SEG = 32 * V;            // elements a segment
  constexpr int BATCH = SEG * ROW_SEGS;  // elements a batch of loads
  const int g = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const bool live_row = row < R;  // a warp past the last row still shuffles
  const T* xr = x + (live_row ? row : 0) * L;
  T* yr = y + (live_row ? row : 0) * L;
  const A fillv = (A)fill;

  Raw<T, V> cur[ROW_SEGS], nxt[ROW_SEGS];
  auto load_batch = [&](Raw<T, V>(&buf)[ROW_SEGS], long long base) {
#pragma unroll
    for (int s = 0; s < ROW_SEGS; ++s) {
      const long long i = base + s * SEG + g * V;
      if (live_row && i < L) buf[s].template load<false>(xr + phys<REVERSE, V>(L, i));
      else buf[s].clear();
    }
  };

  A carry = O::identity();
  load_batch(cur, 0);
  for (long long base = 0; base < L; base += BATCH) {
    const bool more = base + BATCH < L;
    if (more) load_batch(nxt, base + BATCH);
#pragma unroll
    for (int s = 0; s < ROW_SEGS; ++s) {
      if (base + s * SEG < L) {  // the same for every lane of the warp
        const long long i = base + s * SEG + g * V;
        const bool live = i < L;
        S sc;
        sc.unpack(cur[s], live);
        const A incl = warp_scan<A, OP>(sc.v[V - 1], g);
        A before = __shfl_up_sync(FULL, incl, 1);
        before = g == 0 ? carry : O::combine(carry, before);
        if (live_row && live)
          sc.pack(before, exclusive, i == 0, fillv).template store<false>(yr + phys<REVERSE, V>(L, i));
        carry = O::combine(carry, __shfl_sync(FULL, incl, 31));
      }
    }
    if (more) {
#pragma unroll
      for (int s = 0; s < ROW_SEGS; ++s) cur[s] = nxt[s];
    }
  }
}

// ---------------------------------------------------------------------------
// the block-wide part of a tile (tiles and lookback paths): U vectors a
// thread, vector u of thread t at element (u * THREADS + t) * V of the tile,
// so that each load instruction of a warp reads 512 contiguous bytes
// ---------------------------------------------------------------------------
template <typename T, int OP, bool REVERSE, int V, int U, int THREADS>
struct TileScan {
  typedef typename Io<T>::A A;
  typedef Op<A, OP> O;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int SUB = THREADS * V;  // elements of one vector a thread
  static constexpr int TILE = SUB * U;
  static constexpr int N = U * WARPS;  // warp totals of a tile

  VecScan<T, OP, REVERSE, V> sc[U];
  A lane_before[U];  // what the earlier lanes of the warp add, per vector
  A warp_before[U];  // what the earlier vectors and warps of the tile add
  A total;           // the tile's aggregate

  // scan the tile's vectors up to the warp, leave the warp totals in tot
  __device__ __forceinline__ void warps(const Raw<T, V> (&raw)[U], long long base, long long L,
                                        A* tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sc[u].unpack(raw[u], base + u * SUB + (long long)threadIdx.x * V < L);
      const A incl = warp_scan<A, OP>(sc[u].v[V - 1], lane);
      const A up = __shfl_up_sync(FULL, incl, 1);
      lane_before[u] = lane == 0 ? O::identity() : up;
      if (lane == 31) tot[u * WARPS + warp] = incl;
    }
  }
  // after a barrier: every warp scans the N warp totals in tile order
  __device__ __forceinline__ void block(const A* tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    A t = lane < N ? tot[lane] : O::identity();
    t = warp_scan<A, OP>(t, lane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = u * WARPS + warp;
      const A b = __shfl_sync(FULL, t, idx == 0 ? 0 : idx - 1);
      warp_before[u] = idx == 0 ? O::identity() : b;
    }
    total = __shfl_sync(FULL, t, N - 1);
  }
  template <bool STREAM>
  __device__ __forceinline__ void store(T* yr, long long base, long long L, A carry,
                                        bool exclusive, A fill) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * SUB + (long long)threadIdx.x * V;
      if (i < L) {
        const A before = O::combine(O::combine(carry, warp_before[u]), lane_before[u]);
        sc[u].pack(before, exclusive, i == 0, fill).template store<STREAM>(
            yr + phys<REVERSE, V>(L, i));
      }
    }
  }
};

template <typename T, int V, int U, int THREADS>
__device__ __forceinline__ void load_tile(Raw<T, V> (&raw)[U], const T* xr, long long base,
                                          long long L, bool reverse) {
  constexpr int SUB = THREADS * V;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + u * SUB + (long long)threadIdx.x * V;
    if (i < L) raw[u].template load<true>(xr + (reverse ? L - i - V : i));
    else raw[u].clear();
  }
}

// ---------------------------------------------------------------------------
// tiles: one block a row, TILE_VECS vectors a thread a tile
// ---------------------------------------------------------------------------
template <typename T, int OP, bool REVERSE, int V>
__global__ void __launch_bounds__(TILE_THREADS) k3_scan_kernel_tiles(
    const T* __restrict__ x, T* __restrict__ y, long long L, int exclusive, double fill) {
  constexpr int U = TILE_VECS;
  typedef TileScan<T, OP, REVERSE, V, U, TILE_THREADS> TS;
  typedef typename TS::A A;
  typedef typename TS::O O;
  __shared__ A s_tot[2][TS::N];  // double-buffered: one barrier a tile
  const long long row = blockIdx.x;
  const T* xr = x + row * L;
  T* yr = y + row * L;
  const A fillv = (A)fill;

  Raw<T, V> cur[U], nxt[U];
  load_tile<T, V, U, TILE_THREADS>(cur, xr, 0, L, REVERSE);
  A carry = O::identity();
  int buf = 0;
  for (long long base = 0; base < L; base += TS::TILE, buf ^= 1) {
    const bool more = base + TS::TILE < L;
    if (more) load_tile<T, V, U, TILE_THREADS>(nxt, xr, base + TS::TILE, L, REVERSE);
    TS ts;
    ts.warps(cur, base, L, s_tot[buf]);
    __syncthreads();
    ts.block(s_tot[buf]);
    ts.template store<true>(yr, base, L, carry, exclusive, fillv);
    carry = O::combine(carry, ts.total);
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }
}

// ---------------------------------------------------------------------------
// lookback: one block a chunk of CHUNK_VECS vectors a thread
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned state,
                                             unsigned value) {
  const unsigned long long word = ((unsigned long long)state << 32) | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word) : "memory");
}
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(word) : "l"(p) : "memory");
  return word;
}

// ws: [0] the ticket, [1] the timeout (chunk + 1 of a block that gave up),
// [HEAD_WORDS + row * chunks + c] the status of chunk c of a row; all zero
// at launch. The grid is R * chunks blocks.
template <typename T, int OP, bool REVERSE, int V>
__global__ void __launch_bounds__(CHUNK_THREADS) k3_scan_kernel_lookback(
    const T* __restrict__ x, T* __restrict__ y, long long L, long long chunks, int exclusive,
    double fill, unsigned long long* __restrict__ ws, long long timeout_cycles) {
  constexpr int U = CHUNK_VECS;
  typedef TileScan<T, OP, REVERSE, V, U, CHUNK_THREADS> TS;
  typedef typename TS::A A;
  typedef typename TS::O O;
  __shared__ A s_tot[TS::N];
  __shared__ A s_carry;
  __shared__ long long s_id;
  if (threadIdx.x == 0) s_id = (long long)atomicAdd(ws, 1ull);
  __syncthreads();
  const long long id = s_id;
  const long long row = id / chunks, c = id % chunks;
  const long long base = c * TS::TILE;
  const T* xr = x + row * L;
  T* yr = y + row * L;
  unsigned long long* const status = ws + HEAD_WORDS + row * chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  Raw<T, V> raw[U];
  load_tile<T, V, U, CHUNK_THREADS>(raw, xr, base, L, REVERSE);
  TS ts;
  ts.warps(raw, base, L, s_tot);
  __syncthreads();
  ts.block(s_tot);
  if (warp == 0) {
    const bool successor = c + 1 < chunks;
    A carry = O::identity();
    if (c == 0) {
      if (successor && lane == 0) store_status(status, INCLUSIVE, carry_bits(ts.total));
    } else {
      if (successor && lane == 0) store_status(status + c, AGGREGATE, carry_bits(ts.total));
      // carry: the chunks pred + 1 .. c - 1 folded in chunk order
      long long pred = c - 1;
      for (;;) {
        const long long q = pred - lane;  // before the row's start: the identity
        const long long deadline = clock64() + timeout_cycles;
        unsigned state, bits;
        int take;
        bool found;
        for (;;) {
          if (q < 0) {
            state = INCLUSIVE;
            bits = carry_bits(O::identity());
          } else {
            const unsigned long long word = load_status(status + q);
            state = (unsigned)(word >> 32);
            bits = (unsigned)word;
          }
          const unsigned inc = __ballot_sync(FULL, state == INCLUSIVE);
          const unsigned idle = __ballot_sync(FULL, state == NOT_READY);
          const int m = inc ? __ffs(inc) - 1 : 32;   // the nearest inclusive prefix
          const int z = idle ? __ffs(idle) - 1 : 32;  // the nearest chunk not ready
          if (m < z) { take = m + 1; found = true; break; }
          if (z > 0) { take = z; found = false; break; }  // fold what is there, read on
          if (clock64() > deadline) {
            if (lane == 0) atomicExch(ws + 1, (unsigned long long)(id + 1));
            __threadfence();
            __trap();
          }
          __nanosleep(32);
        }
        // lanes take - 1 .. 0 hold chunks pred - take + 1 .. pred
        A acc = O::identity();
        for (int j = take - 1; j >= 0; --j)
          acc = O::combine(acc, carry_from<A>(__shfl_sync(FULL, bits, j)));
        carry = O::combine(acc, carry);
        if (found) break;
        pred -= take;
      }
      if (successor && lane == 0)
        store_status(status + c, INCLUSIVE, carry_bits(O::combine(carry, ts.total)));
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  ts.template store<true>(yr, base, L, s_carry, exclusive, (A)fill);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// a look-back wait longer than this traps
constexpr double TIMEOUT_S = 2.0;

struct Call {
  int path, vec;
  const void* x;
  void* y;
  long long R, L, blocks;
  int exclusive;
  double fill;
  unsigned long long* ws;
  long long timeout_cycles;
  cudaStream_t stream;
};

template <typename T, int OP, bool REVERSE, int V>
int launch_path(const Call& c) {
  const T* x = static_cast<const T*>(c.x);
  T* y = static_cast<T*>(c.y);
  switch (c.path) {
    case PATH_ROWS:
      if (c.blocks != (c.R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK) return -2;
      k3_scan_kernel_rows<T, OP, REVERSE, V><<<(unsigned)c.blocks, ROW_THREADS, 0, c.stream>>>(
          x, y, c.R, c.L, c.exclusive, c.fill);
      break;
    case PATH_TILES:
      if (c.blocks != c.R) return -2;
      k3_scan_kernel_tiles<T, OP, REVERSE, V><<<(unsigned)c.blocks, TILE_THREADS, 0, c.stream>>>(
          x, y, c.L, c.exclusive, c.fill);
      break;
    case PATH_LOOKBACK: {
      if (c.ws == nullptr) return -1;
      constexpr long long CHUNK = (long long)CHUNK_THREADS * V * CHUNK_VECS;
      const long long chunks = (c.L + CHUNK - 1) / CHUNK;
      if (c.blocks != c.R * chunks) return -2;
      const cudaError_t err = cudaMemsetAsync(
          c.ws, 0, (size_t)(HEAD_WORDS + c.blocks) * sizeof(unsigned long long), c.stream);
      if (err != cudaSuccess) return (int)err;
      k3_scan_kernel_lookback<T, OP, REVERSE, V>
          <<<(unsigned)c.blocks, CHUNK_THREADS, 0, c.stream>>>(x, y, c.L, chunks, c.exclusive,
                                                              c.fill, c.ws, c.timeout_cycles);
      break;
    }
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

template <typename T, int OP, bool REVERSE>
int launch_vec(const Call& c) {
  constexpr int V = VEC_BYTES >= (int)sizeof(T) ? VEC_BYTES / (int)sizeof(T) : 1;
  if (c.vec == 1) return launch_path<T, OP, REVERSE, 1>(c);
  if (c.vec != V) return -1;
  // whole, aligned vectors only
  const uintptr_t align = (uintptr_t)V * sizeof(T);
  if (c.L % V != 0 || (uintptr_t)c.x % align != 0 || (uintptr_t)c.y % align != 0) return -1;
  return launch_path<T, OP, REVERSE, V>(c);
}

// the value an exclusive scan puts first: 0, 1, or the type's lowest finite
// value for max (the plain version's scan_identity), exact in the carry type
template <typename T> double lowest();
template <> double lowest<float>() { return -3.4028234663852886e38; }
template <> double lowest<__nv_bfloat16>() { return -3.3895313892515355e38; }
template <> double lowest<__half>() { return -65504.0; }
template <> double lowest<int32_t>() { return -2147483648.0; }
template <> double lowest<int8_t>() { return -128.0; }

template <typename T>
int launch_ops(int op, int reverse, Call& c) {
  if (reverse && op != OP_ADD) return -1;
  switch (op) {
    case OP_ADD:
      c.fill = 0.0;
      return reverse ? launch_vec<T, OP_ADD, true>(c) : launch_vec<T, OP_ADD, false>(c);
    case OP_MAX:
      c.fill = lowest<T>();
      return launch_vec<T, OP_MAX, false>(c);
    case OP_MUL:
      c.fill = 1.0;
      return launch_vec<T, OP_MUL, false>(c);
    default: return -1;
  }
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

// Scan every row of a contiguous (R, L) array x into y as plan_launch
// planned it. `code` packs the call into one word (ctypes converts each
// argument on every call, about a third of a microsecond each): bits 0-1
// the path (0 rows, 1 tiles, 2 lookback), 2-3 the op (0 add, 1 max, 2 mul),
// 4-6 the dtype, 7-11 the vector width (VEC_BYTES / itemsize, or 1), 12
// exclusive, 13 reverse (add only), 16 and up the grid. ws: the lookback
// path's scratch, HEAD_WORDS + grid 64-bit words, zeroed here (null on the
// other paths). Returns 0 on a launched kernel, -1 for an op, dtype,
// direction or plan that the kernels do not take, -2 for a grid they cannot
// launch, else the CUDA error of the launch.
extern "C" int k3_prefix_scan(long long code, const void* x, void* y, long long R, long long L,
                              void* ws, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  Call c;
  c.path = (int)(code & 3);
  const int op = (int)((code >> 2) & 3);
  const int dtype = (int)((code >> 4) & 7);
  c.vec = (int)((code >> 7) & 31);
  c.exclusive = (int)((code >> 12) & 1);
  const int reverse = (int)((code >> 13) & 1);
  c.blocks = code >> 16;
  if (c.blocks <= 0 || c.blocks > 0x7fffffffLL) return -2;
  c.x = x;
  c.y = y;
  c.R = R;
  c.L = L;
  c.ws = static_cast<unsigned long long*>(ws);
  c.timeout_cycles = c.path == PATH_LOOKBACK ? (long long)(TIMEOUT_S * 1e3 * (double)clock_khz()) : 0;
  c.stream = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_FLOAT32: return launch_ops<float>(op, reverse, c);
    case DT_BFLOAT16: return launch_ops<__nv_bfloat16>(op, reverse, c);
    case DT_FLOAT16: return launch_ops<__half>(op, reverse, c);
    case DT_INT32: return launch_ops<int32_t>(op, reverse, c);
    case DT_INT8: return launch_ops<int8_t>(op, reverse, c);
    default: return -1;
  }
}
