// K1: the fused "NIC" collective kernel — every exchange round of one comm
// phase in one launch.
//
// Replaces repro/kernels/pallas_collective.py::_sim_comm_kernel (the sim form
// that _lower_pallas_sim builds per phase). Over stacked (p, M) leaves it runs
//   * SCAN        hillis-steele doubling, inclusive or exclusive (the
//                 exclusive form starts from the rows shifted down by one,
//                 row 0 zeroed);
//   * FUSED       FUSED_SCAN_TOTAL: prefix doubling + suffix doubling, writing
//                 the scan and the axis total;
//   * BUTTERFLY   TOTAL / BARRIER as the pow2 XOR butterfly.
// Rows with no sender read as zero (the kernel's identity handling, which is
// why the planner only hands it zero-identity operators for scans). Operand
// order is the reference's: combine(recv, acc) when the partner is lower,
// combine(acc, recv) otherwise; prefix rounds combine(recv, acc), suffix
// rounds combine(acc, recv).
//
// Design: every round moves data only along the rank axis, so each thread
// owns payload columns across all p rows and runs every round of the phase
// on them alone; no round needs a block or grid sync. fused_collective.
// plan_launch picks one of two paths:
//   * register (2 <= p <= 16): a thread owns VEC contiguous columns, VEC =
//     16 bytes of the leaf type (4 f32, 8 bf16, 16 int8), and keeps its
//     whole column tile in registers. It issues all p row loads as 16-byte
//     vector loads before any combine, runs every round fully unrolled, and
//     stores 16-byte vectors. The kernel is compiled for P_MAX in {2, 4, 8,
//     16}, the power of two at or above p, with the real p guarded at run
//     time (four instances a kind and operator, not fifteen). Where a
//     thread would keep more than reg::BUDGET values (two streams, or the
//     2- and 3-leaf SSD and flash operators, or 16 int8 columns at
//     P_MAX = 16), VEC halves until it keeps no more, so ptxas spills
//     nothing. Rows that are not 16-byte aligned (M * itemsize, or a base
//     pointer) take the VEC = 1 instance of the same kernel; the plan
//     decides, no retry.
//   * column (p = 1 or p > 16, the PR 13 kernel): the column lives in shared
//     memory laid out [stream][leaf][row][thread] (threads of a warp touch
//     consecutive words) or, when p is too large for that, in a
//     global-memory scratch laid out [stream][leaf][row][column].
// Loads and stores of the (p, M) leaves are coalesced across the warp.
//
// Bound: memory. The kernel reads p*M*itemsize bytes per leaf and writes that
// once per output stream; its least time is those bytes over the card's
// memory bandwidth. The combine is a handful of operations per byte.
//
// Arithmetic follows the reference element for element (collective_ops.cuh,
// shared with K2): every combine rounds to the leaf type, integer sums and
// products wrap, MAX/MIN propagate NaN, and no multiply-add is contracted.

#include "collective_ops.cuh"

using namespace collective;

namespace {

enum Path { PATH_REGISTER = 0, PATH_COLUMN = 1 };

// ---- the column path ----------------------------------------------------

template <typename T>
struct Args {
  const T* x[MAX_LEAVES];
  T* y[MAX_LEAVES];    // the phase's output (the scan, or the total)
  T* t[MAX_LEAVES];    // FUSED only: the axis total
  T* scratch;          // null: column buffer in shared memory
  long long M;         // columns per leaf
  int p;               // rows (ranks)
  int inclusive;
};

// one thread's column buffer: element (stream, leaf, row)
template <typename T, int L>
struct Column {
  T* base;
  long long ld;
  int p;
  __device__ __forceinline__ T& at(int s, int l, int r) const {
    return base[((long long)(s * L + l) * p + r) * ld];
  }
};

template <typename T, class Op, int KIND>
__global__ void k1_column_kernel(Args<T> a) {
  constexpr int L = Op::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a.M) return;
  const int p = a.p;
  const long long M = a.M;
  Column<T, L> w;
  if (a.scratch != nullptr) {
    w.base = a.scratch + col;
    w.ld = M;
  } else {
    w.base = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
    w.ld = blockDim.x;
  }
  w.p = p;
  const T zero = Num<T>::zero();
  T lhs[L], rhs[L], res[L];

  // stream 0 starts from x (inclusive / butterfly) or from x shifted down by
  // one row with row 0 zeroed (exclusive)
  const bool shifted = (KIND != KIND_BUTTERFLY) && !a.inclusive;
  for (int r = 0; r < p; ++r) {
    for (int l = 0; l < L; ++l) {
      T v = zero;
      if (!shifted) v = a.x[l][(long long)r * M + col];
      else if (r >= 1) v = a.x[l][(long long)(r - 1) * M + col];
      w.at(0, l, r) = v;
      if (KIND == KIND_FUSED) w.at(1, l, r) = a.x[l][(long long)r * M + col];
    }
  }

  if (KIND == KIND_BUTTERFLY) {
    // pow2 p: rows r and r+d (r & d == 0) both end with combine(acc_r, acc_{r+d})
    for (int d = 1; d < p; d <<= 1) {
      for (int r = 0; r < p; ++r) {
        if (r & d) continue;
        for (int l = 0; l < L; ++l) {
          lhs[l] = w.at(0, l, r);
          rhs[l] = w.at(0, l, r + d);
        }
        Op::combine(lhs, rhs, res);
        for (int l = 0; l < L; ++l) {
          w.at(0, l, r) = res[l];
          w.at(0, l, r + d) = res[l];
        }
      }
    }
  } else {
    for (int d = 1; d < p; d <<= 1) {
      // prefix: acc[r] = combine(recv, acc[r]), recv = acc[r-d] or zero.
      // Descending rows read acc[r-d] before it is overwritten.
      for (int r = p - 1; r >= 0; --r) {
        for (int l = 0; l < L; ++l) {
          lhs[l] = r >= d ? w.at(0, l, r - d) : zero;
          rhs[l] = w.at(0, l, r);
        }
        Op::combine(lhs, rhs, res);
        for (int l = 0; l < L; ++l) w.at(0, l, r) = res[l];
      }
      if (KIND == KIND_FUSED) {
        // suffix: acc[r] = combine(acc[r], recv), recv = acc[r+d] or zero.
        // Ascending rows read acc[r+d] before it is overwritten.
        for (int r = 0; r < p; ++r) {
          for (int l = 0; l < L; ++l) {
            lhs[l] = w.at(1, l, r);
            rhs[l] = r + d < p ? w.at(1, l, r + d) : zero;
          }
          Op::combine(lhs, rhs, res);
          for (int l = 0; l < L; ++l) w.at(1, l, r) = res[l];
        }
      }
    }
  }

  if (KIND != KIND_FUSED) {
    for (int r = 0; r < p; ++r)
      for (int l = 0; l < L; ++l) a.y[l][(long long)r * M + col] = w.at(0, l, r);
    return;
  }
  // fused exits: inclusive total = combine(pre[r], suf[r+1] or zero);
  // exclusive total = combine(pre[r], suf[r]) and the scan's row 0 is zero
  for (int r = 0; r < p; ++r) {
    for (int l = 0; l < L; ++l) {
      lhs[l] = w.at(0, l, r);
      if (a.inclusive) rhs[l] = r + 1 < p ? w.at(1, l, r + 1) : zero;
      else rhs[l] = w.at(1, l, r);
    }
    Op::combine(lhs, rhs, res);
    for (int l = 0; l < L; ++l) {
      a.t[l][(long long)r * M + col] = res[l];
      a.y[l][(long long)r * M + col] = (a.inclusive || r != 0) ? lhs[l] : zero;
    }
  }
}

// ---- the register path ----------------------------------------------

namespace reg {

constexpr int THREADS = 128;
// values of the leaf type a thread may keep: streams * leaves * P_MAX * VEC
constexpr int BUDGET = 128;

// columns a thread owns: 16 bytes of T, halved while the thread would keep
// more than BUDGET values (fused_collective.register_vec)
template <typename T, int L, int KIND, int P_MAX>
constexpr int vec_for() {
  int vec = 16 / (int)sizeof(T);
  const int streams = KIND == KIND_FUSED ? 2 : 1;
  while (vec > 1 && streams * L * P_MAX * vec > BUDGET) vec /= 2;
  return vec;
}

template <typename T>
struct Args {
  const T* x[MAX_LEAVES];
  T* y[MAX_LEAVES];    // the phase's output (the scan, or the total)
  T* t[MAX_LEAVES];    // FUSED only: the axis total
  long long M;         // columns per leaf, a multiple of VEC
  int p;               // rows (ranks), at most P_MAX
  int inclusive;
};

// (THREADS, 1): one block an SM is enough, so ptxas may take up to 255
// registers a thread rather than spill to keep more blocks resident
template <typename T, class Op, int KIND, int P_MAX, int VEC>
__global__ void __launch_bounds__(THREADS, 1) k1_register_kernel(Args<T> a) {
  constexpr int L = Op::L;
  const long long M = a.M;
  const long long col = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (col >= M) return;  // the ragged edge: M % VEC == 0, so whole vectors
  const int p = a.p;
  const bool inclusive = a.inclusive != 0;
  const T zero = Num<T>::zero();
  T lhs[L], rhs[L], res[L];

  // every row of the tile, each one vector load, all before any combine
  T x[L][P_MAX][VEC];
#pragma unroll
  for (int r = 0; r < P_MAX; ++r)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (r < p) {
        load_row<T, VEC>(a.x[l] + (long long)r * M, col, M, true, x[l][r]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[l][r][v] = zero;
      }
    }

  // stream 0 (pre) starts from x (inclusive / butterfly) or from x shifted
  // down by one row with row 0 zeroed (exclusive); stream 1 (suf) from x
  const bool shifted = KIND != KIND_BUTTERFLY && !inclusive;
  T pre[L][P_MAX][VEC];
#pragma unroll
  for (int r = 0; r < P_MAX; ++r)
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        pre[l][r][v] = !shifted ? x[l][r][v] : r >= 1 ? x[l][r >= 1 ? r - 1 : 0][v] : zero;

  if constexpr (KIND == KIND_BUTTERFLY) {
    // pow2 p == P_MAX: rows r and r+d (r & d == 0) both end with
    // combine(acc_r, acc_{r+d})
#pragma unroll
    for (int d = 1; d < P_MAX; d <<= 1)
#pragma unroll
      for (int r = 0; r < P_MAX; ++r) {
        if (r & d) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
            lhs[l] = pre[l][r][v];
            rhs[l] = pre[l][r + d][v];
          }
          Op::combine(lhs, rhs, res);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            pre[l][r][v] = res[l];
            pre[l][r + d][v] = res[l];
          }
        }
      }
#pragma unroll
    for (int r = 0; r < P_MAX; ++r)
#pragma unroll
      for (int l = 0; l < L; ++l)
        store_row<T, VEC>(a.y[l] + (long long)r * M, col, M, true, pre[l][r]);
  } else {
    T suf[L][P_MAX][VEC];
    if constexpr (KIND == KIND_FUSED) {
#pragma unroll
      for (int r = 0; r < P_MAX; ++r)
#pragma unroll
        for (int l = 0; l < L; ++l)
#pragma unroll
          for (int v = 0; v < VEC; ++v) suf[l][r][v] = x[l][r][v];
    }

#pragma unroll
    for (int d = 1; d < P_MAX; d <<= 1) {
      if (d >= p) continue;  // the rounds of p, not of P_MAX
      // prefix: pre[r] = combine(recv, pre[r]), recv = pre[r-d] or zero.
      // Descending rows read pre[r-d] before it is overwritten.
#pragma unroll
      for (int r = P_MAX - 1; r >= 0; --r) {
        if (r >= p) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
            lhs[l] = r >= d ? pre[l][r >= d ? r - d : 0][v] : zero;
            rhs[l] = pre[l][r][v];
          }
          Op::combine(lhs, rhs, res);
#pragma unroll
          for (int l = 0; l < L; ++l) pre[l][r][v] = res[l];
        }
      }
      if constexpr (KIND == KIND_FUSED) {
        // suffix: suf[r] = combine(suf[r], recv), recv = suf[r+d] or zero.
        // Ascending rows read suf[r+d] before it is overwritten.
#pragma unroll
        for (int r = 0; r < P_MAX; ++r) {
          if (r >= p) continue;
          const bool has = r + d < p;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
              lhs[l] = suf[l][r][v];
              rhs[l] = has ? suf[l][r + d < P_MAX ? r + d : r][v] : zero;
            }
            Op::combine(lhs, rhs, res);
#pragma unroll
            for (int l = 0; l < L; ++l) suf[l][r][v] = res[l];
          }
        }
      }
    }

    if constexpr (KIND != KIND_FUSED) {
#pragma unroll
      for (int r = 0; r < P_MAX; ++r) {
        if (r >= p) continue;
#pragma unroll
        for (int l = 0; l < L; ++l)
          store_row<T, VEC>(a.y[l] + (long long)r * M, col, M, true, pre[l][r]);
      }
    } else {
      // fused exits: inclusive total = combine(pre[r], suf[r+1] or zero);
      // exclusive total = combine(pre[r], suf[r]) and the scan's row 0 is zero
#pragma unroll
      for (int r = 0; r < P_MAX; ++r) {
        if (r >= p) continue;
        const bool has = r + 1 < p;
        T tot[L][VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
            lhs[l] = pre[l][r][v];
            if (inclusive) rhs[l] = has ? suf[l][r + 1 < P_MAX ? r + 1 : r][v] : zero;
            else rhs[l] = suf[l][r][v];
          }
          Op::combine(lhs, rhs, res);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            tot[l][v] = res[l];
            if (!inclusive && r == 0) pre[l][r][v] = zero;
          }
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
          store_row<T, VEC>(a.t[l] + (long long)r * M, col, M, true, tot[l]);
          store_row<T, VEC>(a.y[l] + (long long)r * M, col, M, true, pre[l][r]);
        }
      }
    }
  }
}

}  // namespace reg

// ---- host side ----------------------------------------------------------

// one launch as the entry received it
struct Call {
  int path, kind, inclusive, p, p_max, vec, block, smem_bytes;
  long long M;
  const void* x[MAX_LEAVES];
  void* y[MAX_LEAVES];
  void* t[MAX_LEAVES];
  void* scratch;
  cudaStream_t stream;
  int* made;  // kernels launched, each counted once cudaGetLastError() passed it
};

int launched(const Call& c) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*c.made;
  return (int)err;
}

template <typename T>
void fill_leaves(const Call& c, const T** x, T** y, T** t) {
  for (int l = 0; l < MAX_LEAVES; ++l) {
    x[l] = static_cast<const T*>(c.x[l]);
    y[l] = static_cast<T*>(c.y[l]);
    t[l] = static_cast<T*>(c.t[l]);
  }
}

template <typename T, class Op, int KIND>
int launch_column(const Call& c) {
  const long long grid = (c.M + c.block - 1) / c.block;
  if (c.block <= 0 || grid <= 0 || grid > 0x7fffffffLL) return -2;
  Args<T> a;
  fill_leaves<T>(c, a.x, a.y, a.t);
  a.scratch = static_cast<T*>(c.scratch);
  a.M = c.M;
  a.p = c.p;
  a.inclusive = c.inclusive;
  k1_column_kernel<T, Op, KIND><<<(unsigned)grid, c.block, c.smem_bytes, c.stream>>>(a);
  return launched(c);
}

template <typename T, class Op, int KIND, int P_MAX>
int launch_register_pmax(const Call& c) {
  constexpr int VEC = reg::vec_for<T, Op::L, KIND, P_MAX>();
  if (c.p > P_MAX || (KIND == KIND_BUTTERFLY && c.p != P_MAX)) return -1;
  if (c.block != reg::THREADS || (c.vec != VEC && c.vec != 1) || c.M % c.vec) return -1;
  const long long grid = (c.M + (long long)reg::THREADS * c.vec - 1) / ((long long)reg::THREADS * c.vec);
  if (grid <= 0 || grid > 0x7fffffffLL) return -2;
  reg::Args<T> a;
  fill_leaves<T>(c, a.x, a.y, a.t);
  a.M = c.M;
  a.p = c.p;
  a.inclusive = c.inclusive;
  if (c.vec == VEC)
    reg::k1_register_kernel<T, Op, KIND, P_MAX, VEC><<<(unsigned)grid, reg::THREADS, 0, c.stream>>>(a);
  else if constexpr (VEC != 1)
    reg::k1_register_kernel<T, Op, KIND, P_MAX, 1><<<(unsigned)grid, reg::THREADS, 0, c.stream>>>(a);
  return launched(c);
}

template <typename T, class Op, int KIND>
int launch_kind(const Call& c) {
  if (c.path == PATH_COLUMN) return launch_column<T, Op, KIND>(c);
  if (c.path != PATH_REGISTER) return -1;
  switch (c.p_max) {
    case 2: return launch_register_pmax<T, Op, KIND, 2>(c);
    case 4: return launch_register_pmax<T, Op, KIND, 4>(c);
    case 8: return launch_register_pmax<T, Op, KIND, 8>(c);
    case 16: return launch_register_pmax<T, Op, KIND, 16>(c);
    default: return -1;
  }
}

template <typename T, class Op>
int launch_op(const Call& c) {
  switch (c.kind) {
    case KIND_SCAN: return launch_kind<T, Op, KIND_SCAN>(c);
    case KIND_FUSED: return launch_kind<T, Op, KIND_FUSED>(c);
    case KIND_BUTTERFLY: return launch_kind<T, Op, KIND_BUTTERFLY>(c);
    default: return -1;
  }
}

template <typename T>
int launch_float_ops(int op, const Call& c) {
  switch (op) {
    case OP_SUM: return launch_op<T, OpSum<T>>(c);
    case OP_PROD: return launch_op<T, OpProd<T>>(c);
    case OP_MAX: return launch_op<T, OpMax<T>>(c);
    case OP_MIN: return launch_op<T, OpMin<T>>(c);
    case OP_SSD: return launch_op<T, OpSsd<T>>(c);
    case OP_FLASH: return launch_op<T, OpFlash<T>>(c);
    default: return -1;
  }
}

template <typename T>
int launch_int_ops(int op, const Call& c) {
  switch (op) {
    case OP_SUM: return launch_op<T, OpSum<T>>(c);
    case OP_PROD: return launch_op<T, OpProd<T>>(c);
    case OP_MAX: return launch_op<T, OpMax<T>>(c);
    case OP_MIN: return launch_op<T, OpMin<T>>(c);
    default: return -1;
  }
}

}  // namespace

// Launch one comm phase on the path fused_collective.plan_launch chose (0
// register, 1 column). The register path takes p_max (2, 4, 8 or 16, at
// least p; p itself for the butterfly), vec (the kernel's own VEC, or 1 for
// rows not aligned to 16 bytes) and block = 128; the column path takes
// block, smem_bytes and scratch (null when the column buffer fits in shared
// memory). x/y/t hold up to three leaf pointers each (unused ones null).
// Returns cudaGetLastError() after the launch (0 on success), -1 for a
// (path, kind, op, dtype), p_max, vec or block the kernels do not take, -2
// for a grid they cannot cover. *launches is set to the kernels launched,
// each counted once cudaGetLastError() has passed its launch.
extern "C" int k1_fused_comm(int path, int kind, int op, int dtype, int inclusive, int p,
                             long long M, int p_max, int vec, int block, int smem_bytes,
                             const void* x0, const void* x1, const void* x2, void* y0, void* y1,
                             void* y2, void* t0, void* t1, void* t2, void* scratch,
                             void* stream, int* launches) {
  *launches = 0;
  if (p < 1 || M <= 0) return -1;
  Call c;
  c.path = path;
  c.kind = kind;
  c.inclusive = inclusive;
  c.p = p;
  c.p_max = p_max;
  c.vec = vec;
  c.block = block;
  c.smem_bytes = smem_bytes;
  c.M = M;
  const void* x[MAX_LEAVES] = {x0, x1, x2};
  void* y[MAX_LEAVES] = {y0, y1, y2};
  void* t[MAX_LEAVES] = {t0, t1, t2};
  for (int l = 0; l < MAX_LEAVES; ++l) {
    c.x[l] = x[l];
    c.y[l] = y[l];
    c.t[l] = t[l];
  }
  c.scratch = scratch;
  c.stream = static_cast<cudaStream_t>(stream);
  c.made = launches;
  switch (dtype) {
    case DT_FLOAT32: return launch_float_ops<float>(op, c);
    case DT_BFLOAT16: return launch_float_ops<__nv_bfloat16>(op, c);
    case DT_FLOAT16: return launch_float_ops<__half>(op, c);
    case DT_INT32: return launch_int_ops<int32_t>(op, c);
    case DT_INT8: return launch_int_ops<int8_t>(op, c);
    default: return -1;
  }
}

// k1_fused_comm for one leaf without totals (SCAN or a butterfly), the call
// packed into one word as fused_collective.pack_call builds it (ctypes
// converts each argument on every call): bit 0 the path, 1-2 the kind, 3-5
// the op, 6-8 the dtype, 9 inclusive, 10-14 vec, 15-19 p_max, 20-28 block,
// 29-44 smem_bytes, 45-62 p. scratch as k1_fused_comm takes it. Returns what
// k1_fused_comm returns; 0 means one kernel launched.
extern "C" int k1_fused_packed(long long code, long long M, const void* x, void* y,
                               void* scratch, void* stream) {
  int made = 0;
  return k1_fused_comm((int)(code & 1), (int)((code >> 1) & 3), (int)((code >> 3) & 7),
                       (int)((code >> 6) & 7), (int)((code >> 9) & 1), (int)(code >> 45), M,
                       (int)((code >> 15) & 31), (int)((code >> 10) & 31),
                       (int)((code >> 20) & 511), (int)((code >> 29) & 0xffff), x, nullptr,
                       nullptr, y, nullptr, nullptr, nullptr, nullptr, nullptr, scratch, stream,
                       &made);
}
