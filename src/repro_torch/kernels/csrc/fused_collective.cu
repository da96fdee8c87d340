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
// owns one payload column across all p rows and runs every round of the
// phase on that column alone; no round needs a block or grid sync. The
// column lives in shared memory laid out [stream][leaf][row][thread] (threads
// of a warp touch consecutive words) or, when p is too large for that, in a
// global-memory scratch laid out [stream][leaf][row][column]. Loads and
// stores of the (p, M) leaves are coalesced across the warp.
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

enum Kind { KIND_SCAN = 0, KIND_FUSED = 1, KIND_BUTTERFLY = 2 };

// ---- the kernel ---------------------------------------------------------

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
__global__ void k1_kernel(Args<T> a) {
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

template <typename T, class Op>
int launch_op(int kind, const Args<T>& args, int block, int smem_bytes,
              cudaStream_t stream) {
  const long long grid = (args.M + block - 1) / block;
  if (grid <= 0 || grid > 0x7fffffffLL) return -2;
  switch (kind) {
    case KIND_SCAN:
      k1_kernel<T, Op, KIND_SCAN><<<(unsigned)grid, block, smem_bytes, stream>>>(args);
      break;
    case KIND_FUSED:
      k1_kernel<T, Op, KIND_FUSED><<<(unsigned)grid, block, smem_bytes, stream>>>(args);
      break;
    case KIND_BUTTERFLY:
      k1_kernel<T, Op, KIND_BUTTERFLY><<<(unsigned)grid, block, smem_bytes, stream>>>(args);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(int p, long long M, int inclusive, const void* const* x,
                  void* const* y, void* const* t, void* scratch) {
  Args<T> a;
  for (int l = 0; l < MAX_LEAVES; ++l) {
    a.x[l] = static_cast<const T*>(x[l]);
    a.y[l] = static_cast<T*>(y[l]);
    a.t[l] = static_cast<T*>(t[l]);
  }
  a.scratch = static_cast<T*>(scratch);
  a.M = M;
  a.p = p;
  a.inclusive = inclusive;
  return a;
}

template <typename T>
int launch_float_ops(int kind, int op, const Args<T>& a, int block, int smem,
                     cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch_op<T, OpSum<T>>(kind, a, block, smem, s);
    case OP_PROD: return launch_op<T, OpProd<T>>(kind, a, block, smem, s);
    case OP_MAX: return launch_op<T, OpMax<T>>(kind, a, block, smem, s);
    case OP_MIN: return launch_op<T, OpMin<T>>(kind, a, block, smem, s);
    case OP_SSD: return launch_op<T, OpSsd<T>>(kind, a, block, smem, s);
    case OP_FLASH: return launch_op<T, OpFlash<T>>(kind, a, block, smem, s);
    default: return -1;
  }
}

template <typename T>
int launch_int_ops(int kind, int op, const Args<T>& a, int block, int smem,
                   cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch_op<T, OpSum<T>>(kind, a, block, smem, s);
    case OP_PROD: return launch_op<T, OpProd<T>>(kind, a, block, smem, s);
    case OP_MAX: return launch_op<T, OpMax<T>>(kind, a, block, smem, s);
    case OP_MIN: return launch_op<T, OpMin<T>>(kind, a, block, smem, s);
    default: return -1;
  }
}

}  // namespace

// Launch one comm phase. Returns cudaGetLastError() after the launch (0 on
// success), -1 for a (kind, op, dtype) the kernel does not take, -2 for a
// grid it cannot cover. x/y/t hold up to three leaf pointers each (unused
// ones null); scratch is null when the column buffer fits in shared memory.
extern "C" int k1_fused_comm(int kind, int op, int dtype, int inclusive, int p,
                             long long M, const void* x0, const void* x1,
                             const void* x2, void* y0, void* y1, void* y2,
                             void* t0, void* t1, void* t2, void* scratch,
                             int block, int smem_bytes, void* stream) {
  const void* x[MAX_LEAVES] = {x0, x1, x2};
  void* y[MAX_LEAVES] = {y0, y1, y2};
  void* t[MAX_LEAVES] = {t0, t1, t2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_FLOAT32:
      return launch_float_ops<float>(
          kind, op, make_args<float>(p, M, inclusive, x, y, t, scratch), block, smem_bytes, s);
    case DT_BFLOAT16:
      return launch_float_ops<__nv_bfloat16>(
          kind, op, make_args<__nv_bfloat16>(p, M, inclusive, x, y, t, scratch), block,
          smem_bytes, s);
    case DT_FLOAT16:
      return launch_float_ops<__half>(
          kind, op, make_args<__half>(p, M, inclusive, x, y, t, scratch), block, smem_bytes, s);
    case DT_INT32:
      return launch_int_ops<int32_t>(
          kind, op, make_args<int32_t>(p, M, inclusive, x, y, t, scratch), block, smem_bytes, s);
    case DT_INT8:
      return launch_int_ops<int8_t>(
          kind, op, make_args<int8_t>(p, M, inclusive, x, y, t, scratch), block, smem_bytes, s);
    default:
      return -1;
  }
}
