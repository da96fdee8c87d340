// K2: the per-rank collective kernel — every exchange round of one comm
// phase in one launch, each rank running its own program and exchanging with
// its partners through peer puts and signal flags.
//
// Replaces repro/kernels/pallas_collective.py::_spmd_comm_kernel (the spmd
// form that _lower_pallas_spmd builds per phase under shard_map). Per rank it
// runs
//   * SCAN        hillis-steele doubling, inclusive or exclusive (the
//                 exclusive form starts with a structural shift by one);
//   * FUSED       FUSED_SCAN_TOTAL: prefix doubling + suffix doubling, writing
//                 the scan and the axis total;
//   * BUTTERFLY   TOTAL / BARRIER as the pow2 XOR butterfly.
// Every round is a full permutation, as in the reference: rank r puts its
// accumulator into partner (r + d) mod p (prefix), (r - d) mod p (suffix) or
// r ^ d (butterfly), and the receiver masks a wrapped copy back to zero, the
// zero fill of a per-rank permute. Operand order is the reference's:
// combine(recv, acc) for the prefix stream and a lower butterfly partner,
// combine(acc, recv) for the suffix stream and a higher one. The combines
// are collective_ops.cuh's, shared with K1, so K2 and K1 agree bit for bit.
//
// The per-rank protocol. A rank's program is a set of thread blocks, each
// owning tiles of the rank's payload (a grid-stride loop over tiles). For
// exchange s of tile t, a block stores its accumulator tile into its
// partner's receive region for exchange s, through a table of p peer
// pointers (a symmetric layout: every rank's region has the same shape),
// then raises the partner's signal flag (s, t). Before it reads, the block
// waits on its own flag (s, t), then masks and combines.
//   * Co-residency: a block spinning on a flag whose writer is not resident
//     waits forever, so the launch is cooperative and its grid capped at the
//     blocks the device holds at once; a launch that cannot be made resident
//     returns an error instead of running.
//   * Slot reuse: every exchange has its own receive region covering the
//     whole payload, so no sender, however far ahead, overwrites a tile its
//     reader has not consumed.
//   * Flags across calls: a flag is raised to the launch's epoch, a counter
//     the wrapper passes in and bumps per launch, and a reader waits for
//     equality, so one launch never sees the flags of the one before it.
//   * Ordering: data stores, __syncthreads(), a fence and a st.release.gpu
//     on the flag by one thread; the reader's ld.acquire.gpu spin, then
//     __syncthreads(), then L2 loads (ld.global.cg) of the received tile.
//     Peers on other GPUs would need .sys scope; on one device .gpu holds.
//   * No hang: every spin is bounded by a clock64 deadline. A block that
//     times out writes (code, rank, exchange, tile) into a device status
//     word and leaves; the others see the word and leave too. The wrapper
//     reads the word after the launch and raises.
// On one GPU all p ranks run in one launch (blockIdx.y = rank) and the peer
// tables point into one stacked allocation; given tables of pointers that
// lie on other GPUs, the same kernel is the multi-GPU form.
//
// Bound: memory, like K1 (the same function): p*M*itemsize bytes read per
// leaf and written once per output stream. Unlike K1, each round also goes
// through device memory (a put and a read per element) and a flag.

#include "collective_ops.cuh"

#include <cstring>

using namespace collective;

namespace {

enum Kind { KIND_SCAN = 0, KIND_FUSED = 1, KIND_BUTTERFLY = 2 };

constexpr int BLOCK = 256;  // threads per block
constexpr int VEC = 4;      // elements a thread carries per tile
constexpr int TILE = BLOCK * VEC;

enum Status { STATUS_OK = 0, STATUS_TIMEOUT = 1 };

template <typename T>
struct Args {
  const T* x[MAX_LEAVES];  // stacked (p, M) inputs: rank r's row at x + r*M
  T* y[MAX_LEAVES];        // the phase's output (the scan, or the total)
  T* t[MAX_LEAVES];        // FUSED only: the axis total
  T* const* recv;          // peer table: rank q's receive region [exchange][leaf][M]
  unsigned* const* flags;  // peer table: rank q's signal flags [exchange][tile]
  int* status;             // (code, rank, exchange, tile); all zero = fine
  long long M;             // elements per leaf and rank
  long long ntiles;        // tiles per leaf and rank
  long long timeout_cycles;
  unsigned epoch;          // this launch's flag value (never 0)
  int p;                   // ranks
  int inclusive;
};

// a received element, read from L2 (the writer is another block)
template <typename T>
__device__ __forceinline__ T load_cg(const T* ptr) {
  T out;
  if constexpr (sizeof(T) == 4) {
    unsigned v = __ldcg(reinterpret_cast<const unsigned*>(ptr));
    memcpy(&out, &v, sizeof(T));
  } else if constexpr (sizeof(T) == 2) {
    unsigned short v = __ldcg(reinterpret_cast<const unsigned short*>(ptr));
    memcpy(&out, &v, sizeof(T));
  } else {
    unsigned char v = __ldcg(reinterpret_cast<const unsigned char*>(ptr));
    memcpy(&out, &v, sizeof(T));
  }
  return out;
}

__device__ __forceinline__ void signal_release(unsigned* flag, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned poll_acquire(const unsigned* flag) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

template <typename T, class Op, int KIND>
__global__ void __launch_bounds__(BLOCK) k2_kernel(Args<T> a) {
  constexpr int L = Op::L;
  __shared__ int abort_block;
  const int p = a.p;
  const int rank = blockIdx.y;
  const long long M = a.M;
  const T zero = Num<T>::zero();
  int nsteps = 0;
  while ((1 << nsteps) < p) ++nsteps;
  T* const own_recv = a.recv[rank];
  const unsigned* const own_flags = a.flags[rank];
  if (threadIdx.x == 0) abort_block = 0;
  __syncthreads();

  T acc[2][L][VEC];  // [stream][leaf][element]: stream 0 prefix, 1 suffix
  T rv[L][VEC];
  T lhs[L], rhs[L], res[L];

  for (long long tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const long long base = tile * TILE + threadIdx.x;
    // element v of this thread: column base + v*BLOCK (coalesced per warp)
    auto in_range = [&](int v) { return base + (long long)v * BLOCK < M; };
    int ex = 0;  // exchange index of this tile

    // store stream s's accumulator into rank dst's receive region (ex)
    auto put = [&](int s, int dst, int e) {
      T* region = a.recv[dst] + (long long)e * L * M;
      for (int l = 0; l < L; ++l)
        for (int v = 0; v < VEC; ++v)
          if (in_range(v)) region[(long long)l * M + base + (long long)v * BLOCK] = acc[s][l][v];
    };
    // after the puts: one thread raises the partners' flags
    auto publish = [&](int dst0, int e0, int dst1, int e1) {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        signal_release(a.flags[dst0] + (long long)e0 * a.ntiles + tile, a.epoch);
        if (dst1 >= 0) signal_release(a.flags[dst1] + (long long)e1 * a.ntiles + tile, a.epoch);
      }
    };
    // wait for exchange e of this tile, then read it into rv; false = abort
    auto receive = [&](int e) -> bool {
      if (threadIdx.x == 0) {
        const unsigned* flag = own_flags + (long long)e * a.ntiles + tile;
        const long long deadline = clock64() + a.timeout_cycles;
        while (poll_acquire(flag) != a.epoch) {
          if (*(volatile int*)a.status != STATUS_OK) {
            abort_block = 1;
            break;
          }
          if (clock64() > deadline) {
            if (atomicCAS(a.status, STATUS_OK, STATUS_TIMEOUT) == STATUS_OK) {
              a.status[1] = rank;
              a.status[2] = e;
              a.status[3] = (int)tile;
              __threadfence();
            }
            abort_block = 1;
            break;
          }
          __nanosleep(64);
        }
      }
      __syncthreads();
      if (abort_block) return false;
      const T* region = own_recv + (long long)e * L * M;
      for (int l = 0; l < L; ++l)
        for (int v = 0; v < VEC; ++v)
          rv[l][v] = in_range(v) ? load_cg(region + (long long)l * M + base + (long long)v * BLOCK)
                                 : zero;
      return true;
    };
    // acc[s] = keep ? combine(rv, acc[s]) : combine(zero, acc[s])  (recv_left)
    //        or the mirror with recv on the right
    auto fold = [&](int s, bool keep, bool recv_left) {
      for (int v = 0; v < VEC; ++v) {
        for (int l = 0; l < L; ++l) {
          const T got = keep ? rv[l][v] : zero;
          lhs[l] = recv_left ? got : acc[s][l][v];
          rhs[l] = recv_left ? acc[s][l][v] : got;
        }
        Op::combine(lhs, rhs, res);
        for (int l = 0; l < L; ++l) acc[s][l][v] = res[l];
      }
    };

    for (int l = 0; l < L; ++l)
      for (int v = 0; v < VEC; ++v) {
        const T xv = in_range(v) ? a.x[l][(long long)rank * M + base + (long long)v * BLOCK] : zero;
        acc[0][l][v] = xv;
        acc[1][l][v] = xv;
      }

    if (KIND == KIND_BUTTERFLY) {
      for (int k = 0; k < nsteps; ++k, ++ex) {
        const int d = 1 << k;
        put(0, rank ^ d, ex);
        publish(rank ^ d, ex, -1, 0);
        if (!receive(ex)) return;
        fold(0, true, (rank & d) != 0);  // partner lower: combine(recv, acc)
      }
    } else {
      if (!a.inclusive) {
        // structural entry shift: rank r starts from x_{r-1}, rank 0 from zero
        put(0, (rank + 1) % p, ex);
        publish((rank + 1) % p, ex, -1, 0);
        if (!receive(ex)) return;
        for (int l = 0; l < L; ++l)
          for (int v = 0; v < VEC; ++v) acc[0][l][v] = rank >= 1 ? rv[l][v] : zero;
        ++ex;
      }
      for (int k = 0; k < nsteps; ++k) {
        const int d = 1 << k;
        const int up = (rank + d) % p, down = (rank - d + p) % p;
        put(0, up, ex);
        if (KIND == KIND_FUSED) {
          // full duplex: both streams' puts before either wait
          put(1, down, ex + 1);
          publish(up, ex, down, ex + 1);
        } else {
          publish(up, ex, -1, 0);
        }
        if (!receive(ex)) return;
        fold(0, rank >= d, true);
        if (KIND == KIND_FUSED) {
          if (!receive(ex + 1)) return;
          fold(1, rank < p - d, false);
        }
        ex += KIND == KIND_FUSED ? 2 : 1;
      }
    }

    if (KIND != KIND_FUSED) {
      for (int l = 0; l < L; ++l)
        for (int v = 0; v < VEC; ++v)
          if (in_range(v)) a.y[l][(long long)rank * M + base + (long long)v * BLOCK] = acc[0][l][v];
      continue;
    }
    // fused exits: inclusive total = combine(pre, suffix of rank r+1 or
    // zero); exclusive total = combine(pre, suf) and rank 0's scan is zero
    if (a.inclusive) {
      const int down = (rank - 1 + p) % p;
      put(1, down, ex);
      publish(down, ex, -1, 0);
      if (!receive(ex)) return;
    } else {
      for (int l = 0; l < L; ++l)
        for (int v = 0; v < VEC; ++v) rv[l][v] = acc[1][l][v];
    }
    const bool keep = a.inclusive ? rank < p - 1 : true;
    for (int v = 0; v < VEC; ++v) {
      for (int l = 0; l < L; ++l) {
        lhs[l] = acc[0][l][v];
        rhs[l] = keep ? rv[l][v] : zero;
      }
      Op::combine(lhs, rhs, res);
      if (!in_range(v)) continue;
      const long long at = (long long)rank * M + base + (long long)v * BLOCK;
      for (int l = 0; l < L; ++l) {
        a.t[l][at] = res[l];
        a.y[l][at] = (a.inclusive || rank != 0) ? lhs[l] : zero;
      }
    }
  }
}

constexpr int NUM_DTYPES = 5, NUM_OPS = 6, NUM_KINDS = 3;

// What the launch needs to know of the device, queried once per device: the
// queries cost milliseconds a call, many times the kernel itself. per_sm is
// the resident blocks per SM of each kernel instantiation, indexed by
// (dtype, op, kind) code and filled at that instantiation's first launch.
struct DeviceInfo {
  int sms = 0, coop = 0, khz = 0;
  bool ready = false;
  int per_sm[NUM_DTYPES][NUM_OPS][NUM_KINDS] = {};
};

constexpr int MAX_DEVICES = 64;

cudaError_t device_info(DeviceInfo** out) {
  static DeviceInfo cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& info = cache[dev];
  if (!info.ready) {
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info.coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (cudaDeviceGetAttribute(&info.khz, cudaDevAttrClockRate, dev) != cudaSuccess || info.khz <= 0)
      info.khz = 2000000;  // assume 2 GHz: the bound stays finite either way
    info.ready = true;
  }
  *out = &info;
  return cudaSuccess;
}

// the launch context every level below k2_spmd_comm passes down
struct Launch {
  const DeviceInfo& info;
  int* per_sm;  // DeviceInfo::per_sm slot of the (dtype, op, kind) launched
  cudaStream_t stream;
};

template <typename T, class Op, int KIND>
int launch_kind(const Args<T>& args, const Launch& c) {
  const void* fn = reinterpret_cast<const void*>(&k2_kernel<T, Op, KIND>);
  if (*c.per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(c.per_sm, fn, BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
  }
  if (!c.info.coop) return -4;
  const long long resident = (long long)*c.per_sm * c.info.sms;
  if (args.p > resident || args.p > 65535) return -3;  // ranks cannot all be resident
  long long per_rank = resident / args.p;
  if (per_rank > args.ntiles) per_rank = args.ntiles;
  Args<T> a = args;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3((unsigned)per_rank, (unsigned)args.p), dim3(BLOCK), params, 0, c.stream);
  cudaGetLastError();  // clear the launch's error so later calls do not see it
  return (int)err;
}

template <typename T, class Op>
int launch_op(int kind, const Args<T>& args, const Launch& c) {
  switch (kind) {
    case KIND_SCAN: return launch_kind<T, Op, KIND_SCAN>(args, c);
    case KIND_FUSED: return launch_kind<T, Op, KIND_FUSED>(args, c);
    case KIND_BUTTERFLY: return launch_kind<T, Op, KIND_BUTTERFLY>(args, c);
    default: return -1;
  }
}

template <typename T>
int launch_float_ops(int kind, int op, const Args<T>& a, const Launch& c) {
  switch (op) {
    case OP_SUM: return launch_op<T, OpSum<T>>(kind, a, c);
    case OP_PROD: return launch_op<T, OpProd<T>>(kind, a, c);
    case OP_MAX: return launch_op<T, OpMax<T>>(kind, a, c);
    case OP_MIN: return launch_op<T, OpMin<T>>(kind, a, c);
    case OP_SSD: return launch_op<T, OpSsd<T>>(kind, a, c);
    case OP_FLASH: return launch_op<T, OpFlash<T>>(kind, a, c);
    default: return -1;
  }
}

template <typename T>
int launch_int_ops(int kind, int op, const Args<T>& a, const Launch& c) {
  switch (op) {
    case OP_SUM: return launch_op<T, OpSum<T>>(kind, a, c);
    case OP_PROD: return launch_op<T, OpProd<T>>(kind, a, c);
    case OP_MAX: return launch_op<T, OpMax<T>>(kind, a, c);
    case OP_MIN: return launch_op<T, OpMin<T>>(kind, a, c);
    default: return -1;
  }
}

template <typename T>
Args<T> make_args(int p, long long M, int inclusive, const void* const* x, void* const* y,
                  void* const* t, void* recv, void* flags, void* status, unsigned epoch,
                  long long timeout_cycles) {
  Args<T> a;
  for (int l = 0; l < MAX_LEAVES; ++l) {
    a.x[l] = static_cast<const T*>(x[l]);
    a.y[l] = static_cast<T*>(y[l]);
    a.t[l] = static_cast<T*>(t[l]);
  }
  a.recv = static_cast<T* const*>(recv);
  a.flags = static_cast<unsigned* const*>(flags);
  a.status = static_cast<int*>(status);
  a.M = M;
  a.ntiles = (M + TILE - 1) / TILE;
  a.timeout_cycles = timeout_cycles;
  a.epoch = epoch;
  a.p = p;
  a.inclusive = inclusive;
  return a;
}

}  // namespace

// Elements a block's tile covers: the wrapper sizes the flag regions
// (exchanges x ceil(M / tile) per rank) with it.
extern "C" int k2_tile_elems() { return TILE; }

// Launch one comm phase for all p co-resident ranks. recv and flags are
// device tables of p pointers (rank q's receive region and flags), status a
// device int[4]. Returns 0 on a launched kernel, -1 for a (kind, op, dtype)
// the kernel does not take, -3 when the ranks cannot all be resident, -4 when
// the device has no cooperative launch, else the CUDA error of the launch.
extern "C" int k2_spmd_comm(int kind, int op, int dtype, int inclusive, int p, long long M,
                            const void* x0, const void* x1, const void* x2, void* y0, void* y1,
                            void* y2, void* t0, void* t1, void* t2, void* recv, void* flags,
                            void* status, unsigned epoch, double timeout_s, void* stream) {
  const void* x[MAX_LEAVES] = {x0, x1, x2};
  void* y[MAX_LEAVES] = {y0, y1, y2};
  void* t[MAX_LEAVES] = {t0, t1, t2};
  if (dtype < 0 || dtype >= NUM_DTYPES || op < 0 || op >= NUM_OPS || kind < 0 || kind >= NUM_KINDS)
    return -1;
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return (int)err;
  const Launch c{*info, &info->per_sm[dtype][op][kind], static_cast<cudaStream_t>(stream)};
  const long long cycles = (long long)(timeout_s * 1e3 * (double)info->khz);
#define K2_ARGS(T) make_args<T>(p, M, inclusive, x, y, t, recv, flags, status, epoch, cycles), c
  switch (dtype) {
    case DT_FLOAT32: return launch_float_ops<float>(kind, op, K2_ARGS(float));
    case DT_BFLOAT16: return launch_float_ops<__nv_bfloat16>(kind, op, K2_ARGS(__nv_bfloat16));
    case DT_FLOAT16: return launch_float_ops<__half>(kind, op, K2_ARGS(__half));
    case DT_INT32: return launch_int_ops<int32_t>(kind, op, K2_ARGS(int32_t));
    case DT_INT8: return launch_int_ops<int8_t>(kind, op, K2_ARGS(int8_t));
    default: return -1;
  }
#undef K2_ARGS
}
