// K2: the per-rank collective kernel — every exchange round of one comm
// phase in one launch, each rank running its own program and putting its
// accumulator straight into its partner's memory.
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
// Two paths; spmd_collective.plan_launch picks one from p.
//
// The cluster path (2 <= p <= 16): the Hopper counterpart of the
// reference's make_async_remote_copy into the partner's buffer and its
// receive semaphore. One thread-block cluster of p CTAs handles one column
// tile; the CTA's rank in the cluster is the rank. The hardware schedules a
// cluster's CTAs together, so the grid covers every tile (p * tiles CTAs on
// grid.x) with no cooperative launch and no CTA walks a second tile.
//   * A CTA loads only its own rank's row of the tile into registers, 16
//     bytes a thread (one vector load where the rows are 16-byte aligned).
//   * Exchange e has its own receive slot [e][leaf][tile row] and its own
//     mbarrier in the receiving CTA's shared memory. A slot is written
//     once per launch, so no slot needs a handshake to say it is free.
//   * The sender writes its accumulator straight into the partner's slot
//     with st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 (mapa
//     gives the partner's addresses), one instruction per 16 bytes; the
//     bytes complete on the partner's barrier. (A bulk form, each thread
//     writing its 16 bytes into a staging row of its own shared memory and
//     one thread copying each leaf row with cp.async.bulk after a fence to
//     the async proxy and a CTA barrier, needed twice the shared memory and
//     timed up to 16% slower in PR 15's chip runs.) Every exchange is a full
//     permutation, so every CTA receives in every exchange, whole rows
//     (zeros past M), and each barrier is armed once for its slot's bytes.
//   * Order: barriers initialised and armed, fence.mbarrier_init, then a
//     cluster barrier (arrive.release, then the row loads, then
//     wait.acquire) before any put; the receiver's
//     try_wait.parity.acquire.cluster before it reads its slot; a cluster
//     barrier at the end (arrive.relaxed after the last receive, wait
//     after the stores), so no CTA exits while a peer may still address
//     its shared memory.
//   * No hang: every wait carries a clock64 deadline (about 2 s) and traps
//     past it. So this path has no status word, no host read after the
//     launch, no receive regions in device memory, no flags and no epoch.
//   Tile: 128 threads x V vectors of 16 bytes a rank row, V = 4 where it
//   fits (8 KiB rows: float32, int32, bf16, fp16 single-leaf operators), else
//   2 or 1 (cl::row_vecs). The largest case, FUSED at p = 16 with the
//   float32 flash operator (9 exchanges x 3 leaves, V = 2), needs 108 KiB
//   of slots a CTA, so two CTAs fit an SM's 228 KiB and a GPC of 16 SMs
//   holds two 16-CTA clusters; a SUM SCAN at p = 8 needs 24 KiB.
//   Bound: besides p*M*itemsize bytes read and written a leaf, the cluster
//   path moves exchanges x p x M x itemsize bytes a leaf through the
//   SM-to-SM network. On an H100 the exchanged bytes moved at 1.8-2.6 TB/s
//   (SCAN at p = 8 and 16 with 1 MiB a rank, ALLREDUCE at p = 8 with
//   25 MiB), and no tile shape, transport or barrier placement tried moved
//   the 1 MiB cases by more than 15%: that network, not HBM, bounds them.
//
// The flags path (p > 16, or p = 1): a rank's program is a set of thread
// blocks, each owning tiles of the rank's payload (a grid-stride loop over
// tiles). For exchange s of tile t, a block stores its accumulator tile into
// its partner's receive region for exchange s, through a table of p peer
// pointers (a symmetric layout: every rank's region has the same shape), then
// raises the partner's signal flag (s, t). Before it reads, the block waits on
// its own flag (s, t), then masks and combines.
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
//   * Ordering: data stores, __syncthreads(), a fence and a st.release on the
//     flag by one thread; the reader's ld.acquire spin, then __syncthreads(),
//     then L2 loads (ld.global.cg) of the received tile.
//   * No hang: every spin is bounded by a deadline. A block that times out
//     writes (code, rank, exchange, tile) into a device status word and
//     leaves; the other blocks of its launch see the word and leave too. The
//     wrapper reads the word after the launch and raises.
//   On one GPU all p ranks run in one launch (k2_flags_kernel, rank =
//   blockIdx.y), the peer tables point into one stacked allocation, and the
//   flags are released and acquired at .gpu scope.
//
// The peers path (one rank per process, any p): the same program, launched
// by each process for its own rank only (k2_peers_kernel, the rank passed
// in, grid.y = 1), its leaves the process's own. The peer tables hold, for
// every rank, an address in that rank's block of device memory, which the
// wrapper exports with cudaIpcGetMemHandle and every other process maps with
// cudaIpcOpenMemHandle (spmd_collective._PeerWorkspace); a rank's puts go
// straight into its partner's block. Its peers sit in other processes, on
// the same GPU or another, so:
//   * Scope: flags and done words are released and acquired at .sys scope,
//     data is fenced with __threadfence_system().
//   * Slot reuse across launches: the blocks are registered once and reused,
//     so a rank that has finished launch e may start launch e + 1 while a
//     partner still reads launch e. Each block holds two sets of flags and
//     receive regions, used by epoch parity, and a done word: a rank's launch
//     e first publishes done = e - 1 (its launch e - 1 has ended, so every
//     read of that launch is over), and a block waits, before its first put,
//     until each partner's done word is at least e - 2, the last launch that
//     used the parity set it is about to write. The rounds and the operand
//     order are the flags path's, so results are bitwise those of every
//     other K2 path.
//   * Deadline: %globaltimer, not clock64: the contexts of the processes on
//     one GPU are time-sliced, so a wait spans other processes' slices, and
//     a preempted block may resume on another SM, whose clock64 differs.
//   * Co-residency: the launch is cooperative, so all of a rank's blocks are
//     resident together; ranks on one GPU run in turns, each during its
//     context's time slice, and a spinning rank yields at the slice's end.
//   The same kernel and tables are the multi-GPU form: with each rank on its
//   own GPU, the mapped addresses lie in the peers' memory (NVLink, peer
//   access enabled lazily by cudaIpcOpenMemHandle).
//
// Bound: memory, like K1 (the same function): p*M*itemsize bytes read per
// leaf and written once per output stream. The cluster path's rounds stay in
// shared memory; the flags path's go through device memory (a put and a
// read per element) and a flag.

#include "collective_ops.cuh"

#include <cstring>
#include <mutex>

using namespace collective;

namespace {

enum Path { PATH_CLUSTER = 0, PATH_FLAGS = 1, PATH_PEERS = 2 };

// ---------------------------------------------------------------------------
// the flags path
// ---------------------------------------------------------------------------

constexpr int BLOCK = 256;  // threads per block
constexpr int VEC = 4;      // elements a thread carries per tile
constexpr int TILE = BLOCK * VEC;

enum Status { STATUS_OK = 0, STATUS_TIMEOUT = 1 };

template <typename T>
struct Args {
  const T* x[MAX_LEAVES];  // rank r's row at x + r*row (co-resident: stacked (p, M))
  T* y[MAX_LEAVES];        // the phase's output (the scan, or the total)
  T* t[MAX_LEAVES];        // FUSED only: the axis total
  T* const* recv;          // peer table: rank q's receive region [exchange][leaf][M]
  unsigned* const* flags;  // peer table: rank q's signal flags [exchange][tile]
  unsigned* const* done;   // peers path: peer table of the ranks' done words
  int* status;             // (code, rank, exchange, tile); all zero = fine
  long long M;             // elements per leaf and rank
  long long row;           // elements between two ranks' rows: M co-resident, 0 peers
  long long ntiles;        // tiles per leaf and rank
  long long timeout;       // clock64 cycles (flags path) or nanoseconds (peers path)
  unsigned epoch;          // this launch's flag value (never 0)
  unsigned done_need;      // peers path: a partner's done word before any put
  int p;                   // ranks
  int rank;                // peers path: this process's rank
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

// SYS: peers in other processes or on other GPUs (the peers path)
template <bool SYS>
__device__ __forceinline__ void signal_release(unsigned* flag, unsigned v) {
  if (SYS)
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

template <bool SYS>
__device__ __forceinline__ unsigned poll_acquire(const unsigned* flag) {
  unsigned v;
  if (SYS)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// the wait deadline's clock: clock64 cycles on one launch's SMs, the global
// nanosecond timer across time-sliced contexts
template <bool SYS>
__device__ __forceinline__ long long wait_clock() {
  if (!SYS) return clock64();
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return (long long)ns;
}

// A block gives up a wait: the first to time out writes (code, rank,
// exchange, tile) into the status word
__device__ __forceinline__ void time_out(int* status, int rank, int e, long long tile) {
  if (atomicCAS(status, STATUS_OK, STATUS_TIMEOUT) == STATUS_OK) {
    status[1] = rank;
    status[2] = e;
    status[3] = (int)tile;
    __threadfence();
  }
}

// One rank's program on the flags path (PEERS false: every rank in one
// launch, rank = blockIdx.y) or the peers path (PEERS true: one rank a
// launch, its partners in other processes)
template <typename T, class Op, int KIND, bool PEERS>
__device__ __forceinline__ void rank_program(const Args<T>& a, const int rank) {
  constexpr int L = Op::L;
  __shared__ int abort_block;
  const int p = a.p;
  const long long M = a.M;
  const T zero = Num<T>::zero();
  int nsteps = 0;
  while ((1 << nsteps) < p) ++nsteps;
  T* const own_recv = a.recv[rank];
  const unsigned* const own_flags = a.flags[rank];
  if (threadIdx.x == 0) {
    abort_block = 0;
    if (PEERS) {
      // launch e - 1 of this rank has ended (stream order): its reads of
      // the other parity set are over
      if (blockIdx.x == 0) signal_release<true>(a.done[rank], a.epoch - 1);
      // before the first put: every partner has ended the launch that last
      // used this parity set (exchange -1 in a timeout names this wait)
      if (a.done_need > 0) {
        auto wait_done = [&](int q) {
          const long long deadline = wait_clock<true>() + a.timeout;
          while (!abort_block && poll_acquire<true>(a.done[q]) < a.done_need) {
            if (*(volatile int*)a.status != STATUS_OK) abort_block = 1;
            if (wait_clock<true>() > deadline) {
              time_out(a.status, rank, -1, -1);
              abort_block = 1;
            }
            __nanosleep(64);
          }
        };
        if (KIND == KIND_BUTTERFLY) {
          for (int k = 0; k < nsteps; ++k) wait_done(rank ^ (1 << k));
        } else {
          for (int k = 0; k < nsteps; ++k) {
            wait_done((rank + (1 << k)) % p);
            if (KIND == KIND_FUSED) wait_done((rank - (1 << k) + p) % p);
          }
          if (!a.inclusive) wait_done((rank + 1) % p);
          if (KIND == KIND_FUSED && a.inclusive) wait_done((rank - 1 + p) % p);
        }
      }
    }
  }
  __syncthreads();
  if (abort_block) return;

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
        if (PEERS)
          __threadfence_system();
        else
          __threadfence();
        signal_release<PEERS>(a.flags[dst0] + (long long)e0 * a.ntiles + tile, a.epoch);
        if (dst1 >= 0) signal_release<PEERS>(a.flags[dst1] + (long long)e1 * a.ntiles + tile, a.epoch);
      }
    };
    // wait for exchange e of this tile, then read it into rv; false = abort
    auto receive = [&](int e) -> bool {
      if (threadIdx.x == 0) {
        const unsigned* flag = own_flags + (long long)e * a.ntiles + tile;
        const long long deadline = wait_clock<PEERS>() + a.timeout;
        while (poll_acquire<PEERS>(flag) != a.epoch) {
          if (*(volatile int*)a.status != STATUS_OK) {
            abort_block = 1;
            break;
          }
          if (wait_clock<PEERS>() > deadline) {
            time_out(a.status, rank, e, tile);
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
        const T xv = in_range(v) ? a.x[l][(long long)rank * a.row + base + (long long)v * BLOCK] : zero;
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
          if (in_range(v)) a.y[l][(long long)rank * a.row + base + (long long)v * BLOCK] = acc[0][l][v];
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
      const long long at = (long long)rank * a.row + base + (long long)v * BLOCK;
      for (int l = 0; l < L; ++l) {
        a.t[l][at] = res[l];
        a.y[l][at] = (a.inclusive || rank != 0) ? lhs[l] : zero;
      }
    }
  }
}

template <typename T, class Op, int KIND>
__global__ void __launch_bounds__(BLOCK) k2_flags_kernel(Args<T> a) {
  rank_program<T, Op, KIND, false>(a, blockIdx.y);
}

template <typename T, class Op, int KIND>
__global__ void __launch_bounds__(BLOCK) k2_peers_kernel(Args<T> a) {
  rank_program<T, Op, KIND, true>(a, a.rank);
}

// ---------------------------------------------------------------------------
// the cluster path
// ---------------------------------------------------------------------------

// The cluster path's design, and what lost to it on an H100 (PR 15's chip
// runs, float32 SUM, device us at SCAN p = 8 and 16 with 1 MiB a rank and
// ALLREDUCE p = 8 with 25 MiB; the shipped form 13.9-14.0, 30.3-30.6 and
// 242.8-267.7):
// * each cluster barrier is split, so that waiting on it overlaps other
//   work: the opening one around the loads, the closing one (relaxed: it
//   orders no memory) around the last combine and the stores. Arrive and
//   wait together took 15.2-15.3, 33.5-33.8 and 266.4-268.1;
// * one st.async (and one complete_tx on the partner's barrier) per 16
//   bytes a thread. One cp.async.bulk a leaf row from a staging row took
//   14.6-14.7, 35.1-35.3 and 271.1-271.9;
// * 128 threads a CTA (256 took 15.1, 33.1-33.4 and 271.7-274.1), each
//   carrying row_vecs vectors a leaf (one vector took 16.0-16.1, 36.7-36.9
//   and 384.0-385.2).

namespace cl {

constexpr int THREADS = 128;    // threads a CTA
constexpr int MAX_RANKS = 16;   // the largest (non-portable) cluster

// 16-byte vectors a thread carries a leaf (spmd_collective.cluster_row_vecs):
// the most of 4, 2, 1 that keeps L x V <= 6 (at p = 16 a fused phase's 9
// slots then take at most 108 KiB, so two CTAs share an SM) and the values a
// thread holds (two streams and the received vectors) within 96
template <typename T, int L>
__host__ __device__ constexpr int row_vecs() {
  int v = 4;
  while (v > 1 && (L * v > 6 || 3 * L * (16 / (int)sizeof(T)) * v > 96)) v /= 2;
  return v;
}

// one leaf of one rank row of a tile: V vectors of 16 bytes a thread
template <typename T, int L>
__host__ __device__ constexpr int row_bytes() {
  return THREADS * 16 * row_vecs<T, L>();
}

// A CTA's shared memory: one mbarrier (8 bytes) a slot, padded to 16 bytes;
// then slot e, leaf l at bar_bytes + (e * L + l) * row_bytes. A slot is
// written once per launch.
__host__ __device__ constexpr int bar_bytes(int slots) { return (8 * slots + 15) / 16 * 16; }
template <typename T, int L>
__host__ __device__ constexpr int smem_bytes(int slots) {
  return bar_bytes(slots) + slots * L * row_bytes<T, L>();
}

template <typename T>
struct Args {
  const T* x[MAX_LEAVES];  // stacked (p, M) inputs: rank r's row at x + r*M
  T* y[MAX_LEAVES];        // the phase's output (the scan, or the total)
  T* t[MAX_LEAVES];        // FUSED only: the axis total
  long long M;             // elements per leaf and rank
  long long timeout_cycles;
  int p;                   // ranks = CTAs of a cluster
  int slots;               // exchanges of the phase, one slot each
  int inclusive;
  int aligned;             // rows start on 16 bytes (M * itemsize too)
};

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}
// the address of the same shared-memory word in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// 16 bytes into a peer's shared memory; the store completes its bytes on the
// peer's barrier (release at cluster scope)
__device__ __forceinline__ void st_async(uint32_t remote, const uint4& w, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(remote),
      "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w), "r"(remote_bar)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(0u)
      : "memory");
  return done != 0;
}
// returns once the slot's bytes have all arrived (the barrier's first
// phase); a slot that waits past the deadline lost its sender: trap
__device__ __forceinline__ void wait_slot(uint32_t bar, long long timeout_cycles) {
  if (mbar_try_wait(bar)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar))
    if (clock64() - t0 > timeout_cycles) __trap();
}

template <typename T, class Op, int KIND>
__global__ void __launch_bounds__(THREADS, 1) k2_cluster_kernel(Args<T> a) {
  constexpr int L = Op::L;
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte vector
  constexpr int VECS = row_vecs<T, L>();
  constexpr int ROW_BYTES = row_bytes<T, L>();
  constexpr int TILE = THREADS * VEC * VECS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = a.p;
  const int rank = (int)cta_rank();
  const long long M = a.M;
  // vector j of this thread: columns col[j] .. col[j] + VEC of its rank's
  // row, bytes (j * THREADS + threadIdx.x) * 16 of a slot's leaf row
  long long col[VECS];
  bool vec_io[VECS];  // aligned: M % VEC == 0, so a vector lies below M or past it
  for (int j = 0; j < VECS; ++j) {
    col[j] = (long long)cluster_x() * TILE + (long long)(j * THREADS + threadIdx.x) * VEC;
    vec_io[j] = a.aligned && col[j] < M;
  }
  const T zero = Num<T>::zero();
  const uint32_t bars = smem_addr(smem);
  const int slot0 = bar_bytes(a.slots);
  int nsteps = 0;
  while ((1 << nsteps) < p) ++nsteps;

  if (threadIdx.x == 0) {
    // every slot is written once, whole: arm its barrier for all its bytes
    for (int e = 0; e < a.slots; ++e) {
      mbar_init(bars + 8 * e, 1);
      mbar_expect_tx(bars + 8 * e, L * ROW_BYTES);
    }
    fence_mbarrier_init();
  }
  // every peer's barriers are armed before any put
  cluster_arrive_release();

  T acc[2][L][VECS][VEC];  // [stream][leaf][vector][element]: stream 0 prefix, 1 suffix
  T rv[L][VECS][VEC];
  T lhs[L], rhs[L], res[L];
  for (int l = 0; l < L; ++l)
    for (int j = 0; j < VECS; ++j) {
      load_row<T, VEC>(a.x[l] + (long long)rank * M, col[j], M, vec_io[j], acc[0][l][j]);
      for (int v = 0; v < VEC; ++v) acc[1][l][j][v] = acc[0][l][j][v];
    }
  cluster_wait();

  // this thread's vectors of stream s, every leaf, straight into slot e of
  // rank dst
  auto put = [&](int s, int dst, int e) {
    for (int l = 0; l < L; ++l)
      for (int j = 0; j < VECS; ++j) {
        uint4 w;
        memcpy(&w, acc[s][l][j], sizeof(w));
        const int at = (e * L + l) * ROW_BYTES + (j * THREADS + threadIdx.x) * 16;
        st_async(mapa(bars + slot0 + at, dst), w, mapa(bars + 8 * e, dst));
      }
  };
  // wait for slot e, then read this thread's vectors of every leaf into rv
  auto receive = [&](int e) {
    wait_slot(bars + 8 * e, a.timeout_cycles);
    for (int l = 0; l < L; ++l)
      for (int j = 0; j < VECS; ++j) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            smem + slot0 + (e * L + l) * ROW_BYTES + (j * THREADS + threadIdx.x) * 16);
        memcpy(rv[l][j], &w, sizeof(w));
      }
  };
  // acc[s] = keep ? combine(rv, acc[s]) : combine(zero, acc[s])  (recv_left)
  //        or the mirror with recv on the right
  auto fold = [&](int s, bool keep, bool recv_left) {
    for (int j = 0; j < VECS; ++j)
      for (int v = 0; v < VEC; ++v) {
        for (int l = 0; l < L; ++l) {
          const T got = keep ? rv[l][j][v] : zero;
          lhs[l] = recv_left ? got : acc[s][l][j][v];
          rhs[l] = recv_left ? acc[s][l][j][v] : got;
        }
        Op::combine(lhs, rhs, res);
        for (int l = 0; l < L; ++l) acc[s][l][j][v] = res[l];
      }
  };
  auto store = [&](T* const* out, const T (&vals)[L][VECS][VEC]) {
    for (int l = 0; l < L; ++l)
      for (int j = 0; j < VECS; ++j)
        store_row<T, VEC>(out[l] + (long long)rank * M, col[j], M, vec_io[j], vals[l][j]);
  };

  int ex = 0;
  if (KIND == KIND_BUTTERFLY) {
    for (int k = 0; k < nsteps; ++k, ++ex) {
      const int d = 1 << k;
      put(0, rank ^ d, ex);
      receive(ex);
      fold(0, true, (rank & d) != 0);  // partner lower: combine(recv, acc)
    }
  } else {
    if (!a.inclusive) {
      // structural entry shift: rank r starts from x_{r-1}, rank 0 from zero
      put(0, (rank + 1) % p, ex);
      receive(ex);
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < VECS; ++j)
          for (int v = 0; v < VEC; ++v) acc[0][l][j][v] = rank >= 1 ? rv[l][j][v] : zero;
      ++ex;
    }
    for (int k = 0; k < nsteps; ++k) {
      const int d = 1 << k;
      const int up = (rank + d) % p, down = (rank - d + p) % p;
      put(0, up, ex);
      // full duplex: both streams' puts before either wait
      if (KIND == KIND_FUSED) put(1, down, ex + 1);
      receive(ex);
      fold(0, rank >= d, true);
      if (KIND == KIND_FUSED) {
        receive(ex + 1);
        fold(1, rank < p - d, false);
      }
      ex += KIND == KIND_FUSED ? 2 : 1;
    }
  }

  // After its last receive no peer addresses this CTA's shared memory: the
  // closing barrier (no CTA leaves while a peer may still write into its
  // slots) can be entered here and left at the end.
  if (KIND != KIND_FUSED) {
    cluster_arrive_relaxed();
    store(a.y, acc[0]);
  } else {
    // fused exits: inclusive total = combine(pre, suffix of rank r+1 or
    // zero); exclusive total = combine(pre, suf) and rank 0's scan is zero
    if (a.inclusive) {
      put(1, (rank - 1 + p) % p, ex);
      receive(ex);
    }
    cluster_arrive_relaxed();
    if (!a.inclusive) {
      for (int l = 0; l < L; ++l)
        for (int j = 0; j < VECS; ++j)
          for (int v = 0; v < VEC; ++v) rv[l][j][v] = acc[1][l][j][v];
    }
    const bool keep = a.inclusive ? rank < p - 1 : true;
    const bool scan_kept = a.inclusive || rank != 0;
    T tot[L][VECS][VEC];
    for (int j = 0; j < VECS; ++j)
      for (int v = 0; v < VEC; ++v) {
        for (int l = 0; l < L; ++l) {
          lhs[l] = acc[0][l][j][v];
          rhs[l] = keep ? rv[l][j][v] : zero;
        }
        Op::combine(lhs, rhs, res);
        for (int l = 0; l < L; ++l) {
          tot[l][j][v] = res[l];
          if (!scan_kept) acc[0][l][j][v] = zero;
        }
      }
    store(a.t, tot);
    store(a.y, acc[0]);
  }
  cluster_wait();  // no CTA leaves while a peer may still address its slots
}

}  // namespace cl

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr int NUM_DTYPES = 5, NUM_OPS = 6, NUM_KINDS = 3;

// exchanges one rank makes in a phase (spmd_collective.exchanges)
int exchanges(int kind, int p, int inclusive) {
  int steps = 0;
  while ((1 << steps) < p) ++steps;
  if (kind == KIND_BUTTERFLY) return steps;
  if (kind == KIND_SCAN) return steps + (inclusive ? 0 : 1);
  return 2 * steps + 1;
}

// What the launch needs to know of the device, queried once per device: the
// queries cost milliseconds a call, many times the kernel itself. Filled at
// each kernel instantiation's first launch: per_sm, the flags and peers
// kernels' resident blocks per SM by (kernel, dtype, op, kind); clusters,
// one more than the clusters of the cluster kernel that fit at once, by
// (dtype, op, kind, inclusive, p), 0 while unknown; smem, the dynamic shared
// memory the cluster kernel of (dtype, op, kind) may use so far.
struct DeviceInfo {
  int sms = 0, coop = 0, khz = 0;
  bool ready = false;
  int per_sm[2][NUM_DTYPES][NUM_OPS][NUM_KINDS] = {};
  int clusters[NUM_DTYPES][NUM_OPS][NUM_KINDS][2][cl::MAX_RANKS + 1] = {};
  int smem[NUM_DTYPES][NUM_OPS][NUM_KINDS] = {};
};

constexpr int MAX_DEVICES = 64;
std::mutex info_lock;  // ctypes drops the GIL: callers may race on the caches

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

// one launch as the entry received it, passed down every level below it
struct Call {
  int path, kind, op, dtype, inclusive, p, aligned, shared_bytes;
  long long M, tile, ntiles;
  long long timeout;  // clock64 cycles (cluster, flags) or nanoseconds (peers)
  const void* x[MAX_LEAVES];
  void* y[MAX_LEAVES];
  void* t[MAX_LEAVES];
  void* recv;
  void* flags;
  void* done;  // peers path only
  void* status;
  unsigned epoch, done_need;
  int rank;    // peers path only
  cudaStream_t stream;
  DeviceInfo* info;
  int* made;  // kernels launched, each counted once cudaGetLastError() passed it
};

int launched(const Call& c) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*c.made;
  return (int)err;
}

// the flags path (PEERS false: all p ranks, grid.y = p) or the peers path
// (PEERS true: this process's rank, grid.y = 1); both cooperative, grid.x
// capped at the blocks the device holds at once
template <typename T, class Op, int KIND, bool PEERS>
int launch_rank_program(const Call& c) {
  Args<T> a;
  for (int l = 0; l < MAX_LEAVES; ++l) {
    a.x[l] = static_cast<const T*>(c.x[l]);
    a.y[l] = static_cast<T*>(c.y[l]);
    a.t[l] = static_cast<T*>(c.t[l]);
  }
  a.recv = static_cast<T* const*>(c.recv);
  a.flags = static_cast<unsigned* const*>(c.flags);
  a.done = static_cast<unsigned* const*>(c.done);
  a.status = static_cast<int*>(c.status);
  a.M = c.M;
  a.row = PEERS ? 0 : c.M;
  a.ntiles = c.ntiles;
  a.timeout = c.timeout;
  a.epoch = c.epoch;
  a.done_need = c.done_need;
  a.p = c.p;
  a.rank = c.rank;
  a.inclusive = c.inclusive;
  const void* fn = PEERS ? reinterpret_cast<const void*>(&k2_peers_kernel<T, Op, KIND>)
                         : reinterpret_cast<const void*>(&k2_flags_kernel<T, Op, KIND>);
  int& per_sm = c.info->per_sm[PEERS ? 1 : 0][c.dtype][c.op][c.kind];
  {
    std::lock_guard<std::mutex> hold(info_lock);
    if (per_sm == 0) {
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BLOCK, 0);
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (!c.info->coop) return -4;
  const int ranks = PEERS ? 1 : a.p;  // ranks of this launch
  const long long resident = (long long)per_sm * c.info->sms;
  if (ranks > resident || ranks > 65535) return -3;  // ranks cannot all be resident
  long long per_rank = resident / ranks;
  if (per_rank > a.ntiles) per_rank = a.ntiles;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3((unsigned)per_rank, (unsigned)ranks), dim3(BLOCK), params, 0, c.stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch's error so later calls do not see it
    return (int)err;
  }
  return launched(c);
}

template <typename T, class Op, int KIND>
int launch_cluster(const Call& c) {
  cl::Args<T> a;
  for (int l = 0; l < MAX_LEAVES; ++l) {
    a.x[l] = static_cast<const T*>(c.x[l]);
    a.y[l] = static_cast<T*>(c.y[l]);
    a.t[l] = static_cast<T*>(c.t[l]);
  }
  a.M = c.M;
  a.timeout_cycles = c.timeout;
  a.p = c.p;
  a.slots = exchanges(c.kind, c.p, c.inclusive);
  a.inclusive = c.inclusive;
  a.aligned = c.aligned;
  if (c.tile != (long long)cl::row_bytes<T, Op::L>() / (long long)sizeof(T) ||
      c.shared_bytes != cl::smem_bytes<T, Op::L>(a.slots))
    return -1;
  const long long grid = (long long)c.p * c.ntiles;
  if (c.p < 2 || c.p > cl::MAX_RANKS || grid > 0x7fffffffLL) return -2;
  auto kernel = cl::k2_cluster_kernel<T, Op, KIND>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c.p;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(cl::THREADS);
  cfg.dynamicSmemBytes = (size_t)c.shared_bytes;
  cfg.stream = c.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> hold(info_lock);
    int& smem = c.info->smem[c.dtype][c.op][c.kind];
    if (smem < c.shared_bytes) {
      // clusters of 9-16 CTAs are beyond the portable 8, and above 48 KiB
      // dynamic shared memory needs the opt-in
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   c.shared_bytes);
      if (err != cudaSuccess) return (int)err;
      smem = c.shared_bytes;
    }
    int& fit = c.info->clusters[c.dtype][c.op][c.kind][c.inclusive ? 1 : 0][c.p];
    if (fit == 0) {
      int n = 0;
      cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
      }
      fit = n + 1;
    }
    if (fit == 1) return -3;  // no cluster of p CTAs can be resident
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return launched(c);
}

template <typename T, class Op>
int launch_op(const Call& c) {
  switch (c.path * NUM_KINDS + c.kind) {
    case PATH_CLUSTER * NUM_KINDS + KIND_SCAN: return launch_cluster<T, Op, KIND_SCAN>(c);
    case PATH_CLUSTER * NUM_KINDS + KIND_FUSED: return launch_cluster<T, Op, KIND_FUSED>(c);
    case PATH_CLUSTER * NUM_KINDS + KIND_BUTTERFLY: return launch_cluster<T, Op, KIND_BUTTERFLY>(c);
    case PATH_FLAGS * NUM_KINDS + KIND_SCAN: return launch_rank_program<T, Op, KIND_SCAN, false>(c);
    case PATH_FLAGS * NUM_KINDS + KIND_FUSED: return launch_rank_program<T, Op, KIND_FUSED, false>(c);
    case PATH_FLAGS * NUM_KINDS + KIND_BUTTERFLY:
      return launch_rank_program<T, Op, KIND_BUTTERFLY, false>(c);
    case PATH_PEERS * NUM_KINDS + KIND_SCAN: return launch_rank_program<T, Op, KIND_SCAN, true>(c);
    case PATH_PEERS * NUM_KINDS + KIND_FUSED: return launch_rank_program<T, Op, KIND_FUSED, true>(c);
    case PATH_PEERS * NUM_KINDS + KIND_BUTTERFLY:
      return launch_rank_program<T, Op, KIND_BUTTERFLY, true>(c);
    default: return -1;
  }
}

template <typename T>
int launch_float_ops(const Call& c) {
  switch (c.op) {
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
int launch_int_ops(const Call& c) {
  switch (c.op) {
    case OP_SUM: return launch_op<T, OpSum<T>>(c);
    case OP_PROD: return launch_op<T, OpProd<T>>(c);
    case OP_MAX: return launch_op<T, OpMax<T>>(c);
    case OP_MIN: return launch_op<T, OpMin<T>>(c);
    default: return -1;
  }
}

// fills what every entry shares; returns 0 or the entry's error
int begin(Call& c, int path, int kind, int op, int dtype, int inclusive, int p, long long M,
          long long tile, const void* x0, const void* x1, const void* x2, void* y0, void* y1,
          void* y2, void* t0, void* t1, void* t2, void* stream, int* launches) {
  *launches = 0;
  if (dtype < 0 || dtype >= NUM_DTYPES || op < 0 || op >= NUM_OPS || kind < 0 ||
      kind >= NUM_KINDS || p < 1 || M <= 0 || tile <= 0)
    return -1;
  DeviceInfo* info = nullptr;
  {
    std::lock_guard<std::mutex> hold(info_lock);
    cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return (int)err;
  }
  c = Call{};
  c.path = path;
  c.kind = kind;
  c.op = op;
  c.dtype = dtype;
  c.inclusive = inclusive;
  c.p = p;
  c.M = M;
  c.tile = tile;
  c.ntiles = (M + tile - 1) / tile;
  const void* x[MAX_LEAVES] = {x0, x1, x2};
  void* y[MAX_LEAVES] = {y0, y1, y2};
  void* t[MAX_LEAVES] = {t0, t1, t2};
  for (int l = 0; l < MAX_LEAVES; ++l) {
    c.x[l] = x[l];
    c.y[l] = y[l];
    c.t[l] = t[l];
  }
  c.stream = static_cast<cudaStream_t>(stream);
  c.info = info;
  c.made = launches;
  return 0;
}

int run(const Call& c) {
  switch (c.dtype) {
    case DT_FLOAT32: return launch_float_ops<float>(c);
    case DT_BFLOAT16: return launch_float_ops<__nv_bfloat16>(c);
    case DT_FLOAT16: return launch_float_ops<__half>(c);
    case DT_INT32: return launch_int_ops<int32_t>(c);
    case DT_INT8: return launch_int_ops<int8_t>(c);
    default: return -1;
  }
}

// cudaSetDevice(device) for the scope, the caller's device restored after
struct OnDevice {
  int before = -1;
  cudaError_t err;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&before);
    if (err == cudaSuccess) err = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (before >= 0) cudaSetDevice(before);
  }
};

}  // namespace

// Launch one comm phase for all p co-resident ranks on the path
// spmd_collective.plan_launch chose (0 cluster, 1 flags), whose tile and
// shared bytes the entry checks against its own. The flags path takes recv
// and flags, device tables of p pointers (rank q's receive region and
// flags), and status, a device int[4]; the cluster path takes none of them
// (null). aligned: every row of x, y and t starts on 16 bytes. Returns 0 on a
// launched kernel, -1 for a (path, kind, op, dtype), tile or shared size the
// kernels do not take, -2 for a grid they cannot cover, -3 when the ranks
// cannot all be resident, -4 when the device has no cooperative launch,
// else the CUDA error of the launch. *launches is set to the kernels
// launched, each counted once cudaGetLastError() has passed its launch.
extern "C" int k2_spmd_comm(int path, int kind, int op, int dtype, int inclusive, int p,
                            long long M, long long tile, int shared_bytes, int aligned,
                            const void* x0, const void* x1, const void* x2, void* y0, void* y1,
                            void* y2, void* t0, void* t1, void* t2, void* recv, void* flags,
                            void* status, unsigned epoch, double timeout_s, void* stream,
                            int* launches) {
  // the cluster path's tile and shared bytes depend on the type and
  // operator: launch_cluster checks them
  if (path == PATH_FLAGS) {
    if (tile != TILE || shared_bytes != 0) {
      *launches = 0;
      return -1;
    }
  } else if (path != PATH_CLUSTER) {
    *launches = 0;
    return -1;
  }
  Call c;
  const int rc = begin(c, path, kind, op, dtype, inclusive, p, M, tile, x0, x1, x2, y0, y1, y2,
                       t0, t1, t2, stream, launches);
  if (rc != 0) return rc;
  c.aligned = aligned;
  c.shared_bytes = shared_bytes;
  c.timeout = (long long)(timeout_s * 1e3 * (double)c.info->khz);
  c.recv = recv;
  c.flags = flags;
  c.status = status;
  c.epoch = epoch;
  return run(c);
}

// Launch one comm phase for this process's rank of p, one rank a process
// (the peers path). recv, flags and done are device tables of p pointers
// into the ranks' mapped blocks: rank q's receive region and flags of this
// launch's parity set, and q's done word; status is this process's device
// int[4]. The launch publishes done = epoch - 1 and waits, before its first
// put, for each partner's done word to reach done_need (0: no wait). Returns
// as k2_spmd_comm.
extern "C" int k2_spmd_peers(int kind, int op, int dtype, int inclusive, int p, int rank,
                             long long M, long long tile, const void* x0, const void* x1,
                             const void* x2, void* y0, void* y1, void* y2, void* t0, void* t1,
                             void* t2, void* recv, void* flags, void* done, void* status,
                             unsigned epoch, unsigned done_need, double timeout_s, void* stream,
                             int* launches) {
  if (tile != TILE || rank < 0 || rank >= p || epoch == 0) {
    *launches = 0;
    return -1;
  }
  Call c;
  const int rc = begin(c, PATH_PEERS, kind, op, dtype, inclusive, p, M, tile, x0, x1, x2, y0, y1,
                       y2, t0, t1, t2, stream, launches);
  if (rc != 0) return rc;
  c.timeout = (long long)(timeout_s * 1e9);  // %globaltimer nanoseconds
  c.recv = recv;
  c.flags = flags;
  c.done = done;
  c.status = status;
  c.epoch = epoch;
  c.done_need = done_need;
  c.rank = rank;
  return run(c);
}

// The peers path's blocks of device memory, shared between processes with
// legacy CUDA IPC. k2_ipc_alloc: a zeroed block of `bytes` on `device` and
// its cudaIpcMemHandle_t (64 bytes into `handle`); k2_ipc_open: another
// process's block mapped into this one (peer access enabled lazily, for a
// block on another GPU); k2_ipc_close: unmap it; k2_ipc_free: free this
// process's own block. Each returns the CUDA error (0 = success) and leaves
// the caller's current device as it was.
extern "C" int k2_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" int k2_ipc_alloc(int device, size_t bytes, void** ptr, void* handle) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  *ptr = nullptr;
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    if (*ptr != nullptr) cudaFree(*ptr);
    *ptr = nullptr;
    cudaGetLastError();
    return (int)err;
  }
  memcpy(handle, &h, sizeof(h));
  return 0;
}

extern "C" int k2_ipc_open(int device, const void* handle, void** ptr) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" int k2_ipc_close(int device, void* ptr) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t err = cudaIpcCloseMemHandle(ptr);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" int k2_ipc_free(int device, void* ptr) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t err = cudaFree(ptr);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
