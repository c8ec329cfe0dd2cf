// System-scheduler masks for Hopper (sm_90a), hand-written CUDA C++.
//
// K2 — replaces the jitted TPU kernel `system_feasibility`
// (nomad_tpu/kernels/placement.py:957-976): per node row, whether the
// task group's constraints admit it, and whether it also fits —
//   feas = node_ok & extra_mask & every constraint LUT row
//   fit  = feas & all_r(used0 + ask ≤ cap) & (adjusted dyn_free ≥ n_dyn)
//               & every reserved port free
// where used0 = used − Σ delta_res over the row's plan deltas and the
// dyn_free and port bits carry the plan's released and consumed ports.
// No ranking across nodes: the system scheduler places one alloc per
// node, and the gap between the masks is its preemption candidate set.
// B12 — the same function on a node-sharded view (the reference's server
// under a mesh, nomad_tpu/scheduler/system.py:235-236).
//
// `system_rows` serves both: one launch covers every node shard of one
// card. Its argument blocks are K1's PlaceArgs, one a shard, each holding
// the shard's cluster pointers moved back by the shard's first global row
// (row0), so that global row g of the shard lies g rows past every
// cluster pointer; the program's fields stay global (delta_idx, pclr_idx,
// pset_idx and a node-width extra_mask are indexed by global row), so no
// field is rebased. Grid y is the argument block, grid x the shard's rows,
// one thread a row; each thread writes its global row's two bytes into
// one bool [2, n] buffer (row 0 feasible, row 1 feasible-and-fits). K2 is
// one argument block with row0 0.
//
// The row arithmetic is K1's (place_core.cuh: lut_row_ok, used0_of,
// adjusted_dyn, ports_free_row) under -fmad=false, so the masks equal
// `system_pass`'s (below, the one-program pass it replaces, kept so the
// two can be held and timed against each other) bit for bit.
//
// What bounds it on this card: bytes, and at these sizes the launch and
// the host. A row reads capacity and used (2·R·4 bytes), node_ok,
// dyn_free, extra_mask, the referenced attribute columns and port words,
// and writes two bytes: about 90 bytes a row, 1.5 MB at N = 16384, half a
// microsecond at 3.35 TB/s. What the design does about the rest:
//   - a block copies its argument block and the program's small fields
//     (ask, n_dyn, key_idx, the reserved and released/consumed port
//     lists, the constraint LUT rows and the plan deltas, each while the
//     block's 48 KB budget lasts) into shared memory once and points the
//     copied PlaceArgs at them, so a thread's repeated reads of the
//     program are shared-memory broadcasts, not global loads;
//   - at R = 8 a row's capacity and used are two float4 loads each, a
//     warp's 32 rows one contiguous kilobyte;
//   - the block is sized to the shard's rows (at most 256 threads, whole
//     warps), so a shard of 16 rows takes one warp and a card's shards
//     one launch, whatever their count;
//   - the wrapper sends the argument blocks and, for a program still in
//     host memory, the twelve fields this kernel reads (the others stay
//     null) in one staged copy, enqueued with the launch in one library
//     call, and reads the two masks back in one.

#include <stdint.h>

#include "place_core.cuh"

extern "C" {

// One launch of `system_rows`. The two sizes come first so the library
// can refuse a wrapper built against another layout before reading more.
struct SystemRun {
  int run_size;     // sizeof(SystemRun) as the wrapper lays it out
  int args_size;    // sizeof(PlaceArgs) as the wrapper lays it out
  int blocks;       // argument blocks: the card's node shards
  int rows;         // rows a shard
  int n;            // global rows: the width of `out`
  const int* row0;  // device: the first global row of each argument block
  uint8_t* out;     // device: bool [2, n]; row 0 feasible, row 1 fits
};

}  // extern "C"

namespace {

constexpr int SYSTEM_THREADS = 256;
// dynamic shared memory a block stages into: the default limit, so no
// opt-in attribute is needed
constexpr int STAGE_BYTES = 48 * 1024;
// the layout refuses a wrapper whose structs differ (not a CUDA error)
constexpr int ERR_LAYOUT = -1;

// Byte offsets of the staged program fields in a block's shared memory
// (the argument block first, at 0); −1 leaves a field in global memory.
struct StagePlan {
  int ask, n_dyn, key_idx, res_ports, pclr_idx, pclr_port, pset_idx,
      pset_port, lut, delta_idx, delta_res;
  int total;
};

int align16(int x) { return (x + 15) & ~15; }

// Fields in the order they are staged, while the budget lasts: the small
// ones every row reads first, then the LUT rows, then the plan deltas.
StagePlan stage_plan(const PlaceArgs& A) {
  StagePlan P;
  int off = align16((int)sizeof(PlaceArgs));
  auto take = [&](long long bytes) {
    if (bytes <= 0 || off + bytes > STAGE_BYTES) return -1;
    const int at = off;
    off = align16(off + (int)bytes);
    return at;
  };
  P.ask = take(4LL * A.r);
  P.n_dyn = take(4);
  P.key_idx = take(4LL * A.c);
  P.res_ports = take(4LL * A.pp);
  P.pclr_idx = take(4LL * A.pc);
  P.pclr_port = take(4LL * A.pc);
  P.pset_idx = take(4LL * A.ps);
  P.pset_port = take(4LL * A.ps);
  P.lut = take((long long)A.c * A.v);
  P.delta_idx = take(4LL * A.d);
  P.delta_res = take(4LL * A.d * A.r);
  P.total = off;
  return P;
}

// Copy `count` elements of `src` into shared memory at `off` and, from
// thread 0, point `field` of the block's PlaceArgs copy at them.
template <typename T>
__device__ __forceinline__ void stage(const T*& field, const T* src,
                                      long long count, int off,
                                      unsigned char* smem) {
  if (off < 0) return;
  T* dst = reinterpret_cast<T*>(smem + off);
  for (long long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  if (threadIdx.x == 0) field = dst;
}

// Row n fits: every resource's used0 + ask ≤ capacity (used0 the row's
// used minus its plan deltas, summed in delta order, subtracted once),
// the adjusted dynamic ports cover n_dyn, and every reserved port is
// free. At R = 8 with 16-byte aligned rows the row's capacity and used
// are read as two float4 each; the arithmetic is the scalar loop's.
__device__ __forceinline__ bool fits_row(const PlaceArgs& A, int n) {
  bool fits = true;
  const bool vec =
      A.r == 8 && ((reinterpret_cast<uintptr_t>(A.capacity) |
                    reinterpret_cast<uintptr_t>(A.used)) & 15) == 0;
  if (vec) {
    const float4* c4 =
        reinterpret_cast<const float4*>(A.capacity) + 2 * (size_t)n;
    const float4* u4 =
        reinterpret_cast<const float4*>(A.used) + 2 * (size_t)n;
    const float4 c0 = c4[0], c1 = c4[1], u0 = u4[0], u1 = u4[1];
    const float cap[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float used[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float util = used0_of(A, used, n, r) + A.ask[r];
      if (!(util <= cap[r])) fits = false;
    }
  } else {
    for (int r = 0; r < A.r; ++r) {
      float util = used0_at(A, n, r) + A.ask[r];
      if (!(util <= A.capacity[(size_t)n * A.r + r])) fits = false;
    }
  }
  return fits && adjusted_dyn(A, n, A.dyn_free[n]) >= *A.n_dyn &&
         ports_free_row(A, n);
}

__global__ void __launch_bounds__(SYSTEM_THREADS)
    system_rows(const PlaceArgs* __restrict__ args, SystemRun run,
                StagePlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  PlaceArgs& A = *reinterpret_cast<PlaceArgs*>(smem);
  const PlaceArgs& G = args[blockIdx.y];
  // the argument block, a word at a time (PlaceArgs is 8-byte aligned)
  {
    const unsigned long long* src =
        reinterpret_cast<const unsigned long long*>(&G);
    unsigned long long* dst = reinterpret_cast<unsigned long long*>(smem);
    for (int w = threadIdx.x; w < (int)(sizeof(PlaceArgs) / 8);
         w += blockDim.x)
      dst[w] = src[w];
  }
  __syncthreads();
  // the program's small fields, read from the global block; thread 0
  // repoints the copy (no thread reads it until the barrier)
  stage(A.ask, G.ask, G.r, plan.ask, smem);
  stage(A.n_dyn, G.n_dyn, 1, plan.n_dyn, smem);
  stage(A.key_idx, G.key_idx, G.c, plan.key_idx, smem);
  stage(A.res_ports, G.res_ports, G.pp, plan.res_ports, smem);
  stage(A.pclr_idx, G.pclr_idx, G.pc, plan.pclr_idx, smem);
  stage(A.pclr_port, G.pclr_port, G.pc, plan.pclr_port, smem);
  stage(A.pset_idx, G.pset_idx, G.ps, plan.pset_idx, smem);
  stage(A.pset_port, G.pset_port, G.ps, plan.pset_port, smem);
  stage(A.lut, G.lut, (long long)G.c * G.v, plan.lut, smem);
  stage(A.delta_idx, G.delta_idx, G.d, plan.delta_idx, smem);
  stage(A.delta_res, G.delta_res, (long long)G.d * G.r, plan.delta_res, smem);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= run.rows) return;
  const int g = run.row0[blockIdx.y] + i;
  const bool feas = A.node_ok[g] && A.extra_mask[A.e == 1 ? 0 : g] &&
                    lut_row_ok(A, g);
  const bool fit = feas && fits_row(A, g);
  run.out[g] = feas;
  run.out[(size_t)run.n + g] = fit;
}

// The one-program pass `system_rows` replaced: one thread per row of a
// PlaceArgs passed by value, a fixed 256-thread block, every program
// field read from global memory. Kept as the old route.
__global__ void system_pass(PlaceArgs A, uint8_t* feas_out,
                            uint8_t* fit_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= A.n) return;
  const bool feas = A.node_ok[n] && A.extra_mask[A.e == 1 ? 0 : n] &&
                    lut_row_ok(A, n);
  bool fits = true;
  for (int r = 0; r < A.r; ++r) {
    float util = used0_at(A, n, r) + A.ask[r];
    if (!(util <= A.capacity[(size_t)n * A.r + r])) fits = false;
  }
  fits = fits && adjusted_dyn(A, n, A.dyn_free[n]) >= *A.n_dyn &&
         ports_free_row(A, n);
  feas_out[n] = feas;
  fit_out[n] = feas && fits;
}

}  // namespace

extern "C" {

size_t nomad_system_args_size() { return sizeof(PlaceArgs); }

size_t nomad_system_run_size() { return sizeof(SystemRun); }

const char* nomad_system_error_string(int err) {
  if (err == ERR_LAYOUT)
    return "the wrapper's SystemRun or PlaceArgs layout differs from the "
           "library's (rebuild csrc/system.cu)";
  return cudaGetErrorString((cudaError_t)err);
}

// On CUDA device `device` (made current for the call, the caller's
// restored after), on `stream`: the staged copy of `nbytes` from pinned
// host `src` to `dst` (the argument blocks at `dev_args` and a numpy
// program's bytes; none when nbytes is 0), then `system_rows` over
// run->blocks argument blocks, then event `done` (when not null), which
// the wrapper waits on before it refills `src`. `host_args` is the first
// block in host memory, whose dims (every block shares them) size the
// staging. Returns ERR_LAYOUT when the wrapper's struct sizes differ from
// these, else the first CUDA error (0 = ok).
int nomad_system_masks(int device, const PlaceArgs* host_args,
                       const void* src, void* dst, size_t nbytes,
                       const PlaceArgs* dev_args, const SystemRun* run,
                       void* stream, void* done) {
  if (run->run_size != (int)sizeof(SystemRun) ||
      run->args_size != (int)sizeof(PlaceArgs))
    return ERR_LAYOUT;
  const SystemRun R = *run;
  if (R.blocks <= 0 || R.blocks > 65535 || R.rows <= 0 || R.n <= 0 ||
      host_args->r < 1)
    return (int)cudaErrorInvalidValue;
  const StagePlan plan = stage_plan(*host_args);
  const int warps = (R.rows + 31) / 32 * 32;
  const int threads = warps < SYSTEM_THREADS ? warps : SYSTEM_THREADS;
  const dim3 grid((R.rows + threads - 1) / threads, R.blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nbytes)
    err = cudaMemcpyAsync(dst, src, nbytes, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) {
    system_rows<<<grid, threads, plan.total, s>>>(dev_args, R, plan);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && done)
    err = cudaEventRecord((cudaEvent_t)done, s);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// Enqueues the old pass on `stream`; returns cudaGetLastError() (0 = ok).
int nomad_system_feasibility(const PlaceArgs* args, uint8_t* feas_out,
                             uint8_t* fit_out, void* stream) {
  const PlaceArgs A = *args;
  if (A.n <= 0 || A.r < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  system_pass<<<(A.n + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>(A, feas_out, fit_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
