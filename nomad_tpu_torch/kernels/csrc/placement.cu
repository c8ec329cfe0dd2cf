// Placement kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the jitted TPU kernel `place_task_group`
// (nomad_tpu/kernels/placement.py:345, jitted at :601): one task group's
// static feasibility mask, then M dependent steps of fit / ports /
// distinct_hosts / distinct_property → fused mean score → masked argmax
// with the preferred-node override → carry update, plus the optional
// explain reductions (stage counts, first-exhausted dimension, top-5 with
// their five score parts).
//
// K1 takes this route only where the lane route (csrc/lanes.cu, one
// launch, the program's rows in shared memory over a thread-block
// cluster) does not fit: kernels/placement.py `lane_route`. The two are
// bitwise equal. Two launches per program:
//   1. static_pass: one thread per node row. Constraint and affinity LUT
//      lookups (token −1 → V−1, clamped to V−1), node_ok/extra_mask/
//      sampled-candidate membership, the reserved-port bits with the
//      plan's released/consumed ports, the adjusted dyn_free, used0 =
//      used − Σ_d delta_res (a row's deltas summed first, subtracted
//      once), the job/tg counts, and the spread/distinct_property tokens.
//      Writes them to scratch the wrapper allocated.
//   2. scan_pass: ONE block of 1024 threads, each striding over the rows,
//      with the loop over the M steps inside the kernel. Per step every
//      row's ok/final/masked is computed with the same terms in the same
//      order as the reference (NEG_INF = -1e30, exp2f(x·log2 10), IEEE
//      division but for the constant 18, no FMA contraction: built with
//      -fmad=false), then a block argmax (larger value wins; on equal
//      values the lower row, as jnp.argmax), the preferred-node override,
//      and a one-thread carry update. Spread and distinct_property counts
//      live in shared memory.
//
// What bounds it on this card: latency, not bandwidth. Each step reads
// about 1.3 MB at N = 16384 (used, capacity, a few per-row vectors), and
// the M steps depend on each other through the carry, each ending in a
// block-wide reduction and barrier. One block per program uses one SM of
// 132: a whole card's bandwidth is out of reach, but there is no grid-wide
// synchronisation between steps and the carry never leaves the block.
// The trade: a lone program is slow (one SM's share of L2 bandwidth per
// step), while a batch of programs becomes a grid of such blocks for free
// — the chain/wave transports (chain.cu) launch one block per lane.
//
// The device code of both passes lives in place_core.cuh, shared with
// chain.cu.

#include "place_core.cuh"

namespace {

__global__ void static_pass(PlaceArgs A) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= A.n) return;
  static_row(A, n);
  static_row_carry(A, n);
}

__global__ void __launch_bounds__(SCAN_THREADS, 1) scan_pass(PlaceArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scan_program(A, smem_raw);
}

}  // namespace

extern "C" {

size_t nomad_place_args_size() { return sizeof(PlaceArgs); }

const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues both passes on `stream`; returns cudaGetLastError() (0 = ok).
int nomad_place_task_group(const PlaceArgs* args, void* stream) {
  PlaceArgs A = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (A.n <= 0 || A.r < 2) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  static_pass<<<(A.n + threads - 1) / threads, threads, 0, st>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t shm = smem_bytes(A);
  if (shm > 48 * 1024) {
    err = cudaFuncSetAttribute(scan_pass,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  scan_pass<<<1, SCAN_THREADS, shm, st>>>(A);
  return (int)cudaGetLastError();
}

}  // extern "C"
