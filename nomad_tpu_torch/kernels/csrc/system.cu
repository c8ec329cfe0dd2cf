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
//
// Design: one thread per node row, no shared memory, no reduction. The
// row helpers are K1's (place_core.cuh: lut_row_ok, used0_at,
// adjusted_dyn, ports_free_row), so the two kernels read a program the
// same way. The argument block is K1's PlaceArgs; only its cluster and
// program fields are read, and its scratch pointers may be null.
//
// What bounds it on this card: bytes, and at these sizes the launch.
// A row reads capacity and used (2·R·4 bytes), node_ok, dyn_free, the
// referenced attribute columns and port words, and writes two bytes:
// about 90 bytes a row, 1.5 MB at N = 16384, half a microsecond at
// 3.35 TB/s. The launch and the wrapper's ctypes call cost far more.

#include "place_core.cuh"

namespace {

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

const char* nomad_system_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues the pass on `stream`; returns cudaGetLastError() (0 = ok).
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
