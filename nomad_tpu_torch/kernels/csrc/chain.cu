// Chain and wave placement kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the jitted TPU kernels of the batched server path
// (nomad_tpu/kernels/placement.py):
//   K4  `_chain_with_carry` (:754) with its callers `place_task_group_chain`
//       (:778), `place_packed_chain` (:802) and `place_table_chain` (:849),
//       whose static program halves `_assemble_table_batch` (:819) gathers
//       from the device program table: B programs in order, each placing
//       against the (used, dyn_free) carry its predecessors left;
//   K5  `place_table_wave` (:878): L lanes of such chains in parallel, the
//       lane carries folded into one by a bitwise owner-lane select, and
//       the rows more than one lane changed counted as collisions;
//   K6  `place_task_group_batch` (:945) and `place_packed_batch` (:744,
//       its fields unpacked by `_unpack_params`, :730): the vmap of K1 over
//       B independent programs against one snapshot. No program sees
//       another's placements, so a batch is a wave of B lanes of one
//       program each with no fold (`nomad_place_batch`): the static grid
//       over every program, then one scan block per program, B blocks on
//       the card's 132 SMs at once; each lane carry is its program's
//       new_used. The scan also updates the lane's dyn_free carry, which
//       nothing reads here. Per program it keeps N·R + N floats of carry
//       and about 40 bytes a row of scratch (≈ 1.2 MB at N = 16384,
//       R = 8); B ≤ 65535 (gridDim.y of the static grid).
//
// The programs arrive as an array of `PlaceArgs` in device memory, one per
// program, lane-major ([L][P]). The host builds them: each program field
// points straight into its table row (row base + the field's offset in the
// static spec), its dynamic row, or its slice of a stacked program — so
// nothing is gathered or unpacked on the device.
//
// Launches per dispatch:
//   1. chain_static: grid (rows / 256, L·P). The carry-free half of K1's
//      static pass (constraint and affinity LUTs, masks, tokens, counts,
//      reserved-port bits) for every program at once, into per-program
//      scratch. It depends on no earlier program.
//   2. chain_scan: one 1024-thread block per lane. The block copies the
//      view's (used, dyn_free) into the lane's carry, then runs its P
//      programs in order. Per program: the carry-dependent half of the
//      static pass (the dyn_free credit/debit of the plan's ports read
//      from the carry; the plan's resource deltas subtracted from the
//      carried used rows, a row's deltas summed first as in K1), K1's
//      M-step scan with the carried used as new_used, then the dyn_free
//      carry update `dyn -= placed · n_dyn` in f32, as at :770.
//   3. wave_fold (waves only): one thread per row. Lane l changed the row
//      if any of its used or dyn_free values differs from the view's; rows
//      changed by more than one lane add one to the collision count (an
//      integer atomic, so the count is exact); the row is copied bitwise
//      from the highest-numbered lane that changed it, else from the view —
//      the order of the `where` loop at :925-931, with no arithmetic.
//
// What bounds it on this card: as K1, latency. The programs of a lane are
// dependent, each program's M steps are dependent, and each step ends in a
// block-wide argmax; so a lane is one SM looping, and a chain of B programs
// takes about B times K1's scan. The wave puts its L lanes on L SMs, so it
// takes about as long as its longest lane. The bound on an H100 is far
// below that: at N = 16384, M = 16 a chain of 8 programs needs about
// 0.0025 ms (its ~1.7e8 fp32 operations at 67 TFLOP/s; the ~2 MB it must
// move, the view once, the programs and the carry out, take less at
// 3.35 TB/s), a wave of 3 lanes of 4 about 0.0035 ms (chip_smoke.py
// computes both from the run's inputs). A K6 batch runs its B scan blocks
// 132 at a time, one per SM (1024 threads and the launch bound allow one
// block an SM), so it takes about ceil(B / 132) times K1's scan; its
// bound is B times a program's operations, ≈ 0.0003 ms a program at
// N = 16384, M = 16.

#include "place_core.cuh"

extern "C" {

// One dispatch's lane buffers: the view's carry in, the lane carries, and
// (waves) the folded carry and collision count out.
struct LaneArgs {
  const float* used0;  // [n, r] the view's used
  const float* dyn0;   // [n]    the view's dyn_free
  int n, r;
  float* used_l;       // [lanes, n, r] lane carries
  float* dyn_l;        // [lanes, n]
  float* used_snap;    // [lanes·p, n, r] used after each program, or null
  float* used_f;       // [n, r] folded carry (waves)
  float* dyn_f;        // [n]
  int* collisions;     // [1], zeroed by the caller
};

}  // extern "C"

namespace {

__global__ void chain_static(const PlaceArgs* progs) {
  __shared__ __align__(16) PlaceArgs A;
  load_args(&A, progs + blockIdx.y);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= A.n) return;
  static_row(A, n);
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
chain_scan(const PlaceArgs* progs, int p_per_lane, LaneArgs L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) PlaceArgs A;
  const int lane = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int N = L.n, R = L.r;
  float* used_c = L.used_l + (size_t)lane * N * R;
  float* dyn_c = L.dyn_l + (size_t)lane * N;
  for (int i = tid; i < N * R; i += nt) used_c[i] = L.used0[i];
  for (int i = tid; i < N; i += nt) dyn_c[i] = L.dyn0[i];

  for (int b = 0; b < p_per_lane; ++b) {
    const int prog = lane * p_per_lane + b;
    __syncthreads();  // the carry and the previous program are settled
    load_args(&A, progs + prog);

    // carry-dependent half of the static pass
    for (int n = tid; n < N; n += nt) A.dyn[n] = adjusted_dyn(A, n, dyn_c[n]);
    for (int t = tid; t < A.d; t += nt) {
      const int row = A.delta_idx[t];
      if (row < 0 || row >= N) continue;
      bool first = true;
      for (int q = 0; q < t; ++q) first = first && A.delta_idx[q] != row;
      if (!first) continue;  // the row's first delta subtracts them all
      for (int r = 0; r < R; ++r) {
        float dsum = 0.0f;
        for (int i = 0; i < A.d; ++i)
          if (A.delta_idx[i] == row)
            dsum = dsum + A.delta_res[(size_t)i * R + r];
        used_c[(size_t)row * R + r] = used_c[(size_t)row * R + r] - dsum;
      }
    }
    __syncthreads();

    scan_program(A, smem_raw);  // ends with a barrier

    // dyn_free carry: dyn − placed · n_dyn on the rows this program took
    if (tid == 0) {
      const float n_dyn = *A.n_dyn;
      for (int i = 0; i < A.m; ++i) {
        const int row = A.sel_idx[i];
        if (row < 0) continue;
        bool first = true;
        float placed = 0.0f;
        for (int q = 0; q < A.m; ++q) {
          if (A.sel_idx[q] != row) continue;
          if (q < i) first = false;
          placed = placed + 1.0f;
        }
        if (first) dyn_c[row] = dyn_c[row] - placed * n_dyn;
      }
    }
    if (L.used_snap != nullptr) {
      __syncthreads();
      float* snap = L.used_snap + (size_t)prog * N * R;
      for (int i = tid; i < N * R; i += nt) snap[i] = used_c[i];
    }
  }
}

__global__ void wave_fold(LaneArgs L, int lanes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= L.n) return;
  const int N = L.n, R = L.r;
  int changed = 0, owner = -1;
  for (int l = 0; l < lanes; ++l) {
    const float* u = L.used_l + ((size_t)l * N + n) * R;
    bool c = L.dyn_l[(size_t)l * N + n] != L.dyn0[n];
    for (int r = 0; r < R; ++r) c = c || u[r] != L.used0[(size_t)n * R + r];
    if (c) {
      ++changed;
      owner = l;
    }
  }
  if (changed > 1) atomicAdd(L.collisions, 1);
  const float* src = owner >= 0 ? L.used_l + ((size_t)owner * N + n) * R
                                : L.used0 + (size_t)n * R;
  for (int r = 0; r < R; ++r) L.used_f[(size_t)n * R + r] = src[r];
  L.dyn_f[n] = owner >= 0 ? L.dyn_l[(size_t)owner * N + n] : L.dyn0[n];
}

}  // namespace

extern "C" {

size_t nomad_chain_args_size() { return sizeof(PlaceArgs); }

size_t nomad_chain_lane_args_size() { return sizeof(LaneArgs); }

const char* nomad_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues one dispatch on `stream`: the static grid over every program,
// the lane chains, and with fold != 0 the wave fold. `args0` is the host
// copy of program 0's arguments (every program shares its shapes, so its
// shared-memory size); `progs` the device array of lanes·p_per_lane
// arguments. Returns cudaGetLastError() (0 = ok).
int nomad_place_lanes(const PlaceArgs* args0, const void* progs, int lanes,
                      int p_per_lane, const LaneArgs* lane_args, int fold,
                      void* stream) {
  const PlaceArgs& A0 = *args0;
  const LaneArgs L = *lane_args;
  cudaStream_t st = (cudaStream_t)stream;
  if (A0.n <= 0 || A0.r < 2 || lanes <= 0 || p_per_lane <= 0 ||
      L.n != A0.n || L.r != A0.r || lanes * p_per_lane > 65535)
    return (int)cudaErrorInvalidValue;
  const PlaceArgs* dev = (const PlaceArgs*)progs;
  dim3 grid((A0.n + STATIC_THREADS - 1) / STATIC_THREADS, lanes * p_per_lane);
  chain_static<<<grid, STATIC_THREADS, 0, st>>>(dev);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t shm = smem_bytes(A0);
  if (shm + sizeof(PlaceArgs) > 48 * 1024) {
    err = cudaFuncSetAttribute(chain_scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  chain_scan<<<lanes, SCAN_THREADS, shm, st>>>(dev, p_per_lane, L);
  err = cudaGetLastError();
  if (err != cudaSuccess || !fold) return (int)err;
  wave_fold<<<(A0.n + STATIC_THREADS - 1) / STATIC_THREADS, STATIC_THREADS,
              0, st>>>(L, lanes);
  return (int)cudaGetLastError();
}

// K6: `b` independent programs against one snapshot, one lane each with
// no fold (see the header). Returns cudaGetLastError() (0 = ok).
int nomad_place_batch(const PlaceArgs* args0, const void* progs, int b,
                      const LaneArgs* lane_args, void* stream) {
  return nomad_place_lanes(args0, progs, b, 1, lane_args, 0, stream);
}

}  // extern "C"
