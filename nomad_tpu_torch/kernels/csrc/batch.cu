// K6's packed route on Hopper (sm_90a), hand-written CUDA C++: B
// independent placement programs against one snapshot of the view, each
// program's row state kept in shared memory.
//
// Replaces the jitted TPU kernel `place_packed_batch`
// (nomad_tpu/kernels/placement.py:744), the vmap of `place_task_group`
// (:345, scan step :440-566) over B programs that `place_task_group_batch`
// (:945) also runs, for the callers that read only (sel_idx, sel_score).
// `place_task_group_batch`, which returns every program's new_used,
// step-0 scores and explain, stays on chain.cu's `nomad_place_batch`.
//
// What bounds it: operations. A program computes each row's score terms
// once (≈ 64 operations a row at bench's dims), then each of its M·N row
// steps is a few table lookups, an add, a divide and a compare (≈ 9):
// ≈ 17 a row step in all, B·M·N row steps (lib/roofline.py `_onchip_ops`);
// at B = 4096, M = 8, N = 16384 about 0.14 ms at the card's fp32 rate,
// against ≈ 0.02 ms for the bytes it must move (the view once, the
// programs, the outputs).
//
// What the design does about it. The pooled route (chain.cu) wrote ≈ 31 B
// a row of static scratch a program to device memory and reloaded it, the
// carry slot and the lane scratch every step: ≈ 38 GB a dispatch of 4096
// programs, more than the 50 MB L2 holds, so ≈ 11 ms of memory traffic
// before any latency. Here one launch does it all and keeps nothing of a
// program in device memory:
//   - a persistent grid, min(B, resident blocks); block g takes programs
//     g, g + grid, ...;
//   - per program, the block runs the static pass for its rows straight
//     into shared memory: per row the prefix of the score sum that no step
//     changes (f32), its term count and the fit / distinct_hosts bits (one
//     byte), and the spread and distinct_property tokens (u8, or u16 past
//     256 values) — 7 B a row at bench's dims, 112 KiB at N = 16384. A
//     row that none of the program's lists (deltas, counts, port releases
//     and consumptions, sampled candidates) names takes a path without
//     list scans; the few rows they name are then recomputed from all
//     their terms. The pass still reads ≈ 190 B of the view a row (used,
//     capacity and the key columns of attrs, in 32-byte sectors) from L2,
//     ≈ 13 GB a dispatch of 4096: what holds it now;
//   - a step reads only shared memory in its row loop: the row's entry and
//     two tables built at the step's start from the counts, the spread
//     boost of each (spread row, token) and the distinct_property mask of
//     each (property, token);
//   - the rows a step changes — the row the previous step placed on and
//     this step's penalty rows — are recomputed from the view by one
//     thread each, the placed row from the view and the list of the
//     program's placements (its overlay);
//   - only sel_idx and sel_score, all that `place_packed_batch` returns,
//     are written.
// Every score is the pooled route's f32 expression on the same values in
// the same order (built with -fmad=false), so the results are bitwise
// those of `nomad_place_batch_pooled`. The view (used, dyn_free) is read,
// never copied; no scratch, carry or slot is allocated. The on-chip scan
// itself (the static pass, a step's start, a row's value) is onchip.cuh's,
// which the chain and wave lane route (lanes.cu) shares.

#include "onchip.cuh"

namespace {

// regions of the shared-memory layout, in order
enum OnchipRegion {
  O_ARGS, O_RED, O_PLACED, O_PEN, O_SCOUNTS, O_DCOUNTS, O_SPTAB,
  O_MINMAX, O_SEEN, O_DPTAB, O_PREFIX, O_META, O_STOK, O_DTOK, O_END
};

// The byte offset of each region (off[O_END]: the whole layout); every
// region starts on a 16-byte boundary. `onchip_layout` in
// kernels/placement.py reckons the same.
__host__ __device__ inline void onchip_offsets(const PlaceArgs& A,
                                               size_t* off) {
  const size_t n = (size_t)A.n;
  size_t bytes[O_END];
  bytes[O_ARGS] = sizeof(PlaceArgs);
  bytes[O_RED] = 33 * sizeof(Best);
  bytes[O_PLACED] = (size_t)A.m * 4;
  bytes[O_PEN] = (size_t)A.pn * sizeof(PenRow);
  bytes[O_SCOUNTS] = (size_t)A.s * A.sv * 4;
  bytes[O_DCOUNTS] = (size_t)A.p * A.dv * 4;
  bytes[O_SPTAB] = (size_t)A.s * A.sv * 4;
  bytes[O_MINMAX] = (size_t)A.s * 2 * 4;
  bytes[O_SEEN] = (size_t)A.s;
  bytes[O_DPTAB] = (size_t)A.p * A.dv;
  bytes[O_PREFIX] = n * 4;
  bytes[O_META] = n;
  bytes[O_STOK] = (size_t)A.s * n * tok_bytes(A.sv);
  bytes[O_DTOK] = (size_t)A.p * n * tok_bytes(A.dv);
  size_t b = 0;
  for (int i = 0; i < O_END; ++i) {
    off[i] = b;
    b = (b + bytes[i] + 15) & ~(size_t)15;
  }
  off[O_END] = b;
}

__device__ OnchipSmem onchip_carve(const PlaceArgs& A, unsigned char* base) {
  size_t off[O_END + 1];
  onchip_offsets(A, off);
  OnchipSmem S;
  S.red = (Best*)(base + off[O_RED]);
  S.placed = (int*)(base + off[O_PLACED]);
  S.pen = (PenRow*)(base + off[O_PEN]);
  S.scounts = (float*)(base + off[O_SCOUNTS]);
  S.dcounts = (float*)(base + off[O_DCOUNTS]);
  S.sptab = (float*)(base + off[O_SPTAB]);
  S.minc = (float*)(base + off[O_MINMAX]);
  S.maxc = S.minc + A.s;
  S.seen = base + off[O_SEEN];
  S.dptab = base + off[O_DPTAB];
  S.prefix = (float*)(base + off[O_PREFIX]);
  S.meta = base + off[O_META];
  S.stok = base + off[O_STOK];
  S.dtok = base + off[O_DTOK];
  S.swide = tok_bytes(A.sv) == 2;
  S.dwide = tok_bytes(A.dv) == 2;
  S.exh = nullptr;
  S.row0 = 0;
  S.rows = A.n;
  S.overlay = nullptr;
  S.carry_used = S.carry_dyn = nullptr;
  S.spec = nullptr;
  return S;
}

// K6's packed route: `gridDim.x` blocks (the resident ones), block g
// running programs g, g + gridDim.x, ... with `smem_raw` of
// onchip_offsets(...)[O_END] bytes.
__global__ void __launch_bounds__(SCAN_THREADS, 1)
batch_onchip(const PlaceArgs* progs, int b_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PlaceArgs& A = *(PlaceArgs*)smem_raw;
  const int tid = threadIdx.x;
  for (int prog = blockIdx.x; prog < b_total; prog += gridDim.x) {
    __syncthreads();  // the previous program is done with A and the rows
    load_args(&A, progs + prog);
    const OnchipSmem S = onchip_carve(A, smem_raw);
    const ScanConsts C = scan_consts(A);
    onchip_static(A, C, S);
    for (int step = 0; step < A.m; ++step) {
      onchip_begin_step(A, C, S, step);
      Best best{LOWEST, 0x7fffffff};
      for (int n = tid; n < A.n; n += blockDim.x)
        best = better(best, Best{onchip_value(A, S, n).masked, n});
      best = block_argmax(best, S.red);
      if (tid == 0) {
        int idx = best.i;
        const int pref = A.preferred_idx[step];
        if (pref >= 0 && pref < A.n && onchip_value(A, S, pref).ok) idx = pref;
        const RowVal v = onchip_value(A, S, idx);
        const bool found = v.ok && step < C.n_place;
        A.sel_idx[step] = found ? idx : -1;
        A.sel_score[step] = found ? v.masked : 0.0f;
        S.placed[step] = found ? idx : -1;
        if (found) {
          const size_t N = (size_t)A.n;
          for (int s = 0; s < A.s; ++s) {
            int t = tok_get(S.stok, S.swide, s * N + idx);
            if (t != A.sv - 1) S.scounts[s * A.sv + t] += 1.0f;
          }
          for (int q = 0; q < A.p; ++q) {
            int t = tok_get(S.dtok, S.dwide, q * N + idx);
            if (t != A.dv - 1) S.dcounts[q * A.dv + t] += 1.0f;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

size_t nomad_batch_args_size() { return sizeof(PlaceArgs); }

const char* nomad_batch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes a block of batch_onchip takes for programs shaped
// like `args0`.
size_t nomad_batch_onchip_smem(const PlaceArgs* args0) {
  size_t off[O_END + 1];
  onchip_offsets(*args0, off);
  return off[O_END];
}

// Enqueues K6's packed route for `b` programs on `stream`: one launch of
// batch_onchip, 512 threads a block where two blocks fit an SM (`sms` of
// them), else 1024. `args0` is program 0's host arguments (every program
// shares its shapes); `progs` the device array of b arguments; `config`
// gets (blocks, threads). Returns cudaGetLastError() (0 = ok).
int nomad_place_batch_onchip(const PlaceArgs* args0, const void* progs, int b,
                             int sms, void* stream, int* config) {
  const PlaceArgs& A0 = *args0;
  if (A0.n <= 0 || A0.r < 2 || b <= 0 || sms <= 0 || A0.sv > 65536 ||
      A0.dv > 65536)
    return (int)cudaErrorInvalidValue;
  const size_t shm = nomad_batch_onchip_smem(args0);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)batch_onchip, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  int threads = 512, per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)batch_onchip, threads, shm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 2) {
    threads = SCAN_THREADS;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)batch_onchip, threads, shm);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  const long long resident = (long long)per_sm * sms;
  const int grid = (int)(b < resident ? b : resident);
  config[0] = grid;
  config[1] = threads;
  batch_onchip<<<grid, threads, shm, (cudaStream_t)stream>>>(
      (const PlaceArgs*)progs, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
