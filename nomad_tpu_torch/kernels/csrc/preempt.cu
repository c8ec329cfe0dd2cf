// Preemption ranking for Hopper (sm_90a), hand-written CUDA C++.
//
// K3 — replaces the jitted TPU kernel `preempt_rank`
// (nomad_tpu/kernels/preemption.py:62-151). Per node row, with A
// candidate victim slots (priority, usage row; ineligible slots and pads
// carry priority INF_PRIO = 1e9):
//   1. the row's constraint feasibility as the placement kernel sees it:
//      node_ok & extra_mask & every constraint LUT row, less
//      distinct_hosts collisions (the job's counts) and rows whose
//      distinct_property values are used up (the starting counts);
//   2. a stable sort of the slots by priority (victims cheapest first);
//   3. in sorted order, the prefix sums of the released resources and of
//      the eligible priorities, and the first prefix k whose release
//      admits the ask: (used0 − release) + ask ≤ cap in every dimension,
//      every slot of the prefix eligible;
//   4. the score of that prefix: the logistic preemption score of the net
//      priority max_p + sum_p / max(max_p, 1) (rank.go:747-783) and the
//      binpack fit at the post-eviction utilization (K1's fit_total),
//      averaged; −1e30 where no prefix fits or the row is infeasible;
// then the argmax over rows (on equal scores the lower row, as
// jnp.argmax). Outputs: the sort permutation order[N, A], feasible[N],
// scores[N], and best_row / best_k / best_score.
//
// Design: two launches.
//   - rank_rows: ONE WARP PER ROW. Lane i ranks slot i (and i+32, ...):
//     its sorted position is #{j : p_j < p_i, or p_j = p_i and j < i},
//     the permutation of a stable argsort with no data-dependent
//     branches (A ≈ 32 on the BASELINE cluster, so A² compares are 32 a
//     lane). The prefix walk then runs over the sorted positions in
//     order, one resource per lane (R ≤ 32), and a warp vote decides
//     "fits" at each k; the walk stops at the first fit or at the first
//     ineligible slot, after which no prefix can fit. Sums are taken in
//     slot order, as the reference's cumsum takes them (the values are
//     integers below 2^24, so any order would be exact in f32).
//   - best_row: one block of 1024 threads, each striding over the rows,
//     then a block argmax (place_core.cuh) over (score, row).
//   The one-hot einsums of the TPU kernel (which select one prefix
//   element) are direct reads here. Built with -fmad=false, so
//   (used0 − release) + ask, the net priority and the logistic round as
//   the plain PyTorch version does.
//
// What bounds it on this card: bytes, and at these sizes latency. The
// candidate table is the bulk of the input: A·(1 + R)·4 bytes a row,
// 18.9 MB at N = 16384, A = 32, R = 8, plus 4A bytes of order written;
// about 6 µs at 3.35 TB/s. The A² rank compares read the row's
// priorities from L1.

#include "place_core.cuh"

namespace {

constexpr float INF_PRIO = 1e9f;
// structs/funcs.py PREEMPTION_SCORE_RATE / _ORIGIN, as f32
constexpr float SCORE_RATE = 0.0048f;
constexpr float SCORE_ORIGIN = 2048.0f;

// Step 1: the placement kernel's mask without the scan's carry.
__device__ bool preempt_row_feasible(const PlaceArgs& A, int n) {
  bool feas = A.node_ok[n] && A.extra_mask[A.e == 1 ? 0 : n] &&
              lut_row_ok(A, n);
  if (A.j > 0) {
    float jc = 0.0f;
    for (int i = 0; i < A.j; ++i)
      if (A.jc_idx[i] == n) jc = jc + A.jc_val[i];
    feas = feas && !(*A.distinct_hosts && jc > 0.0f);
  }
  for (int q = 0; q < A.p; ++q) {
    int t = norm_tok(attr_at(A, n, A.dp_key_idx[q]), A.dv);
    bool row_ok = (A.dp_counts0[(size_t)q * A.dv + t] < A.dp_allowed[q] &&
                   t != A.dv - 1) || !A.dp_active[q];
    feas = feas && row_ok;
  }
  return feas;
}

struct RankOut {
  int* order;
  uint8_t* feasible;
  float* scores;
  int* kbuf;  // per row: victims in the minimal prefix (0 when none)
};

__global__ void rank_rows(PlaceArgs A, const float* prio, const float* usage,
                          int S, RankOut out) {
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= A.n) return;  // whole warps leave together
  const size_t base = (size_t)n * S;
  const float* pr = prio + base;
  int* order = out.order + base;

  // 2. stable rank sort
  for (int i = lane; i < S; i += 32) {
    const float pi = pr[i];
    int pos = 0;
    for (int j = 0; j < S; ++j) {
      const float pj = pr[j];
      pos += (pj < pi) || (pj == pi && j < i);
    }
    order[pos] = i;
  }
  __syncwarp();  // orders the lanes' writes of `order` before the reads

  // 1. constraint feasibility (lane 0), broadcast
  bool feas = lane == 0 ? preempt_row_feasible(A, n) : false;
  feas = __shfl_sync(FULL, feas, 0);

  // 3. prefix walk in sorted order, lane r holding resource r
  const int R = A.r;
  const bool has_r = lane < R;
  float used0 = 0.0f, cap = 0.0f, ask = 0.0f;
  if (has_r) {
    used0 = used0_at(A, n, lane);
    cap = A.capacity[(size_t)n * R + lane];
    ask = A.ask[lane];
  }
  float rel = 0.0f, psum = 0.0f, util_sel = 0.0f, max_p = 0.0f, sum_p = 0.0f;
  int k_fit = -1;
  for (int k = 0; k < S; ++k) {
    const int slot = order[k];
    const float p = pr[slot];
    if (!(p < INF_PRIO)) break;  // this and every longer prefix ineligible
    psum = psum + p;
    float util = 0.0f;
    bool ok = true;
    if (has_r) {
      rel = rel + usage[(base + slot) * R + lane];
      util = (used0 - rel) + ask;
      ok = util <= cap;
    }
    if (__all_sync(FULL, ok)) {
      k_fit = k;
      util_sel = util;
      max_p = p;  // sorted ascending: the prefix's last is its max
      sum_p = psum;
      break;
    }
  }
  const float util1 = __shfl_sync(FULL, util_sel, 1);
  const float cap1 = __shfl_sync(FULL, cap, 1);

  // 4. the score of the minimal prefix
  if (lane == 0) {
    const bool any_fit = feas && k_fit >= 0;
    float score = NEG_INF;
    if (any_fit) {
      float net = max_p > 0.0f ? max_p + sum_p / fmaxf(max_p, 1.0f) : 0.0f;
      float pre = 1.0f / (1.0f + expf(SCORE_RATE * (net - SCORE_ORIGIN)));
      float total = fit_total(util_sel, util1, cap, cap1);
      float binpack = fminf(fmaxf(20.0f - total, 0.0f), 18.0f) * INV_18;
      score = (binpack + pre) / 2.0f;
    }
    out.feasible[n] = any_fit;
    out.scores[n] = score;
    out.kbuf[n] = any_fit ? k_fit + 1 : 0;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
    best_row(int n_rows, const float* scores, const int* kbuf, int* best_idx,
             int* best_k, float* best_score) {
  __shared__ Best red[33];
  Best b{LOWEST, 0x7fffffff};
  for (int n = threadIdx.x; n < n_rows; n += blockDim.x)
    b = better(b, Best{scores[n], n});
  b = block_argmax(b, red);
  if (threadIdx.x == 0) {
    const bool found = b.v > NEG_INF;
    *best_idx = found ? b.i : -1;
    *best_k = found ? kbuf[b.i] : 0;
    *best_score = found ? b.v : 0.0f;
  }
}

}  // namespace

extern "C" {

size_t nomad_preempt_args_size() { return sizeof(PlaceArgs); }

const char* nomad_preempt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues both launches on `stream`; returns cudaGetLastError() (0 = ok).
// prio f32[N, S], usage f32[N, S, R]; outputs order i32[N, S],
// feasible u8[N], scores f32[N], kbuf i32[N] (scratch), and the three
// scalars.
int nomad_preempt_rank(const PlaceArgs* args, const float* prio,
                       const float* usage, int slots, int* order,
                       uint8_t* feasible, float* scores, int* kbuf,
                       int* best_idx, int* best_k, float* best_score,
                       void* stream) {
  const PlaceArgs A = *args;
  if (A.n <= 0 || A.r < 2 || A.r > 32 || slots <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256, rows_per_block = threads / 32;
  RankOut out{order, feasible, scores, kbuf};
  rank_rows<<<(A.n + rows_per_block - 1) / rows_per_block, threads, 0, st>>>(
      A, prio, usage, slots, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  best_row<<<1, SCAN_THREADS, 0, st>>>(A.n, scores, kbuf, best_idx, best_k,
                                      best_score);
  return (int)cudaGetLastError();
}

}  // extern "C"
