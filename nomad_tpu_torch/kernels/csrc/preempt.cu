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
// Design: ONE LAUNCH a call, `rank_block`.
//   - The candidate table is compact: row n's entries are offsets[n] ..
//     offsets[n + 1], each a slot (distinct in its row, < A), a priority
//     and a usage row of R. The dense [N, A] table is the case of A
//     entries a row in slot order, with no offsets or slots (null).
//   - One warp a row. The warp rebuilds its row's A slots in shared
//     memory — priorities (absent slots INF_PRIO, as the dense table's
//     pads) and usage rows (an absent slot's usage is never read: the
//     walk stops at the first ineligible slot) — with coalesced loads,
//     then ranks them (lane i counts the slots that sort before slot i:
//     #{j : p_j < p_i, or p_j = p_i and j < i}, a stable argsort with no
//     data-dependent branches, the compares reading shared memory), writes
//     the permutation to shared memory and, coalesced, to `order`, and
//     walks the prefix over its shared copy, one resource a lane (R ≤
//     32), a warp vote deciding "fits" at each k. Sums are taken in
//     sorted order with -fmad=false, so every output equals the two-launch
//     route's (`nomad_preempt_rank`, below) bit for bit.
//   - Rows a block by shape alone (the wrapper's `preempt_layout`): up to
//     8 rows while they fit the default 48 KB (A = 32, R = 8: 1,280 bytes
//     a row), else one row a block with the shared-memory limit raised to
//     227 KB, else (a row larger than that) each warp keeps its row in its
//     own slice of a scratch buffer in device memory and walks rows in a
//     grid-stride loop over a grid of one block an SM.
//   - The argmax in the same launch: each block reduces its rows to one
//     (score, row, k) and writes it; the last block to finish (a
//     __threadfence, then an atomic ticket that the staged copy zeroes, so
//     no memset launch is needed) reduces the blocks' triples and writes
//     best_row, best_k and best_score, then zeroes the ticket again.
//   - The block copies its PlaceArgs from the staged argument block into
//     shared memory once, so a warp's reads of the program's dims and
//     pointers are shared-memory broadcasts.
//   Tensor cores and TMA do not serve this work: it has no product, and
//   its rows are small and vary in length.
//
// What bounds it on this card: bytes, and at these sizes latency. The
// candidate table is the bulk of the input: on the dense table A·(1 +
// R)·4 bytes a row, 18.9 MB at N = 16384, A = 32, R = 8; on the compact
// table (4 + 4 + 4R) bytes a real victim plus 4 bytes a row of offsets,
// about 4 MB at 100,000 victims; plus 4A bytes a row of order written.
// About 1–6 µs at 3.35 TB/s. The A² rank compares read shared memory.
//
// Kept beside it as the old route: `nomad_preempt_rank`, two launches —
// `rank_rows` (one warp a row, every read from device memory, `order`
// written and read back) and `best_row` (one block of 1024 threads
// striding over the rows).

#include "place_core.cuh"

extern "C" {

// One block's best row (and the call's, in the last block).
struct PreemptBest {
  float v;  // score (−1e30 infeasible)
  int row;  // node row
  int k;    // victims in its minimal prefix
};

// One launch of `rank_block`. The two sizes come first so the library
// can refuse a wrapper built against another layout before reading more.
struct PreemptRun {
  int run_size;         // sizeof(PreemptRun) as the wrapper lays it out
  int args_size;        // sizeof(PlaceArgs) as the wrapper lays it out
  int slots;            // A: a row's candidate slots, order's width
  int rows;             // rows (warps) a block
  int grid;             // blocks
  int smem;             // dynamic shared memory a block, bytes
  int on_chip;          // 1: a row's state in shared memory, 0: in scratch
  const int* offsets;   // i32[N + 1]: row n's entries; null: dense table
  const int* slot;      // i32[E]: an entry's slot (null: dense table)
  const float* prio;    // f32[E]: an entry's priority
  const float* usage;   // f32[E, R]: an entry's usage row
  int* order;           // i32[N, A]
  uint8_t* feasible;    // bool[N]
  float* scores;        // f32[N]
  int* best;            // i32[3]: best_row, best_k, best_score's bits
  PreemptBest* blocks;  // [grid]: each block's best
  unsigned* ticket;     // blocks finished; 0 at launch (the staged copy)
  float* scratch;       // off chip: A·(R + 2) words (rounded to 4) a warp
};

}  // extern "C"

namespace {

constexpr float INF_PRIO = 1e9f;
// structs/funcs.py PREEMPTION_SCORE_RATE / _ORIGIN, as f32
constexpr float SCORE_RATE = 0.0048f;
constexpr float SCORE_ORIGIN = 2048.0f;
constexpr int RANK_THREADS = 256;  // at most 8 rows (warps) a block
// the default dynamic shared memory of a block, and the opt-in limit
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 232448;
// the layout refuses a wrapper whose structs differ (not a CUDA error)
constexpr int ERR_LAYOUT = -1;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
// a block's shared memory before its rows: PlaceArgs, 32 bests, the flag
constexpr int HEAD_BYTES =
    align16((int)sizeof(PlaceArgs)) + align16(32 * (int)sizeof(PreemptBest)) +
    16;
// words of one row's state: A priorities, A order entries, A·R usages
__host__ __device__ inline int row_words(int slots, int r) {
  return (slots * (r + 2) + 3) & ~3;
}

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

// Steps 1, 3 and 4 for row n on one warp, once the row is ranked: `ord`
// the sorted slots, `pr` the slots' priorities, `us` their usage rows
// (slot-major, R a slot). Writes feasible[n] and scores[n]; lane 0
// returns the row's (score, n, k), k the minimal prefix's length (0
// when none fits).
__device__ PreemptBest walk_score(const PlaceArgs& A, int n, int lane,
                                  int S, const int* ord, const float* pr,
                                  const float* us, uint8_t* feasible,
                                  float* scores) {
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
    const int slot = ord[k];
    const float p = pr[slot];
    if (!(p < INF_PRIO)) break;  // this and every longer prefix ineligible
    psum = psum + p;
    float util = 0.0f;
    bool ok = true;
    if (has_r) {
      rel = rel + us[(size_t)slot * R + lane];
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
  PreemptBest out{NEG_INF, n, 0};
  if (lane == 0) {
    const bool any_fit = feas && k_fit >= 0;
    if (any_fit) {
      float net = max_p > 0.0f ? max_p + sum_p / fmaxf(max_p, 1.0f) : 0.0f;
      float pre = 1.0f / (1.0f + expf(SCORE_RATE * (net - SCORE_ORIGIN)));
      float total = fit_total(util_sel, util1, cap, cap1);
      float binpack = fminf(fmaxf(20.0f - total, 0.0f), 18.0f) * INV_18;
      out.v = (binpack + pre) / 2.0f;
      out.k = k_fit + 1;
    }
    feasible[n] = any_fit;
    scores[n] = out.v;
  }
  return out;
}

// larger score wins; on equal scores the lower row (jnp.argmax)
__device__ __forceinline__ PreemptBest pick(PreemptBest x, PreemptBest y) {
  return (y.v > x.v || (y.v == x.v && y.row < x.row)) ? y : x;
}

// the warp's best in lane 0
__device__ __forceinline__ PreemptBest warp_pick(PreemptBest b) {
  for (int off = 16; off > 0; off >>= 1) {
    PreemptBest o;
    o.v = __shfl_down_sync(FULL, b.v, off);
    o.row = __shfl_down_sync(FULL, b.row, off);
    o.k = __shfl_down_sync(FULL, b.k, off);
    b = pick(b, o);
  }
  return b;
}

// Row n on one warp with its state at `row` (shared memory, or the warp's
// scratch): rebuild the row's A slots, rank them, write `order`, walk.
__device__ PreemptBest rank_row(const PlaceArgs& A, const PreemptRun& run,
                                int n, int lane, float* row) {
  const int S = run.slots, R = A.r;
  float* pr = row;
  int* ord = reinterpret_cast<int*>(row + S);
  float* us = row + 2 * S;
  if (run.offsets == nullptr) {
    // dense: the row's A entries in slot order
    const float* p = run.prio + (size_t)n * S;
    const float* u = run.usage + (size_t)n * S * R;
    for (int i = lane; i < S; i += 32) pr[i] = p[i];
    for (int x = lane; x < S * R; x += 32) us[x] = u[x];
  } else {
    const int beg = run.offsets[n], cnt = run.offsets[n + 1] - beg;
    for (int i = lane; i < S; i += 32) pr[i] = INF_PRIO;  // absent slots
    __syncwarp();
    for (int e = lane; e < cnt; e += 32)
      pr[run.slot[beg + e]] = run.prio[beg + e];
    const float* u = run.usage + (size_t)beg * R;
    for (int x = lane; x < cnt * R; x += 32) {
      const int e = x / R;
      us[run.slot[beg + e] * R + (x - e * R)] = u[x];
    }
  }
  __syncwarp();

  // 2. stable rank sort over the row's copy
  for (int i = lane; i < S; i += 32) {
    const float pi = pr[i];
    int pos = 0;
    for (int j = 0; j < S; ++j) {
      const float pj = pr[j];
      pos += (pj < pi) || (pj == pi && j < i);
    }
    ord[pos] = i;
  }
  __syncwarp();  // orders the lanes' writes of `ord` before the reads
  int* order = run.order + (size_t)n * S;
  for (int k = lane; k < S; k += 32) order[k] = ord[k];

  return walk_score(A, n, lane, S, ord, pr, us, run.feasible, run.scores);
}

__global__ void __launch_bounds__(RANK_THREADS)
    rank_block(const PlaceArgs* __restrict__ args, PreemptRun run) {
  extern __shared__ __align__(16) unsigned char smem[];
  PlaceArgs& A = *reinterpret_cast<PlaceArgs*>(smem);
  PreemptBest* red =
      reinterpret_cast<PreemptBest*>(smem + align16((int)sizeof(PlaceArgs)));
  int* last = reinterpret_cast<int*>(smem + HEAD_BYTES - 16);
  {
    // the argument block, a word at a time (PlaceArgs is 8-byte aligned)
    const unsigned long long* src =
        reinterpret_cast<const unsigned long long*>(args);
    unsigned long long* dst = reinterpret_cast<unsigned long long*>(smem);
    for (int w = threadIdx.x; w < (int)(sizeof(PlaceArgs) / 8);
         w += blockDim.x)
      dst[w] = src[w];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = row_words(run.slots, A.r);
  const PreemptBest none{LOWEST, 0x7fffffff, 0};
  PreemptBest best = none;
  if (run.on_chip) {
    const int n = blockIdx.x * run.rows + warp;
    float* row = reinterpret_cast<float*>(smem + HEAD_BYTES) +
                 (size_t)warp * words;
    if (n < A.n) best = rank_row(A, run, n, lane, row);
  } else {
    const int w = blockIdx.x * run.rows + warp;
    float* row = run.scratch + (size_t)w * words;
    for (int n = w; n < A.n; n += gridDim.x * run.rows)
      best = pick(best, rank_row(A, run, n, lane, row));
  }

  // the block's best, then the ticket
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (warp == 0) {
    PreemptBest b = lane < run.rows ? red[lane] : none;
    b = warp_pick(b);
    if (lane == 0) {
      run.blocks[blockIdx.x] = b;
      __threadfence();  // the block's best is visible before its ticket
      *last = atomicAdd(run.ticket, 1u) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!*last) return;

  // the last block: the call's best over every block's
  __threadfence();
  PreemptBest b = none;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
    const PreemptBest* p = run.blocks + i;
    b = pick(b, PreemptBest{__ldcg(&p->v), __ldcg(&p->row), __ldcg(&p->k)});
  }
  b = warp_pick(b);
  __syncthreads();  // every warp has read red above
  if (lane == 0) red[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = lane < (int)(blockDim.x >> 5) ? red[lane] : none;
    b = warp_pick(b);
    if (lane == 0) {
      const bool found = b.v > NEG_INF;
      run.best[0] = found ? b.row : -1;
      run.best[1] = found ? b.k : 0;
      run.best[2] = __float_as_int(found ? b.v : 0.0f);
      *run.ticket = 0u;
    }
  }
}

// ---- the old route: two launches ----------------------------------------------

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

  const PreemptBest b = walk_score(A, n, lane, S, order, pr,
                                   usage + base * A.r, out.feasible,
                                   out.scores);
  if (lane == 0) out.kbuf[n] = b.k;
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

size_t nomad_preempt_run_size() { return sizeof(PreemptRun); }

size_t nomad_preempt_head_bytes() { return HEAD_BYTES; }

const char* nomad_preempt_error_string(int err) {
  if (err == ERR_LAYOUT)
    return "the wrapper's PreemptRun, PlaceArgs or shared-memory layout "
           "differs from the library's (rebuild csrc/preempt.cu)";
  return cudaGetErrorString((cudaError_t)err);
}

// On CUDA device `device` (made current for the call, the caller's
// restored after), on `stream`: the staged copy of `nbytes` from pinned
// host `src` to `dst` (the argument block first, then the ticket and
// whatever of the program, the cluster and the candidate table came from
// host arrays), then `rank_block` over run->grid blocks, then event
// `done` (when not null), which the wrapper waits on before it refills
// `src`. `host_args` is the argument block in host memory, whose dims
// check the layout. Returns ERR_LAYOUT when the wrapper's struct sizes or
// shared-memory plan differ from these, else the first CUDA error (0 =
// ok).
int nomad_preempt_stage_rank(int device, const PlaceArgs* host_args,
                             const void* src, void* dst, size_t nbytes,
                             const PlaceArgs* dev_args,
                             const PreemptRun* run, void* stream,
                             void* done) {
  if (run->run_size != (int)sizeof(PreemptRun) ||
      run->args_size != (int)sizeof(PlaceArgs))
    return ERR_LAYOUT;
  const PreemptRun R = *run;
  const PlaceArgs& H = *host_args;
  if (H.n <= 0 || H.r < 2 || H.r > 32 || R.slots <= 0 || R.rows < 1 ||
      R.rows > RANK_THREADS / 32 || R.grid < 1)
    return (int)cudaErrorInvalidValue;
  const long long need =
      HEAD_BYTES +
      (R.on_chip ? 4LL * R.rows * row_words(R.slots, H.r) : 0LL);
  if (R.smem != need || need > SMEM_MAX ||
      (R.on_chip && (long long)R.grid * R.rows < H.n) ||
      (!R.on_chip && R.scratch == nullptr))
    return ERR_LAYOUT;
  const cudaStream_t s = (cudaStream_t)stream;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R.smem > SMEM_DEFAULT)
    err = cudaFuncSetAttribute(rank_block,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               R.smem);
  if (err == cudaSuccess && nbytes)
    err = cudaMemcpyAsync(dst, src, nbytes, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) {
    rank_block<<<R.grid, R.rows * 32, R.smem, s>>>(dev_args, R);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && done)
    err = cudaEventRecord((cudaEvent_t)done, s);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// The old route: enqueues both launches on `stream`; returns
// cudaGetLastError() (0 = ok). prio f32[N, S], usage f32[N, S, R];
// outputs order i32[N, S], feasible u8[N], scores f32[N], kbuf i32[N]
// (scratch), and the three scalars.
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
