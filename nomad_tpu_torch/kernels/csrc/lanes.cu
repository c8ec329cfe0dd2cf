// Chain and wave placement on Hopper (sm_90a), the lane route:
// hand-written CUDA C++, each lane one thread-block cluster with its rows
// in shared memory. The single program and the sharded step run on it
// too (below).
//
// Replaces the jitted TPU kernels of the batched server path
// (nomad_tpu/kernels/placement.py):
//   K4  `_chain_with_carry` (:754) as `place_packed_chain` (:802) and
//       `place_table_chain` (:849) run it, whose static program halves
//       `_assemble_table_batch` (:819) gathers from the device program
//       table: P programs in order, each placing against the (used,
//       dyn_free) carry its predecessors left;
//   K5  `place_table_wave` (:878): L lanes of such chains, the lane
//       carries folded by the owner-lane select of :918-931, and the rows
//       more than one lane changed counted as collisions.
//   K1  `place_task_group` (:345): one lane of one program, with the
//       program's step-0 scores (final0) and its carry (new_used) out;
//   K9  `_batch_place` / `_step` (nomad_tpu/parallel/mesh.py:287, :303) on
//       S ≤ 8 node shards of one card: one lane a program, block j node
//       shard j (`shards`), each lane's carry out, then `lane_shard_fold`.
// `place_task_group_chain` (:778), which returns the carry after every
// program, stays on chain.cu's `nomad_place_lanes`, as do programs whose
// rows do not fit this route's layout (kernels/placement.py `lane_route`,
// `shard.py` `step_route`); K1 past it stays on placement.cu, K9 on
// shard.cu's steps.
//
// What bounds it: latency. A lane's P·M steps depend on each other, and
// each ends in an argmax over every row. The work is small: a program
// computes each row's score terms once, then each row step is a few
// table lookups, an add, a divide and a compare (chip_smoke.py
// `_lane_ops`); at N = 16384, M = 16 a chain of 8 is ≈ 0.002 ms at the
// card's fp32 rate, the view read once and the carry written once less.
//
// What the design does about it. chain.cu runs a lane on one SM, rewrites
// ≈ 31 B a row of static scratch a program to device memory and rescans
// it and the carried used rows every step. Here:
//   - a lane is a cluster of C blocks (C ≤ 8, by shape), block j keeping
//     rows [j·rows, (j + 1)·rows) of the view — a multiple of 32 rows, so
//     that the blocks' overlay words never overlap. All lanes are one
//     launch: grid (C, L), cluster (C, 1, 1);
//   - per program, each block runs the on-chip static pass (onchip.cuh)
//     over its rows straight into shared memory: a row's score prefix,
//     its bits and term count, its tokens, and with explain its
//     exhaustion code (row_exh) — 7 B a row at bench's dims;
//   - the carry is the view plus the lane's overlay: a row enters the
//     overlay when a program holds a delta for it or places on it, and
//     from then on reads its used and dyn_free from the lane's carry
//     buffer in device memory; every other row reads the view. At the end
//     of a program one warp per row it touched writes the row's new
//     carry, used0 plus its placements' asks and dyn − placed · n_dyn,
//     computed from the row's carry before the program (carry_in's, take_
//     row's and carry_out_dyn's arithmetic) — so no program reloads N
//     rows of carry, and only overlay rows are ever written to the carry;
//   - a step runs onchip_begin_step, the row loop over shared memory, the
//     block argmax, and one record (cluster_core.cuh) in the block's own
//     slot (two sets of slots, by the step's parity, so a block a step
//     ahead never writes a slot another still reads); one cluster
//     barrier; then every block copies the other blocks' records through
//     distributed shared memory and combines the C records (the
//     max score and the lowest global row among equal scores, the
//     preferred-row override, the counts summed) into the same winner,
//     block 0 writing the step's outputs, and applies the winner to its
//     replicated counts. Between its arrival at the barrier and its wait,
//     a spare warp computes the entry the block's candidate row (its
//     preferred row, or its best) would have after the placement, so the
//     block that owns the winner need not recompute it from device
//     memory at the next step's start;
//   - explain's top-K: each thread keeps its rows' top K in registers,
//     each warp merges its lanes' lists, and warp k < K takes entry k of
//     the merge of the warps' lists and recomputes that row's score parts
//     from its carry (a lane a resource dimension, `warp_row`). No
//     per-row score or parts array exists;
//   - the chain's final carry is written once: the view's rows, the
//     overlay rows from the carry. A wave writes each lane's overlay
//     bitmap and a second launch (`lane_fold`) folds by value: a lane
//     changed a row only where its carry differs from the view (so an
//     overlay row whose deltas cancel is unchanged), rows changed by more
//     than one lane are counted, and a changed row is copied bitwise from
//     the highest-numbered lane that changed it;
//   - each program's penalty rows and the spread and distinct_property
//     constants a step's start reads are copied into shared memory
//     (`lane_consts`);
//   - a step past n_place after a step that placed nothing, with the same
//     penalty rows, has the previous step's state: no block runs it, and
//     block 0 copies the previous step's outputs (a count-10 program
//     padded to M = 16 steps runs 10);
//   - a node shard (K9) is a block: block j of lane l reads argument block
//     l·S + j, whose cluster pointers are node shard j's, each moved back
//     by j·rows rows, so that the kernel indexes every shard by global
//     row exactly as it indexes one view, and reads through them only its
//     own rows [j·rows, (j + 1)·rows); its program fields are the
//     program's (global rows, no rebase). Each lane writes its carry once
//     (the view's rows from its shard, the overlay rows from the carry),
//     and `lane_shard_fold` folds every lane into every node shard in one
//     launch;
//   - lanes past gridDim.y's 65,535 run in turns on the clusters
//     (cluster y takes lanes y, y + gridDim.y, ...): one launch for any
//     lane count.
// One launch a chain or single program, two a wave or sharded step.
// Every score is chain.cu's f32
// expression on the same values in the same order (built with
// -fmad=false, the `+ 0.0f` of absent terms kept, a row's deltas summed
// in delta order and subtracted once), so the outputs and the carry are
// bitwise those of `nomad_place_lanes`, of placement.cu (K1) and of
// shard.cu's steps route (K9).

#include <cooperative_groups.h>

#include "cluster_core.cuh"
#include "onchip.cuh"

namespace cg = cooperative_groups;

namespace {

// shard copies (batch rows × node shards) K9's fold on one card takes
constexpr int MAX_FOLD_COPIES = 64;

}  // namespace

extern "C" {

// One dispatch of the lane route.
struct LaneRun {
  int lanes;          // L lanes, one cluster each
  int per_lane;       // P programs a lane, in order
  int clusters;       // C blocks a lane
  int rows;           // rows a block keeps (a multiple of 32 in a wave)
  int n, r;           // the view's rows and resource dims
  int fold;           // a wave: write the overlay bitmaps, then fold
  int shards;         // 1: block j of lane l reads its own arguments,
                      // progs[l·C + j] (node shard j of program l, K9);
                      // 0: the lane's programs, progs[l·P + k]
  const float* used0;  // [n, r] the view (the fold's)
  const float* dyn0;   // [n]
  float* carry_used;   // [lanes, n, r] the lane carries (overlay rows only)
  float* carry_dyn;    // [lanes, n]; null: none (one program, no fold)
  uint32_t* overlay;   // [lanes, (n + 31) / 32] overlay bitmaps (waves)
  // without fold: [lanes, n, r] each lane's final carry, or null; a
  // wave: [n, r] the fold
  float* out_used;
  float* out_dyn;      // [lanes, n] or [n] as out_used, or null
  int* collisions;     // [1] waves: zeroed by the lane kernel
};

// The fold of K9's cluster route, node shards of one card: every
// program's carry (the lane route's out_used, global rows) folded into
// each node shard's view, used + Σ_b (new_used_b − used) in ascending b,
// the partial sum passing from batch row to batch row in order.
struct LaneShardFold {
  int shards;      // S node shards, equal and in row order
  int batch_rows;  // the mesh's batch rows
  int per_row;     // programs a batch row
  int count;       // floats of a node shard: rows · r
  const float* new_used;  // [batch_rows · per_row, shards · count]
  const float* used[MAX_FOLD_COPIES];  // [batch_rows · shards] each shard
                                       // copy's view
  float* out[MAX_CLUSTER];             // [shards] each node shard's fold
};

}  // extern "C"

namespace {

constexpr int LANE_THREADS = 512;
constexpr int LANE_WARPS = LANE_THREADS / 32;
// a thread's top-K list: explain's K (EXPLAIN_TOPK, kernels/placement.py)
constexpr int LANE_TOPK = 5;
constexpr int FOLD_THREADS = 256;
// counters: [0] fit, [1] distinct_hosts, [2] distinct_property, [3] dyn
// ports, [4] reserved ports, [5] feasible, [6] evaluated, [7] filt_lut,
// [8] filt_extra, then exh_dim [r], then filt_constraint [c]
constexpr int CNT_FIXED = 9;

// regions of a block's shared-memory layout, in order
enum LaneRegion {
  G_ARGS, G_RED, G_CNT, G_PLACED, G_PEN, G_SCOUNTS, G_DCOUNTS, G_SPTAB,
  G_MINMAX, G_SEEN, G_DPTAB, G_CONSTS, G_LISTS, G_SLOTS, G_WIN, G_SPEC,
  G_OVERLAY, G_PREFIX, G_META, G_EXH, G_STOK, G_DTOK, G_END
};

// remote loads a lane keeps in flight when copying the records
constexpr int COPY_ROUND = 4;
// the warp that computes the placed row's next entry ahead (SpecRow):
// the first past the K that build explain's top-K entries
constexpr int SPEC_WARP = LANE_TOPK;

__host__ __device__ inline int win_words(const PlaceArgs& A) {
  return 2 + A.s + A.p;
}

// A thread's arrival at, and its wait for, the cluster's barrier: split
// so that a warp can work between them (the records are published by
// the arrival, release; read after the wait, acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The byte offset of each region for blocks of `rows` rows in clusters of
// `clusters` (off[G_END]: the whole layout); every region starts on a
// 16-byte boundary. `lane_layout` in kernels/placement.py reckons the
// same.
__host__ __device__ inline void lane_offsets(const PlaceArgs& A, int rows,
                                             int clusters, size_t* off) {
  const size_t n = (size_t)rows;
  size_t bytes[G_END];
  bytes[G_ARGS] = sizeof(PlaceArgs);
  bytes[G_RED] = 33 * sizeof(Best);
  bytes[G_CNT] = (size_t)(CNT_FIXED + A.r + A.c) * 4;
  bytes[G_PLACED] = (size_t)A.m * 4;
  bytes[G_PEN] = (size_t)A.pn * sizeof(PenRow);
  bytes[G_SCOUNTS] = (size_t)A.s * A.sv * 4;
  bytes[G_DCOUNTS] = (size_t)A.p * A.dv * 4;
  bytes[G_SPTAB] = (size_t)A.s * A.sv * 4;
  bytes[G_MINMAX] = (size_t)A.s * 2 * 4;
  bytes[G_SEEN] = (size_t)A.s;
  bytes[G_DPTAB] = (size_t)A.p * A.dv;
  bytes[G_CONSTS] = 4 * ((size_t)A.s * A.sv + A.s + A.p + (size_t)A.m * A.pn) +
                    2 * (size_t)A.s + A.p;
  bytes[G_LISTS] = A.explain ? LANE_WARPS * TOPK_MAX * sizeof(Best) : 0;
  bytes[G_SLOTS] = 2 * (size_t)clusters * round4(shard_rec_words(A)) * 4;
  bytes[G_WIN] = (size_t)round4(win_words(A)) * 4;
  bytes[G_SPEC] = sizeof(SpecRow);
  bytes[G_OVERLAY] = (n + 31) / 32 * 4;
  bytes[G_PREFIX] = n * 4;
  bytes[G_META] = n;
  bytes[G_EXH] = A.explain ? n : 0;
  bytes[G_STOK] = (size_t)A.s * n * tok_bytes(A.sv);
  bytes[G_DTOK] = (size_t)A.p * n * tok_bytes(A.dv);
  size_t b = 0;
  for (int i = 0; i < G_END; ++i) {
    off[i] = b;
    b = (b + bytes[i] + 15) & ~(size_t)15;
  }
  off[G_END] = b;
}

// a block's own regions beside the on-chip scan's
struct LaneSmem {
  OnchipSmem S;
  int* cnt;
  Best* lists;        // [warps, TOPK_MAX] each warp's top-K (explain)
  int* slots;         // [2, clusters, stride] the records, by step parity
  int* win;           // [win_words] the step's winner
  SpecRow* spec;      // the placed row's next entry, computed ahead
  uint32_t* overlay;  // [rows / 32] the lane's overlay bits of the rows
  unsigned char* consts;  // the program's constants a step reads
};

__device__ LaneSmem lane_carve(const PlaceArgs& A, const LaneRun& L,
                               unsigned char* base, int row0, int rows,
                               const float* carry_used,
                               const float* carry_dyn) {
  size_t off[G_END + 1];
  lane_offsets(A, L.rows, L.clusters, off);
  LaneSmem G;
  OnchipSmem& S = G.S;
  S.red = (Best*)(base + off[G_RED]);
  S.placed = (int*)(base + off[G_PLACED]);
  S.pen = (PenRow*)(base + off[G_PEN]);
  S.scounts = (float*)(base + off[G_SCOUNTS]);
  S.dcounts = (float*)(base + off[G_DCOUNTS]);
  S.sptab = (float*)(base + off[G_SPTAB]);
  S.minc = (float*)(base + off[G_MINMAX]);
  S.maxc = S.minc + A.s;
  S.seen = base + off[G_SEEN];
  S.dptab = base + off[G_DPTAB];
  S.prefix = (float*)(base + off[G_PREFIX]);
  S.meta = base + off[G_META];
  S.exh = A.explain ? base + off[G_EXH] : nullptr;
  S.stok = base + off[G_STOK];
  S.dtok = base + off[G_DTOK];
  S.swide = tok_bytes(A.sv) == 2;
  S.dwide = tok_bytes(A.dv) == 2;
  S.row0 = row0;
  S.rows = rows;
  G.overlay = (uint32_t*)(base + off[G_OVERLAY]);
  S.overlay = G.overlay;
  S.carry_used = carry_used;
  S.carry_dyn = carry_dyn;
  G.cnt = (int*)(base + off[G_CNT]);
  G.lists = (Best*)(base + off[G_LISTS]);
  G.slots = (int*)(base + off[G_SLOTS]);
  G.win = (int*)(base + off[G_WIN]);
  G.spec = (SpecRow*)(base + off[G_SPEC]);
  S.spec = G.spec;
  G.consts = base + off[G_CONSTS];
  return G;
}

// Copies of what a step reads of the program's fields — the spread
// rows' desired counts, weights and flags, the distinct_property limits
// and flags, and every step's penalty rows — into shared memory, A's
// pointers (the block's own copy of the arguments) turned to them. The
// values are the same; only where they are read from changes. Ends with
// a barrier.
__device__ void lane_consts(PlaceArgs& A, const LaneSmem& G) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sd = A.s * A.sv, pen = A.m * A.pn;
  float* f = (float*)G.consts;               // [sd] [s] [p]
  int* pi = (int*)(f + sd + A.s + A.p);      // [m, pn]
  uint8_t* u = (uint8_t*)(pi + pen);         // [s] [s] [p]
  for (int i = tid; i < sd; i += nt) f[i] = A.spread_desired[i];
  for (int i = tid; i < A.s; i += nt) {
    f[sd + i] = A.spread_weight[i];
    u[i] = A.spread_has_targets[i];
    u[A.s + i] = A.spread_active[i];
  }
  for (int i = tid; i < A.p; i += nt) {
    f[sd + A.s + i] = A.dp_allowed[i];
    u[2 * A.s + i] = A.dp_active[i];
  }
  for (int i = tid; i < pen; i += nt) pi[i] = A.penalty_idx[i];
  __syncthreads();
  if (tid == 0) {
    A.spread_desired = f;
    A.spread_weight = f + sd;
    A.dp_allowed = f + sd + A.s;
    A.penalty_idx = pi;
    A.spread_has_targets = u;
    A.spread_active = u + A.s;
    A.dp_active = u + 2 * A.s;
  }
  __syncthreads();
}

// Step `step` places nothing and leaves every output as the previous
// step's: it is past n_place (so finds nothing), the previous step placed
// nothing (so the rows, the counts and the tables are the same), and its
// penalty rows are the previous step's. Every block decides alike.
__device__ __forceinline__ bool idle_step(const PlaceArgs& A,
                                          const ScanConsts& C,
                                          const OnchipSmem& S, int step) {
  if (step == 0 || step < C.n_place || S.placed[step - 1] >= 0) return false;
  const int* pen = A.penalty_idx + (size_t)step * A.pn;
  for (int q = 0; q < A.pn; ++q)
    if (pen[q] != pen[q - A.pn]) return false;
  return true;
}

// An idle step's outputs, copied from the previous step's (block 0, which
// wrote those): sel_idx −1 and sel_score 0.0f, as a step that finds
// nothing writes them, and the same fit count and explain leaves.
__device__ void lane_copy_step(const PlaceArgs& A, int step) {
  const int tid = threadIdx.x, nt = blockDim.x, R = A.r, K = A.topk;
  if (tid == 0) {
    A.sel_idx[step] = -1;
    A.sel_score[step] = 0.0f;
    A.nodes_fit[step] = A.nodes_fit[step - 1];
    if (A.explain) {
      A.filt_distinct[step] = A.filt_distinct[step - 1];
      A.filt_dp[step] = A.filt_dp[step - 1];
      A.exh_dyn[step] = A.exh_dyn[step - 1];
      A.exh_res[step] = A.exh_res[step - 1];
    }
  }
  if (!A.explain) return;
  for (int q = tid; q < R; q += nt)
    A.exh_dim[(size_t)step * R + q] = A.exh_dim[(size_t)(step - 1) * R + q];
  for (int q = tid; q < K; q += nt) {
    A.topk_idx[(size_t)step * K + q] = A.topk_idx[(size_t)(step - 1) * K + q];
    A.topk_score[(size_t)step * K + q] =
        A.topk_score[(size_t)(step - 1) * K + q];
  }
  for (int q = tid; q < K * N_PARTS; q += nt)
    A.topk_parts[(size_t)step * K * N_PARTS + q] =
        A.topk_parts[(size_t)(step - 1) * K * N_PARTS + q];
}

// nodes_feasible over the block's rows and, with explain, the static
// filter counts (static_row's and static_counts' reckoning) into
// G.cnt[5..8] and the per-constraint counts; the caller zeroed them.
// Starts after a barrier; the caller's next barrier publishes them.
__device__ void lane_static_counts(const PlaceArgs& A, const LaneSmem& G) {
  const OnchipSmem& S = G.S;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  int* cfilt = G.cnt + CNT_FIXED + A.r;
  int nfeas = 0, ev = 0, flut = 0, fext = 0;
  for (int i = tid; i < S.rows; i += nt) {
    nfeas += (S.meta[i] & R_FEAS) != 0;
    if (!A.explain) continue;
    const int n = S.row0 + i;
    bool cand_ok = true;
    if (A.l > 0 && *A.use_cand) {
      cand_ok = false;
      for (int q = 0; q < A.l; ++q)
        if (A.cand_idx[q] == n) { cand_ok = true; break; }
    }
    if (!(A.node_ok[n] && cand_ok)) continue;
    ++ev;
    bool lut_all = true;
    for (int c = 0; c < A.c; ++c) {
      const int t = norm_tok(attr_at(A, n, A.key_idx[c]), A.v);
      if (!A.lut[(size_t)c * A.v + t]) {
        lut_all = false;
        atomicAdd(&cfilt[c], 1);
      }
    }
    if (!lut_all) ++flut;
    else if (!A.extra_mask[A.e == 1 ? 0 : n]) ++fext;
  }
  nfeas = warp_sum(nfeas);
  if (lane == 0) atomicAdd(&G.cnt[5], nfeas);
  if (A.explain) {
    ev = warp_sum(ev);
    flut = warp_sum(flut);
    fext = warp_sum(fext);
    if (lane == 0) {
      atomicAdd(&G.cnt[6], ev);
      atomicAdd(&G.cnt[7], flut);
      atomicAdd(&G.cnt[8], fext);
    }
  }
}

// x into a thread's top-K list `tk` (value descending, the lower row
// first among equal values; the rows unique)
__device__ __forceinline__ void topk_insert(Best (&tk)[LANE_TOPK], Best x) {
#pragma unroll
  for (int q = 0; q < LANE_TOPK; ++q) {
    const Best y = tk[q];
    const bool take = x.v > y.v || (x.v == y.v && x.i < y.i);
    tk[q] = take ? x : y;
    x = take ? y : x;
  }
}

// step_rows' score parts of (global) row n, which the block keeps, at
// `step`, each times `keep`, as record words written by lane 0: by the 32
// lanes of a warp (warp_row)
__device__ void lane_parts(const PlaceArgs& A, const ScanConsts& C,
                           const OnchipSmem& S, int n, int step, float keep,
                           int* out) {
  const int lane = threadIdx.x & 31;
  const int* pen = A.penalty_idx + (size_t)step * A.pn;
  bool hit = false;
  for (int q = lane; q < A.pn; q += 32) hit |= pen[q] == n;
  const bool penalty = __any_sync(FULL, hit);
  const int k = placed_on(S, n, step);
  const float* used = src_used(A, S, n);
  RowTerms t;
  if (A.r <= W_JC) {
    const WarpRow w = warp_row(A, n, k, used, src_dyn(A, S, n));
    t = row_terms_of(C, w.cap0, w.cap1, w.c, penalty, w.aff);
  } else {
    t = row_terms(A, C, n, row_carry(A, n, k, used), penalty);
  }
  const float sp = onchip_spread(A, S, n - S.row0);
  const float p_sp = sp != 0.0f ? sp : 0.0f;
  if (lane == 0) {
    out[0] = __float_as_int(t.fit * keep);
    out[1] = __float_as_int(t.anti * keep);
    out[2] = __float_as_int(t.pen * keep);
    out[3] = __float_as_int(t.aff * keep);
    out[4] = __float_as_int(p_sp * keep);
  }
}

// The new carry of every row the program touched that the block keeps
// (its deltas' rows and its placements' rows), a warp a row, from the
// row's carry before the program: lane r dimension r's used0 plus its
// placements' asks added one at a time, lane 0 dyn − placed · n_dyn where
// it placed; the rows join the overlay. Starts after a barrier (placed is
// complete).
__device__ void lane_carry_out(const PlaceArgs& A, const LaneSmem& G,
                               float* carry_used, float* carry_dyn) {
  const OnchipSmem& S = G.S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, R = A.r;
  for (int t = warp; t < A.d + A.m; t += nw) {
    const int row = t < A.d ? A.delta_idx[t] : S.placed[t - A.d];
    if (row < 0 || row >= A.n || !in_block(S, row)) continue;
    bool first = true;
    for (int q = 0; q < t && first; ++q)
      first = (q < A.d ? A.delta_idx[q] : S.placed[q - A.d]) != row;
    if (!first) continue;
    const float* su = src_used(A, S, row);
    const int k = placed_on(S, row, A.m);
    for (int r = lane; r < R; r += 32)
      carry_used[(size_t)row * R + r] = carried_used(A, su, row, r, k);
    __syncwarp();  // every lane has read the row's carry before it moves
    if (lane == 0) {
      if (carry_dyn != nullptr) {
        const float sd = src_dyn(A, S, row);
        float placed = 0.0f;
        for (int q = 0; q < A.m; ++q)
          if (S.placed[q] == row) placed = placed + 1.0f;
        carry_dyn[row] = k > 0 ? sd - placed * *A.n_dyn : sd;
      }
      const int i = row - S.row0;
      atomicOr(&G.overlay[i >> 5], 1u << (i & 31));
    }
  }
}

// Lane `lane_id`'s chain on the cluster, block j keeping rows [j·rows,
// (j + 1)·rows) of the view for the lane's programs. Every block runs
// every barrier: the loop bounds and the step's branches are the same in
// all of them. Ends with a cluster barrier, so that the next lane may
// reuse the shared memory.
__device__ void lane_run(const PlaceArgs* progs, const LaneRun& L,
                         int lane_id, unsigned char* smem_raw) {
  PlaceArgs& A = *(PlaceArgs*)smem_raw;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = L.n, R = L.r;
  const int row0 = j * L.rows;
  const int rows = max(0, min(N - row0, L.rows));
  float* carry_used = L.carry_used + (size_t)lane_id * N * R;
  float* carry_dyn =
      L.carry_dyn == nullptr ? nullptr : L.carry_dyn + (size_t)lane_id * N;

  // a node shard's block its own arguments (K9), else the lane's
  const PlaceArgs* lane_progs =
      L.shards ? progs + (size_t)lane_id * L.clusters + j
               : progs + (size_t)lane_id * L.per_lane;
  load_args(&A, lane_progs);  // the programs share their shapes: carve once
  const LaneSmem G = lane_carve(A, L, smem_raw, row0, rows, carry_used,
                                carry_dyn);
  const OnchipSmem& S = G.S;
  const int stride = round4(shard_rec_words(A));
  for (int w = tid; w < (rows + 31) / 32; w += nt) G.overlay[w] = 0;
  if (tid == 0) G.spec->row = -1;
  int gstep = 0;  // steps of the lane so far: the record slots' parity

  for (int k = 0; k < L.per_lane; ++k) {
    __syncthreads();  // the previous program is done with A, the rows and
                      // the carry it wrote
    if (k > 0) load_args(&A, lane_progs + k);
    lane_consts(A, G);
    const ScanConsts C = scan_consts(A);
    const int K = A.topk;
    if (tid < 4) G.cnt[5 + tid] = 0;
    for (int c = tid; c < A.c; c += nt) G.cnt[CNT_FIXED + R + c] = 0;
    onchip_static(A, C, S);  // its barriers publish the zeroed counts
    lane_static_counts(A, G);

    for (int step = 0; step < A.m; ++step) {
      if (idle_step(A, C, S, step)) {
        // the previous step's state, so its outputs: no block runs it
        if (j == 0) lane_copy_step(A, step);
        if (tid == 0) S.placed[step] = -1;
        __syncthreads();
        continue;
      }
      // issued now, read by the record after the row loop
      const int pref = A.preferred_idx[step];
      if (tid == 0)
        for (int q = 0; q < 5; ++q) G.cnt[q] = 0;
      for (int q = tid; q < R; q += nt) G.cnt[CNT_FIXED + q] = 0;
      onchip_begin_step(A, C, S, step);  // ends with a barrier

      Best best{LOWEST, NONE};
      int nfit = 0;
      // step 0's masked score of every row, where the program returns it
      float* const final0 = step == 0 ? A.final0 : nullptr;
      if (!A.explain) {
        for (int i = tid; i < rows; i += nt) {
          const float v = onchip_value(A, S, i).masked;
          if (final0 != nullptr) final0[row0 + i] = v;
          best = better(best, Best{v, row0 + i});
          nfit += (S.meta[i] & R_FIT) != 0;
        }
        nfit = warp_sum(nfit);
        if (lane == 0) atomicAdd(&G.cnt[0], nfit);
      } else {
        Best tk[LANE_TOPK];
#pragma unroll
        for (int q = 0; q < LANE_TOPK; ++q) tk[q] = Best{LOWEST, NONE};
        int c_dh = 0, c_dp = 0, c_dyn = 0, c_res = 0;
        for (int i = tid; i < rows; i += nt) {
          const uint8_t m = S.meta[i];
          const bool feas = (m & R_FEAS) != 0, dh = (m & R_DH) != 0;
          const bool dp_mask = onchip_dp_ok(A, S, i);
          const bool ok = (m & (R_FIT | R_DH)) == R_FIT && dp_mask;
          const Best b{ok ? onchip_score(A, S, i, m) : NEG_INF, row0 + i};
          if (final0 != nullptr) final0[b.i] = b.v;
          best = better(best, b);
          topk_insert(tk, b);
          nfit += (m & R_FIT) != 0;
          const bool dh_fail = feas && dh;
          const bool dp_fail = A.p > 0 && feas && !dh_fail && !dp_mask;
          const bool cand_m = feas && !dh_fail && !dp_fail;
          c_dh += dh_fail;
          c_dp += dp_fail;
          const int code = S.exh[i];
          if (cand_m && code != 0) {
            if (code <= R) atomicAdd(&G.cnt[CNT_FIXED + code - 1], 1);
            else if (code == R + 1) ++c_dyn;
            else ++c_res;
          }
        }
        nfit = warp_sum(nfit);
        c_dh = warp_sum(c_dh);
        c_dp = warp_sum(c_dp);
        c_dyn = warp_sum(c_dyn);
        c_res = warp_sum(c_res);
        if (lane == 0) {
          atomicAdd(&G.cnt[0], nfit);
          atomicAdd(&G.cnt[1], c_dh);
          atomicAdd(&G.cnt[2], c_dp);
          atomicAdd(&G.cnt[3], c_dyn);
          atomicAdd(&G.cnt[4], c_res);
        }
        // the warp's top K: K rounds over its lanes' list heads
#pragma unroll
        for (int q = 0; q < LANE_TOPK; ++q) {
          if (q < K) {
            const Best b = warp_best(tk[0]);
            if (lane == 0) G.lists[warp * TOPK_MAX + q] = b;
            if (b.i != NONE && tk[0].i == b.i) {
#pragma unroll
              for (int e = 0; e < LANE_TOPK - 1; ++e) tk[e] = tk[e + 1];
              tk[LANE_TOPK - 1] = Best{LOWEST, NONE};
            }
          }
        }
      }
      // its barriers publish the counts and the warps' lists
      best = block_argmax(best, S.red);

      // this block's record, assembled in its own slot of this step's set
      int* const set = G.slots + (gstep & 1) * L.clusters * stride;
      int* const rec = set + j * stride;
      if (warp == 0 && lane == 0) {
        const int tw = A.s + A.p;
        const size_t rs = (size_t)rows;
        const int bi = best.i == NONE ? -1 : best.i - row0;
        rec[0] = __float_as_int(best.v);
        rec[1] = best.i;
        rec[2] = bi >= 0 && onchip_value(A, S, bi).ok;
        rec[3] = G.cnt[0];
        rec[4] = step == 0 ? G.cnt[5] : 0;
        for (int s = 0; s < A.s; ++s)
          rec[7 + s] = bi >= 0 ? tok_get(S.stok, S.swide, s * rs + bi) : 0;
        for (int q = 0; q < A.p; ++q)
          rec[7 + A.s + q] =
              bi >= 0 ? tok_get(S.dtok, S.dwide, q * rs + bi) : 0;
        const bool owned = pref >= 0 && pref < A.n && in_block(S, pref);
        const RowVal pv = owned ? onchip_value(A, S, pref - row0)
                                : RowVal{false, 0.0f};
        const int pi = pref - row0;
        rec[5] = pv.ok;
        rec[6] = __float_as_int(pv.ok ? pv.masked : 0.0f);
        for (int s = 0; s < A.s; ++s)
          rec[7 + tw + s] = pv.ok ? tok_get(S.stok, S.swide, s * rs + pi)
                                  : 0;
        for (int q = 0; q < A.p; ++q)
          rec[7 + tw + A.s + q] =
              pv.ok ? tok_get(S.dtok, S.dwide, q * rs + pi) : 0;
      }
      if (A.explain) {
        int* ex = rec + shard_ex(A);
        int* tkw = ex + 4 + R;
        if (warp == 0) {
          for (int q = lane; q < 4 + R; q += 32)
            ex[q] = q < 4 ? G.cnt[1 + q] : G.cnt[CNT_FIXED + q - 4];
          if (step == 0) {
            int* st = tkw + TOPK_WORDS * K;
            for (int q = lane; q < 3 + A.c; q += 32)
              st[q] = q < 3 ? G.cnt[6 + q] : G.cnt[CNT_FIXED + R + q - 3];
          }
        }
        if (warp < K) {
          // entry `warp` of the block's top K: rounds 0..warp over the
          // warps' list heads (every such warp runs the same rounds on the
          // same lists), then its parts by this warp
          const int nw = nt >> 5;
          int head = 0;
          Best b{LOWEST, NONE};
          for (int q = 0; q <= warp; ++q) {
            const Best mine = lane < nw && head < K
                                  ? G.lists[lane * TOPK_MAX + head]
                                  : Best{LOWEST, NONE};
            b = warp_best(mine);
            if (b.i != NONE && mine.i == b.i) ++head;
          }
          int* e = tkw + TOPK_WORDS * warp;
          if (lane == 0) {
            e[0] = __float_as_int(b.v);
            e[1] = b.i;
          }
          if (b.i != NONE) {
            lane_parts(A, C, S, b.i, step, b.v > NEG_INF / 2 ? 1.0f : 0.0f,
                       e + 2);
          } else if (lane < N_PARTS) {
            e[2 + lane] = __float_as_int(0.0f);
          }
        }
      }
      __syncwarp();
      cluster_arrive();  // (each writer's part of the record is published)
      if (warp == SPEC_WARP) {
        // the entry of the row this block would place on — its preferred
        // row if it holds it and it is ok (the preferred row overrides),
        // else its best row if ok — after that placement, while the
        // records are combined
        const bool owned = pref >= 0 && pref < A.n && in_block(S, pref);
        const int bi = best.i == NONE ? -1 : best.i - row0;
        int row = -1;
        if (owned && onchip_value(A, S, pref - row0).ok) row = pref;
        else if (bi >= 0 && onchip_value(A, S, bi).ok) row = best.i;
        if (row >= 0) {
          const uint8_t m = S.meta[row - row0];
          const RowEntry e = row_entry_warp(
              A, C, row, placed_on(S, row, step) + 1, (m & R_FEAS) != 0,
              (m & R_RES) != 0, src_used(A, S, row), src_dyn(A, S, row));
          if (lane == 0) *G.spec = SpecRow{row, e.prefix, e.meta, e.exh};
        } else if (lane == 0) {
          G.spec->row = -1;
        }
      }
      __syncwarp();
      cluster_wait();  // every block's record is whole

      if (warp == 0) {
        // every block copies the other blocks' records, each from its own
        // slot in that block, into the same slot here (block 0, which
        // writes the step's outputs, whole records; the others the
        // winner's part; COPY_ROUND remote loads a lane in flight at
        // once), then combines them into the same winner
        const int words = j == 0 ? shard_rec_words(A) : shard_ex(A);
        const int total = L.clusters * words;
        for (int t0 = 0; t0 < total; t0 += 32 * COPY_ROUND) {
          int v[COPY_ROUND];
#pragma unroll
          for (int u = 0; u < COPY_ROUND; ++u) {
            const int t = t0 + u * 32 + lane, q = t / words;
            v[u] = 0;
            if (t < total && q != j)
              v[u] = cluster.map_shared_rank(set, q)[q * stride + t % words];
          }
#pragma unroll
          for (int u = 0; u < COPY_ROUND; ++u) {
            const int t = t0 + u * 32 + lane, q = t / words;
            if (t < total && q != j) set[q * stride + t % words] = v[u];
          }
        }
        __syncwarp();
        ShardCombine Cm = {};
        Cm.step = step;
        Cm.shards = L.clusters;
        Cm.progs = 1;
        Cm.m = A.m;
        Cm.rec_words = shard_rec_words(A);
        Cm.win_words = win_words(A);
        Cm.sel_idx = A.sel_idx;
        Cm.sel_score = A.sel_score;
        Cm.nodes_fit = A.nodes_fit;
        Cm.nodes_feasible = A.nodes_feasible;
        Cm.ex_static = A.ex_static;
        Cm.filt_constraint = A.filt_constraint;
        Cm.filt_distinct = A.filt_distinct;
        Cm.filt_dp = A.filt_dp;
        Cm.exh_dim = A.exh_dim;
        Cm.exh_dyn = A.exh_dyn;
        Cm.exh_res = A.exh_res;
        Cm.topk_idx = A.topk_idx;
        Cm.topk_score = A.topk_score;
        Cm.topk_parts = A.topk_parts;
        combine_records(A, Cm, 0, [&](int q) { return set + q * stride; },
                        G.win, C.n_place, j == 0);
        __syncwarp();
      }
      if (tid == 0) {
        const int* w = G.win;
        S.placed[step] = w[0] ? w[1] : -1;
        if (w[0]) {
          for (int s = 0; s < A.s; ++s) {
            const int t = w[2 + s];
            if (t != A.sv - 1) S.scounts[s * A.sv + t] += 1.0f;
          }
          for (int q = 0; q < A.p; ++q) {
            const int t = w[2 + A.s + q];
            if (t != A.dv - 1) S.dcounts[q * A.dv + t] += 1.0f;
          }
        }
      }
      __syncthreads();
      ++gstep;
    }
    lane_carry_out(A, G, carry_used, carry_dyn);
  }
  __syncthreads();

  if (L.fold) {
    // the lane's overlay bitmap, for the fold
    const int words = (N + 31) / 32;
    for (int w = tid; w < (rows + 31) / 32; w += nt)
      L.overlay[(size_t)lane_id * words + row0 / 32 + w] = G.overlay[w];
  } else if (L.out_used != nullptr) {
    // the lane's final carry: the view's rows (the block's own view: a
    // node shard's is its shard), the overlay rows' carry
    float* out_used = L.out_used + (size_t)lane_id * N * R;
    for (int t = tid; t < rows * R; t += nt) {
      const int i = t / R;
      const size_t e = (size_t)(row0 + i) * R + (t - i * R);
      if (in_overlay(S, row0 + i)) {
        if (out_used != carry_used) out_used[e] = carry_used[e];
      } else {
        out_used[e] = A.used[e];
      }
    }
    float* out_dyn =
        L.out_dyn == nullptr ? nullptr : L.out_dyn + (size_t)lane_id * N;
    for (int i = tid; i < rows && out_dyn != nullptr; i += nt) {
      const int n = row0 + i;
      if (in_overlay(S, n)) {
        if (out_dyn != carry_dyn) out_dyn[n] = carry_dyn[n];
      } else {
        out_dyn[n] = A.dyn_free[n];
      }
    }
  }
  // no block goes on while another may still touch its shared memory
  cluster.sync();
}

// One lane's chain a cluster: grid (C, min(L, MAX_GRID_Y)), cluster (C, 1,
// 1); cluster y runs lanes y, y + gridDim.y, ... in turn, so that a
// dispatch takes any lane count in one launch.
__global__ void __launch_bounds__(LANE_THREADS, 1)
lane_cluster(const PlaceArgs* progs, LaneRun L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (L.fold && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    *L.collisions = 0;
  for (int lane_id = blockIdx.y; lane_id < L.lanes; lane_id += gridDim.y)
    lane_run(progs, L, lane_id, smem_raw);
}

// The wave's fold, one thread a row: a lane changed the row if its overlay
// holds the row and any of its carried used or dyn_free values differs
// from the view's; rows changed by more than one lane add one to the
// collision count (an integer atomic, exact); the row is copied bitwise
// from the highest-numbered lane that changed it, else from the view.
__global__ void lane_fold(LaneRun L) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= L.n) return;
  const int N = L.n, R = L.r, words = (N + 31) / 32;
  int changed = 0, owner = -1;
  for (int l = 0; l < L.lanes; ++l) {
    if (!((L.overlay[(size_t)l * words + (n >> 5)] >> (n & 31)) & 1u))
      continue;
    const float* u = L.carry_used + ((size_t)l * N + n) * R;
    bool c = L.carry_dyn[(size_t)l * N + n] != L.dyn0[n];
    for (int r = 0; r < R; ++r) c = c || u[r] != L.used0[(size_t)n * R + r];
    if (c) {
      ++changed;
      owner = l;
    }
  }
  if (changed > 1) atomicAdd(L.collisions, 1);
  const float* src = owner >= 0 ? L.carry_used + ((size_t)owner * N + n) * R
                                : L.used0 + (size_t)n * R;
  for (int r = 0; r < R; ++r) L.out_used[(size_t)n * R + r] = src[r];
  L.out_dyn[n] = owner >= 0 ? L.carry_dyn[(size_t)owner * N + n] : L.dyn0[n];
}

// K9's fold, one thread an element of the S node shards: acc = 0, then
// for each batch row in order and each of its programs in order, acc +=
// new_used_b − used (the row's copy of the shard), and the shard's folded
// view = used + acc (the last batch row's copy) — shard.cu shard_fold's
// arithmetic in its order, over every shard and batch row in one launch.
__global__ void lane_shard_fold(LaneShardFold F) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)F.shards * F.count;
  if (e >= (long long)stride) return;
  const int j = (int)(e / F.count);
  const int el = (int)(e - (long long)j * F.count);
  float a = 0.0f, u = 0.0f;
  for (int i = 0; i < F.batch_rows; ++i) {
    u = F.used[i * F.shards + j][el];
    const float* nu = F.new_used + (size_t)i * F.per_row * stride + e;
    for (int b = 0; b < F.per_row; ++b) a = a + (nu[(size_t)b * stride] - u);
  }
  F.out[j][el] = u + a;
}

}  // namespace

extern "C" {

size_t nomad_lanes_args_size() { return sizeof(PlaceArgs); }

size_t nomad_lanes_run_size() { return sizeof(LaneRun); }

const char* nomad_lanes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes a block of lane_cluster takes for programs shaped
// like `args0`, blocks of `rows` rows in clusters of `clusters`.
size_t nomad_lanes_smem(const PlaceArgs* args0, int rows, int clusters) {
  size_t off[G_END + 1];
  lane_offsets(*args0, rows, clusters, off);
  return off[G_END];
}

// Enqueues one dispatch of the lane route on `stream`: lane_cluster over
// every lane (one launch, whatever the lane count), then (waves)
// lane_fold. `args0` is the host copy of program 0's arguments (every
// program shares its shapes); `progs` the device array of lanes·per_lane
// arguments, lane-major, or with `shards` of lanes·clusters, a block's
// own. `launches` gets the kernels launched. Returns a CUDA error (0 =
// ok) when the arguments disagree, when the shared memory is refused,
// when no cluster of C such blocks fits the card, or when a launch
// fails.
int nomad_place_lane_clusters(const PlaceArgs* args0, const void* progs,
                              const LaneRun* run, void* stream,
                              int* launches) {
  const PlaceArgs& A0 = *args0;
  const LaneRun L = *run;
  cudaStream_t st = (cudaStream_t)stream;
  *launches = 0;
  // a wave's blocks write words of one overlay bitmap: rows a multiple of
  // 32; a lane without a dyn_free carry has one program and no fold; the
  // node shards of K9 are equal and cover the view, one program each
  if (L.clusters < 1 || L.clusters > MAX_CLUSTER || L.rows <= 0 ||
      (L.fold && L.rows % 32 != 0) || (long long)L.rows * L.clusters < L.n ||
      L.n != A0.n || L.r != A0.r || A0.r < 2 || A0.m < 1 ||
      A0.topk > LANE_TOPK || A0.sv > 65536 || A0.dv > 65536 ||
      L.lanes < 1 || L.per_lane < 1 || L.carry_used == nullptr ||
      (L.carry_dyn == nullptr &&
       (L.per_lane != 1 || L.fold || L.out_dyn != nullptr)) ||
      (L.shards && (L.per_lane != 1 || L.fold ||
                    (long long)L.rows * L.clusters != L.n)) ||
      (L.fold && (L.overlay == nullptr || L.out_used == nullptr ||
                  L.out_dyn == nullptr || L.collisions == nullptr)) ||
      (L.out_dyn != nullptr && L.out_used == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t shm = nomad_lanes_smem(args0, L.rows, L.clusters);
  if (shm > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lane_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(L.clusters, L.lanes < MAX_GRID_Y ? L.lanes : MAX_GRID_Y, 1);
  cfg.blockDim = dim3(LANE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)lane_cluster,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, lane_cluster, (const PlaceArgs*)progs, L);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launches = 1;
  if (!L.fold) return 0;
  lane_fold<<<(L.n + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0, st>>>(
      L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launches = 2;
  return 0;
}

size_t nomad_lanes_fold_size() { return sizeof(LaneShardFold); }

// Enqueues K9's fold over every node shard of one card (lane_shard_fold,
// one launch). Returns a CUDA error (0 = ok).
int nomad_lanes_shard_fold(const LaneShardFold* fold, void* stream) {
  const LaneShardFold F = *fold;
  if (F.shards < 1 || F.shards > MAX_CLUSTER || F.batch_rows < 1 ||
      F.batch_rows * F.shards > MAX_FOLD_COPIES || F.per_row < 0 || F.count <= 0 ||
      F.new_used == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)F.shards * F.count;
  lane_shard_fold<<<(unsigned)((total + FOLD_THREADS - 1) / FOLD_THREADS),
                    FOLD_THREADS, 0, (cudaStream_t)stream>>>(F);
  return (int)cudaGetLastError();
}

}  // extern "C"
