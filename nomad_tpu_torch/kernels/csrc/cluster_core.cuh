// The step record of a thread-block cluster whose blocks split a view's
// rows, and its combine: shared by the sharded chain (shard.cu, a block a
// node shard) and the lane route (lanes.cu, a block a slice of a lane's
// rows). Each block stores one record a step — its best (score, global
// row), that row's ok flag and tokens, its fit (and at step 0 feasible)
// count, the preferred row's ok, score and tokens if the block holds it,
// and with explain its filter counts, its own top-K in lax.top_k's order
// with the score parts, and at step 0 its static filter counts — and one
// warp combines the records into the program's outputs and the winner.
#pragma once

#include "place_core.cuh"

namespace {

// the largest thread-block cluster the chain kernels form: the portable
// cluster size of sm_90
constexpr int MAX_CLUSTER = 8;

}  // namespace

extern "C" {

// The combine of the shards' records on the lead device.
struct ShardCombine {
  int step, shards, progs, m, rec_words, win_words;
  int prog0;            // the first program's index in the outputs
  int cstride;          // row width of filt_constraint
  const int* rec;       // [shards, progs, rec_words]
  int* win;             // [progs, win_words]
  int* sel_idx;         // [P, m]
  float* sel_score;     // [P, m]
  int* nodes_fit;       // [P, m]
  int* nodes_feasible;  // [P]
  // explain (the lead program's PlaceArgs.explain), leading axis P
  int* ex_static;        // [P, 3]: evaluated, filt_lut, filt_extra
  int* filt_constraint;  // [P, cstride]
  int* filt_distinct;    // [P, m]
  int* filt_dp;          // [P, m]
  int* exh_dim;          // [P, m, r]
  int* exh_dyn;          // [P, m]
  int* exh_res;          // [P, m]
  int* topk_idx;         // [P, m, topk]
  float* topk_score;     // [P, m, topk]
  float* topk_parts;     // [P, m, topk, 5]
};

}  // extern "C"

namespace {

constexpr int NONE = 0x7fffffff;  // an empty top-K entry's row
constexpr int TOPK_MAX = 8;
constexpr int TOPK_WORDS = 2 + N_PARTS;  // score bits, global row, parts

// A record: [0] best score bits, [1] best global row, [2] its ok flag,
// [3] fit count, [4] feasible count (step 0), [5] preferred ok,
// [6] preferred score bits, [7, 7 + tw) best row's tokens, [7 + tw,
// 7 + 2 tw) preferred row's tokens (tw = s + p). With explain, from
// shard_ex(): 4 + r filter counts (distinct, dp, dyn ports, reserved
// ports, dims), topk entries of TOPK_WORDS, then (step 0) evaluated,
// filt_lut, filt_extra and c per-constraint counts.
__host__ __device__ inline int shard_ex(const PlaceArgs& A) {
  return 7 + 2 * (A.s + A.p);
}

__host__ __device__ inline int shard_rec_words(const PlaceArgs& A) {
  return shard_ex(A) +
         (A.explain ? 4 + A.r + TOPK_WORDS * A.topk + 3 + A.c : 0);
}

// The best (value, row) of the warp, on every lane (the rows unique, so
// every order of the shuffles picks the same one).
__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(FULL, b.v, off);
    o.i = __shfl_xor_sync(FULL, b.i, off);
    b = better(b, o);
  }
  return b;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The explain outputs of program `g` at this step from its shards'
// records (`rec(j)` shard j's), by one warp: the counts summed over the
// shards (i32, exact in any order), and the global top-K merged from the
// shards' lists by their heads (entries without a row skipped).
template <class Rec>
__device__ void combine_explain(const PlaceArgs& A, const ShardCombine& C,
                                Rec rec, int g) {
  const int lane = threadIdx.x & 31;
  const int ex = shard_ex(A), K = A.topk, R = A.r;
  const size_t o = (size_t)g * C.m + C.step;
  for (int q = lane; q < 4 + R; q += 32) {
    int v = 0;
    for (int j = 0; j < C.shards; ++j) v += rec(j)[ex + q];
    if (q == 0) C.filt_distinct[o] = v;
    else if (q == 1) C.filt_dp[o] = v;
    else if (q == 2) C.exh_dyn[o] = v;
    else if (q == 3) C.exh_res[o] = v;
    else C.exh_dim[o * R + q - 4] = v;
  }
  // K rounds over the heads of the shards' lists (each in lax.top_k
  // order, its empty entries last; a list's head is its entry after the
  // picks it gave): each lane offers the best head of its shards, the
  // warp takes the best offer
  int picks[TOPK_MAX];  // the shard each pick came from
  for (int k = 0; k < K; ++k) {
    Best mine{LOWEST, NONE};
    const int* from = nullptr;
    int mj = -1;
    for (int j = lane; j < C.shards; j += 32) {
      int head = 0;
      for (int q = 0; q < k; ++q) head += picks[q] == j;
      if (head >= K) continue;
      const int* en = rec(j) + ex + 4 + R + TOPK_WORDS * head;
      const Best b{__int_as_float(en[0]), en[1]};
      if (b.i == NONE) continue;
      if (from == nullptr || better(mine, b).i == b.i) {
        mine = b;
        from = en;
        mj = j;
      }
    }
    const Best last = warp_best(mine);
    // the entry's parts from the lane that offered it (none: zeros)
    const unsigned at = __ballot_sync(FULL, from != nullptr &&
                                                mine.i == last.i);
    const int* pick = nullptr;
    picks[k] = -1;
    if (at != 0) {
      const int src = __ffs(at) - 1;
      pick = (const int*)__shfl_sync(FULL, (unsigned long long)from, src);
      picks[k] = __shfl_sync(FULL, mj, src);
    }
    const size_t t = o * K + k;
    if (lane == 0) {
      C.topk_idx[t] = last.i;
      C.topk_score[t] = last.v;
    }
    // (the shards offer min(K, rows) entries each, at least K in all)
    if (lane < N_PARTS)
      C.topk_parts[t * N_PARTS + lane] =
          pick != nullptr ? __int_as_float(pick[2 + lane]) : 0.0f;
  }
  if (C.step == 0) {
    const int st = ex + 4 + R + TOPK_WORDS * K;
    for (int q = lane; q < 3 + A.c; q += 32) {
      int v = 0;
      for (int j = 0; j < C.shards; ++j) v += rec(j)[st + q];
      if (q < 3) C.ex_static[(size_t)g * 3 + q] = v;
      else C.filt_constraint[(size_t)g * C.cstride + q - 3] = v;
    }
  }
}

// The combine of program `g`'s step C.step by one warp: its outputs from
// the shards' records (`rec(j)` shard j's), the winner into `w`. The best
// (score, global row) over the shards, the fit and feasible counts summed,
// the preferred row from the (one) shard that owns it and found it ok;
// `n_place` the program's (*A.n_place). With `outputs` false only the
// winner (a block that combines its own copy of the records).
template <class Rec>
__device__ void combine_records(const PlaceArgs& A, const ShardCombine& C,
                                int g, Rec rec, int* w, int n_place,
                                bool outputs = true) {
  const int lane = threadIdx.x & 31;
  Best c{LOWEST, NONE};
  int cj = 0, pj = -1, nfit = 0, nfeas = 0;
  for (int j = lane; j < C.shards; j += 32) {
    const int* r = rec(j);
    const Best b{__int_as_float(r[0]), r[1]};
    if (j == lane || better(c, b).i == b.i) {  // the rows are distinct
      c = b;
      cj = j;
    }
    nfit += r[3];
    nfeas += r[4];
    if (r[5]) pj = j;
  }
  const Best best = warp_best(c);
  const unsigned at = __ballot_sync(FULL, lane < C.shards && c.i == best.i);
  const int bj = __shfl_sync(FULL, cj, __ffs(at) - 1);
  for (int off = 16; off > 0; off >>= 1)
    pj = max(pj, __shfl_xor_sync(FULL, pj, off));
  nfit = warp_sum(nfit);
  nfeas = warp_sum(nfeas);
  const int* rb = rec(bj);
  const bool pref_ok = pj >= 0;
  const int* rp = pref_ok ? rec(pj) : rb;
  const int idx = pref_ok ? A.preferred_idx[C.step] : best.i;
  const bool found = (pref_ok || rb[2]) && C.step < n_place;
  const size_t o = (size_t)g * C.m + C.step;
  if (lane == 0) {
    if (outputs) {
      C.sel_idx[o] = found ? idx : -1;
      C.sel_score[o] =
          found ? (pref_ok ? __int_as_float(rp[6]) : best.v) : 0.0f;
      C.nodes_fit[o] = nfit;
      if (C.step == 0) C.nodes_feasible[g] = nfeas;
    }
    w[0] = found;
    w[1] = idx;
  }
  const int tw = A.s + A.p;
  const int* tok = pref_ok ? rp + 7 + tw : rb + 7;
  for (int t = lane; t < tw; t += 32) w[2 + t] = tok[t];
  if (outputs && A.explain) combine_explain(A, C, rec, g);
}

// a record's words rounded up to 16 bytes
__host__ __device__ inline int round4(int words) { return (words + 3) & ~3; }

}  // namespace
