// Node-sharded placement for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the jitted TPU kernels the reference runs on a node-sharded
// view, where GSPMD partitions them over a (batch, nodes) mesh of devices:
//   K9   `_batch_place` (nomad_tpu/parallel/mesh.py:287) under the mesh
//        shardings of `place_batch_sharded` (:292), and `_step` (:303)
//        under `scheduler_step` (:318) — K6 (the vmap of K1 over B
//        independent programs) with the cluster's node axis split into row
//        shards, plus the fold of the programs' carries into the snapshot;
//   B10  `place_packed_chain` / `place_task_group_chain`
//        (nomad_tpu/kernels/placement.py:802, :778) on a sharded view, the
//        coordinator's route under a mesh: K4's programs in order, each
//        shard passing its own (used, dyn_free) carry from program to
//        program (`_chain_with_carry`, :754, with the node axis split);
//   B11  `place_task_group` (:345) on a sharded view, with explain: B10 at
//        one program.
// GSPMD turns K1's global argmax (and explain's top-K and counts) into
// local ones and cross-device reductions; this file does the same by hand.
//
// The host (kernels/shard.py) gives each shard the program fields of its
// batch row with the row indices rebased to the shard (idx − row0, −1
// outside it; pads are −1 already), a node-width extra_mask sliced, and
// the preferred rows left global. Per dispatch and batch row of Bp
// programs (K9), or per program of a chain (B10, B11), with S shards:
//   1. shard_static (per shard): grid (shard rows / 256, Bp), in chunks of
//      65535 programs. K1's static pass on the shard's rows; for K9 also
//      the plan's deltas subtracted into the program's carry.
//   2. per step, M times:
//      a. shard_step (per shard): one 1024-thread block per program.
//         First it applies the previous step's winner (the owner adds the
//         ask to its row and bumps the counts; every shard adds the
//         winner's spread and distinct_property tokens to its copy of the
//         replicated counts, the same adds in the same order). A chain's
//         step 0 first takes the carry-dependent half of the static pass
//         against the shard's carry (place_core.cuh `carry_in`). Then K1's
//         step on the shard's rows (`step_rows`, the code K1, K4 and K5
//         run) and the block argmax, and one record per program: the best
//         (score, global row), that row's ok flag and tokens, the fit
//         count, the feasible count (step 0), and the preferred row's ok,
//         score and tokens if this shard owns it. With explain the record
//         adds the step's filter counts, the shard's own top-K (K rounds of
//         the argmax over its rows, as K1's scan; fewer rows than K leave
//         empty entries) and at step 0 the static filter counts.
//      b. the records are copied to the lead device (node shard 0) by the
//         caller, on the devices' current streams.
//      c. shard_combine (lead): one thread per program. The max score,
//         the lowest global row among equal scores (jnp.argmax's first
//         index): every row at the −1e30 floor gives global row 0, not
//         found. The preferred-row override with the owner's ok, the fit
//         counts summed, sel_idx / sel_score / nodes_fit (and
//         nodes_feasible) written, and the winner record (found, row,
//         tokens) copied back to every shard by the caller. With explain:
//         the counts summed over shards (i32, exact in any order) and the
//         shards' top-K merged into the global top-K, score descending and
//         the lowest global row first among equal scores — lax.top_k's
//         order, also for the many rows at the −1e30 floor.
//   3. shard_step with apply only: the last step's winner; a chain's
//      shards then take the dyn_free carry update of the rows they own.
//   4. shard_fold (scheduler_step only, per node shard): one thread per
//      element, used + Σ_b (new_used_b − used) in ascending b; the partial
//      sum passes from batch row to batch row in order.
// No host sync inside a dispatch.
//
// What bounds it on this card: latency, as K1. Each step of a shard is one
// launch whose blocks stride over the shard's rows, then a copy of a few
// words per program, a one-thread-per-program combine and a copy back;
// per step that is 3S + 1 launches and copies per batch row, or per
// program of a chain. The work per step is K1's over N / S rows; when the
// shards share one card their step launches queue on its one stream, so a
// step costs S launches of N / S rows plus the combine. The bound is K1's,
// K4's or K6's operations over the card's fp32 rate, or the bytes of the
// view, the programs and the outputs, whichever is larger; chip_smoke.py
// computes it from the run's inputs.

#include "place_core.cuh"

extern "C" {

// One step of one shard's programs.
struct ShardStep {
  int step;        // the step to evaluate; m = apply only
  int apply;       // apply the previous step's winners first
  int row0;        // the shard's first global row
  int rec_words;   // shard_rec_words()
  int win_words;   // 2 + s + p
  int* rec;        // [progs, rec_words] this step's records
  const int* win;  // [progs, win_words] the previous step's winners
  float* counts;   // [progs, s·sv + p·dv] this shard's replicated counts
  float* dyn_c;    // a chain's [n] dyn_free carry (one program), else null
  int* taken;      // a chain's [m] local rows it placed on (−1: none)
};

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

__global__ void shard_static(const PlaceArgs* progs, int carry) {
  __shared__ __align__(16) PlaceArgs A;
  load_args(&A, progs + blockIdx.y);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= A.n) return;
  static_row(A, n);
  if (carry) static_row_carry(A, n);
}

// The explain part of a step's record (the whole block; after the step's
// block_argmax, which published mbuf and the counts).
__device__ void explain_record(const PlaceArgs& A, const Smem& S,
                               const ShardStep& T, int* r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int* ex = r + shard_ex(A);
  if (tid == 0) {
    ex[0] = S.cnt[1];
    ex[1] = S.cnt[2];
    ex[2] = S.cnt[3];
    ex[3] = S.cnt[4];
    for (int q = 0; q < A.r; ++q) ex[4 + q] = S.cnt[6 + q];
  }
  int* tk = ex + 4 + A.r;
  // the shard's top-K: K rounds of the argmax, excluding rows taken
  for (int k = 0; k < A.topk; ++k) {
    Best b{LOWEST, NONE};
    for (int n = tid; n < A.n; n += nt) {
      bool skip = false;
      for (int q = 0; q < k; ++q) skip |= S.taken[q] == n;
      if (!skip) b = better(b, Best{A.mbuf[n], n});
    }
    b = block_argmax(b, S.red);
    if (tid == 0) {
      S.taken[k] = b.i;
      const bool valid = b.i < A.n;
      const float keep = valid && b.v > NEG_INF / 2 ? 1.0f : 0.0f;
      int* e = tk + TOPK_WORDS * k;
      e[0] = __float_as_int(b.v);
      e[1] = valid ? T.row0 + b.i : NONE;
      for (int q = 0; q < N_PARTS; ++q)
        e[2 + q] = __float_as_int(
            valid ? A.parts[(size_t)b.i * N_PARTS + q] * keep : 0.0f);
    }
    __syncthreads();
  }
  if (T.step == 0) {
    int* st = tk + TOPK_WORDS * A.topk;
    if (tid == 0) {
      st[0] = A.ex_static[0];
      st[1] = A.ex_static[1];
      st[2] = A.ex_static[2];
    }
    for (int c = tid; c < A.c; c += nt) st[3 + c] = A.filt_constraint[c];
  }
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
shard_step(const PlaceArgs* progs, ShardStep T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) PlaceArgs A;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  load_args(&A, progs + b);
  Smem S = carve(A, smem_raw);
  const int sc = A.s * A.sv, dc = A.p * A.dv;
  float* counts = T.counts + (size_t)b * (sc + dc);
  if (T.apply) {
    for (int i = tid; i < sc; i += nt) S.scounts[i] = counts[i];
    for (int i = tid; i < dc; i += nt) S.dcounts[i] = counts[sc + i];
  } else {
    init_counts(A, S);
  }
  __syncthreads();
  if (T.apply && tid == 0) {
    const int* w = T.win + (size_t)b * T.win_words;
    int local = -1;
    if (w[0]) {
      local = w[1] - T.row0;
      if (local >= 0 && local < A.n) take_row(A, local);
      else local = -1;
      count_tokens(A, S, w + 2, w + 2 + A.s);
    }
    if (T.taken != nullptr) {
      T.taken[T.step - 1] = local;
      if (T.step == A.m) carry_out_dyn(A, T.taken, T.dyn_c);
    }
  }
  __syncthreads();
  if (T.dyn_c != nullptr && T.step == 0 && !T.apply)
    carry_in(A, A.new_used, T.dyn_c);

  if (T.step < A.m) {
    const ScanConsts C = scan_consts(A);
    if (T.step == 0) static_counts(A, S);
    begin_step(A, S);
    Best best = step_rows(A, S, C, T.step);
    best = block_argmax(best, S.red);  // its barriers publish mbuf/okbuf
    int* r = T.rec + (size_t)b * T.rec_words;
    if (tid == 0) {
      const int tw = A.s + A.p;
      r[0] = __float_as_int(best.v);
      r[1] = T.row0 + best.i;
      r[2] = A.okbuf[best.i];
      r[3] = S.cnt[0];
      r[4] = T.step == 0 ? *A.nodes_feasible : 0;
      for (int s = 0; s < A.s; ++s) r[7 + s] = A.stok[(size_t)best.i * A.s + s];
      for (int q = 0; q < A.p; ++q) r[7 + A.s + q] = A.dtok[(size_t)best.i * A.p + q];
      const int pref = A.preferred_idx[T.step] - T.row0;
      const bool owned = A.preferred_idx[T.step] >= 0 && pref >= 0 && pref < A.n;
      const bool pref_ok = owned && A.okbuf[pref];
      r[5] = pref_ok;
      r[6] = __float_as_int(pref_ok ? A.mbuf[pref] : 0.0f);
      for (int s = 0; s < A.s; ++s)
        r[7 + tw + s] = pref_ok ? A.stok[(size_t)pref * A.s + s] : 0;
      for (int q = 0; q < A.p; ++q)
        r[7 + tw + A.s + q] = pref_ok ? A.dtok[(size_t)pref * A.p + q] : 0;
    }
    if (A.explain) explain_record(A, S, T, r);
  }
  for (int i = tid; i < sc; i += nt) counts[i] = S.scounts[i];
  for (int i = tid; i < dc; i += nt) counts[sc + i] = S.dcounts[i];
}

// The explain outputs of program `g` at this step from its shards'
// records `r0` (shard stride `stride`).
__device__ void combine_explain(const PlaceArgs& A, const ShardCombine& C,
                                const int* r0, size_t stride, int g) {
  const int ex = shard_ex(A), K = A.topk, R = A.r;
  const size_t o = (size_t)g * C.m + C.step;
  int cnt[4] = {0, 0, 0, 0};
  for (int j = 0; j < C.shards; ++j)
    for (int q = 0; q < 4; ++q) cnt[q] += r0[j * stride + ex + q];
  C.filt_distinct[o] = cnt[0];
  C.filt_dp[o] = cnt[1];
  C.exh_dyn[o] = cnt[2];
  C.exh_res[o] = cnt[3];
  for (int q = 0; q < R; ++q) {
    int d = 0;
    for (int j = 0; j < C.shards; ++j) d += r0[j * stride + ex + 4 + q];
    C.exh_dim[o * R + q] = d;
  }
  // the global top-K: K rounds of the best entry not yet taken over the
  // shards' lists (each holds its shard's best rows in lax.top_k order)
  int picked[TOPK_MAX];
  for (int k = 0; k < K; ++k) {
    Best best{LOWEST, NONE};
    const int* from = nullptr;
    for (int j = 0; j < C.shards; ++j) {
      const int* tk = r0 + j * stride + ex + 4 + R;
      for (int e = 0; e < K; ++e) {
        const int* en = tk + TOPK_WORDS * e;
        const int row = en[1];
        if (row == NONE) continue;
        bool seen = false;
        for (int q = 0; q < k; ++q) seen |= picked[q] == row;
        if (seen) continue;
        const float v = __int_as_float(en[0]);
        if (from == nullptr || v > best.v || (v == best.v && row < best.i)) {
          best = Best{v, row};
          from = en;
        }
      }
    }
    picked[k] = best.i;
    const size_t t = o * K + k;
    C.topk_idx[t] = best.i;
    C.topk_score[t] = best.v;
    // (the shards offer min(K, rows) entries each, at least K in all)
    for (int q = 0; q < N_PARTS; ++q)
      C.topk_parts[t * N_PARTS + q] =
          from != nullptr ? __int_as_float(from[2 + q]) : 0.0f;
  }
  if (C.step == 0) {
    const int st = ex + 4 + R + TOPK_WORDS * K;
    for (int q = 0; q < 3 + A.c; ++q) {
      int v = 0;
      for (int j = 0; j < C.shards; ++j) v += r0[j * stride + st + q];
      if (q < 3) C.ex_static[(size_t)g * 3 + q] = v;
      else C.filt_constraint[(size_t)g * C.cstride + q - 3] = v;
    }
  }
}

__global__ void shard_combine(const PlaceArgs* progs, ShardCombine C) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= C.progs) return;
  const PlaceArgs& A = progs[b];
  const size_t stride = (size_t)C.progs * C.rec_words;
  const int* r0 = C.rec + (size_t)b * C.rec_words;
  int bj = 0, pj = -1, nfit = 0, nfeas = 0;
  Best best{__int_as_float(r0[0]), r0[1]};
  for (int j = 0; j < C.shards; ++j) {
    const int* r = r0 + j * stride;
    const Best c{__int_as_float(r[0]), r[1]};
    if (c.v > best.v || (c.v == best.v && c.i < best.i)) {  // better()
      best = c;
      bj = j;
    }
    nfit += r[3];
    nfeas += r[4];
    if (r[5]) pj = j;
  }
  const int g = C.prog0 + b;
  const int* rb = r0 + bj * stride;
  const bool pref_ok = pj >= 0;
  const int* rp = pref_ok ? r0 + pj * stride : rb;
  const int idx = pref_ok ? A.preferred_idx[C.step] : best.i;
  const bool found = (pref_ok || rb[2]) && C.step < *A.n_place;
  const size_t o = (size_t)g * C.m + C.step;
  C.sel_idx[o] = found ? idx : -1;
  C.sel_score[o] = found ? (pref_ok ? __int_as_float(rp[6]) : best.v) : 0.0f;
  C.nodes_fit[o] = nfit;
  if (C.step == 0) C.nodes_feasible[g] = nfeas;
  int* w = C.win + (size_t)b * C.win_words;
  const int tw = A.s + A.p;
  w[0] = found;
  w[1] = idx;
  const int* tok = pref_ok ? rp + 7 + tw : rb + 7;
  for (int t = 0; t < tw; ++t) w[2 + t] = tok[t];
  if (A.explain) combine_explain(A, C, r0, stride, g);
}

__global__ void shard_fold(const float* new_used, const float* used,
                           float* acc, float* out, int progs, int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const float u = used[e];
  float a = acc[e];
  for (int b = 0; b < progs; ++b) a = a + (new_used[(size_t)b * count + e] - u);
  acc[e] = a;
  if (out != nullptr) out[e] = u + a;
}

}  // namespace

extern "C" {

size_t nomad_shard_args_size() { return sizeof(PlaceArgs); }

const char* nomad_shard_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues the static pass of `progs` programs of one shard on `stream`
// (the current device must be the shard's), in chunks of MAX_GRID_Y
// programs; `carry` != 0 also writes each program's carry from the view
// (K9). `args0` is the host copy of program 0's arguments; `dev` the
// device array. Returns cudaGetLastError() (0 = ok).
int nomad_shard_static(const PlaceArgs* args0, const void* dev, int progs,
                       int carry, void* stream) {
  const PlaceArgs& A0 = *args0;
  if (A0.n <= 0 || A0.r < 2 || progs <= 0) return (int)cudaErrorInvalidValue;
  const int gx = (A0.n + STATIC_THREADS - 1) / STATIC_THREADS;
  for (int y0 = 0; y0 < progs; y0 += MAX_GRID_Y) {
    dim3 grid(gx, progs - y0 < MAX_GRID_Y ? progs - y0 : MAX_GRID_Y);
    shard_static<<<grid, STATIC_THREADS, 0, (cudaStream_t)stream>>>(
        (const PlaceArgs*)dev + y0, carry);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Enqueues one step (and/or the previous step's apply) of one shard.
int nomad_shard_step(const PlaceArgs* args0, const void* dev, int progs,
                     const ShardStep* step, void* stream) {
  const PlaceArgs& A0 = *args0;
  if (A0.n <= 0 || A0.r < 2 || progs <= 0 || step->step > A0.m ||
      step->rec_words != shard_rec_words(A0) ||
      step->win_words != 2 + A0.s + A0.p || A0.topk > TOPK_MAX ||
      ((step->dyn_c != nullptr) != (step->taken != nullptr)) ||
      (step->dyn_c != nullptr && progs != 1))
    return (int)cudaErrorInvalidValue;
  size_t shm = smem_bytes(A0);
  if (shm + sizeof(PlaceArgs) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        shard_step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  shard_step<<<progs, SCAN_THREADS, shm, (cudaStream_t)stream>>>(
      (const PlaceArgs*)dev, *step);
  return (int)cudaGetLastError();
}

// Enqueues the combine of the shards' records on the lead device; `dev`
// is the lead shard's device argument array (from the combined programs).
int nomad_shard_combine(const void* dev, const ShardCombine* c, void* stream) {
  if (c->progs <= 0 || c->shards <= 0 || c->step < 0 || c->step >= c->m ||
      c->prog0 < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  shard_combine<<<(c->progs + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>((const PlaceArgs*)dev, *c);
  return (int)cudaGetLastError();
}

// Enqueues acc += Σ_b (new_used[b] − used) over `progs` carries of
// `count` floats, in ascending b; with `out`, also out = used + acc.
int nomad_shard_fold(const float* new_used, const float* used, float* acc,
                     float* out, int progs, int count, void* stream) {
  if (progs < 0 || count <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  shard_fold<<<(count + threads - 1) / threads, threads, 0,
               (cudaStream_t)stream>>>(new_used, used, acc, out, progs, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
