// Node-sharded batched placement for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the jitted TPU kernel K9 (nomad_tpu/parallel/mesh.py):
// `_batch_place` (:287) under the mesh shardings of `place_batch_sharded`
// (:292), and `_step` (:303) under `scheduler_step` (:318) — K6 (the vmap
// of K1 over B independent programs) with the cluster's node axis split
// into row shards over a (batch, nodes) mesh of devices, so that no device
// holds the whole cluster, plus the fold of the programs' carries into
// the snapshot. GSPMD turns K1's global argmax into a local argmax and a
// cross-device reduction; this file does the same by hand.
//
// The host (kernels/shard.py) gives each shard the program fields of its
// batch row with the row indices rebased to the shard (idx − row0, −1
// outside it; pads are −1 already), a node-width extra_mask sliced, and
// the preferred rows left global. Per dispatch and batch row of Bp
// programs, with S node shards:
//   1. shard_static (per shard): grid (shard rows / 256, Bp). K1's static
//      pass on the shard's rows, the plan's deltas subtracted into the
//      program's carry.
//   2. per step, M times:
//      a. shard_step (per shard): one 1024-thread block per program.
//         First it applies the previous step's winner (the owner adds the
//         ask to its row and bumps the counts; every shard adds the
//         winner's spread and distinct_property tokens to its copy of the
//         replicated counts, the same adds in the same order). Then K1's
//         step on the shard's rows (place_core.cuh `step_rows`, the code
//         K1, K4 and K5 run) and the block argmax, and one record per
//         program: the best (score, global row), that row's ok flag and
//         tokens, the fit count, the feasible count (step 0), and the
//         preferred row's ok, score and tokens if this shard owns it.
//      b. the records are copied to the batch row's lead device (node
//         shard 0) by the caller, on the devices' current streams.
//      c. shard_combine (lead): one thread per program. The max score,
//         the lowest global row among equal scores (jnp.argmax's first
//         index): every row at the −1e30 floor gives global row 0, not
//         found. The preferred-row override with the owner's ok, the fit
//         counts summed, sel_idx / sel_score / nodes_fit (and
//         nodes_feasible) written, and the winner record (found, row,
//         tokens) copied back to every shard by the caller.
//   3. shard_step with apply only: the last step's winner.
//   4. shard_fold (scheduler_step only, per node shard): one thread per
//      element, used + Σ_b (new_used_b − used) in ascending b; the partial
//      sum passes from batch row to batch row in order.
// No host sync inside the M steps.
//
// What bounds it on this card: latency, as K1. Each step of a shard is one
// launch whose blocks stride over the shard's rows, then a copy of a few
// words per program, a one-thread-per-program combine and a copy back;
// per step that is 3S + 1 launches and copies per batch row. The work per
// step is K1's over N / S rows; when the shards share one card their
// step launches queue on its one stream, so a step costs S launches of
// N / S rows plus the combine. The bound is K6's: B programs' operations
// over the card's fp32 rate (≈ 0.0003 ms a program at N = 16384, M = 16),
// or the bytes of the view, the programs and the outputs, whichever is
// larger; chip_smoke.py computes it from the run's inputs.

#include "place_core.cuh"

extern "C" {

// One step of one shard's programs.
struct ShardStep {
  int step;        // the step to evaluate; m = apply only
  int apply;       // apply the previous step's winners first
  int row0;        // the shard's first global row
  int rec_words;   // 7 + 2 (s + p)
  int win_words;   // 2 + s + p
  int* rec;        // [progs, rec_words] this step's records
  const int* win;  // [progs, win_words] the previous step's winners
  float* counts;   // [progs, s·sv + p·dv] this shard's replicated counts
};

// The combine of one batch row's shard records on its lead device.
struct ShardCombine {
  int step, shards, progs, m, rec_words, win_words;
  const int* rec;       // [shards, progs, rec_words]
  int* win;             // [progs, win_words]
  int* sel_idx;         // [progs, m]
  float* sel_score;     // [progs, m]
  int* nodes_fit;       // [progs, m]
  int* nodes_feasible;  // [progs]
};

}  // extern "C"

namespace {

__global__ void shard_static(const PlaceArgs* progs) {
  __shared__ __align__(16) PlaceArgs A;
  load_args(&A, progs + blockIdx.y);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= A.n) return;
  static_row(A, n);
  static_row_carry(A, n);
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
    if (w[0]) {
      const int local = w[1] - T.row0;
      if (local >= 0 && local < A.n) take_row(A, local);
      count_tokens(A, S, w + 2, w + 2 + A.s);
    }
  }
  __syncthreads();

  if (T.step < A.m) {
    const ScanConsts C = scan_consts(A);
    if (T.step == 0) static_counts(A, S);
    begin_step(A, S);
    Best best = step_rows(A, S, C, T.step);
    best = block_argmax(best, S.red);  // its barriers publish mbuf/okbuf
    if (tid == 0) {
      int* r = T.rec + (size_t)b * T.rec_words;
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
  }
  for (int i = tid; i < sc; i += nt) counts[i] = S.scounts[i];
  for (int i = tid; i < dc; i += nt) counts[sc + i] = S.dcounts[i];
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
  const int* rb = r0 + bj * stride;
  const bool pref_ok = pj >= 0;
  const int* rp = pref_ok ? r0 + pj * stride : rb;
  const int idx = pref_ok ? A.preferred_idx[C.step] : best.i;
  const bool found = (pref_ok || rb[2]) && C.step < *A.n_place;
  const size_t o = (size_t)b * C.m + C.step;
  C.sel_idx[o] = found ? idx : -1;
  C.sel_score[o] = found ? (pref_ok ? __int_as_float(rp[6]) : best.v) : 0.0f;
  C.nodes_fit[o] = nfit;
  if (C.step == 0) C.nodes_feasible[b] = nfeas;
  int* w = C.win + (size_t)b * C.win_words;
  const int tw = A.s + A.p;
  w[0] = found;
  w[1] = idx;
  const int* tok = pref_ok ? rp + 7 + tw : rb + 7;
  for (int t = 0; t < tw; ++t) w[2 + t] = tok[t];
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
// (the current device must be the shard's). `args0` is the host copy of
// program 0's arguments; `dev` the device array. Returns
// cudaGetLastError() (0 = ok).
int nomad_shard_static(const PlaceArgs* args0, const void* dev, int progs,
                       void* stream) {
  const PlaceArgs& A0 = *args0;
  if (A0.n <= 0 || A0.r < 2 || progs <= 0 || progs > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((A0.n + STATIC_THREADS - 1) / STATIC_THREADS, progs);
  shard_static<<<grid, STATIC_THREADS, 0, (cudaStream_t)stream>>>(
      (const PlaceArgs*)dev);
  return (int)cudaGetLastError();
}

// Enqueues one step (and/or the previous step's apply) of one shard.
int nomad_shard_step(const PlaceArgs* args0, const void* dev, int progs,
                     const ShardStep* step, void* stream) {
  const PlaceArgs& A0 = *args0;
  if (A0.n <= 0 || A0.r < 2 || progs <= 0 || step->step > A0.m ||
      step->rec_words != 7 + 2 * (A0.s + A0.p) ||
      step->win_words != 2 + A0.s + A0.p)
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

// Enqueues the combine of one batch row's records on its lead device;
// `dev` is the lead shard's device argument array.
int nomad_shard_combine(const void* dev, const ShardCombine* c, void* stream) {
  if (c->progs <= 0 || c->shards <= 0 || c->step < 0 || c->step >= c->m)
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
