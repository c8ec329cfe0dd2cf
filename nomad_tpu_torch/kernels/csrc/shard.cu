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
// the preferred rows left global. One step of one shard's program
// (`step_body`, one 1024-thread block) first applies the previous step's
// winner (the owner adds the ask to its row and bumps the counts; every
// shard adds the winner's spread and distinct_property tokens to its copy
// of the replicated counts, the same adds in the same order); a chain's
// step 0 first takes the carry-dependent half of the static pass against
// the shard's carry (place_core.cuh `carry_in`). Then K1's step on the
// shard's rows (`step_rows`, the code K1, K4 and K5 run) and the block
// argmax, and one record: the best (score, global row), that row's ok flag
// and tokens, the fit count, the feasible count (step 0), and the
// preferred row's ok, score and tokens if this shard owns it. With
// explain the record adds the step's filter counts, the shard's own top-K
// (K rounds of the argmax over its rows, as K1's scan; fewer rows than K
// leave empty entries) and at step 0 the static filter counts. The
// combine of the shards' records (`combine_records`, one warp a program;
// the record format and the combine are cluster_core.cuh's):
// the max score, the lowest global row among equal scores
// (jnp.argmax's first index): every row at the −1e30 floor gives global
// row 0, not found. The preferred-row override with the owner's ok, the
// fit counts summed, sel_idx / sel_score / nodes_fit (and nodes_feasible)
// written, and the winner record (found, row, tokens) for every shard.
// With explain: the counts summed over shards (i32, exact in any order)
// and the shards' top-K merged into the global top-K, score descending
// and the lowest global row first among equal scores — lax.top_k's order,
// also for the many rows at the −1e30 floor.
//
// Two launch structures run those functions (K9 on S ≤ 8 node shards of
// one card takes a third, csrc/lanes.cu's lane route: kernels/shard.py
// `step_route`):
//   steps (K9, B10/B11 when the shards span devices or S > 8): per
//      dispatch and batch row of Bp programs (K9), or per program of a
//      chain, with S shards:
//      1. shard_static (per shard): grid (shard rows / 256, Bp), in chunks
//         of 65535 programs. K1's static pass on the shard's rows; for K9
//         also the plan's deltas subtracted into the program's carry.
//      2. per step, M times: shard_step (per shard, one block a program,
//         the counts through global memory); the records copied to the
//         lead device (node shard 0) by the caller; shard_combine on the
//         lead; the winner copied back to every shard.
//      3. shard_step with apply only: the last step's winner; a chain's
//         shards then take the dyn_free carry update of the rows they own.
//      4. shard_fold (scheduler_step only, per node shard): one thread per
//         element, used + Σ_b (new_used_b − used) in ascending b; the
//         partial sum passes from batch row to batch row in order.
//      That is S + P·(M·(3S + 1) + S) launches and copies a chain.
//   cluster (B10/B11 when batch row 0's S ≤ 8 shards share one card): two
//      launches a dispatch. shard_static over every shard (blockIdx.z the
//      shard), then shard_chain_cluster: S blocks, one a shard, as one
//      thread-block cluster on neighbouring SMs. Each block keeps its
//      counts, the winner and its taken rows in shared memory; per step
//      it runs `step_body` with its record stored into its slot in block
//      0's shared memory through distributed shared memory (stores only:
//      a remote load costs several times a local one, and the combine
//      reads every record word), the cluster meets at a hardware barrier,
//      block 0 runs the same combine over its S slots and stores the
//      winner into every block's shared memory, and the cluster meets
//      again. All P·(M + 1) steps run inside the launch; with snapshots
//      each block writes its carry after each program into a [P, N, R]
//      buffer.
// No host sync inside a dispatch. Both structures run the same device
// functions in the same order, so their outputs are bitwise equal.
//
// What bounds it on this card: latency, as K1. The work per step is K1's
// over N / S rows on one SM a shard; the steps of a chain depend on each
// other. The steps route adds 3S + 1 host calls a step (≈ 20 µs each) and
// its launches queue on one stream when the shards share a card; the
// cluster route replaces them with two cluster barriers a step. What is
// left a step is the scan over N / S rows and, with explain, K rounds of
// a block-wide argmax for the shard's top-K and block 0's serial merge of
// the S lists (PERF.md has the times). The bound is K1's, K4's or K6's
// operations over the card's fp32 rate, or the bytes of the view, the
// programs and the outputs, whichever is larger; chip_smoke.py computes
// it from the run's inputs.

#include <cooperative_groups.h>

#include "cluster_core.cuh"

namespace cg = cooperative_groups;

extern "C" {

// One step of one shard's programs.
struct ShardStep {
  int step;        // the step to evaluate; m = apply only
  int apply;       // apply the previous step's winner first
  int row0;        // the shard's first global row
  int rec_words;   // shard_rec_words()
  int win_words;   // 2 + s + p
  int* rec;        // [progs, rec_words] this step's records
  const int* win;  // [progs, win_words] the previous step's winners
  float* counts;   // [progs, s·sv + p·dv] this shard's replicated counts
  float* dyn_c;    // a chain's [n] dyn_free carry (one program), else null
  int* taken;      // a chain's [m] local rows it placed on (−1: none)
};

// A whole chain dispatch on one card: the static pass of every shard and
// the cluster launch.
struct ShardChain {
  int shards;      // S, node shards of batch row 0 (the cluster's size)
  int progs;       // P programs, in order
  int m;           // steps a program
  int scan_bytes;  // smem_bytes() of the programs (the entry point's)
  int n;           // global rows (the snapshot's)
  const PlaceArgs* args[MAX_CLUSTER];  // shard j's [progs] PlaceArgs
  int row0[MAX_CLUSTER];               // shard j's first global row
  float* dyn_c[MAX_CLUSTER];           // shard j's [rows] dyn_free carry
  float* snap;       // [progs, n, r] the carry after each program, or null
  ShardCombine out;  // the outputs (step set per step; rec, win unused)
};

}  // extern "C"

namespace {

// The programs of up to MAX_CLUSTER shards of one device.
struct ShardProgs {
  const PlaceArgs* p[MAX_CLUSTER];
};

// grid (rows / STATIC_THREADS, programs of this chunk, shards)
__global__ void shard_static(ShardProgs P, int y0, int carry) {
  __shared__ __align__(16) PlaceArgs A;
  load_args(&A, P.p[blockIdx.z] + y0 + blockIdx.y);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= A.n) return;
  static_row(A, n);
  if (carry) static_row_carry(A, n);
}

constexpr int WARPS = SCAN_THREADS / 32;
// the static shared memory of explain_record's per-warp top-K lists
constexpr size_t LIST_BYTES = sizeof(Best) * WARPS * TOPK_MAX;

// `c` comes after `last` in top-K order (value descending, then row
// ascending): the entries left once `last` is taken, the rows unique.
__device__ __forceinline__ bool after(Best c, Best last) {
  return c.v < last.v || (c.v == last.v && c.i > last.i);
}

// The explain part of a step's record (the whole block; after the step's
// block_argmax, which published mbuf and the counts). The shard's top-K
// is lax.top_k's over its rows (value descending, the lower row first):
// each warp takes the top-K of its lanes' rows, K rounds of a warp argmax
// over the rows after its last pick, and warp 0 merges the warps' lists,
// K rounds over their heads — the K picks of K rounds of a block argmax,
// with one block barrier where those take 3K.
__device__ void explain_record(const PlaceArgs& A, const Smem& S, int step,
                               int row0, int* r) {
  __shared__ Best lists[WARPS * TOPK_MAX];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, K = A.topk;
  int* ex = r + shard_ex(A);
  if (tid == 0) {
    ex[0] = S.cnt[1];
    ex[1] = S.cnt[2];
    ex[2] = S.cnt[3];
    ex[3] = S.cnt[4];
    for (int q = 0; q < A.r; ++q) ex[4 + q] = S.cnt[6 + q];
  }
  Best last{LOWEST, NONE};
  for (int k = 0; k < K; ++k) {
    Best b{LOWEST, NONE};
    for (int n = tid; n < A.n; n += nt) {
      const Best c{A.mbuf[n], n};
      if (k == 0 || after(c, last)) b = better(b, c);
    }
    last = warp_best(b);
    if (lane == 0) lists[warp * TOPK_MAX + k] = last;
  }
  __syncthreads();
  int* tk = ex + 4 + A.r;
  if (warp == 0) {
    const int nw = nt >> 5;
    int head = 0;
    for (int k = 0; k < K; ++k) {
      const Best mine = lane < nw && head < K ? lists[lane * TOPK_MAX + head]
                                              : Best{LOWEST, NONE};
      const Best b = warp_best(mine);
      const bool valid = b.i < A.n;
      if (valid && mine.i == b.i) ++head;
      const float keep = valid && b.v > NEG_INF / 2 ? 1.0f : 0.0f;
      int* e = tk + TOPK_WORDS * k;
      if (lane == 0) {
        e[0] = __float_as_int(b.v);
        e[1] = valid ? row0 + b.i : NONE;
      }
      if (lane < N_PARTS)
        e[2 + lane] = __float_as_int(
            valid ? A.parts[(size_t)b.i * N_PARTS + lane] * keep : 0.0f);
    }
  }
  if (step == 0) {
    int* st = tk + TOPK_WORDS * K;
    if (tid == 0) {
      st[0] = A.ex_static[0];
      st[1] = A.ex_static[1];
      st[2] = A.ex_static[2];
    }
    for (int c = tid; c < A.c; c += nt) st[3 + c] = A.filt_constraint[c];
  }
}

// One step of one shard's program, by the whole block, its replicated
// counts in S: with `apply` the previous step's winner `w` first (a chain
// records the local row it took in `taken` and, after its last step,
// takes the dyn_free carry update into `dyn_c`); a chain's carry taken in
// at step 0; then step `step` (< A.m) into the record `r`.
__device__ void step_body(const PlaceArgs& A, const Smem& S, int step,
                          bool apply, int row0, int* r, const int* w,
                          int* taken, float* dyn_c) {
  const int tid = threadIdx.x;
  if (apply && tid == 0) {
    int local = -1;
    if (w[0]) {
      local = w[1] - row0;
      if (local >= 0 && local < A.n) take_row(A, local);
      else local = -1;
      count_tokens(A, S, w + 2, w + 2 + A.s);
    }
    if (taken != nullptr) {
      taken[step - 1] = local;
      if (step == A.m) carry_out_dyn(A, taken, dyn_c);
    }
  }
  __syncthreads();
  if (dyn_c != nullptr && step == 0 && !apply)
    carry_in(A, A.new_used, dyn_c);

  if (step < A.m) {
    const ScanConsts C = scan_consts(A);
    if (step == 0) static_counts(A, S);
    begin_step(A, S);
    Best best = step_rows(A, S, C, step);
    best = block_argmax(best, S.red);  // its barriers publish mbuf/okbuf
    if (tid == 0) {
      const int tw = A.s + A.p;
      r[0] = __float_as_int(best.v);
      r[1] = row0 + best.i;
      r[2] = A.okbuf[best.i];
      r[3] = S.cnt[0];
      r[4] = step == 0 ? *A.nodes_feasible : 0;
      for (int s = 0; s < A.s; ++s) r[7 + s] = A.stok[(size_t)best.i * A.s + s];
      for (int q = 0; q < A.p; ++q) r[7 + A.s + q] = A.dtok[(size_t)best.i * A.p + q];
      const int pref = A.preferred_idx[step] - row0;
      const bool owned = A.preferred_idx[step] >= 0 && pref >= 0 && pref < A.n;
      const bool pref_ok = owned && A.okbuf[pref];
      r[5] = pref_ok;
      r[6] = __float_as_int(pref_ok ? A.mbuf[pref] : 0.0f);
      for (int s = 0; s < A.s; ++s)
        r[7 + tw + s] = pref_ok ? A.stok[(size_t)pref * A.s + s] : 0;
      for (int q = 0; q < A.p; ++q)
        r[7 + tw + A.s + q] = pref_ok ? A.dtok[(size_t)pref * A.p + q] : 0;
    }
    if (A.explain) explain_record(A, S, step, row0, r);
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
  step_body(A, S, T.step, T.apply != 0, T.row0,
            T.rec + (size_t)b * T.rec_words,
            T.win + (size_t)b * T.win_words, T.taken, T.dyn_c);
  for (int i = tid; i < sc; i += nt) counts[i] = S.scounts[i];
  for (int i = tid; i < dc; i += nt) counts[sc + i] = S.dcounts[i];
}

// one warp a program
__global__ void shard_combine(const PlaceArgs* progs, ShardCombine C) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (b >= C.progs) return;
  const size_t stride = (size_t)C.progs * C.rec_words;
  const int* r0 = C.rec + (size_t)b * C.rec_words;
  combine_records(progs[b], C, C.prog0 + b,
                  [&](int j) { return r0 + j * stride; },
                  C.win + (size_t)b * C.win_words, *progs[b].n_place);
}

// Words of the chain kernel's own shared memory after the scan's carve:
// a record slot a shard (read on block 0), the winner, the taken rows.
__host__ inline size_t chain_smem(const ShardChain& Q) {
  return (size_t)Q.scan_bytes +
         4 * (size_t)(Q.shards * round4(Q.out.rec_words) +
                      round4(Q.out.win_words) + Q.m);
}

// A whole chain on one card, one block a node shard, the S blocks one
// thread-block cluster: for each program, for each step 0..M, the step
// with its record stored into the shard's slot in block 0's shared memory
// (through distributed shared memory: remote stores, no remote loads), a
// cluster barrier, block 0's combine over the S slots (the winner stored
// into every block's shared memory), a cluster barrier. Every block runs
// every barrier: the loop bounds and the step's branches are the same in
// all of them.
__global__ void __launch_bounds__(SCAN_THREADS, 1)
shard_chain_cluster(ShardChain Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) PlaceArgs A;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank(), tid = threadIdx.x;
  const int nt = blockDim.x;
  const int stride = round4(Q.out.rec_words);
  int* slots = (int*)(smem_raw + Q.scan_bytes);  // [S, stride] on block 0
  int* win = slots + Q.shards * stride;
  int* taken = win + round4(Q.out.win_words);
  int* rec = j == 0 ? slots : cluster.map_shared_rank(slots + j * stride, 0);
  const int row0 = Q.row0[j];
  float* dyn_c = Q.dyn_c[j];

  for (int k = 0; k < Q.progs; ++k) {
    __syncthreads();  // the previous program's last reads of A are done
    load_args(&A, Q.args[j] + k);
    Smem S = carve(A, smem_raw);
    for (int step = 0; step <= Q.m; ++step) {
      if (step == 0) {
        init_counts(A, S);
        __syncthreads();
      }
      step_body(A, S, step, step > 0, row0, rec, win, taken, dyn_c);
      if (step < Q.m) {
        cluster.sync();  // every shard's record is written
        if (j == 0 && tid < 32) {
          ShardCombine C = Q.out;
          C.step = step;
          combine_records(A, C, k,
                          [&](int q) { return slots + q * stride; }, win,
                          *A.n_place);
          __syncwarp();
          for (int q = 1; q < Q.shards; ++q) {
            int* wq = cluster.map_shared_rank(win, q);
            for (int t = tid; t < Q.out.win_words; t += 32) wq[t] = win[t];
          }
        }
        cluster.sync();  // the winner is in every shard
      }
    }
    if (Q.snap != nullptr) {
      float* dst = Q.snap + ((size_t)k * Q.n + row0) * A.r;
      const int count = A.n * A.r;
      for (int i = tid; i < count; i += nt) dst[i] = A.new_used[i];
    }
  }
  // no block leaves while another may still touch its shared memory
  cluster.sync();
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

// The static pass of `progs` programs of `shards` shards in chunks of
// MAX_GRID_Y programs.
int launch_static(const PlaceArgs& A0, const ShardProgs& P, int shards,
                  int progs, int carry, cudaStream_t stream) {
  const int gx = (A0.n + STATIC_THREADS - 1) / STATIC_THREADS;
  for (int y0 = 0; y0 < progs; y0 += MAX_GRID_Y) {
    dim3 grid(gx, progs - y0 < MAX_GRID_Y ? progs - y0 : MAX_GRID_Y, shards);
    shard_static<<<grid, STATIC_THREADS, 0, stream>>>(P, y0, carry);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The checks a chain dispatch on one card shares between its two launches.
bool chain_ok(const PlaceArgs& A0, const ShardChain& Q) {
  const ShardCombine& C = Q.out;
  if (Q.shards < 1 || Q.shards > MAX_CLUSTER || Q.progs < 1 || Q.m < 1 ||
      A0.n <= 0 || A0.r < 2 || A0.m != Q.m || Q.n != A0.n * Q.shards ||
      C.shards != Q.shards || C.m != Q.m || C.progs != 1 || C.prog0 != 0 ||
      C.rec_words != shard_rec_words(A0) || C.win_words != 2 + A0.s + A0.p ||
      A0.topk > TOPK_MAX)
    return false;
  for (int j = 0; j < Q.shards; ++j)
    if (Q.args[j] == nullptr || Q.dyn_c[j] == nullptr) return false;
  return true;
}

}  // namespace

extern "C" {

size_t nomad_shard_args_size() { return sizeof(PlaceArgs); }

size_t nomad_shard_chain_size() { return sizeof(ShardChain); }

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
  ShardProgs P = {};
  P.p[0] = (const PlaceArgs*)dev;
  return launch_static(A0, P, 1, progs, carry, (cudaStream_t)stream);
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
  if (shm + sizeof(PlaceArgs) + LIST_BYTES > 48 * 1024) {
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
  const int threads = 128, per_block = threads / 32;
  shard_combine<<<(c->progs + per_block - 1) / per_block, threads, 0,
                  (cudaStream_t)stream>>>((const PlaceArgs*)dev, *c);
  return (int)cudaGetLastError();
}

// Enqueues the static pass of a chain dispatch on one card: every
// program of every shard in one launch (blockIdx.z the shard). `args0` is
// the host copy of shard 0's program 0. Refuses what nomad_shard_chain
// refuses.
int nomad_shard_static_shards(const PlaceArgs* args0, const ShardChain* q,
                              void* stream) {
  if (!chain_ok(*args0, *q)) return (int)cudaErrorInvalidValue;
  ShardProgs P = {};
  for (int j = 0; j < q->shards; ++j) P.p[j] = q->args[j];
  return launch_static(*args0, P, q->shards, q->progs, 0,
                       (cudaStream_t)stream);
}

// Enqueues the rest of a chain dispatch on one card: one launch of
// shard_chain_cluster, S blocks as one cluster of S (at most 8, the
// portable cluster size). Returns a CUDA error (0 = ok) when the
// arguments disagree with `args0` (as nomad_shard_step checks them), when
// the shared memory is refused, when no cluster of S such blocks fits the
// card, or when the launch fails.
int nomad_shard_chain(const PlaceArgs* args0, const ShardChain* q,
                      void* stream) {
  const PlaceArgs& A0 = *args0;
  if (!chain_ok(A0, *q)) return (int)cudaErrorInvalidValue;
  ShardChain Q = *q;
  Q.scan_bytes = (int)smem_bytes(A0);
  const size_t shm = chain_smem(Q);
  if (shm + sizeof(PlaceArgs) + LIST_BYTES > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      shard_chain_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q.shards, 1, 1);
  cfg.blockDim = dim3(SCAN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q.shards;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)shard_chain_cluster, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, shard_chain_cluster, Q);
  if (err != cudaSuccess) return (int)err;
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
