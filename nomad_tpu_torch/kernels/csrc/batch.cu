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
// ≈ 17 a row step in all, B·M·N row steps (chip_smoke.py `_onchip_ops`);
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
// never copied; no scratch, carry or slot is allocated.

#include "place_core.cuh"

namespace {

// regions of the shared-memory layout, in order
enum OnchipRegion {
  O_ARGS, O_RED, O_PLACED, O_PEN, O_SCOUNTS, O_DCOUNTS, O_SPTAB,
  O_MINMAX, O_SEEN, O_DPTAB, O_PREFIX, O_META, O_STOK, O_DTOK, O_END
};

// one penalty row of a step: the entry it takes for the step, and the one
// it gives back after
struct PenRow {
  int row;  // −1: a pad, out of range, or a repeat of an earlier entry
  float prefix;
  int meta;
  float save_prefix;
  int save_meta;
};

__host__ __device__ inline int tok_bytes(int v) { return v <= 256 ? 1 : 2; }

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

struct OnchipSmem {
  Best* red;          // [33] block_argmax
  int* placed;        // [m] the row each step placed on, −1 none
  PenRow* pen;        // [pn] this step's penalty rows
  float* scounts;     // [s, sv]
  float* dcounts;     // [p, dv]
  float* sptab;       // [s, sv] spread boost of each (spread row, token)
  float* minc;        // [s]
  float* maxc;        // [s]
  uint8_t* seen;      // [s]
  uint8_t* dptab;     // [p, dv] distinct_property mask of each token
  float* prefix;      // [n]
  uint8_t* meta;      // [n] R_* bits and the term count
  unsigned char* stok;  // [s][n] u8 or u16
  unsigned char* dtok;  // [p][n]
  bool swide, dwide;
};

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
  return S;
}

__device__ __forceinline__ int tok_get(const unsigned char* t, bool wide,
                                       size_t i) {
  return wide ? (int)((const uint16_t*)t)[i] : (int)t[i];
}

__device__ __forceinline__ void tok_set(unsigned char* t, bool wide, size_t i,
                                        int v) {
  if (wide) ((uint16_t*)t)[i] = (uint16_t)v;
  else t[i] = (uint8_t)v;
}

// placements the program made on row n in steps [0, step)
__device__ __forceinline__ int placed_on(const OnchipSmem& S, int n,
                                         int step) {
  int k = 0;
  for (int i = 0; i < step; ++i) k += S.placed[i] == n;
  return k;
}

// Entry t of the program's row lists taken in order — plan deltas, job
// counts, task-group counts, port releases, port consumptions, and the
// first `lc` sampled candidates — as a row index (−1 pads stay −1).
__device__ __forceinline__ int list_row(const PlaceArgs& A, int t) {
  if (t < A.d) return A.delta_idx[t];
  t -= A.d;
  if (t < A.j) return A.jc_idx[t];
  t -= A.j;
  if (t < A.j2) return A.jtc_idx[t];
  t -= A.j2;
  if (t < A.pc) return A.pclr_idx[t];
  t -= A.pc;
  if (t < A.ps) return A.pset_idx[t];
  return A.cand_idx[t - A.ps];
}

// The static pass of one program over this block's rows, straight into
// shared memory, with the counts the scan starts from: every row as if no
// list named it (fresh_entry), then the rows the lists name, each once,
// from all its terms (row_entry). Ends with a barrier.
__device__ void onchip_static(const PlaceArgs& A, const ScanConsts& C,
                              const OnchipSmem& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t N = (size_t)A.n;
  for (int i = tid; i < A.s * A.sv; i += nt) S.scounts[i] = A.spread_counts0[i];
  for (int i = tid; i < A.p * A.dv; i += nt) S.dcounts[i] = A.dp_counts0[i];
  const bool cand_ok = !(A.l > 0 && *A.use_cand);
  for (int n = tid; n < A.n; n += nt) {
    const RowEntry e = fresh_entry(A, C, n, cand_ok);
    S.prefix[n] = e.prefix;
    S.meta[n] = e.meta;
    for (int i = 0; i < A.s; ++i)
      tok_set(S.stok, S.swide, i * N + n,
              norm_tok(attr_at(A, n, A.spread_key_idx[i]), A.sv));
    for (int i = 0; i < A.p; ++i)
      tok_set(S.dtok, S.dwide, i * N + n,
              norm_tok(attr_at(A, n, A.dp_key_idx[i]), A.dv));
  }
  __syncthreads();
  const int lists = A.d + A.j + A.j2 + A.pc + A.ps + (cand_ok ? 0 : A.l);
  for (int t = tid; t < lists; t += nt) {
    const int row = list_row(A, t);
    if (row < 0 || row >= A.n) continue;
    bool first = true;
    for (int q = 0; q < t && first; ++q) first = list_row(A, q) != row;
    if (!first) continue;
    const RowEntry e = row_entry(A, C, row, 0, row_feasible(A, row),
                                 ports_free_row(A, row));
    S.prefix[row] = e.prefix;
    S.meta[row] = e.meta;
  }
  __syncthreads();
}

// The start of a step. Phase one, each part on its own threads: the
// previous step's penalty rows get their entries back and the row it
// placed on is recomputed (one thread); the spread min / max over the
// counts (warp 0); this step's penalty rows recomputed with the penalty
// (warp 2, a thread a row, repeats dropped); the distinct_property table.
// Phase two: the spread table, and the penalty rows' entries swapped in.
// Ends with a barrier.
__device__ void onchip_begin_step(const PlaceArgs& A, const ScanConsts& C,
                                  const OnchipSmem& S, int step) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    for (int s = lane; s < A.s; s += 32) {
      float mn = BIG, mx = -BIG;
      bool seen = false;
      for (int t = 0; t < A.sv; ++t) {
        float c = S.scounts[s * A.sv + t];
        if (c > 0.0f) {
          seen = true;
          mn = fminf(mn, c);
          mx = fmaxf(mx, c);
        }
      }
      S.minc[s] = mn;
      S.maxc[s] = mx;
      S.seen[s] = seen;
    }
  } else if (tid == 32 && step > 0) {
    for (int q = 0; q < A.pn; ++q) {
      const PenRow& pr = S.pen[q];
      if (pr.row < 0) continue;
      S.prefix[pr.row] = pr.save_prefix;
      S.meta[pr.row] = (uint8_t)pr.save_meta;
    }
    const int row = S.placed[step - 1];
    if (row >= 0) {
      const uint8_t m = S.meta[row];
      const RowEntry e = row_entry(A, C, row, placed_on(S, row, step),
                                   (m & R_FEAS) != 0, (m & R_RES) != 0);
      S.prefix[row] = e.prefix;
      S.meta[row] = e.meta;
    }
  } else if (warp == 2) {
    const int* pen = A.penalty_idx + (size_t)step * A.pn;
    for (int q = lane; q < A.pn; q += 32) {
      int row = pen[q];
      bool use = row >= 0 && row < A.n;
      for (int i = 0; i < q && use; ++i) use = pen[i] != row;
      PenRow pr{use ? row : -1, 0.0f, 0, 0.0f, 0};
      if (use) {
        int cnt;
        pr.prefix = row_prefix(A, C, row, row_carry(A, row,
                                                   placed_on(S, row, step)),
                               true, &cnt);
        pr.meta = cnt;
      }
      S.pen[q] = pr;
    }
  } else if (tid >= 96) {
    for (int i = tid - 96; i < A.p * A.dv; i += nt - 96) {
      const int q = i / A.dv, t = i - q * A.dv;
      S.dptab[i] = (S.dcounts[i] < A.dp_allowed[q] && t != A.dv - 1) ||
                   !A.dp_active[q];
    }
  }
  __syncthreads();
  for (int i = tid; i < A.s * A.sv; i += nt) {
    const int s = i / A.sv;
    S.sptab[i] = spread_term(A, S.scounts, S.minc[s], S.maxc[s], S.seen[s],
                             s, i - s * A.sv);
  }
  if (warp == 2) {
    for (int q = lane; q < A.pn; q += 32) {
      PenRow& pr = S.pen[q];
      if (pr.row < 0) continue;
      const uint8_t m = S.meta[pr.row];
      pr.save_prefix = S.prefix[pr.row];
      pr.save_meta = m;
      S.prefix[pr.row] = pr.prefix;
      S.meta[pr.row] = (uint8_t)((m & ~R_CNT) | (pr.meta << R_CNT_SHIFT));
    }
  }
  __syncthreads();
}

struct RowVal {
  bool ok;
  float masked;
};

// step_rows' ok and masked score of row n from its entry and the step's
// tables: the spread boost summed over the spread rows in order, added to
// the prefix, divided by the term count
__device__ __forceinline__ RowVal onchip_value(const PlaceArgs& A,
                                               const OnchipSmem& S, int n) {
  const size_t N = (size_t)A.n;
  const uint8_t m = S.meta[n];
  bool ok = (m & (R_FIT | R_DH)) == R_FIT;
  for (int q = 0; q < A.p && ok; ++q)
    ok = S.dptab[q * A.dv + tok_get(S.dtok, S.dwide, q * N + n)] != 0;
  float masked = NEG_INF;
  if (ok) {
    float sp = 0.0f;
    for (int s = 0; s < A.s; ++s)
      sp = sp + S.sptab[s * A.sv + tok_get(S.stok, S.swide, s * N + n)];
    bool inc = sp != 0.0f;
    float ssum = S.prefix[n] + (inc ? sp : 0.0f);
    float scnt = (float)(((m & R_CNT) >> R_CNT_SHIFT) + (inc ? 1 : 0));
    masked = ssum / scnt;
  }
  return RowVal{ok, masked};
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
