// The on-chip scan core, shared by K6's on-chip route (batch.cu) and the
// chain/wave lane route (lanes.cu): one program's rows kept in shared
// memory by one block, each row's entry computed once a program and the
// rows a step changes recomputed.
//
// A block keeps global rows [row0, row0 + rows) (K6: every row; a lane
// cluster: its slice), each per-row array indexed by the row's place in
// that range. A step reads, of each row, only the entry and two tables
// built at the step's start from the counts: the spread boost of each
// (spread row, token) and the distinct_property mask of each (property,
// token). The rows a step changes — the row the previous step placed on
// and this step's penalty rows — are recomputed by one thread each from
// the row's carry and the program's placements so far.
//
// A row's carry is the view's (A.used, A.dyn_free) unless the block has an
// overlay (a chain's lane, lanes.cu): a row whose overlay bit is set reads
// its used and dyn_free from the lane's carry buffers instead.
#pragma once

#include "place_core.cuh"

namespace {

// A row's entry after the step that places on it, computed while the
// step's winner is still being combined (lanes.cu): begin_step takes it
// when the row placed on is `row`.
struct SpecRow {
  int row;  // −1: none
  float prefix;
  int meta;
  int exh;
};

// one penalty row of a step: the entry it takes for the step, and the one
// it gives back after
struct PenRow {
  int row;  // the row's place in the block's range; −1: a pad, out of
            // range, or a repeat of an earlier entry
  float prefix;
  int meta;
  float save_prefix;
  int save_meta;
};

__host__ __device__ inline int tok_bytes(int v) { return v <= 256 ? 1 : 2; }

struct OnchipSmem {
  Best* red;          // [33] block_argmax
  int* placed;        // [m] the (global) row each step placed on, −1 none
  PenRow* pen;        // [pn] this step's penalty rows
  float* scounts;     // [s, sv]
  float* dcounts;     // [p, dv]
  float* sptab;       // [s, sv] spread boost of each (spread row, token)
  float* minc;        // [s]
  float* maxc;        // [s]
  uint8_t* seen;      // [s]
  uint8_t* dptab;     // [p, dv] distinct_property mask of each token
  float* prefix;      // [rows]
  uint8_t* meta;      // [rows] R_* bits and the term count
  uint8_t* exh;       // [rows] explain's exhaustion code (row_exh), or null
  unsigned char* stok;  // [s][rows] u8 or u16
  unsigned char* dtok;  // [p][rows]
  bool swide, dwide;
  int row0, rows;     // the block's global rows [row0, row0 + rows)
  // a lane's overlay: bit i set (i = row − row0) → the row's carry is in
  // carry_used [n, r] / carry_dyn [n] (global row index); null: the view
  const uint32_t* overlay;
  const float* carry_used;
  const float* carry_dyn;
  // the row entry computed ahead for the next step, or null
  const SpecRow* spec;
};

__device__ __forceinline__ bool in_overlay(const OnchipSmem& S, int n) {
  if (S.overlay == nullptr) return false;
  const int i = n - S.row0;
  return ((S.overlay[i >> 5] >> (i & 31)) & 1u) != 0;
}

// the R used values of row n's carry
__device__ __forceinline__ const float* src_used(const PlaceArgs& A,
                                                 const OnchipSmem& S, int n) {
  return (in_overlay(S, n) ? S.carry_used : A.used) + (size_t)n * A.r;
}

// row n's carried dyn_free
__device__ __forceinline__ float src_dyn(const PlaceArgs& A,
                                         const OnchipSmem& S, int n) {
  return in_overlay(S, n) ? S.carry_dyn[n] : A.dyn_free[n];
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

// placements the program made on (global) row n in steps [0, step)
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

__device__ __forceinline__ bool in_block(const OnchipSmem& S, int n) {
  return n >= S.row0 && n < S.row0 + S.rows;
}

// the lanes of warp_row that hold a row's job count, task-group count,
// affinity and adjusted dyn_free; lanes below them hold its dimensions
constexpr int W_JC = 28, W_TGC = 29, W_AFF = 30, W_DYN = 31;

// What row_entry and the score parts read of row n after `k` placements,
// by the 32 lanes of a warp at once (every lane returns it): lane r < R
// dimension r's carried used and capacity, its over-capacity bit
// gathered by a ballot; lanes W_* the counts, the affinity and
// adjusted_dyn of `dyn`. Each value is row_carry's, row_aff's or
// adjusted_dyn's arithmetic in its order; only their loads overlap.
// Needs A.r ≤ W_JC.
struct WarpRow {
  RowCarry c;
  float cap0, cap1, aff, adj;
};

__device__ __forceinline__ WarpRow warp_row(const PlaceArgs& A, int n, int k,
                                            const float* used, float dyn) {
  const int lane = threadIdx.x & 31;
  float v = 0.0f, cap = 0.0f;
  bool over = false;
  if (lane < A.r) {
    v = carried_used(A, used, n, lane, k);
    cap = A.capacity[(size_t)n * A.r + lane];
    over = v + A.ask[lane] > cap;
  } else if (lane == W_JC) {
    v = row_count(A.jc_idx, A.jc_val, A.j, n, k);
  } else if (lane == W_TGC) {
    v = row_count(A.jtc_idx, A.jtc_val, A.j2, n, k);
  } else if (lane == W_AFF) {
    v = row_aff(A, n);
  } else if (lane == W_DYN) {
    v = adjusted_dyn(A, n, dyn);
  }
  const unsigned mask = __ballot_sync(FULL, over);
  WarpRow w;
  w.c.u0 = __shfl_sync(FULL, v, 0);
  w.c.u1 = __shfl_sync(FULL, v, 1);
  w.c.jc = __shfl_sync(FULL, v, W_JC);
  w.c.tgc = __shfl_sync(FULL, v, W_TGC);
  w.c.splaced = ones(k);
  w.c.any_over = mask != 0;
  w.c.first_over = mask != 0 ? __ffs(mask) - 1 : 0;
  w.cap0 = __shfl_sync(FULL, cap, 0);
  w.cap1 = __shfl_sync(FULL, cap, 1);
  w.aff = __shfl_sync(FULL, v, W_AFF);
  w.adj = __shfl_sync(FULL, v, W_DYN);
  return w;
}

// row_entry by the 32 lanes of a warp (every lane returns it)
__device__ __forceinline__ RowEntry row_entry_warp(const PlaceArgs& A,
                                                   const ScanConsts& C, int n,
                                                   int k, bool feas,
                                                   bool res_free,
                                                   const float* used,
                                                   float dyn) {
  if (A.r > W_JC) return row_entry(A, C, n, k, feas, res_free, used, dyn);
  const WarpRow w = warp_row(A, n, k, used, dyn);
  const RowTerms t = row_terms_of(C, w.cap0, w.cap1, w.c, false, w.aff);
  RowEntry e;
  e.prefix = ((t.fit + t.anti) + t.pen) + t.aff;
  e.meta = row_bits(C, w.c, w.adj, feas, res_free) |
           (uint8_t)(t.cnt << R_CNT_SHIFT);
  e.exh = row_exh(C, w.c, w.adj, res_free, A.r);
  return e;
}

// The static pass of one program over the block's rows, straight into
// shared memory, with the counts the scan starts from: every row as if no
// list named it (fresh_entry), then the rows the lists name, each once,
// from all its terms (row_entry). Ends with a barrier.
__device__ void onchip_static(const PlaceArgs& A, const ScanConsts& C,
                              const OnchipSmem& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t rows = (size_t)S.rows;
  for (int i = tid; i < A.s * A.sv; i += nt) S.scounts[i] = A.spread_counts0[i];
  for (int i = tid; i < A.p * A.dv; i += nt) S.dcounts[i] = A.dp_counts0[i];
  const bool cand_ok = !(A.l > 0 && *A.use_cand);
  for (int i = tid; i < S.rows; i += nt) {
    const int n = S.row0 + i;
    const RowEntry e = fresh_entry(A, C, n, cand_ok, src_used(A, S, n),
                                   src_dyn(A, S, n));
    S.prefix[i] = e.prefix;
    S.meta[i] = e.meta;
    if (S.exh != nullptr) S.exh[i] = e.exh;
    for (int q = 0; q < A.s; ++q)
      tok_set(S.stok, S.swide, q * rows + i,
              norm_tok(attr_at(A, n, A.spread_key_idx[q]), A.sv));
    for (int q = 0; q < A.p; ++q)
      tok_set(S.dtok, S.dwide, q * rows + i,
              norm_tok(attr_at(A, n, A.dp_key_idx[q]), A.dv));
  }
  __syncthreads();
  const int lists = A.d + A.j + A.j2 + A.pc + A.ps + (cand_ok ? 0 : A.l);
  for (int t = tid; t < lists; t += nt) {
    const int row = list_row(A, t);
    if (row < 0 || row >= A.n || !in_block(S, row)) continue;
    bool first = true;
    for (int q = 0; q < t && first; ++q) first = list_row(A, q) != row;
    if (!first) continue;
    const RowEntry e = row_entry(A, C, row, 0, row_feasible(A, row),
                                 ports_free_row(A, row), src_used(A, S, row),
                                 src_dyn(A, S, row));
    const int i = row - S.row0;
    S.prefix[i] = e.prefix;
    S.meta[i] = e.meta;
    if (S.exh != nullptr) S.exh[i] = e.exh;
  }
  __syncthreads();
}

// The start of a step. Phase one, each part on its own threads: the
// spread min / max over the counts (warp 0, a reduction over the
// tokens: a min and a max take the same value in any order); the row the
// previous step placed on, if the block keeps it, recomputed (warp 1,
// row_entry_warp, unless `S.spec` holds it already); the previous step's
// other penalty rows given their entries back, then this step's penalty
// rows the block keeps recomputed with the penalty (warp 2, a thread a
// row, repeats dropped: the two warps touch disjoint rows, and only warp
// 2 the penalty list); the distinct_property table. Phase two: the spread
// table, and the penalty rows' entries swapped in. Ends with a barrier.
__device__ void onchip_begin_step(const PlaceArgs& A, const ScanConsts& C,
                                  const OnchipSmem& S, int step) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    for (int s = 0; s < A.s; ++s) {
      float mn = BIG, mx = -BIG;
      bool seen = false;
      for (int t = lane; t < A.sv; t += 32) {
        float c = S.scounts[s * A.sv + t];
        if (c > 0.0f) {
          seen = true;
          mn = fminf(mn, c);
          mx = fmaxf(mx, c);
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      }
      seen = __any_sync(FULL, seen);
      if (lane == 0) {
        S.minc[s] = mn;
        S.maxc[s] = mx;
        S.seen[s] = seen;
      }
    }
  } else if (warp == 1 && step > 0) {
    const int row = S.placed[step - 1];
    if (row >= 0 && in_block(S, row)) {
      const int i = row - S.row0;
      const uint8_t m = S.meta[i];
      RowEntry e;
      if (S.spec != nullptr && S.spec->row == row) {
        e.prefix = S.spec->prefix;
        e.meta = (uint8_t)S.spec->meta;
        e.exh = (uint8_t)S.spec->exh;
      } else {
        e = row_entry_warp(A, C, row, placed_on(S, row, step),
                           (m & R_FEAS) != 0, (m & R_RES) != 0,
                           src_used(A, S, row), src_dyn(A, S, row));
      }
      if (lane == 0) {
        S.prefix[i] = e.prefix;
        S.meta[i] = e.meta;
        if (S.exh != nullptr) S.exh[i] = e.exh;
      }
    }
  } else if (warp == 2) {
    if (step > 0) {
      // the previous step's penalty rows get their entries back before
      // this step's are written over them; the row it placed on is warp
      // 1's, recomputed whole
      if (lane == 0) {
        const int placed = S.placed[step - 1];
        for (int q = 0; q < A.pn; ++q) {
          const PenRow& pr = S.pen[q];
          if (pr.row < 0 || pr.row + S.row0 == placed) continue;
          S.prefix[pr.row] = pr.save_prefix;
          S.meta[pr.row] = (uint8_t)pr.save_meta;
        }
      }
      __syncwarp();
    }
    const int* pen = A.penalty_idx + (size_t)step * A.pn;
    for (int q = lane; q < A.pn; q += 32) {
      int row = pen[q];
      bool use = row >= 0 && row < A.n && in_block(S, row);
      for (int i = 0; i < q && use; ++i) use = pen[i] != row;
      PenRow pr{use ? row - S.row0 : -1, 0.0f, 0, 0.0f, 0};
      if (use) {
        int cnt;
        pr.prefix = row_prefix(
            A, C, row, row_carry(A, row, placed_on(S, row, step),
                                 src_used(A, S, row)), true, &cnt);
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

// The spread boost of the block's row i: the step's table entries of its
// tokens summed over the spread rows in order (spread_boost's sum)
__device__ __forceinline__ float onchip_spread(const PlaceArgs& A,
                                               const OnchipSmem& S, int i) {
  const size_t rows = (size_t)S.rows;
  float sp = 0.0f;
  for (int s = 0; s < A.s; ++s)
    sp = sp + S.sptab[s * A.sv + tok_get(S.stok, S.swide, s * rows + i)];
  return sp;
}

// step_rows' final score of the block's row i (entry bits `m`): the
// spread boost added to the prefix, divided by the term count
__device__ __forceinline__ float onchip_score(const PlaceArgs& A,
                                              const OnchipSmem& S, int i,
                                              uint8_t m) {
  const float sp = onchip_spread(A, S, i);
  bool inc = sp != 0.0f;
  float ssum = S.prefix[i] + (inc ? sp : 0.0f);
  float scnt = (float)(((m & R_CNT) >> R_CNT_SHIFT) + (inc ? 1 : 0));
  return ssum / scnt;
}

// the step's distinct_property mask of the block's row i
__device__ __forceinline__ bool onchip_dp_ok(const PlaceArgs& A,
                                             const OnchipSmem& S, int i) {
  const size_t rows = (size_t)S.rows;
  bool ok = true;
  for (int q = 0; q < A.p && ok; ++q)
    ok = S.dptab[q * A.dv + tok_get(S.dtok, S.dwide, q * rows + i)] != 0;
  return ok;
}

// step_rows' ok and masked score of the block's row i from its entry and
// the step's tables
__device__ __forceinline__ RowVal onchip_value(const PlaceArgs& A,
                                               const OnchipSmem& S, int i) {
  const uint8_t m = S.meta[i];
  const bool ok = (m & (R_FIT | R_DH)) == R_FIT && onchip_dp_ok(A, S, i);
  return RowVal{ok, ok ? onchip_score(A, S, i, m) : NEG_INF};
}

}  // namespace
