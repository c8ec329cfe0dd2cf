// Shared device code of the placement kernels for Hopper (sm_90a):
// the argument block of one placement program (`PlaceArgs`), the per-row
// static pass, the block-wide argmax and the M-step scan of one program.
// `placement.cu` (K1, one program) and `chain.cu` (K4/K5, chains of
// programs in lanes) include it, and `system.cu` (K2) and `preempt.cu`
// (K3) reuse its per-row helpers. What each computes, and what bounds
// it, is told in those files.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2_10 = 3.321928094887362f;
constexpr float BIG = 3.4e38f;
// below every masked score (the mask floor is NEG_INF): the empty argmax
constexpr float LOWEST = -3.4028234663852886e38f;
// the reference's `/ 18.0` reaches the device as a multiply by the f32
// reciprocal (XLA folds division by a constant); do the same
constexpr float INV_18 = (float)(1.0 / 18.0);
constexpr int SCAN_THREADS = 1024;
constexpr int N_PARTS = 5;

}  // namespace

extern "C" {

struct PlaceArgs {
  // cluster
  const float* capacity; const float* used; const uint8_t* node_ok;
  const void* attrs; const uint32_t* ports_used; const float* dyn_free;
  int n, r, k_cols, port_words, attrs_i32;
  // program (scalars are device pointers to 0-d tensors)
  const float* ask; const int* n_place; const float* desired_count;
  const int* algorithm;
  const int* key_idx; const uint8_t* lut; int c, v;
  const int* aff_key_idx; const float* aff_lut; const float* aff_inv_sum;
  int a, av;
  const int* penalty_idx; const int* preferred_idx; int m, pn;
  const uint8_t* extra_mask; int e;
  const uint8_t* distinct_hosts;
  const int* jc_idx; const float* jc_val; int j;
  const int* jtc_idx; const float* jtc_val; int j2;
  const int* delta_idx; const float* delta_res; int d;
  const int* cand_idx; const uint8_t* use_cand; int l;
  const int* dp_key_idx; const float* dp_allowed; const float* dp_counts0;
  const uint8_t* dp_active; int p, dv;
  const int* res_ports; int pp; const float* n_dyn;
  const int* pclr_idx; const int* pclr_port; int pc;
  const int* pset_idx; const int* pset_port; int ps;
  const int* spread_key_idx; const float* spread_weight;
  const uint8_t* spread_has_targets; const float* spread_desired;
  const float* spread_counts0; const uint8_t* spread_active; int s, sv;
  // scratch
  uint8_t* feas; uint8_t* flags; uint32_t* cfail; int cw;
  float* aff; uint8_t* res_free; float* dyn;
  float* job_cnt; float* tg_cnt; float* splaced;
  int* stok; int* dtok; float* mbuf; uint8_t* okbuf; float* parts;
  // outputs
  float* new_used; int* sel_idx; float* sel_score; int* nodes_feasible;
  int* nodes_fit; float* final0;
  int explain, topk;
  int* ex_static;  // nodes_evaluated, filt_lut, filt_extra
  int* filt_constraint; int* filt_distinct; int* filt_dp; int* exh_dim;
  int* exh_dyn; int* exh_res; int* topk_idx; float* topk_score;
  float* topk_parts;
};

}  // extern "C"

namespace {

// flags bits written by the static pass
constexpr uint8_t F_BASE = 1, F_LUT_ALL = 2, F_EXTRA = 4;

__device__ __forceinline__ int attr_at(const PlaceArgs& A, int n, int k) {
  size_t off = (size_t)n * A.k_cols + k;
  return A.attrs_i32 ? ((const int32_t*)A.attrs)[off]
                     : (int)((const int16_t*)A.attrs)[off];
}

// token normalisation of _select_tokens: missing (−1) → v−1, clamp to v−1
__device__ __forceinline__ int norm_tok(int tok, int v) {
  return tok < 0 ? v - 1 : min(tok, v - 1);
}

// Every constraint LUT row accepts row n's token (K2 and K3; the static
// pass below also records which rows fail, for the explain counters).
__device__ __forceinline__ bool lut_row_ok(const PlaceArgs& A, int n) {
  for (int c = 0; c < A.c; ++c) {
    int t = norm_tok(attr_at(A, n, A.key_idx[c]), A.v);
    if (!A.lut[(size_t)c * A.v + t]) return false;
  }
  return true;
}

// Reserved ports of row n: every static ask free, plan releases read
// free, plan placements read taken.
__device__ __forceinline__ bool ports_free_row(const PlaceArgs& A, int n) {
  bool free_all = true;
  for (int i = 0; i < A.pp; ++i) {
    int port = A.res_ports[i];
    if (port < 0) continue;
    uint32_t word = A.ports_used[(size_t)n * A.port_words + (port >> 5)];
    bool taken = ((word >> (port & 31)) & 1u) != 0;
    for (int q = 0; q < A.pc; ++q)
      if (A.pclr_idx[q] == n && A.pclr_port[q] == port) { taken = false; break; }
    for (int q = 0; q < A.ps; ++q)
      if (A.pset_idx[q] == n && A.pset_port[q] == port) { taken = true; break; }
    if (taken) free_all = false;
  }
  return free_all;
}

// used0[n, r] = used − Σ_d delta_res[d, r] over the row's deltas (summed
// first, in delta order, then subtracted once).
__device__ __forceinline__ float used0_at(const PlaceArgs& A, int n, int r) {
  float u = A.used[(size_t)n * A.r + r];
  if (A.d == 0) return u;
  float dsum = 0.0f;
  for (int i = 0; i < A.d; ++i)
    if (A.delta_idx[i] == n) dsum = dsum + A.delta_res[(size_t)i * A.r + r];
  return u - dsum;
}

// fit_scores' shared term: 10^free_cpu + 10^free_ram at utilization
// (u0, u1) of capacity (c0, c1), as exp2f(x·log2 10).
__device__ __forceinline__ float fit_total(float u0, float u1, float c0,
                                           float c1) {
  float free_cpu = 1.0f - u0 / fmaxf(c0, 1.0f);
  float free_ram = 1.0f - u1 / fmaxf(c1, 1.0f);
  return exp2f(free_cpu * LOG2_10) + exp2f(free_ram * LOG2_10);
}

// The carry-free parts of the static pass for row n: constraint LUT rows,
// node_ok / extra_mask / sampled-candidate membership, affinity, the
// spread and distinct_property tokens, the job/tg counts and the
// reserved-port bits with the plan's released/consumed ports.
__device__ __forceinline__ void static_row(const PlaceArgs& A, int n) {
  // constraint LUT rows
  bool lut_all = true;
  for (int w = 0; w < A.cw; ++w) {
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      int c = w * 32 + b;
      if (c >= A.c) break;
      int t = norm_tok(attr_at(A, n, A.key_idx[c]), A.v);
      if (!A.lut[(size_t)c * A.v + t]) {
        lut_all = false;
        bits |= 1u << b;
      }
    }
    A.cfail[(size_t)n * A.cw + w] = bits;
  }
  bool extra = A.extra_mask[A.e == 1 ? 0 : n] != 0;
  bool cand_ok = true;
  if (A.l > 0 && *A.use_cand) {
    cand_ok = false;
    for (int i = 0; i < A.l; ++i)
      if (A.cand_idx[i] == n) { cand_ok = true; break; }
  }
  bool base = A.node_ok[n] && cand_ok;
  A.feas[n] = base && extra && lut_all;
  A.flags[n] = (base ? F_BASE : 0) | (lut_all ? F_LUT_ALL : 0) |
               (extra ? F_EXTRA : 0);

  // affinity: sum in row order, then scale
  float acc = 0.0f;
  for (int i = 0; i < A.a; ++i) {
    int t = norm_tok(attr_at(A, n, A.aff_key_idx[i]), A.av);
    acc = acc + A.aff_lut[(size_t)i * A.av + t];
  }
  A.aff[n] = acc * *A.aff_inv_sum;

  for (int i = 0; i < A.s; ++i)
    A.stok[(size_t)n * A.s + i] =
        norm_tok(attr_at(A, n, A.spread_key_idx[i]), A.sv);
  for (int i = 0; i < A.p; ++i)
    A.dtok[(size_t)n * A.p + i] =
        norm_tok(attr_at(A, n, A.dp_key_idx[i]), A.dv);

  float jc = 0.0f, jtc = 0.0f;
  for (int i = 0; i < A.j; ++i)
    if (A.jc_idx[i] == n) jc = jc + A.jc_val[i];
  for (int i = 0; i < A.j2; ++i)
    if (A.jtc_idx[i] == n) jtc = jtc + A.jtc_val[i];
  A.job_cnt[n] = jc;
  A.tg_cnt[n] = jtc;
  A.splaced[n] = 0.0f;

  A.res_free[n] = ports_free_row(A, n);
}

// Free dynamic ports of row n from `dyn` (the view's or a chain's carry):
// credit the plan's released in-range ports, then debit consumed ones.
__device__ __forceinline__ float adjusted_dyn(const PlaceArgs& A, int n,
                                              float dyn) {
  if (A.pc > 0) {
    float add = 0.0f;
    for (int q = 0; q < A.pc; ++q)
      if (A.pclr_idx[q] == n && A.pclr_port[q] >= 20000 &&
          A.pclr_port[q] <= 32000)
        add = add + 1.0f;
    dyn = dyn + add;
  }
  if (A.ps > 0) {
    float sub = 0.0f;
    for (int q = 0; q < A.ps; ++q)
      if (A.pset_idx[q] == n && A.pset_port[q] >= 20000 &&
          A.pset_port[q] <= 32000)
        sub = sub + 1.0f;
    dyn = dyn - sub;
  }
  return dyn;
}

// The carry-dependent parts for row n: used0 = used − Σ_d delta_res over
// the row's deltas (written to new_used), and the adjusted dyn_free.
__device__ __forceinline__ void static_row_carry(const PlaceArgs& A, int n) {
  for (int r = 0; r < A.r; ++r)
    A.new_used[(size_t)n * A.r + r] = used0_at(A, n, r);
  A.dyn[n] = adjusted_dyn(A, n, A.dyn_free[n]);
}

struct Best {
  float v;
  int i;
};

// larger value wins; on equal values the lower row (jnp.argmax)
__device__ __forceinline__ Best better(Best x, Best y) {
  if (y.v > x.v || (y.v == x.v && y.i < x.i)) return y;
  return x;
}

// block-wide argmax; every thread returns the winner
__device__ Best block_argmax(Best b, Best* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_down_sync(0xffffffffu, b.v, off);
    o.i = __shfl_down_sync(0xffffffffu, b.i, off);
    b = better(b, o);
  }
  if (lane == 0) red[warp] = b;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    b = lane < nw ? red[lane] : Best{LOWEST, 0x7fffffff};
    for (int off = 16; off > 0; off >>= 1) {
      Best o;
      o.v = __shfl_down_sync(0xffffffffu, b.v, off);
      o.i = __shfl_down_sync(0xffffffffu, b.i, off);
      b = better(b, o);
    }
    if (lane == 0) red[32] = b;
  }
  __syncthreads();
  Best out = red[32];
  __syncthreads();
  return out;
}

// shared-memory layout of scan_pass (dynamic, sized by the host)
struct Smem {
  float* scounts;  // [s, sv]
  float* dcounts;  // [p, dv]
  float* minc;     // [s]
  float* maxc;     // [s]
  uint8_t* any_seen;  // [s]
  Best* red;       // [33]
  int* cnt;        // [6 + r]: nfit, dh, dp, dyn, res, nfeas, dim[r]
  int* cfilt;      // [c]
  int* stat;       // [3]: evaluated, filt_lut, filt_extra
  int* taken;      // [topk]
};

__device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline size_t smem_bytes(const PlaceArgs& A) {
  size_t b = 0;
  b += (size_t)A.s * A.sv * 4; b = (b + 15) & ~(size_t)15;
  b += (size_t)A.p * A.dv * 4; b = (b + 15) & ~(size_t)15;
  b += (size_t)A.s * 4 * 2; b = (b + 15) & ~(size_t)15;
  b += (size_t)A.s; b = (b + 15) & ~(size_t)15;
  b += 33 * sizeof(Best); b = (b + 15) & ~(size_t)15;
  b += (size_t)(6 + A.r) * 4; b = (b + 15) & ~(size_t)15;
  b += (size_t)(A.c > 0 ? A.c : 1) * 4; b = (b + 15) & ~(size_t)15;
  b += 3 * 4; b = (b + 15) & ~(size_t)15;
  b += (size_t)(A.topk > 0 ? A.topk : 1) * 4; b = (b + 15) & ~(size_t)15;
  return b;
}

__device__ Smem carve(const PlaceArgs& A, unsigned char* base) {
  Smem S;
  size_t b = 0;
  S.scounts = (float*)(base + b); b = align16(b + (size_t)A.s * A.sv * 4);
  S.dcounts = (float*)(base + b); b = align16(b + (size_t)A.p * A.dv * 4);
  S.minc = (float*)(base + b); S.maxc = S.minc + A.s;
  b = align16(b + (size_t)A.s * 4 * 2);
  S.any_seen = (uint8_t*)(base + b); b = align16(b + (size_t)A.s);
  S.red = (Best*)(base + b); b = align16(b + 33 * sizeof(Best));
  S.cnt = (int*)(base + b); b = align16(b + (size_t)(6 + A.r) * 4);
  S.cfilt = (int*)(base + b); b = align16(b + (size_t)(A.c > 0 ? A.c : 1) * 4);
  S.stat = (int*)(base + b); b = align16(b + 3 * 4);
  S.taken = (int*)(base + b);
  return S;
}

// one row's total spread boost (spread.go:120-174 + evenSpreadScoreBoost)
__device__ float spread_boost(const PlaceArgs& A, const Smem& S, int n) {
  float total = 0.0f;
  const int miss = A.sv - 1;
  for (int s = 0; s < A.s; ++s) {
    int tok = A.stok[(size_t)n * A.s + s];
    float cur = S.scounts[s * A.sv + tok];
    float desired = A.spread_desired[(size_t)s * A.sv + tok];
    float used_count = cur + 1.0f;
    float target = desired > 0.0f
        ? (desired - used_count) / desired * A.spread_weight[s]
        : -1.0f;
    float minc = S.minc[s], maxc = S.maxc[s];
    float minc_safe = minc > 0.0f ? minc : 1.0f;
    float delta_boost = minc == 0.0f ? -1.0f : (minc - cur) / minc_safe;
    float even;
    if (cur != minc) even = delta_boost;
    else if (minc == maxc) even = -1.0f;
    else if (minc == 0.0f) even = 1.0f;
    else even = (maxc - minc) / minc_safe * 1.0f;
    if (tok == miss) even = -1.0f;
    if (!S.any_seen[s]) even = 0.0f;
    float boost = A.spread_has_targets[s] ? target : even;
    if (!A.spread_active[s]) boost = 0.0f;
    total = total + boost;
  }
  return total;
}

// Per-program constants of the scan, read once per block.
struct ScanConsts {
  float ask0, ask1, desired_count, n_dyn;
  int n_place, algorithm;
  bool distinct_hosts, has_res_ask;
};

__device__ __forceinline__ ScanConsts scan_consts(const PlaceArgs& A) {
  ScanConsts C;
  C.ask0 = A.ask[0];
  C.ask1 = A.ask[1];
  C.n_place = *A.n_place;
  C.desired_count = *A.desired_count;
  C.algorithm = *A.algorithm;
  C.distinct_hosts = *A.distinct_hosts != 0;
  C.n_dyn = *A.n_dyn;
  C.has_res_ask = false;
  for (int i = 0; i < A.pp; ++i) C.has_res_ask |= A.res_ports[i] >= 0;
  return C;
}

// The spread and distinct_property counts start from the program's.
__device__ __forceinline__ void init_counts(const PlaceArgs& A, const Smem& S) {
  for (int i = threadIdx.x; i < A.s * A.sv; i += blockDim.x)
    S.scounts[i] = A.spread_counts0[i];
  for (int i = threadIdx.x; i < A.p * A.dv; i += blockDim.x)
    S.dcounts[i] = A.dp_counts0[i];
}

// Static-stage counts over this block's rows: nodes_feasible, and with
// explain the evaluated / LUT / extra-mask / per-constraint filters.
// Starts and ends with a barrier.
__device__ void static_counts(const PlaceArgs& A, const Smem& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    S.stat[0] = S.stat[1] = S.stat[2] = 0;
    S.cnt[5] = 0;
  }
  for (int i = tid; i < A.c; i += nt) S.cfilt[i] = 0;
  __syncthreads();
  int nfeas = 0, ev = 0, flut = 0, fext = 0;
  for (int n = tid; n < A.n; n += nt) {
    nfeas += A.feas[n];
    uint8_t f = A.flags[n];
    if (f & F_BASE) {
      ++ev;
      if (!(f & F_LUT_ALL)) ++flut;
      else if (!(f & F_EXTRA)) ++fext;
      if (A.explain) {
        for (int c = 0; c < A.c; ++c)
          if ((A.cfail[(size_t)n * A.cw + (c >> 5)] >> (c & 31)) & 1u)
            atomicAdd(&S.cfilt[c], 1);
      }
    }
  }
  atomicAdd(&S.cnt[5], nfeas);
  if (A.explain) {
    atomicAdd(&S.stat[0], ev);
    atomicAdd(&S.stat[1], flut);
    atomicAdd(&S.stat[2], fext);
  }
  __syncthreads();
  if (tid == 0) {
    *A.nodes_feasible = S.cnt[5];
    if (A.explain) {
      A.ex_static[0] = S.stat[0];
      A.ex_static[1] = S.stat[1];
      A.ex_static[2] = S.stat[2];
    }
  }
  if (A.explain)
    for (int c = tid; c < A.c; c += nt) A.filt_constraint[c] = S.cfilt[c];
  __syncthreads();
}

// Start of a step: the even-spread min/max over the current counts and
// zeroed step counters. Ends with a barrier.
__device__ __forceinline__ void begin_step(const PlaceArgs& A, const Smem& S) {
  const int tid = threadIdx.x;
  for (int s = tid; s < A.s; s += blockDim.x) {
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
    S.any_seen[s] = seen;
  }
  if (tid < 6 + A.r) S.cnt[tid] = 0;
  __syncthreads();
}

// One step over this block's rows: fit, ports, distinct_hosts, the
// distinct_property mask and the fused score of every row, into mbuf
// (masked score), okbuf and, at step 0, final0; the fit count into
// S.cnt[0] (and the explain counters). Returns this thread's best row;
// the caller's block_argmax publishes mbuf, okbuf and the counts.
__device__ Best step_rows(const PlaceArgs& A, const Smem& S,
                          const ScanConsts& C, int step) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = A.n, R = A.r;
  const int* pen = A.penalty_idx + (size_t)step * A.pn;
  Best best{LOWEST, 0x7fffffff};
  int nfit = 0, c_dh = 0, c_dp = 0, c_dyn = 0, c_res = 0;
  for (int n = tid; n < N; n += nt) {
    const float* used = A.new_used + (size_t)n * R;
    const float* cap = A.capacity + (size_t)n * R;
    bool any_over = false;
    int first_over = 0;
    for (int r = 0; r < R; ++r) {
      float u = used[r] + A.ask[r];
      if (u > cap[r] && !any_over) { any_over = true; first_over = r; }
    }
    const float splaced = A.splaced[n];
    bool dyn_ok = (A.dyn[n] - splaced * C.n_dyn) >= C.n_dyn;
    bool res_ok = A.res_free[n] && !(C.has_res_ask && splaced > 0.0f);
    bool fits = !any_over && dyn_ok && res_ok;
    bool feas = A.feas[n] != 0;
    bool ok = feas && fits;
    const float jc = A.job_cnt[n];
    bool dh_collide = C.distinct_hosts && jc > 0.0f;
    ok = ok && !dh_collide;
    bool dp_mask = true;
    if (A.p > 0) {
      for (int q = 0; q < A.p; ++q) {
        int t = A.dtok[(size_t)n * A.p + q];
        bool row_ok = (S.dcounts[q * A.dv + t] < A.dp_allowed[q] &&
                       t != A.dv - 1) || !A.dp_active[q];
        dp_mask = dp_mask && row_ok;
      }
      ok = ok && dp_mask;
    }

    // fused score (rank.go semantics)
    float total = fit_total(used[0] + C.ask0, used[1] + C.ask1, cap[0],
                            cap[1]);
    float fit = C.algorithm == 1
        ? fminf(fmaxf(total - 2.0f, 0.0f), 18.0f) * INV_18
        : fminf(fmaxf(20.0f - total, 0.0f), 18.0f) * INV_18;
    float ssum = fit, scnt = 1.0f;
    const float tgc = A.tg_cnt[n];
    bool collide = tgc > 0.0f;
    float anti = -(tgc + 1.0f) / fmaxf(C.desired_count, 1.0f);
    float p_anti = collide ? anti : 0.0f;
    ssum = ssum + p_anti;
    scnt = scnt + (collide ? 1.0f : 0.0f);
    bool penalty = false;
    for (int q = 0; q < A.pn; ++q) penalty |= pen[q] == n;
    float p_pen = penalty ? -1.0f : 0.0f;
    ssum = ssum + p_pen;
    scnt = scnt + (penalty ? 1.0f : 0.0f);
    const float aff = A.aff[n];
    bool inc_aff = aff != 0.0f;
    float p_aff = inc_aff ? aff : 0.0f;
    ssum = ssum + p_aff;
    scnt = scnt + (inc_aff ? 1.0f : 0.0f);
    float sp = spread_boost(A, S, n);
    bool inc_spread = sp != 0.0f;
    float p_sp = inc_spread ? sp : 0.0f;
    ssum = ssum + p_sp;
    scnt = scnt + (inc_spread ? 1.0f : 0.0f);
    float final_ = ssum / scnt;
    float masked = ok ? final_ : NEG_INF;

    A.mbuf[n] = masked;
    A.okbuf[n] = ok;
    if (step == 0) A.final0[n] = masked;
    best = better(best, Best{masked, n});
    nfit += feas && fits;
    if (A.explain) {
      float* pr = A.parts + (size_t)n * N_PARTS;
      pr[0] = fit; pr[1] = p_anti; pr[2] = p_pen; pr[3] = p_aff; pr[4] = p_sp;
      bool dh_fail = feas && dh_collide;
      bool dp_fail = A.p > 0 && feas && !dh_fail && !dp_mask;
      bool cand_m = feas && !dh_fail && !dp_fail;
      c_dh += dh_fail;
      c_dp += dp_fail;
      if (cand_m && any_over) atomicAdd(&S.cnt[6 + first_over], 1);
      c_dyn += cand_m && !any_over && !dyn_ok;
      c_res += cand_m && !any_over && dyn_ok && !res_ok;
    }
  }
  atomicAdd(&S.cnt[0], nfit);
  if (A.explain) {
    atomicAdd(&S.cnt[1], c_dh);
    atomicAdd(&S.cnt[2], c_dp);
    atomicAdd(&S.cnt[3], c_dyn);
    atomicAdd(&S.cnt[4], c_res);
  }
  return best;
}

// The carry update of a placement on row idx (one thread).
__device__ __forceinline__ void take_row(const PlaceArgs& A, int idx) {
  for (int r = 0; r < A.r; ++r)
    A.new_used[(size_t)idx * A.r + r] = A.new_used[(size_t)idx * A.r + r] + A.ask[r];
  A.job_cnt[idx] = A.job_cnt[idx] + 1.0f;
  A.tg_cnt[idx] = A.tg_cnt[idx] + 1.0f;
  A.splaced[idx] = A.splaced[idx] + 1.0f;
}

// The placed row's spread tokens `st` [s] and distinct_property tokens
// `dt` [p] each add one to their value's count (one thread).
__device__ __forceinline__ void count_tokens(const PlaceArgs& A, const Smem& S,
                                             const int* st, const int* dt) {
  for (int s = 0; s < A.s; ++s) {
    int t = st[s];
    if (t != A.sv - 1) S.scounts[s * A.sv + t] += 1.0f;
  }
  for (int q = 0; q < A.p; ++q) {
    int t = dt[q];
    if (t != A.dv - 1) S.dcounts[q * A.dv + t] += 1.0f;
  }
}

// The M-step scan of one program, run by one whole block (blockDim.x a
// multiple of 32, at most 1024) with `smem_raw` of smem_bytes(A) bytes.
// Reads the static pass's scratch, updates new_used (the carry) in place.
__device__ __forceinline__ void scan_program(const PlaceArgs& A,
                                             unsigned char* smem_raw) {
  Smem S = carve(A, smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = A.n, R = A.r;

  init_counts(A, S);
  const ScanConsts C = scan_consts(A);
  static_counts(A, S);

  for (int step = 0; step < A.m; ++step) {
    begin_step(A, S);
    Best best = step_rows(A, S, C, step);
    best = block_argmax(best, S.red);  // its barriers publish mbuf/okbuf

    if (tid == 0) {
      int pref = A.preferred_idx[step];
      int idx = best.i;
      if (pref >= 0 && A.okbuf[pref]) idx = pref;
      bool found = A.okbuf[idx] && step < C.n_place;
      A.sel_idx[step] = found ? idx : -1;
      A.sel_score[step] = found ? A.mbuf[idx] : 0.0f;
      A.nodes_fit[step] = S.cnt[0];
      if (found) {
        take_row(A, idx);
        count_tokens(A, S, A.stok + (size_t)idx * A.s,
                     A.dtok + (size_t)idx * A.p);
      }
      if (A.explain) {
        A.filt_distinct[step] = S.cnt[1];
        A.filt_dp[step] = S.cnt[2];
        A.exh_dyn[step] = S.cnt[3];
        A.exh_res[step] = S.cnt[4];
        for (int r = 0; r < R; ++r) A.exh_dim[(size_t)step * R + r] = S.cnt[6 + r];
      }
    }

    if (A.explain) {
      // top-K: K rounds of the same argmax, excluding rows already taken
      // (value descending, row ascending on ties — lax.top_k's order)
      for (int k = 0; k < A.topk; ++k) {
        Best b{LOWEST, 0x7fffffff};
        for (int n = tid; n < N; n += nt) {
          bool skip = false;
          for (int q = 0; q < k; ++q) skip |= S.taken[q] == n;
          if (!skip) b = better(b, Best{A.mbuf[n], n});
        }
        b = block_argmax(b, S.red);
        if (tid == 0) {
          S.taken[k] = b.i;
          size_t o = (size_t)step * A.topk + k;
          A.topk_idx[o] = b.i;
          A.topk_score[o] = b.v;
          float keep = b.v > NEG_INF / 2 ? 1.0f : 0.0f;
          for (int q = 0; q < N_PARTS; ++q)
            A.topk_parts[o * N_PARTS + q] =
                A.parts[(size_t)b.i * N_PARTS + q] * keep;
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

constexpr int STATIC_THREADS = 256;
constexpr int ARG_WORDS = (int)(sizeof(PlaceArgs) / 4);
static_assert(sizeof(PlaceArgs) % 4 == 0, "PlaceArgs copies as words");

// copy one PlaceArgs from device memory into shared memory, all threads
__device__ __forceinline__ void load_args(PlaceArgs* dst, const PlaceArgs* src) {
  const uint32_t* s = (const uint32_t*)src;
  uint32_t* d = (uint32_t*)dst;
  for (int i = threadIdx.x; i < ARG_WORDS; i += blockDim.x) d[i] = s[i];
  __syncthreads();
}

}  // namespace
