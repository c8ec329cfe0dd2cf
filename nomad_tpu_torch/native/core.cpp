// nomad_tpu native core — host-side hot-path primitives.
//
// Behavioral reference: the reference's performance-critical inner loops
// that sit OUTSIDE the device kernels — port bitmap search
// (nomad/structs/network.go:487 getDynamicPortsPrecise over
// structs.Bitmap, bitmap.go:6), the AllocsFit superset check
// (nomad/structs/funcs.go:103) as run per-node by the plan applier
// (plan_apply.go:629), and the bin-pack score (funcs.go:175). The
// reference runs these in Go; this build runs them in C++ behind a C ABI
// consumed via ctypes (zero-copy over numpy buffers), per the TPU-build
// design: JAX/XLA owns the device compute, C++ owns the host runtime
// loops.
//
// Contract notes:
// - `used` port arrays are byte masks (numpy bool_), length 65536.
// - resource matrices are row-major float32 [N, R].
// - every function is thread-compatible: callers own synchronization of
//   the underlying buffers (the Python side calls under its store lock).

#include <cstdint>
#include <cmath>
#include <cstring>

namespace {

// Everything one alloc-step needs to evaluate a single node: feasibility
// (LUT program, distinct_hosts/property, bin-pack fit) + the fused
// conditional-inclusion score. Returns the score, or -INFINITY when the
// node is infeasible. Shared by the full-scan and sampled select loops so
// the two baselines cannot drift.
struct EvalCtx {
    const float* capacity; const float* used; int R; const float* ask;
    const int32_t* attrs; int K;
    const int32_t* key_idx; const uint8_t* lut; int C; int V;
    const int32_t* aff_key_idx; const float* aff_lut; int A;
    float aff_inv_sum;
    const int32_t* s_key; const float* s_weight; const uint8_t* s_has_t;
    const uint8_t* s_active; const float* s_desired; const float* s_counts;
    int S;
    const int32_t* dp_key; const float* dp_allowed; const float* dp_counts;
    int P;
    int distinct_hosts; const float* jc; const float* jtc;
    float desired_count;
    const uint8_t* node_ok; const uint8_t* extra_mask; int extra_n;
    // per-alloc even-spread statistics (recomputed by the caller)
    const float* minc; const float* maxc; const uint8_t* any_seen;
};

inline float eval_node(const EvalCtx& cx, int i) {
    if (!cx.node_ok[i]) return -INFINITY;
    if (cx.extra_n > 1 && !cx.extra_mask[i]) return -INFINITY;
    if (cx.extra_n == 1 && !cx.extra_mask[0]) return -INFINITY;
    if (cx.distinct_hosts && cx.jc[i] > 0.f) return -INFINITY;
    const int32_t* at = cx.attrs + (size_t)i * cx.K;
    for (int c = 0; c < cx.C; ++c) {
        int tok = at[cx.key_idx[c]];
        if (tok < 0 || tok >= cx.V) tok = cx.V - 1;
        if (!cx.lut[(size_t)c * cx.V + tok]) return -INFINITY;
    }
    // distinct_property (propertyset.go:214): value use count must stay
    // under allowed; unresolved property ⇒ infeasible
    for (int p = 0; p < cx.P; ++p) {
        int tok = at[cx.dp_key[p]];
        if (tok < 0 || tok >= cx.V) tok = cx.V - 1;
        if (tok == cx.V - 1
            || cx.dp_counts[(size_t)p * cx.V + tok] >= cx.dp_allowed[p])
            return -INFINITY;
    }
    const float* cap = cx.capacity + (size_t)i * cx.R;
    const float* use = cx.used + (size_t)i * cx.R;
    for (int r = 0; r < cx.R; ++r)
        if (use[r] + cx.ask[r] > cap[r]) return -INFINITY;

    // fused scoring (rank.go conditional inclusion + mean norm);
    // 10^x as exp2(x·log2 10) — same fast form the kernel uses, so the
    // compiled baseline is not handicapped by powf
    float tc = cap[0] > 1.f ? cap[0] : 1.f;
    float tm = cap[1] > 1.f ? cap[1] : 1.f;
    float free_cpu = 1.f - (use[0] + cx.ask[0]) / tc;
    float free_mem = 1.f - (use[1] + cx.ask[1]) / tm;
    float total = std::exp2(free_cpu * 3.321928094887362f)
                + std::exp2(free_mem * 3.321928094887362f);
    float binpack = 20.f - total;
    if (binpack > 18.f) binpack = 18.f;
    if (binpack < 0.f) binpack = 0.f;
    float ssum = binpack / 18.f;
    float scnt = 1.f;
    if (cx.jtc[i] > 0.f) {
        ssum += -(cx.jtc[i] + 1.f) / cx.desired_count;
        scnt += 1.f;
    }
    if (cx.A > 0) {
        float aff = 0.f;
        for (int c = 0; c < cx.A; ++c) {
            int tok = at[cx.aff_key_idx[c]];
            if (tok < 0 || tok >= cx.V) tok = cx.V - 1;
            aff += cx.aff_lut[(size_t)c * cx.V + tok];
        }
        aff *= cx.aff_inv_sum;
        if (aff != 0.f) { ssum += aff; scnt += 1.f; }
    }
    if (cx.S > 0) {
        float boost = 0.f;
        for (int s = 0; s < cx.S; ++s) {
            if (!cx.s_active[s]) continue;
            int tok = at[cx.s_key[s]];
            if (tok < 0 || tok >= cx.V) tok = cx.V - 1;
            if (cx.s_has_t[s]) {
                // target mode (spread.go:120-174)
                float desired = cx.s_desired[(size_t)s * cx.V + tok];
                float cur = cx.s_counts[(size_t)s * cx.V + tok] + 1.f;
                boost += desired > 0.f
                    ? (desired - cur) / desired * cx.s_weight[s]
                    : -1.f;
            } else {
                // even mode (evenSpreadScoreBoost, spread.go:178;
                // mirrors kernels/placement.py _spread_boost)
                if (!cx.any_seen[s]) continue;
                float cur = cx.s_counts[(size_t)s * cx.V + tok];
                float mn = cx.minc[s], mx = cx.maxc[s];
                float mn_safe = mn > 0.f ? mn : 1.f;
                float ev;
                if (cur != mn) {
                    ev = mn == 0.f ? -1.f : (mn - cur) / mn_safe;
                } else if (mn == mx) {
                    ev = -1.f;
                } else if (mn == 0.f) {
                    ev = 1.f;
                } else {
                    ev = (mx - mn) / mn_safe;
                }
                if (tok == cx.V - 1) ev = -1.f;
                boost += ev;
            }
        }
        if (boost != 0.f) { ssum += boost; scnt += 1.f; }
    }
    return ssum / scnt;
}

// Per-alloc even-mode spread statistics: min/max of seen (>0) counts per
// spread row (kernels/placement.py _spread_boost even branch /
// spread.go:178).
inline void spread_stats(const float* s_counts, int S, int V,
                         float* minc, float* maxc, uint8_t* any_seen) {
    for (int s = 0; s < S; ++s) {
        float mn = 3.4e38f, mx = -3.4e38f;
        uint8_t seen = 0;
        for (int v2 = 0; v2 < V; ++v2) {
            float c = s_counts[(size_t)s * V + v2];
            if (c > 0.f) {
                seen = 1;
                if (c < mn) mn = c;
                if (c > mx) mx = c;
            }
        }
        minc[s] = mn; maxc[s] = mx; any_seen[s] = seen;
    }
}

// Post-selection accounting shared by both loops: consume capacity and
// bump the job/spread/property counters for the chosen node.
inline void account_placement(int best, float* used, int R,
                              const float* ask, float* jc, float* jtc,
                              const int32_t* attrs, int K, int V,
                              const int32_t* s_key, float* s_counts, int S,
                              const int32_t* dp_key, float* dp_counts,
                              int P) {
    float* use = used + (size_t)best * R;
    for (int r = 0; r < R; ++r) use[r] += ask[r];
    jc[best] += 1.f;
    jtc[best] += 1.f;
    const int32_t* at = attrs + (size_t)best * K;
    for (int s = 0; s < S; ++s) {
        int tok = at[s_key[s]];
        if (tok < 0 || tok >= V) tok = V - 1;
        if (tok == V - 1) continue;  // missing never enters the use map
        s_counts[(size_t)s * V + tok] += 1.f;
    }
    for (int p = 0; p < P; ++p) {
        int tok = at[dp_key[p]];
        if (tok < 0 || tok >= V) tok = V - 1;
        if (tok == V - 1) continue;
        dp_counts[(size_t)p * V + tok] += 1.f;
    }
}

}  // namespace

extern "C" {

// First-fit `count` free ports in [min_port, max_port), skipping
// `reserved` values. Returns number written to `out` (== count on
// success; fewer → failure, caller treats as exhaustion).
int nomad_first_fit_ports(const uint8_t* used, int min_port, int max_port,
                          const int32_t* reserved, int n_reserved,
                          int count, int32_t* out) {
    if (count <= 0) return 0;
    int found = 0;
    for (int p = min_port; p < max_port && found < count; ++p) {
        if (used[p]) continue;
        bool skip = false;
        for (int r = 0; r < n_reserved; ++r) {
            if (reserved[r] == p) { skip = true; break; }
        }
        if (skip) continue;
        out[found++] = p;
    }
    return found;
}

// Per-row superset check: capacity[row] - used[row] >= ask (all R dims).
// out_mask[i] = 1 when ask fits on rows[i].
void nomad_fits_batch(const float* capacity, const float* used, int R,
                      const float* ask, const int32_t* rows, int n_rows,
                      uint8_t* out_mask) {
    for (int i = 0; i < n_rows; ++i) {
        const float* cap = capacity + (size_t)rows[i] * R;
        const float* use = used + (size_t)rows[i] * R;
        uint8_t ok = 1;
        for (int r = 0; r < R; ++r) {
            if (use[r] + ask[r] > cap[r]) { ok = 0; break; }
        }
        out_mask[i] = ok;
    }
}

// Batch scatter-add of usage rows into the used matrix:
//   used[rows[i]] += sign * usage[i]   (the plan-commit fan-in)
void nomad_scatter_add(float* used, int R, const int32_t* rows,
                       const float* usage, int n, float sign) {
    for (int i = 0; i < n; ++i) {
        float* dst = used + (size_t)rows[i] * R;
        const float* src = usage + (size_t)i * R;
        for (int r = 0; r < R; ++r) dst[r] += sign * src[r];
    }
}

// Google BestFit-v3 bin-pack score (funcs.go:175 ScoreFitBinPack):
//   score = 20 - 10^free_cpu - 10^free_mem, clamped to [0, 18]
// (normalization by 18 happens at the rank layer, rank.go:11-13).
// capacity rows are node resources MINUS reserved (the same contract as
// tensor/cluster.py); cpu is dim 0, mem dim 1. Zero-capacity rows → 0.
void nomad_score_binpack(const float* capacity, const float* used, int R,
                         const float* ask, const int32_t* rows, int n_rows,
                         float* out) {
    for (int i = 0; i < n_rows; ++i) {
        const float* cap = capacity + (size_t)rows[i] * R;
        const float* use = used + (size_t)rows[i] * R;
        float total_cpu = cap[0], total_mem = cap[1];
        if (total_cpu <= 0.f || total_mem <= 0.f) { out[i] = 0.f; continue; }
        float free_cpu = (total_cpu - use[0] - ask[0]) / total_cpu;
        float free_mem = (total_mem - use[1] - ask[1]) / total_mem;
        float score = 20.f - std::pow(10.f, free_cpu)
                           - std::pow(10.f, free_mem);
        if (score > 18.f) score = 18.f;
        if (score < 0.f) score = 0.f;
        out[i] = score;
    }
}

// Count free ports in a range (introspection / metrics).
int nomad_count_free_ports(const uint8_t* used, int min_port, int max_port) {
    int n = 0;
    for (int p = min_port; p < max_port; ++p) n += used[p] ? 0 : 1;
    return n;
}

// One full evaluation of the scalar select loop — the compiled baseline
// for the bench (the analog of the reference's Go `Stack.Select` hot loop,
// scheduler/stack.go:116 + rank.go:188 + feasible.go:1026, measured by
// scheduler/stack_test.go:14-55). Per alloc: full-node scan evaluating
// the tokenized constraint LUT program, bin-pack fit + score,
// job-anti-affinity, node affinity, spread target boosts, mean
// normalization, argmax; then in-loop accounting (used/jc/jtc/spread
// counts) exactly like the plan-relative threading of the TPU kernel.
//
// Layouts (row-major): capacity/used f32[N,R]; attrs i32[N,K];
// lut u8[C,V] with key_idx i32[C]; aff_lut f32[A,V]; spread tables
// f32[S,V]. Token normalization: tok<0 or tok>=V → V-1 (missing slot).
void nomad_select_eval(
    const float* capacity, float* used, int n, int R, const float* ask,
    const int32_t* attrs, int K,
    const int32_t* key_idx, const uint8_t* lut, int C, int V,
    const int32_t* aff_key_idx, const float* aff_lut, int A,
    float aff_inv_sum,
    const int32_t* s_key, const float* s_weight, const uint8_t* s_has_t,
    const uint8_t* s_active, const float* s_desired, float* s_counts, int S,
    const int32_t* dp_key, const float* dp_allowed, float* dp_counts, int P,
    int distinct_hosts, float* jc, float* jtc, float desired_count,
    const uint8_t* node_ok, const uint8_t* extra_mask, int extra_n,
    int n_allocs, int32_t* out_sel, float* out_score) {
    if (desired_count < 1.f) desired_count = 1.f;
    float* minc = S > 0 ? new float[S] : nullptr;
    float* maxc = S > 0 ? new float[S] : nullptr;
    uint8_t* any_seen = S > 0 ? new uint8_t[S] : nullptr;
    EvalCtx cx{capacity, used, R, ask, attrs, K, key_idx, lut, C, V,
               aff_key_idx, aff_lut, A, aff_inv_sum,
               s_key, s_weight, s_has_t, s_active, s_desired, s_counts, S,
               dp_key, dp_allowed, dp_counts, P,
               distinct_hosts, jc, jtc, desired_count,
               node_ok, extra_mask, extra_n, minc, maxc, any_seen};
    for (int a = 0; a < n_allocs; ++a) {
        spread_stats(s_counts, S, V, minc, maxc, any_seen);
        int best = -1;
        float best_score = -1e30f;
        for (int i = 0; i < n; ++i) {
            float score = eval_node(cx, i);
            if (score > -INFINITY && score > best_score) {
                best_score = score;
                best = i;
            }
        }
        out_sel[a] = best;
        out_score[a] = best < 0 ? 0.f : best_score;
        if (best < 0) continue;
        account_placement(best, used, R, ask, jc, jtc, attrs, K, V,
                          s_key, s_counts, S, dp_key, dp_counts, P);
    }
    delete[] minc;
    delete[] maxc;
    delete[] any_seen;
}

// Sampled-mode scalar select — the reference's ACTUAL algorithm shape
// (scheduler/stack.go:10-18 + LimitIterator, rank.go): per alloc, walk a
// shuffled node order collecting up to `limit` = ⌈log₂(n)⌉ FEASIBLE,
// scored candidates; a candidate scoring below `skip_threshold` does not
// consume the limit for up to `max_skip` skips (stack.go maxSkip = 3,
// skipScoreThreshold = 0). Pick the best of the window, account, repeat.
// `order` is the caller-provided shuffled row permutation (the reference
// shuffles per eval, shuffleNodes, stack.go:77-89); a fresh offset per
// alloc keeps the window rotating the way the iterator chain does.
void nomad_select_eval_sampled(
    const float* capacity, float* used, int n, int R, const float* ask,
    const int32_t* attrs, int K,
    const int32_t* key_idx, const uint8_t* lut, int C, int V,
    const int32_t* aff_key_idx, const float* aff_lut, int A,
    float aff_inv_sum,
    const int32_t* s_key, const float* s_weight, const uint8_t* s_has_t,
    const uint8_t* s_active, const float* s_desired, float* s_counts, int S,
    const int32_t* dp_key, const float* dp_allowed, float* dp_counts, int P,
    int distinct_hosts, float* jc, float* jtc, float desired_count,
    const uint8_t* node_ok, const uint8_t* extra_mask, int extra_n,
    const int32_t* order, int limit, int max_skip, float skip_threshold,
    int n_allocs, int32_t* out_sel, float* out_score) {
    if (desired_count < 1.f) desired_count = 1.f;
    if (limit < 2) limit = 2;
    float* minc = S > 0 ? new float[S] : nullptr;
    float* maxc = S > 0 ? new float[S] : nullptr;
    uint8_t* any_seen = S > 0 ? new uint8_t[S] : nullptr;
    EvalCtx cx{capacity, used, R, ask, attrs, K, key_idx, lut, C, V,
               aff_key_idx, aff_lut, A, aff_inv_sum,
               s_key, s_weight, s_has_t, s_active, s_desired, s_counts, S,
               dp_key, dp_allowed, dp_counts, P,
               distinct_hosts, jc, jtc, desired_count,
               node_ok, extra_mask, extra_n, minc, maxc, any_seen};
    int cursor = 0;  // rotating start: successive allocs continue the walk
    for (int a = 0; a < n_allocs; ++a) {
        spread_stats(s_counts, S, V, minc, maxc, any_seen);
        int best = -1;
        float best_score = -1e30f;
        int taken = 0, skipped = 0;
        for (int seen = 0; seen < n && taken < limit; ++seen) {
            int i = order[(cursor + seen) % n];
            float score = eval_node(cx, i);
            if (score == -INFINITY) continue;  // infeasible: free to pass
            if (score > best_score) { best_score = score; best = i; }
            if (score <= skip_threshold && skipped < max_skip) {
                ++skipped;  // poor option: does not consume the window
                continue;
            }
            ++taken;
        }
        cursor = (cursor + 1) % n;
        out_sel[a] = best;
        out_score[a] = best < 0 ? 0.f : best_score;
        if (best < 0) continue;
        account_placement(best, used, R, ask, jc, jtc, attrs, K, V,
                          s_key, s_counts, S, dp_key, dp_counts, P);
    }
    delete[] minc;
    delete[] maxc;
    delete[] any_seen;
}

int nomad_core_abi_version() { return 4; }

}  // extern "C"
