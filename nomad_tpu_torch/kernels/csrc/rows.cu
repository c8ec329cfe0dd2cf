// Row writes for Hopper (sm_90a), hand-written CUDA C++: the program-table
// insert (K8) and the device view's row-delta refresh (K7). Each is ONE
// launch fed by ONE staged buffer.
//
// The staged buffer. The wrapper (kernels/rows.py) packs a call's host
// arrays into one pinned host buffer and copies it to the card once: a
// header of int64 fields, then each array on a 16-byte boundary, at byte
// offsets the header gives (relative to the header's first byte). The C
// entry points read the header from the HOST copy (it is pinned memory the
// wrapper keeps alive) and pass the layout to the kernel by value, so the
// kernel makes no dependent loads of its own layout. The header's bytes
// travel with the buffer (the arrays' offsets are relative to them) and
// nothing on the card reads them; the wrapper's checks and the plain
// versions read the same host copy.
//
// K8 — replaces `_get_insert_jit` (nomad_tpu/server/program_table.py:99),
// which returns NEW i32/f32/u8 class tables equal to the old ones with K
// rows replaced (not donated: dispatches already committed keep reading
// the old tables). `nomad_table_insert` writes the three new tables in one
// launch: one warp an output row of a table, which binary-searches the
// sorted row indices for its row and copies the staged row k where
// idx[k] == row, else the old row. Every table byte is read once and
// written once; no second pass, no race (each output row has one writer).
// Header (int64): k, li, lf, lu, then the offsets of idx i32[K],
// ri i32[K, li], rf f32[K, lf], ru u8[K, lu].
//
// K7 — replaces the view row-delta kernels of the device view cache
// (nomad_tpu/scheduler/stack.py:115-227: `_rows_update`,
// `_hot_delta_impl`, `_ports_delta_impl`, `_ports_word_impl`, run by
// `_apply_chunked` over 32-row chunks padded by repeating the first row).
// `nomad_view_delta` applies one refresh's three parts in one launch, the
// grid split by block range:
//   - hot rows: one thread a row writes used (f32[N, R]), node_ok (bool[N])
//     and dyn_free (f32[N]);
//   - whole port rows: one block an 8 KiB row of the u32[N, W] bitmap, all
//     of a thread's 16-byte loads issued before its stores;
//   - port words: one thread a word, ports[row[k], word[k]] = val[k].
// The parts write disjoint bytes, so one launch needs no ordering between
// them: the hot tensors are separate tensors from the bitmap, and the view
// cache maps a changed port row either to the whole row or to its words,
// never both (scheduler/stack.py `_apply_port_words`). Within a part the
// rows (and (row, word) pairs) are distinct. Rows outside [0, N) and words
// outside [0, W) are skipped.
// Header (int64): n_hot, r, n_prow, w, n_words, then the offsets of
// hot_idx i32[H], hot_used f32[H, r], hot_ok u8[H], hot_dyn f32[H],
// prow_idx i32[P], prow_vals u32[P, w], word_row i32[Q], word_col i32[Q],
// word_val u32[Q].
//
// What bounds them on an H100: bytes, and those are few. K8 moves the
// three tables (2·T·(4li + 4lf + lu) bytes, ≈ 3 MB at T = 512) plus the K
// staged rows; K7 a few kilobytes (a hot row 4 + 4R + 1 + 4 bytes read,
// 4R + 1 + 4 written; a port row 4 + 4W read, 4W written; a word 12 read,
// 4 written). At 3.35 TB/s that is nanoseconds to a microsecond; a launch
// costs microseconds, and the host's issue of it more. So the design
// spends its effort on the count: one staged copy and one launch a call,
// and the fewest arguments ctypes must convert.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Copy `width` bytes with `vec`-byte words (16, 4 or 1; the caller checked
// that both addresses and the width allow it), `lanes` threads from `lane`.
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src,
                                           long long width, int vec,
                                           int lane, int lanes) {
  if (vec == 16) {
    const long long n = width >> 4;
    for (long long i = lane; i < n; i += lanes)
      ((uint4*)dst)[i] = ((const uint4*)src)[i];
  } else if (vec == 4) {
    const long long n = width >> 2;
    for (long long i = lane; i < n; i += lanes)
      ((uint32_t*)dst)[i] = ((const uint32_t*)src)[i];
  } else {
    for (long long i = lane; i < width; i += lanes) dst[i] = src[i];
  }
}

// The widest word (16, 4 or 1 bytes) that every address and the width allow.
int vec_of(uintptr_t bits) {
  if ((bits & 15) == 0) return 16;
  if ((bits & 3) == 0) return 4;
  return 1;
}

struct Table {
  const unsigned char* old_rows;
  const unsigned char* staged;   // K rows of `width` bytes
  unsigned char* out;
  long long width;               // bytes a row
  int vec;
};

struct Insert {
  Table tab[3];
  const int* idx;                // K sorted, distinct row indices
  int k;
  int t;                         // rows of every table
};

// One output row of one table: the staged row k where idx[k] == row (the
// sorted indices binary-searched; every lane searches alike, so the loads
// are warp-uniform), else the old row.
__device__ __forceinline__ void insert_row(Table tab, const int* idx,
                                           int k, int row, int lane) {
  if (tab.width == 0) return;
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(idx + mid) < row)
      lo = mid + 1;
    else
      hi = mid;
  }
  const unsigned char* src = (lo < k && __ldg(idx + lo) == row)
                                 ? tab.staged + (long long)lo * tab.width
                                 : tab.old_rows + (long long)row * tab.width;
  copy_bytes(tab.out + (long long)row * tab.width, src, tab.width, tab.vec,
             lane, 32);
}

// One warp an output row: warp g writes row g % t of table g / t.
__global__ void __launch_bounds__(kThreads) table_insert(Insert p) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 3LL * p.t) return;
  const int c = (int)(warp / p.t);
  const int row = (int)(warp - (long long)c * p.t);
  // constant indices: a parameter indexed at run time would be copied to
  // local memory first
  if (c == 0)
    insert_row(p.tab[0], p.idx, p.k, row, lane);
  else if (c == 1)
    insert_row(p.tab[1], p.idx, p.k, row, lane);
  else
    insert_row(p.tab[2], p.idx, p.k, row, lane);
}

struct Delta {
  float* used;
  unsigned char* node_ok;
  float* dyn_free;
  uint32_t* ports;
  long long n;
  int r, w;
  int n_hot, n_prow, n_words;
  int hot_blocks, vec_rows;
  const int* hot_idx;
  const float* hot_used;
  const unsigned char* hot_ok;
  const float* hot_dyn;
  const int* prow_idx;
  const uint32_t* prow_vals;
  const int* word_row;
  const int* word_col;
  const uint32_t* word_val;
};

// 16-byte words a thread loads before it stores (a thread's share of a row
// of up to kThreads * kBatch * 4 words; wider rows take several rounds)
constexpr int kBatch = 4;

__global__ void __launch_bounds__(kThreads) view_delta(Delta d) {
  int b = blockIdx.x;
  if (b < d.hot_blocks) {
    const int k = b * kThreads + threadIdx.x;
    if (k >= d.n_hot) return;
    const int row = d.hot_idx[k];
    if (row < 0 || row >= d.n) return;
    float* dst = d.used + (long long)row * d.r;
    const float* src = d.hot_used + (long long)k * d.r;
    for (int j = 0; j < d.r; ++j) dst[j] = src[j];
    d.node_ok[row] = d.hot_ok[k];
    d.dyn_free[row] = d.hot_dyn[k];
    return;
  }
  b -= d.hot_blocks;
  if (b < d.n_prow) {
    const int row = d.prow_idx[b];
    if (row < 0 || row >= d.n) return;
    uint32_t* dst = d.ports + (long long)row * d.w;
    const uint32_t* src = d.prow_vals + (long long)b * d.w;
    if (!d.vec_rows) {
      copy_bytes((unsigned char*)dst, (const unsigned char*)src,
                 4LL * d.w, 4, threadIdx.x, kThreads);
      return;
    }
    const int nv = d.w >> 2;
    for (int base = 0; base < nv; base += kThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + threadIdx.x;
        if (i < nv) v[j] = ((const uint4*)src)[i];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + threadIdx.x;
        if (i < nv) ((uint4*)dst)[i] = v[j];
      }
    }
    return;
  }
  b -= d.n_prow;
  const int k = b * kThreads + threadIdx.x;
  if (k >= d.n_words) return;
  const int row = d.word_row[k];
  const int col = d.word_col[k];
  if (row < 0 || row >= d.n || col < 0 || col >= d.w) return;
  d.ports[(long long)row * d.w + col] = d.word_val[k];
}

}  // namespace

extern "C" {

const char* nomad_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K8: out_c = old_c with row idx[k] replaced by staged row k, for the three
// class tables c (i32, f32, u8) of `t` rows each. `head` is the host copy
// of the staged buffer's header, `base` the buffer on the card. Returns
// cudaGetLastError() after the launch.
int nomad_table_insert(const long long* head, const void* base, int t,
                       const void* old_i, const void* old_f,
                       const void* old_u, void* out_i, void* out_f,
                       void* out_u, void* stream) {
  const long long k = head[0];
  if (k < 0 || t < 0 || head[1] < 0 || head[2] < 0 || head[3] < 0)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  const unsigned char* b = (const unsigned char*)base;
  Insert p;
  const void* olds[3] = {old_i, old_f, old_u};
  void* outs[3] = {out_i, out_f, out_u};
  const long long widths[3] = {4 * head[1], 4 * head[2], head[3]};
  for (int c = 0; c < 3; ++c) {
    Table& tab = p.tab[c];
    tab.old_rows = (const unsigned char*)olds[c];
    tab.staged = b + head[5 + c];
    tab.out = (unsigned char*)outs[c];
    tab.width = widths[c];
    tab.vec = vec_of((uintptr_t)tab.old_rows | (uintptr_t)tab.staged |
                     (uintptr_t)tab.out | (uintptr_t)tab.width);
  }
  p.idx = (const int*)(b + head[4]);
  p.k = (int)k;
  p.t = t;
  const long long warps = 3LL * t;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  table_insert<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// K7: one refresh's hot rows, whole port rows and port words into the view
// tensors (`n` rows; used f32[n, r], node_ok bool[n], dyn_free f32[n],
// ports u32[n, w]), in place. `head` is the host copy of the staged
// buffer's header, `base` the buffer on the card. Returns
// cudaGetLastError() after the launch (0 and no launch for an empty delta).
int nomad_view_delta(const long long* head, const void* base, long long n,
                     void* used, void* node_ok, void* dyn_free, void* ports,
                     void* stream) {
  for (int i = 0; i < 5; ++i)
    if (head[i] < 0) return (int)cudaErrorInvalidValue;
  const unsigned char* b = (const unsigned char*)base;
  Delta d;
  d.used = (float*)used;
  d.node_ok = (unsigned char*)node_ok;
  d.dyn_free = (float*)dyn_free;
  d.ports = (uint32_t*)ports;
  d.n = n;
  d.n_hot = (int)head[0];
  d.r = (int)head[1];
  d.n_prow = (int)head[2];
  d.w = (int)head[3];
  d.n_words = (int)head[4];
  d.hot_idx = (const int*)(b + head[5]);
  d.hot_used = (const float*)(b + head[6]);
  d.hot_ok = b + head[7];
  d.hot_dyn = (const float*)(b + head[8]);
  d.prow_idx = (const int*)(b + head[9]);
  d.prow_vals = (const uint32_t*)(b + head[10]);
  d.word_row = (const int*)(b + head[11]);
  d.word_col = (const int*)(b + head[12]);
  d.word_val = (const uint32_t*)(b + head[13]);
  d.vec_rows = vec_of((uintptr_t)d.ports | (uintptr_t)d.prow_vals |
                      (uintptr_t)(4LL * d.w)) == 16;
  d.hot_blocks = (d.n_hot + kThreads - 1) / kThreads;
  const long long blocks = (long long)d.hot_blocks + d.n_prow +
                           (d.n_words + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  view_delta<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

}  // extern "C"
