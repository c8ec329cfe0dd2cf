// Row scatters for Hopper (sm_90a), hand-written CUDA C++.
//
// K8 — replaces the jitted TPU kernel `_get_insert_jit`
// (nomad_tpu/server/program_table.py:99), which writes K static program
// rows into the device program table's i32/f32/u8 class tables, one
// `dynamic_update_index_in_dim` per row. Here it is a generic scatter:
// row k of `src` (W bytes) is copied to row idx[k] of `dst`; one launch
// per class table.
//
// K7 — replaces the view row-delta kernels of the device view cache
// (nomad_tpu/scheduler/stack.py:115-227: `_rows_update`,
// `_hot_delta_impl`, `_ports_delta_impl`, `_ports_word_impl`, run by
// `_apply_chunked` over 32-row chunks). Three entry points:
//   - `nomad_hot_rows`: the hot-row refresh of one delta, used (f32[N, R]),
//     node_ok (bool[N]) and dyn_free (f32[N]) written in ONE launch, one
//     thread per delta row;
//   - whole port rows (8 KiB rows of the u32[N, 2048] bitmap) go through
//     the generic `nomad_row_scatter` below (one block per row);
//   - `nomad_word_scatter`: single u32 words, ports[row[k], word[k]] =
//     val[k], one thread per word.
// The reference pads each chunk by repeating its first row (an
// idempotent rewrite, needed for one XLA shape); these kernels take any
// count and the callers pass distinct indices, so no padding exists.
//
// Design: rows (and words) are independent, so blocks need no ordering.
// A later entry with the same index wins nondeterministically, as it may
// in the reference (callers pass distinct indices). Indices outside the
// destination are skipped.
//
// What bounds them: bytes. A hot row reads 4 + 4R + 1 + 4 bytes of delta
// and writes 4R + 1 + 4 (R = 8: 41 read, 37 written); a port row reads
// 4 + 8192 and writes 8192; a port word reads 12 and writes 4. A refresh
// moves a few kilobytes (ns at 3.35 TB/s on an H100); the launch costs
// far more, which is why the hot part is one launch, not three.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ void copy_row(unsigned char* dst,
                                         const unsigned char* src,
                                         long long width) {
  const long long words = width / (long long)sizeof(T);
  T* d = (T*)dst;
  const T* s = (const T*)src;
  for (long long i = threadIdx.x; i < words; i += blockDim.x) d[i] = s[i];
}

__global__ void row_scatter(unsigned char* dst, long long dst_rows,
                            const int* idx, const unsigned char* src,
                            long long width) {
  const int k = blockIdx.x;
  const int row = idx[k];
  if (row < 0 || row >= dst_rows) return;
  unsigned char* d = dst + (long long)row * width;
  const unsigned char* s = src + (long long)k * width;
  const uintptr_t align = (uintptr_t)d | (uintptr_t)s | (uintptr_t)width;
  if ((align & 15) == 0)
    copy_row<uint4>(d, s, width);
  else if ((align & 3) == 0)
    copy_row<uint32_t>(d, s, width);
  else
    copy_row<unsigned char>(d, s, width);
}

__global__ void hot_rows(float* used, unsigned char* node_ok,
                         float* dyn_free, long long n_rows, int r,
                         const int* idx, const float* used_vals,
                         const unsigned char* ok_vals,
                         const float* dyn_vals, int k_rows) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_rows) return;
  const int row = idx[k];
  if (row < 0 || row >= n_rows) return;
  float* d = used + (long long)row * r;
  const float* s = used_vals + (long long)k * r;
  for (int j = 0; j < r; ++j) d[j] = s[j];
  node_ok[row] = ok_vals[k];
  dyn_free[row] = dyn_vals[k];
}

__global__ void word_scatter(uint32_t* dst, long long n_rows, int width,
                             const int* rows, const int* words,
                             const uint32_t* vals, int k_words) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_words) return;
  const int row = rows[k];
  const int word = words[k];
  if (row < 0 || row >= n_rows || word < 0 || word >= width) return;
  dst[(long long)row * width + word] = vals[k];
}

}  // namespace

extern "C" {

const char* nomad_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dst[idx[k], :] = src[k, :] for k < k_rows, rows of `width` bytes;
// indices outside [0, dst_rows) are skipped. Returns cudaGetLastError().
int nomad_row_scatter(void* dst, long long dst_rows, const void* idx,
                      const void* src, int k_rows, long long width,
                      void* stream) {
  if (k_rows < 0 || width < 0) return (int)cudaErrorInvalidValue;
  if (k_rows == 0 || width == 0) return 0;
  row_scatter<<<k_rows, 256, 0, (cudaStream_t)stream>>>(
      (unsigned char*)dst, dst_rows, (const int*)idx,
      (const unsigned char*)src, width);
  return (int)cudaGetLastError();
}

// used[idx[k], :] = used_vals[k, :] (r floats), node_ok[idx[k]] =
// ok_vals[k] (one byte), dyn_free[idx[k]] = dyn_vals[k], for k < k_rows;
// indices outside [0, n_rows) are skipped. Returns cudaGetLastError().
int nomad_hot_rows(void* used, void* node_ok, void* dyn_free,
                   long long n_rows, int r, const void* idx,
                   const void* used_vals, const void* ok_vals,
                   const void* dyn_vals, int k_rows, void* stream) {
  if (k_rows < 0 || r < 0) return (int)cudaErrorInvalidValue;
  if (k_rows == 0) return 0;
  const int threads = 128;
  hot_rows<<<(k_rows + threads - 1) / threads, threads, 0,
             (cudaStream_t)stream>>>(
      (float*)used, (unsigned char*)node_ok, (float*)dyn_free, n_rows, r,
      (const int*)idx, (const float*)used_vals,
      (const unsigned char*)ok_vals, (const float*)dyn_vals, k_rows);
  return (int)cudaGetLastError();
}

// dst[rows[k] * width + words[k]] = vals[k] (u32) for k < k_words, over a
// [n_rows, width] bitmap; entries outside it are skipped. Returns
// cudaGetLastError().
int nomad_word_scatter(void* dst, long long n_rows, int width,
                       const void* rows, const void* words, const void* vals,
                       int k_words, void* stream) {
  if (k_words < 0 || width < 0) return (int)cudaErrorInvalidValue;
  if (k_words == 0) return 0;
  const int threads = 256;
  word_scatter<<<(k_words + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      (uint32_t*)dst, n_rows, width, (const int*)rows, (const int*)words,
      (const uint32_t*)vals, k_words);
  return (int)cudaGetLastError();
}

}  // extern "C"
