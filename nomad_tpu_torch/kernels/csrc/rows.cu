// Row scatter for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the jitted TPU kernel `_get_insert_jit`
// (nomad_tpu/server/program_table.py:99), which writes K static program
// rows into the device program table's i32/f32/u8 class tables, one
// `dynamic_update_index_in_dim` per row. Here it is a generic scatter:
// row k of `src` (W bytes) is copied to row idx[k] of `dst`; one launch
// per class table. The view row-delta kernels still to port
// (nomad_tpu/scheduler/stack.py:115-171) are the same scatter.
//
// Design: one block per source row, its threads copying 16-byte words when
// the row width and both row bases allow it, else 4-byte words, else
// bytes. Rows are independent, so the blocks need no ordering; a later row
// with the same index wins nondeterministically, as it may in the
// reference (callers pass distinct indices).
//
// What bounds it: bytes. K·W read and K·W written — a few kilobytes for a
// cold insert (8 rows of the three tables, ~7.7 KB, bound ~2 ns at
// 3.35 TB/s on an H100); the launch itself costs far more.

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

}  // extern "C"
