// Token dispatch / combine for Hopper: the two indirected row copies that
// move the capacity-mode MoE layer's payloads.
//
//   dispatch_scatter:  out[slot[i]] = x[token_of[i]]    for i < n
//   combine_gather:    out[i]       = yb[slot[i]]       for i < n
//
// Replace the TPU kernels of src/repro/kernels/dispatch_combine/
// dispatch_combine.py: `dispatch_scatter` (`_scatter_kernel`, pl.pallas_call
// at line 46) and `combine_gather` (`_gather_kernel`, pl.pallas_call at line
// 75).  On the TPU each grid step is one row and the row indices arrive by
// scalar prefetch into the BlockSpec index maps; here one block copies one
// row at a time (a block-strided loop over the pairs) and loads its own two
// indices from device memory.  Nothing is read back to the host: the indices
// stay device data, as in the reference.
//
// What bounds it on an H100: nothing but bytes.  Each pair reads one row of
// d elements and writes one; there is no arithmetic.  At the decode shapes
// (n = 64 pairs of d = 4096 bf16) the whole launch moves 1 MB, so launch
// latency dominates, not HBM.  What the design does about it: a row is
// copied with 16-byte vector loads and stores by neighbouring threads on
// neighbouring addresses, whenever the row's bytes and both base pointers
// are 16-byte aligned (the bf16 d = 4096 rows of the serving path); anything
// else takes a scalar loop of the element's own width.  The kernels are
// dtype-agnostic copies: the element size is an argument.
//
// dispatch_scatter's output is zeroed by the caller (torch.zeros, as the
// reference zeroes and aliases it).  Row rows_out - 1 is the trash row that
// dropped pairs point at; the kernel never writes it, so many dropped pairs
// cannot race on it, and the valid slots are unique, so no two blocks write
// one row.  A slot or token outside its table is skipped as well (the
// reference's scatter drops out-of-range rows); combine_gather writes zeros
// for a slot outside yb (the reference's gather fills with 0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_BLOCKS = 4096;

// Copy `units` elements of type U from src to dst, block-wide.
template <typename U>
__device__ __forceinline__ void copy_row(U* __restrict__ dst,
                                         const U* __restrict__ src,
                                         long long units) {
  for (long long j = threadIdx.x; j < units; j += blockDim.x) dst[j] = src[j];
}

template <typename U>
__device__ __forceinline__ void zero_row(U* __restrict__ dst,
                                         long long units) {
  for (long long j = threadIdx.x; j < units; j += blockDim.x) dst[j] = U{};
}

// row_units: one row in units of U; the caller picked U so that it divides
// the row and both bases are aligned to sizeof(U).
template <typename U>
__global__ void __launch_bounds__(THREADS)
dispatch_scatter_kernel(const int* __restrict__ token_of,
                        const int* __restrict__ slot,
                        const U* __restrict__ x, U* __restrict__ out, int n,
                        long long row_units, int rows_in, int rows_out) {
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int t = token_of[i];
    const int s = slot[i];
    // the trash row (rows_out - 1) and anything out of range: skipped
    if (s < 0 || s >= rows_out - 1 || t < 0 || t >= rows_in) continue;
    copy_row(out + static_cast<long long>(s) * row_units,
             x + static_cast<long long>(t) * row_units, row_units);
  }
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
combine_gather_kernel(const int* __restrict__ slot, const U* __restrict__ yb,
                      U* __restrict__ out, int n, long long row_units,
                      int rows_in) {
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int s = slot[i];
    U* dst = out + static_cast<long long>(i) * row_units;
    if (s < 0 || s >= rows_in) {
      zero_row(dst, row_units);
    } else {
      copy_row(dst, yb + static_cast<long long>(s) * row_units, row_units);
    }
  }
}

// The widest unit (16, 8, 4 or 2 bytes, down to the element size) that
// divides the row and to which every base pointer is aligned.
int unit_bytes(long long row_bytes, int elem_size, const void* a,
               const void* b) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  for (int u = 16; u > elem_size; u /= 2) {
    if (row_bytes % u == 0 && addr % u == 0) return u;
  }
  return elem_size;
}

int grid_for(int n) { return n < MAX_BLOCKS ? n : MAX_BLOCKS; }

}  // namespace

// token_of, slot: [n] int32; x: [rows_in, d]; out: [rows_out, d], zeroed by
// the caller.  elem_size: 2 (bf16) or 4 (fp32).  Returns a cudaError_t.
extern "C" int dispatch_scatter_launch(const void* token_of, const void* slot,
                                       const void* x, void* out, int n,
                                       int d, int elem_size, int rows_in,
                                       int rows_out, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (elem_size != 2 && elem_size != 4) return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(d) * elem_size;
  const int u = unit_bytes(row_bytes, elem_size, x, out);
  const long long units = row_bytes / u;
  const int* t = reinterpret_cast<const int*>(token_of);
  const int* sl = reinterpret_cast<const int*>(slot);
  const int grid = grid_for(n);
  switch (u) {
    case 16:
      dispatch_scatter_kernel<uint4><<<grid, THREADS, 0, s>>>(
          t, sl, reinterpret_cast<const uint4*>(x),
          reinterpret_cast<uint4*>(out), n, units, rows_in, rows_out);
      break;
    case 8:
      dispatch_scatter_kernel<uint2><<<grid, THREADS, 0, s>>>(
          t, sl, reinterpret_cast<const uint2*>(x),
          reinterpret_cast<uint2*>(out), n, units, rows_in, rows_out);
      break;
    case 4:
      dispatch_scatter_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
          t, sl, reinterpret_cast<const uint32_t*>(x),
          reinterpret_cast<uint32_t*>(out), n, units, rows_in, rows_out);
      break;
    default:
      dispatch_scatter_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
          t, sl, reinterpret_cast<const uint16_t*>(x),
          reinterpret_cast<uint16_t*>(out), n, units, rows_in, rows_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// slot: [n] int32; yb: [rows_in, d]; out: [n, d].  Returns a cudaError_t.
extern "C" int combine_gather_launch(const void* slot, const void* yb,
                                     void* out, int n, int d, int elem_size,
                                     int rows_in, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (elem_size != 2 && elem_size != 4) return -1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(d) * elem_size;
  const int u = unit_bytes(row_bytes, elem_size, yb, out);
  const long long units = row_bytes / u;
  const int* sl = reinterpret_cast<const int*>(slot);
  const int grid = grid_for(n);
  switch (u) {
    case 16:
      combine_gather_kernel<uint4><<<grid, THREADS, 0, s>>>(
          sl, reinterpret_cast<const uint4*>(yb),
          reinterpret_cast<uint4*>(out), n, units, rows_in);
      break;
    case 8:
      combine_gather_kernel<uint2><<<grid, THREADS, 0, s>>>(
          sl, reinterpret_cast<const uint2*>(yb),
          reinterpret_cast<uint2*>(out), n, units, rows_in);
      break;
    case 4:
      combine_gather_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
          sl, reinterpret_cast<const uint32_t*>(yb),
          reinterpret_cast<uint32_t*>(out), n, units, rows_in);
      break;
    default:
      combine_gather_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
          sl, reinterpret_cast<const uint16_t*>(yb),
          reinterpret_cast<uint16_t*>(out), n, units, rows_in);
  }
  return static_cast<int>(cudaGetLastError());
}
