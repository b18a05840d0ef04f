// MoE Super Kernel for Hopper: layer-oblivious grouped (batched-expert) matmul.
//
//   out[e, c, n] = sum_k x[e, c, k] * w[layer_id[0], e, k, n]      (fp32 out)
//
// Replaces the TPU kernel src/repro/kernels/super_gmm/super_gmm.py::super_gmm
// (`_kernel`, pl.pallas_call at line 68).  The three defining properties are
// kept: the kernel is handed the base pointer and strides of the FULL
// [L, E, K, N] weight stack, the (layer, expert, tile) address arithmetic is
// done here, and the layer id is read in the kernel from a one-element int32
// device tensor, so one launch signature serves every layer with no host
// round trip.
//
// What bounds it on an H100: at the serving shapes one launch reads one MoE
// device's expert weights once (n_e * K * N elements) against
// 2 * n_e * C * K * N operations.  Below about 300 rows per expert the weight
// read over HBM is the bound, above it the tensor cores are.  What the design
// does about it: one block per (expert, C-tile, N-tile) so a small C still
// spreads the weight read over hundreds of blocks; 16-byte cp.async loads
// through a three-stage shared-memory ring, so the next K-tiles are in flight
// while the current one is multiplied; bf16 inputs go through the tensor
// cores (wmma 16x16x16, fp32 accumulate), fp32 inputs through a
// register-tiled FMA loop in full fp32.
//
// Capacity buffers are mostly padding when routing is skewed (every expert's
// buffer is as long as the hottest expert's).  `counts` (optional, [E] int32
// on the device -- the dispatch protocol's per-expert row counts) tells the
// kernel how many leading rows of each expert's buffer are real: a C-tile
// wholly beyond counts[e] reads no weight and issues no product, it only
// writes its zeros, so the work follows the rows that exist.  Like the layer
// id, the counts are device data: no host round trip, one launch signature.
//
// The TPU's sequential fourth grid axis (K) has no counterpart: the K loop is
// inside the block with a register accumulator.  The K reduction order
// depends on (K, dtype) only -- fixed BK, ascending, no split-K -- never on C,
// so a row's result is bitwise the same wherever it sits in a capacity
// buffer.  Ragged C, N and K edges are masked, not rounded to divisors.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using bf16 = __nv_bfloat16;

namespace {

// Leading rows of expert e's buffer that are real; the rest is zero padding.
__device__ __forceinline__ int real_rows(const int* counts, int e, int C) {
  return counts == nullptr ? C : min(C, counts[e]);
}

template <int BC, int BN, int THREADS>
__device__ __forceinline__ void zero_tile(float* op, int c0, int n0, int C,
                                          int N) {
  for (int idx = threadIdx.x; idx < BC * BN; idx += THREADS) {
    const int gr = c0 + idx / BN, gn = n0 + idx % BN;
    if (gr < C && gn < N) op[(size_t)gr * N + gn] = 0.f;
  }
}

// ------------------------------------------------------------------ fp32 --
// 64x64 output tile, BK = 16, 256 threads, 4x4 micro-tile per thread.
constexpr int F_BC = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
super_gmm_f32_kernel(const int* __restrict__ layer_ptr,
                     const int* __restrict__ counts,
                     const float* __restrict__ w, const float* __restrict__ x,
                     float* __restrict__ out, int C, int K, int N,
                     long long w_stride_l, long long w_stride_e) {
  __shared__ float As[F_BC][F_BK + 1];
  __shared__ float Bs[F_BK][F_BN];
  const int layer = *layer_ptr;  // dynamic resolution: the layer is data
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * F_BC, n0 = blockIdx.x * F_BN;
  const float* wp = w + layer * w_stride_l + e * w_stride_e;
  const float* xp = x + (size_t)e * C * K;
  float* op = out + (size_t)e * C * N;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int rows = real_rows(counts, e, C);
  if (c0 >= rows) {  // a tile of padding: zeros out, nothing read
    zero_tile<F_BC, F_BN, F_THREADS>(op, c0, n0, C, N);
    return;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int i = 0; i < (F_BC * F_BK) / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx / F_BK, kk = idx % F_BK;
      const int gr = c0 + r, gk = k0 + kk;
      As[r][kk] = (gr < rows && gk < K) ? xp[(size_t)gr * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (F_BK * F_BN) / F_THREADS; ++i) {
      const int idx = tid + i * F_THREADS;
      const int kk = idx / F_BN, c = idx % F_BN;
      const int gk = k0 + kk, gn = n0 + c;
      Bs[kk][c] = (gk < K && gn < N) ? wp[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = c0 + ty * 4 + i;
    if (gr >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) op[(size_t)gr * N + gn] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ bf16 --
// 128x128 output tile, BK = 32, 8 warps in a 2x4 arrangement, each warp a
// 64x32 sub-tile = 4x2 wmma accumulators.  x and w tiles travel global ->
// shared by cp.async through a ring of H_STAGES stages, so the loads of the
// next tiles are in flight while the tensor cores work on the current one.
// A warp whose 16-row slices lie beyond the expert's real rows issues no
// product for them (the same K order for every row that is computed).
constexpr int H_BC = 128, H_BN = 128, H_BK = 32, H_THREADS = 256;
constexpr int H_STAGES = 3;
constexpr int H_LDA = H_BK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int H_LDB = H_BN + 8;
constexpr int H_LDC = H_BN + 8;   // fp32 staging for the masked store
constexpr int H_A_ELEMS = H_BC * H_LDA, H_B_ELEMS = H_BK * H_LDB;
constexpr int H_STAGE_ELEMS = H_A_ELEMS + H_B_ELEMS;
constexpr int H_PIPE_BYTES = H_STAGES * H_STAGE_ELEMS * 2;
constexpr int H_C_BYTES = H_BC * H_LDC * 4;
constexpr int H_SMEM = H_PIPE_BYTES > H_C_BYTES ? H_PIPE_BYTES : H_C_BYTES;
constexpr int H_XCH = (H_BC * H_BK / 8) / H_THREADS;  // 16-byte chunks/thread
constexpr int H_WCH = (H_BK * H_BN / 8) / H_THREADS;
static_assert(H_XCH * H_THREADS * 8 == H_BC * H_BK, "x tile / threads");
static_assert(H_WCH * H_THREADS * 8 == H_BK * H_BN, "w tile / threads");
static_assert((H_STAGE_ELEMS * 2) % 128 == 0 && (H_A_ELEMS * 2) % 32 == 0,
              "stage alignment");

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight consecutive bf16 of one row into shared memory: asynchronously when
// the chunk is whole and 16-byte aligned, element by element at a ragged or
// unaligned edge, zeros beyond the row's end or when the row itself is out
// of range (`row` null).
__device__ __forceinline__ void copy8(bf16* dst, const bf16* row, int col,
                                      int ncols, bool vec_ok) {
  if (row == nullptr || col >= ncols) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (vec_ok && col + 8 <= ncols) {
    cp_async16(dst, row + col);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = col + i < ncols ? row[col + i] : __float2bfloat16(0.f);
  }
}

__global__ void __launch_bounds__(H_THREADS)
super_gmm_bf16_kernel(const int* __restrict__ layer_ptr,
                      const int* __restrict__ counts,
                      const bf16* __restrict__ w, const bf16* __restrict__ x,
                      float* __restrict__ out, int C, int K, int N,
                      long long w_stride_l, long long w_stride_e, int vec_ok) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pipe = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int layer = *layer_ptr;  // dynamic resolution: the layer is data
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * H_BC, n0 = blockIdx.x * H_BN;
  const bf16* wp = w + layer * w_stride_l + e * w_stride_e;
  const bf16* xp = x + (size_t)e * C * K;
  float* op = out + (size_t)e * C * N;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const bool vec = vec_ok != 0;
  const int rows = real_rows(counts, e, C);
  if (c0 >= rows) {  // a tile of padding: zeros out, nothing read
    zero_tile<H_BC, H_BN, H_THREADS>(op, c0, n0, C, N);
    return;
  }
  // 16-row slices of this warp's 64 rows that hold a real row (warp-uniform)
  const int live = min(4, max(0, (rows - c0 - wm * 64 + 15) / 16));

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_stage = [&](int stage, int k0) {
    bf16* As = pipe + stage * H_STAGE_ELEMS;
    bf16* Bs = As + H_A_ELEMS;
#pragma unroll
    for (int i = 0; i < H_XCH; ++i) {
      const int idx = tid + i * H_THREADS;
      const int r = idx / (H_BK / 8), ch = idx % (H_BK / 8);
      const int gr = c0 + r;
      copy8(As + r * H_LDA + ch * 8,
            gr < rows ? xp + (size_t)gr * K : nullptr, k0 + ch * 8, K, vec);
    }
#pragma unroll
    for (int i = 0; i < H_WCH; ++i) {
      const int idx = tid + i * H_THREADS;
      const int kk = idx / (H_BN / 8), ch = idx % (H_BN / 8);
      const int gk = k0 + kk;
      copy8(Bs + kk * H_LDB + ch * 8,
            gk < K ? wp + (size_t)gk * N : nullptr, n0 + ch * 8, N, vec);
    }
  };

  const int nk = (K + H_BK - 1) / H_BK;
#pragma unroll
  for (int s = 0; s < H_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * H_BK);
    cp_async_commit();  // one group per stage, also when it is empty
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<H_STAGES - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread, and stage kt-1 is free again
    const int nxt = kt + H_STAGES - 1;
    if (nxt < nk) load_stage(nxt % H_STAGES, nxt * H_BK);
    cp_async_commit();
    const bf16* As = pipe + (kt % H_STAGES) * H_STAGE_ELEMS;
    const bf16* Bs = As + H_A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * H_LDB + wn * 32 + j * 16,
                               H_LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < live) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, As + (wm * 64 + i * 16) * H_LDA + kk,
                                 H_LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it as staging
  // stage the tile in shared memory, then store it with the edges masked
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * 64 + i * 16) * H_LDC + wn * 32 + j * 16, acc[i][j],
          H_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < H_BC * H_BN; idx += H_THREADS) {
    const int r = idx / H_BN, c = idx % H_BN;
    const int gr = c0 + r, gn = n0 + c;
    if (gr < C && gn < N) op[(size_t)gr * N + gn] = Cs[r * H_LDC + c];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `counts` may be null (every row real).
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (or -1 for a bad dtype).
extern "C" int super_gmm_launch(const void* layer_id, const void* counts,
                                const void* w, const void* x, void* out,
                                int dtype, int E,
                                int C, int K, int N, long long w_stride_l,
                                long long w_stride_e, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* lid = reinterpret_cast<const int*>(layer_id);
  const int* cnt = reinterpret_cast<const int*>(counts);
  float* o = reinterpret_cast<float*>(out);
  if (dtype == 0) {
    dim3 grid((N + F_BN - 1) / F_BN, (C + F_BC - 1) / F_BC, E);
    super_gmm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        lid, cnt, reinterpret_cast<const float*>(w),
        reinterpret_cast<const float*>(x), o, C, K, N, w_stride_l,
        w_stride_e);
  } else if (dtype == 1) {
    const bool aligned =
        (reinterpret_cast<size_t>(w) % 16 == 0) &&
        (reinterpret_cast<size_t>(x) % 16 == 0) && (K % 8 == 0) &&
        (N % 8 == 0) && (w_stride_l % 8 == 0) && (w_stride_e % 8 == 0);
    dim3 grid((N + H_BN - 1) / H_BN, (C + H_BC - 1) / H_BC, E);
    cudaError_t err = cudaFuncSetAttribute(
        super_gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        H_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    super_gmm_bf16_kernel<<<grid, H_THREADS, H_SMEM, s>>>(
        lid, cnt, reinterpret_cast<const bf16*>(w),
        reinterpret_cast<const bf16*>(x), o, C, K, N, w_stride_l, w_stride_e,
        aligned ? 1 : 0);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
