// MoE Super Kernel for Hopper: layer-oblivious grouped (batched-expert) matmul.
//
//   out[e, c, n] = sum_k x[e, c, k] * w[layer_id[0], e, k, n]      (fp32 out)
//
// Replaces the TPU kernel src/repro/kernels/super_gmm/super_gmm.py::super_gmm
// (`_kernel`, pl.pallas_call at line 68).  The three defining properties are
// kept: the kernel is handed the FULL [L, E, K, N] weight stack, the
// (layer, expert, tile) address arithmetic is done here, and the layer id is
// read in the kernel from a one-element int32 device tensor, so one launch
// signature serves every layer with no host round trip.
//
// Capacity buffers are mostly padding when routing is skewed (every expert's
// buffer is as long as the hottest expert's).  `counts` (optional, [E] int32
// on the device -- the dispatch protocol's per-expert row counts) says how
// many leading rows of each expert's buffer are real; the rest come out as
// zeros, also where x holds something there.  Like the layer id, the counts
// are device data: no host round trip, one launch signature.
//
// What bounds it on an H100: one launch reads the weights of the experts
// that have rows (K * N each) and writes the whole fp32 output, against
// 2 * rows * K * N operations.  At the serving shapes (qwen3, one MoE device:
// 32 experts, K/N 4096/1536, ~1300 real rows in a 512-row bucket) the weight
// read and the fp32 output (padding zeros included) over HBM are the bound;
// a dense buffer of 512 rows per expert is bound by the tensor cores.
//
// bf16 (`super_gmm_wgmma_kernel<BM, BN>`, the main path): wgmma on a
// TMA-fed ring.  One persistent block per SM, three warpgroups.  Each block
// reads counts[0..E) into shared memory and prefix-sums the real BM-row
// tiles of every expert (ceil(min(counts[e], C) / BM)) and the padding rows
// beyond them; it first writes its even share of the padding rows' zeros
// with 16-byte stores, then walks the real (expert, n-tile, m-tile) tiles
// with a stride of gridDim.x -- m-tiles innermost, so blocks that run
// together share an expert's weights in L2.  Warpgroup 2 is the producer:
// one thread reads the layer id and streams each tile's K-steps (BK = 64: a
// BMx64 x tile in 64-row halves and a 64xBN weight tile in 64-column
// chunks; 48 KB at the default 128x256) by TMA into a ring with mbarriers
// (as many stages as fit: 4 at 128x256, up to 8 for narrower tiles),
// skipping the half of the x tile that holds no real row.  One weight tensor
// map over the whole [L, E, K, N] stack, with its real strides (the resident
// stacks are strided views), serves every layer and every tile: layer and
// expert are TMA coordinates.  It is built on the host once per weight
// tensor and cached by (pointer, shape, strides).  x gets a 3-D map over
// [E, C, K] per call, so rows beyond C read as zeros and no tile spills into
// the next expert.  Warpgroups 0 and 1 run wgmma m64nWk16 from the swizzled
// ring (weights MN-major), one group in flight while the next stage lands:
// at BM = 128 each owns 64 rows and the whole BN (W = BN), at BM = 64 both
// take the same 64 rows and half of BN each (W = BN / 2).  The epilogue
// writes fp32 pairs straight from the accumulator registers, padding rows as
// zeros, masked at the C and N edges.
//
// Tiles.  BK is fixed at 64 and BM, BN are chosen per launch: the
// instantiated (BM, BN) are 128x256 (the default), 128x128, 64x256 and
// 64x128, picked by super_gmm_launch's `tile` index (a tuning table names
// them per capacity bucket; kernels/super_gmm/tuning.py).  No tile changes
// the K reduction order: every output element is one warpgroup's register,
// summed by wgmma k16 steps in ascending K, 4 per BK = 64 stage, stages in
// ascending K, no split-K -- the same sequence at every (BM, BN), which only
// decides which block and warpgroup hold the element.  So the order depends
// on (K, dtype) only, never on the tile, C or the counts, and a row's result
// is bitwise the same wherever it sits in a capacity buffer and whichever
// tile computed it.

// Other routes, picked by shape in the wrapper (`route`) and handed to
// super_gmm_launch, which refuses tensors the wgmma route cannot take: bf16
// that TMA cannot describe (K or N not a multiple of
// 8, K = 0, a base not 16-byte aligned, a weight stride not a multiple of 16
// bytes, more than 1024 experts) takes `super_gmm_bf16_kernel` on wmma with a
// cp.async ring; fp32 takes `super_gmm_f32_kernel`, a register-tiled FMA
// loop (correctness only).  Ragged C, N and K edges are masked, not rounded
// to divisors, on every route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <mutex>
#include <vector>

#include "hopper.cuh"

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

// ------------------------------------------------------- bf16 on wmma --
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

// ------------------------------------------- bf16 on wgmma + TMA (sm_90a) --
namespace wg {

// BK is fixed for every tile; BM and BN are template arguments (Cfg below),
// and super_gmm_launch picks the instantiation by its `tile` argument.
constexpr int BK = 64;
constexpr int THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int MAX_E = 1024;
constexpr int A_HALF = 64 * BK * 2;   // 64 rows of x, K-major: 8 KB
constexpr int B_CHUNK = BK * 64 * 2;  // 64 K-rows of 64 weight columns: 8 KB
constexpr int SMEM_CAP = 232448;      // a block's shared memory on an H100
constexpr int MAX_STAGES = 8;
// what lies after the ring: mbarriers (for the most stages), the prefix of
// real tiles, the real rows, the prefix of padding elements, the alignment
constexpr int TAIL = 8 * 2 * MAX_STAGES + 4 * (MAX_E + 1) + 4 * MAX_E + 8 +
                     8 * (MAX_E + 1) + 1024;

// One (BM, BN) tile.  The two consumer warpgroups own 64 rows each at
// BM = 128 (WM = 2, each the whole BN), or split BN at BM = 64 (WN = 2,
// both on the same 64 rows).  A narrower stage takes more of them.
template <int BM_, int BN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WM = BM / 64;   // consumer warpgroups along M
  static constexpr int WN = 2 / WM;    // ... and along N
  static constexpr int WGN = BN / WN;  // columns of one consumer warpgroup
  static constexpr int STAGE = WM * A_HALF + (BN / 64) * B_CHUNK;
  static constexpr int FIT = (SMEM_CAP - TAIL) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int OFF_BAR = STAGES * STAGE;
  static constexpr int OFF_TILES = OFF_BAR + 8 * 2 * STAGES;  // int[MAX_E+1]
  static constexpr int OFF_ROWS = OFF_TILES + 4 * (MAX_E + 1);  // int[MAX_E]
  static constexpr int OFF_ZEROS = (OFF_ROWS + 4 * MAX_E + 7) / 8 * 8;
  static constexpr int SMEM = OFF_ZEROS + 8 * (MAX_E + 1) + 1024;
  static_assert(BM == 64 || BM == 128, "BM: one or two 64-row halves");
  static_assert(BN % 64 == 0 && WGN >= 64 && WGN <= 256 && WGN % 64 == 0,
                "BN: 64-column weight chunks, a wgmma width per warpgroup");
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(STAGES >= 2 && SMEM <= SMEM_CAP, "the ring fits");
};

// The largest e < E with pre[e] <= v (pre non-decreasing, pre[E] > v).
template <typename T>
__device__ __forceinline__ int find_expert(const T* pre, int E, T v) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (pre[mid] <= v) lo = mid; else hi = mid;
  }
  return lo;
}

struct Tile {
  int e, m0, n0, rows;  // rows: the expert's real rows
};

// Real tile t of the walk: experts outermost, then n-tiles, then m-tiles.
template <int BM, int BN>
__device__ __forceinline__ Tile tile_at(int t, const int* tiles,
                                        const int* rows, int E) {
  Tile r;
  r.e = find_expert(tiles, E, t);
  r.rows = rows[r.e];
  const int mt = (r.rows + BM - 1) / BM;
  const int local = t - tiles[r.e];
  r.n0 = (local / mt) * BN;
  r.m0 = (local % mt) * BM;
  return r;
}

// acc (+)= A[64 x 16] * B[16 x WGN], both from the swizzled ring.
template <int WGN>
__device__ __forceinline__ void mma(float (&acc)[WGN / 2], uint64_t da,
                                    uint64_t db, int scale_d) {
  if constexpr (WGN == 256) {
    hopper::wgmma_ss_n256<1>(acc, da, db, scale_d);
  } else if constexpr (WGN == 128) {
    hopper::wgmma_ss_n128<1>(acc, da, db, scale_d);
  } else {
    static_assert(WGN == 64, "a consumer warpgroup's width");
    hopper::wgmma_ss_n64<1>(acc, da, db, scale_d);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
super_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap tx,
                       const int* __restrict__ layer_ptr,
                       const int* __restrict__ counts,
                       float* __restrict__ out, int E, int C, int K, int N) {
  using T = Cfg<BM, BN>;
  constexpr int STAGES = T::STAGES, WM = T::WM, WGN = T::WGN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  uint64_t* empty = full + STAGES;
  int* tiles = reinterpret_cast<int*>(smem + T::OFF_TILES);  // prefix
  int* rows = reinterpret_cast<int*>(smem + T::OFF_ROWS);
  long long* zeros = reinterpret_cast<long long*>(smem + T::OFF_ZEROS);
  const int NT = (N + BN - 1) / BN, nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Real rows per expert (device data), and two prefix sums over experts:
  // real tiles, and padding elements beyond the last real tile.
  if (warp == 0) {
    int run_t = 0;
    long long run_z = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      int t = 0;
      long long z = 0;
      if (e < E) {
        const int r = counts == nullptr ? C : min(max(counts[e], 0), C);
        const int mt = (r + BM - 1) / BM;
        rows[e] = r;
        t = mt * NT;
        z = static_cast<long long>(C - min(C, mt * BM)) * N;
      }
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int tv = __shfl_up_sync(0xffffffffu, t, off);
        const long long zv = __shfl_up_sync(0xffffffffu, z, off);
        if (lane >= off) {
          t += tv;
          z += zv;
        }
      }
      if (e < E) {
        tiles[e + 1] = run_t + t;
        zeros[e + 1] = run_z + z;
      }
      run_t += __shfl_sync(0xffffffffu, t, 31);
      run_z += __shfl_sync(0xffffffffu, z, 31);
    }
    if (lane == 0) {
      tiles[0] = 0;
      zeros[0] = 0;
    }
  }
  if (threadIdx.x == 32) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int total = tiles[E];

  if (threadIdx.x >= 256) {  // ------------------------------ producer --
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      const int layer = *layer_ptr;  // dynamic resolution: the layer is data
      int it = 0;  // K-steps issued: the position in the ring
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = tile_at<BM, BN>(t, tiles, rows, E);
        // the second x half (BM = 128) has a real row
        const bool hi_live = WM == 2 && tl.m0 + 64 < tl.rows;
        const uint32_t bytes =
            (hi_live ? 2 : 1) * A_HALF + (BN / 64) * B_CHUNK;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * T::STAGE;
          hopper::mbar_expect_tx(&full[s], bytes);
          hopper::tma_load_3d(st, &tx, &full[s], kt * BK, tl.m0, tl.e);
          if (hi_live)
            hopper::tma_load_3d(st + A_HALF, &tx, &full[s], kt * BK,
                                tl.m0 + 64, tl.e);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_4d(st + WM * A_HALF + c * B_CHUNK, &tw,
                                &full[s], tl.n0 + 64 * c, kt * BK, tl.e,
                                layer);
        }
      }
    }
  } else {  // --------------------------------------------- consumers --
    hopper::regs_alloc<232>();
    const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int wm = wgi % WM, wn = wgi / WM;  // this warpgroup's rows, columns

    // 1. this block's even share of the padding rows beyond the real
    //    tiles: whole rows, so each expert's share is one contiguous run
    const long long zall = zeros[E];
    const long long z0 = zall / 4 * blockIdx.x / gridDim.x * 4;
    const long long z1 = zall / 4 * (blockIdx.x + 1) / gridDim.x * 4;
    for (long long pos = z0; pos < z1;) {
      const int e = find_expert(zeros, E, pos);
      const long long end = min(z1, zeros[e + 1]);
      const int mt = (rows[e] + BM - 1) / BM;
      float* base = out + (static_cast<long long>(e) * C + mt * BM) * N +
                    (pos - zeros[e]);
      float4* dst = reinterpret_cast<float4*>(base);
      const long long n4 = (end - pos) / 4;
      for (long long i = threadIdx.x; i < n4; i += 256)
        dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      pos = end;
    }

    // 2. the real tiles.  A warpgroup whose rows are all padding multiplies
    //    too (its x half was not loaded; its rows are stored as zeros):
    //    a branch around wgmma would make ptxas serialise every product.
    float acc[WGN / 2];
#pragma unroll
    for (int i = 0; i < WGN / 2; ++i) acc[i] = 0.f;
    const int r0 = (tid / 32) * 16 + lane / 4;  // rows r0, r0 + 8 of 64
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = tile_at<BM, BN>(t, tiles, rows, E);
      const int mw = tl.m0 + 64 * wm;   // this warpgroup's first row
      const int nw = tl.n0 + WGN * wn;  // ... and first column
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = smem + s * T::STAGE;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da =
              hopper::desc_sw128(st + wm * A_HALF + kk * 32, 16, 1024);
          const uint64_t db = hopper::desc_sw128(
              st + WM * A_HALF + wn * (WGN / 64) * B_CHUNK + kk * 16 * 128,
              B_CHUNK, 1024);
          mma<WGN>(acc, da, db, (kt | kk) != 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous K-step's products are done
        if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      // epilogue: fp32 pairs from the registers; padding rows as zeros
      float* ob = out + static_cast<long long>(tl.e) * C * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mw + r0 + 8 * r;
        if (row >= C) continue;
        const bool real = row < tl.rows;
        float* orow = ob + static_cast<long long>(row) * N + nw +
                      2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < WGN / 8; ++j) {
          if (nw + 8 * j + 2 * (lane & 3) >= N) continue;
          *reinterpret_cast<float2*>(orow + 8 * j) =
              real ? make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1])
                   : make_float2(0.f, 0.f);
        }
      }
    }
  }
}

// One weight tensor map per weight tensor, built on the host once and kept
// by (pointer, shape, strides): the map is a pure function of that key, so
// an entry can never go stale, and every tile reads through it (its boxes
// are 64-column chunks, whatever the tile's BN).  Launches come from several
// host threads.
struct WeightKey {
  const void* w;
  long long L, E, K, N, sl, se;
  bool operator==(const WeightKey& o) const {
    return w == o.w && L == o.L && E == o.E && K == o.K && N == o.N &&
           sl == o.sl && se == o.se;
  }
};

bool weight_map(CUtensorMap* out, const WeightKey& key) {
  static std::mutex mu;
  static std::vector<std::pair<WeightKey, CUtensorMap>> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& kv : cache)
    if (kv.first == key) {
      *out = kv.second;
      return true;
    }
  // 4-D over [L, E, K, N]: (n, k, expert, layer) are a tile's coordinates
  const uint64_t dims[4] = {static_cast<uint64_t>(key.N),
                            static_cast<uint64_t>(key.K),
                            static_cast<uint64_t>(key.E),
                            static_cast<uint64_t>(key.L)};
  const uint64_t strides[3] = {2ull * key.N, 2ull * key.se, 2ull * key.sl};
  const uint32_t box[4] = {64, BK, 1, 1};
  if (!hopper::make_map(out, key.w, 4, dims, strides, box)) return false;
  if (cache.size() >= 256) cache.clear();
  cache.emplace_back(key, *out);
  return true;
}

template <int BM, int BN>
int launch(const int* lid, const int* cnt, const void* w, const void* x,
           float* o, int L, int E, int C, int K, int N, long long w_stride_l,
           long long w_stride_e, cudaStream_t stream) {
  using T = Cfg<BM, BN>;
  CUtensorMap tw, tx;
  if (!weight_map(&tw, {w, L, E, K, N, w_stride_l, w_stride_e})) return -3;
  // 3-D over [E, C, K] in 64-row halves: rows beyond C read as zeros
  const uint64_t dims[3] = {static_cast<uint64_t>(K),
                            static_cast<uint64_t>(C),
                            static_cast<uint64_t>(E)};
  const uint64_t strides[2] = {2ull * K, 2ull * C * K};
  const uint32_t box[3] = {BK, 64, 1};
  if (!hopper::make_map(&tx, x, 3, dims, strides, box)) return -3;
  cudaError_t err =
      hopper::allow_smem<super_gmm_wgmma_kernel<BM, BN>>(T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = hopper::sm_count();
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  super_gmm_wgmma_kernel<BM, BN><<<grid, THREADS, T::SMEM, stream>>>(
      tw, tx, lid, cnt, o, E, C, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// Routes, as kernels/super_gmm/super_gmm.py::route picks them by shape:
constexpr int ROUTE_FMA = 0;    // fp32
constexpr int ROUTE_WMMA = 1;   // bf16 that TMA cannot describe
constexpr int ROUTE_WGMMA = 2;  // bf16, TMA-describable: the main path

#define WG_ARGS lid, cnt, w, x, o, L, E, C, K, N, w_stride_l, w_stride_e, s

// route: one of ROUTE_* (fp32 tensors for FMA, bf16 for the other two).
// tile: the wgmma route's (BM, BN), by index (kernels/super_gmm/
// super_gmm.py::TILES lists them in this order; 0, the default, on the
// other routes).  `counts` may be null (every row real).  w: [L, E, K, N]
// with layer/expert strides w_stride_l/w_stride_e (elements) and each
// [K, N] matrix contiguous; x: [E, C, K] contiguous.  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError(), -1
// for an unknown route, -3 for a tensor map the driver refuses and -4 for
// tensors the wgmma route cannot take or a tile it does not know.
extern "C" int super_gmm_launch(const void* layer_id, const void* counts,
                                const void* w, const void* x, void* out,
                                int route, int tile, int L, int E, int C,
                                int K, int N, long long w_stride_l,
                                long long w_stride_e, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* lid = reinterpret_cast<const int*>(layer_id);
  const int* cnt = reinterpret_cast<const int*>(counts);
  float* o = reinterpret_cast<float*>(out);
  if (route != ROUTE_WGMMA && tile != 0) return -4;  // tiles are wgmma's
  if (route == ROUTE_FMA) {
    dim3 grid((N + F_BN - 1) / F_BN, (C + F_BC - 1) / F_BC, E);
    super_gmm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        lid, cnt, reinterpret_cast<const float*>(w),
        reinterpret_cast<const float*>(x), o, C, K, N, w_stride_l,
        w_stride_e);
    return static_cast<int>(cudaGetLastError());
  }
  // TMA takes 16-byte-aligned bases and strides that are multiples of 16
  // bytes; the same test lets the wmma kernel copy 16 bytes at a time
  const bool aligned =
      (reinterpret_cast<size_t>(w) % 16 == 0) &&
      (reinterpret_cast<size_t>(x) % 16 == 0) && (K % 8 == 0) &&
      (N % 8 == 0) && (w_stride_l % 8 == 0) && (w_stride_e % 8 == 0);
  if (route == ROUTE_WGMMA) {
    if (!(aligned && K > 0 && E <= wg::MAX_E)) return -4;
    if (tile == 0) return wg::launch<128, 256>(WG_ARGS);
    if (tile == 1) return wg::launch<128, 128>(WG_ARGS);
    if (tile == 2) return wg::launch<64, 256>(WG_ARGS);
    if (tile == 3) return wg::launch<64, 128>(WG_ARGS);
    return -4;
  }
  if (route != ROUTE_WMMA) return -1;
  cudaError_t err =
      hopper::allow_smem<super_gmm_bf16_kernel>(H_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + H_BN - 1) / H_BN, (C + H_BC - 1) / H_BC, E);
  super_gmm_bf16_kernel<<<grid, H_THREADS, H_SMEM, s>>>(
      lid, cnt, reinterpret_cast<const bf16*>(w),
      reinterpret_cast<const bf16*>(x), o, C, K, N, w_stride_l, w_stride_e,
      aligned ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
