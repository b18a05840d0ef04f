// Token dispatch / combine for Hopper: the capacity-mode MoE layer's
// payload movement, in two forms.
//
// The TPU kernels' signatures (the port's counterparts of the JAX package's
// public kernels):
//   dispatch_scatter:  out[slot[i]] = x[token_of[i]]    for i < n
//   combine_gather:    out[i]       = yb[slot[i]]       for i < n
//
// The whole operations of the decode MoE layer, routes of the same two
// wrappers (kernels/dispatch_combine/dispatch_combine.py):
//   dispatch_whole:    idx [T, K] -> xb [E*C, d] and every index output of
//                      models/moe.py::moe_dispatch, one launch
//   combine_weighted:  out[t] = sum_{k=0..K-1} w[t,k] * yb[pair_slot[t*K+k]],
//                      one launch
//
// Replace the TPU kernels of src/repro/kernels/dispatch_combine/
// dispatch_combine.py: `dispatch_scatter` (`_scatter_kernel`, pl.pallas_call
// at line 46) and `combine_gather` (`_gather_kernel`, pl.pallas_call at line
// 75).  On the TPU each grid step is one row and the row indices arrive by
// scalar prefetch into the BlockSpec index maps, after the index arithmetic
// (a stable argsort by expert, offsets, the capacity cut) ran as XLA ops,
// and the un-permute and weighted sum ran after the gather.  Nothing is read
// back to the host here either: the indices stay device data.
//
// What bounds them on an H100: bytes, and at the decode shapes (T = 8 slots,
// K = 8, E = 128, C = 8, d = 4096 bf16) the launch itself.  The dispatch
// must write all E*C rows (8.4 MB, nearly all zeros); the combine reads the
// 64 kept rows (0.5 MB).  What the designs do about it:
//   - dispatch_whole replaces ~20 small torch launches (argsort, cumsum,
//     gathers, compares, the zero fill) with one.  Block 0 counts the pairs
//     per expert, scans the counts and gives each pair its stable rank among
//     the earlier pairs of its expert: chunk by chunk in pair order,
//     `__match_any_sync` inside a warp, per-warp counts scanned across the
//     chunk's warps in shared memory, per-expert counts carried across
//     chunks.  It writes perm, slot, valid, group_sizes and pair_slot.  The
//     other blocks each own one expert's C capacity rows over one chunk of
//     columns: each finds its expert's first C pairs in pair order with a
//     ballot scan of the ids and writes each row once, from x or as zeros.
//     No sort, no cap on N, no block waits on another, no separate zero
//     fill and no trash row.  At the decode shape the launch takes about
//     the longer of its two kinds of block, not their sum.
//   - combine_weighted gathers, weights and sums in registers: no [T*K, d]
//     intermediate, no un-permute pass, no zero row appended to yb.  One
//     warp per (token, 16-byte column block) spreads 8 tokens over ~128
//     blocks; the K row loads of a thread are issued before any is summed.
//     Each weight is rounded to the payload's type first (as
//     `weights.to(out.dtype)`), the sum is fp32 over k = 0..K-1 with
//     separately rounded products and sums (no FMA contraction, so the
//     plain PyTorch version is bitwise equal), rounded once at the end.
//
// dispatch_scatter's output is zeroed by the caller (torch.zeros, as the
// reference zeroes and aliases it).  Row rows_out - 1 is the trash row that
// dropped pairs point at; the kernel never writes it, so many dropped pairs
// cannot race on it, and the valid slots are unique, so no two blocks write
// one row.  A slot or token outside its table is skipped as well (the
// reference's scatter drops out-of-range rows); combine_gather writes zeros
// for a slot outside yb (the reference's gather fills with 0).  The copy
// kernels are dtype-agnostic: the element size is an argument.
#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// dispatch_whole: one launch.  Block 0 ranks every pair and writes the index
// outputs; every other block writes one expert's C capacity rows over one
// chunk of columns.  No block waits on another.

constexpr int WHOLE_THREADS = 256;  // also the chunk of pairs scanned at once
constexpr int WHOLE_WARPS = WHOLE_THREADS / 32;
constexpr int CAP_WINDOW = 1024;    // capacity rows a rows block fills per pass
constexpr unsigned FULL_MASK = 0xffffffffu;

// Shared memory of the rank block, in ints: counts, exclusive offsets and
// carried counts of E + 1 buckets, and one count per (warp, bucket).
// Bucket E collects expert ids outside [0, E): counted, never placed.
int rank_smem_bytes(int E) {
  return static_cast<int>(sizeof(int)) * (E + 1) * (3 + WHOLE_WARPS);
}

// The most experts whose buckets fit the 48 KB a block gets without opting
// in to more (1116); the port's configs have at most 256.  Mirrored by
// WHOLE_MAX_EXPERTS in kernels/dispatch_combine/dispatch_combine.py.
constexpr int WHOLE_MAX_EXPERTS =
    48 * 1024 / (static_cast<int>(sizeof(int)) * (3 + WHOLE_WARPS)) - 1;

// The rank block.  idx: [N] expert ids (the router's [T, K], flat).
// Writes perm, slot, valid ([N], sorted pair order), group_sizes ([E]) and
// pair_slot ([N], pair order).  Each pair's stable rank among the pairs of
// its expert comes chunk by chunk in pair order: `__match_any_sync` inside
// a warp, the warps' counts scanned per bucket in shared memory, counts
// carried across chunks.  Every phase is one pass of the block between two
// barriers, in 32-bit arithmetic (latency-bound at N = 64).
__device__ void rank_block(const int* __restrict__ idx, int N, int E, int C,
                           long long* __restrict__ perm,
                           long long* __restrict__ slot,
                           unsigned char* __restrict__ valid,
                           long long* __restrict__ group_sizes,
                           long long* __restrict__ pair_slot, int* smem) {
  const int B = E + 1;  // buckets
  int* cnt = smem;                // pairs per bucket
  int* off = cnt + B;             // exclusive offsets
  int* carry = off + B;           // pairs of each bucket in earlier chunks
  int* wcnt = carry + B;          // [WHOLE_WARPS][B]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < (3 + WHOLE_WARPS) * B; j += WHOLE_THREADS) smem[j] = 0;
  __syncthreads();
  int first = B;  // this thread's pair of the first chunk, kept for later
  for (int i = tid; i < N; i += WHOLE_THREADS) {
    int e = idx[i];
    e = (e >= 0 && e < E) ? e : E;
    if (i < WHOLE_THREADS) first = e;
    atomicAdd(&cnt[e], 1);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the counts, 32 buckets at a time
    int run = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int e = b0 + lane;
      const int v = e < B ? cnt[e] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      if (e < B) off[e] = run + incl - v;
      run += __shfl_sync(FULL_MASK, incl, 31);
    }
  } else {  // meanwhile, the group sizes
    for (int e = tid - 32; e < E; e += WHOLE_THREADS - 32)
      group_sizes[e] = cnt[e];
  }
  __syncthreads();
  for (int base = 0; base < N; base += WHOLE_THREADS) {
    const int i = base + tid;
    int e = B;  // a lane past N: a key no pair has
    if (base == 0) {
      e = first;
    } else if (i < N) {
      e = idx[i];
      e = (e >= 0 && e < E) ? e : E;
    }
    const unsigned peers = __match_any_sync(FULL_MASK, e);
    const int below = __popc(peers & ((1u << lane) - 1u));
    if (i < N && below == 0) wcnt[warp * B + e] = __popc(peers);
    __syncthreads();
    // per bucket: the pairs of earlier warps of this chunk and of earlier
    // chunks, i.e. each warp's first rank in the bucket
    for (int x = tid; x < B; x += WHOLE_THREADS) {
      int run = carry[x];
#pragma unroll
      for (int w = 0; w < WHOLE_WARPS; ++w) {
        const int c = wcnt[w * B + x];
        wcnt[w * B + x] = run;
        run += c;
      }
      carry[x] = run;
    }
    __syncthreads();
    if (i < N) {
      const int pos = wcnt[warp * B + e] + below;  // stable rank in bucket
      const int j = off[e] + pos;                  // place in the sort
      const bool ok = e < E && pos < C;
      const int s = ok ? e * C + pos : E * C;
      perm[j] = i;
      slot[j] = s;
      valid[j] = ok;
      pair_slot[i] = s;
    }
    if (base + WHOLE_THREADS < N) {  // another chunk: clear the warp counts
      __syncthreads();
      for (int j = tid; j < WHOLE_WARPS * B; j += WHOLE_THREADS) wcnt[j] = 0;
      __syncthreads();
    }
  }
}

// A rows block: capacity rows e*C .. e*C + C - 1, column unit u of each
// (this thread's).  Capacity row c of expert e holds the c-th pair routed to
// e in pair order, if there is one: the block finds them itself, a window
// of CAP_WINDOW rows at a time, by a ballot scan of the ids that resumes
// where the last window stopped (O(N) per block; the grid grows with E and
// d, not with N).  Then it writes every row of the window once: x[token]
// or zeros.
template <typename U>
__device__ void rows_block(const int* __restrict__ idx,
                           const U* __restrict__ x, U* __restrict__ xb, int N,
                           int K, int C, int e, long long u,
                           long long row_units, long long x_stride,
                           int* smem) {
  int* tok = smem;                 // [CAP_WINDOW] source token of each row
  int* wsum = smem + CAP_WINDOW;   // [WHOLE_WARPS] matches per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int pos = 0, seen = 0;  // the next chunk of pairs; matches before it
  for (int c0 = 0; c0 < C; c0 += CAP_WINDOW) {
    const int cw = min(CAP_WINDOW, C - c0);
    int reached = seen;  // matches up to the end of the last chunk scanned
    while (pos < N && seen < c0 + cw) {
      const int i = pos + tid;
      const bool hit = i < N && idx[i] == e;
      const unsigned m = __ballot_sync(FULL_MASK, hit);
      if (lane == 0) wsum[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WHOLE_WARPS; ++w) {
        const int c = wsum[w];
        before += w < warp ? c : 0;
        total += c;
      }
      const int rank = seen + before + __popc(m & ((1u << lane) - 1u));
      if (hit && rank >= c0 && rank < c0 + cw) tok[rank - c0] = i / K;
      __syncthreads();  // wsum is rewritten by the next chunk
      reached = seen + total;
      if (reached > c0 + cw) break;  // the rest of this chunk: next window
      seen = reached;
      pos += WHOLE_THREADS;
    }
    const int filled = min(max(reached - c0, 0), cw);
    if (u < row_units) {
      U* dst = xb + (static_cast<long long>(e) * C + c0) * row_units + u;
      for (int c = 0; c < cw; c += 4) {  // four rows' loads in flight
        U v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = c + j < filled ? x[tok[c + j] * x_stride + u] : U{};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < cw) dst[(c + j) * row_units] = v[j];
      }
    }
    __syncthreads();  // tok is rewritten by the next window
  }
}

// Block 0: rank_block; block 1 + e * chunks + k: rows_block of expert e,
// column units k * WHOLE_THREADS + threadIdx.x.
template <typename U>
__global__ void __launch_bounds__(WHOLE_THREADS)
dispatch_whole_kernel(const int* __restrict__ idx, const U* __restrict__ x,
                      U* __restrict__ xb, int N, int K, int E, int C,
                      long long row_units, long long x_stride, int chunks,
                      long long* __restrict__ perm,
                      long long* __restrict__ slot,
                      unsigned char* __restrict__ valid,
                      long long* __restrict__ group_sizes,
                      long long* __restrict__ pair_slot) {
  extern __shared__ int smem[];
  if (blockIdx.x == 0) {
    rank_block(idx, N, E, C, perm, slot, valid, group_sizes, pair_slot, smem);
    return;
  }
  const int b = blockIdx.x - 1;
  const int e = b / chunks;
  const long long u =
      static_cast<long long>(b - e * chunks) * WHOLE_THREADS + threadIdx.x;
  rows_block<U>(idx, x, xb, N, K, C, e, u, row_units, x_stride, smem);
}

template <typename U>
int launch_whole(const int* idx, const void* x, void* xb, int N, int K,
                 int E, int C, long long row_units, long long x_stride,
                 long long* meta, unsigned char* valid, cudaStream_t s) {
  const long long chunks = (row_units + WHOLE_THREADS - 1) / WHOLE_THREADS;
  const long long blocks = 1 + E * chunks;
  if (blocks > 0x7fffffffLL) return -2;
  const int rows_smem =
      static_cast<int>(sizeof(int)) * (CAP_WINDOW + WHOLE_WARPS);
  const int smem = rank_smem_bytes(E) > rows_smem ? rank_smem_bytes(E)
                                                  : rows_smem;
  dispatch_whole_kernel<U><<<static_cast<unsigned>(blocks), WHOLE_THREADS,
                             smem, s>>>(
      idx, reinterpret_cast<const U*>(x), reinterpret_cast<U*>(xb), N, K, E,
      C, row_units, x_stride, static_cast<int>(chunks), meta, meta + N,
      valid, meta + 3LL * N, meta + 2LL * N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// combine_weighted: one launch.

constexpr int COMBINE_THREADS = 32;
constexpr int COMBINE_INFLIGHT = 8;  // row loads issued before any is summed
constexpr int MAX_GRID_Y = 65535;

struct Bf16 {
  using raw = uint16_t;
  static __device__ __forceinline__ float load(raw b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ raw store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F32 {
  using raw = float;
  static __device__ __forceinline__ float load(raw f) { return f; }
  static __device__ __forceinline__ raw store(float f) { return f; }
};

template <typename R, int V>
struct alignas(sizeof(R) * V) Pack {
  R x[V];
};

// out[t] = sum_k round(w[t, k]) * yb[pair_slot[t*K + k]], the sum in fp32
// over k in order; a pair_slot outside [0, rows) adds nothing.  V elements
// per load; `vecs` loads per row (d = V * vecs).
template <typename Ty, int V>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_weighted_kernel(const long long* __restrict__ pair_slot,
                        const float* __restrict__ w,
                        const typename Ty::raw* __restrict__ yb,
                        typename Ty::raw* __restrict__ out, int T, int K,
                        long long rows, int vecs) {
  using P = Pack<typename Ty::raw, V>;
  const int u = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (u >= vecs) return;
  const P* src = reinterpret_cast<const P*>(yb);
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const long long* ps = pair_slot + static_cast<long long>(t) * K;
    const float* wt = w + static_cast<long long>(t) * K;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += COMBINE_INFLIGHT) {
      P v[COMBINE_INFLIGHT];
      float wk[COMBINE_INFLIGHT];
      bool ok[COMBINE_INFLIGHT];
#pragma unroll
      for (int j = 0; j < COMBINE_INFLIGHT; ++j) {
        const int k = k0 + j;
        const long long s = k < K ? ps[k] : -1;
        ok[j] = s >= 0 && s < rows;
        // the weight in the payload's type, as weights.to(out.dtype)
        wk[j] = ok[j] ? Ty::load(Ty::store(wt[k])) : 0.f;
        if (ok[j]) v[j] = src[s * vecs + u];
      }
#pragma unroll
      for (int j = 0; j < COMBINE_INFLIGHT; ++j) {
        if (!ok[j]) continue;
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(wk[j], Ty::load(v[j].x[i])));
      }
    }
    P o;
#pragma unroll
    for (int i = 0; i < V; ++i) o.x[i] = Ty::store(acc[i]);
    reinterpret_cast<P*>(out)[static_cast<long long>(t) * vecs + u] = o;
  }
}

template <typename Ty, int V>
void launch_combine(const void* pair_slot, const void* w, const void* yb,
                    void* out, int T, int K, long long rows, int vecs,
                    cudaStream_t s) {
  const dim3 grid((vecs + COMBINE_THREADS - 1) / COMBINE_THREADS,
                  T < MAX_GRID_Y ? T : MAX_GRID_Y);
  combine_weighted_kernel<Ty, V><<<grid, COMBINE_THREADS, 0, s>>>(
      reinterpret_cast<const long long*>(pair_slot),
      reinterpret_cast<const float*>(w),
      reinterpret_cast<const typename Ty::raw*>(yb),
      reinterpret_cast<typename Ty::raw*>(out), T, K, rows, vecs);
}



// ---------------------------------------------------------------------------
// combine_weighted_bwd: the gradient of combine_weighted, one launch.
//
//   dyb[pair_slot[t*K+k]] = w[t, k] * dout[t]   (w rounded to yb's type, as
//                                                the forward rounds it; the
//                                                product rounded once)
//   dw[t, k] = sum_d yb[pair_slot[t*K+k], d] * dout[t, d]   (fp32)
//
// Each row of yb is hit by at most one pair (the dispatch gives each kept
// pair its own capacity row), so no two writes meet and nothing is atomic.
// Two kinds of block: a rows block owns BWD_ROWS rows of dyb and finds the
// pairs that land in them by a scan of pair_slot (a row no pair hits is
// written as zeros: no separate fill); a dw block gives one warp to each
// pair, its dot product summed lane by lane in a fixed order and then
// across the warp by xor shuffles, so two runs give the same bits.  A
// dropped pair (pair_slot outside yb) gets dw 0.  Bytes bound it: dout and
// the kept rows of yb read, dyb written once.

constexpr int BWD_THREADS = 256;
constexpr int BWD_ROWS = 128;  // dyb rows per rows block

template <typename Ty, int V>
__global__ void __launch_bounds__(BWD_THREADS)
combine_weighted_bwd_kernel(const long long* __restrict__ pair_slot,
                            const float* __restrict__ w,
                            const typename Ty::raw* __restrict__ yb,
                            const typename Ty::raw* __restrict__ dout,
                            typename Ty::raw* __restrict__ dyb,
                            float* __restrict__ dw, int T, int K,
                            long long rows, int vecs, int row_blocks) {
  using P = Pack<typename Ty::raw, V>;
  const long long N = static_cast<long long>(T) * K;
  const P* y = reinterpret_cast<const P*>(yb);
  const P* g = reinterpret_cast<const P*>(dout);
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    __shared__ long long src[BWD_ROWS];  // the pair landing in each row
    const long long r0 = static_cast<long long>(blockIdx.x) * BWD_ROWS;
    for (int j = threadIdx.x; j < BWD_ROWS; j += BWD_THREADS) src[j] = -1;
    __syncthreads();
    for (long long i = threadIdx.x; i < N; i += BWD_THREADS) {
      const long long s = pair_slot[i];
      if (s >= r0 && s < r0 + BWD_ROWS && s < rows) src[s - r0] = i;
    }
    __syncthreads();
    P* out = reinterpret_cast<P*>(dyb);
    for (int rr = 0; rr < BWD_ROWS && r0 + rr < rows; ++rr) {
      const long long i = src[rr];
      // the weight in the payload's type, as the forward rounds it
      const float wk = i >= 0 ? Ty::load(Ty::store(w[i])) : 0.f;
      const long long t = i >= 0 ? i / K : 0;
      for (int u = threadIdx.x; u < vecs; u += BWD_THREADS) {
        P o;
        if (i >= 0) {
          const P gv = g[t * vecs + u];
#pragma unroll
          for (int e = 0; e < V; ++e)
            o.x[e] = Ty::store(__fmul_rn(wk, Ty::load(gv.x[e])));
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) o.x[e] = Ty::store(0.f);
        }
        out[(r0 + rr) * vecs + u] = o;
      }
    }
    return;
  }
  const long long i =
      static_cast<long long>(blockIdx.x - row_blocks) * (BWD_THREADS / 32) +
      threadIdx.x / 32;
  if (i >= N) return;
  const int lane = threadIdx.x % 32;
  const long long s = pair_slot[i];
  float acc = 0.f;
  if (s >= 0 && s < rows) {
    const long long t = i / K;
    for (int u = lane; u < vecs; u += 32) {
      const P a = y[s * vecs + u], b = g[t * vecs + u];
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc = fmaf(Ty::load(a.x[e]), Ty::load(b.x[e]), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(FULL_MASK, acc, off);
  if (lane == 0) dw[i] = acc;
}

template <typename Ty, int V>
int launch_combine_bwd(const void* pair_slot, const void* w, const void* yb,
                       const void* dout, void* dyb, void* dw, int T, int K,
                       long long rows, int vecs, cudaStream_t s) {
  const long long row_blocks = (rows + BWD_ROWS - 1) / BWD_ROWS;
  const long long dw_blocks =
      (static_cast<long long>(T) * K + BWD_THREADS / 32 - 1) /
      (BWD_THREADS / 32);
  if (row_blocks + dw_blocks > 0x7fffffffLL) return -2;
  combine_weighted_bwd_kernel<Ty, V><<<
      static_cast<unsigned>(row_blocks + dw_blocks), BWD_THREADS, 0, s>>>(
      reinterpret_cast<const long long*>(pair_slot),
      reinterpret_cast<const float*>(w),
      reinterpret_cast<const typename Ty::raw*>(yb),
      reinterpret_cast<const typename Ty::raw*>(dout),
      reinterpret_cast<typename Ty::raw*>(dyb), reinterpret_cast<float*>(dw),
      T, K, rows, vecs, static_cast<int>(row_blocks));
  return static_cast<int>(cudaGetLastError());
}

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

// idx: [N] int32, N = T*K; x: [T, d], row stride x_stride elements;
// xb: [E*C, d]; meta: [3N + E] int64 = perm | slot | pair_slot |
// group_sizes; valid: [N] bool.  One launch on `stream`.  Returns a
// cudaError_t, or -1 for an element size, -2 for an expert count or
// capacity it does not take.
extern "C" int dispatch_whole_launch(const void* idx, const void* x, void* xb,
                                     void* meta, void* valid, int N, int K,
                                     int E, int C, int d, long long x_stride,
                                     int elem_size, void* stream) {
  if (elem_size != 2 && elem_size != 4) return -1;
  if (E < 1 || E > WHOLE_MAX_EXPERTS || C < 1 || K < 1 || d < 1 ||
      static_cast<long long>(E) * C > 0x7fffffff)
    return -2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* id = reinterpret_cast<const int*>(idx);
  long long* m = reinterpret_cast<long long*>(meta);
  unsigned char* v = reinterpret_cast<unsigned char*>(valid);
  const long long row_bytes = static_cast<long long>(d) * elem_size;
  const long long stride_bytes = x_stride * elem_size;
  // the widest unit dividing the row and x's row stride, both bases aligned
  int u = unit_bytes(row_bytes, elem_size, x, xb);
  while (u > elem_size && stride_bytes % u != 0) u /= 2;
  const long long units = row_bytes / u, stride = stride_bytes / u;
  switch (u) {
    case 16: return launch_whole<uint4>(id, x, xb, N, K, E, C, units, stride,
                                        m, v, s);
    case 8: return launch_whole<uint2>(id, x, xb, N, K, E, C, units, stride,
                                       m, v, s);
    case 4: return launch_whole<uint32_t>(id, x, xb, N, K, E, C, units,
                                          stride, m, v, s);
    default: return launch_whole<uint16_t>(id, x, xb, N, K, E, C, units,
                                           stride, m, v, s);
  }
}

// pair_slot: [T*K] int64; w: [T, K] fp32; yb: [rows, d]; out: [T, d], yb's
// type.  elem_size: 2 (bf16) or 4 (fp32).  Returns a cudaError_t, or -1 for
// an element size it does not take.
extern "C" int combine_weighted_launch(const void* pair_slot, const void* w,
                                       const void* yb, void* out, int T,
                                       int K, long long rows, int d,
                                       int elem_size, void* stream) {
  if (elem_size != 2 && elem_size != 4) return -1;
  if (T <= 0 || d <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(d) * elem_size;
  const bool wide = unit_bytes(row_bytes, elem_size, yb, out) == 16;
  if (elem_size == 2) {
    if (wide)
      launch_combine<Bf16, 8>(pair_slot, w, yb, out, T, K, rows, d / 8, s);
    else
      launch_combine<Bf16, 1>(pair_slot, w, yb, out, T, K, rows, d, s);
  } else {
    if (wide)
      launch_combine<F32, 4>(pair_slot, w, yb, out, T, K, rows, d / 4, s);
    else
      launch_combine<F32, 1>(pair_slot, w, yb, out, T, K, rows, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient of combine_weighted_launch: pair_slot [T*K] int64; w [T, K]
// fp32; yb [rows, d]; dout [T, d] (yb's type) -> dyb [rows, d] (yb's type,
// every row written, zeros where no pair lands) and dw [T, K] fp32.
// elem_size: 2 (bf16) or 4 (fp32).  One launch on `stream`.  Returns a
// cudaError_t, -1 for an element size it does not take, -2 for a grid too
// large.
extern "C" int combine_weighted_bwd_launch(const void* pair_slot,
                                           const void* w, const void* yb,
                                           const void* dout, void* dyb,
                                           void* dw, int T, int K,
                                           long long rows, int d,
                                           int elem_size, void* stream) {
  if (elem_size != 2 && elem_size != 4) return -1;
  if (d <= 0 || (rows <= 0 && T <= 0)) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(d) * elem_size;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(yb) |
                         reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(dyb);
  const bool wide = row_bytes % 16 == 0 && addr % 16 == 0;
  if (elem_size == 2)
    return wide ? launch_combine_bwd<Bf16, 8>(pair_slot, w, yb, dout, dyb,
                                              dw, T, K, rows, d / 8, s)
                : launch_combine_bwd<Bf16, 1>(pair_slot, w, yb, dout, dyb,
                                              dw, T, K, rows, d, s);
  return wide ? launch_combine_bwd<F32, 4>(pair_slot, w, yb, dout, dyb, dw, T,
                                           K, rows, d / 4, s)
              : launch_combine_bwd<F32, 1>(pair_slot, w, yb, dout, dyb, dw, T,
                                           K, rows, d, s);
}
