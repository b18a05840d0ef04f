// Blocked online-softmax attention for Hopper (prefill hot spot).
//
//   o = softmax(q k^T / sqrt(dh) [softcap] + mask) v
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py::flash_attention (`_kernel`, pl.pallas_call at line 97).
// Same function: causal and sliding-window masks (kpos > qpos - window),
// optional softcap (tanh(s / cap) * cap), fp32 running (m, l, acc), final
// acc / max(l, 1e-30), key tiles wholly outside the causal/window frontier
// never visited.  A masked score contributes exactly zero (the kernels keep
// it at -inf and take exp2 against a finite row max), which agrees with
// the reference's NEG_INF = -1e30 on every row that has a visible key.
//
// Head dims and routes (flash_attention_launch below; the wrapper's `route`
// and `HEAD_DIMS` in kernels/flash_attention/flash_attention.py pick them,
// and a test reads the instantiations out of this file):
//
//   route   dtype  head dims              kernel
//   wgmma   bf16   64, 128 (TMA-able)     flash_wgmma_kernel<DH>
//           bf16   192, 256 (TMA-able)    flash_wgmma_wide_kernel<DH>
//   wmma    bf16   32, 64, 128, 192, 256  flash_attention_kernel<bf16, DH,
//                                         64, 64>
//   fma     fp32   32, 64, 128, 192, 256  flash_attention_kernel<float, DH,
//                                         32, 32>
//
// The wmma route takes bf16 at head dim 32 and every bf16 tensor TMA cannot
// describe.  Any other head dim is refused (-2).  The backward (below
// `bwd`) takes the same routes at the same head dims.
//
// What bounds it on an H100: 4 * B * H * S^2 * dh / 2 operations (causal)
// against B * (2 H + 2 KVH) * S * dh elements moved.  At the serving shapes
// (qwen3: H=64, KVH=4, dh=128, S=256..2048) that is 20-150 operations per
// byte read from L2-resident K/V and far above the card's 295 per HBM byte:
// the tensor cores are the bound, so what counts is keeping them fed.
//
// bf16, head dim 64 or 128 (`flash_wgmma_kernel`, the main path): one block
// per (batch*head, 128-query tile), heaviest query tiles first; three
// warpgroups.  Warpgroup 2 is the producer: one thread loads Q once and then
// streams K and V tiles by TMA into a two-stage ring, each tile completing on
// its own mbarrier, so the next tile lands while the current one is being
// multiplied.  The K/V tensor maps are 4-D over [B, S, KVH, dh] with the
// tensors' real strides, so the batch, the KV head h / (H / KVH) (GQA, never
// expanded) and the key offset are TMA coordinates and the model layout needs
// no transpose.  Warpgroups 0 and 1 each own 64 query rows and keep every
// intermediate in registers: S = Q K^T by wgmma from swizzled shared memory
// into the accumulator registers; the online softmax on those registers (row
// max and sum over the four threads that share a row, ex2.approx with
// sm_scale * log2(e) folded into one multiply-add); P converted to bf16 in
// registers is the register A operand of O += P V (V the MN-major shared B
// operand); O is rescaled in registers.  Masks are applied only on the tiles
// where they bite (the causal diagonal, the window edge, the ragged end of
// S).  setmaxnreg moves registers from the producer warpgroup (24) to the
// consumers (240).
//
// bf16, head dim 192 or 256 (`flash_wgmma_wide_kernel`: deepseek_v32's
// and gemma3's heads): the same walk and the same register-resident
// softmax, retiled for an O accumulator of 96 or 128 fp32 registers a
// thread.  Keys come in tiles of 64, so S is 32 registers and P 16: 144 /
// 176 registers of fragments at head dim 192 / 256, where 128-key tiles
// would need 224 at 256.  Two warpgroups only, with thread 0 issuing the
// TMA ring between its warpgroup's products: a third (producer) warpgroup
// caps every thread at 168 registers, which these consumers exceed;
// with two each thread may hold 255 (ptxas: 211 at 192, 229 at 256, no
// spill).  Q (128 rows) is loaded once, K and V stream through a ring of
// 64-key stages (three at 192, two at 256: 197,712 / 197,688 bytes of
// shared memory, static_asserted).  O += P V runs as m64n128 plus m64n64
// (192) or two m64n128 (256) register-A products over the 64-column
// chunks of V.  A warpgroup skips the products of a key tile none of its
// 64 rows can see (the causal diagonal's far half, the window's near
// edge, rows past S) but still takes part in the ring.  At 64 keys S =
// Q K^T reads 1/16 byte of shared memory per multiply-add (Q re-read for
// every product), the SM's whole shared-memory rate at the tensor cores'
// peak: with the ring's TMA writes beside it, shared memory as much as
// the tensor cores bounds this kernel.
//
// `flash_attention_kernel` serves the other two routes: a bf16 tensor that
// TMA cannot describe (a base not 16-byte aligned, a stride not a multiple
// of 16 bytes) or at head dim 32 runs its wmma products, whose scores
// and fp32 accumulator live in shared memory; fp32 runs its plain FMA loops
// (correctness only).  Its shared memory (`Layout`) is, in bytes: bf16 64x64
// tiles at DH 128 / 192 / 256: 112,896 / 153,856 / 194,816; fp32 32x32
// tiles at DH 192 / 256: 107,392 / 140,160 -- all above the 48 KB default,
// so each instantiation asks for its size (`hopper::allow_smem`), and all
// under the 232,448 a block may have (static_asserts below).  A sequence
// length that is not a multiple of the tile is masked, not rounded to a
// divisor, on every route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;  // threads per block (4 warps)

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int T_ = 1, F_ = 1; };
template <> struct Pad<bf16> { static constexpr int T_ = 8, F_ = 4; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <typename T, int DH, int BQ, int BKV> struct Layout {
  static constexpr int LDQ = DH + Pad<T>::T_;   // q, k, v tiles (T)
  static constexpr int LDP = BKV + Pad<T>::T_;  // probabilities (T)
  static constexpr int LDS = BKV + Pad<T>::F_;  // scores (fp32)
  static constexpr int LDO = DH + Pad<T>::F_;   // output accumulator (fp32)
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_K = OFF_Q + align128(sizeof(T) * BQ * LDQ);
  static constexpr size_t OFF_V = OFF_K + align128(sizeof(T) * BKV * LDQ);
  static constexpr size_t OFF_S = OFF_V + align128(sizeof(T) * BKV * LDQ);
  static constexpr size_t OFF_P = OFF_S + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t OFF_O = OFF_P + align128(sizeof(T) * BQ * LDP);
  static constexpr size_t OFF_L = OFF_O + align128(sizeof(float) * BQ * LDO);
  static constexpr size_t BYTES = OFF_L + align128(sizeof(float) * BQ);
};

// the largest instantiations (see the header) fit a block's shared memory
constexpr size_t MAX_SMEM = 232448;
static_assert(Layout<bf16, 192, 64, 64>::BYTES == 153856, "layout");
static_assert(Layout<bf16, 256, 64, 64>::BYTES == 194816, "layout");
static_assert(Layout<float, 192, 32, 32>::BYTES == 107392, "layout");
static_assert(Layout<float, 256, 32, 32>::BYTES == 140160, "layout");
static_assert(Layout<bf16, 256, 64, 64>::BYTES <= MAX_SMEM &&
                  Layout<float, 256, 32, 32>::BYTES <= MAX_SMEM,
              "shared memory");

struct Strides {
  long long b, s, h;  // elements; the last (dh) axis is contiguous
};

// One [ROWS, DH] tile of a [B, S, H, dh]-strided tensor into shared memory,
// rows at or beyond S zero-filled.
template <typename T, int DH, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int S, long long stride_s,
                                          bool vec_ok) {
  constexpr bool kVec = sizeof(T) == 2;  // bf16 rows are 16-byte aligned
  if (kVec && vec_ok) {
    constexpr int CH = DH / 8;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
      const int r = idx / CH, ch = idx % CH;
      const int pos = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (pos < S)
        v = *reinterpret_cast<const uint4*>(src + pos * stride_s + ch * 8);
      *reinterpret_cast<uint4*>(dst + r * LD + ch * 8) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH;
      const int pos = row0 + r;
      dst[r * LD + d] = pos < S ? src[pos * stride_s + d] : from_f<T>(0.f);
    }
  }
}

template <typename T, int DH, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int KVH, int S,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, int window, float softcap, float sm_scale,
                       int vec_ok) {
  using L = Layout<T, DH, BQ, BKV>;
  constexpr int LDQ = L::LDQ, LDP = L::LDP, LDS = L::LDS, LDO = L::LDO;
  constexpr int TPR = NT / BQ;  // threads that share one query row
  constexpr int CPT = BKV / TPR;  // score columns per thread
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "TPR");
  static_assert(BKV % TPR == 0 && DH % 16 == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::OFF_Q);
  T* Ks = reinterpret_cast<T*>(smem + L::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + L::OFF_V);
  float* Ss = reinterpret_cast<float*>(smem + L::OFF_S);
  T* Ps = reinterpret_cast<T*>(smem + L::OFF_P);
  float* Os = reinterpret_cast<float*>(smem + L::OFF_O);
  float* Ls = reinterpret_cast<float*>(smem + L::OFF_L);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);  // GQA: the KV head this query head reads
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;
  T* op = o + b * so.b + h * so.h;
  const bool vec = vec_ok != 0;

  load_tile<T, DH, BQ, LDQ>(Qs, qp, q0, S, sq.s, vec);
  for (int idx = tid; idx < BQ * LDO; idx += NT) Os[idx] = 0.f;

  // softmax ownership: thread (r, sub) keeps row r's running (m, l)
  const int r = tid / TPR, sub = tid % TPR;
  const int qpos = q0 + r;
  float m_run = NEG_INF, l_run = 0.f;

  // key tiles inside the causal / window frontier of this query tile
  int kv_hi = S;
  if (causal) kv_hi = min(S, q0 + BQ);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_lo = kv_lo / BKV, t_hi = (kv_hi + BKV - 1) / BKV;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's products are done with Ks/Vs/Ps
    load_tile<T, DH, BKV, LDQ>(Ks, kp, k0, S, sk.s, vec);
    load_tile<T, DH, BKV, LDQ>(Vs, vp, k0, S, sv.s, vec);
    __syncthreads();

    // ---- scores = Q K^T (fp32) ----------------------------------------
    if constexpr (sizeof(T) == 2) {
      using namespace nvcuda;
      static_assert(sizeof(T) != 2 || BQ == 16 * (NT / 32), "16 rows/warp");
      const int warp = tid / 32;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(
            a, reinterpret_cast<const bf16*>(Qs) + warp * 16 * LDQ + kk, LDQ);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              bt;  // K tile row-major == K^T column-major
          wmma::load_matrix_sync(
              bt, reinterpret_cast<const bf16*>(Ks) + j * 16 * LDQ + kk, LDQ);
          wmma::mma_sync(sacc[j], a, bt, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + j * 16, sacc[j], LDS,
                                wmma::mem_row_major);
    } else {
      for (int idx = tid; idx < BQ * BKV; idx += NT) {
        const int rr = idx / BKV, c = idx % BKV;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d)
          s = fmaf(to_f(Qs[rr * LDQ + d]), to_f(Ks[c * LDQ + d]), s);
        Ss[rr * LDS + c] = s;
      }
    }
    __syncthreads();

    // ---- online softmax update of row r --------------------------------
    {
      float sv_[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = sub + i * TPR;
        const int kpos = k0 + c;
        float s = Ss[r * LDS + c] * sm_scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s = ok ? s : NEG_INF;
        sv_[i] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = sub + i * TPR;
        // a masked score contributes nothing, also while the whole row is
        // still masked (m_new == NEG_INF)
        const float p = sv_[i] > 0.5f * NEG_INF ? expf(sv_[i] - m_new) : 0.f;
        Ps[r * LDP + c] = from_f<T>(p);
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      for (int d = sub; d < DH; d += TPR) Os[r * LDO + d] *= corr;
    }
    __syncthreads();

    // ---- acc += P V ------------------------------------------------------
    if constexpr (sizeof(T) == 2) {
      using namespace nvcuda;
      const int warp = tid / 32;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          pa[BKV / 16];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wmma::load_matrix_sync(
            pa[kk],
            reinterpret_cast<const bf16*>(Ps) + warp * 16 * LDP + kk * 16,
            LDP);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        float* optr = Os + warp * 16 * LDO + n * 16;
        wmma::load_matrix_sync(oacc, optr, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              vb;
          wmma::load_matrix_sync(
              vb,
              reinterpret_cast<const bf16*>(Vs) + kk * 16 * LDQ + n * 16,
              LDQ);
          wmma::mma_sync(oacc, pa[kk], vb, oacc);
        }
        wmma::store_matrix_sync(optr, oacc, LDO, wmma::mem_row_major);
      }
    } else {
      for (int idx = tid; idx < BQ * DH; idx += NT) {
        const int rr = idx / DH, d = idx % DH;
        float acc = Os[rr * LDO + d];
#pragma unroll 8
        for (int c = 0; c < BKV; ++c)
          acc = fmaf(to_f(Ps[rr * LDP + c]), to_f(Vs[c * LDQ + d]), acc);
        Os[rr * LDO + d] = acc;
      }
    }
  }

  if (sub == 0) Ls[r] = l_run;
  // the row's log-sum-exp in the scaled (and capped) score's units, for the
  // backward: p = exp(s - lse)
  if (lse != nullptr && sub == 0 && qpos < S)
    lse[static_cast<long long>(bh) * S + qpos] =
        m_run + logf(fmaxf(l_run, 1e-30f));
  __syncthreads();
  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int rr = idx / DH, d = idx % DH;
    const int pos = q0 + rr;
    if (pos < S)
      op[pos * so.s + d] =
          from_f<T>(Os[rr * LDO + d] / fmaxf(Ls[rr], 1e-30f));
  }
}

template <typename T, int DH, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KVH, int S, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, int window, float softcap, float sm_scale,
           int vec_ok, cudaStream_t stream) {
  constexpr auto kern = flash_attention_kernel<T, DH, BQ, BKV>;
  constexpr int bytes = static_cast<int>(Layout<T, DH, BQ, BKV>::BYTES);
  cudaError_t err = hopper::allow_smem<kern>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, bytes, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), reinterpret_cast<T*>(o), lse, H, KVH, S,
      sq, sk, sv, so, causal, window, softcap, sm_scale, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- bf16 on wgmma + TMA (sm_90a) --
namespace wg {

constexpr int BQ = 128;       // query rows per block: two warpgroups of 64
constexpr int BKV = 128;      // keys per tile
constexpr int STAGES = 2;     // depth of the K/V ring
constexpr int THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr float LOG2E = 1.4426950408889634f;

template <int DH> struct Smem {
  static constexpr int CH = DH / 64;          // 64-column chunks of a row
  static constexpr int Q_CHUNK = BQ * 128;    // bytes of one chunk of Q
  static constexpr int KV_CHUNK = BKV * 128;  // ... of K or V
  static constexpr int KV_TILE = CH * KV_CHUNK;
  static constexpr int OFF_K = CH * Q_CHUNK;  // Q | K ring | V ring | bars
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_TILE;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Accumulator layout of wgmma m64nN (fp32): thread (warp w, lane l) of the
// warpgroup holds rows 16w + l/4 and 16w + l/4 + 8; element i sits in row
// half (i >> 1) & 1 and column 8 (i >> 2) + 2 (l & 3) + (i & 1).  The
// layout of S over 16 keys is the register A layout of P for P V, so P
// passes from the accumulators to the next product with a pack, no shuffle.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, float* __restrict__ lse, Strides so,
                   int H, int KVH, int S, int causal, int window,
                   float softcap, float sm_scale) {
  using L = Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);  // GQA: the KV head this query head reads
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  // key tiles inside the causal / window frontier of this query tile
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BKV;
  const int n_tiles = (kv_hi + BKV - 1) / BKV - t_lo;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {  // ---------------------------------------- producer --
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(q_full, L::CH * L::Q_CHUNK);
      for (int c = 0; c < L::CH; ++c)
        hopper::tma_load_4d(smem + c * L::Q_CHUNK, &tq, q_full, 64 * c, q0, h,
                            b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        const int k0 = (t_lo + i) * BKV;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        unsigned char* ks = smem + L::OFF_K + s * L::KV_TILE;
        unsigned char* vs = smem + L::OFF_V + s * L::KV_TILE;
        hopper::mbar_expect_tx(&k_full[s], L::KV_TILE);
        for (int c = 0; c < L::CH; ++c)
          hopper::tma_load_4d(ks + c * L::KV_CHUNK, &tk, &k_full[s], 64 * c,
                              k0, hk, b);
        hopper::mbar_expect_tx(&v_full[s], L::KV_TILE);
        for (int c = 0; c < L::CH; ++c)
          hopper::tma_load_4d(vs + c * L::KV_CHUNK, &tv, &v_full[s], 64 * c,
                              k0, hk, b);
      }
    }
  } else {  // --------------------------------------------- consumers --
    hopper::regs_alloc<240>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qw = q0 + 64 * wgi;                // first row of this warpgroup
    const int qa = qw + (tid / 32) * 16 + lane / 4;  // rows qa, qa + 8
    const float c2 = sm_scale * LOG2E;
    const float cap_in = softcap > 0.f ? sm_scale / softcap : 0.f;
    const float cap_out = softcap > 0.f ? softcap / sm_scale : 0.f;
    const unsigned char* qs = smem + wgi * 64 * 128;

    float sacc[BKV / 2], oacc[DH / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = (t_lo + i) * BKV;
      const unsigned char* ks = smem + L::OFF_K + s * L::KV_TILE;
      const unsigned char* vs = smem + L::OFF_V + s * L::KV_TILE;

      // ---- S = Q K^T into registers ------------------------------------
      hopper::mbar_wait(&k_full[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(
            qs + (kk / 4) * L::Q_CHUNK + (kk % 4) * 32, 16, 1024);
        const uint64_t db = hopper::desc_sw128(
            ks + (kk / 4) * L::KV_CHUNK + (kk % 4) * 32, 16, 1024);
        hopper::wgmma_ss_n128<0>(sacc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);

      // ---- online softmax on the registers -----------------------------
      if (softcap > 0.f) {  // kept in raw units: c2 applies the scale
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j)
          sacc[j] = tanhf(sacc[j] * cap_in) * cap_out;
      }
      const bool edge = k0 + BKV > S;
      const bool diag = causal && k0 + BKV - 1 > qw;
      const bool wedge = window > 0 && k0 <= qw + 63 - window;
      if (edge || diag || wedge) {  // only tiles where a mask bites
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          const int qpos = qa + 8 * ((j >> 1) & 1);
          bool ok = kpos < S;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) sacc[j] = -INFINITY;
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sacc[j]);
      float bias[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no visible key so far keeps p = 0 (exp2(-inf))
        bias[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c2;
        corr[r] = ex2(m_run[r] * c2 - bias[r]);
        m_run[r] = mx[r];
      }
      uint32_t pa[BKV / 16][4];  // P in bf16: the A operand of P V
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e0 = 8 * kk + 2 * j, r = j & 1;
          const float p0 = ex2(fmaf(sacc[e0], c2, -bias[r]));
          const float p1 = ex2(fmaf(sacc[e0 + 1], c2, -bias[r]));
          rs[r] += p0 + p1;
          pa[kk][j] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) oacc[j] *= corr[(j >> 1) & 1];

      // ---- O += P V ------------------------------------------------------
      hopper::mbar_wait(&v_full[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db =
            hopper::desc_sw128(vs + kk * 16 * 128, L::KV_CHUNK, 1024);
        if constexpr (DH == 128)
          hopper::wgmma_rs_n128(oacc, pa[kk], db, 1);
        else
          hopper::wgmma_rs_n64(oacc, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // K/V stage is free
    }

    // ---- o = acc / l, rows beyond S not stored -------------------------
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
      // the row's log-sum-exp in natural units of the scaled score (m_run
      // is in raw units: sm_scale brings it there), for the backward
      const int qpos = qa + 8 * r;
      if (lse != nullptr && (lane & 3) == 0 && qpos < S)
        lse[static_cast<long long>(bh) * S + qpos] =
            m_run[r] * sm_scale + logf(fmaxf(l, 1e-30f));
    }
    bf16* op = o + b * so.b + h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qa + 8 * r;
      if (qpos >= S) continue;
      bf16* row = op + qpos * so.s + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv[r],
                                  oacc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// ------------------------------ head dims 192 and 256 (the wide heads) --
//
// The same block (128 queries of one batch*head, heaviest first), the same
// frontier and the same register-resident softmax as flash_wgmma_kernel,
// retiled so that an O accumulator of DH / 2 fp32 registers a thread fits
// beside S and P: 64-key tiles, two warpgroups, no producer warpgroup.
constexpr int WIDE_BKV = 64;       // keys per tile
constexpr int WIDE_THREADS = 256;  // two consumer warpgroups
static_assert(BQ == 128 && WIDE_BKV == 64, "64-row warpgroup slices");

template <int DH> struct SmemWide {
  static constexpr int STAGES = DH == 192 ? 3 : 2;  // depth of the K/V ring
  static constexpr int CH = DH / 64;
  static constexpr int Q_CHUNK = BQ * 128;
  static constexpr int KV_CHUNK = WIDE_BKV * 128;
  static constexpr int KV_TILE = CH * KV_CHUNK;
  static constexpr int OFF_K = CH * Q_CHUNK;  // Q | K ring | V ring | bars
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_TILE;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 3 * STAGES) + 1024;
};
static_assert(SmemWide<192>::BYTES == 197712 &&
                  SmemWide<256>::BYTES == 197688,
              "wide-head layout");
static_assert(SmemWide<256>::BYTES <= MAX_SMEM &&
                  SmemWide<192>::BYTES <= MAX_SMEM,
              "wide-head shared memory");

// O[64 x 128] or O[64 x 64] += P[64 x 16] V[16 x N]: the product of one
// slice of the accumulator, picked by its size.
__device__ __forceinline__ void pv_acc(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  hopper::wgmma_rs_n128(d, a, db, 1);
}
__device__ __forceinline__ void pv_acc(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  hopper::wgmma_rs_n64(d, a, db, 1);
}

// [a | b] (64 x DH: columns 0-127 and 128 to DH - 1) += A[64 x 16]
// (registers) * B[16 x DH], B MN-major from `base` in 64-column chunks
// `chunk` bytes apart.
template <int NB>
__device__ __forceinline__ void acc_rows(float (&a)[64], float (&b)[NB],
                                         const uint32_t (&x)[4],
                                         const unsigned char* base,
                                         int chunk) {
  pv_acc(a, x, hopper::desc_sw128(base, chunk, 1024));
  pv_acc(b, x, hopper::desc_sw128(base + 2 * chunk, chunk, 1024));
}

// Rows r0, r0 + 8 of [a | b] (64 x DH fp32), each times its scale, to bf16
// rows `ss` elements apart from `out`; rows at or past S not stored.
template <int DH>
__device__ __forceinline__ void store_bf16_rows(bf16* out, long long ss,
                                                int r0, int S,
                                                const float (&a)[64],
                                                const float (&b)[DH / 2 - 64],
                                                const float (&scale)[2],
                                                int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= S) continue;
    bf16* row = out + (r0 + 8 * r) * ss + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(a[4 * j + 2 * r] * scale[r],
                                a[4 * j + 2 * r + 1] * scale[r]);
#pragma unroll
    for (int j = 0; j < (DH / 2 - 64) / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 128 + 8 * j) =
          __floats2bfloat162_rn(b[4 * j + 2 * r] * scale[r],
                                b[4 * j + 2 * r + 1] * scale[r]);
  }
}

// Key tile k0's K and V into stage s of the wide kernel's ring, each
// completing on its own barrier (S = Q K^T need not wait for V).
template <int DH>
__device__ __forceinline__ void wide_fetch(unsigned char* smem,
                                           uint64_t* k_full, uint64_t* v_full,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv, int k0,
                                           int s, int hk, int b) {
  using L = SmemWide<DH>;
  unsigned char* ks = smem + L::OFF_K + s * L::KV_TILE;
  unsigned char* vs = smem + L::OFF_V + s * L::KV_TILE;
  hopper::mbar_expect_tx(&k_full[s], L::KV_TILE);
  for (int c = 0; c < L::CH; ++c)
    hopper::tma_load_4d(ks + c * L::KV_CHUNK, tk, &k_full[s], 64 * c, k0, hk,
                        b);
  hopper::mbar_expect_tx(&v_full[s], L::KV_TILE);
  for (int c = 0; c < L::CH; ++c)
    hopper::tma_load_4d(vs + c * L::KV_CHUNK, tv, &v_full[s], 64 * c, k0, hk,
                        b);
}

// The accumulator layout is flash_wgmma_kernel's; O is held as `oa`
// (columns 0-127) and `ob` (columns 128 to DH - 1).
template <int DH>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ o, float* __restrict__ lse,
                        Strides so, int H, int KVH, int S, int causal,
                        int window, float softcap, float sm_scale) {
  using L = SmemWide<DH>;
  constexpr int BKV = WIDE_BKV, ST = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + ST;
  uint64_t* empty = bars + 1 + 2 * ST;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);  // GQA: the KV head this query head reads
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  // key tiles inside the causal / window frontier of this query tile
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BKV;
  const int n_tiles = (kv_hi + BKV - 1) / BKV - t_lo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], WIDE_THREADS / 32);  // lane 0 of each warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q once; the ring's first tiles
    hopper::mbar_expect_tx(q_full, L::CH * L::Q_CHUNK);
    for (int c = 0; c < L::CH; ++c)
      hopper::tma_load_4d(smem + c * L::Q_CHUNK, &tq, q_full, 64 * c, q0, h,
                          b);
    for (int i = 0; i < min(ST, n_tiles); ++i)
      wide_fetch<DH>(smem, k_full, v_full, &tk, &tv, (t_lo + i) * BKV, i, hk,
                     b);
  }

  const int wgi = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int qw = q0 + 64 * wgi;  // the first of this warpgroup's rows
  const int qa = qw + (tid / 32) * 16 + lane / 4;  // rows qa, qa + 8
  const float c2 = sm_scale * LOG2E;
  const float cap_in = softcap > 0.f ? sm_scale / softcap : 0.f;
  const float cap_out = softcap > 0.f ? softcap / sm_scale : 0.f;
  const unsigned char* qs = smem + wgi * 64 * 128;

  float sacc[BKV / 2], oa[64], ob[DH / 2 - 64];
#pragma unroll
  for (int i = 0; i < 64; ++i) oa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 2 - 64; ++i) ob[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const uint32_t ph = (i / ST) & 1;
    const int k0 = (t_lo + i) * BKV;
    // thread 0 refills the stage of tile i - 1 once both warpgroups are
    // done with it (so they stay within a tile of each other)
    if (threadIdx.x == 0 && i > 0 && i - 1 + ST < n_tiles) {
      const int sp = (i - 1) % ST;
      hopper::mbar_wait(&empty[sp], ((i - 1) / ST) & 1);
      wide_fetch<DH>(smem, k_full, v_full, &tk, &tv,
                     (t_lo + i - 1 + ST) * BKV, sp, hk, b);
    }
    __syncwarp();
    const unsigned char* ks = smem + L::OFF_K + s * L::KV_TILE;
    const unsigned char* vs = smem + L::OFF_V + s * L::KV_TILE;
    // does any of this warpgroup's 64 rows see a key of the tile?
    const bool live = qw < S && !(causal && k0 > qw + 63) &&
                      !(window > 0 && k0 + BKV - 1 <= qw - window);

    // ---- S = Q K^T into registers ------------------------------------
    hopper::mbar_wait(&k_full[s], ph);
    uint32_t pa[BKV / 16][4];  // P in bf16: the A operand of P V
    if (live) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(
            qs + (kk / 4) * L::Q_CHUNK + (kk % 4) * 32, 16, 1024);
        const uint64_t db = hopper::desc_sw128(
            ks + (kk / 4) * L::KV_CHUNK + (kk % 4) * 32, 16, 1024);
        hopper::wgmma_ss_n64<0>(sacc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);

      // ---- online softmax on the registers ---------------------------
      if (softcap > 0.f) {  // kept in raw units: c2 applies the scale
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j)
          sacc[j] = tanhf(sacc[j] * cap_in) * cap_out;
      }
      const bool edge = k0 + BKV > S;
      const bool diag = causal && k0 + BKV - 1 > qw;
      const bool wedge = window > 0 && k0 <= qw + 63 - window;
      if (edge || diag || wedge) {  // only tiles where a mask bites
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          const int qpos = qa + 8 * ((j >> 1) & 1);
          bool ok = kpos < S;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) sacc[j] = -INFINITY;
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sacc[j]);
      float bias[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no visible key so far keeps p = 0 (exp2(-inf))
        bias[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c2;
        corr[r] = ex2(m_run[r] * c2 - bias[r]);
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e0 = 8 * kk + 2 * j, r = j & 1;
          const float p0 = ex2(fmaf(sacc[e0], c2, -bias[r]));
          const float p1 = ex2(fmaf(sacc[e0 + 1], c2, -bias[r]));
          rs[r] += p0 + p1;
          pa[kk][j] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
      for (int j = 0; j < 64; ++j) oa[j] *= corr[(j >> 1) & 1];
#pragma unroll
      for (int j = 0; j < DH / 2 - 64; ++j) ob[j] *= corr[(j >> 1) & 1];
    }

    // ---- O += P V over the 64-column chunks of V ---------------------
    hopper::mbar_wait(&v_full[s], ph);
    if (live) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        acc_rows(oa, ob, pa[kk], vs + kk * 16 * 128, L::KV_CHUNK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oa);
      hopper::fence_regs(ob);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // K/V stage is free
  }

  // ---- o = acc / l, rows beyond S not stored ---------------------------
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
    // the row's log-sum-exp in natural units of the scaled score (m_run is
    // in raw units: sm_scale brings it there), for the backward
    const int qpos = qa + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && qpos < S)
      lse[static_cast<long long>(bh) * S + qpos] =
          m_run[r] * sm_scale + logf(fmaxf(l, 1e-30f));
  }
  store_bf16_rows<DH>(o + b * so.b + h * so.h, so.s, qa, S, oa, ob, inv,
                      lane);
}

// flash_wgmma_kernel at head dim 64 / 128 (one box of BQ rows serves Q, K
// and V), flash_wgmma_wide_kernel at 192 / 256 (Q in boxes of BQ rows, K
// and V of WIDE_BKV).
template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KVH, int S, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, int window, float softcap, float sm_scale,
           cudaStream_t stream) {
  constexpr bool wide = DH > 128;
  // 4-D maps over [B, S, heads, dh] with the real strides: (dh chunk, key
  // or query offset, head, batch) are the coordinates of a tile
  auto map = [&](CUtensorMap* m, const void* base, int heads,
                 const Strides& st, int rows) {
    const uint64_t dims[4] = {DH, static_cast<uint64_t>(S),
                              static_cast<uint64_t>(heads),
                              static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {2ull * st.s, 2ull * st.h, 2ull * st.b};
    const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
    return hopper::make_map(m, base, 4, dims, strides, box);
  };
  constexpr int kv_rows = wide ? WIDE_BKV : BKV;
  CUtensorMap tq, tk, tv;
  if (!map(&tq, q, H, sq, BQ) || !map(&tk, k, KVH, sk, kv_rows) ||
      !map(&tv, v, KVH, sv, kv_rows))
    return -3;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  if constexpr (wide) {
    constexpr auto kern = flash_wgmma_wide_kernel<DH>;
    cudaError_t err = hopper::allow_smem<kern>(SmemWide<DH>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, WIDE_THREADS, SmemWide<DH>::BYTES, stream>>>(
        tq, tk, tv, reinterpret_cast<bf16*>(o), lse, so, H, KVH, S, causal,
        window, softcap, sm_scale);
  } else {
    static_assert(BQ == BKV, "one box shape serves Q, K and V");
    constexpr auto kern = flash_wgmma_kernel<DH>;
    cudaError_t err = hopper::allow_smem<kern>(Smem<DH>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, THREADS, Smem<DH>::BYTES, stream>>>(
        tq, tk, tv, reinterpret_cast<bf16*>(o), lse, so, H, KVH, S, causal,
        window, softcap, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------------- backward --
//
// flash_attention_bwd: the gradient of the forward above, recomputed from
// the forward's log-sum-exp (no [S, S] matrix is ever stored):
//
//   D  = rowsum(dO * O)                      (flash_bwd_rowdot_kernel)
//   P  = exp(S - lse), S the scaled (capped) scores under the forward's mask
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)  [* (1 - tanh^2) if capped]
//   dQ = dS K * sm_scale,  dK = dS^T Q * sm_scale
//
// Two kernels split the work so that no sum is shared between blocks: one
// block per (batch*head, key tile) walks the query tiles of the key tile's
// frontier and keeps its head's dK, dV tile in fp32 (written to a per-head
// fp32 scratch); one block per (batch*head, query tile) walks the key tiles
// and keeps dQ.  A last pass (flash_bwd_reduce_kernel) sums each KV head's
// group of query heads in a fixed order (GQA) and writes dK, dV in the
// input's type.  No atomics: two runs give the same bits.  P and dS are
// rounded to bf16 before their products, as the forward rounds P.
//
// Head dims and routes (flash_attention_bwd_launch below; the wrapper's
// `route` asked of q, k, v and dO and its `HEAD_DIMS` pick them -- the
// forward's rule -- and a test reads the instantiations out of this file):
//
//   route   dtype  head dims              kernels
//   wgmma   bf16   64, 128 (TMA-able)     wgb:: flash_bwd_dkdv_wgmma_kernel,
//                                         flash_bwd_dq_wgmma_kernel<DH>
//           bf16   192, 256 (TMA-able)    wgbw:: flash_bwd_dkdv_wide_kernel,
//                                         flash_bwd_dq_wide_kernel<DH>
//   wmma    bf16   32, 64, 128            bwd:: flash_bwd_dkdv_kernel,
//                  (64 x 64 tiles);       flash_bwd_dq_kernel<bf16, DH,
//                  192, 256 (32 x 32)     BQ, BKV>
//   fma     fp32   32, 64, 128, 192, 256  the same at <float, DH, 32, 32>
//                  (32 x 32 tiles)
//
// The wmma route keeps S, dP, P, dS and its sums in shared memory (wmma
// 16 x 16 round trips, 4 warps, plain loads) and serves what the wgmma
// route does not: head dim 32 and tensors TMA cannot describe.  fp32 runs
// plain FMA loops (correctness first).  Any other head dim is refused (-2)
// -- the wrapper raises first.
//
// What bounds it on an H100: 2.5x the forward's products (5 matrix products
// per tile pair against 2), recomputed here (dQ and dK/dV each form S and
// dP again): 7 products of B * H * S^2 / 2 * dh multiply-adds (causal)
// against B * (4 H + 4 KVH) * S * dh elements moved -- the tensor cores,
// far more than the bytes, so 7/5 of the 5-product bound is this design's
// own floor.  The wgmma route (below `bwd`) keeps every intermediate in
// registers and feeds the tensor cores by TMA; the fp32 dK/dV scratch it
// shares with the wmma route moves 2 x 4 B * H * S * dh bytes each way,
// beside the 2 x 2 B * KVH * S * dh of the outputs.
namespace bwd {

template <typename T, int DH, int BQ, int BKV> struct Layout {
  static constexpr int LDQ = DH + Pad<T>::T_;   // q, k, v, dO tiles (T)
  static constexpr int LDP = BKV + Pad<T>::T_;  // P, dS (T)
  static constexpr int LDS = BKV + Pad<T>::F_;  // S, dP (fp32)
  static constexpr int LDA = DH + Pad<T>::F_;   // dK, dV or dQ sums (fp32)
  static constexpr int ROWS = BQ > BKV ? BQ : BKV;
  static constexpr size_t TILE = align128(sizeof(T) * ROWS * LDQ);
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_DO = OFF_Q + TILE;
  static constexpr size_t OFF_K = OFF_DO + TILE;
  static constexpr size_t OFF_V = OFF_K + TILE;
  static constexpr size_t OFF_S = OFF_V + TILE;
  static constexpr size_t OFF_DP = OFF_S + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t OFF_P = OFF_DP + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t OFF_DS = OFF_P + align128(sizeof(T) * BQ * LDP);
  static constexpr size_t OFF_A0 = OFF_DS + align128(sizeof(T) * BQ * LDP);
  static constexpr size_t OFF_A1 =
      OFF_A0 + align128(sizeof(float) * ROWS * LDA);
  static constexpr size_t OFF_L = OFF_A1 + align128(sizeof(float) * ROWS * LDA);
  static constexpr size_t OFF_D = OFF_L + align128(sizeof(float) * BQ);
  static constexpr size_t BYTES = OFF_D + align128(sizeof(float) * BQ);
};
static_assert(Layout<bf16, 128, 64, 64>::BYTES <= MAX_SMEM &&
                  Layout<float, 128, 32, 32>::BYTES <= MAX_SMEM,
              "backward shared memory");
// head dims 192 and 256 on 32 x 32 tiles (64 x 64 would take ~321 KB at
// 256): bf16 115,968 / 148,736 bytes, fp32 165,376 / 214,528
static_assert(Layout<bf16, 192, 32, 32>::BYTES == 115968 &&
                  Layout<bf16, 256, 32, 32>::BYTES == 148736 &&
                  Layout<float, 192, 32, 32>::BYTES == 165376 &&
                  Layout<float, 256, 32, 32>::BYTES == 214528,
              "backward layout");
static_assert(Layout<bf16, 256, 32, 32>::BYTES <= MAX_SMEM &&
                  Layout<float, 256, 32, 32>::BYTES <= MAX_SMEM,
              "backward shared memory at head dim 256");

// C[M, N] (fp32, row stride ldc) += A[M, K] B[K, N] over the block, A and B
// in shared memory: A(i, k) = A_COL ? A[k * lda + i] : A[i * lda + k],
// B(k, j) = B_COL ? B[j * ldb + k] : B[k * ldb + j].  bf16 on wmma (each
// warp owns whole 16x16 tiles of C), fp32 on FMA loops.
template <typename T, int M, int N, int K, bool A_COL, bool B_COL>
__device__ __forceinline__ void block_mma(float* C, int ldc, const T* A,
                                          int lda, const T* Bm, int ldb) {
  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "wmma tiles");
    using LA = typename std::conditional<A_COL, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<B_COL, wmma::col_major,
                                         wmma::row_major>::type;
    constexpr int TN = N / 16;
    for (int tile = threadIdx.x / 32; tile < (M / 16) * TN;
         tile += NT / 32) {
      const int i0 = (tile / TN) * 16, j0 = (tile % TN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(
            a, reinterpret_cast<const bf16*>(A) +
                   (A_COL ? k0 * lda + i0 : i0 * lda + k0), lda);
        wmma::load_matrix_sync(
            b, reinterpret_cast<const bf16*>(Bm) +
                   (B_COL ? j0 * ldb + k0 : k0 * ldb + j0), ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += NT) {
      const int i = idx / N, j = idx % N;
      float s = C[i * ldc + j];
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        s = fmaf(to_f(A_COL ? A[k * lda + i] : A[i * lda + k]),
                 to_f(B_COL ? Bm[j * ldb + k] : Bm[k * ldb + j]), s);
      C[i * ldc + j] = s;
    }
  }
}

__device__ __forceinline__ void zero_f(float* a, int n) {
  for (int idx = threadIdx.x; idx < n; idx += NT) a[idx] = 0.f;
}

// S = Q K^T and dP = dO V^T of one (query tile, key tile) pair, then, in
// place, P (T) and dS (T) under the forward's mask.  Rows past S and keys
// past S give P = dS = 0.
template <typename T, int DH, int BQ, int BKV>
__device__ __forceinline__ void tile_grads(unsigned char* smem, int q0, int k0,
                                           int S, int causal, int window,
                                           float softcap, float sm_scale) {
  using L = Layout<T, DH, BQ, BKV>;
  const T* Qs = reinterpret_cast<const T*>(smem + L::OFF_Q);
  const T* dOs = reinterpret_cast<const T*>(smem + L::OFF_DO);
  const T* Ks = reinterpret_cast<const T*>(smem + L::OFF_K);
  const T* Vs = reinterpret_cast<const T*>(smem + L::OFF_V);
  float* Ss = reinterpret_cast<float*>(smem + L::OFF_S);
  float* dPs = reinterpret_cast<float*>(smem + L::OFF_DP);
  T* Ps = reinterpret_cast<T*>(smem + L::OFF_P);
  T* dSs = reinterpret_cast<T*>(smem + L::OFF_DS);
  const float* Ls = reinterpret_cast<const float*>(smem + L::OFF_L);
  const float* Ds = reinterpret_cast<const float*>(smem + L::OFF_D);
  zero_f(Ss, BQ * L::LDS);
  zero_f(dPs, BQ * L::LDS);
  __syncthreads();
  block_mma<T, BQ, BKV, DH, false, true>(Ss, L::LDS, Qs, L::LDQ, Ks, L::LDQ);
  block_mma<T, BQ, BKV, DH, false, true>(dPs, L::LDS, dOs, L::LDQ, Vs,
                                         L::LDQ);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * BKV; idx += NT) {
    const int i = idx / BKV, j = idx % BKV;
    const int qpos = q0 + i, kpos = k0 + j;
    float s = Ss[i * L::LDS + j] * sm_scale, th = 0.f;
    if (softcap > 0.f) {
      th = tanhf(s / softcap);
      s = th * softcap;
    }
    bool ok = qpos < S && kpos < S;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
    const float p = ok ? expf(s - Ls[i]) : 0.f;
    float ds = p * (dPs[i * L::LDS + j] - Ds[i]);
    if (softcap > 0.f) ds *= 1.f - th * th;
    Ps[i * L::LDP + j] = from_f<T>(p);
    dSs[i * L::LDP + j] = from_f<T>(ds);
  }
  __syncthreads();
}

// lse and D of query rows q0 .. q0 + BQ - 1 into shared memory (0 past S).
template <typename T, int DH, int BQ, int BKV>
__device__ __forceinline__ void load_rows(unsigned char* smem,
                                          const float* lse, const float* D,
                                          long long row0, int q0, int S) {
  using L = Layout<T, DH, BQ, BKV>;
  float* Ls = reinterpret_cast<float*>(smem + L::OFF_L);
  float* Ds = reinterpret_cast<float*>(smem + L::OFF_D);
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const bool in = q0 + i < S;
    Ls[i] = in ? lse[row0 + q0 + i] : 0.f;
    Ds[i] = in ? D[row0 + q0 + i] : 0.f;
  }
}

// One block per (key tile, batch*head): this head's dK, dV of the key tile
// (unscaled dK), fp32, into dk_part / dv_part [B, H, S, DH].
template <typename T, int DH, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk_part,
                      float* __restrict__ dv_part, int H, int KVH, int S,
                      Strides sq, Strides sk, Strides sv, Strides sdo,
                      int causal, int window, float softcap, float sm_scale,
                      int vec_ok) {
  using L = Layout<T, DH, BQ, BKV>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::OFF_Q);
  T* dOs = reinterpret_cast<T*>(smem + L::OFF_DO);
  T* Ks = reinterpret_cast<T*>(smem + L::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + L::OFF_V);
  const T* Ps = reinterpret_cast<const T*>(smem + L::OFF_P);
  const T* dSs = reinterpret_cast<const T*>(smem + L::OFF_DS);
  float* dKa = reinterpret_cast<float*>(smem + L::OFF_A0);
  float* dVa = reinterpret_cast<float*>(smem + L::OFF_A1);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int k0 = blockIdx.x * BKV;
  const bool vec = vec_ok != 0;
  const long long row0 = static_cast<long long>(bh) * S;

  load_tile<T, DH, BKV, L::LDQ>(Ks, k + b * sk.b + hk * sk.h, k0, S, sk.s,
                                vec);
  load_tile<T, DH, BKV, L::LDQ>(Vs, v + b * sv.b + hk * sv.h, k0, S, sv.s,
                                vec);
  zero_f(dKa, BKV * L::LDA);
  zero_f(dVa, BKV * L::LDA);
  // query tiles that see a key of this tile: from the diagonal (causal) to
  // the last query inside the window of the tile's last key
  const int qt_lo = causal ? k0 / BQ : 0;
  const int q_end = window > 0 ? min(S, k0 + BKV - 1 + window) : S;
  const int qt_hi = (q_end + BQ - 1) / BQ;
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the last tile's products are done with Q, dO, P, dS
    load_tile<T, DH, BQ, L::LDQ>(Qs, q + b * sq.b + h * sq.h, q0, S, sq.s,
                                 vec);
    load_tile<T, DH, BQ, L::LDQ>(dOs, dO + b * sdo.b + h * sdo.h, q0, S,
                                 sdo.s, vec);
    load_rows<T, DH, BQ, BKV>(smem, lse, D, row0, q0, S);
    tile_grads<T, DH, BQ, BKV>(smem, q0, k0, S, causal, window, softcap,
                               sm_scale);
    block_mma<T, BKV, DH, BQ, true, false>(dVa, L::LDA, Ps, L::LDP, dOs,
                                           L::LDQ);
    block_mma<T, BKV, DH, BQ, true, false>(dKa, L::LDA, dSs, L::LDP, Qs,
                                           L::LDQ);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BKV * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    const int pos = k0 + r;
    if (pos >= S) continue;
    const long long at = (row0 + pos) * DH + d;
    dk_part[at] = dKa[r * L::LDA + d];
    dv_part[at] = dVa[r * L::LDA + d];
  }
}

// One block per (query tile, batch*head): dQ of the tile, in T.
template <typename T, int DH, int BQ, int BKV>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    T* __restrict__ dq, int H, int KVH, int S, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdq,
                    int causal, int window, float softcap, float sm_scale,
                    int vec_ok) {
  using L = Layout<T, DH, BQ, BKV>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::OFF_Q);
  T* dOs = reinterpret_cast<T*>(smem + L::OFF_DO);
  T* Ks = reinterpret_cast<T*>(smem + L::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + L::OFF_V);
  const T* dSs = reinterpret_cast<const T*>(smem + L::OFF_DS);
  float* dQa = reinterpret_cast<float*>(smem + L::OFF_A0);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const bool vec = vec_ok != 0;

  load_tile<T, DH, BQ, L::LDQ>(Qs, q + b * sq.b + h * sq.h, q0, S, sq.s, vec);
  load_tile<T, DH, BQ, L::LDQ>(dOs, dO + b * sdo.b + h * sdo.h, q0, S, sdo.s,
                               vec);
  load_rows<T, DH, BQ, BKV>(smem, lse, D, static_cast<long long>(bh) * S, q0,
                            S);
  zero_f(dQa, BQ * L::LDA);
  // key tiles inside the causal / window frontier, as in the forward
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BKV, t_hi = (kv_hi + BKV - 1) / BKV;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the last tile's product is done with K and dS
    load_tile<T, DH, BKV, L::LDQ>(Ks, k + b * sk.b + hk * sk.h, k0, S, sk.s,
                                  vec);
    load_tile<T, DH, BKV, L::LDQ>(Vs, v + b * sv.b + hk * sv.h, k0, S, sv.s,
                                  vec);
    tile_grads<T, DH, BQ, BKV>(smem, q0, k0, S, causal, window, softcap,
                               sm_scale);
    block_mma<T, BQ, DH, BKV, false, false>(dQa, L::LDA, dSs, L::LDP, Ks,
                                            L::LDQ);
  }
  __syncthreads();
  T* dqp = dq + b * sdq.b + h * sdq.h;
  for (int idx = threadIdx.x; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    const int pos = q0 + r;
    if (pos < S)
      dqp[pos * sdq.s + d] = from_f<T>(dQa[r * L::LDA + d] * sm_scale);
  }
}

// D[b, h, pos] = sum_d dO * O over the row, one warp per row.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                        float* __restrict__ D, int B, int H, int S, int DH,
                        Strides so, Strides sdo) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * H * S) return;
  const int lane = threadIdx.x % 32;
  const int pos = static_cast<int>(row % S);
  const long long bh = row / S;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* orow = o + b * so.b + pos * so.s + h * so.h;
  const T* grow = dO + b * sdo.b + pos * sdo.s + h * sdo.h;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(grow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// dk[b, pos, hk] = sm_scale * sum over the group's heads g of
// dk_part[b, hk * G + g, pos], in order of g; dv the same, unscaled.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_reduce_kernel(const float* __restrict__ dk_part,
                        const float* __restrict__ dv_part, T* __restrict__ dk,
                        T* __restrict__ dv, int B, int H, int KVH, int S,
                        int DH, Strides sdk, Strides sdv, float sm_scale) {
  const int G = H / KVH;
  const long long n = static_cast<long long>(B) * S * KVH * DH;
  for (long long idx = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * NT) {
    const int d = static_cast<int>(idx % DH);
    long long rest = idx / DH;
    const int hk = static_cast<int>(rest % KVH);
    rest /= KVH;
    const int pos = static_cast<int>(rest % S);
    const int b = static_cast<int>(rest / S);
    float gk = 0.f, gv = 0.f;
    for (int g = 0; g < G; ++g) {
      const long long at =
          ((static_cast<long long>(b) * H + hk * G + g) * S + pos) * DH + d;
      gk += dk_part[at];
      gv += dv_part[at];
    }
    dk[b * sdk.b + pos * sdk.s + hk * sdk.h + d] = from_f<T>(gk * sm_scale);
    dv[b * sdv.b + pos * sdv.s + hk * sdv.h + d] = from_f<T>(gv);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float *D, *dk_part, *dv_part;
  int B, H, KVH, S;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int causal, window;
  float softcap, sm_scale;
  int vec_ok;
};

template <typename T, int DH, int BQ, int BKV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(Layout<T, DH, BQ, BKV>::BYTES);
  constexpr auto kdkdv = flash_bwd_dkdv_kernel<T, DH, BQ, BKV>;
  constexpr auto kdq = flash_bwd_dq_kernel<T, DH, BQ, BKV>;
  cudaError_t err = hopper::allow_smem<kdkdv>(bytes);
  if (err == cudaSuccess) err = hopper::allow_smem<kdq>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* q = reinterpret_cast<const T*>(a.q);
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  const T* dO = reinterpret_cast<const T*>(a.dO);
  const long long rows = static_cast<long long>(a.B) * a.H * a.S;
  flash_bwd_rowdot_kernel<T><<<static_cast<unsigned>((rows + NT / 32 - 1) /
                                                     (NT / 32)),
                               NT, 0, stream>>>(
      reinterpret_cast<const T*>(a.o), dO, a.D, a.B, a.H, a.S, DH, a.so,
      a.sdo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdkdv<<<dim3((a.S + BKV - 1) / BKV, a.B * a.H), NT, bytes, stream>>>(
      q, k, v, dO, a.lse, a.D, a.dk_part, a.dv_part, a.H, a.KVH, a.S, a.sq,
      a.sk, a.sv, a.sdo, a.causal, a.window, a.softcap, a.sm_scale,
      a.vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdq<<<dim3((a.S + BQ - 1) / BQ, a.B * a.H), NT, bytes, stream>>>(
      q, k, v, dO, a.lse, a.D, reinterpret_cast<T*>(a.dq), a.H, a.KVH, a.S,
      a.sq, a.sk, a.sv, a.sdo, a.sdq, a.causal, a.window, a.softcap,
      a.sm_scale, a.vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(a.B) * a.S * a.KVH * DH;
  const long long blocks = (n + NT - 1) / NT;
  flash_bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks < 8192 ? blocks
                                                                   : 8192),
                               NT, 0, stream>>>(
      a.dk_part, a.dv_part, reinterpret_cast<T*>(a.dk),
      reinterpret_cast<T*>(a.dv), a.B, a.H, a.KVH, a.S, DH, a.sdk, a.sdv,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

// ---------------------------------- backward, bf16 on wgmma + TMA (sm_90a) --
//
// The route the wrapper picks for bf16 at head dim 64 or 128 whose q, k, v,
// dO TMA can describe.  The same arithmetic as `bwd` above, laid out for
// the card: two kernels of consumer warpgroups, every intermediate in
// accumulator registers.  Thread 0 also feeds the block's ring by TMA on
// mbarriers, over the same 4-D [B, S, heads, dh] tensor maps with the real
// strides that the forward uses, so GQA is never expanded: it fills every
// stage up front and refills the stage of tile i - 1 at the top of tile i,
// once every warpgroup has released it.  No producer warp: any third
// warpgroup caps every thread at 168 registers (65,536 / 384), and the
// dK/dV consumer's 128 accumulators at head dim 128 beside S^T and dP^T
// spilled there even with setmaxnreg; with two warpgroups each thread may
// hold 255.
//
//   flash_bwd_dkdv_wgmma_kernel: one block per (batch*head, 128-key tile);
//     K and V loaded once, Q, dO (64 queries) and their lse2, D rows
//     streamed through a four-stage ring over the query tiles of the key
//     tile's causal / window frontier.  Each warpgroup owns 64 keys: S^T =
//     K Q^T and dP^T = V dO^T (both operands K-major from shared memory)
//     into registers; P^T = exp2(S^T c2 - lse2) and dS^T = P^T (dP^T - D)
//     [* (1 - tanh^2)] formed there (the mask applied only on tiles where
//     it bites), packed to bf16 and used as the register A operand of dV +=
//     P^T dO and dK += dS^T Q (dO, Q the MN-major B operands: the tile that
//     served S^T serves these).  dK, dV stay in registers for the whole
//     walk (64 + 64 fp32 at head dim 128) and go to the per-head fp32
//     scratch at the end.
//   flash_bwd_dq_wgmma_kernel: one block per (batch*head, 192-query tile),
//     Q and dO loaded once, K and V (64 keys) streamed through a three-
//     stage ring over the frontier as in the forward.  Each of its three
//     warpgroups owns 64 queries: S = Q K^T, dP = dO V^T into registers, dS in registers as
//     the A operand of dQ += dS K (K the MN-major B operand).
//
// flash_bwd_prep_kernel forms, per (batch*head) row padded to a multiple of
// PAD (384) positions, D = rowsum(dO * O) and lse2 = lse * log2(e) (the
// forward's natural-log units in exp2's), lse2 = +inf and D = 0 past S, so
// every tile the kernels read is in bounds and a query past S has P = 0.
// The GQA sum of the per-head dK, dV stays the ordered
// `flash_bwd_reduce_kernel`: no atomics, two runs give the same bits.
namespace wgb {

// No producer warp: thread 0 feeds the rings.  The dK/dV kernel runs two
// warpgroups, so each thread may hold 255 registers (a third warpgroup
// caps them at 168 and spills its consumers); the dQ kernel's consumers
// fit 168, and it runs three.
constexpr int KV_THREADS = 256;
constexpr int Q_THREADS = 384;
constexpr int STAGES = 3;     // dQ kernel: depth of the K/V ring
constexpr int KV_STAGES = 4;  // dK/dV kernel: depth of the Q/dO ring
constexpr int KV_KEYS = 128;  // dK/dV kernel: keys per block
constexpr int KV_QS = 64;     // ... queries per streamed tile
constexpr int Q_QS = 192;     // dQ kernel: queries per block
constexpr int Q_KEYS = 64;    // ... keys per streamed tile
constexpr int PAD = 384;      // the prep kernel's rows: S rounded up to it
// every tile a kernel reads from those rows lies inside them (the wide
// kernels' tiles below are held to it too)
static_assert(PAD % Q_QS == 0 && PAD % KV_QS == 0, "PAD");
// the score tiles are 64 x 64 (ss_pair, four k16 steps of the A operands)
static_assert(KV_QS == 64 && Q_KEYS == 64, "64-wide score tiles");

template <int DH> struct SmemKV {
  static constexpr int CH = DH / 64;
  static constexpr int K_CHUNK = KV_KEYS * 128;
  static constexpr int K_TILE = CH * K_CHUNK;
  static constexpr int Q_CHUNK = KV_QS * 128;
  static constexpr int Q_TILE = CH * Q_CHUNK;
  static constexpr int ROW = KV_QS * 4;  // one stage's lse2 (or D), bytes
  static constexpr int OFF_K = 0;        // K | V | Q ring | dO ring | lse2,
  static constexpr int OFF_V = K_TILE;   // D rings | barriers
  static constexpr int OFF_Q = 2 * K_TILE;
  static constexpr int OFF_DO = OFF_Q + KV_STAGES * Q_TILE;
  static constexpr int OFF_L = OFF_DO + KV_STAGES * Q_TILE;
  static constexpr int OFF_D = OFF_L + KV_STAGES * ROW;
  static constexpr int OFF_BAR = OFF_D + KV_STAGES * ROW;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * KV_STAGES) + 1024;
};

template <int DH> struct SmemQ {
  static constexpr int CH = DH / 64;
  static constexpr int Q_CHUNK = Q_QS * 128;
  static constexpr int Q_TILE = CH * Q_CHUNK;
  static constexpr int K_CHUNK = Q_KEYS * 128;
  static constexpr int K_TILE = CH * K_CHUNK;
  static constexpr int OFF_Q = 0;  // Q | dO | K ring | V ring | barriers
  static constexpr int OFF_DO = Q_TILE;
  static constexpr int OFF_K = 2 * Q_TILE;
  static constexpr int OFF_V = OFF_K + STAGES * K_TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * K_TILE;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};
static_assert(SmemKV<128>::BYTES <= MAX_SMEM && SmemQ<128>::BYTES <= MAX_SMEM,
              "wgmma backward shared memory");

// D[64 x DH] (+)= A[64 x 16] (registers) * B[16 x DH] (shared, MN-major)
template <int DH>
__device__ __forceinline__ void rs_acc(float (&d)[DH / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 128)
    hopper::wgmma_rs_n128(d, a, db, 1);
  else
    hopper::wgmma_rs_n64(d, a, db, 1);
}

// The pair of products X Y^T, X2 Y2^T (64 x 64) of a 64-row slice: both
// operands K-major from 128-byte-swizzled tiles whose 64-column chunks lie
// `xc` / `yc` bytes apart.
template <int DH>
__device__ __forceinline__ void ss_pair(float (&s)[32], float (&t)[32],
                                        const unsigned char* x, int xc,
                                        const unsigned char* y, int yc,
                                        const unsigned char* x2,
                                        const unsigned char* y2) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int off_x = (kk / 4) * xc + (kk % 4) * 32;
    const int off_y = (kk / 4) * yc + (kk % 4) * 32;
    hopper::wgmma_ss_n64<0>(s, hopper::desc_sw128(x + off_x, 16, 1024),
                            hopper::desc_sw128(y + off_y, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int off_x = (kk / 4) * xc + (kk % 4) * 32;
    const int off_y = (kk / 4) * yc + (kk % 4) * 32;
    hopper::wgmma_ss_n64<0>(t, hopper::desc_sw128(x2 + off_x, 16, 1024),
                            hopper::desc_sw128(y2 + off_y, 16, 1024),
                            kk > 0);
  }
}

// P and dS of one score element: s the raw score (q.k), dp its dP, l2 the
// row's lse2, dd its D.  Returns dS; p through `p`.
__device__ __forceinline__ float grad_elem(float s, float dp, float l2,
                                           float dd, bool ok, float c2,
                                           float cap_in, float cap_out,
                                           float& p) {
  float th = 0.f;
  if (cap_in != 0.f) {  // capped in raw units: c2 applies the scale
    th = tanhf(s * cap_in);
    s = th * cap_out;
  }
  p = ok ? wg::ex2(fmaf(s, c2, -l2)) : 0.f;
  float ds = p * (dp - dd);
  if (cap_in != 0.f) ds *= 1.f - th * th;
  return ds;
}

// Tile i's Q, dO, lse2 and D rows (queries from q0) into stage s of a
// dK/dV kernel's ring (layout L), completing on full[s].
template <class L>
__device__ __forceinline__ void kv_fetch(unsigned char* smem, uint64_t* full,
                                         const CUtensorMap* tq,
                                         const CUtensorMap* tdo,
                                         const float* lrow, const float* drow,
                                         int q0, int s, int h, int b) {
  hopper::mbar_expect_tx(&full[s], 2 * L::Q_TILE + 2 * L::ROW);
  unsigned char* qs = smem + L::OFF_Q + s * L::Q_TILE;
  unsigned char* dos = smem + L::OFF_DO + s * L::Q_TILE;
  for (int c = 0; c < L::CH; ++c) {
    hopper::tma_load_4d(qs + c * L::Q_CHUNK, tq, &full[s], 64 * c, q0, h, b);
    hopper::tma_load_4d(dos + c * L::Q_CHUNK, tdo, &full[s], 64 * c, q0, h,
                        b);
  }
  hopper::bulk_load(smem + L::OFF_L + s * L::ROW, lrow + q0, L::ROW,
                    &full[s]);
  hopper::bulk_load(smem + L::OFF_D + s * L::ROW, drow + q0, L::ROW,
                    &full[s]);
}

template <int DH>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse2,
                            const float* __restrict__ Dp,
                            float* __restrict__ dk_part,
                            float* __restrict__ dv_part, int H, int KVH,
                            int S, int S_pad, int causal, int window,
                            float softcap, float sm_scale) {
  using L = SmemKV<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + KV_STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);   // GQA: the KV head of this query head
  const int k0 = blockIdx.y * KV_KEYS;  // the heaviest key tiles go first
  // query tiles that see a key of this tile: from the diagonal (causal) to
  // the last query inside the window of the tile's last key
  const int qt_lo = causal ? k0 / KV_QS : 0;
  const int q_end = window > 0 ? min(S, k0 + KV_KEYS - 1 + window) : S;
  const int n_tiles = (q_end + KV_QS - 1) / KV_QS - qt_lo;
  const float* lrow = lse2 + static_cast<long long>(bh) * S_pad;
  const float* drow = Dp + static_cast<long long>(bh) * S_pad;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], KV_THREADS / 32);  // lane 0 of each warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // K, V once; the ring's first tiles
    hopper::mbar_expect_tx(kv_full, 2 * L::K_TILE);
    for (int c = 0; c < L::CH; ++c) {
      hopper::tma_load_4d(smem + L::OFF_K + c * L::K_CHUNK, &tk, kv_full,
                          64 * c, k0, hk, b);
      hopper::tma_load_4d(smem + L::OFF_V + c * L::K_CHUNK, &tv, kv_full,
                          64 * c, k0, hk, b);
    }
    for (int i = 0; i < min(KV_STAGES, n_tiles); ++i)
      kv_fetch<L>(smem, full, &tq, &tdo, lrow, drow, (qt_lo + i) * KV_QS,
                  i, h, b);
  }

  const int wgi = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int kw = k0 + 64 * wgi;                     // this warpgroup's keys
  const int ka = kw + (tid / 32) * 16 + lane / 4;   // rows ka, ka + 8
  const float c2 = sm_scale * wg::LOG2E;
  const float cap_in = softcap > 0.f ? sm_scale / softcap : 0.f;
  const float cap_out = softcap > 0.f ? softcap / sm_scale : 0.f;
  const unsigned char* ks = smem + L::OFF_K + wgi * 64 * 128;
  const unsigned char* vs = smem + L::OFF_V + wgi * 64 * 128;

  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % KV_STAGES;
    const uint32_t ph = (i / KV_STAGES) & 1;
    const int q0 = (qt_lo + i) * KV_QS;
    // thread 0 refills the stage of tile i - 1 once both warpgroups are
    // done with it (so they stay within a tile of each other)
    if (threadIdx.x == 0 && i > 0 && i - 1 + KV_STAGES < n_tiles) {
      const int sp = (i - 1) % KV_STAGES;
      hopper::mbar_wait(&empty[sp], ((i - 1) / KV_STAGES) & 1);
      kv_fetch<L>(smem, full, &tq, &tdo, lrow, drow,
                  (qt_lo + i - 1 + KV_STAGES) * KV_QS, sp, h, b);
    }
    __syncwarp();
    const unsigned char* qs = smem + L::OFF_Q + s * L::Q_TILE;
    const unsigned char* dos = smem + L::OFF_DO + s * L::Q_TILE;
    const float* ls = reinterpret_cast<const float*>(smem + L::OFF_L +
                                                     s * L::ROW);
    const float* ds = reinterpret_cast<const float*>(smem + L::OFF_D +
                                                     s * L::ROW);

    // ---- S^T = K Q^T, dP^T = V dO^T into registers -----------------------
    float st[32], dpt[32];
    hopper::mbar_wait(&full[s], ph);
    hopper::wgmma_fence();
    ss_pair<DH>(st, dpt, ks, L::K_CHUNK, qs, L::Q_CHUNK, vs, dos);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // ---- P^T, dS^T in registers, packed as the A operands ----------------
    // element 8 kk + 2 j + e: key row ka + 8 (j & 1), query column
    // 16 kk + 8 (j >> 1) + 2 (lane & 3) + e of the tile
    const bool diag = causal && kw + 63 > q0;
    const bool wedge = window > 0 && kw <= q0 + KV_QS - 1 - window;
    uint32_t pa[KV_QS / 16][4], sa[KV_QS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KV_QS / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e0 = 8 * kk + 2 * j;
        const int col = 16 * kk + 8 * (j >> 1) + 2 * (lane & 3);
        const int kpos = ka + 8 * (j & 1);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 dd = *reinterpret_cast<const float2*>(ds + col);
        bool ok0 = true, ok1 = true;
        if (diag || wedge) {
          const int qpos = q0 + col;
          if (causal) {
            ok0 = kpos <= qpos;
            ok1 = kpos <= qpos + 1;
          }
          if (window > 0) {
            ok0 = ok0 && kpos > qpos - window;
            ok1 = ok1 && kpos > qpos + 1 - window;
          }
        }
        float p0, p1;
        const float g0 = grad_elem(st[e0], dpt[e0], l2.x, dd.x, ok0, c2,
                                   cap_in, cap_out, p0);
        const float g1 = grad_elem(st[e0 + 1], dpt[e0 + 1], l2.y, dd.y, ok1,
                                   c2, cap_in, cap_out, p1);
        pa[kk][j] = wg::pack_bf16(p0, p1);
        sa[kk][j] = wg::pack_bf16(g0, g1);
      }
    }

    // ---- dV += P^T dO, dK += dS^T Q --------------------------------------
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV_QS / 16; ++kk)
      rs_acc<DH>(dv, pa[kk],
                 hopper::desc_sw128(dos + kk * 16 * 128, L::Q_CHUNK, 1024));
#pragma unroll
    for (int kk = 0; kk < KV_QS / 16; ++kk)
      rs_acc<DH>(dk, sa[kk],
                 hopper::desc_sw128(qs + kk * 16 * 128, L::Q_CHUNK, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // the stage is free
  }

  // ---- this head's dK (unscaled), dV rows to the fp32 scratch -----------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = ka + 8 * r;
    if (pos >= S) continue;
    const long long at = (static_cast<long long>(bh) * S + pos) * DH +
                         2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<float2*>(dk_part + at + 8 * j) =
          make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(dv_part + at + 8 * j) =
          make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// Key tile k0's K and V into stage s of a dQ kernel's ring (layout L),
// completing on full[s].
template <class L>
__device__ __forceinline__ void q_fetch(unsigned char* smem, uint64_t* full,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int k0, int s,
                                        int hk, int b) {
  hopper::mbar_expect_tx(&full[s], 2 * L::K_TILE);
  unsigned char* ks = smem + L::OFF_K + s * L::K_TILE;
  unsigned char* vs = smem + L::OFF_V + s * L::K_TILE;
  for (int c = 0; c < L::CH; ++c) {
    hopper::tma_load_4d(ks + c * L::K_CHUNK, tk, &full[s], 64 * c, k0, hk, b);
    hopper::tma_load_4d(vs + c * L::K_CHUNK, tv, &full[s], 64 * c, k0, hk, b);
  }
}

template <int DH>
__global__ void __launch_bounds__(Q_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse2,
                          const float* __restrict__ Dp, bf16* __restrict__ dq,
                          Strides sdq, int H, int KVH, int S, int S_pad,
                          int causal, int window, float softcap,
                          float sm_scale) {
  using L = SmemQ<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Q_QS;  // heaviest first
  // key tiles inside the causal / window frontier, as in the forward
  const int kv_hi = causal ? min(S, q0 + Q_QS) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / Q_KEYS;
  const int n_tiles = (kv_hi + Q_KEYS - 1) / Q_KEYS - t_lo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], Q_THREADS / 32);  // lane 0 of each warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q, dO once; the ring's first tiles
    hopper::mbar_expect_tx(q_full, 2 * L::Q_TILE);
    for (int c = 0; c < L::CH; ++c) {
      hopper::tma_load_4d(smem + L::OFF_Q + c * L::Q_CHUNK, &tq, q_full,
                          64 * c, q0, h, b);
      hopper::tma_load_4d(smem + L::OFF_DO + c * L::Q_CHUNK, &tdo, q_full,
                          64 * c, q0, h, b);
    }
    for (int i = 0; i < min(STAGES, n_tiles); ++i)
      q_fetch<L>(smem, full, &tk, &tv, (t_lo + i) * Q_KEYS, i, hk, b);
  }

  const int wgi = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int qw = q0 + 64 * wgi;
  const int qa = qw + (tid / 32) * 16 + lane / 4;  // rows qa, qa + 8
  const float c2 = sm_scale * wg::LOG2E;
  const float cap_in = softcap > 0.f ? sm_scale / softcap : 0.f;
  const float cap_out = softcap > 0.f ? softcap / sm_scale : 0.f;
  const unsigned char* qs = smem + L::OFF_Q + wgi * 64 * 128;
  const unsigned char* dos = smem + L::OFF_DO + wgi * 64 * 128;
  const long long row = static_cast<long long>(bh) * S_pad;
  const float l2[2] = {lse2[row + qa], lse2[row + qa + 8]};
  const float dd[2] = {Dp[row + qa], Dp[row + qa + 8]};

  float dqa[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dqa[i] = 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = (t_lo + i) * Q_KEYS;
    // thread 0 refills the stage of tile i - 1 once every warpgroup is
    // done with it
    if (threadIdx.x == 0 && i > 0 && i - 1 + STAGES < n_tiles) {
      const int sp = (i - 1) % STAGES;
      hopper::mbar_wait(&empty[sp], ((i - 1) / STAGES) & 1);
      q_fetch<L>(smem, full, &tk, &tv, (t_lo + i - 1 + STAGES) * Q_KEYS, sp,
                 hk, b);
    }
    __syncwarp();
    const unsigned char* ks = smem + L::OFF_K + s * L::K_TILE;
    const unsigned char* vs = smem + L::OFF_V + s * L::K_TILE;

    // ---- S = Q K^T, dP = dO V^T into registers ---------------------------
    float sc[32], dp[32];
    hopper::mbar_wait(&full[s], ph);
    hopper::wgmma_fence();
    ss_pair<DH>(sc, dp, qs, L::Q_CHUNK, ks, L::K_CHUNK, dos, vs);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // ---- dS in registers: the A operand of dQ += dS K --------------------
    const bool edge = k0 + Q_KEYS > S;
    const bool diag = causal && k0 + Q_KEYS - 1 > qw;
    const bool wedge = window > 0 && k0 <= qw + 63 - window;
    uint32_t sa[Q_KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q_KEYS / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e0 = 8 * kk + 2 * j, r = j & 1;
        const int kpos = k0 + 16 * kk + 8 * (j >> 1) + 2 * (lane & 3);
        bool ok0 = true, ok1 = true;
        if (edge || diag || wedge) {
          const int qpos = qa + 8 * r;
          ok0 = kpos < S;
          ok1 = kpos + 1 < S;
          if (causal) {
            ok0 = ok0 && kpos <= qpos;
            ok1 = ok1 && kpos + 1 <= qpos;
          }
          if (window > 0) {
            ok0 = ok0 && kpos > qpos - window;
            ok1 = ok1 && kpos + 1 > qpos - window;
          }
        }
        float p0, p1;
        const float g0 = grad_elem(sc[e0], dp[e0], l2[r], dd[r], ok0, c2,
                                   cap_in, cap_out, p0);
        const float g1 = grad_elem(sc[e0 + 1], dp[e0 + 1], l2[r], dd[r], ok1,
                                   c2, cap_in, cap_out, p1);
        sa[kk][j] = wg::pack_bf16(g0, g1);
      }
    }

    // ---- dQ += dS K --------------------------------------------------------
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q_KEYS / 16; ++kk)
      rs_acc<DH>(dqa, sa[kk],
                 hopper::desc_sw128(ks + kk * 16 * 128, L::K_CHUNK, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqa);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // K/V stage is free
  }

  // ---- dq = dQ * sm_scale, rows beyond S not stored ---------------------
  bf16* dqp = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + 8 * r;
    if (qpos >= S) continue;
    bf16* out = dqp + qpos * sdq.s + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * r] * sm_scale,
                                dqa[4 * j + 2 * r + 1] * sm_scale);
  }
}

// D = rowsum(dO * O) and lse2 = lse * log2(e) per (batch*head, position)
// into rows of S_pad (a multiple of PAD): D = 0 and lse2 = +inf past S.
// One warp per padded row.
__global__ void __launch_bounds__(NT)
flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                      const float* __restrict__ lse, float* __restrict__ Dp,
                      float* __restrict__ lse2, int B, int H, int S,
                      int S_pad, int DH, Strides so, Strides sdo) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * H * S_pad) return;
  const int lane = threadIdx.x % 32;
  const int pos = static_cast<int>(row % S_pad);
  const long long bh = row / S_pad;
  if (pos >= S) {
    if (lane == 0) {
      Dp[row] = 0.f;
      lse2[row] = INFINITY;
    }
    return;
  }
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const bf16* orow = o + b * so.b + pos * so.s + h * so.h;
  const bf16* grow = dO + b * sdo.b + pos * sdo.s + h * sdo.h;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32)
    acc = fmaf(__bfloat162float(orow[d]), __bfloat162float(grow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    Dp[row] = acc;
    lse2[row] = lse[bh * S + pos] * wg::LOG2E;
  }
}

// A 4-D map over [B, S, heads, dh] with the real strides (elements): boxes
// of 64 columns by `rows` positions.
inline bool map_rows(CUtensorMap* m, const void* base, int dh, int S,
                     int heads, int B, const Strides& st, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(dh),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * st.s, 2ull * st.h, 2ull * st.b};
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return hopper::make_map(m, base, 4, dims, strides, box);
}

// The rows of S rounded up to PAD, per (batch*head): a.D holds 2 * B * H *
// S_pad floats, D and then lse2.
inline int pad_rows(int S) { return (S + PAD - 1) / PAD * PAD; }

// The first of a wgmma route's four launches: D and lse2 into a.D.
inline int prep(const bwd::Args& a, int dh, cudaStream_t stream) {
  const int S_pad = pad_rows(a.S);
  const long long rows = static_cast<long long>(a.B) * a.H * S_pad;
  flash_bwd_prep_kernel<<<static_cast<unsigned>((rows + NT / 32 - 1) /
                                                (NT / 32)),
                          NT, 0, stream>>>(
      reinterpret_cast<const bf16*>(a.o), reinterpret_cast<const bf16*>(a.dO),
      a.lse, a.D, a.D + rows, a.B, a.H, a.S, S_pad, dh, a.so, a.sdo);
  return static_cast<int>(cudaGetLastError());
}

// The last: each KV head's group of per-head dK, dV summed in order.
inline int reduce(const bwd::Args& a, int dh, cudaStream_t stream) {
  const long long n = static_cast<long long>(a.B) * a.S * a.KVH * dh;
  const long long blocks = (n + NT - 1) / NT;
  bwd::flash_bwd_reduce_kernel<bf16><<<static_cast<unsigned>(
                                           blocks < 8192 ? blocks : 8192),
                                       NT, 0, stream>>>(
      a.dk_part, a.dv_part, reinterpret_cast<bf16*>(a.dk),
      reinterpret_cast<bf16*>(a.dv), a.B, a.H, a.KVH, a.S, dh, a.sdk, a.sdv,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const bwd::Args& a, cudaStream_t stream) {
  const int S_pad = pad_rows(a.S);
  float* Dp = a.D;
  float* lse2 = a.D + static_cast<long long>(a.B) * a.H * S_pad;
  auto map = [&](CUtensorMap* m, const void* base, int heads,
                 const Strides& st, int rows) {
    return map_rows(m, base, DH, a.S, heads, a.B, st, rows);
  };
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  if (!map(&kq, a.q, a.H, a.sq, KV_QS) || !map(&kdo, a.dO, a.H, a.sdo, KV_QS) ||
      !map(&kk, a.k, a.KVH, a.sk, KV_KEYS) ||
      !map(&kv, a.v, a.KVH, a.sv, KV_KEYS) ||
      !map(&qq, a.q, a.H, a.sq, Q_QS) || !map(&qdo, a.dO, a.H, a.sdo, Q_QS) ||
      !map(&qk, a.k, a.KVH, a.sk, Q_KEYS) ||
      !map(&qv, a.v, a.KVH, a.sv, Q_KEYS))
    return -3;
  constexpr auto kdkdv = flash_bwd_dkdv_wgmma_kernel<DH>;
  constexpr auto kdq = flash_bwd_dq_wgmma_kernel<DH>;
  cudaError_t err = hopper::allow_smem<kdkdv>(SmemKV<DH>::BYTES);
  if (err == cudaSuccess) err = hopper::allow_smem<kdq>(SmemQ<DH>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = prep(a, DH, stream);
  if (rc != 0) return rc;
  kdkdv<<<dim3(a.B * a.H, (a.S + KV_KEYS - 1) / KV_KEYS), KV_THREADS,
          SmemKV<DH>::BYTES, stream>>>(kq, kk, kv, kdo, lse2, Dp, a.dk_part,
                                       a.dv_part, a.H, a.KVH, a.S, S_pad,
                                       a.causal, a.window, a.softcap,
                                       a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdq<<<dim3(a.B * a.H, (a.S + Q_QS - 1) / Q_QS), Q_THREADS, SmemQ<DH>::BYTES,
        stream>>>(qq, qk, qv, qdo, lse2, Dp, reinterpret_cast<bf16*>(a.dq),
                  a.sdq, a.H, a.KVH, a.S, S_pad, a.causal, a.window,
                  a.softcap, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(a, DH, stream);
}

}  // namespace wgb

// ---------------- backward at head dims 192 and 256 on wgmma + TMA (sm_90a) --
//
// The route the wrapper picks for bf16 at head dim 192 (deepseek_v32) or 256
// (gemma3) whose q, k, v, dO TMA can describe: `wgb`'s arithmetic, the same
// 4-D tensor maps, prep pass, per-head fp32 scratch and ordered GQA reduce,
// retiled so that an accumulator of DH / 2 fp32 registers a thread fits
// beside the score tiles.  Two warpgroups a block (a third would cap every
// thread at 168 registers), so each thread may hold 255.
//
//   flash_bwd_dkdv_wide_kernel: one block per (batch*head, 64-key tile),
//     heaviest first; K and V loaded once, Q, dO and their lse2, D rows
//     streamed through a ring of 64-query tiles (Tiles<DH>: three stages
//     at 192, two at 256).  One thread cannot hold both dK and dV (2 x
//     DH / 2 fp32: 256 registers at 256), so the two warpgroups split by
//     ROLE over the same 64 keys: warpgroup 0 forms S^T = K Q^T and P^T,
//     accumulates dV += P^T dO and hands P^T [* (1 - tanh^2)] in fp32 to
//     warpgroup 1 through shared memory (two 16 KB buffers, each on a pair
//     of mbarriers); warpgroup 1 forms dP^T = V dO^T, takes P^T, forms
//     dS^T and accumulates dK += dS^T Q.  Two products a warpgroup, four a
//     tile pair as in `wgb` (S^T formed in both warpgroups instead was ~10 %
//     slower).  The dK warpgroup's first thread feeds the ring (it refills
//     a stage once both warpgroups released it), so the dV warpgroup runs
//     up to two tiles ahead and never waits on a refill.
//   flash_bwd_dq_wide_kernel: one block per (batch*head, 128 queries),
//     heaviest first; Q and dO loaded once, K and V streamed through a ring
//     of key tiles (Tiles<DH>: 64 keys, two stages at 192; 32 keys, three
//     stages at 256 -- 128 KB of Q and dO leave room for one stage of 64
//     keys, none to overlap).  Each warpgroup owns 64 queries: S = Q K^T
//     and dP = dO V^T into registers, dS there as the A operand of dQ += dS
//     K; a warpgroup skips a tile none of its rows sees, as the wide
//     forward does.
//
// Fragments a thread (accumulator + score tiles + packed A operand) at head
// dim 192 / 256: dV 96 + 32 + 16 / 128 + 32 + 16, dK 96 + 32 + 16 / 128 +
// 32 + 16, dQ 96 + 64 + 16 / 128 + 32 + 8; ptxas fits every one without a
// spill (`--verbose-build`).  32-query tiles at 256 were slower.
namespace wgbw {

constexpr int W_THREADS = 256;  // two warpgroups, no producer warpgroup
constexpr int W_KEYS = 64;      // dK/dV kernel: keys per block (both roles)
constexpr int W_QS = 128;       // dQ kernel: queries per block
constexpr int FEED = 128;       // dK/dV kernel: the thread feeding its ring

// Score-tile widths and ring depths by head dim.
template <int DH> struct Tiles;
template <> struct Tiles<192> {
  static constexpr int KV_QT = 64;  // dK/dV kernel: queries per tile
  static constexpr int KV_ST = 3;   // ... stages of its Q/dO ring
  static constexpr int Q_KT = 64;   // dQ kernel: keys per tile
  static constexpr int Q_ST = 2;    // ... stages of its K/V ring
};
template <> struct Tiles<256> {
  static constexpr int KV_QT = 64;
  static constexpr int KV_ST = 2;
  static constexpr int Q_KT = 32;
  static constexpr int Q_ST = 3;
};
// every lse2 / D row a block reads lies below S_pad
static_assert(wgb::PAD % W_QS == 0 && wgb::PAD % Tiles<192>::KV_QT == 0 &&
                  wgb::PAD % Tiles<256>::KV_QT == 0,
              "PAD");

template <int DH> struct SmemKV {
  static constexpr int QT = Tiles<DH>::KV_QT, ST = Tiles<DH>::KV_ST;
  static constexpr int CH = DH / 64;
  static constexpr int K_CHUNK = W_KEYS * 128;
  static constexpr int K_TILE = CH * K_CHUNK;
  static constexpr int Q_CHUNK = QT * 128;
  static constexpr int Q_TILE = CH * Q_CHUNK;
  static constexpr int ROW = QT * 4;  // one stage's lse2 (or D), bytes
  // one tile's fp32 P^T [* (1 - tanh^2)], handed from the dV warpgroup to
  // the dK one: QT / 2 floats of each of its 128 threads
  static constexpr int HAND = 128 * (QT / 2) * 4;
  static constexpr int OFF_K = 0;     // K | V | Q ring | dO ring | lse2,
  static constexpr int OFF_V = K_TILE;  // D rings | two hand-offs | barriers
  static constexpr int OFF_Q = 2 * K_TILE;
  static constexpr int OFF_DO = OFF_Q + ST * Q_TILE;
  static constexpr int OFF_L = OFF_DO + ST * Q_TILE;
  static constexpr int OFF_D = OFF_L + ST * ROW;
  static constexpr int OFF_P = OFF_D + ST * ROW;
  static constexpr int OFF_BAR = OFF_P + 2 * HAND;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * ST + 4) + 1024;
};

template <int DH> struct SmemQ {
  static constexpr int KT = Tiles<DH>::Q_KT, ST = Tiles<DH>::Q_ST;
  static constexpr int CH = DH / 64;
  static constexpr int Q_CHUNK = W_QS * 128;
  static constexpr int Q_TILE = CH * Q_CHUNK;
  static constexpr int K_CHUNK = KT * 128;
  static constexpr int K_TILE = CH * K_CHUNK;
  static constexpr int OFF_Q = 0;  // Q | dO | K ring | V ring | barriers
  static constexpr int OFF_DO = Q_TILE;
  static constexpr int OFF_K = 2 * Q_TILE;
  static constexpr int OFF_V = OFF_K + ST * K_TILE;
  static constexpr int OFF_BAR = OFF_V + ST * K_TILE;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * ST) + 1024;
};
static_assert(SmemKV<192>::BYTES == 232024 && SmemKV<256>::BYTES == 231496 &&
                  SmemQ<192>::BYTES == 197672 && SmemQ<256>::BYTES == 230456,
              "wide backward layouts");
static_assert(SmemKV<192>::BYTES <= MAX_SMEM &&
                  SmemKV<256>::BYTES <= MAX_SMEM &&
                  SmemQ<192>::BYTES <= MAX_SMEM &&
                  SmemQ<256>::BYTES <= MAX_SMEM,
              "wide backward shared memory");

// A score tile D[64 x N] = X Y^T over DH: both operands K-major from
// 128-byte-swizzled tiles whose 64-column chunks lie `xc` / `yc` bytes
// apart; N (32 or 64) the rows of Y.
__device__ __forceinline__ void ss_step(float (&d)[32], uint64_t da,
                                        uint64_t db, int acc) {
  hopper::wgmma_ss_n64<0>(d, da, db, acc);
}
__device__ __forceinline__ void ss_step(float (&d)[16], uint64_t da,
                                        uint64_t db, int acc) {
  hopper::wgmma_ss_n32<0>(d, da, db, acc);
}
template <int DH, int R>
__device__ __forceinline__ void scores(float (&d)[R], const unsigned char* x,
                                       int xc, const unsigned char* y,
                                       int yc) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ss_step(d, hopper::desc_sw128(x + (kk / 4) * xc + (kk % 4) * 32, 16, 1024),
            hopper::desc_sw128(y + (kk / 4) * yc + (kk % 4) * 32, 16, 1024),
            kk > 0);
}

// Rows r0, r0 + 8 of [a | b] (64 x DH fp32) to `out` (row stride DH),
// rows at or past S not stored.
template <int DH>
__device__ __forceinline__ void store_rows(float* out, int r0, int S,
                                           const float (&a)[64],
                                           const float (&b)[DH / 2 - 64],
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= S) continue;
    float* row = out + static_cast<long long>(r0 + 8 * r) * DH +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(a[4 * j + 2 * r], a[4 * j + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < (DH / 2 - 64) / 4; ++j)
      *reinterpret_cast<float2*>(row + 128 + 8 * j) =
          make_float2(b[4 * j + 2 * r], b[4 * j + 2 * r + 1]);
  }
}

template <int DH>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse2,
                           const float* __restrict__ Dp,
                           float* __restrict__ dk_part,
                           float* __restrict__ dv_part, int H, int KVH, int S,
                           int S_pad, int causal, int window, float softcap,
                           float sm_scale) {
  using L = SmemKV<DH>;
  constexpr int QT = L::QT, ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  uint64_t* p_full = bars + 1 + 2 * ST;  // hand-off b written (dV side)
  uint64_t* p_empty = p_full + 2;        // hand-off b read (dK side)

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);           // GQA: the KV head of this head
  const int k0 = blockIdx.y * W_KEYS;     // the heaviest key tiles go first
  // query tiles that see a key of this tile: from the diagonal (causal) to
  // the last query inside the window of the tile's last key
  const int qt_lo = causal ? k0 / QT : 0;
  const int q_end = window > 0 ? min(S, k0 + W_KEYS - 1 + window) : S;
  const int n_tiles = (q_end + QT - 1) / QT - qt_lo;
  const float* lrow = lse2 + static_cast<long long>(bh) * S_pad;
  const float* drow = Dp + static_cast<long long>(bh) * S_pad;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W_THREADS / 32);  // lane 0 of each warp
    }
    for (int x = 0; x < 2; ++x) {  // every thread of one warpgroup
      hopper::mbar_init(&p_full[x], 128);
      hopper::mbar_init(&p_empty[x], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == FEED) {  // K, V once; the ring's first tiles
    hopper::mbar_expect_tx(kv_full, 2 * L::K_TILE);
    for (int c = 0; c < L::CH; ++c) {
      hopper::tma_load_4d(smem + L::OFF_K + c * L::K_CHUNK, &tk, kv_full,
                          64 * c, k0, hk, b);
      hopper::tma_load_4d(smem + L::OFF_V + c * L::K_CHUNK, &tv, kv_full,
                          64 * c, k0, hk, b);
    }
    for (int i = 0; i < min(ST, n_tiles); ++i)
      wgb::kv_fetch<L>(smem, full, &tq, &tdo, lrow, drow, (qt_lo + i) * QT,
                       i, h, b);
  }

  const int wgi = threadIdx.x / 128;  // 0: dV, 1: dK
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int ka = k0 + (tid / 32) * 16 + lane / 4;  // key rows ka, ka + 8
  const float c2 = sm_scale * wg::LOG2E;
  const float cap_in = softcap > 0.f ? sm_scale / softcap : 0.f;
  const float cap_out = softcap > 0.f ? softcap / sm_scale : 0.f;
  const unsigned char* ks = smem + L::OFF_K;
  const unsigned char* vs = smem + L::OFF_V;

  float xa[64], xb[DH / 2 - 64];  // this warpgroup's dV or dK rows
#pragma unroll
  for (int i = 0; i < 64; ++i) xa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 2 - 64; ++i) xb[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const uint32_t ph = (i / ST) & 1;
    const int q0 = (qt_lo + i) * QT;
    // the dK warpgroup refills the stage of tile i - 1 once the dV
    // warpgroup (ahead or level with it) has released it too
    if (threadIdx.x == FEED && i > 0 && i - 1 + ST < n_tiles) {
      const int sp = (i - 1) % ST;
      hopper::mbar_wait(&empty[sp], ((i - 1) / ST) & 1);
      wgb::kv_fetch<L>(smem, full, &tq, &tdo, lrow, drow,
                       (qt_lo + i - 1 + ST) * QT, sp, h, b);
    }
    __syncwarp();
    const unsigned char* qs = smem + L::OFF_Q + s * L::Q_TILE;
    const unsigned char* dos = smem + L::OFF_DO + s * L::Q_TILE;
    const float* ls =
        reinterpret_cast<const float*>(smem + L::OFF_L + s * L::ROW);
    const float* ds =
        reinterpret_cast<const float*>(smem + L::OFF_D + s * L::ROW);
    // does a mask bite in this tile pair? (a query column past S has
    // lse2 = +inf: P = 0 there without one)
    const bool diag = causal && k0 + W_KEYS - 1 > q0;
    const bool wedge = window > 0 && k0 <= q0 + QT - 1 - window;
    // this tile's hand-off: thread tid's element pair (e0, e0 + 1) at
    // float2 e0 / 2 * 128 + tid (a warp's 32 pairs side by side)
    float2* hand = reinterpret_cast<float2*>(smem + L::OFF_P +
                                             (i & 1) * L::HAND) + tid;
    hopper::mbar_wait(&full[s], ph);
    if (wgi == 0) {
      // ---- S^T, P^T; dV += P^T dO -----------------------------------------
      float st[QT / 2];
      hopper::wgmma_fence();
      scores<DH>(st, ks, L::K_CHUNK, qs, L::Q_CHUNK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      // the dK warpgroup has read tile i - 2's hand-off from this buffer
      if (i >= 2) hopper::mbar_wait(&p_empty[i & 1], ((i >> 1) - 1) & 1);
      uint32_t pa[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // element 8 kk + 2 j + e: key row ka + 8 (j & 1), query column
          // 16 kk + 8 (j >> 1) + 2 (lane & 3) + e of the tile
          const int e0 = 8 * kk + 2 * j;
          const int col = 16 * kk + 8 * (j >> 1) + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          bool ok0 = true, ok1 = true;
          if (diag || wedge) {
            const int qpos = q0 + col, kpos = ka + 8 * (j & 1);
            if (causal) {
              ok0 = kpos <= qpos;
              ok1 = kpos <= qpos + 1;
            }
            if (window > 0) {
              ok0 = ok0 && kpos > qpos - window;
              ok1 = ok1 && kpos > qpos + 1 - window;
            }
          }
          // P and, for the dK warpgroup, P * (1 - tanh^2) (P if uncapped):
          // grad_elem's dS at dP - D = 1
          float p0, p1;
          const float g0 = wgb::grad_elem(st[e0], 1.f, l2.x, 0.f, ok0, c2,
                                          cap_in, cap_out, p0);
          const float g1 = wgb::grad_elem(st[e0 + 1], 1.f, l2.y, 0.f, ok1,
                                          c2, cap_in, cap_out, p1);
          hand[(e0 / 2) * 128] = make_float2(g0, g1);
          pa[kk][j] = wg::pack_bf16(p0, p1);
        }
      }
      hopper::mbar_arrive(&p_full[i & 1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        wg::acc_rows(xa, xb, pa[kk], dos + kk * 16 * 128, L::Q_CHUNK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(xa);
      hopper::fence_regs(xb);
    } else {
      // ---- dP^T; dS^T = P^T (dP^T - D) from the hand-off; dK += dS^T Q ----
      float dpt[QT / 2];
      hopper::wgmma_fence();
      scores<DH>(dpt, vs, L::K_CHUNK, dos, L::Q_CHUNK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpt);
      hopper::mbar_wait(&p_full[i & 1], (i >> 1) & 1);  // tile i's P^T
      uint32_t sa[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e0 = 8 * kk + 2 * j;
          const float2 dd = *reinterpret_cast<const float2*>(
              ds + 16 * kk + 8 * (j >> 1) + 2 * (lane & 3));
          const float2 pg = hand[(e0 / 2) * 128];
          sa[kk][j] = wg::pack_bf16(pg.x * (dpt[e0] - dd.x),
                                    pg.y * (dpt[e0 + 1] - dd.y));
        }
      }
      hopper::mbar_arrive(&p_empty[i & 1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        wg::acc_rows(xa, xb, sa[kk], qs + kk * 16 * 128, L::Q_CHUNK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(xa);
      hopper::fence_regs(xb);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // the stage is free
  }

  // ---- this head's dV or dK (unscaled) rows to the fp32 scratch ---------
  float* part = (wgi == 0 ? dv_part : dk_part) +
                static_cast<long long>(bh) * S * DH;
  store_rows<DH>(part, ka, S, xa, xb, lane);
}

template <int DH>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse2,
                         const float* __restrict__ Dp, bf16* __restrict__ dq,
                         Strides sdq, int H, int KVH, int S, int S_pad,
                         int causal, int window, float softcap,
                         float sm_scale) {
  using L = SmemQ<DH>;
  constexpr int KT = L::KT, ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * W_QS;  // heaviest first
  // key tiles inside the causal / window frontier, as in the forward
  const int kv_hi = causal ? min(S, q0 + W_QS) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / KT;
  const int n_tiles = (kv_hi + KT - 1) / KT - t_lo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W_THREADS / 32);  // lane 0 of each warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q, dO once; the ring's first tiles
    hopper::mbar_expect_tx(q_full, 2 * L::Q_TILE);
    for (int c = 0; c < L::CH; ++c) {
      hopper::tma_load_4d(smem + L::OFF_Q + c * L::Q_CHUNK, &tq, q_full,
                          64 * c, q0, h, b);
      hopper::tma_load_4d(smem + L::OFF_DO + c * L::Q_CHUNK, &tdo, q_full,
                          64 * c, q0, h, b);
    }
    for (int i = 0; i < min(ST, n_tiles); ++i)
      wgb::q_fetch<L>(smem, full, &tk, &tv, (t_lo + i) * KT, i, hk, b);
  }

  const int wgi = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int qw = q0 + 64 * wgi;  // the first of this warpgroup's rows
  const int qa = qw + (tid / 32) * 16 + lane / 4;  // rows qa, qa + 8
  const float c2 = sm_scale * wg::LOG2E;
  const float cap_in = softcap > 0.f ? sm_scale / softcap : 0.f;
  const float cap_out = softcap > 0.f ? softcap / sm_scale : 0.f;
  const unsigned char* qs = smem + L::OFF_Q + wgi * 64 * 128;
  const unsigned char* dos = smem + L::OFF_DO + wgi * 64 * 128;
  const long long row = static_cast<long long>(bh) * S_pad;
  const float l2[2] = {lse2[row + qa], lse2[row + qa + 8]};
  const float dd[2] = {Dp[row + qa], Dp[row + qa + 8]};

  float xa[64], xb[DH / 2 - 64];  // dQ, columns 0-127 | 128 to DH - 1
#pragma unroll
  for (int i = 0; i < 64; ++i) xa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 2 - 64; ++i) xb[i] = 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const uint32_t ph = (i / ST) & 1;
    const int k0 = (t_lo + i) * KT;
    // thread 0 refills the stage of tile i - 1 once both warpgroups are
    // done with it
    if (threadIdx.x == 0 && i > 0 && i - 1 + ST < n_tiles) {
      const int sp = (i - 1) % ST;
      hopper::mbar_wait(&empty[sp], ((i - 1) / ST) & 1);
      wgb::q_fetch<L>(smem, full, &tk, &tv, (t_lo + i - 1 + ST) * KT, sp, hk,
                      b);
    }
    __syncwarp();
    const unsigned char* ks = smem + L::OFF_K + s * L::K_TILE;
    const unsigned char* vs = smem + L::OFF_V + s * L::K_TILE;
    // does any of this warpgroup's 64 rows see a key of the tile?
    const bool live = qw < S && !(causal && k0 > qw + 63) &&
                      !(window > 0 && k0 + KT - 1 <= qw - window);
    hopper::mbar_wait(&full[s], ph);
    if (live) {
      // ---- S = Q K^T, dP = dO V^T into registers -------------------------
      float sc[KT / 2], dp[KT / 2];
      hopper::wgmma_fence();
      scores<DH>(sc, qs, L::Q_CHUNK, ks, L::K_CHUNK);
      scores<DH>(dp, dos, L::Q_CHUNK, vs, L::K_CHUNK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // ---- dS in registers: the A operand of dQ += dS K ------------------
      const bool edge = k0 + KT > S;
      const bool diag = causal && k0 + KT - 1 > qw;
      const bool wedge = window > 0 && k0 <= qw + 63 - window;
      uint32_t sa[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e0 = 8 * kk + 2 * j, r = j & 1;
          const int kpos = k0 + 16 * kk + 8 * (j >> 1) + 2 * (lane & 3);
          bool ok0 = true, ok1 = true;
          if (edge || diag || wedge) {
            const int qpos = qa + 8 * r;
            ok0 = kpos < S;
            ok1 = kpos + 1 < S;
            if (causal) {
              ok0 = ok0 && kpos <= qpos;
              ok1 = ok1 && kpos + 1 <= qpos;
            }
            if (window > 0) {
              ok0 = ok0 && kpos > qpos - window;
              ok1 = ok1 && kpos + 1 > qpos - window;
            }
          }
          float p0, p1;
          const float g0 = wgb::grad_elem(sc[e0], dp[e0], l2[r], dd[r], ok0,
                                          c2, cap_in, cap_out, p0);
          const float g1 = wgb::grad_elem(sc[e0 + 1], dp[e0 + 1], l2[r],
                                          dd[r], ok1, c2, cap_in, cap_out,
                                          p1);
          sa[kk][j] = wg::pack_bf16(g0, g1);
        }
      }

      // ---- dQ += dS K ------------------------------------------------------
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wg::acc_rows(xa, xb, sa[kk], ks + kk * 16 * 128, L::K_CHUNK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(xa);
      hopper::fence_regs(xb);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // K/V stage is free
  }

  // ---- dq = dQ * sm_scale, rows beyond S not stored -----------------------
  const float scale[2] = {sm_scale, sm_scale};
  wg::store_bf16_rows<DH>(dq + b * sdq.b + h * sdq.h, sdq.s, qa, S, xa, xb,
                          scale, lane);
}

// The wgmma route at head dim 192 / 256: wgb's prep, the two wide kernels
// (each map built with its own kernel's box rows), wgb's reduce.
template <int DH>
int launch(const bwd::Args& a, cudaStream_t stream) {
  using KV = SmemKV<DH>;
  using Q = SmemQ<DH>;
  const int S_pad = wgb::pad_rows(a.S);
  float* Dp = a.D;
  float* lse2 = a.D + static_cast<long long>(a.B) * a.H * S_pad;
  auto map = [&](CUtensorMap* m, const void* base, int heads,
                 const Strides& st, int rows) {
    return wgb::map_rows(m, base, DH, a.S, heads, a.B, st, rows);
  };
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  if (!map(&kq, a.q, a.H, a.sq, KV::QT) ||
      !map(&kdo, a.dO, a.H, a.sdo, KV::QT) ||
      !map(&kk, a.k, a.KVH, a.sk, W_KEYS) ||
      !map(&kv, a.v, a.KVH, a.sv, W_KEYS) ||
      !map(&qq, a.q, a.H, a.sq, W_QS) || !map(&qdo, a.dO, a.H, a.sdo, W_QS) ||
      !map(&qk, a.k, a.KVH, a.sk, Q::KT) || !map(&qv, a.v, a.KVH, a.sv, Q::KT))
    return -3;
  constexpr auto kdkdv = flash_bwd_dkdv_wide_kernel<DH>;
  constexpr auto kdq = flash_bwd_dq_wide_kernel<DH>;
  cudaError_t err = hopper::allow_smem<kdkdv>(KV::BYTES);
  if (err == cudaSuccess) err = hopper::allow_smem<kdq>(Q::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = wgb::prep(a, DH, stream);
  if (rc != 0) return rc;
  kdkdv<<<dim3(a.B * a.H, (a.S + W_KEYS - 1) / W_KEYS), W_THREADS, KV::BYTES,
          stream>>>(kq, kk, kv, kdo, lse2, Dp, a.dk_part, a.dv_part, a.H,
                    a.KVH, a.S, S_pad, a.causal, a.window, a.softcap,
                    a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kdq<<<dim3(a.B * a.H, (a.S + W_QS - 1) / W_QS), W_THREADS, Q::BYTES,
        stream>>>(qq, qk, qv, qdo, lse2, Dp, reinterpret_cast<bf16*>(a.dq),
                  a.sdq, a.H, a.KVH, a.S, S_pad, a.causal, a.window,
                  a.softcap, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wgb::reduce(a, DH, stream);
}

}  // namespace wgbw

}  // namespace

// Routes, as kernels/flash_attention/flash_attention.py::route picks them
// by shape (forward and backward alike):
constexpr int ROUTE_FMA = 0;    // fp32: plain FMA loops
constexpr int ROUTE_WMMA = 1;   // bf16 that TMA cannot describe; dh 32
constexpr int ROUTE_WGMMA = 2;  // bf16, TMA-describable: dh 64/128/192/256

// route: one of ROUTE_* (fp32 tensors for FMA, bf16 for the other two).
// q, o: [B, S, H, dh]-strided; k, v: [B, S, KVH, dh]-strided (strides in
// elements, dh contiguous).  lse: null (inference), or [B, H, S] fp32, each
// row's log-sum-exp of its scaled (capped) scores for the backward; o is
// the same either way.  window <= 0 and softcap <= 0 switch those options
// off.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError(), -1 for an unknown route, -2 for
// a head dim it does not take, -3 for a tensor map the driver refuses and
// -4 for tensors the wgmma route cannot take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse_,
    int route, int B, int H, int KVH, int S, int dh, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float softcap, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* lse = reinterpret_cast<float*>(lse_);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh},
      sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
#define FA_ARGS q, k, v, o, lse, B, H, KVH, S, sq, sk, sv, so, causal, window, \
                softcap, sm_scale
  if (route == ROUTE_FMA) {
    if (dh == 32) return launch<float, 32, 32, 32>(FA_ARGS, 0, s);
    if (dh == 64) return launch<float, 64, 32, 32>(FA_ARGS, 0, s);
    if (dh == 128) return launch<float, 128, 32, 32>(FA_ARGS, 0, s);
    if (dh == 192) return launch<float, 192, 32, 32>(FA_ARGS, 0, s);
    if (dh == 256) return launch<float, 256, 32, 32>(FA_ARGS, 0, s);
    return -2;
  }
  if (route == ROUTE_WMMA || route == ROUTE_WGMMA) {
    // TMA takes 16-byte-aligned bases and strides that are multiples of 16
    // bytes; the same test lets the wmma kernel copy rows 16 bytes at a time
    auto mult8 = [](const Strides& t) {
      return t.b % 8 == 0 && t.s % 8 == 0 && t.h % 8 == 0;
    };
    const bool aligned =
        reinterpret_cast<size_t>(q) % 16 == 0 &&
        reinterpret_cast<size_t>(k) % 16 == 0 &&
        reinterpret_cast<size_t>(v) % 16 == 0 && mult8(sq) && mult8(sk) &&
        mult8(sv);
    if (route == ROUTE_WGMMA) {
      if (!aligned) return -4;
      if (dh == 64) return wg::launch<64>(FA_ARGS, s);
      if (dh == 128) return wg::launch<128>(FA_ARGS, s);
      if (dh == 192) return wg::launch<192>(FA_ARGS, s);
      if (dh == 256) return wg::launch<256>(FA_ARGS, s);
      return -4;
    }
    const int vec_ok = aligned ? 1 : 0;
    if (dh == 32) return launch<bf16, 32, 64, 64>(FA_ARGS, vec_ok, s);
    if (dh == 64) return launch<bf16, 64, 64, 64>(FA_ARGS, vec_ok, s);
    if (dh == 128) return launch<bf16, 128, 64, 64>(FA_ARGS, vec_ok, s);
    if (dh == 192) return launch<bf16, 192, 64, 64>(FA_ARGS, vec_ok, s);
    if (dh == 256) return launch<bf16, 256, 64, 64>(FA_ARGS, vec_ok, s);
    return -2;
  }
#undef FA_ARGS
  return -1;
}

// The backward of flash_attention_launch.  route: ROUTE_FMA (fp32),
// ROUTE_WMMA (bf16) or ROUTE_WGMMA (bf16, head dim 64, 128, 192 or 256,
// q, k, v, dO TMA-describable).  q, o, dO: [B, S, H, dh]-strided; k, v:
// [B, S, KVH, dh]-strided; lse: [B, H, S] fp32 from the forward.  Writes
// dq [B, S, H, dh], dk, dv [B, S, KVH, dh] (strided as given, the inputs'
// type) through scratch the caller allocates: D, 2 * B * H * S_pad fp32
// with S_pad = S rounded up to a multiple of 384 (the fma and wmma routes
// use its first B * H * S as [B, H, S]; the wgmma route its two halves as
// the padded D and lse2 rows), and dk_part, dv_part [B, H, S, dh] fp32.
// Four launches on `stream`, no atomics, no synchronisation; returns
// cudaGetLastError(), -1 for an unknown route, -2 for a head dim it does
// not take, -3 for a tensor map that cannot be encoded and -4 for tensors
// the wgmma route cannot take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv, void* D,
    void* dk_part, void* dv_part, int route, int B, int H, int KVH, int S,
    int dh, const long long* strides, int causal, int window, float softcap,
    float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // strides: (batch, position, head) of q, k, v, o, dO, dq, dk, dv in turn
  auto st = [&](int i) {
    return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  bwd::Args a{q, k, v, o, dO, reinterpret_cast<const float*>(lse), dq, dk,
              dv, reinterpret_cast<float*>(D),
              reinterpret_cast<float*>(dk_part),
              reinterpret_cast<float*>(dv_part), B, H, KVH, S, st(0), st(1),
              st(2), st(3), st(4), st(5), st(6), st(7), causal, window,
              softcap, sm_scale, 0};
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (route == ROUTE_FMA) {
    if (dh == 32) return bwd::launch<float, 32, 32, 32>(a, s);
    if (dh == 64) return bwd::launch<float, 64, 32, 32>(a, s);
    if (dh == 128) return bwd::launch<float, 128, 32, 32>(a, s);
    if (dh == 192) return bwd::launch<float, 192, 32, 32>(a, s);
    if (dh == 256) return bwd::launch<float, 256, 32, 32>(a, s);
    return -2;
  }
  auto mult8 = [](const Strides& t) {
    return t.b % 8 == 0 && t.s % 8 == 0 && t.h % 8 == 0;
  };
  auto aligned = [&](int i) {  // 16-byte base, strides of 16 bytes
    const void* ptrs[5] = {q, k, v, o, dO};
    return reinterpret_cast<size_t>(ptrs[i]) % 16 == 0 && mult8(st(i));
  };
  if (route == ROUTE_WGMMA) {  // TMA reads q, k, v and dO
    if (!(aligned(0) && aligned(1) && aligned(2) && aligned(4))) return -4;
    if (dh == 64) return wgb::launch<64>(a, s);
    if (dh == 128) return wgb::launch<128>(a, s);
    if (dh == 192) return wgbw::launch<192>(a, s);
    if (dh == 256) return wgbw::launch<256>(a, s);
    return -4;
  }
  if (route == ROUTE_WMMA) {
    bool vec = true;
    for (int i = 0; i < 5; ++i) vec = vec && aligned(i);
    a.vec_ok = vec ? 1 : 0;
    if (dh == 32) return bwd::launch<bf16, 32, 64, 64>(a, s);
    if (dh == 64) return bwd::launch<bf16, 64, 64, 64>(a, s);
    if (dh == 128) return bwd::launch<bf16, 128, 64, 64>(a, s);
    if (dh == 192) return bwd::launch<bf16, 192, 32, 32>(a, s);
    if (dh == 256) return bwd::launch<bf16, 256, 32, 32>(a, s);
    return -2;
  }
  return -1;
}
