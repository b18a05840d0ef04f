// Blocked online-softmax attention for Hopper (prefill hot spot).
//
//   o = softmax(q k^T / sqrt(dh) [softcap] + mask) v
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py::flash_attention (`_kernel`, pl.pallas_call at line 97).
// Same function: causal and sliding-window masks (kpos > qpos - window),
// optional softcap (tanh(s / cap) * cap), NEG_INF = -1e30 for masked scores,
// fp32 running (m, l, acc), final acc / max(l, 1e-30), key tiles wholly
// outside the causal/window frontier never visited.
//
// What bounds it on an H100: 4 * B * H * S^2 * dh / 2 operations (causal)
// against B * (2 H + 2 KVH) * S * dh elements moved -- for S beyond a few
// hundred the tensor cores are the bound, not the memory.  What the design
// does about it: the [S, S] score matrix never leaves the SM (one block per
// (batch*head, 64-query tile), scores, probabilities and the fp32 output
// accumulator live in shared memory); bf16 inputs run both products on the
// tensor cores (wmma 16x16x16, fp32 accumulate); fp32 inputs run them as
// plain fp32 FMA loops.  The TPU's sequential key-block grid axis becomes the
// loop over key tiles inside the block.  KV heads are indexed h / (H / KVH)
// in the kernel, so the head-expanded K and V are never written, and q, k, v
// and o are addressed through (batch, position, head) strides, so the model
// layout [B, S, H, dh] needs no transpose.  A sequence length that is not a
// multiple of the tile is masked, not rounded to a divisor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KVH, int S, Strides sq, Strides sk, Strides sv,
                       Strides so, int causal, int window, float softcap,
                       float sm_scale, int vec_ok) {
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
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int S, Strides sq, Strides sk, Strides sv, Strides so,
           int causal, int window, float softcap, float sm_scale, int vec_ok,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DH, BQ, BKV>;
  constexpr size_t bytes = Layout<T, DH, BQ, BKV>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, bytes, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), reinterpret_cast<T*>(o), H, KVH, S, sq,
      sk, sv, so, causal, window, softcap, sm_scale, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, o: [B, S, H, dh]-strided; k, v:
// [B, S, KVH, dh]-strided (strides in elements, dh contiguous).  window <= 0
// and softcap <= 0 switch those options off.  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError(), -1 for a dtype
// and -2 for a head dim it does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KVH, int S, int dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float softcap,
    float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh},
      sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
#define FA_ARGS q, k, v, o, B, H, KVH, S, sq, sk, sv, so, causal, window, \
                softcap, sm_scale
  if (dtype == 0) {
    if (dh == 32) return launch<float, 32, 32, 32>(FA_ARGS, 0, s);
    if (dh == 64) return launch<float, 64, 32, 32>(FA_ARGS, 0, s);
    if (dh == 128) return launch<float, 128, 32, 32>(FA_ARGS, 0, s);
    return -2;
  }
  if (dtype == 1) {
    auto mult8 = [](const Strides& t) {
      return t.b % 8 == 0 && t.s % 8 == 0 && t.h % 8 == 0;
    };
    const int vec_ok =
        (reinterpret_cast<size_t>(q) % 16 == 0 &&
         reinterpret_cast<size_t>(k) % 16 == 0 &&
         reinterpret_cast<size_t>(v) % 16 == 0 && mult8(sq) && mult8(sk) &&
         mult8(sv))
            ? 1
            : 0;
    if (dh == 32) return launch<bf16, 32, 64, 64>(FA_ARGS, vec_ok, s);
    if (dh == 64) return launch<bf16, 64, 64, 64>(FA_ARGS, vec_ok, s);
    if (dh == 128) return launch<bf16, 128, 64, 64>(FA_ARGS, vec_ok, s);
    return -2;
  }
#undef FA_ARGS
  return -1;
}
