// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:_bwd_dq_kernel
// and _bwd_dkv_kernel (launched by _bwd). Both recompute the scores of a
// (q tile, kv tile) pair from q, k, the forward's lse and
// delta = rowsum(do * o) (computed by the caller):
//   p = exp(s - lse) under the mask, dp = do v^T, ds = p (dp - delta)
//   (times 1 - tanh^2 under softcap), dq = scale ds k, dk = scale ds^T q,
//   dv = p^T do.
// Masking is by per-row positions (q_pos (Bq, Sq), kv_pos (Bk, Sk), Bq/Bk in
// {1, B}), as in the forward kernel, so the gradients are exact for any
// positions. A tile pair whose position ranges cannot meet under the causal
// mask or the window is skipped before its operands are read.
//
// What bounds them on this card: at the training path's shape (B 32, S 128,
// Dh 64) a pair of tiles does ~S/2 multiply-adds per byte it reads, above the
// bytes bound but far below the tensor cores' rate; like the forward, this
// first version computes in f32 on the CUDA cores (no wgmma, no TMA), so its
// time sits far above the bound. What the design does about it: every tile
// staged in shared memory serves a 64-row tile, scores and probabilities
// never leave the SM, and each gradient is written once.
//
// dk/dv: one block owns a kv tile of one kv head and walks the q tiles of all
// G q-heads of its group in a fixed order, so dk and dv come out summed over
// the group inside the kernel, with no atomics: two runs give the same bits.
// (The TPU kernel wrote one dk/dv per q-head and summed the G of a group
// afterwards.) Outputs are cast to k's dtype.
#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // kv rows per tile
constexpr int NT = 128;   // threads: two per tile row
constexpr int HQ = BQ / 2;
constexpr int HK = BK / 2;

// Loads a (rows x DH) tile of a (B, S, NH, DH) tensor, head `head`, rows
// [s0, s0 + n) into smem with row stride DH + 1; rows past n are zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int s0, int n, int S, int NH,
                                          int head, int rows) {
  for (int f = threadIdx.x; f < rows * DH; f += NT) {
    const int r = f / DH, d = f % DH;
    dst[r * (DH + 1) + d] =
        r < n ? to_f32(src[(((size_t)b * S + s0 + r) * NH + head) * DH + d]) : 0.f;
  }
}

// (min, max) of n positions in smem, the same in every thread.
__device__ __forceinline__ void pos_range(const int* p, int n, int* lo, int* hi) {
  int a = INT_MAX, z = INT_MIN;
  for (int i = 0; i < n; ++i) {
    a = min(a, p[i]);
    z = max(z, p[i]);
  }
  *lo = a;
  *hi = z;
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (DH + 1) + 2 * BK * (DH + 1) + BQ * (BK + 1) + 2 * BQ) +
         sizeof(int) * (BK + BQ);
}

// One block per (q tile, q head, batch row); walks the kv tiles.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, T* __restrict__ dq, int Sq, int Sk, int H,
    int KH, int qpos_bstride, int kvpos_bstride, float scale, int causal,
    int window, float softcap) {
  constexpr int HD = DH / 2;   // dq columns per thread (d = 2*i + half)
  extern __shared__ float smem[];
  float* q_s = smem;                      // BQ x (DH+1)
  float* do_s = q_s + BQ * (DH + 1);      // BQ x (DH+1)
  float* k_s = do_s + BQ * (DH + 1);      // BK x (DH+1)
  float* v_s = k_s + BK * (DH + 1);       // BK x (DH+1)
  float* ds_s = v_s + BK * (DH + 1);      // BQ x (BK+1)
  float* lse_s = ds_s + BQ * (BK + 1);    // BQ
  float* dl_s = lse_s + BQ;               // BQ
  int* kp_s = reinterpret_cast<int*>(dl_s + BQ);   // BK
  int* qp_s = kp_s + BK;                           // BQ

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int row = tid >> 1;
  const int half = tid & 1;
  const int nq = min(BQ, Sq - q0);

  load_tile<T, DH>(q_s, q, b, q0, nq, Sq, H, h, BQ);
  load_tile<T, DH>(do_s, dout, b, q0, nq, Sq, H, h, BQ);
  for (int r = tid; r < BQ; r += NT) {
    const bool ok = r < nq;
    const size_t stat = ((size_t)b * H + h) * Sq + q0 + r;
    qp_s[r] = ok ? qpos[(size_t)b * qpos_bstride + q0 + r] : 0;
    lse_s[r] = ok ? lse[stat] : 0.f;
    dl_s[r] = ok ? delta[stat] : 0.f;
  }
  __syncthreads();
  int qmin, qmax;
  pos_range(qp_s, nq, &qmin, &qmax);
  const bool row_ok = row < nq;
  const int qp = qp_s[row];
  const float lse_r = lse_s[row];
  const float dl_r = dl_s[row];

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    for (int j = tid; j < BK; j += NT)
      kp_s[j] = j < nk ? kvpos[(size_t)b * kvpos_bstride + k0 + j] : 0;
    __syncthreads();
    int kmin, kmax;
    pos_range(kp_s, nk, &kmin, &kmax);
    if ((causal && kmin > qmax) || (window > 0 && kmax <= qmin - window)) {
      __syncthreads();
      continue;
    }
    load_tile<T, DH>(k_s, k, b, k0, nk, Sk, KH, kh, BK);
    load_tile<T, DH>(v_s, v, b, k0, nk, Sk, KH, kh, BK);
    __syncthreads();

    // scores and dp of this thread's row against columns j = 2*jj + half
    float sc[HK], dp[HK];
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) sc[jj] = dp[jj] = 0.f;
    const float* qrow = q_s + row * (DH + 1);
    const float* dorow = do_s + row * (DH + 1);
    const float* kcol = k_s + half * (DH + 1);
    const float* vcol = v_s + half * (DH + 1);
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qrow[d], dd = dorow[d];
#pragma unroll
      for (int jj = 0; jj < HK; ++jj) {
        sc[jj] += qd * kcol[2 * jj * (DH + 1) + d];
        dp[jj] += dd * vcol[2 * jj * (DH + 1) + d];
      }
    }
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) {
      const int j = 2 * jj + half;
      float s = sc[jj] * scale, dcap = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(s / softcap);
        s = t * softcap;
        dcap = 1.f - t * t;
      }
      const bool ok = row_ok && j < nk && visible(qp, kp_s[j], causal, window);
      const float p = ok ? expf(s - lse_r) : 0.f;
      ds_s[row * (BK + 1) + j] = p * (dp[jj] - dl_r) * dcap;
    }
    __syncthreads();

    const float* dsrow = ds_s + row * (BK + 1);
    const float* kc = k_s + half;
    for (int j = 0; j < nk; ++j) {
      const float w = dsrow[j];
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] += w * kc[j * (DH + 1) + 2 * i];
    }
    __syncthreads();
  }

  if (row_ok) {
    T* out = dq + (((size_t)b * Sq + q0 + row) * H + h) * DH + half;
#pragma unroll
    for (int i = 0; i < HD; ++i) out[2 * i] = from_f32<T>(acc[i] * scale);
  }
}

template <int DH>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * BK * (DH + 1) + 2 * BQ * (DH + 1) + 2 * BK * (BQ + 1) + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

// One block per (kv tile, kv head, batch row); walks the q tiles of every
// q head of the group, heads in order.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int H, int KH, int qpos_bstride, int kvpos_bstride,
    float scale, int causal, int window, float softcap) {
  constexpr int HD = DH / 2;   // dk/dv columns per thread (d = 2*c + half)
  extern __shared__ float smem[];
  float* k_s = smem;                      // BK x (DH+1)
  float* v_s = k_s + BK * (DH + 1);       // BK x (DH+1)
  float* q_s = v_s + BK * (DH + 1);       // BQ x (DH+1)
  float* do_s = q_s + BQ * (DH + 1);      // BQ x (DH+1)
  float* p_s = do_s + BQ * (DH + 1);      // BK x (BQ+1)
  float* ds_s = p_s + BK * (BQ + 1);      // BK x (BQ+1)
  float* lse_s = ds_s + BK * (BQ + 1);    // BQ
  float* dl_s = lse_s + BQ;               // BQ
  int* qp_s = reinterpret_cast<int*>(dl_s + BQ);   // BQ
  int* kp_s = qp_s + BQ;                           // BK

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int row = tid >> 1;   // kv row of this thread
  const int half = tid & 1;
  const int nk = min(BK, Sk - k0);

  load_tile<T, DH>(k_s, k, b, k0, nk, Sk, KH, kh, BK);
  load_tile<T, DH>(v_s, v, b, k0, nk, Sk, KH, kh, BK);
  for (int j = tid; j < BK; j += NT)
    kp_s[j] = j < nk ? kvpos[(size_t)b * kvpos_bstride + k0 + j] : 0;
  __syncthreads();
  int kmin, kmax;
  pos_range(kp_s, nk, &kmin, &kmax);
  const bool row_ok = row < nk;
  const int kp = kp_s[row];

  float acc_dk[HD], acc_dv[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc_dk[c] = acc_dv[c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      const int nq = min(BQ, Sq - q0);
      for (int r = tid; r < BQ; r += NT) {
        const bool ok = r < nq;
        const size_t stat = ((size_t)b * H + h) * Sq + q0 + r;
        qp_s[r] = ok ? qpos[(size_t)b * qpos_bstride + q0 + r] : 0;
        lse_s[r] = ok ? lse[stat] : 0.f;
        dl_s[r] = ok ? delta[stat] : 0.f;
      }
      __syncthreads();
      int qmin, qmax;
      pos_range(qp_s, nq, &qmin, &qmax);
      if ((causal && kmin > qmax) || (window > 0 && kmax <= qmin - window)) {
        __syncthreads();
        continue;
      }
      load_tile<T, DH>(q_s, q, b, q0, nq, Sq, H, h, BQ);
      load_tile<T, DH>(do_s, dout, b, q0, nq, Sq, H, h, BQ);
      __syncthreads();

      // scores and dp of this thread's kv row against q rows i = 2*ii + half
      float sc[HQ], dp[HQ];
#pragma unroll
      for (int ii = 0; ii < HQ; ++ii) sc[ii] = dp[ii] = 0.f;
      const float* krow = k_s + row * (DH + 1);
      const float* vrow = v_s + row * (DH + 1);
      const float* qcol = q_s + half * (DH + 1);
      const float* docol = do_s + half * (DH + 1);
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int ii = 0; ii < HQ; ++ii) {
          sc[ii] += qcol[2 * ii * (DH + 1) + d] * kd;
          dp[ii] += docol[2 * ii * (DH + 1) + d] * vd;
        }
      }
#pragma unroll
      for (int ii = 0; ii < HQ; ++ii) {
        const int i = 2 * ii + half;
        float s = sc[ii] * scale, dcap = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(s / softcap);
          s = t * softcap;
          dcap = 1.f - t * t;
        }
        const bool ok = row_ok && i < nq && visible(qp_s[i], kp, causal, window);
        const float p = ok ? expf(s - lse_s[i]) : 0.f;
        p_s[row * (BQ + 1) + i] = p;
        ds_s[row * (BQ + 1) + i] = p * (dp[ii] - dl_s[i]) * dcap;
      }
      __syncthreads();

      const float* prow = p_s + row * (BQ + 1);
      const float* dsrow = ds_s + row * (BQ + 1);
      const float* doc = do_s + half;
      const float* qc = q_s + half;
      for (int i = 0; i < nq; ++i) {
        const float pw = prow[i], dw = dsrow[i];
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          acc_dv[c] += pw * doc[i * (DH + 1) + 2 * c];
          acc_dk[c] += dw * qc[i * (DH + 1) + 2 * c];
        }
      }
      __syncthreads();
    }
  }

  if (row_ok) {
    const size_t off = (((size_t)b * Sk + k0 + row) * KH + kh) * DH + half;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dk[off + 2 * c] = from_f32<T>(acc_dk[c] * scale);
      dv[off + 2 * c] = from_f32<T>(acc_dv[c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *qpos, *kvpos;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KH, qb, kb;
  float scale;
  int causal, window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, DH><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kvpos), static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.KH,
      a.qb, a.kb, a.scale, a.causal, a.window, a.softcap);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + BK - 1) / BK, a.KH, a.B);
  flash_bwd_dkv_kernel<T, DH><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kvpos), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.Sq, a.Sk, a.H, a.KH, a.qb, a.kb, a.scale, a.causal, a.window, a.softcap);
  return (int)cudaGetLastError();
}

template <bool DKV, typename T>
int dispatch_dh(int DH, const Args& a) {
  switch (DH) {
    case 16: return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return -1;
  }
}

template <bool DKV>
int dispatch(int DH, int dtype, const Args& a) {
  if (dtype == DT_F32) return dispatch_dh<DKV, float>(DH, a);
  if (dtype == DT_BF16) return dispatch_dh<DKV, __nv_bfloat16>(DH, a);
  return -1;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success), or -1 for a
// head dim / dtype the kernels do not take. q, dout, dq: (B, Sq, H, DH);
// k, v, dk, dv: (B, Sk, KH, DH); lse, delta: (B, H, Sq) f32.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* qpos,
                                      const void* kvpos, void* dq, int B, int Sq,
                                      int Sk, int H, int KH, int DH, int dtype,
                                      int qpos_bstride, int kvpos_bstride,
                                      float scale, int causal, int window,
                                      float softcap, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qpos, kvpos, dq, nullptr, nullptr,
               B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal,
               window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(DH, dtype, a);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* qpos,
                                       const void* kvpos, void* dk, void* dv, int B,
                                       int Sq, int Sk, int H, int KH, int DH,
                                       int dtype, int qpos_bstride,
                                       int kvpos_bstride, float scale, int causal,
                                       int window, float softcap, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qpos, kvpos, nullptr, dk, dv,
               B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal,
               window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(DH, dtype, a);
}
