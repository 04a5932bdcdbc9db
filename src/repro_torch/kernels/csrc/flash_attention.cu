// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_kernel
// (launched by _fwd, entry flash_attention): online softmax over KV tiles,
// optional local window and tanh softcap, q-head h reads kv-head h // G.
// Returns o (B, Sq, H, Dh) in q's dtype and lse (B, H, Sq) in f32; a fully
// masked row gives o = 0 and lse = -1e30.
//
// What bounds it on this card: at the prefill shapes of the serving path
// (Dh = 64, P up to 1024) attention does ~P/2 multiply-adds per byte of q/k/v,
// far above the H100's ~295 FLOP/byte ridge, so it is bound by arithmetic.
// This first kernel computes in f32 on the CUDA cores (no tensor cores, no
// TMA): it is right and simple, and its time sits far above the bf16
// tensor-core bound. What the design does about the bound: one block owns a
// 64-row q tile, so every K/V tile it stages in shared memory serves 64 rows;
// tiles wholly above the causal diagonal (or below the window) are skipped
// before their K/V is read, which halves the work of causal prefill; scores
// and probabilities never leave the SM. wgmma + TMA are a later PR's work.
//
// Positions are per row (q_pos (Bq, Sq), kv_pos (Bk, Sk), Bq/Bk in {1, B}),
// so the kernel is exact for any positions, not only uniform ones. The skip
// test reads each tile's position range (64 ints) instead of assuming
// uniform positions; for uniform causal prefill it leaves exactly the tiles
// on or below the diagonal to compute.
#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // kv rows per shared-memory tile
constexpr int NT = 128;   // threads: two per q row
constexpr int HK = BK / 2;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1)) +
         sizeof(int) * (BK + BQ + 2);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kvpos,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KH,
    int qpos_bstride, int kvpos_bstride, float scale, int causal, int window,
    float softcap) {
  constexpr int HD = DH / 2;   // output columns per thread (d = 2*i + half)
  extern __shared__ float smem[];
  float* q_s = smem;                          // BQ x (DH+1)
  float* k_s = q_s + BQ * (DH + 1);           // BK x (DH+1)
  float* v_s = k_s + BK * (DH + 1);           // BK x DH
  float* p_s = v_s + BK * DH;                 // BQ x (BK+1)
  int* kp_s = reinterpret_cast<int*>(p_s + BQ * (BK + 1));   // BK
  int* qp_s = kp_s + BK;                                     // BQ
  int* range_s = qp_s + BQ;                                  // qmin, qmax

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int row = tid >> 1;
  const int half = tid & 1;

  for (int f = tid; f < BQ * DH; f += NT) {
    const int r = f / DH, d = f % DH, s = q0 + r;
    q_s[r * (DH + 1) + d] =
        s < Sq ? to_f32(q[(((size_t)b * Sq + s) * H + h) * DH + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT)
    qp_s[r] = q0 + r < Sq ? qpos[(size_t)b * qpos_bstride + q0 + r] : 0;
  __syncthreads();
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = 0; r < BQ && q0 + r < Sq; ++r) {
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    range_s[0] = lo;
    range_s[1] = hi;
  }
  __syncthreads();
  const int qmin = range_s[0], qmax = range_s[1];
  const bool row_ok = q0 + row < Sq;
  const int qp = qp_s[row];

  float m = NEG_INF_F, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    for (int j = tid; j < BK; j += NT)
      kp_s[j] = j < nk ? kvpos[(size_t)b * kvpos_bstride + k0 + j] : 0;
    __syncthreads();
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int j = 0; j < nk; ++j) {
      kmin = min(kmin, kp_s[j]);
      kmax = max(kmax, kp_s[j]);
    }
    // every thread reaches the same verdict: the tile holds no key any row
    // of this q tile may see, so its K/V is never read
    if ((causal && kmin > qmax) || (window > 0 && kmax <= qmin - window)) {
      __syncthreads();
      continue;
    }
    for (int f = tid; f < BK * DH; f += NT) {
      const int j = f / DH, d = f % DH;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = (((size_t)b * Sk + k0 + j) * KH + kh) * DH + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[j * (DH + 1) + d] = kv;
      v_s[j * DH + d] = vv;
    }
    __syncthreads();

    // scores of this thread's row against columns j = 2*jj + half (the two
    // threads of a row interleave, so their shared-memory reads hit
    // different banks)
    float sc[HK];
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) sc[jj] = 0.f;
    const float* qrow = q_s + row * (DH + 1);
    const float* kcol = k_s + half * (DH + 1);
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int jj = 0; jj < HK; ++jj) sc[jj] += qd * kcol[2 * jj * (DH + 1) + d];
    }
    unsigned valid = 0u;
    float tmax = NEG_INF_F;
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) {
      const int j = 2 * jj + half;
      float s = sc[jj] * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int kp = kp_s[j];
      const bool ok = row_ok && j < nk && (!causal || kp <= qp) &&
                      (window <= 0 || kp > qp - window);
      sc[jj] = ok ? s : NEG_INF_F;
      valid |= (ok ? 1u : 0u) << jj;
      tmax = fmaxf(tmax, sc[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) {
      const float p = (valid >> jj) & 1u ? expf(sc[jj] - m_new) : 0.f;
      p_s[row * (BK + 1) + 2 * jj + half] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] *= corr;
    const float* prow = p_s + row * (BK + 1);
    const float* vcol = v_s + half;
    for (int j = 0; j < nk; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] += p * vcol[j * DH + 2 * i];
    }
    __syncthreads();
  }

  if (row_ok) {
    const float safe_l = l > 0.f ? l : 1.f;
    T* orow = o + (((size_t)b * Sq + q0 + row) * H + h) * DH + half;
#pragma unroll
    for (int i = 0; i < HD; ++i) orow[2 * i] = from_f32<T>(acc[i] / safe_l);
    if (half == 0)
      lse[((size_t)b * H + h) * Sq + q0 + row] = l > 0.f ? m + logf(l) : NEG_INF_F;
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kvpos, void* o, float* lse, int B, int Sq, int Sk, int H,
           int KH, int qpos_bstride, int kvpos_bstride, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      qpos, kvpos, static_cast<T*>(o), lse, Sq, Sk, H, KH, qpos_bstride,
      kvpos_bstride, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int DH, const void* q, const void* k, const void* v, const int* qpos,
                const int* kvpos, void* o, float* lse, int B, int Sq, int Sk, int H,
                int KH, int qb, int kb, float scale, int causal, int window,
                float softcap, cudaStream_t s) {
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, qpos, kvpos, o, lse, B, Sq, Sk, H, KH, qb, kb, scale, causal, window, softcap, s);
    case 32: return launch<T, 32>(q, k, v, qpos, kvpos, o, lse, B, Sq, Sk, H, KH, qb, kb, scale, causal, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, qpos, kvpos, o, lse, B, Sq, Sk, H, KH, qb, kb, scale, causal, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, qpos, kvpos, o, lse, B, Sq, Sk, H, KH, qb, kb, scale, causal, window, softcap, s);
    default: return -1;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// head dim / dtype the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kvpos, void* o,
                                   void* lse, int B, int Sq, int Sk, int H, int KH,
                                   int DH, int dtype, int qpos_bstride,
                                   int kvpos_bstride, float scale, int causal,
                                   int window, float softcap, void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_dh<float>(DH, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH, qpos_bstride,
                              kvpos_bstride, scale, causal, window, softcap, s);
  if (dtype == DT_BF16)
    return dispatch_dh<__nv_bfloat16>(DH, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH,
                                      qpos_bstride, kvpos_bstride, scale, causal,
                                      window, softcap, s);
  return -1;
}
