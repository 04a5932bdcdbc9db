// Single-query GQA decode attention against a dense slot KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_kernel
// (entry decode_attention): every slot attends its one new query against its
// cache row, with per-slot positions and live bits. KV positions above the
// slot's position (or at/below position - window) are never read; a dead
// slot writes exact zeros.
//
// What bounds it on this card: one decode tick reads each live slot's K/V
// prefix once and does 4 * Dh FLOPs per (head, position), i.e. about G / 2
// FLOPs per byte of bf16 cache -- far below the ~295 FLOP/byte ridge, so it
// is bound by memory. What the design does about that: one block per
// (slot, kv head) stages each K/V tile in shared memory once and all G query
// heads of the group (any G, not only powers of two) read it there, so the
// cache is streamed exactly once per tick and never repeated per q-head; the
// walk starts at the window floor and stops at the slot's position. With
// 16 slots x 3 kv heads the grid is 48 blocks, fewer than the 132 SMs, so
// the simple kernel cannot reach the card's bandwidth; splitting the KV
// walk across blocks (flash-decoding) is a later PR's work.
//
// The online softmax is f32; every sum runs in a fixed order and there are
// no atomics, so repeated runs give identical bits.
#include "common.cuh"

namespace {

constexpr int TK = 64;    // kv positions per shared-memory tile
constexpr int NT = 128;
constexpr int NW = NT / 32;

template <int DH>
size_t smem_bytes(int G) {
  return sizeof(float) * (2 * G * DH + TK * (DH + 1) + TK * DH + G * TK + 3 * G);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ pos, const uint8_t* __restrict__ live,
    T* __restrict__ o, int Smax, int H, int KH, float scale, int window,
    float softcap) {
  extern __shared__ float smem[];
  const int G = H / KH;
  float* q_s = smem;                 // G x DH
  float* acc_s = q_s + G * DH;       // G x DH
  float* k_s = acc_s + G * DH;       // TK x (DH+1)
  float* v_s = k_s + TK * (DH + 1);  // TK x DH
  float* s_s = v_s + TK * DH;        // G x TK
  float* m_s = s_s + G * TK;         // G
  float* l_s = m_s + G;              // G
  float* c_s = l_s + G;              // G

  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // q and o are (B, 1, H, DH): the group's G heads are contiguous
  const size_t base = ((size_t)b * H + (size_t)kh * G) * DH;
  const int p = pos[b];
  const int hi = min(p, Smax - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  if ((live != nullptr && live[b] == 0) || hi < lo) {
    for (int f = tid; f < G * DH; f += NT) o[base + f] = from_f32<T>(0.f);
    return;
  }
  for (int f = tid; f < G * DH; f += NT) {
    q_s[f] = to_f32(q[base + f]);
    acc_s[f] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF_F;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = lo; t0 <= hi; t0 += TK) {
    const int n = min(TK, hi - t0 + 1);
    for (int f = tid; f < TK * DH; f += NT) {
      const int j = f / DH, d = f % DH;
      float kv = 0.f, vv = 0.f;
      if (j < n) {
        const size_t off = (((size_t)b * Smax + t0 + j) * KH + kh) * DH + d;
        kv = to_f32(kc[off]);
        vv = to_f32(vc[off]);
      }
      k_s[j * (DH + 1) + d] = kv;
      v_s[j * DH + d] = vv;
    }
    __syncthreads();
    for (int f = tid; f < G * TK; f += NT) {
      const int g = f / TK, j = f % TK;
      float s = NEG_INF_F;
      if (j < n) {
        const float* qg = q_s + g * DH;
        const float* kj = k_s + j * (DH + 1);
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) a += qg[d] * kj[d];
        s = a * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      }
      s_s[f] = s;
    }
    __syncthreads();
    // every position in [t0, t0 + n) is valid, so the tile max is finite
    for (int g = warp; g < G; g += NW) {
      float mx = NEG_INF_F;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[g * TK + j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float e = j < n ? expf(s_s[g * TK + j] - m_new) : 0.f;
        s_s[g * TK + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int f = tid; f < G * DH; f += NT) {
      const int g = f / DH, d = f % DH;
      const float* pg = s_s + g * TK;
      float a = acc_s[f] * c_s[g];
      for (int j = 0; j < n; ++j) a += pg[j] * v_s[j * DH + d];
      acc_s[f] = a;
    }
    __syncthreads();
  }
  for (int f = tid; f < G * DH; f += NT) {
    const float l = l_s[f / DH];
    o[base + f] = from_f32<T>(acc_s[f] / (l > 0.f ? l : 1.f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const uint8_t* live, void* o, int B, int Smax, int H, int KH,
           float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(H / KH);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KH, B);
  decode_attn_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, live, static_cast<T*>(o), Smax, H, KH, scale, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int DH, const void* q, const void* k, const void* v, const int* pos,
                const uint8_t* live, void* o, int B, int Smax, int H, int KH,
                float scale, int window, float softcap, cudaStream_t s) {
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, pos, live, o, B, Smax, H, KH, scale, window, softcap, s);
    case 32: return launch<T, 32>(q, k, v, pos, live, o, B, Smax, H, KH, scale, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, pos, live, o, B, Smax, H, KH, scale, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, pos, live, o, B, Smax, H, KH, scale, window, softcap, s);
    default: return -1;
  }
}

}  // namespace

// live may be null (every slot live). Returns cudaGetLastError() after the
// launch (0 on success), or -1 for a head dim / dtype the kernel does not take.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* positions,
                                const void* live, void* o, int B, int Smax, int H,
                                int KH, int DH, int dtype, float scale, int window,
                                float softcap, void* stream) {
  const int* pos = static_cast<const int*>(positions);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_dh<float>(DH, q, k_cache, v_cache, pos, lv, o, B, Smax, H, KH,
                              scale, window, softcap, s);
  if (dtype == DT_BF16)
    return dispatch_dh<__nv_bfloat16>(DH, q, k_cache, v_cache, pos, lv, o, B, Smax, H,
                                      KH, scale, window, softcap, s);
  return -1;
}
