// Single-query GQA decode attention for Hopper (sm_90a), against a dense slot
// KV cache or a paged block pool.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py:_kernel
// (entry decode_attention) and :_kernel_paged (entry decode_attention_paged):
// every slot attends its one new query against its cache, with per-slot
// positions and live bits. KV positions above the slot's position (or
// at/below position - window) are never read; a dead slot writes exact zeros.
//
// Paged layout: the cache is a pool (n_blocks, bs, K, Dh) shared by all
// slots, and position t of slot b lives in pool row table[b, t / bs] at
// offset t % bs. The kernel walks positions in order exactly as the dense
// one does and reads each position's K/V row straight from the pool through
// the table; no dense copy of a slot's cache is ever made. Only the table
// entries that cover [window floor, position] are read, so unallocated
// entries (which point at block 0) are never touched. One shared-memory tile
// of TK positions spans TK / bs table entries (bs is a multiple of 8); the
// tile's row offsets are resolved once per position into shared memory, so
// the staging loop does no table read or division per element.
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

// table == nullptr: dense caches (B, Smax, K, DH). Otherwise pools
// (n_blocks, bs, K, DH) read through table (B, Smax / bs), Smax = the
// table's width in positions.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ pos, const uint8_t* __restrict__ live,
    const int* __restrict__ table, int bs, T* __restrict__ o, int Smax, int H,
    int KH, float scale, int window, float softcap) {
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
  __shared__ size_t off_s[TK];       // the tile's cache-row offsets

  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // q and o are (B, 1, H, DH): the group's G heads are contiguous
  const size_t base = ((size_t)b * H + (size_t)kh * G) * DH;
  const int p = pos[b];
  const int hi = min(p, Smax - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int* trow = table == nullptr ? nullptr : table + (size_t)b * (Smax / bs);
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
    // each position's cache row is resolved once (one table read), then
    // every (position, dim) element of the tile is staged from it
    for (int j = tid; j < n; j += NT) {
      const int t = t0 + j;
      const size_t row = trow == nullptr ? (size_t)b * Smax + t
                                         : (size_t)__ldg(&trow[t / bs]) * bs + t % bs;
      off_s[j] = (row * KH + kh) * DH;
    }
    __syncthreads();
    for (int f = tid; f < TK * DH; f += NT) {
      const int j = f / DH, d = f % DH;
      float kv = 0.f, vv = 0.f;
      if (j < n) {
        kv = to_f32(kc[off_s[j] + d]);
        vv = to_f32(vc[off_s[j] + d]);
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
           const uint8_t* live, const int* table, int bs, void* o, int B,
           int Smax, int H, int KH, float scale, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(H / KH);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KH, B);
  decode_attn_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, live, table, bs, static_cast<T*>(o), Smax, H, KH, scale, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int DH, const void* q, const void* k, const void* v, const int* pos,
                const uint8_t* live, const int* table, int bs, void* o, int B,
                int Smax, int H, int KH, float scale, int window, float softcap,
                cudaStream_t s) {
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, pos, live, table, bs, o, B, Smax, H, KH, scale, window, softcap, s);
    case 32: return launch<T, 32>(q, k, v, pos, live, table, bs, o, B, Smax, H, KH, scale, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, pos, live, table, bs, o, B, Smax, H, KH, scale, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, pos, live, table, bs, o, B, Smax, H, KH, scale, window, softcap, s);
    default: return -1;
  }
}

int dispatch(int dtype, int DH, const void* q, const void* k, const void* v,
             const void* positions, const void* live, const void* table, int bs,
             void* o, int B, int Smax, int H, int KH, float scale, int window,
             float softcap, void* stream) {
  const int* pos = static_cast<const int*>(positions);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  const int* tb = static_cast<const int*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_dh<float>(DH, q, k, v, pos, lv, tb, bs, o, B, Smax, H, KH, scale,
                              window, softcap, s);
  if (dtype == DT_BF16)
    return dispatch_dh<__nv_bfloat16>(DH, q, k, v, pos, lv, tb, bs, o, B, Smax, H, KH,
                                      scale, window, softcap, s);
  return -1;
}

}  // namespace

// live may be null (every slot live). Returns cudaGetLastError() after the
// launch (0 on success), or -1 for a head dim / dtype the kernel does not take.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* positions,
                                const void* live, void* o, int B, int Smax, int H,
                                int KH, int DH, int dtype, float scale, int window,
                                float softcap, void* stream) {
  return dispatch(dtype, DH, q, k_cache, v_cache, positions, live, nullptr, 1, o, B,
                  Smax, H, KH, scale, window, softcap, stream);
}

// The paged layout: pools (n_blocks, bs, KH, DH), block_table (B, max_blocks)
// int32 whose entries must index the pool. Same returns as above, and -1 for
// a block size that is not a positive multiple of 8.
extern "C" int decode_attention_paged(const void* q, const void* k_pool,
                                      const void* v_pool, const void* positions,
                                      const void* live, const void* block_table,
                                      void* o, int B, int max_blocks, int bs, int H,
                                      int KH, int DH, int dtype, float scale,
                                      int window, float softcap, void* stream) {
  if (bs < 8 || bs % 8 != 0 || block_table == nullptr) return -1;
  return dispatch(dtype, DH, q, k_pool, v_pool, positions, live, block_table, bs, o,
                  B, max_blocks * bs, H, KH, scale, window, softcap, stream);
}
