// Single-query GQA decode attention for Hopper (sm_90a), against a dense slot
// KV cache or a paged block pool: flash-decoding, with the KV walk split
// across blocks and the splits merged in the same launch.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py:_kernel
// (entry decode_attention) and :_kernel_paged (entry decode_attention_paged):
// every slot attends its one new query against its cache, with per-slot
// positions and live bits. Slot b's query at position p attends
// [lo, hi] = [max(0, p - window + 1), min(p, Smax - 1)] (lo = 0 without a
// window); no other position is read. A dead slot, or one with hi < lo,
// writes exact zeros.
//
// Paged layout: the cache is a pool (n_blocks, bs, K, Dh) shared by all
// slots, and position t of slot b lives in pool row table[b, t / bs] at
// offset t % bs (bs any positive multiple of 8). Each cache row's pool offset
// comes from one table read; no dense copy of a slot's cache is ever made,
// and only the table entries that cover [lo, hi] are read, so unallocated
// entries (which point at block 0) are never touched.
//
// What bounds it on this card: a decode call reads each live slot's K/V
// prefix once and does 4 * Dh FLOPs per (head, position), about G / 2 FLOPs
// per byte of bf16 cache -- far below the ~295 FLOP/byte ridge, so memory
// bandwidth bounds it, and at the serving shape (16 slots x 3 kv heads,
// positions up to ~550, ~3 MB) the latency of a few dependent loads bounds
// it long before the bandwidth does. What the design does about that:
//  - the grid is (n_split, KH, B): the walk over each (slot, kv head)'s cache
//    is cut into splits of SPLIT positions, one block of NW warps each, so
//    the ~130 live splits of a serving tick (8 warps each) spread over the
//    132 SMs instead of 48 blocks of 4 warps walking 9 tiles in turn.
//    n_split = ceil(Smax / SPLIT) is fixed by the shapes (the host never
//    reads the positions, which would be a sync in the tick); a block whose
//    split holds no position of [lo, hi] returns at once.
//  - each warp takes SPLIT / NW positions. A cache row is read by
//    Dh * sizeof(T) / 16 lanes with one 16-byte read-only load each (bf16 at
//    d_head 64: 8 lanes, so a warp reads 4 rows per load), and all of a
//    chunk's K and V loads (up to 8 per lane) are issued before the first
//    use, the first chunk's before q is staged, so they overlap.
//  - q is staged once in shared memory as f32; each lane's partial dot over
//    its dims is reduced by shuffles over the lanes of its row, for each of
//    the G heads of the group (any G), so every K/V row is read once for all
//    G heads and every dependent chain is short.
//  - each warp keeps a running max and sum for each head, and its share of
//    the f32 accumulator in shared memory; the NW warps are merged in warp
//    order, which gives the split's partial (m, l, acc).
//  - merge in the same launch (the last-block pattern of CUDA's
//    threadFenceReduction sample): a slot with one live split writes o
//    directly. Otherwise each block writes its partial to an f32 workspace,
//    fences, and one thread adds 1 to the (slot, kv head)'s int32 counter;
//    the block that sees n_live - 1 merges every live split in split order,
//    o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, writes o, and sets
//    the counter back to 0, so every launch leaves the counters at zero.
//    Every block computes n_live the same way, from pos[b], window and
//    SPLIT. This holds for launches on one stream (all the port has): two
//    launches that share the counters must not run at once.
// What is left at the serving tick is latency, not bytes: a launch whose
// blocks all exit at once, one split, and the merge's chain (fence, counter,
// the partials read back from L2) each cost microseconds (PERF.md).
//
// The online softmax is f32; every sum runs in a fixed order, and the only
// atomic is the integer counter, whose order of arrival changes nothing:
// two launches give the same bits.
//
// Ring layout (the pairs plan's local-window stack under paged KV): slot b
// keeps only its last W_ring positions, position t at ring row
// b * W_ring + t % W_ring, so the paged kernel's table lookup becomes a
// modulo (the RING instantiations). The walk covers the same positions
// [lo, hi] in the same splits of the virtual horizon (Smax = the slots'
// horizon, not W_ring, sizes the grid), so a ring tick gives the bits of a
// dense tick with the same window, as long as W_ring >= window.
//
// d_head 256: a bf16 row is one 16-byte load a lane across the warp; an f32
// row is 64 such loads, so each lane takes two (VPL), and a chunk holds
// half as many rows to keep the registers of K and V in flight at 64.
//
// d_head 112 (zamba2): a row is 14 16-byte loads in bf16 and 28 in f32,
// not a power of two, so a row takes the next power of two of lanes (16,
// 32) and the lanes past its columns load nothing, add zeros to every sum
// and write nothing; the reductions then never mix two rows' lanes.
//
// The log-sum-exp (dense entry only, when the caller gives lse (B, H) f32):
// the block that finishes a slot (its one live split, or the merging block)
// also writes lse = M + log(l) of each head, and o in f32 instead of T, so a
// merge of several caches' results (a KV cache split by position across
// ranks) never sees a rounded partial. An empty slot (dead, or hi < lo)
// writes o = 0 and lse = -inf. A rank holding positions [c S_b, (c+1) S_b)
// of a cache passes positions - c S_b: the causal and window masks depend on
// differences only, a block past the query gets hi < lo (empty), and a block
// wholly before it is live to its end through the clamp hi = min(p, Smax - 1).
#include "common.cuh"

// positions per split (one block) and warps per block. SPLIT 128 with 8
// warps (16 positions a warp) was the fastest at the serving tick of the
// lengths and warp counts measured (PERF.md); the wrappers pass their SPLIT,
// and a launch with another value is refused.
#ifndef DECODE_SPLIT
#define DECODE_SPLIT 128
#endif
#ifndef DECODE_WARPS
#define DECODE_WARPS 8
#endif

namespace {

constexpr int SPLIT = DECODE_SPLIT;
constexpr int NW = DECODE_WARPS;
constexpr int NT = NW * 32;
constexpr int PW = SPLIT / NW;    // positions per warp
static_assert(SPLIT % NW == 0, "a split must divide among the warps");

// one 16-byte load: 8 bf16 or 4 f32 elements, unpacked to f32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// how a warp walks its PW positions: LPR lanes a row (a power of two, so
// that the shuffles over a row's lanes and over the rows stay apart), of
// which the first CPR load VPL 16-byte columns each and the rest load
// nothing; RPW rows a load step, NSTEP steps, taken NB steps (one chunk of
// registers) at a time. d_head 112 has 14 columns in bf16 (16 lanes a row,
// two idle) and 28 in f32 (32 lanes, four idle): the walks of d_head 128.
template <typename T, int DH>
struct Walk {
  static constexpr int EPL = Vec<T>::N;
  static constexpr int VPL = DH / EPL > 32 ? DH / EPL / 32 : 1;
  static constexpr int CPR = DH / EPL / VPL;
  static constexpr int LPR = pow2_ceil(CPR);
  static constexpr int RPW = 32 / LPR;
  static constexpr int NSTEP = (PW + RPW - 1) / RPW;
  static constexpr int NB = NSTEP < 8 / VPL ? NSTEP : 8 / VPL;
  static_assert(CPR >= 1 && CPR <= LPR && LPR <= 32 && (LPR & (LPR - 1)) == 0 &&
                    CPR * VPL * EPL == DH && NSTEP % NB == 0,
                "walk shape");
};

size_t smem_bytes(int G, int DH) {
  // q (G x DH), each warp's acc (NW x G x DH), m and l (NW x G each)
  return sizeof(float) * ((size_t)(1 + NW) * G * DH + 2 * NW * G);
}

// Issue one chunk's K and V loads (rows outside [t_first, t_last], and the
// lanes of a row past its CPR columns, read nothing and stay zero). Lane
// column c loads dims (v CPR + c) EPL + [0, EPL).
template <typename T, int DH, bool RING>
__device__ __forceinline__ void load_chunk(
    uint4 (&kr)[Walk<T, DH>::NB][Walk<T, DH>::VPL],
    uint4 (&vr)[Walk<T, DH>::NB][Walk<T, DH>::VPL],
    const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ trow, int bs, int b, int Smax, int KH, int kh,
    int t0, int r, int c, int t_first, int t_last) {
  using W = Walk<T, DH>;
#pragma unroll
  for (int i = 0; i < W::NB; ++i) {
    const int t = t0 + i * W::RPW + r;
    if (t >= t_first && t <= t_last && c < W::CPR) {
      size_t row;
      if constexpr (RING)
        row = (size_t)b * bs + t % bs;
      else
        row = trow == nullptr ? (size_t)b * Smax + t
                              : (size_t)__ldg(&trow[t / bs]) * bs + t % bs;
#pragma unroll
      for (int u = 0; u < W::VPL; ++u) {
        const size_t off = (row * KH + kh) * DH + (u * W::CPR + c) * W::EPL;
        kr[i][u] = __ldg(reinterpret_cast<const uint4*>(kc + off));
        vr[i][u] = __ldg(reinterpret_cast<const uint4*>(vc + off));
      }
    } else {
#pragma unroll
      for (int u = 0; u < W::VPL; ++u) {
        kr[i][u] = make_uint4(0u, 0u, 0u, 0u);
        vr[i][u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// table == nullptr: dense caches (B, Smax, K, DH). Otherwise pools
// (n_blocks, bs, K, DH) read through table (B, Smax / bs), Smax = the
// table's width in positions. RING: rings (B, bs, K, DH), bs = W_ring, and
// Smax the virtual horizon. ws: (B, KH, n_split, G * (DH + 2)) f32
// partials; counters: (B * KH) int32, zero before and after the launch.
template <typename T, int DH, bool RING>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ pos, const uint8_t* __restrict__ live,
    const int* __restrict__ table, int bs, T* __restrict__ o,
    float* __restrict__ o32, float* __restrict__ lse, float* ws, int* counters,
    int Smax, int H, int KH, float scale, int window, float softcap) {
  using W = Walk<T, DH>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_s;
  const int G = H / KH;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // q and o are (B, 1, H, DH): the group's G heads are contiguous
  const size_t base = ((size_t)b * H + (size_t)kh * G) * DH;
  // with lse, o goes out in f32 (o32), and each head's lse beside it
  auto put = [&](int f, float x) {
    if (lse != nullptr)
      o32[base + f] = x;
    else
      o[base + f] = from_f32<T>(x);
  };
  float* lse_g = lse == nullptr ? nullptr : lse + (size_t)b * H + (size_t)kh * G;
  const int p = pos[b];
  const int hi = min(p, Smax - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  if ((live != nullptr && live[b] == 0) || hi < lo) {
    if (split == 0) {
      for (int f = tid; f < G * DH; f += NT) put(f, 0.f);
      if (lse_g != nullptr)
        for (int g = tid; g < G; g += NT) lse_g[g] = __int_as_float(0xff800000);
    }
    return;
  }
  // the live splits: every block of the slot computes the same range
  const int s_lo = lo / SPLIT, s_hi = hi / SPLIT;
  if (split < s_lo || split > s_hi) return;
  const int n_live = s_hi - s_lo + 1;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  float* q_s = smem;                   // G x DH
  float* acc_s = q_s + G * DH;         // NW x G x DH
  float* m_s = acc_s + NW * G * DH;    // NW x G
  float* l_s = m_s + NW * G;           // NW x G

  // this warp's positions [w0, w0 + PW), of which [t_first, t_last] are valid
  const int w0 = split * SPLIT + warp * PW;
  const int t_first = max(lo, w0), t_last = min(hi, w0 + PW - 1);
  const int r = lane / W::LPR, c = lane % W::LPR;   // row in a step, 16-byte column
  const bool col = c < W::CPR;   // a lane past the row's columns adds zeros
  const int* trow = table == nullptr ? nullptr : table + (size_t)b * (Smax / bs);

  // the first chunk's loads go out before q is staged
  uint4 kr[W::NB][W::VPL], vr[W::NB][W::VPL];
  if (t_first <= t_last)
    load_chunk<T, DH, RING>(kr, vr, kc, vc, trow, bs, b, Smax, KH, kh, w0, r, c,
                            t_first, t_last);
  for (int f = tid; f < G * DH; f += NT) q_s[f] = to_f32(q[base + f]);
  for (int f = tid; f < NW * G * DH; f += NT) acc_s[f] = 0.f;
  for (int f = tid; f < NW * G; f += NT) {
    m_s[f] = NEG_INF_F;
    l_s[f] = 0.f;
  }
  __syncthreads();

  for (int i0 = 0; i0 < W::NSTEP && t_first <= t_last; i0 += W::NB) {
    const int t0 = w0 + i0 * W::RPW;   // the chunk's rows: [t0, t0 + NB * RPW)
    if (t0 > t_last) break;
    if (t0 + W::NB * W::RPW <= t_first) continue;
    if (i0 > 0)
      load_chunk<T, DH, RING>(kr, vr, kc, vc, trow, bs, b, Smax, KH, kh, t0, r, c,
                              t_first, t_last);
    bool valid[W::NB];
#pragma unroll
    for (int i = 0; i < W::NB; ++i) {
      const int t = t0 + i * W::RPW + r;
      valid[i] = t >= t_first && t <= t_last;
    }
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      float qf[W::VPL][W::EPL];
#pragma unroll
      for (int u = 0; u < W::VPL; ++u) {
        const float4* q4 = reinterpret_cast<const float4*>(
            q_s + g * DH + (col ? (u * W::CPR + c) * W::EPL : 0));
#pragma unroll
        for (int e = 0; e < W::EPL / 4; ++e) {
          const float4 x = col ? q4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
          qf[u][4 * e] = x.x; qf[u][4 * e + 1] = x.y; qf[u][4 * e + 2] = x.z;
          qf[u][4 * e + 3] = x.w;
        }
      }
      // scores of the chunk's rows: a partial dot per lane, summed over the
      // LPR lanes of the row (every lane of the row ends with the same bits)
      float sc[W::NB];
      float mx = NEG_INF_F;
#pragma unroll
      for (int i = 0; i < W::NB; ++i) {
        float a = 0.f;
#pragma unroll
        for (int u = 0; u < W::VPL; ++u) {
          float kf[W::EPL];
          Vec<T>::unpack(kr[i][u], kf);
#pragma unroll
          for (int e = 0; e < W::EPL; ++e) a = fmaf(qf[u][e], kf[e], a);
        }
#pragma unroll
        for (int off = W::LPR / 2; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        float s = a * scale;
        if (softcap > 0.f) s = tanhf(s * inv_cap) * softcap;
        sc[i] = valid[i] ? s : NEG_INF_F;
        mx = fmaxf(mx, sc[i]);
      }
#pragma unroll
      for (int off = W::LPR; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const int slot = warp * G + g;
      const float m_old = m_s[slot], l_old = l_s[slot];
      const float m_new = fmaxf(m_old, mx);   // finite: the chunk holds a valid row
      const float corr = expf(m_old - m_new);
      float psum = 0.f, pv[W::VPL][W::EPL];
#pragma unroll
      for (int u = 0; u < W::VPL; ++u)
#pragma unroll
        for (int e = 0; e < W::EPL; ++e) pv[u][e] = 0.f;
#pragma unroll
      for (int i = 0; i < W::NB; ++i) {
        const float pr = valid[i] ? expf(sc[i] - m_new) : 0.f;
        psum += pr;
#pragma unroll
        for (int u = 0; u < W::VPL; ++u) {
          float vf[W::EPL];
          Vec<T>::unpack(vr[i][u], vf);
#pragma unroll
          for (int e = 0; e < W::EPL; ++e) pv[u][e] = fmaf(pr, vf[e], pv[u][e]);
        }
      }
      // sum over the warp's rows (the lanes of one column hold its dims)
#pragma unroll
      for (int off = W::LPR; off < 32; off <<= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
#pragma unroll
        for (int u = 0; u < W::VPL; ++u)
#pragma unroll
          for (int e = 0; e < W::EPL; ++e)
            pv[u][e] += __shfl_xor_sync(0xffffffffu, pv[u][e], off);
      }
      __syncwarp();
      if (r == 0 && col) {
#pragma unroll
        for (int u = 0; u < W::VPL; ++u) {
          float* ag = acc_s + (size_t)slot * DH + (u * W::CPR + c) * W::EPL;
#pragma unroll
          for (int e = 0; e < W::EPL; ++e) ag[e] = fmaf(ag[e], corr, pv[u][e]);
        }
      }
      if (lane == 0) {
        m_s[slot] = m_new;
        l_s[slot] = fmaf(l_old, corr, psum);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // the split's partial: the warps merged in warp order (a warp that had no
  // valid row has m = -1e30 and adds exact zeros)
  const int n_split = gridDim.x;
  const int stride = G * (DH + 2);
  float* part = ws + ((size_t)(b * KH + kh) * n_split + split) * stride;
  for (int f = tid; f < G * DH; f += NT) {
    const int g = f / DH;
    float M = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w * G + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(m_s[w * G + g] - M);
      a = fmaf(e, acc_s[(size_t)(w * G + g) * DH + f % DH], a);
      l = fmaf(e, l_s[w * G + g], l);
    }
    if (n_live == 1) {
      put(f, a / l);
      if (lse_g != nullptr && f % DH == 0) lse_g[g] = M + logf(l);
    } else {
      part[f] = a;
      if (f % DH == 0) {
        part[G * DH + g] = M;
        part[G * DH + G + g] = l;
      }
    }
  }
  if (n_live == 1) return;

  // the last of the slot's n_live blocks to arrive merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + b * KH + kh;
    const int arrived = atomicAdd(cnt, 1);
    last_s = arrived == n_live - 1;
    if (last_s) atomicExch(cnt, 0);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = ws + (size_t)(b * KH + kh) * n_split * stride;
  for (int f = tid; f < G * DH; f += NT) {
    const int g = f / DH;
    float M = NEG_INF_F;
    for (int s = s_lo; s <= s_hi; ++s)
      M = fmaxf(M, __ldcg(parts + (size_t)s * stride + G * DH + g));
    float a = 0.f, l = 0.f;
    for (int s = s_lo; s <= s_hi; ++s) {
      const float* ps = parts + (size_t)s * stride;
      const float e = expf(__ldcg(ps + G * DH + g) - M);
      a = fmaf(e, __ldcg(ps + f), a);
      l = fmaf(e, __ldcg(ps + G * DH + G + g), l);
    }
    put(f, a / l);
    if (lse_g != nullptr && f % DH == 0) lse_g[g] = M + logf(l);
  }
}

template <typename T, int DH, bool RING>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const uint8_t* live, const int* table, int bs, void* o, float* lse,
           float* ws, int* counters, int B, int Smax, int H, int KH, float scale,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KH, DH);
  // the 48 KB a launch may take without the attribute holds the static
  // last_s too (G 12 at d_head 112 asks for exactly 48 KB of dynamic memory)
  if (smem + sizeof(int) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, DH, RING>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Smax + SPLIT - 1) / SPLIT, KH, B);
  decode_split_kernel<T, DH, RING><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, live, table, bs, lse == nullptr ? static_cast<T*>(o) : nullptr,
      lse == nullptr ? nullptr : static_cast<float*>(o), lse, ws, counters, Smax, H,
      KH, scale, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T, bool RING>
int dispatch_dh(int DH, const void* q, const void* k, const void* v, const int* pos,
                const uint8_t* live, const int* table, int bs, void* o, float* lse,
                float* ws, int* cnt, int B, int Smax, int H, int KH, float scale,
                int window, float softcap, cudaStream_t s) {
  switch (DH) {
    case 16: return launch<T, 16, RING>(q, k, v, pos, live, table, bs, o, lse, ws, cnt, B, Smax, H, KH, scale, window, softcap, s);
    case 32: return launch<T, 32, RING>(q, k, v, pos, live, table, bs, o, lse, ws, cnt, B, Smax, H, KH, scale, window, softcap, s);
    case 64: return launch<T, 64, RING>(q, k, v, pos, live, table, bs, o, lse, ws, cnt, B, Smax, H, KH, scale, window, softcap, s);
    case 112: return launch<T, 112, RING>(q, k, v, pos, live, table, bs, o, lse, ws, cnt, B, Smax, H, KH, scale, window, softcap, s);
    case 128: return launch<T, 128, RING>(q, k, v, pos, live, table, bs, o, lse, ws, cnt, B, Smax, H, KH, scale, window, softcap, s);
    case 256: return launch<T, 256, RING>(q, k, v, pos, live, table, bs, o, lse, ws, cnt, B, Smax, H, KH, scale, window, softcap, s);
    default: return -1;
  }
}

template <bool RING>
int dispatch(int dtype, int DH, int split, const void* q, const void* k,
             const void* v, const void* positions, const void* live,
             const void* table, int bs, void* o, void* lse, void* ws, void* counters,
             int B, int Smax, int H, int KH, float scale, int window, float softcap,
             void* stream) {
  if (split != SPLIT || ws == nullptr || counters == nullptr) return -1;
  const int* pos = static_cast<const int*>(positions);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  const int* tb = static_cast<const int*>(table);
  float* w = static_cast<float*>(ws);
  float* ls = static_cast<float*>(lse);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return dispatch_dh<float, RING>(DH, q, k, v, pos, lv, tb, bs, o, ls, w, cnt, B, Smax,
                                    H, KH, scale, window, softcap, s);
  if (dtype == DT_BF16)
    return dispatch_dh<__nv_bfloat16, RING>(DH, q, k, v, pos, lv, tb, bs, o, ls, w, cnt,
                                            B, Smax, H, KH, scale, window, softcap, s);
  return -1;
}

}  // namespace

// live may be null (every slot live). lse may be null; given, it is (B, H)
// f32 and o is then (B, 1, H, DH) f32 whatever the inputs' dtype. workspace:
// at least B * KH * ceil(Smax / split) * (H / KH) * (DH + 2) floats;
// counters: B * KH int32, all zero (every launch leaves them so). split must
// be the kernel's SPLIT. Returns cudaGetLastError() after the launch (0 on
// success), or -1 for a head dim, dtype or split the kernel does not take.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* positions,
                                const void* live, void* o, void* lse,
                                void* workspace, void* counters, int B, int Smax,
                                int H, int KH, int DH, int dtype, int split,
                                float scale, int window, float softcap,
                                void* stream) {
  return dispatch<false>(dtype, DH, split, q, k_cache, v_cache, positions, live,
                         nullptr, 1, o, lse, workspace, counters, B, Smax, H, KH,
                         scale, window, softcap, stream);
}

// The paged layout: pools (n_blocks, bs, KH, DH), block_table (B, max_blocks)
// int32 whose entries must index the pool; Smax = max_blocks * bs. Same
// arguments and returns as above, and -1 for a block size that is not a
// positive multiple of 8.
extern "C" int decode_attention_paged(const void* q, const void* k_pool,
                                      const void* v_pool, const void* positions,
                                      const void* live, const void* block_table,
                                      void* o, void* workspace, void* counters,
                                      int B, int max_blocks, int bs, int H, int KH,
                                      int DH, int dtype, int split, float scale,
                                      int window, float softcap, void* stream) {
  if (bs < 8 || bs % 8 != 0 || block_table == nullptr) return -1;
  return dispatch<false>(dtype, DH, split, q, k_pool, v_pool, positions, live,
                         block_table, bs, o, nullptr, workspace, counters, B,
                         max_blocks * bs, H, KH, scale, window, softcap, stream);
}

// The ring layout: rings (B, w_ring, KH, DH), position t of slot b at ring
// row t % w_ring; horizon = the slots' virtual horizon (the dense cache's
// Smax), which sizes the grid and the workspace as Smax does above. The
// window must be positive and at most w_ring, so that every position the
// query sees is still in its ring. Same arguments and returns as above, and
// -1 for a window that breaks that.
extern "C" int decode_attention_ring(const void* q, const void* k_ring,
                                     const void* v_ring, const void* positions,
                                     const void* live, void* o, void* workspace,
                                     void* counters, int B, int horizon, int w_ring,
                                     int H, int KH, int DH, int dtype, int split,
                                     float scale, int window, float softcap,
                                     void* stream) {
  if (w_ring < 1 || window < 1 || window > w_ring) return -1;
  return dispatch<true>(dtype, DH, split, q, k_ring, v_ring, positions, live,
                        nullptr, w_ring, o, nullptr, workspace, counters, B, horizon,
                        H, KH, scale, window, softcap, stream);
}
