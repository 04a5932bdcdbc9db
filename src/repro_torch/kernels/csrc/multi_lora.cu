// Multi-LoRA apply for Hopper (sm_90a): y[t] = s * (x[t] A[idx[t]]) B[idx[t]].
//
// Replaces the TPU kernels src/repro/kernels/multi_lora.py:_kernel (entry
// multi_lora, f32 bank) and _q8_kernel (entry multi_lora_q8: int8 codes with
// one f32 scale per row). The TPU ran U masked passes over every token block
// so that it never gathered; on this card a gather is cheap, so each row reads
// its own adapter (the BGMV idiom of Punica and S-LoRA).
//
// What bounds it on this card: 2 r (d_in + d_out) FLOPs a row against
// 2 (d_in + d_out) bytes of bf16 x and y, about r / 2 FLOPs a byte, far below
// the CUDA cores' ridge. At a prefill or a chunk round (T in the thousands)
// the bytes of x and y bound it; at a decode tick (T 16) only latency does:
// the launch and a chain of dependent memory round trips.
//
// What the design does about that:
// - One order of summation for every launch shape. A row's shrink
//   xa[j] = sum_d x[d] A[d, j] is taken by a group of NW = min(8,
//   ceil(d_in / 128)) warps: the d axis is cut into quads of 4, thread t of
//   the group owns quads t, t + 32 NW, ..., and chains fmaf over its d in
//   ascending order; the lanes of a warp combine by a butterfly with masks
//   16, 8, 4, 2, 1; the warps' sums are added in warp order. The expand
//   chains fmaf over j in ascending order. So a row's bits are a function of
//   its own x row, its own adapter, d_in and r: not of T, its tile, its
//   neighbours, the launch shape or the instantiation (a row served in a
//   T 16 call equals the same row in a T 8192 call, and the int8 kernel
//   equals the f32 kernel on the dequantised bank, bit for bit).
// - A block takes a tile of rows and a slice of the output columns
//   (kernels/multi_lora.py, plan). At a decode tick the tile is one row and
//   the columns come in slices of up to 128, so 16 rows make 80 blocks at
//   576 columns; each slice recomputes its row's shrink from L2. At a
//   prefill or a chunk round a tile of up to 32 consecutive rows takes every
//   column and holds A and B in registers for a run of rows with one adapter
//   (rows come in runs: a prompt, a chunk), so the bank is read once a run,
//   not once a row; two rows at a time go through the shrink and the expand
//   as independent chains, where both use the adapter held.
// - Loads in flight together: the x tile is staged by cp.async while idx and
//   then the first row's A quad and B columns are read with 16-byte loads
//   (int8: 16 bytes of codes and a float4 of their row scales); only idx
//   comes before them. Stores are 8 (bf16) or 16 (f32) bytes.
// - Ranks 4, 8 and 16 with widths in quads, d_in <= 1024 and 16-byte aligned
//   tensors run multi_lora_vec_kernel<T, Q8, R> (the rank a template
//   parameter, A and B in registers); every other rank (1..256) and width
//   runs multi_lora_any_kernel<T, Q8> (scalar reads, the rank in blocks of
//   8), which sums in the same order.
//
// int8: each value is dequantised as it is loaded, a = (float)code * scale
// rounded once (the plain version's product), and then used as the f32 kernel
// uses A and B. The scales are not factored out of the sums, which would
// round differently.
//
// All sums are f32 on the CUDA cores (the f32 path is the card's oracle: its
// tokens equal the CPU's). Rows with idx < 0 are padding and write exact
// zeros; idx >= U reads the last adapter, as the plain version's clamp does.
// No atomics: repeated runs give identical bits. A tile of x rows is staged in
// shared memory, so one row of x must fit there (d_in up to ~55k in f32).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int MAX_WARPS = 8;       // a row's shrink group: min(8, ceil(d_in / 128)) warps
constexpr int MAX_TILE = 32;       // rows a block takes
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block can have
constexpr unsigned FULL = 0xffffffffu;

int shrink_warps(int d_in) { return d_in > 32 * 4 * MAX_WARPS ? MAX_WARPS : (d_in + 127) / 128; }

// --- element access ---------------------------------------------------------

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// one quad (4 elements) of an x row, global -> shared
__device__ __forceinline__ void copy_quad(float* dst, const float* src) {
  cp_async16(dst, src, true);
}
__device__ __forceinline__ void copy_quad(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  cp_async8(dst, src);
}

__device__ __forceinline__ void load_quad(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __forceinline__ void store_quad(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float code_f32(int w, int byte) {
  return (float)(signed char)(w >> (8 * byte));
}

// One adapter's (A, B) as the kernels read them: f32 values, or int8 codes
// with per-row f32 scales, dequantised as they are loaded. a / b read one
// value (the generic kernel); a_quad reads A rows 4q .. 4q + 3, all R
// columns; b_quad reads output columns 4q .. 4q + 3 of B's R rows.
struct BankF32 {
  const float* A;
  const float* B;
  __device__ float a(size_t u, int d, int j, int d_in, int r) const {
    return __ldg(&A[(u * d_in + d) * r + j]);
  }
  __device__ float b(size_t u, int j, int c, int r, int d_out) const {
    return __ldg(&B[(u * r + j) * d_out + c]);
  }
  template <int R>
  __device__ void a_quad(size_t u, int q, int d_in, float (&a)[4][R]) const {
    const float4* p = reinterpret_cast<const float4*>(A + (u * d_in + 4 * q) * R);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float4 v = __ldg(p + k);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) a[(4 * k + c) / R][(4 * k + c) % R] = e[c];
    }
  }
  template <int R>
  __device__ void b_quad(size_t u, int q, int d_out, float (&b)[R][4]) const {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(B + (u * R + j) * d_out + 4 * q));
      b[j][0] = v.x, b[j][1] = v.y, b[j][2] = v.z, b[j][3] = v.w;
    }
  }
};

struct BankQ8 {
  const int8_t* A;
  const float* A_scale;   // (U, d_in)
  const int8_t* B;
  const float* B_scale;   // (U, r)
  __device__ float a(size_t u, int d, int j, int d_in, int r) const {
    return __fmul_rn((float)__ldg(&A[(u * d_in + d) * r + j]), __ldg(&A_scale[u * d_in + d]));
  }
  __device__ float b(size_t u, int j, int c, int r, int d_out) const {
    return __fmul_rn((float)__ldg(&B[(u * r + j) * d_out + c]), __ldg(&B_scale[u * r + j]));
  }
  template <int R>
  __device__ void a_quad(size_t u, int q, int d_in, float (&a)[4][R]) const {
    const int4* p = reinterpret_cast<const int4*>(A + (u * d_in + 4 * q) * R);
    const float4 s = __ldg(reinterpret_cast<const float4*>(A_scale + u * d_in + 4 * q));
    const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {   // 16 codes a load
      const int4 v = __ldg(p + k);
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int e = 16 * k + c;
        a[e / R][e % R] = __fmul_rn(code_f32(w[c / 4], c % 4), sc[e / R]);
      }
    }
  }
  template <int R>
  __device__ void b_quad(size_t u, int q, int d_out, float (&b)[R][4]) const {
    float sc[R];
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(B_scale + u * R) + k);
      sc[4 * k] = s.x, sc[4 * k + 1] = s.y, sc[4 * k + 2] = s.z, sc[4 * k + 3] = s.w;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int w = __ldg(reinterpret_cast<const int*>(B + (u * R + j) * d_out + 4 * q));
#pragma unroll
      for (int c = 0; c < 4; ++c) b[j][c] = __fmul_rn(code_f32(w, c), sc[j]);
    }
  }
};

template <int Q8> struct BankOf { using type = BankF32; };
template <> struct BankOf<1> { using type = BankQ8; };

// The warp's sums of the first N of v by the butterfly with masks 16, 8, 4,
// 2, 1 (the same tree for every value, whatever N). The first log2 N levels
// halve the values a lane carries (a reduce-scatter), so lane l ends with the
// sum of value l / (32 / N), which it returns. Levels are template arguments,
// so every index into v is a constant and v stays in registers.
template <int N, int M, int S>
__device__ __forceinline__ float warp_sum_scatter(float (&v)[S], int lane) {
  if constexpr (N > 1) {
    const bool hi = lane & M;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float send = hi ? v[k] : v[k + N / 2];
      const float keep = hi ? v[k + N / 2] : v[k];
      v[k] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, M));
    }
    return warp_sum_scatter<N / 2, M / 2>(v, lane);
  } else {
    float s = v[0];
#pragma unroll
    for (int m = M; m > 0; m >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, m));
    return s;
  }
}

// Shared memory of a block: a zero quad (16 bytes), part [tile][nw][r] (the
// warps' sums), xa [tile][r], ids [tile] (clamped adapter ids, -1 for
// padding), then the x tile [tile][d4] in x's type (rows padded to quads).
struct Smem {
  void* zero;
  float* part;
  float* xa;
  int* ids;
  void* xs;
};

__host__ __device__ inline size_t smem_floats(int tile, int nw, int r) {
  return ((size_t)4 + tile * ((nw + 1) * r + 1) + 3) & ~(size_t)3;   // 16-byte multiple
}

__device__ __forceinline__ Smem smem_layout(unsigned char* base, int tile, int nw, int r) {
  float* part = reinterpret_cast<float*>(base) + 4;
  float* xa = part + (size_t)tile * nw * r;
  int* ids = reinterpret_cast<int*>(xa + (size_t)tile * r);
  return {base, part, xa, ids, base + 4 * smem_floats(tile, nw, r)};
}

// The expand's share of one thread: quads q0, q0 + qstep, ... of the block's
// nq and rows i0, i0 + istep, ... of its tile (threads that share a quad split
// its rows); active unless i0 >= istep.
struct ExpandShare {
  int q0, qstep, i0, istep;
  __device__ ExpandShare(int tid, int ns, int nq) {
    qstep = min(nq, ns);
    q0 = tid % qstep;
    i0 = tid / qstep;
    istep = ns / qstep;
  }
};

// The warps' sums of each (row, j) of the tile, in warp order, into xa.
__device__ __forceinline__ void sum_warps(const Smem& s, int tid, int ns, int rows, int nw,
                                          int r) {
  const int jstep = min(r, ns), j0 = tid % jstep, i0 = tid / jstep, istep = ns / jstep;
  if (i0 >= istep) return;
  for (int i = i0; i < rows; i += istep) {
    if (s.ids[i] < 0) continue;
    for (int j = j0; j < r; j += jstep) {
      const float* p = s.part + (size_t)i * nw * r + j;
      float v = p[0];
      for (int w = 1; w < nw; ++w) v = __fadd_rn(v, p[(size_t)w * r]);
      s.xa[(size_t)i * r + j] = v;
    }
  }
}

// --- rank R in {4, 8, 16}, widths in quads, aligned tensors -----------------

// One lane's part of a row's shrink: its quad of x against its A quad, the
// four d in ascending order.
template <typename T, int R>
__device__ __forceinline__ void shrink_quad(const T* xq, const float (&a)[4][R], float (&v)[R]) {
  float xv[4];
  load_quad(xq, xv);
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = __fmaf_rn(xv[k], a[k][j], v[j]);
}

// One quad of a row's output: scale * sum_j xa[j] B[j, quad], j ascending.
template <int R>
__device__ __forceinline__ void expand_quad(const float* xa, const float (&b)[R][4], float scale,
                                            float (&acc)[4]) {
  float xr[R];
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(xa + 4 * k);
    xr[4 * k] = t.x, xr[4 * k + 1] = t.y, xr[4 * k + 2] = t.z, xr[4 * k + 3] = t.w;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = __fmaf_rn(xr[j], b[j][c], acc[c]);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = __fmul_rn(scale, acc[c]);
}

// NB rows of the shrink with the A quad held: independent chains the
// scheduler can interleave. Lane sums go to part (pw, a row apart by pstep).
template <typename T, int R, int NB>
__device__ __forceinline__ void shrink_rows(const T* xq, int xstep, const float (&a)[4][R],
                                            int lane, bool writes, float* pw, int pstep) {
  float v[NB][R], w[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) shrink_quad<T, R>(xq + n * xstep, a, v[n]);
#pragma unroll
  for (int n = 0; n < NB; ++n) w[n] = warp_sum_scatter<R, 16>(v[n], lane);
  if (writes)
#pragma unroll
    for (int n = 0; n < NB; ++n) pw[n * pstep] = w[n];
}

// NB rows of one output quad with the B quad held (rows ystep apart).
template <typename T, int R, int NB>
__device__ __forceinline__ void expand_rows(const float* xa, int xstep, const float (&b)[R][4],
                                            float scale, T* yq, size_t ystep) {
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) expand_quad<R>(xa + n * xstep, b, scale, acc[n]);
#pragma unroll
  for (int n = 0; n < NB; ++n) store_quad(yq + n * ystep, acc[n]);
}

template <typename T, int Q8, int R>
__global__ void __launch_bounds__(MAX_WARPS * 32) multi_lora_vec_kernel(
    const T* __restrict__ x, const typename BankOf<Q8>::type bank, const int* __restrict__ idx,
    T* __restrict__ y, int T_rows, int U, int d_in, int d_out, float scale, int tile,
    int slice_quads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ns = blockDim.x, nw = ns >> 5;
  const int row0 = blockIdx.x * tile, rows = min(tile, T_rows - row0);
  const int nq_in = d_in >> 2;
  const int q_lo = blockIdx.y * slice_quads, nq = min(slice_quads, (d_out >> 2) - q_lo);
  const Smem s = smem_layout(smem, tile, nw, R);
  T* xs = static_cast<T*>(s.xs);

  // x tile -> shared memory, in flight while idx and the first adapter load
  for (int i = 0; i < rows; ++i)
    for (int q = tid; q < nq_in; q += ns)
      copy_quad(xs + (size_t)i * d_in + 4 * q, x + (size_t)(row0 + i) * d_in + 4 * q);
  cp_async_commit();
  if (tid < rows) {
    const int u = idx[row0 + tid];
    s.ids[tid] = u < 0 ? -1 : min(u, U - 1);
  }
  if (tid == 0) *static_cast<float4*>(s.zero) = make_float4(0.f, 0.f, 0.f, 0.f);

  // this thread's A quad (shrink) and B quad (expand), loaded for the first
  // row it meets and again where the adapter changes. A thread that owns no
  // quad reads the zero quad against a zero A, so it adds an exact +0 and the
  // rows need no branch on it.
  const bool has_q = tid < nq_in;
  const ExpandShare e(tid, ns, nq);
  float a[4][R], b[R][4];
  int ua, ub = -1, qb = e.q0;
  {
    const int u = idx[row0];
    ua = u < 0 ? -1 : min(u, U - 1);
    if (ua >= 0 && has_q) bank.template a_quad<R>(ua, tid, d_in, a);
    if (!has_q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < R; ++j) a[k][j] = 0.f;
  }
  if (e.i0 < e.istep && e.i0 < rows) {
    const int u = idx[row0 + e.i0];
    ub = u < 0 ? -1 : min(u, U - 1);
    if (ub >= 0) bank.template b_quad<R>(ub, q_lo + e.q0, d_out, b);
  }
  cp_async_wait<0>();
  __syncthreads();

  // shrink: each row by the whole block, in the fixed order; two rows at a
  // time where both use the adapter held
  const T* xq = has_q ? xs + 4 * tid : static_cast<const T*>(s.zero);
  const int xstep = has_q ? d_in : 0;
  float* pw = s.part + warp * R + lane / (32 / R);   // this lane's sum of row 0
  const bool writes = (lane & (32 / R - 1)) == 0;
  const int pstep = nw * R;
  for (int i = 0; i < rows;) {
    const int u = s.ids[i];
    if (u >= 0 && u == ua && i + 1 < rows && s.ids[i + 1] == u) {
      shrink_rows<T, R, 2>(xq + i * xstep, xstep, a, lane, writes, pw + i * pstep, pstep);
      i += 2;
      continue;
    }
    if (u >= 0) {
      if (u != ua) {
        if (has_q) bank.template a_quad<R>(u, tid, d_in, a);
        ua = u;
      }
      shrink_rows<T, R, 1>(xq + i * xstep, xstep, a, lane, writes, pw + i * pstep, pstep);
    }
    ++i;
  }
  __syncthreads();
  sum_warps(s, tid, ns, rows, nw, R);
  __syncthreads();

  // expand: y[i, 4q .. 4q + 3] = scale * sum_j xa[i, j] B[j, 4q .. 4q + 3];
  // two rows at a time where both use the B quad held
  if (e.i0 >= e.istep) return;
  const int st = e.istep;
  for (int qo = e.q0; qo < nq; qo += e.qstep) {
    T* yq = y + (size_t)row0 * d_out + 4 * (q_lo + qo);
    for (int i = e.i0; i < rows; i += st) {
      const int u = s.ids[i];
      if (u >= 0 && u == ub && qo == qb && i + st < rows && s.ids[i + st] == u) {
        expand_rows<T, R, 2>(s.xa + i * R, st * R, b, scale, yq + (size_t)i * d_out,
                             (size_t)st * d_out);
        i += st;
        continue;
      }
      if (u >= 0) {
        if (u != ub || qo != qb) {
          bank.template b_quad<R>(u, q_lo + qo, d_out, b);
          ub = u, qb = qo;
        }
        expand_rows<T, R, 1>(s.xa + i * R, 0, b, scale, yq + (size_t)i * d_out, 0);
      } else {
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        store_quad(yq + (size_t)i * d_out, zero);
      }
    }
  }
}

// --- any rank 1..256, any width: scalar reads, the same order ---------------

template <typename T, int Q8>
__global__ void __launch_bounds__(MAX_WARPS * 32) multi_lora_any_kernel(
    const T* __restrict__ x, const typename BankOf<Q8>::type bank, const int* __restrict__ idx,
    T* __restrict__ y, int T_rows, int U, int d_in, int r, int d_out, float scale, int tile,
    int slice_quads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ns = blockDim.x, nw = ns >> 5;
  const int row0 = blockIdx.x * tile, rows = min(tile, T_rows - row0);
  const int nq_in = (d_in + 3) >> 2, d4 = 4 * nq_in;
  const int q_lo = blockIdx.y * slice_quads;
  const int nq = min(slice_quads, ((d_out + 3) >> 2) - q_lo);
  const Smem s = smem_layout(smem, tile, nw, r);
  T* xs = static_cast<T*>(s.xs);

  for (int i = 0; i < rows; ++i)
    for (int d = tid; d < d_in; d += ns) xs[(size_t)i * d4 + d] = x[(size_t)(row0 + i) * d_in + d];
  if (tid < rows) {
    const int u = idx[row0 + tid];
    s.ids[tid] = u < 0 ? -1 : min(u, U - 1);
  }
  __syncthreads();

  for (int i = 0; i < rows; ++i) {
    const int u = s.ids[i];
    if (u < 0) continue;
    for (int jb = 0; jb < r; jb += 8) {   // the rank in blocks of 8
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      for (int q = tid; q < nq_in; q += ns) {
        for (int k = 0; k < 4 && 4 * q + k < d_in; ++k) {
          const int d = 4 * q + k;
          const float xv = to_f32(xs[(size_t)i * d4 + d]);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (jb + j < r) v[j] = __fmaf_rn(xv, bank.a(u, d, jb + j, d_in, r), v[j]);
        }
      }
      const float w = warp_sum_scatter<8, 16>(v, lane);
      const int j = jb + (lane >> 2);
      if ((lane & 3) == 0 && j < r) s.part[((size_t)i * nw + warp) * r + j] = w;
    }
  }
  __syncthreads();
  sum_warps(s, tid, ns, rows, nw, r);
  __syncthreads();

  const ExpandShare e(tid, ns, nq);
  if (e.i0 >= e.istep) return;
  for (int qo = e.q0; qo < nq; qo += e.qstep) {
    const int c0 = 4 * (q_lo + qo);
    for (int i = e.i0; i < rows; i += e.istep) {
      const int u = s.ids[i];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (u >= 0) {
        for (int j = 0; j < r; ++j) {
          const float xj = s.xa[(size_t)i * r + j];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < d_out) acc[c] = __fmaf_rn(xj, bank.b(u, j, c0 + c, r, d_out), acc[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = __fmul_rn(scale, acc[c]);
      }
      T* yr = y + (size_t)(row0 + i) * d_out;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < d_out) yr[c0 + c] = from_f32<T>(acc[c]);
    }
  }
}

// --- launch -----------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int Q8>
int launch(const void* x, const typename BankOf<Q8>::type& bank, bool bank_aligned,
           const int* idx, void* y, int T_rows, int U, int d_in, int r, int d_out,
           float scale, int tile, int slice_quads, cudaStream_t stream) {
  const int nw = shrink_warps(d_in);
  const int d4 = (d_in + 3) & ~3;
  const size_t smem = 4 * smem_floats(tile, nw, r) + (size_t)tile * d4 * sizeof(T);
  const dim3 grid((T_rows + tile - 1) / tile, ((d_out + 3) / 4 + slice_quads - 1) / slice_quads);
  if (smem > MAX_SMEM || grid.y > 65535) return -1;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool vec = bank_aligned && aligned16(x) && aligned16(y) && d_in % 4 == 0 &&
                   d_out % 4 == 0 && d_in <= 4 * 32 * MAX_WARPS;
  cudaError_t err;
#define ML_VEC(R)                                                                          \
  if (vec && r == R) {                                                                     \
    auto k = multi_lora_vec_kernel<T, Q8, R>;                                              \
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
    if (err != cudaSuccess) return (int)err;                                               \
    k<<<grid, 32 * nw, smem, stream>>>(xt, bank, idx, yt, T_rows, U, d_in, d_out, scale,   \
                                       tile, slice_quads);                                 \
    return (int)cudaGetLastError();                                                        \
  }
  ML_VEC(4)
  ML_VEC(8)
  ML_VEC(16)
#undef ML_VEC
  auto k = multi_lora_any_kernel<T, Q8>;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * nw, smem, stream>>>(xt, bank, idx, yt, T_rows, U, d_in, r, d_out, scale, tile,
                                     slice_quads);
  return (int)cudaGetLastError();
}

template <int Q8>
int dispatch(int dtype, const void* x, const typename BankOf<Q8>::type& bank, bool bank_aligned,
             const void* idx, void* y, int T_rows, int U, int d_in, int r, int d_out, float scale,
             int tile, int slice_quads, void* stream) {
  if (r < 1 || r > 256 || T_rows < 1 || U < 1 || d_in < 1 || d_out < 1 || tile < 1 ||
      tile > MAX_TILE || slice_quads < 1)
    return -1;
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float, Q8>(x, bank, bank_aligned, ix, y, T_rows, U, d_in, r, d_out, scale,
                             tile, slice_quads, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16, Q8>(x, bank, bank_aligned, ix, y, T_rows, U, d_in, r, d_out,
                                     scale, tile, slice_quads, s);
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// shape, dtype or plan the kernels do not take (r in [1, 256], tile in
// [1, 32] rows, slice_quads >= 1 output quads of 4 columns; the tile's x rows
// must fit in shared memory). tile and slice_quads come from
// kernels/multi_lora.py's plan; the bits do not depend on them.
extern "C" int multi_lora(const void* x, const void* A, const void* B, const void* idx,
                          void* y, int T_rows, int U, int d_in, int r, int d_out,
                          int dtype, float scale, int tile, int slice_quads, void* stream) {
  const BankF32 bank{static_cast<const float*>(A), static_cast<const float*>(B)};
  return dispatch<0>(dtype, x, bank, aligned16(A) && aligned16(B), idx, y, T_rows, U, d_in, r,
                     d_out, scale, tile, slice_quads, stream);
}

// The int8 bank: A_q, B_q int8 codes, A_scale (U, d_in), B_scale (U, r) f32.
// Same returns as multi_lora.
extern "C" int multi_lora_q8(const void* x, const void* A_q, const void* A_scale,
                             const void* B_q, const void* B_scale, const void* idx,
                             void* y, int T_rows, int U, int d_in, int r, int d_out,
                             int dtype, float scale, int tile, int slice_quads,
                             void* stream) {
  const BankQ8 bank{static_cast<const int8_t*>(A_q), static_cast<const float*>(A_scale),
                    static_cast<const int8_t*>(B_q), static_cast<const float*>(B_scale)};
  const bool al = aligned16(A_q) && aligned16(A_scale) && aligned16(B_q) && aligned16(B_scale);
  return dispatch<1>(dtype, x, bank, al, idx, y, T_rows, U, d_in, r, d_out, scale, tile,
                     slice_quads, stream);
}
