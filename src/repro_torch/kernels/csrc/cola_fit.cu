// ColA fit gradient for Hopper (sm_90a): the offloaded Gradient-Learning step
// of the low-rank family, for every layer of a tap in one launch.
//
// Replaces the TPU kernel src/repro/kernels/cola_fit.py:_kernel (entry
// cola_fit_lowrank, which the JAX package vmaps over the layer axis):
//   dB = s (x A)^T g        dA = s x^T (g B^T)
// for x (L, T, d_in), g (L, T, d_out), A (L, d_in, r), B (L, r, d_out), all
// f32, with f32 accumulation. The (T, r) intermediates x A and g B^T never
// reach device memory.
//
// What bounds it on this card: x and g are read once and the work is
// 4 r (d_in + d_out) operations a row, ~8 a byte at r = 8, below the f32
// ridge of the CUDA cores (67e12 / 3.35e12 ~ 20), so it is bound by bytes.
// Tensor cores would not move that bound, and TF32 would break the f32
// tolerance the fit is held to, so it stays on the CUDA cores in f32.
//
// The design (fit_reg_kernel, the path's kernel):
// - Columns, not rows, are spread over the threads. Each thread owns CPT
//   fixed columns c of x (its warp is an "x warp") or of g (a "g warp"), and
//   holds in registers, for a whole chunk of rows, the weights of its
//   columns (A[c, :] or B[:, c]) and their accumulators (dA[c, :] or
//   dB[:, c]); rank and CPT are template parameters, so every inner loop is
//   unrolled and divides by nothing.
// - Row tiles stream through a ring of four shared-memory stages with
//   16-byte cp.async (a tile of whole rows is one contiguous span). A tile
//   takes three steps, one iteration apart: its partials, the warps' sums,
//   the accumulation. So each iteration works on three tiles while the next
//   is in flight, and a tile costs one barrier. Shared memory holds the
//   ring, not the accumulators.
// - Per row, one shared load of x[t, c] feeds RB FMAs into the thread's
//   partial of xa[t, :] (g[t, c] likewise into gb[t, :]). The partials of a
//   group of 32 / RB rows (32 values) are summed over the warp by a
//   reduce-scatter of 31 shuffles that leaves lane l with value l: each lane
//   keeps its partials in an order XOR-permuted by its lane id, so no step
//   needs a select. The warps' sums meet once in shared memory, are added in
//   warp order, and come back as broadcasts: the same x[t, c] then feeds RB
//   FMAs into dA[c, :] += x[t, c] gb[t, :], and g[t, c] RB FMAs into
//   dB[:, c] += xa[t, :] g[t, c].
// - The grid is one wave that fills the card: the L x ceil(T / TT) row tiles
//   of all layers are cut into as many contiguous, equal (within a tile)
//   chunks as the card holds blocks; a chunk may span a layer boundary, and
//   then writes one partial for each layer it touches (slot chunk + layer).
//   A second kernel adds each layer's partials in chunk order and scales.
//   No float atomics, so a refit gives the same bits every time.
// - Ranks other than 4, 8 and 16 run in rank blocks of the next size up
//   (zero-padded) on a second grid axis; each block computes its rank slice
//   (dA's columns and dB's rows of the slice depend on that slice alone).
// - Ragged T: the last tile's missing rows are zero-filled by the copy.
//   Widths that are no multiple of 4 or bases not 16-byte aligned copy 4
//   bytes at a time (the scalar edge path).
//
// Where a shape's accumulators do not fit the register kernel (more than
// 384 threads of CPT columns), fit_smem_kernel keeps them in shared memory,
// updated once per tile, with rank blocks of 8 and, where even that is too
// large, the columns split over a grid axis (each block computes the whole
// projection and accumulates its slice). It reads x and g through the
// cache instead of the ring. Same chunks, partials and reduction.
#include "common.cuh"
#include "mma.cuh"   // cp.async helpers

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_THREADS = 256;  // shared-memory kernel: 4 x warps + 4 g warps
// Ring stages of the register kernel: three tiles in use (partials,
// warps' sums, accumulation) and one in flight. A fifth stage (two in
// flight) measured no faster at the path's shapes.
constexpr int STAGES = 4;

struct FitArgs {
  const float* x;
  const float* g;
  const float* A;
  const float* B;
  float* part;        // (G + L - 1, (d_in + d_out) r): slot chunk + layer
  int T, d_in, d_out, r;
  int n_tiles;        // row tiles a layer
  long long work;     // L * n_tiles
  int tt;             // rows a tile (a template constant of the register kernel)
  int wx;             // warps on x columns; the others are on g columns
  int vec;            // 16-byte copies
  int n_split, slice; // column split (shared-memory kernel)
};

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// One step of reduce_scatter32: keep slots [0, H), add the partner's upper
// half. Steps are templates so every index is a constant and v stays in
// registers.
template <int H>
__device__ __forceinline__ void scatter_step(float (&v)[32]) {
#pragma unroll
  for (int s = 0; s < H; ++s) v[s] += __shfl_xor_sync(FULL, v[s + H], H);
}

// Sum 32 values over the warp; lane l returns the sum of value l. On entry
// slot s of lane l holds the lane's partial of value s ^ l.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32]) {
  scatter_step<16>(v);
  scatter_step<8>(v);
  scatter_step<4>(v);
  scatter_step<2>(v);
  scatter_step<1>(v);
  return v[0];
}

// o[0, n_o) = xa, o[n_o, 2 n_o) = gb of the tile: the x warps' and the g
// warps' sums added in warp order.
__device__ __forceinline__ void sum_warps(const float* red, float* o, int n_o,
                                          int wx, int nw) {
  for (int q = threadIdx.x; q < 2 * n_o; q += blockDim.x) {
    const bool qx = q < n_o;
    const int idx = qx ? q : q - n_o;
    float s = 0.f;
    for (int w = qx ? 0 : wx; w < (qx ? wx : nw); ++w) s += red[w * n_o + idx];
    o[q] = s;
  }
}

// This block's chunk: flattened (layer, tile) indices [f0, f1).
__device__ __forceinline__ void chunk(const FitArgs& a, long long& f0, long long& f1) {
  f0 = (long long)blockIdx.x * a.work / gridDim.x;
  f1 = (long long)(blockIdx.x + 1) * a.work / gridDim.x;
}

// One tile of tt rows, x rows then g rows, into a ring stage; rows past the
// end of the layer are zero-filled (their partials and products are zero).
__device__ __forceinline__ void load_tile(const FitArgs& a, int tt, float* stage, int l,
                                          int tile) {
  const int t0 = tile * tt;
  const int nt = min(tt, a.T - t0);
  const float* src[2] = {a.x + ((size_t)l * a.T + t0) * a.d_in,
                         a.g + ((size_t)l * a.T + t0) * a.d_out};
  const int width[2] = {a.d_in, a.d_out};
  float* dst = stage;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (a.vec) {
      const int n = tt * width[m] / 4, full = nt * width[m] / 4;
      for (int q = threadIdx.x; q < n; q += blockDim.x)
        cp_async16(dst + 4 * q, src[m] + 4 * (q < full ? q : 0), q < full);
    } else {
      const int n = tt * width[m], full = nt * width[m];
      for (int q = threadIdx.x; q < n; q += blockDim.x)
        cp_async4(dst + q, src[m] + (q < full ? q : 0), q < full);
    }
    dst += tt * width[m];
  }
}

// Most threads a block of fit_reg_kernel<RB, CPT, TT> takes (its launch
// bound): 12 warps, and 11 where 6 columns of rank 8 need more registers.
__host__ __device__ constexpr int reg_threads(int rb, int cpt) {
  return rb == 8 && cpt == 6 ? 352 : 384;
}

// One block per chunk (and rank block). Tile i of the chunk goes through
// three steps, in three consecutive iterations separated by one barrier
// each: the partials of its xa / gb rows (into red[i % 2]); the warps' sums
// (red -> o[i % 2]); the accumulation from o. So one barrier a tile, and the
// warps of a step never wait on each other within it.
template <int RB, int CPT, int TT>
__global__ void __launch_bounds__(reg_threads(RB, CPT), 1) fit_reg_kernel(FitArgs a) {
  constexpr int RG = 32 / RB;        // rows a reduce-scatter group
  constexpr int LG = log2i(RB);
  constexpr int NO = TT * RB;        // a tile's xa (or gb) values
  static_assert(TT % RG == 0, "tile rows must be whole reduce-scatter groups");
  extern __shared__ __align__(16) float smem[];
  const int D = a.d_in + a.d_out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const bool kx = warp < a.wx;
  const int dk = kx ? a.d_in : a.d_out;                 // this kind's width
  const int kstride = 32 * (kx ? a.wx : nw - a.wx);
  const int c0 = (kx ? warp : warp - a.wx) * 32 + lane;
  const int rb0 = blockIdx.y * RB;
  const int mrow = lane >> LG, mj = lane & (RB - 1);    // the lane's permutation
  const int stage_floats = TT * D;
  float* ring = smem;                                           // STAGES x TT x D
  float* red = smem + ((STAGES * stage_floats + 3) & ~3);       // 2 x nw x NO
  float* o = red + 2 * nw * NO;                                 // 2 x (xa, gb)
  const int koff = kx ? 0 : TT * a.d_in;
  const int ooff = kx ? NO : 0;      // x columns take gb, g columns xa
  const size_t n_acc = (size_t)D * a.r;

  int ck[CPT];
  bool valid[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    ck[k] = c0 + k * kstride;
    valid[k] = ck[k] < dk;
  }
  int rowoff[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) rowoff[i] = (i ^ mrow) * dk;

  float w[CPT][RB], acc[CPT][RB];   // w[k][j] = weight of rank j ^ mj
  auto load_w = [&](int l) {
#pragma unroll
    for (int k = 0; k < CPT; ++k)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int jj = rb0 + (j ^ mj);
        float v = 0.f;
        if (valid[k] && jj < a.r)
          v = kx ? a.A[((size_t)l * a.d_in + ck[k]) * a.r + jj]
                 : a.B[((size_t)l * a.r + jj) * a.d_out + ck[k]];
        w[k][j] = v;
      }
  };
  auto flush = [&](int l) {
    float* out = a.part + (size_t)(blockIdx.x + l) * n_acc;
#pragma unroll
    for (int k = 0; k < CPT; ++k)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (valid[k] && rb0 + j < a.r) {
          if (kx)
            out[(size_t)ck[k] * a.r + rb0 + j] = acc[k][j];
          else
            out[(size_t)a.d_in * a.r + (size_t)(rb0 + j) * a.d_out + ck[k]] = acc[k][j];
        }
        acc[k][j] = 0.f;
      }
  };

  long long f0, f1;
  chunk(a, f0, f1);
  const int n = (int)(f1 - f0);
  // cursors (layer, tile, stage) of the loads, the partials, the accumulation
  int ll = (int)(f0 / a.n_tiles), lt = (int)(f0 % a.n_tiles), ls = 0;
  int lp = ll, tp = lt, ps = 0;
  int la = ll, ta = lt, as = 0;
  auto next = [](int& st) { st = st + 1 == STAGES ? 0 : st + 1; };
  load_tile(a, TT, ring, ll, lt);   // tile 0 (a chunk has at least one)
  if (++lt == a.n_tiles) lt = 0, ++ll;
  next(ls);
  cp_async_commit();
  load_w(lp);
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[k][j] = 0.f;

  for (int i = 0; i < n + 2; ++i) {
    cp_async_wait<0>();
    // tile i is in for every thread; tile i - 3's stage, red[i % 2] and
    // o[(i - 1) % 2] are free
    __syncthreads();
    if (i + 1 < n) {
      load_tile(a, TT, ring + ls * stage_floats, ll, lt);
      if (++lt == a.n_tiles) lt = 0, ++ll;
      next(ls);
    }
    cp_async_commit();

    if (i >= 1 && i <= n)   // the warps' sums of tile i - 1
      sum_warps(red + ((i - 1) & 1) * nw * NO, o + ((i - 1) & 1) * 2 * NO, NO, a.wx, nw);

    if (i < n) {            // partials of tile i's xa (x warps) or gb (g warps)
      if (i > 0 && tp == 0) load_w(lp);
      const float* sk = ring + ps * stage_floats + koff;
      float* rw = red + (i & 1) * nw * NO + warp * NO;
#pragma unroll 1
      for (int i0 = 0; i0 < TT; i0 += RG) {
        float p[RG * RB];
#pragma unroll
        for (int q = 0; q < RG * RB; ++q) p[q] = 0.f;
        const float* rows = sk + i0 * dk;
#pragma unroll
        for (int k = 0; k < CPT; ++k)
#pragma unroll
          for (int ii = 0; ii < RG; ++ii) {
            const float v = valid[k] ? rows[rowoff[ii] + ck[k]] : 0.f;
#pragma unroll
            for (int j = 0; j < RB; ++j) p[ii * RB + j] = fmaf(v, w[k][j], p[ii * RB + j]);
          }
        rw[i0 * RB + lane] = reduce_scatter32(p);
      }
      if (++tp == a.n_tiles) tp = 0, ++lp;
      next(ps);
    }

    if (i >= 2) {           // dA[c, :] += x[t, c] gb[t, :], dB[:, c] += xa[t, :] g[t, c]
      const float* sk = ring + as * stage_floats + koff;
      const float* other = o + (i & 1) * 2 * NO + ooff;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        float ot[RB];
#pragma unroll
        for (int j = 0; j < RB; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(other + t * RB + j);
          ot[j] = q.x, ot[j + 1] = q.y, ot[j + 2] = q.z, ot[j + 3] = q.w;
        }
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const float v = valid[k] ? sk[t * dk + ck[k]] : 0.f;
#pragma unroll
          for (int j = 0; j < RB; ++j) acc[k][j] = fmaf(v, ot[j], acc[k][j]);
        }
      }
      next(as);
      if (++ta == a.n_tiles || i - 2 == n - 1) {
        flush(la);
        ta = 0, ++la;
      }
    }
  }
}

template <int RB>
__global__ void __launch_bounds__(SMEM_THREADS) fit_smem_kernel(FitArgs a) {
  constexpr int RG = 32 / RB;
  constexpr int LG = log2i(RB);
  constexpr int NW = SMEM_THREADS / 32, WX = NW / 2;
  extern __shared__ __align__(16) float smem[];
  const int D = a.d_in + a.d_out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool kx = warp < WX;
  const int dk = kx ? a.d_in : a.d_out;
  const float* src = kx ? a.x : a.g;
  const int c0 = (kx ? warp : warp - WX) * 32 + lane;
  const int rbi = blockIdx.y / a.n_split;
  const int rb0 = rbi * RB;
  const int cs0 = (blockIdx.y - rbi * a.n_split) * a.slice;
  const int ns = min(D, cs0 + a.slice) - cs0;     // columns of this block's slice
  const int mrow = lane >> LG, mj = lane & (RB - 1);
  const int n_o = a.tt * RB;
  float* acc = smem;                // slice x RB
  float* red = acc + a.slice * RB;  // NW x tt x RB
  float* o = red + NW * n_o;        // xa, gb
  const size_t n_acc = (size_t)D * a.r;

  auto flush = [&](int l) {
    float* out = a.part + (size_t)(blockIdx.x + l) * n_acc;
    for (int e = tid; e < ns; e += SMEM_THREADS) {
      const int ce = cs0 + e;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (rb0 + j >= a.r) break;
        if (ce < a.d_in)
          out[(size_t)ce * a.r + rb0 + j] = acc[e * RB + j];
        else
          out[(size_t)a.d_in * a.r + (size_t)(rb0 + j) * a.d_out + ce - a.d_in] =
              acc[e * RB + j];
        acc[e * RB + j] = 0.f;
      }
    }
  };
  for (int q = tid; q < ns * RB; q += SMEM_THREADS) acc[q] = 0.f;

  long long f0, f1;
  chunk(a, f0, f1);
  const int n = (int)(f1 - f0);
  int l = (int)(f0 / a.n_tiles), tile = (int)(f0 % a.n_tiles);
  for (int i = 0; i < n; ++i) {
    const int t0 = tile * a.tt;
    const int nt = min(a.tt, a.T - t0);
    const float* rows_l = src + ((size_t)l * a.T + t0) * dk;
    for (int i0 = 0; i0 < nt; i0 += RG) {
      float p[RG * RB];
#pragma unroll
      for (int q = 0; q < RG * RB; ++q) p[q] = 0.f;
      for (int c = c0; c < dk; c += 32 * WX) {
        float wv[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int jj = rb0 + (j ^ mj);
          wv[j] = jj >= a.r ? 0.f
                  : kx ? __ldg(a.A + ((size_t)l * a.d_in + c) * a.r + jj)
                       : __ldg(a.B + ((size_t)l * a.r + jj) * a.d_out + c);
        }
#pragma unroll
        for (int ii = 0; ii < RG; ++ii) {
          const int row = i0 + (ii ^ mrow);
          const float v = row < nt ? __ldg(rows_l + (size_t)row * dk + c) : 0.f;
#pragma unroll
          for (int j = 0; j < RB; ++j) p[ii * RB + j] = fmaf(v, wv[j], p[ii * RB + j]);
        }
      }
      red[warp * n_o + i0 * RB + lane] = reduce_scatter32(p);
    }
    __syncthreads();
    sum_warps(red, o, n_o, WX, NW);
    __syncthreads();
    for (int e = tid; e < ns; e += SMEM_THREADS) {
      const int ce = cs0 + e;
      const bool ex = ce < a.d_in;
      const int w = ex ? a.d_in : a.d_out;
      const float* col = (ex ? a.x + ce : a.g + ce - a.d_in) + ((size_t)l * a.T + t0) * w;
      const float* ob = o + (ex ? n_o : 0);
      float s[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) s[j] = acc[e * RB + j];
      for (int t = 0; t < nt; ++t) {
        const float v = __ldg(col + (size_t)t * w);
#pragma unroll
        for (int j = 0; j < RB; ++j) s[j] = fmaf(v, ob[t * RB + j], s[j]);
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[e * RB + j] = s[j];
    }
    if (++tile == a.n_tiles || i == n - 1) {
      flush(l);
      tile = 0;
      ++l;
    }
  }
}

// dA, dB = scale * (sum of each layer's chunk partials, in chunk order).
// Layer l's chunks are b1..b2: the chunks whose tiles meet [l n, (l + 1) n).
__global__ void __launch_bounds__(256) cola_fit_reduce(
    const float* __restrict__ part, float* __restrict__ dA, float* __restrict__ dB,
    int n_tiles, long long work, int G, int d_in, int d_out, int r, float scale) {
  const int n_a = d_in * r;
  const int n_acc = n_a + r * d_out;
  const int l = blockIdx.y;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n_acc) return;
  const long long lo = (long long)l * n_tiles, hi = lo + n_tiles;
  const int b1 = (int)(((lo + 1) * G - 1) / work);
  const int b2 = (int)((hi * G - 1) / work);
  float s = 0.f;
  for (int b = b1; b <= b2; ++b) s += part[(size_t)(b + l) * n_acc + e];
  s *= scale;
  if (e < n_a)
    dA[(size_t)l * n_a + e] = s;
  else
    dB[(size_t)l * r * d_out + (e - n_a)] = s;
}

using Kernel = void (*)(FitArgs);

Kernel pick(int variant, int rb, int cpt) {
  if (variant == 1 && rb == 8) return &fit_smem_kernel<8>;
  if (variant != 0) return nullptr;
  if (rb == 4 && cpt == 6) return &fit_reg_kernel<4, 6, 8>;
  if (rb == 8 && cpt == 3) return &fit_reg_kernel<8, 3, 8>;
  if (rb == 8 && cpt == 6) return &fit_reg_kernel<8, 6, 4>;
  if (rb == 16 && cpt == 3) return &fit_reg_kernel<16, 3, 8>;
  return nullptr;
}

}  // namespace

// How many blocks of one instantiation (variant 0: registers, rank block rb,
// cpt columns a thread; variant 1: shared memory) one SM holds at once; -1
// for an instantiation that does not exist.
extern "C" int cola_fit_blocks_per_sm(int variant, int rb, int cpt, int threads,
                                      int smem) {
  Kernel k = pick(variant, rb, cpt);
  if (k == nullptr) return -1;
  int n = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

// cfg: variant, rb, cpt, threads, wx, tt, smem, chunks (G), rank blocks,
// column splits, slice, vec. part: (G + L - 1) (d_in + d_out) r
// floats. Returns cudaGetLastError() after the two launches (0 on success;
// -1 for a configuration no instantiation takes).
extern "C" int cola_fit(const void* x, const void* g, const void* A, const void* B,
                        void* part, void* dA, void* dB, int L, int T, int d_in,
                        int d_out, int r, const int* cfg, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = cfg[0], rb = cfg[1], cpt = cfg[2], threads = cfg[3];
  const int smem = cfg[6], G = cfg[7], n_rb = cfg[8], n_split = cfg[9];
  Kernel k = pick(variant, rb, cpt);
  if (k == nullptr) return -1;
  FitArgs a;
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B);
  a.part = static_cast<float*>(part);
  a.T = T, a.d_in = d_in, a.d_out = d_out, a.r = r;
  a.tt = cfg[5];
  a.n_tiles = (T + a.tt - 1) / a.tt;
  a.work = (long long)L * a.n_tiles;
  a.wx = cfg[4];
  a.vec = cfg[11];
  a.n_split = n_split, a.slice = cfg[10];
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<dim3(G, n_rb * n_split), threads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_acc = (d_in + d_out) * r;
  cola_fit_reduce<<<dim3((n_acc + 255) / 256, L), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dA), static_cast<float*>(dB),
      a.n_tiles, a.work, G, d_in, d_out, r, scale);
  return (int)cudaGetLastError();
}
