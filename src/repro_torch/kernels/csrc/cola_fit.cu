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
// 4 r (d_in + d_out) multiply-adds per row, ~8 operations per byte at r = 8,
// well below the f32 ridge, so it is bound by bytes. What the design does
// about it: the token axis T is split into chunks across blocks (grid:
// chunks x L, as many blocks as the card holds at once, so one wave) and
// every row is read once, in coalesced tiles staged through shared memory.
// The dot products keep four independent partial sums, so a thread's
// multiply-adds do not wait on each other. Each block keeps its partial
// dA and dB in shared memory and writes them once; a second kernel adds the
// chunks' partials in chunk order. No float atomics, so a refit gives the
// same bits every time (the chaos suite compares refits bit for bit).
#include "common.cuh"

namespace {

constexpr int NT = 256;

// sum_{i < n} a[i * sa] * b[i * sb] with four independent partial sums,
// added in a fixed order, so the result depends on n alone. a and b may be
// in shared or device memory (generic loads).
__device__ __forceinline__ float dot4(const float* a, int sa, const float* b,
                                      int sb, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    s0 += a[i * sa] * b[(size_t)i * sb];
    s1 += a[(i + 1) * sa] * b[(size_t)(i + 1) * sb];
    s2 += a[(i + 2) * sa] * b[(size_t)(i + 2) * sb];
    s3 += a[(i + 3) * sa] * b[(size_t)(i + 3) * sb];
  }
  for (; i < n; ++i) s0 += a[i * sa] * b[(size_t)i * sb];
  return (s0 + s1) + (s2 + s3);
}

// One block per (chunk, layer): partial dA and dB over rows
// [chunk * rows_per, min(T, (chunk + 1) * rows_per)), in tiles of tt rows.
// part: (L, n_chunks, (d_in + d_out) r), dA entries (c r + j) first, then dB
// entries (j d_out + c).
__global__ void __launch_bounds__(NT) cola_fit_partial(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ part, int T, int d_in, int d_out, int r, int rows_per,
    int tt) {
  extern __shared__ float smem[];
  const int n_a = d_in * r;
  const int n_acc = n_a + r * d_out;
  const int lx = d_in + 1, lg = d_out + 1;   // padded rows: no bank conflicts
  float* acc = smem;                 // n_acc
  float* x_s = acc + n_acc;          // tt x lx
  float* g_s = x_s + tt * lx;        // tt x lg
  float* xa_s = g_s + tt * lg;       // tt x r
  float* gb_s = xa_s + tt * r;       // tt x r

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, l = blockIdx.y;
  x += (size_t)l * T * d_in;
  g += (size_t)l * T * d_out;
  A += (size_t)l * d_in * r;
  Bm += (size_t)l * r * d_out;

  for (int e = tid; e < n_acc; e += NT) acc[e] = 0.f;
  const int t_begin = chunk * rows_per;
  const int t_end = min(T, t_begin + rows_per);
  for (int t0 = t_begin; t0 < t_end; t0 += tt) {
    const int nt = min(tt, t_end - t0);
    __syncthreads();   // the previous tile's readers are done
    for (int f = tid; f < tt * d_in; f += NT) {
      const int t = f / d_in, c = f % d_in;
      x_s[t * lx + c] = t < nt ? x[(size_t)(t0 + t) * d_in + c] : 0.f;
    }
    for (int f = tid; f < tt * d_out; f += NT) {
      const int t = f / d_out, c = f % d_out;
      g_s[t * lg + c] = t < nt ? g[(size_t)(t0 + t) * d_out + c] : 0.f;
    }
    __syncthreads();
    // xa = x A and gb = g B^T for the tile's rows
    for (int o = tid; o < 2 * tt * r; o += NT) {
      if (o < tt * r) {
        const int t = o / r, j = o % r;
        xa_s[o] = dot4(x_s + t * lx, 1, A + j, r, d_in);
      } else {
        const int o2 = o - tt * r, t = o2 / r, j = o2 % r;
        gb_s[o2] = dot4(g_s + t * lg, 1, Bm + (size_t)j * d_out, 1, d_out);
      }
    }
    __syncthreads();
    // each thread owns its accumulator entries: no two threads add to one
    for (int e = tid; e < n_acc; e += NT) {
      if (e < n_a) {
        const int c = e / r, j = e % r;
        acc[e] += dot4(x_s + c, lx, gb_s + j, r, nt);
      } else {
        const int e2 = e - n_a, j = e2 / d_out, c = e2 % d_out;
        acc[e] += dot4(xa_s + j, r, g_s + c, lg, nt);
      }
    }
  }
  __syncthreads();
  float* out = part + ((size_t)l * gridDim.x + chunk) * n_acc;
  for (int e = tid; e < n_acc; e += NT) out[e] = acc[e];
}

// dA, dB = scale * (sum of the chunks' partials, in chunk order).
__global__ void __launch_bounds__(NT) cola_fit_reduce(
    const float* __restrict__ part, float* __restrict__ dA, float* __restrict__ dB,
    int n_chunks, int d_in, int d_out, int r, float scale) {
  const int n_a = d_in * r;
  const int n_acc = n_a + r * d_out;
  const int l = blockIdx.y;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= n_acc) return;
  const float* p = part + (size_t)l * n_chunks * n_acc + e;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += p[(size_t)c * n_acc];
  s *= scale;
  if (e < n_a)
    dA[(size_t)l * n_a + e] = s;
  else
    dB[(size_t)l * r * d_out + (e - n_a)] = s;
}

}  // namespace

// Shared memory one partial block needs for tiles of tt rows.
extern "C" size_t cola_fit_smem_bytes(int d_in, int d_out, int r, int tt) {
  return sizeof(float) * ((size_t)(d_in + d_out) * r + (size_t)tt * (d_in + 1) +
                          (size_t)tt * (d_out + 1) + 2 * (size_t)tt * r);
}

// How many partial blocks with tiles of tt rows one SM holds at once.
extern "C" int cola_fit_blocks_per_sm(int d_in, int d_out, int r, int tt) {
  const size_t smem = cola_fit_smem_bytes(d_in, d_out, r, tt);
  int n = 0;
  if (cudaFuncSetAttribute(cola_fit_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cola_fit_partial, NT, smem) !=
          cudaSuccess)
    return 0;
  return n;
}

// Returns cudaGetLastError() after the two launches (0 on success). part is
// scratch of L * n_chunks * (d_in + d_out) * r floats.
extern "C" int cola_fit(const void* x, const void* g, const void* A, const void* B,
                        void* part, void* dA, void* dB, int L, int T, int d_in,
                        int d_out, int r, int n_chunks, int rows_per, int tt,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = cola_fit_smem_bytes(d_in, d_out, r, tt);
  cudaError_t err = cudaFuncSetAttribute(
      cola_fit_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cola_fit_partial<<<dim3(n_chunks, L), NT, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(part), T, d_in, d_out, r, rows_per, tt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_acc = (d_in + d_out) * r;
  cola_fit_reduce<<<dim3((n_acc + NT - 1) / NT, L), NT, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dA), static_cast<float*>(dB),
      n_chunks, d_in, d_out, r, scale);
  return (int)cudaGetLastError();
}
