// Multi-LoRA apply for Hopper (sm_90a): y[t] = s * (x[t] A[idx[t]]) B[idx[t]].
//
// Replaces the TPU kernel src/repro/kernels/multi_lora.py:_kernel (entry
// multi_lora). The TPU ran U masked passes over every token block so that it
// never gathered; on this card a gather is cheap, so the kernel uses the
// BGMV idiom of Punica and S-LoRA instead: each token row reads its own
// adapter A[idx[t]], B[idx[t]]. That design and compact_resident are not
// carried over.
//
// What bounds it on this card: with rank r = 8 the work is 2 r (d_in + d_out)
// FLOPs per row against 2 (d_in + d_out) bytes of bf16 x and y, about r / 2
// FLOPs per byte, so it is bound by memory. What the design does about that:
// x and y cross device memory once per row; the shrink result x A (r values,
// f32) never leaves shared memory (shrink and expand are one launch); the
// bank (U adapters of (d_in + d_out) r f32 values) is small enough to stay in
// the 50 MB L2 across the token rows that share it. One block per row keeps
// each output row a function of its own x row and its own adapter only, so
// serving from any subset of resident adapters gives identical bits.
//
// Rows with idx < 0 are padding and write exact zeros; idx >= U reads the
// last adapter, as the plain version's clamp does. Sums run in a fixed order
// with no atomics, so repeated runs give identical bits.
#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT) multi_lora_kernel(
    const T* __restrict__ x, const float* __restrict__ A, const float* __restrict__ Bm,
    const int* __restrict__ idx, T* __restrict__ y, int U, int d_in, int r,
    int d_out, float scale) {
  extern __shared__ float smem[];
  float* x_s = smem;          // d_in
  float* part = x_s + d_in;   // NT partial sums of the shrink step
  float* xa = part + NT;      // r

  const int t = blockIdx.x, tid = threadIdx.x;
  const int u = idx[t];
  T* yt = y + (size_t)t * d_out;
  if (u < 0) {
    for (int c = tid; c < d_out; c += NT) yt[c] = from_f32<T>(0.f);
    return;
  }
  const int uu = min(u, U - 1);
  const float* a = A + (size_t)uu * d_in * r;
  const float* bm = Bm + (size_t)uu * r * d_out;
  for (int i = tid; i < d_in; i += NT) x_s[i] = to_f32(x[(size_t)t * d_in + i]);
  __syncthreads();

  // shrink: thread (rep, j) sums x[d] A[d, j] over d = rep, rep + nrep, ...;
  // for a fixed step the nrep * r threads read A contiguously
  const int nrep = NT / r;
  float s = 0.f;
  if (tid < nrep * r) {
    const int j = tid % r, rep = tid / r;
    for (int d = rep; d < d_in; d += nrep) s += x_s[d] * a[(size_t)d * r + j];
  }
  part[tid] = s;
  __syncthreads();
  if (tid < r) {
    float v = 0.f;
    for (int q = 0; q < nrep; ++q) v += part[q * r + tid];
    xa[tid] = v;
  }
  __syncthreads();

  // expand: each thread owns output columns c = tid, tid + NT, ...
  for (int c = tid; c < d_out; c += NT) {
    float v = 0.f;
    for (int j = 0; j < r; ++j) v += xa[j] * bm[(size_t)j * d_out + c];
    yt[c] = from_f32<T>(scale * v);
  }
}

template <typename T>
int launch(const void* x, const float* A, const float* Bm, const int* idx, void* y,
           int T_rows, int U, int d_in, int r, int d_out, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (d_in + NT + r);
  cudaError_t err = cudaFuncSetAttribute(
      multi_lora_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  multi_lora_kernel<T><<<T_rows, NT, smem, stream>>>(
      static_cast<const T*>(x), A, Bm, idx, static_cast<T*>(y), U, d_in, r, d_out, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// shape / dtype the kernel does not take (r must be in [1, 256]).
extern "C" int multi_lora(const void* x, const void* A, const void* B, const void* idx,
                          void* y, int T_rows, int U, int d_in, int r, int d_out,
                          int dtype, float scale, void* stream) {
  if (r < 1 || r > NT || T_rows < 1) return -1;
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(x, a, b, ix, y, T_rows, U, d_in, r, d_out, scale, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, a, b, ix, y, T_rows, U, d_in, r, d_out, scale, s);
  return -1;
}
