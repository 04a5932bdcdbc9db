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
// int8 banks (replaces src/repro/kernels/multi_lora.py:_q8_kernel, entry
// multi_lora_q8): A and B are stored as int8 codes with one f32 scale per row
// (A_q (U, d_in, r) with A_scale (U, d_in, 1); B_q (U, r, d_out) with B_scale
// (U, r, 1)). The same kernel reads the codes and their row scales and
// dequantises each value in registers as it is used (code * scale, the plain
// version's product), so no f32 copy of the bank or of a user's rows is ever
// written to device memory, and the bank crosses the memory bus at a quarter
// of its f32 size. Unlike the TPU kernel, whose grid ran over all U adapters
// with a mask, each row still gathers only its own adapter.
//
// Rows with idx < 0 are padding and write exact zeros; idx >= U reads the
// last adapter, as the plain version's clamp does. Sums run in a fixed order
// with no atomics, so repeated runs give identical bits.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// One adapter's (A, B) as the kernel reads them: f32 values, or int8 codes
// with per-row f32 scales dequantised on load.
struct BankF32 {
  const float* A;
  const float* B;
  __device__ float a(size_t u, int d, int j, int d_in, int r) const {
    return __ldg(&A[(u * d_in + d) * r + j]);
  }
  __device__ float b(size_t u, int j, int c, int r, int d_out) const {
    return __ldg(&B[(u * r + j) * d_out + c]);
  }
};

struct BankQ8 {
  const int8_t* A;
  const float* A_scale;
  const int8_t* B;
  const float* B_scale;
  __device__ float a(size_t u, int d, int j, int d_in, int r) const {
    return (float)__ldg(&A[(u * d_in + d) * r + j]) * __ldg(&A_scale[u * d_in + d]);
  }
  __device__ float b(size_t u, int j, int c, int r, int d_out) const {
    return (float)__ldg(&B[(u * r + j) * d_out + c]) * __ldg(&B_scale[u * r + j]);
  }
};

template <typename T, typename Bank>
__global__ void __launch_bounds__(NT) multi_lora_kernel(
    const T* __restrict__ x, const Bank bank, const int* __restrict__ idx,
    T* __restrict__ y, int U, int d_in, int r, int d_out, float scale) {
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
  const size_t uu = (size_t)min(u, U - 1);
  for (int i = tid; i < d_in; i += NT) x_s[i] = to_f32(x[(size_t)t * d_in + i]);
  __syncthreads();

  // shrink: thread (rep, j) sums x[d] A[d, j] over d = rep, rep + nrep, ...;
  // for a fixed step the nrep * r threads read A contiguously
  const int nrep = NT / r;
  float s = 0.f;
  if (tid < nrep * r) {
    const int j = tid % r, rep = tid / r;
    for (int d = rep; d < d_in; d += nrep) s += x_s[d] * bank.a(uu, d, j, d_in, r);
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
    for (int j = 0; j < r; ++j) v += xa[j] * bank.b(uu, j, c, r, d_out);
    yt[c] = from_f32<T>(scale * v);
  }
}

template <typename T, typename Bank>
int launch(const void* x, const Bank& bank, const int* idx, void* y, int T_rows,
           int U, int d_in, int r, int d_out, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (d_in + NT + r);
  cudaError_t err = cudaFuncSetAttribute(
      multi_lora_kernel<T, Bank>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  multi_lora_kernel<T, Bank><<<T_rows, NT, smem, stream>>>(
      static_cast<const T*>(x), bank, idx, static_cast<T*>(y), U, d_in, r, d_out, scale);
  return (int)cudaGetLastError();
}

template <typename Bank>
int dispatch(int dtype, const void* x, const Bank& bank, const void* idx, void* y,
             int T_rows, int U, int d_in, int r, int d_out, float scale, void* stream) {
  if (r < 1 || r > NT || T_rows < 1) return -1;
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(x, bank, ix, y, T_rows, U, d_in, r, d_out, scale, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, bank, ix, y, T_rows, U, d_in, r, d_out, scale, s);
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// shape / dtype the kernel does not take (r must be in [1, 256]).
extern "C" int multi_lora(const void* x, const void* A, const void* B, const void* idx,
                          void* y, int T_rows, int U, int d_in, int r, int d_out,
                          int dtype, float scale, void* stream) {
  const BankF32 bank{static_cast<const float*>(A), static_cast<const float*>(B)};
  return dispatch(dtype, x, bank, idx, y, T_rows, U, d_in, r, d_out, scale, stream);
}

// The int8 bank: A_q, B_q int8 codes, A_scale (U, d_in), B_scale (U, r) f32.
// Same returns as multi_lora.
extern "C" int multi_lora_q8(const void* x, const void* A_q, const void* A_scale,
                             const void* B_q, const void* B_scale, const void* idx,
                             void* y, int T_rows, int U, int d_in, int r, int d_out,
                             int dtype, float scale, void* stream) {
  const BankQ8 bank{static_cast<const int8_t*>(A_q), static_cast<const float*>(A_scale),
                    static_cast<const int8_t*>(B_q), static_cast<const float*>(B_scale)};
  return dispatch(dtype, x, bank, idx, y, T_rows, U, d_in, r, d_out, scale, stream);
}
