// Shared helpers of the port's tensor-core kernels (the bf16 flash forward
// and backward): inline PTX for cp.async, ldmatrix and mma.sync.m16n8k16
// (bf16 in, f32 accumulate), and the fragment loads built on them.
//
// Fragments of one m16n8k16 product, per lane (g = lane >> 2, t4 = lane & 3):
// A (16 x 16, row-major) holds rows g and g + 8, columns 2 t4 + {0, 1} and
// 2 t4 + 8 + {0, 1}; B (16 x 8) holds k = 2 t4 + {0, 1} (b0) and
// 2 t4 + 8 + {0, 1} (b1) of column g; the f32 accumulator C (16 x 8) holds
// rows g (c0, c1) and g + 8 (c2, c3), columns 2 t4 + {0, 1}. So two
// neighbouring n-tiles of C, rounded to bf16 and packed in pairs, are one
// A-fragment of the next product (pack_bf16).
#pragma once

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The three fragment loads of a 16 x 16 bf16 block at p in shared memory,
// row stride ld (rows on 16 bytes):
// A-fragment of a row-major [m][k] block
__device__ __forceinline__ void ld_a(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  ldmatrix_x4(r, p + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8);
}

// B-fragments of two n-tiles from a row-major [n][k] block (B = the block
// transposed): n-tile 0 is (r[0], r[1]), n-tile 1 is (r[2], r[3])
__device__ __forceinline__ void ld_b_nk(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  ldmatrix_x4(r, p + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
}

// B-fragments of two n-tiles from a row-major [k][n] block, by ldmatrix.trans
__device__ __forceinline__ void ld_b_kn(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  ldmatrix_x4_trans(r, p + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8);
}

// c += a b for one m16n8k16 tile: a row-major 16x16, b 16x8 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// n-tiles 2 kk and 2 kk + 1 of an f32 accumulator, in bf16, as the
// A-fragment of k-step kk of the next product
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 2^x in one MUFU instruction (ex2.approx.ftz: relative error ~2^-22; -inf
// and arguments below -126 give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The (min, max) position of each 64-row tile of pos[0, n) into range[t],
// by the block's NW warps (two positions a lane, then shuffles), UNROLL
// tiles a warp at a time so that their loads are in flight together. The
// caller syncs the block before reading range.
template <int NW, int UNROLL = 4>
__device__ __forceinline__ void tile_ranges(const int* __restrict__ pos, int n, int2* range,
                                            int warp, int lane) {
  const int n_tiles = (n + 63) / 64;
  for (int t0 = warp; t0 < n_tiles; t0 += NW * UNROLL) {
    int lo[UNROLL], hi[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * NW, j = t * 64 + lane, end = min(n, (t + 1) * 64);
      const int p0 = j < end ? pos[j] : INT_MAX, p1 = j + 32 < end ? pos[j + 32] : INT_MAX;
      lo[u] = min(p0, p1);
      hi[u] = max(j < end ? p0 : INT_MIN, j + 32 < end ? p1 : INT_MIN);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      lo[u] = warp_min_i(lo[u]);
      hi[u] = warp_max_i(hi[u]);
      if (lane == 0 && t0 + u * NW < n_tiles) range[t0 + u * NW] = make_int2(lo[u], hi[u]);
    }
  }
}
