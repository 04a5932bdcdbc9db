// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// each in two versions behind one C entry, chosen by dtype.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:_bwd_dq_kernel
// and _bwd_dkv_kernel (launched by _bwd). Both recompute the scores of a
// (q tile, kv tile) pair from q, k, the forward's lse and
// delta = rowsum(do * o) (computed by the caller):
//   p = exp(s - lse) under the mask, dp = do v^T, ds = p (dp - delta)
//   (times 1 - tanh^2 under softcap), dq = scale ds k, dk = scale ds^T q,
//   dv = p^T do.
// Masking is by per-row positions (q_pos (Bq, Sq), kv_pos (Bk, Sk), Bq/Bk in
// {1, B}), as in the forward kernel, so the gradients are exact for any
// positions. A tile pair whose position ranges cannot meet under the causal
// mask or the window is skipped before its operands are read. A masked score
// is -inf before the exponent, so a q row that sees no key (lse -1e30) gives
// dq = 0 and adds nothing to dk/dv. dk/dv: one block owns a kv tile of one kv
// head and walks the q tiles of all G q-heads of its group in a fixed order,
// so dk and dv come out summed over the group inside the kernel, with no
// atomics: two runs give the same bits. (The TPU kernel wrote one dk/dv per
// q-head and summed the G of a group afterwards.) Outputs are in the inputs'
// dtype.
//
// What bounds them on this card: at the training path's shape (B 32, S 128,
// 9 / 3 heads, Dh 64) a pair of tiles does ~S/2 multiply-adds per byte it
// reads, above the bytes bound but far below the tensor cores' ridge; each
// block walks at most 2 tiles (dq) or G x 2 = 6 (dk/dv), so the kernels are
// bound by latency: the block's start (its first loads from a cold L2) and
// the serial chain of each step, and for dk/dv the 6 steps of the blocks of
// the first kv tile, which end last. The G-sum stays in the block
// (determinism), so the walk is not split across blocks.
//
// bf16: flash_bwd_dq_tc_kernel and flash_bwd_dkv_tc_kernel, on the tensor
// cores, with the fragment algebra of the forward (mma.cuh). Each block runs
// 4 warps, each warp one 16-row slab of the block's 64-row tile; every
// product is mma.sync.m16n8k16 (bf16 in, f32 accumulate), every intermediate
// stays in registers, and the tile walked over is double-buffered in shared
// memory with 16-byte cp.async (the first tile's copy starts before the
// block knows it is live; ragged tails zero-filled).
//   dq (a 64-row q tile; walks the kv tiles): S = Q K^T and dP = dO V^T with
//   Q and dO as A-fragments, K and V as B-fragments by ldmatrix; P and dS in
//   registers; dQ += dS K with dS's accumulators repacked as the A-fragment
//   and K by ldmatrix.trans. The grid takes the causally heavy q tiles first.
//   dk/dv (a 64-row kv tile; walks G heads x q tiles, the last q tile first,
//   which a causal mask never skips): the transposed products, so that the
//   kv rows are the fragments' rows: S^T = K Q^T and dP^T = V dO^T with K and
//   V as A-fragments and Q, dO by ldmatrix; dV += P^T dO and dK += dS^T Q
//   with P^T and dS^T repacked as A-fragments and dO, Q by ldmatrix.trans; Q,
//   dO, lse, delta and the q positions staged per step. The grid takes the
//   heavy (early) kv tiles first.
// P and dS are rounded to bf16 before their products (as the library
// rounds them): a relative 2^-9 on each term of dv, dk and dq before the
// sum, inside the bf16 tolerance of 2^-7 (1 + max |plain|) against the plain
// version. Registers: dq reads its A-fragments (Q, dO) from shared memory
// at each k-step, which keeps it at three blocks an SM; dk/dv, one wave at
// the training shape, holds K's and V's for the whole walk at d_head <= 64.
// At 128 that would pass the 255-register limit (K and V 64, dK and dV 128,
// S^T and dP^T 64), so there they are re-read as well, and each q tile is
// taken in two halves of 32 columns (S^T and dP^T 32).
//
// f32: flash_bwd_dq_f32_kernel and flash_bwd_dkv_f32_kernel, on the CUDA
// cores: the card's oracle (the f32 training step must match the CPU's
// within 1e-5, which TF32 tensor cores would break). Scalar FMAs from f32
// tiles in shared memory, two threads per row; each gradient written once.
//
// d_head 256 (gemma2's training path: 1 x 4608, 16 / 8 heads, window 4096,
// softcap 50) has its own tiling where the one above does not fit; the
// d_head 16-128 instantiations are unchanged. bf16 dq: dQ's accumulator is
// 128 registers a thread, so S and dP are taken over half a kv tile at a
// time (KW = 32 kv rows: 16 registers each). bf16 dk/dv: a warp's dK and
// dV for a 16-row slab at 256 columns would be 256 registers alone, so two
// warps share a slab (DSPLIT, 8 warps a block), each holding 128 of dK's and
// dV's columns; both compute the slab's S^T and dP^T over the whole d_head
// (it has to be whole for either half), which spends 1.5x the tensor-core
// work of one warp a slab but keeps everything in registers with no
// exchange through shared memory; S^T and dP^T are taken over half the q
// tile at a time (QW = 32, as at 128). In both kernels the 16 k-steps of S
// (S^T) are unrolled four at a time (KU), so that ptxas keeps every value
// in registers. Shared memory at 256 is 6 x 64 x 264 bf16
// (202,752 bytes) plus the positions: one block an SM. f32: 32-row tiles
// and four threads a row (F32Tile), so that the tiles fit shared memory and
// a thread's columns its registers.
//
// d_head 112 (zamba2's training path: 2 x 2048, 32 / 32 heads) takes the
// d_head 128 tiling: KU = 7 (every k-step of S unrolled), dk/dv's q tile in
// two halves of 32 columns, K and V re-read at each k-step; dQ, dK and dV
// are 14 n-tiles (7 x4.trans loads a k-step); f32 two threads a row on
// 64-row tiles (dq 133,376 bytes of shared memory, dk/dv 150,016).
#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // kv rows per tile
constexpr int NT = 128;   // threads: f32, two or four per tile row; bf16, four warps

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernels
// ---------------------------------------------------------------------------

// Loads a (rows x DH) tile of a (B, S, NH, DH) tensor, head `head`, rows
// [s0, s0 + n) into smem with row stride DH + 1; rows past n are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int b, int s0, int n, int S, int NH,
                                          int head, int rows) {
  for (int f = threadIdx.x; f < rows * DH; f += NT) {
    const int r = f / DH, d = f % DH;
    dst[r * (DH + 1) + d] =
        r < n ? src[(((size_t)b * S + s0 + r) * NH + head) * DH + d] : 0.f;
  }
}

// (min, max) of n positions in smem, the same in every thread.
__device__ __forceinline__ void pos_range(const int* p, int n, int* lo, int* hi) {
  int a = INT_MAX, z = INT_MIN;
  for (int i = 0; i < n; ++i) {
    a = min(a, p[i]);
    z = max(z, p[i]);
  }
  *lo = a;
  *hi = z;
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// The f32 kernels' tiling: rows a tile (q and kv tiles alike) and threads a
// row, NT threads a block either way. Two threads a row on 64-row tiles up
// to d_head 128; at 256 those tiles' shared memory (dq 280,832 bytes, dk/dv
// 297,472) passes the 232,448 a block may use, and a thread's columns (128
// of dq, 2 x 128 of dk/dv) would pass the registers, so d_head 256 takes
// 32-row tiles and four threads a row (dq 136,320 bytes, dk/dv 140,544).
template <int DH>
struct F32Tile {
  static constexpr int LOG_TPR = DH > 128 ? 2 : 1;
  static constexpr int TPR = 1 << LOG_TPR;   // threads a row
  static constexpr int R = NT / TPR;         // rows a tile
};

template <int DH>
constexpr size_t dq_smem() {
  constexpr int R = F32Tile<DH>::R;
  return sizeof(float) * (4 * R * (DH + 1) + R * (R + 1) + 2 * R) + sizeof(int) * 2 * R;
}

// One block per (q tile, q head, batch row); walks the kv tiles.
template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, float* __restrict__ dq, int Sq, int Sk, int H,
    int KH, int qpos_bstride, int kvpos_bstride, float scale, int causal,
    int window, float softcap) {
  constexpr int LOG_TPR = F32Tile<DH>::LOG_TPR, TPR = F32Tile<DH>::TPR;
  constexpr int R = F32Tile<DH>::R;   // q and kv rows a tile
  constexpr int HD = DH / TPR;        // dq columns per thread (d = TPR*i + part)
  constexpr int HK = R / TPR;         // score columns per thread (j = TPR*jj + part)
  extern __shared__ float smem[];
  float* q_s = smem;                     // R x (DH+1)
  float* do_s = q_s + R * (DH + 1);      // R x (DH+1)
  float* k_s = do_s + R * (DH + 1);      // R x (DH+1)
  float* v_s = k_s + R * (DH + 1);       // R x (DH+1)
  float* ds_s = v_s + R * (DH + 1);      // R x (R+1)
  float* lse_s = ds_s + R * (R + 1);     // R
  float* dl_s = lse_s + R;               // R
  int* kp_s = reinterpret_cast<int*>(dl_s + R);   // R
  int* qp_s = kp_s + R;                           // R

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int row = tid >> LOG_TPR;
  const int part = tid & (TPR - 1);
  const int nq = min(R, Sq - q0);

  load_tile<DH>(q_s, q, b, q0, nq, Sq, H, h, R);
  load_tile<DH>(do_s, dout, b, q0, nq, Sq, H, h, R);
  for (int r = tid; r < R; r += NT) {
    const bool ok = r < nq;
    const size_t stat = ((size_t)b * H + h) * Sq + q0 + r;
    qp_s[r] = ok ? qpos[(size_t)b * qpos_bstride + q0 + r] : 0;
    lse_s[r] = ok ? lse[stat] : 0.f;
    dl_s[r] = ok ? delta[stat] : 0.f;
  }
  __syncthreads();
  int qmin, qmax;
  pos_range(qp_s, nq, &qmin, &qmax);
  const bool row_ok = row < nq;
  const int qp = qp_s[row];
  const float lse_r = lse_s[row];
  const float dl_r = dl_s[row];

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += R) {
    const int nk = min(R, Sk - k0);
    for (int j = tid; j < R; j += NT)
      kp_s[j] = j < nk ? kvpos[(size_t)b * kvpos_bstride + k0 + j] : 0;
    __syncthreads();
    int kmin, kmax;
    pos_range(kp_s, nk, &kmin, &kmax);
    if ((causal && kmin > qmax) || (window > 0 && kmax <= qmin - window)) {
      __syncthreads();
      continue;
    }
    load_tile<DH>(k_s, k, b, k0, nk, Sk, KH, kh, R);
    load_tile<DH>(v_s, v, b, k0, nk, Sk, KH, kh, R);
    __syncthreads();

    // scores and dp of this thread's row against columns j = TPR*jj + part
    float sc[HK], dp[HK];
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) sc[jj] = dp[jj] = 0.f;
    const float* qrow = q_s + row * (DH + 1);
    const float* dorow = do_s + row * (DH + 1);
    const float* kcol = k_s + part * (DH + 1);
    const float* vcol = v_s + part * (DH + 1);
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qrow[d], dd = dorow[d];
#pragma unroll
      for (int jj = 0; jj < HK; ++jj) {
        sc[jj] += qd * kcol[TPR * jj * (DH + 1) + d];
        dp[jj] += dd * vcol[TPR * jj * (DH + 1) + d];
      }
    }
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) {
      const int j = TPR * jj + part;
      float s = sc[jj] * scale, dcap = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(s / softcap);
        s = t * softcap;
        dcap = 1.f - t * t;
      }
      const bool ok = row_ok && j < nk && visible(qp, kp_s[j], causal, window);
      const float p = ok ? expf(s - lse_r) : 0.f;
      ds_s[row * (R + 1) + j] = p * (dp[jj] - dl_r) * dcap;
    }
    __syncthreads();

    const float* dsrow = ds_s + row * (R + 1);
    const float* kc = k_s + part;
    for (int j = 0; j < nk; ++j) {
      const float w = dsrow[j];
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] += w * kc[j * (DH + 1) + TPR * i];
    }
    __syncthreads();
  }

  if (row_ok) {
    float* out = dq + (((size_t)b * Sq + q0 + row) * H + h) * DH + part;
#pragma unroll
    for (int i = 0; i < HD; ++i) out[TPR * i] = acc[i] * scale;
  }
}

template <int DH>
constexpr size_t dkv_smem() {
  constexpr int R = F32Tile<DH>::R;
  return sizeof(float) * (4 * R * (DH + 1) + 2 * R * (R + 1) + 2 * R) + sizeof(int) * 2 * R;
}

// One block per (kv tile, kv head, batch row); walks the q tiles of every
// q head of the group, heads in order.
template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, float* __restrict__ dk, float* __restrict__ dv,
    int Sq, int Sk, int H, int KH, int qpos_bstride, int kvpos_bstride,
    float scale, int causal, int window, float softcap) {
  constexpr int LOG_TPR = F32Tile<DH>::LOG_TPR, TPR = F32Tile<DH>::TPR;
  constexpr int R = F32Tile<DH>::R;   // kv and q rows a tile
  constexpr int HD = DH / TPR;        // dk/dv columns per thread (d = TPR*c + part)
  constexpr int HQ = R / TPR;         // score columns per thread (i = TPR*ii + part)
  extern __shared__ float smem[];
  float* k_s = smem;                     // R x (DH+1)
  float* v_s = k_s + R * (DH + 1);       // R x (DH+1)
  float* q_s = v_s + R * (DH + 1);       // R x (DH+1)
  float* do_s = q_s + R * (DH + 1);      // R x (DH+1)
  float* p_s = do_s + R * (DH + 1);      // R x (R+1)
  float* ds_s = p_s + R * (R + 1);       // R x (R+1)
  float* lse_s = ds_s + R * (R + 1);     // R
  float* dl_s = lse_s + R;               // R
  int* qp_s = reinterpret_cast<int*>(dl_s + R);   // R
  int* kp_s = qp_s + R;                           // R

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * R;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int row = tid >> LOG_TPR;   // kv row of this thread
  const int part = tid & (TPR - 1);
  const int nk = min(R, Sk - k0);

  load_tile<DH>(k_s, k, b, k0, nk, Sk, KH, kh, R);
  load_tile<DH>(v_s, v, b, k0, nk, Sk, KH, kh, R);
  for (int j = tid; j < R; j += NT)
    kp_s[j] = j < nk ? kvpos[(size_t)b * kvpos_bstride + k0 + j] : 0;
  __syncthreads();
  int kmin, kmax;
  pos_range(kp_s, nk, &kmin, &kmax);
  const bool row_ok = row < nk;
  const int kp = kp_s[row];

  float acc_dk[HD], acc_dv[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc_dk[c] = acc_dv[c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = 0; q0 < Sq; q0 += R) {
      const int nq = min(R, Sq - q0);
      for (int r = tid; r < R; r += NT) {
        const bool ok = r < nq;
        const size_t stat = ((size_t)b * H + h) * Sq + q0 + r;
        qp_s[r] = ok ? qpos[(size_t)b * qpos_bstride + q0 + r] : 0;
        lse_s[r] = ok ? lse[stat] : 0.f;
        dl_s[r] = ok ? delta[stat] : 0.f;
      }
      __syncthreads();
      int qmin, qmax;
      pos_range(qp_s, nq, &qmin, &qmax);
      if ((causal && kmin > qmax) || (window > 0 && kmax <= qmin - window)) {
        __syncthreads();
        continue;
      }
      load_tile<DH>(q_s, q, b, q0, nq, Sq, H, h, R);
      load_tile<DH>(do_s, dout, b, q0, nq, Sq, H, h, R);
      __syncthreads();

      // scores and dp of this thread's kv row against q rows i = TPR*ii + part
      float sc[HQ], dp[HQ];
#pragma unroll
      for (int ii = 0; ii < HQ; ++ii) sc[ii] = dp[ii] = 0.f;
      const float* krow = k_s + row * (DH + 1);
      const float* vrow = v_s + row * (DH + 1);
      const float* qcol = q_s + part * (DH + 1);
      const float* docol = do_s + part * (DH + 1);
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int ii = 0; ii < HQ; ++ii) {
          sc[ii] += qcol[TPR * ii * (DH + 1) + d] * kd;
          dp[ii] += docol[TPR * ii * (DH + 1) + d] * vd;
        }
      }
#pragma unroll
      for (int ii = 0; ii < HQ; ++ii) {
        const int i = TPR * ii + part;
        float s = sc[ii] * scale, dcap = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(s / softcap);
          s = t * softcap;
          dcap = 1.f - t * t;
        }
        const bool ok = row_ok && i < nq && visible(qp_s[i], kp, causal, window);
        const float p = ok ? expf(s - lse_s[i]) : 0.f;
        p_s[row * (R + 1) + i] = p;
        ds_s[row * (R + 1) + i] = p * (dp[ii] - dl_s[i]) * dcap;
      }
      __syncthreads();

      const float* prow = p_s + row * (R + 1);
      const float* dsrow = ds_s + row * (R + 1);
      const float* doc = do_s + part;
      const float* qc = q_s + part;
      for (int i = 0; i < nq; ++i) {
        const float pw = prow[i], dw = dsrow[i];
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          acc_dv[c] += pw * doc[i * (DH + 1) + TPR * c];
          acc_dk[c] += dw * qc[i * (DH + 1) + TPR * c];
        }
      }
      __syncthreads();
    }
  }

  if (row_ok) {
    const size_t off = (((size_t)b * Sk + k0 + row) * KH + kh) * DH + part;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dk[off + TPR * c] = acc_dk[c] * scale;
      dv[off + TPR * c] = acc_dv[c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

template <int DH>
struct TcTile {
  static constexpr int LD = DH + 8;      // row stride in bf16: 16 bytes of padding
  static constexpr int SIZE = BQ * LD;   // one 64-row tile (BQ == BK)
  // two resident tiles and two double-buffered ones (the launch adds each
  // walked tile's position range, an int2 a tile); dq: kv positions x 2
  // stages; dk/dv: lse, delta and q positions x 2 stages
  static constexpr size_t DQ_BYTES = sizeof(bf16) * 6 * SIZE + sizeof(int) * 2 * BK;
  static constexpr size_t DKV_BYTES = sizeof(bf16) * 6 * SIZE + sizeof(float) * 3 * 2 * BQ;
  // dk/dv: K's and V's A-fragments held in registers for the whole walk
  // (else re-read from shared memory at each k-step)
  static constexpr bool FRAGS = DH <= 64;
  // q columns of one dk/dv sub-step: the whole q tile, or half of it from
  // d_head 128, where S^T and dP^T of 64 columns would spill
  static constexpr int QW = DH <= 64 ? BQ : BQ / 2;
  // kv rows of one dq sub-step: the whole kv tile, or half of it at d_head
  // 256, where S and dP of 64 columns beside dQ's 128 accumulators spill
  static constexpr int KW = DH <= 128 ? BK : BK / 2;
  // k-steps of S and dP (S^T and dP^T) unrolled at a time: all of them up to
  // d_head 128; four at 256, where the full unroll of 16 hoists the
  // fragment loads past the registers (ptxas: spills of 64 bytes in dq and
  // 36 in dk/dv; four: none, and faster than quarter sub-steps)
  static constexpr int KU = DH <= 128 ? DH / 16 : 4;
  // dk/dv: warps a 16-row slab, each holding DH / DSPLIT of dK's and dV's
  // columns; at d_head 256 one warp's two accumulators alone would be 256
  // registers, so two warps share a slab (8 warps a block) and each
  // computes the slab's S^T and dP^T over the whole d_head itself
  static constexpr int DSPLIT = DH <= 128 ? 1 : 2;
  static constexpr int DKV_THREADS = NT * DSPLIT;
};

// One block per (q tile, q head, batch row); walks the kv tiles.
template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, bf16* __restrict__ dq, int Sq, int Sk, int H, int KH,
    int qpos_bstride, int kvpos_bstride, float scale, int causal, int window,
    float softcap) {
  static_assert(DH % 16 == 0 && BQ == 64 && BK == 64 && NT == 128, "tile shape");
  constexpr int LD = TcTile<DH>::LD, SIZE = TcTile<DH>::SIZE;
  constexpr int CH = DH / 8;       // 16-byte chunks of a row
  constexpr int KW = TcTile<DH>::KW, KU = TcTile<DH>::KU;
  constexpr int KS = DH / 16;      // k-steps of S and dP
  constexpr int NS = KW / 8;       // n-tiles of S and dP (8 kv columns each)
  constexpr int ND = DH / 8;       // n-tiles of dQ
  constexpr int NW = NT / 32;      // warps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + SIZE;
  bf16* k_s = do_s + SIZE;         // stage st at k_s + st * SIZE
  bf16* v_s = k_s + 2 * SIZE;
  int* kp_s = reinterpret_cast<int*>(v_s + 2 * SIZE);      // 2 x BK
  int2* range_s = reinterpret_cast<int2*>(kp_s + 2 * BK);  // a kv tile's (min, max)
  const int n_tiles = (Sk + BK - 1) / BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // the mma fragments' row group and column pair
  // heavy q tiles (late in causal order) first, so the grid's tail is light
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int* qp = qpos + (size_t)b * qpos_bstride;
  const int* kvp = kvpos + (size_t)b * kvpos_bstride;

  auto load_tile = [&](int t, int st) {   // K, V and kv positions of tile t
    const int k0 = t * BK;
    bf16* ks = k_s + st * SIZE;
    bf16* vs = v_s + st * SIZE;
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, s = k0 + r;
      const bool in = s < Sk;
      const size_t off = (((size_t)b * Sk + (in ? s : 0)) * KH + kh) * DH + (c % CH) * 8;
      cp_async16(ks + r * LD + (c % CH) * 8, k + off, in);
      cp_async16(vs + r * LD + (c % CH) * 8, v + off, in);
    }
    if (tid < BK) {
      const bool in = k0 + tid < Sk;
      cp_async4(kp_s + st * BK + tid, kvp + (in ? k0 + tid : 0), in);
    }
  };

  // group 0: the q and dO tiles (rows past Sq zero-filled). Group 1: tile 0
  // into stage 0, before it is known to be live, as it is on every causal
  // path without a window; its copy then overlaps the range pass below.
  for (int c = tid; c < BQ * CH; c += NT) {
    const int r = c / CH, s = q0 + r;
    const bool in = s < Sq;
    const size_t off = (((size_t)b * Sq + (in ? s : 0)) * H + h) * DH + (c % CH) * 8;
    cp_async16(q_s + r * LD + (c % CH) * 8, q + off, in);
    cp_async16(do_s + r * LD + (c % CH) * 8, dout + off, in);
  }
  cp_async_commit();
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // this thread's two rows: r0 = row g of its warp's slab, r1 = row g + 8;
  // their positions, lse (in log2 units, negated) and delta
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < Sq, ok1 = r1 < Sq;
  const int qp0 = ok0 ? qp[r0] : 0, qp1 = ok1 ? qp[r1] : 0;
  const float LOG2E = 1.4426950408889634f;
  const float* lrow = lse + ((size_t)b * H + h) * Sq;
  const float* drow = delta + ((size_t)b * H + h) * Sq;
  const float nl0 = ok0 ? -lrow[r0] * LOG2E : 0.f, nl1 = ok1 ? -lrow[r1] * LOG2E : 0.f;
  const float dl0 = ok0 ? drow[r0] : 0.f, dl1 = ok1 ? drow[r1] : 0.f;
  // two q positions a lane for the block's range, reduced after the kv pass
  const int qa = q0 + lane < Sq ? qp[q0 + lane] : INT_MAX;
  const int qb = q0 + lane + 32 < Sq ? qp[q0 + lane + 32] : INT_MAX;
  tile_ranges<NW>(kvp, Sk, range_s, warp, lane);
  const int qmin = warp_min_i(min(qa, qb));
  const int qmax = warp_max_i(max(qa == INT_MAX ? INT_MIN : qa, qb == INT_MAX ? INT_MIN : qb));
  cp_async_wait<1>();   // the q and dO tiles have landed
  __syncthreads();

  // live: some row of the block may see a key of tile t (else its K/V is
  // never read); full: every row sees every key of it (no mask needed)
  const bool q_whole = q0 + BQ <= Sq;
  auto live = [&](int t) {
    const int2 r = range_s[t];
    return !((causal && r.x > qmax) || (window > 0 && r.y <= qmin - window));
  };
  auto full = [&](int t) {
    const int2 r = range_s[t];
    return q_whole && (t + 1) * BK <= Sk && (!causal || r.y <= qmin) &&
           (window <= 0 || r.x > qmax - window);
  };
  auto next_live = [&](int t) {
    while (t < n_tiles && !live(t)) ++t;
    return t;
  };
  int cur = next_live(0);
  if (cur != 0) {   // tile 0 is not live: let its copy land, then load the first live one
    cp_async_wait<0>();
    if (cur < n_tiles) load_tile(cur, 0);
    cp_async_commit();
  }

  // this warp's slab of the q and dO tiles, whose A-fragments are read at
  // each k-step (held for the whole walk they would take 214 registers at
  // d_head 64 and allow two blocks an SM instead of three)
  const bf16* q_w = q_s + warp * 16 * LD;
  const bf16* do_w = do_s + warp * 16 * LD;

  // p = 2^(x c - lse log2 e): x is the raw score (c = scale log2(e)) or, with
  // a softcap, the softcapped scaled score (c = log2(e)); a masked x is -inf
  const float c = softcap > 0.f ? LOG2E : scale * LOG2E;
  const float cap_in = scale / softcap;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int st = 0; cur < n_tiles; st ^= 1) {
    const int nxt = next_live(cur + 1);
    if (nxt < n_tiles) load_tile(nxt, st ^ 1);   // in flight while this tile computes
    cp_async_commit();
    cp_async_wait<1>();   // this tile has landed
    __syncthreads();

    const bf16* ks = k_s + st * SIZE;
    const bf16* vs = v_s + st * SIZE;
    const bool whole = full(cur);
    const int nk = min(BK, Sk - cur * BK);
    const int* kps = kp_s + st * BK;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += KW) {   // the sub-steps of KW kv rows
      // S = Q K^T and dP = dO V^T: each x4 load gives the B-fragments of two
      // n-tiles
      float sc[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll (KU)
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa_[4], da_[4];
        ld_a(qa_, q_w + kk * 16, LD, lane);
        ld_a(da_, do_w + kk * 16, LD, lane);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kb[4], vb[4];
          ld_b_nk(kb, ks + (k0 + np * 16) * LD + kk * 16, LD, lane);
          ld_b_nk(vb, vs + (k0 + np * 16) * LD + kk * 16, LD, lane);
          mma_bf16(sc[2 * np], qa_, kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qa_, kb[2], kb[3]);
          mma_bf16(dp[2 * np], da_, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], da_, vb[2], vb[3]);
        }
      }

      // softcap, mask, p and ds = p (dp - delta) dcap in registers; element
      // e of n-tile j is row (e < 2 ? r0 : r1), column k0 + j * 8 + 2 * t4 +
      // (e & 1)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = k0 + j * 8 + 2 * t4;
        const int2 kp = *reinterpret_cast<const int2*>(kps + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e], dcap = 1.f;
          if (softcap > 0.f) {
            const float th = tanhf(x * cap_in);
            x = th * softcap;
            dcap = 1.f - th * th;
          }
          if (!whole) {
            const int kpe = (e & 1) ? kp.y : kp.x;
            const int qpe = e < 2 ? qp0 : qp1;
            const bool ok = (e < 2 ? ok0 : ok1) && col + (e & 1) < nk &&
                            (!causal || kpe <= qpe) && (window <= 0 || kpe > qpe - window);
            if (!ok) x = -INFINITY;
          }
          const float p = exp2_approx(fmaf(x, c, e < 2 ? nl0 : nl1));
          dp[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * dcap;
        }
      }

      // dQ += dS K: dS's accumulator tiles 2 kk and 2 kk + 1 are the
      // A-fragment of k-step kk; each x4.trans load gives K's B-fragments of
      // two n-tiles
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        uint32_t sa[4];
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t kb[4];
          ld_b_kn(kb, ks + (k0 + kk * 16) * LD + np * 16, LD, lane);
          mma_bf16(acc[2 * np], sa, kb[0], kb[1]);
          mma_bf16(acc[2 * np + 1], sa, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
    cur = nxt;
  }

  // dq = scale acc in bf16, staged through this warp's own rows of the q
  // tile (no other warp reads them) so that the stores are 16 bytes wide
  bf16* os = q_s + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + j * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + j * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, s = q0 + warp * 16 + r;
    if (s < Sq)
      *reinterpret_cast<uint4*>(dq + (((size_t)b * Sq + s) * H + h) * DH + (i % CH) * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + (i % CH) * 8);
  }
}

// One block per (kv tile, kv head, batch row); walks the q tiles of every q
// head of the group: step w is head w / n_qt of the group and q tile
// n_qt - 1 - w % n_qt (the last q tile first: a causal mask never skips it).
// DSPLIT warps a 16-row slab of the kv tile: warp w takes slab w % 4 and
// dK's and dV's columns [w / 4 * DW, (w / 4 + 1) * DW).
template <int DH>
__global__ void __launch_bounds__(TcTile<DH>::DKV_THREADS) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
    int Sk, int H, int KH, int qpos_bstride, int kvpos_bstride, float scale, int causal,
    int window, float softcap) {
  static_assert(DH % 16 == 0 && BQ == 64 && BK == 64 && NT == 128, "tile shape");
  constexpr int LD = TcTile<DH>::LD, SIZE = TcTile<DH>::SIZE;
  constexpr bool FRAGS = TcTile<DH>::FRAGS;
  constexpr int CH = DH / 8;       // 16-byte chunks of a row
  constexpr int QW = TcTile<DH>::QW, KU = TcTile<DH>::KU;
  constexpr int DS = TcTile<DH>::DSPLIT;
  constexpr int NTK = TcTile<DH>::DKV_THREADS;
  constexpr int DW = DH / DS;      // dK and dV columns of one warp
  constexpr int KS = DH / 16;      // k-steps of S^T and dP^T
  constexpr int NQ = QW / 8;       // n-tiles of S^T and dP^T (8 q columns each)
  constexpr int ND = DW / 8;       // n-tiles of this warp's dK and dV
  constexpr int NW = NTK / 32;     // warps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + SIZE;
  bf16* q_s = v_s + SIZE;          // stage st at q_s + st * SIZE
  bf16* do_s = q_s + 2 * SIZE;
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * SIZE);   // 2 x BQ
  float* dl_s = lse_s + 2 * BQ;                                // 2 x BQ
  int* qp_s = reinterpret_cast<int*>(dl_s + 2 * BQ);           // 2 x BQ
  int2* range_s = reinterpret_cast<int2*>(qp_s + 2 * BQ);      // a q tile's (min, max)
  const int n_qt = (Sq + BQ - 1) / BQ, G = H / KH, n_w = G * n_qt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // the mma fragments' row group and column pair
  const int slab = DS == 1 ? warp : warp & 3;         // this warp's 16 kv rows
  const int c0 = DS == 1 ? 0 : (warp >> 2) * DW;      // and its first dK / dV column
  // heavy kv tiles (early in causal order) first, so the grid's tail is light
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int* qp = qpos + (size_t)b * qpos_bstride;
  const int* kvp = kvpos + (size_t)b * kvpos_bstride;

  auto q_tile = [&](int w) { return n_qt - 1 - w % n_qt; };
  auto load_step = [&](int w, int st) {   // q, dO, lse, delta and q positions of step w
    const int h = kh * G + w / n_qt, q0 = q_tile(w) * BQ;
    bf16* qs = q_s + st * SIZE;
    bf16* ds = do_s + st * SIZE;
    for (int c = tid; c < BQ * CH; c += NTK) {
      const int r = c / CH, s = q0 + r;
      const bool in = s < Sq;
      const size_t off = (((size_t)b * Sq + (in ? s : 0)) * H + h) * DH + (c % CH) * 8;
      cp_async16(qs + r * LD + (c % CH) * 8, q + off, in);
      cp_async16(ds + r * LD + (c % CH) * 8, dout + off, in);
    }
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      const size_t stat = ((size_t)b * H + h) * Sq + (in ? q0 + tid : 0);
      cp_async4(lse_s + st * BQ + tid, lse + stat, in);
      cp_async4(dl_s + st * BQ + tid, delta + stat, in);
      cp_async4(qp_s + st * BQ + tid, qp + (in ? q0 + tid : 0), in);
    }
  };

  // group 0: the K and V tiles (rows past Sk zero-filled). Group 1: step 0
  // into stage 0, before it is known to be live; its copy then overlaps the
  // range pass below.
  for (int c = tid; c < BK * CH; c += NTK) {
    const int r = c / CH, s = k0 + r;
    const bool in = s < Sk;
    const size_t off = (((size_t)b * Sk + (in ? s : 0)) * KH + kh) * DH + (c % CH) * 8;
    cp_async16(k_s + r * LD + (c % CH) * 8, k + off, in);
    cp_async16(v_s + r * LD + (c % CH) * 8, v + off, in);
  }
  cp_async_commit();
  if (n_w > 0) load_step(0, 0);
  cp_async_commit();

  // this thread's two kv rows: r0 = row g of its warp's slab, r1 = row g + 8
  const int r0 = k0 + slab * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < Sk, ok1 = r1 < Sk;
  const int kp0 = ok0 ? kvp[r0] : 0, kp1 = ok1 ? kvp[r1] : 0;
  // two kv positions a lane for the block's range, reduced after the q pass
  const int ka = k0 + lane < Sk ? kvp[k0 + lane] : INT_MAX;
  const int kb = k0 + lane + 32 < Sk ? kvp[k0 + lane + 32] : INT_MAX;
  tile_ranges<NW>(qp, Sq, range_s, warp, lane);
  const int kmin = warp_min_i(min(ka, kb));
  const int kmax = warp_max_i(max(ka == INT_MAX ? INT_MIN : ka, kb == INT_MAX ? INT_MIN : kb));
  cp_async_wait<1>();   // the K and V tiles have landed
  __syncthreads();

  // live: some kv row of the block may be seen by a row of q tile t; full:
  // every row of q tile t sees every kv row (no mask needed)
  const bool kv_whole = k0 + BK <= Sk;
  auto live = [&](int t) {
    const int2 r = range_s[t];
    return !((causal && kmin > r.y) || (window > 0 && kmax <= r.x - window));
  };
  auto full = [&](int t) {
    const int2 r = range_s[t];
    return kv_whole && (t + 1) * BQ <= Sq && (!causal || kmax <= r.x) &&
           (window <= 0 || kmin > r.y - window);
  };
  auto next_live = [&](int w) {
    while (w < n_w && !live(q_tile(w))) ++w;
    return w;
  };
  int cur = next_live(0);
  if (cur != 0) {   // step 0 is not live: let its copy land, then load the first live one
    cp_async_wait<0>();
    if (cur < n_w) load_step(cur, 0);
    cp_async_commit();
  }

  const bf16* k_w = k_s + slab * 16 * LD;   // this warp's slab of the K and V tiles
  const bf16* v_w = v_s + slab * 16 * LD;
  uint32_t kf[FRAGS ? KS : 1][4], vf[FRAGS ? KS : 1][4];
  if constexpr (FRAGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ld_a(kf[kk], k_w + kk * 16, LD, lane);
      ld_a(vf[kk], v_w + kk * 16, LD, lane);
    }
  }

  // p = 2^(x c - lse log2 e), as in the dq kernel
  const float LOG2E = 1.4426950408889634f;
  const float c = softcap > 0.f ? LOG2E : scale * LOG2E;
  const float cap_in = scale / softcap;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int st = 0; cur < n_w; st ^= 1) {
    const int nxt = next_live(cur + 1);
    if (nxt < n_w) load_step(nxt, st ^ 1);   // in flight while this step computes
    cp_async_commit();
    cp_async_wait<1>();   // this step has landed
    __syncthreads();

    const bf16* qs = q_s + st * SIZE;
    const bf16* dos = do_s + st * SIZE;
    const int t = q_tile(cur);
    const bool whole = full(t);
    const int nq = min(BQ, Sq - t * BQ);
#pragma unroll
    for (int q0 = 0; q0 < BQ; q0 += QW) {   // the sub-steps of QW q columns
      // S^T = K Q^T and dP^T = V dO^T: each x4 load gives the B-fragments of
      // two n-tiles (16 q rows)
      float sc[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll (KU)
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka_[4], va_[4];
        if constexpr (FRAGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ka_[i] = kf[kk][i], va_[i] = vf[kk][i];
        } else {
          ld_a(ka_, k_w + kk * 16, LD, lane);
          ld_a(va_, v_w + kk * 16, LD, lane);
        }
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t qb_[4], db_[4];
          ld_b_nk(qb_, qs + (q0 + np * 16) * LD + kk * 16, LD, lane);
          ld_b_nk(db_, dos + (q0 + np * 16) * LD + kk * 16, LD, lane);
          mma_bf16(sc[2 * np], ka_, qb_[0], qb_[1]);
          mma_bf16(sc[2 * np + 1], ka_, qb_[2], qb_[3]);
          mma_bf16(dp[2 * np], va_, db_[0], db_[1]);
          mma_bf16(dp[2 * np + 1], va_, db_[2], db_[3]);
        }
      }

      // softcap, mask, p^T and ds^T in registers; element e of n-tile j is
      // kv row (e < 2 ? r0 : r1), q column q0 + j * 8 + 2 * t4 + (e & 1)
      const float* ls = lse_s + st * BQ;
      const float* dls = dl_s + st * BQ;
      const int* qps = qp_s + st * BQ;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = q0 + j * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + col);
        const int2 q2 = *reinterpret_cast<const int2*>(qps + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e], dcap = 1.f;
          if (softcap > 0.f) {
            const float th = tanhf(x * cap_in);
            x = th * softcap;
            dcap = 1.f - th * th;
          }
          if (!whole) {
            const int kpe = e < 2 ? kp0 : kp1;
            const int qpe = (e & 1) ? q2.y : q2.x;
            const bool ok = (e < 2 ? ok0 : ok1) && col + (e & 1) < nq &&
                            (!causal || kpe <= qpe) && (window <= 0 || kpe > qpe - window);
            if (!ok) x = -INFINITY;
          }
          const float p = exp2_approx(fmaf(x, c, -((e & 1) ? l2.y : l2.x) * LOG2E));
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x)) * dcap;
        }
      }

      // dV += P^T dO and dK += dS^T Q over this warp's DW columns: the
      // accumulator tiles 2 kk and 2 kk + 1 are the A-fragment of k-step kk
      // (16 q rows); each x4.trans load gives the B-fragments of two n-tiles
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t db_[4], qb_[4];
          ld_b_kn(db_, dos + (q0 + kk * 16) * LD + c0 + np * 16, LD, lane);
          ld_b_kn(qb_, qs + (q0 + kk * 16) * LD + c0 + np * 16, LD, lane);
          mma_bf16(dv_acc[2 * np], pa, db_[0], db_[1]);
          mma_bf16(dv_acc[2 * np + 1], pa, db_[2], db_[3]);
          mma_bf16(dk_acc[2 * np], sa, qb_[0], qb_[1]);
          mma_bf16(dk_acc[2 * np + 1], sa, qb_[2], qb_[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
    cur = nxt;
  }

  // dk = scale acc and dv in bf16, staged through this warp's own rows and
  // columns of the K and V tiles (no other warp reads them) so that the
  // stores are 16 bytes wide
  bf16* ks_w = k_s + slab * 16 * LD + c0;
  bf16* vs_w = v_s + slab * 16 * LD + c0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(ks_w + g * LD + col) =
        __floats2bfloat162_rn(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(ks_w + (g + 8) * LD + col) =
        __floats2bfloat162_rn(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
    *reinterpret_cast<__nv_bfloat162*>(vs_w + g * LD + col) =
        __floats2bfloat162_rn(dv_acc[j][0], dv_acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(vs_w + (g + 8) * LD + col) =
        __floats2bfloat162_rn(dv_acc[j][2], dv_acc[j][3]);
  }
  __syncwarp();
  constexpr int CW = DW / 8;       // 16-byte chunks of this warp's columns of a row
  for (int i = lane; i < 16 * CW; i += 32) {
    const int r = i / CW, s = k0 + slab * 16 + r;
    if (s < Sk) {
      const size_t off = (((size_t)b * Sk + s) * KH + kh) * DH + c0 + (i % CW) * 8;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(ks_w + r * LD + (i % CW) * 8);
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(vs_w + r * LD + (i % CW) * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *qpos, *kvpos;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KH, qb, kb;
  float scale;
  int causal, window;
  float softcap;
  cudaStream_t stream;
};


template <bool DKV, int DH>
int launch_f32(const Args& a) {
  const size_t smem = DKV ? dkv_smem<DH>() : dq_smem<DH>();
  const auto q = static_cast<const float*>(a.q), k = static_cast<const float*>(a.k),
             v = static_cast<const float*>(a.v), dout = static_cast<const float*>(a.dout),
             lse = static_cast<const float*>(a.lse), delta = static_cast<const float*>(a.delta);
  const auto qp = static_cast<const int*>(a.qpos), kp = static_cast<const int*>(a.kvpos);
  cudaError_t err;
  if constexpr (DKV) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.Sk + F32Tile<DH>::R - 1) / F32Tile<DH>::R, a.KH, a.B);
    flash_bwd_dkv_f32_kernel<DH><<<grid, NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, qp, kp, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.Sq, a.Sk, a.H, a.KH, a.qb, a.kb, a.scale, a.causal,
        a.window, a.softcap);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.Sq + F32Tile<DH>::R - 1) / F32Tile<DH>::R, a.H, a.B);
    flash_bwd_dq_f32_kernel<DH><<<grid, NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, qp, kp, static_cast<float*>(a.dq), a.Sq, a.Sk, a.H,
        a.KH, a.qb, a.kb, a.scale, a.causal, a.window, a.softcap);
  }
  return (int)cudaGetLastError();
}

template <bool DKV, int DH>
int launch_bf16(const Args& a) {
  // 16-byte cp.async and stores: every row starts on 16 bytes when the base does
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(DKV ? a.dk : a.dq) |
       reinterpret_cast<uintptr_t>(DKV ? a.dv : a.dq)) & 15)
    return -1;
  const auto q = static_cast<const bf16*>(a.q), k = static_cast<const bf16*>(a.k),
             v = static_cast<const bf16*>(a.v), dout = static_cast<const bf16*>(a.dout);
  const auto lse = static_cast<const float*>(a.lse), delta = static_cast<const float*>(a.delta);
  const auto qp = static_cast<const int*>(a.qpos), kp = static_cast<const int*>(a.kvpos);
  cudaError_t err;
  if constexpr (DKV) {   // the walk's position ranges: one int2 a q tile
    const size_t smem = TcTile<DH>::DKV_BYTES + sizeof(int2) * ((a.Sq + BQ - 1) / BQ);
    err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.Sk + BK - 1) / BK, a.KH, a.B);
    flash_bwd_dkv_tc_kernel<DH><<<grid, TcTile<DH>::DKV_THREADS, smem, a.stream>>>(
        q, k, v, dout, lse, delta, qp, kp, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.Sq, a.Sk, a.H, a.KH, a.qb, a.kb, a.scale, a.causal, a.window, a.softcap);
  } else {     // one int2 a kv tile
    const size_t smem = TcTile<DH>::DQ_BYTES + sizeof(int2) * ((a.Sk + BK - 1) / BK);
    err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_tc_kernel<DH><<<grid, NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, qp, kp, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.KH,
        a.qb, a.kb, a.scale, a.causal, a.window, a.softcap);
  }
  return (int)cudaGetLastError();
}

template <bool DKV, int DH>
int launch(int dtype, const Args& a) {
  if (dtype == DT_F32) return launch_f32<DKV, DH>(a);
  if (dtype == DT_BF16) return launch_bf16<DKV, DH>(a);
  return -1;
}

template <bool DKV>
int dispatch(int DH, int dtype, const Args& a) {
  switch (DH) {
    case 16: return launch<DKV, 16>(dtype, a);
    case 32: return launch<DKV, 32>(dtype, a);
    case 64: return launch<DKV, 64>(dtype, a);
    case 112: return launch<DKV, 112>(dtype, a);
    case 128: return launch<DKV, 128>(dtype, a);
    case 256: return launch<DKV, 256>(dtype, a);
    default: return -1;
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success), or -1 for a
// head dim / dtype the kernels do not take (or a bf16 pointer not on 16
// bytes). q, dout, dq: (B, Sq, H, DH); k, v, dk, dv: (B, Sk, KH, DH); lse,
// delta: (B, H, Sq) f32.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* qpos,
                                      const void* kvpos, void* dq, int B, int Sq,
                                      int Sk, int H, int KH, int DH, int dtype,
                                      int qpos_bstride, int kvpos_bstride,
                                      float scale, int causal, int window,
                                      float softcap, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qpos, kvpos, dq, nullptr, nullptr,
               B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal,
               window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(DH, dtype, a);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* qpos,
                                       const void* kvpos, void* dk, void* dv, int B,
                                       int Sq, int Sk, int H, int KH, int DH,
                                       int dtype, int qpos_bstride,
                                       int kvpos_bstride, float scale, int causal,
                                       int window, float softcap, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qpos, kvpos, nullptr, dk, dv,
               B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal,
               window, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(DH, dtype, a);
}
