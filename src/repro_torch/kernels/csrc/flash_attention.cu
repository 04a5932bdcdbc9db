// Causal GQA flash-attention forward for Hopper (sm_90a): two kernels behind
// one C entry, chosen by dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fwd_kernel
// (launched by _fwd, entry flash_attention): online softmax over KV tiles,
// optional local window and tanh softcap, q-head h reads kv-head h // G.
// Returns o (B, Sq, H, Dh) in q's dtype and lse (B, H, Sq) in f32; a fully
// masked row gives o = 0 and lse = -1e30. Positions are per row (q_pos
// (Bq, Sq), kv_pos (Bk, Sk), Bq/Bk in {1, B}), so both kernels are exact for
// any positions, not only uniform ones.
//
// What bounds it on this card. At the 16 x 512 prefill shape (Dh = 64)
// attention does ~P/2 multiply-adds per byte of q/k/v, far above the H100's
// ~295 FLOP/byte bf16 ridge: it is bound by operations. At the chunk-round
// shape (16 rows x 128 queries against a 1,024-position cache, 288 blocks of
// at most 8 live tiles) and the training shape (32 x 128, 576 blocks of 1 or
// 2 tiles) each block's walk is short, so it is bound by latency: the
// block's start (positions, the q tile, the first K/V tile) and the serial
// steps of one tile.
//
// bf16: flash_fwd_tc_kernel, on the tensor cores. One block owns a 64-row q
// tile of one q head and runs 4 warps, each warp one m16 slab of 16 rows.
// Both products are mma.sync.m16n8k16 (bf16 in, f32 accumulate): S = Q K^T
// with Q held as A-fragments in registers for the whole walk and K's
// B-fragments by ldmatrix, then O += P V with P rounded to bf16 in registers
// and fed straight back as the A-operand (two neighbouring m16n8 accumulator
// tiles are one m16n8k16 A-fragment) and V's B-fragments by ldmatrix.trans.
// P never touches shared memory; l is summed from the f32 P before the
// rounding, which adds at most ~2^-9 max|v| to o (before o's own rounding),
// inside the bf16 tolerance of 2^-7 (1 + max|o|) against the plain version.
//
// Against the operations bound: the products run on the tensor cores; the
// softcap, mask and online softmax stay in registers (row max and sum
// reduced across each quad with two shuffles); each probability is one FFMA
// and one ex2 (the scale folded into log2 units); a tile that every row of
// the block sees whole (below the causal diagonal, inside the window) skips
// the mask; and a tile that holds no key any row may see (above the
// diagonal, below the window) is skipped before its K/V is read, which
// halves causal prefill and skips most of a chunk round's cache. Against
// the latency bound: K/V tiles of 64 rows are double-buffered with 16-byte
// cp.async, so tile j+1's copy is in flight while tile j computes (ragged
// tails zero-filled by the src-size form, never read past the end); tile 0's
// copy starts with the q tile's, before the block knows it is live, as it
// is on every causal path without a window; each tile's position range is
// found once, by one warp with shuffles, four tiles at a time so that their
// loads are in flight together; rows are padded by 16 bytes so ldmatrix is
// free of bank conflicts; and the grid walks the heavy causal q tiles first,
// so the last wave is light. wgmma, TMA and warp specialisation are the
// step that remains (it is slower than the library's attention at the
// prefill shape; PERF.md).
//
// f32: flash_fwd_f32_kernel, on the CUDA cores. The f32 path is the card's
// oracle: the f32 engines must emit the CPU's greedy tokens and the f32
// training step must match the CPU's within 1e-5. TF32 tensor cores keep
// about three decimal digits and would break that, so f32 keeps exact f32
// FMAs: one block per 64-row q tile, two threads per row, K/V tiles staged
// in shared memory, the same tile skip (its range scanned by every thread).
//
// d_head 256 (gemma2) has its own tiling where the one above does not fit.
// bf16: Q as A-fragments would take 16 k-steps x 4 = 64 registers beside
// the 128 of the O accumulator and the 32 of S, past the 255 a thread, so
// at 256 the kernel reads Q's fragment of each k-step from the q tile in
// shared memory by ldmatrix (five 64 x 264 tiles, 169 KB, still fit). f32:
// four threads a row (256 a block) instead of two, so a thread holds 64
// accumulators and 16 scores; its shared memory, 214,280 bytes, fits. The
// d_head 16-128 instantiations are unchanged.
//
// d_head 112 (zamba2, 7 x 16) takes the d_head 16-128 tiling as it is: 7
// k-steps of Q K^T (Q's 28 fragment registers held for the walk), 14
// n-tiles of O (7 x4.trans loads of V), rows of 120 bf16 (240 bytes: on 16
// bytes, and 8 rows of an ldmatrix fall in 8 distinct 4-bank groups); f32
// two threads a row, 56 accumulators each, 103,168 bytes of shared memory.
#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // kv rows per shared-memory tile
constexpr int NT = 128;   // threads: f32, two per q row (f32_threads); bf16, four warps
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

template <int DH>
struct TcTile {
  static constexpr int LD = DH + 8;      // row stride in bf16: 16 bytes of padding
  static constexpr int SIZE = BQ * LD;   // one 64-row tile (BQ == BK)
  // Q, K x 2 stages, V x 2 stages, kv positions x 2 stages (the launch adds
  // each tile's kv position range, an int2 a tile)
  static constexpr size_t BYTES = sizeof(bf16) * 5 * SIZE + sizeof(int) * 2 * BK;
};

template <int DH>
__global__ void __launch_bounds__(NT) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kvpos, bf16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KH, int qpos_bstride,
    int kvpos_bstride, float scale, int causal, int window, float softcap) {
  static_assert(DH % 16 == 0 && BQ == 64 && BK == 64 && NT == 128, "tile shape");
  // Q's A-fragments stay in registers for the whole walk up to d_head 128;
  // at 256 they are read from the q tile at each k-step
  constexpr bool QREG = DH <= 128;
  constexpr int LD = TcTile<DH>::LD, SIZE = TcTile<DH>::SIZE;
  constexpr int CH = DH / 8;       // 16-byte chunks of a row
  constexpr int KS = DH / 16;      // k-steps of Q K^T
  constexpr int NS = BK / 8;       // n-tiles of S (8 kv columns each)
  constexpr int NO = DH / 8;       // n-tiles of O
  constexpr int NW = NT / 32;      // warps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + SIZE;          // stage st at k_s + st * SIZE
  bf16* v_s = k_s + 2 * SIZE;
  int* kp_s = reinterpret_cast<int*>(v_s + 2 * SIZE);           // 2 x BK
  int2* range_s = reinterpret_cast<int2*>(kp_s + 2 * BK);       // a tile's (min, max)
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

  // group 0: the q tile (rows past Sq zero-filled). Group 1: tile 0 into
  // stage 0, before it is known to be live, as it is on every causal path
  // without a window; its copy then overlaps the range pass below.
  for (int c = tid; c < BQ * CH; c += NT) {
    const int r = c / CH, s = q0 + r;
    const bool in = s < Sq;
    cp_async16(q_s + r * LD + (c % CH) * 8,
               q + (((size_t)b * Sq + (in ? s : 0)) * H + h) * DH + (c % CH) * 8, in);
  }
  cp_async_commit();
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // this thread's two rows: r0 = row g of its warp's slab, r1 = row g + 8
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < Sq, ok1 = r1 < Sq;
  const int qp0 = ok0 ? qp[r0] : 0, qp1 = ok1 ? qp[r1] : 0;
  // two q positions a lane for the block's range, reduced after the kv pass
  // so that all these loads are in flight together
  const int qa = q0 + lane < Sq ? qp[q0 + lane] : INT_MAX;
  const int qb = q0 + lane + 32 < Sq ? qp[q0 + lane + 32] : INT_MAX;

  // each tile's kv position range, once, by one warp
  tile_ranges<NW>(kvp, Sk, range_s, warp, lane);
  const int qmin = warp_min_i(min(qa, qb));
  const int qmax = warp_max_i(max(qa == INT_MAX ? INT_MIN : qa, qb == INT_MAX ? INT_MIN : qb));
  cp_async_wait<1>();   // the q tile has landed
  __syncthreads();

  // live: some row of the block may see a key of tile t (else its K/V is
  // never read); full: every row sees every key of it (no mask needed)
  auto live = [&](int t) {
    const int2 r = range_s[t];
    return !((causal && r.x > qmax) || (window > 0 && r.y <= qmin - window));
  };
  auto full = [&](int t) {
    const int2 r = range_s[t];
    return (t + 1) * BK <= Sk && (!causal || r.y <= qmin) &&
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

  // Q as A-fragments for the whole walk: x4 matrices (rows 0-7 | 8-15) x
  // (columns 0-7 | 8-15) of each 16-wide k-step
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ld_a(qf[kk], q_s + warp * 16 * LD + kk * 16, LD, lane);
  }

  // p = 2^(x c - m c), one FFMA and one ex2 an element: x is the raw score
  // (c = scale log2(e)) or, with a softcap, the softcapped scaled score
  // (c = log2(e)); m is the running max of x. A masked score is -inf, which
  // gives p = 0 whatever m is; m starts at the finite NEG_INF_F, so a row
  // that has seen no key keeps corr = 2^0 = 1 on a zero sum and never gets
  // p = 2^0 for a masked key (the guard the f32 kernel keeps in valid bits).
  const float LOG2E = 1.4426950408889634f;
  const float c = softcap > 0.f ? LOG2E : scale * LOG2E;
  const float cap_in = scale / softcap;
  float m0 = NEG_INF_F, m1 = NEG_INF_F;   // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;               // this thread's share of their sums
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int st = 0; cur < n_tiles; st ^= 1) {
    const int nxt = next_live(cur + 1);
    if (nxt < n_tiles) load_tile(nxt, st ^ 1);   // in flight while this tile computes
    cp_async_commit();
    cp_async_wait<1>();   // this tile has landed
    __syncthreads();

    // S = Q K^T: each x4 load gives the B-fragments of two n-tiles
    const bf16* ks = k_s + st * SIZE;
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    if constexpr (QREG) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kf[4];
          ld_b_nk(kf, ks + np * 16 * LD + kk * 16, LD, lane);
          mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4];
        ld_a(qa, q_s + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kf[4];
          ld_b_nk(kf, ks + np * 16 * LD + kk * 16, LD, lane);
          mma_bf16(sc[2 * np], qa, kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
    }

    // softcap and mask in registers; element e of n-tile j is row
    // (e < 2 ? r0 : r1), column j * 8 + 2 * t4 + (e & 1)
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = tanhf(sc[j][e] * cap_in) * softcap;
    }
    if (!full(cur)) {
      const int nk = min(BK, Sk - cur * BK);
      const int* kps = kp_s + st * BK;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = j * 8 + 2 * t4;
        const int2 kp = *reinterpret_cast<const int2*>(kps + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpe = (e & 1) ? kp.y : kp.x;
          const int qpe = e < 2 ? qp0 : qp1;
          const bool ok = (e < 2 ? ok0 : ok1) && col + (e & 1) < nk &&
                          (!causal || kpe <= qpe) && (window <= 0 || kpe > qpe - window);
          if (!ok) sc[j][e] = -INFINITY;
        }
      }
    }
    // online softmax: the quad of a row group holds the row's 64 columns
    float mx0 = NEG_INF_F, mx1 = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2_approx((m0 - mn0) * c), corr1 = exp2_approx((m1 - mn1) * c);
    const float mc0 = mn0 * c, mc1 = mn1 * c;
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[j][0] = exp2_approx(fmaf(sc[j][0], c, -mc0));
      sc[j][1] = exp2_approx(fmaf(sc[j][1], c, -mc0));
      sc[j][2] = exp2_approx(fmaf(sc[j][2], c, -mc1));
      sc[j][3] = exp2_approx(fmaf(sc[j][3], c, -mc1));
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr0;
      acc[j][1] *= corr0;
      acc[j][2] *= corr1;
      acc[j][3] *= corr1;
    }

    // O += P V: P's accumulator tiles 2 kk and 2 kk + 1 are the A-fragment
    // of k-step kk; each x4.trans load gives V's B-fragments of two n-tiles
    const bf16* vs = v_s + st * SIZE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vf[4];
        ld_b_kn(vf, vs + kk * 16 * LD + np * 16, LD, lane);
        mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
    cur = nxt;
  }

  // o = acc / l in bf16, staged through this warp's own rows of the q tile
  // (no other warp reads them) so that the stores are 16 bytes wide
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f, inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  bf16* os = q_s + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + j * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + j * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, s = q0 + warp * 16 + r;
    if (s < Sq)
      *reinterpret_cast<uint4*>(o + (((size_t)b * Sq + s) * H + h) * DH + (i % CH) * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + (i % CH) * 8);
  }
  if (t4 == 0) {   // lse = c m ln 2 + log l: the natural-log max plus log of the sum
    const float LN2 = 0.6931471805599453f;
    float* lrow = lse + ((size_t)b * H + h) * Sq;
    if (ok0) lrow[r0] = l0 > 0.f ? m0 * (c * LN2) + logf(l0) : NEG_INF_F;
    if (ok1) lrow[r1] = l1 > 0.f ? m1 * (c * LN2) + logf(l1) : NEG_INF_F;
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1)) +
         sizeof(int) * (BK + BQ + 2);
}

// threads a q row of the f32 kernel: two, four at d_head 256
__host__ __device__ constexpr int f32_log_tpr(int dh) { return dh > 128 ? 2 : 1; }
__host__ __device__ constexpr int f32_threads(int dh) { return BQ << f32_log_tpr(dh); }

template <int DH>
__global__ void __launch_bounds__(f32_threads(DH)) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, float* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KH,
    int qpos_bstride, int kvpos_bstride, float scale, int causal, int window,
    float softcap) {
  constexpr int LOG_TPR = f32_log_tpr(DH);
  constexpr int TPR = 1 << LOG_TPR;         // threads a row
  constexpr int NTF = f32_threads(DH);
  constexpr int HD = DH / TPR;   // output columns per thread (d = TPR*i + part)
  constexpr int HKF = BK / TPR;  // score columns per thread (j = TPR*jj + part)
  extern __shared__ float smem[];
  float* q_s = smem;                          // BQ x (DH+1)
  float* k_s = q_s + BQ * (DH + 1);           // BK x (DH+1)
  float* v_s = k_s + BK * (DH + 1);           // BK x DH
  float* p_s = v_s + BK * DH;                 // BQ x (BK+1)
  int* kp_s = reinterpret_cast<int*>(p_s + BQ * (BK + 1));   // BK
  int* qp_s = kp_s + BK;                                     // BQ
  int* range_s = qp_s + BQ;                                  // qmin, qmax

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int row = tid >> LOG_TPR;
  const int part = tid & (TPR - 1);

  for (int f = tid; f < BQ * DH; f += NTF) {
    const int r = f / DH, d = f % DH, s = q0 + r;
    q_s[r * (DH + 1) + d] =
        s < Sq ? q[(((size_t)b * Sq + s) * H + h) * DH + d] : 0.f;
  }
  for (int r = tid; r < BQ; r += NTF)
    qp_s[r] = q0 + r < Sq ? qpos[(size_t)b * qpos_bstride + q0 + r] : 0;
  __syncthreads();
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = 0; r < BQ && q0 + r < Sq; ++r) {
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    range_s[0] = lo;
    range_s[1] = hi;
  }
  __syncthreads();
  const int qmin = range_s[0], qmax = range_s[1];
  const bool row_ok = q0 + row < Sq;
  const int qp = qp_s[row];

  float m = NEG_INF_F, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    for (int j = tid; j < BK; j += NTF)
      kp_s[j] = j < nk ? kvpos[(size_t)b * kvpos_bstride + k0 + j] : 0;
    __syncthreads();
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int j = 0; j < nk; ++j) {
      kmin = min(kmin, kp_s[j]);
      kmax = max(kmax, kp_s[j]);
    }
    // every thread reaches the same verdict: the tile holds no key any row
    // of this q tile may see, so its K/V is never read
    if ((causal && kmin > qmax) || (window > 0 && kmax <= qmin - window)) {
      __syncthreads();
      continue;
    }
    for (int f = tid; f < BK * DH; f += NTF) {
      const int j = f / DH, d = f % DH;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = (((size_t)b * Sk + k0 + j) * KH + kh) * DH + d;
        kv = k[off];
        vv = v[off];
      }
      k_s[j * (DH + 1) + d] = kv;
      v_s[j * DH + d] = vv;
    }
    __syncthreads();

    // scores of this thread's row against columns j = TPR*jj + part (the
    // threads of a row interleave, so their shared-memory reads hit
    // different banks)
    float sc[HKF];
#pragma unroll
    for (int jj = 0; jj < HKF; ++jj) sc[jj] = 0.f;
    const float* qrow = q_s + row * (DH + 1);
    const float* kcol = k_s + part * (DH + 1);
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int jj = 0; jj < HKF; ++jj) sc[jj] += qd * kcol[TPR * jj * (DH + 1) + d];
    }
    unsigned valid = 0u;
    float tmax = NEG_INF_F;
#pragma unroll
    for (int jj = 0; jj < HKF; ++jj) {
      const int j = TPR * jj + part;
      float s = sc[jj] * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int kp = kp_s[j];
      const bool ok = row_ok && j < nk && (!causal || kp <= qp) &&
                      (window <= 0 || kp > qp - window);
      sc[jj] = ok ? s : NEG_INF_F;
      valid |= (ok ? 1u : 0u) << jj;
      tmax = fmaxf(tmax, sc[jj]);
    }
#pragma unroll
    for (int sh = 1; sh < TPR; sh <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, sh));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < HKF; ++jj) {
      const float p = (valid >> jj) & 1u ? expf(sc[jj] - m_new) : 0.f;
      p_s[row * (BK + 1) + TPR * jj + part] = p;
      psum += p;
    }
#pragma unroll
    for (int sh = 1; sh < TPR; sh <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, sh);
    l = l * corr + psum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] *= corr;
    const float* prow = p_s + row * (BK + 1);
    const float* vcol = v_s + part;
    for (int j = 0; j < nk; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] += p * vcol[j * DH + TPR * i];
    }
    __syncthreads();
  }

  if (row_ok) {
    const float safe_l = l > 0.f ? l : 1.f;
    float* orow = o + (((size_t)b * Sq + q0 + row) * H + h) * DH + part;
#pragma unroll
    for (int i = 0; i < HD; ++i) orow[TPR * i] = acc[i] / safe_l;
    if (part == 0)
      lse[((size_t)b * H + h) * Sq + q0 + row] = l > 0.f ? m + logf(l) : NEG_INF_F;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const int* qpos,
               const int* kvpos, void* o, float* lse, int B, int Sq, int Sk, int H,
               int KH, int qpos_bstride, int kvpos_bstride, float scale, int causal,
               int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<DH><<<grid, f32_threads(DH), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qpos, kvpos, static_cast<float*>(o), lse, Sq, Sk,
      H, KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const int* qpos,
                const int* kvpos, void* o, float* lse, int B, int Sq, int Sk, int H,
                int KH, int qpos_bstride, int kvpos_bstride, float scale, int causal,
                int window, float softcap, cudaStream_t stream) {
  // 16-byte cp.async and stores: every row starts on 16 bytes when the base does
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return -1;
  const int n_tiles = (Sk + BK - 1) / BK;
  const size_t smem = TcTile<DH>::BYTES + sizeof(int2) * n_tiles;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_tc_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), qpos, kvpos, static_cast<bf16*>(o), lse, Sq, Sk, H,
      KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, const int* qpos,
           const int* kvpos, void* o, float* lse, int B, int Sq, int Sk, int H, int KH,
           int qb, int kb, float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  if (dtype == DT_F32)
    return launch_f32<DH>(q, k, v, qpos, kvpos, o, lse, B, Sq, Sk, H, KH, qb, kb, scale,
                          causal, window, softcap, s);
  if (dtype == DT_BF16)
    return launch_bf16<DH>(q, k, v, qpos, kvpos, o, lse, B, Sq, Sk, H, KH, qb, kb, scale,
                           causal, window, softcap, s);
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// head dim / dtype the kernels do not take (or a bf16 pointer not on 16 bytes).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kvpos, void* o,
                                   void* lse, int B, int Sq, int Sk, int H, int KH,
                                   int DH, int dtype, int qpos_bstride,
                                   int kvpos_bstride, float scale, int causal,
                                   int window, float softcap, void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 16: return launch<16>(dtype, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap, s);
    case 32: return launch<32>(dtype, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap, s);
    case 64: return launch<64>(dtype, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap, s);
    case 112: return launch<112>(dtype, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap, s);
    case 128: return launch<128>(dtype, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap, s);
    case 256: return launch<256>(dtype, q, k, v, qp, kp, o, ls, B, Sq, Sk, H, KH, qpos_bstride, kvpos_bstride, scale, causal, window, softcap, s);
    default: return -1;
  }
}
