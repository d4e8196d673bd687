// Flash-attention backward, dq, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_flash_dq_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:661 (launched by `_flash_bhsd_bwd`
// :808, the backward of `flash_attention` :867).
//
// For one (b*h) slice, from the forward's lse and delta = sum(do * out)
// (computed by the caller, outside any kernel), with scale applied AFTER
// the dots, as the TPU kernel does:
//   p[r][c]  = exp(q[r] . k[c] * scale - lse[r])      over live (r, c)
//   ds[r][c] = p[r][c] * (do[r] . v[c] - delta[r])
//   dq[r]    = scale * sum_c ds[r][c] k[c]
// Live pairs as in flash_fwd.cu (c < sk, causal: r >= c).
//
// f32 build (flash_dq_kernel; the pieces of flash_tf32.cuh).  What bounds
// it: the operations, 6 d flops per live pair (q.k, do.v, ds.k): at the
// slice path's b1 h16 s8192 d64 causal 206 GFLOP, 0.42 ms at the dense
// TF32 rate of 495 TFLOP/s (3.08 ms at 67 TFLOP/s on the FMA pipes),
// against ~0.05 ms of bytes.  The kernel takes three TF32 products a term
// (the 3xTF32 split keeps f32 accuracy), 1.25 ms at that rate.  Design:
//   * a block of eight warps owns 256 query rows (32 a warp, two 16-row
//     fragments) up to d = 64 and 128 at d = 128 (16 a warp: dQ alone
//     then takes 64 registers a thread); query tiles are issued heaviest
//     first; Q and dO are staged once, the 32-key K and V tiles through
//     a cp.async ring (three buffers, two at d = 128, where Q and dO take
//     135 KB), 16-byte copies where d % 4 == 0, else 4-byte ones;
//   * per key tile, S = Q K^T and dP = dO V^T by mma.sync m16n8k8 on
//     TF32 operands: each fragment is loaded from the row-major staged
//     tile (rows padded to d + 4 floats: no bank conflicts) and split
//     into hi + lo in registers (flash_tf32.cuh: two instructions a
//     value), and each product is the three terms of the split (the B
//     fragment's split serves the warp's two row fragments);
//   * on the accumulators, p = 2^(scale log2(e) s - log2(e) lse) and ds =
//     p (dp - delta), with each row's lse and delta held in registers,
//     the mask only on tiles that cross sk or the warp's causal diagonal;
//     a warp skips a key tile wholly above its diagonal;
//   * dQ += dS K with dS as the A operand straight from its accumulator
//     (flash_tf32.cuh's relabelling of the contraction) and K's fragments
//     read at rows 2t, 2t + 1 of the same staged tile; each key tile's
//     products sum in a fresh accumulator that an f32 add puts into dQ
//     (flash_tf32.cuh tf_grad: the tensor cores' sums round toward zero,
//     and one chain over 8192 keys would drift ~2e-4);
//   * no atomics: each block owns its rows of dq, so two launches give
//     bitwise-equal outputs.
//
// bf16 build (flash_dq_wgmma_kernel; the pieces of flash_mma.cuh that
// the forward's tensor-core build uses).  What bounds it: the operations
// on the bf16 tensor cores (989 TFLOP/s dense), 8 d flops per live pair
// with ds split in two (6 d without): at b1 h8 s32768 d64 causal 2.2
// TFLOP, 2.22 ms (1.67 ms unsplit), against ~0.02 ms of bytes.  Design:
//   * the forward's block: two warpgroups of 64 query rows each, query
//     tiles issued heaviest first; Q and dO staged once, the 64-key K and
//     V tiles through the forward's cp.async ring (four buffers, copied
//     two tiles ahead; 16-byte copies planned once per thread, 4-byte or
//     plain ones for a head width that is not a multiple of 8);
//   * per key tile, S = Q K^T and dP = dO V^T by wgmma (m64n64k16, all
//     operands K-major from shared memory) in one batch; then, on the
//     accumulators, p = 2^(scale log2(e) s - log2(e) lse) and ds = p (dp
//     - delta) with each row's lse and delta held in registers (rows g
//     and g + 8 of the lane), the mask only on tiles that cross sk or
//     the causal diagonal;
//   * dQ += dS K by wgmma with dS as the register operand, taken from
//     the accumulator as the forward takes P, and K read N-major from the
//     same staged tile (no transposed copy), in two halves of 32 keys:
//     the first half's products run while the second half's ds is formed
//     (3-7 % at s32768 on an H100; products of tile j issued with tile j
//     + 1's S and dP were slower: 160 registers leave one block an SM);
//   * ds is split into hi + lo bf16 (flash_mma.cuh fw_split) and both
//     halves are multiplied: a row's ds sums to ~0 (sum_c p dp = delta),
//     so dq cancels harder than the forward's out, and a bf16 ds alone
//     misses the one-bf16-step bound against the plain version;
//   * no atomics: each block owns its rows; no call and no fence in a
//     path ptxas cannot prove warp-uniform (the warpgroup index is read
//     through __shfl_sync), so no wgmma is serialized.


#include "flash_mma.cuh"
#include "flash_tf32.cuh"

// the f32 build's shape at head width DP: 16-row fragments a warp, keys
// per staged K / V tile, K / V buffers, query rows a block
template <int DP>
struct DqTf {
  static constexpr int MT = DP <= 64 ? 2 : 1;
  static constexpr int KT = 32;
  static constexpr int STAGES = DP <= 64 ? 3 : 2;
  static constexpr int BM = 16 * MT * TF_WARPS;
  static constexpr size_t SMEM =
      (size_t)(2 * BM + 2 * STAGES * KT) * (DP + 4) * sizeof(float);
};

template <int DP, int VEC>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int sq, int sk, int d, int causal, float scale_log2,
                float scale) {
  constexpr int MT = DqTf<DP>::MT, NST = DqTf<DP>::STAGES;
  constexpr int BM = DqTf<DP>::BM, KT = DqTf<DP>::KT, LD = DP + 4;
  constexpr int NK = KT / 8, ND = DP / 8;
  extern __shared__ __align__(16) float tf_buf[];
  float* Qs = tf_buf;                  // BM x LD each
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;           // NST buffers of KT x LD
  float* Vs = Ks + NST * KT * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const long long bh = blockIdx.y;
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16 * MT;       // the warp's first row in the tile
  const int row_lo = q0 + wr, row_hi = row_lo + 16 * MT - 1;
  const int kend = causal ? min(sk, q0 + BM) : sk;
  const int ntiles = (kend + KT - 1) / KT;

  // -lse log2(e) and delta of the lane's rows (fragment m, + 8 h); 0 past
  // sq: those rows are never stored
  float nl[MT][2], dl[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 16 * m + 8 * h + g;
      nl[m][h] = row < sq ? -lse[bh * sq + row] * 1.44269504f : 0.f;
      dl[m][h] = row < sq ? delta[bh * sq + row] : 0.f;
    }
  float acc[MT][ND][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // Q and dO with tile 0 (copy group 0), tiles 1 .. NST - 2 after
  tf_stage<BM, DP, VEC>(Qs, q + bh * sq * d, q0, sq, d);
  tf_stage<BM, DP, VEC>(dOs, dout + bh * sq * d, q0, sq, d);
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < ntiles) {
      tf_stage<KT, DP, VEC>(Ks + j * KT * LD, kb, j * KT, sk, d);
      tf_stage<KT, DP, VEC>(Vs + j * KT * LD, vb, j * KT, sk, d);
    }
    fw_cp_commit();
  }
  // Tile `it` is copied NST - 1 tiles ahead into buffer it % NST, one copy
  // group a tile; the buffer refilled here held tile it - 1, which every
  // warp finished reading before this iteration's barrier
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * KT, buf = it % NST;
    tf_cp_wait<NST - 2>();
    __syncthreads();
    if (it + NST - 1 < ntiles) {
      const int j = it + NST - 1, nb = j % NST;
      tf_stage<KT, DP, VEC>(Ks + nb * KT * LD, kb, j * KT, sk, d);
      tf_stage<KT, DP, VEC>(Vs + nb * KT * LD, vb, j * KT, sk, d);
    }
    fw_cp_commit();
    if (causal && k0 > row_hi) continue;   // wholly above the diagonal
    const float* Kt = Ks + buf * KT * LD;
    const float* Vt = Vs + buf * KT * LD;

    float s[MT][NK][4], dp[MT][NK][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][n][e] = dp[m][n][e] = 0.f;
    // S = Q K^T, then dP = dO V^T, 8 columns of d a step
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        tf_load_a<LD>(Qs, wr + 16 * m + g, 8 * kk + t, ah[m], al[m]);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const TfB b = tf_load_bt<LD>(Kt, 8 * n + g, 8 * kk + t);
#pragma unroll
        for (int m = 0; m < MT; ++m) tf_mma3(s[m][n], ah[m], al[m], b);
      }
    }
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        tf_load_a<LD>(dOs, wr + 16 * m + g, 8 * kk + t, ah[m], al[m]);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const TfB b = tf_load_bt<LD>(Vt, 8 * n + g, 8 * kk + t);
#pragma unroll
        for (int m = 0; m < MT; ++m) tf_mma3(dp[m][n], ah[m], al[m], b);
      }
    }
    // p and ds on the accumulators (ds into s); the mask only on a tile
    // that crosses sk or the warp's diagonal
    const bool edge = k0 + KT > sk || (causal && k0 + KT - 1 > row_lo);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = fw_exp2(fmaf(s[m][n][e], scale_log2, nl[m][h]));
          if (edge) {
            const int row = row_lo + 16 * m + 8 * h + g;
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= sk || (causal && col > row)) p = 0.f;
          }
          s[m][n][e] = p * (dp[m][n][e] - dl[m][h]);
        }
    tf_grad<LD>(acc, s, Kt, t, g);     // dQ += dS K
  }
  tf_cp_wait<0>();                     // no copy outlives the block

  float* db = dq + bh * sq * d;
#pragma unroll
  for (int m = 0; m < MT; ++m)
    tf_store<ND, VEC>(db, acc[m], scale, row_lo + 16 * m + g, sq, d, t);
}

template <int DP, int VEC>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int sq, int sk, int d, int causal,
                     float scale, void* stream) {
  constexpr int BM = DqTf<DP>::BM;
  return fw_launch<TF_THREADS>(
      flash_dq_kernel<DP, VEC>, dim3((sq + BM - 1) / BM, bh), DqTf<DP>::SMEM,
      stream, (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, (const float*)lse, (const float*)delta, (float*)dq,
      sq, sk, d, causal, scale * 1.44269504f, scale);
}

template <int DP>
static int launch_dq_vec(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, int bh, int sq, int sk,
                         int d, int causal, float scale, void* stream) {
  // 16-byte copies where every row start allows them, else 4-byte ones
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)dq;
  if (d % 4 == 0 && addr % 16 == 0)
    return launch_dq<DP, 4>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                            causal, scale, stream);
  return launch_dq<DP, 1>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                          causal, scale, stream);
}

extern "C" int flash_dq_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, int causal, float scale,
                            void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_dq_vec<32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                             causal, scale, stream);
  if (d <= 64)
    return launch_dq_vec<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                             causal, scale, stream);
  return launch_dq_vec<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                            causal, scale, stream);
}

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int DQ_KT = 64;              // keys per staged K / V tile
constexpr int DQ_GROUPS = 2;           // warpgroups per block, 64 rows each
constexpr int DQ_BM = 64 * DQ_GROUPS;  // query rows per block
constexpr int DQ_THREADS = 128 * DQ_GROUPS;
constexpr int DQ_STAGES = 4;           // K / V tile buffers

// ds = p (dp - delta) on half hf (keys 32 hf .. 32 hf + 31) of a 64 x 64
// tile's S accumulator, with p = 2^(s scale log2(e) + nl) and nl = -lse
// log2(e) of the lane's two rows.  EDGE: a tile that crosses sk or the
// causal diagonal (a separate instantiation, so that inner tiles carry
// no mask code)
template <bool EDGE, int NS>
__device__ __forceinline__ void dq_ds(float (&s)[NS], const float (&dp)[NS],
                                      int hf, const float (&nl)[2],
                                      const float (&dl)[2], int k0, int sk,
                                      int causal, int ra, int t,
                                      float scale_log2) {
  // (start + a constant count: the loop unrolls, s stays in registers)
#pragma unroll
  for (int i = hf * (NS / 2); i < hf * (NS / 2) + NS / 2; ++i) {
    const int h = (i >> 1) & 1;
    if constexpr (EDGE) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (col >= sk || (causal && col > ra + 8 * h)) s[i] = -INFINITY;
    }
    s[i] = fw_exp2(fmaf(s[i], scale_log2, nl[h])) * (dp[i] - dl[h]);
  }
}

template <int DP, int VEC>
__global__ void __launch_bounds__(DQ_THREADS, DP <= 64 ? 2 : 1)
flash_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int sq, int sk, int d,
                      int causal, float scale, float scale_log2) {
  constexpr int NS = DQ_KT / 2;        // score accumulators per thread
  constexpr int QBYTES = DQ_BM * DP * 2, TBYTES = DQ_KT * DP * 2;
  extern __shared__ __align__(128) unsigned char fw_buf[];
  unsigned char* Qs = fw_buf;
  unsigned char* dOs = Qs + QBYTES;
  unsigned char* Ks = dOs + QBYTES;    // DQ_STAGES buffers of TBYTES
  unsigned char* Vs = Ks + DQ_STAGES * TBYTES;

  // blockIdx.x walks a slice's query tiles from the last (for causal the
  // heaviest first), blockIdx.y the slices
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BM;
  const long long bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * sq * d;
  const __nv_bfloat16* ob = dout + bh * sq * d;
  const __nv_bfloat16* kb = k + bh * sk * d;
  const __nv_bfloat16* vb = v + bh * sk * d;
  // the warpgroup index through a shuffle: ptxas then knows every branch
  // on it is warp-uniform (a wgmma fence it cannot prove uniform
  // serializes every wgmma of the kernel)
  const int grp = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + 64 * grp;    // the warpgroup's first query row
  const int ra = row_lo + 16 * ((threadIdx.x >> 5) & 3) + g;  // and + 8
  const int kend = causal ? min(sk, q0 + DQ_BM) : sk;
  const int ntiles = (kend + DQ_KT - 1) / DQ_KT;
  // the warpgroup's live key tiles are 0 .. nlive - 1 (a tile wholly
  // above its rows' causal diagonal is skipped)
  const int nlive = causal ? min(ntiles, row_lo / DQ_KT + 1) : ntiles;

  // -lse log2(e) and delta of the lane's rows ra and ra + 8 (0 past sq:
  // those rows are never stored)
  float nl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    nl[h] = row < sq ? -lse[bh * sq + row] * 1.44269504f : 0.f;
    dl[h] = row < sq ? delta[bh * sq + row] : 0.f;
  }

  // Q, dO (the warpgroup's 64 rows) and K, V K-major for S and dP; K
  // N-major (next 8 keys DP * 16 bytes on, next 8 columns 128) for dS K
  const uint64_t dqa = fw_desc(fw_smem(Qs + grp * 64 * DP * 2), 128, DP * 16);
  const uint64_t doa = fw_desc(fw_smem(dOs + grp * 64 * DP * 2), 128,
                               DP * 16);

  float acc[DP / 2], s[NS], dp[NS];
  uint32_t hi[NS / 8][4], lo[NS / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  const FwTilePlan<DP, DQ_THREADS> plan(d);
  const uint32_t ks_addr = fw_smem(Ks), vs_addr = fw_smem(Vs);
  // tile j of K and V into buffer j % DQ_STAGES
  auto stage_kv = [&](int j) {
    const int nb = j % DQ_STAGES;
    if constexpr (VEC == 8) {
      plan.copy(ks_addr + nb * TBYTES, kb, j * DQ_KT, sk, d);
      plan.copy(vs_addr + nb * TBYTES, vb, j * DQ_KT, sk, d);
    } else {
      fw_stage<DQ_KT, DP, VEC, DQ_THREADS>(Ks + nb * TBYTES, kb, j * DQ_KT,
                                           sk, d);
      fw_stage<DQ_KT, DP, VEC, DQ_THREADS>(Vs + nb * TBYTES, vb, j * DQ_KT,
                                           sk, d);
    }
  };
  if constexpr (VEC == 8) {           // each warpgroup's 64 rows of Q, dO
#pragma unroll
    for (int h = 0; h < DQ_GROUPS; ++h) {
      plan.copy(fw_smem(Qs) + h * 64 * DP * 2, qb, q0 + 64 * h, sq, d);
      plan.copy(fw_smem(dOs) + h * 64 * DP * 2, ob, q0 + 64 * h, sq, d);
    }
  } else {
    fw_stage<DQ_BM, DP, VEC, DQ_THREADS>(Qs, qb, q0, sq, d);
    fw_stage<DQ_BM, DP, VEC, DQ_THREADS>(dOs, ob, q0, sq, d);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < ntiles) stage_kv(j);
    fw_cp_commit();
  }
  // Tile `it` is copied two tiles ahead into buffer it % 4, one copy
  // group a tile; a warpgroup's products of tile it end (fw_wait<0>)
  // before the barrier of tile it + 1, so buffer (it + 2) % 4 is free
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * DQ_KT, buf = it % DQ_STAGES;
    fw_cp_wait<1>();                   // tile it (and Q, dO) has landed
    __syncthreads();
    if (it + 2 < ntiles) stage_kv(it + 2);
    fw_cp_commit();
    if (it >= nlive) continue;
    const uint32_t kt = fw_smem(Ks + buf * TBYTES);
    const uint64_t dk = fw_desc(kt, 128, DP * 16);
    const uint64_t dv = fw_desc(fw_smem(Vs + buf * TBYTES), 128, DP * 16);
    const uint64_t dkn = fw_desc(kt, DP * 16, 128);
    fw_pin(s);
    fw_pin(dp);
    fw_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      fw_mma_ss_n64(s, dqa + kk * 16, dk + kk * 16, kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      fw_mma_ss_n64(dp, doa + kk * 16, dv + kk * 16, kk > 0);
    fw_commit();
    fw_wait<0>();
    fw_pin(s);
    fw_pin(dp);
    // dQ += dS K in two halves of 32 keys: the first half's products run
    // while the second half's ds is formed
    const bool edge = k0 + DQ_KT > sk || (causal && k0 + DQ_KT - 1 > row_lo);
    fw_pin(acc);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (edge)
        dq_ds<true>(s, dp, hf, nl, dl, k0, sk, causal, ra, t, scale_log2);
      else
        dq_ds<false>(s, dp, hf, nl, dl, k0, sk, causal, ra, t, scale_log2);
      // keys 16 kb .. 16 kb + 15 are the accumulator's 8-key blocks 2 kb
      // and 2 kb + 1 (fw_split, half by half)
#pragma unroll
      for (int kb = hf * (NS / 16); kb < hf * (NS / 16) + NS / 16; ++kb)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kb + 4 * (r >> 1) + 2 * (r & 1);
          hi[kb][r] = fw_pack(s[i], s[i + 1]);
          lo[kb][r] = fw_pack_rest(s[i], s[i + 1], hi[kb][r]);
        }
      fw_pin(hi);
      fw_pin(lo);
      fw_fence();
#pragma unroll
      for (int kb = hf * (NS / 16); kb < hf * (NS / 16) + NS / 16; ++kb) {
        fw_pv<DP>(acc, hi[kb], dkn + kb * 2 * DP);
        fw_pv<DP>(acc, lo[kb], dkn + kb * 2 * DP);
      }
      fw_commit();
    }
    fw_wait<0>();
    fw_pin(acc);
    fw_pin(hi);
    fw_pin(lo);
  }

  // dq = scale * acc, rounded once to bf16
  fw_store<DP, VEC>(dq + bh * sq * d, acc, scale, ra, sq, d, t);
}

template <int DP, int VEC>
static int launch_dq_wgmma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int sq,
                           int sk, int d, int causal, float scale,
                           void* stream) {
  const size_t smem = (size_t)(2 * DQ_BM + 2 * DQ_STAGES * DQ_KT) * DP * 2;
  auto kernel = flash_dq_wgmma_kernel<DP, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((sq + DQ_BM - 1) / DQ_BM, bh), DQ_THREADS, smem,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, sq, sk, d,
      causal, scale, scale * 1.44269504f);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_dq_wgmma_vec(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int sq,
                               int sk, int d, int causal, float scale,
                               void* stream) {
  // the widest copy every row start allows: 16 bytes, 4 bytes or plain
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)dq;
  if (d % 8 == 0 && addr % 16 == 0)
    return launch_dq_wgmma<DP, 8>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                  d, causal, scale, stream);
  if (d % 2 == 0 && addr % 4 == 0)
    return launch_dq_wgmma<DP, 2>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                  d, causal, scale, stream);
  return launch_dq_wgmma<DP, 1>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                                causal, scale, stream);
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int bh, int sq,
                             int sk, int d, int causal, float scale,
                             void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_dq_wgmma_vec<32>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                   d, causal, scale, stream);
  if (d <= 64)
    return launch_dq_wgmma_vec<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                   d, causal, scale, stream);
  return launch_dq_wgmma_vec<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                  d, causal, scale, stream);
}
