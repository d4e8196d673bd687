// Flash-attention backward, dk and dv, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_flash_dkv_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:699 (launched by `_flash_bhsd_bwd`
// :808, the backward of `flash_attention` :867).
//
// For one (b*h) slice, from the forward's lse and delta = sum(do * out),
// scale applied AFTER the dots as the TPU kernel does:
//   p[r][c]  = exp(q[r] . k[c] * scale - lse[r])      over live (r, c)
//   ds[r][c] = p[r][c] * (do[r] . v[c] - delta[r])
//   dv[c]    = sum_r p[r][c] do[r]
//   dk[c]    = scale * sum_r ds[r][c] q[r]
// Live pairs as in flash_fwd.cu (r < sq, c < sk, causal: r >= c).
//
// f32 build (flash_dkv_kernel; the pieces of flash_tf32.cuh): the
// transposed problem of flash_dq.cu's f32 build.  What bounds it: the
// operations, 8 d flops per live pair (k.q, v.do, p^T do, ds^T q): at the
// slice path's b1 h16 s8192 d64 causal 275 GFLOP, 0.56 ms at the dense
// TF32 rate of 495 TFLOP/s (4.10 ms at 67 TFLOP/s on the FMA pipes),
// against ~0.06 ms of bytes.  The kernel takes three TF32 products a term
// (3xTF32), 1.67 ms at that rate.  Design:
//   * a block of eight warps owns 128 keys, 16 a warp (dK and dV stay in
//     registers across the walk: 2 x d / 2 a thread), staged once; key
//     blocks are issued heaviest first (for causal the first, which every
//     query sees);
//   * the block walks the query tiles that see its keys (causal: from the
//     diagonal tile on) through a cp.async ring of three 64-query Q and
//     dO tiles with their lse and delta (16-query tiles at d = 128);
//   * S^T = K Q^T and dP^T = V dO^T by mma.sync m16n8k8 on TF32 operands,
//     every fragment split hi + lo in registers and multiplied as the
//     three terms of the split; p^T and ds^T on the accumulators, the
//     mask only on tiles that cross sq or the warp's diagonal, and a
//     warp skips a query tile wholly above it;
//   * dV += P^T dO and dK += dS^T Q with P^T and dS^T as A operands
//     straight from their accumulators, dO and Q read at rows 2t, 2t + 1
//     of the same staged tiles; each query tile's products sum in a fresh
//     accumulator that an f32 add puts into dV or dK (flash_tf32.cuh
//     tf_grad: the tensor cores' sums round toward zero, and one chain
//     over 8192 queries would drift ~2e-4);
//   * no atomics: each block owns its keys' rows, so two launches give
//     bitwise-equal outputs.
//
// bf16 build (flash_dkv_wgmma_kernel; the pieces of flash_mma.cuh).
// What bounds it: the operations on the bf16 tensor cores, 12 d flops
// per live pair with p and ds split in two (8 d without): at b1 h8
// s32768 d64 causal 3.3 TFLOP, 3.33 ms at 989 TFLOP/s (2.22 ms
// unsplit), against ~0.02 ms of bytes.  Design:
//   * a block of two warpgroups owns 128 keys, 64 each, staged once in
//     wgmma's interleaved layout; key blocks are issued heaviest first
//     (for causal the first, which every query sees);
//   * the block walks the query tiles that see its keys (causal: from
//     the diagonal tile on) through a cp.async ring of Q and dO tiles
//     (four buffers, copied two tiles ahead), each with its lse and
//     delta beside it in shared memory: per column here, so each lane
//     reads its 2 x NQ / 8 columns' pairs as float2;
//   * S^T = K Q^T and dP^T = V dO^T by wgmma, all K-major, in one batch;
//     p^T = 2^(scale log2(e) s - log2(e) lse) and ds^T = p^T (dp^T -
//     delta) on the accumulators, the mask only on tiles that cross sq or
//     the diagonal;
//   * dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T as register
//     operands from the accumulators, and dO and Q read N-major from the
//     same staged tiles;
//   * FlashAttention-3's pipeline within a warpgroup: tile j's S^T and
//     dP^T products are issued together with tile j - 1's dV and dK
//     products, and tile j's p and ds are formed while those run (~12 %
//     at s32768 on an H100: the block's one barrier a tile keeps its two
//     warpgroups in step, so without it both wait on the same products);
//   * P and dS are split into hi + lo bf16 and both halves multiplied,
//     as in flash_dq.cu, to stay within one bf16 step of the plain
//     version;
//   * registers: dK and dV (DP / 2 each) stay in registers across the
//     walk, beside two tiles' worth of S^T, dP^T and their hi + lo
//     operands, so a query tile is 64 wide up to d = 64 and 32 wide at d
//     = 128 (S^T and dP^T then take 16 registers each, dK and dV 128);
//     one block a multiprocessor, 255 registers a thread;
//   * no atomics: each block owns its keys' rows, so two launches give
//     bitwise-equal outputs.

#include "flash_mma.cuh"
#include "flash_tf32.cuh"

// the f32 build's shape at head width DP: queries per staged Q / dO tile
// (16 at d = 128, where dK and dV take 128 registers a thread), Q / dO
// buffers, keys a block (16 a warp)
template <int DP>
struct DkvTf {
  static constexpr int QT = DP <= 64 ? 64 : 16;
  static constexpr int STAGES = 3;
  static constexpr int BN = 16 * TF_WARPS;
  static constexpr size_t SMEM =
      (size_t)(2 * BN + 2 * STAGES * QT) * (DP + 4) * sizeof(float) +
      (size_t)STAGES * 2 * QT * sizeof(float);
};

template <int DP, int VEC>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int sq, int sk, int d, int causal,
                 float scale_log2, float scale) {
  constexpr int NST = DkvTf<DP>::STAGES, BN = DkvTf<DP>::BN;
  constexpr int QT = DkvTf<DP>::QT, LD = DP + 4, NQ = QT / 8, ND = DP / 8;
  extern __shared__ __align__(16) float tf_buf[];
  float* Ks = tf_buf;                  // BN x LD each
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;            // NST buffers of QT x LD
  float* dOs = Qs + NST * QT * LD;
  float* Ls = dOs + NST * QT * LD;     // per buffer: QT lse, QT delta

  const int k0 = blockIdx.x * BN;
  const long long bh = blockIdx.y;
  const float* qb = q + bh * sq * d;
  const float* ob = dout + bh * sq * d;
  const float* lb = lse + bh * sq;
  const float* deb = delta + bh * sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp * 16;            // the warp's first key in the block
  const int key_lo = k0 + wk, key_hi = key_lo + 15;
  // query tiles from the first that sees key k0 (tiles are aligned)
  const int qstart = causal ? k0 : 0;
  const int nqt = qstart < sq ? (sq - qstart + QT - 1) / QT : 0;

  float dka[1][ND][4], dva[1][ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[0][n][e] = dva[0][n][e] = 0.f;

  // query tile j of Q, dO, lse and delta into buffer j % NST
  auto stage_q = [&](int j) {
    const int nb = j % NST, r0 = qstart + j * QT;
    tf_stage<QT, DP, VEC>(Qs + nb * QT * LD, qb, r0, sq, d);
    tf_stage<QT, DP, VEC>(dOs + nb * QT * LD, ob, r0, sq, d);
    if (threadIdx.x < 2 * QT) {        // lse (threads < QT), then delta
      const int r = r0 + (threadIdx.x & (QT - 1));
      const float* src = threadIdx.x < QT ? lb : deb;
      const bool ok = r < sq;
      fw_cp4(fw_smem(Ls + nb * 2 * QT + threadIdx.x), ok ? src + r : src,
             ok ? 4 : 0);
    }
  };
  // K and V with query tile 0 (copy group 0), tiles 1 .. NST - 2 after
  tf_stage<BN, DP, VEC>(Ks, k + bh * sk * d, k0, sk, d);
  tf_stage<BN, DP, VEC>(Vs, v + bh * sk * d, k0, sk, d);
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < nqt) stage_q(j);
    fw_cp_commit();
  }
  // Tile `it` is copied NST - 1 tiles ahead into buffer it % NST, one copy
  // group a tile; the buffer refilled here held tile it - 1, which every
  // warp finished reading before this iteration's barrier
  for (int it = 0; it < nqt; ++it) {
    const int q0 = qstart + it * QT, buf = it % NST;
    tf_cp_wait<NST - 2>();
    __syncthreads();
    if (it + NST - 1 < nqt) stage_q(it + NST - 1);
    fw_cp_commit();
    if (causal && q0 + QT - 1 < key_lo) continue;  // above the diagonal
    const float* Qt = Qs + buf * QT * LD;
    const float* Ot = dOs + buf * QT * LD;
    const float* Lt = Ls + buf * 2 * QT;

    float s[1][NQ][4], dp[1][NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][n][e] = dp[0][n][e] = 0.f;
    // S^T = K Q^T, then dP^T = V dO^T, 8 columns of d a step
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[4], al[4];
      tf_load_a<LD>(Ks, wk + g, 8 * kk + t, ah, al);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        tf_mma3(s[0][n], ah, al, tf_load_bt<LD>(Qt, 8 * n + g, 8 * kk + t));
    }
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[4], al[4];
      tf_load_a<LD>(Vs, wk + g, 8 * kk + t, ah, al);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        tf_mma3(dp[0][n], ah, al, tf_load_bt<LD>(Ot, 8 * n + g, 8 * kk + t));
    }
    // p^T into s, ds^T into dp, on the accumulators (keys on rows, the
    // lane's two queries of a block share a float2 of lse and of delta);
    // the mask only on a tile that crosses sq or the warp's diagonal
    const bool edge = q0 + QT > sq || (causal && q0 < key_hi);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(Lt + 8 * n + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(Lt + QT + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float nl = ((e & 1) ? l.y : l.x) * -1.44269504f;
        float p = fw_exp2(fmaf(s[0][n][e], scale_log2, nl));
        if (edge) {
          const int query = q0 + 8 * n + 2 * t + (e & 1);
          const int key = key_lo + g + 8 * (e >> 1);
          if (query >= sq || (causal && key > query)) p = 0.f;
        }
        s[0][n][e] = p;
        dp[0][n][e] = p * (dp[0][n][e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    // dV += P^T dO, then dK += dS^T Q
    tf_grad<LD>(dva, s, Ot, t, g);
    tf_grad<LD>(dka, dp, Qt, t, g);
  }
  tf_cp_wait<0>();                     // no copy outlives the block

  tf_store<ND, VEC>(dk + bh * sk * d, dka[0], scale, key_lo + g, sk, d, t);
  tf_store<ND, VEC>(dv + bh * sk * d, dva[0], 1.f, key_lo + g, sk, d, t);
}

template <int DP, int VEC>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int sq, int sk, int d,
                      int causal, float scale, void* stream) {
  constexpr int BN = DkvTf<DP>::BN;
  return fw_launch<TF_THREADS>(
      flash_dkv_kernel<DP, VEC>, dim3((sk + BN - 1) / BN, bh), DkvTf<DP>::SMEM,
      stream, (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, sq, sk, d, causal, scale * 1.44269504f, scale);
}

template <int DP>
static int launch_dkv_vec(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int bh,
                          int sq, int sk, int d, int causal, float scale,
                          void* stream) {
  // 16-byte copies where every row start allows them, else 4-byte ones
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)dk | (uintptr_t)dv;
  if (d % 4 == 0 && addr % 16 == 0)
    return launch_dkv<DP, 4>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, causal, scale, stream);
  return launch_dkv<DP, 1>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                           causal, scale, stream);
}

extern "C" int flash_dkv_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int causal, float scale,
                             void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_dkv_vec<32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                              d, causal, scale, stream);
  if (d <= 64)
    return launch_dkv_vec<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                              d, causal, scale, stream);
  return launch_dkv_vec<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, causal, scale, stream);
}

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int DKV_GROUPS = 2;          // warpgroups per block, 64 keys each
constexpr int DKV_BN = 64 * DKV_GROUPS;  // keys per block
constexpr int DKV_THREADS = 128 * DKV_GROUPS;
constexpr int DKV_STAGES = 4;          // Q / dO tile buffers

// p^T of one 64 x NQ tile (keys on rows) on the S^T accumulator: p = 2^(s
// scale log2(e) - log2(e) lse[col]), lse of this tile's queries at lse_s.
// EDGE: a tile that crosses sq or the causal diagonal
template <bool EDGE, int NS>
__device__ __forceinline__ void dkv_p(float (&s)[NS],
                                      const float* __restrict__ lse_s,
                                      int q0, int sq, int causal, int ca,
                                      int t, float scale_log2) {
#pragma unroll
  for (int jb = 0; jb < NS / 4; ++jb) {
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * jb + 2 * t);
    const float nl[2] = {l.x * -1.44269504f, l.y * -1.44269504f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jb + e;
      if constexpr (EDGE) {
        const int row = q0 + 8 * jb + 2 * t + (e & 1);   // the query
        const int col = ca + 8 * (e >> 1);               // the key
        if (row >= sq || (causal && col > row)) s[i] = -INFINITY;
      }
      s[i] = fw_exp2(fmaf(s[i], scale_log2, nl[e & 1]));
    }
  }
}

// ds^T = p^T (dp^T - delta[col]) into dp, delta of the tile's queries at
// delta_s
template <int NS>
__device__ __forceinline__ void dkv_ds(const float (&p)[NS], float (&dp)[NS],
                                       const float* __restrict__ delta_s,
                                       int t) {
#pragma unroll
  for (int jb = 0; jb < NS / 4; ++jb) {
    const float2 dl =
        *reinterpret_cast<const float2*>(delta_s + 8 * jb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jb + e;
      dp[i] = p[i] * (dp[i] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

// dV += P^T dO and dK += dS^T Q for one query tile, with P^T and dS^T as
// hi + lo bf16 register operands and dO and Q read N-major from the
// tile's buffers (next 8 queries DP * 16 bytes on, next 8 columns 128)
template <int DP, int NS>
__device__ __forceinline__ void dkv_grads(float (&dv)[DP / 2],
                                          float (&dk)[DP / 2],
                                          const uint32_t (&ph)[NS / 8][4],
                                          const uint32_t (&pl)[NS / 8][4],
                                          const uint32_t (&sh)[NS / 8][4],
                                          const uint32_t (&sl)[NS / 8][4],
                                          uint32_t q_addr, uint32_t o_addr) {
  const uint64_t dqn = fw_desc(q_addr, DP * 16, 128);
  const uint64_t don = fw_desc(o_addr, DP * 16, 128);
#pragma unroll
  for (int kb = 0; kb < NS / 8; ++kb) {
    fw_pv<DP>(dv, ph[kb], don + kb * 2 * DP);
    fw_pv<DP>(dv, pl[kb], don + kb * 2 * DP);
  }
#pragma unroll
  for (int kb = 0; kb < NS / 8; ++kb) {
    fw_pv<DP>(dk, sh[kb], dqn + kb * 2 * DP);
    fw_pv<DP>(dk, sl[kb], dqn + kb * 2 * DP);
  }
}

template <int DP, int VEC>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int sq, int sk, int d,
                       int causal, float scale, float scale_log2) {
  constexpr int NQ = DP <= 64 ? 64 : 32;   // queries per staged tile
  constexpr int NS = NQ / 2;           // score accumulators per thread
  constexpr int KBYTES = DKV_BN * DP * 2, TBYTES = NQ * DP * 2;
  extern __shared__ __align__(128) unsigned char fw_buf[];
  unsigned char* Ks = fw_buf;
  unsigned char* Vs = Ks + KBYTES;
  unsigned char* Qs = Vs + KBYTES;     // DKV_STAGES buffers of TBYTES
  unsigned char* dOs = Qs + DKV_STAGES * TBYTES;
  // per buffer: NQ lse, then NQ delta
  float* Ls = reinterpret_cast<float*>(dOs + DKV_STAGES * TBYTES);

  // blockIdx.x walks a slice's key blocks from the first (for causal the
  // heaviest), blockIdx.y the slices
  const int k0 = blockIdx.x * DKV_BN;
  const long long bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * sq * d;
  const __nv_bfloat16* ob = dout + bh * sq * d;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;
  const int grp = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int kw = k0 + 64 * grp;        // the warpgroup's first key
  const int ca = kw + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // + 8
  // query tiles from the first that sees key k0 (tiles are aligned)
  const int qstart = causal ? k0 : 0;
  const int nqt = qstart < sq ? (sq - qstart + NQ - 1) / NQ : 0;
  // the warpgroup's first live tile: those before lie wholly above its
  // keys' diagonal
  const int first_live = causal ? grp * (64 / NQ) : 0;

  // K and V (the warpgroup's 64 keys) K-major for S^T and dP^T
  const uint64_t dka = fw_desc(fw_smem(Ks + grp * 64 * DP * 2), 128, DP * 16);
  const uint64_t dva = fw_desc(fw_smem(Vs + grp * 64 * DP * 2), 128, DP * 16);

  float dka_acc[DP / 2], dva_acc[DP / 2], s[NS], dp[NS];
  uint32_t ph[NS / 8][4], pl[NS / 8][4], sh[NS / 8][4], sl[NS / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka_acc[i] = dva_acc[i] = 0.f;

  const FwTilePlan<DP, DKV_THREADS, NQ> plan(d);
  const uint32_t qs_addr = fw_smem(Qs), os_addr = fw_smem(dOs);
  // query tile j of Q, dO, lse and delta into buffer j % DKV_STAGES
  auto stage_q = [&](int j) {
    const int nb = j % DKV_STAGES, r0 = qstart + j * NQ;
    if constexpr (VEC == 8) {
      plan.copy(qs_addr + nb * TBYTES, qb, r0, sq, d);
      plan.copy(os_addr + nb * TBYTES, ob, r0, sq, d);
    } else {
      fw_stage<NQ, DP, VEC, DKV_THREADS>(Qs + nb * TBYTES, qb, r0, sq, d);
      fw_stage<NQ, DP, VEC, DKV_THREADS>(dOs + nb * TBYTES, ob, r0, sq, d);
    }
    if (threadIdx.x < 2 * NQ) {        // lse (threads < NQ), then delta
      const int r = r0 + (threadIdx.x & (NQ - 1));
      const float* src = threadIdx.x < NQ ? lb : db;
      const bool ok = r < sq;
      fw_cp4(fw_smem(Ls + nb * 2 * NQ + threadIdx.x), ok ? src + r : src,
             ok ? 4 : 0);
    }
  };
  if constexpr (VEC == 8) {
    const FwTilePlan<DP, DKV_THREADS> kplan(d);
#pragma unroll
    for (int h = 0; h < DKV_GROUPS; ++h) {
      kplan.copy(fw_smem(Ks) + h * 64 * DP * 2, k + bh * sk * d, k0 + 64 * h,
                 sk, d);
      kplan.copy(fw_smem(Vs) + h * 64 * DP * 2, v + bh * sk * d, k0 + 64 * h,
                 sk, d);
    }
  } else {
    fw_stage<DKV_BN, DP, VEC, DKV_THREADS>(Ks, k + bh * sk * d, k0, sk, d);
    fw_stage<DKV_BN, DP, VEC, DKV_THREADS>(Vs, v + bh * sk * d, k0, sk, d);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < nqt) stage_q(j);
    fw_cp_commit();
  }
  // Tile `it` is copied two tiles ahead into buffer it % 4, one copy
  // group a tile.  A live tile's S^T and dP^T products are issued
  // together with the dV and dK products of the tile before (from its
  // buffer, (it - 1) % 4), and its p and ds are formed while those run.
  // Buffer (it + 2) % 4 last held tile it - 2, whose products finished in
  // iteration it - 1, before this iteration's barrier.
  for (int it = 0; it < nqt; ++it) {
    const int q0 = qstart + it * NQ, buf = it % DKV_STAGES;
    fw_cp_wait<1>();                   // tile it (and K, V) has landed
    __syncthreads();
    if (it + 2 < nqt) stage_q(it + 2);
    fw_cp_commit();
    if (it < first_live) continue;
    const uint64_t dqk = fw_desc(qs_addr + buf * TBYTES, 128, DP * 16);
    const uint64_t dok = fw_desc(os_addr + buf * TBYTES, 128, DP * 16);
    const float* lse_s = Ls + buf * 2 * NQ;
    fw_pin(s);
    fw_pin(dp);
    fw_pin(dka_acc);
    fw_pin(dva_acc);
    fw_pin(ph);
    fw_pin(pl);
    fw_pin(sh);
    fw_pin(sl);
    fw_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      fw_mma_ss<NQ>(s, dka + kk * 16, dqk + kk * 16, kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      fw_mma_ss<NQ>(dp, dva + kk * 16, dok + kk * 16, kk > 0);
    fw_commit();
    if (it > first_live) {             // dV, dK of the tile before
      const int pb = (it + DKV_STAGES - 1) % DKV_STAGES;
      dkv_grads<DP, NS>(dva_acc, dka_acc, ph, pl, sh, sl,
                        qs_addr + pb * TBYTES, os_addr + pb * TBYTES);
      fw_commit();
      fw_wait<1>();                    // S^T, dP^T have landed
    } else {
      fw_wait<0>();
    }
    fw_pin(s);
    fw_pin(dp);
    if (q0 + NQ > sq || (causal && q0 < kw + 63))
      dkv_p<true>(s, lse_s, q0, sq, causal, ca, t, scale_log2);
    else
      dkv_p<false>(s, lse_s, q0, sq, causal, ca, t, scale_log2);
    dkv_ds(s, dp, lse_s + NQ, t);
    fw_wait<0>();                      // the tile before's dV, dK are done
    fw_pin(dka_acc);
    fw_pin(dva_acc);
    fw_pin(ph);
    fw_pin(pl);
    fw_pin(sh);
    fw_pin(sl);
    fw_split(s, ph, pl);
    fw_split(dp, sh, sl);
  }
  // the dV and dK products of the warpgroup's last live tile; no copy
  // was issued into its buffers after it
  if (nqt > first_live) {
    const int lb = (nqt - 1) % DKV_STAGES;
    fw_pin(dka_acc);
    fw_pin(dva_acc);
    fw_pin(ph);
    fw_pin(pl);
    fw_pin(sh);
    fw_pin(sl);
    fw_fence();
    dkv_grads<DP, NS>(dva_acc, dka_acc, ph, pl, sh, sl,
                      qs_addr + lb * TBYTES, os_addr + lb * TBYTES);
    fw_commit();
    fw_wait<0>();
    fw_pin(dka_acc);
    fw_pin(dva_acc);
  }
  fw_cp_wait<0>();                     // no copy outlives the block

  // dk = scale * acc and dv, each rounded once to bf16
  fw_store<DP, VEC>(dk + bh * sk * d, dka_acc, scale, ca, sk, d, t);
  fw_store<DP, VEC>(dv + bh * sk * d, dva_acc, 1.f, ca, sk, d, t);
}

template <int DP, int VEC>
static int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int sq, int sk, int d, int causal, float scale,
                            void* stream) {
  constexpr int NQ = DP <= 64 ? 64 : 32;
  const size_t smem = (size_t)(2 * DKV_BN + 2 * DKV_STAGES * NQ) * DP * 2 +
                      (size_t)DKV_STAGES * 2 * NQ * sizeof(float);
  auto kernel = flash_dkv_wgmma_kernel<DP, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((sk + DKV_BN - 1) / DKV_BN, bh), DKV_THREADS, smem,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, sq, sk, d, causal, scale, scale * 1.44269504f);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_dkv_wgmma_vec(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int bh, int sq, int sk, int d, int causal,
                                float scale, void* stream) {
  // the widest copy every row start allows: 16 bytes, 4 bytes or plain
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)dout | (uintptr_t)dk | (uintptr_t)dv;
  if (d % 8 == 0 && addr % 16 == 0)
    return launch_dkv_wgmma<DP, 8>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                   sk, d, causal, scale, stream);
  if (d % 2 == 0 && addr % 4 == 0)
    return launch_dkv_wgmma<DP, 2>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                   sk, d, causal, scale, stream);
  return launch_dkv_wgmma<DP, 1>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                 sk, d, causal, scale, stream);
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh,
                              int sq, int sk, int d, int causal, float scale,
                              void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_dkv_wgmma_vec<32>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    sq, sk, d, causal, scale, stream);
  if (d <= 64)
    return launch_dkv_wgmma_vec<64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    sq, sk, d, causal, scale, stream);
  return launch_dkv_wgmma_vec<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                   sk, d, causal, scale, stream);
}
