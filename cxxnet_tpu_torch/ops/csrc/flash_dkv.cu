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
// f32 build (flash_dkv_kernel, tiles of flash_attn.cuh): one block per
// (64-row key tile, b*h slice); the transposed problem of flash_dq.cu.
// The K and V tiles stay in shared memory; the block walks the query
// tiles that see its keys (for causal, from the diagonal tile down),
// staging q, do, lse and delta, computing the transposed score and
// v.do^T tiles in registers (keys on rows), writing p^T and ds^T to
// shared memory and accumulating p^T do and ds^T q into two (64, d)
// register tiles.  Each block owns its rows of dk and dv: no atomics, and
// no (sq, sk) matrix in device memory.  Bound on an H100: the
// operations, 8 d flops per live pair (k.q, v.do, p^T do, ds^T q): 275
// GFLOP at the slice path's b1 h16 s8192 d64 causal, 4.10 ms at 67
// TFLOP/s f32, against ~0.06 ms of bytes; FMA pipes fed from
// conflict-free shared memory.
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

#include "flash_attn.cuh"
#include "flash_mma.cuh"

template <typename T, int DPAD>
__global__ void __launch_bounds__(FA_THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int sq, int sk, int d, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* Kt = smem;                    // DPAD x FA_LD each
  float* Vt = Kt + DPAD * FA_LD;
  float* Qt = Vt + DPAD * FA_LD;
  float* dOt = Qt + DPAD * FA_LD;
  float* PT = dOt + DPAD * FA_LD;      // FA_TILE x FA_LD, keys on rows
  float* DST = PT + FA_TILE * FA_LD;
  float* lse_s = DST + FA_TILE * FA_LD;   // FA_TILE each
  float* delta_s = lse_s + FA_TILE;
  const int k0 = blockIdx.x * FA_TILE;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * sq * d;
  const T* ob = dout + bh * sq * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  fa_stage<T, DPAD>(Kt, k + bh * sk * d, k0, sk, d, 1.f);
  fa_stage<T, DPAD>(Vt, v + bh * sk * d, k0, sk, d, 1.f);
  float dka[4][DPAD / 16], dva[4][DPAD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) dka[i][c] = dva[i][c] = 0.f;
  // the first query tile that sees key k0 (tiles are aligned)
  for (int q0 = causal ? k0 : 0; q0 < sq; q0 += FA_TILE) {
    __syncthreads();
    fa_stage<T, DPAD>(Qt, qb, q0, sq, d, 1.f);
    fa_stage<T, DPAD>(dOt, ob, q0, sq, d, 1.f);
    if (threadIdx.x < FA_TILE) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < sq ? lse[bh * sq + row] : 0.f;
      delta_s[threadIdx.x] = row < sq ? delta[bh * sq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    fa_qk<DPAD>(Kt, Qt, ty, tx, s);    // s[i][j]: key ty+16i, query tx+16j
    fa_qk<DPAD>(Vt, dOt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float p = fa_live(q0 + r, col, sq, sk, causal)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        PT[(ty + 16 * i) * FA_LD + r] = p;
        DST[(ty + 16 * i) * FA_LD + r] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    fa_pv<DPAD>(PT, dOt, ty, tx, dva);
    fa_pv<DPAD>(DST, Qt, ty, tx, dka);
  }

  T* kd = dk + bh * sk * d;
  T* vd = dv + bh * sk * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        FaElem<T>::store(kd + (long long)row * d + col, dka[i][c] * scale);
        FaElem<T>::store(vd + (long long)row * d + col, dva[i][c]);
      }
    }
  }
}

template <typename T, int DPAD>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int sq, int sk, int d,
                      int causal, float scale, void* stream) {
  const size_t smem = (size_t)(4 * DPAD + 2 * FA_TILE) * FA_LD * sizeof(float)
                      + 2 * FA_TILE * sizeof(float);
  return fa_launch(flash_dkv_kernel<T, DPAD>,
                   dim3((sk + FA_TILE - 1) / FA_TILE, bh), smem, stream,
                   (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                   (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                   sq, sk, d, causal, scale);
}

template <typename T>
static int dispatch_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int sq, int sk, int d,
                        int causal, float scale, void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, causal, scale, stream);
  if (d <= 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, causal, scale, stream);
  return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                            causal, scale, stream);
}

extern "C" int flash_dkv_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int causal, float scale,
                             void* stream) {
  return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                             causal, scale, stream);
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
