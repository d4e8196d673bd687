// Flash-attention forward, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_flash_fwd_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:612 (launched by `_flash_fwd_impl`
// :768, the forward of `flash_attention` :867, which
// parallel/sequence.py's Ulysses attention takes as its local attention
// when the dense score matrix would not fit).
//
// For one (b*h) slice, with scale = 1 / sqrt(d):
//   s[r][c]  = scale * (q[r] . k[c])          over live (r, c)
//   out[r]   = sum_c exp(s[r][c] - m_r) v[c] / l_r
//   lse[r]   = m_r + log(l_r)                  (f32; the backward's input)
// with m_r, l_r the running max and denominator of row r.  A pair (r, c)
// is live when c < sk and, for causal, r >= c (top-left alignment).
//
// f32 build (flash_fwd_kernel, tiles of flash_attn.cuh), with q scaled
// BEFORE the dot as the TPU kernel does: one block per (64-row query
// tile, b*h slice), tiles issued from the last (for causal the heaviest)
// to the first.  The query tile, pre-scaled, stays in shared memory; the
// block walks the key tiles, staging K and V, computing the 64 x 64 score
// tile in registers (4 x 4 per thread), updating each row's max and
// denominator in registers (half-warp shuffles), writing the tile's
// weights to shared memory and accumulating P V into a (64, d) register
// tile, all on FMA pipes.  Bound on an H100: the operations, 4 d flops
// per live pair against 4 d bytes of q, k, v, out per row: at the slice
// path's b1 h16 s8192 d64 causal, 137 GFLOP against ~135 MB, 2.05 ms at
// 67 TFLOP/s f32 and 0.04 ms at 3.35 TB/s.
//
// bf16 build (flash_fwd_wgmma_kernel, FlashAttention-2's loop on
// Hopper's warpgroup products; pieces in flash_mma.cuh).  What bounds it:
// the same 4 d flops per live pair, now on the bf16 tensor cores (989
// TFLOP/s dense): at b1 h8 s32768 d64 causal 1.1 TFLOP, 1.1 ms, against
// 0.03 ms of bytes.  The design keeps every product on the tensor cores
// and every intermediate on chip:
//   * a block of two warpgroups owns 128 query rows, 64 each; a slice's
//     query tiles are issued heaviest first, slice after slice, so the
//     blocks in flight share one or two slices' K and V in L2;
//   * Q and the 64-key K / V tiles are staged as bf16 by cp.async in
//     wgmma's interleaved layout (whole 128-byte core matrices: no bank
//     conflicts), K and V in a ring of four buffers copied two tiles
//     ahead, each thread's 16-byte copies planned once (FwTilePlan: an
//     add, a compare and the copy each).  Rows of a head width that is
//     not a multiple of 8 (d = 100: 200-byte rows) take 4-byte copies,
//     odd widths plain loads; d is padded to DP (32, 64, 128) in shared
//     memory only;
//   * S = Q K^T by wgmma (m64n64k16, both operands from shared memory)
//     into f32 registers; the online softmax runs on the accumulator
//     (scale folded into exp2, a row's max over the four lanes of a quad
//     by two xor shuffles; the mask only on tiles that cross sk or the
//     diagonal, O rescaled only when a row's max moved): on an H100 this
//     kernel is bound by the CUDA cores' instruction issue more than by
//     the tensor cores, so every instruction per score counts;
//   * P V by wgmma with P as the register operand, taken from the S
//     accumulator as it stands, and V read N-major from shared memory.
//     FlashAttention-3's pipeline within a warpgroup: tile j's S product
//     is issued together with tile j - 1's P V, and tile j's softmax runs
//     while that P V is in flight;
//   * P is split into hi + lo bf16 (hi = bf16(p), lo = bf16(p - hi)) and
//     both halves are multiplied by V: P keeps ~16 bits, not bf16's 8, so
//     out stays within one bf16 step of the plain version's f32 P element
//     by element, at 1.5x the tensor-core work of a bf16 P (a bf16 P puts
//     the output ~2^-9 of the summed |p v| off, several floors past the
//     bound where the output cancels to near zero);
//   * a warpgroup skips a key tile that lies wholly above its rows'
//     causal diagonal; key tiles past sk or the block's diagonal are never
//     visited; a row with nothing live yet keeps a finite reference point
//     (the m_use guard);
//   * nothing makes ptxas serialize the wgmmas (its C7520 notice): no
//     call in the function (the epilogue divides with __fdividef) and no
//     fence in a path it cannot prove warp-uniform (the warpgroup index is
//     read through __shfl_sync).
// Scale: the TPU kernel scales q in f32 before the dot; here q stays bf16
// and the f32 score is scaled, which differs only by f32 rounding (and
// not at all at d = 64, where scale = 1/8).

#include "flash_attn.cuh"
#include "flash_mma.cuh"

template <int DPAD>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;                    // DPAD x FA_LD each
  float* Kt = Qt + DPAD * FA_LD;
  float* Vt = Kt + DPAD * FA_LD;
  float* P = Vt + DPAD * FA_LD;        // FA_TILE x FA_LD, row-major
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const long long bh = blockIdx.y;
  const float* qb = q + bh * sq * d;
  const float* kb = k + bh * sk * d;
  const float* vb = v + bh * sk * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  fa_stage<DPAD>(Qt, qb, q0, sq, d, scale);
  float m[4], l[4], o[4][DPAD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) o[i][c] = 0.f;
  }
  const int kend = causal ? min(sk, q0 + FA_TILE) : sk;
  for (int k0 = 0; k0 < kend; k0 += FA_TILE) {
    __syncthreads();                   // the last tile's readers are done
    fa_stage<DPAD>(Kt, kb, k0, sk, d, 1.f);
    fa_stage<DPAD>(Vt, vb, k0, sk, d, 1.f);
    __syncthreads();
    float s[4][4] = {};
    fa_qk<DPAD>(Qt, Kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!fa_live(row, k0 + tx + 16 * j, sq, sk, causal))
          s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], fa_row_max(mx));
      // a row with nothing live yet keeps a finite reference point
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_use);
        P[(ty + 16 * i) * FA_LD + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + fa_row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPAD / 16; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    fa_pv<DPAD>(P, Vt, ty, tx, o);
  }

  float* ob = out + bh * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DPAD / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[(long long)row * d + col] = o[i][c] / l_safe;
    }
    if (tx == 0) lse[bh * sq + row] = m[i] + logf(l_safe);
  }
}

template <int DPAD>
static int launch_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int bh, int sq, int sk, int d, int causal,
                      float scale, void* stream) {
  const size_t smem = (size_t)(3 * DPAD + FA_TILE) * FA_LD * sizeof(float);
  return fw_launch<FA_THREADS>(
      flash_fwd_kernel<DPAD>, dim3((sq + FA_TILE - 1) / FA_TILE, bh), smem,
      stream, (const float*)q, (const float*)k, (const float*)v,
      (float*)out, (float*)lse, sq, sk, d, causal, scale);
}

static int dispatch_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int bh, int sq, int sk, int d,
                        int causal, float scale, void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_fwd<32>(q, k, v, out, lse, bh, sq, sk, d, causal,
                          scale, stream);
  if (d <= 64)
    return launch_fwd<64>(q, k, v, out, lse, bh, sq, sk, d, causal,
                          scale, stream);
  return launch_fwd<128>(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
                         stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int sq, int sk,
                             int d, int causal, float scale, void* stream) {
  return dispatch_fwd(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
                      stream);
}


// ---- bf16: tensor cores ------------------------------------------------------

constexpr int FW_KT = 64;              // keys per staged K / V tile
constexpr int FW_GROUPS = 2;           // warpgroups per block, 64 rows each
constexpr int FW_BM = 64 * FW_GROUPS;  // query rows per block
constexpr int FW_THREADS = 128 * FW_GROUPS;
constexpr int FW_STAGES = 4;           // K / V tile buffers

// The online softmax of one 64 x 64 score tile on its accumulator:
// mask it (EDGE: a tile that crosses sk or the causal diagonal; a
// separate instantiation, so that inner tiles carry no mask code),
// update each row's running max m (raw scores) and denominator share l,
// and turn s into the weights p = 2^(scale log2(e) (s - m)) (one FFMA and
// one exp2 each).  Returns, in corr, the factor that rescales what O
// holds so far.
template <bool EDGE, int NS>
__device__ __forceinline__ void fw_softmax(float (&s)[NS], float (&m)[2],
                                           float (&l)[2], float (&corr)[2],
                                           int k0, int sk, int causal, int ra,
                                           int t, float scale_log2) {
  if constexpr (EDGE) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = ra + 8 * ((i >> 1) & 1);
      if (col >= sk || (causal && col > row)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float nms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    // a row with nothing live yet keeps a finite reference point
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = fw_exp2((m[h] - m_use) * scale_log2);
    nms[h] = -m_use * scale_log2;
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = fw_exp2(fmaf(s[i], scale_log2, nms[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
}

template <int DP, int VEC>
__global__ void __launch_bounds__(FW_THREADS, DP <= 64 ? 2 : 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int d,
                       int causal, float scale_log2) {
  constexpr int NS = FW_KT / 2;        // score accumulators per thread
  constexpr int ND = DP / 8;           // 8-column blocks of the output
  constexpr int QBYTES = FW_BM * DP * 2, TBYTES = FW_KT * DP * 2;
  extern __shared__ __align__(128) unsigned char fw_buf[];
  unsigned char* Qs = fw_buf;
  unsigned char* Ks = Qs + QBYTES;     // FW_STAGES buffers of TBYTES
  unsigned char* Vs = Ks + FW_STAGES * TBYTES;

  // blockIdx.x walks a slice's query tiles from the last (for causal the
  // heaviest first), blockIdx.y the slices: the blocks in flight share
  // one or two slices' K and V, which stay in L2
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FW_BM;
  const long long bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * sq * d;
  const __nv_bfloat16* kb = k + bh * sk * d;
  const __nv_bfloat16* vb = v + bh * sk * d;
  // this thread's warpgroup, read through a shuffle so that ptxas knows
  // it (and every branch on it) is uniform across the warp: a wgmma
  // fence in a path it cannot prove uniform serializes every wgmma
  const int grp = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + 64 * grp;    // the warpgroup's first query row
  const int ra = row_lo + 16 * ((threadIdx.x >> 5) & 3) + g;  // and + 8
  const int kend = causal ? min(sk, q0 + FW_BM) : sk;
  const int ntiles = (kend + FW_KT - 1) / FW_KT;
  // the warpgroup's live key tiles are 0 .. nlive - 1: a tile wholly
  // above its rows' causal diagonal is skipped (tiles and warpgroups
  // start at multiples of 64)
  const int nlive = causal ? min(ntiles, row_lo / FW_KT + 1) : ntiles;

  // K-major operands (Q, K): next 8 columns 128 bytes on, next 8 rows
  // DP * 16; N-major V: the other way round.  One k16 step of S is two
  // column blocks (256 bytes: + 16 in the descriptor); one 16-key step of
  // P V two row blocks (2 DP * 16 bytes).
  const uint64_t dq = fw_desc(fw_smem(Qs + grp * 64 * DP * 2), 128, DP * 16);

  float o[DP / 2], s[NS], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t hi[NS / 8][4], lo[NS / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  // Tile `it` is copied two tiles ahead into buffer it % 4, one copy
  // group a tile.  A live tile's S product is issued together with the
  // P V product of the tile before, and its softmax runs while that P V
  // is in flight.  Buffer (it + 2) % 4 last held tile it - 2, whose P V
  // finished in iteration it - 1, before this iteration's barrier.
  const FwTilePlan<DP, FW_THREADS> plan(d);
  const uint32_t ks_addr = fw_smem(Ks), vs_addr = fw_smem(Vs);
  // tile j of K and V into buffer j % 4
  auto stage_kv = [&](int j) {
    const int nb = j % FW_STAGES;
    if constexpr (VEC == 8) {
      plan.copy(ks_addr + nb * TBYTES, kb, j * FW_KT, sk, d);
      plan.copy(vs_addr + nb * TBYTES, vb, j * FW_KT, sk, d);
    } else {
      fw_stage<FW_KT, DP, VEC, FW_THREADS>(Ks + nb * TBYTES, kb, j * FW_KT,
                                           sk, d);
      fw_stage<FW_KT, DP, VEC, FW_THREADS>(Vs + nb * TBYTES, vb, j * FW_KT,
                                           sk, d);
    }
  };
  if constexpr (VEC == 8) {           // Q's two 64-row halves
    plan.copy(fw_smem(Qs), qb, q0, sq, d);
    plan.copy(fw_smem(Qs) + 64 * DP * 2, qb, q0 + 64, sq, d);
  } else {
    fw_stage<FW_BM, DP, VEC, FW_THREADS>(Qs, qb, q0, sq, d);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < ntiles) stage_kv(j);
    fw_cp_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * FW_KT, buf = it % FW_STAGES;
    fw_cp_wait<1>();                   // tile it (and Q) has landed
    __syncthreads();
    if (it + 2 < ntiles) stage_kv(it + 2);
    fw_cp_commit();
    if (it >= nlive) continue;
    const uint64_t dk = fw_desc(fw_smem(Ks + buf * TBYTES), 128, DP * 16);
    const uint64_t dv_prev =
        fw_desc(fw_smem(Vs + (it + FW_STAGES - 1) % FW_STAGES * TBYTES),
                DP * 16, 128);
    fw_pin(s);
    fw_pin(o);
    fw_pin(hi);
    fw_pin(lo);
    fw_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      fw_mma_ss_n64(s, dq + kk * 16, dk + kk * 16, kk > 0);
    fw_commit();
    if (it > 0) {                      // O += P V of the tile before
#pragma unroll
      for (int kb2 = 0; kb2 < NS / 8; ++kb2) {
        fw_pv<DP>(o, hi[kb2], dv_prev + kb2 * 2 * DP);
        fw_pv<DP>(o, lo[kb2], dv_prev + kb2 * 2 * DP);
      }
      fw_commit();
      fw_wait<1>();                    // S has landed; P V may still run
    } else {
      fw_wait<0>();
    }
    fw_pin(s);
    float corr[2];
    if (k0 + FW_KT > sk || (causal && k0 + FW_KT - 1 > row_lo))
      fw_softmax<true>(s, m, l, corr, k0, sk, causal, ra, t, scale_log2);
    else
      fw_softmax<false>(s, m, l, corr, k0, sk, causal, ra, t, scale_log2);
    fw_wait<0>();
    fw_pin(o);
    fw_pin(hi);
    fw_pin(lo);
    if (corr[0] != 1.f || corr[1] != 1.f) {   // a row's max moved
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    }
    fw_split(s, hi, lo);
  }
  // the P V of the warpgroup's last live tile; no copy was issued into
  // its V buffer after it (only a causal block's last tile is skipped)
  {
    const uint64_t dv_last =
        fw_desc(fw_smem(Vs + (nlive - 1) % FW_STAGES * TBYTES), DP * 16, 128);
    fw_pin(o);
    fw_pin(hi);
    fw_pin(lo);
    fw_fence();
#pragma unroll
    for (int kb2 = 0; kb2 < NS / 8; ++kb2) {
      fw_pv<DP>(o, hi[kb2], dv_last + kb2 * 2 * DP);
      fw_pv<DP>(o, lo[kb2], dv_last + kb2 * 2 * DP);
    }
    fw_commit();
    fw_wait<0>();
    fw_pin(o);
  }

  // a row's denominator over the four lanes of its quad; out = O / l
  __nv_bfloat16* ob = out + bh * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = ra + 8 * h;
    if (row >= sq) continue;
    const float l_safe = lt == 0.f ? 1.f : lt;
    __nv_bfloat16* orow = ob + (long long)row * d;
    // __fdividef (2 ulp, l_safe in [1, 2^126)): IEEE division's slow-path
    // call would make ptxas serialize every wgmma of the kernel
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = 8 * nd + 2 * t;
      const float x = __fdividef(o[4 * nd + 2 * h], l_safe);
      const float y = __fdividef(o[4 * nd + 2 * h + 1], l_safe);
      if (VEC > 1 && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x, y);
      } else {
        if (col < d) orow[col] = __float2bfloat16(x);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(y);
      }
    }
    // lse = scale m + ln l, in the natural log as the f32 build
    if (t == 0)
      lse[bh * sq + row] = (m[h] * scale_log2 + log2f(l_safe)) * 0.69314718f;
  }
}

template <int DP, int VEC>
static int launch_fwd_wgmma(const void* q, const void* k, const void* v,
                            void* out, void* lse, int bh, int sq, int sk,
                            int d, int causal, float scale, void* stream) {
  const size_t smem = (size_t)(FW_BM + 2 * FW_STAGES * FW_KT) * DP * 2;
  auto kernel = flash_fwd_wgmma_kernel<DP, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((sq + FW_BM - 1) / FW_BM, bh), FW_THREADS, smem,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, sq, sk, d,
      causal, scale * 1.44269504f);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_fwd_wgmma_vec(const void* q, const void* k, const void* v,
                                void* out, void* lse, int bh, int sq, int sk,
                                int d, int causal, float scale,
                                void* stream) {
  // the widest copy every row start allows: 16 bytes, 4 bytes or plain
  uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                   (uintptr_t)out;
  if (d % 8 == 0 && addr % 16 == 0)
    return launch_fwd_wgmma<DP, 8>(q, k, v, out, lse, bh, sq, sk, d, causal,
                                   scale, stream);
  if (d % 2 == 0 && addr % 4 == 0)
    return launch_fwd_wgmma<DP, 2>(q, k, v, out, lse, bh, sq, sk, d, causal,
                                   scale, stream);
  return launch_fwd_wgmma<DP, 1>(q, k, v, out, lse, bh, sq, sk, d, causal,
                                 scale, stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int sq, int sk,
                              int d, int causal, float scale, void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_fwd_wgmma_vec<32>(q, k, v, out, lse, bh, sq, sk, d, causal,
                                    scale, stream);
  if (d <= 64)
    return launch_fwd_wgmma_vec<64>(q, k, v, out, lse, bh, sq, sk, d, causal,
                                    scale, stream);
  return launch_fwd_wgmma_vec<128>(q, k, v, out, lse, bh, sq, sk, d, causal,
                                   scale, stream);
}
