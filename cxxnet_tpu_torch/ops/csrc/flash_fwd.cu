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
// f32 build (flash_fwd_kernel; the pieces of flash_tf32.cuh that the f32
// dq and dk/dv kernels use).  What bounds it: the operations, 4 d flops
// per live pair (q.k, p.v): at the slice path's b1 h16 s8192 d64 causal
// 137 GFLOP, 0.28 ms at the dense TF32 rate of 495 TFLOP/s (2.05 ms at
// 67 TFLOP/s on the FMA pipes), against ~0.04 ms of bytes.  The kernel
// takes three TF32 products a term (the 3xTF32 split keeps f32
// accuracy), 0.83 ms at that rate.  Design (flash_dq.cu's f32 shape,
// without dO and dP):
//   * a block of eight warps owns 256 query rows (32 a warp, two 16-row
//     fragments) up to d = 64 and 128 at d = 128; query tiles are issued
//     heaviest first; Q is staged once and scaled there by 1 / sqrt(d)
//     BEFORE the dot, as the TPU kernel scales it; the 64-key K and V
//     tiles are double-buffered by cp.async (rows of d + 4 floats; the
//     next tile's copy runs under this tile's products), 16-byte copies
//     where d % 4 == 0, else 4-byte ones (32-key tiles in three buffers
//     were 10 % slower, tools/flash_bwd_variants.py f32_fwd_kt32);
//   * per key tile, S = Q K^T by mma.sync m16n8k8 on TF32 operands split
//     hi + lo in registers (three products a term) into a fresh f32
//     accumulator; a warp skips a key tile wholly above its diagonal;
//   * the online softmax runs on the accumulator: a row's max over the
//     four lanes of its quad by two xor shuffles, p = 2^(log2(e) (s -
//     m)) by one FFMA and ex2.approx, the mask only on tiles that cross
//     sk or the warp's diagonal, a row with nothing live yet keeping a
//     finite reference point (m_use), O rescaled only when a row's max
//     moved; each lane keeps its share of a row's denominator, summed
//     over the quad once at the end;
//   * O += P V with P as the A operand straight from its accumulator
//     (flash_tf32.cuh's relabelling) and V's fragments read at rows 2t,
//     2t + 1 of the staged tile; each key tile's products sum in a fresh
//     accumulator added to O in f32 after its rescale (tf_grad): the
//     tensor cores round a sum toward zero;
//   * out = O / l and lse = m + ln l, as the TPU kernel's finalize; no
//     atomics, so two launches give bitwise-equal outputs.
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

#include "flash_mma.cuh"
#include "flash_tf32.cuh"

// the f32 build's shape at head width DP: 16-row fragments a warp, keys
// per staged K / V tile, K / V buffers, query rows a block
template <int DP>
struct FwdTf {
  static constexpr int MT = DP <= 64 ? 2 : 1;
  static constexpr int KT = 64;
  static constexpr int STAGES = 2;
  static constexpr int BM = 16 * MT * TF_WARPS;
  static constexpr size_t SMEM =
      (size_t)(BM + 2 * STAGES * KT) * (DP + 4) * sizeof(float);
};

template <int DP, int VEC>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, int causal,
                 float scale) {
  constexpr int MT = FwdTf<DP>::MT, NST = FwdTf<DP>::STAGES;
  constexpr int BM = FwdTf<DP>::BM, KT = FwdTf<DP>::KT, LD = DP + 4;
  constexpr int NK = KT / 8, ND = DP / 8;
  constexpr float LOG2E = 1.44269504f;
  extern __shared__ __align__(16) float tf_buf[];
  float* Qs = tf_buf;                  // BM x LD
  float* Ks = Qs + BM * LD;            // NST buffers of KT x LD each
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

  // the running max (of scaled scores) and this lane's share of the
  // denominator of its rows (fragment m, + 8 h), and O
  float mx[MT][2], l[MT][2], o[MT][ND][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[m][h] = -INFINITY;
      l[m][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][n][e] = 0.f;
  }

  // Q with tile 0 (copy group 0), tiles 1 .. NST - 2 after
  tf_stage<BM, DP, VEC>(Qs, q + bh * sq * d, q0, sq, d);
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
    if (it == 0) {                     // Q has landed: q * scale, once
      for (int i = threadIdx.x; i < BM * DP; i += TF_THREADS)
        Qs[(i / DP) * LD + i % DP] *= scale;
      __syncthreads();
    }
    if (causal && k0 > row_hi) continue;   // wholly above the diagonal
    const float* Kt = Ks + buf * KT * LD;
    const float* Vt = Vs + buf * KT * LD;

    // S = Q K^T, 8 columns of d a step
    float s[MT][NK][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][n][e] = 0.f;
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
    // the online softmax on the accumulator; the mask only on a tile
    // that crosses sk or the warp's diagonal
    if (k0 + KT > sk || (causal && k0 + KT - 1 > row_lo)) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_lo + 16 * m + 8 * (e >> 1) + g;
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= sk || (causal && col > row)) s[m][n][e] = -INFINITY;
          }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float tmax[2] = {-INFINITY, -INFINITY}, corr[2], nms[2];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s[m][n][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
        const float m_new = fmaxf(mx[m][h], tmax[h]);
        // a row with nothing live yet keeps a finite reference point
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        corr[h] = fw_exp2((mx[m][h] - m_use) * LOG2E);
        nms[h] = -m_use * LOG2E;
        mx[m][h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[m][n][e] = fw_exp2(fmaf(s[m][n][e], LOG2E, nms[e >> 1]));
          sum[e >> 1] += s[m][n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[m][h] = l[m][h] * corr[h] + sum[h];
      if (corr[0] != 1.f || corr[1] != 1.f) {   // a row's max moved
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[m][n][e] *= corr[e >> 1];
      }
    }
    tf_grad<LD>(o, s, Vt, t, g);       // O += P V
  }
  tf_cp_wait<0>();                     // no copy outlives the block

  // a row's denominator over the four lanes of its quad; out = O / l,
  // lse = m + ln l
  float* ob = out + bh * sq * d;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float lsum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[m][h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float l_safe = lt == 0.f ? 1.f : lt;
      lsum[h] = l_safe;
      const int row = row_lo + 16 * m + 8 * h + g;
      if (t == 0 && row < sq) lse[bh * sq + row] = mx[m][h] + logf(l_safe);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][n][e] /= lsum[e >> 1];
    tf_store<ND, VEC>(ob, o[m], 1.f, row_lo + 16 * m + g, sq, d, t);
  }
}

template <int DP, int VEC>
static int launch_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int bh, int sq, int sk, int d, int causal,
                      float scale, void* stream) {
  constexpr int BM = FwdTf<DP>::BM;
  return fw_launch<TF_THREADS>(
      flash_fwd_kernel<DP, VEC>, dim3((sq + BM - 1) / BM, bh),
      FwdTf<DP>::SMEM, stream, (const float*)q, (const float*)k,
      (const float*)v, (float*)out, (float*)lse, sq, sk, d, causal, scale);
}

template <int DP>
static int launch_fwd_vec(const void* q, const void* k, const void* v,
                          void* out, void* lse, int bh, int sq, int sk,
                          int d, int causal, float scale, void* stream) {
  // 16-byte copies (and float2 stores) where every row start allows
  // them, else 4-byte ones
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)out;
  if (d % 4 == 0 && addr % 16 == 0)
    return launch_fwd<DP, 4>(q, k, v, out, lse, bh, sq, sk, d, causal,
                             scale, stream);
  return launch_fwd<DP, 1>(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
                           stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int sq, int sk,
                             int d, int causal, float scale, void* stream) {
  if (d <= 0 || d > 128 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (d <= 32)
    return launch_fwd_vec<32>(q, k, v, out, lse, bh, sq, sk, d, causal,
                              scale, stream);
  if (d <= 64)
    return launch_fwd_vec<64>(q, k, v, out, lse, bh, sq, sk, d, causal,
                              scale, stream);
  return launch_fwd_vec<128>(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
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
