// The bf16 and f16 builds of the fullc backward's input gradient, on
// wgmma, for Hopper (sm_90a): one body over the 16-bit element type, two
// entries (fullc_gemm_nt_bf16, fullc_gemm_nt_f16).  Replaces, at
// compute_type=bfloat16 and =float16, the Pallas `_matmul_nt_kernel` /
// `_matmul_nt_impl` of cxxnet_tpu/ops/pallas_kernels.py:433,480 (the
// `da = g @ b^T` half of `_matmul_vjp_bwd` :419); fullc_gemm_nt.cu holds
// the f32 build.
//
// What it computes: c (m, k) = g (m, n) @ b (k, n)^T, g, b and c of one
// 16-bit type, row-major: g the upstream gradient of the fullc output, b
// the weight in its stored (nin, nhidden) layout, c the gradient of the
// fullc input.  f32 sums, each output rounded to the 16-bit type once, as
// the Pallas kernel's f32 scratch accumulator and final astype.  A product
// of two bf16 or two f16 values is exact in f32, so only the order of the
// sums differs from JAX's.
//
// What bounds it on an H100: the bytes, by a little.  fc6 at batch 256
// (256 x 4096 -> 9216) does 19.3 GFLOP on 82 MB, 0.020 ms at the dense
// bf16 / f16 rate of 989 TFLOP/s and 0.025 ms at 3.35 TB/s; fc7 and fc8
// the same split at 0.011 and 0.003 ms of bytes.
//
// Design (gemm_wgmma.cuh):
//   * a block of two warpgroups owns a 128 x BN tile of c, BN 128 or 144
//     (nb_plan): warpgroup w its rows 64 w .. 64 w + 63, one m64nBNk16
//     wgmma a k16 step, both operands from shared memory, f32
//     accumulators in registers (BN / 2 a thread).  A 64-deep slice of
//     the contraction moves (128 + BN) * 128 bytes from L2 for 128 BN 64
//     products;
//   * both operands are contraction-major, wgmma's native K-major layout:
//     a slice is g's 128 rows and b's BN rows, 64 wide (128 bytes), staged
//     as they lie into the 128-byte swizzle layout by 16-byte cp.async
//     copies, a warp copying whole lines (zero-filled past m, k and the
//     range's end by the copy itself), in a five-stage ring (170 KB at BN
//     144).  Each iteration copies the slice three ahead, multiplies the
//     current one and waits for the wgmma group before it, so one group
//     stays in flight.  Where n is not a multiple of 8 or an operand is
//     not 16-byte aligned the slices are staged by 2-byte loads and
//     stores into the same layout;
//   * a deterministic split of the contraction fills the card where the
//     tiles do not (fc7, fc8, GoogLeNet's m = 128): the S <= 8 ranges of
//     one tile form a thread block cluster.  After a cluster barrier (the
//     rings are free) each block pushes its f32 partial, row by row, into
//     the ring of the rank that owns the row (rank r owns rows [r 128 /
//     S, (r + 1) 128 / S)), through distributed shared memory, into slot
//     s; after a second barrier each block sums its slots in rank order,
//     rounds once and writes its rows.  One launch, no workspace, no
//     atomics: two launches on the same inputs are bitwise equal;
//   * nb_plan picks BN and S for a shape on the card it runs on, once a
//     shape, type and device: the fewest waves of clusters the card holds at
//     once (cudaOccupancyMaxActiveClusters) times the slices a range plus
//     a block's fill, epilogue and reduction, times the bytes a slice
//     moves.  At AlexNet's batch 256 that is fc6 on 128 x 144 unsplit
//     (128 tiles, one wave), fc7 and fc8 on 128 x 128 in two ranges (128
//     blocks);
//   * the epilogue stages the tile as f32 rows in shared memory (S = 1:
//     the block's own slot 0) and writes 8 outputs, 16 bytes, a lane: a
//     warp stores whole rows.
//
// tests/test_torch_gemm_bwd_bf16_design.py models the staging, the
// descriptors, the split and the summation order on the CPU.

#include <cooperative_groups.h>

#include <array>
#include <map>
#include <mutex>

#include "gemm_wgmma.cuh"

namespace cg = cooperative_groups;

constexpr int NB_BM = 128;                // output rows a block (the batch)
constexpr int NB_BK = 64;                 // contraction (n) a slice: a row
constexpr int NB_STAGES = 5;              // the ring
constexpr int NB_AHEAD = NB_STAGES - 2;   // slices copied ahead
constexpr int NB_THREADS = 256;           // two warpgroups
constexpr int NB_MAX_SPLITS = 8;          // the portable cluster size
constexpr int NB_A_BYTES = NB_BM * NB_BK * 2;
// the plan's cost model, in slices: a block's fill and epilogue, and the
// reduction's barriers and pushes (fitted to tools/sgemm_variants.py's
// nb_s* variants on an H100)
constexpr int NB_FIXED = 8, NB_REDUCE = 5;

// The layout of a block of BN output columns (k)
template <int BN>
struct NbTile {
  static constexpr int STAGE = (NB_BM + BN) * NB_BK * 2;   // bytes
  static constexpr size_t RING = (size_t)NB_STAGES * STAGE;
  static constexpr size_t SMEM = RING + 1024;   // + the 1024-byte alignment
  static constexpr int LD = BN + 8;   // floats a row of a pushed partial
  static_assert((size_t)(NB_BM + NB_MAX_SPLITS) * LD * 4 <= RING,
                "the pushed partials fit in the ring");
};

static inline int nb_ceil(long long x, long long y) {
  return (int)((x + y - 1) / y);
}

// One (output tile, contraction range) block: grid (S, m tiles, k tiles),
// clusters of (S, 1, 1); range s covers slices [s per, (s + 1) per).
// vec_c: k a multiple of 8 and c 16-byte aligned (16-byte stores).  E:
// the 16-bit element type (gw_bf16 or gw_f16).
template <int BN, bool VEC, class E>
__global__ void __launch_bounds__(NB_THREADS, 1)
fullc_gemm_nt_bf16_kernel(const E* __restrict__ g,
                          const E* __restrict__ b,
                          E* __restrict__ c, int m, int n, int k,
                          int per, int vec_c) {
  using T = NbTile<BN>;
  extern __shared__ __align__(1024) unsigned char nb_raw[];
  unsigned char* nb_smem = gw_align1024(nb_raw);
  const int S = gridDim.x, s = blockIdx.x;   // the cluster's size, rank
  const int m0 = blockIdx.y * NB_BM, k0 = blockIdx.z * BN;
  const int nbeg = s * per * NB_BK;
  const int nend = min(n, nbeg + per * NB_BK);
  const int nk = nend > nbeg ? (nend - nbeg + NB_BK - 1) / NB_BK : 0;
  // the warpgroup, through a shuffle so that ptxas knows it is uniform
  // across the warp (a wgmma fence it cannot prove uniform serializes)
  const int grp = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // slice j of the range into buffer j % NB_STAGES
  auto stage = [&](int j) {
    unsigned char* st = nb_smem + (j % NB_STAGES) * T::STAGE;
    const int n0 = nbeg + j * NB_BK;
    gw_stage<NB_BM, NB_BK, NB_THREADS, VEC>(st, g, n, m0, m, n0, nend);
    gw_stage<BN, NB_BK, NB_THREADS, VEC>(st + NB_A_BYTES, b, n, k0, k, n0,
                                         nend);
  };
#pragma unroll
  for (int j = 0; j < NB_AHEAD; ++j) {
    if (j < nk) stage(j);
    fw_cp_commit();
  }
  const uint32_t ring = fw_smem(nb_smem);
  for (int j = 0; j < nk; ++j) {
    fw_cp_wait<NB_AHEAD - 1>();   // slice j landed (this thread's copies)
    __syncthreads();              // everyone's; slice j - 2's products done
    if (j + NB_AHEAD < nk) stage(j + NB_AHEAD);
    fw_cp_commit();
    // K-major, the warpgroup's 64 rows of g 64 * 128 bytes along
    const uint32_t sa = ring + (j % NB_STAGES) * T::STAGE;
    const uint64_t da = gw_desc_k(sa + grp * 64 * NB_BK * 2);
    const uint64_t db = gw_desc_k(sa + NB_A_BYTES);
    fw_pin(acc);
    fw_fence();
#pragma unroll
    for (int kk = 0; kk < NB_BK / 16; ++kk)
      gw_mma<BN, 0, 0, E>(acc, da + kk * GW_KSTEP_K, db + kk * GW_KSTEP_K, 1);
    fw_commit();
    fw_wait<1>();
  }
  fw_wait<0>();
  fw_pin(acc);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // none outlives

  // every block of the tile is done with its ring: it receives the rows
  // it owns, slot z from rank z
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1)
    cluster.sync();
  else
    __syncthreads();
  float* recv = reinterpret_cast<float*>(nb_smem);
  const int slot = (NB_BM + S - 1) / S * T::LD;    // floats a sender's slot
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * grp + 16 * warp + (lane >> 2) + 8 * h;
    const int r = ((row + 1) * S - 1) / NB_BM;     // its owner
    float* dst = (S > 1 ? cluster.map_shared_rank(recv, r) : recv) +
                 s * slot + (row - r * NB_BM / S) * T::LD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  if (S > 1)    // every push has landed; no block reads another's after
    cluster.sync();
  else
    __syncthreads();

  // this block's rows: the S partials in rank order, rounded once
  const int rb = s * NB_BM / S, nr = (s + 1) * NB_BM / S - rb;
  for (int i = threadIdx.x; i < nr * (BN / 8); i += NB_THREADS) {
    const int lr = i / (BN / 8), cc = 8 * (i % (BN / 8));
    const int row = m0 + rb + lr, col = k0 + cc;
    if (row >= m || col >= k) continue;
    const float* p = recv + lr * T::LD + cc;
    float v[8];
    const float4 x0 = *reinterpret_cast<const float4*>(p);
    const float4 x1 = *reinterpret_cast<const float4*>(p + 4);
    v[0] = x0.x, v[1] = x0.y, v[2] = x0.z, v[3] = x0.w;
    v[4] = x1.x, v[5] = x1.y, v[6] = x1.z, v[7] = x1.w;
    for (int z = 1; z < S; ++z) {
      const float4 y0 = *reinterpret_cast<const float4*>(p + z * slot);
      const float4 y1 = *reinterpret_cast<const float4*>(p + z * slot + 4);
      v[0] += y0.x, v[1] += y0.y, v[2] += y0.z, v[3] += y0.w;
      v[4] += y1.x, v[5] += y1.y, v[6] += y1.z, v[7] += y1.w;
    }
    E* dst = c + (long long)row * k + col;
    if (vec_c)
      gw_put8<true>(dst, v, 8);
    else
      gw_put8<false>(dst, v, k - col);
  }
}

// A launch configuration of the (BN, VEC, E) kernel with clusters of S
// blocks, its shared memory opted in (once a device)
template <int BN, bool VEC, class E>
static cudaError_t nb_config(cudaLaunchConfig_t& cfg,
                             cudaLaunchAttribute (&attr)[1], dim3 grid,
                             int S, cudaStream_t st) {
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NB_THREADS, 1, 1);
  cfg.dynamicSmemBytes = NbTile<BN>::SMEM;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return gw_opt_in<fullc_gemm_nt_bf16_kernel<BN, VEC, E>>(NbTile<BN>::SMEM);
}

// The blocks the card runs at once in clusters of S of the (BN, E) kernel
// (S = 1: blocks); -1 where it cannot run them
template <int BN, class E>
static long long nb_slots(int S) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  if (nb_config<BN, true, E>(cfg, attr, dim3(S, 1, 1), S, 0) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveClusters(&clusters,
                                     fullc_gemm_nt_bf16_kernel<BN, true, E>,
                                     &cfg) == cudaSuccess && clusters > 0)
    return (long long)clusters * S;
  return -1;
}

struct NbPlan {
  int bn, splits;
};

// The tile width (128 or 144 columns of k) and the contraction ranges
// (the cluster size S <= 8) for g (m, n) @ b (k, n)^T on the current
// device: the pair that minimizes ceil(tiles S / slots) * (ceil(slices /
// S) + NB_FIXED + NB_REDUCE [S > 1]) * (NB_BM + BN), the slices a block
// runs and what each moves; the narrower tile and the fewer ranges on a
// tie.  An S whose last range would be empty is the same as a smaller one
// and is skipped.
template <class E>
static NbPlan nb_plan(int m, int n, int k) {
  NbPlan best = {128, 1};
  const int slices = nb_ceil(n, NB_BK);
  long long best_cost = -1;
  for (int bn : {128, 144}) {
    const long long tiles = (long long)nb_ceil(m, NB_BM) * nb_ceil(k, bn);
    for (int S = 1; S <= NB_MAX_SPLITS && S <= slices; ++S) {
      const int per = nb_ceil(slices, S);
      if (nb_ceil(slices, per) != S) continue;
      const long long slots =
          bn == 128 ? nb_slots<128, E>(S) : nb_slots<144, E>(S);
      if (slots <= 0) continue;
      const long long cost = (tiles * S + slots - 1) / slots *
                             (per + NB_FIXED + (S > 1 ? NB_REDUCE : 0)) *
                             (NB_BM + bn);
      if (best_cost < 0 || cost < best_cost) {
        best = {bn, S};
        best_cost = cost;
      }
    }
  }
  return best;
}

// nb_plan for a shape of E on the current device, searched once a shape,
// type and device (the search's occupancy queries cost more host time
// than fc8's products); {128, 1} for an empty product
template <class E>
static NbPlan nb_cached_plan(int m, int n, int k) {
  int dev = 0;
  if (m <= 0 || n <= 0 || k <= 0 || cudaGetDevice(&dev) != cudaSuccess)
    return {128, 1};
  static std::mutex lock;
  static std::map<std::array<int, 4>, NbPlan> plans;
  std::lock_guard<std::mutex> hold(lock);
  const std::array<int, 4> key = {dev, m, n, k};
  auto it = plans.find(key);
  if (it == plans.end())
    it = plans.emplace(key, nb_plan<E>(m, n, k)).first;
  return it->second;
}

// The plan's number of contraction ranges
extern "C" int fullc_gemm_nt_bf16_splits(int m, int n, int k) {
  return nb_cached_plan<gw_bf16>(m, n, k).splits;
}

extern "C" int fullc_gemm_nt_f16_splits(int m, int n, int k) {
  return nb_cached_plan<gw_f16>(m, n, k).splits;
}

template <int BN, bool VEC, class E>
static cudaError_t nb_launch(int S, cudaStream_t st, const E* g,
                             const E* b, E* c, int m, int n,
                             int k, int per, int vec_c) {
  const dim3 grid((unsigned)S, (unsigned)nb_ceil(m, NB_BM),
                  (unsigned)nb_ceil(k, BN));
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = nb_config<BN, VEC, E>(cfg, attr, grid, S, st);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, fullc_gemm_nt_bf16_kernel<BN, VEC, E>, g, b,
                         c, m, n, k, per, vec_c);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// c = g @ b^T in E, f32 sums, one rounding, on the plan's tile.
// `splits` is the plan's for the shape and type (anything else is
// refused); the ranges sum inside their cluster, so the entries take no
// workspace.
template <class E>
static int nb_gemm(const void* g, const void* b, void* c, int m, int n,
                   int k, int splits, void* stream) {
  if (m <= 0 || k <= 0) return 0;
  const NbPlan plan = nb_cached_plan<E>(m, n, k);
  if (splits != plan.splits) return (int)cudaErrorInvalidValue;
  const int per = nb_ceil(nb_ceil(n > 0 ? n : 1, NB_BK), splits);
  const bool vec = n % 8 == 0 && (((uintptr_t)g | (uintptr_t)b) % 16) == 0;
  const int vec_c = k % 8 == 0 && ((uintptr_t)c % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const E *G = (const E*)g, *B = (const E*)b;
  E* C = (E*)c;
  cudaError_t e;
  if (plan.bn == 144)
    e = vec ? nb_launch<144, true>(splits, st, G, B, C, m, n, k, per, vec_c)
            : nb_launch<144, false>(splits, st, G, B, C, m, n, k, per, vec_c);
  else
    e = vec ? nb_launch<128, true>(splits, st, G, B, C, m, n, k, per, vec_c)
            : nb_launch<128, false>(splits, st, G, B, C, m, n, k, per, vec_c);
  return (int)e;
}

// the bf16 build: c = g @ b^T, all bf16; `ws` is not used (it may be null)
extern "C" int fullc_gemm_nt_bf16(const void* g, const void* b, void* c,
                                  void* ws, int m, int n, int k, int splits,
                                  void* stream) {
  (void)ws;
  return nb_gemm<gw_bf16>(g, b, c, m, n, k, splits, stream);
}

// the f16 build: c = g @ b^T, all f16; `ws` is not used (it may be null)
extern "C" int fullc_gemm_nt_f16(const void* g, const void* b, void* c,
                                 void* ws, int m, int n, int k, int splits,
                                 void* stream) {
  (void)ws;
  return nb_gemm<gw_f16>(g, b, c, m, n, k, splits, stream);
}
