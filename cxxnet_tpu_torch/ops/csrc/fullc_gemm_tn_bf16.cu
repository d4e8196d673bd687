// The bf16 and f16 builds of the fullc backward's weight gradient, on
// wgmma, for Hopper (sm_90a): one body over the 16-bit element type, two
// entries (fullc_gemm_tn_bf16, fullc_gemm_tn_f16).  Replaces, at
// compute_type=bfloat16 and =float16, the Pallas `_matmul_tn_kernel` /
// `_matmul_tn_impl` of cxxnet_tpu/ops/pallas_kernels.py:449,506 (the
// `db = a^T @ g` half of `_matmul_vjp_bwd` :419); fullc_gemm_tn.cu holds
// the f32 build.
//
// What it computes: c (k, n) = a (m, k)^T @ g (m, n), a, g and c of one
// 16-bit type, row-major: a the fullc input, g the upstream gradient of
// its output, c the gradient of the weight in its stored (nin, nhidden)
// layout, which the caller widens into the f32 weight's gradient as JAX's
// .astype chain does.  f32 sums, each output rounded to the 16-bit type
// once (in f16, a gradient below 2^-24 in magnitude rounds to zero there,
// as JAX's does).
//
// What bounds it on an H100: the output.  fc6's weight gradient at batch
// 256 (9216 x 4096, contracting 256) does 19.3 GFLOP, 0.020 ms at the
// dense bf16 / f16 rate, against 80 MB of bytes, 75.5 MB of them the
// 16-bit dW written once: 0.024 ms at 3.35 TB/s.
//
// Design (gemm_wgmma.cuh):
//   * a persistent grid, one block of two warpgroups an SM, walks the
//     128 x 256 output tiles (tile blockIdx.x, then + gridDim.x, ...).
//     Warpgroup w owns the tile's rows 64 w .. 64 w + 63: one m64n256k16
//     wgmma a k16 step, 128 f32 accumulators a thread.  A 128 x 256 tile
//     moves 6 bytes of operands from L2 for each output (128 x 128: 8);
//   * both operands contract over their leading (batch) axis, so a slice
//     is 32 batch rows of a's 128 columns and of g's 256, staged as they
//     lie (MN-major) into the 128-byte swizzle layout and read through
//     wgmma's transpose bits.  16-byte cp.async copies, zero-filled past
//     m, k and n by the copy itself, where k and n are multiples of 8 and
//     a and g 16-byte aligned, 2-byte loads and stores otherwise;
//   * the block's slices run as one stream across its tiles through a
//     six-stage ring (144 KB): each iteration copies the slice four
//     ahead, which at a tile's end is the next tile's, so the next tile's
//     loads run under this tile's last products and epilogue; one wgmma
//     group stays in flight within a tile;
//   * the epilogue rounds the tile to 16 bits into a staging tile of its own
//     (66 KB, rows padded by 16 bytes: the fragment writes and the row
//     reads are free of bank conflicts) and writes it 16 bytes a lane, a
//     warp a whole 512-byte row.  No split and no atomics: each tile is
//     written once, and two launches are bitwise equal.
//
// What holds it back (tools/sgemm_variants.py): the products alone take
// fc6 0.018 ms of its 0.068; each tile's epilogue runs with the tensor
// cores idle, and the copies share the memory system with the 75.5 MB of
// stores.  Storing a tile under the next one's products ran no faster,
// by the threads or by the bulk-copy engine (0.075); so did g kept in
// shared memory across a run's tiles (2.5x fewer L2 bytes, but room for
// only two slices in flight: 0.073).
//
// tests/test_torch_gemm_bwd_bf16_design.py models the staging, the
// transposed descriptors, the tile walk and the summation order on the
// CPU.

#include "gemm_wgmma.cuh"

constexpr int TB_BM = 128;                 // output rows a tile (k)
constexpr int TB_BN = 256;                 // output columns a tile (n)
constexpr int TB_BK = 32;                  // batch rows a staged slice
constexpr int TB_STAGES = 6;               // the ring
constexpr int TB_AHEAD = TB_STAGES - 2;    // slices copied ahead
constexpr int TB_THREADS = 256;            // two warpgroups
constexpr int TB_A_BYTES = TB_BK * TB_BM * 2;
constexpr int TB_STAGE_BYTES = TB_BK * (TB_BM + TB_BN) * 2;
constexpr int TB_LDC = TB_BN + 8;          // elements a staged output row
constexpr size_t TB_RING = (size_t)TB_STAGES * TB_STAGE_BYTES;
// the ring, the staged output tile, the 1024-byte alignment
constexpr size_t TB_SMEM = TB_RING + (size_t)TB_BM * TB_LDC * 2 + 1024;

static_assert(TB_SMEM <= 232448, "one block's shared memory");

// The block's tiles of c (grid: at most one block an SM).  vec_c: n a
// multiple of 8 and c 16-byte aligned (16-byte stores).  E: the 16-bit
// element type (gw_bf16 or gw_f16).
template <bool VEC, class E>
__global__ void __launch_bounds__(TB_THREADS, 1)
fullc_gemm_tn_bf16_kernel(const E* __restrict__ a,
                          const E* __restrict__ g,
                          E* __restrict__ c, int m, int n, int k,
                          int vec_c) {
  extern __shared__ __align__(1024) unsigned char tb_raw[];
  unsigned char* tb_smem = gw_align1024(tb_raw);
  E* cs = reinterpret_cast<E*>(tb_smem + TB_RING);
  const int tiles_n = (n + TB_BN - 1) / TB_BN;
  const int tiles = (k + TB_BM - 1) / TB_BM * tiles_n;
  const int nk = m > 0 ? (m + TB_BK - 1) / TB_BK : 1;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * nk;           // the block's slices, in order
  const int grp = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  // the block's slice q: slice q % nk of its tile q / nk, into buffer
  // q % TB_STAGES
  auto stage = [&](int q) {
    const int tile = blockIdx.x + q / nk * gridDim.x, mb = q % nk * TB_BK;
    const int k0 = tile / tiles_n * TB_BM, n0 = tile % tiles_n * TB_BN;
    unsigned char* st = tb_smem + (q % TB_STAGES) * TB_STAGE_BYTES;
    gw_stage<TB_BK, TB_BM, TB_THREADS, VEC>(st, a, k, mb, m, k0, k);
    gw_stage<TB_BK, TB_BN, TB_THREADS, VEC>(st + TB_A_BYTES, g, n, mb, m, n0,
                                            n);
  };
#pragma unroll
  for (int q = 0; q < TB_AHEAD; ++q) {
    if (q < total) stage(q);
    fw_cp_commit();
  }

  // the staged tile at (k0, n0) into c, 16 bytes a lane, a warp a row
  auto store = [&](int k0, int n0) {
#pragma unroll 4
    for (int e = threadIdx.x; e < TB_BM * TB_BN / 8; e += TB_THREADS) {
      const int r = e / (TB_BN / 8), cc = 8 * (e % (TB_BN / 8));
      const int row = k0 + r, col = n0 + cc;
      if (row >= k || col >= n) continue;
      const E* src = cs + r * TB_LDC + cc;
      E* dst = c + (long long)row * n + col;
      if (vec_c) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int x = 0; x < 8 && col + x < n; ++x) dst[x] = src[x];
      }
    }
  };

  float acc[TB_BN / 2];
#pragma unroll
  for (int i = 0; i < TB_BN / 2; ++i) acc[i] = 0.f;
  const uint32_t ring = fw_smem(tb_smem);
  int q = 0;
  for (int it = 0; it < mine; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    const int k0 = tile / tiles_n * TB_BM, n0 = tile % tiles_n * TB_BN;
    for (int j = 0; j < nk; ++j, ++q) {
      fw_cp_wait<TB_AHEAD - 1>();  // slice q landed (this thread's copies)
      __syncthreads();             // everyone's; slice q - 2's products done
      if (q + TB_AHEAD < total) stage(q + TB_AHEAD);
      fw_cp_commit();
      // MN-major, read transposed; the warpgroup's 64 rows of c are the
      // next 64 columns of a's slice
      const uint32_t sa = ring + (q % TB_STAGES) * TB_STAGE_BYTES;
      const uint64_t da = gw_desc_mn<TB_BK>(sa + grp * TB_BK * 128);
      const uint64_t db = gw_desc_mn<TB_BK>(sa + TB_A_BYTES);
      fw_pin(acc);
      fw_fence();
#pragma unroll
      for (int kk = 0; kk < TB_BK / 16; ++kk)
        gw_mma<TB_BN, 1, 1, E>(acc, da + kk * GW_KSTEP_MN,
                            db + kk * GW_KSTEP_MN, j > 0 || kk > 0);
      fw_commit();
      fw_wait<1>();
    }
    fw_wait<0>();
    fw_pin(acc);

    // the tile rounded once into cs (lane (g, t) of warp w holds rows
    // 16 w + g and + 8, columns 8 j + 2 t and + 1), then stored
    __syncthreads();                   // every read of cs is done
    const int r0 = 64 * grp + 16 * warp + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      E* crow = cs + (r0 + 8 * h) * TB_LDC + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < TB_BN / 8; ++j)
        *reinterpret_cast<uint32_t*>(crow + 8 * j) =
            gw_pack(crow, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    __syncthreads();
    store(k0, n0);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // none outlives
}

template <bool VEC, class E>
static cudaError_t tb_launch(dim3 grid, cudaStream_t st, const E* a,
                             const E* g, E* c, int m, int n,
                             int k, int vec_c) {
  cudaError_t e = gw_opt_in<fullc_gemm_tn_bf16_kernel<VEC, E>>(TB_SMEM);
  if (e != cudaSuccess) return e;
  fullc_gemm_tn_bf16_kernel<VEC, E><<<grid, TB_THREADS, TB_SMEM, st>>>(
      a, g, c, m, n, k, vec_c);
  return cudaGetLastError();
}

// c (k, n) = a^T @ g in E, f32 sums, one rounding
template <class E>
static int tb_gemm(const void* a, const void* g, void* c, int m, int n,
                   int k, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  static std::atomic<int> sms[GW_MAX_DEVICES];   // SMs a device, asked once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= GW_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev].load() == 0) {
    int v = 0;
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms[dev].store(v);
  }
  const long long tiles = (long long)((k + TB_BM - 1) / TB_BM) *
                          ((n + TB_BN - 1) / TB_BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms[dev].load() ? tiles : sms[dev].load());
  const bool vec = k % 8 == 0 && n % 8 == 0 &&
                   (((uintptr_t)a | (uintptr_t)g) % 16) == 0;
  const int vec_c = n % 8 == 0 && ((uintptr_t)c % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t r =
      vec ? tb_launch<true>(dim3(grid), st, (const E*)a, (const E*)g,
                            (E*)c, m, n, k, vec_c)
          : tb_launch<false>(dim3(grid), st, (const E*)a, (const E*)g,
                             (E*)c, m, n, k, vec_c);
  return (int)r;
}

// the bf16 build: c = a^T @ g, all bf16
extern "C" int fullc_gemm_tn_bf16(const void* a, const void* g, void* c,
                                  int m, int n, int k, void* stream) {
  return tb_gemm<gw_bf16>(a, g, c, m, n, k, stream);
}

// the f16 build: c = a^T @ g, all f16
extern "C" int fullc_gemm_tn_f16(const void* a, const void* g, void* c,
                                 int m, int n, int k, void* stream) {
  return tb_gemm<gw_f16>(a, g, c, m, n, k, stream);
}
