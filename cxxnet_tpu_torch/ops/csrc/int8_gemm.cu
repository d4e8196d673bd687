// int8 x int8 -> int32 GEMM for Hopper (sm_90a): the quantized serving
// tier's matmul.  Replaces the Pallas `_int8_matmul_kernel` /
// `pallas_int8_matmul` of cxxnet_tpu/ops/pallas_kernels.py:1073,1090
// (reached from nnet/quantize.py `qdot` at every inference matmul of the
// TransformerLM when serve.dtype=int8).
//
// What it computes: c (m, n) int32 = a (m, k) int8 @ b (k, n) int8, all
// row-major, b the weight in its stored (k, n) layout.  The accumulation
// is exact (|c| <= k * 127^2 < 2^31 for k < 133143, which the wrapper
// checks), so the order of the sums changes nothing: the result is
// bitwise the plain version's and the JAX package's.
//
// What bounds it on an H100: the bytes.  A decode step runs 64 padded
// rows, so each weight byte (1 MB for a 1024 x 1024 projection, 32 MB for
// the head) meets 128 integer operations, under the ~590 a byte where the
// int8 tensor cores' 1979 TOP/s would take over; the weight has to
// stream through at the memory rate, and a 1 MB product is over in about
// a microsecond of transfer, so the latency of the first loads and the
// launch weigh as much as the rate.
//
// Design:
// * s8 tensor-core products, `mma.sync.m16n8k32.row.col.s32.s8.s8.s32`.
//   A block of 4 warps owns a 64 x 64 output tile; warp w takes rows
//   32 (w & 1) .. +31 and columns 32 (w >> 1) .. +31: 2 x 4 products of
//   16 x 8 each per 32-deep step.
// * Split-K over a thread block cluster.  The contraction's 64-deep
//   tiles are cut into S = 1, 2, 4 or 8 contiguous ranges, S the
//   smallest power of two that gives >= 132 blocks (one an SM), at most
//   8 and at most half the tiles (int8_gemm_splits).  The S blocks of
//   one output tile form one cluster: each leaves its 64 x 64 int32
//   partial; block r owns rows r * 64 / S .. of the tile, and each block
//   writes each owner its share of those rows, through distributed
//   shared memory, into slot s of the owner's receive buffer.  After one
//   cluster barrier each block adds its slots in rank order and writes
//   its rows once.  One launch, no memset, no atomics, no workspace:
//   exact and deterministic.  (Pushing the shares costs one full barrier
//   where pulling them costs two; an unsplit product, S = 1, takes none.)
// * A four-stage `cp.async` ring of 16-byte copies (32 KB, three stages
//   in flight; 16 KB more receive the shares): a's rows as they lie
//   (16-byte chunks XOR-swizzled by (row >> 1) & 3, so the `ldmatrix.x4`
//   that reads an A fragment is conflict-free) and b's k-rows as they
//   lie, two 64-byte rows to a 128-byte line, chunks swizzled by
//   (k >> 2) & 3.  The tensor cores read an 8-bit B operand only
//   k-major, so the regroup of the N-major weight happens at the
//   fragment read: a lane reads the words of 4 consecutive k-rows at 4
//   consecutive columns (conflict-free under the swizzle) and transposes
//   the 4 x 4 bytes with 8 `prmt`s into 4 registers, one column's 4 k
//   each.  The 4 registers feed 4 different 16 x 8 products: product j
//   of a warp maps its column g to the warp's column 4 g + j, and the
//   epilogue maps the result back.  Nothing is transposed or padded in
//   device memory.
// * Ragged m, n and k are zero-filled on the copy (src-size 0 for a
//   chunk outside).  Where k (for a) or n (for b) is not a multiple of
//   16, or an operand is not 16-byte aligned, that operand takes a byte
//   path into the same shared-memory layout.
//
// tests/test_torch_int8_mma.py models the loaders, the fragment mapping,
// the byte regroup and the split in numpy against a @ b.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int I8_BM = 64;          // output rows per block
constexpr int I8_BN = 64;          // output columns per block
constexpr int I8_BK = 64;          // contraction bytes per stage
constexpr int I8_STAGES = 4;       // stages of the cp.async ring
constexpr int I8_THREADS = 128;
constexpr int I8_MAX_SPLITS = 8;   // the portable cluster size
constexpr int I8_TARGET_BLOCKS = 132;  // blocks the split aims for
constexpr int I8_A_STAGE = I8_BM * I8_BK;  // bytes
constexpr int I8_B_STAGE = I8_BK * I8_BN;
constexpr int I8_STAGE = I8_A_STAGE + I8_B_STAGE;
constexpr int I8_CS = I8_BN + 4;   // ints per row of the partial tile
constexpr int I8_RECV = I8_BM * I8_BN * 4;  // bytes of the receive buffer

static_assert(I8_BM * I8_CS * 4 <= I8_STAGES * I8_STAGE,
              "the partial tile reuses the ring");
static_assert(I8_STAGES * I8_STAGE + I8_RECV <= 48 * 1024,
              "static shared memory");

// byte offset of 16-byte chunk `c` (0..3) of a's tile row `row`
__device__ __forceinline__ int a_off(int row, int c) {
  return row * I8_BK + ((c ^ ((row >> 1) & 3)) << 4);
}

// byte offset of 16-byte chunk `c` (0..3) of b's tile k-row `kr`: k-rows
// 2i and 2i + 1 share 128-byte line i, at 16-byte slot
// (4 (kr & 1) + c) ^ 2 ((kr >> 2) & 3)
__device__ __forceinline__ int b_off(int kr, int c) {
  return (kr >> 1) * 128 +
         (((((kr & 1) << 2) | c) ^ (((kr >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of `p` from `avail` on zero-filled, one byte at a time
__device__ __forceinline__ void copy16_bytes(uint8_t* dst, const int8_t* p,
                                             int avail) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < avail) w[i >> 2] |= (uint32_t)(uint8_t)p[i] << (8 * (i & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// rows r of w[r] (4 k-rows, bytes = 4 columns) -> out[j] = column j's 4
// k-rows, k ascending from the low byte
__device__ __forceinline__ void transpose4x4(const uint32_t w[4],
                                             uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one stage: a's 64 x 64 tile at (m0, k0) and b's at (k0, n0), two
// 16-byte chunks of each per thread
template <bool VA, bool VB>
__device__ __forceinline__ void load_stage(uint8_t* st,
                                           const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b,
                                           int m, int n, int k, int m0,
                                           int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int id = tid + I8_THREADS * j;
    const int row = id >> 2, c = id & 3;
    const int gr = m0 + row, gk = k0 + 16 * c;
    uint8_t* dst = st + a_off(row, c);
    if (VA) {
      const bool ok = gr < m && gk < k;
      cp_async16(dst, ok ? a + (long long)gr * k + gk : a, ok ? 16 : 0);
    } else {
      copy16_bytes(dst, a + (long long)gr * k + gk,
                   gr < m ? k - gk : 0);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int id = tid + I8_THREADS * j;
    const int kr = id >> 2, c = id & 3;
    const int gk = k0 + kr, gn = n0 + 16 * c;
    uint8_t* dst = st + I8_A_STAGE + b_off(kr, c);
    if (VB) {
      const bool ok = gk < k && gn < n;
      cp_async16(dst, ok ? b + (long long)gk * n + gn : b, ok ? 16 : 0);
    } else {
      copy16_bytes(dst, b + (long long)gk * n + gn,
                   gk < k ? n - gn : 0);
    }
  }
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(I8_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int* __restrict__ c, int m, int n, int k, int tps,
                 int c_vec) {
  // the ring (the partial tile once the loop is done), then the receive
  // buffer: slot r holds sender r's share of this block's rows
  __shared__ __align__(128) uint8_t smem[I8_STAGES * I8_STAGE + I8_RECV];
  int* recv = reinterpret_cast<int*>(smem + I8_STAGES * I8_STAGE);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x;          // the split count = the cluster size
  const int s = blockIdx.x;         // this block's split = cluster rank
  // "started" half of a cluster barrier: waited on only before the first
  // write into another block's shared memory
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);
  const int n0 = blockIdx.y * I8_BN;
  const int m0 = blockIdx.z * I8_BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;

  const int ktiles = (k + I8_BK - 1) / I8_BK;
  const int kt0 = s * tps;
  const int nt = max(min(ktiles, kt0 + tps) - kt0, 0);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int p = 0; p < I8_STAGES - 1; ++p) {
    if (p < nt)
      load_stage<VA, VB>(smem + p * I8_STAGE, a, b, m, n, k, m0, n0,
                         (kt0 + p) * I8_BK);
    cp_async_commit();
  }

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<I8_STAGES - 2>();
    __syncthreads();
    const int nx = it + I8_STAGES - 1;
    if (nx < nt)
      load_stage<VA, VB>(smem + (nx % I8_STAGES) * I8_STAGE, a, b, m, n, k,
                         m0, n0, (kt0 + nx) * I8_BK);
    cp_async_commit();

    const uint8_t* As = smem + (it % I8_STAGES) * I8_STAGE;
    const uint8_t* Bs = As + I8_A_STAGE;
#pragma unroll
    for (int kk = 0; kk < I8_BK / 32; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // ldmatrix.x4: lane L names row L & 7 of matrix L >> 3; matrices
        // (rows 0-7 | 8-15) x (k 0-15 | 16-31) are A's four registers
        const int q = lane >> 3;
        const int row = 32 * wm + 16 * i + ((q & 1) << 3) + (lane & 7);
        const unsigned addr = smem_u32(As + a_off(row, 2 * kk + (q >> 1)));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(af[i][0]), "=r"(af[i][1]), "=r"(af[i][2]), "=r"(af[i][3])
            : "r"(addr));
      }
      uint32_t bf[2][4];  // [k half][product j]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kr = 32 * kk + 16 * h + 4 * t + r;
          w[r] = *reinterpret_cast<const uint32_t*>(
              Bs + b_off(kr, 2 * wn + (g >> 2)) + 4 * (g & 3));
        }
        transpose4x4(w, bf[h]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[0][j], bf[1][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this split's partial, rows and columns in tile order
  int* Cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 32 * wm + 16 * i + g + 8 * (e >> 1);
        const int col = 32 * wn + 4 * (2 * t + (e & 1)) + j;
        Cs[row * I8_CS + col] = acc[i][j][e];
      }
  __syncthreads();

  // rank r owns rows [r 64 / S, (r + 1) 64 / S) of the tile: send each
  // rank its rows, into slot s of its receive buffer (16 bytes a group)
  const int rows = I8_BM / S;
  constexpr int GROUPS = I8_BM * I8_BN / 4 / I8_THREADS;
  if (S > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::);
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) {
      const int e = tid + q * I8_THREADS;
      const int row = e / (I8_BN / 4), col = 4 * (e % (I8_BN / 4));
      const int r = row / rows;
      *reinterpret_cast<int4*>(cluster.map_shared_rank(recv, r) +
                               (s * rows + row - r * rows) * I8_BN + col) =
          *reinterpret_cast<const int4*>(Cs + row * I8_CS + col);
    }
    // the one full barrier: every share has landed; after it no block
    // touches another's shared memory, so each leaves when it is done
    cluster.sync();
  }

  // this block's rows: the S shares in rank order (the partial tile
  // itself when S = 1), then the stores
  const int ng = GROUPS / S;
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) {
    if (q >= ng) break;
    const int e = tid + q * I8_THREADS;
    const int lr = e / (I8_BN / 4), col = 4 * (e % (I8_BN / 4));
    int4 sum = *reinterpret_cast<const int4*>(
        S > 1 ? recv + lr * I8_BN + col : Cs + lr * I8_CS + col);
    for (int r = 1; r < S; ++r) {
      const int4 v = *reinterpret_cast<const int4*>(
          recv + (r * rows + lr) * I8_BN + col);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int gr = m0 + s * rows + lr, gc = n0 + col;
    if (gr >= m || gc >= n) continue;
    int* dst = c + (long long)gr * n + gc;
    if (c_vec) {
      *reinterpret_cast<int4*>(dst) = sum;
    } else {
      const int w[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (gc + x < n) dst[x] = w[x];
    }
  }
}

// the split count of an (m, n, k) product: see the design note above
extern "C" int int8_gemm_splits(int m, int n, int k) {
  const long long tiles = (long long)((m + I8_BM - 1) / I8_BM) *
                          ((n + I8_BN - 1) / I8_BN);
  const int ktiles = (k + I8_BK - 1) / I8_BK;
  int S = 1;
  while (S < I8_MAX_SPLITS && 2 * S <= ktiles &&
         tiles * S < I8_TARGET_BLOCKS)
    S *= 2;
  return S;
}

template <bool VA, bool VB>
static cudaError_t launch(const int8_t* a, const int8_t* b, int* c, int m,
                          int n, int k, int S, int tps, int c_vec,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S, (unsigned)((n + I8_BN - 1) / I8_BN),
                     (unsigned)((m + I8_BM - 1) / I8_BM));
  cfg.blockDim = dim3(I8_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_gemm_kernel<VA, VB>, a, b, c, m, n,
                            k, tps, c_vec);
}

extern "C" int int8_gemm_s8s32(const void* a, const void* b, void* c, int m,
                               int n, int k, void* stream) {
  if (m < 0 || n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  if ((m + I8_BM - 1) / I8_BM > 65535 || (n + I8_BN - 1) / I8_BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 0)  // an empty contraction: zeros
    return (int)cudaMemsetAsync(c, 0, (size_t)m * n * sizeof(int), st);
  const int S = int8_gemm_splits(m, n, k);
  const int ktiles = (k + I8_BK - 1) / I8_BK;
  const int tps = (ktiles + S - 1) / S;
  const bool va = (k % 16 == 0) && ((uintptr_t)a % 16 == 0);
  const bool vb = (n % 16 == 0) && ((uintptr_t)b % 16 == 0);
  const int c_vec = (n % 4 == 0) && ((uintptr_t)c % 16 == 0);
  const int8_t* A = (const int8_t*)a;
  const int8_t* B = (const int8_t*)b;
  int* C = (int*)c;
  cudaError_t e;
  if (va && vb)
    e = launch<true, true>(A, B, C, m, n, k, S, tps, c_vec, st);
  else if (va)
    e = launch<true, false>(A, B, C, m, n, k, S, tps, c_vec, st);
  else if (vb)
    e = launch<false, true>(A, B, C, m, n, k, S, tps, c_vec, st);
  else
    e = launch<false, false>(A, B, C, m, n, k, S, tps, c_vec, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
