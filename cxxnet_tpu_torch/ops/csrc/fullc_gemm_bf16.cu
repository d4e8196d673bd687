// The bf16 and f16 builds of the fullc forward GEMM, on the tensor cores,
// for Hopper (sm_90a): one body over the 16-bit element type, two entries
// (fullc_gemm_bf16, fullc_gemm_f16).  Replaces, at compute_type=bfloat16
// and =float16, the Pallas `_matmul_kernel` / `_matmul_impl` of
// cxxnet_tpu/ops/pallas_kernels.py:383,532 (and its whole-K variant
// `_matmul_kernel_wholek` :376, the same function); fullc_gemm.cu holds
// the f32 build.
//
// What it computes: c (m, n) = a (m, k) @ b (k, n), a, b and c of one
// 16-bit type, row-major, b the fullc weight in its stored (nin, nhidden)
// layout: f32 sums, each output rounded to the 16-bit type once, as the
// Pallas kernel's f32 scratch accumulator and final astype
// (pallas_kernels.py:383-396).  A product of two bf16 or two f16 values is
// exact in f32, so mma.sync's products with f32 accumulators are JAX's;
// only the order of the sums differs.
//
// What bounds it on an H100: the bytes, by a little.  fc6 at batch 256
// (256 x 9216 -> 4096) does 19.3 GFLOP on 82 MB: 0.020 ms at the dense
// bf16 / f16 rate of 989 TFLOP/s, 0.025 ms at 3.35 TB/s; fc7 and fc8
// likewise.
//
// Design: gemm_bf16.cuh's tile in the NN layout.  A block of eight warps
// (2 x 4) owns a 128 x 128 tile of c, each warp a 64 x 32 piece of
// mma.sync m16n8k16 fragments: a 128 x 128 tile moves 16 KB from L2 a
// 32 k for 1 MFLOP, where 128 x 64 moved 12 KB for half that
// (tools/sgemm_variants.py: fc6 0.080 ms against 0.117).  64-deep slices
// of a (As[row][kk], rows of 72 elements) and b (Bs[kk][col], rows of 136)
// are staged by sgemm_pipe.cuh's three-stage cp.async ring, in 107.5 KB
// of dynamic shared memory: 16-byte copies, zero-filled past the edges
// by the copy itself, where k and n are multiples of 8 and the bases
// 16-byte aligned; otherwise 2-byte loads and stores.  a's fragments come
// out by ldmatrix, b's by ldmatrix.trans.  Deterministic split-K fills
// the card where the output has few tiles (fc8: 2 x 8): the contraction
// is cut into `splits` equal ranges of slices (sp_splits, reckoned for
// this kernel), one block per (tile, range), each range's f32 partial
// tile in its own slice of a workspace the wrapper allocates, summed in a
// fixed order and rounded once by sp_splitk_sum.  With one range the tile
// is rounded and written to c directly.  No atomics: two launches on the
// same inputs give bitwise-equal outputs.

#include "gemm_bf16.cuh"

constexpr int FB_WN = 4;                   // warp columns a block
constexpr int FB_BN = 32 * FB_WN, FB_THREADS = 64 * FB_WN;
constexpr int FB_BK = 64;                  // k a staged slice
constexpr int FB_LDA = FB_BK + 8;          // staged a row: 144 bytes
constexpr int FB_LDB = FB_BN + 8;          // staged b row
constexpr int FB_STAGE_FLOATS = (GM_BM * FB_LDA + FB_BK * FB_LDB) / 2;
constexpr size_t FB_SMEM = SP_STAGES * FB_STAGE_FLOATS * sizeof(float);

// Stage slice [k0, k0 + FB_BK) of the block's a rows and b columns, zero
// past m, n and kend.  VEC: k and n multiples of 8, a and b 16-byte
// aligned.
template <bool VEC, class T>
__device__ __forceinline__ void fb_stage(T* As, T* Bs,
                                         const T* __restrict__ a,
                                         const T* __restrict__ b,
                                         int m, int n, int k, int m0, int n0,
                                         int k0, int kend) {
  const int t = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < GM_BM * FB_BK / 8 / FB_THREADS; ++c) {
      const int i = t + c * FB_THREADS;
      const int r = i / (FB_BK / 8), kc = (i % (FB_BK / 8)) * 8;
      const bool ok = m0 + r < m && k0 + kc < kend;
      gm_cp16(As + r * FB_LDA + kc,
              ok ? a + (long long)(m0 + r) * k + k0 + kc : a, ok);
    }
#pragma unroll
    for (int c = 0; c < FB_BK * FB_BN / 8 / FB_THREADS; ++c) {
      const int i = t + c * FB_THREADS;
      const int r = i / (FB_BN / 8), nc = (i % (FB_BN / 8)) * 8;
      const bool ok = k0 + r < kend && n0 + nc < n;
      gm_cp16(Bs + r * FB_LDB + nc,
              ok ? b + (long long)(k0 + r) * n + n0 + nc : b, ok);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < GM_BM * FB_BK / FB_THREADS; ++c) {
      const int i = t + c * FB_THREADS;
      const int r = i / FB_BK, kc = i % FB_BK;
      As[r * FB_LDA + kc] = m0 + r < m && k0 + kc < kend
                                ? a[(long long)(m0 + r) * k + k0 + kc]
                                : gm_0<T>();
    }
#pragma unroll 4
    for (int c = 0; c < FB_BK * FB_BN / FB_THREADS; ++c) {
      const int i = t + c * FB_THREADS;
      const int r = i / FB_BN, nc = i % FB_BN;
      Bs[r * FB_LDB + nc] = k0 + r < kend && n0 + nc < n
                                ? b[(long long)(k0 + r) * n + n0 + nc]
                                : gm_0<T>();
    }
  }
}

// One (output tile, k range) block: grid (n tiles, m tiles, splits).
// Range z covers slices [z * per, (z + 1) * per).  OUT float: its partial
// tile into out + z * m * n; OUT = T: the tile, rounded, into c (one
// range).
template <bool VEC, class OUT, class T>
__global__ void __launch_bounds__(FB_THREADS, 6 / FB_WN)
fullc_gemm_bf16_kernel(const T* __restrict__ a,
                       const T* __restrict__ b, OUT* __restrict__ out,
                       int m, int n, int k, int per, bool pair) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * FB_BN, m0 = blockIdx.y * GM_BM;
  const int kbeg = blockIdx.z * per * FB_BK;
  const int kend = min(k, kbeg + per * FB_BK);
  const int nk = kend > kbeg ? (kend - kbeg + FB_BK - 1) / FB_BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp / FB_WN) * 16 * GM_MT;
  const int wc = (warp % FB_WN) * 8 * GM_NT;

  float acc[GM_MT][GM_NT][4];
  gm_zero(acc);
  sp_mainloop(
      smem, FB_STAGE_FLOATS, nk,
      [&](float* st, int s) {
        T* As = reinterpret_cast<T*>(st);
        fb_stage<VEC>(As, As + GM_BM * FB_LDA, a, b, m, n, k, m0, n0,
                      kbeg + s * FB_BK, kend);
      },
      [&](const float* st) {
        const T* As = reinterpret_cast<const T*>(st);
        gm_slice_nn<FB_BK>(As, FB_LDA, As + GM_BM * FB_LDA, FB_LDB, wr, wc,
                           lane, acc);
      });
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // none outlives
  gm_store(acc, out + (long long)blockIdx.z * m * n, m, n, m0 + wr, n0 + wc,
           pair);
}

// The number of split-K ranges for an (m, n, k) product of T on the
// current device (sp_splits, at this kernel's occupancy and slice depth);
// the wrapper sizes the workspace (splits, m, n) from it.
template <class T>
static int fb_splits(int m, int n, int k) {
  if (m <= 0 || n <= 0 || k <= 0) return 1;
  return sp_splits((const void*)fullc_gemm_bf16_kernel<true, float, T>,
                   FB_THREADS,
                   (long long)sp_ceil(m, GM_BM) * sp_ceil(n, FB_BN),
                   sp_ceil(k, FB_BK), FB_SMEM);
}

extern "C" int fullc_gemm_bf16_splits(int m, int n, int k) {
  return fb_splits<gm_bf16>(m, n, k);
}

extern "C" int fullc_gemm_f16_splits(int m, int n, int k) {
  return fb_splits<gm_f16>(m, n, k);
}

template <bool VEC, class OUT, class T>
static cudaError_t fb_launch_out(dim3 grid, cudaStream_t st, const T* a,
                             const T* b, OUT* out, int m, int n, int k,
                             int per, bool pair) {
  auto kernel = fullc_gemm_bf16_kernel<VEC, OUT, T>;
  // above 48 KB of shared memory only by opting in
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FB_SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, FB_THREADS, FB_SMEM, st>>>(a, b, out, m, n, k, per, pair);
  return cudaGetLastError();
}

template <bool VEC, class T>
static cudaError_t fb_launch(dim3 grid, cudaStream_t st, const T* a,
                             const T* b, void* out, bool partial, int m,
                             int n, int k, int per, bool pair) {
  return partial ? fb_launch_out<VEC>(grid, st, a, b, (float*)out, m, n, k,
                                      per, pair)
                 : fb_launch_out<VEC>(grid, st, a, b, (T*)out, m, n,
                                      k, per, pair);
}

// c = a @ b in T (bf16 or f16), f32 sums, one rounding.  `splits` from
// fb_splits<T>; with splits > 1, `ws` is a (splits, m, n) f32 scratch
// buffer (unused, may be null, otherwise).
template <class T>
static int fb_gemm(const void* a, const void* b, void* c, void* ws, int m,
                   int n, int k, int splits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int slices = sp_ceil(k > 0 ? k : 1, FB_BK);
  const int per = sp_ceil(slices, splits);
  splits = sp_ceil(slices, per);       // no empty range
  const bool vec = k % 8 == 0 && n % 8 == 0 &&
                   (((uintptr_t)a | (uintptr_t)b) % 16) == 0;
  const bool partial = splits > 1;
  void* out = partial ? ws : c;
  const bool pair = n % 2 == 0 && ((uintptr_t)out % 8) == 0;
  const dim3 grid(sp_ceil(n, FB_BN), sp_ceil(m, GM_BM), splits);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      vec ? fb_launch<true>(grid, st, (const T*)a, (const T*)b,
                            out, partial, m, n, k, per, pair)
          : fb_launch<false>(grid, st, (const T*)a, (const T*)b,
                             out, partial, m, n, k, per, pair);
  if (e != cudaSuccess) return (int)e;
  return (int)sp_finish((const float*)ws, (T*)c, (long long)m * n,
                        splits, st);
}

// the bf16 build: c = a @ b, all bf16
extern "C" int fullc_gemm_bf16(const void* a, const void* b, void* c,
                               void* ws, int m, int n, int k, int splits,
                               void* stream) {
  return fb_gemm<gm_bf16>(a, b, c, ws, m, n, k, splits, stream);
}

// the f16 build: c = a @ b, all f16
extern "C" int fullc_gemm_f16(const void* a, const void* b, void* c,
                              void* ws, int m, int n, int k, int splits,
                              void* stream) {
  return fb_gemm<gm_f16>(a, b, c, ws, m, n, k, splits, stream);
}
