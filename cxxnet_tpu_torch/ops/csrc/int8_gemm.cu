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
// Design: one block of 256 threads per 64 x 64 output tile, each thread
// a 4 x 4 register accumulator; the contraction loop runs inside the
// block (the TPU kernel's sequential K grid axis and its int32 VMEM
// accumulator become registers here) over 64-deep slices staged in
// shared memory as 32-bit words of four consecutive k: a's rows as they
// lie in memory, b's columns transposed on the way in (four rows of four
// columns loaded as words, their bytes regrouped per column), so that
// one `__dp4a` multiplies and adds four k at once.  The next slice is
// loaded into registers while the current one is multiplied.  Ragged
// edges (any m >= 1, any k and n) are masked on load and store; nothing
// is padded in device memory as the Pallas kernel pads its operands.
//
// What bounds it on an H100: at the decode step's 64 rows the bytes —
// each weight byte is read once (1 MB for a 1024 x 1024 projection, 32 MB
// for the head) against 128 integer operations per weight byte, well
// under the 590 int8 operations per byte where the tensor cores' 1979
// TOP/s would take over.  `__dp4a` runs on the CUDA cores, not the
// tensor cores; at these row counts that does not matter, at prefill's
// 128 rows it starts to.  A 64-row tile leaves most of the card idle
// when n is 1024 (16 blocks); split-K (exact with integer atomics) or
// `mma.sync`/`wgmma` tiles are where a faster version starts.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int I8_TM = 64;        // output rows per block
constexpr int I8_TN = 64;        // output columns per block
constexpr int I8_TK = 64;        // contraction bytes per slice
constexpr int I8_KW = I8_TK / 4; // 32-bit words of k per slice
constexpr int I8_THREADS = 256;

// four bytes of row `row` of a at columns [c, c + 4), zero outside
__device__ __forceinline__ int load_a_word(const int8_t* __restrict__ a,
                                           int m, int k, int row, int c,
                                           bool vec) {
  if (row >= m || c >= k) return 0;
  const int8_t* p = a + (long long)row * k + c;
  if (vec && c + 4 <= k) return *reinterpret_cast<const int*>(p);
  uint32_t w = 0;
  for (int i = 0; i < 4 && c + i < k; ++i)
    w |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return (int)w;
}

// b's bytes at rows [r0, r0 + 4) and columns [c, c + 4), zero outside,
// regrouped so that word j holds column c + j's four rows (k ascending)
__device__ __forceinline__ void load_b_quad(const int8_t* __restrict__ b,
                                            int k, int n, int r0, int c,
                                            bool vec, int out[4]) {
  uint32_t rows[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rows[r] = 0;
    const int kr = r0 + r;
    if (kr >= k || c >= n) continue;
    const int8_t* p = b + (long long)kr * n + c;
    if (vec && c + 4 <= n) {
      rows[r] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      for (int i = 0; i < 4 && c + i < n; ++i)
        rows[r] |= (uint32_t)(uint8_t)p[i] << (8 * i);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) w |= ((rows[r] >> (8 * j)) & 0xffu) << (8 * r);
    out[j] = (int)w;
  }
}

__global__ void __launch_bounds__(I8_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int* __restrict__ c, int m, int n, int k, int a_vec,
                 int b_vec) {
  __shared__ int As[I8_KW][I8_TM + 1];  // [k word][row]
  __shared__ int Bs[I8_KW][I8_TN];      // [k word][column]

  const int m0 = blockIdx.x * I8_TM;
  const int n0 = blockIdx.y * I8_TN;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  // this thread's share of a slice: four words of a (rows t/16 + 16i,
  // word t%16) and one 4 x 4 quad of b (word t/16, columns 4 (t%16) + j)
  const int a_kw = t % I8_KW;
  const int a_row = t / I8_KW;
  const int b_kw = t / 16;
  const int b_col = 4 * (t % 16);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  int ra[4], rb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ra[i] = load_a_word(a, m, k, m0 + a_row + 16 * i, 4 * a_kw, a_vec);
  load_b_quad(b, k, n, 4 * b_kw, n0 + b_col, b_vec, rb);

  for (int k0 = 0; k0 < k; k0 += I8_TK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_kw][a_row + 16 * i] = ra[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[b_kw][b_col + j] = rb[j];
    __syncthreads();
    const int k1 = k0 + I8_TK;
    if (k1 < k) {  // the next slice, in flight while this one multiplies
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = load_a_word(a, m, k, m0 + a_row + 16 * i, k1 + 4 * a_kw,
                            a_vec);
      load_b_quad(b, k, n, k1 + 4 * b_kw, n0 + b_col, b_vec, rb);
    }
#pragma unroll
    for (int kw = 0; kw < I8_KW; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kw][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) c[(long long)row * n + col] = acc[i][j];
    }
  }
}

extern "C" int int8_gemm_s8s32(const void* a, const void* b, void* c, int m,
                               int n, int k, void* stream) {
  if (m < 0 || n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  if (k == 0) {  // an empty contraction: zeros
    return (int)cudaMemsetAsync(c, 0, (size_t)m * n * sizeof(int),
                                (cudaStream_t)stream);
  }
  const int a_vec = (k % 4 == 0) && ((uintptr_t)a % 4 == 0);
  const int b_vec = (n % 4 == 0) && ((uintptr_t)b % 4 == 0);
  dim3 grid((unsigned)((m + I8_TM - 1) / I8_TM),
            (unsigned)((n + I8_TN - 1) / I8_TN));
  int8_gemm_kernel<<<grid, I8_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int*)c, m, n, k, a_vec, b_vec);
  return (int)cudaGetLastError();
}
