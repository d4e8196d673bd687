// Paged flash-verify attention, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_paged_verify_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:988 (launched by `paged_flash_verify`
// :1021 from transformer.verify_step_paged, the speculative-decoding
// verify round).
//
// The K-query window of paged_decode.cu: slot s's query k sits at
// position pos[s] + k and attends the live rows [w[s], pos[s] + k] (its
// own row and earlier drafts, never a later one), read in place from the
// paged pool of one stage through the page table.
//
// Design: one block of 256 threads per (head, query, slot), each running
// paged_attend_one (paged_attn.cuh; see there for the row layout) over
// its own live range.  So query k
// computes bitwise what paged_decode.cu computes for a decode step at
// position pos + k over the same rows, and K = 1 is the decode kernel:
// the greedy verify window accepts exactly the tokens single steps would
// pick.  The window's queries re-read the shared rows (K times from L2,
// once from device memory when they fit in it).
//
// What bounds it on an H100: the bytes (half of them in bf16).  Each
// live K and V row once (rows [w, pos + K - 1]) plus the K queries and
// outputs, against ~4 hd flops per row, head and query.

#include "paged_attn.cuh"

template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(PA_THREADS)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, const int* __restrict__ w,
                    T* __restrict__ out, int K, int H, int hd, int ps,
                    int pp, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const long long qo = (((long long)s * K + k) * H + h) * hd;
  paged_attend_one<T, VEC, CPL>(q + qo, kpool, vpool,
                                table + (long long)s * pp, pp, ps, H, hd, h,
                                w[s], pos[s] + k, scale, out + qo, smem);
}

template <typename T, int VEC, int CPL>
static int launch_vec(const void* q, const void* kpool, const void* vpool,
                      const void* table, const void* pos, const void* w,
                      void* out, int S, int K, int H, int hd, int ps, int pp,
                      float scale, void* stream) {
  const size_t smem = pa_smem_bytes(pp * ps, pp, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_verify_kernel<T, VEC, CPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_verify_kernel<T, VEC, CPL><<<dim3(H, K, S), PA_THREADS, smem,
                                (cudaStream_t)stream>>>(
      (const T*)q, (const T*)kpool, (const T*)vpool, (const int*)table,
      (const int*)pos, (const int*)w, (T*)out, K, H, hd, ps, pp, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_paged_verify(const void* q, const void* kpool,
                               const void* vpool, const void* table,
                               const void* pos, const void* w, void* out,
                               int S, int K, int H, int hd, int ps, int pp,
                               float scale, void* stream) {
  if (hd <= 0 || hd > PA_MAX_HD || ps <= 0 || pp <= 0 || H <= 0 ||
      K <= 0 || K > 65535)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
#define PA_LAUNCH(TT, VEC, CPL)                                          \
  launch_vec<TT, VEC, CPL>(q, kpool, vpool, table, pos, w, out, S, K, H, hd, \
                           ps, pp, scale, stream)
  PA_DISPATCH(T, pa_vec_ok(q, kpool, vpool, hd * sizeof(T)), hd, PA_LAUNCH);
#undef PA_LAUNCH
}

extern "C" int paged_verify_f32(const void* q, const void* kpool,
                                const void* vpool, const void* table,
                                const void* pos, const void* w, void* out,
                                int S, int K, int H, int hd, int ps, int pp,
                                float scale, void* stream) {
  return launch_paged_verify<float>(q, kpool, vpool, table, pos, w, out, S,
                                    K, H, hd, ps, pp, scale, stream);
}

extern "C" int paged_verify_bf16(const void* q, const void* kpool,
                                 const void* vpool, const void* table,
                                 const void* pos, const void* w, void* out,
                                 int S, int K, int H, int hd, int ps, int pp,
                                 float scale, void* stream) {
  return launch_paged_verify<__nv_bfloat16>(q, kpool, vpool, table, pos, w,
                                            out, S, K, H, hd, ps, pp, scale,
                                            stream);
}
