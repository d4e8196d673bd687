// Paged flash-decode attention, f32 and bf16, for Hopper (sm_90a).
// Replaces the Pallas `_paged_decode_kernel` of
// cxxnet_tpu/ops/pallas_kernels.py:910 (launched by `paged_flash_decode`
// :942 from transformer.decode_step_paged, the decode engine's step).
//
// One decode step's attention for every slot: slot s's single query
// attends its live cache rows [w[s], pos[s]], read in place from the
// paged K/V pool of one stage through the page table (no dense cache is
// gathered).  Idle slots step on scratch page 0 with pos = w = 0, so
// position 0 is live and no row is all masked.
//
// Design: one block of 256 threads per (head, slot); the body is
// paged_attend_one (paged_attn.cuh), whose arithmetic depends only on the
// live rows in position order.  The TPU kernel DMAs every page of the
// slot into VMEM and masks afterwards; here only the live rows are read,
// each K and V row once.
//
// What bounds it on an H100: the bytes.  It reads each live K and V row
// once (2 * H * hd * 4 bytes per position in f32, half in bf16) plus q
// and out, against ~4 hd flops per row and head: at 16 slots of up to
// 256 positions that is tens of MB, a few microseconds at 3.35 TB/s,
// while the flops take well under a microsecond.

#include "paged_attn.cuh"

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, const int* __restrict__ w,
                    T* __restrict__ out, int H, int hd, int ps, int pp,
                    float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int cache_len = pp * ps;
  float* s_q = smem + cache_len;
  float* s_red = s_q + hd;
  const long long qo = ((long long)s * H + h) * hd;
  paged_attend_one<T>(q + qo, kpool, vpool, table + (long long)s * pp, ps,
                      H, hd, h, w[s], pos[s], scale, out + qo, smem, s_q,
                      s_red);
}

template <typename T>
static int launch_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* table,
                               const void* pos, const void* w, void* out,
                               int S, int H, int hd, int ps, int pp,
                               float scale, void* stream) {
  if (hd <= 0 || hd > PA_THREADS || ps <= 0 || pp <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  const size_t smem = pa_smem_bytes(pp * ps, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T><<<dim3(H, S), PA_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const T*)q, (const T*)kpool, (const T*)vpool, (const int*)table,
      (const int*)pos, (const int*)w, (T*)out, H, hd, ps, pp, scale);
  return (int)cudaGetLastError();
}

extern "C" int paged_decode_f32(const void* q, const void* kpool,
                                const void* vpool, const void* table,
                                const void* pos, const void* w, void* out,
                                int S, int H, int hd, int ps, int pp,
                                float scale, void* stream) {
  return launch_paged_decode<float>(q, kpool, vpool, table, pos, w, out, S,
                                    H, hd, ps, pp, scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* kpool,
                                 const void* vpool, const void* table,
                                 const void* pos, const void* w, void* out,
                                 int S, int H, int hd, int ps, int pp,
                                 float scale, void* stream) {
  return launch_paged_decode<__nv_bfloat16>(q, kpool, vpool, table, pos, w,
                                            out, S, H, hd, ps, pp, scale,
                                            stream);
}
