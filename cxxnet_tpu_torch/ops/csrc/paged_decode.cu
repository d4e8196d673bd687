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
// paged_attend_one (paged_attn.cuh): the slot's page ids read once into
// shared memory, each warp a contiguous run of live rows read with 16-byte
// loads (8 passes in flight), warp-shuffle reductions, and sums whose
// order depends only on the live rows in position order.  The TPU kernel
// DMAs every page of the slot into VMEM and masks afterwards; here only
// the live rows are read, each K and V row once.
//
// What bounds it on an H100: the bytes.  It reads each live K and V row
// once (2 * H * hd * 4 bytes per position in f32, half in bf16) plus q
// and out, against ~4 hd flops per row and head: at 16 slots of up to
// 256 positions that is ~11 MB, 3.4 us at 3.35 TB/s (1.7 in bf16), about
// what a launch itself costs; paged_empty_launch times that floor.

#include "paged_attn.cuh"

template <typename T, int VEC, int CPL>
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
  const long long qo = ((long long)s * H + h) * hd;
  paged_attend_one<T, VEC, CPL>(q + qo, kpool, vpool,
                                table + (long long)s * pp, pp, ps, H, hd, h,
                                w[s], pos[s], scale, out + qo, smem);
}

template <typename T, int VEC, int CPL>
static int launch_vec(const void* q, const void* kpool, const void* vpool,
                      const void* table, const void* pos, const void* w,
                      void* out, int S, int H, int hd, int ps, int pp,
                      float scale, void* stream) {
  const size_t smem = pa_smem_bytes(pp * ps, pp, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, VEC, CPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T, VEC, CPL><<<dim3(H, S), PA_THREADS, smem,
                                (cudaStream_t)stream>>>(
      (const T*)q, (const T*)kpool, (const T*)vpool, (const int*)table,
      (const int*)pos, (const int*)w, (T*)out, H, hd, ps, pp, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* table,
                               const void* pos, const void* w, void* out,
                               int S, int H, int hd, int ps, int pp,
                               float scale, void* stream) {
  if (hd <= 0 || hd > PA_MAX_HD || ps <= 0 || pp <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
#define PA_LAUNCH(TT, VEC, CPL)                                            \
  launch_vec<TT, VEC, CPL>(q, kpool, vpool, table, pos, w, out, S, H, hd, ps, \
                           pp, scale, stream)
  PA_DISPATCH(T, pa_vec_ok(q, kpool, vpool, hd * sizeof(T)), hd, PA_LAUNCH);
#undef PA_LAUNCH
}

__global__ void paged_empty_kernel() {}

// an empty kernel on the decode kernel's grid: the floor of a launch
extern "C" int paged_empty_launch(int S, int H, void* stream) {
  paged_empty_kernel<<<dim3(H, S), PA_THREADS, 0, (cudaStream_t)stream>>>();
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
