// Fused convolution + bias + activation (relu or identity), f32, for
// Hopper (sm_90a).  Replaces the Pallas block `_conv_act_kernel` /
// `_fused_call` of cxxnet_tpu/ops/pallas_cnn.py:103,149.
//
// What it computes: NHWC input x (n, h, w, cin), HWIO weight
// (kh, kw, cin/g, cout), optional bias (cout), strides (sy, sx), top/left
// padding (the bottom/right padding is implied by the output size oh/ow
// the caller passes), `groups` channel groups:
//   z[p, co] = sum_{u,v,c} x[n, oy*sy-pad_t+u, ox*sx-pad_l+v, g*cin_g+c]
//                          * w[u, v, c, co] + bias[co]
//   y = relu(z) or z,
// with p = (n, oy, ox) and zero for taps outside the input.  z is written
// only when `z` is non-null (the caller asks for it only when a backward
// will need the relu mask).
//
// What bounds it on an H100: the operations.  AlexNet's conv1-conv5 at
// batch 256 do 10 to 115 GFLOP each on at most 0.25 GB, and f32 FMA
// outside the tensor cores peaks at 67 TFLOP/s: the five together 5.1 ms.
//
// Design: an implicit GEMM per group, M = n*oh*ow output pixels,
// N = cout/g channels, K = kh*kw*cin/g in (u, v, c) order — exactly the
// row order of the HWIO weight viewed as a (K, cout) matrix — on the
// register-blocked, cp.async-pipelined tile of sgemm_pipe.cuh: 128 pixels
// x BN channels a block, 8 x 8 outputs a thread, a three-stage ring of
// 16-deep slices.  The patch slice is copied straight from the input, so
// the im2col matrix never exists in device memory (the point of the
// Pallas block).  Each block decodes its 128 pixels once, into a table in
// shared memory (the offset of the pixel's top-left tap in x, and that
// tap's input position for the padding test), so no per-pixel state sits
// in registers; a thread decodes its slice column's tap (u, v, c) once a
// slice into one offset, tap = (u * w + v) * cin + c, and a patch element
// is x[row offset + tap] where (iy0 + u, ix0 + v) lies in the input.  The
// patch copy depends on cin/g:
//   * cin/g % 16 == 0 (conv2-conv5): a 16-deep slice lies inside one tap
//     (u, v) and covers 16 contiguous channels of each pixel: the tap is
//     decoded once a slice, uniformly across the block, and each pixel's
//     run is four 16-byte copies;
//   * cin/g % 4 == 0: each 4-channel chunk lies inside one tap: a thread
//     decodes its chunk's tap once a slice and copies 16 bytes a pixel;
//   * otherwise (conv1, cin 3): a thread decodes its one column of the
//     slice once a slice and copies 4 bytes a pixel.
// A tap in the padding is zero-filled by the copy itself (src-size 0),
// as are the ragged tail of K (conv1: 363) and pixels past M.  The weight
// slice is staged as the forward GEMM stages its right operand, 16 bytes
// along cout where cout and cout/g allow.  The block is 64 channels wide,
// or 96 where that pads cout/g less (conv1's 96 channels are one tile,
// not a full and a half-empty one).  The epilogue adds the bias, applies
// relu, writes z when asked, and stores 16 bytes at a time along cout.
// No split-K (conv2-conv5 have over a thousand tiles each), no atomics:
// two launches give bitwise-equal outputs.
//
// The bf16 build (conv_bias_act_bf16, compute_type=bfloat16) is its own
// source, conv_bias_act_bf16.cu, on the bf16 tensor cores.

#include "sgemm_pipe.cuh"

struct ConvGeom {
  long long M;                      // n * oh * ow
  int h, wd, cin, kw, cout, sy, sx, pad_t, pad_l, oh, ow;
  int cin_g, cout_g, K, relu;
  int bvec;                         // 16-byte weight copies
  int ovec;                         // 16-byte stores of y, z and bias reads
};

// how a slice of the patch matrix is copied (see the header comment)
enum { A_SCALAR = 0, A_CHUNK4 = 1, A_TAP16 = 2 };

template <int BN>
__host__ __device__ constexpr int conv_stage_floats() {
  return SP_AFLOATS + SP_BK * BN;
}

template <int BN>
constexpr size_t conv_smem_bytes() {
  // the ring, then the pixel table: the top-left tap's offset (8 bytes)
  // and input position (8 bytes) for each of the 128 rows
  return SP_STAGES * conv_stage_floats<BN>() * sizeof(float) + SP_BM * 16;
}

template <int BN, int AMODE>
__device__ __forceinline__ void conv_stage(
    float* As, float* Bs, const float* __restrict__ x,
    const float* __restrict__ w, const ConvGeom& p,
    const long long* rbase, const int2* rpos, int g, int j0, int k0) {
  constexpr int THREADS = 2 * BN;
  const int t = threadIdx.x;
  if constexpr (AMODE == A_SCALAR) {
    // column kk of the slice, rows t / 16 + (THREADS / 16) i
    const int kk = t % SP_BK, k = k0 + kk;
    int u = 0, v = 0, c = 0;
    const bool kok = k < p.K;
    if (kok) {
      const int tap = k / p.cin_g;
      c = k - tap * p.cin_g;
      u = tap / p.kw;
      v = tap - u * p.kw;
    }
    const int off = (u * p.wd + v) * p.cin + c;
    constexpr int RSTEP = THREADS / SP_BK;
#pragma unroll 4
    for (int r = t / SP_BK; r < SP_BM; r += RSTEP) {
      const int2 pos = rpos[r];
      const bool ok = kok && (unsigned)(pos.x + u) < (unsigned)p.h &&
                      (unsigned)(pos.y + v) < (unsigned)p.wd;
      sp_cp(As + r * SP_LDA + kk, ok ? x + rbase[r] + off : x, ok, 4);
    }
  } else {
    // chunk q (4 channels) of the slice, rows t / 4 + (THREADS / 4) i
    const int q = t % 4;
    int u, v, c;
    bool kok = true;
    if constexpr (AMODE == A_TAP16) {
      const int tap = k0 / p.cin_g;            // uniform across the block
      c = k0 - tap * p.cin_g + 4 * q;
      u = tap / p.kw;
      v = tap - u * p.kw;
    } else {
      const int k = k0 + 4 * q;
      kok = k < p.K;
      const int tap = kok ? k / p.cin_g : 0;
      c = k - tap * p.cin_g;
      u = tap / p.kw;
      v = tap - u * p.kw;
    }
    const int off = (u * p.wd + v) * p.cin + c;
    constexpr int RSTEP = THREADS / 4;
#pragma unroll
    for (int r = t / 4; r < SP_BM; r += RSTEP) {
      const int2 pos = rpos[r];
      const bool ok = kok && (unsigned)(pos.x + u) < (unsigned)p.h &&
                      (unsigned)(pos.y + v) < (unsigned)p.wd;
      sp_cp(As + r * SP_LDA + 4 * q, ok ? x + rbase[r] + off : x, ok, 16);
    }
  }
  // the weight slice: rows k0 .. k0 + 15 of the (K, cout) matrix, columns
  // g * cout_g + j0 .. + BN
  const float* wg = w + (long long)g * p.cout_g + j0;
  const int ncols = p.cout_g - j0;
  if (p.bvec) {
#pragma unroll
    for (int e = 0; e < SP_BK * BN / 4 / THREADS; ++e) {
      const int i = t + e * THREADS;
      const int r = i / (BN / 4), nc = (i % (BN / 4)) * 4;
      const bool ok = k0 + r < p.K && nc < ncols;
      sp_cp(Bs + r * BN + nc,
            ok ? wg + (long long)(k0 + r) * p.cout + nc : w, ok, 16);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < SP_BK * BN / THREADS; ++e) {
      const int i = t + e * THREADS;
      const int r = i / BN, nc = i % BN;
      const bool ok = k0 + r < p.K && nc < ncols;
      sp_cp(Bs + r * BN + nc,
            ok ? wg + (long long)(k0 + r) * p.cout + nc : w, ok, 4);
    }
  }
}

// grid (pixel tiles, channel tiles, groups), 2 * BN threads
template <int BN, int AMODE>
__global__ void __launch_bounds__(2 * BN, BN == 64 ? 3 : 2)
conv_bias_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ z, const ConvGeom p) {
  constexpr int THREADS = 2 * BN, TX = BN / 8;
  constexpr int STAGE = conv_stage_floats<BN>();
  extern __shared__ __align__(16) float smem[];
  long long* rbase = reinterpret_cast<long long*>(smem + SP_STAGES * STAGE);
  int2* rpos = reinterpret_cast<int2*>(rbase + SP_BM);
  const int g = blockIdx.z, j0 = blockIdx.y * BN;
  const long long m0 = (long long)blockIdx.x * SP_BM;
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;

  // decode the block's pixels once; a row past M fails every bounds test
  for (int r = t; r < SP_BM; r += THREADS) {
    const long long m = m0 + r;
    int iy0 = -(1 << 30), ix0 = 0;
    long long base = 0;
    if (m < p.M) {
      const int ohw = p.oh * p.ow;
      const long long ni = m / ohw;
      const int rr = (int)(m - ni * ohw);
      const int oy = rr / p.ow, ox = rr - oy * p.ow;
      iy0 = oy * p.sy - p.pad_t;
      ix0 = ox * p.sx - p.pad_l;
      // may point before the image (a padded tap): read only in bounds
      base = (ni * p.h * p.wd + (long long)iy0 * p.wd + ix0) * p.cin +
             (long long)g * p.cin_g;
    }
    rbase[r] = base;
    rpos[r] = make_int2(iy0, ix0);
  }
  __syncthreads();

  float acc[8][8];
  sp_zero(acc);
  sp_mainloop(
      smem, STAGE, (p.K + SP_BK - 1) / SP_BK,
      [&](float* st, int s) {
        conv_stage<BN, AMODE>(st, st + SP_AFLOATS, x, w, p, rbase, rpos, g,
                              j0, s * SP_BK);
      },
      [&](const float* st) {
        sp_mma_kn<BN>(st, st + SP_AFLOATS, ty, tx, acc);
      });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = j0 + hf * (BN / 2) + tx * 4;     // within the group
      const int co = g * p.cout_g + col;
      const long long off = m * p.cout + co;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) v[jj] = acc[i][4 * hf + jj];
      if (p.ovec) {                     // cout_g % 4 == 0: all four or none
        if (col >= p.cout_g) continue;
        if (bias != nullptr) {
          const float4 b4 = *reinterpret_cast<const float4*>(bias + co);
          v[0] += b4.x; v[1] += b4.y; v[2] += b4.z; v[3] += b4.w;
        }
        if (z != nullptr)
          *reinterpret_cast<float4*>(z + off) =
              make_float4(v[0], v[1], v[2], v[3]);
        // NaN propagates like torch.relu / jnp.maximum
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (p.relu && v[jj] < 0.f) v[jj] = 0.f;
        *reinterpret_cast<float4*>(y + off) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (col + jj >= p.cout_g) continue;
          const float s = v[jj] + (bias != nullptr ? bias[co + jj] : 0.f);
          if (z != nullptr) z[off + jj] = s;
          y[off + jj] = (p.relu && s < 0.f) ? 0.f : s;
        }
      }
    }
  }
}

template <int BN, int AMODE>
static cudaError_t conv_launch(const float* x, const float* w,
                               const float* bias, float* y, float* z,
                               const ConvGeom& p, int groups,
                               cudaStream_t st) {
  constexpr size_t smem = conv_smem_bytes<BN>();
  auto kernel = conv_bias_act_kernel<BN, AMODE>;
  // above 48 KB of shared memory only by opting in (the 96-wide tile)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(sp_ceil(p.M, SP_BM), sp_ceil(p.cout_g, BN), groups);
  kernel<<<grid, 2 * BN, smem, st>>>(x, w, bias, y, z, p);
  return cudaGetLastError();
}

template <int BN>
static cudaError_t conv_dispatch(int amode, const float* x, const float* w,
                                 const float* bias, float* y, float* z,
                                 const ConvGeom& p, int groups,
                                 cudaStream_t st) {
  if (amode == A_TAP16)
    return conv_launch<BN, A_TAP16>(x, w, bias, y, z, p, groups, st);
  if (amode == A_CHUNK4)
    return conv_launch<BN, A_CHUNK4>(x, w, bias, y, z, p, groups, st);
  return conv_launch<BN, A_SCALAR>(x, w, bias, y, z, p, groups, st);
}

static ConvGeom conv_geom(int n, int h, int wd, int cin, int kh, int kw,
                          int cout, int groups, int sy, int sx, int pad_t,
                          int pad_l, int oh, int ow, int relu) {
  ConvGeom p;
  p.M = (long long)n * oh * ow;
  p.h = h; p.wd = wd; p.cin = cin; p.kw = kw;
  p.cout = cout; p.sy = sy; p.sx = sx;
  p.pad_t = pad_t; p.pad_l = pad_l; p.oh = oh; p.ow = ow;
  p.cin_g = cin / groups;
  p.cout_g = cout / groups;
  p.K = kh * kw * p.cin_g;
  p.relu = relu;
  return p;
}

static bool al16(const void* ptr) { return ((uintptr_t)ptr % 16) == 0; }

// the channel tile that pads cout/g least (64 on a tie)
static bool conv_wide(const ConvGeom& p) {
  return sp_ceil(p.cout_g, 96) * 96 < sp_ceil(p.cout_g, 64) * 64;
}

extern "C" int conv_bias_act_f32(const void* x, const void* w,
                                 const void* bias, void* y, void* z, int n,
                                 int h, int wd, int cin, int kh, int kw,
                                 int cout, int groups, int sy, int sx,
                                 int pad_t, int pad_l, int oh, int ow,
                                 int relu, void* stream) {
  ConvGeom p = conv_geom(n, h, wd, cin, kh, kw, cout, groups, sy, sx, pad_t,
                         pad_l, oh, ow, relu);
  if (p.M <= 0 || p.cout_g <= 0) return 0;
  const bool cvec = cout % 4 == 0 && p.cout_g % 4 == 0;
  p.bvec = cvec && al16(w);
  p.ovec = cvec && al16(y) && (z == nullptr || al16(z)) &&
           (bias == nullptr || al16(bias));
  const bool xvec = p.cin_g % 4 == 0 && al16(x);
  const int amode = !xvec ? A_SCALAR
                  : p.cin_g % 16 == 0 ? A_TAP16 : A_CHUNK4;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  float *yf = (float*)y, *zf = (float*)z;
  return (int)(conv_wide(p)
      ? conv_dispatch<96>(amode, xf, wf, bf, yf, zf, p, groups, st)
      : conv_dispatch<64>(amode, xf, wf, bf, yf, zf, p, groups, st));
}
