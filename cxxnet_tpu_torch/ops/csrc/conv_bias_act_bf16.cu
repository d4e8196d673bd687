// The bf16 and f16 builds of the fused convolution + bias + activation,
// on the tensor cores, for Hopper (sm_90a): one body over the 16-bit
// element type, two entries (conv_bias_act_bf16, conv_bias_act_f16).
// Replaces, at compute_type=bfloat16 and =float16, the Pallas block
// `_conv_act_kernel` / `_fused_call` of cxxnet_tpu/ops/pallas_cnn.py:
// 103,149; conv_bias_act.cu holds the f32 build and states the function
// in full.
//
// What it computes: NHWC x (n, h, w, cin) and HWIO weight (kh, kw,
// cin/g, cout) of one 16-bit type, optional bias (cout) of that type,
// strides, top/left padding and `groups` as the f32 build; z = the
// convolution + bias in f32 (written only when `z` is non-null), y =
// relu(z) or z rounded to the 16-bit type once, to nearest even, as the
// Pallas block widens x and w to f32, dots with f32 results and writes y
// in the input's dtype (pallas_cnn.py:140-146, 171-174).  A product of two
// bf16 or two f16 values is exact in f32, so mma.sync's products with f32
// accumulators are JAX's; only the order of the sums differs.  f16's
// range ends at 65504: a larger y is written as inf, as JAX's astype
// writes it (nothing is clamped or rescaled), and f16's gradual underflow
// is kept (no flush-to-zero anywhere).
//
// What bounds it on an H100: the operations, except conv1.  AlexNet's
// conv2-conv5 at batch 256 do 38-115 GFLOP each on at most 0.13 GB:
// 0.04-0.12 ms each at the dense bf16 / f16 rate of 989 TFLOP/s.  conv1
// (cin 3, K 363) does 54 GFLOP on 0.23 GB: 0.068 ms of bytes at 3.35
// TB/s.
//
// Design: the implicit GEMM per group, M = n*oh*ow output pixels, N =
// cout/g channels, K = kh*kw*cin/g in (u, v, c) order (the row order of
// the HWIO weight viewed as a (K, cout) matrix), on gemm_bf16.cuh's
// tensor-core tile: a block of 2 x WN warps owns 128 pixels x 32 WN
// channels, each warp a 64 x 32 piece of mma.sync m16n8k16 fragments.
// WN (1 to 4) is the width that needs the fewest channel tiles for the
// least padding (conv1's 96 channels in one tile; GoogLeNet's 16 and 24
// in a 32-wide one): each tile copies the whole patch slice again, so a
// tile is reckoned at its width plus 64 channels; the 128-wide tile runs
// two blocks an SM (at most 128 registers a thread, no spill), the others
// two or more by their registers.  64-deep K slices (half the barriers
// and twice the bytes in flight of 32-deep ones) are staged by
// sgemm_pipe.cuh's three-stage cp.async ring; the im2col matrix
// never exists in device memory.  Each block decodes its 128 pixels once,
// into a table in shared memory (the offset of the pixel's top-left tap
// in x, and that tap's input position for the padding test), as the f32
// build does; a thread decodes its slice column's tap once a slice.  The
// patch slice (As[pixel][kk], rows of 72 elements) is copied
//   * where cin/g % 8 == 0 and x is 16-byte aligned (AlexNet conv2-conv5,
//     most of GoogLeNet), straight into shared memory by 16-byte
//     cp.async of 8-channel chunks, each inside one tap; taps in the
//     padding, the K tail and pixels past M are zero-filled by the copy
//     itself (src-size 0);
//   * otherwise (conv1's cin 3, an unaligned x), one column a thread, by
//     2-byte loads and stores, zero where the tap is outside, eight
//     loads issued before their stores.
// The weight slice (Bs[kk][channel], rows of 32 WN + 8) is copied in
// 8-channel chunks where cout and cout/g are multiples of 8 and w is
// 16-byte aligned, else 2 bytes at a time; the patch fragments come out
// of shared memory by ldmatrix, the weight's by ldmatrix.trans.  The
// epilogue adds the bias in f32, writes z in f32 when asked, applies
// relu, rounds y once and stores each lane's two neighbouring channels
// together where cout/g is even and the outputs aligned; ragged
// channels are masked.  No split-K, no atomics: two launches give
// bitwise-equal outputs.

#include "gemm_bf16.cuh"

struct CbGeom {
  long long M;                      // n * oh * ow
  int h, wd, cin, kw, cout, sy, sx, pad_t, pad_l, oh, ow;
  int cin_g, cout_g, K, relu;
  int bvec;                         // 16-byte weight copies
  int pair;                         // two channels a store of y, z, bias
};

constexpr int CB_BK = 64;                  // K a staged slice
constexpr int CB_LDA = CB_BK + 8;          // staged patch row: 144 bytes
constexpr int CB_SB = 8;                   // 2-byte loads in flight a thread

// The tile of WN warp columns: its channels, threads, staged weight row
// (a multiple of 16 bytes plus 16: ldmatrix's eight rows fall on eight
// bank groups), 16-bit elements a stage, and shared memory: the ring,
// then the pixel table (the top-left tap's offset, 8 bytes, and input position, 8 bytes,
// of each of the 128 rows).
template <int WN>
struct CbTile {
  static constexpr int BN = 32 * WN, THREADS = 64 * WN, LDB = BN + 8;
  static constexpr int STAGE = GM_BM * CB_LDA + CB_BK * LDB;
  static constexpr size_t SMEM = SP_STAGES * STAGE * 2 + GM_BM * 16;
};

// Stage K slice [k0, k0 + CB_BK) of the block's patch rows and its
// channels j0 .. j0 + BN of group g's weight columns.
template <int WN, bool CHUNK, class T16>
__device__ __forceinline__ void cb_stage(T16* As, T16* Bs,
                                         const T16* __restrict__ x,
                                         const T16* __restrict__ w,
                                         const CbGeom& p,
                                         const long long* rbase,
                                         const int2* rpos, int g, int j0,
                                         int k0) {
  using T = CbTile<WN>;
  const int t = threadIdx.x;
  if constexpr (CHUNK) {
    // chunk q (8 channels of one tap) of the slice, rows t / 8 +
    // (THREADS / 8) i; cin/g % 8 == 0, so a chunk never straddles a tap
    constexpr int Q = CB_BK / 8;
    const int q = t % Q, k = k0 + 8 * q;
    const bool kok = k < p.K;
    const int tap = kok ? k / p.cin_g : 0;
    const int c = k - tap * p.cin_g, u = tap / p.kw, v = tap - u * p.kw;
    const int off = (u * p.wd + v) * p.cin + c;
#pragma unroll
    for (int r = t / Q; r < GM_BM; r += T::THREADS / Q) {
      const int2 pos = rpos[r];
      const bool ok = kok && (unsigned)(pos.x + u) < (unsigned)p.h &&
                      (unsigned)(pos.y + v) < (unsigned)p.wd;
      gm_cp16(As + r * CB_LDA + 8 * q, ok ? x + rbase[r] + off : x, ok);
    }
  } else {
    // column kk of the slice, rows t / 64 + (THREADS / 64) i, CB_SB rows'
    // loads issued before their stores (a store to shared memory may
    // alias x as far as the compiler knows, so a load after it waits)
    const int kk = t % CB_BK, k = k0 + kk;
    int u = 0, v = 0, c = 0;
    const bool kok = k < p.K;
    if (kok) {
      const int tap = k / p.cin_g;
      c = k - tap * p.cin_g;
      u = tap / p.kw;
      v = tap - u * p.kw;
    }
    const int off = (u * p.wd + v) * p.cin + c;
    constexpr int RSTEP = T::THREADS / CB_BK;
    constexpr int NR = (GM_BM + RSTEP - 1) / RSTEP;    // rows a thread
    const int r0 = t / CB_BK;
#pragma unroll
    for (int i0 = 0; i0 < NR; i0 += CB_SB) {
      T16 val[CB_SB];
#pragma unroll
      for (int j = 0; j < CB_SB; ++j) {
        const int r = r0 + (i0 + j) * RSTEP;
        bool ok = false;
        if (i0 + j < NR && r < GM_BM) {
          const int2 pos = rpos[r];
          ok = kok && (unsigned)(pos.x + u) < (unsigned)p.h &&
               (unsigned)(pos.y + v) < (unsigned)p.wd;
        }
        val[j] = ok ? x[rbase[r] + off] : gm_0<T16>();
      }
#pragma unroll
      for (int j = 0; j < CB_SB; ++j) {
        const int r = r0 + (i0 + j) * RSTEP;
        if (i0 + j < NR && r < GM_BM) As[r * CB_LDA + kk] = val[j];
      }
    }
  }
  // the weight slice: rows k0 .. k0 + 63 of the (K, cout) matrix, columns
  // g * cout_g + j0 .. + BN
  const T16* wg = w + (long long)g * p.cout_g + j0;
  const int ncols = p.cout_g - j0;
  if (p.bvec) {
#pragma unroll
    for (int e = 0; e < CB_BK * T::BN / 8 / T::THREADS; ++e) {
      const int i = t + e * T::THREADS;
      const int r = i / (T::BN / 8), nc = (i % (T::BN / 8)) * 8;
      const bool ok = k0 + r < p.K && nc < ncols;
      gm_cp16(Bs + r * T::LDB + nc,
              ok ? wg + (long long)(k0 + r) * p.cout + nc : w, ok);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < CB_BK * T::BN / T::THREADS; ++e) {
      const int i = t + e * T::THREADS;
      const int r = i / T::BN, nc = i % T::BN;
      Bs[r * T::LDB + nc] = k0 + r < p.K && nc < ncols
                                ? wg[(long long)(k0 + r) * p.cout + nc]
                                : gm_0<T16>();
    }
  }
}

// a 16-bit element -> f32 (exact)
__device__ __forceinline__ float cb_f32(gm_bf16 h) {
  return __uint_as_float((uint32_t)h << 16);
}
__device__ __forceinline__ float cb_f32(gm_f16 h) { return __half2float(h); }

// v0 += bias[co], v1 += bias[co + 1], from one 4-byte load (co even,
// bias 4-byte aligned)
__device__ __forceinline__ void cb_bias2(const gm_bf16* bias, int co,
                                         float& v0, float& v1) {
  const uint32_t bb = *reinterpret_cast<const uint32_t*>(bias + co);
  v0 += __uint_as_float(bb << 16);
  v1 += __uint_as_float(bb & 0xffff0000u);
}
__device__ __forceinline__ void cb_bias2(const gm_f16* bias, int co,
                                         float& v0, float& v1) {
  const float2 bb =
      __half22float2(*reinterpret_cast<const __half2*>(bias + co));
  v0 += bb.x;
  v1 += bb.y;
}

// grid (pixel tiles, channel tiles, groups), 64 WN threads; T16 the
// 16-bit element type (gm_bf16 or gm_f16)
template <int WN, bool CHUNK, class T16>
__global__ void __launch_bounds__(64 * WN, WN == 4 ? 2 : 6 / WN)
conv_bias_act_bf16_kernel(const T16* __restrict__ x,
                          const T16* __restrict__ w,
                          const T16* __restrict__ bias,
                          T16* __restrict__ y, float* __restrict__ z,
                          const CbGeom p) {
  using T = CbTile<WN>;
  extern __shared__ __align__(16) float smem[];
  long long* rbase = reinterpret_cast<long long*>(
      smem + SP_STAGES * (T::STAGE / 2));
  int2* rpos = reinterpret_cast<int2*>(rbase + GM_BM);
  const int g = blockIdx.z, j0 = blockIdx.y * T::BN;
  const long long m0 = (long long)blockIdx.x * GM_BM;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int wr = (warp / WN) * 16 * GM_MT, wc = (warp % WN) * 8 * GM_NT;

  // decode the block's pixels once; a row past M fails every bounds test
  for (int r = t; r < GM_BM; r += T::THREADS) {
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

  float acc[GM_MT][GM_NT][4];
  gm_zero(acc);
  sp_mainloop(
      smem, T::STAGE / 2, (p.K + CB_BK - 1) / CB_BK,
      [&](float* st, int s) {
        T16* As = reinterpret_cast<T16*>(st);
        cb_stage<WN, CHUNK>(As, As + GM_BM * CB_LDA, x, w, p, rbase, rpos,
                            g, j0, s * CB_BK);
      },
      [&](const float* st) {
        const T16* As = reinterpret_cast<const T16*>(st);
        gm_slice_nn<CB_BK>(As, CB_LDA, As + GM_BM * CB_LDA, T::LDB, wr, wc,
                           lane, acc);
      });
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // none outlives

  // lane (gi, tq) holds rows gi and gi + 8 of each fragment, channels
  // 2 tq and 2 tq + 1
  const int gi = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < GM_MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = m0 + wr + 16 * i + 8 * hh + gi;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < GM_NT; ++j) {
        const int col = j0 + wc + 8 * j + 2 * tq;      // within the group
        if (col >= p.cout_g) continue;
        const int co = g * p.cout_g + col;
        const long long off = m * p.cout + co;
        float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        if (p.pair) {                  // cout/g even: both channels or none
          if (bias != nullptr) cb_bias2(bias, co, v0, v1);
          if (z != nullptr)
            *reinterpret_cast<float2*>(z + off) = make_float2(v0, v1);
          // NaN propagates like torch.relu / jnp.maximum
          if (p.relu && v0 < 0.f) v0 = 0.f;
          if (p.relu && v1 < 0.f) v1 = 0.f;
          gm_put2(y + off, v0, v1);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= p.cout_g) continue;
            const float s = (e ? v1 : v0) +
                            (bias != nullptr ? cb_f32(bias[co + e]) : 0.f);
            if (z != nullptr) z[off + e] = s;
            sp_put(y + off + e, (p.relu && s < 0.f) ? 0.f : s);
          }
        }
      }
    }
}

template <int WN, class T16>
static cudaError_t cb_launch(bool chunk, const T16* x, const T16* w,
                             const T16* bias, T16* y, float* z,
                             const CbGeom& p, int groups, cudaStream_t st) {
  using T = CbTile<WN>;
  auto kernel = chunk ? conv_bias_act_bf16_kernel<WN, true, T16>
                      : conv_bias_act_bf16_kernel<WN, false, T16>;
  // above 48 KB of shared memory only by opting in (the 96- and 128-wide
  // tiles)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(sp_ceil(p.M, GM_BM), sp_ceil(p.cout_g, T::BN), groups);
  kernel<<<grid, T::THREADS, T::SMEM, st>>>(x, w, bias, y, z, p);
  return cudaGetLastError();
}

// The warp columns of the tile (1 to 4, 32 channels each) that cover
// cout/g most cheaply, a channel tile reckoned at its width plus 64 (the
// patch slice it copies again); the narrower on a tie.
static int cb_width(int cout_g) {
  int best = 1;
  long long best_cost = -1;
  for (int wn = 1; wn <= 4; ++wn) {
    const long long cost =
        (long long)sp_ceil(cout_g, 32 * wn) * (32 * wn + 64);
    if (best_cost < 0 || cost < best_cost) {
      best = wn;
      best_cost = cost;
    }
  }
  return best;
}

static bool cb_aligned(const void* ptr, int bytes) {
  return ((uintptr_t)ptr % bytes) == 0;
}

// x, w, bias and y of T16, z f32 (may be null; so may bias).  16-byte
// patch copies where cin/g % 8 == 0 and x is 16-byte aligned; 16-byte
// weight copies where cout, cout/g % 8 == 0 and w is 16-byte aligned;
// paired stores where cout/g is even and y, bias 4-byte, z 8-byte aligned.
template <class T16>
static int cb_conv(const void* x, const void* w, const void* bias, void* y,
                   void* z, int n, int h, int wd, int cin, int kh, int kw,
                   int cout, int groups, int sy, int sx, int pad_t,
                   int pad_l, int oh, int ow, int relu, void* stream) {
  CbGeom p;
  p.M = (long long)n * oh * ow;
  p.h = h; p.wd = wd; p.cin = cin; p.kw = kw;
  p.cout = cout; p.sy = sy; p.sx = sx;
  p.pad_t = pad_t; p.pad_l = pad_l; p.oh = oh; p.ow = ow;
  p.cin_g = cin / groups;
  p.cout_g = cout / groups;
  p.K = kh * kw * p.cin_g;
  p.relu = relu;
  if (p.M <= 0 || p.cout_g <= 0) return 0;
  p.bvec = cout % 8 == 0 && p.cout_g % 8 == 0 && cb_aligned(w, 16);
  p.pair = p.cout_g % 2 == 0 && cb_aligned(y, 4) &&
           (z == nullptr || cb_aligned(z, 8)) &&
           (bias == nullptr || cb_aligned(bias, 4));
  const bool chunk = p.cin_g % 8 == 0 && cb_aligned(x, 16);
  const T16* xh = (const T16*)x;
  const T16* wh = (const T16*)w;
  const T16* bh = (const T16*)bias;
  T16* yh = (T16*)y;
  float* zf = (float*)z;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cb_width(p.cout_g)) {
    case 1: return (int)cb_launch<1>(chunk, xh, wh, bh, yh, zf, p, groups, st);
    case 2: return (int)cb_launch<2>(chunk, xh, wh, bh, yh, zf, p, groups, st);
    case 3: return (int)cb_launch<3>(chunk, xh, wh, bh, yh, zf, p, groups, st);
    default:
      return (int)cb_launch<4>(chunk, xh, wh, bh, yh, zf, p, groups, st);
  }
}

// the bf16 build: x, w, bias and y bf16
extern "C" int conv_bias_act_bf16(const void* x, const void* w,
                                  const void* bias, void* y, void* z, int n,
                                  int h, int wd, int cin, int kh, int kw,
                                  int cout, int groups, int sy, int sx,
                                  int pad_t, int pad_l, int oh, int ow,
                                  int relu, void* stream) {
  return cb_conv<gm_bf16>(x, w, bias, y, z, n, h, wd, cin, kh, kw, cout,
                          groups, sy, sx, pad_t, pad_l, oh, ow, relu,
                          stream);
}

// the f16 build: x, w, bias and y f16
extern "C" int conv_bias_act_f16(const void* x, const void* w,
                                 const void* bias, void* y, void* z, int n,
                                 int h, int wd, int cin, int kh, int kw,
                                 int cout, int groups, int sy, int sx,
                                 int pad_t, int pad_l, int oh, int ow,
                                 int relu, void* stream) {
  return cb_conv<gm_f16>(x, w, bias, y, z, n, h, wd, cin, kh, kw, cout,
                         groups, sy, sx, pad_t, pad_l, oh, ow, relu, stream);
}
