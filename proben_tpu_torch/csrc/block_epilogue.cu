// K4: a ResNet bottleneck's conv epilogue for Hopper (sm_90a), forward and
// backward. Forward, per element of a bf16 map laid out as M rows (N*H*W)
// of C contiguous channels:
//   y = relu(bf16(bf16(x * s) + b))                       (no residual)
//   y = relu(bf16(bf16(bf16(x * s) + b) + r))             (identity residual)
//   y = relu(bf16(bf16(bf16(x * s) + b) + bf16(bf16(xr * sr) + br)))  (shortcut)
// with s, b, sr, br the per-channel f32 folded-FrozenBN parameters rounded
// to bf16. Backward, with gm = (y <= 0) ? 0 : g:
//   gx = bf16(gm * s), gs = sum bf16(gm * x), gb = sum gm,
//   gr = gm (identity, g's bits) or gxr = bf16(gm * sr), gsr = sum bf16(gm * xr) (shortcut),
// each sum over the M rows in f32, then rounded to bf16.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA's
// fusion. The port ran it as PyTorch's elementwise kernels (two casts, a
// mul and an add per affine, an add and three ReLUs per block, and the
// autograd chain behind them), which read and wrote every map several
// times, mostly through the generic (non-vectorised) broadcast path.
//
// Rounding: every step is rounded where eager PyTorch rounds it (each bf16
// op computes in f32 and rounds once), with __fmul_rn / __fadd_rn so nvcc
// contracts nothing into an FMA, so the forward and gx / gr / gxr are the
// composition's bits. ReLU is eager's clamp_min: a NaN passes unchanged,
// otherwise fmaxf(v, 0). The sums differ from autograd's only in their
// order (f32 partials per CTA, then a fixed-order sum), so they are
// deterministic and within one bf16 ulp of eager's.
//
// What bounds it on the H100: memory. Forward 4 bytes an element without a
// residual (read x, write y), 6 with one (read x and r or xr, write y);
// backward 8 (g, y, x, gx) to 12 (and xr, gxr). A handful of flops per
// element, far below the card's rate.
//
// Design: 16-byte accesses along C (8 channels a thread, C % 8 == 0). A
// CTA of 256 threads is blockDim.x channel vectors (up to 32, a warp spans
// up to 512 contiguous bytes of a row) by blockDim.y rows; each thread keeps
// its 8 channels' parameters (and, backward, its sums) in registers for the
// whole CTA. gridDim.y slices C; gridDim.x splits the M rows into equal
// contiguous stretches, one per CTA, sized by the caller to fill every SM
// once at the occupancy the kernel reaches, so large maps stream with
// several loads in flight a thread and small ones (the C4 head's RoI maps)
// still spread over the card. The backward reduces each CTA's sums over
// blockDim.y in shared memory in a fixed order into a (sums, gridDim.x, C)
// f32 scratch, and a second kernel adds those partials per channel in a
// fixed order and rounds them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdUnroll = 4;  // rows in flight per thread, forward
constexpr int kBwdUnroll = 2;  // backward: four maps a row, and the sums
constexpr int kSumGroups = 8;  // row groups of the partials' final sum

enum Mode { kPlain = 0, kIdentity = 1, kShortcut = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const __nv_bfloat16 (&b)[8]) {
  uint4 v;
  uint16_t* u = reinterpret_cast<uint16_t*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) u[j] = __bfloat16_as_ushort(b[j]);
  return v;
}

__device__ __forceinline__ float affine(float x, float s, float b) {
  return round_bf16(__fadd_rn(round_bf16(__fmul_rn(x, s)), b));
}

// eager ReLU (clamp_min(v, 0)): NaN unchanged, else max(v, 0)
__device__ __forceinline__ __nv_bfloat16 relu(__nv_bfloat16 v) {
  const float f = __bfloat162float(v);
  return isnan(f) ? v : __float2bfloat16_rn(fmaxf(f, 0.f));
}

__device__ __forceinline__ void load_params(const float* __restrict__ p, int c0, float (&out)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = round_bf16(p[c0 + j]);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
epilogue_fwd(const uint4* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const uint4* __restrict__ r,
             const float* __restrict__ rscale, const float* __restrict__ rbias,
             uint4* __restrict__ y, long long rows, int vecs, long long rows_per_cta) {
  const int v = blockIdx.y * blockDim.x + threadIdx.x;  // channel vector
  if (v >= vecs) return;
  float s[8], b[8], rs[8], rb[8];
  load_params(scale, v * 8, s);
  load_params(bias, v * 8, b);
  if (MODE == kShortcut) {
    load_params(rscale, v * 8, rs);
    load_params(rbias, v * 8, rb);
  }
  const long long begin = blockIdx.x * rows_per_cta;
  const long long end = min(begin + rows_per_cta, rows);
  const int step = blockDim.y;
  for (long long row = begin + threadIdx.y; row < end; row += kFwdUnroll * step) {
    uint4 xv[kFwdUnroll], rv[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const long long i = row + u * step;
      if (i < end) {
        xv[u] = x[i * vecs + v];
        if (MODE != kPlain) rv[u] = r[i * vecs + v];
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const long long i = row + u * step;
      if (i >= end) continue;
      float xf[8], rf[8];
      unpack(xv[u], xf);
      if (MODE != kPlain) unpack(rv[u], rf);
      __nv_bfloat16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float t = affine(xf[j], s[j], b[j]);
        if (MODE == kShortcut) rf[j] = affine(rf[j], rs[j], rb[j]);
        if (MODE != kPlain) t = __fadd_rn(t, rf[j]);
        o[j] = relu(__float2bfloat16_rn(t));
      }
      y[i * vecs + v] = pack(o);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
epilogue_bwd(const uint4* __restrict__ g, const uint4* __restrict__ y,
             const uint4* __restrict__ x, const float* __restrict__ scale,
             const uint4* __restrict__ xr, const float* __restrict__ rscale,
             uint4* __restrict__ gx, uint4* __restrict__ gr, float* __restrict__ partial,
             long long rows, int vecs, long long rows_per_cta) {
  constexpr int kSums = MODE == kShortcut ? 3 : 2;
  __shared__ float red[kThreads * 8];
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  float acc[kSums][8];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
  if (v < vecs) {
    float s[8], rs[8];
    load_params(scale, v * 8, s);
    if (MODE == kShortcut) load_params(rscale, v * 8, rs);
    const long long begin = blockIdx.x * rows_per_cta;
    const long long end = min(begin + rows_per_cta, rows);
    const int step = blockDim.y;
    for (long long row = begin + threadIdx.y; row < end; row += kBwdUnroll * step) {
      uint4 gv[kBwdUnroll], yv[kBwdUnroll], xv[kBwdUnroll], rv[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const long long i = row + u * step;
        if (i < end) {
          gv[u] = g[i * vecs + v];
          yv[u] = y[i * vecs + v];
          xv[u] = x[i * vecs + v];
          if (MODE == kShortcut) rv[u] = xr[i * vecs + v];
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const long long i = row + u * step;
        if (i >= end) continue;
        float gf[8], yf[8], xf[8], rf[8];
        const uint16_t* gbits = reinterpret_cast<const uint16_t*>(&gv[u]);
        unpack(gv[u], gf);
        unpack(yv[u], yf);
        unpack(xv[u], xf);
        if (MODE == kShortcut) unpack(rv[u], rf);
        __nv_bfloat16 ox[8], orr[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float gm = yf[j] <= 0.f ? 0.f : gf[j];  // threshold_backward: NaN y passes g
          ox[j] = __float2bfloat16_rn(__fmul_rn(gm, s[j]));
          acc[0][j] = __fadd_rn(acc[0][j], round_bf16(__fmul_rn(gm, xf[j])));
          acc[1][j] = __fadd_rn(acc[1][j], gm);
          // the residual's gradient is g's own bits where y > 0 (a NaN's payload too)
          if (MODE == kIdentity) orr[j] = __ushort_as_bfloat16(yf[j] <= 0.f ? 0 : gbits[j]);
          if (MODE == kShortcut) {
            orr[j] = __float2bfloat16_rn(__fmul_rn(gm, rs[j]));
            acc[kSums - 1][j] = __fadd_rn(acc[kSums - 1][j], round_bf16(__fmul_rn(gm, rf[j])));
          }
        }
        gx[i * vecs + v] = pack(ox);
        if (MODE != kPlain) gr[i * vecs + v] = pack(orr);
      }
    }
  }
  // the CTA's sums over its rows: thread (tx, ty) holds channels 8 tx .. 8 tx + 7
  // of the slice; add the blockDim.y rows of each channel in order
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int width = blockDim.x * 8;
  const int c0 = blockIdx.y * width;
  const int channels = vecs * 8;
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[tid * 8 + j] = acc[k][j];
    __syncthreads();
    for (int e = tid; e < width; e += kThreads) {
      float t = 0.f;
      for (int ty = 0; ty < blockDim.y; ++ty) t = __fadd_rn(t, red[ty * width + e]);
      if (c0 + e < channels) partial[((long long)k * gridDim.x + blockIdx.x) * channels + c0 + e] = t;
    }
    __syncthreads();
  }
}

// out_k[c] = bf16(sum_p partial[k, p, c]) for the sums k = blockIdx.y, the
// parts p in kSumGroups contiguous groups added in order; dup (if set) gets
// a copy of the second sum (the shortcut's bias gradient equals the block's)
__global__ void __launch_bounds__(kThreads)
epilogue_bwd_sum(const float* __restrict__ partial, int parts, int channels,
                 float* __restrict__ out0, float* __restrict__ out1, float* __restrict__ out2,
                 float* __restrict__ dup) {
  __shared__ float red[kSumGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int k = blockIdx.y;
  float t = 0.f;
  if (c < channels) {
    const float* p = partial + (long long)k * parts * channels + c;
    const int lo = grp * parts / kSumGroups, hi = (grp + 1) * parts / kSumGroups;
    for (int i = lo; i < hi; ++i) t = __fadd_rn(t, p[(long long)i * channels]);
  }
  red[grp][lane] = t;
  __syncthreads();
  if (grp != 0 || c >= channels) return;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kSumGroups; ++i) total = __fadd_rn(total, red[i][lane]);
  const float v = round_bf16(total);
  float* out = k == 0 ? out0 : (k == 1 ? out1 : out2);
  out[c] = v;
  if (k == 1 && dup != nullptr) dup[c] = v;
}

template <int MODE>
int fwd(const void* x, const void* scale, const void* bias, const void* r, const void* rscale,
        const void* rbias, void* y, long long rows, int channels, int tx, int ty, int grid_x,
        int grid_y, long long rows_per_cta, cudaStream_t stream) {
  epilogue_fwd<MODE><<<dim3(grid_x, grid_y), dim3(tx, ty), 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const uint4*>(r),
      static_cast<const float*>(rscale), static_cast<const float*>(rbias), static_cast<uint4*>(y),
      rows, channels / 8, rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int bwd(const void* g, const void* y, const void* x, const void* scale, const void* xr,
        const void* rscale, void* gx, void* gr, void* partial, void* out0, void* out1, void* out2,
        void* dup, long long rows, int channels, int tx, int ty, int grid_x, int grid_y,
        long long rows_per_cta, cudaStream_t stream) {
  epilogue_bwd<MODE><<<dim3(grid_x, grid_y), dim3(tx, ty), 0, stream>>>(
      static_cast<const uint4*>(g), static_cast<const uint4*>(y), static_cast<const uint4*>(x),
      static_cast<const float*>(scale), static_cast<const uint4*>(xr),
      static_cast<const float*>(rscale), static_cast<uint4*>(gx), static_cast<uint4*>(gr),
      static_cast<float*>(partial), rows, channels / 8, rows_per_cta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sums = MODE == kShortcut ? 3 : 2;
  epilogue_bwd_sum<<<dim3((channels + 31) / 32, sums), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), grid_x, channels, static_cast<float*>(out0),
      static_cast<float*>(out1), static_cast<float*>(out2), static_cast<float*>(dup));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int blocks_per_sm(K kernel, int* out) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, 0));
}

}  // namespace

// CTAs of 256 threads each kernel keeps resident on one SM (the caller sizes
// the grid from it): bwd 0 the forward, 1 the backward, of mode 0..2
extern "C" int block_epilogue_occupancy(int bwd_kernel, int mode, int* out) {
  if (mode < kPlain || mode > kShortcut) return static_cast<int>(cudaErrorInvalidValue);
  if (!bwd_kernel) {
    if (mode == kPlain) return blocks_per_sm(epilogue_fwd<kPlain>, out);
    if (mode == kIdentity) return blocks_per_sm(epilogue_fwd<kIdentity>, out);
    return blocks_per_sm(epilogue_fwd<kShortcut>, out);
  }
  if (mode == kPlain) return blocks_per_sm(epilogue_bwd<kPlain>, out);
  if (mode == kIdentity) return blocks_per_sm(epilogue_bwd<kIdentity>, out);
  return blocks_per_sm(epilogue_bwd<kShortcut>, out);
}

extern "C" int block_epilogue_fwd_bf16(const void* x, const void* scale, const void* bias,
                                       const void* r, const void* rscale, const void* rbias,
                                       void* y, long long rows, int channels, int mode, int tx,
                                       int ty, int grid_x, int grid_y, long long rows_per_cta,
                                       void* stream) {
  if (channels % 8 != 0 || tx * ty != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kPlain)
    return fwd<kPlain>(x, scale, bias, r, rscale, rbias, y, rows, channels, tx, ty, grid_x,
                       grid_y, rows_per_cta, s);
  if (mode == kIdentity)
    return fwd<kIdentity>(x, scale, bias, r, rscale, rbias, y, rows, channels, tx, ty, grid_x,
                          grid_y, rows_per_cta, s);
  if (mode == kShortcut)
    return fwd<kShortcut>(x, scale, bias, r, rscale, rbias, y, rows, channels, tx, ty, grid_x,
                          grid_y, rows_per_cta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int block_epilogue_bwd_bf16(const void* g, const void* y, const void* x,
                                       const void* scale, const void* xr, const void* rscale,
                                       void* gx, void* gr, void* partial, void* out0, void* out1,
                                       void* out2, void* dup, long long rows, int channels,
                                       int mode, int tx, int ty, int grid_x, int grid_y,
                                       long long rows_per_cta, void* stream) {
  if (channels % 8 != 0 || tx * ty != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kPlain)
    return bwd<kPlain>(g, y, x, scale, xr, rscale, gx, gr, partial, out0, out1, out2, dup, rows,
                       channels, tx, ty, grid_x, grid_y, rows_per_cta, s);
  if (mode == kIdentity)
    return bwd<kIdentity>(g, y, x, scale, xr, rscale, gx, gr, partial, out0, out1, out2, dup,
                          rows, channels, tx, ty, grid_x, grid_y, rows_per_cta, s);
  if (mode == kShortcut)
    return bwd<kShortcut>(g, y, x, scale, xr, rscale, gx, gr, partial, out0, out1, out2, dup,
                          rows, channels, tx, ty, grid_x, grid_y, rows_per_cta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
