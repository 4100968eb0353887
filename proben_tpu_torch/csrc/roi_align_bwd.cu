// Multi-level RoIAlignV2 backward for Hopper (sm_90a): the VJP of the
// windowed forward (csrc/roi_align_fwd.cu). Per RoI r of level l, window
// origin (y0, x0) and cotangent g[r] (P, P, C):
//   u[y, q, c]              = sum_p wy[p, y] * g[p, q, c]
//   dF_l[y0 + y, x0 + x, c] += sum_q wx[q, x] * u[y, q, c]
//
// Replaces: proben_tpu/ops/roi_align_bwd_pallas.py::wholemap_grad_pallas
// (its Pallas kernel `_bwd_kernel`). It takes exactly what K2 takes (level
// index, window origin, wy (R, P, 56), wx (R, P, 64) from
// ops/roi_align.py::build_window_weights) plus the cotangent, so it is the
// exact VJP of K2; rows the forward re-pooled whole-map get a zero
// cotangent from autograd and their gradient flows through the plain
// whole-map path, as in the TPU kernel's tier structure. Rounding as both
// JAX backward paths: wy and wx rounded to the feature dtype, u summed in
// f32 and rounded to the feature dtype, the scatter accumulated in f32, the
// result rounded to the feature dtype. The TPU kernel's stacked-level
// canvas, y-sorted RoI blocks, visit enumeration and block-diagonal first
// dot exist for Mosaic's sequential grid and the MXU; none of that carries
// over.
//
// What bounds it on the H100: memory. At the training shape (8 x 512 RoIs,
// C = 256 bf16) the cotangent read is 103 MB and the bf16 dF write 279 MB;
// the multiply-adds the nonzero weights need are ~1 GFMA, far below any
// rate. Design, simple first: one CTA per RoI, one thread per channel, so
// every cotangent load and every accumulator update is a coalesced row of
// consecutive channels; each thread keeps its P x P cotangent values in
// registers; the RoI's weights live in shared memory, and the y and x loops
// walk only the union of the nonzero wy / wx spans. Overlapping RoIs add
// into one f32 accumulator with atomicAdd (as detectron2's own CUDA
// backward does), so the summation order, and the last bits of f32 sums,
// vary from run to run. A second kernel rounds the accumulator to the
// feature dtype. The f32 accumulator costs an extra zero-fill, read and
// write of 4 bytes per dF entry beyond the bound. A RoI with a non-finite
// weight (a NaN box) walks the whole window, as the plain version does, so
// both give NaN at the same positions. The level index is clipped and
// window positions outside the level map are skipped, so no input can make
// the kernel write out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WIN_Y = 56;
constexpr int WIN_X = 64;
constexpr int MAXP = 8;

struct Levels {
  float* acc[4];  // f32 accumulators, (B, H_l, W_l, C)
  void* out[4];   // results in the feature dtype, same shapes
  int h[4];
  int w[4];
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T>
__global__ void roi_align_bwd_kernel(Levels lv, int num_levels, int C,
                                     int rois_per_image,
                                     const int* __restrict__ lvl,
                                     const int* __restrict__ y0s,
                                     const int* __restrict__ x0s,
                                     const float* __restrict__ wy,
                                     const float* __restrict__ wx,
                                     const T* __restrict__ g, int P) {
  __shared__ float wy_s[MAXP][WIN_Y];
  __shared__ float wx_s[MAXP][WIN_X];
  __shared__ int ylo_s, yhi_s, xlo_s, xhi_s;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* wy_r = wy + static_cast<size_t>(r) * P * WIN_Y;
  const float* wx_r = wx + static_cast<size_t>(r) * P * WIN_X;
  int bad = 0;
  for (int i = tid; i < P * WIN_Y; i += blockDim.x) {
    const float v = wy_r[i];
    bad |= !isfinite(v);
    wy_s[i / WIN_Y][i % WIN_Y] = round_to<T>(v);
  }
  for (int i = tid; i < P * WIN_X; i += blockDim.x) {
    const float v = wx_r[i];
    bad |= !isfinite(v);
    wx_s[i / WIN_X][i % WIN_X] = round_to<T>(v);
  }
  bad = __syncthreads_or(bad);

  // the union of the nonzero spans (the whole window for a non-finite RoI)
  if (tid == 0) {
    int lo = bad ? 0 : WIN_Y, hi = bad ? WIN_Y - 1 : -1;
    for (int p = 0; p < P; ++p)
      for (int y = 0; y < WIN_Y; ++y)
        if (wy_s[p][y] != 0.f) { lo = min(lo, y); hi = max(hi, y); }
    ylo_s = lo;
    yhi_s = hi;
  } else if (tid == static_cast<int>(blockDim.x) - 1) {
    int lo = bad ? 0 : WIN_X, hi = bad ? WIN_X - 1 : -1;
    for (int q = 0; q < P; ++q)
      for (int x = 0; x < WIN_X; ++x)
        if (wx_s[q][x] != 0.f) { lo = min(lo, x); hi = max(hi, x); }
    xlo_s = lo;
    xhi_s = hi;
  }
  __syncthreads();

  const int l = min(max(lvl[r], 0), num_levels - 1);
  const int H = lv.h[l];
  const int W = lv.w[l];
  const int img = r / rois_per_image;
  float* acc = lv.acc[l] + static_cast<size_t>(img) * H * W * C;
  const int y0 = y0s[r];
  const int x0 = x0s[r];
  const int ylo = ylo_s, yhi = yhi_s, xlo = xlo_s, xhi = xhi_s;
  const T* g_r = g + static_cast<size_t>(r) * P * P * C;

  for (int c = tid; c < C; c += blockDim.x) {
    float gv[MAXP][MAXP];
#pragma unroll
    for (int p = 0; p < MAXP; ++p)
#pragma unroll
      for (int q = 0; q < MAXP; ++q)
        gv[p][q] = (p < P && q < P) ? to_f<T>(g_r[(static_cast<size_t>(p) * P + q) * C + c]) : 0.f;

    for (int y = ylo; y <= yhi; ++y) {
      const int gy = y0 + y;
      if (gy < 0 || gy >= H) continue;
      float u[MAXP];
#pragma unroll
      for (int q = 0; q < MAXP; ++q) u[q] = 0.f;
#pragma unroll
      for (int p = 0; p < MAXP; ++p) {
        if (p < P) {
          const float w = wy_s[p][y];
#pragma unroll
          for (int q = 0; q < MAXP; ++q) u[q] = fmaf(w, gv[p][q], u[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < MAXP; ++q) u[q] = round_to<T>(u[q]);
      float* row = acc + static_cast<size_t>(gy) * W * C + c;
      for (int x = xlo; x <= xhi; ++x) {
        const int gx = x0 + x;
        if (gx < 0 || gx >= W) continue;
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < MAXP; ++q)
          if (q < P) v = fmaf(wx_s[q][x], u[q], v);
        if (v != 0.f) atomicAdd(row + static_cast<size_t>(gx) * C, v);
      }
    }
  }
}

// second pass: round each level's f32 accumulator to the feature dtype
template <typename T>
__global__ void round_levels_kernel(Levels lv, int B, int C) {
  const int l = blockIdx.y;
  const size_t n = static_cast<size_t>(B) * lv.h[l] * lv.w[l] * C;
  const float* acc = lv.acc[l];
  T* out = static_cast<T*>(lv.out[l]);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[i] = from_f<T>(acc[i]);
}

template <typename T>
int launch(const void* g, const int* lvl, const int* y0, const int* x0,
           const float* wy, const float* wx, float* a0, float* a1, float* a2,
           float* a3, void* o0, void* o1, void* o2, void* o3, int h0, int h1,
           int h2, int h3, int w0, int w1, int w2, int w3, int num_levels,
           int B, int C, int rois_per_image, int R, int P, int threads,
           void* stream) {
  Levels lv{{a0, a1, a2, a3}, {o0, o1, o2, o3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    roi_align_bwd_kernel<T><<<R, threads, 0, s>>>(
        lv, num_levels, C, rois_per_image, lvl, y0, x0, wy, wx,
        static_cast<const T*>(g), P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  round_levels_kernel<T><<<dim3(1024, num_levels), 256, 0, s>>>(lv, B, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROI_ALIGN_BWD_ARGS                                                    \
  const void *g, const int *lvl, const int *y0, const int *x0,                \
      const float *wy, const float *wx, float *a0, float *a1, float *a2,      \
      float *a3, void *o0, void *o1, void *o2, void *o3, int h0, int h1,      \
      int h2, int h3, int w0, int w1, int w2, int w3, int num_levels, int B,  \
      int C, int rois_per_image, int R, int P, int threads, void *stream
#define ROI_ALIGN_BWD_PASS                                                    \
  g, lvl, y0, x0, wy, wx, a0, a1, a2, a3, o0, o1, o2, o3, h0, h1, h2, h3, w0, \
      w1, w2, w3, num_levels, B, C, rois_per_image, R, P, threads, stream

extern "C" int roi_align_bwd_bf16(ROI_ALIGN_BWD_ARGS) {
  return launch<__nv_bfloat16>(ROI_ALIGN_BWD_PASS);
}

extern "C" int roi_align_bwd_f32(ROI_ALIGN_BWD_ARGS) {
  return launch<float>(ROI_ALIGN_BWD_PASS);
}
