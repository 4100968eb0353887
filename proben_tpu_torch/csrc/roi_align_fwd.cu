// Multi-level RoIAlignV2 forward for Hopper (sm_90a): per RoI,
//   out[p, q, c] = sum_x wx[q, x] * sum_y wy[p, y] * F_l[y0 + y, x0 + x, c]
// over a (56, 64) window of the RoI's FPN level l at origin (y0, x0).
//
// Replaces: proben_tpu/ops/roi_align_pallas.py::multilevel_roi_align_pallas
// (its Pallas kernel `_kernel`). It consumes what
// ops/roi_align.py::build_window_weights produces (level index, window
// origin, wy (R, P, 56), wx (R, P, 64)), so it and its plain version
// (pool_from_windows over gathered windows) have identical inputs. Rounding
// as the TPU kernel: wy rounded to the feature dtype, the y sum and the x
// pass in f32, wx kept f32, the result rounded to the feature dtype. The
// TPU kernel's DMA size classes, duplicate-window sort and slot rotation
// exist for Mosaic's sequential grid and are not carried over: each RoI
// writes its own output row, so callers need no permutation.
//
// What bounds it on the H100: memory. At the main-path shape (8 x 1000 RoIs,
// C = 256 bf16) the output alone is 201 MB; the sampled window pixels add a
// data-dependent amount (each RoI reads ~7 x 15 pixels of 512 bytes at
// typical spans), while the arithmetic is ~0.9 GFMA, far below the card's
// rate.
//
// Design: one CTA per RoI with one warp per output row p (P warps), so a
// CTA holds P independent row computations and the SM many RoIs at once.
// - Two instances by the largest P they take (MAXP): 8 (the FPN pooler's
//   P = 7, two CTAs per SM) and 14 (the C4 pooler's P = 14, one CTA of 14
//   warps per SM). A warp keeps the sums of at most 8 outputs q in
//   registers (acc[QB][V], 8 x 8 floats at 16-byte lanes), so at MAXP = 14
//   it runs its q in two blocks of 7, each over the union of its own wx
//   spans; the blocks share at most a boundary column, which is read twice.
// - Wide accesses: each lane owns 16 bytes of channels (8 bf16 or 4 f32),
//   so one warp covers C = 256 bf16 with one 512-byte load or store; a
//   scalar path (one channel per lane) takes any other C.
// - Setup: the RoI's wy and wx rows are staged in shared memory with float4
//   loads by the whole CTA; each warp finds the nonzero span of its wy row
//   and of every wx row with two __ballot_sync each.
// - Work: the y pass walks the row's wy span at each column of the union
//   of the wx spans; the x pass adds a column only into the outputs q whose
//   wx span holds it (one or two of the P), instead of P FMAs per column.
// - Reads: warp p reads only the rows of its own wy span, each pixel of
//   its window band once; neighbouring rows share at most their boundary
//   samples, which the CTA's other warps read at the same time (L1).
// - In flight: the x loop runs two columns at a time, so every y step
//   issues two independent 16-byte loads, and the y sums of the two columns
//   are separate FMA chains.
// - Positions outside the level map read as zero, exactly as the plain
//   version's zero-padded windows, and the level index is clipped, so no
//   input can make it read out of bounds, and NaN/Inf weights give the
//   plain version's NaN rows.
//
// Measured on the H100 (PERF.md; proben_tpu_torch/kernel_probe.py):
// ~4x the byte bound. Setup is 4-6% of the time; the output stores alone
// reach about half the rate of a plain zero-fill of the same tensor, and
// without feature loads the kernel still takes ~57% of its time (the y
// pass unpacks and multiplies every channel of every 16-byte load). Wider
// column groups (more registers, fewer warps) and single columns (less in
// flight) are both slower, and so were persistent CTAs that prefetch the
// next RoI's weights: the prefetch costs registers (hence warps), and a
// fixed RoI order loses the hardware's balancing of short CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN_Y = 56;
constexpr int WIN_X = 64;
constexpr int UX = 2;  // window columns per x step

struct Levels {
  const void* ptr[4];
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

// V channels from p into f (V = 1, or 16 bytes: 8 bf16 / 4 f32)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f<T>(*p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        f[2 * e] = t.x;
        f[2 * e + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(w[e]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(f[0]);
  } else {
    uint32_t w[4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&b);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = __float_as_uint(f[e]);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// [lo, hi] of the set bits of (m0 | m1 << 32); lo > hi when empty
__device__ __forceinline__ void nonzero_span(unsigned m0, unsigned m1, int empty_lo, int& lo, int& hi) {
  lo = m0 ? __ffs(m0) - 1 : (m1 ? 31 + __ffs(m1) : empty_lo);
  hi = m1 ? 63 - __clz(m1) : (m0 ? 31 - __clz(m0) : -1);
}

template <typename T, int V, int MAXP>
__global__ void __launch_bounds__(MAXP * 32, MAXP <= 8 ? 2 : 1)
roi_align_fwd_kernel(Levels lv, int num_levels, int C, int rois_per_image,
                     const int* __restrict__ lvl, const int* __restrict__ y0s,
                     const int* __restrict__ x0s, const float* __restrict__ wy,
                     const float* __restrict__ wx, T* __restrict__ out, int P) {
  // outputs q per block of register sums, and blocks per row
  constexpr int QB = MAXP <= 8 ? MAXP : (MAXP + 1) / 2;
  constexpr int NQB = (MAXP + QB - 1) / QB;
  __shared__ __align__(16) float wy_s[MAXP * WIN_Y];
  __shared__ __align__(16) float wx_s[MAXP * WIN_X];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = tid >> 5;  // this warp's output row
  // the RoI's level and origin, loaded alongside its weights
  const int l = min(max(lvl[r], 0), num_levels - 1);
  const int y0 = y0s[r];
  const int x0 = x0s[r];
  {
    const float* wy_r = wy + static_cast<size_t>(r) * P * WIN_Y;
    const float* wx_r = wx + static_cast<size_t>(r) * P * WIN_X;
    // rows are 16-byte multiples; the base is aligned for any fresh tensor
    if ((reinterpret_cast<uintptr_t>(wy) | reinterpret_cast<uintptr_t>(wx)) % 16 == 0) {
      for (int i = tid; i < P * WIN_Y / 4; i += blockDim.x) {
        const float4 v = reinterpret_cast<const float4*>(wy_r)[i];  // rounded to the feature dtype
        reinterpret_cast<float4*>(wy_s)[i] =
            make_float4(to_f<T>(from_f<T>(v.x)), to_f<T>(from_f<T>(v.y)),
                        to_f<T>(from_f<T>(v.z)), to_f<T>(from_f<T>(v.w)));
      }
      for (int i = tid; i < P * WIN_X / 4; i += blockDim.x)
        reinterpret_cast<float4*>(wx_s)[i] = reinterpret_cast<const float4*>(wx_r)[i];
    } else {
      for (int i = tid; i < P * WIN_Y; i += blockDim.x) wy_s[i] = to_f<T>(from_f<T>(wy_r[i]));
      for (int i = tid; i < P * WIN_X; i += blockDim.x) wx_s[i] = wx_r[i];
    }
  }
  __syncthreads();

  // nonzero spans (NaN counts as nonzero): this row's wy, each wx row and
  // their union. A row whose wy holds a non-finite value takes the union for
  // every q, since 0 * NaN is NaN in the plain version's dense sum.
  const float* wyp = wy_s + p * WIN_Y;
  const bool in1 = lane + 32 < WIN_Y;
  int ylo, yhi;
  nonzero_span(__ballot_sync(0xffffffffu, wyp[lane] != 0.f),
               __ballot_sync(0xffffffffu, in1 && wyp[lane + 32] != 0.f), WIN_Y, ylo, yhi);
  const bool wy_finite =
      __all_sync(0xffffffffu, isfinite(wyp[lane]) && (!in1 || isfinite(wyp[lane + 32])));
  int qlo[MAXP], qhi[MAXP];
  int ulo = WIN_X, uhi = -1;
#pragma unroll
  for (int q = 0; q < MAXP; ++q) {
    qlo[q] = WIN_X;
    qhi[q] = -1;
    if (q < P) {
      nonzero_span(__ballot_sync(0xffffffffu, wx_s[q * WIN_X + lane] != 0.f),
                   __ballot_sync(0xffffffffu, wx_s[q * WIN_X + lane + 32] != 0.f), WIN_X,
                   qlo[q], qhi[q]);
      ulo = min(ulo, qlo[q]);
      uhi = max(uhi, qhi[q]);
    }
  }
  if (!wy_finite) {
#pragma unroll
    for (int q = 0; q < MAXP; ++q) {
      qlo[q] = ulo;
      qhi[q] = uhi;
    }
  }
  int blo[NQB], bhi[NQB];  // the union of each q block's spans (one block: the union)
  if constexpr (NQB == 1) {
    blo[0] = ulo;
    bhi[0] = uhi;
  } else {
#pragma unroll
    for (int qb = 0; qb < NQB; ++qb) {
      blo[qb] = WIN_X;
      bhi[qb] = -1;
#pragma unroll
      for (int q = qb * QB; q < (qb + 1) * QB && q < MAXP; ++q) {
        blo[qb] = min(blo[qb], qlo[q]);
        bhi[qb] = max(bhi[qb], qhi[q]);
      }
    }
  }

  const int H = lv.h[l];
  const int W = lv.w[l];
  const T* f = static_cast<const T*>(lv.ptr[l]) + static_cast<size_t>(r / rois_per_image) * H * W * C;
  T* out_p = out + (static_cast<size_t>(r) * P + p) * P * C;
  for (int ch = lane * V; ch < C; ch += 32 * V) {
#pragma unroll
    for (int qb = 0; qb < NQB; ++qb) {
      const int q0 = qb * QB;
      const int xlo = blo[qb], xhi = bhi[qb];
      float acc[QB][V];
#pragma unroll
      for (int q = 0; q < QB; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][e] = 0.f;

      for (int xb = xlo; xb <= xhi; xb += UX) {
        float t[UX][V];
#pragma unroll
        for (int u = 0; u < UX; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) t[u][e] = 0.f;
        bool col_ok[UX];
#pragma unroll
        for (int u = 0; u < UX; ++u) {
          const int gx = x0 + xb + u;
          col_ok[u] = xb + u <= xhi && gx >= 0 && gx < W;
        }
#pragma unroll 2
        for (int y = ylo; y <= yhi; ++y) {
          const int gy = y0 + y;
          const bool row_ok = gy >= 0 && gy < H;
          const float w = wyp[y];
          const T* row = f + (static_cast<long long>(gy) * W + x0 + xb) * C + ch;
#pragma unroll
          for (int u = 0; u < UX; ++u) {
            float v[V];
            if (row_ok && col_ok[u]) {
              load_vec<T, V>(row + u * C, v);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) v[e] = 0.f;  // zero padding, as the plain version
            }
#pragma unroll
            for (int e = 0; e < V; ++e) t[u][e] = fmaf(w, v[e], t[u][e]);
          }
        }
#pragma unroll
        for (int u = 0; u < UX; ++u) {
          const int x = xb + u;
          if (x > xhi) break;
#pragma unroll
          for (int q = 0; q < QB; ++q) {
            const int qq = q0 + q;  // wx[qq, x] is 0 outside [qlo, qhi]
            if (qq < P && x >= qlo[q0 + q] && x <= qhi[q0 + q]) {
              const float wq = wx_s[qq * WIN_X + x];
#pragma unroll
              for (int e = 0; e < V; ++e) acc[q][e] = fmaf(wq, t[u][e], acc[q][e]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < QB; ++q)
        if (q0 + q < P) store_vec<T, V>(out_p + static_cast<size_t>(q0 + q) * C + ch, acc[q]);
    }
  }
}

template <typename T>
int launch(const void* f0, const void* f1, const void* f2, const void* f3,
           int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
           int num_levels, int C, int rois_per_image, const int* lvl,
           const int* y0, const int* x0, const float* wy, const float* wx,
           void* out, int R, int P, void* stream) {
  if (P < 1 || P > 14 || num_levels < 1 || num_levels > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  constexpr int V = 16 / sizeof(T);
  bool vec = C % V == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = 0; i < num_levels; ++i) vec = vec && reinterpret_cast<uintptr_t>(lv.ptr[i]) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* o = static_cast<T*>(out);
  if (P <= 8) {
    if (vec)
      roi_align_fwd_kernel<T, V, 8><<<R, 32 * P, 0, s>>>(lv, num_levels, C, rois_per_image, lvl,
                                                         y0, x0, wy, wx, o, P);
    else
      roi_align_fwd_kernel<T, 1, 8><<<R, 32 * P, 0, s>>>(lv, num_levels, C, rois_per_image, lvl,
                                                         y0, x0, wy, wx, o, P);
  } else {
    if (vec)
      roi_align_fwd_kernel<T, V, 14><<<R, 32 * P, 0, s>>>(lv, num_levels, C, rois_per_image, lvl,
                                                          y0, x0, wy, wx, o, P);
    else
      roi_align_fwd_kernel<T, 1, 14><<<R, 32 * P, 0, s>>>(lv, num_levels, C, rois_per_image, lvl,
                                                          y0, x0, wy, wx, o, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROI_ALIGN_ARGS                                                        \
  const void *f0, const void *f1, const void *f2, const void *f3, int h0,     \
      int h1, int h2, int h3, int w0, int w1, int w2, int w3, int num_levels, \
      int C, int rois_per_image, const int *lvl, const int *y0,               \
      const int *x0, const float *wy, const float *wx, void *out, int R,      \
      int P, void *stream
#define ROI_ALIGN_PASS                                                         \
  f0, f1, f2, f3, h0, h1, h2, h3, w0, w1, w2, w3, num_levels, C,               \
      rois_per_image, lvl, y0, x0, wy, wx, out, R, P, stream

extern "C" int roi_align_fwd_bf16(ROI_ALIGN_ARGS) {
  return launch<__nv_bfloat16>(ROI_ALIGN_PASS);
}

extern "C" int roi_align_fwd_f32(ROI_ALIGN_ARGS) {
  return launch<float>(ROI_ALIGN_PASS);
}
