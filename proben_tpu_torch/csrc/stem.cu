// Fused ResNet stem for Hopper (sm_90a): 7x7 / stride-2 / pad-3 conv
// (C_in <= 8 -> 64) + folded-BN affine + ReLU + 3x3 / stride-2 / pad-1
// max-pool in one pass; only the pooled tensor is written.
//
// Replaces: proben_tpu/ops/stem_pallas.py::_stem_pool_impl (its Pallas
// kernel `_kernel`). Same function and rounding points: bf16 input and
// weights, f32 accumulation, conv output rounded to bf16, the affine in bf16
// (product rounded, then sum rounded), ReLU, max-pool. The TPU kernel's
// width-quad packing and lane shifts exist for Mosaic and are not carried
// over.
//
// What bounds it on the H100: at the main-path shape (8x800x1024x3 ->
// 8x200x256x64) the conv is 30.8 GFLOP against 39 MB read and 52 MB
// written: 0.031 ms on the bf16 tensor cores, 0.027 ms for the bytes, so
// operations. On the CUDA cores alone it could not beat ~0.46 ms.
//
// Design: the conv is an implicit GEMM on the tensor cores.
// - Regrouping (exact). Pad the input by 4 at the top and left and take
//   2x2 space-to-depth: X'[u, v, (dy, dx, c)] = x[2u+dy-4, 2v+dx-4, c]. With
//   one zero tap in front of the 7x7 kernel, the 7x7/s2 conv becomes a 4x4
//   stride-1 valid conv over X': stem(s, t) = sum_{a,b} X'[s+a, t+b] . w'[a, b]
//   with w'[a, b, (dy, dx, c)] = w[2a+dy-1, 2b+dx-1, c] (zero at index -1).
//   Channels c are padded to CP = 4 (C <= 4) or 8, so one tap is K = 4*CP =
//   16 or 32 deep and the GEMM has K = 256 or 512. The wrapper packs w' as
//   (64, K) rows (ops/stem_cuda.py::pack_stem_weights); the kernel builds
//   X' tiles in shared memory straight from x.
// - mma.sync.m16n8k16 (bf16 -> f32) fed by ldmatrix, not wgmma: for a fixed
//   tap (a, b) the A rows of 16 stem pixels are 16-byte slices of X' pixels
//   at arbitrary positions in the tile, and ldmatrix takes one address per
//   row, so any 16 stem pixels of the tile form an m16 tile and no im2col
//   buffer is needed. wgmma would need A in its canonical shared layout or
//   in registers (an im2col copy per tap). At K = 256 and N = 64 the GEMM
//   is short and the tile's halo, staging and pooling weigh as much as the
//   products, so the simpler instruction costs little here.
// - Tile: a CTA computes a 7 x 8 pooled tile = 15 x 17 = 255 stem pixels
//   (4.55 per pooled output; the halo alone needs 4) as exactly 16 m16
//   tiles, one pair per warp against all 8 n8 tiles (64 f32
//   accumulators): per k-step 6 ldmatrix.x4 feed 16 mma. Shared rows are
//   padded (X' pixel pitch 48 or 80 bytes, weight rows K+8) so the 8 rows of
//   every ldmatrix phase hit distinct banks.
// - Occupancy over tile size: at <= 128 registers and 88 KB of shared
//   memory (C <= 4) two CTAs share an SM, so one CTA's staging, epilogue and
//   pooling overlap the other's MMA. Measured on the H100, this took 37%
//   less time than an 8 x 16 tile (4.38 stem pixels per output, 149 KB,
//   one CTA per SM) and 7-23% less than 6 x 8, 8 x 8 and 4 x 16 tiles
//   (PERF.md; proben_tpu_torch/kernel_probe.py).
// - The CTA is persistent: it stages the packed weights once and walks the
//   tiles. Per tile: X' patch (18 x 20 pixels) from global memory, MMA,
//   epilogue (round to bf16, scale and bias with the plain version's
//   rounding, ReLU) into a bf16 stem tile in shared memory, then the 3x3/s2
//   max-pool from there with 16-byte loads and coalesced 16-byte stores.
//   Out-of-map stem positions hold 0, which is exact padding because the
//   post-ReLU values are >= 0 (and each pooling window holds one in-map
//   position).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OUT_C = 64;
constexpr int TILE_PH = 7;                    // pooled rows per tile
constexpr int TILE_PW = 8;                    // pooled cols per tile
constexpr int STEM_H = 2 * TILE_PH + 1;       // 15 stem rows
constexpr int STEM_W = 2 * TILE_PW + 1;       // 17 stem cols
constexpr int STEM_PIX = STEM_H * STEM_W;     // 255
constexpr int M_TILES = (STEM_PIX + 15) / 16; // 16: one pair per warp
constexpr int PATCH_H = STEM_H + 3;           // 18 X' rows (4x4 taps)
constexpr int PATCH_W = STEM_W + 3;           // 20 X' cols
constexpr int STEM_PITCH = OUT_C + 8;         // bf16 per stem pixel in shared memory
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(M_TILES == 2 * WARPS, "each warp takes one pair of m16 tiles");

template <int CP>
struct Cfg {
  static constexpr int KT = 4 * CP;          // K of one tap: (dy, dx, c)
  static constexpr int K = 16 * KT;          // 4 x 4 taps
  static constexpr int KSTEPS = K / 16;
  static constexpr int PP = KT + 8;          // X' pixel pitch (bf16)
  static constexpr int WP = K + 8;           // weight row pitch (bf16)
  static constexpr int W_ELEMS = OUT_C * WP;
  static constexpr int PATCH_ELEMS = PATCH_H * PATCH_W * PP;
  static constexpr int STEM_ELEMS = STEM_PIX * STEM_PITCH;
  static constexpr int SMEM = (W_ELEMS + PATCH_ELEMS + STEM_ELEMS) * 2 + 2 * OUT_C * 4;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// NaN-propagating max, as torch.max_pool2d
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// CP bf16 channels of one input pixel (zero outside the map and for c >= C)
template <int CP>
struct Pix {
  uint32_t w[CP / 2];
};

template <int CP>
__device__ __forceinline__ Pix<CP> load_pixel(const unsigned short* __restrict__ x, int n, int gy,
                                              int gx, int H, int W, int C, bool ok) {
  Pix<CP> px;
#pragma unroll
  for (int i = 0; i < CP / 2; ++i) px.w[i] = 0u;
  if (ok && gy >= 0 && gy < H && gx >= 0 && gx < W) {
    const unsigned short* p = x + ((static_cast<size_t>(n) * H + gy) * W + gx) * C;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      if (c < C) px.w[c >> 1] |= static_cast<uint32_t>(p[c]) << (16 * (c & 1));
  }
  return px;
}

template <int CP>
__device__ __forceinline__ void store_pixel(__nv_bfloat16* dst, const Pix<CP>& px) {
  if constexpr (CP == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(px.w[0], px.w[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(px.w[0], px.w[1], px.w[2], px.w[3]);
  }
}

// Conv of MT m16 tiles of the stem tile against all 64 outputs, then the
// epilogue into the bf16 stem tile.
template <int CP, int MT>
__device__ __forceinline__ void conv_mtiles(const int (&mts)[MT], const __nv_bfloat16* patch_s,
                                            uint32_t b_base, __nv_bfloat16* stem_s,
                                            const float* sc_s, const float* bi_s, int s0, int t0,
                                            int Hs, int Ws, int lane) {
  using G = Cfg<CP>;
  uint32_t a_base[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int p = min(mts[m] * 16 + (lane & 15), STEM_PIX - 1);  // rows past the tile: discarded
    const int sl = p / STEM_W;
    const int tl = p - sl * STEM_W;
    a_base[m] = smem_addr(patch_s + (sl * PATCH_W + tl) * G::PP + (lane >> 4) * 8);
  }
  float acc[MT][8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

#pragma unroll
  for (int ks = 0; ks < G::KSTEPS; ++ks) {
    constexpr int STEPS_PER_TAP = G::KT / 16;
    const int tap = ks / STEPS_PER_TAP;
    const int kin = (ks % STEPS_PER_TAP) * 16;
    const int a_off = (((tap >> 2) * PATCH_W + (tap & 3)) * G::PP + kin) * 2;  // bytes
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldsm_x4(af[m][0], af[m][1], af[m][2], af[m][3], a_base[m] + a_off);
    uint32_t bf[8][2];
#pragma unroll
    for (int np = 0; np < 4; ++np)
      ldsm_x4(bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0], bf[2 * np + 1][1],
              b_base + (np * 16 * G::WP + ks * 16) * 2);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16(acc[m][j], af[m], bf[j][0], bf[j][1]);
  }

  // accumulator (row g / g+8, cols 8j + 2t, +1) -> rounded, affine, ReLU
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mts[m] * 16 + g + 8 * h;
      if (p >= STEM_PIX) continue;
      const int sl = p / STEM_W;
      const int tl = p - sl * STEM_W;
      const int s = s0 + sl;
      const int t = t0 + tl;
      const bool inside = s >= 0 && s < Hs && t >= 0 && t < Ws;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(stem_s + p * STEM_PITCH);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * t4;
        float h0 = 0.f, h1 = 0.f;
        if (inside) {
          h0 = bf16_round(bf16_round(bf16_round(acc[m][j][2 * h]) * sc_s[n]) + bi_s[n]);
          h1 = bf16_round(bf16_round(bf16_round(acc[m][j][2 * h + 1]) * sc_s[n + 1]) + bi_s[n + 1]);
          h0 = h0 < 0.f ? 0.f : h0;  // ReLU, NaN passes through as torch.relu
          h1 = h1 < 0.f ? 0.f : h1;
        }
        dst[n >> 1] = __floats2bfloat162_rn(h0, h1);
      }
    }
  }
}

template <int CP>
__global__ void __launch_bounds__(THREADS, 2)
stem_pool_kernel(const unsigned short* __restrict__ x,      // (N, H, W, C) bf16 bits
                 const __nv_bfloat16* __restrict__ wpk,     // (64, K) packed w'
                 const __nv_bfloat16* __restrict__ scale,   // (64,)
                 const __nv_bfloat16* __restrict__ bias,    // (64,)
                 __nv_bfloat16* __restrict__ out,           // (N, Hp, Wp, 64)
                 int N, int H, int W, int C, int Hs, int Ws, int Hp, int Wp,
                 int tiles_h, int tiles_w) {
  using G = Cfg<CP>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* patch_s = w_s + G::W_ELEMS;
  __nv_bfloat16* stem_s = patch_s + G::PATCH_ELEMS;
  float* sc_s = reinterpret_cast<float*>(stem_s + G::STEM_ELEMS);
  float* bi_s = sc_s + OUT_C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // packed weights once per CTA, 16 bytes at a time, into pitched rows
  constexpr int CHUNKS = G::K / 8;
  for (int i = tid; i < OUT_C * CHUNKS; i += THREADS) {
    const int o = i / CHUNKS;
    const int k8 = i - o * CHUNKS;
    *reinterpret_cast<uint4*>(w_s + o * G::WP + k8 * 8) =
        *reinterpret_cast<const uint4*>(wpk + o * G::K + k8 * 8);
  }
  if (tid < OUT_C) {
    sc_s[tid] = __bfloat162float(scale[tid]);
    bi_s[tid] = __bfloat162float(bias[tid]);
  }
  // ldmatrix row of this lane in the B (n-major) operand
  const int bq = lane >> 3;
  const uint32_t b_base = smem_addr(w_s + ((bq >> 1) * 8 + (lane & 7)) * G::WP + (bq & 1) * 8);

  constexpr int PIN_W = 2 * PATCH_W;                 // 40 input cols of a patch
  constexpr int ITEMS = 2 * PATCH_H * PIN_W;         // 36 x 40 input pixels
  constexpr int PER = (ITEMS + THREADS - 1) / THREADS;

  const int per_image = tiles_h * tiles_w;
  const int tiles = N * per_image;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / per_image;
    const int rem = tile - n * per_image;
    const int ti = rem / tiles_w;
    const int i0 = ti * TILE_PH;                 // first pooled row
    const int j0 = (rem - ti * tiles_w) * TILE_PW;  // first pooled col
    const int s0 = 2 * i0 - 1;                   // first stem row
    const int t0 = 2 * j0 - 1;                   // first stem col
    const int in_r0 = 2 * s0 - 4;                // X' row s0 + u covers input rows 2(s0+u)-4+dy
    const int in_c0 = 2 * t0 - 4;

    // X' patch: loads first (all in flight), then the stores
    Pix<CP> px[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int it = tid + k * THREADS;
      const int ir = it / PIN_W;
      const int ic = it - ir * PIN_W;
      px[k] = load_pixel<CP>(x, n, in_r0 + ir, in_c0 + ic, H, W, C, it < ITEMS);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int it = tid + k * THREADS;
      if (it < ITEMS) {
        const int ir = it / PIN_W;
        const int ic = it - ir * PIN_W;
        store_pixel<CP>(patch_s + ((ir >> 1) * PATCH_W + (ic >> 1)) * G::PP +
                            ((ir & 1) * 2 + (ic & 1)) * CP,
                        px[k]);
      }
    }
    __syncthreads();  // patch (and, first time, weights) ready; last tile's pool done

    {
      const int mts[2] = {2 * warp, 2 * warp + 1};  // this warp's pair of m16 tiles
      conv_mtiles<CP, 2>(mts, patch_s, b_base, stem_s, sc_s, bi_s, s0, t0, Hs, Ws, lane);
    }
    __syncthreads();  // stem tile complete

    // 3x3 / stride-2 max-pool: 8 lanes per pooled pixel, 8 channels each
    for (int it = tid; it < TILE_PH * TILE_PW * 8; it += THREADS) {
      const int pix = it >> 3;
      const int c8 = it & 7;
      const int i = pix / TILE_PW;
      const int j = pix - i * TILE_PW;
      const int oi = i0 + i;
      const int oj = j0 + j;
      if (oi >= Hp || oj >= Wp) continue;
      float mx[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = -INFINITY;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              stem_s + ((2 * i + dr) * STEM_W + 2 * j + dc) * STEM_PITCH + c8 * 8);
          const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[e]));
            mx[2 * e] = max_nan(mx[2 * e], f.x);
            mx[2 * e + 1] = max_nan(mx[2 * e + 1], f.y);
          }
        }
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(mx[2 * e], mx[2 * e + 1]);
        o[e] = *reinterpret_cast<const uint32_t*>(&b2);
      }
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(n) * Hp + oi) * Wp + oj) * OUT_C +
                                c8 * 8) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int CP>
int launch(const void* x, const void* wpk, const void* scale, const void* bias, void* out, int N,
           int H, int W, int C, int Hs, int Ws, int Hp, int Wp, void* stream) {
  auto kernel = stem_pool_kernel<CP>;
  const int smem = Cfg<CP>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int tiles_h = (Hp + TILE_PH - 1) / TILE_PH;
  const int tiles_w = (Wp + TILE_PW - 1) / TILE_PW;
  const long long tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), N, H, W, C, Hs, Ws, Hp, Wp, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, C) bf16 with C <= 8; wpk the (64, 16 * 4 * CP) packed weights
// (CP = 4 for C <= 4, else 8); out (N, Hp, Wp, 64) bf16
extern "C" int stem_pool_bf16(const void* x, const void* wpk, const void* scale,
                              const void* bias, void* out, int N, int H, int W, int C, int Hs,
                              int Ws, int Hp, int Wp, void* stream) {
  if (C < 1 || C > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 4) return launch<4>(x, wpk, scale, bias, out, N, H, W, C, Hs, Ws, Hp, Wp, stream);
  return launch<8>(x, wpk, scale, bias, out, N, H, W, C, Hs, Ws, Hp, Wp, stream);
}
