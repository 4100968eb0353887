// Multi-level RoIAlignV2 backward for Hopper (sm_90a): the VJP of the
// windowed forward (csrc/roi_align_fwd.cu). Per RoI r of level l, window
// origin (y0, x0) and cotangent g[r] (P, P, C):
//   u[y, q, c]              = round_T(sum_p wy[p, y] * g[p, q, c])
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
// f32 and rounded to the feature dtype, dF summed in f32 and rounded once.
// What carries over from the TPU kernel: the accumulator stays on chip,
// each output tile is visited once, and a matrix product takes two RoIs
// block-diagonally (the MMA's k of 16 would otherwise hold P = 7 weights).
// Its stacked-level canvas and y-sorted visit enumeration exist for
// Mosaic's sequential grid and do not.
//
// What bounds it on the H100: memory. At the training shape (8 x 512 RoIs,
// C = 256 bf16) the bf16 dF write is 279 MB and the cotangent read 103 MB;
// the multiply-adds the nonzero weights need are ~0.5 GFMA. A scatter design
// (one CTA per RoI adding into dF, this kernel's first form) needs an f32
// accumulator in device memory: its zero-fill, atomics and rounding pass
// alone move ~3.5x the bound's bytes, and atomics fix no summation order.
//
// Design: output-stationary, three passes in one entry point.
// 1. Spans: one warp per RoI finds the nonzero spans of its rounded wy and
//    wx with __ballot_sync, moves them to the level's coordinates and clips
//    them to the true map (window positions in the padding are dropped, as
//    the plain version cuts each level to its true size). A RoI with any
//    non-finite weight takes its whole window, since 0 * NaN is NaN in the
//    plain version's dense sums. It also writes the rounded weights
//    transposed, 8 per window row and column, so that a tile later copies
//    a row's or a column's weights as two 16-byte lanes.
// 2. Lists: one CTA per TILE_Y x TILE_X tile of a level's true map lists
//    the RoIs of its image whose spans touch the tile, in RoI order
//    (ballot + popc prefix), once for all of the tile's channel chunks.
// 3. Tiles: one CTA per (tile, chunk of channels); the chunk is the
//    fastest grid index, so the CTAs of a tile run together.
//    - Steps of NB listed RoIs: cp.async copies their cotangent chunks and
//      the tile's rows and columns of their weights into shared memory,
//      one step ahead of the arithmetic. u of the tile's rows is formed in
//      f32 and rounded; then wx^T u is added into the tile's f32
//      accumulators, in registers, in list order.
//    - bf16 runs both products on the tensor cores (mma.sync m16n8k16, bf16
//      in, f32 out; the weights are bf16 values already), two RoIs per MMA
//      block-diagonally, as the TPU kernel's first dot pairs RoIs: u takes
//      rows 0-7 and k 0-7 for one RoI, rows 8-15 and k 8-15 for the other;
//      wx^T u puts one RoI's q in k 0-7, the other's in k 8-15, one warp
//      per tile row. A pair with a non-finite RoI goes one RoI per MMA, its
//      sum added only where the RoI reaches (0 * NaN must not leak into
//      columns outside its span). f32 and the scalar path use FMAs and skip
//      zero weights (never for a non-finite RoI).
//    - Store: round once, write every pixel of the tile (zeros where no RoI
//      reaches) as whole 16-byte lanes.
//    - Output sizes: two instances by the largest P they take (MAXP), 8 (the
//      FPN pooler's P = 7) and 16 (the C4 pooler's P = 14). At MAXP = 16 a
//      RoI fills the MMA's k = 16 alone, so a step takes one RoI (NB = 1)
//      and each product runs one RoI per MMA, with 16 weight slots per
//      window row and column (zeros past P) in the transposed scratch.
//    Every dF element is written exactly once and summed in a fixed order:
//    no f32 buffer, zero-fill, atomics or rounding pass, and the result is
//    the same from run to run. The level index is clipped and the spans are
//    clipped to the true map, so no input can make the kernel write out of
//    bounds.
//
// Measured (PERF.md; proben_tpu_torch/kernel_probe.py): ~3.7x the byte
// bound. Spans, lists and the stores of every tile (empty ones included)
// take ~30% of the time; the rest goes to the listed RoIs, ~1.3 us each for
// a CTA at three CTAs per SM: the two products, the copies and the steps'
// barriers in about equal parts. FMAs instead of the tensor cores cost
// ~60% more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN_Y = 56;
constexpr int WIN_X = 64;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// a CTA's output tile: TILE_Y x TILE_X pixels and CHUNK_BYTES of channels
// (64 bf16 or 32 f32) on the 16-byte path, SCALAR_CHUNK channels otherwise
constexpr int TILE_Y = 8;
constexpr int TILE_X = 16;
constexpr int CHUNK_BYTES = 128;
constexpr int SCALAR_CHUNK = 8;
constexpr int NB = 2;           // listed RoIs per step at MAXP = 8 (the MMA path pairs them)
constexpr int CTAS_PER_SM = 3;  // the tile kernel's launch bound
// listed RoIs per step, and the transposed weights per RoI, for MAXP
template <int MAXP> __host__ __device__ constexpr int steps_rois() { return MAXP == 8 ? NB : 1; }
template <int MAXP> __host__ __device__ constexpr int wt_stride() { return (WIN_Y + WIN_X) * MAXP; }

struct Levels {
  void* out[4];      // dF per level, (B, H_l, W_l, C) in the feature dtype
  int h[4];
  int w[4];
  int tiles_x[4];    // tiles per row of each level
  int tile_off[4];   // first tile of each level among an image's tiles
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

// f rounded to T into V channels at p
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

// V channels copied as they are (zeros where ok is false)
template <typename T, int V>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, bool ok) {
  if constexpr (V == 1) {
    *dst = ok ? *src : from_f<T>(0.f);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// 16 bytes from global to shared memory with no register round trip (zeros
// when ok is false; src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait for every group of copies but the one committed last
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Hopper's warp-level bf16 MMA (m16n8k16, f32 accumulate) and its operand
// loads
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&b);
}
// two (x2) or four (x4) transposed 8x8 bf16 matrices, rows from lanes 0-15
// (0-31); each row is 16 bytes in shared memory
__device__ __forceinline__ void ldsm_x2_trans(unsigned& r0, unsigned& r1, const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// d = A B for a 16x16 bf16 A (a0: row g, k 2t and 2t + 1; a1: row g + 8;
// a2, a3: the same rows at k + 8) and a 16x8 B (b0: k 2t, 2t + 1; b1:
// k 2t + 8, 2t + 9), with g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                      unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

// [lo, hi] of the set bits of (m0 | m1 << 32); lo > hi when empty
__device__ __forceinline__ void nonzero_span(unsigned m0, unsigned m1, int empty_lo, int& lo, int& hi) {
  lo = m0 ? __ffs(m0) - 1 : (m1 ? 31 + __ffs(m1) : empty_lo);
  hi = m1 ? 63 - __clz(m1) : (m0 ? 31 - __clz(m0) : -1);
}

// a[l] for a runtime l without copying the kernel's parameter struct to
// local memory
template <typename A>
__device__ __forceinline__ A pick(const A (&a)[4], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// Pass 1, one warp per RoI: its spans, {l | bad << 8, ylo | yhi << 16,
// xlo | xhi << 16, y0 | x0 << 16}, in the level's coordinates and clipped to
// the true map (x = -1 for a RoI that reaches no position of the map), and
// its weights rounded to T and transposed, wt[r] = (wy[:, y] for each window
// row y, then wx[:, x] for each window column x), MAXP floats each (zeros
// past P), so that a tile takes a row's or a column's weights in MAXP / 4
// 16-byte copies. Window origins lie in [0, padded size - window], so they
// fit 16 bits.
template <typename T, int MAXP>
__global__ void __launch_bounds__(THREADS)
spans_kernel(Levels lv, int num_levels, const int* __restrict__ lvl, const int* __restrict__ y0s,
             const int* __restrict__ x0s, const float* __restrict__ wy,
             const float* __restrict__ wx, int4* __restrict__ spans, float* __restrict__ wt,
             int R, int P) {
  const int r = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const float* wy_r = wy + static_cast<size_t>(r) * P * WIN_Y;
  const float* wx_r = wx + static_cast<size_t>(r) * P * WIN_X;
  float* wt_r = wt + static_cast<size_t>(r) * wt_stride<MAXP>();
  bool nz[4] = {false, false, false, false}, fin = true;
  // this lane's window rows lane, lane + 32 and columns lane, lane + 32
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int i = lane + 32 * (h & 1);
    const bool is_row = h < 2;
    if (is_row && i >= WIN_Y) continue;
    float w[MAXP];
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {  // NaN counts as nonzero
      w[p] = p < P ? round_to<T>(is_row ? wy_r[p * WIN_Y + i] : wx_r[p * WIN_X + i]) : 0.f;
      nz[h] |= w[p] != 0.f;
      fin = fin && isfinite(w[p]);
    }
    float4* dst = reinterpret_cast<float4*>(wt_r + ((is_row ? 0 : WIN_Y) + i) * MAXP);
#pragma unroll
    for (int v = 0; v < MAXP / 4; ++v)
      dst[v] = make_float4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
  }
  const bool bad = !__all_sync(FULL, fin);
  int ylo, yhi, xlo, xhi;
  nonzero_span(__ballot_sync(FULL, nz[0]), __ballot_sync(FULL, nz[1]), WIN_Y, ylo, yhi);
  nonzero_span(__ballot_sync(FULL, nz[2]), __ballot_sync(FULL, nz[3]), WIN_X, xlo, xhi);
  if (lane != 0) return;
  if (bad) {
    ylo = 0;
    yhi = WIN_Y - 1;
    xlo = 0;
    xhi = WIN_X - 1;
  }
  const int l = min(max(lvl[r], 0), num_levels - 1);
  const int y0 = y0s[r], x0 = x0s[r];
  ylo = max(y0 + ylo, 0);
  yhi = min(y0 + yhi, pick(lv.h, l) - 1);
  xlo = max(x0 + xlo, 0);
  xhi = min(x0 + xhi, pick(lv.w, l) - 1);
  spans[r] = ylo > yhi || xlo > xhi
                 ? make_int4(-1, 0, 0, 0)
                 : make_int4(l | (bad ? 1 << 8 : 0), ylo | (yhi << 16), xlo | (xhi << 16),
                             (y0 & 0xffff) | (x0 << 16));
}

// shared memory of the tile kernel for P. Rows of the staged cotangent
// (P * CC + PAD) and of u (CC + PAD) are padded by 16 bytes so that the
// eight rows of an 8x8 ldmatrix fall in different banks.
constexpr int PAD = 8;
template <typename T, int CC, int MAXP>
constexpr int tile_smem_bytes(int P) {
  constexpr int nb = steps_rois<MAXP>();
  const int staging = (2 * nb * P * (P * CC + PAD)                      // g_s, two steps
                       + nb * TILE_Y * P * (CC + PAD)) * static_cast<int>(sizeof(T))  // u_s
                      + 2 * nb * (TILE_Y + TILE_X) * MAXP * 4;          // wt_s, two steps
  const int out_tile = TILE_Y * TILE_X * (CC + PAD) * static_cast<int>(sizeof(T));
  return THREADS * 20 + (staging > out_tile ? staging : out_tile);  // list, then either
}

// a listed RoI's rows and columns within the tile, tile-relative
struct View {
  int ra, rb, ca, cb;
  bool bad;
};
__device__ __forceinline__ View tile_view(int4 s, int ty0, int tx0) {
  return {max(s.y & 0xffff, ty0) - ty0, min(s.y >> 16, ty0 + TILE_Y - 1) - ty0,
          max(s.z & 0xffff, tx0) - tx0, min(s.z >> 16, tx0 + TILE_X - 1) - tx0,
          ((s.x >> 8) & 1) != 0};
}

// the tile of blockIdx-derived index t: image b, level l, origin (ty0, tx0)
struct Tile {
  int b, l, ty0, tx0;
};
__device__ __forceinline__ Tile tile_of(const Levels& lv, int t, int tiles_per_image) {
  Tile tl;
  tl.b = t / tiles_per_image;
  int tt = t % tiles_per_image;
  tl.l = 0;
  while (tl.l < 3 && tt >= pick(lv.tile_off, tl.l + 1)) ++tl.l;
  tt -= pick(lv.tile_off, tl.l);
  tl.ty0 = (tt / pick(lv.tiles_x, tl.l)) * TILE_Y;
  tl.tx0 = (tt % pick(lv.tiles_x, tl.l)) * TILE_X;
  return tl;
}

// Pass 2, one CTA per tile: the RoIs of its image whose spans touch it, in
// RoI order (ballot + popc prefix over THREADS candidates at a time), into
// lists[t * rois_per_image ...], and their number into cnt[t]. Built once
// here, each list serves all of the tile's channel chunks.
__global__ void __launch_bounds__(THREADS)
lists_kernel(Levels lv, int tiles_per_image, int rois_per_image, const int4* __restrict__ spans,
             int* __restrict__ cnt, int* __restrict__ lists) {
  __shared__ int warp_hits[THREADS / 32];
  const int t = blockIdx.x;
  const Tile tl = tile_of(lv, t, tiles_per_image);
  const int4* sp = spans + static_cast<size_t>(tl.b) * rois_per_image;
  int* out = lists + static_cast<size_t>(t) * rois_per_image;
  const int tid = threadIdx.x;
  int n = 0;
  for (int base = 0; base < rois_per_image; base += THREADS) {
    const int ci = base + tid;
    bool hit = false;
    if (ci < rois_per_image) {
      const int4 s = sp[ci];
      hit = s.x >= 0 && (s.x & 0xff) == tl.l && (s.y & 0xffff) < tl.ty0 + TILE_Y &&
            (s.y >> 16) >= tl.ty0 && (s.z & 0xffff) < tl.tx0 + TILE_X && (s.z >> 16) >= tl.tx0;
    }
    const unsigned m = __ballot_sync(FULL, hit);
    if ((tid & 31) == 0) warp_hits[tid >> 5] = __popc(m);
    __syncthreads();
    int off = n;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = warp_hits[w];
      off += w < (tid >> 5) ? c : 0;
      n += c;
    }
    if (hit) out[off + __popc(m & ((1u << (tid & 31)) - 1u))] = ci;
    __syncthreads();  // warp_hits is rewritten next round
  }
  if (tid == 0) cnt[t] = n;
}

// Pass 3, one CTA per output tile and channel chunk (see the note above).
// bf16 with 16-byte lanes runs both products on the tensor cores: per listed
// RoI, u (TILE_Y x P*CC) = wy^T (TILE_Y x P) g (P x P*CC), rounded to bf16,
// then for each tile row y, dF[y] (TILE_X x CC) += wx^T (TILE_X x P) u[y]
// (P x CC), one warp per tile row; at MAXP = 8 each MMA takes a pair of
// RoIs, each with 8 of the k = 16, at MAXP = 16 one RoI with all 16 (zero
// weights past P). f32 and the scalar path use FMAs, thread by thread.
template <typename T, int V, int CC, int MAXP>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
tile_kernel(Levels lv, int C, int rois_per_image, int tiles_per_image, int chunks,
            const int4* __restrict__ spans, const int* __restrict__ tile_cnt,
            const int* __restrict__ tile_lists,
            const float* __restrict__ wt, const T* __restrict__ g, int P) {
  constexpr bool MMA = sizeof(T) == 2 && V == 8;
  constexpr int NBM = steps_rois<MAXP>();       // listed RoIs per step
  constexpr int QW = MAXP / 4;                  // 16-byte pieces of a row's weights
  constexpr int NV = CC / V;                // channel vectors per pixel
  constexpr int NS = THREADS / NV;          // pixel slots
  constexpr int NP = TILE_Y * TILE_X / NS;  // pixels per thread
  constexpr int RSTEP = NS / TILE_X;        // rows between a thread's pixels
  constexpr int WS = (TILE_Y + TILE_X) * MAXP;  // a staged RoI's tile rows' and columns' weights
  constexpr int UP = CC + PAD;                  // pitch of u's rows
  constexpr int NACC = MMA ? CC / 2 : NP * V;   // accumulators per thread
  static_assert(CC % V == 0 && THREADS % NV == 0 && NS % TILE_X == 0 &&
                    (TILE_Y * TILE_X) % NS == 0,
                "each thread owns one tile column and NP of its rows");
  static_assert(!MMA || (TILE_Y == 8 && THREADS == 256 && TILE_X == 16 && CC % 16 == 0 &&
                          ((MAXP == 8 && NBM == 2) || (MAXP == 16 && NBM == 1))),
                "one warp per tile row; two RoIs per MMA at MAXP = 8, one at MAXP = 16: the "
                "tile's 8 rows per RoI in the first product, its 16 columns in the second");
  const int GP = P * CC + PAD;     // pitch of the staged cotangent's rows p
  const int GS = P * GP;           // a staged RoI's cotangent chunk, (P, P * CC)
  const int US = TILE_Y * P * UP;  // its u rows, (TILE_Y, P, CC)
  extern __shared__ __align__(16) unsigned char smem[];
  int4* list = reinterpret_cast<int4*>(smem);                  // listed RoIs' spans
  int* list_r = reinterpret_cast<int*>(list + THREADS);        // and indices in the image
  T* g_s = reinterpret_cast<T*>(list_r + THREADS);             // (2, NBM, P, GP)
  T* u_s = g_s + 2 * NBM * GS;                                 // (NBM, TILE_Y, P, UP)
  float* wt_s = reinterpret_cast<float*>(u_s + NBM * US);      // (2, NBM, TILE_Y + TILE_X, MAXP)

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % chunks;
  const int t = blockIdx.x / chunks;
  const Tile tl = tile_of(lv, t, tiles_per_image);
  const int b = tl.b, l = tl.l, ty0 = tl.ty0, tx0 = tl.tx0;
  const int H = pick(lv.h, l);
  const int W = pick(lv.w, l);

  // FMA path: a channel vector and NP pixels of one column per thread;
  // MMA path: warp = tile row, lane = (g8, t4) of the MMA fragments
  const int cv = tid % NV;
  const int slot = tid / NV;
  const int px = slot % TILE_X;
  const int py = slot / TILE_X;
  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int c0 = chunk * CC;
  const bool ch_ok = c0 + cv * V < C;  // C % V == 0: the whole vector
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const int4* sp = spans + static_cast<size_t>(b) * rois_per_image;
  const int roi0 = b * rois_per_image;

  // start the copies of listed RoIs [j0, j0 + nb) into staging buffer s: the
  // cotangent chunks, the weights of the tile rows and columns they cover
  auto stage = [&](int j0, int nb, int s) {
    T* gb = g_s + s * NBM * GS;
    for (int k = tid; k < nb * MAXP * MAXP * NV; k += THREADS) {
      const int v = k % NV, pq = (k / NV) % (MAXP * MAXP), j = k / (MAXP * MAXP * NV);
      const int p = pq / MAXP, q = pq % MAXP;
      if (p < P && q < P) {
        const bool ok = c0 + v * V < C;
        const T* src = g + (static_cast<size_t>(roi0 + list_r[j0 + j]) * P * P + p * P + q) * C + c0 + v * V;
        T* dst = gb + j * GS + p * GP + q * CC + v * V;
        if constexpr (V > 1)
          cp_async16(dst, ok ? src : g, ok);
        else
          copy_vec<T, V>(dst, src, ok);
      }
    }
    for (int k = tid; k < nb * (TILE_Y + TILE_X) * QW; k += THREADS) {
      const int piece = k & (QW - 1), kq = k >> (QW == 2 ? 1 : 2);  // QW is 2 or 4
      const int e = kq % (TILE_Y + TILE_X), j = kq / (TILE_Y + TILE_X);
      const int4 sj = list[j0 + j];
      const float* src =
          wt + static_cast<size_t>(roi0 + list_r[j0 + j]) * wt_stride<MAXP>() + 4 * piece;
      bool in;
      if (e < TILE_Y) {  // tile row e, window row ty0 + e - y0
        const int gy = ty0 + e;
        in = gy >= (sj.y & 0xffff) && gy <= (sj.y >> 16);
        src += (gy - (sj.w & 0xffff)) * MAXP;
      } else {  // tile column e - TILE_Y
        const int gx = tx0 + e - TILE_Y;
        in = gx >= (sj.z & 0xffff) && gx <= (sj.z >> 16);
        src += (WIN_Y + gx - (sj.w >> 16)) * MAXP;
      }
      if (in) cp_async16(wt_s + (s * NBM + j) * WS + e * MAXP + 4 * piece, src, true);
    }
    cp_async_commit();
  };

  // this tile's RoIs, in RoI order, THREADS at a time
  const int* lst = tile_lists + static_cast<size_t>(t) * rois_per_image;
  const int n_t = tile_cnt[t];
  for (int base = 0; base < n_t; base += THREADS) {
    const int n = min(THREADS, n_t - base);
    if (tid < n) {
      const int ri = lst[base + tid];
      list[tid] = sp[ri];
      list_r[tid] = ri;
    }
    __syncthreads();

    // NBM listed RoIs per step; the next step's copies fly during this
    // one's arithmetic
    if (n > 0) stage(0, min(NBM, n), 0);
    for (int j0 = 0, sb = 0; j0 < n; j0 += NBM, sb ^= 1) {
      const int nb = min(NBM, n - j0);
      if (j0 + NBM < n) stage(j0 + NBM, min(NBM, n - j0 - NBM), sb ^ 1);
      else cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();
      const T* gb = g_s + sb * NBM * GS;
      const float* wb = wt_s + sb * NBM * WS;

      // u of the staged RoIs' covered rows, summed in f32 and rounded to T
      if constexpr (MMA && MAXP == 16) {
        // one RoI per MMA: rows 0-7 are the tile rows y, k its p (A's rows
        // 8-15 are zero); B rows past P repeat row P - 1, against zero
        // weights
        const View v0 = tile_view(list[j0], ty0, tx0);
        const bool r0 = g8 >= v0.ra && g8 <= v0.rb;
        const float* w = wb + g8 * MAXP + 2 * t4;
        const unsigned a0 = r0 ? pack_bf16x2(w[0], w[1]) : 0u;
        const unsigned a2 = r0 ? pack_bf16x2(w[8], w[9]) : 0u;
        const T* grow = gb + min(lane & 15, P - 1) * GP;
#pragma unroll
        for (int i = 0; i < MAXP * CC / 8 / (THREADS / 32); ++i) {
          const int nt = warp + i * (THREADS / 32);
          if (nt < P * CC / 8) {
            unsigned b0, b1;
            ldsm_x2_trans(b0, b1, grow + nt * 8);
            float d[4];
            mma16(d, a0, 0u, a2, 0u, b0, b1);
            T* u = u_s + (g8 * P + nt / (CC / 8)) * UP + (nt % (CC / 8)) * 8 + 2 * t4;
            if (r0) *reinterpret_cast<unsigned*>(u) = pack_bf16x2(d[0], d[1]);
          }
        }
      } else if constexpr (MMA) {
        // both RoIs in one MMA, block-diagonally: rows 0-7 and k 0-7 are the
        // first RoI's (tile rows y, its p), rows 8-15 and k 8-15 the
        // second's. B rows past P repeat row P - 1, and without a second
        // RoI its half reads the first's rows, against zero weights.
        const bool two = nb > 1;
        const View v0 = tile_view(list[j0], ty0, tx0);
        const View v1 = two ? tile_view(list[j0 + 1], ty0, tx0) : View{1, 0, 1, 0, false};
        const bool r0 = g8 >= v0.ra && g8 <= v0.rb, r1 = g8 >= v1.ra && g8 <= v1.rb;
        const float* w = wb + g8 * MAXP + 2 * t4;
        const unsigned a0 = r0 ? pack_bf16x2(w[0], w[1]) : 0u;
        const unsigned a3 = r1 ? pack_bf16x2(w[WS], w[WS + 1]) : 0u;
        const T* grow = gb + ((lane & 8) && two ? GS : 0) + min(lane & 7, P - 1) * GP;
        // unrolled over this warp's n tiles, so that their loads and MMAs
        // overlap
#pragma unroll
        for (int i = 0; i < MAXP * CC / 8 / (THREADS / 32); ++i) {
          const int nt = warp + i * (THREADS / 32);
          if (nt < P * CC / 8) {
            unsigned b0, b1;
            ldsm_x2_trans(b0, b1, grow + nt * 8);
            float d[4];
            mma16(d, a0, 0u, 0u, a3, b0, b1);
            T* u = u_s + (g8 * P + nt / (CC / 8)) * UP + (nt % (CC / 8)) * 8 + 2 * t4;
            if (r0) *reinterpret_cast<unsigned*>(u) = pack_bf16x2(d[0], d[1]);
            if (r1) *reinterpret_cast<unsigned*>(u + US) = pack_bf16x2(d[2], d[3]);
          }
        }
      } else {  // each thread keeps one channel vector
        const int v = tid % NV;
        for (int k = tid / NV; k < nb * TILE_Y * MAXP; k += THREADS / NV) {
          const int q = k % MAXP, y = (k / MAXP) % TILE_Y, j = k / (TILE_Y * MAXP);
          const View vw = tile_view(list[j0 + j], ty0, tx0);
          if (q >= P || y < vw.ra || y > vw.rb) continue;
          float w[MAXP];
#pragma unroll
          for (int i = 0; i < QW; ++i) {
            const float4 wv = *reinterpret_cast<const float4*>(wb + j * WS + y * MAXP + 4 * i);
            w[4 * i] = wv.x, w[4 * i + 1] = wv.y, w[4 * i + 2] = wv.z, w[4 * i + 3] = wv.w;
          }
          const T* gj = gb + j * GS + q * CC + v * V;
          float u[V];
#pragma unroll
          for (int e = 0; e < V; ++e) u[e] = 0.f;
#pragma unroll
          for (int p = 0; p < MAXP; ++p) {
            if (p < P && (vw.bad || w[p] != 0.f)) {  // 0 * g adds nothing to a finite sum
              float gv[V];
              load_vec<T, V>(gj + p * GP, gv);
#pragma unroll
              for (int e = 0; e < V; ++e) u[e] = fmaf(w[p], gv[e], u[e]);
            }
          }
          store_vec<T, V>(u_s + j * US + (y * P + q) * UP + v * V, u);
        }
      }
      __syncthreads();

      // dF += wx^T u, in list order. FMA path: RoI by RoI, each RoI's
      // contribution summed over q first, then added. MMA path: one warp per
      // tile row, at MAXP = 8 the step's two RoIs in one MMA (block-diagonally
      // in k), their sum added; at MAXP = 16 the step's RoI alone.
      if constexpr (MMA) {
        const int y = warp;
        const bool two = nb > 1;
        const View v0 = tile_view(list[j0], ty0, tx0);
        const View v1 = two ? tile_view(list[j0 + 1], ty0, tx0) : View{1, 0, 1, 0, false};
        const bool y0 = y >= v0.ra && y <= v0.rb, y1 = y >= v1.ra && y <= v1.rb;
        if (MAXP == 16 || v0.bad || v1.bad) {
          // one RoI per MMA. A: tile columns x = g8, g8 + 8 by k = q (k 8-15
          // at MAXP = 16 only); a column outside the RoI's span gets zero
          // weights (they were not staged). A non-finite RoI's u may hold
          // NaN, and 0 * NaN must not reach the columns outside its span:
          // its sum is added only where the RoI reaches (at MAXP = 8 any
          // RoI's of a step with a non-finite one)
          for (int h = 0; h < (MAXP == 16 ? 1 : nb); ++h) {  // MAXP = 16: nb is 1
            const View vw = h ? v1 : v0;
            if (!(h ? y1 : y0)) continue;  // the whole warp
            const float* w = wb + h * WS + (TILE_Y + g8) * MAXP + 2 * t4;
            const bool x_lo = g8 >= vw.ca && g8 <= vw.cb;
            const bool x_hi = g8 + 8 >= vw.ca && g8 + 8 <= vw.cb;
            const unsigned a0 = x_lo ? pack_bf16x2(w[0], w[1]) : 0u;
            const unsigned a1 = x_hi ? pack_bf16x2(w[8 * MAXP], w[8 * MAXP + 1]) : 0u;
            unsigned a2 = 0u, a3 = 0u;
            if constexpr (MAXP == 16) {
              a2 = x_lo ? pack_bf16x2(w[8], w[9]) : 0u;
              a3 = x_hi ? pack_bf16x2(w[8 * MAXP + 8], w[8 * MAXP + 9]) : 0u;
            }
            const bool add_lo = x_lo || (MAXP == 16 && !vw.bad);
            const bool add_hi = x_hi || (MAXP == 16 && !vw.bad);
            // B rows k = q (past P: row P - 1 against zero weights); lanes
            // 16-31 address the next n tile
            const T* urow = u_s + h * US + (y * P + min(lane & 15, P - 1)) * UP + (lane >> 4) * 8;
#pragma unroll
            for (int nt = 0; nt < CC / 8; nt += 2) {
              unsigned bq[4];
              ldsm_x4_trans(bq, urow + nt * 8);
              float d[4], e[4];
              mma16(d, a0, a1, a2, a3, bq[0], bq[1]);
              mma16(e, a0, a1, a2, a3, bq[2], bq[3]);
              acc[4 * nt] += add_lo ? d[0] : 0.f;
              acc[4 * nt + 1] += add_lo ? d[1] : 0.f;
              acc[4 * nt + 2] += add_hi ? d[2] : 0.f;
              acc[4 * nt + 3] += add_hi ? d[3] : 0.f;
              acc[4 * nt + 4] += add_lo ? e[0] : 0.f;
              acc[4 * nt + 5] += add_lo ? e[1] : 0.f;
              acc[4 * nt + 6] += add_hi ? e[2] : 0.f;
              acc[4 * nt + 7] += add_hi ? e[3] : 0.f;
            }
          }
        } else if (y0 || y1) {
          // A: tile columns x = g8, g8 + 8 by k = the first RoI's q, then
          // the second's; a column outside a RoI's span gets zero weights
          const float* w = wb + (TILE_Y + g8) * MAXP + 2 * t4;
          const unsigned a0 = y0 && g8 >= v0.ca && g8 <= v0.cb ? pack_bf16x2(w[0], w[1]) : 0u;
          const unsigned a1 =
              y0 && g8 + 8 >= v0.ca && g8 + 8 <= v0.cb ? pack_bf16x2(w[8 * MAXP], w[8 * MAXP + 1]) : 0u;
          const unsigned a2 = y1 && g8 >= v1.ca && g8 <= v1.cb ? pack_bf16x2(w[WS], w[WS + 1]) : 0u;
          const unsigned a3 = y1 && g8 + 8 >= v1.ca && g8 + 8 <= v1.cb
                                  ? pack_bf16x2(w[WS + 8 * MAXP], w[WS + 8 * MAXP + 1]) : 0u;
          // B rows: lanes 8-15 and 24-31 read the second RoI's u, the others
          // the first's; a RoI without row y reads the other's, against
          // zero weights; lanes 16-31 address the next n tile
          const int h = (lane >> 3) & 1;
          const int src = (h ? y1 : y0) ? h : 1 - h;
          const T* urow = u_s + src * US + (y * P + min(lane & 7, P - 1)) * UP + (lane >> 4) * 8;
#pragma unroll
          for (int nt = 0; nt < CC / 8; nt += 2) {
            unsigned bq[4];
            ldsm_x4_trans(bq, urow + nt * 8);
            float d[4], e[4];
            mma16(d, a0, a1, a2, a3, bq[0], bq[1]);
            mma16(e, a0, a1, a2, a3, bq[2], bq[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[4 * nt + i] += d[i];
              acc[4 * nt + 4 + i] += e[i];
            }
          }
        }
      } else if (ch_ok) {  // this thread's pixels, q by q over the column's nonzero wx
        for (int j = 0; j < nb; ++j) {
          const View vw = tile_view(list[j0 + j], ty0, tx0);
          if (px < vw.ca || px > vw.cb) continue;
          float wq[MAXP];
#pragma unroll
          for (int i = 0; i < QW; ++i) {
            const float4 wv =
                *reinterpret_cast<const float4*>(wb + j * WS + (TILE_Y + px) * MAXP + 4 * i);
            wq[4 * i] = wv.x, wq[4 * i + 1] = wv.y, wq[4 * i + 2] = wv.z, wq[4 * i + 3] = wv.w;
          }
          const T* uj = u_s + j * US + cv * V;
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int y = py + i * RSTEP;
            if (y >= vw.ra && y <= vw.rb) {
              float v[V];
#pragma unroll
              for (int e = 0; e < V; ++e) v[e] = 0.f;
#pragma unroll
              for (int q = 0; q < MAXP; ++q) {
                if (q < P && (vw.bad || wq[q] != 0.f)) {
                  float uv[V];
                  load_vec<T, V>(uj + (y * P + q) * UP, uv);
#pragma unroll
                  for (int e = 0; e < V; ++e) v[e] = fmaf(wq[q], uv[e], v[e]);
                }
              }
#pragma unroll
              for (int e = 0; e < V; ++e) acc[i * V + e] += v[e];
            }
          }
        }
      }
      // the next step copies into this step's buffers and writes u_s
      __syncthreads();
    }
  }

  // round once, write every pixel of the tile that lies in the map
  T* out = static_cast<T*>(pick(lv.out, l)) + static_cast<size_t>(b) * H * W * C;
  if constexpr (MMA) {
    // through shared memory (the staging buffers, free now), so that the
    // stores are whole 16-byte lanes of consecutive channels: (pixel,
    // CC + PAD) in bf16
    T* out_s = g_s;
#pragma unroll
    for (int nt = 0; nt < CC / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(out_s + (warp * TILE_X + g8 + 8 * h) * UP + nt * 8 + 2 * t4) =
            pack_bf16x2(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    __syncthreads();
    for (int k = tid; k < TILE_Y * TILE_X * NV; k += THREADS) {
      const int v = k % NV, pix = k / NV;
      const int gy = ty0 + pix / TILE_X, gx = tx0 + pix % TILE_X;
      if (gy < H && gx < W && c0 + v * V < C)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(gy) * W + gx) * C + c0 + v * V) =
            *reinterpret_cast<const uint4*>(out_s + pix * UP + v * V);
    }
  } else {
    const int gx = tx0 + px;
    if (ch_ok && gx < W) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int gy = ty0 + py + i * RSTEP;
        float a[V];
#pragma unroll
        for (int e = 0; e < V; ++e) a[e] = acc[i * V + e];
        if (gy < H) store_vec<T, V>(out + (static_cast<size_t>(gy) * W + gx) * C + c0 + cv * V, a);
      }
    }
  }
}

template <typename T, int V, int CC, int MAXP>
int launch_tiles(const Levels& lv, int B, int C, int rois_per_image, int tiles_per_image,
                 const int4* spans, const int* tile_cnt, const int* tile_lists,
                 const float* wt, const T* g, int P, cudaStream_t s) {
  constexpr int max_smem = tile_smem_bytes<T, CC, MAXP>(MAXP);
  static_assert(max_smem <= 232448, "the tile kernel's shared memory exceeds an SM's");
  if (max_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<T, V, CC, MAXP>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = (C + CC - 1) / CC;
  tile_kernel<T, V, CC, MAXP>
      <<<B * tiles_per_image * chunks, THREADS, tile_smem_bytes<T, CC, MAXP>(P), s>>>(
          lv, C, rois_per_image, tiles_per_image, chunks, spans, tile_cnt, tile_lists, wt, g, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MAXP>
int launch(const void* g, const int* lvl, const int* y0, const int* x0, const float* wy,
           const float* wx, void* scratch, long long scratch_ints, void* o0, void* o1,
           void* o2, void* o3, int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
           int num_levels, int B, int C, int rois_per_image, int R, int P, void* stream) {
  if (P < 1 || P > MAXP || num_levels < 1 || num_levels > 4 || B < 0 || C < 1 ||
      rois_per_image < 0 || R != B * rois_per_image)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{{o0, o1, o2, o3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {}, {}};
  long long tiles = 0;
  for (int i = 0; i < 4; ++i) {
    lv.tile_off[i] = static_cast<int>(tiles);
    lv.tiles_x[i] = 1;
    if (i < num_levels) {
      lv.tiles_x[i] = (lv.w[i] + TILE_X - 1) / TILE_X;
      tiles += static_cast<long long>(lv.tiles_x[i]) * ((lv.h[i] + TILE_Y - 1) / TILE_Y);
    }
  }
  const long long grid = B * tiles * ((C + SCALAR_CHUNK - 1) / SCALAR_CHUNK);
  if (grid > 0x7fffffffLL ||
      static_cast<long long>(wt_stride<MAXP>() + 4 + tiles) * R + B * tiles > scratch_ints)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * tiles == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(B * tiles);
  float* wt = static_cast<float*>(scratch);
  int4* sp = reinterpret_cast<int4*>(wt + static_cast<size_t>(wt_stride<MAXP>()) * R);
  int* cnt = reinterpret_cast<int*>(sp + R);
  int* lists = cnt + n;  // (n, rois_per_image)
  if (R > 0) {
    constexpr int WARPS = THREADS / 32;
    spans_kernel<T, MAXP><<<(R + WARPS - 1) / WARPS, THREADS, 0, s>>>(lv, num_levels, lvl, y0,
                                                                       x0, wy, wx, sp, wt, R, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lists_kernel<<<n, THREADS, 0, s>>>(lv, static_cast<int>(tiles), rois_per_image, sp, cnt, lists);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int V = 16 / sizeof(T);
  bool vec = C % V == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  for (int i = 0; i < num_levels; ++i) vec = vec && reinterpret_cast<uintptr_t>(lv.out[i]) % 16 == 0;
  const T* gt = static_cast<const T*>(g);
  const int tpi = static_cast<int>(tiles);
  if (vec)
    return launch_tiles<T, V, CHUNK_BYTES / static_cast<int>(sizeof(T)), MAXP>(
        lv, B, C, rois_per_image, tpi, sp, cnt, lists, wt, gt, P, s);
  return launch_tiles<T, 1, SCALAR_CHUNK, MAXP>(lv, B, C, rois_per_image, tpi, sp, cnt, lists, wt,
                                                gt, P, s);
}

// the instance for P: MAXP = 8 up to P = 8, 16 above
template <typename T>
int launch_p(const void* g, const int* lvl, const int* y0, const int* x0, const float* wy,
             const float* wx, void* scratch, long long scratch_ints, void* o0, void* o1,
             void* o2, void* o3, int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
             int num_levels, int B, int C, int rois_per_image, int R, int P, void* stream) {
  return (P <= 8 ? launch<T, 8> : launch<T, 16>)(
      g, lvl, y0, x0, wy, wx, scratch, scratch_ints, o0, o1, o2, o3, h0, h1, h2, h3, w0, w1, w2,
      w3, num_levels, B, C, rois_per_image, R, P, stream);
}

}  // namespace

#define ROI_ALIGN_BWD_ARGS                                                            \
  const void *g, const int *lvl, const int *y0, const int *x0, const float *wy,       \
      const float *wx, void *scratch, long long scratch_ints, void *o0, void *o1,     \
      void *o2, void *o3, int h0, int h1, int h2, int h3, int w0, int w1, int w2,     \
      int w3, int num_levels, int B, int C, int rois_per_image, int R, int P,         \
      void *stream
#define ROI_ALIGN_BWD_PASS                                                            \
  g, lvl, y0, x0, wy, wx, scratch, scratch_ints, o0, o1, o2, o3, h0, h1, h2, h3, w0,  \
      w1, w2, w3, num_levels, B, C, rois_per_image, R, P, stream

// Every pass on the caller's stream; P up to 16. scratch: scratch_ints of
// 4-byte words, 16-byte aligned, at least ((56 + 64) MAXP + 4 + T) R + B T
// for T tiles per image and MAXP = 8 (P <= 8) or 16 (the transposed
// weights, the spans, each tile's RoI list and its length); o0..o3: the
// per-level outputs, each written whole. Returns cudaGetLastError() of the last launch
// (or of the first that failed).
extern "C" int roi_align_bwd_bf16(ROI_ALIGN_BWD_ARGS) {
  return launch_p<__nv_bfloat16>(ROI_ALIGN_BWD_PASS);
}

extern "C" int roi_align_bwd_f32(ROI_ALIGN_BWD_ARGS) {
  return launch_p<float>(ROI_ALIGN_BWD_PASS);
}
