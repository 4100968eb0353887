// K5: exact greedy NMS over score-sorted boxes for Hopper (sm_90a). Per
// problem p of P (the flattened leading dims: images x FPN levels, or
// images), with boxes b[0..N) in score order and a validity flag each:
//   keep[j] = valid[j] and not any(keep[i] and iou(b[i], b[j]) > t, i < j)
// the keep mask in the sorted order.
//
// Replaces no Pallas kernel. It replaces the dense route that the JAX
// package kept for the TPU's matrix unit (proben_tpu/ops/nms.py, ported as
// ops/nms.py::nms_keep_plain): the whole (P, N, N) float32 IoU matrix,
// a suppression mask cast to float32, and a Jacobi fixpoint of one batched
// matvec and one host-read convergence test an iteration. On the H100 that
// route moves tens of GB a call and syncs the host once an iteration.
//
// IoU is pairwise_iou's float32 arithmetic step for step:
//   area = (x2 - x1) * (y2 - y1)
//   iw = min(x2a, x2b) - max(x1a, x1b), ih the same, NaN propagating
//   inter = clamp(iw, 0) * clamp(ih, 0), NaN propagating
//   union = (area_a + area_b) - inter
//   iou = inter > 0 ? inter / (union > 0 ? union : 1) : 0
// with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc contracts
// nothing into an FMA, compared as `iou > t` with t the threshold rounded
// to float32 (what a comparison of a float32 tensor with a Python float
// does). So the suppression bits, and the keep mask, are the dense
// route's bits.
//
// What bounds it on the H100: neither bytes nor flops. The mask is one bit
// a pair over the upper triangle, N * ceil(N / 64) u64 words a problem
// (10 MB at 80 x 1000, 18 MB at 16 x 3000, 41 MB at 80 x 2000), written
// once and read at most once, from L2; the IoUs are ~20 float operations a
// pair. What remains is the recurrence's serial depth: greedy NMS is
// sequential in the boxes.
//
// Design: two launches on the caller's stream, no host sync.
// 1. Mask pass: one CTA of 64 threads per (column block >= row block of 64
//    boxes, problem); the column boxes and their areas are staged in shared
//    memory, each thread forms the u64 word of its row: bit k set iff the
//    column box is later than the row box, both are valid and their IoU is
//    above t. Lower-triangle CTAs exit at once; a row or column that is not
//    valid (read from `valid`, not assumed from the sort: a valid box with
//    a NaN score sorts after the invalid ones) costs no IoU.
// 2. Sweep pass: one CTA of 256 threads per problem holds the "removed"
//    bitmask (N / 64 words, N <= kMaxBoxes) in shared memory. For each
//    64-box block in order, one lane resolves the block's candidates (valid
//    and not removed) against their diagonal words in registers, visiting
//    only the boxes it keeps (find-first-set over what is left), then the
//    whole CTA ORs the kept rows' words for the later blocks into
//    "removed": lanes over columns (coalesced from L2), warps over rows,
//    shared-memory atomicOr to combine. The serial depth is N / 64 blocks,
//    not N boxes. The keep bits go out as bools at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;               // boxes a block, bits a mask word
constexpr int kMaxWords = 128;           // the sweep's shared words per bitmask
constexpr int kMaxBoxes = kBlock * kMaxWords;  // 8192 boxes a problem
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// clamp(min=0): NaN stays NaN
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

struct Box {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ boxes, long long i) {
  const float* p = boxes + 4 * i;
  Box b;
  b.x1 = p[0];
  b.y1 = p[1];
  b.x2 = p[2];
  b.y2 = p[3];
  b.area = __fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1));
  return b;
}

__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  const float iw = __fsub_rn(nan_min(a.x2, b.x2), nan_max(a.x1, b.x1));
  const float ih = __fsub_rn(nan_min(a.y2, b.y2), nan_max(a.y1, b.y1));
  const float inter = __fmul_rn(clamp0(iw), clamp0(ih));
  if (!(inter > 0.f)) return 0.f;
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  return __fdiv_rn(inter, uni > 0.f ? uni : 1.f);
}

// mask[(p * n + i) * nb + c]: bit k set iff box c * 64 + k is suppressed by
// box i (later, both valid, IoU > thr); written for c >= i / 64
__global__ void __launch_bounds__(kBlock)
nms_mask_pass(const float* __restrict__ boxes, const bool* __restrict__ valid,
              u64* __restrict__ mask, int n, int nb, float thr) {
  const int r = blockIdx.y, c = blockIdx.z;
  if (c < r) return;  // the lower triangle is never read
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const int t = threadIdx.x;
  __shared__ Box cols[kBlock];
  __shared__ unsigned col_valid[2];
  const int j = c * kBlock + t;
  const bool vj = j < n && valid[base + j];
  if (vj) cols[t] = load_box(boxes, base + j);
  const unsigned ballot = __ballot_sync(kFull, vj);
  if ((t & 31) == 0) col_valid[t >> 5] = ballot;
  __syncthreads();
  const int i = r * kBlock + t;
  if (i >= n) return;
  const u64 cv = static_cast<u64>(col_valid[0]) | (static_cast<u64>(col_valid[1]) << 32);
  // on the diagonal only later columns: bits above t
  u64 todo = c == r ? (t == kBlock - 1 ? 0ull : cv & (~0ull << (t + 1))) : cv;
  u64 word = 0;
  if (todo && valid[base + i]) {
    const Box a = load_box(boxes, base + i);
    while (todo) {
      const int k = __ffsll(static_cast<long long>(todo)) - 1;
      todo &= todo - 1;
      if (iou(a, cols[k]) > thr) word |= 1ull << k;
    }
  }
  mask[(base + i) * nb + c] = word;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_pass(const u64* __restrict__ mask, const bool* __restrict__ valid,
               bool* __restrict__ keep, int n, int nb) {
  __shared__ u64 removed[kMaxWords];
  __shared__ u64 kept[kMaxWords];
  __shared__ u64 diag[kBlock];
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int w = t; w < nb; w += kSweepThreads) removed[w] = 0;
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    if (warp == 0) {
      const int i0 = b * kBlock + lane, i1 = i0 + 32;
      const bool v0 = i0 < n && valid[base + i0];
      const bool v1 = i1 < n && valid[base + i1];
      const u64 vw = static_cast<u64>(__ballot_sync(kFull, v0)) |
                     (static_cast<u64>(__ballot_sync(kFull, v1)) << 32);
      const u64 cand = vw & ~removed[b];
      if (cand) {  // warp-uniform
        diag[lane] = v0 ? mask[(base + i0) * nb + b] : 0ull;
        diag[lane + 32] = v1 ? mask[(base + i1) * nb + b] : 0ull;
      }
      __syncwarp();
      if (lane == 0) {
        // greedy within the block: the lowest candidate left is kept, and
        // its diagonal word (bits above it only) removes later ones
        u64 left = cand, kw = 0;
        while (left) {
          const int k = __ffsll(static_cast<long long>(left)) - 1;
          kw |= 1ull << k;
          left &= ~diag[k];
          left &= left - 1;  // k is the lowest bit left
        }
        kept[b] = kw;
      }
    }
    __syncthreads();
    const u64 kw = kept[b];
    if (kw && b + 1 < nb) {
      const u64* rows = mask + (base + static_cast<long long>(b) * kBlock) * nb;
      for (int c = b + 1 + lane; c < nb; c += 32) {
        u64 acc = 0;
#pragma unroll
        for (int r = warp; r < kBlock; r += kSweepWarps)
          if ((kw >> r) & 1ull) acc |= rows[static_cast<long long>(r) * nb + c];
        if (acc) atomicOr(&removed[c], acc);
      }
    }
    __syncthreads();
  }
  for (int i = t; i < n; i += kSweepThreads) keep[base + i] = (kept[i / kBlock] >> (i % kBlock)) & 1ull;
}

}  // namespace

// boxes (P, N, 4) f32 and valid (P, N) bool, contiguous; mask scratch of
// P * N * ceil(N / 64) u64; keep (P, N) bool. thr is the float32 threshold.
extern "C" int nms_keep_f32(const void* boxes, const void* valid, void* mask, void* keep,
                            long long problems, int n, float thr, void* stream) {
  if (n <= 0 || n > kMaxBoxes || problems <= 0 || problems > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kBlock - 1) / kBlock;
  const dim3 grid(static_cast<unsigned>(problems), nb, nb);
  nms_mask_pass<<<grid, kBlock, 0, s>>>(static_cast<const float*>(boxes),
                                         static_cast<const bool*>(valid),
                                         static_cast<u64*>(mask), n, nb, thr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_sweep_pass<<<static_cast<unsigned>(problems), kSweepThreads, 0, s>>>(
      static_cast<const u64*>(mask), static_cast<const bool*>(valid), static_cast<bool*>(keep), n,
      nb);
  return static_cast<int>(cudaGetLastError());
}
