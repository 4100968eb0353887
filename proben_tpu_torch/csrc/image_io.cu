// image_io: JPEG decode with nvJPEG and the compose + resize + pad kernel.
//
// Counterpart of native/proben_io.cpp (host C++ with libjpeg, not a Pallas
// kernel): what the host did there before a batch went to the device --
// decode, multimodal channel composition, shortest-edge bilinear resize and
// zero padding into the static (N, PH, PW, C) float32 canvas -- happens here
// on the card, so the canvas is made where the model reads it and no image
// crosses from the host.
//
// Decode: nvJPEG (the CUDA toolkit's JPEG library), one nvjpegDecode per
// image, into interleaved BGR uint8 (NVJPEG_OUTPUT_BGRI) for colour files and
// one Y channel (NVJPEG_OUTPUT_Y) for single-component ones; the compose
// kernel replicates Y into the three channels, as cv2.IMREAD_COLOR does.
// Encode (for synthetic test trees): nvjpegEncodeImage (BGRI, 4:2:0) and
// nvjpegEncodeYUV (grayscale).
//
// compose_resize_pad_kernel: one thread per canvas pixel of one image. For a
// pixel inside the image's resized size (nh, nw) -- of a flipped image (the
// training augmentation's horizontal flip of the resized image,
// proben_tpu/data/transforms.py:207-209) at resized column nw - 1 - x, so the
// flip costs no pass of its own -- it takes the four taps of
// the half-pixel bilinear map into the image's crop window (the training
// augmentation's random crop of the composed frame,
// proben_tpu/data/transforms.py:65: rows y0 .. y0 + ch - 1 and columns
// x0 .. x0 + cw - 1 of the thermal frame (th, tw); without a crop the whole
// frame) (src = (dst + 0.5) * scale - 0.5, clamped to [0, size - 1], as
// proben_io.cpp:96-154 and cv2.INTER_LINEAR), composes each tap's channels
// (BGR: the thermal file's three channels; BGRT: the RGB file resized to the
// thermal frame, then thermal channel 0; BGRTTT: that, then the three
// thermal channels) and blends them; outside it writes zeros. A tap's
// window coordinates are offset by (y0, x0) into the frame, so the RGB taps
// are read at the cropped composed coordinates through the same two-stage
// sampling as without a crop, never at a crop of the raw RGB file. The RGB
// image resized to the thermal frame is recomputed per tap rather than staged: a
// uint8 bilinear resize with cv2.INTER_LINEAR's fixed-point arithmetic and
// rounding, which is the value cv2.resize gives the JAX package
// (detection_utils.py:46); proben_io.cpp:162-168 rounds a float resize
// instead and differs from it by one level at many pixels. Every float
// operation is an explicitly rounded intrinsic (__fmul_rn, __dadd_rn, ...)
// in the order of the plain version (native/io.py::compose_resize_pad_plain),
// which the compiler may not contract into FMAs: the kernel and its plain
// version agree bit for bit.
//
// Bound: bytes. The canvas is written once (N * PH * PW * C * 4 bytes, 157 MB
// for a BGRTTT batch of 8 at 800x1024) and the decoded images are read (72
// MB for that batch, nearly all of it the 1800x1600 RGB files); the
// arithmetic is ~100 operations per output value. A simple kernel: no
// staging of the RGB resize, no vector stores. The images' descriptions
// travel as kernel parameters, so a launch needs no copy from the host.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kNvjpegBase = 1000;  // error codes: 1000 + nvjpegStatus_t

struct Codec {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
};

inline int nv(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : kNvjpegBase + int(s); }

struct Taps {
  int i0, i1;
  float w0, w1;
};

// half-pixel bilinear taps of output index d for a source of n samples
__device__ __forceinline__ Taps taps(int d, float scale, int n) {
  float f = __fsub_rn(__fmul_rn(__fadd_rn(float(d), 0.5f), scale), 0.5f);
  f = fminf(fmaxf(f, 0.0f), float(n - 1));
  Taps t;
  t.i0 = int(f);
  t.i1 = min(t.i0 + 1, n - 1);
  t.w1 = __fsub_rn(f, float(t.i0));
  t.w0 = __fsub_rn(1.0f, t.w1);
  return t;
}

__device__ __forceinline__ float lerp2(float a, float b, float w0, float w1) {
  return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1));
}

// cv2.INTER_LINEAR on uint8 (what cv2.resize computes for the JAX package):
// per axis, src = (dst + 0.5) * scale - 0.5 in double, rounded to float, split
// into floor and fraction; 11-bit fixed-point weights round((1 - f) * 2048),
// round(f * 2048). Along x an index left of 0 or right of n - 2 is clamped
// with weights (2048, 0); along y the rows are clamped and the weights kept.
struct FixedTaps {
  int i0, i1, a0, a1;
};

__device__ __forceinline__ FixedTaps fixed_taps(int d, double scale, int n, bool clamp_weights) {
  float f = __double2float_rn(__dsub_rn(__dmul_rn(__dadd_rn(double(d), 0.5), scale), 0.5));
  int i = int(floorf(f));
  f = __fsub_rn(f, float(i));
  FixedTaps t;
  if (clamp_weights && i < 0) f = 0.0f, i = 0;
  if (clamp_weights && i >= n - 1) f = 0.0f, i = n - 1;
  t.i0 = min(max(i, 0), n - 1);
  t.i1 = min(max(i + 1, 0), n - 1);
  t.a0 = __float2int_rn(__fmul_rn(__fsub_rn(1.0f, f), 2048.0f));
  t.a1 = __float2int_rn(__fmul_rn(f, 2048.0f));
  return t;
}

// the RGB image resized (uint8, cv2's rounding) to the thermal frame, at (y, x), channel k
__device__ __forceinline__ float rgb_at(const uint8_t* rgb, int rh, int rw, int rc, double ry,
                                        double rx, int y, int x, int k) {
  const FixedTaps ty = fixed_taps(y, ry, rh, false), tx = fixed_taps(x, rx, rw, true);
  const int kk = rc == 1 ? 0 : k;
  const int s0 = rgb[(size_t(ty.i0) * rw + tx.i0) * rc + kk] * tx.a0 +
                 rgb[(size_t(ty.i0) * rw + tx.i1) * rc + kk] * tx.a1;
  const int s1 = rgb[(size_t(ty.i1) * rw + tx.i0) * rc + kk] * tx.a0 +
                 rgb[(size_t(ty.i1) * rw + tx.i1) * rc + kk] * tx.a1;
  const int v = (((ty.a0 * (s0 >> 4)) >> 16) + ((ty.a1 * (s1 >> 4)) >> 16) + 2) >> 2;
  return float(min(max(v, 0), 255));
}

// composed channel k of the thermal-frame pixel (y, x); fmt 0 BGR, 1 BGRT, 2 BGRTTT
__device__ __forceinline__ float composed(const uint8_t* t, int tw, int tc, const uint8_t* rgb,
                                          int rh, int rw, int rc, double ry, double rx, int fmt,
                                          int y, int x, int k) {
  if (fmt == 0 || k >= 3) {
    const int kt = fmt == 0 ? k : (fmt == 1 ? 0 : k - 3);
    return t[(size_t(y) * tw + x) * tc + (tc == 1 ? 0 : kt)];
  }
  return rgb_at(rgb, rh, rw, rc, ry, rx, y, x, k);
}

// One launch's images, passed by value (kernel parameters, not a table the
// host copies to the device): thermal and RGB pointers; th, tw, tc, rh, rw,
// rc, nh, nw, flip, y0, x0, ch, cw (the crop window in the thermal frame);
// sy, sx (crop window over output: float32(ch) / float32(nh), float32(cw) /
// float32(nw)) and ry, rx (RGB over thermal frame, cv2's 1 / (dst / src) in
// double). 40 images fill 4000 B; with the other four parameters 4020 B of
// the classic 4 KB limit, which the launch keeps (kMaxBatch stays 40, so
// launches per batch are unchanged; the static_assert fails the build if a
// field is added without lowering it).
constexpr int kMaxBatch = 40;
constexpr int kInts = 13;

struct Batch {
  const uint8_t* thermal[kMaxBatch];
  const uint8_t* rgb[kMaxBatch];
  int ints[kMaxBatch][kInts];
  double scale[kMaxBatch][4];
};
static_assert(sizeof(Batch) + sizeof(float*) + 3 * sizeof(int) <= 4096,
              "image_io: the batch descriptor outgrows the 4 KB of kernel parameters");

template <int C>
__global__ void compose_resize_pad_kernel(const __grid_constant__ Batch b, float* __restrict__ out,
                                          int ph, int pw, int fmt) {
  const int n = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ph * pw) return;
  const int y = idx / pw, x = idx - y * pw;
  float* o = out + (size_t(n) * ph * pw + idx) * C;
  const int* d = b.ints[n];
  const int tw = d[1], tc = d[2], rh = d[3], rw = d[4], rc = d[5], nh = d[6], nw = d[7];
  const bool flip = d[8] != 0;
  const int y0 = d[9], x0 = d[10], ch = d[11], cw = d[12];
  if (y >= nh || x >= nw) {
#pragma unroll
    for (int k = 0; k < C; k++) o[k] = 0.0f;
    return;
  }
  const uint8_t* t = b.thermal[n];
  const uint8_t* rgb = b.rgb[n];
  const double* s = b.scale[n];
  const Taps ty = taps(y, float(s[0]), ch), tx = taps(flip ? nw - 1 - x : x, float(s[1]), cw);
  const int ya = y0 + ty.i0, yb = y0 + ty.i1, xa = x0 + tx.i0, xb = x0 + tx.i1;
#pragma unroll
  for (int k = 0; k < C; k++) {
    const float v00 = composed(t, tw, tc, rgb, rh, rw, rc, s[2], s[3], fmt, ya, xa, k);
    const float v01 = composed(t, tw, tc, rgb, rh, rw, rc, s[2], s[3], fmt, ya, xb, k);
    const float v10 = composed(t, tw, tc, rgb, rh, rw, rc, s[2], s[3], fmt, yb, xa, k);
    const float v11 = composed(t, tw, tc, rgb, rh, rw, rc, s[2], s[3], fmt, yb, xb, k);
    const float a = lerp2(v00, v01, tx.w0, tx.w1);
    const float b2 = lerp2(v10, v11, tx.w0, tx.w1);
    o[k] = lerp2(a, b2, ty.w0, ty.w1);
  }
}

}  // namespace

extern "C" {

int image_io_codec_create(void** out) {
  Codec* c = new Codec();
  int err = nv(nvjpegCreateSimple(&c->handle));
  if (!err) err = nv(nvjpegJpegStateCreate(c->handle, &c->state));
  if (!err) err = nv(nvjpegEncoderStateCreate(c->handle, &c->enc_state, nullptr));
  if (!err) err = nv(nvjpegEncoderParamsCreate(c->handle, &c->enc_params, nullptr));
  if (!err) err = nv(nvjpegEncoderParamsSetOptimizedHuffman(c->enc_params, 0, nullptr));
  *out = c;
  return err;
}

int image_io_codec_destroy(void* codec) {
  Codec* c = static_cast<Codec*>(codec);
  if (c == nullptr) return 0;
  if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->state) nvjpegJpegStateDestroy(c->state);
  int err = c->handle ? nv(nvjpegDestroy(c->handle)) : 0;
  delete c;
  return err;
}

// Height, width and decoded channels (1 for a single-component file, else 3).
int image_io_info(void* codec, const unsigned char* data, size_t len, int* h, int* w, int* ch) {
  Codec* c = static_cast<Codec*>(codec);
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  int err = nv(nvjpegGetImageInfo(c->handle, data, len, &ncomp, &css, widths, heights));
  if (err) return err;
  if (css == NVJPEG_CSS_UNKNOWN || (ncomp != 1 && ncomp != 3))
    return kNvjpegBase + int(NVJPEG_STATUS_JPEG_NOT_SUPPORTED);
  *h = heights[0];
  *w = widths[0];
  *ch = css == NVJPEG_CSS_GRAY ? 1 : 3;
  return 0;
}

// Decode into out (h, w, ch) uint8 on the device: BGR for ch = 3, Y for ch = 1.
// Returns once the stream has passed the decode: the next nvjpegDecode on the
// same state overwrites the host-side Huffman output that this decode's
// device part still has to copy, and nvjpegDecode may read data after it
// returns.
int image_io_decode(void* codec, const unsigned char* data, size_t len, unsigned char* out, int h,
                    int w, int ch, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = out;
  img.pitch[0] = size_t(w) * ch;
  (void)h;
  int err = nv(nvjpegDecode(c->handle, c->state, data, len,
                            ch == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_BGRI, &img, st));
  if (err) return err;
  return int(cudaStreamSynchronize(st));
}

// Encode src (h, w, ch) uint8 on the device (BGR 4:2:0 for ch = 3, grayscale
// for ch = 1) into out (host, cap bytes); *len is the stream's length. Returns
// -1 (and the needed length in *len) when cap is too small.
int image_io_encode(void* codec, const unsigned char* src, int h, int w, int ch, int quality,
                    unsigned char* out, size_t cap, size_t* len, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = const_cast<unsigned char*>(src);
  img.pitch[0] = size_t(w) * ch;
  int err = nv(nvjpegEncoderParamsSetQuality(c->enc_params, quality, st));
  if (!err)
    err = nv(nvjpegEncoderParamsSetSamplingFactors(
        c->enc_params, ch == 1 ? NVJPEG_CSS_GRAY : NVJPEG_CSS_420, st));
  if (!err)
    err = ch == 1 ? nv(nvjpegEncodeYUV(c->handle, c->enc_state, c->enc_params, &img,
                                       NVJPEG_CSS_GRAY, w, h, st))
                  : nv(nvjpegEncodeImage(c->handle, c->enc_state, c->enc_params, &img,
                                         NVJPEG_INPUT_BGRI, w, h, st));
  size_t n = 0;
  if (!err) err = nv(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, nullptr, &n, st));
  if (err) return err;
  *len = n;
  if (n > cap) return -1;
  cudaError_t ce = cudaStreamSynchronize(st);
  if (ce != cudaSuccess) return int(ce);
  err = nv(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, out, &n, st));
  if (err) return err;
  ce = cudaStreamSynchronize(st);
  *len = n;
  return int(ce);
}

// The (n, ph, pw, channels) float32 canvas from the decoded images described
// by three host tables: ptrs (n, 2) thermal and RGB device pointers, ints
// (n, kInts) and scales (n, 4) as in Batch. One launch per kMaxBatch images.
int image_io_compose(const long long* ptrs, const int* ints, const double* scales, float* out,
                     int n, int ph, int pw, int fmt, int channels, void* stream) {
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += kMaxBatch) {
    const int m = n - first < kMaxBatch ? n - first : kMaxBatch;
    Batch b;
    memset(&b, 0, sizeof(b));
    for (int i = 0; i < m; i++) {
      b.thermal[i] = reinterpret_cast<const uint8_t*>(ptrs[2 * (first + i)]);
      b.rgb[i] = reinterpret_cast<const uint8_t*>(ptrs[2 * (first + i) + 1]);
      for (int j = 0; j < kInts; j++) b.ints[i][j] = ints[kInts * (first + i) + j];
      for (int j = 0; j < 4; j++) b.scale[i][j] = scales[4 * (first + i) + j];
    }
    float* o = out + size_t(first) * ph * pw * channels;
    dim3 grid((ph * pw + threads - 1) / threads, m);
    switch (channels) {
      case 3:
        compose_resize_pad_kernel<3><<<grid, threads, 0, st>>>(b, o, ph, pw, fmt);
        break;
      case 4:
        compose_resize_pad_kernel<4><<<grid, threads, 0, st>>>(b, o, ph, pw, fmt);
        break;
      case 6:
        compose_resize_pad_kernel<6><<<grid, threads, 0, st>>>(b, o, ph, pw, fmt);
        break;
      default:
        return int(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

int image_io_max_batch() { return kMaxBatch; }

}  // extern "C"
