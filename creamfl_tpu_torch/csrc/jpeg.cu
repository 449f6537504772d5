// JPEG decoding on the card: nvJPEG (the CUDA toolkit's decoder) for the
// entropy decoding, dequantisation and IDCT, then one hand-written kernel
// for libjpeg's chroma upsampling and colour conversion. Plain C interface
// for ctypes (creamfl_tpu_torch/data/jpeg.py).
//
// This replaces no TPU kernel: the JAX package decodes with PIL (libjpeg)
// on the host. nvJPEG's own RGB output upsamples chroma by replication and
// rounds its colour conversion otherwise, several levels away from PIL on
// detailed images. So nvjpegDecode (the default backend: Huffman decoding
// on the host, the rest on the card) writes each image's planes, at their
// subsampled sizes, into a scratch buffer (NVJPEG_OUTPUT_YUV for gray and
// YCbCr files, NVJPEG_OUTPUT_UNCHANGED, the components as they are stored,
// for RGB-coded, CMYK and YCCK files), and to_rgb_kernel then does what
// libjpeg-turbo does by default (jdsample.c "fancy" upsampling of each
// component from its own sampling factors: h2v1, h2v2, h1v2 triangle
// filters with their biased rounding, edge rows and columns replicated; box
// replication where libjpeg uses it; jdcolor.c's 16-bit fixed-point YCbCr
// -> RGB, and for YCCK its ycck_cmyk_convert) and then what PIL's
// convert("RGB") does to the Adobe-inverted CMYK it reads from libjpeg
// (cmyk2rgb), writing interleaved RGB into each image's slot of one padded
// [B, Hmax, Wmax, 3] uint8 buffer. What is left between the two decoders
// is the IDCT's rounding (ISLOW in libjpeg): a level on a few pixels.
//
// Bound: the kernel reads the planes and writes 3 bytes a pixel, a few
// integer operations each: bytes, a few microseconds a batch of 224-pixel
// images; the decode itself (host Huffman decoding, one image after
// another) is what takes the time. Batched or hardware-engine decode
// (H100's NVJPG engines) is later work.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;
nvjpegHandle_t g_handle[kMaxDevices];
nvjpegJpegState_t g_state[kMaxDevices];

// Error codes past nvJPEG's own statuses (which are below 100).
constexpr int kErrPlanes = 102;
constexpr int kErrDevice = 103;

// Per-image metadata, int64 each (data/jpeg.py:_META): the four planes'
// offsets, the image's size, colour space and component count, then per
// component its plane's width and height, upsampling mode and factors.
constexpr int kMaxComp = 4;
enum Meta { kOff0, kW = kMaxComp, kH, kColour, kNComp, kComp0 };
enum CompMeta { kCw, kCh, kMode, kHfac, kVfac, kCompLen };
constexpr int kMetaLen = kComp0 + kMaxComp * kCompLen;
// Upsampling modes and colour spaces (data/jpeg.py FULL.., GRAY..).
enum Mode { kFull, kH2V1, kH2V2, kH1V2, kBox };
enum Colour { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

int ensure_handle(int device) {
  if (device < 0 || device >= kMaxDevices) return kErrDevice;
  if (g_handle[device] != nullptr) return 0;
  nvjpegStatus_t st = nvjpegCreateSimple(&g_handle[device]);
  if (st != NVJPEG_STATUS_SUCCESS) {
    g_handle[device] = nullptr;
    return static_cast<int>(st);
  }
  st = nvjpegJpegStateCreate(g_handle[device], &g_state[device]);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(g_handle[device]);
    g_handle[device] = nullptr;
    return static_cast<int>(st);
  }
  return 0;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The sample at output pixel (x, y) of one component's plane (cw x ch, row
// pitch cw), upsampled as libjpeg-turbo's jdsample.c does.
__device__ int upsample(const uint8_t* p, int cw, int ch, int x, int y,
                        int mode, int hfac, int vfac) {
  if (mode == kFull) return p[y * cw + x];
  if (mode == kBox) return p[(y / vfac) * cw + (x / hfac)];
  if (mode == kH2V1) {  // h2v1_fancy_upsample
    const uint8_t* row = p + y * cw;
    int c = x >> 1;
    if ((x & 1) == 0) {
      return c == 0 ? row[0] : (row[c] * 3 + row[c - 1] + 1) >> 2;
    }
    return c == cw - 1 ? row[c] : (row[c] * 3 + row[c + 1] + 2) >> 2;
  }
  // h2v2 and h1v2: the nearer chroma row times 3 plus the other neighbour
  // (the row above for even output rows, below for odd; edge rows are
  // repeated).
  int r = y >> 1;
  int r1 = clampi((y & 1) ? r + 1 : r - 1, 0, ch - 1);
  const uint8_t* row0 = p + r * cw;
  const uint8_t* row1 = p + r1 * cw;
  if (mode == kH1V2) {  // h1v2_fancy_upsample
    return (row0[x] * 3 + row1[x] + ((y & 1) ? 2 : 1)) >> 2;
  }
  // h2v2_fancy_upsample: column sums, then 3:1 across columns.
  int c = x >> 1;
  int here = row0[c] * 3 + row1[c];
  if ((x & 1) == 0) {
    if (c == 0) return (here * 4 + 8) >> 4;
    int left = row0[c - 1] * 3 + row1[c - 1];
    return (here * 3 + left + 8) >> 4;
  }
  if (c == cw - 1) return (here * 4 + 7) >> 4;
  int right = row0[c + 1] * 3 + row1[c + 1];
  return (here * 3 + right + 7) >> 4;
}

__device__ __forceinline__ int range_limit(int v) { return clampi(v, 0, 255); }

// jdcolor.c build_ycc_rgb_table / ycc_rgb_convert, SCALEBITS 16:
// FIX(1.40200) = 91881, FIX(1.77200) = 116130, FIX(0.71414) = 46802,
// FIX(0.34414) = 22554; right shifts are arithmetic (floor). The same
// tables give ycck_cmyk_convert's 255 - R, 255 - G, 255 - B.
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, int* rgb) {
  const int half = 1 << 15;
  int xcb = cb - 128, xcr = cr - 128;
  rgb[0] = range_limit(y + ((91881 * xcr + half) >> 16));
  rgb[1] = range_limit(y + ((-22554 * xcb + half - 46802 * xcr) >> 16));
  rgb[2] = range_limit(y + ((116130 * xcb + half) >> 16));
}

// PIL's MULDIV255: round(a * b / 255) in integers.
__device__ __forceinline__ int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// One thread per output pixel of image blockIdx.z; pixels past the image
// keep the buffer's zeros.
__global__ void to_rgb_kernel(const uint8_t* __restrict__ planes,
                              const long long* __restrict__ meta,
                              uint8_t* __restrict__ out,
                              long long image_stride, int pitch) {
  const long long* m = meta + blockIdx.z * kMetaLen;
  int w = static_cast<int>(m[kW]), h = static_cast<int>(m[kH]);
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  uint8_t* o = out + blockIdx.z * image_stride + static_cast<long long>(y) *
                                                    pitch + 3 * x;
  int n = static_cast<int>(m[kNComp]);
  int c[kMaxComp] = {0, 0, 0, 0};
  for (int i = 0; i < n; ++i) {
    const long long* cm = m + kComp0 + i * kCompLen;
    c[i] = upsample(planes + m[kOff0 + i], static_cast<int>(cm[kCw]),
                    static_cast<int>(cm[kCh]), x, y,
                    static_cast<int>(cm[kMode]), static_cast<int>(cm[kHfac]),
                    static_cast<int>(cm[kVfac]));
  }
  int rgb[3];
  switch (static_cast<int>(m[kColour])) {
    case kGray:
      rgb[0] = rgb[1] = rgb[2] = c[0];
      break;
    case kYCbCr:
      ycc_rgb(c[0], c[1], c[2], rgb);
      break;
    case kRGB:
      rgb[0] = c[0], rgb[1] = c[1], rgb[2] = c[2];
      break;
    default: {
      // CMYK: PIL reads the ink as 255 - stored and gives nk - nk * ink /
      // 255 with nk = 255 - K = the stored K. YCCK: libjpeg first makes
      // the ink 255 - (Y, Cb, Cr -> R, G, B), which PIL reads as R, G, B.
      int ink[3];
      if (static_cast<int>(m[kColour]) == kCMYK) {
        ink[0] = 255 - c[0], ink[1] = 255 - c[1], ink[2] = 255 - c[2];
      } else {
        ycc_rgb(c[0], c[1], c[2], ink);
      }
      for (int i = 0; i < 3; ++i) rgb[i] = c[3] - muldiv255(ink[i], c[3]);
    }
  }
  o[0] = static_cast<uint8_t>(range_limit(rgb[0]));
  o[1] = static_cast<uint8_t>(range_limit(rgb[1]));
  o[2] = static_cast<uint8_t>(range_limit(rgb[2]));
}

}  // namespace

extern "C" {

// Decode n JPEG files (host bytes datas[i] of lengths[i]). meta_host and
// meta_dev hold the same [n][kMetaLen] int64 metadata (on the host and on
// the card): each image's plane offsets in the scratch buffer planes, its
// size and colour space, and each component's plane size and upsampling. nvJPEG writes the
// planes (tight rows), then one kernel writes RGB into out, image i at
// out + i * image_stride with rows pitch bytes apart, over an hmax x wmax
// grid. Returns 0, or an nvJPEG status / one of the codes above with
// *failed set to the image at fault, or 200 + a CUDA error.
int jpeg_decode(int device, int n, const unsigned char* const* datas,
                const size_t* lengths, const long long* meta_host,
                const long long* meta_dev, unsigned char* planes,
                unsigned char* out, long long image_stride, int pitch,
                int hmax, int wmax, void* stream_ptr, int* failed) {
  *failed = -1;
  int err = ensure_handle(device);
  if (err != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  nvjpegHandle_t handle = g_handle[device];
  nvjpegJpegState_t state = g_state[device];
  for (int i = 0; i < n; ++i) {
    const long long* m = meta_host + i * kMetaLen;
    int n_comp = 0;
    nvjpegChromaSubsampling_t subsampling;
    int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
    nvjpegStatus_t st = nvjpegGetImageInfo(handle, datas[i], lengths[i],
                                           &n_comp, &subsampling, w, h);
    if (st != NVJPEG_STATUS_SUCCESS) {
      *failed = i;
      return static_cast<int>(st);
    }
    int n_meta = static_cast<int>(m[kNComp]);
    bool planar = n_meta == 1 || m[kColour] == kYCbCr;
    bool same = n_comp == n_meta;
    for (int c = 0; same && c < n_meta; ++c) {
      const long long* cm = m + kComp0 + c * kCompLen;
      same = w[c] == cm[kCw] && h[c] == cm[kCh];
    }
    if (!same) {
      *failed = i;
      return kErrPlanes;
    }
    nvjpegImage_t img = {};
    for (int c = 0; c < n_meta; ++c) {
      img.channel[c] = planes + m[kOff0 + c];
      img.pitch[c] = static_cast<size_t>(m[kComp0 + c * kCompLen + kCw]);
    }
    st = nvjpegDecode(handle, state, datas[i], lengths[i],
                      planar ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_UNCHANGED,
                      &img, stream);
    if (st != NVJPEG_STATUS_SUCCESS) {
      *failed = i;
      return static_cast<int>(st);
    }
  }
  dim3 block(32, 8);
  dim3 grid((wmax + 31) / 32, (hmax + 7) / 8, n);
  to_rgb_kernel<<<grid, block, 0, stream>>>(planes, meta_dev, out,
                                            image_stride, pitch);
  cudaError_t cerr = cudaGetLastError();
  return cerr == cudaSuccess ? 0 : 200 + static_cast<int>(cerr);
}

}  // extern "C"
