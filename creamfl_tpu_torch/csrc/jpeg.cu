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
// subsampled sizes, into a scratch buffer (NVJPEG_OUTPUT_YUV), and
// ycc_to_rgb_kernel then does what libjpeg-turbo does by default (jdsample.c
// "fancy" upsampling: h2v1, h2v2, h1v2 triangle filters with their biased
// rounding, edge rows and columns replicated; box replication where libjpeg
// uses it; jdcolor.c's 16-bit fixed-point YCbCr -> RGB), writing
// interleaved RGB into each image's slot of one padded [B, Hmax, Wmax, 3]
// uint8 buffer. What is left between the two decoders is the IDCT's
// rounding (ISLOW in libjpeg): a level on a few pixels.
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

// Per-image metadata, int64 each (data/jpeg.py:_META).
enum Meta { kYOff, kCbOff, kCrOff, kW, kH, kCw, kCh, kMode, kHfac, kVfac,
            kMetaLen };
// Upsampling modes (data/jpeg.py:_MODES).
enum Mode { kGray, k444, kH2V1, kH2V2, kH1V2, kBox };

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

// The chroma sample at output pixel (x, y) of one plane (cw x ch, row
// pitch cw), upsampled as libjpeg-turbo's jdsample.c does.
__device__ int upsample(const uint8_t* p, int cw, int ch, int x, int y,
                        int mode, int hfac, int vfac) {
  if (mode == k444) return p[y * cw + x];
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

__device__ __forceinline__ uint8_t range_limit(int v) {
  return static_cast<uint8_t>(clampi(v, 0, 255));
}

// One thread per output pixel of image blockIdx.z; pixels past the image
// keep the buffer's zeros.
__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ planes,
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
  int yy = planes[m[kYOff] + static_cast<long long>(y) * w + x];
  int mode = static_cast<int>(m[kMode]);
  if (mode == kGray) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(yy);
    return;
  }
  int cw = static_cast<int>(m[kCw]), ch = static_cast<int>(m[kCh]);
  int hfac = static_cast<int>(m[kHfac]), vfac = static_cast<int>(m[kVfac]);
  int cb = upsample(planes + m[kCbOff], cw, ch, x, y, mode, hfac, vfac);
  int cr = upsample(planes + m[kCrOff], cw, ch, x, y, mode, hfac, vfac);
  // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert, SCALEBITS 16:
  // FIX(1.40200) = 91881, FIX(1.77200) = 116130, FIX(0.71414) = 46802,
  // FIX(0.34414) = 22554; right shifts are arithmetic (floor).
  const int half = 1 << 15;
  int xcb = cb - 128, xcr = cr - 128;
  int r = yy + ((91881 * xcr + half) >> 16);
  int g = yy + ((-22554 * xcb + half - 46802 * xcr) >> 16);
  int b = yy + ((116130 * xcb + half) >> 16);
  o[0] = range_limit(r);
  o[1] = range_limit(g);
  o[2] = range_limit(b);
}

}  // namespace

extern "C" {

// Decode n JPEG files (host bytes datas[i] of lengths[i]). meta_host and
// meta_dev hold the same [n][kMetaLen] int64 metadata (on the host and on
// the card): each image's plane offsets in the scratch buffer planes, its
// size, its chroma planes' size and its upsampling mode. nvJPEG writes the
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
    bool gray = m[kMode] == kGray;
    if (n_comp != (gray ? 1 : 3) || w[0] != m[kW] || h[0] != m[kH] ||
        (!gray && (w[1] != m[kCw] || h[1] != m[kCh] || w[2] != m[kCw] ||
                   h[2] != m[kCh]))) {
      *failed = i;
      return kErrPlanes;
    }
    nvjpegImage_t img = {};
    img.channel[0] = planes + m[kYOff];
    img.pitch[0] = static_cast<size_t>(m[kW]);
    if (!gray) {
      img.channel[1] = planes + m[kCbOff];
      img.channel[2] = planes + m[kCrOff];
      img.pitch[1] = img.pitch[2] = static_cast<size_t>(m[kCw]);
    }
    st = nvjpegDecode(handle, state, datas[i], lengths[i],
                      NVJPEG_OUTPUT_YUV, &img, stream);
    if (st != NVJPEG_STATUS_SUCCESS) {
      *failed = i;
      return static_cast<int>(st);
    }
  }
  dim3 block(32, 8);
  dim3 grid((wmax + 31) / 32, (hmax + 7) / 8, n);
  ycc_to_rgb_kernel<<<grid, block, 0, stream>>>(planes, meta_dev, out,
                                                image_stride, pitch);
  cudaError_t cerr = cudaGetLastError();
  return cerr == cudaSuccess ? 0 : 200 + static_cast<int>(cerr);
}

}  // extern "C"
