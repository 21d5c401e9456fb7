/*!
 * The host decode stage of mxnet_tpu_torch's input path: image decode,
 * encode and resize for the python tier (mxnet_tpu_torch/image), and the
 * no-GIL native image loader (io.NativeImageRecordIter), behind one C
 * interface that Python binds with ctypes (ctypes drops the GIL for the
 * length of each call).
 *
 * Decoders, chosen when the library is built (mxnet_tpu_torch/_host_build.py):
 * - MXT_JPEG_LIBJPEG: libjpeg's jpeg_mem_src, JDCT_ISLOW and fancy
 *   upsampling, at 8/8 what OpenCV's imdecode does.  The native loader
 *   may decode at a DCT-domain scale M/8 (PickScaleNum) when it resizes
 *   the short side afterwards.
 * - MXT_JPEG_NVJPEG: nvJPEG from the CUDA toolkit; the native loader
 *   decodes a ticket's JPEGs in one nvjpegDecodeBatched call on a stream
 *   of its worker, and the pixels come back to pinned host memory.
 *   JPEG encoding uses nvJPEG's encoder.
 * - MXT_WITH_ZLIB: PNG (8-bit, not interlaced) through zlib's inflate and
 *   the five row filters; PNG encoding through deflate.
 * A build without a JPEG decoder raises, naming the missing library, when
 * asked to decode or encode a JPEG.  No call swaps one decoder for
 * another.
 *
 * Resize: OpenCV's cv::resize on uint8 in its fixed-point form (11-bit
 * coefficients, half-pixel centres, border pixels replicated), nearest,
 * linear and cubic (A = -0.75); on float32 the same coefficients in
 * float.
 *
 * The native loader: W worker threads, each with its own file handle and
 * decoder state, claim whole-batch tickets, decode, resize the short
 * side, crop, mirror and stack CHW samples into a pooled batch buffer;
 * the consumer takes batches in ticket order through a bounded reorder
 * window.  Per-sample randomness is drawn from mt19937(seed ^ epoch ^
 * index), so a batch does not depend on scheduling.  Per-stage counters
 * (read / decode / augment / batchify µs, queue depth, backpressure and
 * consumer waits) come out as one JSON object.
 */
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>

#include "recordio_format.h"

#ifdef MXT_JPEG_LIBJPEG
#include <jpeglib.h>
#endif
#ifdef MXT_JPEG_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#endif
#ifdef MXT_WITH_ZLIB
#include <zlib.h>
#endif

namespace mxt {

thread_local std::string g_last_error;

// ----------------------------------------------------------- images ---
struct Img {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> px;          // HWC
  void Create(int hh, int ww, int cc) {
    h = hh; w = ww; c = cc;
    px.resize(static_cast<size_t>(h) * w * c);
  }
  uint8_t *Row(int y) { return px.data() + static_cast<size_t>(y) * w * c; }
  const uint8_t *Row(int y) const {
    return px.data() + static_cast<size_t>(y) * w * c;
  }
};

inline bool IsJpeg(const uint8_t *b, size_t n) {
  return n >= 3 && b[0] == 0xFF && b[1] == 0xD8 && b[2] == 0xFF;
}
inline bool IsPng(const uint8_t *b, size_t n) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  return n >= 8 && std::memcmp(b, sig, 8) == 0;
}

const char *JpegLibrary() {
#if defined(MXT_JPEG_LIBJPEG)
  return "libjpeg";
#elif defined(MXT_JPEG_NVJPEG)
  return "nvjpeg";
#else
  return "none";
#endif
}

[[noreturn]] void NoJpeg(const char *what) {
  throw std::runtime_error(
      std::string(what) + ": this build of the decode stage has no JPEG "
      "library (neither libjpeg's jpeglib.h / -ljpeg nor nvJPEG's nvjpeg.h "
      "/ -lnvjpeg under CUDA_HOME was found when it was built)");
}

// --------------------------------------------------------- libjpeg ---
#ifdef MXT_JPEG_LIBJPEG

// The smallest DCT-domain scale M/8 (M in 1, 2, 4) whose output short side
// still covers the resize-short target; libjpeg rounds output sizes up,
// so the resize after it only ever shrinks.  No target, or an image
// already under it, decodes at 8/8.
int PickScaleNum(int width, int height, int resize_short) {
  if (resize_short <= 0) return 8;
  int short_side = std::min(width, height);
  for (int num : {1, 2, 4}) {
    if ((short_side * num + 7) / 8 >= resize_short) return num;
  }
  return 8;
}

struct JpegErr {
  jpeg_error_mgr pub;               // first: cinfo->err points here
  std::jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void JpegErrorExit(j_common_ptr cinfo) {
  auto *e = reinterpret_cast<JpegErr *>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->msg);
  std::longjmp(e->jb, 1);
}

void JpegQuiet(j_common_ptr, int) {}

// One decompressor a thread or worker, reused across images.
class JpegDecoder {
 public:
  JpegDecoder() {
    cinfo_.err = jpeg_std_error(&err_.pub);
    err_.pub.error_exit = JpegErrorExit;
    err_.pub.emit_message = JpegQuiet;
    jpeg_create_decompress(&cinfo_);
  }
  ~JpegDecoder() { jpeg_destroy_decompress(&cinfo_); }
  JpegDecoder(const JpegDecoder &) = delete;
  JpegDecoder &operator=(const JpegDecoder &) = delete;

  // channels: 3 (RGB), 1 (gray) or 0 (the stream's own: 1 or 3).
  // Throws on a corrupt stream.
  void Decode(const uint8_t *buf, size_t len, int channels,
              int resize_short, Img *out, int *scale_num) {
    if (setjmp(err_.jb)) {
      jpeg_abort_decompress(&cinfo_);
      throw std::runtime_error(std::string("undecodable JPEG: ") +
                               err_.msg);
    }
    jpeg_mem_src(&cinfo_, const_cast<unsigned char *>(buf),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo_, TRUE);
    int comps = cinfo_.num_components;
    if (comps != 1 && comps != 3) {
      jpeg_abort_decompress(&cinfo_);
      throw std::runtime_error("JPEG with " + std::to_string(comps) +
                               " components (CMYK / YCCK) is not supported");
    }
    int c = channels == 0 ? comps : channels;
    cinfo_.out_color_space = c == 3 ? JCS_RGB : JCS_GRAYSCALE;
    int num = PickScaleNum(static_cast<int>(cinfo_.image_width),
                           static_cast<int>(cinfo_.image_height),
                           resize_short);
    cinfo_.scale_num = static_cast<unsigned>(num);
    cinfo_.scale_denom = 8;
    cinfo_.dct_method = JDCT_ISLOW;        // OpenCV's choice
    cinfo_.do_fancy_upsampling = TRUE;
    jpeg_start_decompress(&cinfo_);
    out->Create(static_cast<int>(cinfo_.output_height),
                static_cast<int>(cinfo_.output_width), c);
    while (cinfo_.output_scanline < cinfo_.output_height) {
      JSAMPROW row = out->Row(static_cast<int>(cinfo_.output_scanline));
      jpeg_read_scanlines(&cinfo_, &row, 1);
    }
    jpeg_finish_decompress(&cinfo_);
    if (scale_num) *scale_num = num;
  }

 private:
  jpeg_decompress_struct cinfo_;
  JpegErr err_;
};

std::vector<uint8_t> JpegEncode(const uint8_t *src, int h, int w, int c,
                                int quality, bool progressive) {
  jpeg_compress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = JpegErrorExit;
  err.pub.emit_message = JpegQuiet;
  unsigned char *mem = nullptr;
  unsigned long mem_len = 0;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::free(mem);
    throw std::runtime_error(std::string("JPEG encode failed: ") + err.msg);
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = c;
  cinfo.in_color_space = c == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (progressive) jpeg_simple_progression(&cinfo);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        src + static_cast<size_t>(cinfo.next_scanline) * w * c);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  std::vector<uint8_t> out(mem, mem + mem_len);
  jpeg_destroy_compress(&cinfo);
  std::free(mem);
  return out;
}

#endif  // MXT_JPEG_LIBJPEG

// ---------------------------------------------------------- nvJPEG ---
#ifdef MXT_JPEG_NVJPEG

#define MXT_NVJ(call)                                                   \
  do {                                                                  \
    nvjpegStatus_t st_ = (call);                                        \
    if (st_ != NVJPEG_STATUS_SUCCESS)                                   \
      throw std::runtime_error(std::string("nvJPEG: ") + #call +        \
                               " returned " + std::to_string(st_));     \
  } while (0)
#define MXT_CUDA(call)                                                  \
  do {                                                                  \
    cudaError_t e_ = (call);                                            \
    if (e_ != cudaSuccess)                                              \
      throw std::runtime_error(std::string("CUDA: ") + #call + ": " +   \
                               cudaGetErrorString(e_));                 \
  } while (0)

nvjpegHandle_t NvjpegHandle() {
  static std::once_flag once;
  static nvjpegHandle_t handle = nullptr;
  static std::string err;
  std::call_once(once, [] {
    if (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS) {
      handle = nullptr;
      err = "nvjpegCreateSimple failed (no CUDA device?)";
    }
  });
  if (!handle) throw std::runtime_error("nvJPEG: " + err);
  return handle;
}

// One decode state, stream and pair of buffers (device, pinned host) a
// thread or worker.
class NvjpegDecoder {
 public:
  NvjpegDecoder() {
    handle_ = NvjpegHandle();
    MXT_NVJ(nvjpegJpegStateCreate(handle_, &state_));
    MXT_CUDA(cudaStreamCreateWithFlags(&stream_, cudaStreamNonBlocking));
  }
  ~NvjpegDecoder() {
    if (dbuf_) cudaFree(dbuf_);
    if (hbuf_) cudaFreeHost(hbuf_);
    if (ebuf_) cudaFree(ebuf_);
    if (enc_params_) nvjpegEncoderParamsDestroy(enc_params_);
    if (enc_state_) nvjpegEncoderStateDestroy(enc_state_);
    if (state_) nvjpegJpegStateDestroy(state_);
    if (stream_) cudaStreamDestroy(stream_);
  }
  NvjpegDecoder(const NvjpegDecoder &) = delete;
  NvjpegDecoder &operator=(const NvjpegDecoder &) = delete;

  // Decode n JPEG streams in one batched call; channels 3 (RGB) or 1 (Y),
  // 0 = each stream's own component count (1 or 3), which must agree.
  void DecodeBatch(const std::vector<const uint8_t *> &data,
                   const std::vector<size_t> &lens, int channels,
                   std::vector<Img *> *outs) {
    int n = static_cast<int>(data.size());
    if (n == 0) return;
    std::vector<int> hs(n), ws(n);
    std::vector<size_t> off(n + 1, 0);
    int c = channels;
    for (int i = 0; i < n; ++i) {
      int comps = 0;
      nvjpegChromaSubsampling_t ss;
      int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
      if (nvjpegGetImageInfo(handle_, data[i], lens[i], &comps, &ss, widths,
                             heights) != NVJPEG_STATUS_SUCCESS)
        throw std::runtime_error("undecodable JPEG (nvjpegGetImageInfo)");
      if (comps != 1 && comps != 3)
        throw std::runtime_error("JPEG with " + std::to_string(comps) +
                                 " components is not supported");
      if (channels == 0) {
        if (i == 0) c = comps;
        else if (comps != c)
          throw std::runtime_error("batched decode of mixed component "
                                   "counts needs channels=1 or 3");
      }
      hs[i] = heights[0];
      ws[i] = widths[0];
      off[i + 1] = off[i] + static_cast<size_t>(hs[i]) * ws[i] * c;
    }
    Reserve(off[n]);
    nvjpegOutputFormat_t fmt = c == 3 ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_Y;
    if (batched_n_ != n || batched_fmt_ != static_cast<int>(fmt)) {
      MXT_NVJ(nvjpegDecodeBatchedInitialize(handle_, state_, n, 1, fmt));
      batched_n_ = n;
      batched_fmt_ = static_cast<int>(fmt);
    }
    std::vector<nvjpegImage_t> dest(n);
    for (int i = 0; i < n; ++i) {
      std::memset(&dest[i], 0, sizeof(nvjpegImage_t));
      dest[i].channel[0] = dbuf_ + off[i];
      dest[i].pitch[0] = static_cast<size_t>(ws[i]) * c;
    }
    nvjpegStatus_t st = nvjpegDecodeBatched(handle_, state_, data.data(),
                                            lens.data(), dest.data(),
                                            stream_);
    if (st != NVJPEG_STATUS_SUCCESS) {
      batched_n_ = -1;     // a failed call leaves the state to re-init
      throw std::runtime_error("undecodable JPEG in a batch "
                               "(nvjpegDecodeBatched returned " +
                               std::to_string(st) + ")");
    }
    MXT_CUDA(cudaMemcpyAsync(hbuf_, dbuf_, off[n], cudaMemcpyDeviceToHost,
                             stream_));
    MXT_CUDA(cudaStreamSynchronize(stream_));
    for (int i = 0; i < n; ++i) {
      (*outs)[i]->Create(hs[i], ws[i], c);
      std::memcpy((*outs)[i]->px.data(), hbuf_ + off[i], off[i + 1] - off[i]);
    }
  }

  std::vector<uint8_t> Encode(const uint8_t *src, int h, int w, int c,
                              int quality, bool progressive) {
    if (!enc_state_) {
      MXT_NVJ(nvjpegEncoderStateCreate(handle_, &enc_state_, stream_));
      MXT_NVJ(nvjpegEncoderParamsCreate(handle_, &enc_params_, stream_));
    }
    MXT_NVJ(nvjpegEncoderParamsSetQuality(enc_params_, quality, stream_));
    MXT_NVJ(nvjpegEncoderParamsSetEncoding(
        enc_params_, progressive ? NVJPEG_ENCODING_PROGRESSIVE_DCT_HUFFMAN
                                 : NVJPEG_ENCODING_BASELINE_DCT,
        stream_));
    MXT_NVJ(nvjpegEncoderParamsSetSamplingFactors(
        enc_params_, c == 3 ? NVJPEG_CSS_420 : NVJPEG_CSS_GRAY, stream_));
    size_t n = static_cast<size_t>(h) * w * c;
    if (n > ecap_) {
      if (ebuf_) cudaFree(ebuf_);
      ebuf_ = nullptr;
      MXT_CUDA(cudaMalloc(reinterpret_cast<void **>(&ebuf_), n));
      ecap_ = n;
    }
    MXT_CUDA(cudaMemcpyAsync(ebuf_, src, n, cudaMemcpyHostToDevice,
                             stream_));
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof img);
    img.channel[0] = ebuf_;
    img.pitch[0] = static_cast<size_t>(w) * c;
    if (c == 3) {
      MXT_NVJ(nvjpegEncodeImage(handle_, enc_state_, enc_params_, &img,
                                NVJPEG_INPUT_RGBI, w, h, stream_));
    } else {
      MXT_NVJ(nvjpegEncodeYUV(handle_, enc_state_, enc_params_, &img,
                              NVJPEG_CSS_GRAY, w, h, stream_));
    }
    size_t len = 0;
    MXT_NVJ(nvjpegEncodeRetrieveBitstream(handle_, enc_state_, nullptr, &len,
                                          stream_));
    MXT_CUDA(cudaStreamSynchronize(stream_));
    std::vector<uint8_t> out(len);
    MXT_NVJ(nvjpegEncodeRetrieveBitstream(handle_, enc_state_, out.data(),
                                          &len, stream_));
    MXT_CUDA(cudaStreamSynchronize(stream_));
    out.resize(len);
    return out;
  }

 private:
  void Reserve(size_t n) {
    if (n <= cap_) return;
    if (dbuf_) cudaFree(dbuf_);
    if (hbuf_) cudaFreeHost(hbuf_);
    dbuf_ = hbuf_ = nullptr;
    cap_ = 0;
    MXT_CUDA(cudaMalloc(reinterpret_cast<void **>(&dbuf_), n));
    MXT_CUDA(cudaMallocHost(reinterpret_cast<void **>(&hbuf_), n));
    cap_ = n;
  }

  nvjpegHandle_t handle_ = nullptr;
  nvjpegJpegState_t state_ = nullptr;
  cudaStream_t stream_ = nullptr;
  nvjpegEncoderState_t enc_state_ = nullptr;
  nvjpegEncoderParams_t enc_params_ = nullptr;
  uint8_t *dbuf_ = nullptr, *hbuf_ = nullptr, *ebuf_ = nullptr;
  size_t cap_ = 0, ecap_ = 0;
  int batched_n_ = -1, batched_fmt_ = -1;
};

#endif  // MXT_JPEG_NVJPEG

// ------------------------------------------------------------- PNG ---
#ifdef MXT_WITH_ZLIB

inline uint32_t BE32(const uint8_t *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int Paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// channels: 3 (RGB, alpha dropped, palette expanded, gray replicated),
// 1 (gray; colour through libpng's rgb_to_gray weights, which OpenCV's
// PNG reader asks for) or 0 (the file's own: 1, 3 or 4).
void PngDecode(const uint8_t *buf, size_t len, int channels, Img *out) {
  if (!IsPng(buf, len)) throw std::runtime_error("not a PNG stream");
  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = -1, interlace = 0;
  std::vector<uint8_t> idat, plte;
  bool seen_end = false;
  while (pos + 12 <= len && !seen_end) {
    uint32_t n = BE32(buf + pos);
    const uint8_t *type = buf + pos + 4;
    if (pos + 12 + static_cast<size_t>(n) > len)
      throw std::runtime_error("undecodable PNG: truncated chunk");
    const uint8_t *data = type + 4;
    uint32_t crc = BE32(data + n);
    if (crc32(crc32(0L, Z_NULL, 0), type, n + 4) != crc)
      throw std::runtime_error("undecodable PNG: chunk CRC mismatch");
    if (std::memcmp(type, "IHDR", 4) == 0 && n >= 13) {
      width = BE32(data);
      height = BE32(data + 4);
      depth = data[8];
      ctype = data[9];
      interlace = data[12];
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      plte.assign(data, data + n);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + n);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      seen_end = true;
    }
    pos += 12 + n;
  }
  if (ctype < 0 || width == 0 || height == 0)
    throw std::runtime_error("undecodable PNG: no IHDR");
  if (depth != 8)
    throw std::runtime_error("PNG of bit depth " + std::to_string(depth) +
                             " is not supported (8 only)");
  if (interlace != 0)
    throw std::runtime_error("interlaced PNG is not supported");
  int fc;                               // channels a pixel in the file
  switch (ctype) {
    case 0: fc = 1; break;
    case 2: fc = 3; break;
    case 3: fc = 1; break;
    case 4: fc = 2; break;
    case 6: fc = 4; break;
    default:
      throw std::runtime_error("undecodable PNG: colour type " +
                               std::to_string(ctype));
  }
  if (ctype == 3 && plte.size() < 3)
    throw std::runtime_error("undecodable PNG: palette image without PLTE");
  size_t stride = static_cast<size_t>(width) * fc;
  std::vector<uint8_t> raw((stride + 1) * height);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK)
    throw std::runtime_error("zlib inflateInit failed");
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  int zr = inflate(&zs, Z_FINISH);
  size_t got = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if ((zr != Z_STREAM_END && zr != Z_BUF_ERROR) || got != raw.size())
    throw std::runtime_error("undecodable PNG: bad or short image data");
  // unfilter in place (bpp = fc bytes at depth 8)
  std::vector<uint8_t> pix(stride * height);
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t *in = raw.data() + y * (stride + 1);
    uint8_t f = in[0];
    ++in;
    uint8_t *cur = pix.data() + y * stride;
    const uint8_t *prev = y ? cur - stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= static_cast<size_t>(fc) ? cur[x - fc] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= static_cast<size_t>(fc)) ? prev[x - fc] : 0;
      int v = in[x];
      switch (f) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += Paeth(a, b, c); break;
        default:
          throw std::runtime_error("undecodable PNG: filter type " +
                                   std::to_string(f));
      }
      cur[x] = static_cast<uint8_t>(v);
    }
  }
  // to the requested channels
  int own = ctype == 3 ? 3 : (fc == 2 ? 4 : fc);
  int c = channels == 0 ? own : channels;
  out->Create(static_cast<int>(height), static_cast<int>(width), c);
  size_t np = static_cast<size_t>(width) * height;
  const uint8_t *p = pix.data();
  uint8_t *o = out->px.data();
  // libpng's png_set_rgb_to_gray(0.299, 0.587) weights, in 1/32768
  const int rc = 9797, gc = 19234, bc = 32768 - 9797 - 19234;
  for (size_t i = 0; i < np; ++i, p += fc, o += c) {
    uint8_t r, g, b, al = 255;
    if (ctype == 3) {
      size_t k = static_cast<size_t>(p[0]) * 3;
      if (k + 2 >= plte.size())
        throw std::runtime_error("undecodable PNG: palette index");
      r = plte[k]; g = plte[k + 1]; b = plte[k + 2];
    } else if (fc <= 2) {
      r = g = b = p[0];
      if (fc == 2) al = p[1];
    } else {
      r = p[0]; g = p[1]; b = p[2];
      if (fc == 4) al = p[3];
    }
    if (c == 1) {
      o[0] = (fc <= 2 && ctype != 3)
                 ? r
                 : static_cast<uint8_t>((rc * r + gc * g + bc * b + 16384) >>
                                        15);
    } else {
      o[0] = r; o[1] = g; o[2] = b;
      if (c == 4) o[3] = al;
    }
  }
}

void PutBE32(std::vector<uint8_t> *v, uint32_t x) {
  v->push_back(uint8_t(x >> 24)); v->push_back(uint8_t(x >> 16));
  v->push_back(uint8_t(x >> 8)); v->push_back(uint8_t(x));
}

void PutChunk(std::vector<uint8_t> *v, const char *type,
              const uint8_t *data, size_t n) {
  PutBE32(v, static_cast<uint32_t>(n));
  size_t at = v->size();
  v->insert(v->end(), type, type + 4);
  if (n) v->insert(v->end(), data, data + n);
  uint32_t crc = crc32(crc32(0L, Z_NULL, 0), v->data() + at, n + 4);
  PutBE32(v, crc);
}

// 8-bit gray (c 1), RGB (c 3) or RGBA (c 4), filter 0 on every row.
std::vector<uint8_t> PngEncode(const uint8_t *src, int h, int w, int c,
                               int level) {
  if (c != 1 && c != 3 && c != 4)
    throw std::runtime_error("PNG encode takes 1, 3 or 4 channels");
  size_t stride = static_cast<size_t>(w) * c;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], src + y * stride, stride);
  }
  uLongf zlen = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), static_cast<uLong>(raw.size()),
                level) != Z_OK)
    throw std::runtime_error("zlib compress2 failed");
  std::vector<uint8_t> out = {137, 80, 78, 71, 13, 10, 26, 10};
  uint8_t ihdr[13];
  for (int i = 0; i < 4; ++i) {
    ihdr[i] = uint8_t(uint32_t(w) >> (24 - 8 * i));
    ihdr[4 + i] = uint8_t(uint32_t(h) >> (24 - 8 * i));
  }
  ihdr[8] = 8;
  ihdr[9] = c == 1 ? 0 : (c == 3 ? 2 : 6);
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  PutChunk(&out, "IHDR", ihdr, 13);
  PutChunk(&out, "IDAT", z.data(), zlen);
  PutChunk(&out, "IEND", nullptr, 0);
  return out;
}

#endif  // MXT_WITH_ZLIB

// ------------------------------------------------------- decoders ---
// A thread's or a worker's decoder: JPEG through the library the build
// names, PNG through zlib.
class Decoder {
 public:
  // Decode one stream; resize_short > 0 lets libjpeg pick a DCT scale.
  void DecodeOne(const uint8_t *buf, size_t len, int channels,
                 int resize_short, Img *out, int *scale_num) {
    if (scale_num) *scale_num = 8;
    if (IsJpeg(buf, len)) {
#if defined(MXT_JPEG_LIBJPEG)
      jpeg_.Decode(buf, len, channels, resize_short, out, scale_num);
#elif defined(MXT_JPEG_NVJPEG)
      (void)resize_short;
      std::vector<const uint8_t *> d{buf};
      std::vector<size_t> l{len};
      std::vector<Img *> o{out};
      Nv()->DecodeBatch(d, l, channels, &o);
#else
      (void)resize_short;
      NoJpeg("JPEG decode");
#endif
      return;
    }
    DecodeOther(buf, len, channels, out);
  }

  // Decode a ticket's streams: JPEGs in one batched call under nvJPEG,
  // one by one under libjpeg; PNGs through zlib.  scale[i] is the DCT
  // scale each image took (8 where none).  Counts go to *jpegs / *pngs.
  void DecodeMany(const std::vector<const uint8_t *> &bufs,
                  const std::vector<size_t> &lens, int channels,
                  int resize_short, std::vector<Img> *outs,
                  std::vector<int> *scale, int *jpegs, int *pngs) {
    size_t n = bufs.size();
    outs->resize(n);
    scale->assign(n, 8);
    *jpegs = *pngs = 0;
#if defined(MXT_JPEG_NVJPEG)
    std::vector<const uint8_t *> jd;
    std::vector<size_t> jl;
    std::vector<Img *> jo;
#endif
    for (size_t i = 0; i < n; ++i) {
      if (IsJpeg(bufs[i], lens[i])) {
        ++*jpegs;
#if defined(MXT_JPEG_LIBJPEG)
        jpeg_.Decode(bufs[i], lens[i], channels, resize_short, &(*outs)[i],
                     &(*scale)[i]);
#elif defined(MXT_JPEG_NVJPEG)
        jd.push_back(bufs[i]);
        jl.push_back(lens[i]);
        jo.push_back(&(*outs)[i]);
#else
        NoJpeg("JPEG decode");
#endif
      } else {
        ++*pngs;
        DecodeOther(bufs[i], lens[i], channels, &(*outs)[i]);
      }
    }
#if defined(MXT_JPEG_NVJPEG)
    if (!jd.empty()) Nv()->DecodeBatch(jd, jl, channels, &jo);
#endif
    (void)resize_short;
  }

  std::vector<uint8_t> EncodeJpeg(const uint8_t *src, int h, int w, int c,
                                  int quality, bool progressive) {
#if defined(MXT_JPEG_LIBJPEG)
    return JpegEncode(src, h, w, c, quality, progressive);
#elif defined(MXT_JPEG_NVJPEG)
    return Nv()->Encode(src, h, w, c, quality, progressive);
#else
    (void)src; (void)h; (void)w; (void)c; (void)quality; (void)progressive;
    NoJpeg("JPEG encode");
#endif
  }

 private:
  void DecodeOther(const uint8_t *buf, size_t len, int channels, Img *out) {
    if (IsPng(buf, len)) {
#ifdef MXT_WITH_ZLIB
      PngDecode(buf, len, channels, out);
      return;
#else
      throw std::runtime_error("PNG decode: this build of the decode stage "
                               "has no zlib (zlib.h / -lz)");
#endif
    }
    throw std::runtime_error("undecodable image: neither JPEG nor PNG");
  }

#if defined(MXT_JPEG_LIBJPEG)
  JpegDecoder jpeg_;
#elif defined(MXT_JPEG_NVJPEG)
  NvjpegDecoder *Nv() {
    if (!nv_) nv_.reset(new NvjpegDecoder());
    return nv_.get();
  }
  std::unique_ptr<NvjpegDecoder> nv_;
#endif
};

Decoder &ThreadDecoder() {
  thread_local Decoder dec;
  return dec;
}

// ---------------------------------------------------------- resize ---
// cv::resize's tables: for each output column (row) its first source
// tap and ksize coefficients.  Nearest: one tap; linear: two, clamped
// to the border with the weight moved onto the edge pixel; cubic: four,
// taps past the border replicate the edge.
constexpr int kCoefBits = 11;
constexpr int kCoefScale = 1 << kCoefBits;

struct AxisTab {
  int ksize = 1;
  std::vector<int> ofs;      // first tap (may be < 0 or past the end: cubic)
  std::vector<float> fw;     // ksize weights an output (float)
  std::vector<int> iw;       // the same in 1/2048 (saturate_cast<short>)
};

void CubicCoeffs(float x, float *c) {
  const float A = -0.75f;
  c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
  c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
  c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
  c[3] = 1.f - c[0] - c[1] - c[2];
}

AxisTab MakeTab(int ssize, int dsize, int interp) {
  AxisTab t;
  double inv_scale = static_cast<double>(dsize) / ssize;
  double scale = 1.0 / inv_scale;
  t.ksize = interp == 0 ? 1 : (interp == 1 ? 2 : 4);
  t.ofs.resize(dsize);
  t.fw.resize(static_cast<size_t>(dsize) * t.ksize);
  t.iw.resize(static_cast<size_t>(dsize) * t.ksize);
  for (int d = 0; d < dsize; ++d) {
    float cb[4] = {1.f, 0.f, 0.f, 0.f};
    if (interp == 0) {
      int s = static_cast<int>(std::floor(d * scale));
      t.ofs[d] = std::min(s, ssize - 1);
    } else {
      float fx = static_cast<float>((d + 0.5) * scale - 0.5);
      int sx = static_cast<int>(std::floor(fx));
      fx -= sx;
      if (interp == 1) {
        if (sx < 0) { fx = 0; sx = 0; }
        if (sx >= ssize - 1) { fx = 0; sx = ssize - 1; }
        cb[0] = 1.f - fx;
        cb[1] = fx;
        t.ofs[d] = sx;
      } else {
        CubicCoeffs(fx, cb);
        t.ofs[d] = sx - 1;
      }
    }
    for (int k = 0; k < t.ksize; ++k) {
      t.fw[static_cast<size_t>(d) * t.ksize + k] = cb[k];
      float v = cb[k] * kCoefScale;
      long r = std::lrintf(v);                 // cvRound: to nearest even
      r = std::max<long>(-32768, std::min<long>(32767, r));
      t.iw[static_cast<size_t>(d) * t.ksize + k] = static_cast<int>(r);
    }
  }
  return t;
}

inline int Clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// uint8: horizontal pass into int rows (value * 2048), vertical pass with
// the 22-bit rounding shift and saturation, as cv::resize's scalar path.
void ResizeU8(const uint8_t *src, int sh, int sw, int c, uint8_t *dst,
              int dh, int dw, int interp) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * c);
    return;
  }
  if (interp == 0) {
    AxisTab tx = MakeTab(sw, dw, 0), ty = MakeTab(sh, dh, 0);
    for (int y = 0; y < dh; ++y) {
      const uint8_t *srow = src + static_cast<size_t>(ty.ofs[y]) * sw * c;
      uint8_t *drow = dst + static_cast<size_t>(y) * dw * c;
      for (int x = 0; x < dw; ++x)
        std::memcpy(drow + x * c, srow + tx.ofs[x] * c, c);
    }
    return;
  }
  AxisTab tx = MakeTab(sw, dw, interp), ty = MakeTab(sh, dh, interp);
  int kx = tx.ksize, ky = ty.ksize;
  // horizontal pass of every source row the vertical pass needs
  std::vector<int> hrow(static_cast<size_t>(sh) * dw * c);
  for (int y = 0; y < sh; ++y) {
    const uint8_t *s = src + static_cast<size_t>(y) * sw * c;
    int *h = hrow.data() + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      const int *w = &tx.iw[static_cast<size_t>(x) * kx];
      for (int ch = 0; ch < c; ++ch) {
        int acc = 0;
        for (int k = 0; k < kx; ++k) {
          int sx = Clamp(tx.ofs[x] + k, 0, sw - 1);
          acc += s[sx * c + ch] * w[k];
        }
        h[x * c + ch] = acc;
      }
    }
  }
  const int shift = 2 * kCoefBits, delta = 1 << (shift - 1);
  for (int y = 0; y < dh; ++y) {
    const int *w = &ty.iw[static_cast<size_t>(y) * ky];
    const int *rows[4];
    for (int k = 0; k < ky; ++k)
      rows[k] = hrow.data() +
                static_cast<size_t>(Clamp(ty.ofs[y] + k, 0, sh - 1)) * dw * c;
    uint8_t *d = dst + static_cast<size_t>(y) * dw * c;
    for (int i = 0; i < dw * c; ++i) {
      long long acc = 0;
      for (int k = 0; k < ky; ++k)
        acc += static_cast<long long>(rows[k][i]) * w[k];
      long long v = (acc + delta) >> shift;
      d[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

void ResizeF32(const float *src, int sh, int sw, int c, float *dst, int dh,
               int dw, int interp) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, sizeof(float) * sh * sw * c);
    return;
  }
  AxisTab tx = MakeTab(sw, dw, interp), ty = MakeTab(sh, dh, interp);
  int kx = tx.ksize, ky = ty.ksize;
  std::vector<float> hrow(static_cast<size_t>(sh) * dw * c);
  for (int y = 0; y < sh; ++y) {
    const float *s = src + static_cast<size_t>(y) * sw * c;
    float *h = hrow.data() + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      const float *w = &tx.fw[static_cast<size_t>(x) * kx];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < kx; ++k) {
          int sx = Clamp(tx.ofs[x] + k, 0, sw - 1);
          acc += s[sx * c + ch] * w[k];
        }
        h[x * c + ch] = acc;
      }
    }
  }
  for (int y = 0; y < dh; ++y) {
    const float *w = &ty.fw[static_cast<size_t>(y) * ky];
    const float *rows[4];
    for (int k = 0; k < ky; ++k)
      rows[k] = hrow.data() +
                static_cast<size_t>(Clamp(ty.ofs[y] + k, 0, sh - 1)) * dw * c;
    float *d = dst + static_cast<size_t>(y) * dw * c;
    for (int i = 0; i < dw * c; ++i) {
      float acc = 0.f;
      for (int k = 0; k < ky; ++k) acc += rows[k][i] * w[k];
      d[i] = acc;
    }
  }
}

void ResizeImg(const Img &in, int dh, int dw, Img *out) {
  Img tmp;
  tmp.Create(dh, dw, in.c);
  ResizeU8(in.px.data(), in.h, in.w, in.c, tmp.px.data(), dh, dw, 1);
  *out = std::move(tmp);
}

// ---------------------------------------------------------- loader ---
struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};

bool ReadRecordAt(std::FILE *fp, size_t offset, std::vector<char> *out) {
  if (std::fseek(fp, static_cast<long>(offset), SEEK_SET) != 0) return false;
  return recfmt::ReadOneRecord(fp, out);
}

inline uint64_t NowUs() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::microseconds>(
          std::chrono::steady_clock::now().time_since_epoch()).count());
}

struct Batch {
  std::vector<float> f32;      // out_dtype 0
  std::vector<uint8_t> u8;     // out_dtype 1 (the uint8 wire)
  std::vector<float> label;
  int n_valid = 0;
};

struct StageUs {
  uint64_t read = 0, decode = 0, augment = 0, batchify = 0;
};

// One a worker, on its own cache line; summed by a stats snapshot.
struct alignas(64) WorkerStats {
  std::atomic<uint64_t> read_us{0}, decode_us{0}, augment_us{0},
      batchify_us{0}, batches{0}, samples{0}, backpressure_waits{0},
      jpeg_decodes{0}, png_decodes{0};
  std::atomic<uint64_t> scale_counts[4] = {{0}, {0}, {0}, {0}};  // 1,2,4,8

  void Zero() {
    read_us = 0; decode_us = 0; augment_us = 0; batchify_us = 0;
    batches = 0; samples = 0; backpressure_waits = 0;
    jpeg_decodes = 0; png_decodes = 0;
    for (auto &s : scale_counts) s = 0;
  }
};

inline int ScaleIdx(int num) {
  return num == 1 ? 0 : num == 2 ? 1 : num == 4 ? 2 : 3;
}

void CheckBackend(const char *name) {
  std::string s = name ? name : "";
  if (s.empty() || s == "auto") return;
  if (s != "libjpeg" && s != "nvjpeg")
    throw std::runtime_error("unknown decode backend '" + s +
                             "' (expected auto | libjpeg | nvjpeg)");
  if (s != JpegLibrary())
    throw std::runtime_error("decode backend '" + s +
                             "' requested, but this build of the decode "
                             "stage decodes JPEG with " + JpegLibrary());
}

class Loader {
 public:
  Loader(const std::string &rec_path, const std::string &idx_path,
         int batch, int channels, int h, int w, int resize, bool shuffle,
         uint64_t seed, int n_threads, bool mirror, bool rand_crop,
         int label_width, int prefetch, int out_dtype,
         const char *decode_backend, int claim_window)
      : rec_path_(rec_path), batch_(batch), c_(channels), h_(h), w_(w),
        resize_(resize), shuffle_(shuffle), seed_(seed), mirror_(mirror),
        rand_crop_(rand_crop), label_width_(label_width),
        out_u8_(out_dtype == 1) {
    CheckBackend(decode_backend);
    if (c_ != 1 && c_ != 3)
      throw std::runtime_error("the loader takes 1 or 3 channels");
    std::FILE *probe = std::fopen(rec_path.c_str(), "rb");
    if (!probe)
      throw std::runtime_error("cannot open rec file " + rec_path);
    std::fclose(probe);
    std::FILE *f = std::fopen(idx_path.c_str(), "r");
    if (!f)
      throw std::runtime_error("cannot open idx file " + idx_path);
    char line[256];
    while (std::fgets(line, sizeof line, f)) {
      unsigned long long key = 0, off = 0;
      if (std::sscanf(line, "%llu %llu", &key, &off) == 2)
        offsets_.push_back(static_cast<size_t>(off));
    }
    std::fclose(f);
    if (offsets_.empty())
      throw std::runtime_error("empty idx file " + idx_path);
    order_.resize(offsets_.size());
    n_threads_ = n_threads < 1 ? 1 : n_threads;
    claim_window_ = std::max({claim_window > 0 ? claim_window : prefetch,
                              n_threads_, 2});
    ResetOrderLocked();
    wstats_.reset(new WorkerStats[n_threads_]);
    n_live_ = n_threads_;
    for (int i = 0; i < n_threads_; ++i)
      workers_.emplace_back([this, i] { this->Work(i); });
  }

  ~Loader() {
    stop_.store(true);
    { std::lock_guard<std::mutex> lk(claim_mu_); }
    { std::lock_guard<std::mutex> lk(mu_); }
    cv_claim_.notify_all();
    cv_done_.notify_all();
    for (auto &t : workers_) t.join();
  }

  int NumBatches() const {
    return static_cast<int>((offsets_.size() + batch_ - 1) / batch_);
  }

  bool OutU8() const { return out_u8_; }

  // Fills data (batch*c*h*w, float32 or uint8) and label
  // (batch*label_width); returns the valid rows, 0 at the epoch's end.
  int Next(void *data, float *label) {
    int want = next_out_.load(std::memory_order_relaxed);
    if (want >= NumBatches()) return 0;
    std::unique_lock<std::mutex> lk(mu_);
    if (!(stop_.load() || !error_.empty() || n_live_ == 0 ||
          ready_.count(want) > 0)) {
      consumer_waits_.fetch_add(1, std::memory_order_relaxed);
      uint64_t t0 = NowUs();
      cv_done_.wait(lk, [this, want] {
        return stop_.load() || !error_.empty() || n_live_ == 0 ||
               ready_.count(want) > 0;
      });
      consumer_wait_us_.fetch_add(NowUs() - t0, std::memory_order_relaxed);
    }
    if (!error_.empty()) throw std::runtime_error(error_);
    if (ready_.count(want) == 0 && n_live_ == 0)
      throw std::runtime_error("all loader workers exited");
    if (stop_.load()) return 0;
    Batch b = std::move(ready_[want]);
    ready_.erase(want);
    lk.unlock();
    next_out_.fetch_add(1, std::memory_order_release);
    { std::lock_guard<std::mutex> clk(claim_mu_); }
    cv_claim_.notify_all();
    if (out_u8_)
      std::memcpy(data, b.u8.data(), b.u8.size());
    else
      std::memcpy(data, b.f32.data(), b.f32.size() * sizeof(float));
    std::memcpy(label, b.label.data(), b.label.size() * sizeof(float));
    int n = b.n_valid;
    Recycle(std::move(b));
    return n;
  }

  void Reset() {
    std::unique_lock<std::mutex> clk(claim_mu_);
    draining_ = true;
    cv_claim_.wait(clk, [this] { return stop_.load() || in_flight_ == 0; });
    if (stop_.load()) { draining_ = false; return; }
    ++epoch_;
    ResetOrderLocked();
    std::vector<Batch> stale;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (auto &kv : ready_) stale.push_back(std::move(kv.second));
      ready_.clear();
      error_.clear();
    }
    {
      std::lock_guard<std::mutex> plk(pool_mu_);
      for (auto &b : stale)
        if (pool_.size() < PoolCap()) pool_.push_back(std::move(b));
    }
    next_out_.store(0, std::memory_order_release);
    draining_ = false;
    clk.unlock();
    cv_claim_.notify_all();
  }

  void StatsReset() {
    for (int i = 0; i < n_threads_; ++i) wstats_[i].Zero();
    consumer_waits_.store(0, std::memory_order_relaxed);
    consumer_wait_us_.store(0, std::memory_order_relaxed);
  }

  std::string StatsJson() {
    size_t depth;
    {
      std::lock_guard<std::mutex> lk(mu_);
      depth = ready_.size();
    }
    int inflight;
    uint64_t epochs;
    {
      std::lock_guard<std::mutex> lk(claim_mu_);
      inflight = in_flight_;
      epochs = epoch_;
    }
    uint64_t read_us = 0, decode_us = 0, augment_us = 0, batchify_us = 0,
             batches = 0, samples = 0, bp_waits = 0, jpegs = 0, pngs = 0;
    uint64_t scales[4] = {0, 0, 0, 0};
    for (int i = 0; i < n_threads_; ++i) {
      const WorkerStats &ws = wstats_[i];
      read_us += ws.read_us.load(std::memory_order_relaxed);
      decode_us += ws.decode_us.load(std::memory_order_relaxed);
      augment_us += ws.augment_us.load(std::memory_order_relaxed);
      batchify_us += ws.batchify_us.load(std::memory_order_relaxed);
      batches += ws.batches.load(std::memory_order_relaxed);
      samples += ws.samples.load(std::memory_order_relaxed);
      bp_waits += ws.backpressure_waits.load(std::memory_order_relaxed);
      jpegs += ws.jpeg_decodes.load(std::memory_order_relaxed);
      pngs += ws.png_decodes.load(std::memory_order_relaxed);
      for (int s = 0; s < 4; ++s)
        scales[s] += ws.scale_counts[s].load(std::memory_order_relaxed);
    }
    char buf[1152];
    std::snprintf(
        buf, sizeof buf,
        "{\"workers\": %d, \"batch\": %d, \"uint8_wire\": %s, "
        "\"decode_backend\": \"%s\", "
        "\"batches\": %llu, \"samples\": %llu, "
        "\"read_us\": %llu, \"decode_us\": %llu, \"augment_us\": %llu, "
        "\"batchify_us\": %llu, "
        "\"jpeg_decodes\": %llu, \"png_decodes\": %llu, "
        "\"scale_counts\": {\"1\": %llu, \"2\": %llu, \"4\": %llu, "
        "\"8\": %llu}, "
        "\"queue_depth\": %zu, \"in_flight\": %d, \"prefetch\": %d, "
        "\"claim_window\": %d, "
        "\"backpressure_waits\": %llu, \"consumer_waits\": %llu, "
        "\"consumer_wait_us\": %llu, \"epochs\": %llu}",
        n_threads_, batch_, out_u8_ ? "true" : "false", JpegLibrary(),
        (unsigned long long)batches, (unsigned long long)samples,
        (unsigned long long)read_us, (unsigned long long)decode_us,
        (unsigned long long)augment_us, (unsigned long long)batchify_us,
        (unsigned long long)jpegs, (unsigned long long)pngs,
        (unsigned long long)scales[0], (unsigned long long)scales[1],
        (unsigned long long)scales[2], (unsigned long long)scales[3],
        depth, inflight, claim_window_, claim_window_,
        (unsigned long long)bp_waits,
        (unsigned long long)consumer_waits_.load(),
        (unsigned long long)consumer_wait_us_.load(),
        (unsigned long long)epochs);
    return buf;
  }

 private:
  void Fail(const std::string &msg) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (error_.empty()) error_ = msg;
    }
    cv_done_.notify_all();
  }

  void ResetOrderLocked() {
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    if (shuffle_) {
      std::mt19937_64 rng(seed_ + 0x9e3779b97f4a7c15ULL * (epoch_ + 1));
      std::shuffle(order_.begin(), order_.end(), rng);
    }
    next_ticket_ = 0;
  }

  size_t PoolCap() const {
    return static_cast<size_t>(claim_window_) + workers_.size();
  }

  Batch Acquire() {
    std::lock_guard<std::mutex> lk(pool_mu_);
    if (!pool_.empty()) {
      Batch b = std::move(pool_.back());
      pool_.pop_back();
      return b;
    }
    return Batch();
  }

  void Recycle(Batch &&b) {
    std::lock_guard<std::mutex> lk(pool_mu_);
    if (pool_.size() < PoolCap()) pool_.push_back(std::move(b));
  }

  void PrepareBuffers(Batch *b) {
    size_t dn = static_cast<size_t>(batch_) * c_ * h_ * w_;
    size_t ln = static_cast<size_t>(batch_) * label_width_;
    if (out_u8_) {
      b->u8.resize(dn);
      b->f32.clear();
    } else {
      b->f32.resize(dn);
      b->u8.clear();
    }
    b->label.assign(ln, 0.f);
  }

  void ZeroTail(Batch *b, int valid) {
    size_t row = static_cast<size_t>(c_) * h_ * w_;
    size_t off = static_cast<size_t>(valid) * row;
    size_t n = static_cast<size_t>(batch_ - valid) * row;
    if (n == 0) return;
    if (out_u8_)
      std::memset(b->u8.data() + off, 0, n);
    else
      std::memset(b->f32.data() + off, 0, n * sizeof(float));
  }

  // Advise the kernel of the byte range of a ticket claim_window ahead,
  // so its records page in while this one decodes.
  void Readahead(std::FILE *fp, int ticket) {
#if defined(POSIX_FADV_WILLNEED)
    int ahead = ticket + claim_window_;
    if (ahead >= NumBatches()) return;
    int start = ahead * batch_;
    int stop_row = std::min<int>(start + batch_,
                                 static_cast<int>(offsets_.size()));
    size_t lo = SIZE_MAX, hi = 0;
    for (int r = start; r < stop_row; ++r) {
      size_t off = offsets_[order_[static_cast<size_t>(r)]];
      lo = std::min(lo, off);
      hi = std::max(hi, off);
    }
    if (lo >= hi) return;
    size_t span = hi - lo + (hi - lo) / (stop_row - start ? stop_row - start
                                                          : 1) + 4096;
    posix_fadvise(fileno(fp), static_cast<off_t>(lo),
                  static_cast<off_t>(span), POSIX_FADV_WILLNEED);
#else
    (void)fp; (void)ticket;
#endif
  }

  bool ClaimReady() const {
    return !draining_ && next_ticket_ < NumBatches() &&
           next_ticket_ - next_out_.load(std::memory_order_acquire) <
               claim_window_;
  }

  void Work(int widx) {
    struct Live {
      Loader *ld;
      ~Live() {
        {
          std::lock_guard<std::mutex> lk(ld->mu_);
          --ld->n_live_;
        }
        ld->cv_done_.notify_all();
        ld->cv_claim_.notify_all();
      }
    } live{this};
    WorkerStats &ws = wstats_[widx];
    std::FILE *fp = std::fopen(rec_path_.c_str(), "rb");
    if (!fp) {
      Fail("worker cannot open rec file " + rec_path_);
      return;
    }
    std::unique_ptr<Decoder> dec;
    std::vector<std::vector<char>> recs;
    std::vector<Img> imgs;
    std::vector<int> scales;
    for (;;) {
      int ticket;
      uint64_t epoch;
      {
        std::unique_lock<std::mutex> lk(claim_mu_);
        if (!(stop_.load() || ClaimReady())) {
          if (next_ticket_ < NumBatches() && !draining_)
            ws.backpressure_waits.fetch_add(1, std::memory_order_relaxed);
          cv_claim_.wait(lk, [this] {
            return stop_.load() || ClaimReady();
          });
        }
        if (stop_.load()) break;
        ticket = next_ticket_++;
        epoch = epoch_;
        ++in_flight_;
      }
      Batch b = Acquire();
      PrepareBuffers(&b);
      Readahead(fp, ticket);
      int start = ticket * batch_;
      int stop_row = std::min<int>(start + batch_,
                                   static_cast<int>(offsets_.size()));
      int n = stop_row - start;
      StageUs us;
      try {
        if (!dec) dec.reset(new Decoder());
        recs.resize(n);
        std::vector<const uint8_t *> bufs(n);
        std::vector<size_t> lens(n);
        uint64_t t0 = NowUs();
        for (int r = 0; r < n; ++r) {
          size_t sample = order_[static_cast<size_t>(start + r)];
          if (!ReadRecordAt(fp, offsets_[sample], &recs[r]))
            throw std::runtime_error(
                "unreadable record at index " + std::to_string(sample));
          size_t poff = ParseLabel(recs[r], b.label.data() +
                                   static_cast<size_t>(r) * label_width_);
          bufs[r] = reinterpret_cast<const uint8_t *>(recs[r].data()) + poff;
          lens[r] = recs[r].size() - poff;
        }
        uint64_t t1 = NowUs();
        us.read += t1 - t0;
        int jpegs = 0, pngs = 0;
        dec->DecodeMany(bufs, lens, c_, resize_, &imgs, &scales, &jpegs,
                        &pngs);
        uint64_t t2 = NowUs();
        us.decode += t2 - t1;
        ws.jpeg_decodes.fetch_add(jpegs, std::memory_order_relaxed);
        ws.png_decodes.fetch_add(pngs, std::memory_order_relaxed);
#ifdef MXT_JPEG_LIBJPEG
        for (int r = 0; r < n; ++r)
          if (IsJpeg(bufs[r], lens[r]))
            ws.scale_counts[ScaleIdx(scales[r])].fetch_add(
                1, std::memory_order_relaxed);
#endif
        for (int r = 0; r < n; ++r) {
          size_t sample = order_[static_cast<size_t>(start + r)];
          Augment(&imgs[r], sample, epoch, &b,
                  static_cast<size_t>(r) * c_ * h_ * w_, &us);
        }
        ZeroTail(&b, n);
      } catch (const std::exception &e) {
        Fail(e.what());
        {
          std::lock_guard<std::mutex> lk(claim_mu_);
          --in_flight_;
        }
        cv_claim_.notify_all();
        cv_done_.notify_all();
        break;
      }
      b.n_valid = n;
      ws.read_us.fetch_add(us.read, std::memory_order_relaxed);
      ws.decode_us.fetch_add(us.decode, std::memory_order_relaxed);
      ws.augment_us.fetch_add(us.augment, std::memory_order_relaxed);
      ws.batchify_us.fetch_add(us.batchify, std::memory_order_relaxed);
      ws.batches.fetch_add(1, std::memory_order_relaxed);
      ws.samples.fetch_add(static_cast<uint64_t>(n),
                           std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_[ticket] = std::move(b);
      }
      cv_done_.notify_all();
      bool wake_drain;
      {
        std::lock_guard<std::mutex> lk(claim_mu_);
        --in_flight_;
        wake_drain = draining_ && in_flight_ == 0;
      }
      if (wake_drain) cv_claim_.notify_all();
    }
    std::fclose(fp);
  }

  // The record's label into `label`; → the payload's offset.
  size_t ParseLabel(const std::vector<char> &rec, float *label) {
    if (rec.size() < sizeof(IRHeader))
      throw std::runtime_error("record shorter than its header");
    IRHeader hdr;
    std::memcpy(&hdr, rec.data(), sizeof hdr);
    size_t payload_off = sizeof(IRHeader);
    if (hdr.flag > 0) {
      if (payload_off + static_cast<size_t>(hdr.flag) * sizeof(float) >
          rec.size())
        throw std::runtime_error("corrupt record: label count exceeds "
                                 "record size");
      size_t n = std::min<size_t>(hdr.flag, label_width_);
      std::memcpy(label, rec.data() + payload_off, n * sizeof(float));
      payload_off += hdr.flag * sizeof(float);
    } else {
      label[0] = hdr.label;
    }
    return payload_off;
  }

  void Augment(Img *img, size_t sample, uint64_t epoch, Batch *b,
               size_t out_off, StageUs *us) {
    uint64_t t1 = NowUs();
    std::mt19937 rng(static_cast<uint32_t>(
        seed_ ^ (epoch * 0x9e3779b9ULL) ^ (sample * 0x85ebca6bULL)));
    if (resize_ > 0) {
      double s = static_cast<double>(resize_) / std::min(img->h, img->w);
      ResizeImg(*img, std::max(1, static_cast<int>(img->h * s)),
                std::max(1, static_cast<int>(img->w * s)), img);
    }
    if (img->h < h_ || img->w < w_)
      ResizeImg(*img, std::max(img->h, h_), std::max(img->w, w_), img);
    int max_y = img->h - h_, max_x = img->w - w_;
    int y0, x0;
    if (rand_crop_) {
      y0 = max_y ? static_cast<int>(rng() % (max_y + 1)) : 0;
      x0 = max_x ? static_cast<int>(rng() % (max_x + 1)) : 0;
    } else {
      y0 = max_y / 2;
      x0 = max_x / 2;
    }
    bool flip = mirror_ && (rng() & 1U);
    uint64_t t2 = NowUs();
    us->augment += t2 - t1;
    // crop, mirror and HWC -> CHW in one pass
    for (int ch = 0; ch < c_; ++ch)
      for (int y = 0; y < h_; ++y) {
        const uint8_t *rowp = img->Row(y0 + y) + static_cast<size_t>(x0) * c_;
        size_t o = out_off + (static_cast<size_t>(ch) * h_ + y) * w_;
        if (out_u8_) {
          uint8_t *out = b->u8.data() + o;
          for (int x = 0; x < w_; ++x)
            out[x] = rowp[(flip ? w_ - 1 - x : x) * c_ + ch];
        } else {
          float *out = b->f32.data() + o;
          for (int x = 0; x < w_; ++x)
            out[x] = static_cast<float>(rowp[(flip ? w_ - 1 - x : x) * c_ +
                                             ch]);
        }
      }
    us->batchify += NowUs() - t2;
  }

  std::string rec_path_;
  int batch_, c_, h_, w_, resize_;
  bool shuffle_;
  uint64_t seed_;
  bool mirror_;
  bool rand_crop_;
  size_t label_width_;
  bool out_u8_;
  int claim_window_ = 2;
  int n_threads_ = 1;
  std::vector<size_t> offsets_;
  std::vector<std::thread> workers_;

  // claim domain (claim_mu_ / cv_claim_): ticket handout and drain
  std::mutex claim_mu_;
  std::condition_variable cv_claim_;
  std::vector<size_t> order_;
  int next_ticket_ = 0;
  int in_flight_ = 0;
  uint64_t epoch_ = 0;
  bool draining_ = false;

  // done domain (mu_ / cv_done_): reorder map, consumer, errors
  std::mutex mu_;
  std::condition_variable cv_done_;
  std::map<int, Batch> ready_;
  std::string error_;
  int n_live_ = 0;

  // pool domain (pool_mu_): recycled batch buffers
  std::mutex pool_mu_;
  std::vector<Batch> pool_;

  std::atomic<int> next_out_{0};
  std::atomic<bool> stop_{false};

  std::unique_ptr<WorkerStats[]> wstats_;
  std::atomic<uint64_t> consumer_waits_{0}, consumer_wait_us_{0};
};

}  // namespace mxt

// ----------------------------------------------------------- C API ---
#define API_BEGIN() try {
#define API_END()                                      \
  }                                                    \
  catch (const std::exception &e) {                    \
    mxt::g_last_error = e.what();                      \
    return -1;                                         \
  }                                                    \
  catch (...) {                                        \
    mxt::g_last_error = "unknown C++ exception";       \
    return -1;                                         \
  }                                                    \
  return 0

namespace {
uint8_t *CopyOut(const std::vector<uint8_t> &v) {
  auto *p = static_cast<uint8_t *>(std::malloc(v.size() ? v.size() : 1));
  if (!p) throw std::runtime_error("out of host memory");
  if (!v.empty()) std::memcpy(p, v.data(), v.size());
  return p;
}
}  // namespace

extern "C" {

const char *mxt_last_error() { return mxt::g_last_error.c_str(); }

void mxt_free(void *p) { std::free(p); }

int mxt_backend_info(char *json, size_t capacity) {
  API_BEGIN();
  char buf[256];
#ifdef MXT_JPEG_LIBJPEG
  int jv = JPEG_LIB_VERSION;
#elif defined(MXT_JPEG_NVJPEG)
  int jv = 0;
  nvjpegGetProperty(MAJOR_VERSION, &jv);
  int minor = 0;
  nvjpegGetProperty(MINOR_VERSION, &minor);
  jv = jv * 100 + minor;
#else
  int jv = 0;
#endif
#ifdef MXT_WITH_ZLIB
  const char *zv = zlibVersion();
#else
  const char *zv = "";
#endif
  std::snprintf(buf, sizeof buf,
                "{\"jpeg\": \"%s\", \"jpeg_version\": %d, \"png\": %s, "
                "\"zlib\": \"%s\"}",
                mxt::JpegLibrary(), jv, zv[0] ? "true" : "false", zv);
  std::string s = buf;
  if (s.size() + 1 > capacity) throw std::runtime_error("buffer too small");
  std::memcpy(json, s.c_str(), s.size() + 1);
  API_END();
}

// flag: 1 colour (3 channels, RGB), 0 gray, -1 the stream's own.
int mxt_imdecode(const uint8_t *buf, size_t len, int flag, uint8_t **out,
                 int *h, int *w, int *c) {
  API_BEGIN();
  mxt::Img img;
  int channels = flag == 1 ? 3 : (flag == 0 ? 1 : 0);
  mxt::ThreadDecoder().DecodeOne(buf, len, channels, 0, &img, nullptr);
  *out = CopyOut(img.px);
  *h = img.h;
  *w = img.w;
  *c = img.c;
  API_END();
}

// fmt 0: JPEG at `quality`; 1: PNG at zlib level `quality`; 2:
// progressive JPEG at `quality`.
int mxt_imencode(const uint8_t *src, int h, int w, int c, int fmt,
                 int quality, uint8_t **out, size_t *len) {
  API_BEGIN();
  std::vector<uint8_t> v;
  if (fmt == 0 || fmt == 2) {
    if (c != 1 && c != 3)
      throw std::runtime_error("JPEG encode takes 1 or 3 channels");
    v = mxt::ThreadDecoder().EncodeJpeg(src, h, w, c, quality, fmt == 2);
  } else {
#ifdef MXT_WITH_ZLIB
    v = mxt::PngEncode(src, h, w, c, quality);
#else
    throw std::runtime_error("PNG encode: this build of the decode stage "
                             "has no zlib (zlib.h / -lz)");
#endif
  }
  *out = CopyOut(v);
  *len = v.size();
  API_END();
}

int mxt_imresize_u8(const uint8_t *src, int sh, int sw, int c, uint8_t *dst,
                    int dh, int dw, int interp) {
  API_BEGIN();
  if (interp < 0 || interp > 2)
    throw std::runtime_error("interp " + std::to_string(interp) +
                             " is not implemented (0 nearest, 1 linear, "
                             "2 cubic)");
  mxt::ResizeU8(src, sh, sw, c, dst, dh, dw, interp);
  API_END();
}

int mxt_imresize_f32(const float *src, int sh, int sw, int c, float *dst,
                     int dh, int dw, int interp) {
  API_BEGIN();
  if (interp < 0 || interp > 2)
    throw std::runtime_error("interp " + std::to_string(interp) +
                             " is not implemented (0 nearest, 1 linear, "
                             "2 cubic)");
  mxt::ResizeF32(src, sh, sw, c, dst, dh, dw, interp);
  API_END();
}

int mxt_loader_create(const char *rec_path, const char *idx_path, int batch,
                      int channels, int height, int width, int resize,
                      int shuffle, uint64_t seed, int n_threads, int mirror,
                      int rand_crop, int label_width, int prefetch,
                      int out_dtype, const char *decode_backend,
                      int claim_window, void **out) {
  API_BEGIN();
  if (out_dtype != 0 && out_dtype != 1)
    throw std::runtime_error("out_dtype must be 0 (float32) or 1 (uint8)");
  *out = new mxt::Loader(rec_path, idx_path, batch, channels, height, width,
                         resize, shuffle != 0, seed, n_threads, mirror != 0,
                         rand_crop != 0, label_width < 1 ? 1 : label_width,
                         prefetch, out_dtype, decode_backend, claim_window);
  API_END();
}

int mxt_loader_next(void *h, void *data, int is_u8, float *label,
                    int *n_valid) {
  API_BEGIN();
  auto *ld = static_cast<mxt::Loader *>(h);
  if ((is_u8 != 0) != ld->OutU8())
    throw std::runtime_error("the data buffer's dtype is not the loader's");
  *n_valid = ld->Next(data, label);
  API_END();
}

int mxt_loader_stats(void *h, char *json, size_t capacity) {
  API_BEGIN();
  std::string s = static_cast<mxt::Loader *>(h)->StatsJson();
  if (s.size() + 1 > capacity)
    throw std::runtime_error("stats buffer too small: need " +
                             std::to_string(s.size() + 1) + " bytes");
  std::memcpy(json, s.c_str(), s.size() + 1);
  API_END();
}

int mxt_loader_stats_reset(void *h) {
  API_BEGIN();
  static_cast<mxt::Loader *>(h)->StatsReset();
  API_END();
}

int mxt_loader_reset(void *h) {
  API_BEGIN();
  static_cast<mxt::Loader *>(h)->Reset();
  API_END();
}

int mxt_loader_free(void *h) {
  API_BEGIN();
  delete static_cast<mxt::Loader *>(h);
  API_END();
}

}  // extern "C"
