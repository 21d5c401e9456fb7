/*!
 * RecordIO on-disk framing, shared by the image loader's per-worker
 * readers (dataio.cc).
 *
 * Format (the dmlc recordio framing of python/mxnet/recordio.py):
 * <u32 magic> <u32 lrec> payload pad4, where lrec's top 3 bits are the
 * continuation flag (0 whole, 1 start, 2 middle, 3 end); the magic word
 * is put back between reassembled chunks because the writer split the
 * payload on it.
 */
#ifndef MXNET_TPU_TORCH_CSRC_HOST_RECORDIO_FORMAT_H_
#define MXNET_TPU_TORCH_CSRC_HOST_RECORDIO_FORMAT_H_

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace mxt {
namespace recfmt {

constexpr uint32_t kMagic = 0xced7230a;

inline uint32_t DecodeFlag(uint32_t lrec) { return lrec >> 29U; }
inline uint32_t DecodeLength(uint32_t lrec) {
  return lrec & ((1U << 29U) - 1U);
}

/* Read one whole (reassembled) record from fp's current position into
 * *out.  Returns false at the end of the input; `err`, when given, is set
 * for malformed input (bad magic, truncation) and left empty at a clean
 * end of file. */
inline bool ReadOneRecord(std::FILE *fp, std::vector<char> *out,
                          std::string *err = nullptr) {
  if (err) err->clear();
  out->clear();
  bool in_multi = false;
  auto fail = [err](const char *msg) {
    if (err) *err = msg;
    return false;
  };
  for (;;) {
    uint32_t magic = 0, lrec = 0;
    if (std::fread(&magic, 1, 4, fp) != 4)
      return in_multi ? fail("recordio: truncated record") : false;
    if (magic != kMagic) return fail("recordio: bad magic");
    if (std::fread(&lrec, 1, 4, fp) != 4)
      return fail("recordio: truncated header");
    uint32_t cflag = DecodeFlag(lrec);
    uint32_t len = DecodeLength(lrec);
    size_t off = out->size();
    out->resize(off + len);
    if (len && std::fread(out->data() + off, 1, len, fp) != len)
      return fail("recordio: truncated payload");
    size_t pad = (4 - (len & 3U)) & 3U;
    char scratch[4];
    if (pad && std::fread(scratch, 1, pad, fp) != pad)
      return fail("recordio: truncated pad");
    if (cflag == 0) return true;
    if (cflag == 1) {
      in_multi = true;
      continue;
    }
    if (!in_multi) return fail("recordio: orphan continuation");
    uint32_t m = kMagic;
    out->insert(out->begin() + static_cast<long>(off),
                reinterpret_cast<char *>(&m),
                reinterpret_cast<char *>(&m) + 4);
    if (cflag == 3) return true;
  }
}

}  // namespace recfmt
}  // namespace mxt

#endif  // MXNET_TPU_TORCH_CSRC_HOST_RECORDIO_FORMAT_H_
