// png_codec — the port's PNG reader and writer, without libpng.
//
// The card's machine has no libpng, so the port carries its own codec for
// the PNGs the repository's writers produce: 8-bit RGB, non-interlaced.
// Reading a file: parse the chunks, inflate the concatenated IDAT stream
// (zlib's `uncompress`), reverse the per-row filters of the PNG
// specification (section 9: None, Sub, Up, Average, Paeth). The bytes it
// returns are the pixels libpng and Pillow return for such a file.
// Writing: rows with filter type None, deflated by zlib's `compress2`, in
// IHDR / IDAT / IEND chunks with their CRCs. Any other form is refused with
// a status the caller turns into an error naming the file.
//
// Whole batches run on a pool of std::threads; Python calls one function
// per batch through ctypes (which releases the GIL), so no Python code
// runs per image.
//
// zlib is linked as -l:libz.so.1 with its four entry points declared here,
// so no zlib header is needed. Built with g++ into ganleaks_tpu_torch/_build/
// by io/native.py.

#include <sys/stat.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
int uncompress(unsigned char* dest, unsigned long* dest_len,
               const unsigned char* source, unsigned long source_len);
int compress2(unsigned char* dest, unsigned long* dest_len,
              const unsigned char* source, unsigned long source_len,
              int level);
unsigned long compressBound(unsigned long source_len);
unsigned long crc32(unsigned long crc, const unsigned char* buf,
                    unsigned int len);
}

namespace {

// per-image status, mirrored in io/native.py
constexpr int kOk = 0;
constexpr int kErrOpen = 1;     // cannot open, read or write the file
constexpr int kErrNotPng = 2;   // no PNG signature
constexpr int kErrCorrupt = 3;  // truncated chunks, bad IDAT stream, ...
constexpr int kErrForm = 4;     // not 8-bit RGB non-interlaced
constexpr int kErrSize = 5;     // another width or height than asked for

constexpr int kBpp = 3;  // bytes per pixel: 8-bit RGB
constexpr unsigned char kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                   '\n'};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline void put_be32(std::vector<uint8_t>* out, uint32_t v) {
  const uint8_t b[4] = {uint8_t(v >> 24), uint8_t(v >> 16), uint8_t(v >> 8),
                        uint8_t(v)};
  out->insert(out->end(), b, b + 4);
}

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(f) : -1;
  ok = ok && size >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    data->resize(static_cast<size_t>(size));
    ok = std::fread(data->data(), 1, data->size(), f) == data->size();
  }
  std::fclose(f);
  return ok;
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// `raw`: h scanlines of (1 + 3w) bytes, a filter-type byte and the
// filtered row each. Writes h * 3w pixel bytes to `out`.
bool unfilter(const uint8_t* raw, int h, int w, uint8_t* out) {
  const size_t stride = static_cast<size_t>(w) * kBpp;
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (stride + 1);
    const uint8_t type = *src++;
    uint8_t* dst = out + static_cast<size_t>(y) * stride;
    switch (type) {
      case 0:  // None
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= kBpp ? dst[i - kBpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= kBpp ? dst[i - kBpp] : 0;
          const int b = prev ? prev[i] : 0;
          dst[i] = uint8_t(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= kBpp ? dst[i - kBpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= kBpp) ? prev[i - kBpp] : 0;
          dst[i] = uint8_t(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = dst;
  }
  return true;
}

// Decode `path`. With `any` null: into `out` (want_h x want_w x 3) when
// its header says exactly that size. Else: into *any, resized to the
// file's own size. info[0..4] = width, height, bit depth, color type,
// interlace method, as far as they were read.
int decode_one(const char* path, int want_h, int want_w, uint8_t* out,
               std::vector<uint8_t>* any, int32_t* info) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) return kErrOpen;
  const size_t n = data.size();
  const uint8_t* p = data.data();
  if (n < 8 || std::memcmp(p, kSig, 8) != 0) return kErrNotPng;
  bool have_hdr = false;
  uint32_t w = 0, h = 0;
  std::vector<uint8_t> idat;
  for (size_t pos = 8; pos + 8 <= n;) {
    const uint32_t len = be32(p + pos);
    const uint8_t* tag = p + pos + 4;
    if (len > n || pos + 12 + len > n) return kErrCorrupt;
    const uint8_t* body = p + pos + 8;
    if (std::memcmp(tag, "IHDR", 4) == 0) {
      if (len != 13) return kErrCorrupt;
      w = be32(body);
      h = be32(body + 4);
      info[0] = int32_t(w);
      info[1] = int32_t(h);
      info[2] = body[8];
      info[3] = body[9];
      info[4] = body[12];
      if (body[8] != 8 || body[9] != 2 || body[10] != 0 || body[11] != 0 ||
          body[12] != 0)
        return kErrForm;
      have_hdr = true;
    } else if (std::memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + static_cast<size_t>(len);
  }
  // a corrupt IHDR can declare up to 2^31 x 2^31: refuse absurd sizes
  // before allocating (64 M pixels is far beyond any dataset image)
  if (!have_hdr || w == 0 || h == 0 || uint64_t(w) * h > (uint64_t(64) << 20))
    return kErrCorrupt;
  if (any) {
    any->resize(size_t(h) * w * kBpp);
    out = any->data();
  } else if (int64_t(h) != want_h || int64_t(w) != want_w) {
    return kErrSize;
  }
  const size_t raw_len = size_t(h) * (size_t(w) * kBpp + 1);
  std::vector<uint8_t> raw(raw_len);
  unsigned long got = raw_len;
  if (uncompress(raw.data(), &got, idat.data(), idat.size()) != 0 ||
      got != raw_len)
    return kErrCorrupt;
  return unfilter(raw.data(), int(h), int(w), out) ? kOk : kErrCorrupt;
}

void chunk(std::vector<uint8_t>* out, const char* tag, const uint8_t* body,
           uint32_t len) {
  put_be32(out, len);
  const uint8_t* t = reinterpret_cast<const uint8_t*>(tag);
  out->insert(out->end(), t, t + 4);
  out->insert(out->end(), body, body + len);
  put_be32(out, uint32_t(crc32(crc32(0, t, 4), body, len)));
}

int encode_one(const char* path, const uint8_t* px, int h, int w,
               int level) {
  const size_t stride = size_t(w) * kBpp;
  std::vector<uint8_t> rows(size_t(h) * (stride + 1));
  for (int y = 0; y < h; ++y) {
    rows[size_t(y) * (stride + 1)] = 0;  // filter type None
    std::memcpy(&rows[size_t(y) * (stride + 1) + 1], px + size_t(y) * stride,
                stride);
  }
  unsigned long zlen = compressBound(rows.size());
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, rows.data(), rows.size(), level) != 0)
    return kErrCorrupt;
  std::vector<uint8_t> file(kSig, kSig + 8);
  file.reserve(8 + 25 + 12 + zlen + 12);
  uint8_t ihdr[13] = {0};
  for (int i = 0; i < 4; ++i) {
    ihdr[i] = uint8_t(uint32_t(w) >> (24 - 8 * i));
    ihdr[4 + i] = uint8_t(uint32_t(h) >> (24 - 8 * i));
  }
  ihdr[8] = 8;  // bit depth
  ihdr[9] = 2;  // color type RGB
  chunk(&file, "IHDR", ihdr, 13);
  chunk(&file, "IDAT", z.data(), uint32_t(zlen));
  chunk(&file, "IEND", nullptr, 0);
  FILE* f = std::fopen(path, "wb");
  if (!f) return kErrOpen;
  const bool ok = std::fwrite(file.data(), 1, file.size(), f) == file.size();
  return (std::fclose(f) == 0 && ok) ? kOk : kErrOpen;
}

// run fn(i) for i in [0, n) on min(n, n_threads) threads
template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  const int workers = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Decode n PNGs into `out` (n, h, w, 3) uint8. status[i]: kOk or an error
// code; info[5 i .. 5 i + 4]: width, height, bit depth, color type,
// interlace of file i. Returns the number of files not decoded.
int gl_decode_batch(const char** paths, int n, int h, int w, uint8_t* out,
                    int32_t* status, int32_t* info, int n_threads) {
  std::atomic<int> failures(0);
  const size_t img = size_t(h) * size_t(w) * kBpp;
  parallel_for(n, n_threads, [&](int i) {
    int rc;
    try {
      rc = decode_one(paths[i], h, w, out + img * i, nullptr,
                      info + 5 * size_t(i));
    } catch (...) {  // std::bad_alloc must not terminate the process
      rc = kErrCorrupt;
    }
    status[i] = rc;
    if (rc != kOk) failures.fetch_add(1);
  });
  return failures.load();
}

// Decode one PNG of any size into a buffer this library allocates: *out
// (info[1] x info[0] x 3 bytes), freed with gl_free. Returns the status.
int gl_decode_any(const char* path, uint8_t** out, int32_t* info) {
  *out = nullptr;
  try {
    std::vector<uint8_t> px;
    const int rc = decode_one(path, 0, 0, nullptr, &px, info);
    if (rc != kOk) return rc;
    *out = static_cast<uint8_t*>(std::malloc(px.size()));
    if (*out == nullptr) return kErrCorrupt;
    std::memcpy(*out, px.data(), px.size());
    return kOk;
  } catch (...) {
    return kErrCorrupt;
  }
}

void gl_free(void* p) { std::free(p); }

// Encode n (h, w, 3) uint8 images (one contiguous batch) as PNGs at zlib
// `level`. status[i]: kOk or an error code. Returns the failures.
int gl_encode_batch(const char** paths, int n, int h, int w,
                    const uint8_t* data, int level, int32_t* status,
                    int n_threads) {
  std::atomic<int> failures(0);
  const size_t img = size_t(h) * size_t(w) * kBpp;
  parallel_for(n, n_threads, [&](int i) {
    int rc;
    try {
      rc = encode_one(paths[i], data + img * i, h, w, level);
    } catch (...) {
      rc = kErrCorrupt;
    }
    status[i] = rc;
    if (rc != kOk) failures.fetch_add(1);
  });
  return failures.load();
}

// stat() n files: size[i] and mtime_ns[i] (os.stat's st_size and
// st_mtime_ns), or size[i] = -1 where stat fails. Returns the failures.
int gl_stat_batch(const char** paths, int n, int64_t* size,
                  int64_t* mtime_ns, int n_threads) {
  std::atomic<int> failures(0);
  parallel_for(n, n_threads, [&](int i) {
    struct stat st;
    if (::stat(paths[i], &st) != 0) {
      size[i] = -1;
      mtime_ns[i] = 0;
      failures.fetch_add(1);
      return;
    }
    size[i] = int64_t(st.st_size);
    mtime_ns[i] = int64_t(st.st_mtim.tv_sec) * 1000000000 +
                  int64_t(st.st_mtim.tv_nsec);
  });
  return failures.load();
}

}  // extern "C"
