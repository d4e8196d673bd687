// cxxnet_tpu_torch native runtime: binary-page data loader + JPEG decode.
//
// The port's own copy of runtime/cxxnet_runtime.cc, the native IO stack of
// the reference (src/io/iter_thread_imbin-inl.hpp + utils/thread_buffer.h +
// utils/decoder.h): a background reader thread streams fixed 64MB
// BinaryPages from disk into a bounded ring (the double-buffer pipeline),
// objects are exposed zero-copy, and JPEG blobs decode straight to RGB via
// libjpeg.  Exposed as a plain C ABI consumed through ctypes
// (cxxnet_tpu_torch/runtime/native.py).
//
// Built with -DCXR_NO_JPEG where the machine has no jpeglib.h / libjpeg:
// the page reader alone, cxr_has_jpeg() returning 0 and cxr_jpeg_decode
// returning -4, so the caller decodes with PIL.
//
// Page format (byte-compatible with utils/io.h:253-326):
//   int32 data[64<<18]; data[0]=count, data[1+i]=cumulative byte offsets,
//   object r occupies [PAGE_BYTES - data[r+2], PAGE_BYTES - data[r+1]).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifndef CXR_NO_JPEG
#include <jpeglib.h>
#include <csetjmp>
#endif

namespace {

constexpr size_t kPageInts = 64u << 18;
constexpr size_t kPageBytes = kPageInts * 4;

struct Page {
  std::vector<char> buf;
  Page() : buf(kPageBytes) {}
  const int32_t* head() const {
    return reinterpret_cast<const int32_t*>(buf.data());
  }
  int count() const { return head()[0]; }
  const char* obj(int r, size_t* size) const {
    const int32_t* h = head();
    size_t lo = kPageBytes - static_cast<size_t>(h[r + 2]);
    *size = static_cast<size_t>(h[r + 2] - h[r + 1]);
    return buf.data() + lo;
  }
};

// Bounded-ring page prefetcher: one reader thread, consumer pops in order.
// With a page-index order list (imgbinx shuffled epochs) the reader seeks
// page-by-page — pages are fixed-size records, hence random-access — so
// shuffle costs no extra IO and prefetch still runs ahead of decode.
struct PageStream {
  FILE* fp = nullptr;
  std::thread reader;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::unique_ptr<Page>> ready;
  size_t max_ready = 2;
  bool eof = false;
  bool stop = false;
  std::unique_ptr<Page> current;
  bool use_order = false;      // explicit: order=[] means read NOTHING
  std::vector<int64_t> order;
  size_t order_pos = 0;        // reader thread only
  bool read_error = false;     // short read mid-order: error, not EOF

  ~PageStream() { Close(); }

  bool Open(const char* path, int prefetch, const int64_t* idx, int n) {
    fp = fopen(path, "rb");
    if (!fp) return false;
    if (idx) {
      use_order = true;
      if (n > 0) order.assign(idx, idx + n);
    }
    max_ready = prefetch > 0 ? static_cast<size_t>(prefetch) : 2;
    reader = std::thread([this] { ReadLoop(); });
    return true;
  }

  void ReadLoop() {
    for (;;) {
      bool ok;
      if (use_order && order_pos >= order.size()) {
        std::lock_guard<std::mutex> lk(mu);
        eof = true;
        cv_get.notify_all();
        return;
      }
      auto page = std::make_unique<Page>();
      if (use_order) {
        int64_t idx = order[order_pos++];
        ok = fseeko(fp, static_cast<off_t>(idx) *
                            static_cast<off_t>(kPageBytes), SEEK_SET) == 0 &&
             fread(page->buf.data(), 1, kPageBytes, fp) == kPageBytes;
      } else {
        ok = fread(page->buf.data(), 1, kPageBytes, fp) == kPageBytes;
      }
      std::unique_lock<std::mutex> lk(mu);
      if (!ok) {
        // sequential mode ends at the first short read (tail) — that is
        // the normal EOF; an ordered read that comes up short points past
        // the file and must surface as an error, not silent truncation
        read_error = use_order;
        eof = true;
        cv_get.notify_all();
        return;
      }
      cv_put.wait(lk, [this] { return ready.size() < max_ready || stop; });
      if (stop) return;
      ready.push_back(std::move(page));
      cv_get.notify_one();
    }
  }

  // returns object count, -1 at end of stream, -2 on read error
  int NextPage() {
    std::unique_lock<std::mutex> lk(mu);
    cv_get.wait(lk, [this] { return !ready.empty() || eof || stop; });
    if (ready.empty()) return read_error ? -2 : -1;
    current = std::move(ready.front());
    ready.pop_front();
    cv_put.notify_one();
    return current->count();
  }

  void Close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
      cv_put.notify_all();
      cv_get.notify_all();
    }
    if (reader.joinable()) reader.join();
    if (fp) {
      fclose(fp);
      fp = nullptr;
    }
  }
};

#ifndef CXR_NO_JPEG
// libjpeg error handling: jump back instead of exit()
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}
#endif  // CXR_NO_JPEG

}  // namespace

extern "C" {

void* cxr_open(const char* path, int prefetch_pages) {
  auto* s = new PageStream();
  if (!s->Open(path, prefetch_pages, nullptr, 0)) {
    delete s;
    return nullptr;
  }
  return s;
}

// Open reading only the given page indices, in that order (seek-based).
void* cxr_open_order(const char* path, const int64_t* order, int n,
                     int prefetch_pages) {
  auto* s = new PageStream();
  if (!s->Open(path, prefetch_pages, order, n)) {
    delete s;
    return nullptr;
  }
  return s;
}

int cxr_next_page(void* handle) {
  return static_cast<PageStream*>(handle)->NextPage();
}

const char* cxr_get_obj(void* handle, int r, size_t* size) {
  auto* s = static_cast<PageStream*>(handle);
  if (!s->current || r >= s->current->count()) {
    *size = 0;
    return nullptr;
  }
  return s->current->obj(r, size);
}

void cxr_close(void* handle) { delete static_cast<PageStream*>(handle); }

// 1 when the JPEG decoder was compiled in, 0 for a -DCXR_NO_JPEG build.
int cxr_has_jpeg() {
#ifdef CXR_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

// Decode a JPEG blob to tightly-packed RGB (H*W*3 uint8).  Returns 0 on
// success; fills *w/*h.  out may be null to query dimensions only.
// Returns -4 when the decoder was not compiled in (CXR_NO_JPEG).
int cxr_jpeg_decode(const unsigned char* blob, size_t size,
                    unsigned char* out, size_t out_capacity,
                    int* w, int* h) {
#ifdef CXR_NO_JPEG
  (void)blob; (void)size; (void)out; (void)out_capacity; (void)w; (void)h;
  return -4;
#else
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(blob),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  if (out == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  size_t need = static_cast<size_t>(*w) * (*h) * 3;
  if (out_capacity < need) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  jpeg_start_decompress(&cinfo);
  size_t stride = static_cast<size_t>(cinfo.output_width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
#endif  // CXR_NO_JPEG
}

}  // extern "C"
