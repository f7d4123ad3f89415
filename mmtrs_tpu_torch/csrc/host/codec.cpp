// JPEG codec on the system libjpeg (libjpeg-turbo), for utils/codec.py's
// CPU backend: decode to RGB u8 as Pillow's ``Image.open(...).convert("RGB")``
// gives it (JDCT_ISLOW, fancy upsampling: libjpeg's defaults, which Pillow
// keeps), and encode RGB u8 as Pillow's ``save(..., quality=q)`` does
// (jpeg_set_defaults, then jpeg_set_quality(q, TRUE): baseline, 4:2:0).
// A CMYK or YCCK JPEG decodes to CMYK (libjpeg converts YCCK), which
// Pillow inverts ("CMYK;I", whatever the Adobe marker says) and converts
// with its cmyk2rgb: nk = 255 - k, r = nk - MULDIV255(c, nk).
//
// C API (ctypes, plain C; every call returns a status):
//   int mmtrs_jpeg_info(const void* buf, long long n, void* dims);
//     dims: int[3] <- height, width, components. 0 ok, 2 not a decodable
//     JPEG.
//   int mmtrs_jpeg_decode(const void* buf, long long n, void* out, int h, int w);
//     out: h x w x 3 bytes. 0 ok, 2 decode error (a truncated stream
//     included, as Pillow refuses one), 4 size differs.
//   int mmtrs_jpeg_decode_paths(const void* paths, int n, int min_edge,
//                               int threads, void* pixels, void* dims,
//                               void* status, void* own, long long max_pixels,
//                               void* spaces);
//     paths: const char*[n]; pixels: void*[n] <- a malloc'd buffer per
//     decoded image (free with mmtrs_codec_free), null otherwise; dims:
//     int[2n] <- (h, w); status: int[n] <- 0 ok, 1 min edge below
//     min_edge, 2 decode error; spaces: int[n] <- 0 for libjpeg's h x w x 3
//     RGB, else the colour space of the components as stored (h x w x c)
//     that ``own`` (jpeg.cpp's mmtrs_jpeg_own_decode, refusing frames over
//     max_pixels) gave: a file whose frame is lossless or arithmetic-coded
//     goes to it, every other to libjpeg. Decodes on up to ``threads``
//     threads and returns the count of status 0.
//   int mmtrs_jpeg_encode(const void* rgb, int h, int w, int quality,
//                         void* out, void* out_len);
//     out: void*[1] <- a malloc'd JPEG stream (free with
//     mmtrs_codec_free); out_len: long long[1]. 0 ok, 2 encode error.
//   int mmtrs_jpeg_decode_tiff(const void* buf, long long n, void* out,
//                              int h, int w, int comps, int ycbcr);
//     A JPEG-in-TIFF strip or tile as libtiff's JPEG codec decodes it:
//     ycbcr 1, YCbCr converted to RGB (comps 3); ycbcr 0, the components
//     as stored (JCS_UNKNOWN in and out). out: h x w x comps bytes. 0 ok,
//     2 decode error, 4 size or component count differs.
//   int mmtrs_codec_free(void* p);
//
// Build: g++ -O3 -fPIC -shared codec.cpp -ljpeg (see mmtrs_tpu_torch/_build.py)

#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#include <jpeglib.h>
#include <jerror.h>

#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void err_exit(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

// Warnings pass silently, except a stream that ends early: libjpeg pads it
// with grey and goes on, where Pillow raises "image file is truncated".
void emit_message(j_common_ptr cinfo, int level) {
    if (level < 0 && cinfo->err->msg_code == JWRN_JPEG_EOF) err_exit(cinfo);
}

bool four_components(const jpeg_decompress_struct& cinfo) {
    return cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK;
}

// Pillow's "CMYK;I" unpacking then its cmyk2rgb (libImaging/Convert.c)
void cmyk_row_to_rgb(const unsigned char* in, unsigned char* out, int w) {
    for (int x = 0; x < w; ++x, in += 4, out += 3) {
        const int nk = in[3];  // 255 - (255 - k)
        for (int c = 0; c < 3; ++c) {
            const int t = (255 - in[c]) * nk + 128;
            const int v = nk - (((t >> 8) + t) >> 8);
            out[c] = static_cast<unsigned char>(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
}

// Decode one JPEG stream from memory. With ``out`` null, reads the header
// only. Returns the status of the C API.
int decode(const unsigned char* buf, size_t n, unsigned char* out, int want_h, int want_w, int* dims) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = err_exit;
    jerr.mgr.emit_message = emit_message;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    jpeg_create_decompress(&cinfo);
    if (n == 0) err_exit(reinterpret_cast<j_common_ptr>(&cinfo));  // jpeg_mem_src refuses an empty buffer
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(n));
    jpeg_read_header(&cinfo, TRUE);
    if (dims) {
        dims[0] = static_cast<int>(cinfo.image_height);
        dims[1] = static_cast<int>(cinfo.image_width);
        dims[2] = cinfo.num_components;
    }
    if (!out) {
        jpeg_destroy_decompress(&cinfo);
        return 0;
    }
    const bool cmyk = four_components(cinfo);
    cinfo.out_color_space = cmyk ? JCS_CMYK : JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_height) != want_h || static_cast<int>(cinfo.output_width) != want_w) {
        jpeg_destroy_decompress(&cinfo);
        return 4;
    }
    const size_t row_bytes = static_cast<size_t>(want_w) * 3;
    std::vector<unsigned char> cmyk_row(cmyk ? static_cast<size_t>(want_w) * 4 : 0);
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = out + static_cast<size_t>(cinfo.output_scanline) * row_bytes;
        if (cmyk) {
            unsigned char* src = cmyk_row.data();
            jpeg_read_scanlines(&cinfo, &src, 1);
            cmyk_row_to_rgb(src, row, want_w);
        } else {
            jpeg_read_scanlines(&cinfo, &row, 1);
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

int decode_tiff(const unsigned char* buf, size_t n, unsigned char* out, int want_h, int want_w, int comps,
                bool ycbcr) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = err_exit;
    jerr.mgr.emit_message = emit_message;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    jpeg_create_decompress(&cinfo);
    if (n == 0) err_exit(reinterpret_cast<j_common_ptr>(&cinfo));
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(n));
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.num_components != comps) {
        jpeg_destroy_decompress(&cinfo);
        return 4;
    }
    cinfo.jpeg_color_space = ycbcr ? JCS_YCbCr : JCS_UNKNOWN;
    cinfo.out_color_space = ycbcr ? JCS_RGB : JCS_UNKNOWN;
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_height) != want_h || static_cast<int>(cinfo.output_width) != want_w
        || cinfo.output_components != comps) {
        jpeg_destroy_decompress(&cinfo);
        return 4;
    }
    const size_t row_bytes = static_cast<size_t>(want_w) * comps;
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = out + static_cast<size_t>(cinfo.output_scanline) * row_bytes;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

bool read_file(const char* path, std::vector<unsigned char>& bytes) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    bytes.clear();
    unsigned char chunk[1 << 16];
    size_t got;
    while ((got = std::fread(chunk, 1, sizeof chunk, f)) > 0) bytes.insert(bytes.end(), chunk, chunk + got);
    const bool ok = !std::ferror(f);
    std::fclose(f);
    return ok;
}

}  // namespace

extern "C" int mmtrs_jpeg_info(const void* buf, long long n, void* dims) {
    return decode(static_cast<const unsigned char*>(buf), static_cast<size_t>(n), nullptr, 0, 0,
                  static_cast<int*>(dims));
}

extern "C" int mmtrs_jpeg_decode(const void* buf, long long n, void* out, int h, int w) {
    return decode(static_cast<const unsigned char*>(buf), static_cast<size_t>(n),
                  static_cast<unsigned char*>(out), h, w, nullptr);
}

extern "C" int mmtrs_jpeg_decode_tiff(const void* buf, long long n, void* out, int h, int w, int comps, int ycbcr) {
    return decode_tiff(static_cast<const unsigned char*>(buf), static_cast<size_t>(n),
                       static_cast<unsigned char*>(out), h, w, comps, ycbcr != 0);
}

// jpeg.cpp's mmtrs_jpeg_own_decode: 0 decoded, 1 a frame it leaves to libjpeg
typedef int (*OwnDecode)(const void*, long long, long long, void*, void*, void*);

extern "C" int mmtrs_jpeg_decode_paths(const void* paths, int n, int min_edge, int threads, void* pixels,
                                       void* dims, void* status, void* own, long long max_pixels, void* spaces) {
    const char* const* p = static_cast<const char* const*>(paths);
    unsigned char** px = static_cast<unsigned char**>(pixels);
    int* hw = static_cast<int*>(dims);
    int* st = static_cast<int*>(status);
    int* sp = static_cast<int*>(spaces);
    const OwnDecode own_decode = reinterpret_cast<OwnDecode>(own);
    std::atomic<int> next(0);
    auto worker = [&]() {
        std::vector<unsigned char> bytes;
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            px[i] = nullptr;
            sp[i] = 0;
            int d[4] = {0, 0, 0, 0};
            st[i] = 2;
            if (!read_file(p[i], bytes)) continue;
            unsigned char* buf = nullptr;
            char msg[256];
            const int own_status = own_decode(bytes.data(), static_cast<long long>(bytes.size()), max_pixels, &buf, d, msg);
            if (own_status == 0) {
                sp[i] = d[3];
            } else if (own_status != 1) {
                continue;
            } else {
                if (decode(bytes.data(), bytes.size(), nullptr, 0, 0, d) != 0) continue;
                buf = static_cast<unsigned char*>(std::malloc(static_cast<size_t>(d[0]) * d[1] * 3));
                if (!buf) continue;
                if (decode(bytes.data(), bytes.size(), buf, d[0], d[1], nullptr) != 0) {
                    std::free(buf);
                    continue;
                }
            }
            hw[2 * i] = d[0];
            hw[2 * i + 1] = d[1];
            if (min_edge > 0 && std::min(d[0], d[1]) < min_edge) {  // decoded first, as Pillow's route does
                std::free(buf);
                st[i] = 1;
                continue;
            }
            px[i] = buf;
            st[i] = 0;
        }
    };
    const int nt = std::max(1, std::min(threads, n));
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    int ok = 0;
    for (int i = 0; i < n; ++i) ok += st[i] == 0;
    return ok;
}

extern "C" int mmtrs_jpeg_encode(const void* rgb, int h, int w, int quality, void* out, void* out_len) {
    unsigned char** dst = static_cast<unsigned char**>(out);
    long long* len = static_cast<long long*>(out_len);
    *dst = nullptr;
    *len = 0;
    // jpeg_mem_dest's buffer and size live on the heap: a local written
    // after setjmp is indeterminate after the longjmp
    struct Stream {
        unsigned char* buf;
        unsigned long size;
    };
    Stream* s = static_cast<Stream*>(std::calloc(1, sizeof(Stream)));
    if (!s) return 2;
    jpeg_compress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_compress(&cinfo);
        std::free(s->buf);
        std::free(s);
        return 2;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &s->buf, &s->size);
    cinfo.image_width = static_cast<JDIMENSION>(w);
    cinfo.image_height = static_cast<JDIMENSION>(h);
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    const unsigned char* data = static_cast<const unsigned char*>(rgb);
    const size_t row_bytes = static_cast<size_t>(w) * 3;
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<JSAMPROW>(data + static_cast<size_t>(cinfo.next_scanline) * row_bytes);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    *dst = s->buf;
    *len = static_cast<long long>(s->size);
    std::free(s);
    return 0;
}

extern "C" int mmtrs_codec_free(void* p) {
    std::free(p);
    return 0;
}
