// JPEG codec on the CUDA toolkit's nvJPEG, for utils/codec.py's card
// backend: decode into a CUDA buffer that the caller allocated (a PyTorch
// tensor), and encode from one. nvJPEG's IDCT and chroma upsampling are not
// libjpeg's, so a decode is near Pillow's, not equal to it (the bar is
// stated where chip_smoke.py holds the two together).
//
// One nvJPEG handle, decoder state, encoder state and encoder parameters
// serve the process, created at the first call and guarded by a mutex;
// every call finishes its work on ``stream`` (a cudaStream_t) before it
// returns, so the caller's host bytes and nvJPEG's own pinned buffers are
// free again.
//
// C API (ctypes, plain C; every call returns a status):
//   int mmtrs_nvjpeg_info(const void* buf, long long n, void* dims);
//     dims: int[11] <- height, width, components, then (height, width) of
//     each of four components (0 past the last). 0 ok, 2 not a decodable
//     JPEG.
//   int mmtrs_nvjpeg_decode(const void* buf, long long n, void* out, int h,
//                           int w, int gray, void* stream);
//     out: device h x w x 3 bytes (interleaved RGB), or h x w with
//     ``gray`` (the Y plane of a one-component JPEG). 0 ok, 2 decode error,
//     4 size differs, 100 + nvjpegStatus_t, 200 + cudaError_t.
//   int mmtrs_nvjpeg_decode_planes(const void* buf, long long n,
//                                  void* planes, void* stream);
//     A three- or four-component JPEG (CMYK or YCCK; a JPEG-in-TIFF strip
//     of RGB or CMYK samples) with NVJPEG_OUTPUT_UNCHANGED: planes:
//     void*[components] <- each component's samples as stored, on the
//     device, at its own size (info's), rows packed. 0 ok, 2 decode error,
//     100 + nvjpegStatus_t (nvJPEG's refusal of the scan included),
//     200 + cudaError_t.
//   int mmtrs_nvjpeg_encode(const void* rgb, int h, int w, int quality,
//                           void* out, void* out_len, void* stream);
//     rgb: device h x w x 3 bytes; out: void*[1] <- a malloc'd JPEG
//     stream (free with mmtrs_nvjpeg_free), 4:2:0, baseline Huffman
//     tables; out_len: long long[1]. 0 ok, 100 + nvjpegStatus_t,
//     200 + cudaError_t.
//   int mmtrs_nvjpeg_free(void* p);
//
// Build: nvcc -O3 -Xcompiler -fPIC -shared nvjpeg.cpp -lnvjpeg
// (see mmtrs_tpu_torch/_build.py)

#include <cstdlib>
#include <cstring>
#include <mutex>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_dec = nullptr;
nvjpegEncoderState_t g_enc = nullptr;
nvjpegEncoderParams_t g_params = nullptr;

int fail(nvjpegStatus_t s) { return 100 + static_cast<int>(s); }

int ensure_handle() {
    if (!g_handle) {
        const nvjpegStatus_t s = nvjpegCreateSimple(&g_handle);
        if (s != NVJPEG_STATUS_SUCCESS) {
            g_handle = nullptr;
            return fail(s);
        }
    }
    return 0;
}

}  // namespace

extern "C" int mmtrs_nvjpeg_info(const void* buf, long long n, void* dims) {
    std::lock_guard<std::mutex> lock(g_mu);
    if (const int e = ensure_handle()) return e;
    int comps = 0;
    nvjpegChromaSubsampling_t css;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    if (n <= 0 || nvjpegGetImageInfo(g_handle, static_cast<const unsigned char*>(buf), static_cast<size_t>(n),
                                     &comps, &css, widths, heights) != NVJPEG_STATUS_SUCCESS)
        return 2;
    if (comps != 1 && comps != 3 && comps != 4) return 2;
    int* d = static_cast<int*>(dims);
    d[0] = heights[0];
    d[1] = widths[0];
    d[2] = comps;
    for (int c = 0; c < 4; ++c) {
        d[3 + 2 * c] = c < comps ? heights[c] : 0;
        d[4 + 2 * c] = c < comps ? widths[c] : 0;
    }
    return 0;
}

namespace {

int ensure_decoder() {
    if (const int e = ensure_handle()) return e;
    if (!g_dec) {
        const nvjpegStatus_t s = nvjpegJpegStateCreate(g_handle, &g_dec);
        if (s != NVJPEG_STATUS_SUCCESS) {
            g_dec = nullptr;
            return fail(s);
        }
    }
    return 0;
}

}  // namespace

extern "C" int mmtrs_nvjpeg_decode_planes(const void* buf, long long n, void* planes, void* stream) {
    std::lock_guard<std::mutex> lock(g_mu);
    if (const int e = ensure_decoder()) return e;
    const unsigned char* data = static_cast<const unsigned char*>(buf);
    int comps = 0;
    nvjpegChromaSubsampling_t css;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    if (n <= 0 || nvjpegGetImageInfo(g_handle, data, static_cast<size_t>(n), &comps, &css, widths, heights) !=
                      NVJPEG_STATUS_SUCCESS || comps < 3 || comps > 4)
        return 2;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof img);
    void* const* p = static_cast<void* const*>(planes);
    for (int c = 0; c < comps; ++c) {
        img.channel[c] = static_cast<unsigned char*>(p[c]);
        img.pitch[c] = static_cast<size_t>(widths[c]);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const nvjpegStatus_t s = nvjpegDecode(g_handle, g_dec, data, static_cast<size_t>(n), NVJPEG_OUTPUT_UNCHANGED,
                                          &img, st);
    if (s == NVJPEG_STATUS_BAD_JPEG) return 2;
    if (s != NVJPEG_STATUS_SUCCESS) return fail(s);
    const cudaError_t c = cudaStreamSynchronize(st);
    return c == cudaSuccess ? 0 : 200 + static_cast<int>(c);
}

extern "C" int mmtrs_nvjpeg_decode(const void* buf, long long n, void* out, int h, int w, int gray, void* stream) {
    std::lock_guard<std::mutex> lock(g_mu);
    if (const int e = ensure_decoder()) return e;
    const unsigned char* data = static_cast<const unsigned char*>(buf);
    int comps = 0;
    nvjpegChromaSubsampling_t css;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    if (n <= 0 || nvjpegGetImageInfo(g_handle, data, static_cast<size_t>(n), &comps, &css, widths, heights) !=
                      NVJPEG_STATUS_SUCCESS)
        return 2;
    if (heights[0] != h || widths[0] != w || (comps == 1) != (gray != 0)) return 4;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof img);
    img.channel[0] = static_cast<unsigned char*>(out);
    img.pitch[0] = static_cast<size_t>(w) * (gray ? 1 : 3);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const nvjpegStatus_t s = nvjpegDecode(g_handle, g_dec, data, static_cast<size_t>(n),
                                          gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img, st);
    if (s == NVJPEG_STATUS_BAD_JPEG || s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED) return 2;
    if (s != NVJPEG_STATUS_SUCCESS) return fail(s);
    const cudaError_t c = cudaStreamSynchronize(st);
    return c == cudaSuccess ? 0 : 200 + static_cast<int>(c);
}

extern "C" int mmtrs_nvjpeg_encode(const void* rgb, int h, int w, int quality, void* out, void* out_len,
                                   void* stream) {
    std::lock_guard<std::mutex> lock(g_mu);
    void** dst = static_cast<void**>(out);
    long long* len = static_cast<long long*>(out_len);
    *dst = nullptr;
    *len = 0;
    if (const int e = ensure_handle()) return e;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
    if (!g_enc && (s = nvjpegEncoderStateCreate(g_handle, &g_enc, st)) != NVJPEG_STATUS_SUCCESS) {
        g_enc = nullptr;
        return fail(s);
    }
    if (!g_params && (s = nvjpegEncoderParamsCreate(g_handle, &g_params, st)) != NVJPEG_STATUS_SUCCESS) {
        g_params = nullptr;
        return fail(s);
    }
    if ((s = nvjpegEncoderParamsSetQuality(g_params, quality, st)) != NVJPEG_STATUS_SUCCESS ||
        (s = nvjpegEncoderParamsSetSamplingFactors(g_params, NVJPEG_CSS_420, st)) != NVJPEG_STATUS_SUCCESS ||
        (s = nvjpegEncoderParamsSetOptimizedHuffman(g_params, 0, st)) != NVJPEG_STATUS_SUCCESS)
        return fail(s);
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof img);
    img.channel[0] = static_cast<unsigned char*>(const_cast<void*>(rgb));
    img.pitch[0] = static_cast<size_t>(w) * 3;
    if ((s = nvjpegEncodeImage(g_handle, g_enc, g_params, &img, NVJPEG_INPUT_RGBI, w, h, st)) !=
        NVJPEG_STATUS_SUCCESS)
        return fail(s);
    size_t size = 0;
    if ((s = nvjpegEncodeRetrieveBitstream(g_handle, g_enc, nullptr, &size, st)) != NVJPEG_STATUS_SUCCESS)
        return fail(s);
    cudaError_t c = cudaStreamSynchronize(st);
    if (c != cudaSuccess) return 200 + static_cast<int>(c);
    unsigned char* buf = static_cast<unsigned char*>(std::malloc(size ? size : 1));
    if (!buf) return fail(NVJPEG_STATUS_ALLOCATOR_FAILURE);
    if ((s = nvjpegEncodeRetrieveBitstream(g_handle, g_enc, buf, &size, st)) != NVJPEG_STATUS_SUCCESS) {
        std::free(buf);
        return fail(s);
    }
    if ((c = cudaStreamSynchronize(st)) != cudaSuccess) {
        std::free(buf);
        return 200 + static_cast<int>(c);
    }
    *dst = buf;
    *len = static_cast<long long>(size);
    return 0;
}

extern "C" int mmtrs_nvjpeg_free(void* p) {
    std::free(p);
    return 0;
}
