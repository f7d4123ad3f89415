"""libavif 1.3.0 as Pillow 12.1's wheel bundles it (``pillow.libs/libavif-*.so``,
dav1d 1.5.1 for decoding, libyuv 1909 for colour), driven by ctypes for the
tests alone: the YUV planes dav1d decodes an AVIF to, and the RGB that
``avifImageYUVToRGB`` makes of any planes, as Pillow's AVIF plugin calls it
(``avifRGBImageSetDefaults``, then 8-bit RGB). The port never loads it.

The struct offsets are libavif 1.3.0's (``avif.h``); ``_check_layout``
holds them to what the library itself writes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

# avifPixelFormat
YUV444, YUV422, YUV420, YUV400 = 1, 2, 3, 4
# avifRange
LIMITED, FULL = 0, 1
_RGB_FORMAT_RGB, _RGB_FORMAT_RGBA = 0, 1
_PLANES_YUV, _PLANES_A = 1, 2
_CHAN_A = 3

# avifImage: width, height, depth, yuvFormat, yuvRange at 0-16;
# alphaPremultiplied after the alpha plane, its row bytes and ownership;
# matrixCoefficients (uint16) after the icc avifRWData
_IMG_RANGE, _IMG_PREMULTIPLIED, _IMG_CP, _IMG_TC, _IMG_MC = 16, 80, 104, 106, 108
# avifRGBImage: width, height, depth, format, chromaUpsampling,
# chromaDownsampling, avoidLibYUV, ignoreAlpha, alphaPremultiplied, isFloat,
# maxThreads, then pixels and rowBytes
_RGB_SIZE, _RGB_FORMAT, _RGB_PIXELS, _RGB_ROWBYTES = 64, 12, 48, 56
# avifDecoder: codecChoice, maxThreads, requestedSource, allowProgressive,
# allowIncremental, ignoreExif, ignoreXMP, imageSizeLimit,
# imageDimensionLimit, imageCountLimit, strictFlags
_DEC_SIZE_LIMIT, _DEC_STRICT = 28, 40
# avifEncoder: codecChoice, maxThreads, speed, keyframeInterval, timescale
# (8 bytes), repetitionCount, extraLayerCount, quality
_ENC_SPEED, _ENC_QUALITY = 8, 32


@functools.cache
def library() -> ctypes.CDLL:
    import PIL

    from PIL import _avif  # noqa: F401  (loads the wheel's libavif and what it needs)

    path = next((Path(PIL.__file__).resolve().parents[1] / "pillow.libs").glob("libavif-*.so*"))
    lib = ctypes.CDLL(str(path))
    for name, res, args in (
        ("avifDecoderCreate", ctypes.c_void_p, []),
        ("avifDecoderDestroy", None, [ctypes.c_void_p]),
        ("avifDecoderReadMemory", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]),
        ("avifImageCreateEmpty", ctypes.c_void_p, []),
        ("avifImageCreate", ctypes.c_void_p, [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]),
        ("avifImageAllocatePlanes", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
        ("avifImageDestroy", None, [ctypes.c_void_p]),
        ("avifImagePlane", ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int]),
        ("avifImagePlaneRowBytes", ctypes.c_uint32, [ctypes.c_void_p, ctypes.c_int]),
        ("avifImagePlaneWidth", ctypes.c_uint32, [ctypes.c_void_p, ctypes.c_int]),
        ("avifImagePlaneHeight", ctypes.c_uint32, [ctypes.c_void_p, ctypes.c_int]),
        ("avifRGBImageSetDefaults", None, [ctypes.c_void_p, ctypes.c_void_p]),
        ("avifRGBImageAllocatePixels", ctypes.c_int, [ctypes.c_void_p]),
        ("avifRGBImageFreePixels", None, [ctypes.c_void_p]),
        ("avifImageYUVToRGB", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("avifResultToString", ctypes.c_char_p, [ctypes.c_int]),
        ("avifLibYUVVersion", ctypes.c_uint, []),
        ("avifCodecVersions", None, [ctypes.c_char_p]),
        ("avifEncoderCreate", ctypes.c_void_p, []),
        ("avifEncoderDestroy", None, [ctypes.c_void_p]),
        ("avifEncoderSetCodecSpecificOption", ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]),
        ("avifEncoderAddImage", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]),
        ("avifEncoderFinish", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("avifRWDataFree", None, [ctypes.c_void_p]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _check_layout(lib)
    return lib


def _u32(ptr: int, off: int) -> int:
    return ctypes.c_uint32.from_address(ptr + off).value


def _u16(ptr: int, off: int) -> int:
    return ctypes.c_uint16.from_address(ptr + off).value


def _check_layout(lib: ctypes.CDLL) -> None:
    img = lib.avifImageCreate(7, 5, 8, YUV420)
    try:
        assert (_u32(img, 0), _u32(img, 4), _u32(img, 8), _u32(img, 12)) == (7, 5, 8, YUV420)
        rgb = (ctypes.c_ubyte * _RGB_SIZE)()
        lib.avifRGBImageSetDefaults(rgb, img)
        at = ctypes.addressof(rgb)
        assert (_u32(at, 0), _u32(at, 4), _u32(at, 8)) == (7, 5, 8)
    finally:
        lib.avifImageDestroy(img)
    dec = lib.avifDecoderCreate()
    try:  # the defaults: 16384² pixels, 32768 a side, 3600 s × 720 images, strict
        assert [_u32(dec, _DEC_SIZE_LIMIT + 4 * k) for k in range(4)] == [16384 * 16384, 32768, 2592000, 7]
    finally:
        lib.avifDecoderDestroy(dec)
    text = ctypes.create_string_buffer(256)
    lib.avifCodecVersions(text)
    assert b"dav1d" in text.value and lib.avifLibYUVVersion() == 1909, (text.value, lib.avifLibYUVVersion())


def _planes(lib: ctypes.CDLL, img: int) -> list[np.ndarray]:
    out = []
    for p in range(3):
        base = lib.avifImagePlane(img, p)
        if not base:
            break
        w, h, rb = lib.avifImagePlaneWidth(img, p), lib.avifImagePlaneHeight(img, p), lib.avifImagePlaneRowBytes(img, p)
        raw = np.ctypeslib.as_array((ctypes.c_ubyte * (rb * h)).from_address(base))
        out.append(raw.reshape(h, rb)[:, :w].copy())
    return out


def decode(data: bytes) -> dict:
    """libavif's read of ``data`` with its strict checks off, as Pillow's
    decoder sets it: its size, depth, pixel format, range, CICP, and the Y,
    U and V planes dav1d decoded (8-bit only); raises ValueError with
    libavif's result where it refuses the file."""
    lib = library()
    dec, img = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    ctypes.c_uint32.from_address(dec + _DEC_STRICT).value = 0
    try:
        res = lib.avifDecoderReadMemory(dec, img, data, len(data))
        if res:
            raise ValueError(lib.avifResultToString(res).decode())
        depth, fmt = _u32(img, 8), _u32(img, 12)
        info = {"width": _u32(img, 0), "height": _u32(img, 4), "depth": depth, "format": fmt,
                "range": _u32(img, _IMG_RANGE),
                "cicp": (_u16(img, _IMG_CP), _u16(img, _IMG_TC), _u16(img, _IMG_MC))}
        info["planes"] = _planes(lib, img) if depth == 8 else None
        return info
    finally:
        lib.avifImageDestroy(img)
        lib.avifDecoderDestroy(dec)


class _RWData(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]


def encode(yuv: np.ndarray, options: list[tuple[str, str]], speed: int = 6, quality: int = 60) -> bytes:
    """libavif's encoder (libaom) on 8-bit 4:2:0 planes taken from ``yuv``
    [H, W, 3] (U and V from every other sample), added as a one-frame
    sequence rather than a single image: libavif then runs libaom in its
    good-quality usage, where options Pillow's all-intra encoder ignores
    take effect (``aq-mode``: segmentation); the file is a still AVIF."""
    lib = library()
    h, w, _ = yuv.shape
    img, enc, out = lib.avifImageCreate(w, h, 8, YUV420), lib.avifEncoderCreate(), _RWData()
    try:
        if lib.avifImageAllocatePlanes(img, _PLANES_YUV):
            raise MemoryError("avifImageAllocatePlanes")
        for p, src in enumerate((yuv[..., 0], yuv[::2, ::2, 1], yuv[::2, ::2, 2])):
            base, rb = lib.avifImagePlane(img, p), lib.avifImagePlaneRowBytes(img, p)
            ph, pw = src.shape
            np.ctypeslib.as_array((ctypes.c_ubyte * (rb * ph)).from_address(base)).reshape(ph, rb)[:, :pw] = src
        ctypes.c_int32.from_address(enc + _ENC_SPEED).value = speed
        ctypes.c_int32.from_address(enc + _ENC_QUALITY).value = quality
        for key, value in options:
            if lib.avifEncoderSetCodecSpecificOption(enc, key.encode(), value.encode()):
                raise ValueError(f"libavif refuses the option {key}")
        res = lib.avifEncoderAddImage(enc, img, 1, 0) or lib.avifEncoderFinish(enc, ctypes.byref(out))
        if res:
            raise ValueError(lib.avifResultToString(res).decode())
        return ctypes.string_at(out.data, out.size)
    finally:
        lib.avifRWDataFree(ctypes.byref(out))
        lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(img)


def yuv_to_rgb(planes: list[np.ndarray], fmt: int, matrix: int, yuv_range: int, primaries: int = 1,
               transfer: int = 13, alpha: np.ndarray | None = None, premultiplied: bool = False) -> np.ndarray:
    """``avifImageYUVToRGB`` of 8-bit planes into 8-bit RGB with Pillow's
    settings (``avifRGBImageSetDefaults``, format RGB, automatic chroma
    upsampling) → [H, W, 3] u8. With an ``alpha`` plane, as Pillow converts
    an RGBA image: into RGBA (unpremultiplied where the image is
    ``premultiplied``), the alpha then dropped."""
    lib = library()
    h, w = planes[0].shape
    img = lib.avifImageCreate(w, h, 8, fmt)
    try:
        ctypes.c_uint32.from_address(img + _IMG_RANGE).value = yuv_range
        ctypes.c_uint32.from_address(img + _IMG_PREMULTIPLIED).value = int(premultiplied)
        for off, v in ((_IMG_CP, primaries), (_IMG_TC, transfer), (_IMG_MC, matrix)):
            ctypes.c_uint16.from_address(img + off).value = v
        if lib.avifImageAllocatePlanes(img, _PLANES_YUV | (_PLANES_A if alpha is not None else 0)):
            raise MemoryError("avifImageAllocatePlanes")
        sources = list(enumerate(planes[:1] if fmt == YUV400 else planes))
        if alpha is not None:
            sources.append((_CHAN_A, alpha))
        for p, src in sources:
            base, rb = lib.avifImagePlane(img, p), lib.avifImagePlaneRowBytes(img, p)
            ph, pw = src.shape
            dst = np.ctypeslib.as_array((ctypes.c_ubyte * (rb * ph)).from_address(base)).reshape(ph, rb)
            dst[:, :pw] = src
        rgb = (ctypes.c_ubyte * _RGB_SIZE)()
        at = ctypes.addressof(rgb)
        lib.avifRGBImageSetDefaults(rgb, img)
        ch = 3 if alpha is None else 4
        ctypes.c_uint32.from_address(at + _RGB_FORMAT).value = _RGB_FORMAT_RGB if alpha is None else _RGB_FORMAT_RGBA
        if lib.avifRGBImageAllocatePixels(rgb):
            raise MemoryError("avifRGBImageAllocatePixels")
        try:
            res = lib.avifImageYUVToRGB(img, rgb)
            if res:
                raise ValueError(lib.avifResultToString(res).decode())
            rb = _u32(at, _RGB_ROWBYTES)
            px = ctypes.c_void_p.from_address(at + _RGB_PIXELS).value
            raw = np.ctypeslib.as_array((ctypes.c_ubyte * (rb * h)).from_address(px))
            return raw.reshape(h, rb)[:, :w * ch].reshape(h, w, ch)[..., :3].copy()
        finally:
            lib.avifRGBImageFreePixels(rgb)
    finally:
        lib.avifImageDestroy(img)
