"""The codec's WebP decoder (``csrc/host/webp.cpp`` behind
``utils/codec.py``) held against Pillow 12.1 (libwebp 1.6) on the CPU: every
file decodes to ``np.asarray(Image.open(f).convert("RGB"))`` exactly, with
no tolerance.

Lossy files come from Pillow's ``save`` (qualities, methods, sizes, alpha)
and, for the settings Pillow's ``save`` does not expose (the simple loop
filter, sharpness, filter strength, segment counts, 2 to 8 token
partitions, sharp YUV, spatial noise shaping), from the encoder of the same
libwebp through ctypes; a small boolean decoder here reads each file's
frame header back, so a setting that did not reach the bitstream fails its
case. Lossless files force each transform (palettes bundled 8, 4, 2 and 1
to a pixel, subtract-green and cross-colour on photographs, the colour
cache on many colours). Extended files carry ICC, EXIF and XMP chunks or an
animation whose first frame sits at an offset. Truncated and mutated files
raise a ValueError naming WebP exactly where Pillow raises, and decode
equal where Pillow decodes them.

Regenerate the goldens that ``chip_smoke.py`` decodes on the card
(``mmtrs_tpu_torch/testdata/webp_goldens.npz``) with ``python -m
tests.test_torch_codec_webp``.
"""

import ctypes
import hashlib
import importlib.util
import io
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mmtrs_tpu_torch.synth import synth_teeth

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "webp_goldens.npz"
PHONE_SHAPE = (768, 1024)  # a 4:3 upload: the app's 688x512 bucket
ARCHIVE_SHAPE = (3024, 4032)  # a 12 MP phone photo


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _decode(data: bytes) -> np.ndarray:
    from mmtrs_tpu_torch.utils.codec import decode_image

    return decode_image(data, "cpu").numpy()


def _save(a: np.ndarray, mode: str | None = None, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a, mode).save(b, "WEBP", **kw)
    return b.getvalue()


def _assert_equal_pillow(data: bytes, what=""):
    want = _pil(data)
    got = _decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() == 0, (what, int(d.max()), float((d > 0).mean()))


def _noise(h, w, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _smooth(h, w) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * x / max(w, 1), 255 * y / max(h, 1), 128 + 100 * np.sin(x / 9.0) * np.cos(y / 7.0)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _teeth(h, w, seed=3) -> np.ndarray:
    return synth_teeth(1, (h, w), seed=seed)[0]


# ---------------------------------------------------------------------------
# libwebp's encoder through ctypes, for the settings Pillow's save hides
# ---------------------------------------------------------------------------

# WebPConfig's int fields by index (quality, index 1, is a float); the
# layout is checked against WebPConfigInitInternal's defaults before use
_CONFIG_FIELDS = {"lossless": 0, "method": 2, "segments": 6, "sns_strength": 7, "filter_strength": 8,
                  "filter_sharpness": 9, "filter_type": 10, "autofilter": 11, "preprocessing": 17, "partitions": 18,
                  "near_lossless": 23, "exact": 24, "use_sharp_yuv": 26}
_CONFIG_DEFAULTS = {0: 0, 2: 4, 6: 4, 7: 50, 8: 60, 9: 0, 10: 1, 11: 0, 12: 1, 13: 1, 14: 100, 15: 1, 18: 0, 23: 100,
                    27: 0, 28: 100}
_ABI = 0x0200  # libwebp checks only the major byte


def _tables_script():
    spec = importlib.util.spec_from_file_location("make_webp_tables", ROOT / "scripts" / "make_webp_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def libwebp_encode(rgb: np.ndarray, quality: float = 75.0, **settings) -> bytes:
    """RGB u8 → a WebP from libwebp's WebPEncode with ``settings``
    (WebPConfig field names)."""
    from PIL import _webp  # noqa: F401  (loads libwebp with its libsharpyuv)

    lib = ctypes.CDLL(str(_tables_script().find_libwebp()))
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), _ABI)
    assert {i: cfg[i] for i in _CONFIG_DEFAULTS} == _CONFIG_DEFAULTS, "WebPConfig's layout is not the one assumed"
    ctypes.c_float.from_buffer(cfg, 4).value = quality
    for k, v in settings.items():
        cfg[_CONFIG_FIELDS[k]] = v
    assert lib.WebPValidateConfig(cfg), settings
    pic = (ctypes.c_uint8 * 1024)()  # WebPPicture is 256 bytes
    writer = (ctypes.c_uint8 * 64)()  # WebPMemoryWriter: mem, size, max_size
    assert lib.WebPPictureInitInternal(pic, _ABI)
    h, w, _ = rgb.shape
    rgb = np.ascontiguousarray(rgb)
    ctypes.c_int32.from_buffer(pic, 0).value = settings.get("lossless", 0)  # use_argb
    ctypes.c_int32.from_buffer(pic, 8).value = w
    ctypes.c_int32.from_buffer(pic, 12).value = h
    try:
        assert lib.WebPPictureImportRGB(pic, rgb.ctypes.data_as(ctypes.c_void_p), w * 3)
        lib.WebPMemoryWriterInit(writer)
        ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
        ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
        assert lib.WebPEncode(cfg, pic), settings
        return ctypes.string_at(ctypes.c_void_p.from_buffer(writer, 0).value, ctypes.c_size_t.from_buffer(writer, 8).value)
    finally:
        lib.WebPPictureFree(pic)
        lib.WebPMemoryWriterClear(writer)


class _BoolDecoder:
    """RFC 6386's boolean decoder, enough to read a frame header back."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.value, self.bits, self.range = data, 0, 0, -8, 254
        self._load()

    def _load(self):
        self.value = (self.value << 8) | (self.data[self.pos] if self.pos < len(self.data) else 0)
        self.pos, self.bits = self.pos + 1, self.bits + 8

    def bit(self, prob=128) -> int:
        if self.bits < 0:
            self._load()
        split = (self.range * prob) >> 8
        if self.value >> self.bits > split:
            r, b = self.range - split, 1
            self.value -= (split + 1) << self.bits
        else:
            r, b = split + 1, 0
        while r < 128:
            r, self.bits = r << 1, self.bits - 1
        self.range = r - 1
        return b

    def value_bits(self, n: int) -> int:
        return sum(self.bit() << i for i in range(n - 1, -1, -1))

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit() else v


def vp8_frame_header(data: bytes) -> dict:
    """The segment count, filter type, level, sharpness and token
    partitions in a lossy WebP's frame header."""
    p = data[data.find(b"VP8 ") + 8:]
    br = _BoolDecoder(p[10:10 + (int.from_bytes(p[:3], "little") >> 5)])
    br.value_bits(2)  # colour space, clamping
    segments = 1
    if br.bit():
        segments, update_map = 4, br.bit()
        if br.bit():
            br.bit()
            for n in (7, 6):
                for _ in range(4):
                    if br.bit():
                        br.signed(n)
        if update_map:
            for _ in range(3):
                if br.bit():
                    br.value_bits(8)
    simple, level, sharpness = br.bit(), br.value_bits(6), br.value_bits(3)
    if br.bit() and br.bit():
        for _ in range(8):
            if br.bit():
                br.signed(6)
    return {"segments": segments, "simple": simple, "level": level, "sharpness": sharpness,
            "partitions": 1 << br.value_bits(2)}


class _BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int = 128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def signed(self, v: int, n: int):
        self.value(abs(v), n)
        self.put(int(v < 0))

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7) << (8 * (c >> 3))) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


class _Log(_BoolDecoder):
    """A boolean decoder that logs each (bit, probability) it reads."""

    def __init__(self, data: bytes):
        super().__init__(data)
        self.log = []

    def bit(self, prob=128) -> int:
        b = super().bit(prob)
        self.log.append((b, prob))
        return b


def _skip_modes(br: _Log, mb_w: int, mb_h: int, seg_probs: list, skip_p: int | None, bmodes: list):
    """Read every macroblock's segment, skip flag and intra modes (libwebp's
    ParseIntraMode), so that each decision's probability is logged."""
    top = [0] * (4 * mb_w)
    for _ in range(mb_h):
        left = [0] * 4
        for x in range(mb_w):
            if seg_probs:
                br.bit(seg_probs[2] if br.bit(seg_probs[0]) else seg_probs[1])
            if skip_p is not None:
                br.bit(skip_p)
            if br.bit(145):  # 16x16: DC, TM, V, H as 0, 1, 2, 3
                m = (1 if br.bit(128) else 3) if br.bit(156) else (2 if br.bit(163) else 0)
                top[4 * x:4 * x + 4], left = [m] * 4, [m] * 4
            else:
                for y in range(4):
                    mode = left[y]
                    for xx in range(4):
                        pr = bmodes[top[4 * x + xx]][mode]
                        if not br.bit(pr[0]):
                            mode = 0
                        elif not br.bit(pr[1]):
                            mode = 1
                        elif not br.bit(pr[2]):
                            mode = 2
                        elif not br.bit(pr[3]):
                            mode = 3 if not br.bit(pr[4]) else 4 if not br.bit(pr[5]) else 5
                        else:
                            mode = 6 if not br.bit(pr[6]) else 7 if not br.bit(pr[7]) else 8 if not br.bit(pr[8]) else 9
                        top[4 * x + xx] = mode
                    left[y] = mode
            if br.bit(142) and br.bit(114):  # chroma: DC, V, then TM or H
                br.bit(183)


def rewrite_header(data: bytes, **change) -> bytes:
    """A lossy WebP with its frame header's segment or filter fields
    changed (``seg_<field>``, ``flt_<field>``): the first partition is
    parsed to its end (modes and all, every decision logged with its
    probability), its header re-encoded with the changes and the rest
    replayed through RFC 6386's boolean encoder; the token partitions are
    kept. libwebp's encoder never writes loop-filter deltas or relative
    segment values, so these files reach the decoder's paths for them."""
    mod = _tables_script()
    tables = mod.extract(mod.find_libwebp().read_bytes())
    update_proba = tables["CoeffsUpdateProba"][1].astype(int).reshape(-1).tolist()
    bmodes = tables["kBModesProba"][1].astype(int).tolist()
    i = data.find(b"VP8 ")
    p = data[i + 8:i + 8 + struct.unpack("<I", data[i + 4:i + 8])[0]]
    first = int.from_bytes(p[:3], "little") >> 5
    w, h = (v & 0x3FFF for v in struct.unpack("<HH", p[6:10]))
    br = _Log(p[10:10 + first])
    color = br.value_bits(2)
    seg = {"use": br.bit(), "update_map": 0, "update_data": 0, "probs": []}
    if seg["use"]:
        seg["update_map"], seg["update_data"] = br.bit(), br.bit()
        if seg["update_data"]:
            seg["absolute"] = br.bit()
            seg["quant"] = [br.signed(7) if br.bit() else 0 for _ in range(4)]
            seg["filter"] = [br.signed(6) if br.bit() else 0 for _ in range(4)]
        if seg["update_map"]:
            seg["probs"] = [br.value_bits(8) if br.bit() else 255 for _ in range(3)]
    flt = {"simple": br.bit(), "level": br.value_bits(6), "sharpness": br.value_bits(3), "use_delta": br.bit(),
           "ref": [None] * 4, "mode": [None] * 4}
    if flt["use_delta"] and br.bit():
        flt["ref"] = [br.signed(6) if br.bit() else None for _ in range(4)]
        flt["mode"] = [br.signed(6) if br.bit() else None for _ in range(4)]
    start = len(br.log)
    br.value_bits(2 + 7)  # token partitions, base quantiser
    for _ in range(5):
        if br.bit():
            br.signed(4)
    br.bit()  # update_proba
    for prob in update_proba:
        if br.bit(prob):
            br.value_bits(8)
    skip_p = br.value_bits(8) if br.bit() else None
    _skip_modes(br, (w + 15) >> 4, (h + 15) >> 4, seg["probs"], skip_p, bmodes)
    rest = br.log[start:]

    for k, v in change.items():
        (seg if k.startswith("seg_") else flt)[k[4:]] = v
    enc = _BoolEncoder()
    enc.value(color, 2)
    enc.put(seg["use"])
    if seg["use"]:
        enc.put(seg["update_map"])
        enc.put(seg["update_data"])
        if seg["update_data"]:
            enc.put(seg["absolute"])
            for n, values in ((7, seg["quant"]), (6, seg["filter"])):
                for v in values:
                    enc.put(1)
                    enc.signed(v, n)
        for prob in seg["probs"]:
            enc.put(1)
            enc.value(prob, 8)
    enc.put(flt["simple"])
    enc.value(flt["level"], 6)
    enc.value(flt["sharpness"], 3)
    enc.put(flt["use_delta"])
    if flt["use_delta"]:
        enc.put(1)  # update the deltas
        for v in flt["ref"] + flt["mode"]:
            enc.put(v is not None)
            if v is not None:
                enc.signed(v, 6)
    for b, prob in rest:
        enc.put(b, prob)
    part0 = enc.flush()
    tag = (int.from_bytes(p[:3], "little") & 0x1F) | (len(part0) << 5)
    payload = tag.to_bytes(3, "little") + p[3:10] + part0 + p[10 + first:]
    body = b"VP8 " + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ---------------------------------------------------------------------------
# Lossy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [0, 5, 50, 75, 90, 100])
def test_lossy_every_quality(quality):
    for img in (_teeth(101, 97), _noise(61, 75, quality), _smooth(50, 83)):
        _assert_equal_pillow(_save(img, quality=quality), (quality, img.shape))


@pytest.mark.parametrize("method", range(7))
def test_lossy_every_method(method):
    for img, q in ((_teeth(97, 101, 4), 80), (_noise(40, 33, method), 30), (_smooth(64, 48), 95)):
        _assert_equal_pillow(_save(img, quality=q, method=method), (method, q, img.shape))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (15, 17), (97, 101), (1, 40), (37, 1029)])
def test_lossy_sizes(shape):
    """Sizes off the macroblock grid, odd chroma widths and heights, one
    row, and a strip over 1,000 pixels wide."""
    for img in (_noise(*shape, seed=shape[0]), _smooth(*shape)):
        for q in (10, 85):
            _assert_equal_pillow(_save(img, quality=q), (shape, q))


LIBWEBP_CASES = {
    "simple_filter": ({"filter_type": 0}, {"simple": 1}),
    "simple_filter_sharp": ({"filter_type": 0, "filter_strength": 100, "filter_sharpness": 3}, {"simple": 1}),
    "normal_sharpness_7": ({"filter_sharpness": 7}, {"sharpness": 7}),
    "normal_sharpness_5": ({"filter_sharpness": 5, "filter_strength": 30}, {"sharpness": 5}),
    "strongest_filter": ({"filter_strength": 100}, {"simple": 0}),
    "no_filter": ({"filter_strength": 0}, {"level": 0}),
    "autofilter": ({"autofilter": 1}, {}),
    "one_segment": ({"segments": 1}, {"segments": 1}),
    "two_segments": ({"segments": 2}, {"segments": 4}),
    "two_partitions": ({"partitions": 1, "method": 0}, {"partitions": 2}),
    "four_partitions": ({"partitions": 2, "method": 1}, {"partitions": 4}),
    "eight_partitions": ({"partitions": 3, "method": 2}, {"partitions": 8}),
    "sharp_yuv": ({"use_sharp_yuv": 1}, {}),
    "sns_off": ({"sns_strength": 0}, {}),
    "sns_full": ({"sns_strength": 100}, {}),
    "eight_partitions_simple_q3": ({"partitions": 3, "method": 0, "filter_type": 0}, {"partitions": 8, "simple": 1}),
}


@pytest.mark.parametrize("case", list(LIBWEBP_CASES))
def test_lossy_encoder_settings(case):
    """Settings Pillow's save does not expose, from libwebp's encoder;
    each file's frame header shows the setting took."""
    settings, header = LIBWEBP_CASES[case]
    quality = 3.0 if case.endswith("q3") else 70.0
    for img in (_teeth(120, 136, 5), _noise(49, 67, 2)):
        data = libwebp_encode(img, quality, **settings)
        got = vp8_frame_header(data)
        assert {k: got[k] for k in header} == header, (case, got)
        _assert_equal_pillow(data, case)


HEADER_REWRITES = {
    "lf_deltas": {"flt_use_delta": 1, "flt_ref": [12, -3, 4, None], "flt_mode": [-9, 2, None, 5]},
    "lf_deltas_clamped": {"flt_use_delta": 1, "flt_ref": [-63, None, None, None], "flt_mode": [63, None, None, None]},
    "lf_delta_sharpness_6": {"flt_use_delta": 1, "flt_ref": [20, None, None, None], "flt_sharpness": 6},
    "relative_segments": {"seg_absolute": 0, "seg_quant": [-5, 3, 0, 10], "seg_filter": [4, -6, 10, 0]},
    "simple_filter_lf_deltas": {"flt_simple": 1, "flt_use_delta": 1, "flt_ref": [-4, None, None, None],
                                "flt_mode": [30, None, None, None]},
}


@pytest.mark.parametrize("case", list(HEADER_REWRITES))
def test_lossy_header_rewrites(case):
    """The loop filter's reference and mode deltas (clamped at 0 and 63,
    with sharpness, on either filter) and segment values relative to the
    base, written into a libwebp file's first partition: each file decodes
    otherwise than the original, and equal to Pillow."""
    base = libwebp_encode(_teeth(120, 136, 5), 60.0)
    assert _pil(rewrite_header(base)).tobytes() == _pil(base).tobytes()  # the rewrite alone changes nothing
    data = rewrite_header(base, **HEADER_REWRITES[case])
    assert not np.array_equal(_pil(data), _pil(base))
    _assert_equal_pillow(data, case)


@pytest.mark.parametrize("case", ["default", "exact", "alpha_quality_20", "lossless", "lossless_exact"])
def test_alpha_does_not_change_rgb(case):
    """RGBA files (ALPH + VP8, or VP8L with alpha): Pillow's RGB is the
    colour planes as decoded, whatever the alpha."""
    t = _teeth(61, 83, 6)
    a = np.random.default_rng(7).integers(0, 256, t.shape[:2]).astype(np.uint8)
    a[:12] = 0  # rows the encoder may rewrite unless exact
    kw = {"default": {}, "exact": {"exact": True}, "alpha_quality_20": {"alpha_quality": 20},
          "lossless": {"lossless": True}, "lossless_exact": {"lossless": True, "exact": True}}[case]
    data = _save(np.dstack([t, a]), "RGBA", **kw)
    assert (b"ALPH" in data) == (not kw.get("lossless"))
    _assert_equal_pillow(data, case)


# ---------------------------------------------------------------------------
# Lossless
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("colors", [2, 3, 4, 5, 16, 17, 256])
def test_lossless_palettes_at_every_bundling(colors):
    """Colour indexing with 8, 4, 2 and 1 pixels to a byte (2, 3-4, 5-16
    and more colours), on widths that do not fill the last byte."""
    pal = np.random.default_rng(colors).integers(0, 256, (colors, 3)).astype(np.uint8)
    for h, w in ((33, 37), (5, 1), (16, 129)):
        idx = np.random.default_rng(h * w).integers(0, colors, (h, w))
        for method in (0, 6):
            _assert_equal_pillow(_save(pal[idx], lossless=True, method=method), (colors, h, w, method))


@pytest.mark.parametrize("case", ["teeth_m0_q0", "teeth_m3_q50", "teeth_m6_q100", "noise_m4", "smooth_m5",
                                  "gray", "many_colors_cache", "near_lossless"])
def test_lossless_transforms(case):
    """Predictor, cross-colour and subtract-green on photographs and ramps,
    gray, many distinct colours (the colour cache and long references)."""
    if case.startswith("teeth"):
        method, q = int(case.split("_")[1][1:]), int(case.split("_")[2][1:])
        data = _save(_teeth(90, 120, 8), lossless=True, method=method, quality=q)
    elif case == "noise_m4":
        data = _save(_noise(40, 51, 9), lossless=True)
    elif case == "smooth_m5":
        data = _save(_smooth(77, 91), lossless=True, method=5)
    elif case == "gray":
        data = _save(np.repeat(_teeth(64, 80, 10)[..., :1], 3, axis=2), lossless=True)
    elif case == "many_colors_cache":
        base = np.random.default_rng(11).integers(0, 256, (64, 3)).astype(np.uint8)
        idx = np.random.default_rng(12).integers(0, 64, (70, 90))
        idx[:, 45:] = idx[:, :45]  # repeats: references and cache hits
        data = _save(base[idx] ^ np.uint8(3) * (np.arange(90)[None, :, None] % 2).astype(np.uint8), lossless=True)
    else:
        data = libwebp_encode(_teeth(80, 96, 13), 90.0, lossless=1, near_lossless=40)
    assert data[12:16] == b"VP8L"
    _assert_equal_pillow(data, case)


# ---------------------------------------------------------------------------
# Extended files
# ---------------------------------------------------------------------------


def _animation(offset: bool, **kw) -> bytes:
    """Two frames; with ``offset`` the first is drawn in a rectangle of a
    transparent canvas, which Pillow's encoder crops to an ANMF frame at an
    offset."""
    first = np.zeros((40, 50, 4), np.uint8)
    if offset:
        first[10:30, 6:40, :3] = _teeth(20, 34, 14)
        first[10:30, 6:40, 3] = 255
    else:
        first[..., :3], first[..., 3] = _teeth(40, 50, 14), 255
    second = np.dstack([_teeth(40, 50, 15), np.full((40, 50), 255, np.uint8)])
    b = io.BytesIO()
    Image.fromarray(first, "RGBA").save(b, "WEBP", save_all=True, append_images=[Image.fromarray(second, "RGBA")],
                                        duration=80, **kw)
    return b.getvalue()


def _first_anmf(data: bytes) -> tuple[int, int, int, int]:
    i = data.find(b"ANMF") + 8
    x, y, w, h = (int.from_bytes(data[i + k:i + k + 3], "little") for k in (0, 3, 6, 9))
    return 2 * x, 2 * y, w + 1, h + 1


@pytest.mark.parametrize("case", ["offset_lossy", "offset_lossless", "full_lossy", "mixed"])
def test_animation_first_frame(case):
    """The first frame of a two-frame animation, at its offset on a black
    canvas as Pillow gives it."""
    kw = {"offset_lossy": {"minimize_size": True}, "offset_lossless": {"minimize_size": True, "lossless": True},
          "full_lossy": {}, "mixed": {"allow_mixed": True}}[case]
    data = _animation(case.startswith("offset"), **kw)
    if case.startswith("offset"):
        assert _first_anmf(data) == (6, 10, 34, 20)
        assert not _pil(data)[:10].any()
    _assert_equal_pillow(data, case)


def test_icc_exif_and_xmp_are_skipped():
    data = _save(_teeth(61, 83, 16), quality=80, icc_profile=bytes(range(200)), exif=b"Exif\x00\x00II*\x00" + bytes(30),
                 xmp="<x:xmpmeta/>")
    assert all(tag in data for tag in (b"VP8X", b"ICCP", b"EXIF", b"XMP "))
    _assert_equal_pillow(data)


def test_alph_in_a_simple_file_is_dropped_unread():
    """A simple (no VP8X) file with a broken ALPH chunk after its image:
    the demuxer drops ALPH without the canvas's alpha flag, so Pillow
    decodes the image, and so does the port."""
    data = _save(_teeth(30, 40, 3), quality=70) + b"ALPH" + struct.pack("<I", 3) + b"\x01\xff\xff\x00"
    _assert_equal_pillow(data[:4] + struct.pack("<I", len(data) - 8) + data[8:])


# ---------------------------------------------------------------------------
# The tables, cuts, corruption and bombs
# ---------------------------------------------------------------------------


def test_tables_header_equals_what_the_script_reads_from_libwebp():
    mod = _tables_script()
    assert (ROOT / "mmtrs_tpu_torch" / "csrc" / "host" / "webp_tables.h").read_text() == mod.render()


def _small_files() -> dict[str, bytes]:
    t = _teeth(29, 33, 17)
    return {"lossy": _save(t, quality=60), "lossless": _save(t, lossless=True),
            "lossy_partitions": libwebp_encode(t, 60.0, partitions=2, method=0),
            "alpha": _save(np.dstack([t, t[..., 0]]), "RGBA", quality=50),
            "animated": _animation(True, minimize_size=True)}


@pytest.mark.parametrize("kind", ["lossy", "lossless"])
def test_every_cut_raises(kind):
    from mmtrs_tpu_torch.utils.codec import decode_image

    data = _small_files()[kind]
    for cut in range(len(data)):
        with pytest.raises(ValueError, match="WebP|cannot identify"):
            decode_image(data[:cut], "cpu")


def _resized(data: bytes, cut: int) -> bytes:
    """``data[:cut]`` with the RIFF size and the cut chunk's size made to
    fit, so that the bitstream itself ends early."""
    m = bytearray(data[:cut])
    m[4:8] = struct.pack("<I", cut - 8)
    pos = 30 if m[12:16] == b"VP8X" else 12
    while pos + 8 <= cut:
        size = struct.unpack("<I", m[pos + 4:pos + 8])[0]
        inner = 24 if m[pos:pos + 4] == b"ANMF" and pos + 24 + 8 <= cut else 0
        if pos + 8 + size + (size & 1) >= cut:
            m[pos + 4:pos + 8] = struct.pack("<I", cut - pos - 8)
            if inner:
                pos += inner
                continue
            break
        pos += 8 + size + (size & 1)
    return bytes(m)


def _agree(data: bytes) -> bool:
    try:
        want = _pil(data)
    except Exception:  # noqa: BLE001  (whatever Pillow raises for a bad file)
        want = None
    try:
        got = _decode(data)
    except ValueError as e:
        assert "WebP" in str(e), e
        got = None
    return (want is None) == (got is None) and (want is None or np.array_equal(got, want))


@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy_partitions", "alpha", "animated"])
def test_short_and_mutated_bitstreams_agree_with_pillow(kind):
    """Each cut with its sizes made to fit, and 150 files with 1-3 bytes
    changed past the RIFF header: the decoder raises a ValueError naming
    WebP exactly where Pillow raises, and otherwise decodes equal."""
    data = _small_files()[kind]
    rng = np.random.default_rng(len(data))
    bad = [cut for cut in range(21, len(data)) if not _agree(_resized(data, cut))]
    for _ in range(150):
        m = bytearray(data)
        for i in rng.integers(12, len(m), rng.integers(1, 4)):
            m[int(i)] = int(rng.integers(0, 256))
        if not _agree(bytes(m)):
            bad.append(bytes(m).hex())
    assert bad == [], bad[:3]


def _corrupt() -> dict[str, bytes]:
    """Corrupt WebPs of each kind, which Pillow refuses too."""
    t = _teeth(30, 40, 18)
    lossy, lossless = _save(t, quality=70), _save(t, lossless=True)
    inter = bytearray(lossy)
    inter[20] |= 1  # the frame tag's key-frame bit: an inter frame
    riff = bytearray(lossy)
    riff[4:8] = struct.pack("<I", len(lossy) + 100)  # the RIFF size beyond the file
    return {"truncated_vp8": _resized(lossy, len(lossy) - 20), "truncated_vp8l": _resized(lossless, len(lossless) - 30),
            "inter_frame": bytes(inter), "bad_riff_size": bytes(riff)}


@pytest.mark.parametrize("case", ["truncated_vp8", "truncated_vp8l", "inter_frame", "bad_riff_size"])
def test_corrupt_files_raise_naming_webp(case):
    from mmtrs_tpu_torch.utils.codec import decode_image

    data = _corrupt()[case]
    with pytest.raises(Exception):  # noqa: B017  (Pillow's own error types)
        _pil(data)
    with pytest.raises(ValueError, match="WebP"):
        decode_image(data, "cpu")


def _bombs() -> dict[str, bytes]:
    """Headers that ask for more than Pillow's DecompressionBombError limit."""
    riff = lambda body: b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
    chunk = lambda tag, body: tag + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)
    size14 = 16383 | (16383 << 14)  # VP8L: 16384 x 16384
    vp8l = chunk(b"VP8L", b"\x2f" + struct.pack("<I", size14) + bytes(16))
    small_vp8l = _save(_teeth(8, 8, 19), lossless=True)[12:]
    vp8 = chunk(b"VP8 ", struct.pack("<I", 0x10 | (8 << 5))[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", 16383, 16383)
                + bytes(40))
    canvas = chunk(b"VP8X", bytes([0, 0, 0, 0]) + (60000 - 1).to_bytes(3, "little") * 2)
    return {"vp8l": riff(vp8l), "vp8": riff(vp8), "vp8x_canvas": riff(canvas + small_vp8l)}


@pytest.mark.parametrize("case", ["vp8l", "vp8", "vp8x_canvas"])
def test_oversized_headers_are_refused_before_allocating(case):
    import tracemalloc

    from mmtrs_tpu_torch.utils.codec import MAX_PIXELS, decode_image

    data = _bombs()[case]
    assert len(data) < 2048
    with pytest.raises(Exception):  # noqa: B017  (DecompressionBombError, or a bad-file error)
        _pil(data)
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=rf"WebP .* exceeds the limit of {MAX_PIXELS} pixels"):
            decode_image(data, "cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 16 << 20, peak


# ---------------------------------------------------------------------------
# Goldens for the card (written by python -m tests.test_torch_codec_webp)
# ---------------------------------------------------------------------------

BIG_GOLDENS = ("phone_1024x768_q90.webp", "archive_3024x4032_q80.webp")


def make_goldens() -> dict[str, bytes]:
    """The WebP files ``chip_smoke.py`` decodes on the card: small lossy,
    lossless, alpha, extended and animated files, a 1024x768 tooth to upload
    and a 12 MP tooth, both turned."""
    t = _teeth(101, 97, 20)
    return {
        "lossy_q80_97x101.webp": _save(t, quality=80),
        "lossy_q5_m0_15x17.webp": _save(_noise(15, 17, 21), quality=5, method=0),
        "lossy_simple_filter_8_partitions.webp": libwebp_encode(_teeth(120, 136, 22), 60.0, filter_type=0,
                                                                 partitions=3, method=0),
        "lossless_97x101.webp": _save(t, lossless=True),
        "lossless_palette_4.webp": _save(np.random.default_rng(23).integers(0, 4, (33, 37)).astype(np.uint8)[..., None]
                                         .repeat(3, axis=2) * np.uint8(60), lossless=True),
        "alpha_lossy.webp": _save(np.dstack([t, t[..., 1]]), "RGBA", quality=70),
        "icc_exif.webp": _save(t, quality=80, icc_profile=bytes(range(200)), exif=b"Exif\x00\x00II*\x00" + bytes(30)),
        "animated_offset.webp": _animation(True, minimize_size=True),
        # turned past deskew's 15° tolerance, so the card's paths shear them (K3, K7)
        BIG_GOLDENS[0]: _save(synth_teeth(1, PHONE_SHAPE, seed=24, angles_deg=[-25.0])[0], quality=90),
        BIG_GOLDENS[1]: _save(synth_teeth(1, ARCHIVE_SHAPE, seed=25, angles_deg=[30.0])[0], quality=80),
    }


def golden_arrays(files: dict[str, bytes]) -> dict[str, np.ndarray]:
    """The npz's arrays: each file's bytes, and Pillow's decode of the
    small ones, the SHA-256 and shape of the big ones'."""
    arrays = {}
    for name, data in files.items():
        arrays[name] = np.frombuffer(data, np.uint8)
        want = _pil(data)
        if name in BIG_GOLDENS:
            arrays[f"{name}.sha256"] = np.frombuffer(hashlib.sha256(want.tobytes()).digest(), np.uint8)
            arrays[f"{name}.shape"] = np.array(want.shape, np.int64)
        else:
            arrays[f"{name}.pil"] = want
    return arrays


def test_goldens_are_committed_and_equal_pillow():
    """The committed goldens are a fresh build's bytes and Pillow's decode;
    the codec decodes each equal (the big ones by SHA-256 and shape)."""
    fresh = make_goldens()
    with np.load(GOLDENS) as z:
        assert sorted(f for f in z.files if f.endswith(".webp")) == sorted(fresh)
        want = golden_arrays({name: z[name].tobytes() for name in fresh})
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
            got = _decode(data)
            for key in (k for k in want if k.startswith(name + ".")):
                np.testing.assert_array_equal(z[key], want[key], err_msg=key)
            if name in BIG_GOLDENS:
                assert hashlib.sha256(got.tobytes()).digest() == z[f"{name}.sha256"].tobytes(), name
                assert got.shape == tuple(z[f"{name}.shape"]), name
            else:
                np.testing.assert_array_equal(got, z[f"{name}.pil"], err_msg=name)
    assert len(fresh[BIG_GOLDENS[1]]) < 1_000_000


if __name__ == "__main__":
    GOLDENS.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDENS, **golden_arrays(make_goldens()))
    print(f"wrote {GOLDENS} ({GOLDENS.stat().st_size} bytes)")
