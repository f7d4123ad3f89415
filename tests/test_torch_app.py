"""The port's serving app (``mmtrs_tpu_torch/serve/app.py``) beside the JAX
package's on the CPU: both ``serve_http`` surfaces on ephemeral ports.

- ``GET /`` answers the same JSON; ``GET /ui`` the same page but for its
  title, which names the H100;
- the serving contract of tests/test_serve_contract.py holds on a weightless
  service: the full schema, a structured error for every refused request;
- on the folds tests/test_torch_service_weights.py exports, ``POST
  /predict`` (uploads in JPEG, lossless and arithmetic-coded JPEG, PNG and
  the other formats, without and with all 9 fields) answers
  what the port's ``predict_one`` answers on the decoded upload, its streams
  within that file's bf16 bar of the JAX app's, and its preview PNG decodes
  to ``processed_image`` exactly.
"""

import base64
import io
import json
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mmtrs_tpu.serve.choices import CHOICES_MAP, FIELD_ORDER
from tests.synth import synth_images
from tests.test_torch_service_weights import BF16_BAR, TAB_BAR, weights_dir  # noqa: F401 (a fixture)


def _port_server(service):
    from mmtrs_tpu_torch.serve import app

    httpd = app.make_server(service, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _jax_server(service) -> str:
    """The JAX app's ``serve_http`` (which serves forever) on a free port,
    in a daemon thread, once it accepts connections."""
    from mmtrs_tpu.serve import app as japp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=japp.serve_http, args=(service, "127.0.0.1", port), daemon=True).start()
    for _ in range(100):
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return f"http://127.0.0.1:{port}"
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("the JAX app did not start")


def _get(url: str):
    with urllib.request.urlopen(url) as r:
        return r.headers["Content-Type"], r.read()


def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(f"{url}/predict", data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _encoded(img: np.ndarray, fmt: str) -> bytes:
    """``img`` as a ``fmt`` upload: Pillow's writers, a CMYK TIFF, a 16-bit
    RGB TIFF (each sample v · 257), an RLE TGA, an RLE PSD, a DXT5 DDS, a
    lossless JPEG (predictor 1), an arithmetic-coded 4:2:0 JPEG (the
    system libjpeg's, q75: under Pillow's 64 KiB read block, which the JAX
    app's stock Pillow needs for an arithmetic-coded file) and JPEG 2000
    (.jp2, 5/3 or 9/7); AVIF at Pillow's defaults."""
    from tests.jpeg_streams import lossless_jpeg
    from tests.test_torch_codec_formats import tiff_bytes
    from tests.test_torch_codec_jpeg import JpegTool
    from tests.test_torch_codec_pillow import psd_bytes

    if fmt == "JPEG_LOSSLESS":
        return lossless_jpeg(img, 1)
    if fmt == "JPEG_ARITH":
        with tempfile.TemporaryDirectory() as d:
            return JpegTool(Path(d))(img, quality=75)
    h, w, _ = img.shape
    if fmt == "TIFF_16BIT":
        px = (img.astype(np.uint16) * 257).astype(">u2")
        return tiff_bytes(w, h, {258: (3, [16] * 3), 259: (3, [1]), 262: (3, [2]), 277: (3, [3]), 278: (4, [h])},
                          [px.tobytes()], bo=">")
    if fmt == "PSD":
        return psd_bytes(3, 8, [np.ascontiguousarray(img[..., c]) for c in range(3)], True)
    if fmt.startswith("JPEG2000"):  # a .jp2: the 5/3 wavelet, or the 9/7 at 20:1
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG2000", **({"irreversible": True, "quality_layers": [20]}
                                                      if fmt.endswith("97") else {}))
        return buf.getvalue()
    buf = io.BytesIO()
    pil = Image.fromarray(img)
    kw = {"JPEG": {"quality": 95}, "TGA": {"compression": "tga_rle"}, "DDS": {"pixel_format": "DXT5"}}.get(fmt, {})
    if fmt == "TIFF_CMYK":
        pil, fmt = pil.convert("CMYK"), "TIFF"
    pil.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def weightless(tmp_path_factory):
    """Both apps over a service with no streams (the contract test's)."""
    from mmtrs_tpu.serve.ensembles import build_service_from_weights as jbuild
    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights

    empty = tmp_path_factory.mktemp("empty_weights")
    httpd, url = _port_server(build_service_from_weights(empty, device="cpu"))
    yield url, _jax_server(jbuild(empty))
    httpd.shutdown()
    httpd.server_close()


def test_schema_equals_jax(weightless):
    from mmtrs_tpu.serve.choices import THRESHOLD_MODES as JMODES
    from mmtrs_tpu_torch.serve.choices import THRESHOLD_MODES

    url, jurl = weightless
    (ctype, body), (jctype, jbody) = _get(f"{url}/"), _get(f"{jurl}/")
    assert ctype == jctype == "application/json"
    assert json.loads(body) == json.loads(jbody)
    schema = json.loads(body)
    assert set(schema["fields"]) == set(FIELD_ORDER)
    for field in FIELD_ORDER:
        assert schema["fields"][field] == list(CHOICES_MAP[field])
    assert THRESHOLD_MODES == JMODES == schema["threshold_modes"]
    assert "metrics" in schema


def test_ui_page_equals_jax_but_for_the_title(weightless):
    url, jurl = weightless
    (ctype, body), (jctype, jbody) = _get(f"{url}/ui"), _get(f"{jurl}/ui/")
    assert ctype == jctype == "text/html; charset=utf-8"
    page, jpage = body.decode(), jbody.decode()
    assert "<title>Tooth Restoration Selection (H100)</title>" in page
    assert page.replace("(H100)</title>", "(TPU)</title>") == jpage
    for needle in ('id="image"', 'id="fields"', "thr_mode", 'id="go"', 'id="streams"', 'id="proc"',
                   'id="dash"', "/predict"):
        assert needle in page, needle


@pytest.mark.parametrize("case", ["no_streams_png", "no_streams_jpeg", "bad_base64", "not_an_image",
                                  "missing_image", "unknown_endpoint", "eps", "wmf", "emf", "bufr", "grib", "hdf5",
                                  "mpeg"])
def test_error_contract_equals_jax(weightless, case):
    """Every refused request is a structured error with JAX's status and
    text; where the text comes from the image decoder (Pillow's against the
    port's codec), the status and the presence of an error. EPS, WMF/EMF
    and the stub formats (BUFR, GRIB, HDF5, MPEG), which Pillow here cannot
    load either, are refused alike."""
    from tests.test_torch_codec_pillow import refused_files

    url, jurl = weightless
    img = np.zeros((8, 8, 3), np.uint8)
    body = {
        "no_streams_png": {"image_b64": _b64(_encoded(img, "PNG"))},
        "no_streams_jpeg": {"image_b64": _b64(_encoded(synth_images(1, 520, seed=3)[0], "JPEG"))},
        "bad_base64": {"image_b64": "!!!"},
        "not_an_image": {"image_b64": _b64(b"plain text")},
        "missing_image": {"fields": {}},
    }.get(case)
    if case in refused_files():
        body = {"image_b64": _b64(refused_files()[case][0])}
    if case == "unknown_endpoint":
        req = lambda u: urllib.request.Request(f"{u}/other", data=b"{}", method="POST")
        codes = []
        for u in (url, jurl):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req(u))
            codes.append((e.value.code, json.loads(e.value.read())))
        assert codes[0] == codes[1] == (404, {"error": "unknown endpoint"})
        return
    (code, got), (jcode, want) = _post(url, body), _post(jurl, body)
    assert code == jcode and "error" in got and "error" in want
    if case in ("no_streams_png", "no_streams_jpeg", "missing_image"):
        assert got == want


@pytest.fixture(scope="module")
def trained(weights_dir):  # noqa: F811
    from mmtrs_tpu.serve.ensembles import build_service_from_weights as jbuild
    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights

    svc = build_service_from_weights(weights_dir, device="cpu")
    httpd, url = _port_server(svc)
    yield svc, url, _jax_server(jbuild(weights_dir))
    httpd.shutdown()
    httpd.server_close()


@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "WEBP", "TIFF_CMYK", "TIFF_16BIT", "TGA", "PSD", "DDS",
                                 "JPEG_LOSSLESS", "JPEG_ARITH", "JPEG2000", "JPEG2000_97", "AVIF"])
@pytest.mark.parametrize("with_fields", [False, True])
def test_predict_equals_predict_one_and_jax(trained, fmt, with_fields):
    from mmtrs_tpu_torch.utils.codec import decode_image

    svc, url, jurl = trained
    raw = _encoded(synth_images(1, 520, seed=77)[0], fmt)
    fields = {k: list(CHOICES_MAP[k])[1] for k in FIELD_ORDER} if with_fields else None
    body = {"image_b64": _b64(raw), "include_processed": True, "thr_mode": "max_acc",
            **({"fields": fields} if fields else {})}
    (code, got), (jcode, want) = _post(url, body), _post(jurl, body)
    assert code == jcode == 200
    ref = svc.predict_one(decode_image(raw, "cpu"), fields=fields, thr_mode="max_acc")
    proc = ref.pop("processed_image")
    assert {k: v for k, v in got.items() if k != "processed_image_b64"} == json.loads(json.dumps(ref))
    preview = np.asarray(Image.open(io.BytesIO(base64.b64decode(got["processed_image_b64"]))))
    np.testing.assert_array_equal(preview, proc)
    np.testing.assert_array_equal(decode_image(base64.b64decode(got["processed_image_b64"]), "cpu").numpy(), proc)
    assert set(got["streams"]) == set(want["streams"]) == (
        {"prob_mm", "prob_mil", "prob_tab"} if with_fields else {"prob_mm", "prob_mil"})
    for k, p in got["streams"].items():
        assert abs(p - want["streams"][k]) <= (TAB_BAR if k == "prob_tab" else BF16_BAR), (k, p, want["streams"][k])
    assert abs(got["p_indirect"] - want["p_indirect"]) <= BF16_BAR
    assert got["threshold"] == want["threshold"] and got["used_tabular"] == want["used_tabular"] == with_fields


@pytest.mark.parametrize("case", ["low_resolution", "partial_fields"])
def test_refusals_equal_jax(trained, case):
    """A 300×300 upload and a partial set of fields give JAX's answers."""
    _, url, jurl = trained
    if case == "low_resolution":
        body = {"image_b64": _b64(_encoded(synth_images(1, 300, seed=5)[0], "PNG"))}
    else:
        body = {"image_b64": _b64(_encoded(synth_images(1, 520, seed=6)[0], "JPEG")),
                "fields": {"depth": "> 4mm", "width": "< 1mm"}}
    (code, got), (jcode, want) = _post(url, body), _post(jurl, body)
    assert code == jcode == 400 and got == want
    assert got["error"] == ("image resolution too low (min edge 300 < 512)" if case == "low_resolution" else
                            "provide all tabular fields or none; missing: " + str(FIELD_ORDER[2:]))


def test_main_builds_the_service_on_the_named_device(tmp_path, monkeypatch):
    """``main`` builds from ``--weights`` on ``--device`` and, without
    Gradio, serves over HTTP."""
    from mmtrs_tpu_torch.serve import app

    calls = {}
    monkeypatch.setattr(app, "serve_http", lambda svc, host, port: calls.update(svc=svc, host=host, port=port))
    assert app.main(["--weights", str(tmp_path), "--device", "cpu", "--port", "0"]) == 0
    assert calls["svc"].device.type == "cpu" and calls["port"] == 0 and calls["host"] == "127.0.0.1"
