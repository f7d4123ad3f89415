"""Serving app on the card — Gradio UI when available, stdlib JSON HTTP
otherwise (the port's twin of mmtrs_tpu/serve/app.py).

Reference: ui/gradio_app/app.py (form with 9 dropdowns mirroring the
standardizer encodings, threshold-mode selector, per-stream probability
table, processed-image preview, performance dashboard reading
results/stack_v2/summary.json with hard-coded fallback metrics
(app.py:157-214)). Uploads are decoded with the port's codec on the
service's device (nvJPEG on the card; PNG on the host) and the preview is
encoded as PNG with ``zlib``, so the app needs no Pillow. All logic lives in
mmtrs_tpu_torch.serve.service.

    python -m mmtrs_tpu_torch.serve.app --weights weights [--port 7860] [--device cuda]
"""

from __future__ import annotations

import base64
import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.serve.choices import CHOICES_MAP, FIELD_ORDER, THRESHOLD_MODES
from mmtrs_tpu_torch.serve.service import PredictService
from mmtrs_tpu_torch.utils.codec import decode_image, encode_png

FALLBACK_METRICS = {  # app.py:157-214 hard-coded fallback dashboard values
    "test": {"auc": 0.8695, "acc": 0.8223, "prec": 0.8192, "rec": 0.9062, "f1": 0.8605},
    "thr": 0.4703,
}


def load_overall_metrics(results_dir: str | Path = "results/stack_v2") -> dict:
    p = Path(results_dir) / "summary.json"
    if p.exists():
        try:
            return json.loads(p.read_text())
        except (OSError, ValueError):
            pass
    return FALLBACK_METRICS


def _decode_image(b64: str, device: str | torch.device | None = None) -> torch.Tensor:
    """A base64 upload → RGB u8 [H, W, 3] on ``device`` (None: the card)."""
    return decode_image(base64.b64decode(b64), device)


def _encode_png(arr) -> str:
    # clip+round to match the on-device quantization contract used by
    # data/records.py (truncation would disagree with training artifacts by
    # up to one intensity level)
    u8 = np.clip(np.round(np.asarray(arr, dtype=np.float32)), 0, 255).astype(np.uint8)
    return base64.b64encode(encode_png(u8)).decode()


def make_server(service: PredictService, host: str = "127.0.0.1", port: int = 7860) -> HTTPServer:
    """The HTTP server of :func:`serve_http`, bound and not yet serving
    (port 0: an ephemeral port, in ``server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj):
            body = json.dumps(obj, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/ui":
                body = build_ui_html().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._send(
                200,
                {
                    "fields": {k: list(v) for k, v in CHOICES_MAP.items()},
                    "threshold_modes": THRESHOLD_MODES,
                    "metrics": load_overall_metrics(),
                },
            )

        def do_POST(self):
            if self.path != "/predict":
                return self._send(404, {"error": "unknown endpoint"})
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n))
                img = _decode_image(req["image_b64"], service.device)
                out = service.predict_one(
                    img,
                    fields=req.get("fields"),
                    thr_mode=req.get("thr_mode", "max_f1"),
                    threshold=req.get("threshold"),
                )
                proc = out.pop("processed_image", None)
                if req.get("include_processed") and proc is not None:
                    out["processed_image_b64"] = _encode_png(proc)
                self._send(200 if "error" not in out else 400, out)
            except Exception as e:  # the server answers every request; the error goes back to the client
                self._send(500, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return HTTPServer((host, port), Handler)


def serve_http(service: PredictService, host: str = "127.0.0.1", port: int = 7860):
    """JSON API + browser UI: GET / → form schema + dashboard (JSON);
    GET /ui → the HTML serving surface (the reference's Gradio form —
    ui/gradio_app/app.py:25-86 — as a dependency-free page over the same
    API); POST /predict (set ``include_processed`` for the preview)."""
    httpd = make_server(service, host, port)
    print(f"serving on http://{host}:{port}")
    httpd.serve_forever()


def build_ui_html() -> str:
    """The serving UI as a dependency-free HTML page over the JSON API.

    Functional parity with the reference's Gradio Blocks app
    (ui/gradio_app/app.py:25-86): tooth-photo upload, the 9 clinical
    dropdowns (choices pulled live from GET / so they always match the
    standardizer encodings), threshold-mode selector, prediction label,
    per-stream probability table, processed-image preview, and the
    performance dashboard (app.py:157-214)."""
    return """<!doctype html>
<html><head><meta charset="utf-8"><title>Tooth Restoration Selection (H100)</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem auto;max-width:60rem;color:#222}
 h1{font-size:1.4rem} .row{display:flex;gap:2rem;flex-wrap:wrap}
 .col{flex:1;min-width:18rem} label{display:block;margin:.5rem 0 .15rem;font-size:.85rem}
 select,input[type=file]{width:100%;padding:.3rem} button{margin-top:1rem;padding:.5rem 1.4rem;font-size:1rem;cursor:pointer}
 table{border-collapse:collapse;margin-top:.75rem} td,th{border:1px solid #bbb;padding:.25rem .7rem;font-size:.9rem}
 #label{font-size:1.15rem;font-weight:600;margin-top:1rem} #dash{color:#555;font-size:.85rem}
 img#proc{max-width:16rem;border:1px solid #ccc;margin-top:.5rem}
 .err{color:#b00}
</style></head><body>
<h1>Direct vs. Indirect restoration — TPU serving UI</h1>
<div id="dash">loading dashboard…</div>
<div class="row">
 <div class="col">
  <label>Tooth photograph</label><input type="file" id="image" accept="image/*">
  <img id="proc" hidden>
 </div>
 <div class="col" id="fields"></div>
</div>
<button id="go">Preprocess &amp; Predict</button>
<div id="label"></div>
<table id="streams" hidden><thead><tr><th>stream</th><th>probability</th></tr></thead><tbody></tbody></table>
<script>
let schema;
async function init(){
  schema = await (await fetch("/")).json();
  const m = schema.metrics && (schema.metrics.test || schema.metrics);
  if (m && m.auc !== undefined)
    document.getElementById("dash").textContent =
      `Test AUC ${m.auc} · Acc ${m.acc} · F1 ${m.f1 ?? ""}`;
  const holder = document.getElementById("fields");
  for (const [field, choices] of Object.entries(schema.fields)){
    const l = document.createElement("label"); l.textContent = field;
    const s = document.createElement("select"); s.id = "f_" + field;
    s.append(new Option("(not provided)", ""));
    for (const c of choices) s.append(new Option(c, c));
    holder.append(l, s);
  }
  const l = document.createElement("label"); l.textContent = "threshold mode";
  const s = document.createElement("select"); s.id = "thr_mode";
  for (const c of schema.threshold_modes) s.append(new Option(c, c));
  s.value = "max_f1";
  holder.append(l, s);
}
function fileToB64(f){return new Promise((res, rej) => {
  const r = new FileReader();
  r.onload = () => res(r.result.split(",")[1]); r.onerror = rej;
  r.readAsDataURL(f);});}
async function predict(){
  const out = document.getElementById("label");
  const f = document.getElementById("image").files[0];
  if (!f){ out.textContent = "choose an image first"; out.className = "err"; return; }
  out.className = ""; out.textContent = "running…";
  const fields = {};
  for (const k of Object.keys(schema.fields)){
    const v = document.getElementById("f_" + k).value;
    if (v) fields[k] = v;
  }
  const body = {image_b64: await fileToB64(f), fields,
                thr_mode: document.getElementById("thr_mode").value,
                include_processed: true};
  const r = await fetch("/predict", {method: "POST", body: JSON.stringify(body)});
  const j = await r.json();
  if (j.error){ out.textContent = j.error; out.className = "err"; return; }
  out.textContent = `${j.label} (p=${(+j.p_indirect).toFixed(3)}, thr=${(+j.threshold).toFixed(3)})`;
  const tb = document.querySelector("#streams tbody"); tb.innerHTML = "";
  for (const [k, v] of Object.entries(j.streams || {})){
    const tr = document.createElement("tr");
    tr.innerHTML = `<td>${k}</td><td>${(+v).toFixed(4)}</td>`;
    tb.append(tr);
  }
  document.getElementById("streams").hidden = false;
  if (j.processed_image_b64){
    const im = document.getElementById("proc");
    im.src = "data:image/png;base64," + j.processed_image_b64; im.hidden = false;
  }
}
document.getElementById("go").addEventListener("click", predict);
init();
</script></body></html>"""


def build_gradio_app(service: PredictService):  # pragma: no cover - needs gradio
    import gradio as gr

    metrics = load_overall_metrics()

    def predict(image, thr_mode, *field_values):
        fields = {k: (v or None) for k, v in zip(FIELD_ORDER, field_values)}
        out = service.predict_one(np.asarray(image), fields, thr_mode=thr_mode)
        if "error" in out:
            return out["error"], None, None
        table = [[k, f"{v:.4f}"] for k, v in out["streams"].items()]
        proc = out.pop("processed_image")
        return (
            f"{out['label']} (p={out['p_indirect']:.3f}, thr={out['threshold']:.3f})",
            table,
            proc.astype(np.uint8),
        )

    with gr.Blocks(title="Tooth Restoration Selection (H100)") as demo:
        gr.Markdown(
            f"## Direct vs. Indirect restoration\n"
            f"Test AUC {metrics['test']['auc']} · Acc {metrics['test']['acc']}"
        )
        with gr.Row():
            img = gr.Image(label="Tooth photograph")
            with gr.Column():
                dds = [
                    gr.Dropdown(choices=[""] + list(CHOICES_MAP[k]), label=k, value="")
                    for k in FIELD_ORDER
                ]
                mode = gr.Dropdown(choices=THRESHOLD_MODES, value="max_f1",
                                   label="threshold mode")
        btn = gr.Button("Preprocess & Predict")
        out_label = gr.Textbox(label="Prediction")
        out_table = gr.Dataframe(headers=["stream", "probability"])
        out_img = gr.Image(label="Processed image")
        btn.click(predict, [img, mode] + dds, [out_label, out_table, out_img])
    return demo


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--weights", default="weights")
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    args = p.parse_args(argv)

    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights

    service = build_service_from_weights(args.weights, device=args.device)
    try:  # pragma: no cover
        app = build_gradio_app(service)
        app.launch(server_name=args.host, server_port=args.port)
    except ImportError:
        serve_http(service, args.host, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
