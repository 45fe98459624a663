"""Serve a classification hub over HTTP: raw events in, logits out.

Counterpart of eventpretrain_tpu/cli/serve.py:41-152. The JAX server loads
an exported artifact of the logits function
(utils/export_infer.py::export_cls_inference); here the live hub is served
with the device preprocessing put first (``make_cls_infer``): padded raw
events -> voxel grid -> eval view -> ViT -> logits.

Run::

    python -m eventpretrain_tpu_torch.cli.serve --weights cls.pth \\
        --num_classes 2 --canvas 128 128 --device cuda

``--weights`` is a ``save_torch_checkpoint`` file
(eventpretrain_tpu/ckpt/torch_export.py). On ``cuda`` the hub runs in
bf16, which routes every ViT block through the K1/K2 kernels; on ``cpu``
it runs in f32.

Protocol (numpy bodies, dtype and shape self-describing):

- ``GET /healthz``  -> 200 ``{"ok": true, "artifact": ..., "kind": ...}``
- ``POST /predict`` body = one ``.npz`` holding, in this order, events f32
  ``(B, E, 4)`` xytp, counts i32 ``(B,)`` and sensor_hw i32 ``(B, 2)``
  -> 200 body = ``.npy`` of the f32 logits ``(B, num_classes)``
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.data.cls_pipeline import (
    _device_preprocess,
    eval_view_params,
)
from eventpretrain_tpu_torch.models.cls_hub import FtClsHub, cls_hub_vit_small


def make_cls_infer(hub: FtClsHub, *, num_bins: int = 5,
                   canvas: tuple[int, int] = (128, 128),
                   input_size: int = 224, mode: str = "bilinear"):
    """``infer(events, counts, sensor_hw) -> (B, num_classes) f32 numpy``.

    Inputs are numpy arrays or tensors (events f32 ``(B, E, 4)``, counts
    ``(B,)``, sensor_hw ``(B, 2)``); they are moved to the hub's device,
    rasterised on ``canvas``, viewed through each sample's sensor box,
    resized to ``input_size`` and classified.
    """
    hub.eval()
    device = hub.classify_head.weight.device
    height, width = canvas

    @torch.inference_mode()
    def infer(events, counts, sensor_hw) -> np.ndarray:
        events = torch.as_tensor(events, device=device)
        counts = torch.as_tensor(counts, device=device).to(torch.int32)
        sensor_hw = torch.as_tensor(sensor_hw, device=device).to(torch.int32)
        evg = _device_preprocess(
            events, counts, sensor_hw, eval_view_params(sensor_hw),
            num_bins=num_bins, height=height, width=width,
            out_size=input_size, mode=mode,
        )
        _, logits, _ = hub(evg)
        return logits.float().cpu().numpy()

    return infer


def _decode_body(body: bytes) -> tuple:
    """One .npy array -> 1 arg; .npz -> args in file order."""
    if body[:4] == b"PK\x03\x04":  # zip = .npz
        z = np.load(io.BytesIO(body))
        return tuple(z[k] for k in z.files)
    return (np.load(io.BytesIO(body)),)


def _encode_result(out) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(out, np.float32))
    return buf.getvalue()


def make_handler(infer, artifact: str, kind: str):
    lock = threading.Lock()  # one device queue; serialize dispatch

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; errors still raise
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                payload = json.dumps(
                    {"ok": True, "artifact": artifact, "kind": kind}
                ).encode()
                self._send(200, payload, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                args = _decode_body(self.rfile.read(n))
                with lock:
                    out = infer(*args)
                body = _encode_result(out)
            except Exception as e:  # surface the error to the client
                msg = json.dumps(
                    {"ok": False, "error": f"{type(e).__name__}: {e}"}
                ).encode()
                self._send(400, msg, "application/json")
                return
            self._send(200, body, "application/octet-stream")

    return Handler


def make_server(infer, name: str, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; port 0 = ephemeral."""
    return ThreadingHTTPServer((host, port),
                               make_handler(infer, name, "cls_hub"))


def build_hub(weights: str, num_classes: int, num_bins: int = 5,
              device: str = "cuda", **bk) -> FtClsHub:
    """A ViT-S cls hub (``bk`` overrides backbone widths) with ``weights``
    loaded strictly; bf16 on CUDA, f32 elsewhere."""
    dtype = torch.bfloat16 if device.startswith("cuda") else torch.float32
    hub = cls_hub_vit_small(num_classes, num_bins, dtype=dtype, device=device,
                            **bk)
    return load_jax_state_dict(hub, load_torch_checkpoint(weights))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", required=True,
                   help="save_torch_checkpoint .pth of a ViT-S cls hub")
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--num_bins", type=int, default=5)
    p.add_argument("--canvas", type=int, nargs=2, default=(128, 128),
                   metavar=("H", "W"), help="raster canvas (max sensor size)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)

    hub = build_hub(args.weights, args.num_classes, args.num_bins, args.device)
    infer = make_cls_infer(hub, num_bins=args.num_bins,
                           canvas=tuple(args.canvas))
    srv = make_server(infer, args.weights, args.host, args.port)
    print(f"serving {args.weights} on http://{args.host}:{srv.server_port} "
          f"(POST /predict, GET /healthz)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
