"""HTTP pose-serving daemon over an exported pipeline artifact (the port's
counterpart of tools/serve.py).

The artifact (pvnet_tpu_torch/export.py) runs at a fixed batch; this
dependency-free front (stdlib http.server) micro-batches concurrent
requests into that batch and runs one device call per window: requests
arriving within ``--max_wait_ms`` of the first share one call, and a lone
request pays for the full batch anyway.

  python -m pvnet_tpu_torch.serve --export_dir DIR [--port 8400]
      [--max_wait_ms 10] [--device cuda]

API:
  GET  /healthz          -> {"status": "ok", "batch", "height", "width",
                             "vn", "weights"}
  POST /pose             -> {"pose": [3,4], "keypoints": [vn,2]}
      body: a .npy array [h, w, 3] (uint8, or float32), or image file
      bytes (PNG/JPEG), decoded by data/image_io (the port's own decoder,
      on the artifact's device). A body of another size than the
      artifact's is resized as PIL's BILINEAR resize does it
      (data/resample, without PIL). Raw
      images are ImageNet-normalized here for a float32 artifact (pass
      "X-Normalized: 1" if the payload already is) and sent as uint8 to a
      packed-stem artifact, which normalizes on the device.
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time

import numpy as np

from pvnet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu_torch.data.image_io import decode_rgb_bytes
from pvnet_tpu_torch.data.resample import resize_bilinear


class PoseBatcher:
    """Micro-batching front of an artifact's ``call(images, seed)``.

    ``calls`` counts the device calls, so a caller can see that concurrent
    requests shared one."""

    def __init__(self, fn, batch: int, height: int, width: int,
                 max_wait_ms: float = 10.0, request_timeout: float = 600.0,
                 input_dtype=np.float32):
        self.fn = fn
        self.batch, self.h, self.w = batch, height, width
        self.input_dtype = input_dtype
        self.max_wait = max_wait_ms / 1e3
        self.request_timeout = request_timeout
        self.q: "queue.Queue" = queue.Queue()
        self.seed = 0
        self.calls = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def warmup(self) -> float:
        """One batched call before accepting traffic (the first call loads
        the kernels and lets cuDNN pick its algorithms); its seconds."""
        t0 = time.monotonic()
        self.fn.call(np.zeros((self.batch, self.h, self.w, 3),
                              self.input_dtype), 0)
        return time.monotonic() - t0

    def infer(self, image: np.ndarray, timeout: float = None):
        """image: [h, w, 3] in the artifact's input dtype. Returns (pose
        [3, 4], keypoints [vn, 2]) as numpy arrays."""
        done = threading.Event()
        slot = {}
        self.q.put((image, slot, done))
        if not done.wait(self.request_timeout if timeout is None else timeout):
            raise TimeoutError("inference timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["pose"], slot["kps"]

    def close(self):
        self._stop.set()
        self.q.put(None)
        self.thread.join(timeout=5)

    def _collect(self, first) -> list:
        """``first`` and whatever else arrives within the window, up to
        the batch."""
        pending = [first]
        deadline = time.monotonic() + self.max_wait
        while len(pending) < self.batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self.q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is not None:
                pending.append(nxt)
        return pending

    def _loop(self):
        while not self._stop.is_set():
            item = self.q.get()
            if item is None:
                continue
            pending = self._collect(item)
            imgs = np.zeros((self.batch, self.h, self.w, 3), self.input_dtype)
            for i, (im, _, _) in enumerate(pending):
                imgs[i] = im
            try:
                self.seed += 1
                self.calls += 1
                pose, kps = self.fn.call(imgs, self.seed)
                pose, kps = pose.cpu().numpy(), kps.cpu().numpy()
                for i, (_, slot, done) in enumerate(pending):
                    slot["pose"], slot["kps"] = pose[i], kps[i]
                    done.set()
            except Exception as e:                    # surface to callers
                for _, slot, done in pending:
                    slot["error"] = repr(e)
                    done.set()


def _resize(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's bilinear resize (data/resample): uint8 pixels as an RGB
    image, float channels each as a mode "F" image, so that normalized
    values keep their sign and fraction."""
    if not np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.uint8)
    return resize_bilinear(arr, h, w)


def decode_image(body: bytes, content_type: str, h: int, w: int,
                 normalized: bool, raw_uint8: bool = False,
                 device="cpu") -> np.ndarray:
    """Request body -> [h, w, 3] float32 ImageNet-normalized, or raw uint8
    for packed-stem artifacts (normalization runs on the device). A .npy
    body is loaded, a JPEG or PNG body decoded by data/image_io on
    ``device``; another size is resized (:func:`_resize`)."""
    if content_type == "application/x-npy" or body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        arr = decode_rgb_bytes(body, content_type or "body",
                               device).cpu().numpy()
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected an [h, w, 3] image, got {arr.shape}")
    if arr.shape[:2] != (h, w):
        arr = _resize(arr, h, w)
    if raw_uint8:
        if np.issubdtype(arr.dtype, np.floating):
            arr = np.clip(arr * (255.0 if arr.max() <= 2.0 else 1.0),
                          0, 255)
        return arr.astype(np.uint8)
    arr = arr.astype(np.float32)
    if normalized:
        return arr
    if arr.max() > 2.0:                                # uint8 range
        arr = arr / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def make_handler(batcher: PoseBatcher, manifest: dict,
                 decode_device="cpu"):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "batch": batcher.batch,
                                 "height": batcher.h, "width": batcher.w,
                                 "vn": manifest.get("vn"),
                                 "weights": manifest.get("weights")})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/pose":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                img = decode_image(
                    self.rfile.read(n), self.headers.get("Content-Type", ""),
                    batcher.h, batcher.w,
                    self.headers.get("X-Normalized") == "1",
                    raw_uint8=batcher.input_dtype == np.uint8,
                    device=decode_device)
            except Exception as e:                    # a bad payload
                self._send(400, {"error": repr(e)})
                return
            try:
                pose, kps = batcher.infer(img)
            except Exception as e:                    # the call failed
                self._send(500, {"error": repr(e)})
                return
            self._send(200, {"pose": pose.tolist(),
                             "keypoints": kps.tolist()})

        def log_message(self, fmt, *a):                # quiet by default
            pass

    return Handler


def serve(export_dir: str, host: str = "0.0.0.0", port: int = 8400,
          max_wait_ms: float = 10.0, started: "threading.Event" = None,
          device=None, artifact=None):
    """Load the artifact (or take the already loaded ``artifact`` of
    ``export_dir``), warm it up and serve until shut down. With
    ``started``, the event gets the server (``started.server``) and the
    batcher (``started.batcher``) and is set once requests are taken."""
    from http.server import ThreadingHTTPServer
    from pvnet_tpu_torch.export import load_artifact
    art = artifact
    if art is None:
        t0 = time.monotonic()
        art = load_artifact(export_dir, device)
        print(f"loaded {export_dir} in {time.monotonic() - t0:.1f} s",
              flush=True)
    m = art.manifest
    batcher = PoseBatcher(
        art, m["batch"], m["height"], m["width"], max_wait_ms,
        input_dtype=np.uint8 if m["input_dtype"] == "uint8" else np.float32)
    try:
        print(f"warmup call: {batcher.warmup():.1f} s", flush=True)
        httpd = ThreadingHTTPServer((host, port),
                                    make_handler(batcher, m, art.device))
        if started is not None:
            started.server, started.batcher = httpd, batcher
            started.set()
        print(f"serving {export_dir} (batch {m['batch']}, {m['height']}x"
              f"{m['width']}, {m['device']}) on {host}:{port}", flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    finally:
        batcher.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export_dir", default="export_out")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--max_wait_ms", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="the artifact's device type (an artifact runs "
                         "where it was exported)")
    args = ap.parse_args(argv)
    serve(args.export_dir, args.host, args.port, args.max_wait_ms,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
