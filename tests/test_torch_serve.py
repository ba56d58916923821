"""The serving daemon of the port (pvnet_tpu_torch/serve.py), mirroring
tests/test_serve.py: micro-batched HTTP inference over an exported artifact
(random init, plain path, batch 4 at 64x64 on the CPU); concurrent
requests share one device call; .npy bodies always decode, image files
only where PIL imports."""
import io
import json
import socket
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from pvnet_tpu_torch import export as TE
from pvnet_tpu_torch import serve as TS

# a window wide enough that requests started together share it on a busy
# machine
WINDOW_MS = 300.0


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    pts = np.random.RandomState(0).uniform(-0.05, 0.05, (9, 3))
    np.savetxt(d / "points.txt", pts)
    out = str(d / "artifact")
    assert TE.main(["--out_dir", out, "--points_3d", str(d / "points.txt"),
                    "--device", "cpu", "--batch", "4", "--height", "64",
                    "--width", "64", "--no-fused_tail", "--no-bf16"]) == 0
    return out


@pytest.fixture(scope="module")
def server(export_dir):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    started = threading.Event()
    t = threading.Thread(
        target=TS.serve, args=(export_dir, "127.0.0.1", port, WINDOW_MS,
                               started), kwargs={"device": "cpu"},
        daemon=True)
    t.start()
    assert started.wait(300)
    yield f"http://127.0.0.1:{port}", started.batcher
    started.server.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(url, body, headers):
    req = urllib.request.Request(url + "/pose", data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _post_npy(url, arr, normalized=True):
    buf = io.BytesIO()
    np.save(buf, arr)
    return _post(url, buf.getvalue(),
                 {"Content-Type": "application/x-npy",
                  **({"X-Normalized": "1"} if normalized else {})})


def test_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["batch"] == 4
    assert (h["height"], h["width"], h["vn"]) == (64, 64, 9)
    assert h["weights"] == "random-init"


def test_single_request(server):
    url, _ = server
    rng = np.random.RandomState(1)
    out = _post_npy(url, rng.randn(64, 64, 3).astype(np.float32))
    pose = np.asarray(out["pose"])
    kps = np.asarray(out["keypoints"])
    assert pose.shape == (3, 4) and kps.shape == (9, 2)
    assert np.isfinite(pose).all()


def test_concurrent_requests_batched(server):
    url, batcher = server
    rng = np.random.RandomState(2)
    images = [rng.randn(64, 64, 3).astype(np.float32) for _ in range(3)]
    results = [None] * 3
    errs = []
    go = threading.Barrier(3)

    def worker(i):
        try:
            go.wait(timeout=30)
            results[i] = _post_npy(url, images[i])
        except Exception as e:                          # pragma: no cover
            errs.append(e)

    calls = batcher.calls
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errs and not any(t.is_alive() for t in threads)
    for out in results:
        assert np.asarray(out["pose"]).shape == (3, 4)
    # the three requests shared the window: fewer device calls than
    # requests
    assert batcher.calls - calls < 3


def test_uint8_image_is_normalized(server):
    # raw uint8 payload goes through ImageNet normalization server-side
    url, _ = server
    rng = np.random.RandomState(3)
    out = _post_npy(url, rng.randint(0, 255, (64, 64, 3), np.uint8),
                    normalized=False)
    assert np.isfinite(np.asarray(out["pose"])).all()


@pytest.mark.parametrize("body,ctype", [
    (b"not an image", "image/png"), (b"not an array", "application/x-npy")])
def test_bad_payload_is_4xx(server, body, ctype):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, body, {"Content-Type": ctype})
    assert 400 <= ei.value.code < 500


def test_image_body_without_pil_names_the_decoder(server, monkeypatch):
    url, _ = server
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, b"\x89PNG\r\n\x1a\n", {"Content-Type": "image/png"})
    assert ei.value.code == 415
    assert "PIL" in json.loads(ei.value.read())["error"]
    with pytest.raises(TS.DecoderMissing, match="PIL"):
        TS.decode_image(b"\xff\xd8\xff", "image/jpeg", 64, 64, False)


def test_decode_raw_uint8():
    rng = np.random.RandomState(2)
    arr = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    buf = io.BytesIO()
    np.save(buf, arr)
    out = TS.decode_image(buf.getvalue(), "application/x-npy", 48, 64,
                          normalized=False, raw_uint8=True)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, arr)
    # normalized for a float32 artifact
    norm = TS.decode_image(buf.getvalue(), "application/x-npy", 48, 64,
                           normalized=False)
    np.testing.assert_allclose(
        norm, (arr / 255.0 - TS.IMAGENET_MEAN) / TS.IMAGENET_STD,
        rtol=1e-6, atol=1e-6)


class _Recorder:
    """A stand-in for an artifact: records each call's batch, or fails."""

    def __init__(self, fail=False):
        self.batches, self.fail = [], fail
        self.lock = threading.Lock()

    def call(self, images, seed):
        import torch
        with self.lock:
            self.batches.append(images.copy())
        if self.fail:
            raise RuntimeError("device lost")
        b = images.shape[0]
        pose = torch.arange(b, dtype=torch.float32)[:, None, None].expand(
            b, 3, 4)
        return pose, torch.zeros(b, 9, 2)


def test_batcher_fills_the_batch_and_answers_each_caller():
    fn = _Recorder()
    batcher = TS.PoseBatcher(fn, 4, 2, 2, max_wait_ms=WINDOW_MS)
    try:
        out = [None] * 4
        go = threading.Barrier(4)

        def worker(i):
            go.wait(timeout=30)
            out[i] = batcher.infer(np.full((2, 2, 3), i, np.float32))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert batcher.calls == len(fn.batches) == 1
        # each caller gets its own row of the one call
        for i, (pose, _) in enumerate(out):
            row = int(fn.batches[0][:, 0, 0, 0].tolist().index(i))
            assert (pose == row).all()
    finally:
        batcher.close()
    assert not batcher.thread.is_alive()


def test_batcher_surfaces_errors_to_every_caller():
    batcher = TS.PoseBatcher(_Recorder(fail=True), 4, 2, 2,
                             max_wait_ms=WINDOW_MS)
    try:
        errors = []

        def worker():
            try:
                batcher.infer(np.zeros((2, 2, 3), np.float32), timeout=60)
            except RuntimeError as e:
                errors.append(str(e))

        threads = [threading.Thread(target=worker) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(errors) == 3 and all("device lost" in e for e in errors)
    finally:
        batcher.close()
