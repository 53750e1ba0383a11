"""The port's front ends on the CPU: ``llie-torch`` (cli.main) enhance,
eval, bench (``--chain python``), video and video --streams with
``--device cpu``; and the HTTP server
on an ephemeral loopback port, whose answers equal pipeline.enhance, with
its 400, 404, /healthz and /stats."""

import http.client
import json

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch import cli
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.http_server import (
    HttpEnhanceServer,
)
from low_light_image_enhancement_tpu_torch.io.codec import (
    decode_image,
    encode_image,
)
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline
from low_light_image_enhancement_tpu_torch.video import (
    MultiStreamVideoEnhancer,
    VideoEnhancer,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)


def test_cli_enhance(tmp_path, capsys):
    low = synth_batch(1, 40, 64, seed=4)[0][0]
    src, dst = tmp_path / "dark.png", tmp_path / "bright.png"
    encode_image(low, src)
    assert cli.main(["enhance", str(src), str(dst), "--device", "cpu",
                     "--gamma", "0.5"]) == 0
    assert "wrote" in capsys.readouterr().out
    want = EnhancePipeline(PipelineConfig(gamma=0.5),
                           device="cpu").enhance(low)
    np.testing.assert_array_equal(decode_image(dst), want)


def test_cli_eval_json_report(tmp_path, capsys):
    """On an on-disk LOL layout of three small pairs (decoded from PNG)."""
    lows, highs = synth_batch(3, 32, 48, seed=8)
    for kind, imgs in (("low", lows), ("high", highs)):
        d = tmp_path / "eval15" / kind
        d.mkdir(parents=True)
        for i, img in enumerate(imgs):
            encode_image(img, d / f"{i}.png")
    assert cli.main(["eval", "--max-images", "2", "--device", "cpu",
                     "--data-dir", str(tmp_path)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["n_images"] == 2.0 and rep["synthetic_data"] == 0.0
    assert rep["parity_max_abs_u8"] == 0.0


@pytest.mark.parametrize("method", ["retinex", "hybrid"])
def test_cli_bench_python_chain_on_cpu(method, capsys):
    """llie-torch bench at a tiny size on the CPU: one JSON line, the
    bench's result."""
    assert cli.main(["bench", "--device", "cpu", "--chain", "python",
                     "--bench-method", method, "--height", "16", "--width",
                     "24", "--batch", "2", "--repeats", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["images_per_sec"] > 0 and res["method"] == method
    assert res["backend"] == "cpu" and res["chain"] == "python"
    assert res["batch"] == 2 and len(res["rates"]) == 2


def test_cli_video_frames(tmp_path, capsys):
    frames = synth_batch(3, 32, 48, seed=5)[0]
    (tmp_path / "in").mkdir()
    for t, f in enumerate(frames):
        encode_image(f, tmp_path / "in" / f"f{t:03d}.png")
    assert cli.main(["video", str(tmp_path / "in" / "*.png"),
                     str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert "wrote 3 frames" in capsys.readouterr().out
    ve = VideoEnhancer(PipelineConfig(), alpha=0.3, device="cpu")
    for t, f in enumerate(frames):
        np.testing.assert_array_equal(
            decode_image(tmp_path / "out" / f"f{t:03d}.png"), ve.process(f))
    assert cli.main(["video", str(tmp_path / "none*.png"),
                     str(tmp_path / "out")]) == 1


def test_cli_video_multi_stream(tmp_path, capsys):
    frames = synth_batch(4, 32, 48, seed=6)[0].reshape(2, 2, 32, 48, 3)
    for s in range(2):
        d = tmp_path / "in" / f"cam{s}"
        d.mkdir(parents=True)
        for t in range(2):
            encode_image(frames[s, t], d / f"f{t}.png")
    assert cli.main(["video", str(tmp_path / "in" / "cam*"),
                     str(tmp_path / "out"), "--streams", "--device",
                     "cpu"]) == 0
    assert "2 frames x 2 streams" in capsys.readouterr().out
    mv = MultiStreamVideoEnhancer(2, PipelineConfig(), device="cpu")
    for t in range(2):
        want = mv.process(frames[:, t])
        for s in range(2):
            np.testing.assert_array_equal(
                decode_image(tmp_path / "out" / f"cam{s}" / f"f{t}.png"),
                want[s])


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        headers = {} if body is None else {"Content-Length": str(len(body))}
        conn.request(method, path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("Content-Type")
    finally:
        conn.close()


def test_http_roundtrip_and_errors():
    lows = synth_batch(2, 40, 64, seed=7)[0]
    srv = HttpEnhanceServer(host="127.0.0.1", port=0, max_delay_ms=1.0,
                            device="cpu").start()
    try:
        assert _request(srv.port, "GET", "/healthz")[:2] == (200, b"ok")
        ref = EnhancePipeline(device="cpu", bucket=64)
        for low in lows:
            status, body, ctype = _request(
                srv.port, "POST", "/enhance", encode_image(low, format="PNG"))
            assert status == 200 and ctype == "image/png"
            np.testing.assert_array_equal(decode_image(body),
                                          ref.enhance(low))
        status, body, ctype = _request(srv.port, "POST", "/enhance",
                                       encode_image(lows[0], format="JPEG"))
        assert status == 200 and ctype == "image/jpeg"
        assert decode_image(body).shape == lows[0].shape
        assert _request(srv.port, "POST", "/enhance", b"not an image")[0] \
            == 400
        assert _request(srv.port, "POST", "/enhance",
                        b"\x89PNG broken")[0] == 400
        assert _request(srv.port, "POST", "/nope", b"x")[0] == 404
        stats = json.loads(_request(srv.port, "GET", "/stats")[1])
        assert stats["requests_by_status"]["200"] >= 4
        assert stats["requests_by_status"]["400"] == 2
        assert stats["enhance_latency_ms"]["window"] == 3
    finally:
        srv.close()
