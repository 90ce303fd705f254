"""PyTorch port: the viewer server (``apps/viewer.py``) over live HTTP on
loopback, mirroring ``tests/test_viewer.py`` with ``device="cpu"``, and its
served frame against the JAX ``ViewerServer.render_jpeg`` at one pose.

The frames of the two packages differ only where the renders differ (within
BLEND_TOL, 5e-4) and the truncating uint8 cast lands on either side of a
level: before JPEG the two uint8 frames differ by at most 1 level, and
after both are encoded at quality 90 and decoded, by at most JPEG_TOL
levels, with a PSNR between them of at least 45 dB.
"""

import io
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from luisacomputegaussiansplatting_tpu_torch.apps.viewer import (
    ViewerServer,
    _parse_hex_color,
    _parse_vec,
    main,
    make_handler,
)
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import create_cube_scene
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianScene

torch.set_num_threads(2)

POSE = dict(pos=(3.0, -2.5, 2.0), front=(-0.66, 0.55, -0.44), up=(0, 0, 1),
            fov=70.0, bg=(0.0, 0.0, 0.0))
JPEG_TOL = 8


def cube_server(**kw):
    return ViewerServer(
        create_cube_scene(nx=4, device="cpu"), width=96, height=64,
        cfg=RenderConfig(max_pairs=50_000), name="cube",
        init_pos=(3.0, -2.5, 2.0), init_target=(0.0, 0.0, 0.0),
        world_up=(0.0, 0.0, 1.0), fov=70.0, device="cpu", **kw)


@pytest.fixture(scope="module")
def viewer():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(cube_server()))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def test_page_served(viewer):
    with urllib.request.urlopen(viewer + "/") as r:
        body = r.read().decode()
    assert r.status == 200
    assert "lcgs-tpu viewer" in body and "(cube)" in body
    assert "/frame?" in body  # the JS render loop


def test_frame_renders(viewer):
    url = (viewer + "/frame?pos=3,-2.5,2&front=-0.66,0.55,-0.44&up=0,0,1"
           + "&fov=70&bg=%23000000")
    with urllib.request.urlopen(url) as r:
        data = r.read()
    assert r.headers["Content-Type"] == "image/jpeg"
    img = decode(data)
    assert img.shape == (64, 96, 3)
    assert img.mean() > 1.0  # the cube is visible, not a black frame


def test_bg_color_applied(viewer):
    url = (viewer + "/frame?pos=50,50,50&front=0.577,0.577,0.577&up=0,0,1"
           + "&fov=70&bg=%23ff0000")
    with urllib.request.urlopen(url) as r:
        img = decode(r.read())
    assert img[..., 0].mean() > 200  # red
    assert img[..., 1].mean() < 30  # no green


def test_frame_is_upright():
    """A gaussian above the look-at target lands in the top rows of the
    served JPEG (the renderer's rows are bottom-up; the server flips)."""
    sh = torch.zeros((1, 16, 3))
    sh[:, 0, :] = 2.0
    scene = GaussianScene(
        means=torch.tensor([[0.0, 0.0, 1.0]]), scales=torch.full((1, 3), 0.25),
        quats=torch.tensor([[0.0, 0.0, 0.0, 1.0]]), opacities=torch.ones(1),
        sh=sh)
    srv = ViewerServer(
        scene, width=64, height=64, cfg=RenderConfig(max_pairs=10_000),
        name="dot", init_pos=(4.0, 0.0, 0.0), init_target=(0.0, 0.0, 0.0),
        world_up=(0.0, 0.0, 1.0), fov=60.0, device="cpu")
    img = decode(srv.render_jpeg((4.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
                                 (0.0, 0.0, 1.0), 60.0,
                                 (0.0, 0.0, 0.0))).astype(np.float32)
    rows = img.sum(axis=(1, 2))
    com = float((rows * np.arange(64)).sum() / max(rows.sum(), 1e-9))
    assert com < 32, "viewer frame is upside-down"


def test_bad_query_is_400_not_crash(viewer):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(viewer + "/frame?pos=1,2")
    assert ei.value.code == 400
    with urllib.request.urlopen(viewer + "/") as r:  # still serving
        assert r.status == 200
    with pytest.raises(ValueError):
        _parse_vec("1,2,3,4")
    assert _parse_hex_color("#ff8000") == [1.0, 128 / 255.0, 0.0]
    # the entry point defaults to the card and refuses to start without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(["--synthetic", "10"])


def test_frame_matches_jax_viewer():
    from luisacomputegaussiansplatting_tpu.apps import viewer as jviewer
    from luisacomputegaussiansplatting_tpu.config import RenderConfig as JCfg
    from luisacomputegaussiansplatting_tpu.io.synthetic import create_cube_scene as jcube

    jsrv = jviewer.ViewerServer(
        jcube(nx=4), width=96, height=64, cfg=JCfg(max_pairs=50_000),
        name="cube", init_pos=(3.0, -2.5, 2.0), init_target=(0.0, 0.0, 0.0),
        world_up=(0.0, 0.0, 1.0), fov=70.0)
    psrv = cube_server()
    assert psrv.page() == jsrv.page()
    pose = list(POSE.values())
    jhwc = decode(jsrv.render_jpeg(*pose))
    phwc = decode(psrv.render_jpeg(*pose))
    # the uint8 frames before JPEG: at most 1 level apart
    frame = psrv.frame_to_hwc(psrv.render_frame(*pose)).astype(np.int32)
    img = np.asarray(jsrv._render(*jsrv.scene_args, jsrv._build_view(*pose[:4]),
                                  np.zeros(3, np.float32)))
    jframe = (np.transpose(img, (1, 2, 0))[::-1] * 255.0).astype(np.uint8)
    assert np.abs(frame - jframe).max() <= 1
    d = np.abs(phwc.astype(np.int32) - jhwc.astype(np.int32))
    mse = float(np.mean(d.astype(np.float64) ** 2))
    psnr = 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    assert d.max() <= JPEG_TOL and psnr >= 45.0, (d.max(), psnr)
