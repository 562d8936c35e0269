"""Port parity of the result visualization (airpose_tpu_torch.serve.viz vs
airpose_tpu.serve.viz, on the CPU): the same wire messages and the same
synthetic SMPL-X give PNGs whose RGB is within one uint8 step of JAX's
(JAX's matplotlib writes RGBA, the port's OpenCV writer RGB), and the
body lands where the message's translation puts it."""

import cv2
import numpy as np
import pytest

from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic
from airpose_tpu.serve.viz import render_wire_messages as jrender
from airpose_tpu_torch import constants as C
from airpose_tpu_torch.bodymodel import synthetic_smplx_params
from airpose_tpu_torch.serve.protocol import pack_params
from airpose_tpu_torch.serve.viz import main, render_wire_messages

V = 222
SIZE = (480, 270)
FOCAL = (1475.0, 1475.0)


def wire_messages(n=3, seed=0):
    """(n, 145) messages: small β, bodies 6-9 m in front of the camera,
    6D poses near the identity."""
    rng = np.random.default_rng(seed)
    eye6 = np.tile(np.asarray([1.0, 0, 0, 1, 0, 0], np.float32), 22)
    return np.stack([pack_params((rng.normal(size=10) * 0.5).astype(np.float32),
                                 np.asarray([0.4 * i - 0.4, 0.2, 6.0 + i], np.float32),
                                 eye6 + (rng.normal(size=132) * 0.1).astype(np.float32))
                     for i in range(n)]).astype(np.float32)


def rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return img[..., 2::-1] if img.shape[-1] == 4 else img[..., ::-1]


def body_mask(img):
    return np.abs(img.astype(np.int16) - int(0.15 * 255)).max(axis=-1) > 1


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    out = tmp_path_factory.mktemp("viz")
    wire = wire_messages()
    got = render_wire_messages(wire, synthetic_smplx_params(num_vertices=V), str(out / "port"),
                               FOCAL, image_size=SIZE, device="cpu")
    want = jrender(wire, jsynthetic(num_vertices=V), str(out / "jax"), FOCAL, image_size=SIZE)
    return wire, got, want


def test_render_matches_jax(rendered):
    _, got, want = rendered
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        a, b = rgb(g), rgb(w)
        assert a.shape == b.shape == (SIZE[1], SIZE[0], 3)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1, (g, diff.max(), (diff > 1).sum())
        assert body_mask(a).sum() > 100


def test_body_lands_at_the_message_translation(rendered):
    """The body's silhouette centres near the projection of the message's
    (unscaled) translation, and moves with it."""
    wire, got, _ = rendered
    fx, fy = (FOCAL[k] * SIZE[k] / C.IMG_SIZE[k] for k in (0, 1))
    centroids = []
    for i, path in enumerate(got):
        ys, xs = np.nonzero(body_mask(rgb(path)))
        tx, ty, tz = wire[i, 10:13] / C.TRANS_SCALE
        u, v = fx * tx / tz + SIZE[0] / 2, fy * ty / tz + SIZE[1] / 2
        centroids.append((xs.mean(), ys.mean()))
        # the synthetic body spans ~1 m about the origin: ~25 px at 6 m here
        assert abs(xs.mean() - u) < 15 and abs(ys.mean() - v) < 15, (i, xs.mean(), u,
                                                                      ys.mean(), v)
    assert centroids[0][0] < centroids[1][0] < centroids[2][0]


def test_viz_cli_writes_pngs(tmp_path, capsys):
    wire = tmp_path / "wire.npy"
    np.save(wire, wire_messages(2))
    main(["--wire", str(wire), "--out", str(tmp_path / "out"), "--synthetic_verts", str(V),
          "--platform", "cpu"])
    assert "wrote 2 overlays" in capsys.readouterr().out
    pngs = sorted((tmp_path / "out").glob("frame_*.png"))
    assert [p.name for p in pngs] == ["frame_000000.png", "frame_000001.png"]
    for p in pngs:
        img = rgb(p)
        assert img.shape == (540, 960, 3) and img.std() > 0
