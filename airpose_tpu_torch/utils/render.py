"""Host-side mesh-overlay rendering for training summaries (copy of
airpose_tpu/utils/render.py, numpy only).

Replaces the reference's pyrender offscreen Renderer (ref
copenet/utils/renderer.py:9-86 — EGL/pyrender is not available here and
does not belong near jit boundaries anyway; SURVEY.md §7 risks). A compact
vectorized-numpy z-buffer rasterizer with flat Lambertian shading: slow-path
visualization only, never on the training hot path.
"""

from typing import Optional, Tuple

import numpy as np


def rasterize_mesh(
    vertices: np.ndarray,   # (V, 3) camera-frame
    faces: np.ndarray,      # (F, 3) int
    focal: Tuple[float, float],
    center: Tuple[float, float],
    image_size: Tuple[int, int],   # (W, H)
    max_faces: int = 40000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (depth (H, W), shade (H, W)) — inf depth where no surface."""
    W, H = image_size
    fx, fy = focal
    cx, cy = center

    v = np.asarray(vertices, np.float64)
    tri = v[np.asarray(faces[:max_faces], np.int64)]  # (F, 3, 3)

    # cull behind-camera triangles
    ok = (tri[:, :, 2] > 1e-3).all(axis=1)
    tri = tri[ok]
    if tri.shape[0] == 0:
        return np.full((H, W), np.inf), np.zeros((H, W))

    # project
    uv = tri[:, :, :2] / tri[:, :, 2:] * np.asarray([fx, fy]) + np.asarray([cx, cy])
    z = tri[:, :, 2]

    # flat shading from the face normal vs the view direction
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
    shade_f = np.abs(n[:, 2]) * 0.8 + 0.2

    depth = np.full((H, W), np.inf)
    shade = np.zeros((H, W))

    # rasterize per face over its bounding box (vectorized inner loop)
    mins = np.clip(np.floor(uv.min(axis=1)).astype(int), 0, [W - 1, H - 1])
    maxs = np.clip(np.ceil(uv.max(axis=1)).astype(int), 0, [W - 1, H - 1])
    areas = (maxs - mins).prod(axis=1)
    order = np.argsort(-z.mean(axis=1))  # far to near; z-buffer fixes overlap
    for f in order:
        x0, y0 = mins[f]
        x1, y1 = maxs[f]
        if areas[f] <= 0 or areas[f] > 200 * 200:
            continue
        xs = np.arange(x0, x1 + 1)
        ys = np.arange(y0, y1 + 1)
        gx, gy = np.meshgrid(xs, ys)
        p = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)

        a, b, c = uv[f]
        det = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(det) < 1e-9:
            continue
        w0 = ((b[1] - c[1]) * (p[:, 0] - c[0]) + (c[0] - b[0]) * (p[:, 1] - c[1])) / det
        w1 = ((c[1] - a[1]) * (p[:, 0] - c[0]) + (a[0] - c[0]) * (p[:, 1] - c[1])) / det
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        pz = w0 * z[f, 0] + w1 * z[f, 1] + w2 * z[f, 2]
        px = p[inside, 0].astype(int)
        py = p[inside, 1].astype(int)
        pz = pz[inside]
        closer = pz < depth[py, px]
        depth[py[closer], px[closer]] = pz[closer]
        shade[py[closer], px[closer]] = shade_f[f]
    return depth, shade


def overlay_mesh(
    image: np.ndarray,      # (H, W, 3) float [0,1]
    vertices: np.ndarray,
    faces: np.ndarray,
    focal: Tuple[float, float],
    center: Optional[Tuple[float, float]] = None,
    color=(0.3, 0.6, 1.0),
    alpha: float = 0.7,
) -> np.ndarray:
    """Blend a shaded mesh over an image (the reference's visualize_tb
    role, ref copenet/utils/renderer.py:43-62)."""
    H, W = image.shape[:2]
    if center is None:
        center = (W / 2.0, H / 2.0)
    depth, shade = rasterize_mesh(vertices, faces, focal, center, (W, H))
    mask = np.isfinite(depth)
    out = image.astype(np.float64).copy()
    tint = shade[mask][:, None] * np.asarray(color)
    out[mask] = (1 - alpha) * out[mask] + alpha * tint
    return out


def draw_keypoints(
    image: np.ndarray, kp: np.ndarray, color=(1.0, 0.2, 0.2), radius: int = 3
) -> np.ndarray:
    """Dot-overlay 2D keypoints (kp (N, 2) pixel coords)."""
    out = image.copy()
    H, W = image.shape[:2]
    for x, y in np.asarray(kp):
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            y0, y1 = max(0, yi - radius), min(H, yi + radius + 1)
            x0, x1 = max(0, xi - radius), min(W, xi + radius + 1)
            out[y0:y1, x0:x1] = color
    return out
