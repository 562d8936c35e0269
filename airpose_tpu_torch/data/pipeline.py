"""Device-side input pipeline (port of airpose_tpu/data/pipeline.py).

  host:    decode JPEG → fixed-size uint8 context windows (+ metadata)
  device:  per batch — random jitter-crop box, aspect-preserving
           resize-with-pad to 224, zero-pad masking, ImageNet normalization —
           overlapped with the train step by the Prefetcher's worker threads.

Semantics replicate resize_with_pad + the bb encoding
(ref utils/utils.py:214-235, dsets/aerialpeople.py:98-141):
  bb = (crop_center / principal_point − 1, scale),  scale = 224/max(w, h),
  pad is centered and constant-zero *before* normalization.

The resample is the JAX package's, ``jax.image.scale_and_translate(method=
"linear", antialias=False)``, computed the way JAX computes it: one weight
matrix per spatial axis and crop (``_weight_mat``), applied as two batched
matmuls. Random draws come from a ``torch.Generator`` and cannot match
``jax.random``; the deterministic (eval) path is exact.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from .. import resolve_device

_DECODE_POOL = None
_DECODE_POOL_LOCK = threading.Lock()
_F32_EPS = float(np.finfo(np.float32).eps)


def decode_pool(num_threads: int = 8) -> ThreadPoolExecutor:
    """Process-wide JPEG-decode thread pool shared by the dataset readers
    (cv2.imread releases the GIL). A persistent pool: spawning/joining one
    per batch measured ~50 ms of pure thread churn at batch 30.

    The pool GROWS to the largest ``num_threads`` ever requested (a new
    executor replaces the old one, which finishes its in-flight work and
    is garbage-collected); smaller requests reuse the existing pool — a
    shared pool cannot shrink for one caller without throttling the
    others."""
    global _DECODE_POOL
    with _DECODE_POOL_LOCK:
        if _DECODE_POOL is None or num_threads > _DECODE_POOL._max_workers:
            _DECODE_POOL = ThreadPoolExecutor(num_threads)
    return _DECODE_POOL


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) linear-resample weights of one axis per crop,
    as jax/_src/image/scale.py::compute_weight_mat builds them: output
    sample i sits at (i + 0.5 − t)/s − 0.5 in the input; triangle-kernel
    weights, each column renormalized by its sum where that sum exceeds
    1000·eps; a column whose sample lies outside [−0.5, in − 0.5] is zero."""
    dev = scale.device
    inv = (torch.ones_like(scale) / scale)[:, None]
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (out_idx + 0.5) * inv - translation[:, None] * inv - 0.5   # (B, out)
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - (sample[:, None, :] - in_idx[None, :, None]).abs(), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return w * inside[:, None, :]


def crop_resize_pad(
    images: torch.Tensor,  # (B, H, W, 3) uint8 or f32 context windows
    boxes: torch.Tensor,   # (B, 4) [x0, y0, w, h] float, context coords
    out_size: int = C.CROP_SIZE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop each box, aspect-preserving resize to out_size with centered
    zero padding, ImageNet-normalize. Returns (out (B,S,S,3) f32, scale (B,))."""
    imgs = images.float() / 255.0 if images.dtype == torch.uint8 else images
    B, H, W = imgs.shape[:3]
    x0, y0, w, h = boxes.unbind(dim=1)
    # a Python number over a tensor is computed as a product with the
    # reciprocal, one f32 rounding off JAX's quotient: divide two tensors
    longest = torch.maximum(w, h)
    scale = torch.full_like(longest, float(out_size)) / longest
    # centered pad offsets in output space
    ty = (out_size - scale * h) / 2.0
    tx = (out_size - scale * w) / 2.0

    wy = _weight_mat(H, out_size, scale, ty - scale * y0)   # (B, H, S)
    wx = _weight_mat(W, out_size, scale, tx - scale * x0)   # (B, W, S)
    rows = torch.bmm(wy.transpose(1, 2), imgs.reshape(B, H, W * 3))      # (B, S, W·3)
    rows = rows.reshape(B, out_size, W, 3).transpose(2, 3).reshape(B, out_size * 3, W)
    out = torch.bmm(rows, wx).reshape(B, out_size, 3, out_size).transpose(2, 3)

    # Zero out the padded border (the reference pads the materialized crop
    # with zeros; sampling the context would leak pixels past the box).
    yy = torch.arange(out_size, dtype=torch.float32, device=imgs.device)
    in_y = (yy[None, :] >= ty[:, None] - 0.5) & (yy[None, :] < (ty + scale * h)[:, None] - 0.5)
    in_x = (yy[None, :] >= tx[:, None] - 0.5) & (yy[None, :] < (tx + scale * w)[:, None] - 0.5)
    mask = in_y[:, :, None] & in_x[:, None, :]
    out = out * mask[..., None]

    mean = torch.tensor(C.IMG_NORM_MEAN, device=imgs.device)
    std = torch.tensor(C.IMG_NORM_STD, device=imgs.device)
    return (out - mean) / std, scale


def jitter_crop_boxes(
    generator: Optional[torch.Generator],
    person_box: torch.Tensor,      # (B, 4) [xmin, ymin, xmax, ymax] person bb, context coords
    context_extent: torch.Tensor,  # (B, 2) [W, H] of valid context region
    margin=200.0,                  # scalar or (B,) per-sample margin
    deterministic: bool = False,
) -> torch.Tensor:
    """Random jitter-crop like ref dsets/aerialpeople.py:98-127: window =
    person bb ± margin clamped to the frame, each side then pulled in by a
    uniform random offset (from ``generator``, on the boxes' device) within
    its slack. Returns (B, 4) [x0, y0, w, h]."""
    xmin_p, ymin_p, xmax_p, ymax_p = person_box.unbind(dim=1)
    Wc, Hc = context_extent.unbind(dim=1)
    margin = torch.as_tensor(margin, dtype=torch.float32,
                             device=person_box.device).expand(xmin_p.shape)
    xmin = torch.clamp(xmin_p - margin, min=0.0)
    ymin = torch.clamp(ymin_p - margin, min=0.0)
    xmax = torch.minimum(xmax_p + margin, Wc)
    ymax = torch.minimum(ymax_p + margin, Hc)

    if deterministic:
        off = torch.zeros((person_box.shape[0], 4), device=person_box.device)
    else:
        u = torch.rand((person_box.shape[0], 4), generator=generator,
                       device=person_box.device)
        off = u * torch.stack(
            [xmin_p - xmin, ymin_p - ymin, xmax - xmax_p, ymax - ymax_p], dim=1)
    x0 = xmin + off[:, 0]
    y0 = ymin + off[:, 1]
    x1 = xmax - off[:, 2]
    y1 = ymax - off[:, 3]
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=1)


def bb_encoding(
    boxes: torch.Tensor,      # (B, 4) [x0, y0, w, h]
    principal: torch.Tensor,  # (B, 2) (cx, cy)
    scale: torch.Tensor,      # (B,)
) -> torch.Tensor:
    """(B, 3) network conditioning: normalized crop center + scale
    (ref dsets/aerialpeople.py:134-135,200)."""
    center = boxes[:, :2] + boxes[:, 2:] / 2.0
    return torch.cat([center / principal - 1.0, scale[:, None]], dim=1)


def _to_device(x, dev: torch.device):
    """A numpy array, tensor or number → a tensor on ``dev`` (float64 becomes
    float32, as jnp.asarray makes it with x64 off); dicts, lists and tuples
    are converted leaf by leaf."""
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, dev) for v in x)
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(dev)


class Prefetcher:
    """Host→device prefetch: builds/uploads upcoming batches while the
    current step runs. Replaces DataLoader pin_memory+workers
    (ref copenet_twoview.py:427-443).

    Two modes:
      * ``Prefetcher(iterator)`` — one worker drains an iterator (ordered;
        right for deterministic eval streams);
      * ``Prefetcher.from_factory(make_batch, num_workers=N)`` — N workers
        each call ``make_batch(worker_id)`` repeatedly and push results
        (unordered; right for infinite random training streams, where the
        reference used 8-30 DataLoader worker processes). ``make_batch``
        must be thread-safe across distinct worker_ids.

    Batches are moved to ``device`` (CUDA by default; raises without it).
    Workers are threads that issue their device work (``finish_batch``,
    uploads) on the device's default stream, the stream the consumer's
    steps run on: the stream orders a batch's producing work before any
    step that reads it, so there is no side stream, no ``wait_stream`` and
    no ``record_stream``.
    """

    def __init__(self, iterator: Iterator = None, device=None,
                 depth: int = 2, host_keys=()):
        self._device = resolve_device(device)
        self._host_keys = tuple(host_keys)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error = None
        self._threads = []
        self._live_workers = 0
        self._lock = threading.Lock()
        self._stop = False
        if iterator is not None:
            self._start([lambda _wid: None], iterator=iterator)

    @classmethod
    def from_factory(cls, make_batch, num_workers: int = 2, device=None,
                     depth: int = 4, host_keys=()) -> "Prefetcher":
        """``host_keys`` names dict-batch entries kept as host numpy arrays
        (e.g. the ``mixed_source`` dispatch tag): uploading them would force
        the consumer into a blocking device→host read per batch just to
        branch on them."""
        self = cls(iterator=None, device=device,
                   depth=max(depth, num_workers), host_keys=host_keys)
        self._start([make_batch] * num_workers, iterator=None)
        return self

    class _Stopped(Exception):
        """Internal: a sibling worker failed (or close() ran); exit without
        overwriting the recorded error."""

    def _put(self, batch):
        host = {}
        if self._host_keys and isinstance(batch, dict):
            # Shallow-copy before popping host keys: the iterator-based
            # constructor may hand us caller-owned dicts that must not be
            # mutated (the from_factory path always builds fresh ones).
            batch = dict(batch)
            host = {k: batch.pop(k) for k in self._host_keys if k in batch}
        batch = _to_device(batch, self._device)
        if host:
            batch.update(host)
        # Bounded put that respects the stop flag: after one worker errors
        # (or close()), surviving workers must not block forever on a full
        # queue the consumer stopped draining — they would leak, together
        # with their queued batches, for the process lifetime.
        while True:
            if self._stop:
                raise Prefetcher._Stopped()
            try:
                self._q.put(batch, timeout=0.1)
                return
            except queue.Full:
                continue

    def _start(self, factories, iterator):
        self._live_workers = len(factories)

        def iter_worker():
            try:
                for batch in iterator:
                    self._put(batch)
            except Prefetcher._Stopped:
                pass
            except BaseException as e:  # surfaced in __next__, not swallowed
                self._error = e
            finally:
                self._finish_one()

        def factory_worker(wid, make_batch):
            try:
                while True:
                    self._put(make_batch(wid))
            except Prefetcher._Stopped:
                pass
            except BaseException as e:
                self._error = e
            finally:
                self._finish_one()

        for wid, f in enumerate(factories):
            target = (iter_worker if iterator is not None
                      else (lambda w=wid, mb=f: factory_worker(w, mb)))
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def _finish_one(self):
        with self._lock:
            self._live_workers -= 1
            # the sentinel goes in when ANY worker errors (so the consumer
            # learns promptly while siblings still produce) or when all
            # workers drained cleanly; an error also stops the siblings —
            # the consumer is about to raise and will never drain them
            if self._error is not None:
                self._stop = True
            if self._live_workers == 0 or self._error is not None:
                # best-effort: with the queue full the sentinel is dropped
                # rather than blocking an exiting worker; __next__ also
                # polls worker/error state so nothing is lost
                try:
                    self._q.put_nowait(self._done)
                except queue.Full:
                    pass

    def close(self):
        """Stop all workers and let them exit promptly (they observe the
        flag on their next bounded put). Safe to call more than once; the
        consumer can keep draining already-queued batches."""
        self._stop = True

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                # sentinel may have been dropped against a full queue that
                # has since drained — fall back to polling worker state
                with self._lock:
                    if self._error is not None:
                        raise RuntimeError(
                            "Prefetcher worker failed") from self._error
                    if self._live_workers == 0 and self._q.empty():
                        raise StopIteration
                continue
            if item is not self._done:
                return item
            if self._error is not None:
                raise RuntimeError("Prefetcher worker failed") from self._error
            with self._lock:
                if self._live_workers == 0:
                    raise StopIteration
            # a spurious sentinel (raced with a late error-set): keep going


def finish_batch(
    host_batch: Dict,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
    margin: float = 200.0,
    out_size: int = C.CROP_SIZE,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Device-side completion of a host batch: moves it to ``device`` (CUDA
    by default; raises without it), then jitter-crop (``generator`` on that
    device draws the jitter; unused when ``deterministic``) → resize-with-pad
    → normalize, and computes the bb conditioning. Folds the view axis into
    the batch for the image ops. Consumes the fields emitted by the dataset
    readers (context, context_extent, context_origin, person_box, intr) and
    returns the canonical train-batch layout."""
    dev = resolve_device(device)
    ctx = _to_device(host_batch["context"], dev)
    B, V = ctx.shape[:2]

    def flat(a):
        return a.reshape((B * V,) + tuple(a.shape[2:]))

    # context_scale: integer factor by which an oversized window was
    # downsampled into the fixed context buffer (1 = native resolution)
    f = flat(_to_device(host_batch.get(
        "context_scale", np.ones((B, V), np.float32)), dev))
    boxes = jitter_crop_boxes(
        generator,
        flat(_to_device(host_batch["person_box"], dev)),
        flat(_to_device(host_batch["context_extent"], dev)),
        margin=torch.full_like(f, margin) / f,
        deterministic=deterministic,
    )
    images, scale_ctx = crop_resize_pad(flat(ctx), boxes, out_size)
    # geometry bookkeeping is in FRAME pixels
    scale = scale_ctx / f

    intr = _to_device(host_batch["intr"], dev)
    principal = flat(intr[..., :2, 2])
    origin = flat(_to_device(host_batch["context_origin"], dev))
    frame_boxes = boxes * f[:, None]
    frame_boxes = torch.cat([frame_boxes[:, :2] + origin, frame_boxes[:, 2:]], dim=1)
    bb = bb_encoding(frame_boxes, principal, scale)

    batch = {
        k: _to_device(v, dev)
        for k, v in host_batch.items()
        if k not in ("context", "context_extent", "context_origin",
                     "person_box", "context_scale")
    }
    batch["images"] = images.reshape(B, V, out_size, out_size, 3)
    batch["bb"] = bb.reshape(B, V, 3)
    # Crop-frame keypoints (centered at 0, scaled): kp_crop = s·(uv − c)
    # (ref dsets/copenet_real.py:226-227) — used by the single-view real
    # losses.
    center = (frame_boxes[:, :2] + frame_boxes[:, 2:] / 2.0).reshape(B, V, 1, 2)
    if "gt_j2d_conf" in batch:
        kp = batch["gt_j2d_conf"]
        uv_crop = scale.reshape(B, V, 1, 1) * (kp[..., :2] - center)
        batch["gt_j2d_crop_conf"] = torch.cat([uv_crop, kp[..., 2:]], dim=-1)
    if "gt_j2d" in batch:
        # crop-frame GT keypoints for the weak-cam families
        # (same convention: kp_crop = s·(uv − crop_center))
        batch["gt_j2d_crop"] = (
            scale.reshape(B, V, 1, 1) * (batch["gt_j2d"][..., :2] - center))
    return batch
