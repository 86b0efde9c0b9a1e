"""Visualization: colormap LUTs and debug-image generators — a near copy of
``slam_eds_tpu.utils.viz`` (numpy only; the port keeps its own so that it
imports nothing of the JAX package).

Colormaps (BlueWhiteRed for signed event images, a jet-style rainbow for
inverse depth, green for weights) and the keyframe debug images: idepth,
weights and residual overlays, events blended on the keyframe. Everything
takes host arrays (``tensor.cpu()`` first) and returns HxWx3 uint8 images,
which ``io.recorder.Recorder.save_viz`` writes as PNG.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# colormaps
# ---------------------------------------------------------------------------


def _lut_from_anchors(anchors, n: int = 256) -> np.ndarray:
    """[n, 3] uint8 LUT linearly interpolated through RGB anchor rows."""
    anchors = np.asarray(anchors, np.float64)
    pos = np.linspace(0.0, 1.0, len(anchors))
    x = np.linspace(0.0, 1.0, n)
    lut = np.stack([np.interp(x, pos, anchors[:, c]) for c in range(3)], -1)
    return np.clip(lut, 0, 255).astype(np.uint8)


# Diverging blue-white-red map used for signed event / brightness-increment
# images (reference Colormap.hpp:29-60 BLUE_WHITE_RED).
BLUE_WHITE_RED = _lut_from_anchors([
    (0, 0, 255), (128, 128, 255), (255, 255, 255),
    (255, 128, 128), (255, 0, 0),
])

# Jet-style rainbow for inverse-depth maps (reference uses cv::COLORMAP_JET
# style LUTs in Colormap.cpp).
JET = _lut_from_anchors([
    (0, 0, 131), (0, 60, 255), (0, 255, 255), (60, 255, 60),
    (255, 255, 0), (255, 60, 0), (131, 0, 0),
])

# Green-magnitude map for weights in [0, 1].
GREEN = _lut_from_anchors([(0, 0, 0), (0, 255, 0)])


def apply_colormap(values, lut, vmin=None, vmax=None) -> np.ndarray:
    """Map a float image through a [256, 3] LUT -> HxWx3 uint8."""
    v = np.asarray(values, np.float64)
    lo = np.nanmin(v) if vmin is None else vmin
    hi = np.nanmax(v) if vmax is None else vmax
    scale = (hi - lo) if hi > lo else 1.0
    idx = np.clip((v - lo) / scale * 255.0, 0, 255).astype(np.int32)
    return lut[idx]


# ---------------------------------------------------------------------------
# debug images
# ---------------------------------------------------------------------------


def gray_to_rgb(img) -> np.ndarray:
    """[H, W] float (any range) -> HxWx3 uint8 grayscale base canvas."""
    g = np.asarray(img, np.float64)
    lo, hi = np.nanmin(g), np.nanmax(g)
    g8 = np.clip((g - lo) / (hi - lo if hi > lo else 1.0) * 255, 0, 255)
    return np.repeat(g8.astype(np.uint8)[..., None], 3, axis=-1)


def event_frame_viz(event_frame) -> np.ndarray:
    """Signed brightness-increment image -> BlueWhiteRed viz (reference
    EventFrame::getEventFrameViz, EventFrame.cpp:430-460): symmetric range
    about zero so polarity 0 maps to white."""
    ef = np.asarray(event_frame, np.float64)
    m = np.nanmax(np.abs(ef)) or 1.0
    return apply_colormap(ef, BLUE_WHITE_RED, vmin=-m, vmax=m)


def _splat(canvas: np.ndarray, uv, colors, valid=None, radius: int = 1):
    """Draw filled squares of `radius` at point pixel coords on canvas."""
    H, W, _ = canvas.shape
    uv = np.asarray(uv)
    colors = np.asarray(colors)
    if valid is None:
        valid = np.ones(len(uv), bool)
    valid = (np.asarray(valid, bool)
             & (uv[:, 0] >= 0) & (uv[:, 0] <= W - 1)
             & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1))
    u = np.clip(np.round(uv[:, 0]).astype(np.int32), 0, W - 1)
    v = np.clip(np.round(uv[:, 1]).astype(np.int32), 0, H - 1)
    for du in range(-radius, radius + 1):
        for dv in range(-radius, radius + 1):
            uu = np.clip(u + du, 0, W - 1)
            vv = np.clip(v + dv, 0, H - 1)
            canvas[vv[valid], uu[valid]] = colors[valid]
    return canvas


def idepth_map_viz(image, uv, idepth, valid=None, vmin=None,
                   vmax=None) -> np.ndarray:
    """Sparse inverse-depth overlay on the keyframe image (reference
    KeyFrame::idepthmapViz, KeyFrame.cpp:1425-1460): JET-colored squares at
    the active points."""
    canvas = gray_to_rgb(image)
    idp = np.asarray(idepth, np.float64)
    if valid is None:
        valid = np.isfinite(idp)
    lo = vmin if vmin is not None else np.nanmin(np.where(valid, idp, np.nan))
    hi = vmax if vmax is not None else np.nanmax(np.where(valid, idp, np.nan))
    colors = apply_colormap(idp, JET, vmin=lo, vmax=hi)
    return _splat(canvas, uv, colors, valid)


def weights_viz(image, uv, weights, valid=None) -> np.ndarray:
    """Per-point weight overlay in green intensity (reference
    KeyFrame::weightsViz, KeyFrame.cpp:1462-1489)."""
    canvas = gray_to_rgb(image)
    colors = apply_colormap(np.asarray(weights, np.float64), GREEN,
                            vmin=0.0, vmax=1.0)
    return _splat(canvas, uv, colors, valid)


def residuals_viz(image, uv, residuals, valid=None) -> np.ndarray:
    """Signed residual overlay, BlueWhiteRed symmetric about zero
    (reference KeyFrame::residualsViz, KeyFrame.cpp:1491-1516)."""
    canvas = gray_to_rgb(image)
    r = np.asarray(residuals, np.float64)
    m = np.nanmax(np.abs(r[np.asarray(valid, bool)] if valid is not None
                         else r)) or 1.0
    colors = apply_colormap(r, BLUE_WHITE_RED, vmin=-m, vmax=m)
    return _splat(canvas, uv, colors, valid)


def events_on_keyframe_viz(image, event_frame, alpha: float = 0.6,
                           threshold: float = 0.0) -> np.ndarray:
    """Blend the event brightness-increment image over the keyframe
    grayscale (reference KeyFrame::eventsOnKeyFrameViz,
    KeyFrame.cpp:1518-1539): only pixels with |event| > threshold are
    tinted."""
    canvas = gray_to_rgb(image).astype(np.float64)
    ef = np.asarray(event_frame, np.float64)
    tint = event_frame_viz(ef).astype(np.float64)
    mask = (np.abs(ef) > threshold)[..., None]
    out = np.where(mask, (1 - alpha) * canvas + alpha * tint, canvas)
    return np.clip(out, 0, 255).astype(np.uint8)
