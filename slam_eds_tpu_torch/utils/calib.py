"""Calibration loading — port of ``slam_eds_tpu.utils.calib``: per-camera
info, the frame + event dual rig, the common-view rectified geometry, DSO
``camera.txt`` export and photometric calibration (gamma response +
vignette).

``calib.yaml`` is read by ``read_yaml``, a reader of the kalibr subset these
files use, always (PyYAML is not a dependency of the port): block mappings
and block sequences by indentation, flow lists (nested, and continued over
lines), plain and quoted scalars resolved as YAML 1.1 / PyYAML's
``safe_load`` resolves them, and comments. Anything else raises
``ValueError``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from .cameras import (CameraModel, Pinhole, f32, forward_maps,
                      gamma_inverse_table, undistortion_maps)

# ---------------------------------------------------------------------------
# The YAML subset reader
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), less the sexagesimal forms
_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)"
                       r"|\.(?:nan|NaN|NAN))$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_DQ_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/",
               "0": "\0", "r": "\r"}


def _scalar(tok: str):
    """One plain or quoted scalar, resolved as PyYAML's SafeLoader does."""
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        return re.sub(r"\\(.)", lambda m: _DQ_ESCAPES[m.group(1)], tok[1:-1])
    if _NULL_RE.match(tok):
        return None
    if _BOOL_RE.match(tok):
        return _BOOL[tok.lower()]
    if _INT_RE.match(tok):
        s = tok.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if len(s) > 1 and s[0] == "0":
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT_RE.match(tok):
        s = tok.replace("_", "").lower()
        if s.endswith(".inf"):
            return float("-inf") if s[0] == "-" else float("inf")
        if s.endswith(".nan"):
            return float("nan")
        return float(s)
    if tok[:1] in "[]{}&*!|>%@`" or tok.startswith(("- ", "? ")):
        raise ValueError(f"calib YAML: unsupported syntax {tok!r}")
    return tok


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow(text: str):
    """A flow sequence ``[a, [b, c], ...]`` of scalars."""
    pos = 0

    def item():
        nonlocal pos
        while text[pos] == " ":
            pos += 1
        if text[pos] == "[":
            pos += 1
            out = []
            while True:
                while text[pos] == " ":
                    pos += 1
                if text[pos] == "]":
                    pos += 1
                    return out
                out.append(item())
                while text[pos] == " ":
                    pos += 1
                if text[pos] == ",":
                    pos += 1
                elif text[pos] != "]":
                    raise ValueError(f"calib YAML: bad flow list {text!r}")
        m = re.match(r"'(?:[^']|'')*'|\"(?:[^\"\\]|\\.)*\"|[^,\[\]]*",
                     text[pos:])
        pos += m.end()
        return _scalar(m.group(0).strip())

    value = item()
    if text[pos:].strip():
        raise ValueError(f"calib YAML: trailing text after {text!r}")
    return value


def _split_key(content: str):
    """``key: rest`` -> (key, rest) or None when ``content`` is no pair."""
    m = re.match(r"^('(?:[^']|'')*'|\"(?:[^\"\\]|\\.)*\"|[^'\"\[\]{}#][^:#]*?)"
                 r"\s*:(?:\s+(.*)|$)", content)
    if m is None:
        return None
    return _scalar(m.group(1).strip()), (m.group(2) or "").strip()


def read_yaml(text: str):
    """Parse the kalibr YAML subset; returns what ``yaml.safe_load`` would
    (None for an empty document)."""
    lines = []                                 # (indent, content)
    pending = None                             # a flow list spanning lines
    for raw in text.splitlines():
        if raw.startswith(("%", "---")) and pending is None:
            if raw.startswith("---") and raw[3:].strip():
                raise ValueError(f"calib YAML: unsupported syntax {raw!r}")
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("calib YAML: tab indentation")
        line = _strip_comment(raw)
        if pending is not None:
            pending[1] += " " + line.strip()
            if pending[1].count("[") == pending[1].count("]"):
                lines.append(tuple(pending))
                pending = None
            continue
        if not line.strip():
            continue
        entry = [len(line) - len(line.lstrip()), line.strip()]
        if entry[1].count("[") > entry[1].count("]"):
            pending = entry
        else:
            lines.append(tuple(entry))
    if pending is not None:
        raise ValueError("calib YAML: unterminated flow list")
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"calib YAML: unexpected line {lines[end][1]!r}")
    return value


def _inline(text: str):
    return _flow(text) if text.startswith("[") else _scalar(text)


def _is_item(content: str) -> bool:
    """A block-sequence entry ("- value" or a bare "-")."""
    return content == "-" or content.startswith("- ")


def _block(lines, i, indent):
    """The block node whose lines start at ``lines[i]``, at ``indent``;
    returns (value, index of the first line after it)."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent \
                and _is_item(lines[i][1]):
            content = lines[i][1]
            rest = content[1:].strip()
            if _is_item(rest):
                # compact nested sequence "- - a": the inner items sit at
                # the inner dash's column
                lines[i] = (indent + len(content) - len(rest), rest)
                value, i = _block(lines, i, lines[i][0])
                out.append(value)
                continue
            i += 1
            if rest:
                if _split_key(rest) is not None:
                    raise ValueError("calib YAML: mappings inside block "
                                     "sequences are not supported")
                out.append(_inline(rest))
            elif i < len(lines) and lines[i][0] > indent:
                value, i = _block(lines, i, lines[i][0])
                out.append(value)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        pair = _split_key(lines[i][1])
        if pair is None:
            raise ValueError(f"calib YAML: expected 'key: value', got "
                             f"{lines[i][1]!r}")
        key, rest = pair
        i += 1
        if rest:
            out[key] = _inline(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"calib YAML: bad indentation at {lines[i][1]!r}")
    return out, i


def _load(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict) as f:
        return read_yaml(f.read()) or {}


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------

@dataclass
class CameraInfo:
    """One sensor's calibration block (kalibr key names)."""
    width: int = 0
    height: int = 0
    distortion_model: str = "none"
    intrinsics: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)   # fx fy cx cy
    D: Tuple[float, ...] = ()
    R: Optional[list] = None          # 3x3 rectification
    P: Optional[list] = None          # 3x4 projection
    T_cam_imu: Optional[list] = None  # 4x4
    flip: bool = False

    def to_model(self, *, device) -> CameraModel:
        """The camera as a ``CameraModel`` (intrinsics rounded to float32,
        D a float32 tensor on ``device``)."""
        fx, fy, cx, cy = self.intrinsics
        pin = Pinhole(f32(fx), f32(fy), f32(cx), f32(cy), int(self.width),
                      int(self.height))
        model = {"radial-tangential": "radtan", "plumb_bob": "radtan",
                 "equidistant": "kb", "kannala_brandt": "kb",
                 "fov": "fov", "none": "none"}.get(
                     self.distortion_model, self.distortion_model)
        D = torch.tensor(self.D or (0.0,) * 4, dtype=torch.float32,
                         device=device)
        return CameraModel(pin, D, model)


@dataclass
class DualCamera:
    """Frame camera + event camera + the extrinsics between them."""
    cam0: CameraInfo = field(default_factory=CameraInfo)   # frames
    cam1: CameraInfo = field(default_factory=CameraInfo)   # events
    T_cam0_cam1: Optional[list] = None                     # 4x4


def _read_camera_block(data: dict) -> CameraInfo:
    res = data.get("resolution", [0, 0])
    return CameraInfo(
        width=int(res[0]), height=int(res[1]),
        distortion_model=data.get("distortion_model", "none"),
        intrinsics=tuple(data.get("intrinsics", (0, 0, 0, 0))),
        D=tuple(data.get("distortion_coeffs", ())),
        R=data.get("rectification_matrix"),
        P=data.get("projection_matrix"),
        T_cam_imu=data.get("T_cam_imu"),
        flip=bool(data.get("flip", False)),
    )


def read_camera_calib(path_or_dict, key: str = "cam0") -> CameraInfo:
    data = _load(path_or_dict)
    return _read_camera_block(data.get(key, data))


def read_dual_calibration(path_or_dict) -> DualCamera:
    """The frame + event rig: ``cam0`` frame camera, ``cam1`` event camera,
    ``cam1.T_cn_cnm1`` the 4x4 extrinsic cam1 <- cam0."""
    data = _load(path_or_dict)
    cam0 = _read_camera_block(data.get("cam0", {}))
    cam1 = _read_camera_block(data.get("cam1", {}))
    T = data.get("cam1", {}).get("T_cn_cnm1", data.get("T_cam0_cam1"))
    return DualCamera(cam0=cam0, cam1=cam1, T_cam0_cam1=T)


def common_view_camera(dual: DualCamera,
                       out_size: Optional[Tuple[int, int]] = None) -> Pinhole:
    """The shared rectified geometry both sensors map into: the event
    camera's size by default, intrinsics the mean of both cameras' scaled
    to it."""
    w1, h1 = dual.cam1.width, dual.cam1.height
    out_w, out_h = out_size or (w1, h1)

    def scaled(info: CameraInfo):
        fx, fy, cx, cy = info.intrinsics
        sx, sy = out_w / info.width, out_h / info.height
        return np.array([fx * sx, fy * sy, cx * sx, cy * sy])

    k = 0.5 * (scaled(dual.cam0) + scaled(dual.cam1))
    return Pinhole(f32(k[0]), f32(k[1]), f32(k[2]), f32(k[3]), int(out_w),
                   int(out_h))


def dual_mappings(dual: DualCamera, out: Optional[Pinhole] = None, *,
                  device):
    """Maps of both sensors into the common view, on ``device``: the frame
    camera's inverse maps (image remap) and the event camera's forward maps
    (per-event lookup)."""
    out = out or common_view_camera(dual)
    frame_maps = undistortion_maps(dual.cam0.to_model(device=device), out)
    event_fwd = forward_maps(dual.cam1.to_model(device=device), out)
    return {"frame_map_x": frame_maps[0], "frame_map_y": frame_maps[1],
            "event_fwd_x": event_fwd[0], "event_fwd_y": event_fwd[1],
            "out": out}


def to_dso_format(cam: CameraModel, out: Optional[Pinhole] = None) -> str:
    """DSO ``camera.txt``: normalized input intrinsics + distortion, input
    size, normalized output intrinsics, output size."""
    pin, outp = cam.pinhole, (out or cam.pinhole)
    d = " ".join(f"{float(v):.10f}" for v in cam.D.tolist())
    l1 = (f"{float(pin.fx) / pin.width:.10f} {float(pin.fy) / pin.height:.10f} "
          f"{float(pin.cx) / pin.width:.10f} {float(pin.cy) / pin.height:.10f} "
          f"{d}").rstrip()
    l3 = (f"{float(outp.fx) / outp.width:.10f} "
          f"{float(outp.fy) / outp.height:.10f} "
          f"{float(outp.cx) / outp.width:.10f} "
          f"{float(outp.cy) / outp.height:.10f}")
    return (f"{l1}\n{pin.width} {pin.height}\n{l3}\n"
            f"{outp.width} {outp.height}\n")


# ---------------------------------------------------------------------------
# Photometric calibration
# ---------------------------------------------------------------------------

@dataclass
class PhotometricCalib:
    """Gamma response + vignette (DSO's PhotometricUndistorter). ``correct``
    maps a raw 8-bit image to linear irradiance with the vignette
    removed."""
    B: np.ndarray               # [256] response
    Binv: np.ndarray            # [256] inverse response
    vignette_inv: Optional[np.ndarray] = None   # [H, W] 1/V

    @staticmethod
    def from_files(gamma_values, vignette: Optional[np.ndarray] = None
                   ) -> "PhotometricCalib":
        B, Binv = gamma_inverse_table(gamma_values)
        vinv = None
        if vignette is not None:
            v = np.asarray(vignette, np.float64)
            vinv = np.asarray(v.max() / np.maximum(v, 1e-3), np.float32)
        return PhotometricCalib(B, Binv, vinv)

    def correct(self, img):
        """Binv[clip(img, 0, 255)] (times 1/V) as float32, computed on the
        image's device (a numpy image is taken as a CPU tensor)."""
        img = torch.as_tensor(img)
        lut = torch.as_tensor(self.Binv, device=img.device)
        out = lut[torch.clamp(img.to(torch.int64), 0, 255)]
        if self.vignette_inv is not None:
            out = out * torch.as_tensor(self.vignette_inv, device=img.device)
        return out

    def b_grad_table(self) -> np.ndarray:
        """[256] forward-response derivative at a corrected intensity:
        bg[i] = B[c+1] - B[c] with c = clip(i, 5, 250)
        (CalibHessian::getBGradOnly). The pixel selector weights its
        squared-gradient maps by bg^2."""
        B = np.asarray(self.B, np.float64)
        c = np.clip(np.arange(256), 5, 250)
        return np.asarray(B[c + 1] - B[c], np.float32)
