"""Checkpoint / resume of the full sliding-window odometry state — port of
``slam_eds_tpu.checkpoint``.

**The file formats are the JAX package's**, so a file written by either
package restores in the other:

* ``save`` / ``restore``: one ``.npz`` with the tree's leaves as
  ``leaf_{i}`` in ``jax.tree_util.tree_flatten`` order (dict keys SORTED,
  NamedTuple fields and list/tuple items in order, ``None`` holds no leaf)
  and an optional ``.meta.json`` beside it. The JAX package's orbax route
  is JAX's own and has no counterpart here.
* ``save_pipeline`` / ``restore_pipeline``: one ``.ckpt`` (an npz): arrays
  under generated keys and a JSON manifest (structure plus plain Python
  scalars; NamedTuples by class name) stored as the string array
  ``__manifest__``. Loaded with ``allow_pickle=False``: a file from an
  untrusted source can corrupt a resume but never executes code.

``restore_pipeline`` is the whole-pipeline carry-across function: it goes
through the per-type ``*_from_numpy`` converters. State the port holds
beyond the stored window (the planar intensity stack, pyramids, coarse
templates, the photometric gradient table) is derived on restore.

Three scalars of the frame tracker's re-track policy (``last_rms``,
``first_rms``) and the window's lifetime ``marg_count`` are written as
additional manifest entries: the JAX package's snapshot leaves them out, so
its resumed run restarts them from their defaults; a resumed run of the port
repeats the uninterrupted one. Either reader ignores entries it does not
know and defaults those it does not find.
"""
from __future__ import annotations

import inspect
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .utils.lie import SE3


# ---------------------------------------------------------------------------
# generic trees: leaf_{i} in the JAX flatten order
# ---------------------------------------------------------------------------

def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _children(node):
    """The sub-trees of a container in JAX's flatten order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def _leaves(tree) -> list:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in _leaves(kid)]


def _unflatten(example, leaves):
    """Rebuild ``example``'s structure from an iterator of leaves."""
    if example is None:
        return None
    if isinstance(example, dict):
        new = {k: _unflatten(example[k], leaves) for k in sorted(example)}
        return {k: new[k] for k in example}
    if _is_namedtuple(example):
        return type(example)(*[_unflatten(x, leaves) for x in example])
    if isinstance(example, (list, tuple)):
        return type(example)(_unflatten(x, leaves) for x in example)
    return next(leaves)


def _as_array(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> str:
    """Save a state tree (e.g. {'ba': BAState, 'filter': DepthFilterState,
    'step': k}) as ``path`` (+ ``.npz``). Returns the file written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    loc = path if path.endswith(".npz") else path + ".npz"
    np.savez_compressed(loc, **{f"leaf_{i}": _as_array(x)
                                for i, x in enumerate(_leaves(tree))})
    if metadata is not None:
        with open(loc.rstrip("/") + ".meta.json", "w") as f:
            json.dump(metadata, f)
    return loc


def restore(path: str, example_tree: Any, device="cuda"):
    """Restore into the structure of ``example_tree`` (the fixed-capacity
    design makes shapes and dtypes those that were saved); every leaf comes
    back as a tensor on ``device``."""
    device = resolve_device(device)
    loc = path if path.endswith(".npz") else path + ".npz"
    with np.load(loc, allow_pickle=False) as data:
        n = len(data.files)
        want = len(_leaves(example_tree))
        if n != want:
            raise ValueError(f"{loc} holds {n} leaves, the example tree "
                             f"{want}")
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device)
                  for i in range(n)]
    return _unflatten(example_tree, iter(leaves))


def load_metadata(path: str) -> Optional[dict]:
    for loc in (path, path + ".npz"):
        meta = loc.rstrip("/") + ".meta.json"
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
    return None


# ---------------------------------------------------------------------------
# whole-pipeline checkpoint / resume
# ---------------------------------------------------------------------------

def _encode(obj, arrays: Dict[str, np.ndarray]):
    """Structure -> JSON-able manifest node; arrays hoisted into ``arrays``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj if not isinstance(obj, float) or np.isfinite(obj) \
            else {"t": "f", "v": repr(obj)}
    if torch.is_tensor(obj) or isinstance(obj, (np.ndarray, np.generic)):
        key = f"a{len(arrays)}"
        arrays[key] = _as_array(obj)
        return {"t": "arr", "k": key}
    if _is_namedtuple(obj):
        return {"t": "nt", "cls": type(obj).__name__,
                "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, dict):
        return {"t": "dict", "v": {k: _encode(v, arrays)
                                   for k, v in obj.items()}}
    raise TypeError(f"checkpoint cannot encode {type(obj)!r}")


def _nt_registry() -> Dict[str, type]:
    """Known NamedTuple state types, looked up by class name on decode."""
    from .models import ba_state, keyframe
    from .ops import depth_filter, event_tracker, immature, coarse_init
    from .utils import lie
    reg: Dict[str, type] = {}
    for mod in (ba_state, keyframe, depth_filter, event_tracker, immature,
                coarse_init, lie):
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if _is_namedtuple_class(cls):
                reg[name] = cls
    return reg


def _is_namedtuple_class(cls) -> bool:
    return issubclass(cls, tuple) and hasattr(cls, "_fields")


def _decode(node, arrays, reg):
    """Manifest node -> structure, its arrays still numpy."""
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if not isinstance(node, dict) or "t" not in node:
        raise ValueError(f"bad checkpoint node {node!r}")
    t = node["t"]
    if t == "f":
        return float(node["v"])          # inf / nan
    if t == "arr":
        return arrays[node["k"]]
    if t == "nt":
        if node["cls"] not in reg:
            raise ValueError(f"unknown state type {node['cls']!r}")
        return reg[node["cls"]](*[_decode(x, arrays, reg)
                                  for x in node["v"]])
    if t == "list":
        return [_decode(x, arrays, reg) for x in node["v"]]
    if t == "tuple":
        return tuple(_decode(x, arrays, reg) for x in node["v"])
    if t == "dict":
        return {k: _decode(v, arrays, reg) for k, v in node["v"].items()}
    raise ValueError(f"bad checkpoint node type {t!r}")


def save_pipeline(path: str, pipe) -> str:
    """Snapshot a FrameOnlyPipeline or EDSPipeline (after initialization).
    Returns the file written (``path`` with a .ckpt suffix)."""
    is_eds = hasattr(pipe, "tracker_state")
    fp = pipe.frame_pipe if is_eds else pipe
    w = fp.window
    if not fp._initialized:
        raise ValueError("checkpoint only defined after initialization")
    d = {
        "version": 1,
        "is_eds": is_eds,
        "window": {
            "state": w.state,
            "images": w.images,
            "immatures": list(w.immatures),
            "frame_times": [float(t) for t in w.frame_times],
            "frame_ids": [int(i) for i in w.frame_ids],
            "next_id": int(w.next_id),
            "newest_slot": int(w.newest_slot),
            "marg_count": int(w.marg_count),
        },
        "frame_pipe": {
            "last_pose": fp._last_pose,
            "last_good_pose": fp._last_good_pose,
            "motion": fp._motion,
            "frames_since_kf": int(fp._frames_since_kf),
            "lost": bool(fp._lost),
            "lost_frames": int(fp._lost_frames),
            "resets": int(fp._resets),
            "world_anchor": fp._world_anchor,
            "trajectory": [np.asarray(t) for t in fp.trajectory],
            "poses": list(fp.poses),
            "times": [float(t) for t in fp.times],
            "last_rms": float(fp._last_rms),
            "first_rms": (None if fp._first_rms is None
                          else float(fp._first_rms)),
        },
    }
    if is_eds:
        d["eds"] = {
            "kf": pipe.kf,
            "depth": pipe.depth,
            "tracker": pipe.tracker_state,
            "pose_filter": pipe.pose_filter,
            "loss_scale": float(pipe.loss_scale),
            "pending_kf": bool(pipe._pending_kf),
            "num_event_kfs": int(pipe.num_event_kfs),
            "event_poses": [np.asarray(t) for t in pipe.event_poses],
            "event_pose_list": list(pipe.event_pose_list),
        }
    loc = path if path.endswith(".ckpt") else path + ".ckpt"
    os.makedirs(os.path.dirname(os.path.abspath(loc)) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest = _encode(d, arrays)
    with open(loc, "wb") as f:
        np.savez(f, __manifest__=np.asarray(json.dumps(manifest)), **arrays)
    return loc


def _fields(nt) -> dict:
    """A decoded NamedTuple as the field dict the ``*_from_numpy``
    converters take (an SE3 field as 'name.R' / 'name.t')."""
    out = {}
    for name, v in nt._asdict().items():
        if isinstance(v, SE3):
            out[f"{name}.R"], out[f"{name}.t"] = v.R, v.t
        else:
            out[name] = v
    return out


def restore_pipeline(path: str, cam, cfg=None, device="cuda",
                     photometric=None):
    """Rebuild a running pipeline on ``device`` from a ``save_pipeline``
    snapshot of either package. Derived state (the intensity stack, image
    pyramids, coarse-tracker templates) is recomputed from the restored
    tensors."""
    from .config import EDSConfig
    from .models import ba_state, keyframe
    from .models.pipeline import EDSPipeline, FrameOnlyPipeline
    from .ops import depth_filter, event_tracker, immature

    loc = path if path.endswith(".ckpt") else path + ".ckpt"
    with np.load(loc, allow_pickle=False) as data:
        if "__manifest__" not in data.files:
            raise ValueError(f"{loc} holds no manifest")
        manifest = json.loads(str(data["__manifest__"]))
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    d = _decode(manifest, arrays, _nt_registry())
    if not isinstance(d, dict) or not {"is_eds", "window",
                                       "frame_pipe"} <= set(d):
        raise ValueError(f"{loc} is not a pipeline checkpoint")
    cfg = cfg or EDSConfig()

    pipe = (EDSPipeline if d["is_eds"] else FrameOnlyPipeline)(
        cam, cfg, device=device, photometric=photometric)
    dev = pipe.device
    fp = pipe.frame_pipe if d["is_eds"] else pipe

    def pose(p) -> SE3:
        return SE3(torch.as_tensor(np.array(p[0]), device=dev),
                   torch.as_tensor(np.array(p[1]), device=dev))

    w = fp.window
    dw = d["window"]
    w.state = ba_state.from_numpy(_fields(dw["state"]), device=dev)
    w.images = torch.as_tensor(np.array(dw["images"]), device=dev)
    w.intensity = w.images[..., 0].contiguous()
    w.immatures = [None if im is None
                   else immature.from_numpy(_fields(im), device=dev)
                   for im in dw["immatures"]]
    w.frame_times = [float(t) for t in dw["frame_times"]]
    w.frame_ids = [int(i) for i in dw["frame_ids"]]
    w.next_id = int(dw["next_id"])
    w.newest_slot = int(dw["newest_slot"])
    w.marg_count = int(dw.get("marg_count", 0))
    valid = w.state.frame_valid.tolist()
    w.pyramids = [w._pyramid(w.intensity[s]) if valid[s] else None
                  for s in range(w.state.num_frames)]
    if w.newest_slot >= 0:
        w.rebuild_coarse_template()

    dfp = d["frame_pipe"]
    fp._initialized = True
    fp._last_pose = pose(dfp["last_pose"])
    fp._motion = pose(dfp["motion"])
    fp._frames_since_kf = int(dfp["frames_since_kf"])
    # recovery-ladder state (older snapshots lack these; defaults apply)
    if "last_good_pose" in dfp:
        fp._last_good_pose = pose(dfp["last_good_pose"])
        fp._lost = bool(dfp["lost"])
        fp._lost_frames = int(dfp["lost_frames"])
        fp._resets = int(dfp["resets"])
        fp._world_anchor = pose(dfp["world_anchor"])
        if d["is_eds"]:
            pipe._seen_resets = fp._resets
    fp._last_rms = float(dfp.get("last_rms", float("inf")))
    first_rms = dfp.get("first_rms")
    fp._first_rms = None if first_rms is None else float(first_rms)
    fp.trajectory = [np.asarray(t) for t in dfp["trajectory"]]
    fp.poses = [pose(p) for p in dfp["poses"]]
    fp.times = [float(t) for t in dfp.get("times", [])]

    if d["is_eds"]:
        de = d["eds"]
        pipe.kf = None if de["kf"] is None else keyframe.from_numpy(
            _fields(de["kf"]), device=dev)
        pipe.depth = None if de["depth"] is None else depth_filter.from_numpy(
            _fields(de["depth"]), device=dev)
        pipe.tracker_state = event_tracker.state_from_numpy(
            _fields(de["tracker"]), device=dev)
        pipe.pose_filter = event_tracker.pose_filter_from_numpy(
            _fields(de["pose_filter"]), device=dev)
        pipe.loss_scale = float(de["loss_scale"])
        pipe._pending_kf = bool(de["pending_kf"])
        pipe.num_event_kfs = int(de["num_event_kfs"])
        pipe._kf_n_initial = 0 if pipe.kf is None else int(pipe.kf.n_initial)
        pipe.event_poses = [np.asarray(t) for t in de["event_poses"]]
        pipe.event_pose_list = [pose(p) for p in de["event_pose_list"]]
    return pipe
