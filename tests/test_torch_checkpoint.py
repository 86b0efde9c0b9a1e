"""The port's checkpoint module against the JAX package's on the CPU, on the
setup of ``test_checkpoint_resume.py`` (128x96, 12 frames, split at 7).

* ``save`` / ``restore``: leaves in the JAX flatten order (dict keys sorted,
  ``None`` without a leaf), shown on a dict whose keys are not in sorted
  order, in both directions between the packages.
* The state NamedTuples of both packages have the same names and field
  lists: the shared ``.ckpt`` format rebuilds them positionally by name.
* ``save_pipeline`` / ``restore_pipeline``: a round trip in the port is
  bitwise, and the resumed run repeats the uninterrupted one bitwise; a
  ``.ckpt`` written by JAX restores in the port and one written by the port
  restores in JAX, every tensor bitwise with the dtype the other package
  uses; then one more frame and one more packet go through both from the
  restored state: frame pose within 2e-3, the packet's verdict equal and
  its pose within 2e-2 (a whole coarse track and an LM run to its cap in
  float32; the stepwise tolerances are in ``test_torch_eds_pipeline``).
* A file without a manifest, with a malformed node or with an unknown class
  raises ``ValueError``; a pickled array in the file raises and is not
  unpickled.
"""
import inspect
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import slam_eds_tpu.checkpoint as jck
from slam_eds_tpu.config import load_config as jload
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models import pipeline as jpl
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole

import slam_eds_tpu_torch.checkpoint as tck
from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.models import ba_state as tbs
from slam_eds_tpu_torch.models import pipeline as tpl
from slam_eds_tpu_torch.ops import depth_filter as tdf
from slam_eds_tpu_torch.utils.cameras import Pinhole as TPinhole
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3

torch.set_num_threads(1)

W, H = 128, 96
JCAM = JPinhole(jnp.float32(110.0), jnp.float32(110.0),
                jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = TPinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
N_FRAMES, SPLIT = 12, 7
CFG = {
    "caps": {"max_points_per_kf": 256, "max_immature_per_kf": 256,
             "max_window_frames": 6, "max_events": 4096},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 300.0,
                 "desired_point_density": 200.0},
    "event_frame": {"num_levels": 2, "events_per_frame": 4096},
    "tracker": {"max_iterations": [12, 8]},
}


# ---------------------------------------------------------------------------
# generic trees
# ---------------------------------------------------------------------------

def _tree(xp):
    """Keys out of sorted order, a None, a NamedTuple, nested containers."""
    arr = (lambda a: torch.as_tensor(np.array(a))) if xp is torch \
        else jnp.asarray
    return {"zeta": arr(np.float32([1, 2, 3])),
            "alpha": [arr(np.int32([7])), None,
                      (arr(np.float32([[4.0]])), arr(np.array([True, False])))],
            "mid": {"b": arr(np.float32(2.5)), "a": arr(np.int32(9))}}


def test_leaf_order_is_jax_tree_flatten():
    import jax
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(_tree(jnp))]
    got = [x.numpy() for x in tck._leaves(_tree(torch))]
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_generic_save_restore_across_packages(tmp_path, writer):
    path = str(tmp_path / "tree")
    if writer == "jax":
        loc = jck.save(path, _tree(jnp), metadata={"step": 3},
                       use_orbax=False)
    else:
        loc = tck.save(path, _tree(torch), metadata={"step": 3})
    assert loc.endswith(".npz")
    assert tck.load_metadata(path) == jck.load_metadata(path) == {"step": 3}
    back_t = tck.restore(path, _tree(torch), device="cpu")
    back_j = jck.restore(path, _tree(jnp), use_orbax=False)
    want = _tree(torch)
    assert list(back_t) == list(want)            # the example's key order
    assert back_t["alpha"][1] is None
    for key in ("zeta",):
        assert torch.equal(back_t[key], want[key])
        np.testing.assert_array_equal(np.asarray(back_j[key]),
                                      want[key].numpy())
    assert int(back_t["mid"]["a"]) == int(back_j["mid"]["a"]) == 9
    assert float(back_t["mid"]["b"]) == float(back_j["mid"]["b"]) == 2.5
    assert torch.equal(back_t["alpha"][2][1], want["alpha"][2][1])
    with pytest.raises(ValueError):
        tck.restore(path, {"only": want["zeta"]}, device="cpu")


def test_generic_round_trip_of_state_tuples(tmp_path):
    ba = tbs.empty_state(3, 8, [100.0, 100.0, 5.0, 4.0], device="cpu")
    ba = ba._replace(p_idepth=torch.arange(8, dtype=torch.float32))
    flt = tdf.init_from_prior(torch.full((8,), 0.5), 0.25, 4.0, 10.0, 10.0,
                              device="cpu")
    tree = {"filter": flt, "ba": ba, "step": 11}
    tck.save(str(tmp_path / "st"), tree)
    back = tck.restore(str(tmp_path / "st"), tree, device="cpu")
    assert isinstance(back["ba"], tbs.BAState)
    assert isinstance(back["ba"].T_eval, TSE3)
    assert torch.equal(back["ba"].p_idepth, ba.p_idepth)
    assert back["ba"].p_host.dtype == torch.int32
    assert torch.equal(back["filter"].mu, flt.mu) and int(back["step"]) == 11


def test_state_types_have_the_same_fields_in_both_packages():
    """A field added to one package's state breaks the shared format: this
    fails first."""
    regj, regt = jck._nt_registry(), tck._nt_registry()
    names = ("BAState", "KeyFrame", "ImmaturePoints", "DepthFilterState",
             "TrackerState", "PoseFilter", "SE3", "InitState", "InitLevel")
    for name in names:
        assert regt[name]._fields == regj[name]._fields, name
    assert len(regt["BAState"]._fields) == 21
    assert len(regt["KeyFrame"]._fields) == 15
    assert len(regt["ImmaturePoints"]._fields) == 9
    # every state type the JAX registry knows and a pipeline can hold
    assert set(names) <= set(regt)
    sig = inspect.signature(tck.restore_pipeline)
    assert sig.parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# whole pipelines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sequence():
    seq = SyntheticSequence(JCAM, num_frames=N_FRAMES, events_per_packet=4096,
                            motion_scale=0.3)
    frames = [(float(t), np.array(img, np.float32))
              for t, img in (seq.frame(k)[:2] for k in range(N_FRAMES))]
    packets = [seq.events_between(k, k + 1) for k in range(N_FRAMES - 1)]
    return frames, packets


def _feed(pipe, sequence, k0, k1, conv=lambda a: a):
    frames, packets = sequence
    out = []
    for k in range(k0, k1):
        t, img = frames[k]
        pipe.process_frame(conv(img), t)
        if k + 1 < N_FRAMES and int(packets[k].n_valid) >= 64:
            out.append(pipe.process_events(packets[k]))
    return out


def _new_port():
    return tpl.EDSPipeline(TCAM, load_config(CFG), device="cpu")


@pytest.fixture(scope="module")
def port_split(sequence, tmp_path_factory):
    pipe = _new_port()
    _feed(pipe, sequence, 0, SPLIT)
    assert pipe.frame_pipe._initialized and pipe.kf is not None
    loc = tck.save_pipeline(str(tmp_path_factory.mktemp("p") / "snap"), pipe)
    return pipe, loc


@pytest.fixture(scope="module")
def jax_split(sequence, tmp_path_factory):
    pipe = jpl.EDSPipeline(JCAM, jload(CFG))
    _feed(pipe, sequence, 0, SPLIT, jnp.asarray)
    assert pipe.frame_pipe._initialized and pipe.kf is not None
    loc = jck.save_pipeline(str(tmp_path_factory.mktemp("j") / "snap"), pipe)
    return pipe, loc


def _trees(pipe):
    """Every state tuple of a pipeline, by name."""
    fp = pipe.frame_pipe
    out = {"state": fp.window.state, "kf": pipe.kf, "depth": pipe.depth,
           "tracker": pipe.tracker_state, "pose_filter": pipe.pose_filter,
           "last_pose": fp._last_pose, "motion": fp._motion,
           "last_good_pose": fp._last_good_pose,
           "world_anchor": fp._world_anchor}
    for i, im in enumerate(fp.window.immatures):
        if im is not None:
            out[f"immature{i}"] = im
    return out


def _arr(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_same_state(a, b, dtypes=True):
    ta, tb = _trees(a), _trees(b)
    assert set(ta) == set(tb)
    for name in ta:
        for leaf_a, leaf_b in zip(tck._leaves(ta[name]), tck._leaves(tb[name])):
            xa, xb = _arr(leaf_a), _arr(leaf_b)
            np.testing.assert_array_equal(xa, xb, err_msg=name)
            if dtypes:
                assert xa.dtype == xb.dtype, (name, xa.dtype, xb.dtype)
    fa, fb = a.frame_pipe, b.frame_pipe
    np.testing.assert_array_equal(_arr(fa.window.images),
                                  _arr(fb.window.images))
    assert list(fa.window.frame_ids) == list(fb.window.frame_ids)
    assert list(fa.window.frame_times) == list(fb.window.frame_times)
    assert (fa.window.next_id, fa.window.newest_slot) == \
        (fb.window.next_id, fb.window.newest_slot)
    assert (fa._frames_since_kf, fa._lost, fa._lost_frames, fa._resets) == \
        (fb._frames_since_kf, fb._lost, fb._lost_frames, fb._resets)
    assert fa.times == fb.times and len(fa.poses) == len(fb.poses)
    np.testing.assert_array_equal(np.stack(fa.trajectory),
                                  np.stack(fb.trajectory))
    assert float(a.loss_scale) == float(b.loss_scale)
    assert (a._pending_kf, a.num_event_kfs) == (b._pending_kf, b.num_event_kfs)
    assert len(a.event_poses) == len(b.event_poses)


def test_port_round_trip_and_resume(sequence, port_split):
    a, loc = port_split
    assert loc.endswith(".ckpt")
    b = tck.restore_pipeline(loc, TCAM, load_config(CFG), device="cpu")
    _assert_same_state(a, b)
    fa, fb = a.frame_pipe, b.frame_pipe
    assert (fa._last_rms, fa._first_rms) == (fb._last_rms, fb._first_rms)
    assert fa.window.marg_count == fb.window.marg_count
    assert b._kf_n_initial == a._kf_n_initial and b._seen_resets == fa._resets
    # derived state
    assert torch.equal(fb.window.intensity, fa.window.intensity)
    for pa, pb in zip(fa.window.pyramids, fb.window.pyramids):
        assert (pa is None) == (pb is None)
        if pa is not None:
            assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    for x, y in zip(fa.window.coarse_templates, fb.window.coarse_templates):
        assert all(torch.equal(p, q) for p, q in zip(x, y))

    ref = _new_port()
    out_ref = _feed(ref, sequence, 0, N_FRAMES)
    out_b = _feed(b, sequence, SPLIT, N_FRAMES)
    # the resumed run repeats the uninterrupted one bit for bit
    np.testing.assert_array_equal(np.stack(b.frame_pipe.trajectory),
                                  np.stack(ref.frame_pipe.trajectory))
    tail = out_ref[len(out_ref) - len(out_b):]
    assert [T is None for T in out_b] == [T is None for T in tail]
    for Tb, Tr in zip(out_b, tail):
        if Tb is not None:
            assert torch.equal(Tb.t, Tr.t) and torch.equal(Tb.R, Tr.R)
    assert len(b.event_poses) == len(ref.event_poses)


def _next_step(pipe, sequence, conv=lambda a: a):
    frames, packets = sequence
    t, img = frames[SPLIT]
    T_f = pipe.process_frame(conv(img), t)
    T_e = pipe.process_events(packets[SPLIT])
    return (_arr(T_f.t), None if T_e is None else _arr(T_e.t))


def _assert_next_step_agrees(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=2e-3)
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        np.testing.assert_allclose(got[1], want[1], atol=2e-2)


def test_jax_checkpoint_restores_in_the_port(sequence, jax_split):
    jp, loc = jax_split
    tp = tck.restore_pipeline(loc, TCAM, load_config(CFG), device="cpu")
    assert isinstance(tp, tpl.EDSPipeline) and tp.frame_pipe._initialized
    _assert_same_state(jp, tp)
    assert tp.frame_pipe._last_rms == float("inf")       # not in JAX's file
    assert tp._kf_n_initial == int(jp.kf.n_initial)
    jb = jck.restore_pipeline(loc, JCAM, jload(CFG))
    _assert_next_step_agrees(_next_step(tp, sequence),
                             _next_step(jb, sequence, jnp.asarray))


def test_port_checkpoint_restores_in_jax(sequence, port_split):
    tp, loc = port_split
    jp = jck.restore_pipeline(loc, JCAM, jload(CFG))
    assert isinstance(jp, jpl.EDSPipeline) and jp.frame_pipe._initialized
    _assert_same_state(tp, jp)
    tb = tck.restore_pipeline(loc, TCAM, load_config(CFG), device="cpu")
    _assert_next_step_agrees(_next_step(tb, sequence),
                             _next_step(jp, sequence, jnp.asarray))


def test_frame_only_pipeline_round_trip(sequence, tmp_path):
    frames, _ = sequence
    a = tpl.FrameOnlyPipeline(TCAM, load_config(CFG), device="cpu")
    with pytest.raises(ValueError):
        tck.save_pipeline(str(tmp_path / "early"), a)
    for t, img in frames[:5]:
        a.process_frame(img, t)
    loc = tck.save_pipeline(str(tmp_path / "fo.ckpt"), a)
    b = tck.restore_pipeline(loc, TCAM, load_config(CFG), device="cpu")
    assert isinstance(b, tpl.FrameOnlyPipeline)
    for t, img in frames[5:8]:
        Ta, Tb = a.process_frame(img, t), b.process_frame(img, t)
        assert torch.equal(Ta.t, Tb.t)


# ---------------------------------------------------------------------------
# malformed files
# ---------------------------------------------------------------------------

def _rewrite(loc, out, edit):
    with np.load(loc, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    manifest = json.loads(str(arrays.pop("__manifest__")))
    manifest = edit(manifest, arrays)
    extra = {} if manifest is None else {
        "__manifest__": np.asarray(json.dumps(manifest))}
    with open(out, "wb") as f:
        np.savez(f, **extra, **arrays)
    return out


def _bad_node(m, arrays):
    m["v"]["window"]["v"]["next_id"] = {"t": "exec", "v": "boom"}
    return m


def _unknown_class(m, arrays):
    m["v"]["frame_pipe"]["v"]["motion"]["cls"] = "Popen"
    return m


def _not_a_pipeline(m, arrays):
    return {"t": "dict", "v": {"version": 1}}


@pytest.mark.parametrize("edit", (lambda m, a: None, _bad_node,
                                  _unknown_class, _not_a_pipeline),
                         ids=("no_manifest", "bad_node", "unknown_class",
                              "not_a_pipeline"))
def test_malformed_manifest_raises(port_split, tmp_path, edit):
    bad = _rewrite(port_split[1], str(tmp_path / "bad.ckpt"), edit)
    with pytest.raises(ValueError):
        tck.restore_pipeline(bad, TCAM, load_config(CFG), device="cpu")


def test_nothing_is_unpickled(port_split, tmp_path):
    """An object array needs pickle to load: the restore refuses it."""
    class Boom:
        def __reduce__(self):
            return (pytest.fail, ("the checkpoint was unpickled",))

    def edit(m, arrays):
        arrays["a0"] = np.array([Boom()], dtype=object)
        return m
    bad = _rewrite(port_split[1], str(tmp_path / "pickled.ckpt"), edit)
    with pytest.raises(ValueError, match="[Pp]ickle"):
        tck.restore_pipeline(bad, TCAM, load_config(CFG), device="cpu")
