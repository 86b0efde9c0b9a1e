"""The port's evaluator, map export and viz against the JAX package on the
CPU.

* ``batched_event_solves`` / ``batched_ba_windows`` (one ``torch.vmap``
  each, run under the no-read guard): JAX's ``vmap`` of the same problems
  within 2e-4 on the pose and 1e-3 relative on the energy (the JAX test's
  own tolerance between its batched and single programs), the BA's state
  within the tolerances of ``test_torch_energy``. Against the port's single
  solve of the same problem: the batched products sum in another order than
  the single ones, so a lane is not bitwise its single solve; the event
  lanes stop at the same iteration and stay within JAX's 2e-4 / 1e-3 (the
  8-iteration LM amplifies the rounding: 8.6e-5 at most, CPU); the BA lanes
  within 2e-5 on the deltas (1.1e-6 measured, deltas up to 2.8e-3), 2e-4 on
  the idepths (1.9e-5) and 2e-5 relative on the energy (4.9e-6).
* ``evaluate_sequences`` on two tiny written datasets: the report's
  structure and counts, finite ATE / RPE, and the directory expansion.
* ``_backproject_window``, ``radius_outlier_removal``: within 1e-5 / equal;
  ``get_map`` colors equal; ``write_ply`` and ``write_trajectory_tum``: the
  files' bytes equal to JAX's on the same state; every ``viz`` function:
  the images equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import slam_eds_tpu.eval as jev
from slam_eds_tpu.io import output_maps as jom
from slam_eds_tpu.models import ba_state as jbs
from slam_eds_tpu.ops import energy as jen
from slam_eds_tpu.ops import event_tracker as jet
from slam_eds_tpu.utils import viz as jviz
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole
from slam_eds_tpu.utils.lie import SE3 as JSE3

import slam_eds_tpu_torch.eval as tev
from slam_eds_tpu_torch.config import RecorderConfig, load_config
from slam_eds_tpu_torch.io import output_maps as tom
from slam_eds_tpu_torch.io.dataset import SyntheticSequence
from slam_eds_tpu_torch.io.image_rw import read_png
from slam_eds_tpu_torch.io.recorder import Recorder
from slam_eds_tpu_torch.models import ba_state as tbs
from slam_eds_tpu_torch.ops import energy as ten
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.utils import viz as tviz
from slam_eds_tpu_torch.utils.cameras import Pinhole as TPinhole
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3
from torch_guard import no_host_reads
from torch_world import CX, CY, FX, FY, H, W, world_arrays

torch.set_num_threads(1)

JCAM = JPinhole(jnp.float32(110.0), jnp.float32(110.0),
                jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = TPinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# batched solver surface
# ---------------------------------------------------------------------------

def _toy_problem(rng, P=128):
    ys, xs = np.mgrid[0:H, 0:W]
    ef = (np.sin(xs * 0.2 + rng.normal()) * np.cos(ys * 0.15)).astype(
        np.float32)
    ef = ef / np.linalg.norm(ef)
    nc = np.stack([rng.uniform(-0.4, 0.4, P), rng.uniform(-0.3, 0.3, P)],
                  -1).astype(np.float32)
    return (ef, nc, rng.normal(size=(P, 2)).astype(np.float32),
            rng.uniform(0.3, 1.0, P).astype(np.float32),
            np.ones(P, np.float32), rng.uniform(size=P) > 0.1)


@pytest.mark.parametrize("scalar_scale", (False, True))
def test_batched_event_solves(scalar_scale):
    rng = np.random.default_rng(3)
    B = 3
    probs = [_toy_problem(rng) for _ in range(B)]
    stacked = [np.stack([p[i] for p in probs]) for i in range(6)]
    jstates = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jet.initial_tracker_state() for _ in range(B)])
    tstates = tet.TrackerState(*(torch.stack([x] * B) for x in
                                 tet.initial_tracker_state("cpu")))
    jls = 0.2 if scalar_scale else jnp.full((B,), 0.2, jnp.float32)
    tls = 0.2 if scalar_scale else torch.full((B,), 0.2)
    jres = jev.batched_event_solves(
        jstates, *(jnp.asarray(stacked[0]), JCAM),
        *(jnp.asarray(a) for a in stacked[1:]), max_iterations=8,
        loss_scale=jls)
    frames, args = _t(stacked[0]), [_t(a) for a in stacked[1:]]
    with no_host_reads():
        tres = tev.batched_event_solves(tstates, frames, TCAM, *args,
                                        max_iterations=8, loss_scale=tls)
    assert isinstance(tres, tet.TrackerResult)
    assert tres.state.px.shape == (B, 3) and tres.residuals.shape == (B, 128)
    for b in range(B):
        single = tet.optimize(tet.initial_tracker_state("cpu"),
                              _t(probs[b][0]), TCAM,
                              *(_t(probs[b][i]) for i in range(1, 6)),
                              max_iterations=8, loss_scale=0.2)
        lane = _lane(tres, b)
        assert int(lane.n_iter) == int(single.n_iter)
        for name in ("px", "qx", "vx"):
            np.testing.assert_allclose(getattr(lane.state, name).numpy(),
                                       getattr(single.state, name).numpy(),
                                       atol=2e-4, err_msg=name)
        np.testing.assert_allclose(float(lane.energy), float(single.energy),
                                   rtol=1e-3)
        np.testing.assert_allclose(tres.state.px[b].numpy(),
                                   np.asarray(jres.state.px[b]), atol=2e-4)
        np.testing.assert_allclose(tres.state.qx[b].numpy(),
                                   np.asarray(jres.state.qx[b]), atol=2e-4)
        np.testing.assert_allclose(float(tres.energy[b]),
                                   float(jres.energy[b]), rtol=1e-3)


def tck_leaves(tree):
    from slam_eds_tpu_torch.checkpoint import _leaves
    return _leaves(tree)


def _lane(tree, b):
    return tev._lane(tree, b)


def _ba_lane(seed):
    """One well-conditioned window (``torch_world``) as numpy fields."""
    d = world_arrays(seed)
    imgs = d.pop("images")
    return d, imgs


def test_batched_ba_windows():
    B = 2
    lanes = [_ba_lane(seed) for seed in (11, 12)]
    F, P = lanes[0][0]["frame_valid"].shape[0], lanes[0][0]["p_host"].shape[0]
    calib = [FX, FY, CX, CY]

    def jstate(d):
        st = jbs.empty_state(F, P, jnp.asarray(calib, jnp.float32))
        fields = {k: jnp.asarray(v) for k, v in d.items()
                  if not k.startswith("T_eval")}
        return st._replace(T_eval=JSE3(jnp.asarray(d["T_eval.R"]),
                                       jnp.asarray(d["T_eval.t"])), **fields)

    def tstate(d):
        st = tbs.empty_state(F, P, calib, device="cpu")
        fields = {k: _t(v) for k, v in d.items()
                  if not k.startswith("T_eval")}
        return st._replace(T_eval=TSE3(_t(d["T_eval.R"]), _t(d["T_eval.t"])),
                           **fields)

    jstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[jstate(d) for d, _ in lanes])
    tlanes = [tstate(d) for d, _ in lanes]
    tstates = tev._stack(tlanes)
    imgs = np.stack([im for _, im in lanes])
    jout, je = jev.batched_ba_windows(jstates, jnp.asarray(imgs), H, W,
                                      iterations=4)
    timgs = _t(imgs)
    # the warm-up, as on the card: per-device constants are uploaded once
    ten.linearize(tlanes[0], timgs[0], H, W)
    with no_host_reads():
        tout, te = tev.batched_ba_windows(tstates, timgs, H, W, iterations=4)
    assert te.shape == (B,) and tout.delta.shape == (B, F, 8)
    for b in range(B):
        st, e, _ = ten.ba_iterate(tlanes[b], _t(imgs[b]), H, W, iterations=4)
        np.testing.assert_allclose(tout.delta[b].numpy(), st.delta.numpy(),
                                   atol=2e-5)
        np.testing.assert_allclose(tout.p_idepth[b].numpy(),
                                   st.p_idepth.numpy(), atol=2e-4)
        np.testing.assert_allclose(float(te[b]), float(e), rtol=2e-5)
        np.testing.assert_allclose(float(te[b]), float(je[b]), rtol=1e-4)
        np.testing.assert_allclose(tout.p_idepth[b].numpy(),
                                   np.asarray(jout.p_idepth[b]), rtol=2e-3,
                                   atol=2e-4)
        np.testing.assert_allclose(tout.delta[b].numpy(),
                                   np.asarray(jout.delta[b]), atol=2e-3)
    # JAX's single solve of lane 0, for the record of what vmap changes
    s0, e0, _ = jen.ba_iterate(jstate(lanes[0][0]),
                               jnp.asarray(lanes[0][1]), H, W, iterations=4)
    np.testing.assert_allclose(float(te[0]), float(e0), rtol=1e-4)


# ---------------------------------------------------------------------------
# multi-sequence evaluation
# ---------------------------------------------------------------------------

EVAL_CFG = {
    "caps": {"max_points_per_kf": 256, "max_immature_per_kf": 256,
             "max_window_frames": 6, "max_events": 4096},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 300.0,
                 "desired_point_density": 200.0},
}


def test_evaluate_sequences_aggregates(tmp_path, capsys):
    for i, scale in enumerate([0.3, 0.4]):
        SyntheticSequence(TCAM, num_frames=8, events_per_packet=64,
                          motion_scale=scale, seed=i,
                          device="cpu").write_dataset(str(tmp_path / f"seq{i}"))
    (tmp_path / "notes").mkdir()                  # not a sequence: skipped
    assert tev._expand_sequence_dirs([str(tmp_path)]) == [
        str(tmp_path / "seq0"), str(tmp_path / "seq1")]
    assert tev._expand_sequence_dirs([str(tmp_path / "seq1")]) == [
        str(tmp_path / "seq1")]
    assert jev._expand_sequence_dirs([str(tmp_path)]) == \
        tev._expand_sequence_dirs([str(tmp_path)])
    report = tev.evaluate_sequences([str(tmp_path)], load_config(EVAL_CFG),
                                    frame_only=True, verbose=True,
                                    device="cpu")
    assert "[eval] sequence seq0" in capsys.readouterr().out
    assert report["num_sequences"] == 2
    assert sorted(report["sequences"]) == ["seq0", "seq1"]
    assert set(report) == {"sequences", "num_sequences", "wall_s",
                           "mean_ate_rmse", "median_ate_rmse",
                           "total_frames_per_s"}
    assert report["total_frames_per_s"] > 0
    ates = []
    for res in report["sequences"].values():
        assert res["frames"] == 8 and "positions" not in res
        assert np.isfinite(res["ate_rmse"]) and res["ate_rmse"] < 0.2
        assert np.isfinite(res["rpe_trans"])
        ates.append(res["ate_rmse"])
    assert report["mean_ate_rmse"] == pytest.approx(np.mean(ates))
    limited = tev.evaluate_sequences([str(tmp_path / "seq0")],
                                     load_config(EVAL_CFG), max_frames=5,
                                     frame_only=True, verbose=False,
                                     device="cpu")
    assert limited["sequences"]["seq0"]["frames"] == 5


# ---------------------------------------------------------------------------
# map export
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def window():
    """The ``torch_world`` window with a few slots emptied, marginalized
    and hosted by an invalid frame, in both packages."""
    d = world_arrays(11)
    imgs = d.pop("images")
    rng = np.random.default_rng(4)
    status = d["p_status"].copy()
    status[rng.choice(len(status), 40, replace=False)] = tbs.PT_EMPTY
    status[rng.choice(len(status), 30, replace=False)] = tbs.PT_MARGINALIZE
    d["p_status"] = status
    d["frame_valid"] = np.array([True, True, False, True])
    d["c_delta"] = np.float32([0.5, -0.5, 0.1, 0.2])
    F, P = 4, len(status)
    calib = [FX, FY, CX, CY]
    sj = jbs.empty_state(F, P, jnp.asarray(calib, jnp.float32))._replace(
        T_eval=JSE3(jnp.asarray(d["T_eval.R"]), jnp.asarray(d["T_eval.t"])),
        **{k: jnp.asarray(v) for k, v in d.items()
           if not k.startswith("T_eval")})
    st = tbs.from_numpy(
        {**tbs.to_numpy(tbs.empty_state(F, P, calib, device="cpu")), **d},
        device="cpu")
    return sj, st, imgs


def test_backproject_window(window):
    sj, st, _ = window
    xj, vj = jom._backproject_window(sj)
    xt, vt = tom._backproject_window(st)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert 0 < vt.sum() < len(vt)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)


def test_radius_outlier_removal(window):
    sj, st, _ = window
    xj, vj = jom._backproject_window(sj)
    for nb, radius in ((3, 0.25), (8, 0.1), (1, 0.5)):
        kj = np.asarray(jom.radius_outlier_removal(xj, vj, nb, radius))
        kt = tom.radius_outlier_removal(_t(xj), _t(vj), nb, radius).numpy()
        # a pair whose distance sits on the radius may fall either way
        assert (kt != kj).sum() <= 1, (nb, radius)
    kt = tom.radius_outlier_removal(_t(xj), _t(vj), 3, 0.25).numpy()
    assert 0 < kt.sum() < np.asarray(vj).sum()
    assert not kt[~np.asarray(vj)].any()


@pytest.mark.parametrize("mode,sor", (("image", None), ("depth", None),
                                      ("image", (3, 0.25))))
def test_get_map_and_ply_bytes(window, tmp_path, mode, sor):
    sj, st, imgs = window
    cj = jom.get_map(sj, imgs, color_mode=mode, sor=sor)
    ct = tom.get_map(st, _t(imgs), color_mode=mode, sor=sor)
    assert isinstance(ct, tom.PointCloud) and ct.color.dtype == np.uint8
    np.testing.assert_array_equal(ct.color, cj.color)
    # the same cloud through both writers: bytes equal
    same = tom.PointCloud(cj.xyz, cj.color, cj.valid)
    nj = jom.write_ply(str(tmp_path / "j.ply"), cj)
    nt = tom.write_ply(str(tmp_path / "t.ply"), same)
    assert nt == nj == int(cj.valid.sum())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    # the port's own cloud: the same points to the PLY's 1e-6 precision
    n = tom.write_ply(str(tmp_path / "own.ply"), ct)
    if sor is None:
        assert n == nj
        np.testing.assert_allclose(ct.xyz[ct.valid], cj.xyz[cj.valid],
                                   atol=1e-5)
    lines = (tmp_path / "own.ply").read_text().splitlines()
    assert lines[2] == f"element vertex {n}" and len(lines) == 10 + n


def test_write_trajectory_tum_bytes(tmp_path):
    rng = np.random.default_rng(8)
    taus = rng.uniform(-0.5, 0.5, (9, 6)).astype(np.float32)
    times = np.arange(9) * 0.04 + 1.5
    Tt = TSE3.exp(_t(taus))
    Tj = JSE3(jnp.asarray(Tt.R.numpy()), jnp.asarray(Tt.t.numpy()))
    nj = jom.write_trajectory_tum(str(tmp_path / "j.txt"), times, Tj)
    nt = tom.write_trajectory_tum(str(tmp_path / "t.txt"), times, Tt)
    assert nt == nj == 9
    a = np.loadtxt(tmp_path / "t.txt")
    b = np.loadtxt(tmp_path / "j.txt")
    assert a.shape == (9, 8)
    np.testing.assert_allclose(a, b, atol=2e-6)      # 1e-6 text quantum
    assert (tmp_path / "t.txt").read_text().splitlines()[0].split()[0] == \
        (tmp_path / "j.txt").read_text().splitlines()[0].split()[0]


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------

def _viz_inputs():
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (16, 20)).astype(np.float32)
    uv = np.stack([rng.uniform(-1, 21, 12), rng.uniform(-1, 17, 12)], -1)
    ef = (rng.normal(size=(16, 20)) * 0.1).astype(np.float32)
    return dict(img=img, uv=uv, ef=ef, idp=rng.uniform(0.2, 2.0, 12),
                res=rng.normal(size=12), w=rng.uniform(0, 1, 12),
                valid=rng.uniform(size=12) > 0.2)


VIZ_CASES = {
    "apply_colormap": lambda v, i: v.apply_colormap(i["ef"], v.JET),
    "apply_colormap_range": lambda v, i: v.apply_colormap(
        i["ef"], v.GREEN, vmin=-0.05, vmax=0.05),
    "gray_to_rgb": lambda v, i: v.gray_to_rgb(i["img"]),
    "event_frame_viz": lambda v, i: v.event_frame_viz(i["ef"]),
    "idepth_map_viz": lambda v, i: v.idepth_map_viz(i["img"], i["uv"],
                                                    i["idp"], i["valid"]),
    "weights_viz": lambda v, i: v.weights_viz(i["img"], i["uv"], i["w"]),
    "residuals_viz": lambda v, i: v.residuals_viz(i["img"], i["uv"],
                                                  i["res"], i["valid"]),
    "events_on_keyframe_viz": lambda v, i: v.events_on_keyframe_viz(
        i["img"], i["ef"], threshold=0.02),
}


@pytest.mark.parametrize("name", sorted(VIZ_CASES))
def test_viz_functions_equal_jax(name):
    got = VIZ_CASES[name](tviz, _viz_inputs())
    want = VIZ_CASES[name](jviz, _viz_inputs())
    assert got.dtype == np.uint8 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


def test_viz_luts_and_recorder_save(tmp_path):
    for lut in ("BLUE_WHITE_RED", "JET", "GREEN"):
        np.testing.assert_array_equal(getattr(tviz, lut), getattr(jviz, lut))
    rec = Recorder(RecorderConfig(enabled=True,
                                  output_folder=str(tmp_path / "out")))
    img = tviz.event_frame_viz(_viz_inputs()["ef"])
    path = rec.save_viz("event_frame", img)
    rec.close()
    np.testing.assert_array_equal(read_png(path), img)
