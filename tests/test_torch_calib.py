"""The port's cameras and calibration against the JAX package, on the CPU.

* Distortion models: normalized coordinates within 1e-6 relative.
  ``undistortion_maps`` / ``forward_maps`` of the three models with
  non-zero coefficients at 128x96: within 1e-5 px plus two float32 ulps of
  the map's largest coordinate (``_assert_map_close``: 3e-5 px for a
  128-px map, 8e-5 px for the 327-px equidistant map; the two libraries'
  atan, tan and divisions round an ulp apart, and ``fx * x + cx`` carries
  that ulp of its largest term). ``remap`` of one image through the same
  maps within 1e-5 per gray level plus two ulps of 255, and NaN where JAX
  gives NaN.
* ``gamma_inverse_table`` (``jnp.interp`` formula for formula),
  ``optimal_k_crop``, ``to_dso_format`` and the pinhole helpers: bitwise
  or exact strings; ``project`` / ``backproject`` within 1e-6 relative.
* The calib reader equals ``yaml.safe_load`` on every calib file the JAX
  tests and ``write_dataset`` write, on PyYAML's own dumps of the dual-rig
  dict of ``test_viz_io.py`` and on a kalibr camchain; what it does not
  read raises ``ValueError``.
* ``read_dual_calibration`` / ``common_view_camera`` / ``dual_mappings``,
  ``PhotometricCalib.correct`` / ``b_grad_table``: equal to JAX's (maps
  within the map bound above).
* The selector weighting of ``test_photometric_gamma.py``: the same
  immature points as the JAX window, and the table carried through the
  pipeline's window re-creations.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from slam_eds_tpu.config import load_config as jload
from slam_eds_tpu.io.dataset import SyntheticSequence as JSequence
from slam_eds_tpu.models.window import WindowManager as JWindow
from slam_eds_tpu.utils import calib as jcal
from slam_eds_tpu.utils import cameras as jc
from slam_eds_tpu.utils.lie import SE3 as JSE3

from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.io.dataset import SyntheticSequence as TSequence
from slam_eds_tpu_torch.models.pipeline import FrameOnlyPipeline
from slam_eds_tpu_torch.models.window import WindowManager as TWindow
from slam_eds_tpu_torch.utils import calib as tcal
from slam_eds_tpu_torch.utils import cameras as tc
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3

torch.set_num_threads(1)

W, H = 128, 96
JPIN = jc.Pinhole(jnp.float32(110.0), jnp.float32(108.0), jnp.float32(63.5),
                  jnp.float32(47.5), W, H)
TPIN = tc.Pinhole(110.0, 108.0, 63.5, 47.5, W, H)
MODELS = {"radtan5": ("radtan", [-0.28, 0.07, 2e-4, 1.8e-5, 0.01]),
          "radtan4": ("radtan", [-0.2, 0.05, 1e-3, -5e-4]),
          "kb": ("kb", [0.1, -0.02, 0.003, -0.0005]),
          "equidistant": ("equidistant", [-0.05, 0.01, 0.0, 0.0]),
          "fov": ("fov", [0.9])}


def _assert_map_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    ulps2 = 2.4e-7 * float(np.nanmax(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 + ulps2)


def _models(name):
    model, D = MODELS[name]
    return (jc.CameraModel(JPIN, jnp.asarray(D, jnp.float32), model),
            tc.CameraModel(TPIN, torch.tensor(D, dtype=torch.float32), model))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_distortion_round_trip_matches_jax(name, rng):
    jm, tm = _models(name)
    xy = rng.uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
    model = tm.model
    for fn in (tc._DISTORT[model], tc._UNDISTORT[model]):
        got = fn(torch.as_tensor(xy), tm.D).numpy()
        want = np.asarray(getattr(jc, fn.__name__)(jnp.asarray(xy), jm.D))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the inverse undoes the model (the fixed-count loops converge here)
    back = tc._UNDISTORT[model](tc._DISTORT[model](torch.as_tensor(xy), tm.D),
                                tm.D).numpy()
    np.testing.assert_allclose(back, xy, atol=2e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_maps_and_remap_match_jax(name, rng):
    jm, tm = _models(name)
    for fn in ("undistortion_maps", "forward_maps"):
        got = getattr(tc, fn)(tm)
        want = getattr(jc, fn)(jm)
        for g, w in zip(got, want):
            assert g.shape == (H, W) and g.dtype == torch.float32
            _assert_map_close(g.numpy(), w)
    mx, my = tc.undistortion_maps(tm)
    mx[0, 0], my[3, 5] = float("nan"), float("inf")
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    got = tc.remap(torch.as_tensor(img), mx, my).numpy()
    want = np.asarray(jc.remap(jnp.asarray(img), jnp.asarray(mx.numpy()),
                               jnp.asarray(my.numpy())))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 0]) and np.isnan(got[3, 5])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 + 2.4e-7 * 255)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_optimal_k_crop_and_dso_format_match_jax(name):
    jm, tm = _models(name)
    got, want = tc.optimal_k_crop(tm, 100, 80), jc.optimal_k_crop(jm, 100, 80)
    assert tuple(got) == tuple(float(v) if i < 4 else v
                               for i, v in enumerate(want))
    assert tcal.to_dso_format(tm, got) == jcal.to_dso_format(jm, want)


def test_pinhole_helpers_match_jax(rng):
    uv = rng.uniform(0, 120, (50, 2)).astype(np.float32)
    idp = rng.uniform(0.2, 2.0, 50).astype(np.float32)
    xyz = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    xyz[:, 2] += 3.0
    for got, want in (
            (tc.project(TPIN, torch.as_tensor(xyz)), jc.project(JPIN, xyz)),
            (tc.backproject(TPIN, torch.as_tensor(uv), torch.as_tensor(idp)),
             jc.backproject(JPIN, uv, idp)),
            (tc.normalized_coords(TPIN, torch.as_tensor(uv)),
             jc.normalized_coords(JPIN, uv))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    assert tuple(TPIN.scaled(64, 48)) == tuple(
        float(v) if i < 4 else v for i, v in enumerate(JPIN.scaled(64, 48)))


@pytest.mark.parametrize("power", [1.0, 2.2, 0.45])
def test_gamma_tables_and_correct_match_jax(power, rng):
    g = 255.0 * (np.arange(256) / 255.0) ** (1.0 / power)
    vig = rng.uniform(0.3, 1.0, (H, W)).astype(np.float32)
    jp, tp = (mod.PhotometricCalib.from_files(g, vig) for mod in (jcal, tcal))
    for a, b in ((tp.B, jp.B), (tp.Binv, jp.Binv),
                 (tp.vignette_inv, jp.vignette_inv),
                 (tp.b_grad_table(), jp.b_grad_table())):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    raw = rng.integers(0, 256, (H, W)).astype(np.int32)
    raw[0, :3] = [-4, 300, 255]                   # clipped to [0, 255]
    np.testing.assert_array_equal(tp.correct(raw).numpy(),
                                  np.asarray(jp.correct(raw)))
    # test_viz_io.py's identity response with a vignette
    gamma = np.arange(256, dtype=np.float32)
    v = np.full((4, 4), 0.5, np.float32)
    v[0, 0] = 1.0
    img = np.full((4, 4), 100, np.uint8)
    np.testing.assert_array_equal(
        tcal.PhotometricCalib.from_files(gamma, v).correct(img).numpy(),
        np.asarray(jcal.PhotometricCalib.from_files(gamma, v).correct(img)))


# ---------------------------------------------------------------------------
# calib.yaml
# ---------------------------------------------------------------------------

# test_runner.py's calib files (mono radtan, dual rig) and test_viz_io.py's
# dual-rig dict
RUNNER_MONO = ("cam0:\n"
               "  intrinsics: [110.0, 110.0, 63.5, 47.5]\n"
               f"  resolution: [{W}, {H}]\n"
               "  distortion_model: radtan\n"
               "  distortion_coeffs: [0, 0, 0, 0]\n")
RUNNER_DUAL = (RUNNER_MONO
               + "cam1:\n"
               "  intrinsics: [110.0, 110.0, 63.5, 47.5]\n"
               f"  resolution: [{W}, {H}]\n"
               "  distortion_model: none\n"
               "  T_cn_cnm1: [[1, 0, 0, 0], [0, 1, 0, 0],\n"
               "              [0, 0, 1, 0], [0, 0, 0, 1]]\n")
DUAL_YAML = {
    "cam0": {"resolution": [640, 480], "distortion_model": "radial-tangential",
             "intrinsics": [400.0, 402.0, 320.0, 240.0],
             "distortion_coeffs": [-0.1, 0.01, 0.0, 0.0]},
    "cam1": {"resolution": [320, 240], "distortion_model": "radial-tangential",
             "intrinsics": [200.0, 201.0, 160.0, 120.0],
             "distortion_coeffs": [-0.05, 0.005, 0.0, 0.0],
             "T_cn_cnm1": [[1, 0, 0, 0.01], [0, 1, 0, 0], [0, 0, 1, 0],
                           [0, 0, 0, 1]]},
}
KALIBR = """%YAML 1.1
---
# kalibr camchain, block sequences and comments
cam0:
  T_cam_imu:
  - [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975]
  - [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768]
  - [0.0, 0.0, 0.0, 1.0]
  cam_overlaps: [1]
  camera_model: pinhole
  distortion_coeffs: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
  distortion_model: radtan   # Brown-Conrady
  intrinsics: [458.654, 457.296, 367.215, 248.375]
  resolution: [752, 480]
  rostopic: /cam0/image_raw
  timeshift_cam_imu: -1.0e-3
  label: 'a # not a comment'
  note: "tab\\there"
  flip: no
  gain: 1e-5
  octal: 010
  hex: 0x1F
  low: -.inf
  unset:
cam1:
  T_cn_cnm1:
  - - 1
    - 0
  - [0, 1]
  resolution: [346, 260]
"""


def _calib_texts(tmp_path):
    texts = {"runner_mono": RUNNER_MONO, "runner_dual": RUNNER_DUAL,
             "viz_dual_block": yaml.safe_dump(DUAL_YAML),
             "viz_dual_flow": yaml.safe_dump(DUAL_YAML,
                                             default_flow_style=None),
             "kalibr": KALIBR, "empty": "", "comment_only": "# nothing\n"}
    jseq = JSequence(jc.Pinhole(jnp.float32(110.0), jnp.float32(110.0),
                                jnp.float32(63.5), jnp.float32(47.5), W, H),
                     num_frames=2)
    tseq = TSequence(tc.Pinhole(110.0, 110.0, 63.5, 47.5, W, H),
                     num_frames=2, device="cpu")
    for name, seq in (("jax_write_dataset", jseq),
                      ("port_write_dataset", tseq)):
        d = str(tmp_path / name)
        seq.write_dataset(d, events=False)
        texts[name] = open(f"{d}/calib.yaml").read()
    return texts


def test_calib_reader_equals_safe_load(tmp_path):
    texts = _calib_texts(tmp_path)
    assert texts["jax_write_dataset"] == texts["port_write_dataset"]
    for name, text in texts.items():
        assert tcal.read_yaml(text) == yaml.safe_load(text), name


@pytest.mark.parametrize("text", [
    yaml.safe_dump(DUAL_YAML, default_flow_style=True),   # flow mappings
    "a: &anchor 1\n", "a: |\n  block text\n", "a:\n- b: 1\n",
    "a: [1, 2\n", "a: 1\n  b: 2\n"])
def test_calib_reader_rejects_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        tcal.read_yaml(text)


def test_dual_rig_matches_jax(tmp_path):
    path = tmp_path / "calib.yaml"
    path.write_text(yaml.safe_dump(DUAL_YAML))
    tdual = tcal.read_dual_calibration(str(path))
    jdual = jcal.read_dual_calibration(DUAL_YAML)
    for cam in ("cam0", "cam1"):
        a, b = getattr(tdual, cam), getattr(jdual, cam)
        assert (a.width, a.height, a.distortion_model, a.intrinsics, a.D) \
            == (b.width, b.height, b.distortion_model, b.intrinsics, b.D)
    assert tdual.T_cam0_cam1 == jdual.T_cam0_cam1
    tout, jout = tcal.common_view_camera(tdual), jcal.common_view_camera(jdual)
    assert tuple(tout) == tuple(float(v) if i < 4 else v
                                for i, v in enumerate(jout))
    tm = tcal.dual_mappings(tdual, device="cpu")
    jm = jcal.dual_mappings(jdual)
    for key in ("frame_map_x", "frame_map_y", "event_fwd_x", "event_fwd_y"):
        _assert_map_close(tm[key].numpy(), jm[key])
    info = tcal.read_camera_calib(str(path), "cam1")
    assert info.to_model(device="cpu").model == "radtan"
    assert tcal.to_dso_format(info.to_model(device="cpu")) == \
        jcal.to_dso_format(jcal.read_camera_calib(DUAL_YAML, "cam1")
                           .to_model())


# ---------------------------------------------------------------------------
# The photometric table in the pixel selector and the pipeline
# ---------------------------------------------------------------------------

def _gamma_table(power=2.2):
    g = 255.0 * (np.arange(256, dtype=np.float64) / 255.0) ** (1.0 / power)
    return tcal.PhotometricCalib.from_files(g), \
        jcal.PhotometricCalib.from_files(g)


def test_selector_weighting_matches_jax(rng):
    """test_photometric_gamma.py's case: the gamma-weighted selection picks
    the JAX window's immature points, and differs from the unweighted
    one."""
    w, h = 64, 48
    cfg = {"caps": {"max_points_per_kf": 128, "max_immature_per_kf": 128,
                    "max_window_frames": 3},
           "coarse": {"pyr_levels": 3, "max_iterations": [4, 4, 4]},
           "selector": {"desired_immature_density": 120.0}}
    jcam = jc.Pinhole(jnp.float32(40.0), jnp.float32(40.0),
                      jnp.float32(w / 2 - 0.5), jnp.float32(h / 2 - 0.5), w, h)
    tcam = tc.Pinhole(40.0, 40.0, w / 2 - 0.5, h / 2 - 0.5, w, h)
    tcal_, jcal_ = _gamma_table()
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    masks = {}
    for bgrad in (None, "gamma"):
        jw = JWindow(jcam, jload(cfg), photometric_bgrad=None if bgrad is None
                     else jcal_.b_grad_table())
        tw = TWindow(tcam, load_config(cfg), device="cpu",
                     photometric_bgrad=None if bgrad is None
                     else tcal_.b_grad_table())
        jw.insert_frame(jnp.asarray(img), JSE3.identity(), 0.0)
        tw.insert_frame(img, TSE3.identity(device="cpu"), 0.0)
        ji, ti = jw.immatures[jw.newest_slot], tw.immatures[tw.newest_slot]
        np.testing.assert_array_equal(ti.mask.numpy(), np.asarray(ji.mask))
        np.testing.assert_array_equal(ti.uv.numpy(), np.asarray(ji.uv))
        assert int(ti.mask.sum()) > 10
        masks[bgrad] = ti.uv.numpy()[ti.mask.numpy()]
    assert masks[None].shape != masks["gamma"].shape or \
        not np.array_equal(masks[None], masks["gamma"])


def test_pipeline_carries_the_photometric_table():
    """The window gets the calib's table, and keeps it when the pipeline
    re-creates it (a full reset)."""
    tcal_, _ = _gamma_table()
    pipe = FrameOnlyPipeline(TPIN, load_config({}), device="cpu",
                             photometric=tcal_)
    np.testing.assert_array_equal(pipe.window.photometric_bgrad,
                                  tcal_.b_grad_table())
    pipe._full_reset()
    np.testing.assert_array_equal(pipe.window.photometric_bgrad,
                                  tcal_.b_grad_table())
