"""Parity of the port's event rasterization with the JAX package on the CPU:
the raster kernel's plain version (``rasterize_bilinear_reference``, what a
CPU tensor takes) against the Pallas kernel in interpret mode and against the
XLA ``segment_sum`` path, the nearest-pixel scatter, time weights, event
frames at 2 and 3 levels, the median event time and undistortion. Inputs are
made with numpy from a seed and fed to both sides.

Tolerances: rasters atol 1e-5 (float sums in another order); event frames
and norms rtol 1e-5 with an absolute floor of 1e-6 of the frame's largest
value (the blur and the normalization add float rounding). On the card the
kernel accumulates in 64-bit fixed point, about 1e-7 relative from a float
raster: far inside these tolerances, and checked against the plain version
in ``test_torch_kernels_cuda.py``. Coordinates are finite: for a NaN
coordinate the two JAX forms disagree with each other, and the port drops
the event.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.ops.pallas.raster import rasterize_bilinear as j_raster
from slam_eds_tpu.utils import events as jev

from slam_eds_tpu_torch.ops.kernels import rasterize as tr
from slam_eds_tpu_torch.utils import events as tev

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.asarray(a))


def _events(kind, rng, h, w):
    if kind == "ragged_700":
        n = 700
        xs = rng.uniform(-2, w + 2, n)
        ys = rng.uniform(-2, h + 2, n)
        vals = rng.choice([-1.0, 1.0], n)
    elif kind == "border_taps":
        xs = np.array([w - 1 + 0.75, -0.25, 0.0, w - 1.0, -1.0, w - 0.5, 3.5])
        ys = np.array([3.5, 3.5, 0.0, h - 1.0, 2.0, h - 1.25, -0.5])
        vals = np.array([1.0, 1.0, -1.0, 0.5, 1.0, -1.0, 1.0])
    elif kind == "huge_and_pad":
        xs = np.array([1e10, -1e10, -1e6, 5.5, 1e10, 3.25, -1e6, 7.0])
        ys = np.array([2.0, 3.0, -1e6, 1e10, -1e10, 4.75, 6.0, 7.0])
        vals = np.array([1.0, -1.0, 1.0, 1.0, 1.0, -1.0, 1.0, 2.0])
    elif kind == "all_zero_values":
        xs = rng.uniform(0, w - 1, 64)
        ys = rng.uniform(0, h - 1, 64)
        vals = np.zeros(64)
    else:   # integer and fractional coordinates, repeats at one pixel
        xs = np.concatenate([rng.integers(0, w, 300), rng.uniform(0, w, 300),
                             np.full(20, 9.0)])
        ys = np.concatenate([rng.integers(0, h, 300), rng.uniform(0, h, 300),
                             np.full(20, 11.0)])
        vals = rng.choice([-1.0, 1.0], 620) * rng.uniform(0.1, 1.0, 620)
    return [np.asarray(a, np.float32) for a in (xs, ys, vals)]


@pytest.mark.parametrize("kind", ["ragged_700", "border_taps", "huge_and_pad",
                                  "all_zero_values", "int_and_frac"])
def test_raster_plain_matches_pallas_and_segment_sum(kind):
    rng = np.random.default_rng(len(kind))
    h, w = 48, 64
    xs, ys, vals = _events(kind, rng, h, w)
    got = tr.rasterize_bilinear_reference(T(xs), T(ys), T(vals), h, w).numpy()
    pallas = np.asarray(j_raster(jnp.asarray(xs), jnp.asarray(ys),
                                 jnp.asarray(vals), h, w, chunk=256,
                                 interpret=True))
    seg = np.asarray(jev.scatter_accumulate(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(vals), h, w,
        use_pallas=False))
    assert got.shape == (h, w) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, seg, rtol=0, atol=1e-5)
    if kind == "all_zero_values":
        assert np.all(got == 0)
    else:
        assert np.abs(got).sum() > 0
    # the dispatching wrapper takes the plain version for a CPU tensor
    before = tr.rasterize_bilinear.launches
    np.testing.assert_array_equal(
        tr.rasterize_bilinear(T(xs), T(ys), T(vals), h, w).numpy(), got)
    assert tr.rasterize_bilinear.launches == before


def test_raster_drops_nonfinite_coordinates():
    xs = np.array([np.nan, 3.5, np.inf, 2.0, -np.inf], np.float32)
    ys = np.array([1.0, np.nan, 2.0, 2.5, 1.0], np.float32)
    vals = np.ones(5, np.float32)
    got = tr.rasterize_bilinear_reference(T(xs), T(ys), T(vals), 8, 8).numpy()
    want = tr.rasterize_bilinear_reference(T(xs[3:4]), T(ys[3:4]),
                                           T(vals[3:4]), 8, 8).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["bilinear", "nn"])
def test_scatter_accumulate_with_mask(method):
    rng = np.random.default_rng(5)
    h, w, n = 40, 56, 900
    xs = rng.uniform(-3, w + 3, n).astype(np.float32)
    ys = rng.uniform(-3, h + 3, n).astype(np.float32)
    xs[:50] = np.round(xs[:50]) + 0.5          # round-half-to-even cases
    vals = rng.choice([-1.0, 1.0], n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    want = np.asarray(jev.scatter_accumulate(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(vals), h, w,
        mask=jnp.asarray(mask), method=method, use_pallas=False))
    got = tev.scatter_accumulate(T(xs), T(ys), T(vals), h, w, mask=T(mask),
                                 method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_valid", [0, 1, 777, 4096])
def test_event_time_weights(n_valid):
    want = np.asarray(jev.event_time_weights(jnp.asarray(n_valid), 4096))
    got = tev.event_time_weights(n_valid, 4096, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _packet(rng, cap, n_valid, h, w):
    xs = np.zeros(cap, np.float32)
    ys = np.zeros(cap, np.float32)
    ps = np.zeros(cap, np.float32)
    ts = np.zeros(cap, np.float32)
    xs[:n_valid] = rng.integers(0, w, n_valid)
    ys[:n_valid] = rng.integers(0, h, n_valid)
    xs[: n_valid // 3] += rng.uniform(0, 1, n_valid // 3).astype(np.float32)
    ps[:n_valid] = rng.choice([-1.0, 1.0], n_valid)
    ts[:n_valid] = np.sort(rng.uniform(0.1, 0.2, n_valid))
    return xs, ys, ts, ps


@pytest.mark.parametrize("levels,time_weighted,interp", [
    (2, True, "bilinear"), (3, True, "bilinear"), (3, False, "nn")])
def test_build_event_frame(levels, time_weighted, interp):
    rng = np.random.default_rng(levels)
    h, w, cap, n_valid = 48, 64, 2048, 1500
    xs, ys, _, ps = _packet(rng, cap, n_valid, h, w)
    jf, jn = jev.build_event_frame(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ps),
        jnp.asarray(n_valid), h, w, num_levels=levels,
        use_time_weights=time_weighted, interpolation=interp)
    tf, tn = tev.build_event_frame(T(xs), T(ys), T(ps), n_valid, h, w,
                                   num_levels=levels,
                                   use_time_weights=time_weighted,
                                   interpolation=interp)
    jf, jn = np.asarray(jf), np.asarray(jn)
    assert tf.shape == (levels, h, w)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5,
                               atol=1e-6 * np.abs(jf).max())


@pytest.mark.parametrize("n_valid", [0, 1, 2, 9, 1000])
def test_median_event_time(n_valid):
    ts = np.sort(np.random.default_rng(n_valid).uniform(0, 1, 1024)).astype(
        np.float32)
    want = float(jev.median_event_time(jnp.asarray(ts), jnp.asarray(n_valid)))
    assert float(tev.median_event_time(T(ts), n_valid)) == want


def test_undistort_events():
    rng = np.random.default_rng(11)
    h, w = 30, 40
    mx = rng.uniform(0, w, (h, w)).astype(np.float32)
    my = rng.uniform(0, h, (h, w)).astype(np.float32)
    xs = np.concatenate([rng.uniform(-3, w + 3, 200),
                         [0.5, 1.5, 2.5, w - 0.5]]).astype(np.float32)
    ys = np.concatenate([rng.uniform(-3, h + 3, 200),
                         [0.5, 1.5, h + 9.0, -9.0]]).astype(np.float32)
    jx, jy = jev.undistort_events(jnp.asarray(xs), jnp.asarray(ys),
                                  jnp.asarray(mx), jnp.asarray(my))
    tx, ty = tev.undistort_events(T(xs), T(ys), T(mx), T(my))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_create_event_frame_metadata():
    from slam_eds_tpu.models.event_frame import create_event_frame as jcreate
    from slam_eds_tpu_torch.models.event_frame import create_event_frame
    rng = np.random.default_rng(2)
    h, w, cap, n_valid = 32, 48, 512, 301
    xs, ys, ts, ps = _packet(rng, cap, n_valid, h, w)
    j = jcreate(*(jnp.asarray(a) for a in (xs, ys, ts, ps)),
                jnp.asarray(n_valid), h, w, num_levels=2)
    t = create_event_frame(*(T(a) for a in (xs, ys, ts, ps)), n_valid, h, w,
                           num_levels=2)
    for name in ("time", "first_time", "last_time", "delta_time", "n_events",
                 "T_w_ef_R", "T_w_ef_t"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t.frames.numpy(), np.asarray(j.frames),
                               rtol=1e-5,
                               atol=1e-6 * float(np.abs(j.frames).max()))
