"""Small names of the JAX package that the port lacked, each against its
JAX counterpart on the same seeded numpy inputs (float32: within 1e-5
unless a case says otherwise), and the port's telemetry counters."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu import telemetry as jtel
from slam_eds_tpu.io import dataset as jds
from slam_eds_tpu.io import event_buffer as jeb
from slam_eds_tpu.ops import distance_map as jdm
from slam_eds_tpu.utils import image as jim
from slam_eds_tpu.utils import lie as jlie

from slam_eds_tpu_torch import telemetry as ttel
from slam_eds_tpu_torch.io import dataset as tds
from slam_eds_tpu_torch.io import event_buffer as teb
from slam_eds_tpu_torch.ops import distance_map as tdm
from slam_eds_tpu_torch.utils import image as tim
from slam_eds_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)
RNG_SEED = 17


def _t(a):
    return torch.as_tensor(np.array(a))


def _rng():
    return np.random.default_rng(RNG_SEED)


def case_sample_distance():
    rng = _rng()
    dist = rng.uniform(0, 40, (24, 32)).astype(np.float32)
    uv = np.stack([rng.uniform(-3, 35, 50), rng.uniform(-3, 27, 50)],
                  -1).astype(np.float32)
    return (tdm.sample_distance(_t(dist), _t(uv)),
            jdm.sample_distance(jnp.asarray(dist), jnp.asarray(uv)), 0.0)


def _taus(n=5):
    return _rng().uniform(-0.6, 0.6, (n, 6)).astype(np.float32)


def case_se3_matrix():
    tau = _taus()
    got = tlie.SE3.exp(_t(tau)).matrix()
    want = jax.vmap(lambda x: jlie.SE3.exp(x).matrix())(jnp.asarray(tau))
    assert got.shape == (5, 4, 4)
    return got, want, 1e-6


def case_se3_from_matrix():
    M = np.asarray(jax.vmap(lambda x: jlie.SE3.exp(x).matrix())(
        jnp.asarray(_taus())))
    got, want = tlie.SE3.from_matrix(_t(M)), jlie.SE3.from_matrix(
        jnp.asarray(M))
    return torch.cat([got.R.reshape(5, 9), got.t], 1), \
        np.concatenate([np.asarray(want.R).reshape(5, 9),
                        np.asarray(want.t)], 1), 0.0


def case_se3_matmul():
    a, b = _taus(1)[0], _taus(2)[1]
    got = tlie.SE3.exp(_t(a)) @ tlie.SE3.exp(_t(b))
    want = jlie.SE3.exp(jnp.asarray(a)) @ jlie.SE3.exp(jnp.asarray(b))
    with pytest.raises(TypeError):
        tlie.SE3.exp(_t(a)) @ _t(b)
    return torch.cat([got.R.reshape(9), got.t]), \
        np.concatenate([np.asarray(want.R).reshape(9), np.asarray(want.t)]), \
        1e-6


def case_vee():
    w = _rng().normal(size=3).astype(np.float32)
    got = tlie.vee(tlie.hat(_t(w)))
    assert torch.equal(got, _t(w))
    return got, jlie.vee(jlie.hat(jnp.asarray(w))), 0.0


def case_quat_rotate():
    rng = _rng()
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    got = tlie.quat_rotate(_t(q), _t(v))
    # the same as rotating by the matrix
    ref = (tlie.quat_to_mat(_t(q)) @ _t(v)[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    return got, jlie.quat_rotate(jnp.asarray(q), jnp.asarray(v)), 1e-6


def case_se3_mean():
    tau = _taus(7)
    return tlie.se3_mean(_t(tau)), jlie.se3_mean(jnp.asarray(tau)), 1e-6


def case_se3_mean_weighted():
    tau = _taus(7)
    w = _rng().uniform(0.1, 1.0, 7).astype(np.float32)
    return (tlie.se3_mean(_t(tau), _t(w)),
            jlie.se3_mean(jnp.asarray(tau), jnp.asarray(w)), 1e-6)


def _image_and_points():
    rng = _rng()
    img = rng.uniform(0, 255, (30, 40)).astype(np.float32)
    uv = np.stack([rng.uniform(0, 39, 20), rng.uniform(0, 29, 20)],
                  -1).astype(np.float32)
    return img, uv


def case_split_image_in_patches():
    img, uv = _image_and_points()
    got, ok = tim.split_image_in_patches(_t(img), _t(uv), 2)
    want, okj = jim.split_image_in_patches(jnp.asarray(img), jnp.asarray(uv), 2)
    assert got.shape == (20, 5, 5)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert 0 < ok.sum() < 20
    return got, want, 1e-4


def case_pyramid_patches():
    img, uv = _image_and_points()
    tp = tim.build_pyramid(_t(img), 3)[0]
    jp = jim.build_pyramid(jnp.asarray(img), 3)[0]
    got = tim.pyramid_patches([l[..., 0] for l in tp], _t(uv), 1)
    want = jim.pyramid_patches([l[..., 0] for l in jp], jnp.asarray(uv), 1)
    assert len(got) == 3
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return (torch.stack([g[0] for g in got]),
            np.stack([np.asarray(w[0]) for w in want]), 1e-4)


def case_compute_bundle_patches():
    img, uv = _image_and_points()
    got, ok = tim.compute_bundle_patches(_t(img), _t(uv))
    want, okj = jim.compute_bundle_patches(jnp.asarray(img), jnp.asarray(uv))
    assert got.shape == (20, 8)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    return got, want, 1e-4


CASES = {f.__name__[5:]: f for f in (
    case_sample_distance, case_se3_matrix, case_se3_from_matrix,
    case_se3_matmul, case_vee, case_quat_rotate, case_se3_mean,
    case_se3_mean_weighted, case_split_image_in_patches,
    case_pyramid_patches, case_compute_bundle_patches)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_small_helper_matches_jax(name):
    got, want, atol = CASES[name]()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=atol)


@pytest.mark.parametrize("route", ("native", "numpy"))
def test_apply_undistort(route, monkeypatch):
    """Both routes against the JAX package's numpy route, half-pixel
    coordinates (rounded away from zero) and out-of-map events included."""
    if route == "numpy":
        monkeypatch.setattr(teb, "_load", lambda: None)
    elif not teb.available():
        pytest.skip(f"host runtime not built: {teb.build_error()}")
    monkeypatch.setattr(jeb, "_load", lambda: None)
    rng = _rng()
    w, h = 12, 9
    mapx = rng.uniform(0, w, (h, w)).astype(np.float32)
    mapy = rng.uniform(0, h, (h, w)).astype(np.float32)
    xs = np.concatenate([rng.uniform(-2, w + 2, 60),
                         [0.5, 1.5, 2.5, -0.5, w - 0.5]]).astype(np.float32)
    ys = np.concatenate([rng.uniform(-2, h + 2, 60),
                         [0.5, 2.5, 3.5, 1.0, 1.0]]).astype(np.float32)
    gx, gy, wx, wy = xs.copy(), ys.copy(), xs.copy(), ys.copy()
    teb.apply_undistort(gx, gy, mapx, mapy, w, h)
    jeb.apply_undistort(wx, wy, mapx, mapy, w, h)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    assert (gx == -1).any() and (gx != -1).any()


def test_array_sequence():
    times = np.arange(4) * 0.1
    images = _rng().uniform(0, 255, (4, 6, 8)).astype(np.float32)
    packets = ["p0", "p1", "p2"]
    gt = np.zeros((4, 3))
    for mod in (tds, jds):
        seq = mod.ArraySequence(times, images, packets, gt_positions=gt)
        assert seq.num_frames == 4
        t, img, depth = seq.frame(2)
        assert t == pytest.approx(0.2) and depth is None
        np.testing.assert_array_equal(img, images[2])
        assert seq.events_between(1, 2) == "p1"
        assert seq.gt_positions() is gt
        assert mod.ArraySequence(times, images).events_between(0, 1) is None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_telemetry_timers_and_summary():
    """The counters the port keeps are the JAX package's for the same
    calls (the port keeps no timers, energies or ``track_failures``: its
    spans are ``telemetry.TRACE``'s, tests/test_torch_trace.py)."""
    got, want = ttel.Telemetry(), jtel.Telemetry()
    got.event_solve(n_iter=4)
    want.event_solve(n_iter=4, energy=1.5)
    got.ba()
    want.ba(energy=2.5)
    got.frame()
    got.frame()
    want.frame(ok=True)
    want.frame(ok=False)
    assert got.summary() == {k: v for k, v in want.counters.items()
                             if k != "track_failures"}
    assert got.summary() == {"event_solves": 1, "event_iters": 4,
                             "ba_runs": 1, "frames": 2}
    assert not hasattr(got, "sums") and not hasattr(ttel, "profile_trace")
