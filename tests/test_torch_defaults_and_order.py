"""The port on the card by default, the raster kernel's launch geometry, and
the order-free scatter-sums, on the CPU.

* Every public entry point of the port defaults to ``"cuda"``: without a
  card, building one (or running ``run_sequence``, before it reads a
  file) with no device raises (``resolve_device``); a caller asks for the
  CPU by name.
* ``launch_geometry``: every pixel of the frame is owned by exactly one
  block of one band, and a block's int64 slice fits the card's 232,448 B of
  shared memory, with clusters of 16 and of the portable 8, one cluster or
  as many bands as the card holds clusters at once.
* ``order_free_index_add`` and ``splat_idepth``: the sum does not depend on
  the order of the terms (bitwise under a permutation), is the float64 sum
  rounded once (within one float32 ulp: each term is exact up to 2^-32),
  equals the float ``index_add_`` it replaces within rtol 1e-6 (that sum
  rounds at each of its terms), and ``splat_idepth`` equals the JAX
  package's ``segment_sum`` form within the coarse-template test's rtol
  1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.ops import coarse_tracker as jct

from slam_eds_tpu_torch.config import EDSConfig
from slam_eds_tpu_torch.io.dataset import SyntheticSequence
from slam_eds_tpu_torch.models import ba_state as tbs
from slam_eds_tpu_torch.models import keyframe as tkf
from slam_eds_tpu_torch.models import pipeline as tpl
from slam_eds_tpu_torch.ops import coarse_tracker as tct
from slam_eds_tpu_torch.ops import depth_filter as tdf
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.ops import immature as tim
from slam_eds_tpu_torch.ops.kernels import rasterize as rz
from slam_eds_tpu_torch.runner import run_sequence
from slam_eds_tpu_torch.utils.cameras import Pinhole
from slam_eds_tpu_torch.utils.scatter import order_free_index_add

torch.set_num_threads(1)

CAM = Pinhole(110.0, 110.0, 63.5, 47.5, 128, 96)
ENTRY_POINTS = {
    "EDSPipeline": lambda: tpl.EDSPipeline(CAM, EDSConfig()),
    "FrameOnlyPipeline": lambda: tpl.FrameOnlyPipeline(CAM, EDSConfig()),
    "SyntheticSequence": lambda: SyntheticSequence(CAM, num_frames=3),
    "empty_state": lambda: tbs.empty_state(4, 16, [1.0, 1.0, 0.5, 0.5]),
    "ba_state.from_numpy": lambda: tbs.from_numpy(tbs.to_numpy(
        tbs.empty_state(2, 4, [1.0, 1.0, 0.5, 0.5], device="cpu"))),
    "keyframe.from_numpy": lambda: tkf.from_numpy({}),
    "immature.from_numpy": lambda: tim.from_numpy({}),
    "state_from_numpy": lambda: tet.state_from_numpy({}),
    "pose_filter_from_numpy": lambda: tet.pose_filter_from_numpy({}),
    "depth_filter.from_numpy": lambda: tdf.from_numpy({}),
    "template_from_numpy": lambda: tct.template_from_numpy({}),
    "run_sequence": lambda: run_sequence("no-such-dataset"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda requested"):
        ENTRY_POINTS[name]()


def test_the_cpu_is_asked_for_by_name():
    pipe = tpl.EDSPipeline(CAM, EDSConfig(), device="cpu")
    assert pipe.device.type == "cpu"
    assert pipe.frame_pipe.window.intensity.device.type == "cpu"
    seq = SyntheticSequence(CAM, num_frames=3, device="cpu")
    assert seq.frame(0)[1].device.type == "cpu"


@pytest.mark.parametrize("clusters", [1, 7, 16])
@pytest.mark.parametrize("cluster", rz.CLUSTER_SIZES)
@pytest.mark.parametrize("height,width,bands16", [
    (480, 640, 1), (260, 346, 1), (131, 77, 1), (77, 131, 1),
    (720, 1280, 2)])
def test_raster_launch_geometry_owns_every_pixel_once(height, width, bands16,
                                                      cluster, clusters):
    g = rz.launch_geometry(height, width, cluster, clusters)
    assert g.cluster == cluster
    assert g.bytes_per_block == 8 * g.slice_px <= rz.MAX_SMEM_PER_BLOCK
    assert g.slice_px % 4 == 0
    if cluster == 16 and clusters == 1:
        assert g.bands == bands16
    # no band taller than the frame cut into one band per cluster
    assert g.rows_per_band <= -(-height // min(clusters, height))
    owners = np.zeros(height * width, np.int64)
    for band in range(g.bands):
        y_lo = band * g.rows_per_band
        y_hi = min(height, y_lo + g.rows_per_band)
        band_px = (y_hi - y_lo) * width
        for rank in range(g.cluster):
            first = rank * g.slice_px
            count = max(0, min(g.slice_px, band_px - first))
            owners[y_lo * width + first:y_lo * width + first + count] += 1
        # a tap's owner rank must exist in the cluster
        assert (band_px - 1) // g.slice_px < g.cluster
    assert (owners == 1).all()
    assert g.bands * g.rows_per_band >= height > (g.bands - 1) \
        * g.rows_per_band


def test_raster_geometry_of_the_operating_point():
    T = rz.THREADS
    assert rz.launch_geometry(480, 640) == (16, 1, 480, 19200, 153600, T)
    # the portable cluster cuts the frame into two bands
    assert rz.launch_geometry(480, 640, 8) == (8, 2, 240, 19200, 153600, T)
    # spread over 8 clusters of 16: 60 rows per band
    assert rz.launch_geometry(480, 640, 16, 8) == (16, 8, 60, 2400, 19200, T)


def _terms(seed, n=4000, bins=300):
    rng = np.random.default_rng(seed)
    flat = torch.as_tensor(rng.integers(0, bins, n))
    x = torch.as_tensor(rng.uniform(0.05, 3.0, n).astype(np.float32))
    return flat, x, bins


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_free_index_add_does_not_depend_on_the_order(seed):
    flat, x, bins = _terms(seed)
    got = order_free_index_add(flat, x, bins)
    perm = torch.as_tensor(np.random.default_rng(seed + 10).permutation(
        len(x)))
    assert torch.equal(got, order_free_index_add(flat[perm], x[perm], bins))
    exact = torch.zeros(bins, dtype=torch.float64).index_add_(
        0, flat, x.double())
    ulp = torch.finfo(torch.float32).eps * exact.abs()
    assert ((got.double() - exact).abs() <= ulp).all()
    want = torch.zeros(bins).index_add_(0, flat, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_order_free_index_add_propagates_non_finite_terms():
    flat = torch.tensor([0, 0, 1, 1, 2, 2, 3])
    x = torch.tensor([1.0, np.inf, -np.inf, np.inf, np.nan, 2.0, 0.5])
    got = order_free_index_add(flat, x, 5)
    want = torch.zeros(5).index_add_(0, flat, x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert torch.equal(got[fin], want[fin])


@pytest.mark.parametrize("seed", [3, 4])
def test_splat_idepth_order_free_matches_float_and_jax(seed):
    rng = np.random.default_rng(seed)
    H, W, n = 24, 32, 1500          # about 2 points per pixel
    uv = np.stack([rng.uniform(-1, W, n), rng.uniform(-1, H, n)],
                  -1).astype(np.float32)
    idp = rng.uniform(0.1, 2.0, n).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    t = torch.as_tensor
    idw, ws = tct.splat_idepth(t(uv), t(idp), t(w), t(mask), H, W)
    jidw, jws = jct.splat_idepth(jnp.asarray(uv), jnp.asarray(idp),
                                 jnp.asarray(w), jnp.asarray(mask), H, W)
    np.testing.assert_allclose(idw.numpy(), np.asarray(jidw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-5,
                               atol=1e-6)
    # the float index_add_ form it replaces
    ix = torch.clamp((t(uv)[:, 0] + 0.5).long(), 0, W - 1)
    iy = torch.clamp((t(uv)[:, 1] + 0.5).long(), 0, H - 1)
    wm = torch.where(t(mask), t(w), torch.zeros(n))
    f_idw = torch.zeros(H * W).index_add_(0, iy * W + ix, t(idp) * wm)
    np.testing.assert_allclose(idw.reshape(-1).numpy(), f_idw.numpy(),
                               rtol=1e-6)
    # and a permutation of the points gives the same grids, bitwise
    perm = t(rng.permutation(n))
    idw_p, ws_p = tct.splat_idepth(t(uv)[perm], t(idp)[perm], t(w)[perm],
                                   t(mask)[perm], H, W)
    assert torch.equal(idw, idw_p) and torch.equal(ws, ws_p)
