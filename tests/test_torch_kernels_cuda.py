"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports neither JAX nor ``tests/conftest.py``'s helpers, so it also
runs on a machine that has only PyTorch (the BA window is
``torch_world``'s):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

The raster kernel is held to its plain version on the four cases of
``chip_smoke.py``'s phase 7 (a 640x480 packet of 65,536-event capacity, random
fractional events, a ragged case with border, huge, NaN and inf coordinates,
and a case at the fixed-point range bound, there against the plain version
in float64): max |d| <= 1e-5 max(1, max|ref|), finite, bitwise equal to
the 64-bit fixed-point sum formed with torch int64 ops, and two launches
bitwise equal (the kernel accumulates in 64-bit fixed point, in a
thread-block cluster's shared memory, one launch per call).

The same kernel at the track refinement's splat shape (2,048 float-valued
points at 640x480: gradient-sized values, normalized model values, masked
lanes with NaN and far coordinates) is held to the same four properties,
and each ``refine_tracks_*`` on the card launches it once per splat (2 for
``klt``, 1 for ``model_klt``, 1 for ``epiline``) and agrees with the same
call on the CPU within 1e-3 px.

``splat_idepth`` sums in 64-bit fixed point with integer ``index_add_``: two
launches on the card, and the CPU, give the same grid bitwise.

The loops' small solve (``csrc/lu_solve.cu``'s ``small_solve``, one warp
per system, the one route of ``utils.linalg.solve`` up to 32 unknowns):
on one system it is taken at every n of 1..32 and is bitwise
``torch.linalg.solve_ex`` there, in float32 and float64; a batch and
``torch.vmap`` lanes (also nested) take one launch, each system bitwise
``solve_ex`` on that system alone; the launcher holds from 1 to 4097
systems and at 2^31; over many systems in one launch it is within kappa n
eps of its plain version (it fuses each product into its update, the
plain version rounds it first); captured in a WHILE body, also nested in
an IF body, it runs only in the passes that run
(``graphs.launch_ledger``).

The coarse tracker's fused pass (``csrc/coarse_pass.cu``) on the six
level templates of the smoke's 640x480 sequence: one launch linearizes a
level as ``calc_res`` / ``calc_gs`` do on the same card tensors (H and b
within 1e-5 of their terms' scale, E within 1e-6 relative, counts and the
saturated share equal) and two launches are bitwise equal; the whole level
by the kernel against ``track_level_plain`` (the same doublings, the pose
within 1e-4); ``track_newest_coarse`` captured is bitwise its eager run and
runs one launch per pass that ran and three a level.

The event LM's fused pass (``csrc/event_pass.cu``) on the packet step's
inputs after frame 4 of the smoke's 640x480 sequence (2,048 point slots,
the packet's three event-frame levels): at each level and at 256 and 2,048
slots, one launch of each mode against the plain pass on the same card
tensors (``chip_smoke.event_pass_gaps``: the start and the candidate's
energy and the final residuals within ``chip_smoke.EVENT_SUM_TOL``, H and
g within it of their terms' scale, the state after a pass within
``EVENT_STEP_TOL``, lambda, the count and done equal, two launches
bitwise), with the Cauchy loss, no loss and the normalized-event cost too;
masked slots with junk and a non-finite projection, a live slot behind the
camera, a live slot whose projection is not finite (NaN energies, the step
refused) and a pass after done (the carry bitwise); every pass of a level
to its cap against the plain pass from the same carry
(``chip_smoke.event_forced_passes``), then the whole level and the whole
``_pyramid_fused`` run apart beside the plain route (the same passes, the
final energies within ``chip_smoke.EVENT_SOLVE_TOL``: the runs part along
the LM's weak directions as the plain pass parts from itself under another
summation order); captured, a pass is two graph nodes and the ledger runs
one launch a pass and two a level; the wrapper raises on a CPU tensor, a
wrong dtype or shape. The batched event lanes run the plain pass and are
held bitwise to it (not to ``optimize`` on the card, which takes the
kernel).

``parallel.dryrun.dryrun_multichip(2, "cuda")`` runs with two spawned ranks
sharing the card over gloo and holds itself to the JAX dry run's bounds.

The seam the steps go through (``graphs.run``): at the end of the smoke's
frame and event cells the window's ``track_frame`` and ``ba`` programs,
and the ``dso`` initializer's ``coarse_init_track`` on a strided pyramid,
run eagerly in ``graphs.eagerly()`` are bitwise their replays; the launch
ledger over a warm run of each cell is ``PARENT_LEDGER``, read at the
commit before the seam.

Tolerances: the sampler kernel is built without multiply-add contraction and
follows the plain version term by term, so ``ok`` is identical and values
agree within 1e-4 (0-255 planes); linearize/ba_iterate on the card against
the same code on the CPU agree within 1e-4 relative on the energy and 1e-3
on linearization entries; after 6 GN iterations the state agrees within
1e-2 scale-relative, as between the JAX package and the port (the card sums
the BA reductions in another order, and the reduced system is about
1e8-conditioned).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_eds_tpu_torch.ops import coarse_tracker as ct
from slam_eds_tpu_torch.ops import energy
from slam_eds_tpu_torch.ops import event_tracker as et
from slam_eds_tpu_torch.ops.kernels import pattern_sample as ps
from slam_eds_tpu_torch.ops.kernels import rasterize as rz
from slam_eds_tpu_torch.utils import events as ev
from torch_guard import masked_branches
from torch_world import H, W, event_world, port_world

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

CASES = [(3, 37, 61, 23), (2, 48, 130, 67), (4, 96, 128, 256),
         (8, 480, 640, 2048)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from slam_eds_tpu_torch.device import set_numerics
    set_numerics()
    return torch.device("cuda")


def _taps(rng, F, H, W, P, K=8):
    u = rng.uniform(-3, W + 3, (P, F, K)).astype(np.float32)
    v = rng.uniform(-3, H + 3, (P, F, K)).astype(np.float32)
    u[0, :, 0], v[0, :, 0] = 1.0, 1.0
    u[0, :, 1], v[0, :, 1] = W - 2.0 - 1e-3, H - 2.0 - 1e-3
    u[0, :, 2], v[0, :, 2] = W - 2.0, 5.0
    u[1, :, :4] = np.arange(4) + 3.0
    u[2, :, 0], v[2, :, 1] = np.nan, np.nan
    u[2, :, 2], v[2, :, 3] = np.inf, -np.inf
    return u, v


@pytest.mark.cuda
@pytest.mark.parametrize("stack", [True, False])
@pytest.mark.parametrize("F,H,W,P", CASES)
def test_sampler_kernel_matches_plain(card, F, H, W, P, stack):
    rng = np.random.default_rng(F * H + W + P)
    shape = (F, H, W, 3) if stack else (F, H, W)
    planes = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32),
                             device=card)
    u, v = (torch.as_tensor(a, device=card) for a in _taps(rng, F, H, W, P))
    before = ps.pattern_sample.launches
    out = ps.pattern_sample(planes, u, v)
    torch.cuda.synchronize()
    assert ps.pattern_sample.launches == before + 1
    ref = ps.pattern_sample_reference(planes, u, v)
    assert torch.equal(out[3], ref[3])
    ok = ref[3]
    assert ok.any()
    for a, b in zip(out[:3], ref[:3]):
        assert a.shape == u.shape
        assert torch.isfinite(a).all()
        assert (a[ok] - b[ok]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("stack", [True, False])
@pytest.mark.parametrize("F,H,W,P", CASES)
def test_sampler_kernel_is_bitwise_the_plain_version_on_ok_taps(card, F, H,
                                                                W, P, stack):
    rng = np.random.default_rng(F * H + W + P + 1)
    shape = (F, H, W, 3) if stack else (F, H, W)
    planes = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32),
                             device=card)
    u, v = (torch.as_tensor(a, device=card) for a in _taps(rng, F, H, W, P))
    # clustered 8-tap patterns as on the path: one centre per (p, f)
    c = rng.uniform(2, (W - 3, H - 3), (P, F, 1, 2)).astype(np.float32)
    pat = np.array([[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0],
                    [-1, 1], [0, 2]], np.float32)
    uc, vc = (torch.as_tensor(a, device=card)
              for a in np.moveaxis(c + pat, -1, 0))
    for uu, vv in ((u, v), (uc.contiguous(), vc.contiguous())):
        out = ps.pattern_sample(planes, uu, vv)
        ref = ps.pattern_sample_reference(planes, uu, vv)
        torch.cuda.synchronize()
        ok = ref[3]
        assert torch.equal(out[3], ok) and ok.any()
        for a, b in zip(out[:3], ref[:3]):
            assert torch.equal(a[ok], b[ok])
            assert torch.isfinite(a).all()


@pytest.mark.cuda
def test_sampler_wrapper_rejects_what_the_kernel_does_not_take(card):
    planes = torch.zeros((2, 20, 30), device=card)
    u = torch.zeros((5, 2, 8), device=card)
    with pytest.raises(TypeError):
        ps.pattern_sample(planes.double(), u.double(), u.double())
    with pytest.raises(ValueError):
        ps.pattern_sample(planes, u.transpose(0, 2), u.transpose(0, 2))
    with pytest.raises(ValueError):
        ps.pattern_sample(planes, torch.zeros((5, 3, 8), device=card),
                          torch.zeros((5, 3, 8), device=card))
    with pytest.raises(ValueError):
        ps.pattern_sample_cuda(planes.cpu(), u, u)


@pytest.mark.cuda
def test_linearize_on_card_matches_cpu(card):
    st_g, im_g = port_world(card)
    st_c, im_c = port_world("cpu")
    before = ps.pattern_sample.launches
    lg = energy.linearize(st_g, im_g, H, W)
    assert ps.pattern_sample.launches == before + 1
    lc = energy.linearize(st_c, im_c, H, W)
    assert torch.equal(lg.valid.cpu(), lc.valid)
    assert int(lc.valid.sum()) > 100
    for name in ("res", "JIdx", "Jab", "Jpdxi", "Jpdc", "Jpdd", "energy"):
        np.testing.assert_allclose(getattr(lg, name).cpu().numpy(),
                                   getattr(lc, name).numpy(), rtol=1e-4,
                                   atol=1e-3, err_msg=name)


@pytest.mark.cuda
def test_ba_iterate_on_card_matches_cpu(card):
    st_g, im_g = port_world(card)
    st_c, im_c = port_world("cpu")
    before = ps.pattern_sample.launches
    sg, eg, _ = energy.ba_iterate(st_g, im_g, H, W, iterations=6,
                                  final_linearize=False)
    assert ps.pattern_sample.launches == before + 6
    sc, ec, _ = energy.ba_iterate(st_c, im_c, H, W, iterations=6,
                                  final_linearize=False)
    assert np.isfinite(float(eg))
    assert abs(float(eg) - float(ec)) <= 1e-4 * abs(float(ec))
    for name in ("delta", "p_idepth"):
        a, b = getattr(sg, name).cpu().numpy(), getattr(sc, name).numpy()
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max(), name


@pytest.fixture(scope="module")
def raster_cases():
    """chip_smoke's raster cases; the packet is the first one phase 8's
    event path is fed, the largest of its sequence (57,508 events in 65,536
    lanes in the JAX package's rendering)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    dev = torch.device("cuda")
    seq = SyntheticSequence(Pinhole(400.0, 400.0, 319.5, 239.5, 640, 480),
                            num_frames=chip_smoke.PIPE_FRAMES,
                            motion_scale=0.22, micro_steps=2,
                            events_per_packet=chip_smoke.EVENT_CAP,
                            device=dev)
    return chip_smoke.raster_cases(dev, [seq.events_between(1, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packet", "random", "ragged", "bound"])
def test_raster_kernel_matches_plain_and_is_deterministic(card, raster_cases,
                                                          case):
    err, bound = chip_smoke._compare_raster(rz, *raster_cases[case])
    assert err <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packet", "random", "ragged", "bound"])
def test_raster_kernel_is_bitwise_the_fixed_point_sum(card, raster_cases,
                                                      case):
    xs, ys, vals, H, W, _ = raster_cases[case]
    got = rz.rasterize_bilinear(xs, ys, vals, H, W)
    assert torch.equal(got, chip_smoke.raster_fixed_point(xs, ys, vals, H, W))


@pytest.mark.cuda
def test_raster_geometry_on_the_card(card):
    geo = rz.card_geometry(480, 640)
    assert geo.cluster in rz.CLUSTER_SIZES
    assert geo == rz.launch_geometry(480, 640, geo.cluster, geo.bands)
    # one launch and one device activity per call
    x = torch.zeros(64, device=card)
    assert chip_smoke.device_profile(
        lambda: rz.rasterize_bilinear_cuda(x, x, x, 480, 640))[1] == 1


@pytest.mark.cuda
def test_splat_idepth_is_bitwise_repeatable_and_the_cpu_grid(card):
    rng = np.random.default_rng(8)
    H, W, n = 480, 640, 2048
    uv = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
    uv[: n // 2] = uv[n // 2:] + rng.uniform(-0.4, 0.4, (n // 2, 2))
    args = [uv.astype(np.float32), rng.uniform(0.1, 3.0, n).astype(
        np.float32), np.ones(n, np.float32), rng.uniform(size=n) < 0.9]
    on = [torch.as_tensor(a, device=card) for a in args]
    a = ct.splat_idepth(*on, H, W)
    b = ct.splat_idepth(*on, H, W)
    c = ct.splat_idepth(*(torch.as_tensor(x) for x in args), H, W)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert torch.equal(x.cpu(), z)


@pytest.mark.cuda
def test_scatter_accumulate_launches_the_raster_kernel(card):
    rng = np.random.default_rng(6)
    n, h, w = 5000, 48, 64
    xs, ys = (torch.as_tensor(rng.uniform(-2, m + 2, n).astype(np.float32),
                              device=card) for m in (w, h))
    vals = torch.as_tensor(rng.choice([-1.0, 1.0], n).astype(np.float32),
                           device=card)
    mask = torch.as_tensor(rng.uniform(size=n) < 0.7, device=card)
    before = rz.rasterize_bilinear.launches
    got = ev.scatter_accumulate(xs, ys, vals, h, w, mask=mask)
    assert rz.rasterize_bilinear.launches == before + 1
    want = rz.rasterize_bilinear_reference(
        xs, ys, torch.where(mask, vals, torch.zeros_like(vals)), h, w)
    assert got.device.type == "cuda"
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_raster_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.zeros(16, device=card)
    with pytest.raises(TypeError):
        rz.rasterize_bilinear(x.double(), x.double(), x.double(), 8, 8)
    with pytest.raises(ValueError):
        rz.rasterize_bilinear(x, x[:8], x, 8, 8)
    with pytest.raises(ValueError):
        rz.rasterize_bilinear(x.reshape(4, 4), x.reshape(4, 4),
                              x.reshape(4, 4), 8, 8)
    with pytest.raises(ValueError):
        rz.rasterize_bilinear(torch.zeros(32, device=card)[::2], x, x, 8, 8)
    with pytest.raises(ValueError):
        rz.rasterize_bilinear_cuda(x.cpu(), x.cpu(), x.cpu(), 8, 8)


def _splat_case(kind):
    """2,048 points at 640x480 as the refinement modes splat them: masked
    lanes (a fifth) carry NaN or far coordinates and arbitrary values."""
    rng = np.random.default_rng(12)
    n, h, w = 2048, 480, 640
    uv = np.stack([rng.uniform(-1, w, n), rng.uniform(-1, h, n)],
                  -1).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    uv[~mask] = rng.choice([np.nan, 1e7, -3e5], ((~mask).sum(), 2))
    if kind == "gradient":
        vals = (rng.normal(size=n) * 300).astype(np.float32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
        vals /= np.linalg.norm(vals)
    return uv, vals, mask, h, w


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gradient", "model"])
def test_raster_kernel_at_the_splat_shape(card, kind):
    uv, vals, mask, h, w = _splat_case(kind)
    uv, vals, mask = (torch.as_tensor(a, device=card)
                      for a in (uv, vals, mask))
    before = rz.rasterize_bilinear.launches
    got = et._splat(uv, vals, mask, h, w)
    assert rz.rasterize_bilinear.launches == before + 1
    xs, ys = uv[:, 0].contiguous(), uv[:, 1].contiguous()
    v = torch.where(mask, vals, torch.zeros_like(vals))
    err, bound = chip_smoke._compare_raster(rz, xs, ys, v, h, w, False)
    assert err <= bound
    assert torch.equal(got, chip_smoke.raster_fixed_point(xs, ys, v, h, w))
    assert 2048 * float(v.abs().max()) < 2.0 ** 30


@pytest.mark.cuda
@pytest.mark.parametrize("mode,launches", [("klt", 2), ("klt_pyr", 2),
                                           ("model_klt", 1), ("epiline", 1)])
def test_refinement_splats_launch_the_raster_kernel(card, mode, launches):
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    from slam_eds_tpu_torch.utils.lie import SE3
    rng = np.random.default_rng(13)
    n, h, w = 2048, 480, 640
    cam = Pinhole(400.0, 400.0, 319.5, 239.5, w, h)
    uv = np.stack([rng.uniform(8, w - 9, n), rng.uniform(8, h - 9, n)],
                  -1).astype(np.float32)
    grad = (rng.normal(size=(n, 2)) * 30).astype(np.float32)
    model = rng.normal(size=n).astype(np.float32)
    model /= np.linalg.norm(model)
    mask = rng.uniform(size=n) < 0.9
    shift = np.float32([0.6, -0.3])
    ev_frame = rz.rasterize_bilinear_reference(
        *(torch.as_tensor(a) for a in (uv[:, 0] + shift[0],
                                       uv[:, 1] + shift[1], model)), h, w)
    tau = torch.tensor([0.05, 0.0, 0.0, 0.0, 0.0, 0.0])

    def run(dev):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        if mode in ("klt", "klt_pyr"):
            return et.refine_tracks_klt(
                t(ev_frame), t(uv), t(grad), t(mask), patch_radius=3,
                num_levels=3 if mode == "klt_pyr" else 1)
        if mode == "model_klt":
            return et.refine_tracks_model_klt(t(ev_frame), t(uv), t(model),
                                              t(mask), patch_radius=3)
        return et.refine_tracks_epiline(
            t(ev_frame), t(uv), t(uv), t(model), t(mask), SE3.exp(t(tau)),
            cam, patch_radius=3)

    before = rz.rasterize_bilinear.launches
    got, ok = run(card)
    assert rz.rasterize_bilinear.launches == before + launches
    want, ok_cpu = run("cpu")
    assert got.device.type == "cuda"
    same = (ok.cpu() == ok_cpu)
    assert int((~same).sum()) <= 2
    sel = same & ok_cpu
    assert float((got.cpu() - want)[sel].abs().max()) <= 1e-3


@pytest.mark.cuda
def test_dryrun_on_the_card(card, tmp_path):
    """The multi-rank dry run with both ranks on this card over gloo: its
    own bounds (the JAX dry run's) and bitwise replication hold, and the
    sampler kernel is launched in each rank (the parent builds it first, so
    the ranks only load it)."""
    from slam_eds_tpu_torch.parallel import dryrun
    ps.load()
    rep = dryrun.dryrun_multichip(2, "cuda", store_dir=str(tmp_path))
    assert rep["backend"] == "gloo"
    assert min(rep["launches"]) > 0 and rep["launches_1"] > 0


# ---------------------------------------------------------------------------
# the sampler's lane axis and operator; captured programs
# ---------------------------------------------------------------------------

def _contiguous(tree):
    """A captured program's inputs as it holds them: contiguous copies (an
    eager run on the same layouts is then bitwise the replay)."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: None if t is None else t.contiguous(), tree)


def _lanes(card, B=3, F=4, H=48, W=64, P=96, K=8, seed=5):
    rng = np.random.default_rng(seed)
    planes = torch.as_tensor(rng.uniform(0, 255, (B, F, H, W)).astype(
        np.float32), device=card)
    u = torch.as_tensor(rng.uniform(-3, W + 3, (B, P, F, K)).astype(
        np.float32), device=card)
    v = torch.as_tensor(rng.uniform(-3, H + 3, (B, P, F, K)).astype(
        np.float32), device=card)
    u[0, 0, :, 0] = float("nan")
    return planes, u, v


@pytest.mark.cuda
def test_lane_axis_sampler_matches_plain(card):
    """Taps [B, P, F, K] on planes [B, F, H, W]: one launch, ``ok`` equal to
    the plain version's and the values bitwise on ok taps; each lane is
    bitwise the single-problem kernel on its own planes."""
    planes, u, v = _lanes(card)
    before = ps.pattern_sample_lanes.launches
    got = ps.pattern_sample_lanes(planes, u, v)
    assert ps.pattern_sample_lanes.launches == before + 1
    ref = ps.pattern_sample_lanes_reference(planes, u, v)
    assert torch.equal(got[3], ref[3]) and int(ref[3].sum()) > 100
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a[ref[3]], b[ref[3]])
        assert torch.isfinite(a).all()
    for b in range(planes.shape[0]):
        single = ps.pattern_sample(planes[b], u[b].contiguous(),
                                   v[b].contiguous())
        for a, s in zip(got, single):
            assert torch.equal(a[b], s)


@pytest.mark.cuda
def test_sampler_operator_fake_and_vmap_rules(card):
    planes, u, v = _lanes(card, B=2)
    torch.library.opcheck(ps.sample_op, (planes[0], u[0].contiguous(),
                                         v[0].contiguous()))
    before = ps.pattern_sample_lanes.launches
    mapped = torch.vmap(ps.sample_op)(planes, u, v)
    assert ps.pattern_sample_lanes.launches == before + 1
    lanes = ps.pattern_sample_lanes(planes, u, v)
    for a, b in zip(mapped, lanes):
        assert torch.equal(a, b)
    # planes shared by every lane (not mapped)
    shared = torch.vmap(ps.sample_op, in_dims=(None, 0, 0))(planes[0], u, v)
    for b in range(2):
        single = ps.pattern_sample(planes[0], u[b].contiguous(),
                                   v[b].contiguous())
        for a, s in zip(shared, single):
            assert torch.equal(a[b], s)


@pytest.mark.cuda
def test_graph_replays_count_kernel_launches(card):
    from slam_eds_tpu_torch import graphs
    planes, u, v = _lanes(card, B=1)
    xs = torch.rand(4096, device=card) * 64
    ys = torch.rand(4096, device=card) * 48
    vals = torch.ones(4096, device=card)

    def fn(x):
        s = ps.pattern_sample(x["planes"], x["u"], x["v"])
        img = rz.rasterize_bilinear(x["xs"], x["ys"], x["vals"], 48, 64)
        return s[0] * 2.0, img + 1.0

    cache = graphs.GraphCache()
    x = {"planes": planes[0], "u": u[0].contiguous(), "v": v[0].contiguous(),
         "xs": xs, "ys": ys, "vals": vals}
    n0 = (ps.pattern_sample.launches, rz.rasterize_bilinear.launches)
    first = cache.run("t", fn, x)       # warm-up, capture, then a replay
    n1 = (ps.pattern_sample.launches, rz.rasterize_bilinear.launches)
    assert n1 == (n0[0] + 2, n0[1] + 2)
    assert cache.warmups == {**{k.__name__: 0 for k in graphs.counters()},
                             "pattern_sample": 1, "rasterize_bilinear": 1}
    with graphs.sync_check("error"):
        for k in range(3):
            x2 = dict(x, xs=torch.rand(4096, device=card) * 64)
            out = cache.run("t", fn, x2)
            eager = fn(x2)
            assert torch.equal(out[0], eager[0])
            assert torch.equal(out[1], eager[1])
    assert torch.equal(first[0], out[0])        # same taps
    n2 = (ps.pattern_sample.launches, rz.rasterize_bilinear.launches)
    # 3 replays and 3 eager calls
    assert n2 == (n1[0] + 6, n1[1] + 6)
    assert cache.replays() == 4


@pytest.mark.cuda
def test_ba_program_captured_is_bitwise_eager(card):
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.models.window import ba_program
    st, im = port_world(card)
    kw = dict(height=H, width=W, iterations=4, break_tol=5e-5)
    cache = graphs.GraphCache()
    x = {"state": st, "planes": im[..., 0].contiguous()}
    cache.run("ba", lambda x: ba_program(x, **kw), x)
    with graphs.sync_check("error"):
        got = cache.run("ba", lambda x: ba_program(x, **kw), x)
        torch.cuda.set_sync_debug_mode("error")
        try:
            want = ba_program(_contiguous(x), **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    from torch.utils._pytree import tree_leaves
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_packet_program_replayed_on_two_live_counts(card):
    """The packet step's captured program (``gate_ladder``, its retries IF
    nodes) replayed on one packet at two live counts: each replay bitwise
    the eager program at that count, its retries masked."""
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.config import EDSConfig
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch.models import keyframe as kfm
    from slam_eds_tpu_torch.models import pipeline as pl
    from slam_eds_tpu_torch.ops import depth_filter as dfm
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    from torch.utils._pytree import tree_leaves
    cam = Pinhole(110.0, 110.0, 63.5, 47.5, 128, 96)
    seq = SyntheticSequence(cam, num_frames=3, events_per_packet=4096,
                            motion_scale=0.1, device=card)
    _, img0, _ = seq.frame(0)[:3]
    kf = kfm.create_keyframe(img0, cam, capacity=256, init_depth=2.0,
                             device=card)
    pk = seq.events_between(0, 1)
    cfg = EDSConfig()
    pipe = pl.EDSPipeline(cam, cfg, device=card)
    lim, iters, statics = pipe._packet_step_args()

    def program(x):
        return pl.gate_ladder(x, cam, iters, lim, statics)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=card)  # noqa
    x = {"xs": t(pk.xs), "ys": t(pk.ys), "ts": t(pk.ts),
         "ps": t(pk.polarity), "fwd_maps": None,
         "state": et.initial_tracker_state(card),
         "pf": et.pose_filter_init(cfg.tracker.pose_filter_window, card),
         "depth": dfm.init_from_prior(kf.idepth, cfg.mapping.min_depth,
                                      cfg.mapping.max_depth, device=card),
         "kf_R": kf.T_w_kf_R, "kf_t": kf.T_w_kf_t,
         "pred_R": torch.eye(3, device=card),
         "pred_t": torch.zeros(3, device=card), "kf_uv": kf.uv,
         "kf_nc": kf.norm_coord, "kf_grad": kf.grad, "kf_idp": kf.idepth,
         "kf_weight": kf.weight, "kf_mask": kf.mask,
         "loss_scale": torch.full((), 0.2, device=card)}
    cache = graphs.GraphCache()
    n = int(pk.n_valid)
    x["n_valid"] = torch.full((), n, dtype=torch.int32, device=card)
    cache.run("packet", program, x)                       # warm-up
    heads = []
    for count in (n, n // 3):
        x["n_valid"] = torch.full((), count, dtype=torch.int32, device=card)
        with graphs.sync_check("error"):
            got = cache.run("packet", program, x)
        with masked_branches():
            want = program(_contiguous(x))
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)
        heads.append(got[0][4].clone())
    assert not torch.equal(heads[0], heads[1])


def _solve_loop(stop, cap):
    """A while_loop of ``cap`` LM-like passes (a 12x12 solve each) that
    stops after ``stop`` (at once where ``stop`` is 0); its carry ends in
    the pass counter."""
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.utils.linalg import solve

    def fn(x):
        def one(_, c):
            v, it, done = c
            active = ~done
            v = torch.where(active, v + 1e-3 * solve(x["H"], v), v)
            it = it + active.to(torch.int32)
            return v, it, done | (it >= stop)
        dev = x["v"].device
        return graphs.while_loop(
            lambda c: c[2], one,
            (x["v"], torch.zeros((), dtype=torch.int32, device=dev),
             torch.full((), stop <= 0, dtype=torch.bool, device=dev)), cap)
    return fn


def _loop_inputs(card, seed):
    rng = np.random.default_rng(seed)
    return {"v": torch.as_tensor(rng.normal(size=12).astype(np.float32),
                                 device=card),
            "H": torch.as_tensor((rng.normal(size=(12, 12))
                                  + 12 * np.eye(12)).astype(np.float32),
                                 device=card)}


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [0, 3, 10])
def test_captured_if_loop_is_bitwise_its_eager_run(card, stop):
    """A loop captured as one WHILE node (its pass captured once) replays
    bitwise its eager masked run, whether it stops at once, early or runs
    to the cap; the captured program holds one WHILE node and no IF
    node."""
    from slam_eds_tpu_torch import graphs
    x = _loop_inputs(card, stop)
    fn = _solve_loop(stop, 10)
    cache = graphs.GraphCache()
    cache.run("loop", fn, x)
    with graphs.sync_check("error"):
        got = graphs.copy_out(cache.run("loop", fn, x))
    want = fn(_contiguous(x))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1]) == min(stop, 10)
    (prog,) = cache.programs.values()
    assert prog.nodes["while"] == 1 and prog.nodes["if"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [0, 3, 10])
def test_launch_ledger_counts_the_passes_that_ran(card, stop):
    """Over one replay of a loop with a cap of 10 that stops after
    ``stop`` passes, ``graphs.launch_ledger`` counts 10 slots of the small
    solve (also under its size, 12) and of the pass tail (a slot per pass
    the cap allows) and ``stop`` launches run of each (the pass tail's
    ``taken`` count); the condition kernel, which starts the loop, runs
    once. The ledger has no LU substitution: the small solve is the one
    route of the loops' solves."""
    from slam_eds_tpu_torch import graphs
    x = _loop_inputs(card, stop)
    fn = _solve_loop(stop, 10)
    cache = graphs.GraphCache()
    cache.run("loop", fn, x)                  # warm-up, capture, replay
    before = graphs.launch_ledger()
    cache.run("loop", fn, x)
    d = graphs.ledger_delta(before, graphs.launch_ledger())
    assert d["small_solve"] == {"slots": 10, "run": stop}
    assert d["small_solve_n12"] == {"slots": 10, "run": stop}
    assert "lu_substitute" not in d
    assert d["pass_tail"] == {"slots": 10, "run": stop}
    assert d["set_condition"] == {"slots": 1, "run": 1}


# A size's first small solve captured in an IF body that the warm-up skips
# (its branch false): run in a fresh process, where no size has launched.
_FIRST_SIZE_IN_A_CAPTURE = """
import json, torch
from slam_eds_tpu_torch import graphs
from slam_eds_tpu_torch.device import set_numerics
from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
from slam_eds_tpu_torch.utils.linalg import solve
set_numerics()
dev = torch.device("cuda")
A12 = torch.eye(12, device=dev) * 2.0
solve(A12, torch.ones(12, device=dev))
def fn(x):
    return graphs.cond(x["p"], lambda c: (solve(x["A"], c[0]),), (x["b"],))
x = {"p": torch.zeros((), dtype=torch.bool, device=dev),
     "A": torch.eye(5, device=dev) * 2.0, "b": torch.ones(5, device=dev)}
cache = graphs.GraphCache()
cache.run("f", fn, x)                # warm-up (branch skipped), capture
made = sorted(lu.SMALL_SOLVE_BY_N)
before = graphs.launch_ledger()
cache.run("f", fn, x)
x["p"].fill_(True)
out = graphs.copy_out(cache.run("f", fn, x))[0]
d = graphs.ledger_delta(before, graphs.launch_ledger())
print(json.dumps({"made": made, "n5": d["small_solve_n5"],
                  "n12": d["small_solve_n12"], "all": d["small_solve"],
                  "x": out.tolist()}))
"""


@pytest.mark.cuda
def test_launch_ledger_takes_a_size_first_launched_in_a_capture(card):
    """In a fresh process one 12x12 solve runs eagerly, then a 5x5 solve
    is first met while an IF body that the warm-up skipped is captured: its
    counter is made during the capture and joins the ledger, two replays
    (the branch false, then true) count two slots and one launch run of
    it, the 12x12 counter keeps its count, and the taken branch solves."""
    import json
    import subprocess
    proc = subprocess.run([sys.executable, "-c", _FIRST_SIZE_IN_A_CAPTURE],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["made"] == [5, 12]
    assert got["n5"] == {"slots": 2, "run": 1}
    assert got["all"] == {"slots": 2, "run": 1}
    assert got["n12"] == {"slots": 0, "run": 0}
    assert got["x"] == [0.5] * 5


@pytest.mark.cuda
def test_loop_records_go_back_with_their_program(card):
    """A captured loop takes rows of the pass tails' record array; they go
    back to the free rows when its program is collected, and the next
    capture takes them again."""
    import gc
    from slam_eds_tpu_torch import graphs
    x = _loop_inputs(card, 3)
    dev = x["v"].device
    fn = _solve_loop(3, 10)
    graphs.GraphCache().run("warm", fn, x)    # the device's arrays exist
    gc.collect()
    free = list(graphs._RECORD_FREE[dev])
    cache = graphs.GraphCache()
    cache.run("loop", fn, x)
    assert graphs._RECORD_FREE[dev] != free
    del cache
    gc.collect()
    assert graphs._RECORD_FREE[dev] == free
    cache = graphs.GraphCache()
    got = graphs.copy_out(cache.run("loop", fn, x))
    assert int(got[1]) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("taken", [False, True])
def test_while_node_nested_in_an_if_body(card, taken):
    """A WHILE node inside an IF node's body (the event LM inside the
    gate's retries): bitwise the eager run (a host ``if`` around the masked
    loop) on both branches, the loop's passes, and its small solves, run
    only where the branch was taken."""
    from slam_eds_tpu_torch import graphs
    x = dict(_loop_inputs(card, 5), p=torch.full((), taken, device=card))
    loop = _solve_loop(4, 10)

    def fn(x):
        def branch(c):
            v, it, _ = loop({"v": c[0] * 2.0, "H": x["H"]})
            return v, c[1] + it
        return graphs.cond(x["p"], branch,
                           (x["v"], torch.zeros((), dtype=torch.int32,
                                                device=card)))
    cache = graphs.GraphCache()
    cache.run("nest", fn, x)
    before = graphs.launch_ledger()
    with graphs.sync_check("error"):
        got = graphs.copy_out(cache.run("nest", fn, x))
    d = graphs.ledger_delta(before, graphs.launch_ledger())
    want = fn(_contiguous(x))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1]) == (4 if taken else 0)
    assert d["pass_tail"] == {"slots": 10, "run": 4 if taken else 0}
    assert d["small_solve"] == {"slots": 10, "run": 4 if taken else 0}
    (prog,) = cache.programs.values()
    assert prog.nodes["while"] == 1 and prog.nodes["if"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,batch", [(6, 1), (7, 1), (7, 2), (8, 1), (12, 1),
                                     (12, 4), (68, 1)])
def test_loop_solve_is_solve_ex_at_the_path_sizes(card, n, batch, dtype):
    """``utils.linalg.solve`` at every size and batch of the path (the
    coarse LM's 6 and 8, the BA gauge's 7, the event LM's 12, the window
    BA's reduced 68) in float32 and float64: up to 32 unknowns one launch
    of the small solve kernel per call, one system or a batch, each system
    bitwise ``torch.linalg.solve_ex`` on that system alone; above 32
    (torch's factorization and two triangular solves) bitwise
    ``torch.linalg.solve_ex``; and its normwise relative residual
    ||A x - b|| / (||A|| ||x|| + ||b||) (max norms, in float64) at most
    n eps on these systems, which need row swaps."""
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    from slam_eds_tpu_torch.utils.linalg import solve
    rng = np.random.default_rng(n * 10 + batch)
    A = rng.normal(size=(batch, n, n)) + 0.05 * np.eye(n)
    b = rng.normal(size=(batch, n))
    A, b = (torch.as_tensor(a, dtype=dtype, device=card) for a in (A, b))
    if batch == 1:
        A, b = A[0], b[0]
    before = lu.small_solve.launches
    x = solve(A, b)
    if n <= lu.MAX_N:
        assert lu.small_solve.launches - before == 1
        A3, b3 = A.reshape(-1, n, n), b.reshape(-1, n)
        want = torch.stack([torch.linalg.solve_ex(
            A3[i], b3[i][:, None], check_errors=False)[0][:, 0]
            for i in range(len(A3))]).reshape(b.shape)
    else:
        assert lu.small_solve.launches == before
        want = torch.linalg.solve_ex(A, b[..., None],
                                     check_errors=False)[0][..., 0]
    assert torch.equal(x, want)
    A64, b64, x64 = A.double(), b.double(), x.double()
    r = (A64 @ x64[..., None])[..., 0] - b64
    res = r.abs().amax(-1) / (A64.abs().sum(-1).amax(-1)
                              * x64.abs().amax(-1) + b64.abs().amax(-1))
    assert float(res.max()) <= n * torch.finfo(dtype).eps, float(res.max())


@pytest.mark.cuda
@pytest.mark.parametrize("systems", [1, 2, 3, 4, 33, 4097])
@pytest.mark.parametrize("n", [7, 12, 17])
def test_small_solve_launcher_over_many_systems(card, n, systems):
    """The launcher at many systems (a warp each, four a block, the last
    block partial for 1, 2, 3, 33 and 4097): one launch for all; each
    system bitwise the kernel on that system alone and
    ``torch.linalg.solve_ex`` on it alone; an output buffer longer than
    the systems keeps its sentinel past the last one, and inputs followed
    by NaNs give the same x (nothing past the last system is read into a
    result or written)."""
    import ctypes
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    gen = torch.Generator().manual_seed(systems * 100 + n)
    A = chip_smoke.solve_systems("general", n, systems, torch.float32, card,
                                 gen)
    b = torch.randn(systems, n, generator=gen).to(card)
    before = lu.small_solve.launches
    x = lu.small_solve(A, b)
    assert lu.small_solve.launches - before == 1
    for i in sorted({0, 1 % systems, systems // 2, systems - 1}):
        one = lu.small_solve(A[i].contiguous(), b[i].contiguous())
        assert torch.equal(one, x[i])
        assert torch.equal(one, torch.linalg.solve_ex(
            A[i], b[i][:, None], check_errors=False)[0][:, 0])
    if systems <= 33:
        assert torch.equal(x, torch.stack([lu.small_solve(
            A[i].contiguous(), b[i].contiguous()) for i in range(systems)]))
    pad = 5
    Ap = torch.full((systems + pad, n, n), float("nan"), device=card)
    bp = torch.full((systems + pad, n), float("nan"), device=card)
    xp = torch.full((systems + pad, n), -7.0, device=card)
    Ap[:systems], bp[:systems] = A, b
    lib = lu.load().lib
    rc = lib.small_solve_f32(Ap.data_ptr(), bp.data_ptr(), xp.data_ptr(), n,
                             systems, int(lu.reciprocal_route(n)),
                             torch.cuda.current_stream(card).cuda_stream)
    assert rc == 0
    assert torch.equal(xp[:systems], x)
    assert bool((xp[systems:] == -7.0).all())
    # a grid past the limit in x is refused before any launch
    too_many = ctypes.c_longlong(4 * (2 ** 31 - 1) + 1)
    assert lib.small_solve_f32(None, None, None, n, too_many, 0, None) != 0


@pytest.mark.cuda
def test_small_solve_launcher_at_2_31_systems(card):
    """2^31 systems of one unknown in one launch (2^29 blocks): the grid
    arithmetic and the 64-bit system index past int32, x = b / a at the
    first, middle and last systems."""
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    systems = 2 ** 31
    free, _ = torch.cuda.mem_get_info(card)
    assert free > 3 * 4 * systems + 2 ** 30, "needs 25 GiB free on the card"
    A = torch.full((systems, 1, 1), 4.0, device=card)
    b = torch.full((systems, 1), 2.0, device=card)
    b[-1] = 6.0
    b[systems // 2 + 3] = -1.0
    x = lu.small_solve(A, b)
    torch.cuda.synchronize()
    assert float(x[0, 0]) == 0.5 and float(x[-1, 0]) == 1.5
    assert float(x[systems // 2 + 3, 0]) == -0.25
    assert int((x == 0.5).sum()) == systems - 2
    del A, b, x
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(7, 2), (12, 4), (8, 3)])
def test_vmapped_lanes_take_one_small_solve(card, n, B):
    """``torch.vmap`` of ``utils.linalg.solve`` on the card, as the batched
    surfaces call it: one small solve launch for every lane (A and b
    mapped, A alone mapped, and 2 x B lanes under nested maps), each lane
    bitwise ``torch.linalg.solve_ex`` on its system alone."""
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    from slam_eds_tpu_torch.utils.linalg import solve
    gen = torch.Generator().manual_seed(900 + n)
    A = chip_smoke.solve_systems("path", n, 2 * B, torch.float32, card, gen)
    b = torch.randn(2 * B, n, generator=gen).to(card)

    def alone(A, b):
        return torch.linalg.solve_ex(A, b[:, None],
                                     check_errors=False)[0][:, 0]
    for how in ("both", "A", "nested"):
        before = lu.small_solve.launches
        if how == "both":
            x = torch.vmap(solve)(A[:B], b[:B])
            want = [alone(A[i], b[i]) for i in range(B)]
        elif how == "A":
            x = torch.vmap(solve, in_dims=(0, None))(A[:B], b[0])
            want = [alone(A[i], b[0]) for i in range(B)]
        else:
            x = torch.vmap(torch.vmap(solve))(A.reshape(2, B, n, n),
                                              b.reshape(2, B, n))
            x = x.reshape(2 * B, n)
            want = [alone(A[i], b[i]) for i in range(2 * B)]
        assert lu.small_solve.launches - before == 1, how
        assert torch.equal(x, torch.stack(want)), how


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [2, 5])
def test_batched_event_lanes_are_bitwise_single_solves(card, iterations):
    """``eval.batched_event_solves`` on the card (one ``torch.vmap`` of the
    event LM: the plain pass, its reductions lane by lane, ``ops.lanes``;
    its solves one small solve launch for all lanes a pass): every lane
    bitwise the plain pass (``event_tracker._lm_solve_plain``, what
    ``optimize`` runs on CPU tensors) on its own inputs alone. A single
    ``optimize`` on the card takes the ``event_pass`` kernel, whose sums
    run in another order; the lanes keep the plain pass."""
    from slam_eds_tpu_torch import eval as ev
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    st, frame, (cam, nc, grad, idp, w, mask) = event_world(card)
    frames = torch.stack([frame, torch.roll(frame, 1, -1),
                          torch.roll(frame, 2, -2), frame * 0.5])
    B = len(frames)
    pts = (nc, grad, idp, w, mask)
    states = et.TrackerState(*(torch.stack([x] * B) for x in st))
    before = lu.small_solve.launches
    got = ev.batched_event_solves(
        states, frames, cam, *(torch.stack([a] * B) for a in pts),
        max_iterations=iterations, loss_scale=0.2)
    assert lu.small_solve.launches - before == iterations
    for b in range(B):
        one = et._lm_solve_plain(st, frames[b], cam, *pts, iterations,
                                 "huber", torch.tensor(0.2, device=card),
                                 1e-6, False)
        lane = ev._lane(got, b)
        for n in ("px", "qx", "vx"):
            assert torch.equal(getattr(lane.state, n), getattr(one.state, n))
        for n in ("energy", "residuals", "loss_scale", "n_iter"):
            assert torch.equal(getattr(lane, n), getattr(one, n)), n


def _sweep_systems(card, kind, n, dtype, seed, systems=8):
    gen = torch.Generator().manual_seed(seed)
    A = chip_smoke.solve_systems(kind, n, systems, dtype, card, gen)
    b = torch.randn(systems, n, generator=gen,
                    dtype=torch.float64).to(dtype).to(card)
    return A, b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["path", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_solve_is_solve_ex_at_every_size(card, dtype, kind):
    """``utils.linalg.solve`` on one system takes the small solve kernel
    at every n of 1..32 and is bitwise ``torch.linalg.solve_ex`` on that
    system, on both of ``chip_smoke.solve_systems``' draws; the sizes that
    are not are named."""
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    from slam_eds_tpu_torch.utils.linalg import solve
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    bad = []
    for n in range(1, lu.MAX_N + 1):
        A, b = _sweep_systems(card, kind, n, dtype, n)
        before = lu.small_solve.launches
        x = torch.stack([solve(A[i], b[i]) for i in range(len(A))])
        assert lu.small_solve.launches - before == len(A)
        want = torch.stack([torch.linalg.solve_ex(
            A[i], b[i][:, None], check_errors=False)[0][:, 0]
            for i in range(len(A))])
        if not torch.equal(x.view(ints), want.view(ints)):
            bad.append(n)
    assert not bad, f"not bitwise solve_ex at n = {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_solve_kernel_matches_its_plain_version(card, dtype):
    """The kernel over many systems in one launch (a warp each) against
    ``small_solve_reference``: within kappa n eps in the infinity norm
    (``chip_smoke.plain_gap``; the kernel fuses each product into its
    update, the plain version rounds it first), each system as if alone."""
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    for kind in ("path", "general"):
        for n in (1, 2, 5, 6, 7, 8, 9, 12, 16, 17, 31, 32):
            A, b = _sweep_systems(card, kind, n, dtype, 50 + n, systems=37)
            x = lu.small_solve_cuda(A, b)
            assert torch.isfinite(x).all()
            assert chip_smoke.plain_gap(
                x, lu.small_solve_reference(A, b), A) <= 1.0
            one = lu.small_solve_cuda(A[5].contiguous(), b[5].contiguous())
            assert torch.equal(one, x[5])


@pytest.mark.cuda
def test_small_solve_wrapper_rejects_what_the_kernel_does_not_take(card):
    from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
    A = torch.eye(6, device=card)
    b = torch.ones(6, device=card)
    with pytest.raises(ValueError):
        lu.small_solve_cuda(A.cpu(), b)
    with pytest.raises(TypeError):
        lu.small_solve_cuda(A.half(), b.half())
    with pytest.raises(TypeError):
        lu.small_solve_cuda(A, b.double())
    with pytest.raises(ValueError):
        lu.small_solve_cuda(A, torch.ones(5, device=card))
    with pytest.raises(ValueError):
        lu.small_solve_cuda(torch.eye(33, device=card),
                            torch.ones(33, device=card))
    with pytest.raises(ValueError):
        lu.small_solve_cuda(torch.eye(12, device=card).t()[:6, :6],
                            b)
    with pytest.raises(ValueError):
        lu.small_solve_cuda(A, torch.ones(12, device=card)[::2])


@pytest.mark.cuda
def test_converging_lm_runs_fewer_passes_than_its_cap(card):
    """The event LM on ``torch_world``'s scene, stopping at a relative
    energy change of 1e-3 (at the tracker's 1e-6 the stop is float32 noise
    on the card, and this scene runs to the cap there), converges before a
    cap of 40: the captured solve reads back fewer passes (``n_iter``, the
    loop's ``it``) than the cap, the same count as the eager run, and the
    same bits."""
    from slam_eds_tpu_torch import graphs
    ts, frame, args = event_world(card)
    cam = args[0]
    x = {"state": ts, "frame": frame, "args": list(args[1:])}

    def run(x):
        return et._lm_solve(x["state"], x["frame"], cam, *x["args"], 40,
                            "huber", 0.2, 1e-3, False)
    cache = graphs.GraphCache()
    cache.run("lm", run, x)
    got = graphs.copy_out(cache.run("lm", run, x))
    want = run(_contiguous(x))
    from torch.utils._pytree import tree_leaves
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    assert 1 <= int(got.n_iter) < 40


@pytest.mark.cuda
def test_if_node_on_false_leaves_its_carry(card):
    """``graphs.cond`` on a false predicate leaves the carry's buffers as
    they were; on a true one it runs the body."""
    from slam_eds_tpu_torch import graphs

    def fn(x):
        return graphs.cond(x["p"], lambda c: (c[0] * 3.0 + 1.0, c[1] - 2.0),
                           (x["a"], x["b"]))
    a = torch.arange(5, dtype=torch.float32, device=card)
    b = torch.ones(7, device=card)
    for taken in (False, True):
        cache = graphs.GraphCache()
        x = {"p": torch.full((), taken, device=card), "a": a, "b": b}
        cache.run("cond", fn, x)
        got = cache.run("cond", fn, x)
        want = (a * 3.0 + 1.0, b - 2.0) if taken else (a, b)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the coarse tracker's fused pass (csrc/coarse_pass.cu)
# ---------------------------------------------------------------------------

COARSE_LEVELS = 6


@pytest.fixture(scope="module")
def coarse_levels():
    """The six level templates of frame 0 of the smoke's 640x480 sequence
    (caps 8192 >> l, as the window builds them) and frame 2's pyramid, on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from slam_eds_tpu_torch.device import set_numerics
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch.ops import pixel_selector as psel
    from slam_eds_tpu_torch.utils import image as image_ops
    set_numerics()
    dev = torch.device("cuda")
    cam = chip_smoke.smoke_camera()
    seq = SyntheticSequence(cam, num_frames=4, motion_scale=0.22,
                            micro_steps=2, device=dev)
    _, img0, depth0 = seq.frame(0)
    _, img1, _ = seq.frame(2)
    pyr0 = image_ops.build_pyramid(img0, COARSE_LEVELS)[0]
    pyr1 = image_ops.build_pyramid(img1, COARSE_LEVELS)[0]
    uv, mask = psel.candidate_points_grid(
        image_ops.gradient_magnitude(pyr0[0][..., 1], pyr0[0][..., 2]),
        patch=4, capacity=8192)
    iy = torch.clamp(torch.round(uv[:, 1]).long(), 0, cam.height - 1)
    ix = torch.clamp(torch.round(uv[:, 0]).long(), 0, cam.width - 1)
    idp = 1.0 / depth0[iy, ix]
    tpls = ct.build_template(uv, idp, torch.ones_like(idp), mask, pyr0,
                             tuple(8192 >> l for l in range(COARSE_LEVELS)))
    return cam, tpls, pyr1


def _coarse_call(coarse_levels, lvl):
    from slam_eds_tpu_torch.utils.lie import SE3
    cam, tpls, pyr = coarse_levels
    dev = pyr[0].device
    pose = SE3.exp(torch.tensor([0.01, -0.02, 0.005, 0.002, -0.001, 0.003],
                                device=dev))
    return (tpls[lvl], pyr[lvl], cam.pyramid_level(lvl), pose,
            torch.tensor([0.05, 1.0], device=dev),
            (torch.ones((), device=dev), torch.full((), 1.1, device=dev)),
            torch.tensor([0.02, 0.5], device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("lvl", range(COARSE_LEVELS))
def test_coarse_pass_matches_plain_per_level(coarse_levels, lvl):
    """One launch linearizes a level as ``calc_res`` and ``calc_gs`` do on
    the same card tensors: H and b within 1e-5 of their terms' scale
    (``chip_smoke.coarse_system_gaps``), E within 1e-6 relative, the counts
    and the saturated share equal; two
    launches are bitwise equal (the sums' order is fixed, no float
    atomics)."""
    from slam_eds_tpu_torch.ops.kernels import coarse_pass as cp
    tpl, img, cam, pose, aff, exps, aff_ref = _coarse_call(coarse_levels,
                                                           lvl)
    level = cp.Level(tpl, img, cam, exps, aff_ref, 9.0, 20.0, 0.01, 0.001,
                     False, False)
    cutoff = torch.full((), 20.0, device=img.device)
    at = (pose.R, pose.t, aff)
    n0 = cp.coarse_pass.launches
    st = level.run("init", at, cutoff)
    again = level.run("init", at, cutoff)
    sat0 = level.run("sat0", at)
    assert cp.coarse_pass.launches == n0 + 3
    assert all(torch.equal(a, b) for a, b in zip(st, again))
    rel = ct.aff_from_to(exps[0], aff_ref, exps[1], aff)
    E, n, sat, buf = ct.calc_res(tpl, img, cam, pose, rel, 9.0, cutoff)
    H, b = ct.calc_gs(buf, cam, rel, aff_ref[1])
    f = st[0]
    assert int(f[cp.S_N]) == int(n) > 0
    assert abs(float(f[cp.S_E]) - float(E)) <= 1e-6 * abs(float(E))
    gaps = chip_smoke.coarse_system_gaps(
        f[cp.S_H:cp.S_B].view(8, 8), f[cp.S_B:cp.S_E], H, b, E,
        buf["mask"].sum())
    assert gaps["H"] <= 1e-5 and gaps["b"] <= 1e-5, gaps
    assert float(sat0[0][1]) == float(sat)
    assert not bool(st[2]) and int(st[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("lvl", range(COARSE_LEVELS))
def test_fused_track_level_is_the_plain_track_on_the_card(coarse_levels,
                                                          lvl):
    """The whole level (escalation, LM, last residuals) by the kernel
    against ``track_level_plain`` on the same card tensors: the same
    doublings, the pose within 1e-4, the rms within 1e-4 relative; two
    runs bitwise equal."""
    args = _coarse_call(coarse_levels, lvl)
    kw = dict(max_iterations=30, huber_th=9.0, cutoff_th=20.0)
    got = ct.track_level(*args, **kw)
    again = ct.track_level(*args, **kw)
    from torch.utils._pytree import tree_leaves
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(again)))
    want = ct.track_level_plain(*args, **kw)
    assert int(got[5][0]) == int(want[5][0])
    assert float((got[0].R - want[0].R).abs().max()) <= 1e-4
    assert float((got[0].t - want[0].t).abs().max()) <= 1e-4
    assert abs(float(got[2]) - float(want[2])) <= 1e-4 * float(want[2])
    assert bool(got[4]) == bool(want[4])


@pytest.mark.cuda
def test_captured_coarse_track_runs_one_launch_a_pass(coarse_levels,
                                                      monkeypatch):
    """``track_newest_coarse`` captured: each of its twelve WHILE bodies
    (a level's doublings and LM) holds two graph nodes, the kernel and the
    pass tail; bitwise its eager run; the kernel's launches run are one a
    cutoff doubling and one an LM pass that ran (``TrackResult.passes``)
    plus three a level (``graphs.launch_ledger``); its slots count every
    pass the caps allow."""
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.ops.kernels import coarse_pass as cp
    from slam_eds_tpu_torch.utils.lie import SE3
    cam, tpls, pyr = coarse_levels
    dev = pyr[0].device
    cams = [cam.pyramid_level(l) for l in range(COARSE_LEVELS)]
    iters = (10, 20, 50, 50, 50, 50)

    def run(x):
        return ct.track_newest_coarse(
            x["tpls"], x["pyr"], cams, SE3(x["R"], x["t"]), x["aff"],
            (x["e"], x["e"]), x["aff"], x["abort"], max_iterations=iters)
    x = {"tpls": list(tpls), "pyr": list(pyr),
         "R": torch.eye(3, device=dev), "t": torch.zeros(3, device=dev),
         "aff": torch.zeros(2, device=dev), "e": torch.ones((), device=dev),
         "abort": torch.full((COARSE_LEVELS,), 1e9, device=dev)}
    counted = []

    def nodes(stream, orig=graphs.capture_nodes):
        counted.append(orig(stream))
        return counted[-1]
    monkeypatch.setattr(graphs, "capture_nodes", nodes)
    cache = graphs.GraphCache()
    cache.run("coarse", run, x)
    # the bodies' counts, then the program's own level
    assert counted[:-1] == [2] * (2 * COARSE_LEVELS), counted
    before = graphs.launch_ledger()
    got = graphs.copy_out(cache.run("coarse", run, x))
    ran = graphs.ledger_delta(before, graphs.launch_ledger())["coarse_pass"]
    want = run(_contiguous(x))
    from torch.utils._pytree import tree_leaves
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))
    passes = int(got.passes.sum())
    assert ran["run"] == passes + 3 * COARSE_LEVELS
    assert ran["slots"] == (3 + ct.CUTOFF_DOUBLINGS) * COARSE_LEVELS \
        + sum(iters)
    assert cp.coarse_pass in graphs.counters()


# ---------------------------------------------------------------------------
# the event LM's fused pass (csrc/event_pass.cu)
# ---------------------------------------------------------------------------

EVENT_LEVELS = 3
EVENT_POINTS = ("kf_nc", "kf_grad", "kf_idp", "kf_weight", "kf_mask")


@pytest.fixture(scope="module")
def event_levels():
    """The packet step's inputs after frame 4 of the smoke's 640x480
    sequence (2,048 keyframe point slots, the packet of frames 4-5 made
    into its three event-frame levels), on the card: (cam, frames [3, H,
    W], the step's inputs, the level caps, the loss kind)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from slam_eds_tpu_torch.device import set_numerics
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch.models import pipeline as pl
    set_numerics()
    dev = torch.device("cuda")
    cam = chip_smoke.smoke_camera()
    seq = SyntheticSequence(cam, num_frames=6, motion_scale=0.22,
                            micro_steps=2,
                            events_per_packet=chip_smoke.EVENT_CAP,
                            device=dev)
    pipe = pl.EDSPipeline(cam, chip_smoke.eds_config(), device=dev)
    for k in range(5):
        t, img = seq.frame(k)[:2]
        pipe.process_frame(img, t)
        if k < 4 and pipe.kf is not None:
            pipe.process_events(seq.events_between(k, k + 1))
    assert pipe.kf is not None
    x = _contiguous(pipe.packet_inputs(seq.events_between(4, 5)))
    lim, iters, statics = pipe._packet_step_args()
    frames, _, _ = pl._event_packet_head(
        x["xs"], x["ys"], x["ts"], x["ps"], x["n_valid"], x["fwd_maps"],
        x["kf_idp"], x["kf_mask"], lim,
        **{k: statics[k] for k in pl.HEAD_STATICS})
    assert frames.shape[0] == EVENT_LEVELS
    assert x["kf_idp"].shape[0] == 2048
    return cam, frames, x, iters, statics["loss_kind"]


def _event_call(event_levels, lvl, slots, loss_kind=None):
    """One level's ``_lm_solve`` arguments at the first ``slots`` point
    slots."""
    cam, frames, x, iters, kind = event_levels
    pts = tuple(x[k][:slots].contiguous() for k in EVENT_POINTS)
    return (x["state"], frames[lvl].contiguous(), cam, *pts, iters[lvl],
            loss_kind or kind, x["loss_scale"], 1e-6, False)


# chip_smoke's tolerances of one launch against the plain version (the
# sums' order; the damped solve's weakly determined directions)
EVENT_SUM_TOL = chip_smoke.EVENT_SUM_TOL
EVENT_STEP_TOL = chip_smoke.EVENT_STEP_TOL


def _check_level(args):
    """``chip_smoke.event_pass_gaps`` held: the energies, H, g and the
    final residuals within ``EVENT_SUM_TOL``, the state after a pass within
    ``EVENT_STEP_TOL``, lambda, the count and done as the plain pass's, two
    launches of each mode bitwise."""
    import json
    gaps = chip_smoke.event_pass_gaps(args)[0]
    msg = json.dumps(gaps)
    assert gaps["bitwise"] and gaps["lambda_equal"], msg
    assert gaps["count_equal"] and gaps["done_equal"], msg
    assert max(gaps[k] for k in ("E0", "E1", "H", "b", "residuals")) \
        <= EVENT_SUM_TOL, msg
    assert gaps["state"] <= EVENT_STEP_TOL, msg


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [256, 2048])
@pytest.mark.parametrize("lvl", range(EVENT_LEVELS))
def test_event_pass_matches_plain_per_level(event_levels, lvl, slots):
    """Each level's frame, at 256 and 2,048 slots: the start energy and
    the candidate's within ``EVENT_SUM_TOL`` relative, H and g within it of
    their terms' scale (``chip_smoke.coarse_system_gaps``), the final
    residuals within it of theirs (``chip_smoke.event_residual_scale``),
    the state after one pass within ``EVENT_STEP_TOL``, lambda, the count
    and done equal; two launches of each mode bitwise (the sums' order is
    fixed, no float atomics)."""
    _check_level(_event_call(event_levels, lvl, slots))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,norm_event", [("cauchy", False),
                                             ("none", False),
                                             ("huber", True)])
def test_event_pass_options_match_plain(event_levels, kind, norm_event):
    """The robust losses the kernel takes as template flags, and the
    normalized-event cost, at level 0 and 2,048 slots, as above."""
    args = list(_event_call(event_levels, 0, 2048, kind))
    args[-1] = norm_event
    _check_level(tuple(args))


@pytest.mark.cuda
@pytest.mark.parametrize("lvl", range(EVENT_LEVELS))
def test_fused_event_lm_solve_is_the_plain_solve_on_the_card(event_levels,
                                                             lvl):
    """A whole level to its cap on the kernel, every pass against the plain
    pass from the same carry (``chip_smoke.event_forced_passes``): the
    state within ``EVENT_STEP_TOL``, the energy within ``EVENT_SUM_TOL``,
    lambda, the accept test, done and the count equal at every pass. Then
    ``_lm_solve`` (the kernel) and ``_lm_solve_plain`` run apart: the same
    passes, the final energies within ``chip_smoke.EVENT_SOLVE_TOL`` (the
    two trajectories part along the LM's weak directions, as the plain
    pass parts from itself under another summation order); two runs of
    the kernel bitwise."""
    args = _event_call(event_levels, lvl, 2048)
    forced = chip_smoke.event_forced_passes(args)
    assert forced["agree"], forced
    assert forced["state"] <= EVENT_STEP_TOL, forced
    assert forced["energy"] <= EVENT_SUM_TOL, forced
    assert "a" in forced["passes"], forced
    got = et._lm_solve(*args)
    again = et._lm_solve(*args)
    from torch.utils._pytree import tree_leaves
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(again)))
    want = et._lm_solve_plain(*args)
    assert int(got.n_iter) == int(want.n_iter)
    assert abs(float(got.energy - want.energy)) \
        <= chip_smoke.EVENT_SOLVE_TOL * float(want.energy)


@pytest.mark.cuda
def test_fused_event_pyramid_is_the_plain_pyramid_on_the_card(event_levels,
                                                              monkeypatch):
    """The packet's whole coarse-to-fine solve, ``_pyramid_fused`` on the
    kernel against the plain route, run apart: the same finest-level
    passes, the final energies within ``chip_smoke.EVENT_SOLVE_TOL`` (the
    reason above: three levels chain the state and the MAD scale of two
    trajectories that part along the weak directions)."""
    cam, frames, x, iters, kind = event_levels
    args = (x["state"], frames, cam, *(x[k] for k in EVENT_POINTS), iters,
            kind, x["loss_scale"], False)
    got = et._pyramid_fused(*args)
    monkeypatch.setattr(et, "_lm_solve", et._lm_solve_plain)
    want = et._pyramid_fused(*args)
    assert int(got.n_iter) == int(want.n_iter)
    assert abs(float(got.energy - want.energy)) \
        <= chip_smoke.EVENT_SOLVE_TOL * float(want.energy)


@pytest.mark.cuda
def test_event_pass_edge_slots(event_levels):
    """Masked slots with far, finite junk and one whose projection is not
    finite, and a live slot behind the camera: the launches match the
    plain version as above. A live slot whose projection is not finite
    makes both energies NaN, and the pass then refuses its step: the state
    bitwise as given, the count advanced, lambda x4. A pass of a done carry
    returns it bitwise."""
    from slam_eds_tpu_torch.ops.kernels import event_pass as ep
    st, frame, cam, nc, grad, idp, w, mask, *rest = _event_call(
        event_levels, 0, 256)
    nc, grad, idp, w, mask = (t.clone() for t in (nc, grad, idp, w, mask))
    mask[:3] = torch.tensor([False, False, True])
    idp[:3] = torch.tensor([-0.5, -1e-5, -0.5])
    grad[0], nc[0], w[0] = 1e3, 3.0, 5.0
    args = (st, frame, cam, nc, grad, idp, w, mask, *rest)
    _check_level(args)

    mask[1] = True
    level = ep.Level(frame, cam, nc, grad, idp, w, mask, rest[1], rest[2],
                     rest[3], rest[4])
    init = level.run("init", tuple(x.contiguous() for x in st))
    assert torch.isnan(init[0][ep.S_E])
    f, it, done = level.run("lm", carry=init)
    assert torch.equal(f[:ep.S_LAM], init[0][:ep.S_LAM])
    assert float(f[ep.S_LAM]) == float(init[0][ep.S_LAM] * 4.0)
    assert int(it) == 1 and not bool(done)

    mask[1] = False
    level = ep.Level(frame, cam, nc, grad, idp, w, mask, rest[1], rest[2],
                     rest[3], rest[4])
    f0 = torch.randn(ep.STATE, device=frame.device)
    carry = (f0, torch.full((), 7, dtype=torch.int32, device=frame.device),
             torch.ones((), dtype=torch.bool, device=frame.device))
    out = level.run("lm", carry=carry)
    assert all(torch.equal(a, b) for a, b in zip(out, carry))


@pytest.mark.cuda
def test_captured_event_lm_runs_one_launch_a_pass(event_levels,
                                                  monkeypatch):
    """One level's ``_lm_solve`` captured: its WHILE body holds two graph
    nodes, the kernel and the pass tail; bitwise its eager run; the
    kernel's launches run are one an LM pass that ran (``n_iter``) and two
    for the level (``graphs.launch_ledger``); its slots count every pass
    the cap allows."""
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.ops.kernels import event_pass as ep
    st, frame, cam, *pts, cap, kind, loss, tol, ne = _event_call(
        event_levels, 0, 2048)
    cap = 40

    def run(x):
        return et._lm_solve(x["state"], x["frame"], cam, *x["pts"], cap,
                            kind, x["loss"], 1e-3, ne)
    x = {"state": st, "frame": frame, "pts": list(pts), "loss": loss}
    counted = []

    def nodes(stream, orig=graphs.capture_nodes):
        counted.append(orig(stream))
        return counted[-1]
    monkeypatch.setattr(graphs, "capture_nodes", nodes)
    cache = graphs.GraphCache()
    cache.run("event_lm", run, x)
    assert counted[0] == 2, counted
    before = graphs.launch_ledger()
    got = graphs.copy_out(cache.run("event_lm", run, x))
    ran = graphs.ledger_delta(before, graphs.launch_ledger())["event_pass"]
    want = run(_contiguous(x))
    from torch.utils._pytree import tree_leaves
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))
    assert 1 <= int(got.n_iter) < cap
    assert ran["run"] == int(got.n_iter) + 2
    assert ran["slots"] == cap + 2
    assert ep.event_pass in graphs.counters()


@pytest.mark.cuda
def test_event_pass_wrapper_rejects_what_the_kernel_does_not_take(
        event_levels):
    from slam_eds_tpu_torch.ops.kernels import event_pass as ep
    st, frame, cam, *pts, _, kind, loss, tol, ne = _event_call(
        event_levels, 0, 256)
    with pytest.raises(ValueError, match="CUDA"):
        ep.Level(frame.cpu(), cam, *(p.cpu() for p in pts), kind,
                 loss.cpu(), tol, ne)
    with pytest.raises(TypeError):
        ep.Level(frame.double(), cam, *pts, kind, loss, tol, ne)
    with pytest.raises(ValueError):
        ep.Level(frame, cam, pts[0][:, :1].contiguous(), *pts[1:], kind,
                 loss, tol, ne)
    with pytest.raises(ValueError):
        ep.Level(frame, cam, *pts, kind, loss.double(), tol, ne)


# ---------------------------------------------------------------------------
# the seam between the pipelines and the card (graphs.run, graphs.eagerly)
# ---------------------------------------------------------------------------

def _cell_pipe(dev, cell, frames, packets):
    """The smoke's frame cell (``FrameOnlyPipeline``, the default config)
    or event cell (``EDSPipeline``, 65,536-event packets) over ``frames``,
    each packet fed after its frame."""
    from slam_eds_tpu_torch.config import EDSConfig
    from slam_eds_tpu_torch.models.pipeline import (EDSPipeline,
                                                    FrameOnlyPipeline)
    cam = chip_smoke.smoke_camera()
    if cell == "frame":
        pipe = FrameOnlyPipeline(cam, EDSConfig(), device=dev)
        for t, img in frames:
            pipe.process_frame(img, t)
        return pipe
    pipe = EDSPipeline(cam, chip_smoke.eds_config(), device=dev)
    for k, (t, img) in enumerate(frames):
        pipe.process_frame(img, t)
        if k + 1 < len(frames) and pipe.kf is not None:
            pipe.process_events(packets[k])
    return pipe


def seam_cells(dev):
    """Each cell over the smoke's 32 frames twice, each time in a new
    pipeline (the first run warms and captures every program, the second
    only replays): {cell: (the second run's pipeline, its launch ledger
    delta without the counters that did not move, its per-frame poses,
    the last frame's image)}.
    Uses only what the pipelines, ``graphs`` and the smoke have long
    offered, so that an older checkout reads the same numbers."""
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    cam = chip_smoke.smoke_camera()
    seq = SyntheticSequence(cam, num_frames=chip_smoke.PIPE_FRAMES,
                            motion_scale=0.22, micro_steps=2, device=dev)
    frame_cell = [seq.frame(k)[:2] for k in range(chip_smoke.PIPE_FRAMES)]
    _, _, event_frames, packets = chip_smoke.eds_inputs(dev)
    out = {}
    for cell, frames in (("frame", frame_cell), ("event", event_frames)):
        _cell_pipe(dev, cell, frames, packets)
        before = graphs.launch_ledger()
        pipe = _cell_pipe(dev, cell, frames, packets)
        delta = graphs.ledger_delta(before, graphs.launch_ledger())
        fp = pipe if cell == "frame" else pipe.frame_pipe
        poses = [torch.cat([T.R.reshape(-1), T.t]) for T in fp.poses]
        if cell == "event":
            poses += [torch.cat([T.R.reshape(-1), T.t])
                      for T in pipe.event_pose_list]
        out[cell] = (pipe, {k: v for k, v in delta.items()
                            if v != {"slots": 0, "run": 0}},
                     torch.stack(poses).cpu().numpy(), frames[-1][1])
    return out


# ``seam_cells``' launch ledger deltas read at the commit before the steps
# went through ``graphs.run`` (ec6db4d; torch 2.11, CUDA 12.8, an H100)
PARENT_LEDGER = {
    "frame": {
        "coarse_pass": {"slots": 12212, "run": 3793},
        "pass_tail": {"slots": 11492, "run": 3073},
        "pattern_sample": {"slots": 63, "run": 63},
        "set_condition": {"slots": 525, "run": 525},
        "small_solve": {"slots": 54, "run": 54},
        "small_solve_n7": {"slots": 54, "run": 54},
    },
    "event": {
        "coarse_pass": {"slots": 9088, "run": 2198},
        "event_pass": {"slots": 4140, "run": 1422},
        "pass_tail": {"slots": 12166, "run": 2909},
        "pattern_sample": {"slots": 63, "run": 60},
        "rasterize_bilinear": {"slots": 30, "run": 30},
        "set_condition": {"slots": 723, "run": 517},
        "small_solve": {"slots": 54, "run": 51},
        "small_solve_n7": {"slots": 54, "run": 51},
    },
}


@pytest.fixture(scope="module")
def seam():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from slam_eds_tpu_torch.device import set_numerics
    set_numerics()
    return seam_cells(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["frame", "event"])
def test_window_programs_run_eagerly_are_bitwise_their_replays(seam, cell):
    """At the end of each cell the window's ``track_frame`` (from the
    pipeline's last pose: the event tracker's seeds it transposed) and
    ``ba`` programs: replayed through ``graphs.run``, and run eagerly in
    ``graphs.eagerly()``, which captures and replays nothing. Under
    ``torch.inference_mode``, as the pipelines run (their programs' buffers
    are inference tensors)."""
    from slam_eds_tpu_torch import graphs
    from torch.utils._pytree import tree_leaves
    pipe, _, _, img = seam[cell]
    fp = pipe if cell == "frame" else pipe.frame_pipe
    win = fp.window
    x, static = win.track_inputs(img, fp._last_pose)
    xb, kw = win.ba_inputs()
    for name, step in (("track_frame", lambda: win.run_track(x, static)),
                       ("ba", lambda: win.run_ba(xb, kw))):
        programs, replays = len(graphs.CACHE.programs), \
            graphs.CACHE.replays()
        with torch.inference_mode():
            got = step()
        assert graphs.CACHE.replays() == replays + 1, name
        with graphs.eagerly(), torch.inference_mode():
            want = step()
        assert graphs.CACHE.replays() == replays + 1, name
        assert len(graphs.CACHE.programs) == programs, name
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_coarse_init_track_run_eagerly_is_bitwise_its_replay(card):
    """The ``dso`` initializer's ``track_frame`` (``coarse_init_track``) on
    the smoke's frames, the new frame's pyramid in a strided layout: its
    replay and its eager run in ``graphs.eagerly()`` (both on contiguous
    copies) give the same bits and the same verdict."""
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.config import EDSConfig
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch.ops import coarse_init as ci
    from slam_eds_tpu_torch.utils import image as image_ops
    from torch.utils._pytree import tree_leaves
    cam = chip_smoke.smoke_camera()
    seq = SyntheticSequence(cam, num_frames=6, motion_scale=0.22,
                            micro_steps=2, device=card)
    levels = EDSConfig().initializer.pyr_levels

    def pyr(k):
        return image_ops.build_pyramid(seq.frame(k)[1], levels)[0]
    state = ci.set_first(pyr(0))
    for k in range(1, 4):
        state, _ = ci.track_frame(state, pyr(k), cam)
    strided = [p.permute(2, 0, 1).contiguous().permute(1, 2, 0)
               for p in pyr(4)]
    assert not strided[0].is_contiguous()
    replays = graphs.CACHE.replays()
    got = ci.track_frame(state, strided, cam)
    assert graphs.CACHE.replays() == replays + 1
    with graphs.eagerly():
        want = ci.track_frame(state, strided, cam)
    assert graphs.CACHE.replays() == replays + 1
    assert got[1] == want[1]
    for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["frame", "event"])
def test_launch_ledger_over_a_cell_is_the_parents(seam, cell):
    """Every kernel's launch slots and launches run over a whole warm run
    of each cell are what they were before the pipelines' steps went
    through ``graphs.run`` (``PARENT_LEDGER``)."""
    assert seam[cell][1] == PARENT_LEDGER[cell]
