"""The event LM's fused pass (``ops/kernels/event_pass.py``,
``csrc/event_pass.cu``) on the CPU.

* CPU tensors take the plain version: ``_lm_solve``, ``optimize`` and
  ``_pyramid_fused`` are bitwise ``_lm_solve_plain`` (the former loop) on
  ``torch_world.event_world``'s scene, with each robust loss, with and
  without the normalized-event cost, and launch nothing.
* The route: CUDA tensors of one unsharded solve outside ``torch.vmap``
  take the kernel; ``reduce`` or ``gather`` (the sharded solve) or a
  ``torch.vmap`` lane (``eval.batched_event_solves``) take the plain pass.
* ``_lm_solve_fused``'s loop (the carry's layout, the modes' order, the
  stop, the final residuals and the MAD) with every launch replaced by
  ``EmulatedLevel``, the kernel's modes in the plain version's torch ops:
  bitwise ``_lm_solve_plain``, masked or with the passes after the stop
  skipped, read-free, and chained over a pyramid's levels.
* The wrapper raises on what the kernel does not take, and its launches
  are counted with the other kernels' (``graphs.counters()``).

The kernel itself against the plain version runs on the card:
``tests/test_torch_kernels_cuda.py``.
"""
import ctypes
from types import SimpleNamespace

import pytest
import torch
from torch.utils._pytree import tree_leaves

from slam_eds_tpu_torch import graphs
from slam_eds_tpu_torch.ops import event_tracker as et
from slam_eds_tpu_torch.ops.kernels import event_pass as ep
from torch_guard import no_host_reads, skipped_passes
from torch_world import event_world

torch.set_num_threads(1)

# (loss_kind, norm_event)
OPTIONS = [("huber", False), ("cauchy", False), ("none", False),
           ("huber", True)]


def _bitwise(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.fixture(scope="module")
def scene():
    return event_world("cpu")


def _solve_args(scene, opts, max_iterations=12, tol=1e-6):
    st, frame, (cam, *pts) = scene
    loss_kind, norm_event = opts
    # a start away from the answer, so the LM takes and refuses steps
    start = st._replace(px=st.px + torch.tensor([0.01, -0.005, 0.004]))
    return (start, frame, cam, *pts, max_iterations, loss_kind,
            torch.tensor(0.2), tol, norm_event)


class EmulatedLevel:
    """``event_pass.Level`` with each launch done in the plain version's
    torch ops (``_plain_lm``), in the kernel's carry: what one launch of
    each mode returns, to the plain version's bits."""

    def __init__(self, frame, cam, norm_coord, grad, idp, weights, mask,
                 loss_kind, loss_scale, function_tolerance, norm_event):
        ep.check_level(frame, norm_coord, grad, idp, weights, mask)
        self.lm = et._plain_lm(frame, cam, norm_coord, grad, idp, weights,
                               mask, loss_kind, loss_scale,
                               function_tolerance, norm_event)

    @staticmethod
    def _pack(st, lam, energy):
        return torch.cat([st.px, st.qx, st.vx, lam[None], energy[None]])

    def run(self, mode, state=None, carry=()):
        if mode == "init":
            st = et.TrackerState(*state)
            return (self._pack(st, torch.full((), 1e-4),
                               self.lm.energy_of(self.lm.residuals(st))),
                    torch.zeros((), dtype=torch.int32),
                    torch.zeros((), dtype=torch.bool))
        f, it, done = carry
        st = et.TrackerState(f[ep.S_PX:ep.S_QX], f[ep.S_QX:ep.S_VX],
                             f[ep.S_VX:ep.S_LAM])
        if mode == "final":
            return self.lm.residuals(st)
        st, lam, energy, it, done = self.lm.lm_pass(
            None, (st, f[ep.S_LAM], f[ep.S_E], it, done))
        return self._pack(st, lam, energy), it, done


@pytest.mark.parametrize("opts", OPTIONS)
def test_cpu_lm_solve_is_the_plain_version(scene, opts):
    args = _solve_args(scene, opts)
    n0 = ep.event_pass.launches
    _bitwise(et._lm_solve(*args), et._lm_solve_plain(*args))
    assert ep.event_pass.launches == n0


def test_cpu_pyramid_launches_nothing(scene, monkeypatch):
    st, frame, (cam, *pts) = scene
    frames = torch.stack([frame, 0.5 * frame, torch.roll(frame, 1, -1)])
    n0 = ep.event_pass.launches
    got = et._pyramid_fused(st, frames, cam, *pts, [4, 6, 8], "huber", 0.2,
                            False)
    assert ep.event_pass.launches == n0
    monkeypatch.setattr(et, "_lm_solve", et._lm_solve_plain)
    _bitwise(got, et._pyramid_fused(st, frames, cam, *pts, [4, 6, 8],
                                    "huber", 0.2, False))


def test_route_follows_the_call():
    card = SimpleNamespace(is_cuda=True)
    cpu = SimpleNamespace(is_cuda=False)
    assert et._fused_route(card, None, None)
    assert not et._fused_route(cpu, None, None)
    assert not et._fused_route(card, lambda x: x, None)
    assert not et._fused_route(card, None, lambda x: x)
    seen = []

    def lane(x):
        seen.append(et._fused_route(card, None, None))
        return x
    torch.vmap(lane)(torch.zeros(2, 3))
    assert seen == [False]


@pytest.mark.parametrize("opts", OPTIONS)
def test_fused_loop_is_the_plain_loop(scene, opts, monkeypatch):
    """``_lm_solve_fused`` with the kernel's modes done in torch ops is
    bitwise ``_lm_solve_plain``: masked, with the passes after the stop
    skipped (as a captured loop skips them), and read-free."""
    args = _solve_args(scene, opts)
    want = et._lm_solve_plain(*args)
    monkeypatch.setattr(ep, "Level", EmulatedLevel)
    _bitwise(et._lm_solve_fused(*args), want)
    with skipped_passes() as runs:
        skipped = et._lm_solve_fused(*args)
    _bitwise(skipped, want)
    assert runs == [(int(want.n_iter), args[8])]
    with no_host_reads():
        again = et._lm_solve_fused(*args)
    _bitwise(again, want)


def test_fused_loop_stops_before_its_cap(scene, monkeypatch):
    """At a relative tolerance of 1e-3 the loop stops before a cap of 40,
    so the equality above covers carries after the stop; at the tracker's
    1e-6 it runs to the cap of 12, which covers the cap."""
    monkeypatch.setattr(ep, "Level", EmulatedLevel)
    args = _solve_args(scene, OPTIONS[0], max_iterations=40, tol=1e-3)
    with skipped_passes() as runs:
        got = et._lm_solve_fused(*args)
    _bitwise(got, et._lm_solve_plain(*args))
    (ran, cap), = runs
    assert 1 <= ran < cap == 40
    with skipped_passes() as runs:
        et._lm_solve_fused(*_solve_args(scene, OPTIONS[0]))
    assert runs == [(12, 12)]


def test_fused_pyramid_is_the_plain_pyramid(scene, monkeypatch):
    """``_pyramid_fused`` with every level's solve on the fused route (the
    emulated kernel) chains the state views and the MAD scale as the plain
    route does, to the same bits."""
    st, frame, (cam, *pts) = scene
    frames = torch.stack([frame, 0.5 * frame, torch.roll(frame, 1, -1)])

    def run():
        return et._pyramid_fused(st, frames, cam, *pts, [4, 6, 8], "huber",
                                 0.2, False)
    monkeypatch.setattr(et, "_lm_solve", et._lm_solve_plain)
    want = run()
    monkeypatch.setattr(ep, "Level", EmulatedLevel)
    monkeypatch.setattr(
        et, "_lm_solve", lambda *a: et._lm_solve_fused(*a))
    _bitwise(run(), want)


def _points(n=64, **change):
    fields = dict(norm_coord=torch.zeros(n, 2), grad=torch.zeros(n, 2),
                  idp=torch.ones(n), weights=torch.ones(n),
                  mask=torch.ones(n, dtype=torch.bool))
    return {**fields, **change}


@pytest.mark.parametrize("frame,pts,err", [
    (torch.zeros(8, 8), _points(idp=torch.ones(64, dtype=torch.float64)),
     TypeError),
    (torch.zeros(8, 8), _points(mask=torch.ones(64)), TypeError),
    (torch.zeros(8, 8, dtype=torch.float16), _points(), TypeError),
    (torch.zeros(8, 8), _points(weights=torch.ones(32)), ValueError),
    (torch.zeros(8, 8), _points(norm_coord=torch.zeros(64, 3)), ValueError),
    (torch.zeros(8, 8), _points(grad=torch.zeros(64)), ValueError),
    (torch.zeros(8, 8, 2), _points(), ValueError),
    (torch.zeros(8, 8), _points(idp=torch.ones(128)[::2]), ValueError),
    (torch.zeros(8, 16)[:, ::2], _points(), ValueError),
    (torch.zeros(8, 8), _points(n=ep.MAX_SLOTS + 1), ValueError),
    (torch.zeros(8, 8), _points(n=0), ValueError),
    (torch.zeros(8, 8, device="meta"), _points(), ValueError),
], ids=["idp_float64", "mask_float", "frame_float16", "ragged",
        "coords_3", "grad_1d", "frame_3d", "idp_strided", "frame_strided",
        "cap", "empty", "other_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(frame, pts, err):
    with pytest.raises(err):
        ep.check_level(frame, **pts)


def test_wrapper_launches_on_a_card_only(scene):
    _, _, (cam, *_) = scene
    with pytest.raises(ValueError, match="CUDA"):
        ep.Level(torch.zeros(8, 8), cam, **_points(), loss_kind="huber",
                 loss_scale=torch.tensor(0.2), function_tolerance=1e-6,
                 norm_event=False)


def test_event_pass_is_counted():
    assert ep.event_pass in graphs.counters()
    assert ep.event_pass.__name__ == "event_pass"
    assert "event_pass" in graphs.launch_ledger()


def test_argument_struct_matches_the_kernel_layout():
    """``_Args`` mirrors ``EventArgs``: 17 pointers, then 4 ints and 5
    floats, padded to the pointers' alignment as the C struct is."""
    assert ep._Args.slots.offset == 17 * 8
    assert ep._Args.fx.offset == 17 * 8 + 4 * 4
    assert ep._Args.tol.offset == ep._Args.fx.offset + 4 * 4
    assert ctypes.sizeof(ep._Args) == 176
    assert (ep.H_UPPER, ep.G, ep.E_NEW, ep.STEP, ep.SYSTEM) == \
        (0, 78, 90, 91, 103)
