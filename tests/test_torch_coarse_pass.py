"""The coarse tracker's fused pass (``ops/kernels/coarse_pass.py``,
``csrc/coarse_pass.cu``) on the CPU.

* CPU tensors take the plain version: ``track_level`` and
  ``track_newest_coarse`` are bitwise ``track_level_plain`` (today's loops
  of ``calc_res`` / ``calc_gs``) on ``test_torch_device_loops``'s coarse
  scene, at the default cutoff and at one low enough that the escalation
  doubles, with the affine parameters fixed or scaled, and launch nothing.
* ``track_level_fused``'s loops (the carry that holds the next pass's
  candidate, the modes' order, the stop) with every launch replaced by
  ``EmulatedLevel``, the kernel's modes in the plain version's torch ops:
  bitwise ``track_level_plain``, masked or with the passes after the stop
  skipped, and read-free.
* The wrapper raises on what the kernel does not take, and its launches
  are counted with the other kernels' (``graphs.counters()``).

The kernel itself against the plain version runs on the card:
``tests/test_torch_kernels_cuda.py``.
"""
import ctypes

import pytest
import torch
from torch.utils._pytree import tree_leaves

from slam_eds_tpu_torch import graphs
from slam_eds_tpu_torch.ops import coarse_tracker as ct
from slam_eds_tpu_torch.ops.kernels import coarse_pass as cp
from slam_eds_tpu_torch.utils.lie import SE3
from test_torch_device_loops import TCAM, T, coarse_scene  # noqa: F401
from torch_guard import no_host_reads, skipped_passes

torch.set_num_threads(1)

# (cutoff_th, huber_th, fix_a, fix_b, scale_a, scale_b)
OPTIONS = [(20.0, 9.0, False, False, 1.0, 1.0),
           (1.5, 0.5, False, False, 1.0, 1.0),
           (20.0, 9.0, True, True, 1.0, 1.0),
           (3.0, 0.5, True, False, 1.0, 1.0),
           (20.0, 9.0, False, True, 2.0, 0.5)]


def _bitwise(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _level_args(scene, lvl, opts, max_iterations=30):
    _, tt, pyr = scene
    cutoff_th, huber_th, fix_a, fix_b, scale_a, scale_b = opts
    # a start away from the answer, so the LM takes and refuses steps
    pose0 = SE3.exp(torch.tensor([0.01, -0.02, 0.005, 0.002, -0.001, 0.003]))
    args = (tt[lvl], T(pyr[lvl]), TCAM.pyramid_level(lvl), pose0,
            torch.tensor([0.05, 1.0]),
            (torch.ones(()), torch.full((), 1.1)), torch.tensor([0.02, 0.5]))
    kw = dict(max_iterations=max_iterations, huber_th=huber_th,
              cutoff_th=cutoff_th, fix_a=fix_a, fix_b=fix_b,
              scale_a=scale_a, scale_b=scale_b)
    return args, kw


class EmulatedLevel:
    """``coarse_pass.Level`` with each launch done in the plain version's
    torch ops (``calc_res``, ``calc_gs``, the step of
    ``track_level_plain``), in the kernel's carries: what one launch of
    each mode returns, to the plain version's bits."""

    def __init__(self, tpl, img, cam, exposures, aff_ref, huber_th,
                 cutoff_th, lambda_init, lambda_extrap_limit, fix_a, fix_b,
                 scale=(1.0, 1.0)):
        cp.check_level(tpl, img)
        self.tpl, self.img, self.cam = tpl, img, cam
        self.exp_ref, self.exp_new = exposures
        self.aff_ref, self.huber, self.cutoff_th = aff_ref, huber_th, cutoff_th
        self.lambda_init, self.lel = lambda_init, lambda_extrap_limit
        self.fix_a, self.fix_b = fix_a, fix_b
        S = torch.ones(8)
        if scale != (1.0, 1.0):
            S = torch.cat([S[:6], torch.full((1,), scale[0]),
                           torch.full((1,), scale[1])])
        self.S = S
        n_tpl = torch.sum(tpl.mask)
        self.n_floor = torch.clamp(0.2 * n_tpl.to(torch.float32),
                                   min=10).to(n_tpl.dtype)

    def rel(self, aff):
        return ct.aff_from_to(self.exp_ref, self.aff_ref, self.exp_new, aff)

    def res(self, pose, aff, cutoff):
        return ct.calc_res(self.tpl, self.img, self.cam, pose, self.rel(aff),
                           self.huber, cutoff)

    def mean_E(self, E, n):
        return torch.where(n >= self.n_floor, E / torch.clamp(n, min=1),
                           torch.full((), float("inf")))

    def candidate(self, R, t, aff, H, b, lam):
        """The next pass's pose, affine and step norm (the plain pass's
        head)."""
        S, eye6, eye8 = self.S, torch.eye(6), torch.eye(8)
        Hs = (H + lam * torch.diag(torch.diagonal(H))) * S[None, :] \
            * S[:, None]
        bs = b * S
        if self.fix_a and self.fix_b:
            inc = torch.cat([ct.solve(Hs[:6, :6] + 1e-12 * eye6, -bs[:6]),
                             torch.zeros(2)])
        else:
            inc = ct.solve(Hs + 1e-12 * eye8, -bs)
            if self.fix_a:
                inc = torch.cat([inc[:6], inc.new_zeros(1), inc[7:]])
            if self.fix_b:
                inc = torch.cat([inc[:7], inc.new_zeros(1)])
        inc = inc * S
        extrap = torch.where(lam < self.lel, torch.sqrt(torch.sqrt(
            torch.full((), self.lel) / lam)), torch.ones_like(lam))
        inc = inc * extrap
        inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
        new = SE3.exp(inc[:6]).compose(SE3(R, t))
        return new.R, new.t, aff + inc[6:8], torch.linalg.vector_norm(inc)

    def state(self, R, t, aff, H, b, E, n, lam):
        cand = self.candidate(R, t, aff, H, b, lam)
        return torch.cat([R.reshape(9), t, aff, H.reshape(64), b,
                          torch.stack([E, n, lam]), cand[0].reshape(9),
                          cand[1], cand[2], cand[3][None]])

    def run(self, mode, pose, cutoff=None, carry=()):
        R, t, aff = pose
        P = SE3(R.reshape(3, 3), t)
        if mode in ("sat0", "double"):
            if mode == "sat0":
                cut = torch.full((), self.cutoff_th)
                sat = self.res(P, aff, self.cutoff_th)[2]
                n = torch.zeros((), dtype=torch.int32)
            else:
                f, n, stop = carry
                grow = ~stop
                c2 = f[0] * 2.0
                cut = torch.where(grow, c2, f[0])
                sat = torch.where(grow, self.res(P, aff, c2)[2], f[1])
                n = n + grow.to(torch.int32)
            stop = ~((sat > 0.6) & (cut < self.cutoff_th * 50.0))
            return torch.stack([cut, sat]), n, stop
        E, n, sat, buf = self.res(P, aff, cutoff)
        if mode == "final":
            st = carry[0]
            rms = torch.sqrt(st[cp.S_E] / torch.clamp(st[cp.S_N], min=1.0))
            return torch.stack([rms, sat]), n >= self.n_floor
        H, b = ct.calc_gs(buf, self.cam, self.rel(aff), self.aff_ref[1])
        if mode == "init":
            return (self.state(P.R, P.t, aff, H, b, E, n.to(E.dtype),
                               torch.full((), self.lambda_init)),
                    torch.zeros((), dtype=torch.int32),
                    torch.zeros((), dtype=torch.bool))
        st, it, done = carry
        old = SE3(st[cp.S_R:cp.S_T].view(3, 3), st[cp.S_T:cp.S_AFF])
        H0 = st[cp.S_H:cp.S_B].view(8, 8)
        res_old = st[cp.S_E:cp.S_N + 1]
        lam = st[cp.S_N + 1]
        active = ~done
        accept = self.mean_E(E, n) < self.mean_E(res_old[0],
                                                 res_old[1].to(n.dtype))
        take = active & accept
        res_new = torch.where(take, torch.stack([E, n.to(E.dtype)]), res_old)
        lam = torch.where(active, torch.where(
            accept, lam * 0.5, torch.clamp(lam * 4.0, min=self.lel)), lam)
        return (self.state(torch.where(take, P.R, old.R),
                           torch.where(take, P.t, old.t),
                           torch.where(take, aff, st[cp.S_AFF:cp.S_H]),
                           torch.where(take, H, H0),
                           torch.where(take, b, st[cp.S_B:cp.S_E]),
                           res_new[0], res_new[1], lam),
                it + active.to(torch.int32),
                done | (st[cp.S_CNORM] <= 1e-3))


@pytest.mark.parametrize("opts", OPTIONS)
def test_cpu_track_level_is_the_plain_version(coarse_scene, opts):
    args, kw = _level_args(coarse_scene, 1, opts)
    n0 = cp.coarse_pass.launches
    _bitwise(ct.track_level(*args, **kw), ct.track_level_plain(*args, **kw))
    assert cp.coarse_pass.launches == n0


@pytest.mark.parametrize("cutoff_th", [20.0, 1.5])
def test_cpu_track_newest_coarse_launches_nothing(coarse_scene, cutoff_th,
                                                  monkeypatch):
    _, tt, pyr = coarse_scene
    L = 4
    call = (tt, [T(l) for l in pyr], [TCAM.pyramid_level(l) for l in range(L)],
            SE3.identity(device="cpu"), torch.zeros(2),
            (torch.ones(()), torch.ones(())), torch.zeros(2),
            torch.full((L,), 1e9))
    kw = dict(max_iterations=(10, 20, 30, 30), cutoff_th=cutoff_th)
    n0 = cp.coarse_pass.launches
    got = ct.track_newest_coarse(*call, **kw)
    assert cp.coarse_pass.launches == n0
    monkeypatch.setattr(ct, "track_level", ct.track_level_plain)
    _bitwise(got, ct.track_newest_coarse(*call, **kw))


@pytest.mark.parametrize("lvl", [1, 3])
@pytest.mark.parametrize("opts", OPTIONS)
def test_fused_loops_are_the_plain_loops(coarse_scene, opts, lvl,
                                         monkeypatch):
    """``track_level_fused`` with the kernel's modes done in torch ops is
    bitwise ``track_level_plain``: masked, with the passes after each stop
    skipped (as a captured loop skips them), and read-free."""
    args, kw = _level_args(coarse_scene, lvl, opts)
    want = ct.track_level_plain(*args, **kw)
    monkeypatch.setattr(cp, "Level", EmulatedLevel)
    _bitwise(ct.track_level_fused(*args, **kw), want)
    with skipped_passes() as runs:
        skipped = ct.track_level_fused(*args, **kw)
    _bitwise(skipped, want)
    assert runs[1][0] == int(want[5][1])
    with no_host_reads():
        again = ct.track_level_fused(*args, **kw)
    _bitwise(again, want)


def test_fused_loops_stop_before_their_caps(coarse_scene, monkeypatch):
    """The escalation doubles and stops, the LM stops before its cap, so
    the equality above covers carries after the stop (``OPTIONS[3]``'s LM
    runs to its cap, which covers the cap)."""
    args, kw = _level_args(coarse_scene, 3, OPTIONS[1])
    monkeypatch.setattr(cp, "Level", EmulatedLevel)
    with skipped_passes() as runs:
        ct.track_level_fused(*args, **kw)
    (dbl, dcap), (lm, lcap) = runs
    assert 1 <= dbl < dcap and 1 <= lm < lcap, runs


def _tpl(n=64, **change):
    fields = dict(u=torch.zeros(n), v=torch.zeros(n), idepth=torch.ones(n),
                  color=torch.zeros(n), mask=torch.ones(n, dtype=torch.bool))
    return ct.LevelTemplate(**{**fields, **change})


@pytest.mark.parametrize("tpl,img,err", [
    (_tpl(u=torch.zeros(64, dtype=torch.float64)), torch.zeros(8, 8, 3),
     TypeError),
    (_tpl(mask=torch.ones(64)), torch.zeros(8, 8, 3), TypeError),
    (_tpl(), torch.zeros(8, 8, 3, dtype=torch.float16), TypeError),
    (_tpl(v=torch.zeros(32)), torch.zeros(8, 8, 3), ValueError),
    (_tpl(), torch.zeros(8, 8), ValueError),
    (_tpl(), torch.zeros(8, 8, 2), ValueError),
    (_tpl(u=torch.zeros(128)[::2]), torch.zeros(8, 8, 3), ValueError),
    (_tpl(), torch.zeros(8, 3, 8).transpose(1, 2), ValueError),
    (_tpl(n=cp.MAX_SLOTS + 1), torch.zeros(8, 8, 3), ValueError),
    (_tpl(n=0), torch.zeros(8, 8, 3), ValueError),
    (_tpl(), torch.zeros(8, 8, 3, device="meta"), ValueError),
], ids=["u_float64", "mask_float", "img_float16", "ragged", "img_2d",
        "img_2ch", "u_strided", "img_strided", "cap", "empty",
        "other_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(tpl, img, err):
    with pytest.raises(err):
        cp.check_level(tpl, img)


def test_wrapper_launches_on_a_card_only():
    tpl = _tpl()
    with pytest.raises(ValueError, match="CUDA"):
        cp.Level(tpl, torch.zeros(8, 8, 3), TCAM, (1.0, 1.0),
                 torch.zeros(2), 9.0, 20.0, 0.01, 0.001, False, False)
    with pytest.raises(ValueError, match="unsupported device"):
        ct.track_level(tpl, torch.zeros(8, 8, 3, device="meta"), TCAM,
                       SE3.identity(device="cpu"), torch.zeros(2),
                       (1.0, 1.0), torch.zeros(2), max_iterations=3,
                       huber_th=9.0, cutoff_th=20.0)


def test_coarse_pass_is_counted():
    assert cp.coarse_pass in graphs.counters()
    assert cp.coarse_pass.__name__ == "coarse_pass"
    assert "coarse_pass" in graphs.launch_ledger()


def test_argument_struct_matches_the_kernel_layout():
    """``_Args`` mirrors ``CoarseArgs``: 21 pointers, then 4 ints, 13
    floats, the scale's 8 and the two flags, padded to the pointers'
    alignment as the C struct is."""
    assert cp._Args.S.offset == 21 * 8 + 4 * 4 + 13 * 4
    assert cp._Args.fix_b.offset == cp._Args.S.offset + 8 * 4 + 4
    assert ctypes.sizeof(cp._Args) == 280
