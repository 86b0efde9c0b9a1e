"""The port's point-sharded event tracker (``parallel/
sharded_event_tracker.py``) on spawned gloo CPU ranks, against the port's
single-rank ``optimize`` and the JAX package's ``optimize_sharded`` at the
same rank count (conftest's virtual CPU devices): the four cases of
``tests/test_sharded_event_tracker.py`` on its problem (64x96, P=64, seed
7), all at ``max_iterations=8`` (the LM's stopping iteration is float32
noise at convergence, so the comparisons are made at a cap).

* 4 ranks: px, qx atol 2e-4, energy rtol 1e-3, loss scale rtol 1e-2, and
  the residuals, each rank's block concatenated in rank order, atol 2e-4;
  the NC cost: px, qx 3e-4, energy 2e-3.
* 2 against 8 ranks: loss scale rtol 1e-4, px 2e-5, vx 2e-4.
* 56 live points padded to 64 with garbage in the dead lanes, 8 ranks:
  finite energy, px 2e-4, the dead lanes' residuals exactly 0.
* Every replicated output (state, energy, iterations, loss scale) is
  bitwise equal on all ranks.
One process group per rank count runs every case of that count.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.ops import event_tracker as jet
from slam_eds_tpu.parallel import sharded_event_tracker as jset
from slam_eds_tpu.parallel.sharded_ba import make_mesh
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole

from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.parallel import run_ranks
from slam_eds_tpu_torch.utils.cameras import Pinhole
from torch_dist import tracker_cases_rank

torch.set_num_threads(1)
ITERS = 8
KEYS = ("nc", "grad", "idp", "weights", "mask")


def _problem():
    Hp, Wp, P = 64, 96, 64
    rng = np.random.default_rng(7)
    cx, cy = Wp / 2 - 0.5, Hp / 2 - 0.5
    ef = (rng.normal(size=(Hp, Wp)) * 0.02).astype(np.float32)
    nc = np.stack([(rng.uniform(8, Wp - 8, P) - cx) / 80.0,
                   (rng.uniform(8, Hp - 8, P) - cy) / 80.0], -1).astype(
                       np.float32)
    grad = (rng.normal(size=(P, 2)) * 15).astype(np.float32)
    idp = rng.uniform(0.4, 1.2, P).astype(np.float32)
    mask = rng.random(P) > 0.1
    return {"cam": (80.0, 80.0, cx, cy, Wp, Hp), "ef": ef, "nc": nc,
            "grad": grad, "idp": idp, "weights": np.ones(P, np.float32),
            "mask": mask}


PROBLEM = _problem()


def _tail():
    """The last 8 lanes dead, with out-of-frame coordinates and ~0 idepth."""
    mask = PROBLEM["mask"].copy()
    mask[-8:] = False
    nc = PROBLEM["nc"].copy()
    nc[-8:] = 1e3
    idp = PROBLEM["idp"].copy()
    idp[-8:] = 1e-9
    return {"mask": mask, "nc": nc, "idp": idp}


CASES = {
    "huber": ({}, {"max_iterations": ITERS}),
    "nc": ({}, {"max_iterations": ITERS, "norm_event": True}),
    "mad": ({}, {"max_iterations": ITERS}),
    "tail": (_tail(), {"max_iterations": ITERS}),
}
GROUPS = {4: ("huber", "nc"), 2: ("mad",), 8: ("mad", "tail")}


@pytest.fixture(scope="module")
def port_ranks(tmp_path_factory):
    """rank count -> every rank's results of its cases; the three process
    groups run at the same time."""
    with ThreadPoolExecutor(len(GROUPS)) as ex:
        futs = {n: ex.submit(run_ranks, tracker_cases_rank, n, PROBLEM,
                             [(name, *CASES[name]) for name in names],
                             device="cpu",
                             store_dir=str(tmp_path_factory.mktemp("gloo")))
                for n, names in GROUPS.items()}
        return {n: f.result() for n, f in futs.items()}


def _arrays(name):
    over = CASES[name][0]
    return [over.get(k, PROBLEM[k]) for k in KEYS]


def port_single(name):
    kw = CASES[name][1]
    cam = Pinhole(*PROBLEM["cam"])
    args = [torch.as_tensor(a) for a in _arrays(name)]
    return tet.optimize(tet.initial_tracker_state("cpu"),
                        torch.as_tensor(PROBLEM["ef"]), cam, *args, **kw)


def jax_sharded(name, n):
    kw = CASES[name][1]
    cam = JPinhole(*(jnp.float32(v) for v in PROBLEM["cam"][:4]),
                   *PROBLEM["cam"][4:])
    mesh = make_mesh(jax.devices()[:n], axis=jset.AXIS)
    return jset.optimize_sharded(jet.initial_tracker_state(),
                                 jnp.asarray(PROBLEM["ef"]), cam,
                                 *(jnp.asarray(a) for a in _arrays(name)),
                                 mesh, **kw)


def got(port_ranks, n, name):
    """Rank 0's result with the residual blocks of all ranks joined."""
    res = [r[name] for r in port_ranks[n]]
    return res[0]._replace(residuals=np.concatenate([r.residuals
                                                     for r in res]))


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               err_msg=what)


def test_sharded_matches_single_rank_and_jax(port_ranks):
    out = got(port_ranks, 4, "huber")
    for what, ref in (("port single rank", port_single("huber")),
                      ("JAX sharded, 4", jax_sharded("huber", 4))):
        _close(out.state.px, ref.state.px, 2e-4, what)
        _close(out.state.qx, ref.state.qx, 2e-4, what)
        np.testing.assert_allclose(float(out.energy), float(ref.energy),
                                   rtol=1e-3, err_msg=what)
        np.testing.assert_allclose(float(out.loss_scale),
                                   float(ref.loss_scale), rtol=1e-2,
                                   err_msg=what)
        # residual layout matches after the gather
        _close(out.residuals, ref.residuals, 2e-4, what)


def test_sharded_nc_variant_matches(port_ranks):
    """PhotometricErrorNC: the event-side normalization is its own global
    sum over the ranks."""
    out = got(port_ranks, 4, "nc")
    for what, ref in (("port single rank", port_single("nc")),
                      ("JAX sharded, 4", jax_sharded("nc", 4))):
        _close(out.state.px, ref.state.px, 3e-4, what)
        _close(out.state.qx, ref.state.qx, 3e-4, what)
        np.testing.assert_allclose(float(out.energy), float(ref.energy),
                                   rtol=2e-3, err_msg=what)


def test_sharded_mad_parity_across_rank_counts(port_ranks):
    """The MAD loss scale does not depend on the rank count (one global
    gather); the pose agrees 2 against 8 ranks, and each against the JAX
    package at its rank count."""
    two, eight = got(port_ranks, 2, "mad"), got(port_ranks, 8, "mad")
    np.testing.assert_allclose(float(two.loss_scale),
                               float(eight.loss_scale), rtol=1e-4)
    _close(two.state.px, eight.state.px, 2e-5, "2 vs 8 ranks")
    _close(two.state.vx, eight.state.vx, 2e-4, "2 vs 8 ranks")
    for n, out in ((2, two), (8, eight)):
        ref = jax_sharded("mad", n)
        what = f"JAX sharded, {n}"
        np.testing.assert_allclose(float(out.loss_scale),
                                   float(ref.loss_scale), rtol=1e-4,
                                   err_msg=what)
        _close(out.state.px, ref.state.px, 2e-5, what)
        _close(out.state.vx, ref.state.vx, 2e-4, what)


def test_sharded_uneven_points_masked_tail(port_ranks):
    """56 live points padded to 64 with dead garbage lanes spread over the
    ranks: the dead lanes do not perturb the solve."""
    out = got(port_ranks, 8, "tail")
    assert np.isfinite(float(out.energy))
    for what, ref in (("port single rank", port_single("tail")),
                      ("JAX sharded, 8", jax_sharded("tail", 8))):
        _close(out.state.px, ref.state.px, 2e-4, what)
    # dead lanes produce exactly zero residuals
    assert np.all(out.residuals[-8:] == 0.0)


def test_replicated_outputs_bitwise_across_ranks(port_ranks):
    for n, outs in port_ranks.items():
        for name in GROUPS[n]:
            ref = outs[0][name]
            for r, out in enumerate(outs[1:], 1):
                res = out[name]
                for a, b in zip(jax.tree_util.tree_leaves(
                        (ref.state, ref.energy, ref.n_iter, ref.loss_scale)),
                        jax.tree_util.tree_leaves(
                        (res.state, res.energy, res.n_iter, res.loss_scale))):
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), \
                        (n, name, r)
