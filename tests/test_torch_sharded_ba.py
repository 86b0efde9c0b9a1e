"""The port's point-sharded BA (``parallel/sharded_ba.py``) and the
reduction hooks it puts into the single-card math, on the CPU.

* Hooks: ``reduce=None`` and an identity ``reduce`` (and ``gather``) give
  bitwise the same ``solve_delta``, ``marginalize_points``,
  ``event_residuals_and_jac`` and event LM outputs.
* The three cases of ``tests/test_sharded_ba.py`` on ``test_energy.
  build_scene`` (80x96), on 8 spawned gloo ranks (one process group runs
  all three), each held with that file's bounds against the port's
  single-rank path and against the JAX package's sharded functions on
  conftest's 8 virtual CPU devices: the 4-iteration BA (F=4, P=144: energy
  rtol 1e-3, pose deltas atol 1e-2, affine deltas 5e-2, idepths 2e-3), the
  point marginalization (F=3, P=64: HM and bM atol 1e-2, rtol 1e-3) and the
  three-cycle window lifecycle (F=4, P=64: HM, bM, delta relative Frobenius
  1e-4, 2e-2, 5e-2; active idepths 1e-3; equal p_status and frame_valid).
* Every replicated tensor comes back bitwise equal from all ranks.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.models import ba_state as jbs
from slam_eds_tpu.ops import energy as jen
from slam_eds_tpu.parallel import sharded_ba as jsba

from slam_eds_tpu_torch.models import ba_state as tbs
from slam_eds_tpu_torch.ops import energy as ten
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.parallel import run_ranks
from slam_eds_tpu_torch.utils.cameras import Pinhole
from test_energy import build_scene, H, W
from torch_dist import ba_cases_rank, flag_oldest
from torch_world import port_world

torch.set_num_threads(1)
RANKS = 8
SEED = 3141592          # conftest's ``rng`` fixture


def state_np(jstate) -> dict:
    d = {k: np.asarray(v) for k, v in jstate._asdict().items()
         if k != "T_eval"}
    d["T_eval.R"] = np.asarray(jstate.T_eval.R)
    d["T_eval.t"] = np.asarray(jstate.T_eval.t)
    return d


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9)


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX state, JAX images) of the three cases."""
    st, imgs, _ = build_scene(np.random.default_rng(SEED), F=4, P=144)
    d = np.zeros((4, 8), np.float32)
    d[1:, :3] = 0.008
    out = {"ba": (st._replace(delta=jnp.asarray(d)), imgs)}
    st, imgs, _ = build_scene(np.random.default_rng(SEED), F=3, P=64)
    stat = np.asarray(st.p_status).copy()
    stat[np.where(stat == jbs.PT_ACTIVE)[0][::2]] = jbs.PT_MARGINALIZE
    out["marg"] = (st._replace(p_status=jnp.asarray(stat)), imgs)
    st, imgs, _ = build_scene(np.random.default_rng(SEED), F=4, P=64)
    out["lifecycle"] = (st, imgs)
    return out


def jax_sharded(scenes, mesh):
    """The JAX package's sharded results of the three cases."""
    js, ji = scenes["ba"]
    out = {"ba": jsba.ba_iterate_sharded(jsba.shard_state(js, mesh), ji,
                                         mesh, H, W, iterations=4)}
    js, ji = scenes["marg"]
    out["marg"] = jsba.marginalize_points_sharded(
        jsba.shard_state(js, mesh), ji, mesh, H, W)
    js, ji = scenes["lifecycle"]
    js = jsba.shard_state(js, mesh)
    marg_frame = jax.jit(jen.marginalize_frame, static_argnames=("slot",))
    for cycle in range(3):
        js, _ = jsba.ba_iterate_sharded(js, ji, mesh, H, W, iterations=2)
        stat = flag_oldest(tbs.from_numpy(state_np(js), device="cpu"), cycle)
        js = js._replace(p_status=jnp.asarray(stat.numpy()))
        js = jsba.marginalize_points_sharded(js, ji, mesh, H, W)
        js = marg_frame(js, slot=cycle)
    out["lifecycle"] = js
    return out


@pytest.fixture(scope="module")
def runs(scenes, mesh, tmp_path_factory):
    """(every rank's results of the three cases on 8 ranks, the JAX
    package's); the ranks run while this process computes the JAX side."""
    arg = {k: (state_np(s), np.array(i), H, W)
           for k, (s, i) in scenes.items()}
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, ba_cases_rank, RANKS, arg, device="cpu",
                          store_dir=str(tmp_path_factory.mktemp("gloo")))
        ref = jax_sharded(scenes, mesh)
        return ranks.result(), ref


@pytest.fixture(scope="module")
def port_ranks(runs):
    return runs[0]


def port_single(scenes, name):
    s, i = scenes[name]
    return tbs.from_numpy(state_np(s), device="cpu"), torch.as_tensor(
        np.array(i))


@pytest.fixture(scope="module")
def mesh():
    return jsba.make_mesh()


# ---------------------------------------------------------------------------
# the reduction hooks: an identity reduce is bitwise the default

def _identity(x):
    return x.clone()


def _tracker_problem():
    rng = np.random.default_rng(7)
    Hp, Wp, P = 64, 96, 64
    cam = Pinhole(80.0, 80.0, Wp / 2 - 0.5, Hp / 2 - 0.5, Wp, Hp)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    ef = t(rng.normal(size=(Hp, Wp)) * 0.02)
    nc = t(np.stack([(rng.uniform(8, Wp - 8, P) - cam.cx) / cam.fx,
                     (rng.uniform(8, Hp - 8, P) - cam.cy) / cam.fy], -1))
    grad = t(rng.normal(size=(P, 2)) * 15)
    idp = t(rng.uniform(0.4, 1.2, P))
    mask = torch.as_tensor(rng.random(P) > 0.1)
    return (ef, cam, nc, grad, idp, torch.ones(P), mask)


def _assert_bitwise(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.mark.parametrize("fn", ["solve_delta", "marginalize_points",
                                "event_residuals_and_jac", "lm_solve"])
def test_identity_reduce_is_bitwise_the_default(fn):
    if fn in ("solve_delta", "marginalize_points"):
        st, imgs = port_world("cpu")
        status = st.p_status.clone()
        status[::3] = tbs.PT_MARGINALIZE
        st = st._replace(p_status=status, HM=torch.eye(st.dim) * 3.0)
        lin = ten.linearize(st, imgs, imgs.shape[1], imgs.shape[2])
        if fn == "solve_delta":
            asm = ten.assemble(st, lin)
            a = ten.solve_delta(st, asm)
            b = ten.solve_delta(st, asm, reduce=_identity)
        else:
            a = ten.marginalize_points(st, lin)
            b = ten.marginalize_points(st, lin, reduce=_identity)
        _assert_bitwise(list(a), list(b))
        return
    ef, cam, nc, grad, idp, w, mask = _tracker_problem()
    st = tet.initial_tracker_state("cpu")
    for norm_event in (False, True):
        if fn == "event_residuals_and_jac":
            a = tet.event_residuals_and_jac(st, ef, cam, nc, grad, idp, w,
                                            mask, norm_event=norm_event)
            b = tet.event_residuals_and_jac(st, ef, cam, nc, grad, idp, w,
                                            mask, norm_event=norm_event,
                                            reduce=_identity)
            a += (tet.event_residuals(st, ef, cam, nc, grad, idp, w, mask,
                                      norm_event=norm_event),)
            b += (tet.event_residuals(st, ef, cam, nc, grad, idp, w, mask,
                                      norm_event=norm_event,
                                      reduce=_identity),)
        else:
            a = tet.optimize(st, ef, cam, nc, grad, idp, w, mask,
                             max_iterations=8, norm_event=norm_event)
            b = tet._lm_solve(st, ef, cam, nc, grad, idp, w, mask, 8,
                              "huber", 0.2, 1e-6, norm_event,
                              reduce=_identity, gather=_identity)
            a, b = [a.state, *a[1:]], [b.state, *b[1:]]
        _assert_bitwise(a, b)


# ---------------------------------------------------------------------------
# the three cases of tests/test_sharded_ba.py on 8 ranks

def test_sharded_ba_matches_single_rank_and_jax(scenes, runs):
    got = runs[0][0]["ba"]
    st, imgs = port_single(scenes, "ba")
    ref_state, ref_e, _ = ten.ba_iterate(st, imgs, H, W, iterations=4)
    jst, je = runs[1]["ba"]
    for name, ref, e in (("port single rank", ref_state, ref_e),
                         ("JAX sharded", jst, je)):
        np.testing.assert_allclose(float(got["energy"]), float(e), rtol=1e-3,
                                   err_msg=name)
        d, rd = got["state"].delta, np.asarray(ref.delta)
        np.testing.assert_allclose(d[:, :6], rd[:, :6], atol=1e-2,
                                   err_msg=name)
        np.testing.assert_allclose(d[:, 6:], rd[:, 6:], atol=5e-2,
                                   err_msg=name)
        np.testing.assert_allclose(got["state"].p_idepth,
                                   np.asarray(ref.p_idepth), atol=2e-3,
                                   err_msg=name)


def test_sharded_marginalization_matches(scenes, runs):
    got = runs[0][0]["marg"]["state"]
    st, imgs = port_single(scenes, "marg")
    ref = ten.marginalize_points(st, ten.linearize(st, imgs, H, W))
    for name, r in (("port single rank", ref), ("JAX sharded",
                                                runs[1]["marg"])):
        np.testing.assert_allclose(got.HM, np.asarray(r.HM), atol=1e-2,
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(got.bM, np.asarray(r.bM), atol=1e-2,
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_array_equal(got.p_status, np.asarray(r.p_status))
    assert int((got.p_status == tbs.PT_MARGINALIZE).sum()) == 0


def test_sharded_window_lifecycle_matches(scenes, runs):
    """Insert -> BA -> point marginalization -> frame marginalization over
    three keyframe cycles (EnergyFunctional.cpp:498-676 order)."""
    got = runs[0][0]["lifecycle"]["state"]
    st, imgs = port_single(scenes, "lifecycle")
    for cycle in range(3):
        st, _, _ = ten.ba_iterate(st, imgs, H, W, iterations=2)
        st = st._replace(p_status=flag_oldest(st, cycle))
        st = ten.marginalize_points(st, ten.linearize(st, imgs, H, W))
        st = ten.marginalize_frame(st, slot=cycle)

    for name, r in (("port single rank", st),
                    ("JAX sharded", runs[1]["lifecycle"])):
        assert rel_fro(got.HM, r.HM) < 1e-4, (name, rel_fro(got.HM, r.HM))
        assert rel_fro(got.bM, r.bM) < 2e-2, (name, rel_fro(got.bM, r.bM))
        assert rel_fro(got.delta, r.delta) < 5e-2, name
        act = np.asarray(r.p_status) == tbs.PT_ACTIVE
        np.testing.assert_allclose(got.p_idepth[act],
                                   np.asarray(r.p_idepth)[act], atol=1e-3,
                                   err_msg=name)
        np.testing.assert_array_equal(got.p_status, np.asarray(r.p_status))
        np.testing.assert_array_equal(got.frame_valid,
                                      np.asarray(r.frame_valid))


def test_replicated_tensors_bitwise_across_ranks(port_ranks):
    """The whole state each rank returns (its replicated fields and the
    gathered point blocks) and the energy are bitwise rank 0's."""
    ref = jax.tree_util.tree_leaves(port_ranks[0])
    for out in port_ranks[1:]:
        leaves = jax.tree_util.tree_leaves(out)
        assert len(leaves) == len(ref)
        for a, b in zip(ref, leaves):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
