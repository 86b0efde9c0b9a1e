"""Parity of the port's photometric BA (``ops/energy.py``) with the JAX
package on the CPU, on one rendered world (F=4 frames, P=256 points,
96x128 images) built with numpy from a seed and handed to both sides
through ``ba_state.from_numpy``. The JAX side samples taps through its own
CPU path (``pattern_mm_sample``), the port through its plain gather.

Tolerances (stated per step):
* linearize: masks equal; entries rtol 1e-4, atol 1e-3;
* assemble (same linearization in): H, b relative Frobenius <= 1e-5;
* solve_delta (same system in): x relative <= 1e-3;
* 6-iteration ba_iterate: energy relative <= 1e-4; state scale-relative
  <= 1e-2 (the reduced system is ~1e8-conditioned);
* marginalize_points / marginalize_frame (same inputs): HM, bM relative
  <= 1e-4.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.models import ba_state as jbs
from slam_eds_tpu.ops import energy as jen
from slam_eds_tpu.utils.lie import SE3 as JSE3

from slam_eds_tpu_torch.models import ba_state as tbs
from slam_eds_tpu_torch.ops import energy as ten
from torch_world import CX, CY, FX, FY, F, H, P, W, world_arrays

torch.set_num_threads(1)


def build_world(seed=11):
    """The JAX state and images of ``torch_world.world_arrays``."""
    d = world_arrays(seed)
    st = jbs.empty_state(F, P, jnp.asarray([FX, FY, CX, CY], jnp.float32))
    st = st._replace(
        T_eval=JSE3(jnp.asarray(d["T_eval.R"]), jnp.asarray(d["T_eval.t"])),
        **{k: jnp.asarray(v) for k, v in d.items()
           if k not in ("T_eval.R", "T_eval.t", "images")})
    return st, jnp.asarray(d["images"])


def to_torch(jstate) -> tbs.BAState:
    d = {k: np.asarray(v) for k, v in jstate._asdict().items()
         if k != "T_eval"}
    d["T_eval.R"] = np.asarray(jstate.T_eval.R)
    d["T_eval.t"] = np.asarray(jstate.T_eval.t)
    return tbs.from_numpy(d, device="cpu")


def tt(tup, cls):
    return cls(*(torch.as_tensor(np.asarray(x)) for x in tup))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def world():
    st, imgs = build_world()
    return st, imgs, to_torch(st), torch.as_tensor(np.array(imgs))


def test_state_numpy_roundtrip(world):
    jst, _, tst, _ = world
    d = tbs.to_numpy(tst)
    back = tbs.from_numpy(d, device="cpu")
    for a, b in zip(tbs.tuple_to_numpy(back).values(), d.values()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(d["p_host"], np.asarray(jst.p_host))
    assert tst.p_host.dtype == torch.int32


def test_linearize_parity(world):
    jst, jimgs, tst, timgs = world
    lj = jen.linearize(jst, jimgs, H, W)
    lt = ten.linearize(tst, timgs, H, W)
    v = np.asarray(lj.valid)
    assert v.sum() > 300
    np.testing.assert_array_equal(lt.valid.numpy(), v)
    np.testing.assert_array_equal(lt.oob.numpy(), np.asarray(lj.oob))
    for name in ("res", "JIdx", "Jab", "Jpdxi", "Jpdc", "Jpdd", "energy"):
        np.testing.assert_allclose(getattr(lt, name).numpy(),
                                   np.asarray(getattr(lj, name)),
                                   rtol=1e-4, atol=1e-3, err_msg=name)


def test_assemble_parity(world):
    jst, jimgs, tst, _ = world
    lj = jen.linearize(jst, jimgs, H, W)
    aj = jen.assemble(jst, lj)
    at = ten.assemble(tst, tt(lj, ten.Linearization))
    assert rel(at.H.numpy(), aj.H) <= 1e-5
    assert rel(at.b.numpy(), aj.b) <= 1e-5
    for name in ("Hdd", "bd", "V"):
        assert rel(getattr(at, name).numpy(), getattr(aj, name)) <= 1e-5, name


@pytest.mark.parametrize("use_orth", [False, True])
def test_solve_delta_parity(world, use_orth):
    jst, jimgs, tst, _ = world
    aj = jen.assemble(jst, jen.linearize(jst, jimgs, H, W))
    sj = jen.solve_delta(jst, aj, use_orth=use_orth)
    st = ten.solve_delta(tst, tt(aj, ten.Assembled), use_orth=use_orth)
    assert rel(st.x.numpy(), sj.x) <= 1e-3
    assert rel(st.point_step.numpy(), sj.point_step) <= 1e-3
    assert rel(st.H_final.numpy(), sj.H_final) <= 1e-5


@pytest.mark.parametrize("use_orth", [False, True])
def test_solve_delta_tensor_use_orth(world, use_orth):
    """``use_orth`` as a bool tensor (the GN loop's predicate on its device
    pass index) selects the projected step: bitwise the Python-bool call."""
    _, _, tst, timgs = world
    asm = ten.assemble(tst, ten.linearize(tst, timgs, H, W))
    want = ten.solve_delta(tst, asm, use_orth=use_orth)
    got = ten.solve_delta(tst, asm, use_orth=torch.tensor(use_orth))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_nullspace_orthogonalize_parity(world, rng):
    jst, _, tst, _ = world
    Nj, Nt = jen.nullspaces(jst), ten.nullspaces(tst)
    np.testing.assert_allclose(Nt.numpy(), np.asarray(Nj), atol=1e-6)
    x = rng.normal(size=jst.dim).astype(np.float32)
    np.testing.assert_allclose(
        ten.orthogonalize(torch.as_tensor(x), Nt).numpy(),
        np.asarray(jen.orthogonalize(jnp.asarray(x), Nj)), atol=1e-5)
    for a, b in zip(ten.pair_adjoints(tst), jen.pair_adjoints(jst)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("break_tol", [0.0, 5e-5])
def test_ba_iterate_parity(world, break_tol):
    jst, jimgs, tst, timgs = world
    sj, ej, lj = jen.ba_iterate(jst, jimgs, H, W, iterations=6,
                                orth_from_iteration=0, break_tol=break_tol)
    st_, et, lt = ten.ba_iterate(tst, timgs, H, W, iterations=6,
                                 orth_from_iteration=0, break_tol=break_tol)
    e_start = float(jen.linearize(jst, jimgs, H, W).energy.sum())
    assert float(ej) < 0.5 * e_start            # the BA did converge
    assert abs(float(et) - float(ej)) <= 1e-4 * abs(float(ej))
    for name in ("delta", "p_idepth"):
        a, b = np.asarray(getattr(sj, name)), getattr(st_, name).numpy()
        assert np.abs(b - a).max() <= 1e-2 * np.abs(a).max(), name
    np.testing.assert_array_equal(lt.valid.numpy(), np.asarray(lj.valid))


def test_marginalize_points_parity(world):
    jst, jimgs, tst, _ = world
    status = np.asarray(jst.p_status).copy()
    status[::3] = jbs.PT_MARGINALIZE
    jst_m = jst._replace(p_status=jnp.asarray(status))
    lj = jen.linearize(jst_m, jimgs, H, W)
    res_j = jen.fej_recentered_residuals(jst_m, lj)
    mj = jen.marginalize_points(jst_m, lj)
    tst_m = tst._replace(p_status=torch.as_tensor(status))
    lt = tt(lj, ten.Linearization)
    assert rel(ten.fej_recentered_residuals(tst_m, lt).numpy(), res_j) <= 1e-5
    mt = ten.marginalize_points(tst_m, lt)
    assert np.abs(np.asarray(mj.HM)).max() > 0
    assert rel(mt.HM.numpy(), mj.HM) <= 1e-4
    assert rel(mt.bM.numpy(), mj.bM) <= 1e-4
    np.testing.assert_array_equal(mt.p_status.numpy(), np.asarray(mj.p_status))
    np.testing.assert_array_equal(mt.r_active.numpy(), np.asarray(mj.r_active))


def test_marginalize_frame_parity(world):
    jst, jimgs, _, _ = world
    status = np.asarray(jst.p_status).copy()
    status[np.asarray(jst.p_host) == 1] = jbs.PT_MARGINALIZE
    jst_m = jst._replace(p_status=jnp.asarray(status))
    jst_m = jen.marginalize_points(jst_m, jen.linearize(jst_m, jimgs, H, W))
    fj = jen.marginalize_frame(jst_m, slot=1)
    ft = ten.marginalize_frame(to_torch(jst_m), slot=1)
    assert rel(ft.HM.numpy(), fj.HM) <= 1e-4
    assert rel(ft.bM.numpy(), fj.bM) <= 1e-4
    HM = ft.HM.numpy()
    np.testing.assert_array_equal(HM, HM.T)
    assert not bool(ft.frame_valid[1])
    np.testing.assert_array_equal(ft.r_active.numpy(), np.asarray(fj.r_active))
