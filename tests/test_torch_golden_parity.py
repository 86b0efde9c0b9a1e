"""The port's BA and event cost against the second oracle,
``native/dso_golden.cpp``: an independent double-precision implementation
of the reference's BA math (linearization, mode-0 accumulation with
SCALE_A/SCALE_B, the Schur complement, the damped scaled solve and the
idepth back-substitution) and of the EDS event cost. The seeded worlds,
the binary's input/output formats and the tolerances are those of
``tests/test_golden_parity.py`` (F=4, P=48, 160x120; the event world
96 points at 80x60); the states reach the port through
``ba_state.from_numpy``. The source is compiled read-only with g++ into a
temporary directory; the test skips only when g++ is missing.

Representation differences, asserted through as in the JAX test: the
reference optimizes SCALE_A/SCALE_B-scaled affine variables (an exact
diagonal similarity D applied before comparing), and back-substitutes
idepths with the undamped point Hessian (a 1e-5 relative difference at
the FIX_LAMBDA default).
"""
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from slam_eds_tpu_torch.models import ba_state as tbs
from slam_eds_tpu_torch.ops import energy as ten
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.utils.cameras import Pinhole
from test_golden_parity import (F, H, LAM, SRC, W, _dscale, _event_world,
                                _read_ba_output, _rel_h, _world,
                                _write_ba_input)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    exe = str(tmp_path_factory.mktemp("golden") / "dso_golden")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe, SRC], check=True,
                   capture_output=True, timeout=180)
    return exe


def run_golden_ba(exe, state, images_np, tmp):
    inp, outp = os.path.join(tmp, "ba_in.bin"), os.path.join(tmp, "ba_out.bin")
    _write_ba_input(inp, state, images_np)
    subprocess.run([exe, "ba", inp, outp], check=True, timeout=120)
    return _read_ba_output(outp)


def port_state(jstate):
    d = {k: np.asarray(v) for k, v in jstate._asdict().items()
         if k != "T_eval"}
    d["T_eval.R"] = np.asarray(jstate.T_eval.R)
    d["T_eval.t"] = np.asarray(jstate.T_eval.t)
    return tbs.from_numpy(d, device="cpu")


@pytest.fixture(scope="module")
def golden(golden_exe, tmp_path_factory):
    state, _, images_np = _world()
    g = run_golden_ba(golden_exe, state, images_np,
                      str(tmp_path_factory.mktemp("ba")))
    st = port_state(state)
    lin = ten.linearize(st, torch.as_tensor(images_np), H, W)
    asm = ten.assemble(st, lin)
    sol = ten.solve_delta(st, asm, lam=LAM, use_orth=False)
    return st, g, lin, asm, sol


def _struct_off(st):
    return ~st.r_active.numpy() | (np.arange(F)[None, :]
                                   == st.p_host.numpy()[:, None])


def test_golden_residual_states_match(golden):
    st, g, lin, asm, sol = golden
    off = _struct_off(st)
    assert (g["status"][off] == 3).all()
    live = ~off
    valid, oob = lin.valid.numpy(), lin.oob.numpy()
    assert (valid[live] == (g["status"][live] == 0)).all()
    assert (oob[live] == (g["status"][live] == 1)).all()
    assert valid.sum() > 0.5 * live.sum()


def test_golden_linearization_matches(golden):
    st, g, lin, asm, sol = golden
    m = lin.valid.numpy()
    J = g["J"][m]
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lin.res.numpy()[m], g["resF"][m], **tol)
    np.testing.assert_allclose(lin.Jpdxi.numpy()[m].reshape(-1, 12),
                               J[:, :12], **tol)
    np.testing.assert_allclose(lin.Jpdc.numpy()[m].reshape(-1, 8),
                               J[:, 12:20], **tol)
    np.testing.assert_allclose(lin.Jpdd.numpy()[m], J[:, 20:22], **tol)
    JIdx = lin.JIdx.numpy()[m]
    np.testing.assert_allclose(JIdx[..., 0], J[:, 22:30], **tol)
    np.testing.assert_allclose(JIdx[..., 1], J[:, 30:38], **tol)
    np.testing.assert_allclose(lin.energy.numpy()[m], g["energy"][m],
                               rtol=3e-3, atol=1e-2)


def test_golden_assembled_system_matches(golden):
    st, g, lin, asm, sol = golden
    d = _dscale()
    HA_u = g["HA"] / np.outer(d, d)
    assert _rel_h(asm.H.numpy(), HA_u) < 5e-4
    sb = np.sqrt(np.abs(np.diag(HA_u))) + 1.0
    assert np.max(np.abs(asm.b.numpy() - g["bA"] / d) / sb) < 5e-4
    # point Schur scalars (the port includes the idepth prior; the golden
    # binary dumps them without)
    pprior = st.p_prior.numpy()
    dF = (st.p_idepth - st.p_idepth_zero).numpy()
    np.testing.assert_allclose(asm.Hdd.numpy() - pprior, g["Hdd"],
                               rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(asm.bd.numpy() - pprior * dF, g["bd"],
                               rtol=2e-3, atol=2e-2)


def test_golden_solve_matches(golden):
    st, g, lin, asm, sol = golden
    d = _dscale()
    HF_u = g["HF"] / np.outer(d, d)
    assert _rel_h(sol.H_final.numpy(), HF_u) < 5e-4
    sb = np.sqrt(np.abs(np.diag(HF_u))) + 1.0
    assert np.max(np.abs(sol.b_final.numpy() - g["bF"] / d) / sb) < 2e-3
    x_u = g["x"] * d
    scale = np.max(np.abs(x_u)) + 1e-12
    np.testing.assert_allclose(sol.x.numpy(), x_u, rtol=5e-3,
                               atol=5e-4 * scale)
    np.testing.assert_allclose(sol.point_step.numpy(), g["steps"],
                               rtol=5e-3, atol=5e-4)


def test_golden_outlier_gating_matches(golden_exe, tmp_path_factory):
    """A moderate frameEnergyTH, so that the outlier branch fires in
    both."""
    state, _, images_np = _world(energy_th=2000.0, seed=11)
    g = run_golden_ba(golden_exe, state, images_np,
                      str(tmp_path_factory.mktemp("gate")))
    st = port_state(state)
    lin = ten.linearize(st, torch.as_tensor(images_np), H, W)
    live = ~_struct_off(st)
    assert (g["status"] == 2).any()                 # gating exercised
    assert (lin.valid.numpy()[live] == (g["status"][live] == 0)).all()


@pytest.mark.parametrize("norm_event", [False, True])
def test_golden_event_cost_matches(golden_exe, tmp_path_factory, norm_event):
    Pe, He, We, ef, ncx, ncy, gx, gy, idp, wts, px, q, v = _event_world()
    tmp = str(tmp_path_factory.mktemp("event"))
    inp, outp = os.path.join(tmp, "ev_in.bin"), os.path.join(tmp, "ev_out.bin")
    with open(inp, "wb") as f:
        f.write(struct.pack("<4i", Pe, He, We, int(norm_event)))
        f.write(struct.pack("<4d", 70.0, 72.0, We / 2 - 0.5, He / 2 - 0.5))
        for a in (px, q, v, ncx, ncy, gx, gy, idp, wts, ef.ravel()):
            f.write(np.asarray(a, "<f8").tobytes())
    subprocess.run([golden_exe, "event", inp, outp], check=True, timeout=60)
    with open(outp, "rb") as f:
        Pn, = struct.unpack("<i", f.read(4))
        r_g = np.frombuffer(f.read(8 * Pn), "<f8")

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa
    cam = Pinhole(70.0, 72.0, We / 2 - 0.5, He / 2 - 0.5, We, He)
    st = tet.TrackerState(px=t(px), qx=t(q), vx=t(v))
    r = tet.event_residuals(st, t(ef), cam, t(np.stack([ncx, ncy], -1)),
                            t(np.stack([gx, gy], -1)), t(idp), t(wts),
                            torch.ones(Pe, dtype=torch.bool),
                            norm_event=norm_event)
    np.testing.assert_allclose(r.numpy(), r_g, rtol=2e-3, atol=2e-4)
