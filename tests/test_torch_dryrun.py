"""The port's multi-rank dry run and entry point (``parallel/dryrun.py``,
the counterparts of ``__graft_entry__.py``) and the process-group plumbing
of ``parallel/__init__.py``, on the CPU.

* ``dryrun_multichip(2, "cpu")`` at its full per-rank load (2,048 points
  per rank, F=8, 128x96): it raises unless the 2-rank and 1-rank runs meet
  the JAX dry run's bounds and every replicated tensor is bitwise equal on
  both ranks.
* A rank that raises fails ``run_ranks`` within seconds, with its
  traceback, while its peer waits in a collective.
* ``entry("cpu")`` builds bitwise the JAX entry's inputs and its solve
  agrees with the JAX package's ``optimize`` on them (pose atol 1e-4,
  energy rtol 1e-3).
* The entry points default to the card; uneven point blocks raise.
"""
import time

import numpy as np
import jax
import pytest
import torch

from slam_eds_tpu_torch.parallel import (block, default_backend, make_group,
                                        run_ranks)
from slam_eds_tpu_torch.parallel import dryrun
from slam_eds_tpu_torch.parallel import sharded_ba as sba
from torch_dist import failing_rank

torch.set_num_threads(1)


def test_dryrun_multichip_two_ranks(tmp_path):
    rep = dryrun.dryrun_multichip(2, "cpu", store_dir=str(tmp_path))
    assert rep["backend"] == rep["backend_1"] == "gloo"
    assert rep["points"] == 4096
    assert np.isfinite(rep["energies"]).all() and len(rep["energies"]) == 2
    assert np.isfinite(rep["event_energy"])
    # the plain sampler runs on the CPU: the kernel is launched nowhere
    assert rep["launches"] == [0, 0] and rep["launches_1"] == 0


def test_failing_rank_fails_the_call(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(failing_rank, 2, device="cpu", store_dir=str(tmp_path))
    # the peer, stuck in its collective, was stopped, not waited for
    assert time.monotonic() - t0 < 45.0


def test_entry_matches_jax_entry():
    import __graft_entry__ as graft
    from slam_eds_tpu.ops import event_tracker as jet
    from slam_eds_tpu.utils.cameras import Pinhole as JPinhole
    step, args = dryrun.entry("cpu")
    _, jargs = graft.entry()
    for a, b in zip(jax.tree_util.tree_leaves(args[1:]), jargs[1:]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    state, e, res = step(*args)
    cam = JPinhole(*(np.float32(v) for v in (400.0, 400.0, 319.5, 239.5)),
                   640, 480)
    ref = jet.optimize(jargs[0], jargs[1], cam, *jargs[2:],
                       max_iterations=10)
    np.testing.assert_allclose(state.px.numpy(), np.asarray(ref.state.px),
                               atol=1e-4)
    np.testing.assert_allclose(state.qx.numpy(), np.asarray(ref.state.qx),
                               atol=1e-4)
    np.testing.assert_allclose(float(e), float(ref.energy), rtol=1e-3)
    assert res.shape == (2048,) and torch.isfinite(res).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(failing_rank, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_group(0, 1, "file:///nonexistent/store")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_backend(2)
    assert default_backend(2, "cpu") == "gloo"


def test_blocks_split_evenly_or_raise():
    x = torch.arange(12)
    assert torch.equal(torch.cat([block(x, r, 3) for r in range(3)]), x)
    with pytest.raises(ValueError, match="do not split evenly"):
        block(torch.zeros(10), 0, 3)
    specs = sba.state_specs()
    split = [k for k, v in specs._asdict().items() if v == sba.AXIS]
    assert tuple(split) == sba._POINT_FIELDS
    assert specs.T_eval == (None, None) and specs.HM is None
