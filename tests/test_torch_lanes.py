"""``ops.lanes``: the event LM's reductions whose ``torch.vmap`` lanes are
bitwise the same call on each lane alone, on the CPU.

* Each helper (``matmul``, ``total``, ``norm``, ``einsum``) outside any map
  is its torch op, bit for bit; under ``torch.vmap`` (mapped operands,
  unmapped ones, the mapped axis not first, two nested maps) each lane is
  bitwise the op on that lane alone.
* ``eval.batched_event_solves`` (one ``torch.vmap`` of the event LM): every
  lane bitwise ``event_tracker.optimize`` on its own inputs (state, energy,
  residuals, loss scale, pass count) after 2, 5 and 8 passes, on the event
  tracker tests' scene at three frames. (``tests/test_torch_eval_maps.py``
  holds the batched solves against the JAX package's.)
"""
import pytest
import torch

from slam_eds_tpu_torch import eval as tev
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.ops import lanes
from torch_world import event_world

torch.set_num_threads(1)


def _rand(*shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


CASES = {
    "matmul_mv": (lanes.matmul, torch.matmul, ((300, 6), (6,))),
    "matmul_vm": (lanes.matmul, torch.matmul, ((300,), (300, 6))),
    "matmul_mm": (lanes.matmul, torch.matmul, ((12, 300), (300, 12))),
    "total": (lanes.total, torch.sum, ((300,),)),
    "norm": (lanes.norm, torch.linalg.vector_norm, ((6,),)),
    "einsum": (lambda a, b: lanes.einsum("pgx,pg->px", a, b),
               lambda a, b: torch.einsum("pgx,pg->px", a, b),
               ((300, 2, 6), (300, 2))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_ops_are_each_lane_alone(name):
    fn, op, shapes = CASES[name]
    B = 3
    xs = [_rand(B, *s, seed=10 * i + 1) for i, s in enumerate(shapes)]
    assert torch.equal(fn(*(x[0] for x in xs)), op(*(x[0] for x in xs)))
    want = torch.stack([op(*(x[b] for x in xs)) for b in range(B)])
    assert torch.equal(torch.vmap(fn)(*xs), want)
    # the mapped axis last, and the first operand unmapped
    moved = [x.movedim(0, -1).contiguous() for x in xs]
    assert torch.equal(torch.vmap(fn, in_dims=-1)(*moved), want)
    if len(xs) == 2:
        got = torch.vmap(fn, in_dims=(None, 0))(xs[0][0], xs[1])
        assert torch.equal(got, torch.stack([op(xs[0][0], xs[1][b])
                                             for b in range(B)]))


def test_lane_ops_nested_maps():
    a, v = _rand(2, 3, 300, 6, seed=5), _rand(2, 3, 6, seed=6)
    got = torch.vmap(torch.vmap(lanes.matmul))(a, v)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], a[i, j] @ v[i, j])


@pytest.mark.parametrize("iterations", [2, 5, 8])
def test_batched_event_lanes_are_bitwise_single_solves(iterations):
    """Three lanes on the event tracker tests' scene, each at its own event
    frame (the scene's, shifted by one and two pixels): every lane bitwise
    its single solve."""
    st, frame, (cam, nc, grad, idp, w, mask) = event_world("cpu")
    frames = torch.stack([frame, torch.roll(frame, 1, -1),
                          torch.roll(frame, 2, -2)])
    B = len(frames)
    states = tet.TrackerState(*(torch.stack([x] * B) for x in st))
    pts = (nc, grad, idp, w, mask)
    got = tev.batched_event_solves(
        states, frames, cam, *(torch.stack([a] * B) for a in pts),
        max_iterations=iterations, loss_scale=0.2)
    for b in range(B):
        one = tet.optimize(st, frames[b], cam, *pts,
                           max_iterations=iterations,
                           loss_scale=torch.tensor(0.2))
        lane = tev._lane(got, b)
        for n in ("px", "qx", "vx"):
            assert torch.equal(getattr(lane.state, n), getattr(one.state, n))
        for n in ("energy", "residuals", "loss_scale", "n_iter"):
            assert torch.equal(getattr(lane, n), getattr(one, n)), n
