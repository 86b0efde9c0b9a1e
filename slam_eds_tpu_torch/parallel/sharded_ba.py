"""Distributed bundle adjustment over ranks — port of
``slam_eds_tpu.parallel.sharded_ba``.

The *point* axis of the sliding-window BA is split over the ranks of a
process group (``parallel.make_group``):

* every rank linearizes and assembles the residuals of its point block
  (``ops.energy.linearize``/``assemble`` on the local block),
* the reduced camera system ([4+8F]^2, tiny) and the point-Schur complement
  are summed over the ranks (``solve_delta(reduce=...)``),
* the damped solve and the nullspace orthogonalization run replicated (equal
  inputs on every rank, so equal results), and each rank back-substitutes
  its own idepth block,
* the marginalization prior (HM/bM) comes from the same sums, so it evolves
  identically on every rank.

Frame state, calib, images and HM/bM are replicated; only the nine ``[P,
...]`` point fields (``_POINT_FIELDS``, the ``[P, F]`` residual mask
among them) are split, in contiguous blocks.

One difference from the JAX module: the assembly, the sums over ranks and
the solve (and the marginalization's) run in float64 on float32
linearizations, and the step and HM/bM are rounded back to float32. In
float32 the rank count moves the sums' rounding, and the reduced system's
near-gauge directions amplify it: on the dry run's world
(``parallel.dryrun``, 2 x 2,048 points) the 2-rank and 1-rank bM differ
by 1.3e-3 of its scale in float32, and the JAX module's by 2.2e-3 on 2
and 1 CPU devices, both past the JAX dry run's 1e-3 bound
(``tools/sharded_rank_noise.py``). With float64 sums the 1-, 2- and
4-rank runs give bitwise the same state.

The sharded calls run eagerly over gloo and capture nothing: the GN
passes are a fixed count (no ``break_tol``, so no early exit to skip).
"""
from __future__ import annotations

import torch

from ..models.ba_state import BAState
from ..ops import energy
from ..utils.lie import SE3
from . import AXIS, Group, block

# BAState fields whose leading axis is the point axis
_POINT_FIELDS = ("p_host", "p_uv", "p_idepth", "p_idepth_zero", "p_color",
                 "p_weight", "p_prior", "p_status", "r_active")


def state_specs(axis: str = AXIS) -> BAState:
    """Which fields split: a BAState holding ``axis`` in the point fields
    and None (replicated) in the others (JAX: its PartitionSpec tree)."""
    fields = {name: axis if name in _POINT_FIELDS else None
              for name in BAState._fields}
    fields["T_eval"] = SE3(None, None)
    return BAState(**fields)


def shard_state(state: BAState, rank: int, world_size: int) -> BAState:
    """Rank ``rank``'s part of a whole BAState: its contiguous block of the
    point fields, the rest as it is. Raises unless P % world_size == 0."""
    return state._replace(**{name: block(getattr(state, name), rank,
                                         world_size)
                             for name in _POINT_FIELDS})


def gather_state(local: BAState, group: Group) -> BAState:
    """The whole BAState on every rank: the point blocks concatenated in
    rank order, the replicated fields from this rank."""
    return local._replace(**{name: group.all_gather(getattr(local, name))
                             for name in _POINT_FIELDS})


def _as(dtype, tup):
    """A NamedTuple of tensors (SE3 fields included) with every floating
    tensor cast to ``dtype``."""
    return type(tup)(*(_as(dtype, x) if isinstance(x, tuple) else
                       (x.to(dtype) if x.is_floating_point() else x)
                       for x in tup))


def ba_iterate_sharded(state: BAState, target_images, group: Group,
                       height: int, width: int, iterations: int = 6,
                       lam: float = 1e-5, huber_th: float = 9.0,
                       orth_from_iteration: int = 2):
    """Distributed ba_iterate: a fixed count of GN iterations (no host read)
    on this rank's point block, each one float32 ``linearize``, then
    ``assemble`` and ``solve_delta(reduce=...)`` in float64. Returns (state,
    final energy summed over the ranks)."""
    for it in range(iterations):
        lin = energy.linearize(state, target_images, height, width,
                               huber_th=huber_th)
        s64 = _as(torch.float64, state)
        asm = energy.assemble(s64, _as(torch.float64, lin))
        sol = energy.solve_delta(s64, asm, lam=lam,
                                 use_orth=(it >= orth_from_iteration),
                                 reduce=group.all_reduce)
        state = energy.apply_step(state, _as(state.delta.dtype, sol))
    lin = energy.linearize(state, target_images, height, width,
                           huber_th=huber_th)
    return state, group.all_reduce(torch.sum(lin.energy))


def marginalize_points_sharded(state: BAState, target_images, group: Group,
                               height: int, width: int,
                               marg_weight: float = 0.25) -> BAState:
    """Distributed point marginalization: every rank contributes its flagged
    points; HM/bM update through one set of float64 sums (replicated
    result), rounded to the state's dtype."""
    lin = energy.linearize(state, target_images, height, width)
    m = energy.marginalize_points(_as(torch.float64, state),
                                  _as(torch.float64, lin),
                                  marg_weight=marg_weight,
                                  reduce=group.all_reduce)
    return _as(state.delta.dtype, m)
