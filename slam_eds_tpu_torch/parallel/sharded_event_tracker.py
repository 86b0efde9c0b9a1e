"""Distributed event-to-model alignment over ranks — port of
``slam_eds_tpu.parallel.sharded_event_tracker``.

The event tracker's point residuals (``ops.event_tracker``) split over the
ranks the way the BA points do (``parallel.sharded_ba``): each rank owns a
contiguous block of points and the [12, 12] Gauss-Newton system is summed
over the ranks.

Two global couplings take collectives, both inside the single-card code
through its ``reduce``/``gather`` hooks (the JAX module's
``_residuals_sharded`` is ``event_residuals(reduce=...)`` here):
* the model normalization ``model / ||model||`` (and, for the NC cost, the
  event normalization): one sum over the ranks, a global normalization
  that does not depend on the rank count,
* the robust-loss statistics (the MAD of the final residuals): the residual
  vector and mask are gathered in rank order, so every rank computes the
  same global MAD.

The pose/velocity state, the event frame and the LM control are replicated;
the energies that decide acceptance and the early stop are sums over the
ranks, so every rank takes the same step and leaves at the same iteration.
The solve runs eagerly over gloo, so its LM is the masked loop
(``graphs.while_loop`` outside a capture): every pass to the cap runs,
the passes after the stop keeping their carry.
"""
from __future__ import annotations

from ..ops import event_tracker as et
from ..utils.cameras import Pinhole
from . import AXIS, Group  # noqa: F401  (AXIS: the JAX module's axis name)


def optimize_sharded(state: et.TrackerState, event_frame, cam: Pinhole,
                     norm_coord, grad, idp, weights, mask, group: Group,
                     max_iterations: int = 20, loss_kind: str = "huber",
                     loss_scale=0.2, function_tolerance: float = 1e-6,
                     norm_event: bool = False) -> et.TrackerResult:
    """Distributed Tracker::optimize. The point arrays (``norm_coord``,
    ``grad``, ``idp``, ``weights``, ``mask``) are this rank's block
    (``parallel.block``); the state and the frame are replicated. Matches
    ``ops.event_tracker.optimize`` up to summation order; the result's
    ``residuals`` are this rank's block, the rest is replicated."""
    return et._lm_solve(state, event_frame, cam, norm_coord, grad, idp,
                        weights, mask, max_iterations, loss_kind, loss_scale,
                        function_tolerance, norm_event,
                        reduce=group.all_reduce, gather=group.all_gather)
