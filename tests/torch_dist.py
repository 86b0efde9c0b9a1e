"""Rank functions of the port's sharded-path tests: ``parallel.run_ranks``
spawns each rank in a fresh process, which imports these by name (no JAX
here). Each runs every case of one rank count inside one process group and
returns what the parent compares, tensors as numpy."""
import numpy as np
import torch

from slam_eds_tpu_torch.models import ba_state as bs
from slam_eds_tpu_torch.ops import energy
from slam_eds_tpu_torch.ops import event_tracker as et
from slam_eds_tpu_torch.parallel import block
from slam_eds_tpu_torch.parallel import sharded_ba as sba
from slam_eds_tpu_torch.parallel.sharded_event_tracker import optimize_sharded
from slam_eds_tpu_torch.utils.cameras import Pinhole


def flag_oldest(full, cycle):
    """The lifecycle's host policy of ``tests/test_sharded_ba.py``, on the
    whole state: every third active point hosted by frame ``cycle`` flagged
    for marginalization. Returns the new [P] status."""
    stat = full.p_status.numpy().copy()
    act = np.where((stat == bs.PT_ACTIVE)
                   & (full.p_host.numpy() == cycle))[0]
    stat[act[::3]] = bs.PT_MARGINALIZE
    return torch.as_tensor(stat)


def ba_cases_rank(group, scenes):
    """The three cases of ``tests/test_sharded_ba.py`` on this rank:
    ``scenes[name] = (state as numpy dict, images, H, W)``. Returns, per
    case, the whole final state (and the energy of the 4-iteration BA)."""
    def load(name):
        d, imgs, H, W = scenes[name]
        st = sba.shard_state(bs.from_numpy(d, device="cpu"), group.rank,
                             group.world_size)
        return st, torch.as_tensor(imgs), H, W

    out = {}
    st, imgs, H, W = load("ba")
    st, e = sba.ba_iterate_sharded(st, imgs, group, H, W, iterations=4)
    out["ba"] = {"state": sba.gather_state(st, group), "energy": e}

    st, imgs, H, W = load("marg")
    st = sba.marginalize_points_sharded(st, imgs, group, H, W)
    out["marg"] = {"state": sba.gather_state(st, group)}

    # three cycles: BA -> point marginalization -> frame marginalization
    st, imgs, H, W = load("lifecycle")
    for cycle in range(3):
        st, _ = sba.ba_iterate_sharded(st, imgs, group, H, W, iterations=2)
        stat = flag_oldest(sba.gather_state(st, group), cycle)
        st = st._replace(p_status=block(stat, group.rank, group.world_size))
        st = sba.marginalize_points_sharded(st, imgs, group, H, W)
        st = energy.marginalize_frame(st, slot=cycle)
    out["lifecycle"] = {"state": sba.gather_state(st, group)}
    return out


def tracker_cases_rank(group, problem, cases):
    """Sharded event solves on this rank's block of the points: ``problem``
    holds the camera tuple, the event frame and the [P] point arrays;
    ``cases`` is a list of (name, overrides of the point arrays, keyword
    arguments). Returns, per case, the replicated result and this rank's
    residual block."""
    cam = Pinhole(*problem["cam"])
    ef = torch.as_tensor(problem["ef"])
    out = {}
    for name, over, kw in cases:
        arr = {k: torch.as_tensor(over.get(k, problem[k]))
               for k in ("nc", "grad", "idp", "weights", "mask")}
        loc = {k: block(v, group.rank, group.world_size)
               for k, v in arr.items()}
        res = optimize_sharded(et.initial_tracker_state("cpu"), ef, cam,
                               loc["nc"], loc["grad"], loc["idp"],
                               loc["weights"], loc["mask"], group, **kw)
        out[name] = res
    return out


def failing_rank(group):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    group.all_reduce(torch.ones(3))
    return "unreachable"
