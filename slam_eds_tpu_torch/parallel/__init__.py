"""Point-sharded paths on ``torch.distributed`` — the port's counterpart of
the JAX package's one-axis device mesh (``slam_eds_tpu.parallel``).

A JAX mesh names devices inside one process and ``shard_map`` splits the
point axis over them; here each rank is a process that holds its own block
of the point axis and a copy of everything else:

* ``make_group`` joins a process group (the counterpart of ``make_mesh``):
  gloo on the CPU and when several ranks share one card, NCCL only when
  each rank has a card of its own. The returned ``Group`` sums
  (``all_reduce``, JAX ``psum``) and concatenates in rank order
  (``all_gather``, JAX ``all_gather(tiled=True)``). Under gloo a tensor on
  the card is copied to the host for the collective and back: the reduced
  tensors are small (the ``[4+8F]`` BA system, the ``[12, 12]`` tracker
  system, scalars, the gathered ``[P]`` residuals) and the math stays on the
  card.
* ``run_ranks`` starts the ranks as spawned processes, rendezvoused through a
  ``file://`` store, and returns each rank's result as numpy; a rank that
  raises makes the call raise and stops its peers.
* ``block`` splits an array along its leading (point) axis into contiguous
  blocks, raising unless they are equal, as ``shard_map`` does.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import resolve_device, set_numerics

AXIS = "points"
COLLECTIVE_TIMEOUT = 60.0   # seconds a collective waits for its peers
CALL_TIMEOUT = 600.0        # seconds ``run_ranks`` waits for every result


class Group(NamedTuple):
    """This process's place in the process group."""
    rank: int
    world_size: int
    device: torch.device
    backend: str

    def _staged(self, x):
        """x as the collective takes it: a private copy (collectives work in
        place), on the host under gloo."""
        if self.backend == "gloo":
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone().contiguous()

    def all_reduce(self, x):
        """Sum of ``x`` over the ranks, the same on every rank."""
        y = self._staged(x)
        dist.all_reduce(y)
        return y.to(x.device)

    def all_gather(self, x):
        """The ranks' ``x`` concatenated along dim 0 in rank order."""
        src = self._staged(x.to(torch.uint8) if x.dtype == torch.bool else x)
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        out = torch.cat(parts).to(x.device)
        return out.bool() if x.dtype == torch.bool else out


def default_backend(world_size: int, device="cuda") -> str:
    """NCCL when each of ``world_size`` ranks has a card of its own, gloo on
    the CPU and when ranks share a card (NCCL refuses two ranks on one
    device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def make_group(rank: int, world_size: int, init_method: str,
               backend: str | None = None,
               timeout: float = COLLECTIVE_TIMEOUT, device="cuda") -> Group:
    """Join the default process group as ``rank`` of ``world_size``.

    On the card each rank takes ``cuda:rank % count``; ``backend`` defaults
    to ``default_backend``. A collective that waits longer than ``timeout``
    seconds raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        set_numerics()
    backend = backend or default_backend(world_size, dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout))
    return Group(rank, world_size, dev, backend)


def block(x, rank: int, world_size: int):
    """Rank ``rank``'s contiguous block of ``x`` along dim 0."""
    n = x.shape[0]
    if n % world_size:
        raise ValueError(f"{n} points do not split evenly over {world_size} "
                         f"ranks")
    m = n // world_size
    return x[rank * m:(rank + 1) * m]


def _to_numpy(x):
    """Tensors inside (named) tuples, lists and dicts -> numpy arrays."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _rank_main(fn, rank, world_size, init_method, backend, device, args,
               results):
    """One spawned rank: join the group, run ``fn(group, *args)``, report
    (rank, True, result as numpy) or (rank, False, traceback)."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        group = make_group(rank, world_size, init_method, backend,
                           device=device)
        with torch.inference_mode():
            out = _to_numpy(fn(group, *args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, device="cuda",
              store_dir: str | None = None, backend: str | None = None):
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks; returns
    their results in rank order (tensors as numpy arrays).

    ``fn`` must be importable in a fresh process (a module-level function).
    The ranks rendezvous through a ``file://`` store in ``store_dir`` (a new
    temporary directory when None), never a fixed port, and join over
    ``backend`` (``default_backend`` when None). A collective waits at most
    ``COLLECTIVE_TIMEOUT`` seconds; the first rank that raises, or dies,
    makes the call raise with its traceback and kills its peers, and so
    does a call that outlasts ``CALL_TIMEOUT`` seconds."""
    resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_method, backend,
                                   device, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + CALL_TIMEOUT
        try:
            while len(out) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                    if time.monotonic() > deadline:
                        missing = sorted(set(range(world_size)) - set(out))
                        raise TimeoutError(f"ranks {missing} gave no result "
                                           f"in {CALL_TIMEOUT} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(COLLECTIVE_TIMEOUT)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
