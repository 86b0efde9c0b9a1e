"""The loops' small solve on the CPU: ``small_solve_reference`` (the
algorithm of the ``small_solve`` kernel of ``csrc/lu_solve.cu`` in torch
ops), the same seeded numpy inputs through the JAX package's solve and the
port's.

* Against ``jnp.linalg.solve`` at the loops' sizes (the coarse LM's 6 and
  8, the BA gauge's 7, the event LM's 12) in float32, on systems built as
  the LM loops build theirs (``J^T J + lam diag(J^T J) + 1e-10 I``,
  condition at most 1e4, checked): x within 1e-4 of its scale. Both are LU
  with partial pivoting in float32; their gap is two rounding orders times
  the condition.
* Against ``torch.linalg.lu_factor`` (LAPACK's getrf on the CPU): the same
  pivots, on systems whose two largest pivot candidates differ by more
  than 1e-3 of the larger at every step (closer ones may trade places with
  the rounding), and factors within 1e-4 of their scale.
* Backward error ||A x - b|| / (||A|| ||x|| + ||b||) (max norms, in
  float64) at most n eps, in float32 and float64, at n = 1, 6, 7, 8, 12
  and 32, on both draws.

* ``torch.vmap`` of the kernel's operator (``solve_op``, whose vmap rule
  gathers every lane into one call of ``small_solve``): each lane bitwise
  ``small_solve_reference`` on that system alone, with A, b or both mapped,
  the mapped axis first or not, and nested maps, in one call; against
  ``jax.vmap(jnp.linalg.solve)`` within 1e-4 of the scale (as above).

``utils.linalg.solve`` on CPU tensors is ``torch.linalg.solve_ex``, bit
for bit; up to 32 unknowns elsewhere it takes the operator, under
``torch.vmap`` or not (checked on meta tensors, which reach the
operator's fake); the kernel's wrapper refuses CPU tensors, and the launch
ledger counts the small solve beside the other kernels, also per size.
"""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu_torch import graphs
from slam_eds_tpu_torch.ops.kernels import build
from slam_eds_tpu_torch.ops.kernels import lu_solve as lu
from slam_eds_tpu_torch.utils.linalg import solve

torch.set_num_threads(1)
PATH_SIZES = (6, 7, 8, 12)


def path_system(rng, n, scale_decades=1.0):
    """``J^T J + lam diag(J^T J) + 1e-10 I`` in float64 (J with 3n + 2
    rows, its columns scaled over ``scale_decades`` decades, lam over
    1e-4..1e2) and a right-hand side."""
    J = rng.normal(size=(3 * n + 2, n)) * 10.0 ** (
        scale_decades * (rng.random(n) - 0.5))
    H = J.T @ J
    lam = 10.0 ** rng.uniform(-4, 2)
    return H + lam * np.diag(np.diag(H)) + 1e-10 * np.eye(n), \
        rng.normal(size=n)


def general_system(rng, n):
    return rng.normal(size=(n, n)) + 0.05 * np.eye(n), rng.normal(size=n)


def pivot_gaps(A):
    """Per elimination step (float64, partial pivoting), the gap between
    the two largest candidates over the larger."""
    M = A.astype(np.float64).copy()
    n = len(M)
    gaps = []
    for k in range(n - 1):
        c = np.sort(np.abs(M[k:, k]))[::-1]
        gaps.append((c[0] - c[1]) / c[0])
        p = k + int(np.argmax(np.abs(M[k:, k])))
        M[[k, p]] = M[[p, k]]
        M[k + 1:, k] /= M[k, k]
        M[k + 1:, k + 1:] -= np.outer(M[k + 1:, k], M[k, k + 1:])
    return gaps


def relative_residual(A, x, b):
    A, x, b = (np.asarray(t, dtype=np.float64) for t in (A, x, b))
    r = A @ x - b
    return np.abs(r).max() / (np.abs(A).sum(1).max() * np.abs(x).max()
                              + np.abs(b).max())


@pytest.mark.parametrize("n", PATH_SIZES)
def test_small_solve_reference_matches_jax_solve(n):
    rng = np.random.default_rng(100 + n)
    for _ in range(20):
        A, b = path_system(rng, n)
        A32, b32 = A.astype(np.float32), b.astype(np.float32)
        assert np.linalg.cond(A32.astype(np.float64)) <= 1e4
        want = np.asarray(jnp.linalg.solve(jnp.asarray(A32),
                                           jnp.asarray(b32)))
        got = lu.small_solve_reference(torch.as_tensor(A32),
                                       torch.as_tensor(b32)).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("draw", ["path", "general"])
@pytest.mark.parametrize("n", [2, *PATH_SIZES, 32])
def test_small_lu_reference_pivots_are_lapacks(n, draw):
    rng = np.random.default_rng(200 + n)
    kept = 0
    while kept < 10:
        A, b = (path_system(rng, n, 2.0) if draw == "path"
                else general_system(rng, n))
        A32 = A.astype(np.float32)
        if n > 1 and min(pivot_gaps(A32)) <= 1e-3:
            continue
        kept += 1
        M, piv = lu.small_lu_reference(torch.as_tensor(A32),
                                       torch.as_tensor(b.astype(np.float32)))
        LU, want = torch.linalg.lu_factor(torch.as_tensor(A32))
        assert torch.equal(piv, want.to(torch.int32))
        scale = float(LU.abs().max())
        assert float((M[:, :n] - LU).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, *PATH_SIZES, 32])
def test_small_solve_reference_backward_error(n, dtype):
    rng = np.random.default_rng(300 + n)
    eps = torch.finfo(dtype).eps
    for draw in (path_system, general_system):
        for _ in range(10):
            A, b = draw(rng, n)
            A, b = (torch.as_tensor(t, dtype=dtype) for t in (A, b))
            x = lu.small_solve_reference(A, b)
            assert torch.isfinite(x).all()
            assert relative_residual(A, x, b) <= n * eps


def test_small_solve_reference_takes_leading_axes():
    """Systems stacked on leading axes are solved each as if alone."""
    rng = np.random.default_rng(7)
    A = np.stack([[general_system(rng, 7)[0] for _ in range(3)]
                  for _ in range(2)]).astype(np.float32)
    b = rng.normal(size=(2, 3, 7)).astype(np.float32)
    A, b = torch.as_tensor(A), torch.as_tensor(b)
    got = lu.small_solve_reference(A, b)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j],
                               lu.small_solve_reference(A[i, j], b[i, j]))


@pytest.mark.parametrize("n", [*PATH_SIZES, 68])
def test_solve_on_the_cpu_is_solve_ex(n):
    rng = np.random.default_rng(400 + n)
    A, b = (torch.as_tensor(t, dtype=torch.float32)
            for t in general_system(rng, n))
    assert torch.equal(solve(A, b), torch.linalg.solve_ex(
        A, b[:, None], check_errors=False)[0][:, 0])


def test_small_solve_dispatch_and_checks():
    """On CPU tensors ``small_solve`` is its plain version and launches
    nothing; the kernel's wrapper refuses them."""
    rng = np.random.default_rng(5)
    A, b = (torch.as_tensor(t, dtype=torch.float32)
            for t in general_system(rng, 12))
    before = lu.small_solve.launches
    assert torch.equal(lu.small_solve(A, b), lu.small_solve_reference(A, b))
    assert lu.small_solve.launches == before
    with pytest.raises(ValueError):
        lu.small_solve_cuda(A, b)


def test_launch_ledger_counts_the_small_solve_per_size(monkeypatch):
    """A size's counter is made at the small solve's first launch at that
    size and joins the registry (``build.COUNTERS``), and so the ledger,
    then: a delta across its making counts it from 0, and leaves every
    other counter as it was."""
    before = graphs.launch_ledger()
    assert "small_solve" in before
    assert [k for k in before if k.startswith("small_solve_n")] == [
        c.__name__ for c in lu.SMALL_SOLVE_BY_N.values()]
    n = next(m for m in range(1, lu.MAX_N + 1)
             if m not in lu.SMALL_SOLVE_BY_N)
    monkeypatch.setattr(build, "COUNTERS", list(build.COUNTERS))
    count = lu.LaunchCount(f"small_solve_n{n}")
    monkeypatch.setitem(lu.SMALL_SOLVE_BY_N, n, count)
    count.launches += 3
    assert graphs.counters()[-1] is count
    delta = graphs.ledger_delta(before, graphs.launch_ledger())
    assert delta.pop(f"small_solve_n{n}") == {"slots": 3, "run": 3}
    assert all(v == {"slots": 0, "run": 0} for v in delta.values())


LANE_CASES = ((7, 2), (12, 4), (8, 3))


def lane_systems(n, B, seed):
    """B float32 systems of n unknowns as the LM loops build them
    (condition at most 1e4, checked) and their right-hand sides."""
    rng = np.random.default_rng(seed)
    A, b = zip(*(path_system(rng, n) for _ in range(B)))
    A, b = np.stack(A).astype(np.float32), np.stack(b).astype(np.float32)
    assert max(np.linalg.cond(a.astype(np.float64)) for a in A) <= 1e4
    return torch.as_tensor(A), torch.as_tensor(b)


def counted_calls(monkeypatch):
    """The calls of ``small_solve`` on the CPU (its plain version), each
    with its number of systems."""
    calls, plain = [], lu.small_solve_reference

    def count(A, b):
        calls.append(b.numel() // b.shape[-1])
        return plain(A, b)
    monkeypatch.setattr(lu, "small_solve_reference", count)
    return calls


@pytest.mark.parametrize("mapped", ["A", "b", "both", "not_first"])
@pytest.mark.parametrize("n,B", LANE_CASES)
def test_solve_op_vmap_is_each_system_alone(n, B, mapped, monkeypatch):
    """``torch.vmap`` of the operator: one call over every lane, each lane
    bitwise the plain version on its system alone; an unmapped operand is
    every lane's."""
    A, b = lane_systems(n, B, 500 + n)
    want_A = A if mapped != "b" else A[:1].expand(B, n, n)
    want_b = b if mapped != "A" else b[:1].expand(B, n)
    want = torch.stack([lu.small_solve_reference(want_A[i], want_b[i])
                        for i in range(B)])
    calls = counted_calls(monkeypatch)
    if mapped == "A":
        got = torch.vmap(lu.solve_op, in_dims=(0, None))(A, b[0])
    elif mapped == "b":
        got = torch.vmap(lu.solve_op, in_dims=(None, 0))(A[0], b)
    elif mapped == "both":
        got = torch.vmap(lu.solve_op)(A, b)
    else:
        got = torch.vmap(lu.solve_op, in_dims=(2, 1))(
            A.permute(1, 2, 0), b.T)
    assert calls == [B]
    assert torch.equal(got, want)


def test_solve_op_nested_vmap(monkeypatch):
    """2 x 3 lanes under two nested maps: one call over all six, each
    bitwise its system alone."""
    A, b = lane_systems(12, 6, 600)
    A, b = A.reshape(2, 3, 12, 12), b.reshape(2, 3, 12)
    calls = counted_calls(monkeypatch)
    got = torch.vmap(torch.vmap(lu.solve_op))(A, b)
    assert calls == [6]
    assert got.shape == (2, 3, 12)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j],
                               lu.small_solve_reference(A[i, j], b[i, j]))


@pytest.mark.parametrize("n,B", LANE_CASES)
def test_solve_op_vmap_matches_jax_vmap_solve(n, B):
    """The batched surfaces of both packages on the same seeded systems:
    ``jax.vmap(jnp.linalg.solve)`` and ``torch.vmap`` of the operator,
    within 1e-4 of x's scale lane by lane."""
    A, b = lane_systems(n, B, 700 + n)
    want = np.asarray(jax.vmap(jnp.linalg.solve)(jnp.asarray(A.numpy()),
                                                 jnp.asarray(b.numpy())))
    got = torch.vmap(lu.solve_op)(A, b).numpy()
    for i in range(B):
        assert np.abs(got[i] - want[i]).max() <= 1e-4 * np.abs(want[i]).max()


def test_solve_route_off_the_cpu(monkeypatch):
    """Off the CPU, up to 32 unknowns, ``utils.linalg.solve`` takes the
    kernel's operator, outside ``torch.vmap`` and under it (on meta tensors
    the operator's fake gives the [B, n] result); above 32 it does not."""
    from slam_eds_tpu_torch.utils import linalg
    seen = []

    def op(A, b):
        seen.append(tuple(A.shape))
        return lu.solve_op(A, b)
    monkeypatch.setattr(linalg, "solve_op", op)
    A = torch.empty(4, 12, 12, device="meta")
    b = torch.empty(4, 12, device="meta")
    got = torch.vmap(solve)(A, b)
    assert got.shape == (4, 12) and got.device.type == "meta"
    assert solve(A, b).shape == (4, 12)
    assert seen == [(12, 12), (4, 12, 12)]
    seen.clear()
    A = torch.empty(33, 33, device="meta")
    try:
        solve(A, torch.empty(33, device="meta"))
    except (NotImplementedError, RuntimeError):
        pass                      # torch's factorization has no meta kernel
    assert seen == []
