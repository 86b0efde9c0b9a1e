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

``utils.linalg.solve`` on CPU tensors is ``torch.linalg.solve_ex``, bit
for bit; the kernel's wrapper refuses CPU tensors, and the launch ledger
counts the small solve beside the other kernels, also per size.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu_torch import graphs
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
    size and joins the ledger then: a delta across its making counts it
    from 0, and leaves every other counter as it was."""
    before = graphs.launch_ledger()
    assert "small_solve" in before and "lu_substitute" in before
    assert [k for k in before if k.startswith("small_solve_n")] == [
        c.__name__ for c in lu.SMALL_SOLVE_BY_N.values()]
    n = next(m for m in range(1, lu.MAX_N + 1)
             if m not in lu.SMALL_SOLVE_BY_N)
    count = lu.LaunchCount(f"small_solve_n{n}")
    monkeypatch.setitem(lu.SMALL_SOLVE_BY_N, n, count)
    count.launches += 3
    assert graphs.counters()[-1] is count
    delta = graphs.ledger_delta(before, graphs.launch_ledger())
    assert delta.pop(f"small_solve_n{n}") == {"slots": 3, "run": 3}
    assert all(v == {"slots": 0, "run": 0} for v in delta.values())
