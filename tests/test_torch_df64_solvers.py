"""The port's double-word solvers held against the JAX package.

``cg_df64`` / ``bicgstab_df64`` and the refinement solvers ``cg_ir_df64`` /
``bicgstab_ir_df64`` run on the same double-word operators (carried over by
``interop``) and the same seeded float64 right-hand sides in both packages.
Held: the same status, iteration counts within 2 for the full double-word
recurrences (the JAX package computes its error-free transforms through
float64 on the CPU, which moves the step that crosses eps by at most one or
two) and x within relative 1e-10 of the JAX solution; for the refinement
solvers the same status, outer rounds within one, and total inner f32
iterations within 5% plus a round's worth for each round apart (the f32
inner dots sum in other orders: ``torch.dot`` here, ``jnp.sum`` there; see
test_refinement_matches_jax).  Every SUCCESS is checked on the host: ``||b - A x||``
in float64 against the operator's float64 values is at most eps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.ops import df32 as JD
from sparse_matrix_math_tpu.precond.padded_sgs import PaddedSGS as JaxPaddedSGS
from sparse_matrix_math_tpu.solvers.ir_df64 import hi_operator as jax_hi_operator
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.precond import PaddedSGS
from sparse_matrix_math_tpu_torch.solvers import _loop
from sparse_matrix_math_tpu_torch.solvers.ir_df64 import hi_operator

SUCCESS = smm.SolverStatus.SUCCESS
MAX = smm.SolverStatus.MAX_ITERATIONS_REACHED


def _csr(name, n, dtype=np.float64):
    """Host CSR arrays of a generator's matrix, or of ``drift``: the JAX
    package's nonsymmetric test system, Poisson with 0.3 added on the +1
    diagonal (tests/test_ir_df64.py:211-219)."""
    a = getattr(jax_gen, "poisson_2d" if name == "drift" else name)(n, dtype=dtype)
    data, indices, indptr = (np.array(a.data), np.asarray(a.indices, np.int64),
                             np.asarray(a.indptr, np.int64))
    if name == "drift":
        rows = np.repeat(np.arange(a.shape[0]), np.diff(indptr))
        data[indices == rows + 1] += 0.3
    return data, indices, indptr, a.shape


def _system(name, n, fmt="dia", seed=0):
    """(JAX operator, port operator, host CSR, b = A @ x_true in float64)
    for a seeded standard-normal x_true."""
    data, indices, indptr, shape = _csr(name, n)
    if fmt == "dia":
        j = JD.DfDiaMatrix.from_host_csr(data, indices, indptr, shape)
        t = interop.df_dia_from_numpy(np.asarray(j.diags_hi), np.asarray(j.diags_lo), j.offsets,
                                      j.shape, j.nnz, "cpu")
    else:
        j = JD.DfEllMatrix.from_host_csr(data, indices, indptr, shape)
        t = interop.df_ell_from_numpy(np.asarray(j.vals_hi), np.asarray(j.vals_lo),
                                      np.asarray(j.cols), j.shape, j.nnz, "cpu")
    x_true = np.random.default_rng(seed).standard_normal(shape[0])
    b = np.add.reduceat(data * x_true[indices], indptr[:-1])
    return j, t, (data, indices, indptr), b


def _true_residual(csr, b, x):
    data, indices, indptr = csr
    return float(np.linalg.norm(b - np.add.reduceat(data * x[indices], indptr[:-1])))


def _check_success(res, csr, b, eps):
    assert res.status == SUCCESS, res
    assert isinstance(res.x_hi, torch.Tensor) and res.x_hi.dtype == torch.float32
    assert res.x_f64().dtype == np.float64 and np.all(np.isfinite(res.x_f64()))
    assert _true_residual(csr, b, res.x_f64()) <= eps


def _rel(x, y):
    return np.linalg.norm(x - y) / np.linalg.norm(y)


DF_CASES = [("cg_df64", "poisson_2d", 32, "dia"), ("cg_df64", "poisson_2d", 32, "ell"),
            ("bicgstab_df64", "convection_diffusion_2d", 24, "dia"),
            ("bicgstab_df64", "convection_diffusion_2d", 24, "ell")]


@pytest.mark.parametrize("solver,name,n,fmt", DF_CASES, ids=[f"{c[0]}-{c[3]}" for c in DF_CASES])
def test_df_solvers_match_jax(solver, name, n, fmt):
    j, t, csr, b = _system(name, n, fmt)
    eps = 1e-10
    want = getattr(jsmm, solver)(j, b, epsilon=eps)
    syncs = _loop.host_syncs["count"]
    got = getattr(smm, solver)(t, b, epsilon=eps)
    _check_success(got, csr, b, eps)
    assert got.status == int(want.status)
    assert abs(got.iterations - int(want.iterations)) <= 2
    assert _rel(got.x_f64(), want.x_f64()) <= 1e-10
    # one host read per chunk of iterations, plus the result
    assert _loop.host_syncs["count"] - syncs <= got.iterations // _loop.CHUNK + 3
    assert float(got.residual_norm2) <= np.float32(eps ** 2)


def test_cg_df64_accepts_csr_and_pairs():
    """A float64 CSR matrix keeps its values (the same operator as the
    double-word DIA one); b as an (hi, lo) pair or as a float64 tensor."""
    j, t, csr, b = _system("poisson_2d", 16)
    port_csr = interop.csr_from_numpy(csr[2], csr[1], csr[0], t.shape, "cpu")
    ref = smm.cg_df64(t, b, epsilon=1e-10)
    for a, rhs in ((port_csr, b), (t, smm.df_from_host(b, device="cpu")),
                   (t, torch.from_numpy(b))):
        res = smm.cg_df64(a, rhs, epsilon=1e-10)
        assert res.iterations == ref.iterations
        assert torch.equal(res.x_hi, ref.x_hi) and torch.equal(res.x_lo, ref.x_lo)
    # float32 values: zero lo planes, a double-word recurrence all the same
    res = smm.cg_df64(interop.csr_from_numpy(csr[2], csr[1], csr[0].astype(np.float32), t.shape,
                                             "cpu"), np.ones(t.shape[0], np.float32))
    assert res.status == SUCCESS and res.x.shape == (t.shape[0],)


@pytest.mark.parametrize("solver", ["cg_df64", "bicgstab_df64"])
def test_df_status_paths_match_jax(solver):
    j, t, csr, b = _system("poisson_2d", 8)
    for kw in (dict(max_iterations=1, epsilon=1e-14), dict(max_iterations=0, epsilon=1e-14)):
        got, want = getattr(smm, solver)(t, b, **kw), getattr(jsmm, solver)(j, b, **kw)
        assert got.status == int(want.status) == MAX
        assert got.iterations == int(want.iterations) == kw["max_iterations"]
    zero = getattr(smm, solver)(t, np.zeros(t.shape[0]), epsilon=1e-12)
    assert zero.status == SUCCESS and zero.iterations == 0
    assert float(zero.residual_norm2) == 0.0
    with pytest.raises(TypeError):
        getattr(smm, solver)(np.eye(4), np.ones(4))


# Sizes where a round takes tens of inner iterations, so one iteration more
# or fewer in a round stays inside the 5%.  The unpreconditioned and Jacobi
# BiCGStab cases run on the JAX package's own nonsymmetric test system: on
# the convection-diffusion stencil the f32 BiCGStab inner counts move by up
# to ~25% with the summation order of the dots alone (measured in both
# packages at n = 32-96), so only its SGS-preconditioned solve is compared.
IR_CASES = [("cg_ir_df64", "poisson_2d", 48, "dia", p) for p in ("none", "jacobi", "padded_sgs")]
IR_CASES += [("bicgstab_ir_df64", "drift", 48, "dia", p) for p in ("none", "jacobi")]
IR_CASES += [("bicgstab_ir_df64", "convection_diffusion_2d", 48, "dia", "padded_sgs"),
             ("cg_ir_df64", "poisson_2d", 32, "ell", "none"),
             ("bicgstab_ir_df64", "drift", 40, "ell", "jacobi")]


def _preconditioners(kind, name, n, j, t):
    if kind == "none":
        return None, None
    if kind == "jacobi":
        data, indices, indptr, _ = _csr(name, n)
        rows = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
        inv = (1.0 / data[indices == rows]).astype(np.float32)
        return (jsmm.JacobiPreconditioner(inv_diag=jnp.asarray(inv)),
                interop.jacobi_from_numpy(inv, "cpu"))
    return (JaxPaddedSGS.from_dia(jax_hi_operator(j), sweeps=4),
            PaddedSGS.from_dia(hi_operator(t), sweeps=4))


@pytest.mark.parametrize("solver,name,n,fmt,pre", IR_CASES,
                         ids=[f"{c[0]}-{c[3]}-{c[4]}" for c in IR_CASES])
def test_refinement_matches_jax(solver, name, n, fmt, pre):
    """Both solves end in SUCCESS at the host's float64 residual, so the last
    round of each is the first to cross eps; the f32 inner dots' summation
    order can put that crossing one round later.  On the SGS-preconditioned
    convection-diffusion case (seeds 0-2) the port ends after 5 or 6 rounds
    depending on the order alone (BLAS sdot, torch.sum, pairwise, the
    correctly rounded sum), and the JAX package after 5 or 6.  So the rounds
    agree within one, and the inner iterations within 5% plus one round's
    worth for each round apart (a round taken as the longer mean round of
    the two solves)."""
    j, t, csr, b = _system(name, n, fmt)
    eps = 1e-10
    jpre, tpre = _preconditioners(pre, name, n, j, t)
    want = getattr(jsmm, solver)(j, b, epsilon=eps, preconditioner=jpre)
    got = getattr(smm, solver)(t, b, epsilon=eps, preconditioner=tpre)
    _check_success(got, csr, b, eps)
    assert got.status == int(want.status)
    w_rounds, w_its = int(want.outer_rounds), int(want.iterations)
    apart = abs(got.outer_rounds - w_rounds)
    assert apart <= 1 and min(got.outer_rounds, w_rounds) >= 2
    round_len = max(w_its / w_rounds, got.iterations / got.outer_rounds)
    assert abs(got.iterations - w_its) <= 0.05 * w_its + apart * round_len


def test_padded_sgs_inner_applies_in_the_padded_layout(monkeypatch):
    """A PaddedSGS of the inner operator's layout applies to padded vectors
    (one fused apply per inner step, K4 on a card); one of another layout
    goes through its logical ``apply``, as in the JAX package."""
    from sparse_matrix_math_tpu_torch.ops import trisweep

    j, t, csr, b = _system("convection_diffusion_2d", 12)
    calls = {"padded": 0, "logical": 0}
    real = trisweep.sgs_apply_plain

    def counting(psgs, rp):
        calls["padded"] += 1
        return real(psgs, rp)

    monkeypatch.setattr(trisweep, "sgs_apply_plain", counting)
    pre = PaddedSGS.from_dia(hi_operator(t), sweeps=4)
    logical = PaddedSGS.apply

    def counting_apply(self, r):
        calls["logical"] += 1
        return logical(self, r)

    monkeypatch.setattr(PaddedSGS, "apply", counting_apply)
    res = smm.bicgstab_ir_df64(t, b, epsilon=1e-10, preconditioner=pre)
    _check_success(res, csr, b, 1e-10)
    assert calls["padded"] >= 2 * res.iterations
    assert calls["logical"] == 0
    # the ELL inner operator has no padded layout: the logical apply runs
    _, te, _, _ = _system("convection_diffusion_2d", 12, "ell")
    res = smm.bicgstab_ir_df64(te, b, epsilon=1e-10, preconditioner=pre)
    _check_success(res, csr, b, 1e-10)
    assert calls["logical"] >= 2 * res.iterations


@pytest.mark.parametrize("solver", ["cg_ir_df64", "bicgstab_ir_df64"])
def test_refinement_status_paths_match_jax(solver):
    name = "poisson_2d" if solver == "cg_ir_df64" else "convection_diffusion_2d"
    j, t, csr, b = _system(name, 8)
    got = getattr(smm, solver)(t, b, max_iterations=0)
    assert got.status == int(getattr(jsmm, solver)(j, b, max_iterations=0).status) == MAX
    # an unreachable epsilon: the stall test reports the floor, finite
    got = getattr(smm, solver)(t, b, epsilon=1e-18)
    want = getattr(jsmm, solver)(j, b, epsilon=1e-18)
    assert got.status == int(want.status) == MAX
    assert np.isfinite(float(got.residual_norm2))
    with pytest.raises(ValueError):
        getattr(smm, solver)(t, b, epsilon=1e-20)
    # x0 that already solves the system: SUCCESS with no work
    x_true = np.random.default_rng(0).standard_normal(t.shape[0])
    res = getattr(smm, solver)(t, b, x0=x_true, epsilon=1e-8)
    assert res.status == SUCCESS and res.iterations == 0 and res.outer_rounds == 0
    with pytest.raises(TypeError):
        getattr(smm, solver)(t, b, preconditioner=object())
