"""The distributed padded DIA path (sparse_matrix_math_tpu_torch/parallel/dist_padded.py)
on gloo CPU worlds of 2 and 4 ranks, each rank laying out only its own rows.

Every rank builds its rows of a 27-point f64 stencil with the benchmark's
``solvebench/operators/stencil.py:csr_rows`` and lays them out through
``parallel.distribute_dia_rows``; the test process holds the ranks' results
against the single-card path on the whole CSR (``try_dia_from_csr``,
``pad_dia``, the plain product, ``solve``) and against the plain
whole-system SGS of ``tests/torch_dist_reference.py``.  Products and
applies are compared bit for bit (zeros by value); CG and PCG
solves by status, iterations within 2 (the dots sum in another order),
each solution's true residual and the gathered solutions within 1e-6
relative.  A card test runs the kernels over 2 CUDA
cards and NCCL.
"""

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu_torch as smm
import torch_dist_reference as ref
from solvebench.operators import stencil
from sparse_matrix_math_tpu_torch import parallel
from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
from sparse_matrix_math_tpu_torch.ops import trisweep as T
from sparse_matrix_math_tpu_torch.parallel import dist_padded as DP
from sparse_matrix_math_tpu_torch.parallel import mesh as M

WORLDS = (2, 4)
GRID = (12, 12, 32)  # x fastest: 4,608 rows, a reach of 157, blocks of 1,152 at 4 ranks
SWEEPS = 4
SOLVES = [("cg", None), ("cg", "sgs")]


def _cfg(grid):
    return {"grid": list(grid), "stencil": {"points": 27, "diagonal": 26.0, "neighbour": -1.0}}


def _vector(n: int, seed: int, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=gen, dtype=torch.float64).to(device)


def _rhs(cfg, device="cpu"):
    n = stencil.rows(cfg)
    return stencil.apply(cfg, 1.0 + 0.05 * _vector(n, 11, device))


def _options(pre):
    return {} if pre is None else {"preconditioner": pre,
                                   "preconditioner_options": {"sweeps": SWEEPS}}


def _own_rows(mesh, cfg, device):
    n = stencil.rows(cfg)
    lo, hi = mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size
    return lo, hi, stencil.csr_rows(cfg, lo, hi, device, torch.float64, smm.CSRMatrix)


def _guards_zero(v, lay):
    lead, m = lay.lead, lay.pdia.shape[0]
    return bool((v[:lead] == 0).all() and (v[lead + m:] == 0).all())


def _rank_case(mesh, grid):
    """One rank's readings (arrays as NumPy, which pass between processes
    by value): its layout, product, apply and solves, the halo bytes of a
    product and an apply, and a profiled solve's spans."""
    cfg = _cfg(grid)
    n = stencil.rows(cfg)
    lo, hi, local = _own_rows(mesh, cfg, torch.device("cpu"))
    op = parallel.distribute_dia_rows(local, mesh)
    out = {"lo": lo, "hi": hi, "offsets": op.offsets, "diags": op.diags.numpy(),
           "reach": op.reach}

    sent = M.collectives["halo_bytes"]
    out["product"] = parallel.dist_padded_spmv(op, _vector(n, 7)[lo:hi]).numpy()
    out["product_bytes"] = M.collectives["halo_bytes"] - sent

    lay = DP._layout(op, SWEEPS)
    out["own_diags_p"] = lay.pdia.diags_p[:, lay.lead:lay.lead + hi - lo].numpy()
    rp = lay.pdia.to_padded(_vector(n, 9)[lo:hi])
    sent = M.collectives["halo_bytes"]
    z = DP._sgs_apply(lay, mesh)(rp)
    out["apply_bytes"] = M.collectives["halo_bytes"] - sent
    out["depth"] = lay.depth
    out["apply"] = lay.pdia.from_padded(z).numpy()
    out["guards_zero"] = _guards_zero(z, lay) and _guards_zero(rp, lay)
    out["scalar"] = _window_case(op, lay, mesh, rp)

    b = _rhs(cfg)
    eps = 1e-8 * float(torch.linalg.vector_norm(b))
    for method, pre in SOLVES:
        res = parallel.dist_padded_solve(op, b[lo:hi], epsilon=eps, method=method,
                                         **_options(pre))
        out[method, pre] = (res.status, res.iterations, res.x.numpy())

    wire, reduces = M.collectives["halo_wire"], M.collectives["all_reduce"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = parallel.dist_padded_solve(op, b[lo:hi], epsilon=eps, method="cg",
                                         **_options("sgs"))
    names = [e.name for e in prof.events()]
    out["spans"] = {"halo": names.count("smm.halo"), "allreduce": names.count("smm.allreduce"),
                    "spmv": names.count("smm.spmv"),
                    "precond_apply": names.count("smm.precond_apply"),
                    "wire": M.collectives["halo_wire"] - wire,
                    "all_reduce": M.collectives["all_reduce"] - reduces,
                    "iterations": res.iterations}
    return out


def _bits(t):
    return t.view(torch.int64)


def _window_case(op, lay, mesh, rp):
    """Whether the window's SGS holds the stencil as scalars, at which global
    row, its laid-out factors the stored rows and the scalar variant's replay
    the plain apply, bit for bit."""
    psgs, main = lay.psgs, op.offsets.index(0)
    if not T._is_scalar(psgs):
        return {"engaged": False}
    window = slice(psgs.lead, psgs.lead + psgs.shape[0])
    DP._fill_halo(rp, lay, mesh, lay.depth)
    stored = all(torch.equal(_bits(p.diags_p[:, window]), _bits(lay.pdia.diags_p[part, window]))
                 for p, part in ((psgs.p_lower, slice(0, main)),
                                 (psgs.p_upper, slice(main + 1, None))))
    replay = torch.equal(_bits(T.sgs_apply_scalar_plain(psgs, rp)),
                         _bits(T.sgs_apply_plain(psgs, rp)))
    DP._clear_halo(rp, lay, mesh, lay.depth)
    return {"engaged": True, "row0": psgs.p_lower.row0, "stored": stored, "replay": replay}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return {k: parallel.spawn_cpu_world(_rank_case, k, GRID,
                                        store_dir=str(tmp_path_factory.mktemp(f"world{k}")))
            for k in WORLDS}


@pytest.fixture(scope="module")
def single():
    """The single-card path on the whole CSR."""
    cfg = _cfg(GRID)
    csr = stencil.csr(cfg, torch.device("cpu"), torch.float64, smm.CSRMatrix)
    dia = smm.try_dia_from_csr(csr)
    return cfg, csr, dia, K.pad_dia(dia)


@pytest.mark.parametrize("k", WORLDS)
def test_layout_matches_one_card(world, single, k):
    _, _, dia, pdia = single
    for r in world[k]:
        assert r["offsets"] == dia.offsets
        own = pdia.diags_p[:, pdia.lead + r["lo"]:pdia.lead + r["hi"]]
        assert torch.equal(torch.from_numpy(r["diags"]), own)
        assert torch.equal(torch.from_numpy(r["own_diags_p"]), own)


@pytest.mark.parametrize("k", WORLDS)
def test_product_matches_one_card(world, single, k):
    cfg, _, dia, pdia = single
    xp = pdia.to_padded(_vector(stencil.rows(cfg), 7))
    want = pdia.from_padded(K.dia_spmv_padded_plain(pdia.diags_p, pdia.offsets, pdia.lead,
                                                    dia.shape[0], xp))
    got = torch.cat([torch.from_numpy(r["product"]) for r in world[k]])
    assert torch.equal(got, want)  # bit for bit: the same sums in the same order


@pytest.mark.parametrize("k", WORLDS)
def test_sgs_apply_matches_reference(world, single, k):
    cfg, csr, _, _ = single
    want = ref.sgs_apply(csr.indptr, csr.indices, csr.data, _vector(stencil.rows(cfg), 9),
                         SWEEPS)
    got = torch.cat([torch.from_numpy(r["apply"]) for r in world[k]])
    # value for value: the reference sums in the kernels' order and scales by
    # 1 / d as they do; only the sign of a zero may differ
    assert torch.equal(got, want)
    assert all(r["guards_zero"] for r in world[k])


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("method,pre", SOLVES, ids=["cg", "pcg_sgs"])
def test_solve_matches_one_card(world, single, k, method, pre):
    cfg, csr, dia, _ = single
    b = _rhs(cfg)
    eps = 1e-8 * float(torch.linalg.vector_norm(b))
    one = smm.solve(dia, b, epsilon=eps, method=method, **_options(pre))
    outs = [r[method, pre] for r in world[k]]
    assert len({(s, i) for s, i, _ in outs}) == 1  # every rank read the same
    status, iterations, _ = outs[0]
    assert status == one.status == 0
    assert abs(iterations - one.iterations) <= 2
    x = torch.cat([torch.from_numpy(x) for _, _, x in outs])
    for sol in (x, one.x):
        assert float(torch.linalg.vector_norm(b - stencil.apply(cfg, sol))) <= eps
    assert float(torch.linalg.vector_norm(x - one.x) / torch.linalg.vector_norm(one.x)) <= 1e-6


@pytest.mark.parametrize("k", WORLDS)
def test_windows_hold_the_stencil_as_scalars(world, k):
    """Each rank's SGS window, starting ``depth`` rows before its own rows (no
    whole number of planes), is found to hold the constant-coefficient
    stencil at its row phase."""
    for rank, r in enumerate(world[k]):
        s = r["scalar"]
        assert s["engaged"] and s["stored"] and s["replay"]
        assert s["row0"] == r["lo"] - (r["depth"] if rank > 0 else 0)


@pytest.mark.parametrize("k", WORLDS)
def test_halo_volume(world, k):
    for rank, r in enumerate(world[k]):
        sides = (rank > 0) + (rank < k - 1)
        assert r["product_bytes"] == sides * r["reach"] * 8
        assert r["apply_bytes"] == sides * r["depth"] * 8
        assert r["depth"] == -(-(SWEEPS - 1) * r["reach"] // 128) * 128
        assert r["depth"] < r["hi"] - r["lo"]  # never a whole block
    inner = [r for rank, r in enumerate(world[k]) if 0 < rank < k - 1]
    assert all(r["product_bytes"] == 2 * r["reach"] * 8 for r in inner)


@pytest.mark.parametrize("k", WORLDS)
def test_spans(world, k):
    for r in world[k]:
        s = r["spans"]
        # one smm.halo a wire exchange, one smm.allreduce a dot
        assert s["halo"] == s["wire"] == s["spmv"] + s["precond_apply"] > 0
        assert s["allreduce"] == s["all_reduce"] >= 3 * s["iterations"]


# -- on two cards -------------------------------------------------------------------------


def _card_rank(rank, k, store, results, grid):
    try:
        torch.cuda.set_device(rank)
        mesh = parallel.init_distributed(f"file://{store}", k, rank, device=f"cuda:{rank}")
        results.put((rank, True, _card_case(mesh, grid)))
    except Exception:  # reported to the test process, which fails on it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _card_case(mesh, grid):
    """K3 and K4 on the shard against their plain versions, bit for bit,
    and a PCG + SGS(4) solve that launches them alone."""
    dev = mesh.device
    cfg = _cfg(grid)
    n = stencil.rows(cfg)
    lo, hi, local = _own_rows(mesh, cfg, dev)
    op = parallel.distribute_dia_rows(local, mesh)
    del local
    out = {}
    lay = DP._layout(op, SWEEPS)
    xp = lay.pdia.to_padded(_vector(n, 7, dev)[lo:hi])
    DP._fill_halo(xp, lay, mesh, op.reach)
    k3 = K.launches["dia_spmv_padded"]
    y = K.dia_spmv_padded(lay.pdia, xp)
    out["k3"] = K.launches["dia_spmv_padded"] - k3
    out["k3_equal"] = torch.equal(y, K.dia_spmv_padded_plain(
        lay.pdia.diags_p, lay.pdia.offsets, lay.lead, hi - lo, xp))
    rp = lay.pdia.to_padded(_vector(n, 9, dev)[lo:hi])
    DP._fill_halo(rp, lay, mesh, lay.depth)
    k4 = T.launches["sgs_apply"]
    out["variant"] = T.variant(lay.psgs, dev)
    z = T.sgs_apply_fused(lay.psgs, rp)
    out["k4"] = T.launches["sgs_apply"] - k4
    out["k4_equal"] = torch.equal(z, T.sgs_apply_plain(lay.psgs, rp))

    b = _rhs(cfg, dev)
    eps = 1e-8 * float(torch.linalg.vector_norm(b))
    k3, k4 = K.launches["dia_spmv_padded"], T.launches["sgs_apply"]
    scalar = T.variant_launches["scalar"]
    res = parallel.dist_padded_solve(op, b[lo:hi].clone(), epsilon=eps, method="cg",
                                     **_options("sgs"))
    out["solve"] = (res.status, res.iterations, K.launches["dia_spmv_padded"] - k3,
                    T.launches["sgs_apply"] - k4)
    out["scalar_applies"] = T.variant_launches["scalar"] - scalar
    x = M.all_gather(res.x, mesh)
    out["residual"] = float(torch.linalg.vector_norm(b - stencil.apply(cfg, x))) / eps
    return out


@pytest.mark.cuda
def test_shard_kernels_on_two_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: K3 and K4 over NCCL halos run only there")
    ctx = multiprocessing.get_context("spawn")
    results, k = ctx.Queue(), 2
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "store")
    procs = [ctx.Process(target=_card_rank, args=(r, k, store, results, (64, 64, 128)))
             for r in range(k)]
    for p in procs:
        p.start()
    outs, deadline = {}, time.monotonic() + M.JOIN_TIMEOUT
    try:
        while len(outs) < k:
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 1.0))
            except queue.Empty:
                pytest.fail(f"{k} card ranks did not finish in {M.JOIN_TIMEOUT} s")
            assert ok, f"rank {rank} failed:\n{value}"
            outs[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r in outs.values():
        assert r["k3"] == 1 and r["k3_equal"]
        assert r["k4"] == 1 and r["k4_equal"] and r["variant"] == "scalar"
        status, iterations, k3, k4 = r["solve"]
        assert status == 0 and iterations > 0
        assert k3 >= iterations and k4 >= iterations  # every product and apply a kernel
        assert r["scalar_applies"] == k4
        assert r["residual"] <= 1.0
