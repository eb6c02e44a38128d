"""The multi-rank runner on the CPU: each rank's inputs against the one-card
inputs, the rules that join the ranks' readings, and whole runs of gloo
worlds of 2 and 4 ranks (``run.launch`` over ``ranks.py``, the port's
distributed CSR path) with faults planted on one rank."""

import json
import math
import time
import types
from pathlib import Path

import pytest
import torch

from solvebench import generate, reference, run
from solvebench.operators import stencil
from sparse_matrix_math_tpu_torch import CSRMatrix

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**31 + 12345


def _cfg(points=27, grid=(8, 8, 16), dtype="float64", tolerance=1e-8):
    diagonal = {7: 6.0, 27: 26.0}[points]
    return {"name": f"p{points}_tiny", "source": "test", "operator": "stencil",
            "grid": list(grid), "dtype": dtype, "tolerance": tolerance,
            "stencil": {"points": points, "diagonal": diagonal, "neighbour": -1.0}}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_ranks_pools_are_the_one_card_pool_bit_for_bit(world, dtype):
    cfg = _cfg()
    whole, norms = generate.rhs_pool(cfg, SEED, 3, 0.05, CPU, dtype)
    blocks = [generate.rhs_pool(cfg, SEED, 3, 0.05, CPU, dtype,
                                rows=run.rank_rows(cfg, world, r)) for r in range(world)]
    for k in range(3):
        joined = torch.cat([pool[k] for pool, _ in blocks])
        assert joined.dtype == dtype and torch.equal(joined, whole[k])
    assert all(rank_norms == norms for _, rank_norms in blocks)
    member = generate.rhs_order(SEED, 3)[2]
    assert torch.equal(generate.rhs(cfg, member, 0.05, CPU, dtype), whole[2])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("points, grid", [(27, (8, 8, 16)), (7, (8, 4, 8)), (27, (4, 4, 8))])
def test_csr_rows_blocks_stack_to_csr(world, points, grid):
    cfg = _cfg(points, grid)
    whole = stencil.csr(cfg, CPU, torch.float64, CSRMatrix)
    n = whole.shape[0]
    blocks = [stencil.csr_rows(cfg, *run.rank_rows(cfg, world, r), CPU, torch.float64,
                               CSRMatrix) for r in range(world)]
    assert all(b.shape == (n // world, n) for b in blocks)
    assert torch.equal(torch.cat([b.data for b in blocks]), whole.data)
    assert torch.equal(torch.cat([b.indices for b in blocks]), whole.indices)
    offsets = [0]
    for b in blocks[:-1]:
        offsets.append(offsets[-1] + b.nnz)
    indptr = torch.cat([blocks[0].indptr[:1]]
                       + [b.indptr[1:] + o for b, o in zip(blocks, offsets)])
    assert torch.equal(indptr, whole.indptr)
    row_ids = torch.cat([b.row_ids + r * (n // world) for r, b in enumerate(blocks)])
    assert torch.equal(row_ids, whole.row_ids)


def test_rank_rows_refuses_by_name(monkeypatch):
    assert run.rank_rows(_cfg(), 4, 3) == (768, 1024)
    with pytest.raises(ValueError, match="p27_tiny has 120 rows, not a multiple of 8 x 2"):
        run.rank_rows(_cfg(grid=(6, 5, 4)), 2, 0)
    rowless = types.SimpleNamespace(rows=stencil.rows)  # an operator without csr_rows
    monkeypatch.setattr(reference, "operator", lambda cfg: rowless)
    with pytest.raises(ValueError, match="'stencil' has no csr_rows"):
        run.rank_rows(_cfg(), 2, 0)


def test_a_solve_takes_the_slowest_rank_and_any_rank_that_failed():
    per_rank = [[run.Solve(0.10, 0, 30), run.Solve(0.30, 0, 31), run.Solve(0.20, 0, 30)],
                [run.Solve(0.25, 0, 30), run.Solve(0.05, 2, 31), run.Solve(0.20, 0, 30)]]
    assert run.combined_solves(per_rank) == [run.Solve(0.25, 0, 30), run.Solve(0.30, 2, 31),
                                             run.Solve(0.20, 0, 30)]
    with pytest.raises(RuntimeError, match="solves"):
        run.combined_solves([per_rank[0], per_rank[1][:2]])


def test_each_metric_reads_its_worst_rank():
    specs = [{"name": "spmv_us_per_iter", "unit": "us", "better": "lower"},
             {"name": "spmv_roofline_pct", "unit": "%", "better": "higher"},
             {"name": "sweep_us_per_iter", "unit": "us", "better": "lower"}]
    per_rank = [{"spmv_us_per_iter": {"value": 10.0, "unit": "us"},
                 "spmv_roofline_pct": {"value": 40.0, "unit": "%"},
                 "sweep_us_per_iter": {"value": 5.0, "unit": "us"}},
                {"spmv_us_per_iter": {"value": 12.0, "unit": "us"},
                 "spmv_roofline_pct": {"value": 35.0, "unit": "%"}}]
    assert run.worst_readings(per_rank, specs) == {
        "spmv_us_per_iter": {"value": 12.0, "unit": "us"},
        "spmv_roofline_pct": {"value": 35.0, "unit": "%"}}  # rank 1 read no sweeps


def test_a_ranks_roofline_divides_its_own_time_by_its_own_work():
    from solvebench import trace as tracing

    cfg = _cfg(grid=(100, 100, 100))
    trace = tracing.Trace([tracing.DeviceOp("k3", 150, 350, 110),
                           tracing.DeviceOp("sweep", 420, 700, 410)],
                          {"solve": [(0, 1000)], "spmv": [(100, 300)],
                           "precond_apply": [(400, 600)]}, [])
    readings = {}
    for share in (1, 0.25):
        r = run.Run(cfg, {"traffic": {"solve": {"preconditioner_options": {"sweeps": 4}}}},
                    share=share)
        r.solves, r.trace = [run.Solve(1.0, 0, 1)], trace
        r.spans = tracing.SpanCounts(calls={"spmv": 1, "precond_apply": 1})
        readings[share] = {name: run.read_metric(name, r)
                           for name in ("spmv_roofline_pct", "sweep_roofline_pct")}
    least = 2 * 10 ** 6 * 8 / 3.35e12  # bytes-bound at this size
    assert readings[1]["spmv_roofline_pct"] == pytest.approx(100 * least / 200e-9)
    for name, value in readings[0.25].items():
        assert value == pytest.approx(0.25 * readings[1][name], rel=1e-15), name


# -- whole runs of gloo worlds ---------------------------------------------------

CELL = "p27_tiny.dist_cg"


def _world(tmp_path, capfd, world, *extra, trace=0, seconds=0.4, per_layer=(), deadline=240):
    """One run of a tiny 27-point f64 cell on ``world`` gloo ranks: the exit
    code, standard output and error, and the seconds the launch took."""
    cfg = _cfg()
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["per_layer"] = [dict(m, workloads=[CELL]) for m in manifest["per_layer"]
                             if m["name"] in per_layer]
    workload = {"name": CELL, "config": cfg["name"], "chips": world,
                "traffic": {"layout": "parallel.gathered_layout", "call": "parallel.dist_solve",
                            "pool": 4, "perturbation": 0.05, "solve": {"solver": "cg"}}}
    path = tmp_path / "cell.json"
    path.write_text(json.dumps({"workload": workload, "config": cfg, "manifest": manifest}))
    args = ["--cell", str(path), *extra, "--workload", CELL, "--seed", str(SEED),
            "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.monotonic()
    rc = run.launch(str(BENCH / "tests" / "ranks.py"), args, world, seconds=deadline)
    captured = capfd.readouterr()
    return rc, captured.out, captured.err, time.monotonic() - t0


def _result(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("world", [2, 4])
def test_a_sound_world_is_correct(world, tmp_path, capfd):
    rc, out, err, _ = _world(tmp_path, capfd, world)
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    assert res["device"]["count"] == world
    assert set(res["metrics"]) == {"solve_ms", "solve_p90_ms", "setup_s"}
    assert 0 < res["metrics"]["setup_s"]["value"] < 200
    assert list(res)[-1] == "checks"
    assert err.rstrip().splitlines()[-1] == "[rank0]:correct: True"
    assert res["checks"]["worst_rel_residual"]["value"] <= 1e-8


def test_a_traced_world_reads_each_ranks_layers(tmp_path, capfd):
    rc, out, err, _ = _world(tmp_path, capfd, 2, trace=1,
                             per_layer=("layout_s", "iters_per_solve"))
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"layout_s", "iters_per_solve"}
    assert res["metrics"]["iters_per_solve"]["value"] > 0


def test_a_solve_lasts_as_long_as_its_slowest_rank(tmp_path, capfd):
    rc, out, err, _ = _world(tmp_path, capfd, 2, "--fault", "slow")
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert res["correct"]
    assert res["metrics"]["solve_ms"]["value"] >= 50.0  # rank 1 sleeps 50 ms a solve


def test_one_ranks_perturbed_block_is_not_correct(tmp_path, capfd):
    rc, out, err, _ = _world(tmp_path, capfd, 2, "--fault", "perturbed")
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["worst_rel_residual"]["value"] > 1e-8


def test_one_ranks_status_is_counted(tmp_path, capfd):
    rc, out, err, _ = _world(tmp_path, capfd, 4, "--fault", "status")
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] == res["checks"]["solves_not_success"]["value"]
    assert res["checks"]["worst_rel_residual"]["value"] <= 1e-8


def test_a_rank_that_raises_ends_the_run(tmp_path, capfd):
    rc, out, err, seconds = _world(tmp_path, capfd, 2, "--fault", "raises")
    assert rc != 0 and out == ""
    assert "rank 1 of 2 exited with code 1" in err
    assert "[rank1]:RuntimeError: a planted fault" in err
    assert seconds < 120  # the others were stopped, not left to time out


def test_a_rank_that_hangs_is_stopped_at_the_deadline(tmp_path, capfd):
    rc, out, err, seconds = _world(tmp_path, capfd, 2, "--fault", "hangs", deadline=30)
    assert rc == 1 and out == ""
    assert "still ran after 30 s" in err
    # the hung rank's stack, line by line under its name, shows where it waits
    assert any(line.startswith("[rank1]:") and "in faulty" in line for line in err.splitlines())
    assert seconds < 30 + 45  # torchrun's 30 s grace for a rank that ignores the signal


def test_a_rank_that_imports_jax_fails_the_run(tmp_path, capfd):
    rc, out, err, _ = _world(tmp_path, capfd, 2, "--fault", "jax")
    assert rc == 3 and out == ""
    assert "rank 1 of 2 exited with code 3" in err
    assert "[rank1]:forbidden modules loaded: jax" in err


def test_the_control_on_the_whole_system_is_not_correct(tmp_path, capfd):
    rc, out, err, _ = _world(tmp_path, capfd, 2, "--control")
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert not res["correct"]
    c = res["checks"]["worst_rel_residual"]
    assert c["value"] > c["limit"] and math.isfinite(c["value"])
