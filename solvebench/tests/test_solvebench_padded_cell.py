"""The 4-card HPCG weak-scaling cell, ``hpcg27_256x4_f64.pcg_sgs``, on the
CPU: its own workload and configuration at a 12 x 12 x 32 grid, run through
``run.launch`` over ``padded_ranks.py`` in gloo worlds of 2 and 4 ranks,
each rank laying out its own rows with ``parallel.distribute_dia_rows`` and
solving with ``parallel.dist_padded_solve``.  A sound run is correct; the
control, a state returned unchanged and every second solve skipped are not.
"""

import json

import pytest
import torch

from solvebench import run

torch.set_num_threads(1)

CELL = "hpcg27_256x4_f64.pcg_sgs"
GRID = (12, 12, 32)  # 4,608 rows: blocks of 1,152 at 4 ranks, SGS(4)'s halo 512 rows
SEED = 2**31 + 4321


def _world(tmp_path, capfd, world, *extra, trace=0, per_layer=None):
    """One run of the cell at ``GRID`` on ``world`` gloo ranks: the exit
    code, standard output and standard error.  ``per_layer`` narrows the
    manifest's per-layer metrics to those named."""
    wl, cfg = run.load_cell(CELL)
    cfg = dict(cfg, grid=list(GRID))
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    if per_layer is not None:
        manifest["per_layer"] = [m for m in manifest["per_layer"] if m["name"] in per_layer]
    path = tmp_path / "cell.json"
    path.write_text(json.dumps({"workload": wl, "config": cfg, "manifest": manifest}))
    args = ["--cell", str(path), *extra, "--workload", CELL, "--seed", str(SEED),
            "--seconds", "1.5", "--trace", str(trace)]
    rc = run.launch(str(run.BENCH / "tests" / "padded_ranks.py"), args, world, seconds=240)
    captured = capfd.readouterr()
    return rc, captured.out, captured.err


def _result(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("world", [2, 4])
def test_a_sound_run_is_correct(world, tmp_path, capfd):
    rc, out, err = _world(tmp_path, capfd, world)
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2, res["checks"]
    assert res["sampled"] == res["attempted"]  # every solution held to the reference
    assert res["device"]["count"] == world
    assert res["checks"]["worst_rel_residual"]["value"] <= 1e-8
    assert res["checks"]["solves_not_success"]["value"] == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fault", ["control", "unchanged", "half"])
def test_the_control_and_planted_faults_are_not_correct(fault, world, tmp_path, capfd):
    extra = ("--control",) if fault == "control" else ("--fault", fault)
    rc, out, err = _world(tmp_path, capfd, world, *extra)
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert res["attempted"] >= 2  # the window's second solve is the first that "half" skips
    assert not res["correct"] and res["failed"] >= 1, (fault, res["checks"])
    c = res["checks"]["worst_rel_residual"]
    assert c["value"] > c["limit"]


def test_a_traced_run_reads_the_cells_counters_and_host_spans(tmp_path, capfd):
    """The per-layer metrics that list the cell and read no device trace
    (which a CPU run has not) read a value on every rank."""
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in manifest["per_layer"]
             if CELL in m.get("workloads", [CELL]) and m["source"] != "device_trace"}
    assert {"layout_s", "iters_per_solve", "halo_mb_per_iter"} <= names
    rc, out, err = _world(tmp_path, capfd, 2, trace=1, per_layer=names)
    assert rc == 0, err[-3000:]
    res = _result(out)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == names
    assert res["metrics"]["iters_per_solve"]["value"] > 0
    assert res["metrics"]["halo_mb_per_iter"]["value"] > 0
