"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to
report a result without a GPU.  The full sizes run only on the card
(`python chip_smoke.py`)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert "{" not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip().endswith("}")


def test_phase_lone_tiny():
    out = chip_smoke.phase_lone(nass=4, reps=1)
    solver, _, _, sols = out["lu_B1"]
    assert solver.info["linear_solver"]["method"] == "lu"
    assert sols[0].status.name == "SOLVED"


def test_phase_batch_tiny():
    table = chip_smoke.phase_batch(nass=4, B=8, n_sample=2, sizes=(1, 8),
                                   reps=1)
    assert [(r["method"], r["B"]) for r in table] == [
        (m, b) for m in ("lu", "inverse", "qr") for b in (1, 8)]
    assert all(r["solved"] == r["B"] for r in table)


def test_phase_batch_tolerates_unsolved_alternative(monkeypatch):
    """Only the default method must solve every problem: a non-SOLVED
    problem under inverse/qr is reported, under lu it fails the phase."""
    import cuclarabel_tpu as cc
    from cuclarabel_tpu.parallel import BatchSolver

    real = BatchSolver.solve

    def spoiled(self, *a, **kw):
        sols = real(self, *a, **kw)
        if self.settings.kkt_solve_method == bad:
            sols[0].status = cc.SolverStatus.INSUFFICIENT_PROGRESS
        return sols

    monkeypatch.setattr(BatchSolver, "solve", spoiled)
    bad = "inverse"
    table = chip_smoke.phase_batch(nass=4, B=4, n_sample=1, sizes=(4,),
                                   reps=1)
    assert [r["solved"] for r in table] == [4, 3, 4]
    bad = "auto"  # what lu rows are built with
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.phase_batch(nass=4, B=4, n_sample=1, sizes=(4,), reps=1)


def test_phase_cones_tiny():
    chip_smoke.phase_cones(maros=False, reps=1)


def test_cone_rows_cover_every_family():
    names = [r[0] for r in chip_smoke._cone_rows(maros=True)]
    assert names[0] == "qp-golden"
    assert sum(n.startswith("mm-") for n in names) == 16
    for prefix in ("exp-", "genpow-", "pow-", "sdp-"):
        assert any(n.startswith(prefix) for n in names), prefix


def test_phase_sparse_tiny():
    chip_smoke.phase_sparse(grid_k=4, cvxqp="CVXQP1_S", batch_k=3,
                            batch_B=4, n_lone=2, reps=1)


def test_phase_four_on_virtual_devices():
    # conftest gives the CPU backend 8 virtual devices
    chip_smoke.phase_four(n_devices=4, nass=4, B=8, sharded_nass=8, reps=1)


def test_phase_failure_is_raised():
    with pytest.raises(chip_smoke.PhaseFailure, match="boom"):
        chip_smoke._require(False, "boom")


def test_count_collectives():
    hlo = ("%a = f64[4] all-reduce(%x), replica_groups={}\n"
           "%b = f64[8] all-gather(%y)\n%c = f64[4] add(%a, %a)\n"
           "%d = collective-permute(%z)")
    assert chip_smoke.count_collectives(hlo) == 3
    assert chip_smoke.count_collectives("%c = f64[4] add(%a, %b)") == 0


def test_kkt_certificate_flags_a_wrong_point():
    import cuclarabel_tpu as cc

    P, q, A, b, cones = chip_smoke.grid_qp(3, seed=1)
    sol = cc.SparseSolver(P, q, A, b, cones).solve()
    good = chip_smoke.kkt_certificate(P, q, A, b, sol, n_zero=1)
    assert max(good) < 1e-7
    sol.x = sol.x + 1e-3
    bad = chip_smoke.kkt_certificate(P, q, A, b, sol, n_zero=1)
    assert max(bad) > 1e-4


def test_relative_difference_scale():
    assert chip_smoke._rel(1.0 + 1e-7, 1.0) == pytest.approx(1e-7)
    # near-zero optimum: judged at the scale of the constant term
    assert chip_smoke._rel(1e-4, 0.0, scale=1e4) == pytest.approx(1e-8)
    assert np.isclose(chip_smoke._rel(3.0, 2.0), 0.5)
    # small optima (the portfolio's ~-0.07) are judged relatively
    assert chip_smoke._rel(-0.07 + 7e-8, -0.07) == pytest.approx(1e-6)
    # an optimum at zero: absolute difference
    assert chip_smoke._rel(2e-9, 0.0) == pytest.approx(2e-9)


@pytest.mark.gpu
def test_smoke_lone_phase_on_gpu(gpu):
    chip_smoke.phase_lone(reps=1)


@pytest.mark.parametrize("argv, count", [([], 1), (["--four"], 4)])
def test_last_line_contract(monkeypatch, capsys, argv, count):
    """With a GPU reported and every phase passing, the last stdout line
    is the JSON result with the device as JAX reports it, and the count
    of devices the phases ran on (not of the devices the host has)."""
    import jax

    class _Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return {"peak_bytes_in_use": 1}

    # a host with more cards than the phases use
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()] * 8)
    for name in ("phase_lone", "phase_batch", "phase_cones",
                 "phase_sparse", "phase_four"):
        monkeypatch.setattr(chip_smoke, name, lambda **kw: {})
    monkeypatch.setattr(chip_smoke, "_nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert chip_smoke.main(argv) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": count}}
