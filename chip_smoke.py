"""Smoke run of the solver's main paths on one NVIDIA GPU.

Drives the public solver classes once, in one process, at the sizes
their users run, and checks every result against a reference:

  1. lone   - `Solver` on the portfolio SOCP (nass=32, N_kkt=76), a
              warm re-solve after 1 % drift, and the host_solve="on"
              route; reference: the same solves on the CPU device.
  2. batch  - `BatchSolver` on 4096 portfolio scenarios, with the dense
              KKT methods lu / inverse / qr timed at B=1, 256 and 4096
              (lu, the default, must solve every problem; the others
              report their SOLVED counts); reference: CPU lone solves of
              64 sampled scenarios.
  3. cones  - the suite's rows per cone family through `Solver`
              (golden QP, 16 Maros-Meszaros members, exp-cone logistic
              regression, generalized power cones, the 3-d power-cone
              golden problem, chordal SDP); reference: the published
              or golden optimum where the row carries one, else the
              CPU f64 solve.
  4. sparse - `SparseSolver` on CVXQP1_M (published optimum) and on the
              k=100 grid QP (N_kkt=20001, checked by its KKT optimality
              certificate in NumPy f64 — the native host LDL path
              densifies the KKT system, too slow at this size);
              `BatchSparseSolver` on 64 grid QPs (k=16) against lone
              `SparseSolver` solves, and one of those against the
              native host LDL (direct_solve_method="qdldl").

With --four it runs only the multi-device paths (four GPUs):
`BatchSolver(n_devices=4)` at B=4096 against the same batch on one
device, with a count of the collectives in the compiled program, and
`ShardedSolver(n_devices=4)` on one portfolio problem of ~2,700 KKT
rows against a lone `Solver`.

Every phase prints its compile time (set-up), warm time, iterations
and status counts, residuals, the comparison with its tolerance, and
the device's peak memory.  The last line of standard output is one
JSON object; it is printed only when every phase passed.  The script
exits non-zero, printing no result, when the first JAX device is not a
GPU or any phase fails.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs, multi-device paths only
"""

import argparse
import json
import os
import re
import statistics
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Objective agreement with a CPU f64 solve or a published optimum: both
# solves stop at the 1e-8 duality-gap tolerance, and reductions run in
# a different order on the card, so objectives agree to ~1e-8 relative
# and 1e-6 leaves two orders of margin.  The denominator is the larger
# of the magnitudes of the optimum and any constant term of the
# objective.  Only where both are below NEAR_ZERO (an optimum at zero,
# such as the published 0 of HS3, HS28 and TAME) is the difference
# taken as absolute.
OBJ_RTOL = 1e-6
NEAR_ZERO = 1e-3
# Primal and dual residuals on the card: SOLVED means both are below
# the default feasibility tolerance.
RES_TOL = 1e-8
# The data-parallel mesh against one device: each problem runs the same
# arithmetic on either, so objectives agree to rounding.
MESH_RTOL = 1e-9

NASS = 32  # portfolio assets; N_kkt = 76
FOUR = 4  # devices of the --four paths


def _log(msg):
    print(msg, flush=True)


def _rel(a, b, scale=0.0):
    denom = max(abs(b), abs(scale))
    return abs(a - b) / (denom if denom >= NEAR_ZERO else 1.0)


class PhaseFailure(AssertionError):
    pass


def _require(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _warm(fn, reps):
    """Median wall seconds of `reps` calls; every solver's solve() ends
    in a host fetch of its results, so each call is complete."""
    ts = []
    out = None
    for _ in range(reps):
        out, dt = _timed(fn)
        ts.append(dt)
    return out, statistics.median(ts)


def _peak_bytes(device=None):
    import jax

    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "n/a")


def _on_cpu():
    import jax

    return jax.default_device(jax.devices("cpu")[0])


def _status_counts(sols):
    counts = {}
    for s in sols:
        counts[s.status.name] = counts.get(s.status.name, 0) + 1
    return counts


def _check_solution(tag, sol):
    import cuclarabel_tpu as cc

    _require(sol.status == cc.SolverStatus.SOLVED,
             f"{tag}: status {sol.status.name}")
    _require(sol.r_prim <= RES_TOL and sol.r_dual <= RES_TOL,
             f"{tag}: r_prim {sol.r_prim:.3e} r_dual {sol.r_dual:.3e} "
             f"> {RES_TOL:g}")


def _report(tag, compile_s, warm_s, iters, status, r_prim, r_dual,
            obj, ref, ref_name, rel, tol):
    _log(f"  {tag}: compile+first {compile_s:.2f} s, warm "
         f"{warm_s * 1e3:.3f} ms, iters {iters}, status {status}, "
         f"r_prim {r_prim:.2e}, r_dual {r_dual:.2e}, obj {obj:.10g} vs "
         f"{ref_name} {ref:.10g}: rel {rel:.2e} (tol {tol:g})")


def portfolio(nass, batch, seed=0):
    from __graft_entry__ import _portfolio_socp

    return _portfolio_socp(nass=nass, batch=batch, seed=seed)


# ----------------------------------------------------------------------
def phase_lone(nass=NASS, reps=5):
    """Lone solve, warm re-solve after 1 % drift, host_solve="on"."""
    import cuclarabel_tpu as cc

    A, qs, bs, cones = portfolio(nass, 1, seed=3)
    q, b = qs[0], bs[0]
    solver = cc.Solver(None, q, A, b, cones, host_solve="off")
    sol, t_first = _timed(solver.solve)
    sol, t_warm = _warm(solver.solve, reps)
    _check_solution("lone", sol)
    with _on_cpu():
        ref = cc.Solver(None, q, A, b, cones, host_solve="off").solve()
    rel = _rel(sol.obj_val, ref.obj_val)
    _report("lone", t_first, t_warm, sol.iterations, sol.status.name,
            sol.r_prim, sol.r_dual, sol.obj_val, ref.obj_val, "cpu_f64",
            rel, OBJ_RTOL)
    _require(rel <= OBJ_RTOL, f"lone: objective rel {rel:.2e}")
    _require(solver.info["linear_solver"]["method"] == "lu",
             "lone: auto did not resolve to lu")

    # 1 % drift of the expected returns, then a warm-started re-solve
    rng = np.random.default_rng(11)
    q2 = q.copy()
    q2[:-1] *= 1.0 + 0.01 * rng.standard_normal(nass)
    solver.update_data(q=q2)
    ws = (sol.x, sol.s, sol.z)
    wsol, t_wfirst = _timed(lambda: solver.solve(warm_start=ws))
    wsol, t_wwarm = _warm(lambda: solver.solve(warm_start=ws), reps)
    _check_solution("warm re-solve", wsol)
    with _on_cpu():
        ref2 = cc.Solver(None, q2, A, b, cones, host_solve="off").solve()
    rel2 = _rel(wsol.obj_val, ref2.obj_val)
    _report("warm re-solve", t_wfirst, t_wwarm, wsol.iterations,
            wsol.status.name, wsol.r_prim, wsol.r_dual, wsol.obj_val,
            ref2.obj_val, "cpu_f64", rel2, OBJ_RTOL)
    _require(rel2 <= OBJ_RTOL, f"warm re-solve: objective rel {rel2:.2e}")

    # host_solve="on": the same lone solve on the in-process CPU device
    hs = cc.Solver(None, q, A, b, cones, host_solve="on")
    hsol, t_hfirst = _timed(hs.solve)
    hsol, t_hwarm = _warm(hs.solve, reps)
    _check_solution("host_solve=on", hsol)
    rel3 = _rel(hsol.obj_val, ref.obj_val)
    _report("host_solve=on", t_hfirst, t_hwarm, hsol.iterations,
            hsol.status.name, hsol.r_prim, hsol.r_dual, hsol.obj_val,
            ref.obj_val, "cpu_f64", rel3, OBJ_RTOL)
    _require(rel3 <= OBJ_RTOL, f"host_solve=on: objective rel {rel3:.2e}")
    return {"lu_B1": (solver, t_first, t_warm, [sol])}


def phase_batch(nass=NASS, B=4096, n_sample=64, sizes=(1, 256, 4096),
                reps=5, lone=None):
    """BatchSolver at width B against CPU lone solves, plus the table of
    dense KKT methods at each width in `sizes`."""
    import cuclarabel_tpu as cc
    from cuclarabel_tpu.parallel import BatchSolver

    A, qs, bs, cones = portfolio(nass, max(B, *sizes), seed=7)
    batch = BatchSolver(None, qs[:B], A, bs[:B], cones)
    sols, t_first = _timed(batch.solve)
    sols, t_warm = _warm(batch.solve, reps)
    counts = _status_counts(sols)
    _require(counts == {"SOLVED": B}, f"batch: statuses {counts}")
    for i, s in enumerate(sols):
        _check_solution(f"batch[{i}]", s)
    idx = np.random.default_rng(5).choice(B, size=min(n_sample, B),
                                          replace=False)
    worst = 0.0
    with _on_cpu():
        for i in idx:
            ref = cc.Solver(None, qs[i], A, bs[i], cones,
                            host_solve="off").solve()
            worst = max(worst, _rel(sols[i].obj_val, ref.obj_val))
    iters = [s.iterations for s in sols]
    _log(f"  batch B={B}: compile+first {t_first:.2f} s, warm "
         f"{t_warm * 1e3:.3f} ms ({B / t_warm:.1f} problems/s), iters "
         f"mean {np.mean(iters):.2f} max {max(iters)}, status {counts}, "
         f"max r_prim {max(s.r_prim for s in sols):.2e}, max r_dual "
         f"{max(s.r_dual for s in sols):.2e}, {len(idx)} sampled objs vs "
         f"cpu_f64: max rel {worst:.2e} (tol {OBJ_RTOL:g})")
    _require(worst <= OBJ_RTOL, f"batch: objective rel {worst:.2e}")

    known = dict(lone or {})
    if B in sizes:
        known[f"lu_B{B}"] = (batch, t_first, t_warm, sols)
    _log("  dense KKT methods (portfolio, N_kkt="
         f"{A.shape[0] + A.shape[1]}; warm median of {reps}):")
    table = []
    for method in ("lu", "inverse", "qr"):
        for width in sizes:
            key = f"{method}_B{width}"
            if key in known:
                solver, tf, tw, ss = known[key]
            else:
                # "lu" is what kkt_solve_method="auto" resolves to
                kw = {} if method == "lu" else {"kkt_solve_method": method}
                if width == 1:
                    solver = cc.Solver(None, qs[0], A, bs[0], cones,
                                       host_solve="off", **kw)
                    ss, tf = _timed(lambda: [solver.solve()])
                    ss, tw = _warm(lambda: [solver.solve()], reps)
                else:
                    solver = BatchSolver(None, qs[:width], A, bs[:width],
                                         cones, **kw)
                    ss, tf = _timed(solver.solve)
                    ss, tw = _warm(solver.solve, reps)
            c = _status_counts(ss)
            it = [s.iterations for s in ss]
            row = {"method": method, "B": width, "compile_s": tf,
                   "warm_ms": tw * 1e3, "problems_per_s": width / tw,
                   "iters_mean": float(np.mean(it)),
                   "iters_max": int(max(it)),
                   "solved": c.get("SOLVED", 0)}
            table.append(row)
            _log(f"    {method:<8s} B={width:<5d} warm {tw * 1e3:10.3f} ms "
                 f"{width / tw:12.1f} problems/s  iters mean "
                 f"{row['iters_mean']:.2f} max {row['iters_max']}  "
                 f"SOLVED {row['solved']}/{width}  (compile+first "
                 f"{tf:.2f} s)")
            # the table measures the alternatives; only the default
            # ("auto" -> lu) must solve every problem, the others report
            # their SOLVED count as part of the comparison
            if method == "lu":
                _require(row["solved"] == width,
                         f"{method} B={width}: statuses {c}")
            elif row["solved"] != width:
                _log(f"    {method} B={width}: not every problem SOLVED: {c}")
    return table


def _cone_rows(maros=True):
    """(name, P, q, A, b, cones, Solver kwargs, optimum, constant) for
    each cone-family row; optimum None means "compare with the CPU f64
    solve"."""
    import cuclarabel_tpu as cc
    from benchmarks import maros as mm
    from benchmarks import suite

    def row(p):
        return (p.name, p.P, p.q, p.A, p.b, p.cones, p.kw, p.expect_obj,
                0.0)

    rows = [row(suite.qp_golden())]
    if maros:
        for make in mm.PROBLEMS:
            p = make()
            rows.append((f"mm-{p.name}", p.P, p.q, p.A, p.b, p.cones, {},
                         p.obj_golden - p.obj_const, p.obj_const))
    rows.append(row(suite.exp_logistic(4, 10, 5)))
    rows.append(row(suite.genpow_family(8, 9)))
    # the 3-d power-cone golden problem (tests/test_basic_pow.py); its
    # golden value has 4 digits, so the CPU f64 solve is the reference
    q = np.zeros(6)
    q[2] = q[5] = -1.0
    A = -np.vstack([np.eye(6), [[1.0, 2.0, 0.0, 3.0, 0.0, 0.0]],
                    [[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]]])
    b = np.concatenate([np.zeros(6), [-3.0], [-1.0]])
    rows.append(("pow-golden", None, q, A, b,
                 [cc.PowerConeT(0.6), cc.PowerConeT(0.1), cc.ZeroConeT(1),
                  cc.ZeroConeT(1)], {}, None, 0.0))
    rows.append(row(suite.sdp_chordal_banded(12, 2, 6)))
    return rows


def phase_cones(maros=True, reps=3):
    """One row per cone family through Solver on the default device."""
    import cuclarabel_tpu as cc

    for name, P, q, A, b, cones, kw, optimum, const in _cone_rows(maros):
        solver = cc.Solver(P, q, A, b, cones, **kw)
        sol, t_first = _timed(solver.solve)
        sol, t_warm = _warm(solver.solve, reps)
        _check_solution(name, sol)
        if optimum is None:
            with _on_cpu():
                ref = cc.Solver(P, q, A, b, cones, **kw).solve().obj_val
            ref_name = "cpu_f64"
        else:
            ref, ref_name = optimum, "published"
        rel = _rel(sol.obj_val + const, ref + const, const)
        _report(name, t_first, t_warm, sol.iterations, sol.status.name,
                sol.r_prim, sol.r_dual, sol.obj_val + const, ref + const,
                ref_name, rel, OBJ_RTOL)
        _require(rel <= OBJ_RTOL, f"{name}: objective rel {rel:.2e}")


def grid_qp(k, seed):
    """The suite's grid-Laplacian sparse QP (N_kkt = 2k^2 + 1)."""
    from benchmarks import suite

    p = suite.sparse_grid_qp(k, seed)
    return p.P, p.q, p.A, p.b, p.cones


def kkt_certificate(P, q, A, b, sol, n_zero):
    """Optimality certificate of a QP solution in NumPy f64: relative
    primal and dual residuals, cone membership of s and z (zero cone
    first, then nonnegative), and the relative duality gap."""
    x, s, z = sol.x, sol.s, sol.z
    rp = np.abs(A @ x + s - b).max() / max(1.0, np.abs(b).max())
    rd = np.abs(P @ x + q + A.T @ z).max() / max(1.0, np.abs(q).max())
    cone = max(np.abs(s[:n_zero]).max(initial=0.0),
               -min(0.0, s[n_zero:].min()), -min(0.0, z[n_zero:].min()))
    primal = 0.5 * x @ (P @ x) + q @ x
    dual = -0.5 * x @ (P @ x) - b @ z
    gap = abs(primal - dual) / max(1.0, abs(primal))
    return rp, rd, cone, gap


def phase_sparse(grid_k=100, cvxqp="CVXQP1_M", batch_k=16, batch_B=64,
                 n_lone=8, reps=3):
    """SparseSolver on a published MM member and a large grid QP;
    BatchSparseSolver against lone SparseSolver solves."""
    import cuclarabel_tpu as cc
    from benchmarks.cvxqp import PUBLISHED, cvxqp_qps
    from cuclarabel_tpu.parallel import BatchSparseSolver
    from cuclarabel_tpu.qps import qps_objective, to_clarabel
    from cuclarabel_tpu.sparse_solver import SparseSolver

    # CVXQP through the QPS pipeline, against its published optimum
    p = cvxqp_qps(cvxqp)
    P, q, A, b, cones, sgn_c0 = to_clarabel(p)
    solver = SparseSolver(P, q, A, b, cones)
    sol, t_first = _timed(solver.solve)
    sol, t_warm = _warm(solver.solve, reps)
    _check_solution(cvxqp, sol)
    obj = qps_objective(sgn_c0, sol.obj_val)
    rel = _rel(obj, PUBLISHED[cvxqp])
    _report(cvxqp, t_first, t_warm, sol.iterations, sol.status.name,
            sol.r_prim, sol.r_dual, obj, PUBLISHED[cvxqp], "published",
            rel, OBJ_RTOL)
    _require(rel <= OBJ_RTOL, f"{cvxqp}: objective rel {rel:.2e}")

    # the k x k grid QP: checked by its own KKT certificate
    P, q, A, b, cones = grid_qp(grid_k, seed=7)
    solver = SparseSolver(P, q, A, b, cones)
    sol, t_first = _timed(solver.solve)
    sol, t_warm = _warm(solver.solve, reps)
    _check_solution(f"grid k={grid_k}", sol)
    rp, rd, cone, gap = kkt_certificate(P, q, A, b, sol, n_zero=1)
    _log(f"  grid k={grid_k} (N_kkt={A.shape[0] + A.shape[1]}): "
         f"compile+first {t_first:.2f} s, warm {t_warm * 1e3:.3f} ms, "
         f"iters {sol.iterations}, status {sol.status.name}, r_prim "
         f"{sol.r_prim:.2e}, r_dual {sol.r_dual:.2e}; numpy certificate: "
         f"primal {rp:.2e}, dual {rd:.2e}, cone {cone:.2e}, gap {gap:.2e} "
         f"(tol {OBJ_RTOL:g})")
    _require(max(rp, rd, cone, gap) <= OBJ_RTOL,
             f"grid k={grid_k}: certificate {rp, rd, cone, gap}")
    step = getattr(solver, "_solve_fn", None)
    if step is not None and hasattr(step, "lower"):
        mem = step.lower(solver._dev).compile().memory_analysis()
        _log(f"  grid k={grid_k} sparse step memory_analysis: {mem}")

    # one pattern, batch_B instances: BatchSparseSolver vs lone solves
    P, q0, A, b0, cones = grid_qp(batch_k, seed=9)
    rng = np.random.default_rng(13)
    qs = q0[None, :] * (1.0 + 0.05 * rng.standard_normal((batch_B, 1)))
    bs = np.broadcast_to(b0, (batch_B, b0.size)).copy()
    bss = BatchSparseSolver(P, qs, A, bs, cones)
    sols, t_first = _timed(bss.solve)
    sols, t_warm = _warm(bss.solve, reps)
    counts = _status_counts(sols)
    _require(counts == {"SOLVED": batch_B}, f"sparse batch: {counts}")
    for i, s in enumerate(sols):
        _check_solution(f"sparse batch[{i}]", s)
    lone = SparseSolver(P, qs[0], A, bs[0], cones)
    worst = 0.0
    for i in range(min(n_lone, batch_B)):
        lone.update_q(qs[i])
        worst = max(worst, _rel(sols[i].obj_val, lone.solve().obj_val))
    _log(f"  sparse batch B={batch_B} k={batch_k}: compile+first "
         f"{t_first:.2f} s, warm {t_warm * 1e3:.3f} ms "
         f"({batch_B / t_warm:.1f} problems/s), status {counts}, max "
         f"r_prim {max(s.r_prim for s in sols):.2e}, max r_dual "
         f"{max(s.r_dual for s in sols):.2e}, {min(n_lone, batch_B)} vs "
         f"lone SparseSolver: max rel {worst:.2e} (tol {OBJ_RTOL:g})")
    _require(worst <= OBJ_RTOL, f"sparse batch: objective rel {worst:.2e}")

    # the lone multifrontal solve against the native host LDL (qdldl,
    # run on the CPU device), whose dense-interface KKT assembly is
    # cheap at this size
    with _on_cpu():
        ref = cc.Solver(P, qs[0], A, bs[0], cones,
                        direct_solve_method="qdldl").solve()
    lone.update_q(qs[0])
    lsol = lone.solve()
    _check_solution("sparse lone", lsol)
    rel = _rel(lsol.obj_val, ref.obj_val)
    _log(f"  sparse lone k={batch_k} vs qdldl: iters {lsol.iterations} vs "
         f"{ref.iterations}, status {lsol.status.name} vs "
         f"{ref.status.name}, obj {lsol.obj_val:.10g} vs {ref.obj_val:.10g}:"
         f" rel {rel:.2e} (tol {OBJ_RTOL:g})")
    _require(rel <= OBJ_RTOL, f"sparse vs qdldl: objective rel {rel:.2e}")


def count_collectives(hlo_text):
    return len(re.findall(
        r"\b(?:all-reduce|all-gather|reduce-scatter|collective-permute|"
        r"all-to-all)\b", hlo_text))


def phase_four(n_devices=FOUR, nass=NASS, B=4096, sharded_nass=1200, reps=3):
    """The multi-device paths: the data-parallel batch mesh and the
    tensor-parallel arrow KKT."""
    import jax
    import jax.numpy as jnp

    import cuclarabel_tpu as cc
    from cuclarabel_tpu.parallel import BatchSolver, ShardedSolver

    devs = jax.devices()
    _require(len(devs) >= n_devices,
             f"four: need {n_devices} devices, have {len(devs)}")
    t_phase = time.perf_counter()

    def step(msg):
        # progress lines, so a stall shows which step it is in
        _log(f"  [{time.perf_counter() - t_phase:7.1f} s] {msg}")

    A, qs, bs, cones = portfolio(nass, B, seed=7)
    step(f"dp: BatchSolver(n_devices={n_devices}) B={B}, first solve")
    dp = BatchSolver(None, qs, A, bs, cones, n_devices=n_devices)
    sols, t_first = _timed(dp.solve)
    step("dp: warm solves")
    sols, t_warm = _warm(dp.solve, reps)
    counts = _status_counts(sols)
    _require(counts == {"SOLVED": B}, f"dp: statuses {counts}")
    step("one device: first solve")
    one = BatchSolver(None, qs, A, bs, cones, batch_compaction=0.0)
    ref, t_ref_first = _timed(one.solve)
    step("one device: warm solves")
    ref, t_ref = _warm(one.solve, reps)
    worst = max(_rel(s.obj_val, r.obj_val) for s, r in zip(sols, ref))
    step("dp: compiled HLO")
    t0 = jnp.asarray(0.0)
    hlo = dp._fn.lower(*dp._args, t0).compile().as_text()
    n_coll = count_collectives(hlo)
    out = dp._fn(*dp._args, t0)
    used = {d.id for d in out["x"].sharding.device_set}
    peaks = [_peak_bytes(d) for d in devs[:n_devices]]
    _log(f"  dp B={B} on {n_devices} devices: compile+first {t_first:.2f} s,"
         f" warm {t_warm * 1e3:.3f} ms ({B / t_warm:.1f} problems/s); one "
         f"device: compile+first {t_ref_first:.2f} s, warm "
         f"{t_ref * 1e3:.3f} ms ({B / t_ref:.1f} problems/s); status "
         f"{counts}; max rel vs one device {worst:.2e} (tol {MESH_RTOL:g});"
         f" collectives in compiled dp program: {n_coll}; output on "
         f"devices {sorted(used)}; peak bytes per device {peaks}")
    _require(worst <= MESH_RTOL, f"dp: objective rel {worst:.2e}")
    _require(n_coll == 0, f"dp: {n_coll} collectives")
    _require(len(used) == n_devices, f"dp: output on devices {used}")

    A1, q1, b1, cones1 = portfolio(sharded_nass, 1, seed=21)
    step(f"sharded: ShardedSolver(n_devices={n_devices}) N_kkt="
         f"{A1.shape[0] + A1.shape[1]}, set-up")
    sh = ShardedSolver(None, q1[0], A1, b1[0], cones1, n_devices=n_devices)
    _require(sh.tp_mode == "arrow", f"sharded: tp_mode {sh.tp_mode}")
    step("sharded: first solve")
    ssol, t_first = _timed(sh.solve)
    step("sharded: warm solves")
    ssol, t_warm = _warm(sh.solve, reps)
    _check_solution("sharded", ssol)
    step("lone Solver at the same size: first solve")
    lone = cc.Solver(None, q1[0], A1, b1[0], cones1, host_solve="off")
    lsol, t_lfirst = _timed(lone.solve)
    step("lone Solver: warm solves")
    lsol, t_lwarm = _warm(lone.solve, reps)
    rel = _rel(ssol.obj_val, lsol.obj_val)
    sh_devs = {d.id for v in jax.tree_util.tree_leaves(sh._dev)
               if hasattr(v, "sharding") for d in v.sharding.device_set}
    _report(f"sharded arrow N_kkt={A1.shape[0] + A1.shape[1]}", t_first,
            t_warm, ssol.iterations, ssol.status.name, ssol.r_prim,
            ssol.r_dual, ssol.obj_val, lsol.obj_val, "lone Solver", rel,
            OBJ_RTOL)
    _log(f"  lone Solver at the same size: compile+first {t_lfirst:.2f} s, "
         f"warm {t_lwarm * 1e3:.3f} ms; sharded data on devices "
         f"{sorted(sh_devs)}")
    _require(rel <= OBJ_RTOL, f"sharded: objective rel {rel:.2e}")
    _require(len(sh_devs) == n_devices, f"sharded: data on {sh_devs}")


# ----------------------------------------------------------------------
def _nvidia_smi():
    from cuclarabel_tpu.device import gpu_name_and_power

    return gpu_name_and_power()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device paths")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: first device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 2

    import cuclarabel_tpu  # noqa: F401  (x64, compile cache)

    _log(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    _log(f"devices: {len(jax.devices())} x {dev.device_kind}")
    _log(f"nvidia-smi name, power.limit: {_nvidia_smi()}")
    if args.four:
        phases = [("four", lambda: phase_four(n_devices=FOUR))]
    else:
        lone = {}
        phases = [
            ("lone", lambda: lone.update(phase_lone())),
            ("batch", lambda: phase_batch(lone=lone)),
            ("cones", phase_cones),
            ("sparse", phase_sparse),
        ]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        _log(f"phase {name}:")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report, keep going, fail at the end
            traceback.print_exc()
            failed.append(name)
            _log(f"phase {name}: FAILED")
        _log(f"phase {name}: {time.perf_counter() - t0:.1f} s, device peak "
             f"bytes {_peak_bytes()}")
    _log(f"total {time.perf_counter() - t_all:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    _log(f"nvidia-smi name, power.limit: {_nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        # the devices the phases ran on, not the devices the host has
        "count": FOUR if args.four else 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
