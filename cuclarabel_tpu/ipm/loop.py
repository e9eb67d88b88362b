"""The IPM main loop as a single jitted `lax.while_loop`.

Functional re-design of the reference solve! loop (`src/solver.jl:189-380`)
with the homogeneous embedding that keeps the quadratic objective:

  * all solver state (x, s, z, tau, kappa, info scalars, strategy flags)
    is one flat pytree carried through the loop;
  * the three strategy checkpoints (insufficient progress / numerical
    error / small step, solver.jl:453-514) become branchless flag
    arithmetic: a "continue-with-Dual-scaling" retry is a loop pass that
    commits no step;
  * termination conditions (info.jl:65-120,230-331) are evaluated
    on-device each pass; the loop exits when a final status is set.

The dense KKT factorize/solve and all cone kernels are closed over and
fuse into one XLA computation; the whole solve is a single device
program with no host round-trips.
"""

import math
import time as _time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..cones import ops as cone_ops
from ..cones.layout import ConeLayout
from ..kkt.dense import make_dense_kkt
from ..statuscodes import SolverStatus as S

F64EPS = float(np.finfo(np.float64).eps)
FMAX = float(np.finfo(np.float64).max)

# scaling strategy flags (PrimalDual first, like the reference)
PRIMAL_DUAL = 0
DUAL_ONLY = 1

INFO_KEYS = (
    "cost_primal",
    "cost_dual",
    "res_primal",
    "res_dual",
    "res_primal_inf",
    "res_dual_inf",
    "gap_abs",
    "gap_rel",
    "ktratio",
    "dot_bz",
    "dot_qx",
)


def _norm_scaled(w, v):
    """Overflow-safe 2-norm of the elementwise product w .* v
    (mathutils.jl:58-82).  LAPACK-style scale/sum-of-squares, vectorized:
    factor out the inf-norm before squaring so products near 1e±154
    (squares overflow/underflow f64) still norm correctly — certificates
    with extreme scalings live there."""
    p = w * v
    if p.size == 0:  # fully presolved / unconstrained blocks
        return jnp.asarray(0.0)
    scale = jnp.max(jnp.abs(p))
    safe = jnp.where((scale > 0) & jnp.isfinite(scale), scale, 1.0)
    return scale * jnp.linalg.norm(p / safe)


def make_solve_fn(layout: ConeLayout, settings, n: int, m: int, has_P: bool,
                  factor_dtype, raw: bool = False, mesh=None,
                  mesh_axis: str = "row", sparse=None, warm: bool = False,
                  parts: bool = False, stream: bool = False):
    """Builds the jitted solve function for this (layout, settings,
    dims) signature.  The returned fn maps a dict of device arrays
    {P, q, A, b, d, dinv, e, einv, cscale, normq, normb} to the solution
    pytree.  With raw=True returns the traceable (unjitted) function for
    composition under vmap/shard_map (parallel/batch.py).  With a mesh,
    the KKT backend partitions over `mesh_axis` via the block-arrow
    Schur backend (kkt/arrow.py) when direct_solve_method is
    auto/arrow.  With parts=True returns `build(dev) -> (state0,
    loop_cond, loop_body, post)` — the pieces of the IPM loop — so a
    caller can drive the `lax.while_loop` itself (the batch-compaction
    path in parallel/batch.py exits on a batch quorum and resumes
    stragglers from mid-loop state in a narrower program)."""

    sym = layout.is_symmetric
    deg1 = layout.degree + 1
    if sparse is not None:
        # device sparse multifrontal backend (kkt/sparse_kkt.py);
        # problem data stays as nz values end-to-end
        from ..kkt.sparse_kkt import make_sparse_kkt

        factorize, kkt_solve, sparse_bufs = make_sparse_kkt(
            n, m, settings, layout, sparse
        )
        _pf_size = sparse_bufs["pf_rows"].shape[0]
        _hs_plan = cone_ops.sparse_hs_plan(layout)
    elif settings.direct_solve_method == "qdldl":
        # native C++ sparse LDL^T, host-side via pure_callback (CPU path;
        # mirrors the reference's pluggable L1 backend registry,
        # directldl_defaults.jl:1-73)
        from ..kkt.sparse_cpu import make_sparse_cpu_kkt

        factorize, kkt_solve = make_sparse_cpu_kkt(n, m, settings, layout)
    elif mesh is not None and settings.direct_solve_method in ("auto", "arrow"):
        from ..kkt.arrow import make_arrow_kkt

        factorize, kkt_solve = make_arrow_kkt(
            n, m, settings, layout, mesh, mesh_axis
        )
    elif settings.direct_solve_method == "arrow":
        raise ValueError("direct_solve_method='arrow' needs a device mesh "
                         "(use ShardedSolver)")
    else:
        factorize, kkt_solve = make_dense_kkt(n, m, settings, factor_dtype, layout)

    # backends taking the structured (diag, blk, socx, gpx) Hs tuple
    # (kkt/arrow.py) instead of the materialized dense (m, m) Hs
    structured_hs = getattr(factorize, "structured_hs", False)
    if structured_hs:
        _hs_plan = cone_ops.sparse_hs_plan(layout)

    def _hs_for_backend(scal):
        if structured_hs:
            return cone_ops.sparse_hs_values(layout, scal, _hs_plan)
        return cone_ops.assemble_Hs_dense(layout, scal)

    allows_pd = layout.allows_primal_dual_scaling
    init_scaling = PRIMAL_DUAL if allows_pd else DUAL_ONLY

    st = settings  # brevity

    # multi-RHS ("pair") solves: None = auto — off on dense backends
    # (the round-2/3 interleaved A/Bs measured no-pair faster there),
    # ON for the sparse multifrontal whose latency-bound level walk is
    # paid once for both RHS columns (see kkt_pair_solve in settings.py)
    _pair_on = (
        st.kkt_pair_solve
        if st.kkt_pair_solve is not None
        else sparse is not None
    )
    kkt_solve_pair = getattr(kkt_solve, "pair", None) if _pair_on else None
    # the LP init's two solves are one-off and independent: where the
    # backend offers a 2-RHS solve, one launch shares the substitution
    # chain's latency instead of paying it twice
    _init_pair = getattr(kkt_solve, "pair", None)

    # ------------------------------------------------------------------
    def build(dev: Dict[str, jnp.ndarray]):
        q, b = dev["q"], dev["b"]
        d, dinv = dev["d"], dev["dinv"]
        e, einv = dev["e"], dev["einv"]
        cinv = 1.0 / dev["cscale"]
        normq, normb = dev["normq"], dev["normb"]

        if sparse is None:
            P, A = dev["P"], dev["A"]
            # Small dense products as broadcast multiply + reduce
            # instead of f64 dot_general: this form was chosen for a
            # device that emulates f64 matmuls.  Whether it still pays
            # on a device with native f64 is open (ROADMAP A5).  Large
            # problems keep the dot form.
            if n + m <= 256:
                Amv = lambda v: (A * v[None, :]).sum(-1)
                ATmv = lambda v: (A * v[:, None]).sum(0)
            else:
                Amv = lambda v: A @ v
                ATmv = lambda v: A.T @ v
            if not has_P:
                # P is exactly zero for LP/SOCP-form problems: skip the
                # products entirely
                Pmv = lambda v: jnp.zeros_like(v)
            elif n + m <= 256:
                Pmv = lambda v: (P * v[None, :]).sum(-1)
            else:
                Pmv = lambda v: P @ v
        else:
            Pv, Av = dev["Pv"], dev["Av"]
            spb = dev["spbufs"]

            def Pmv(v):
                if _pf_size == 0:
                    return jnp.zeros(n)
                return jax.ops.segment_sum(
                    Pv[spb["pf_src"]] * v[spb["pf_cols"]],
                    spb["pf_rows"], num_segments=n,
                )

            def Amv(v):
                return jax.ops.segment_sum(
                    Av * v[spb["a_cols"]], spb["a_rows"], num_segments=m
                )

            def ATmv(v):
                return jax.ops.segment_sum(
                    Av * v[spb["a_rows"]], spb["a_cols"], num_segments=n
                )

        # vector-vector dots in the same multiply + reduce form
        def vdot(u, v):
            return (u * v).sum(-1)

        if has_P:
            def quad(u, v):
                return vdot(u, Pmv(v))
        else:
            def quad(u, v):
                return jnp.zeros((), u.dtype)

        # -------------------- residuals (residuals.jl:1-37)
        def residuals(v):
            x, s_, z_, tau = v["x"], v["s"], v["z"], v["tau"]
            Px = Pmv(x)
            qx = vdot(q, x)
            bz = vdot(b, z_)
            sz = vdot(s_, z_)
            xPx = vdot(x, Px)
            rx_inf = -ATmv(z_)
            rz_inf = Amv(x) + s_
            return {
                "rx": rx_inf - Px - q * tau,
                "rz": rz_inf - b * tau,
                "rtau": qx + bz + v["kappa"] + xPx / tau,
                "rx_inf": rx_inf,
                "rz_inf": rz_inf,
                "Px": Px,
                "qx": qx,
                "bz": bz,
                "sz": sz,
                "xPx": xPx,
            }

        # -------------------- info scalars (info.jl:1-63)
        def info_update(r, v):
            tinv = 1.0 / v["tau"]
            xPx_half = r["xPx"] * tinv * tinv / 2.0
            cost_primal = (r["qx"] * tinv + xPx_half) * cinv
            cost_dual = (-r["bz"] * tinv - xPx_half) * cinv

            normx = _norm_scaled(d, v["x"])
            normz = _norm_scaled(e, v["z"]) * cinv
            norms = _norm_scaled(einv, v["s"])

            res_primal_inf = (_norm_scaled(dinv, r["rx_inf"]) * cinv) / jnp.maximum(
                1.0, normz
            )
            res_dual_inf = jnp.maximum(
                _norm_scaled(dinv, r["Px"]) / jnp.maximum(1.0, normx),
                _norm_scaled(einv, r["rz_inf"]) / jnp.maximum(1.0, normx + norms),
            )

            normx = normx * tinv
            normz = normz * tinv
            norms = norms * tinv

            res_primal = (
                _norm_scaled(einv, r["rz"]) * tinv
                / jnp.maximum(1.0, normb + normx + norms)
            )
            res_dual = (
                _norm_scaled(dinv, r["rx"]) * tinv * cinv
                / jnp.maximum(1.0, normq + normx + normz)
            )

            gap_abs = jnp.abs(cost_primal - cost_dual)
            gap_rel = gap_abs / jnp.maximum(
                1.0, jnp.minimum(jnp.abs(cost_primal), jnp.abs(cost_dual))
            )
            return {
                "cost_primal": cost_primal,
                "cost_dual": cost_dual,
                "res_primal": res_primal,
                "res_dual": res_dual,
                "res_primal_inf": res_primal_inf,
                "res_dual_inf": res_dual_inf,
                "gap_abs": gap_abs,
                "gap_rel": gap_rel,
                "ktratio": v["kappa"] * tinv,
                "dot_bz": r["bz"],
                "dot_qx": r["qx"],
            }

        # -------------------- convergence predicate (info.jl:274-331)
        def check_convergence(info, tol_gap_abs, tol_gap_rel, tol_feas,
                              tol_infeas_abs, tol_infeas_rel, tol_ktratio,
                              solved_code, pinf_code, dinf_code):
            solved = (
                (info["ktratio"] <= 1.0)
                & ((info["gap_abs"] < tol_gap_abs) | (info["gap_rel"] < tol_gap_rel))
                & (info["res_primal"] < tol_feas)
                & (info["res_dual"] < tol_feas)
            )
            kt_huge = info["ktratio"] > 1000.0 / tol_ktratio
            pinf = (
                kt_huge
                & (info["dot_bz"] < -tol_infeas_abs)
                & (info["res_primal_inf"] < -tol_infeas_rel * info["dot_bz"])
            )
            dinf = (
                kt_huge
                & ~pinf
                & (info["dot_qx"] < -tol_infeas_abs)
                & (info["res_dual_inf"] < -tol_infeas_rel * info["dot_qx"])
            )
            return jnp.where(
                solved,
                solved_code,
                jnp.where(pinf, pinf_code, jnp.where(dinf, dinf_code, int(S.UNSOLVED))),
            ).astype(jnp.int32)

        # -------------------- termination (info.jl:65-120)
        def check_termination(info, prev_info, it, elapsed):
            status = check_convergence(
                info,
                st.tol_gap_abs, st.tol_gap_rel, st.tol_feas,
                st.tol_infeas_abs, st.tol_infeas_rel, st.tol_ktratio,
                int(S.SOLVED), int(S.PRIMAL_INFEASIBLE), int(S.DUAL_INFEASIBLE),
            )
            # poor progress detectors
            backwards = (it > 1) & (
                (info["res_dual"] > prev_info["res_dual"])
                | (info["res_primal"] > prev_info["res_primal"])
            )
            poor_hi = (
                backwards
                & (info["ktratio"] < 100.0 * F64EPS)
                & (
                    (prev_info["gap_abs"] < st.tol_gap_abs)
                    | (prev_info["gap_rel"] < st.tol_gap_rel)
                )
            )
            diverging = (
                backwards
                & (info["ktratio"] < 1.0)
                & (
                    (
                        (info["res_dual"] > 100.0 * st.tol_feas)
                        & (info["res_dual"] > 100.0 * prev_info["res_dual"])
                    )
                    | (
                        (info["res_primal"] > 100.0 * st.tol_feas)
                        & (info["res_primal"] > 100.0 * prev_info["res_primal"])
                    )
                )
            )
            status = jnp.where(
                (status == int(S.UNSOLVED)) & (poor_hi | diverging),
                int(S.INSUFFICIENT_PROGRESS),
                status,
            )
            status = jnp.where(
                (status == int(S.UNSOLVED)) & (it >= st.max_iter),
                int(S.MAX_ITERATIONS),
                status,
            ).astype(jnp.int32)
            # time limit -> MAX_TIME (info.jl:110-115); elapsed is 0
            # when time_limit is inf (no host clock in the loop)
            status = jnp.where(
                (status == int(S.UNSOLVED)) & (elapsed > st.time_limit),
                int(S.MAX_TIME),
                status,
            ).astype(jnp.int32)
            return status

        # -------------------- one generic KKT step solve
        # (kktsystem.jl:135-215)
        def kkt_step(fac, x2, z2, v, scal, rhs, is_affine: bool,
                     presolved=None):
            if is_affine:
                const = v["s"]
            else:
                const = cone_ops.ds_from_dz_offset(layout, scal, rhs["s"], v["z"])
            workz = const - rhs["z"]
            if presolved is None:
                x1, z1, ok, nir = kkt_solve(fac, rhs["x"], workz)
            else:
                # solved jointly with the constant-RHS system in one
                # multi-RHS kernel launch (see kkt_solve.pair)
                x1, z1, ok, nir = presolved

            tau, kappa = v["tau"], v["kappa"]
            xi = v["x"] / tau
            tau_num = (
                rhs["tau"] - rhs["kappa"] / tau
                + vdot(q, x1) + vdot(b, z1) + 2.0 * quad(xi, x1)
            )
            xi_m = xi - x2
            tau_den = (
                kappa / tau - vdot(q, x2) - vdot(b, z2)
                + quad(xi_m, xi_m) - quad(x2, x2)
            )
            dtau = tau_num / tau_den
            dx = x1 + dtau * x2
            dz = z1 + dtau * z2
            dsv = -(cone_ops.mul_Hs(layout, scal, dz) + const)
            dkappa = -(rhs["kappa"] + kappa * dtau) / tau
            return (
                {"x": dx, "s": dsv, "z": dz, "tau": dtau, "kappa": dkappa},
                ok,
                nir,
            )

        # -------------------- step length (variables.jl:14-43)
        def get_step_length(v, step, scal, scaling, combined: bool):
            atau = jnp.where(step["tau"] < 0, -v["tau"] / step["tau"], FMAX)
            akappa = jnp.where(step["kappa"] < 0, -v["kappa"] / step["kappa"], FMAX)
            amax = jnp.minimum(jnp.minimum(atau, akappa), 1.0)
            alpha = cone_ops.step_length(
                layout, scal, step["z"], step["s"], v["z"], v["s"], amax, st
            )
            if combined:
                alpha = alpha * st.max_step_fraction
                if not sym:
                    # barrier backtrack for Dual-scaled asymmetric steps
                    # (solver.jl:407-442)
                    alpha = jnp.where(
                        scaling == DUAL_ONLY,
                        backtrack_barrier(v, step, alpha),
                        alpha,
                    )
            return alpha

        def full_barrier(v, step, alpha):
            """variables_barrier (variables.jl:46-72)."""
            cur_tau = v["tau"] + alpha * step["tau"]
            cur_kappa = v["kappa"] + alpha * step["kappa"]
            sz = jnp.sum((v["z"] + alpha * step["z"]) * (v["s"] + alpha * step["s"]))
            mu = (sz + cur_tau * cur_kappa) / deg1
            barrier = (
                deg1 * cone_ops._logsafe(mu)
                - cone_ops._logsafe(cur_tau)
                - cone_ops._logsafe(cur_kappa)
            )
            return barrier + cone_ops.compute_barrier(
                layout, v["z"], v["s"], step["z"], step["s"], alpha
            )

        def backtrack_barrier(v, step, alpha0):
            def cond(c):
                _, j, done = c
                return (~done) & (j < 50)

            def body(c):
                a, j, _ = c
                done = full_barrier(v, step, a) < 1.0
                a = jnp.where(done, a, st.linesearch_backtrack_step * a)
                return (a, j + 1, done)

            a, _, _ = jax.lax.while_loop(cond, body, (alpha0, 0, False))
            return a

        # -------------------- initialization (solver.jl:383-404)
        def default_start():
            if warm:
                # Warm start (no reference counterpart — iterates always
                # restart there, data_updating.jl): user iterates in the
                # scaled space, nudged to a small strictly-interior
                # margin.  The cold start's shift_to_cone_interior
                # targets margin >= 1 (variables.jl:180-208), which
                # would erase a near-optimal point whose active
                # constraints sit at margin ~ 0; here the floor is a
                # small multiple of the point's scale so the supplied
                # centrality survives.  tau = 1 and kappa = mu0 place
                # the homogeneous embedding at that centrality.
                def interior(vec, pd):
                    min_margin, _ = cone_ops.margins(layout, vec, pd)
                    # fixed small floor in the equilibrated space (Ruiz
                    # keeps entries near O(1)); scaling the floor by
                    # max|vec| would let one legitimately large entry
                    # inflate the shift applied to every cone and erase
                    # the supplied centrality
                    shift = jnp.maximum(1e-6 - min_margin, 0.0)
                    return cone_ops.scaled_unit_shift(layout, vec, shift, pd)

                s0 = interior(dev["ws_s"], cone_ops.PRIMAL)
                z0 = interior(dev["ws_z"], cone_ops.DUAL)
                mu0 = jnp.maximum(vdot(s0, z0) / deg1, 1e-8)
                return {
                    "x": dev["ws_x"],
                    "s": s0,
                    "z": z0,
                    "tau": jnp.asarray(1.0),
                    "kappa": mu0,
                }
            if sym:
                scal0 = cone_ops.set_identity_scaling(layout)
                if sparse is None:
                    fac, _ = factorize(P, A, _hs_for_backend(scal0))
                else:
                    fac, _ = factorize(
                        Pv, Av,
                        cone_ops.sparse_hs_values(layout, scal0, _hs_plan),
                        dev["spbufs"],
                    )
                if has_P:
                    # QP init (kktsystem.jl:120-128)
                    x0, z0, _, _ = kkt_solve(fac, -q, b)
                    s0 = -z0
                else:
                    # LP init (kktsystem.jl:101-119); the two solves
                    # share the factor — one multi-RHS launch if the
                    # backend offers it
                    pair0 = _init_pair
                    if pair0 is not None:
                        x0, ms, _, z0, _, _ = pair0(
                            fac, jnp.zeros(n), b, -q, jnp.zeros(m)
                        )
                    else:
                        x0, ms, _, _ = kkt_solve(fac, jnp.zeros(n), b)
                        _, z0, _, _ = kkt_solve(fac, -q, jnp.zeros(m))
                    s0 = -ms
                s0 = cone_ops.shift_to_cone_interior(layout, s0, cone_ops.PRIMAL)
                z0 = cone_ops.shift_to_cone_interior(layout, z0, cone_ops.DUAL)
            else:
                z0, s0 = cone_ops.unit_initialization(layout)
                x0 = jnp.zeros(n)
            return {
                "x": x0,
                "s": s0,
                "z": z0,
                "tau": jnp.asarray(1.0),
                "kappa": jnp.asarray(1.0),
            }

        # -------------------- loop state
        def where_tree(c, a, b_):
            return jax.tree_util.tree_map(lambda u, w: jnp.where(c, u, w), a, b_)

        def make_state0():
            # lazy: tracing the init-point KKT solves only happens when
            # the caller actually wants the initial state (the staged
            # batch path calls build() three times but initializes once)
            v0 = default_start()
            info0 = {k: jnp.asarray(FMAX) for k in INFO_KEYS}
            state0 = {
                "vars": v0,
                "prev_vars": v0,
                "info": info0,
                "prev_info": info0,
                "iter": jnp.asarray(0, jnp.int32),
                "status": jnp.asarray(int(S.UNSOLVED), jnp.int32),
                "scaling": jnp.asarray(init_scaling, jnp.int32),
                "mu": jnp.asarray(FMAX),
                "alpha": jnp.asarray(0.0),
                "sigma": jnp.asarray(1.0),
                "ir_count": jnp.asarray(0, jnp.int32),
                "ir_last": jnp.asarray(0, jnp.int32),
            }
            if st.verbose:
                # per-iteration progress table, written on device and
                # printed post-hoc on the host (device-side equivalent of the
                # reference's streaming print_status line,
                # info_print.jl:122-160)
                state0["hist"] = jnp.zeros((st.max_iter + 1, 11))
            return state0

        def loop_cond(s_):
            return s_["status"] == int(S.UNSOLVED)

        has_time_limit = math.isfinite(st.time_limit)

        def _host_clock(it):
            # shaped like `it` so vmap_method="broadcast_all" batches it;
            # depending on the iteration counter keeps XLA from CSE'ing
            # the call across loop passes
            return np.full(np.shape(it), _time.time())

        def loop_body(s_):
            v = s_["vars"]
            scaling = s_["scaling"]

            r = residuals(v)
            mu = (r["sz"] + v["tau"] * v["kappa"]) / deg1
            info = info_update(r, v)
            if has_time_limit:
                # host wall clock, only compiled in when a finite
                # time_limit is set (settings.jl:73 -> MAX_TIME)
                tnow = jax.pure_callback(
                    _host_clock,
                    jax.ShapeDtypeStruct((), jnp.float64),
                    s_["iter"],
                    vmap_method="broadcast_all",
                )
                elapsed = tnow - dev["t_start"]
            else:
                elapsed = jnp.asarray(0.0)
            status = check_termination(
                info, s_["prev_info"], s_["iter"], elapsed
            )

            if st.verbose:
                row = jnp.stack(
                    [
                        info["cost_primal"],
                        info["cost_dual"],
                        info["gap_rel"],
                        info["res_primal"],
                        info["res_dual"],
                        info["ktratio"],
                        mu,
                        s_["alpha"],
                        s_["iter"].astype(jnp.float64),
                        s_["ir_last"].astype(jnp.float64),
                        scaling.astype(jnp.float64),
                    ]
                )
                hist = s_["hist"].at[s_["iter"]].set(row)
                if stream:
                    # live status line per iteration (the reference
                    # STREAMS print_status, info_print.jl:122-160; the
                    # post-hoc history buffer alone leaves a
                    # minutes-long sparse solve silent).  Unbatched
                    # solver paths only — a vmapped callback would
                    # interleave problems.
                    def _emit(i, r):
                        from .. import info_print

                        print(info_print.format_iteration_row(
                            int(i), np.asarray(r)), flush=True)

                    jax.debug.callback(
                        _emit, s_["iter"], row, ordered=True
                    )

            # --- insufficient-progress checkpoint (solver.jl:453-472)
            if not sym:
                restore = (status == int(S.INSUFFICIENT_PROGRESS)) & (
                    scaling == PRIMAL_DUAL
                )
            else:
                restore = jnp.asarray(False)
            v = where_tree(restore, s_["prev_vars"], v)
            info = where_tree(restore, s_["prev_info"], info)
            status = jnp.where(restore, int(S.UNSOLVED), status).astype(jnp.int32)
            scaling = jnp.where(restore, DUAL_ONLY, scaling).astype(jnp.int32)

            done = status != int(S.UNSOLVED)
            proceed = (~done) & (~restore)

            # --- cone scaling update
            scal, scale_ok = cone_ops.update_scaling(
                layout, v["s"], v["z"], mu, scaling
            )
            status = jnp.where(
                proceed & ~scale_ok, int(S.NUMERICAL_ERROR), status
            ).astype(jnp.int32)
            proceed = proceed & scale_ok

            it = jnp.where(proceed, s_["iter"] + 1, s_["iter"]).astype(jnp.int32)

            # --- KKT update + constant-rhs solve (kktsystem.jl:62-92)
            if sparse is None:
                fac, okf = factorize(P, A, _hs_for_backend(scal))
            else:
                hs_parts = cone_ops.sparse_hs_values(layout, scal, _hs_plan)
                fac, okf = factorize(Pv, Av, hs_parts, dev["spbufs"])

            # --- affine step (variables.jl:107-121)
            rhs_aff = {
                "x": r["rx"],
                "z": r["rz"],
                "s": cone_ops.affine_ds(layout, scal, v["s"]),
                "tau": r["rtau"],
                "kappa": v["tau"] * v["kappa"],
            }
            pair_solve = kkt_solve_pair
            if pair_solve is not None:
                # the constant-RHS (-q, b) and affine systems share the
                # factor and both right-hand sides exist now — solve
                # them in ONE multi-RHS kernel launch (the substitution
                # chain's sequential latency is paid once)
                x2, z2, x1a, z1a, okc, nir_c = pair_solve(
                    fac, -q, b, rhs_aff["x"], v["s"] - rhs_aff["z"]
                )
                presolved_aff = (x1a, z1a, okc, nir_c)
            else:
                x2, z2, okc, nir_c = kkt_solve(fac, -q, b)
                presolved_aff = None
            kkt_ok = okf & okc

            step_aff, oka, nir_a = kkt_step(
                fac, x2, z2, v, scal, rhs_aff, True, presolved=presolved_aff
            )
            kkt_ok = kkt_ok & oka

            alpha_aff = get_step_length(v, step_aff, scal, scaling, combined=False)
            sigma = (1.0 - alpha_aff) ** 3  # Mehrotra (solver.jl:446-449)
            # reduced correction on the first iteration (solver.jl:305-307:
            # m = iter > 1 ? 1 : alpha).  Applying it by scaling step_z
            # before the per-cone shift matches the reference exactly —
            # variables_combined_step_rhs! does `step.z .*= m` globally
            # before combined_ds_shift! (variables.jl:147-151), so the
            # nonsymmetric higher-order corrections see the scaled step_z
            # there too.
            mcorr = jnp.where(it > 1, 1.0, alpha_aff)

            # --- combined step (variables.jl:124-162)
            sigma_mu = sigma * mu
            shift = cone_ops.combined_ds_shift(
                layout, scal, step_aff["z"] * mcorr, step_aff["s"], sigma_mu, v["z"]
            )
            rhs_comb = {
                "x": (1.0 - sigma) * r["rx"],
                "z": (1.0 - sigma) * r["rz"],
                "s": rhs_aff["s"] + shift,
                "tau": (1.0 - sigma) * r["rtau"],
                "kappa": -sigma_mu
                + mcorr * step_aff["tau"] * step_aff["kappa"]
                + v["tau"] * v["kappa"],
            }
            step_comb, okcb, nir_b = kkt_step(fac, x2, z2, v, scal, rhs_comb, False)
            kkt_ok = kkt_ok & okcb

            # --- Gondzio multiple centrality correctors (optional; no
            # reference counterpart — Clarabel.jl stops at the Mehrotra
            # correction above).  Each round reuses the factorization:
            # evaluate the trial point's scaled complementarity, push
            # outlier components back into [bmin, bmax]*sigma*mu via one
            # extra back-solve, keep the corrected step only if the step
            # length improves by >=10% of the headroom probed.
            # Symmetric-cone problems only (the nonsymmetric shift is
            # gradient-based and has no product to retarget).
            n_corr = int(st.centrality_correctors) if sym else 0
            if n_corr > 0:
                alpha_cc = get_step_length(
                    v, step_comb, scal, scaling, combined=True
                )
                for _ in range(n_corr):
                    abar = jnp.minimum(1.0, 1.08 * alpha_cc + 0.08)
                    z_t = v["z"] + abar * step_comb["z"]
                    s_t = v["s"] + abar * step_comb["s"]
                    lo = st.corrector_beta_min * sigma_mu
                    hi = st.corrector_beta_max * sigma_mu
                    cadd = cone_ops.centrality_correction(
                        layout, scal, z_t, s_t, lo, hi
                    )
                    tk = (v["tau"] + abar * step_comb["tau"]) * (
                        v["kappa"] + abar * step_comb["kappa"]
                    )
                    rhs_try = dict(rhs_comb)
                    rhs_try["s"] = rhs_comb["s"] + cadd
                    rhs_try["kappa"] = rhs_comb["kappa"] + (
                        tk - jnp.clip(tk, lo, hi)
                    )
                    step_try, okt, nir_t = kkt_step(
                        fac, x2, z2, v, scal, rhs_try, False
                    )
                    alpha_try = get_step_length(
                        v, step_try, scal, scaling, combined=True
                    )
                    accept = okt & (
                        alpha_try >= alpha_cc + 0.1 * (abar - alpha_cc)
                    )
                    step_comb = where_tree(accept, step_try, step_comb)
                    rhs_comb = where_tree(accept, rhs_try, rhs_comb)
                    alpha_cc = jnp.where(accept, alpha_try, alpha_cc)
                    nir_b = nir_b + jnp.where(accept, nir_t, 0)

            # --- numerical-error checkpoint (solver.jl:475-489)
            if not sym:
                ne_retry = proceed & ~kkt_ok & (scaling == PRIMAL_DUAL)
                scaling = jnp.where(ne_retry, DUAL_ONLY, scaling).astype(jnp.int32)
            else:
                ne_retry = jnp.asarray(False)
            ne_fail = proceed & ~kkt_ok & ~ne_retry
            status = jnp.where(ne_fail, int(S.NUMERICAL_ERROR), status).astype(
                jnp.int32
            )
            active = proceed & kkt_ok

            # --- final step length + small-step checkpoint
            # (solver.jl:337-344,492-505)
            if n_corr > 0:
                alpha = alpha_cc  # already computed on the final step
            else:
                alpha = get_step_length(
                    v, step_comb, scal, scaling, combined=True
                )
            if not sym:
                small_switch = (
                    active
                    & (scaling == PRIMAL_DUAL)
                    & (alpha < st.min_switch_step_length)
                )
                scaling = jnp.where(small_switch, DUAL_ONLY, scaling).astype(
                    jnp.int32
                )
            else:
                small_switch = jnp.asarray(False)
            small_fail = (
                active
                & ~small_switch
                & (alpha <= max(0.0, st.min_terminate_step_length))
            )
            status = jnp.where(
                small_fail, int(S.INSUFFICIENT_PROGRESS), status
            ).astype(jnp.int32)

            commit = active & ~small_switch & ~small_fail

            # --- commit step (variables.jl:92-104) + save prev iterate
            new_vars = {
                "x": v["x"] + alpha * step_comb["x"],
                "s": v["s"] + alpha * step_comb["s"],
                "z": v["z"] + alpha * step_comb["z"],
                "tau": v["tau"] + alpha * step_comb["tau"],
                "kappa": v["kappa"] + alpha * step_comb["kappa"],
            }
            vars_out = where_tree(commit, new_vars, v)
            prev_vars_out = where_tree(commit, v, s_["prev_vars"])
            prev_info_out = where_tree(commit, info, s_["prev_info"])

            out = {
                "vars": vars_out,
                "prev_vars": prev_vars_out,
                "info": info,
                "prev_info": prev_info_out,
                "iter": it,
                "status": status,
                "scaling": scaling,
                "mu": mu,
                "alpha": jnp.where(commit, alpha, 0.0),
                "sigma": sigma,
                # ir_count accumulates every refinement pass of the
                # whole solve (the reference counts per-solve; summing
                # makes info.ir_count the total refinement work);
                # ir_last keeps this iteration's count for the verbose
                # table
                "ir_count": s_["ir_count"]
                + (nir_c + nir_a + nir_b).astype(jnp.int32),
                "ir_last": (nir_c + nir_a + nir_b).astype(jnp.int32),
            }
            if st.verbose:
                out["hist"] = hist
            return out

        # -------------------- post-processing
        def post(final):
            info = final["info"]
            status = final["status"]

            # "almost" convergence on errored / limit exits
            # (info.jl:198-214)
            errored_or_limit = (
                (status == int(S.NUMERICAL_ERROR))
                | (status == int(S.INSUFFICIENT_PROGRESS))
                | (status == int(S.MAX_ITERATIONS))
                | (status == int(S.MAX_TIME))
            )
            almost = check_convergence(
                info,
                st.reduced_tol_gap_abs, st.reduced_tol_gap_rel,
                st.reduced_tol_feas,
                st.reduced_tol_infeas_abs, st.reduced_tol_infeas_rel,
                st.reduced_tol_ktratio,
                int(S.ALMOST_SOLVED),
                int(S.ALMOST_PRIMAL_INFEASIBLE),
                int(S.ALMOST_DUAL_INFEASIBLE),
            )
            status = jnp.where(
                errored_or_limit & (almost != int(S.UNSOLVED)), almost, status
            ).astype(jnp.int32)

            is_infeasible = (
                (status == int(S.PRIMAL_INFEASIBLE))
                | (status == int(S.DUAL_INFEASIBLE))
                | (status == int(S.ALMOST_PRIMAL_INFEASIBLE))
                | (status == int(S.ALMOST_DUAL_INFEASIBLE))
            )

            # unscale (variables.jl:247-275)
            v = final["vars"]
            scaleinv = jnp.where(is_infeasible, 1.0 / v["kappa"], 1.0 / v["tau"])
            x_out = v["x"] * d * scaleinv
            z_out = v["z"] * e * (scaleinv * cinv)
            s_out = v["s"] * einv * scaleinv

            nan = jnp.asarray(float("nan"))
            obj_val = jnp.where(is_infeasible, nan, info["cost_primal"])
            obj_val_dual = jnp.where(is_infeasible, nan, info["cost_dual"])

            result_extra = {"hist": final["hist"]} if st.verbose else {}
            return {
                **result_extra,
                "x": x_out,
                "s": s_out,
                "z": z_out,
                "tau": v["tau"] * scaleinv,
                "kappa": v["kappa"] * scaleinv,
                "status": status,
                "obj_val": obj_val,
                "obj_val_dual": obj_val_dual,
                "iterations": final["iter"],
                "r_prim": info["res_primal"],
                "r_dual": info["res_dual"],
                # partial (infeasibility-certificate) residuals, part of
                # the reference's DefaultInfo surface (types.jl:209-251)
                "res_primal_inf": info["res_primal_inf"],
                "res_dual_inf": info["res_dual_inf"],
                "gap_abs": info["gap_abs"],
                "gap_rel": info["gap_rel"],
                "ktratio": info["ktratio"],
                "mu": final["mu"],
                "step_length": final["alpha"],
                "sigma": final["sigma"],
                "ir_count": final["ir_count"],
                # terminal scaling strategy (0 = PrimalDual, 1 = Dual):
                # surfaces the per-problem nonsymmetric-cone downgrade
                # (solver.jl:453-514's strategy ladder) so batched
                # callers can observe strategy divergence across lanes
                "scaling": final["scaling"],
            }

        return make_state0, loop_cond, loop_body, post

    def solve(dev: Dict[str, jnp.ndarray]):
        make_state0, loop_cond, loop_body, post = build(dev)
        return post(jax.lax.while_loop(loop_cond, loop_body, make_state0()))

    def solve_precise(dev: Dict[str, jnp.ndarray]):
        # f32 matmuls may default to reduced internal precision (TF32
        # on GPU tensor cores), which costs ~3 decimal digits in the KKT
        # solves and cone products; the IPM's 1e-8 termination needs
        # true f32.
        with jax.default_matmul_precision("highest"):
            return solve(dev)

    if parts:
        return build
    return solve_precise if raw else jax.jit(solve_precise)
