"""Large sparse QPs (device multifrontal) and chordal SDPs.

1. A 2-D grid-Laplacian QP at N ~ 10^3-10^4 KKT dims through
   SparseSolver (host symbolic analysis + level-scheduled batched
   fronts on device).
2. A banded SDP decomposed into clique-sized PSD blocks (chordal
   decomposition), which stay sparse end-to-end.

Run:  python examples/sparse_and_sdp.py
"""

import os
import sys

# runnable from anywhere without installation; runs on the default JAX
# backend (the GPU when there is one; JAX_PLATFORMS=cpu forces the CPU)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np
import scipy.sparse as sp

import cuclarabel_tpu as cc
from cuclarabel_tpu.sparse_solver import SparseSolver


def grid_qp(k: int, seed=0):
    """min 1/2 x'Lx - q'x s.t. 0 <= x <= 1 on a k-by-k grid Laplacian."""
    rng = np.random.default_rng(seed)
    n = k * k
    L = (sp.kronsum(sp.diags([[-1.0], [2.0], [-1.0]],
                             offsets=[-1, 0, 1], shape=(k, k)),
                    sp.diags([[-1.0], [2.0], [-1.0]],
                             offsets=[-1, 0, 1], shape=(k, k)))
         + 0.1 * sp.eye(n)).tocsc()
    q = -rng.random(n)
    A = sp.vstack([-sp.eye(n), sp.eye(n)]).tocsc()
    b = np.concatenate([np.zeros(n), np.ones(n)])
    return sp.triu(L).tocsc(), q, A, b, [cc.NonnegativeConeT(2 * n)]


def banded_sdp(nv: int, bw: int, seed=0):
    """min c'x s.t. S0 + sum x_i S_i is PSD, with banded aggregate
    sparsity -> chordal decomposition splits the cone into cliques."""
    rng = np.random.default_rng(seed)
    d = nv
    sv = d * (d + 1) // 2

    def svec(M):
        out = []
        rt2 = np.sqrt(2.0)
        for j in range(d):
            for i in range(j + 1):
                out.append(M[i, j] * (1.0 if i == j else rt2))
        return np.array(out)

    def band(M):
        out = np.zeros((d, d))
        for i in range(d):
            for j in range(max(0, i - bw), min(d, i + bw + 1)):
                out[i, j] = M[i, j]
        return (out + out.T) / 2

    nx = 6
    S = [band(rng.standard_normal((d, d))) for _ in range(nx)]
    X0 = band(rng.standard_normal((d, d)))
    S0 = X0 @ X0.T + 0.1 * np.eye(d)   # strictly feasible at x = 0
    S0 = band(S0) + np.eye(d) * (bw + 1)
    c = rng.random(nx)
    A = -np.column_stack([svec(Si) for Si in S])
    b = svec(S0)
    return None, c, A, b, [cc.PSDTriangleConeT(d)]


def main():
    k = 24
    P, q, A, b, cones = grid_qp(k)
    t0 = time.perf_counter()
    sol = SparseSolver(P, q, A, b, cones).solve()
    t1 = time.perf_counter() - t0
    print(f"grid QP n={k*k}: {sol.status.name} in {sol.iterations} iters, "
          f"r_prim={sol.r_prim:.1e} ({t1:.1f}s incl. compile)")

    P, q, A, b, cones = banded_sdp(16, 2)
    t0 = time.perf_counter()
    sol = cc.Solver(P, q, A, b, cones,
                    chordal_decomposition_enable=True).solve()
    t1 = time.perf_counter() - t0
    print(f"banded SDP d=16 (chordal): {sol.status.name} in "
          f"{sol.iterations} iters ({t1:.1f}s incl. compile)")


if __name__ == "__main__":
    main()
