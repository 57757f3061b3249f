# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Sparse spectral engine for the mixing observatory.

Counterpart of ``bluefog_tpu/topology/spectral.py``, copied: it is pure
numpy, so the port's SLEMs, decay rates and info dicts are bitwise the JAX
package's. The one-shot warning comes from the port's own
:func:`bluefog_tpu_torch.logging_util.warn_once` (a ``UserWarning``).

Gossip matrices have ``O(N * degree)`` nonzeros by construction — that is
the whole point of the Exp2/ring topology families — yet every spectral
query used to bottom out in dense ``np.linalg.eigvals`` on the full N x N
combine matrix (O(N^3) per query). This module computes the same SLEM /
decay-rate quantities by *deflated Arnoldi iteration over edge lists*:

- The combine convention is ``W[i, j]`` = weight rank ``j`` applies to
  rank ``i``'s value; one gossip step is ``x -> W^T x``. Every matrix
  this codebase produces is stochastic in at least one orientation
  (receiver-normalized: columns of ``W`` sum to 1; push-sum /
  mass-conserving: rows sum to 1; most generators are doubly
  stochastic). In either orientation the all-ones vector is a Perron
  eigenvector (right for row-stochastic ``A = W^T``, left for
  column-stochastic), so the Wielandt deflation

      ``B = A - (1/n) * ones @ ones.T``

  removes exactly the Perron root and preserves every other eigenvalue —
  the SLEM is the largest-modulus eigenvalue of ``B``.
- Period products (dynamic one-peer schedules, per-period repaired
  plans) are applied as *composed mat-vecs*: the N x N product is never
  materialized; one operator application costs the sum of the factors'
  nonzeros.
- The dominant eigenvalue of ``B`` is found by restarted Arnoldi
  iteration (Krylov dimension ``min(n, 64)``, residual from the
  Hessenberg subdiagonal). For ``n <= krylov`` the reduction is complete
  and the Ritz values are exact to roundoff, which is how the
  sparse-vs-dense 1e-9 agreement sweep passes across every generator.
- Disconnected / periodic chains keep a second modulus-1 root after
  deflation, so the SLEM == 1.0 "no contraction promised" contract is
  preserved structurally, not special-cased.

Routing: :func:`slem_info` / :func:`decay_info` auto-select the sparse
path above ``BLUEFOG_SPECTRAL_DENSE_MAX`` ranks (default 64); the dense
eigvals path below that threshold — and as the disclosed fallback when a
matrix is not stochastic in either orientation — is retained verbatim as
the oracle. Every result carries a structured ``info`` dict
(``engine`` / ``matvecs`` / ``residual`` / ``converged``) so health,
autotune, and the elastic repair verdicts can publish how the number
they acted on was obtained.
"""

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from bluefog_tpu_torch.logging_util import warn_once

__all__ = [
    "DENSE_MAX_ENV",
    "DENSE_MAX_DEFAULT",
    "EdgeMatrix",
    "dense_max",
    "spectral_dense_max",
    "dense_slem",
    "slem_info",
    "decay_info",
    "edges_from_dense",
    "live_submatrix_edges",
]

DENSE_MAX_ENV = "BLUEFOG_SPECTRAL_DENSE_MAX"
DENSE_MAX_DEFAULT = 64

# N above which a dense-forced call (BLUEFOG_SPECTRAL_DENSE_MAX=0) warns
# once — nobody silently reintroduces O(N^3) at fleet scale.
_DENSE_FORCE_WARN_N = 256

# column/row sums must be within this of 1.0 for the ones-deflation to
# be exact; everything this repo constructs is stochastic to ~1e-15
_STOCHASTIC_TOL = 1e-8

# Krylov subspace dimension: complete (hence exact) reduction for every
# n the dense oracle is also willing to touch; restarted above that
_KRYLOV_DIM = 64
_MAX_RESTARTS = 200
_ARNOLDI_TOL = 1e-11

# Period products can be numerically nilpotent (dynamic exp2 one-peer
# reaches EXACT consensus after one period), leaving both engines with
# noise-level SLEMs that the ``rho ** (1/K)`` normalization amplifies
# into disagreement. A rho this far below machine meaning snaps to the
# floor, so both engines report the identical (tiny, still > 0 — the
# downstream log() stays finite) per-step rate.
_PERIOD_RHO_FLOOR = 1e-12


def dense_max() -> int:
    """Rank count at or below which the dense eigvals path runs.

    ``BLUEFOG_SPECTRAL_DENSE_MAX`` overrides the default (64);
    ``0`` disables the sparse engine entirely (dense-forced — warns
    once past N=256)."""
    env = os.environ.get(DENSE_MAX_ENV)
    if env is None:
        return DENSE_MAX_DEFAULT
    try:
        return int(env)
    except ValueError:
        return DENSE_MAX_DEFAULT


# public alias under the package namespace (`bf.topology.spectral_dense_max`)
spectral_dense_max = dense_max


class EdgeMatrix:
    """A combine matrix held as a COO edge list — the sparse engine's
    native operand, and the form the fleet simulator's repair algebra
    produces directly (no N x N array ever exists at fleet scale).

    ``edges`` maps ``(i, j) -> w`` with the module convention
    ``W[i, j]`` = weight receiver ``j`` applies to sender ``i``
    (self loops included as ``(i, i)``)."""

    __slots__ = ("n", "rows", "cols", "vals")

    def __init__(self, n: int, edges: Union[Dict[Tuple[int, int], float],
                                            Iterable[Tuple[int, int, float]]]):
        if isinstance(edges, dict):
            items = [(i, j, w) for (i, j), w in edges.items()]
        else:
            items = [(i, j, w) for i, j, w in edges]
        items = [(i, j, w) for i, j, w in items if w != 0.0]
        self.n = int(n)
        self.rows = np.asarray([i for i, _, _ in items], dtype=np.intp)
        self.cols = np.asarray([j for _, j, _ in items], dtype=np.intp)
        self.vals = np.asarray([w for _, _, w in items], dtype=np.float64)

    @property
    def nnz(self) -> int:
        return int(self.vals.size)

    def apply_transpose(self, x: np.ndarray) -> np.ndarray:
        """One gossip step ``x -> W^T x`` as a bincount scatter-add:
        ``y[j] = sum_i W[i, j] * x[i]`` — O(nnz), never densified."""
        return np.bincount(
            self.cols, weights=self.vals * x[self.rows], minlength=self.n
        )

    def col_sums(self) -> np.ndarray:
        return np.bincount(self.cols, weights=self.vals, minlength=self.n)

    def row_sums(self) -> np.ndarray:
        return np.bincount(self.rows, weights=self.vals, minlength=self.n)

    def to_dense(self) -> np.ndarray:
        w = np.zeros((self.n, self.n))
        w[self.rows, self.cols] = self.vals
        return w


def edges_from_dense(w: np.ndarray) -> EdgeMatrix:
    """COO view of a dense combine matrix (one O(n^2) scan — still far
    below the O(n^3) eigendecomposition it replaces)."""
    w = np.asarray(w, np.float64)
    rows, cols = np.nonzero(w)
    em = EdgeMatrix.__new__(EdgeMatrix)
    em.n = int(w.shape[0])
    em.rows = rows.astype(np.intp)
    em.cols = cols.astype(np.intp)
    em.vals = w[rows, cols].astype(np.float64)
    return em


def live_submatrix_edges(
    edges: Dict[Tuple[int, int], float], live: Sequence[int]
) -> Tuple[int, Dict[Tuple[int, int], float]]:
    """Restrict a full-size edge dict to the live set, remapped to
    ``0..len(live)-1`` — the sparse analogue of ``w[np.ix_(live, live)]``
    (a dead rank's frozen self loop adds a second Perron root and would
    misread every prediction as "no contraction promised")."""
    live = sorted(int(r) for r in set(live))
    remap = {r: k for k, r in enumerate(live)}
    sub = {
        (remap[i], remap[j]): w
        for (i, j), w in edges.items()
        if i in remap and j in remap and w != 0.0
    }
    return len(live), sub


def _as_edge_matrix(m) -> EdgeMatrix:
    if isinstance(m, EdgeMatrix):
        return m
    if isinstance(m, tuple) and len(m) == 2:
        return EdgeMatrix(m[0], m[1])
    return edges_from_dense(np.asarray(m, np.float64))


# -- dense oracle --------------------------------------------------------------


def dense_slem(w: np.ndarray) -> float:
    """The dense SLEM oracle: full eigvals, drop ONE root closest to 1
    (the Perron eigenvalue); ties beyond it (disconnected/periodic
    chains) stay and correctly report 1.0."""
    w = np.asarray(w, np.float64)
    if w.shape[0] <= 1:
        return 0.0
    eig = np.linalg.eigvals(w)
    drop = int(np.argmin(np.abs(eig - 1.0)))
    rest = np.delete(eig, drop)
    return float(np.max(np.abs(rest))) if rest.size else 0.0


# -- sparse engine -------------------------------------------------------------


def _arnoldi_dominant(matvec, n: int, *, tol: float = _ARNOLDI_TOL,
                      krylov: int = _KRYLOV_DIM,
                      restarts: int = _MAX_RESTARTS):
    """Largest-modulus eigenvalue of the (deflated) operator by
    restarted Arnoldi. Returns ``(modulus, residual, matvecs,
    converged)``. For ``n <= krylov`` the reduction is complete and the
    result is exact to roundoff (residual 0.0)."""
    m = min(n, krylov)
    rng = np.random.RandomState(0x5EED)
    v0 = rng.standard_normal(n)
    total_mv = 0
    best_val, best_res = 0.0, np.inf
    for _ in range(max(restarts, 1)):
        V = np.zeros((m + 1, n))
        H = np.zeros((m + 1, m))
        nrm = np.linalg.norm(v0)
        if nrm == 0.0 or not np.isfinite(nrm):
            v0 = rng.standard_normal(n)
            nrm = np.linalg.norm(v0)
        V[0] = v0 / nrm
        j_used = m
        broke = False
        for j in range(m):
            w = matvec(V[j])
            total_mv += 1
            # modified Gram-Schmidt with one reorthogonalization pass —
            # the cheap insurance that keeps Ritz values at 1e-12 even
            # when the Krylov basis nearly saturates an invariant
            # subspace (ring graphs do this by round m = n)
            for _pass in range(2):
                for i in range(j + 1):
                    c = float(np.dot(V[i], w))
                    H[i, j] += c
                    w -= c * V[i]
            h = float(np.linalg.norm(w))
            H[j + 1, j] = h
            if h <= 1e-13:
                # invariant subspace: Ritz values are exact eigenvalues
                j_used = j + 1
                broke = True
                break
            V[j + 1] = w / h
        k = j_used
        evals, evecs = np.linalg.eig(H[:k, :k])
        idx = int(np.argmax(np.abs(evals)))
        lam = evals[idx]
        y = evecs[:, idx]
        if broke or k >= n:
            return float(np.abs(lam)), 0.0, total_mv, True
        resid = float(np.abs(H[k, k - 1]) * np.abs(y[-1]))
        scale = max(float(np.abs(lam)), 1.0)
        if resid / scale <= tol:
            return float(np.abs(lam)), resid, total_mv, True
        if resid < best_res:
            best_val, best_res = float(np.abs(lam)), resid
        # restart from the dominant Ritz vector (real part — a complex
        # pair restarts along its invariant plane's real section)
        v0 = np.real(V[:k].T @ y)
    return best_val, best_res, total_mv, False


def _sparse_slem(mats: List[EdgeMatrix]):
    """SLEM of the period product ``W_K^T ... W_1^T`` by deflated
    Arnoldi over composed edge-list mat-vecs. Returns ``(value, info)``
    or ``None`` when the ones-deflation is not licensed (no matrix
    orientation is stochastic) — caller falls back dense."""
    n = mats[0].n
    # the ones-deflation needs the all-ones Perron direction: right
    # eigenvector when every factor's A = W^T is row-stochastic
    # (W columns sum to 1), left eigenvector when every factor is
    # column-stochastic (W rows sum to 1)
    col_ok = all(
        float(np.max(np.abs(m.col_sums() - 1.0))) <= _STOCHASTIC_TOL
        for m in mats
    )
    row_ok = all(
        float(np.max(np.abs(m.row_sums() - 1.0))) <= _STOCHASTIC_TOL
        for m in mats
    )
    if not (col_ok or row_ok):
        return None
    inv_n = 1.0 / n
    ones = np.ones(n)

    def matvec(x):
        y = x
        for m in mats:
            y = m.apply_transpose(y)
        return y - (inv_n * float(np.sum(x))) * ones

    val, resid, mv, converged = _arnoldi_dominant(matvec, n)
    info = {
        "engine": "sparse",
        "n": n,
        "nnz": int(sum(m.nnz for m in mats)),
        "period": len(mats),
        "matvecs": mv,
        "residual": float(resid),
        "converged": bool(converged),
    }
    return float(val), info


def _dense_info(mats: List[EdgeMatrix], *, reason: str):
    n = mats[0].n
    prod = np.eye(n)
    for m in mats:
        prod = m.to_dense().T @ prod
    val = dense_slem(prod)
    return val, {
        "engine": "dense",
        "n": n,
        "nnz": int(sum(m.nnz for m in mats)),
        "period": len(mats),
        "matvecs": 0,
        "residual": 0.0,
        "converged": True,
        "reason": reason,
    }


def slem_info(w) -> Tuple[float, dict]:
    """SLEM of one combine matrix with the engine-disclosure info dict.

    Accepts a dense array, an :class:`EdgeMatrix`, or an ``(n, {(i, j):
    w})`` edge-dict pair. Routing: dense at ``n <= dense_max()``
    (and when dense is forced via ``BLUEFOG_SPECTRAL_DENSE_MAX=0``),
    deflated Arnoldi over the edge list above."""
    return decay_info([w], _single=True)


def decay_info(mats, *, _single: bool = False) -> Tuple[float, dict]:
    """Per-step consensus decay rate of a matrix sequence (SLEM of the
    period product, normalized ``rho ** (1/K)``) with the
    engine-disclosure info dict. The N x N product is never formed on
    the sparse path — the period composes as mat-vecs."""
    if isinstance(mats, np.ndarray) and mats.ndim == 2:
        mats = [mats]
    elif isinstance(mats, (EdgeMatrix, tuple)):
        mats = [mats]
    ems = [_as_edge_matrix(m) for m in mats]
    if not ems:
        return 1.0, {"engine": "dense", "n": 0, "nnz": 0, "period": 0,
                     "matvecs": 0, "residual": 0.0, "converged": True}
    n = ems[0].n
    if n <= 1:
        info = {"engine": "dense", "n": n, "nnz": int(sum(m.nnz for m in ems)),
                "period": len(ems), "matvecs": 0, "residual": 0.0,
                "converged": True}
        return 0.0, info
    limit = dense_max()
    forced_dense = limit <= 0
    if forced_dense and n > _DENSE_FORCE_WARN_N:
        warn_once(
            "spectral-dense-forced",
            "dense-forced spectral call at N=%d (O(N^3) eigvals): %s=0 "
            "disables the sparse engine — unset it or raise the "
            "threshold to restore O(edges) scaling",
            n, DENSE_MAX_ENV,
        )
    if forced_dense or n <= limit:
        rho, info = _dense_info(ems, reason="forced" if forced_dense
                                else "below_dense_max")
    else:
        out = _sparse_slem(ems)
        if out is None:
            rho, info = _dense_info(ems, reason="not_stochastic")
        else:
            rho, info = out
    if _single:
        info["slem"] = float(rho)
        return float(rho), info
    if len(ems) > 1 and rho < _PERIOD_RHO_FLOOR:
        rho = _PERIOD_RHO_FLOOR
        info["floored"] = True
    rate = float(rho ** (1.0 / len(ems)))
    info["slem"] = float(rho)
    info["rate"] = rate
    return rate, info
