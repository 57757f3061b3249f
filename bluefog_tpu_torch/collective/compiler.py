# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Comm-plan compiler: pack a directed edge set into permutation rounds.

Counterpart of ``bluefog_tpu/collective/compiler.py`` (the offset grouping,
the König edge coloring and the ``auto`` choice between them). Each round
is a partial permutation: every rank sends at most once and receives at
most once, which is all the stacked combine (a gather along the worker
axis per round) relies on.

Left out: the short-cut relay family, the measured calibration and the
chunk chooser. The stacked transport has no wire to pipeline, so it always
runs one chunk; the JAX package pins chunked == monolithic bitwise, so the
numbers are the same either way.
"""

import dataclasses
from typing import Dict, Iterable, List, Tuple

__all__ = [
    "CompiledEdges",
    "compile_edges",
    "offset_perms",
    "coloring_perms",
    "min_rounds",
]

Perms = Tuple[Tuple[Tuple[int, int], ...], ...]


@dataclasses.dataclass(frozen=True)
class CompiledEdges:
    """The chosen round structure and how it was chosen."""

    perms: Perms
    method: str  # "offset" | "coloring"
    rounds: int
    offset_rounds: int  # the naive (offset-grouped) round count
    lower_bound: int  # König bound: max(max_in_degree, max_out_degree)


def _canonical(edges: Iterable[Tuple[int, int]], size: int) -> Tuple[Tuple[int, int], ...]:
    """Dedupe, drop self loops, validate range, sort."""
    out = set()
    for i, j in edges:
        i, j = int(i), int(j)
        if i == j:
            continue
        if not (0 <= i < size and 0 <= j < size):
            raise ValueError(f"edge ({i}, {j}) out of range for size {size}")
        out.add((i, j))
    return tuple(sorted(out))


def offset_perms(edges: Iterable[Tuple[int, int]], size: int) -> Perms:
    """Group edges by ring offset ``(dst - src) % size``; circulant
    topologies yield one full permutation per offset."""
    by_offset: Dict[int, List[Tuple[int, int]]] = {}
    for i, j in _canonical(edges, size):
        by_offset.setdefault((j - i) % size, []).append((i, j))
    return tuple(tuple(sorted(by_offset[o])) for o in sorted(by_offset))


def min_rounds(edges: Iterable[Tuple[int, int]], size: int) -> int:
    """König lower bound: the busiest sender or receiver."""
    out_deg = [0] * size
    in_deg = [0] * size
    for i, j in _canonical(edges, size):
        out_deg[i] += 1
        in_deg[j] += 1
    return max(max(out_deg, default=0), max(in_deg, default=0))


def coloring_perms(edges: Iterable[Tuple[int, int]], size: int) -> Perms:
    """Minimum-round packing: bipartite edge coloring by Kempe chains,
    with exactly :func:`min_rounds` colors (same algorithm and edge order
    as the JAX compiler, so the rounds come out identical)."""
    edge_list = _canonical(edges, size)
    src_color: List[Dict[int, int]] = [dict() for _ in range(size)]
    dst_color: List[Dict[int, int]] = [dict() for _ in range(size)]

    def first_free(used: Dict[int, int]) -> int:
        c = 0
        while c in used:
            c += 1
        return c

    for u, v in edge_list:
        a = first_free(src_color[u])
        b = first_free(dst_color[v])
        if a != b:
            # flip the maximal a/b alternating chain starting at v
            chain: List[Tuple[int, int, int]] = []
            cur, want, at_dst = v, a, True
            while True:
                if at_dst:
                    s = dst_color[cur].get(want)
                    if s is None:
                        break
                    chain.append((s, cur, want))
                    cur, at_dst = s, False
                else:
                    d = src_color[cur].get(want)
                    if d is None:
                        break
                    chain.append((cur, d, want))
                    cur, at_dst = d, True
                want = b if want == a else a
            for s, d, c in chain:
                del src_color[s][c]
                del dst_color[d][c]
            for s, d, c in chain:
                nc = b if c == a else a
                src_color[s][nc] = d
                dst_color[d][nc] = s
        src_color[u][a] = v
        dst_color[v][a] = u

    n_colors = 1 + max((c for cols in src_color for c in cols), default=-1)
    rounds: List[List[Tuple[int, int]]] = [[] for _ in range(n_colors)]
    for s, cols in enumerate(src_color):
        for c, d in cols.items():
            rounds[c].append((s, d))
    perms = tuple(tuple(sorted(r)) for r in rounds if r)
    _check_rounds(perms, edge_list)
    return perms


def _check_rounds(perms: Perms, edge_list) -> None:
    """Every round is a partial permutation and the rounds partition the
    edge set exactly."""
    seen = []
    for perm in perms:
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise AssertionError(f"round is not a partial permutation: {perm}")
        seen.extend(perm)
    if sorted(seen) != list(edge_list):
        raise AssertionError("compiled rounds do not partition the edge set")


def compile_edges(
    edges: Iterable[Tuple[int, int]], size: int, method: str = "auto"
) -> CompiledEdges:
    """Compile a directed edge set into permutation rounds.

    ``auto`` takes the coloring only when it strictly reduces the round
    count and keeps the offset grouping on ties (the JAX compiler's rule,
    whose cost model is monotone in the round count); ``offset`` and
    ``coloring`` force one pass."""
    if method not in ("auto", "offset", "coloring"):
        raise ValueError(
            f"method must be 'auto', 'offset' or 'coloring', got {method!r}"
        )
    canon = _canonical(edges, size)
    naive = offset_perms(canon, size)
    bound = min_rounds(canon, size)
    if method == "offset":
        perms, chosen = naive, "offset"
    else:
        colored = naive if len(naive) <= bound else coloring_perms(canon, size)
        if method == "coloring" or len(colored) < len(naive):
            perms, chosen = colored, "coloring"
        else:
            perms, chosen = naive, "offset"
    return CompiledEdges(
        perms=perms,
        method=chosen,
        rounds=len(perms),
        offset_rounds=len(naive),
        lower_bound=bound,
    )
