"""Throughput-from-port-usage LP (§5.3.2).

    minimize   max_p Σ_{(pc,μ)} f(p, pc)
    subject to f(p, pc) = 0             for p ∉ pc
               Σ_p f(p, pc) = μ         for every (pc, μ)

Linearized with z ≥ Σ f(p, pc) per port. Solved with scipy's HiGHS; a pure
bisection + max-flow feasibility fallback (networkx) covers environments
without scipy and doubles as an independent check in tests.

For prediction serving there is also a *closed form*: by max-flow/min-cut
(Hall's condition on the bipartite pc→port graph), a makespan z is feasible
iff for every port set S, the μops that can only run on S fit: demand(S) ≤
z·|S|, where demand(S) = Σ{μ(pc) : pc ⊆ S}. The binding S can always be
taken as a union of the port combinations present, so

    z* = max over unions S of the pcs of demand(S) / |S|

which is exact, needs no solver, and vectorizes across many blocks as one
matrix pass (see service/batch_predictor.py). ``port_bound_from_usage`` is
the shared entry point: closed form while the union closure stays small,
LP fallback beyond that — both the single-block reference predictor and the
batched service path route through it, so their numbers are identical.
"""
from __future__ import annotations

# Beyond this many distinct port combinations the union closure may blow up
# combinatorially; fall back to the LP. Both the reference predictor and the
# batch predictor apply the same rule per block, keeping them bit-identical.
CUT_COMBO_CAP = 12


def union_closure(combos, cap: int = 4096) -> list | None:
    """All distinct unions of the given port combinations, sorted smallest
    first — the candidate min-cut port sets. Returns None if the closure
    exceeds ``cap`` sets (caller should use the LP instead)."""
    closed: set = set()
    for pc in combos:
        pc = frozenset(pc)
        closed |= {pc} | {pc | s for s in closed}
        if len(closed) > cap:
            return None
    return sorted(closed, key=lambda s: (len(s), sorted(s)))


def cut_matrices(combos, candidates):
    """Integer matrices of the closed form, shared by the vectorized
    predictor backends (see ``service/batch_predictor.py``).

    Returns ``(mask, sizes)`` as numpy int32 arrays: ``mask[c, s] = 1``
    iff port combination ``combos[c]`` is contained in candidate cut set
    ``candidates[s]`` and ``sizes[s] = |candidates[s]|``.  With integer
    μop counts ``u`` (blocks × combos), ``demand = u @ mask`` is an exact
    integer matrix product, so the bound ``max_s demand[:, s]/sizes[s]``
    can be evaluated *exactly* on any backend: the winning candidate per
    block can be selected purely with integer cross-multiplication
    (``d1 * s2 > d2 * s1``) and only the final division performed in
    float64 — two candidates with equal rational ratios round to the same
    float, so the result is bit-identical to the scalar reference loop in
    :func:`cut_bound`."""
    import numpy as np

    mask = np.array([[1 if pc <= s else 0 for s in candidates]
                     for pc in combos], dtype=np.int32)
    sizes = np.array([len(s) for s in candidates], dtype=np.int32)
    return mask, sizes


def cut_bound(usage: dict, candidates=None) -> float:
    """Exact min-max port load via the min-cut closed form.

    ``candidates`` may be any superset of the unions of ``usage``'s port
    combinations (e.g. a model-wide closure shared across blocks): extra
    sets can never exceed the maximum, because shrinking a candidate to the
    union of the combinations it contains only increases its ratio."""
    usage = {pc: float(n) for pc, n in usage.items() if n > 0}
    if not usage:
        return 0.0
    if candidates is None:
        candidates = union_closure(usage)
        if candidates is None:  # pragma: no cover - guarded by caller's cap
            return throughput_lp(usage)
    best = 0.0
    for s in candidates:
        demand = 0.0
        for pc, n in usage.items():
            if pc <= s:
                demand += n
        best = max(best, demand / len(s))
    return best


def port_bound_from_usage(usage: dict, combo_cap: int = CUT_COMBO_CAP
                          ) -> float:
    """Port-pressure bound shared by the reference and batched predictors:
    the closed-form cut bound when few distinct combinations are involved
    (the common case), the LP otherwise."""
    distinct = [pc for pc, n in usage.items() if n > 0]
    if not distinct:
        return 0.0
    if len(distinct) > combo_cap:
        # canonical variable order: the LP result must not depend on dict
        # insertion order (in-memory vs artifact-loaded models)
        return throughput_lp(dict(sorted(usage.items(),
                                         key=lambda kv: sorted(kv[0]))))
    return cut_bound(usage)


def throughput_lp(usage: dict, ports=None) -> float:
    """``usage``: {frozenset(ports): uop_count}. Returns min-max port load
    (= Intel-definition throughput, Def. 1, for divider-free instructions)."""
    usage = {pc: float(n) for pc, n in usage.items() if n > 0}
    if not usage:
        return 0.0
    all_ports = sorted(set().union(*usage)) if ports is None else list(ports)
    try:
        return _scipy_lp(usage, all_ports)
    except ImportError:  # pragma: no cover
        return _bisect_flow(usage, all_ports)


def _scipy_lp(usage: dict, ports: list) -> float:
    import numpy as np
    from scipy.optimize import linprog

    pcs = list(usage)
    # variables: f(p, pc) for p in pc (flattened), then z
    var_idx = {}
    for pc in pcs:
        for p in pc:
            var_idx[(p, pc)] = len(var_idx)
    nz = len(var_idx)
    c = np.zeros(nz + 1)
    c[nz] = 1.0  # minimize z
    # equality: sum_p f(p,pc) = mu
    A_eq = np.zeros((len(pcs), nz + 1))
    b_eq = np.zeros(len(pcs))
    for i, pc in enumerate(pcs):
        for p in pc:
            A_eq[i, var_idx[(p, pc)]] = 1.0
        b_eq[i] = usage[pc]
    # inequality: sum_pc f(p,pc) - z <= 0
    A_ub = np.zeros((len(ports), nz + 1))
    for j, p in enumerate(ports):
        for pc in pcs:
            if p in pc:
                A_ub[j, var_idx[(p, pc)]] = 1.0
        A_ub[j, nz] = -1.0
    res = linprog(c, A_ub=A_ub, b_ub=np.zeros(len(ports)), A_eq=A_eq,
                  b_eq=b_eq, bounds=[(0, None)] * (nz + 1), method="highs")
    if not res.success:  # pragma: no cover
        raise RuntimeError(f"LP failed: {res.message}")
    return float(res.x[nz])


def _bisect_flow(usage: dict, ports: list, tol: float = 1e-6) -> float:
    """Feasibility of makespan z == max-flow saturation in the bipartite
    graph pc -> ports with port capacity z."""
    import networkx as nx

    total = sum(usage.values())
    lo, hi = 0.0, float(total)

    def feasible(z: float) -> bool:
        g = nx.DiGraph()
        for i, (pc, mu) in enumerate(usage.items()):
            g.add_edge("s", f"c{i}", capacity=mu)
            for p in pc:
                g.add_edge(f"c{i}", f"p{p}", capacity=mu)
        for p in ports:
            g.add_edge(f"p{p}", "t", capacity=z)
        val = nx.maximum_flow_value(g, "s", "t")
        return val >= total - 1e-9

    for _ in range(60):
        mid = (lo + hi) / 2
        if feasible(mid):
            hi = mid
        else:
            lo = mid
        if hi - lo < tol:
            break
    return hi
