"""Corpus accuracy scoring: MAPE, Kendall-τ and error buckets per uarch.

The port of the reference package's ``repro/corpus/score.py``, numpy only
and unchanged: the accuracy artifact is a pure function of the results.

The quantities the downstream-tool literature reports (uiCA, PALMED,
BHive — see PAPERS.md): mean absolute percentage error of predicted vs
measured cycles, rank correlation (Kendall τ-b, the tie-aware variant —
exact, computed in chunked numpy so 10k-block corpora stay cheap), and a
relative-error histogram with per-family drill-downs plus the worst
offenders (the blocks a fidelity PR should look at first).

Everything here is deterministic and timestamp-free: scoring the same
results twice yields byte-identical JSON, which is what the CI
determinism gate and the served-vs-in-process byte-identity check rely
on.
"""
from __future__ import annotations

import numpy as np

#: relative-error histogram edges (fractions) and their report labels
BUCKET_EDGES = (0.01, 0.05, 0.10, 0.25)
BUCKET_LABELS = ("<1%", "1-5%", "5-10%", "10-25%", ">25%")


def mape(pred, true) -> float:
    """Mean absolute percentage error, skipping zero-measured entries."""
    p = np.asarray(pred, dtype=np.float64)
    t = np.asarray(true, dtype=np.float64)
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch {p.shape} vs {t.shape}")
    ok = t != 0
    if not ok.any():
        return 0.0
    return float(np.mean(np.abs(p[ok] - t[ok]) / np.abs(t[ok])))


def kendall_tau(a, b, *, chunk: int = 256) -> float:
    """Exact Kendall τ-b (tie-aware) of two equal-length sequences.

    Chunked O(n²) in numpy: pairwise sign agreement is computed a few
    hundred rows at a time against the full vector, so memory stays at
    ``chunk × n`` while 10k-element corpora take seconds, not minutes."""
    x = np.asarray(a, dtype=np.float64)
    y = np.asarray(b, dtype=np.float64)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")
    n = x.size
    if n < 2:
        return 1.0
    nc = nd = 0
    for i0 in range(0, n - 1, chunk):
        i1 = min(i0 + chunk, n - 1)
        rows = np.arange(i0, i1)
        dx = np.sign(x[None, :] - x[rows, None])
        dy = np.sign(y[None, :] - y[rows, None])
        upper = np.arange(n)[None, :] > rows[:, None]  # pairs with j > i
        s = dx * dy
        nc += int(np.count_nonzero((s > 0) & upper))
        nd += int(np.count_nonzero((s < 0) & upper))
    n0 = n * (n - 1) // 2

    def tie_term(v) -> int:
        _, counts = np.unique(v, return_counts=True)
        return int(np.sum(counts * (counts - 1) // 2))

    n1, n2 = tie_term(x), tie_term(y)
    denom = np.sqrt(float(n0 - n1) * float(n0 - n2))
    if denom == 0:
        return 1.0 if nc == nd else 0.0
    return float((nc - nd) / denom)


def error_buckets(pred, true) -> dict:
    """Relative-error histogram: label -> count (zero-measured entries are
    counted in the widest bucket only if the prediction is also
    nonzero)."""
    p = np.asarray(pred, dtype=np.float64)
    t = np.asarray(true, dtype=np.float64)
    rel = np.where(t != 0, np.abs(p - t) / np.maximum(np.abs(t), 1e-300),
                   np.where(p != 0, np.inf, 0.0))
    idx = np.searchsorted(np.asarray(BUCKET_EDGES), rel, side="right")
    return {lab: int(np.count_nonzero(idx == k))
            for k, lab in enumerate(BUCKET_LABELS)}


def score_pairs(pred, true, *, families=None, records=None,
                worst_k: int = 10) -> dict:
    """Full score dict for one uarch's (predicted, measured) pairs.

    ``families`` (one label per pair) adds the per-family drill-down;
    ``records`` (the corpus records, same order) adds the worst-offender
    list."""
    p = np.asarray(pred, dtype=np.float64)
    t = np.asarray(true, dtype=np.float64)
    out = {"n": int(p.size),
           "mape": round(mape(p, t), 6),
           "kendall_tau": round(kendall_tau(p, t), 6),
           "buckets": error_buckets(p, t)}
    if families is not None:
        fams: dict[str, dict] = {}
        labels = np.asarray(families)
        for fam in sorted(set(families)):
            m = labels == fam
            fams[fam] = {"n": int(np.count_nonzero(m)),
                         "mape": round(mape(p[m], t[m]), 6),
                         "kendall_tau": round(kendall_tau(p[m], t[m]), 6)}
        out["families"] = fams
    if records is not None and p.size:
        rel = np.where(t != 0, np.abs(p - t) / np.maximum(np.abs(t), 1e-300),
                       0.0)
        order = np.argsort(-rel, kind="stable")[:worst_k]
        out["worst"] = [
            {"id": records[i]["id"], "family": records[i]["family"],
             "block": records[i]["block"],
             "predicted": float(p[i]), "measured": float(t[i]),
             "rel_err": round(float(rel[i]), 6)} for i in order]
    return out


def score_results(results: dict, *, worst_k: int = 10) -> dict:
    """Score an evaluation-results dict (see ``repro_torch.corpus.evaluate``)
    into the accuracy artifact: per-uarch scores + the corpus identity it
    was computed over. Purely a function of the results — no timestamps,
    no paths — so equal inputs give byte-identical JSON."""
    out = {"corpus_id": results["corpus_id"], "spec": results["spec"],
           "uarches": {}}
    for ua in sorted(results["uarches"]):
        rows = results["uarches"][ua]
        out["uarches"][ua] = score_pairs(
            [r["predicted"] for r in rows], [r["measured"] for r in rows],
            families=[r["family"] for r in rows], records=rows,
            worst_k=worst_k)
    if "wave_stats" in results:
        out["wave_stats"] = results["wave_stats"]
    if "engine_stats" in results:
        out["engine_stats"] = results["engine_stats"]
    return out


def format_report(report: dict) -> str:
    """Human-readable accuracy tables for an artifact from
    :func:`score_results` (what ``scripts/analyze_torch.py
    --corpus-report`` prints)."""
    lines = [f"corpus {report['corpus_id'][:12]} — "
             f"{sum(u['n'] for u in report['uarches'].values())} blocks "
             f"across {len(report['uarches'])} uarches"]
    hdr = (f"{'uarch':<10} {'n':>7} {'MAPE':>8} {'tau':>7}  "
           + "  ".join(f"{lab:>7}" for lab in BUCKET_LABELS))
    lines += ["", hdr, "-" * len(hdr)]
    for ua, sc in sorted(report["uarches"].items()):
        buck = "  ".join(f"{sc['buckets'][lab]:>7}" for lab in BUCKET_LABELS)
        lines.append(f"{ua:<10} {sc['n']:>7} {sc['mape'] * 100:>7.2f}% "
                     f"{sc['kendall_tau']:>7.4f}  {buck}")
    for ua, sc in sorted(report["uarches"].items()):
        fams = sc.get("families")
        if not fams:
            continue
        lines += ["", f"{ua} by family:"]
        for fam, fsc in sorted(fams.items()):
            lines.append(f"  {fam:<14} n={fsc['n']:<6} "
                         f"MAPE={fsc['mape'] * 100:6.2f}%  "
                         f"tau={fsc['kendall_tau']:.4f}")
        worst = sc.get("worst") or []
        if worst:
            lines.append("  worst: " + ", ".join(
                f"{w['id']} ({w['rel_err'] * 100:.1f}%)"
                for w in worst[:5]))
    ws = report.get("wave_stats")
    if ws:
        lines += ["", f"waves: {ws.get('waves')} fused, "
                      f"mean width {ws.get('mean_wave_width')}, "
                      f"max width {ws.get('max_wave_width')}"]
    return "\n".join(lines)
