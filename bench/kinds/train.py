"""Training steps back to back: ``train/train_loop.py:make_train_step``
with ``optim/adamw.py`` over batches of ``data/pipeline.py``.

Set-up builds the one step object (model, AdamW state) and drives it
through its first ``check_steps`` steps on the stream's first batches;
the window continues with the same object.  Those first steps give the
program's readings: each step's loss, each leaf's first gradient as the
optimizer got it (clipped, from AdamW's first moment after one step) and
each leaf's change after the check steps.  The plain reference repeats the
check steps from the same weights on rows the benchmark made itself.

Once the window has closed, the same object takes one more step through
the window's own call (the late step), its weights and AdamW moments
copied to the host first: the reference replays that step from the copy,
so a path that changes after warm-up is compared too (``late_*``).
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from bench import counts
from bench import traffic as T
from bench.reference import common as C


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def setup(cell):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step

    tr = cell.traffic
    cell.opt = adamw.AdamWConfig(**tr["adamw"])
    cell.step = make_train_step(cell.model, cell.opt, tr["microbatches"])
    cell.opt_state = adamw.init_state(cell.model)
    cell.data = SyntheticTokens(
        cell.cfg, ShapeSpec(cell.name, tr["seq_len"], tr["batch"], "train"),
        DataConfig(seed=cell.seed, vocab_size=cell.cfg_json["vocab_size"]),
        device=cell.device)
    cell.next_step = 0
    losses = []
    for i in range(tr["check_steps"]):
        losses.append(float(unit(cell)["loss"]))
        if i == 0:
            b1 = cell.opt.b1
            cell.prog_grad = {n: float(torch.linalg.vector_norm(
                m.double())) / (1 - b1)
                for n, m in _flat(cell.opt_state.mu).items()}
    cell.prog_loss = losses
    cell.prog_change = _changes(cell.model.state_dict(), cell)


def _changes(params: dict, cell) -> dict:
    """Each leaf's norm of its change from the seed's weights."""
    out = {}
    for name in cell.specs:
        p0 = C.make_leaf(cell.specs, name, cell.seed, cell.device)
        out[name] = float(torch.linalg.vector_norm(
            (params[name].detach().float() - p0).double()))
        del p0
    return out


def unit(cell):
    batch = cell.data.batch_at(cell.next_step)
    cell.next_step += 1
    _, cell.opt_state, metrics = cell.step(cell.model, cell.opt_state, batch)
    cell.sync()
    return metrics


def window(cell, seconds: float) -> dict:
    tr = cell.traffic
    lat, failed, k = [], 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        loss = unit(cell)["loss"]
        te = time.perf_counter()
        lat.append(te - ts)
        failed += int(not torch.isfinite(loss))
        k += 1
        if te - t0 >= seconds:
            break
    return {"seconds": te - t0, "units": k, "attempted": k,
            "failed": failed, "tokens": k * tr["batch"] * tr["seq_len"],
            "latencies_s": lat,
            "flops": k * counts.train_flops(
                cell.cfg_json, tr["batch"], tr["seq_len"])}


def _diff_norm(a, b) -> float:
    """The float64 norm of ``a - b``, ``b`` on any device, a slice of the
    leading dimension at a time (a stacked leaf's temporaries fit beside
    the program's state)."""
    pairs = zip(a, b) if a.dim() >= 2 else [(a, b)]
    return math.sqrt(sum(float(torch.sum(
        (x.double() - y.to(x.device).double()) ** 2)) for x, y in pairs))


def late_step(cell) -> tuple:
    """The late step: the program's readings of one more step through the
    window's call ({"loss": [..], "change"} as the check steps'), and its
    state before the step, on the host, for the reference."""
    def host(t):
        return t.detach().float().to("cpu", copy=True)

    before = {"params": {n: host(p) for n, p in
                         cell.model.state_dict().items() if n in cell.specs},
              "mu": {n: host(t) for n, t in _flat(cell.opt_state.mu).items()},
              "nu": {n: host(t) for n, t in _flat(cell.opt_state.nu).items()},
              "step": int(cell.opt_state.step), "batch": cell.next_step}
    loss = float(unit(cell)["loss"])
    params = cell.model.state_dict()
    change = {n: _diff_norm(params[n].detach(), before["params"][n])
              for n in cell.specs}
    return {"loss": [loss], "change": change}, before


def _ref_step(cell, flat, mu, nu, step, batch_index, precision, rows):
    """One reference step from ``flat`` (updated in place with ``mu`` and
    ``nu``): the batch's mean loss over ``rows``, rows one at a time, then
    AdamW at ``step``; returns (loss, each leaf's clipped gradient norm)."""
    tr, cfg = cell.traffic, cell.cfg_json
    B, S = tr["batch"], tr["seq_len"]
    rows = range(B) if rows is None else rows
    batch = T.synthetic_batch(cell.seed, batch_index, B, S,
                              cfg["vocab_size"])
    params, total = C.nest(flat), 0.0
    for r in rows:
        tok = batch["tokens"][r:r + 1].to(cell.device)
        lbl = batch["labels"][r:r + 1].to(cell.device)
        loss = cell.reference.loss_sum(params, tok, lbl, cfg,
                                       precision) / (len(rows) * S)
        loss.backward()
        total += float(loss.detach())
    grads = {n: p.grad for n, p in flat.items()}
    norms = C.adamw_step(flat, grads, mu, nu, step, tr["adamw"])
    for p in flat.values():
        p.grad = None
    return total, norms


def reference_readings(cell, precision=C.EXACT, rows=None) -> dict:
    """The check steps on the plain reference from the seed's weights:
    {"loss": [...], "grad": {leaf: norm}, "change": {leaf: norm}}.
    ``rows`` (all by default) are the rows of each batch that take part,
    the loss their mean."""
    C.no_tf32()
    flat = C.make_weights(cell.specs, cell.seed, cell.device)
    for p in flat.values():
        p.requires_grad_(True)
    mu = {n: torch.zeros_like(p) for n, p in flat.items()}
    nu = {n: torch.zeros_like(p) for n, p in flat.items()}
    losses, grads0 = [], None
    for step in range(cell.traffic["check_steps"]):
        loss, norms = _ref_step(cell, flat, mu, nu, step + 1, step,
                                precision, rows)
        losses.append(loss)
        if step == 0:
            grads0 = norms
    del mu, nu
    return {"loss": losses, "grad": grads0, "change": _changes(flat, cell)}


def late_reference(cell, before: dict, precision=C.EXACT,
                   rows=None) -> dict:
    """The late step on the plain reference from the program's state
    before it (``late_step``'s), as ``reference_readings``."""
    C.no_tf32()
    dev = cell.device

    def load(t):
        return t.to(dev, copy=True)

    flat = {n: load(p).requires_grad_(True)
            for n, p in before["params"].items()}
    mu = {n: load(before["mu"][n]) for n in flat}
    nu = {n: load(before["nu"][n]) for n in flat}
    loss, norms = _ref_step(cell, flat, mu, nu, before["step"] + 1,
                            before["batch"], precision, rows)
    del mu, nu
    change = {n: _diff_norm(p.detach(), before["params"][n])
              for n, p in flat.items()}
    return {"loss": [loss], "grad": norms, "change": change}


def _worst_leaf(prog: dict, ref: dict, leaves) -> float:
    """The largest gap of two norms over ``leaves``, against the
    reference's norm of the leaf or of the median leaf, whichever is
    larger."""
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in leaves)


def _loss_gap(prog: dict, ref: dict) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                     ref["loss"]))


def _moving(ref: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others move by round-off alone."""
    med = statistics.median(ref["grad"].values())
    return [n for n in sorted(ref["grad"]) if ref["grad"][n] >= 1e-3 * med]


def compare(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the largest relative gap of a check step's loss;
    ``grad_gap`` and ``change_gap``: the worst leaf's gap of the first
    gradient's norm and, over the moving leaves, of the change's norm."""
    return {"loss_gap": _loss_gap(prog, ref),
            "grad_gap": _worst_leaf(prog["grad"], ref["grad"],
                                    sorted(ref["grad"])),
            "change_gap": _worst_leaf(prog["change"], ref["change"],
                                      _moving(ref))}


def program_readings(cell) -> dict:
    return {"loss": cell.prog_loss, "grad": cell.prog_grad,
            "change": cell.prog_change}


def late_numbers(prog: dict, ref: dict) -> dict:
    """The late step's loss and change gaps, as ``compare``'s.  Its
    gradient is not compared: no fault read at the cell's size reaches ten
    times the program's gap there (``PERF.md``)."""
    return {"late_loss_gap": _loss_gap(prog, ref),
            "late_change_gap": _worst_leaf(prog["change"], ref["change"],
                                           _moving(ref))}


def check(cell) -> dict:
    prog = program_readings(cell)
    late, before = late_step(cell)
    cell.free_program()
    cell.weights = None             # the program's, trained in place
    numbers = compare(prog, reference_readings(cell))
    numbers.update(late_numbers(late, late_reference(cell, before)))
    return numbers
