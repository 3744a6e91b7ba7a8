"""Closed-loop prefill: one client sends a batch of prompts, waits for the
program's last-position logits and decode state, and sends the next.

Timed path: ``train/serve.py:make_prefill`` over the model
(``BaseLM.prefill(batch, pad_to=)``), each batch timed on the host's
clock to its synchronisation.  ``correct`` compares, for a sample of the
window's batches drawn from the seed, every row's logits and decode state
with the plain float32 reference run on the same prompts and weights.
"""
from __future__ import annotations

import random
import time

import torch

from bench import counts
from bench import traffic as T
from bench.reference import common as C


def setup(cell):
    from repro_torch.train.serve import make_prefill

    tr = cell.traffic
    cell.pool = T.prompts(tr, cell.seed, cell.cfg_json["vocab_size"],
                          cell.device)
    cell.step = make_prefill(cell.model)
    cell.kept = []
    unit(cell)                       # every shape of the cell, twice
    unit(cell)


def unit(cell, k: int = 0):
    out = cell.step({"tokens": cell.pool[k % len(cell.pool)]},
                    pad_to=cell.traffic["pad_to"])
    cell.sync()
    return out


def window(cell, seconds: float) -> dict:
    """Batches back to back until ``seconds`` have passed; a reservoir
    sample (from the seed) of ``check_batches`` of them is kept."""
    tr = cell.traffic
    keep = tr["check_batches"]
    rng = random.Random(T.stream_seed(cell.seed, 2))
    lat, failed, k = [], 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        logits, state = unit(cell, k)
        te = time.perf_counter()
        lat.append(te - ts)
        failed += int((~torch.isfinite(logits)).any(dim=-1).sum())
        if k < keep:
            cell.kept.append((k, logits, state))
        else:
            j = rng.randrange(k + 1)
            if j < keep:
                cell.kept[j] = (k, logits, state)
        k += 1
        if te - t0 >= seconds:
            break
    window_s = te - t0
    rows = k * tr["batch"]
    return {"seconds": window_s, "units": k, "attempted": rows,
            "failed": failed, "tokens": rows * tr["prompt_len"],
            "latencies_s": lat,
            "flops": k * counts.prefill_flops(
                cell.cfg_json, tr["batch"], tr["prompt_len"])}


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a.float() - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp(min=1e-30))


def _state_err(prog: dict, ref: dict) -> float:
    """The worst relative error over the state's leaves, a layer (or an
    application of the shared block) at a time."""
    worst = 0.0
    for key, r in ref.items():
        if isinstance(r, dict):
            worst = max(worst, _state_err(prog[key], r))
            continue
        p = prog[key]
        if tuple(p.shape) != tuple(r.shape):
            return float("inf")
        for pl, rl in zip(p.flatten(0, -4).unbind(0),
                          r.flatten(0, -4).unbind(0)):
            worst = max(worst, _rel(pl, rl))
    return worst


def compare(kept, ref_fn) -> dict:
    """The numbers ``correct`` holds against its limits, over the kept
    batches: ``token_gap``, the widest gap by which the served (greedy)
    token's reference logit lies below the reference's best;
    ``logit_err``, the largest |program - reference| logit over the row's
    RMS; ``state_err``, the worst relative error of a decode-state
    leaf."""
    gap = lerr = rerr = serr = 0.0
    for k, logits, state in kept:
        r_logits, r_state = ref_fn(k)
        served = torch.argmax(logits, dim=-1)
        best = r_logits.max(dim=-1).values
        gap = max(gap, float((best - r_logits.gather(
            -1, served[:, None])[:, 0]).max()))
        rms = torch.sqrt(torch.mean(r_logits * r_logits, dim=-1))
        diff = logits.float() - r_logits
        lerr = max(lerr, float((diff.abs().amax(-1) / rms).max()))
        rerr = max(rerr, float((torch.sqrt(torch.mean(diff * diff, dim=-1))
                                / rms).max()))
        serr = max(serr, _state_err(state, r_state))
    return {"token_gap": gap, "logit_err": lerr, "logit_rms_err": rerr,
            "state_err": serr}


def reference(cell, k: int, precision=C.EXACT):
    """The plain reference's (logits, state) of the pool's batch ``k``."""
    C.no_tf32()
    with torch.no_grad():
        return cell.reference.prefill(
            C.nest(cell.weights), cell.pool[k % len(cell.pool)],
            cell.cfg_json, precision, cell.traffic["pad_to"])


def check(cell) -> dict:
    """The reference over the kept batches, after the program is freed."""
    cell.free_program()
    return compare(cell.kept, lambda k: reference(cell, k))
