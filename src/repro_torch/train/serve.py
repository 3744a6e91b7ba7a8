"""Serving: prefill + single-token decode step + sampling.

The port of the reference package's ``repro.train.serve``.  The model
holds its parameters, so the functions take no params argument; sampling
is greedy by default, and categorical sampling draws from an explicit
``torch.Generator`` (on the logits' device).
"""
from __future__ import annotations

import torch

from repro_torch.obs import tracer as obs


def make_serve_step(model, sample: str = "greedy", temperature: float = 1.0):
    """serve_step(state, tokens, generator=None) -> (next_tokens, logits,
    state).

    ``tokens``: (B,) int32 current tokens; state from prefill (or shaped
    like ``decode_state_specs``).  ``generator`` is read only by
    ``sample="categorical"``.
    """

    def serve_step(state, tokens, generator=None):
        logits, state = model.decode_step(state, tokens)
        if sample == "greedy":
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            nxt = nxt.to(torch.int32)
        return nxt, logits, state

    return serve_step


def make_prefill(model):
    def prefill(batch, pad_to: int | None = None):
        with obs.span("serve.prefill", tokens=batch["tokens"].numel()):
            return model.prefill(batch, pad_to=pad_to)

    return prefill


def generate(model, batch, steps: int, generator=None, temperature=0.0):
    """Eager helper: prefill then decode ``steps`` tokens; (B, steps)
    int32 ids, the first from the prefill's logits."""
    serve_step = make_serve_step(
        model, "greedy" if temperature == 0 else "categorical", temperature)
    S = batch["tokens"].shape[1]
    logits, state = model.prefill(batch, pad_to=S + steps + 8)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        tok, logits, state = serve_step(state, tok, generator)
        out.append(tok)
    return torch.stack(out, dim=1)  # (B, steps)
