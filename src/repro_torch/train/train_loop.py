"""Training step factory: loss and gradients by autograd + microbatch
gradient accumulation + AdamW.

The port of the reference package's ``repro.train.train_loop``.  The
reference builds one jittable function from ``jax.value_and_grad``; the
port runs ``model.loss`` and ``torch.autograd.grad`` eagerly (the layer
bodies' activation checkpointing is ``cfg.remat``, see
``models/transformer.py:_remat``).  Gradient accumulation bounds
activation memory: ``num_microbatches`` forward/backward passes, their
gradients summed in f32 and divided by the count, one optimizer update.

On a mesh the parameters are DTensors and autograd returns DTensor
gradients; one that comes back partial (a replicated weight used on each
batch rank's own tokens) or otherwise placed is redistributed to its
parameter's placements before the update, which sums it over the mesh.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import replicated
from repro_torch.optim import adamw


def _split(x, n: int):
    """The reference's microbatch split: ``reshape(b // n, n, ...)`` then
    ``moveaxis(1, 0)``, so microbatch ``i`` holds rows ``i, i + n, ...``
    (strided, not contiguous)."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} % microbatches {n} != 0")
    return x.reshape(b // n, n, *x.shape[1:]).movedim(1, 0)


def _nest(names, values) -> dict:
    """``{"layers.attn.wq": v}`` pairs as the nested dict of the parameter
    tree."""
    out: dict = {}
    for name, v in zip(names, values):
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def make_train_step(model, opt_cfg: adamw.AdamWConfig,
                    num_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``params`` is ``model`` itself (its parameters are updated
    in place); ``batch`` leaves have leading dim global_batch, which must
    be divisible by ``num_microbatches``.  Turns the model's gradients on.

    With one microbatch ``metrics`` holds the model's loss metrics plus
    ``loss``, ``grad_norm`` and ``lr``; with more, only ``ce`` (the mean
    of the microbatches' losses), ``loss``, ``grad_norm`` and ``lr``, as
    in the reference.  Every value is a 0-d tensor on the model's device.
    """
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    n = num_microbatches

    def placed(g, p):
        if isinstance(p, DTensor) and tuple(g.placements) != \
                tuple(p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g

    def grad_fn(mb):
        loss, metrics = model.loss(mb)
        grads = torch.autograd.grad(loss, params)
        return (loss.detach(), metrics,
                [placed(g, p) for g, p in zip(grads, params)])

    def train_step(params_, opt_state, batch):
        if params_ is not model:
            raise ValueError("train_step updates its own model: pass it as "
                             "params")
        if n == 1:
            loss, metrics, grads = grad_fn(batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            mbs = {k: _split(v, n) for k, v in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                   for p in params]
            lsum = replicated(torch.zeros((), dtype=torch.float32,
                                          device=model.device), params[0])
            for i in range(n):
                l, _, g = grad_fn({k: v[i] for k, v in mbs.items()})
                acc = [a + gg.to(torch.float32) for a, gg in zip(acc, g)]
                lsum = lsum + l
            grads = [a / n for a in acc]
            loss = lsum / n
            metrics = {"ce": loss}
        _, opt_state, om = adamw.apply_update(model, _nest(names, grads),
                                              opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(om)
        return model, opt_state, metrics

    return train_step
