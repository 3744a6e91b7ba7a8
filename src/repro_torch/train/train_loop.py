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
A microbatch whose rows do not divide over the model's batch axes (256
rows in 16 microbatches over (pod, data) = 32 ranks) runs over the inner
batch axes that its rows divide over, replicated over the outer ones, as
XLA's padded shards spread it: one row a device either way.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import axis_size, placements, replicated
from repro_torch.obs import tracer as obs
from repro_torch.optim import adamw


def _split(x, n: int):
    """The reference's microbatch split: ``reshape(b // n, n, ...)`` then
    ``moveaxis(1, 0)``, so microbatch ``i`` holds rows ``i, i + n, ...``
    (strided, not contiguous)."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} % microbatches {n} != 0")
    return x.reshape(b // n, n, *x.shape[1:]).movedim(1, 0)


def _microbatch_axes(axes, mesh, rows: int):
    """``axes`` with its batch axes cut, outermost first, to those that
    ``rows`` divides over."""
    batch = list(axes.batch)
    while batch and rows % axis_size(mesh, tuple(batch)):
        batch.pop(0)
    return axes.replace(batch=tuple(batch))


@contextlib.contextmanager
def _batch_axes(model, axes):
    """``model`` runs with ``axes`` inside (forward and the backward's
    recomputation both read ``model.axes``)."""
    kept, model.axes = model.axes, axes
    try:
        yield
    finally:
        model.axes = kept


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

    def grad_fn(mb, i: int = 0):
        loss, metrics = model.loss(mb)
        with obs.span("train.backward", microbatch=i):
            grads = torch.autograd.grad(loss, params)
        return (loss.detach(), metrics,
                [placed(g, p) for g, p in zip(grads, params)])

    def train_step(params_, opt_state, batch):
        if params_ is not model:
            raise ValueError("train_step updates its own model: pass it as "
                             "params")
        with obs.span("train.step", tokens=batch["tokens"].numel()):
            return _step(opt_state, batch)

    def _step(opt_state, batch):
        if n == 1:
            loss, metrics, grads = grad_fn(batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            mb_axes = model.axes
            if mb_axes.enabled:
                rows = next(iter(batch.values())).shape[0] // n
                mb_axes = _microbatch_axes(mb_axes, model.mesh, rows)
                if mb_axes != model.axes:   # the rows over those axes only
                    batch = {k: v.redistribute(model.mesh, placements(
                        model.mesh, (mb_axes.bspec,), v.dim()))
                        if isinstance(v, DTensor) else v
                        for k, v in batch.items()}
            mbs = {k: _split(v, n) for k, v in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                   for p in params]
            lsum = replicated(torch.zeros((), dtype=torch.float32,
                                          device=model.device), params[0])
            for i in range(n):
                with _batch_axes(model, mb_axes):
                    l, _, g = grad_fn({k: v[i] for k, v in mbs.items()}, i)
                acc = [a + gg.to(torch.float32) for a, gg in zip(acc, g)]
                lsum = lsum + l
            grads = [a / n for a in acc]
            loss = lsum / n
            metrics = {"ce": loss}
        with obs.span("optim.adamw"):
            _, opt_state, om = adamw.apply_update(
                model, _nest(names, grads), opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(om)
        return model, opt_state, metrics

    return train_step
