"""AdamW + global-norm clipping + schedules, in plain PyTorch.

The port of the reference package's ``repro.optim.adamw``, its own code
rather than ``torch.optim.AdamW`` (which clips, schedules, decays and
rounds differently).  The optimizer state is a tree mirroring the
parameters: ``mu`` and ``nu`` are nested dicts of f32 tensors with the
parameter tree's paths, on the parameters' device.  Every quantity is
computed in f32 tensors in the reference's order, so the two packages
agree to f32 rounding on the same gradients.

Two points are the reference's and kept:

* **decay** applies to every leaf with ``ndim >= 2``.  Layer stacks keep
  their leading ``(L, ...)`` dimension, so that includes the stacked norm
  weights ``ln1``/``ln2`` ``(L, d)`` and Mamba's ``A_log``/``D``/
  ``dt_bias`` ``(L, h)``; the unstacked ``ln_f`` is not decayed.
* **in place**: :func:`apply_update` writes the new parameters, ``mu`` and
  ``nu`` into the tensors it was given, under ``torch.no_grad()`` (the
  reference donates them: ``jax.jit(..., donate_argnums=(0, 1))``).  It
  still returns ``(params, state, metrics)``.

On a mesh the leaves are DTensors: ``mu`` and ``nu`` are placed as their
parameters, the step is a replicated 0-d DTensor, and the global norm is
taken over the whole sharded tensors (DTensor sums a shard's squares and
reduces the partial sums over the mesh), not over this rank's shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.models.sharding import replicated
from repro_torch.tree_util import tree_flatten, tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: dict
    nu: dict


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def init_state(params) -> AdamWState:
    """Zero moments for a parameter tree (a model or a nested dict), each
    placed as its parameter; the step replicated beside them."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    mu = tree_map(zeros, params)
    nu = tree_map(zeros, params)
    leaves = tree_leaves(params)
    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    return AdamWState(replicated(step, leaves[0]) if leaves else step, mu,
                      nu)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to min_lr_ratio (``step``: a 0-d
    tensor); an f32 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in tree order as the reference's Python ``sum`` does."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step, in place (see the module docstring).  ``params``:
    the model or a nested dict of tensors; ``grads``: a tree of the same
    paths (read, not written).  Returns (params, new_state, metrics) with
    ``grad_norm`` and ``lr`` as 0-d f32 tensors.

    Leaf by leaf, each intermediate is the reference's value (the same
    operation on the same operands, rounded once); the in-place forms only
    keep a leaf's temporaries to a few of its size."""
    g_leaves = [g.to(torch.float32) for g in tree_leaves(grads)]
    gn = global_norm(g_leaves)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    p_leaves, _ = tree_flatten(params)
    m_leaves, v_leaves = tree_leaves(state.mu), tree_leaves(state.nu)
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("params, grads and the optimizer state differ in "
                         "their leaves")
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        g = g * scale                                   # clipped
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = m / bc1                                 # mhat
        delta.div_((v / bc2).sqrt_().add_(cfg.eps))     # / (sqrt(vhat) + eps)
        p32 = p.to(torch.float32)
        if p.dim() >= 2:
            delta.add_(cfg.weight_decay * p32)
        delta.mul_(lr)
        if p32 is p:
            p.sub_(delta)
        else:
            p.copy_(p32 - delta)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gn,
                                                          "lr": lr}
