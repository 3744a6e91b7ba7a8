"""Carry a model's weights across from plain data.

The counterpart of :mod:`repro_torch.core.carry` for the model substrate:
:func:`params_from_reference` takes a parameter tree in the reference
package's layout — nested dicts of numpy arrays, as ``jax.tree.map(
np.asarray, model.init(rng))`` gives it — and loads it into the port's
model, so that both packages compute the same function on the same
weights.  The port keeps the reference's ``(in, out)`` weight layout and
stacked layer dimension and computes ``x @ w`` as it does, so the carry is
a copy with no transpose and bf16 rounding follows the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import build_model, flatten_tree


def _tensor(a) -> torch.Tensor:
    """A numpy array (or array-like) as a torch tensor; bfloat16 arrays
    (numpy's extension dtype) are carried bit for bit through uint16."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(cfg: ModelConfig, tree: dict, *, device="cuda",
                          axes=None, mesh=None):
    """The port's model for ``cfg`` with its parameters copied from
    ``tree`` onto ``device``.  The tree must hold exactly the model's
    parameter paths, each with the model's shape and ``cfg.param_dtype``;
    anything else raises.  With an enabled ``axes`` the model is built on
    ``mesh`` and the parameters placed by ``param_pspecs`` (rank 0's
    tree)."""
    model = build_model(cfg, axes, mesh, device="meta")
    flat = {k: _tensor(v) for k, v in flatten_tree(tree).items()}
    for name, p in model.named_parameters():
        if name in flat and flat[name].dtype != p.dtype:
            raise ValueError(f"{name}: dtype {flat[name].dtype}, the model "
                             f"holds {p.dtype}")
    model.load_state_dict({k: v.to(device) for k, v in flat.items()},
                          strict=True, assign=True)
    return model.place()
