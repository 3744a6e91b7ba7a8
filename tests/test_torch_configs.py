"""The port's architecture configs are the reference's, field by field.

Every ``repro_torch.configs.<id>`` holds the same ``CONFIG`` and
``SMOKE_CONFIG`` as ``repro.configs.<id>``: every dataclass field equal,
dtypes compared by name (``jnp.float32`` against ``torch.float32``), and
the derived widths and parameter counts equal.  ``load_config`` finds every
architecture id, in its dashed and dotted spellings too."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as rb
from repro_torch.configs import base as pb

DTYPE_NAMES = {jnp.float32: "float32", jnp.bfloat16: "bfloat16",
               torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _plain(cfg):
    """The config's fields with dtypes as names."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = DTYPE_NAMES.get(v, v)
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", rb.ARCH_IDS)
def test_config_equals_the_reference(arch, smoke):
    want = rb.load_config(arch, smoke=smoke)
    got = pb.load_config(arch, smoke=smoke)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert _plain(got) == _plain(want)
    for dt in (got.param_dtype, got.compute_dtype):
        assert isinstance(dt, torch.dtype)
    for prop in ("vocab_padded", "d_inner", "ssm_heads", "q_dim", "kv_dim"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_field_list_and_tables_equal_the_reference():
    assert ([f.name for f in dataclasses.fields(pb.ModelConfig)]
            == [f.name for f in dataclasses.fields(rb.ModelConfig)])
    assert pb.ARCH_IDS == rb.ARCH_IDS
    assert pb.VOCAB_ALIGN == rb.VOCAB_ALIGN
    assert pb.LONG_CONTEXT_ARCHS == rb.LONG_CONTEXT_ARCHS
    assert ({k: dataclasses.astuple(v) for k, v in pb.SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in rb.SHAPES.items()})
    assert pb.all_cells() == rb.all_cells()
    assert pb.runnable_cells() == rb.runnable_cells()


@pytest.mark.parametrize("arch", rb.ARCH_IDS)
def test_load_config_finds_every_arch(arch):
    cfg = pb.load_config(arch)
    assert _plain(cfg) == _plain(rb.load_config(arch))
    dotted = cfg.name.split("-a")[0] if "moe" in cfg.family else cfg.name
    for spelling in (arch.replace("_", "-"), dotted):
        assert pb.load_config(spelling) == cfg, spelling
    assert pb.cell_is_runnable(arch, "long_500k") == \
        rb.cell_is_runnable(arch, "long_500k")
