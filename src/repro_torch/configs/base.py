"""Configuration dataclasses for architectures and input shapes.

The port's copy of the reference's ``repro/configs/base.py``: every field,
default and derived property is the reference's, with the dtypes as torch
dtypes.  Every architecture has a module ``repro_torch.configs.<id>``
exporting ``CONFIG`` (the full-scale config) and ``SMOKE_CONFIG`` (a reduced
same-family config).  The op layer (``kernels/ops.py``) is driven at these
widths, and the models of ``repro_torch.models`` are built from them.  As
in the reference, ``attn_impl`` is read nowhere; the training and mesh
fields (``ce_impl``, ``remat``, ``train_microbatches``, ``embed_sharding``,
``bf16_all_reduce``) wait for those slices of the port.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any

import torch

VOCAB_ALIGN = 256  # pad embedding tables so vocab shards evenly & MXU-aligned


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # --- hybrid (zamba2-style): one shared attn+mlp block every k ssm layers
    attn_every: int = 0
    # --- enc-dec (whisper-style) ---
    num_decoder_layers: int = 0
    num_audio_frames: int = 1500  # encoder input length (frontend stub)
    # --- vlm (qwen2-vl-style) ---
    num_patch_tokens: int = 0  # patch embeddings prepended (frontend stub)
    mrope_sections: tuple[int, ...] = ()  # M-RoPE section split of head_dim/2
    # --- misc ---
    mlp_kind: str = "swiglu"  # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # attention implementation: "dense" (jnp, XLA-compiled; used for dry-runs
    # since Pallas/Mosaic only lowers for real TPUs) or "pallas" (TPU target).
    attn_impl: str = "dense"
    remat: str = "full"  # full | dots | none — activation checkpoint policy
    # cross-entropy implementation: "gather" (take_along_axis over the
    # model-sharded vocab; GSPMD inserts a full logits all-gather — the
    # measured baseline pathology) or "vocab_parallel" (shard_map with local
    # gold-logit extraction + psum'd softmax statistics).
    ce_impl: str = "gather"
    # SSD intra-chunk precision: fp32 (reference-faithful) or bf16 inputs
    # with fp32 state accumulation (the TPU-native mixed mode).
    ssd_dtype: str = "fp32"
    # gradient-accumulation microbatches for the train step (HBM fit)
    train_microbatches: int = 4
    # embedding-table sharding: "model_data" (vocab over model + ZeRO over
    # data; baseline) or "model_only" (pure vocab-TP: required for
    # vocab-parallel CE to avoid per-chunk data-axis table gathers)
    embed_sharding: str = "model_data"
    # decode layer loop: "scan" (lax.scan with the KV cache as stacked ys —
    # XLA double-buffers the cache) or "fori" (full cache as a while-loop
    # carry: in-place dynamic updates, single cache buffer)
    decode_loop: str = "scan"
    # query-chunk size for the HLO-level flash attention blocking
    attn_q_chunk: int = 1024
    # force bf16 tensor-parallel all-reduces: place an optimization barrier
    # after the TP matmul outputs so XLA's collective-promotion pass cannot
    # upcast the (B,S,D) all-reduces to fp32 (measured 2x wire on minitron)
    bf16_all_reduce: bool = False
    # Unroll lax.scan loops when lowering. XLA's cost_analysis counts a
    # while-loop body ONCE regardless of trip count (verified empirically),
    # so the roofline cost-compile unrolls; the memory/multi-pod compiles
    # keep scans for fast compilation. (The tiny SSD inter-chunk recurrence
    # stays scanned either way — its FLOPs are negligible; see DESIGN.md.)
    unroll_scans: bool = False

    @property
    def vocab_padded(self) -> int:
        v = self.vocab_size
        return (v + VOCAB_ALIGN - 1) // VOCAB_ALIGN * VOCAB_ALIGN

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer), for 6ND math."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mlp_kind == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        n = emb
        if self.family in ("dense", "vlm"):
            n += self.num_layers * (attn + mlp)
        elif self.family == "moe":
            n += self.num_layers * (attn + self.num_experts * mlp + d * self.num_experts)
        elif self.family == "ssm":
            n += self.num_layers * self._ssm_block_params()
        elif self.family == "hybrid":
            n += self.num_layers * self._ssm_block_params()
            n += attn + mlp  # one shared block
        elif self.family == "encdec":
            n += self.num_layers * (attn + mlp)  # encoder
            n += self.num_decoder_layers * (2 * attn + mlp)  # self+cross
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top-k of experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f if self.mlp_kind == "swiglu" else 2 * d * f
        dense = self.param_count() - self.num_layers * self.num_experts * mlp
        return dense + self.num_layers * self.experts_per_token * mlp

    def _ssm_block_params(self) -> int:
        d, di, n, g = self.d_model, self.d_inner, self.ssm_state, self.ssm_groups
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * g * n + h)
        conv = self.ssm_conv * (di + 2 * g * n)
        return in_proj + conv + 3 * h + di * d + di  # + A, D, dt_bias, out, norm


@dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """The released Zamba2 layout (transformers' ``Zamba2Config``;
    arXiv:2405.16712 eq. 6), built by ``models/transformer.py:Zamba2LM``.

    ``mem_blocks`` shared attention+MLP blocks are applied in turn before
    the Mamba2 layers at ``hybrid_layer_ids`` (application ``j`` runs block
    ``j % mem_blocks``).  An application reads ``RMSNorm([h ; e])`` (the
    residual stream beside the embedding output, ``2 * d_model`` wide,
    which is what q, k and v project from), gives its MLP's gate/up
    product a low-rank term of its own (``adapter_rank``) and its output a
    ``d_model``-square linear of its own; the result enters only the next
    Mamba2 layer's input, not the residual.  The softmax scale is
    ``attn_scale_dim ** -0.5``; the Mamba2 layers normalise ``y * SiLU(z)``
    one of ``ssm_groups`` groups at a time and add a bias after the causal
    conv.  The positions are a list, so that they compare equal with a
    JSON list of the same positions.
    ``ModelConfig``'s own fields stay the reference's, and its families'
    configs are untouched by these."""
    hybrid_layer_ids: list = field(default_factory=list)
    mem_blocks: int = 2
    adapter_rank: int = 128
    attn_scale_dim: int = 0

    @property
    def attn_scale(self) -> float:
        return self.attn_scale_dim ** -0.5

    def param_count(self) -> int:
        d, f, r = self.d_model, self.d_ff, self.adapter_rank
        apps = len(self.hybrid_layer_ids)
        block = (2 * d * self.q_dim + 2 * 2 * d * self.kv_dim
                 + self.q_dim * d + 3 * d * f + 3 * d)
        # the Mamba2 layer's pre-norm and conv bias beside the base count
        layer = (self._ssm_block_params() + d
                 + self.d_inner + 2 * self.ssm_groups * self.ssm_state)
        n = self.vocab_padded * d * (1 if self.tie_embeddings else 2) + d
        return (n + self.num_layers * layer + self.mem_blocks * block
                + apps * (d * r + r * 2 * f + d * d))


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "minitron_8b",
    "qwen3_8b",
    "smollm_360m",
    "phi3_mini_3_8b",
    "qwen2_vl_2b",
    "zamba2_2_7b",
    "mamba2_2_7b",
    "whisper_medium",
    "phi3_5_moe_42b",
    "llama4_scout_17b",
]

# long_500k requires sub-quadratic sequence handling; pure full-attention
# archs skip it (documented in DESIGN.md §Arch-applicability).
LONG_CONTEXT_ARCHS = {"zamba2_2_7b", "mamba2_2_7b"}


def load_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def cell_is_runnable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if cell_is_runnable(a, s)]
