"""Three-term roofline analysis from the dry run's records.

The port of the reference package's ``repro.analysis.roofline``.  Per
(arch × shape × mesh), using the H100 SXM's constants (``core/uarch.py``
``H100_SXM``) in place of the TPU v5e's:

    compute_term    = FLOPs_per_device / peak_bf16_flops
    memory_term     = bytes_accessed_per_device / hbm_bw
    collective_term = wire_bytes_per_device / link_bw

(the dry run counts on each device's local shards, so dividing by
per-GPU peaks is the prompt's ``global / (chips × peak)``).  The analytic
counters (``attn_flops_forward``, ``model_flops``, ``decode_state_bytes``,
``model_bytes``) are the reference's, unchanged.

The link: the reference assumes one ICI link a chip.  An H100 mesh has
two: NVLink 4 inside an 8-GPU node (``nvlink_bw``, 450e9 B/s each way)
and NDR InfiniBand between nodes (``ib_bw``, 50e9 B/s a GPU).  A
collective's wire bytes divide by the slowest link its group crosses: a
group whose ranks lie in one node stays on NVLink, any other crosses IB.
The port's records split the wire bytes by link (``collective_links``,
from :mod:`repro_torch.launch.dryrun`); a record without that split (the
reference's) is divided by IB throughout.  On the row-major (16, 16)
production mesh both the ``data`` groups (stride 16) and the ``model``
groups (16 consecutive ranks, two nodes) cross IB.

Methodology caveats: "bytes accessed" counts unfused operand+result
traffic of every local op, an upper bound on real HBM traffic after
fusion; FLOPs are ``torch.utils.flop_counter``'s (matrix products,
convolutions, attention), where XLA's ``cost_analysis`` also counts
elementwise work.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      load_config)
from repro_torch.core.uarch import H100_SXM

DRYRUN_DIR = (Path(__file__).resolve().parents[3] / "experiments" /
              "dryrun_torch")


def attn_flops_forward(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Full-attention score+value FLOPs, forward, causal-halved."""
    if cfg.num_heads == 0:
        return 0.0
    per_layer = 2 * 2 * batch * seq * seq * cfg.num_heads * cfg.head_dim / 2
    if cfg.family in ("dense", "vlm", "moe"):
        layers = cfg.num_layers
    elif cfg.family == "hybrid":
        layers = cfg.num_layers // cfg.attn_every
    elif cfg.family == "encdec":
        enc = 2 * 2 * batch * cfg.num_audio_frames ** 2 * cfg.num_heads * cfg.head_dim
        cross = 2 * 2 * batch * seq * cfg.num_audio_frames * cfg.num_heads * cfg.head_dim
        return cfg.num_layers * enc + cfg.num_decoder_layers * (per_layer + cross)
    else:
        layers = 0
    return layers * per_layer


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic useful FLOPs per step (global): 6ND (train) / 2ND (prefill)
    / 2N per token (decode), plus the attention term."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6 * n * toks + 3 * attn_flops_forward(cfg, shape.global_batch,
                                                     shape.seq_len)
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2 * n * toks + attn_flops_forward(cfg, shape.global_batch,
                                                 shape.seq_len)
    # decode: one token per sequence; attention reads the whole cache
    flops = 2 * n * shape.global_batch
    if cfg.num_heads:
        stack = (cfg.num_layers if cfg.family in ("dense", "vlm", "moe")
                 else cfg.num_layers // cfg.attn_every
                 if cfg.family == "hybrid" else cfg.num_decoder_layers)
        flops += (2 * 2 * shape.global_batch * shape.seq_len *
                  cfg.num_kv_heads * cfg.head_dim * stack)
    return flops


def decode_state_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """KV-cache + SSM-state bytes (global) — the decode memory floor."""
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    if cfg.num_heads:
        stack = (cfg.num_layers if cfg.family in ("dense", "vlm", "moe")
                 else cfg.num_layers // cfg.attn_every
                 if cfg.family == "hybrid" else cfg.num_decoder_layers)
        total += 2 * stack * B * S * cfg.num_kv_heads * cfg.head_dim * 2
    if cfg.ssm_state:
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        total += cfg.num_layers * B * (
            cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state
            + (cfg.ssm_conv - 1) * conv_ch) * 2
    return total


def model_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic HBM-traffic floor per step (global), for the fair roofline
    fraction of memory-bound cells:

      train:   6 × param bytes (fwd read + bwd read + grad/opt update)
               + 4 × activation-residual traffic (write + re-read, fwd+bwd)
      prefill: param read + KV write + 2 × activations
      decode:  active-param read + full decode-state read (the floor that
               dominates at long context)
    """
    p_bytes = cfg.param_count() * 4.0  # fp32 master weights
    d = cfg.d_model
    toks = shape.global_batch * shape.seq_len
    layers = cfg.num_layers + (cfg.num_decoder_layers or 0)
    act = toks * d * 2.0 * layers  # bf16 residual stream per layer
    if shape.kind == "train":
        return 6 * p_bytes + 4 * act
    if shape.kind == "prefill":
        kv = decode_state_bytes(cfg, shape)
        return cfg.active_param_count() * 2.0 + kv + 2 * act
    return (cfg.active_param_count() * 2.0 +
            decode_state_bytes(cfg, shape))


def load_records(dryrun_dir: Path = DRYRUN_DIR, variant: str = "cost",
                 mesh: str = "single", tag: str = "") -> dict:
    out = {}
    for f in sorted(Path(dryrun_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("variant") != variant or rec.get("mesh") != mesh:
            continue
        if rec.get("tag", "") != tag:
            continue
        out[(rec["arch"], rec["shape"])] = rec
    return out


def collective_seconds(rec: dict, hw: dict = H100_SXM) -> float:
    """The record's wire bytes over the links they cross (every byte over
    IB when the record does not split them by link)."""
    links = rec.get("collective_links")
    if links is None:
        return rec.get("collectives", {}).get("total_wire_bytes", 0.0) / \
            hw["ib_bw"]
    return (links.get("nvlink", 0.0) / hw["nvlink_bw"] +
            links.get("ib", 0.0) / hw["ib_bw"])


def roofline(rec: dict, chips: int = 256) -> dict | None:
    """The three terms (seconds) + bottleneck for one dry-run record."""
    if not rec.get("ok"):
        return None
    ca = rec.get("cost_analysis", {})
    flops_dev = ca.get("flops", 0.0)
    bytes_dev = ca.get("bytes accessed", 0.0)
    hw = H100_SXM
    compute_s = flops_dev / hw["peak_bf16_flops"]
    memory_s = bytes_dev / hw["hbm_bw"]
    coll_s = collective_seconds(rec, hw)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    cfg = load_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    mf = model_flops(cfg, shape)
    mb = model_bytes(cfg, shape)
    hlo_global = flops_dev * chips
    bound = max(terms.values())
    # ideal step time: the analytically-necessary work on the dominant
    # resource (compute floor OR traffic floor, whichever binds)
    ideal_s = max(mf / (chips * hw["peak_bf16_flops"]),
                  mb / (chips * hw["hbm_bw"]))
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "model_flops": mf, "model_bytes": mb,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "bound_s": bound,
        "ideal_s": ideal_s,
        # roofline fraction (the §Perf score): necessary-work time on the
        # binding resource vs the achieved bound
        "roofline_fraction": ideal_s / bound if bound else 0.0,
        "collectives": rec.get("collectives", {}).get("wire_bytes", {}),
        "memory_analysis": rec.get("memory_analysis", {}),
    }


def full_table(variant: str = "cost", mesh: str = "single", tag: str = "",
               chips: int = 256, dryrun_dir: Path = DRYRUN_DIR) -> list[dict]:
    recs = load_records(dryrun_dir, variant=variant, mesh=mesh, tag=tag)
    rows = []
    for (arch, shape), rec in sorted(recs.items()):
        r = roofline(rec, chips)
        if r:
            rows.append(r)
    return rows


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| useful FLOP ratio | roofline frac |\n|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.3f} | "
            f"{r['roofline_fraction']:.4f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    variant = sys.argv[1] if len(sys.argv) > 1 else "cost"
    tag = sys.argv[2] if len(sys.argv) > 2 else ""
    print(markdown_table(full_table(variant=variant, tag=tag)))
