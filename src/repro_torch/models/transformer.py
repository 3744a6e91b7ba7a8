"""Model families assembled from layers/moe/mamba, all config-driven.

The port of the reference package's ``repro.models.transformer``: the
families dense (+vlm), moe, ssm (mamba2), hybrid (zamba2) and encdec
(whisper).  Every family is an ``nn.Module`` whose parameters are the
reference's parameter tree (:class:`repro_torch.models.layers.ParamTree`:
the stacked layer dimension is kept, ``layers.attn.wq`` is
``(L, d, q_dim)``), with the reference's interface less the params
argument:

    init(generator) -> self                       # draws every parameter
    loss(batch) -> (scalar, metrics)              # training
    prefill(batch, pad_to=None) -> (last_logits, state)
    decode_step(state, tokens) -> (logits, state)  # 1 token, O(cache)
    decode_state_specs(batch, seq_len) -> meta tensors

Layer stacks loop over the stacked params (:func:`layers.xscan`).  The
decode state is a dict of tensors; ``pos`` is a 0-d int32 tensor on the
model's device, so a decode step never waits on the host.  A decode step
copies the stacked KV cache once and writes each layer's k/v row into that
copy in place, so the state it was given stays valid; the reference's
``cfg.decode_loop`` settings (``"scan"``, ``"fori"``) are accepted and
both run this one loop.

Training differentiates ``loss`` with autograd; the parameters take part
once ``requires_grad_(True)`` is called on the model.  Each layer body of
a training trunk, and each chunk of :func:`chunked_ce_loss`, runs under
``cfg.remat`` (:func:`_remat`); prefill and decode collect caches and
never differentiate, so they run their bodies plainly.

On a mesh (``build_model(cfg, axes, mesh)`` with ``axes.enabled``) every
parameter is a ``DTensor`` placed by ``model.param_pspecs``, and the entry
points (``loss``, ``prefill``, ``decode_step``) place their inputs by
``model.input_pspecs`` (``jit``'s ``in_shardings``); the layers' ``sc``
calls then constrain activations as the reference's do.  The values every
rank computes alike (positions, masks, zeros) enter as replicated
DTensors (:func:`sharding.replicated`).
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ShapeSpec, Zamba2Config
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SH
from repro_torch.models.sharding import SINGLE, MeshAxes, P, sc
from repro_torch.obs import tracer as obs

# products with no batch dimension (``x @ w`` reaches ``aten.mm``; the
# attention's batched einsums reach ``aten.bmm``)
_UNBATCHED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op in _UNBATCHED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_tp_out(ctx, op, *args, **kwargs):
    """``save_only_these_names("attn_out", "mlp_out")``: the outputs of
    :func:`layers.checkpoint_name`, which only those two tags reach."""
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.checkpoint_name.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICIES = {"dots": _save_dots, "tp_out": _save_tp_out}


def _remat(f, cfg: ModelConfig):
    """``f`` under the activation-checkpoint policy ``cfg.remat`` (the
    reference's ``jax.checkpoint`` settings), as
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:

    * ``"none"``: ``f`` itself; autograd keeps what the backward needs;
    * ``"full"``: keep ``f``'s inputs only, run ``f`` again in the
      backward (``jax.checkpoint(f)``);
    * ``"dots"``: keep the outputs of products with no batch dimension
      (``aten.mm``/``addmm``), recompute the rest
      (``dots_with_no_batch_dims_saveable``);
    * ``"tp_out"``: keep the outputs tagged ``attn_out``/``mlp_out`` by
      :func:`layers._tp_out`, recompute the rest
      (``save_only_these_names``).

    Every setting gives the same values and gradients; another value
    raises.  A trunk that collects serving caches runs its body plainly
    instead."""
    if cfg.remat == "none":
        return f
    if cfg.remat == "full":
        context_fn = None
    elif cfg.remat in _POLICIES:
        context_fn = partial(create_selective_checkpoint_contexts,
                             _POLICIES[cfg.remat])
    else:
        raise ValueError(f"unknown remat policy {cfg.remat!r}: none, full, "
                         "dots or tp_out")

    if context_fn is None:
        return partial(checkpoint, f, use_reentrant=False)
    return partial(checkpoint, f, use_reentrant=False, context_fn=context_fn)


def _positions(cfg: ModelConfig, B: int, S: int, offset=0, device=None):
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(B, S)
    if cfg.mrope_sections:
        # frontend stub: text-like ids on all three M-RoPE streams
        return pos[None].expand(3, B, S)
    return pos


def _angles(cfg: ModelConfig, positions):
    return L.rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.mrope_sections)


def _ce_chunk_gather(hc, lc, embed, axes: MeshAxes):
    """The loss of one sequence chunk: (sum of token losses, count of
    labelled tokens); ``lc < 0`` marks an unlabelled position.  The
    baseline: the gold logit is taken from logits gathered over the
    vocab's shards (:func:`_ce_chunk_vocab_parallel` avoids that)."""
    # the table whole over its d_model (the ZeRO gather): with the rows'
    # d_model sharded over the axes that shard the batch, DTensor's
    # cheapest plan for the einsum is to gather the batch and compute
    # every rank's (B, qc, V) logits in full
    if isinstance(embed, DTensor):
        embed = sc(SH.grad_placed_as_value(embed), axes, "model", None)
    logits = torch.einsum("bqd,vd->bqv", hc.to(torch.float32),
                          embed.to(torch.float32))
    logits = sc(logits, axes, "batch", None, "model")
    lse = torch.logsumexp(logits, dim=-1)
    mask = lc >= 0
    lbl = torch.where(mask, lc, 0).long()
    # torch.gather has no working sharding rule for logits sharded on the
    # vocab (DTensor's masked-partial gather fails): they are gathered
    # over the model axis first, the (B, qc, V) all-gather that GSPMD
    # inserts here too
    full = sc(logits, axes, "batch", None, None)
    if isinstance(full, DTensor):
        # on each rank's own rows: DTensor's rule for the gather's
        # backward (a scatter) replicates its (B, qc, V) gradient over
        # the batch axes, every rank holding the whole batch's
        b = axes.bspec
        gold = SH.from_region(torch.gather(
            SH.to_region(full, P(b, None, None)), -1,
            SH.to_region(lbl, P(b, None))[..., None])[..., 0],
            full.device_mesh, P(b, None))
    else:
        gold = torch.gather(full, -1, lbl[..., None])[..., 0]
    tok_loss = torch.where(mask, lse - gold, 0.0)
    return torch.sum(tok_loss), torch.sum(mask.to(torch.float32))


def _ce_chunk_vocab_parallel(hc, lc, embed, axes: MeshAxes, mesh):
    """Vocab-parallel CE (Megatron-style), the reference's ``shard_map``
    region on local shards: each model rank computes its local logits
    shard, extracts the gold logit if the label falls in its shard, and
    only softmax *statistics* cross the wire (two scalars per token
    instead of the V-wide logits row).

    ``hc`` is replicated over the model axis and used by every model rank
    for its own vocab shard, so it enters through ``copy_to`` (its
    gradient is the sum of the ranks' parts); the table's shard is used
    on each batch rank's own tokens, so its gradient is partial over the
    batch axes; the sums over the model axis and the batch axes are
    ``reduce_from`` (their results are replicated)."""
    b = axes.bspec
    model = SH.axis_groups(mesh, axes.model)
    batch = SH.axis_groups(mesh, axes.batch)
    h = SH.copy_to(SH.to_region(hc, P(b, None, None)), model)
    lbl = SH.to_region(lc, P(b, None))
    emb = SH.to_region(embed, P(axes.model, None), partial=axes.batch)
    shard = mesh.get_local_rank(axes.model)
    v_loc = emb.shape[0]
    logits = torch.einsum("bqd,vd->bqv", h.to(torch.float32),
                          emb.to(torch.float32))
    local_max = torch.amax(logits, dim=-1)
    # detached: the max is a numerical-stability shift (the reference's
    # stop_gradient; pmax has no differentiation rule)
    gmax = SH.max_over(local_max, model)
    sumexp = torch.sum(torch.exp(logits - gmax[..., None]), dim=-1)
    sumexp = SH.reduce_from(sumexp, model)
    lse = torch.log(sumexp) + gmax
    mask = lbl >= 0
    lbl = torch.where(mask, lbl, 0).long()
    idx = lbl - shard * v_loc
    in_shard = (idx >= 0) & (idx < v_loc)
    gold_loc = torch.gather(logits, -1,
                            torch.clamp(idx, 0, v_loc - 1)[..., None])[..., 0]
    gold = SH.reduce_from(torch.where(in_shard, gold_loc, 0.0), model)
    tok_loss = torch.where(mask, lse - gold, 0.0)
    ls = SH.reduce_from(torch.sum(tok_loss), batch)
    cnt = SH.reduce_from(torch.sum(mask.to(torch.float32)), batch)
    return SH.from_region(ls, mesh, P()), SH.from_region(cnt, mesh, P())


def chunked_ce_loss(h, embed, labels, cfg: ModelConfig, axes: MeshAxes,
                    chunk: int = 512, mesh=None):
    """Cross-entropy computed in sequence chunks so the (B, S, V) logits are
    never materialized: each chunk's (B, chunk, V) logits live inside its
    :func:`_remat` body (recomputed in the backward unless ``cfg.remat``
    is ``"none"``).  ``S`` must be a multiple of ``min(chunk, S)``, as in
    the reference."""
    B, S, D = h.shape
    qc = min(chunk, S)
    n = S // qc
    hr = h.reshape(B, n, qc, D)
    lr = labels.reshape(B, n, qc)
    use_vp = (cfg.ce_impl == "vocab_parallel" and axes.enabled
              and mesh is not None and axes.model is not None)

    def chunk_loss(hc, lc):
        if use_vp:
            return _ce_chunk_vocab_parallel(hc, lc, embed, axes, mesh)
        return _ce_chunk_gather(hc, lc, embed, axes)

    def body(carry, inp):
        hc, lc = inp
        ls, cnt = _remat(chunk_loss, cfg)(hc, lc)
        return (carry[0] + ls, carry[1] + cnt), None

    zero = SH.replicated(torch.zeros((), dtype=torch.float32,
                                     device=h.device), h)
    (tot, cnt), _ = L.xscan(cfg, body, (zero, zero),
                            (hr.movedim(1, 0), lr.movedim(1, 0)))
    # replicated on a mesh: a partial sum would read as this rank's part
    return sc(tot / torch.clamp(cnt, min=1), axes)


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """A nested parameter dict as a flat ``{"layers.attn.wq": leaf}``
    dict (the model's ``state_dict`` names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class BaseLM(L.ParamTree):
    """The shared half of every family: the parameter tree (shaped on the
    ``meta`` device until :meth:`init` draws it, or ``build_model`` /
    ``models.carry`` place it), embedding, logits and KV-cache helpers."""

    def __init__(self, cfg: ModelConfig, axes: MeshAxes | None = None,
                 mesh=None):
        with torch.device("meta"):
            tree = self.init_tree(cfg, None)
        super().__init__(tree)
        self.cfg = cfg
        self.axes = axes or SINGLE
        self.mesh = mesh
        if self.axes.enabled and mesh is None:
            raise ValueError("an enabled MeshAxes needs the mesh its axes "
                             "name")

    @property
    def device(self) -> torch.device:
        return self["embed"].device

    # ---- parameters ----
    @staticmethod
    def init_tree(cfg: ModelConfig, gen) -> dict:
        """The reference's ``init``: the parameter tree drawn from ``gen``
        (on its device; shapes only on the ambient device without one)."""
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> "BaseLM":
        """Draw every parameter from ``generator``, on its device (on a
        mesh: rank 0's draw, placed by ``param_pspecs``)."""
        self.load_state_dict(flatten_tree(self.init_tree(self.cfg,
                                                         generator)),
                             strict=True, assign=True)
        return self.place()

    def place(self) -> "BaseLM":
        """On a mesh, every parameter that is still a whole tensor becomes
        a DTensor placed by ``model.param_pspecs`` (the reference's
        ``jax.device_put(params, to_shardings(mesh, param_pspecs(...)))``,
        rank 0's values); without one, nothing changes."""
        if not self.axes.enabled:
            return self
        from repro_torch.models.model import param_pspecs  # noqa: PLC0415
        specs = flatten_tree(param_pspecs(self, self.cfg))
        for name, p in list(self.named_parameters()):
            if isinstance(p, DTensor):
                continue
            path, _, leaf = name.rpartition(".")
            owner = self.get_submodule(path) if path else self
            owner._parameters[leaf] = nn.Parameter(
                SH.distribute(p.detach(), self.mesh, specs[name], what=name),
                requires_grad=p.requires_grad)
        return self

    # ---- inputs on a mesh ----
    def _inputs(self, batch: dict, kind: str) -> dict:
        """A batch of whole tensors placed by ``model.input_pspecs`` on the
        mesh (each rank holds the global batch and keeps its shard); a
        DTensor leaf is redistributed to its spec.  Unchanged without a
        mesh."""
        if not self.axes.enabled:
            return batch
        from repro_torch.models.model import input_pspecs  # noqa: PLC0415
        specs = input_pspecs(self.cfg, ShapeSpec(kind, 0, 0, kind), self.axes)
        return {k: self._placed(v, specs.get(k, P()), k)
                for k, v in batch.items()}

    def _placed(self, t, spec, what):
        if isinstance(t, DTensor):
            want = SH.placements(self.mesh, spec, t.dim())
            return (t if tuple(t.placements) == want
                    else t.redistribute(self.mesh, want))
        if not isinstance(t, torch.Tensor):
            return t
        return SH.distribute(t, self.mesh, spec, what=what,
                             src_data_rank=None)

    def _decode_inputs(self, state: dict, tokens):
        """``state`` placed by ``model.state_pspecs`` and ``tokens`` by
        ``input_pspecs`` on a mesh; unchanged without one."""
        if not self.axes.enabled:
            return state, tokens
        from repro_torch.models.model import state_pspecs  # noqa: PLC0415
        specs = state_pspecs(state, self.axes)

        def place(x, spec, path):
            if isinstance(x, dict):
                return {k: place(x[k], spec[k], f"{path}.{k}") for k in x}
            return self._placed(x, spec, path)

        state = place(state, specs, "state")
        return state, self._inputs({"tokens": tokens}, "decode")["tokens"]

    @staticmethod
    def _embed_tree(cfg: ModelConfig, gen) -> dict:
        p = {"embed": L.embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                   cfg.param_dtype),
             "ln_f": L.full(gen, (cfg.d_model,), 1.0, cfg.param_dtype)}
        if not cfg.tie_embeddings:
            p["unembed"] = L.embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                        cfg.param_dtype)
        return p

    # ---- embedding helpers ----
    def _embed(self, tokens):
        # the rows are cast after the gather: the same values as casting
        # the whole table first, as the reference writes it
        table = self["embed"]
        if not isinstance(table, DTensor):
            return table[tokens].to(self.cfg.compute_dtype)
        # on a mesh the lookup runs on local shards: DTensor's rules for
        # aten.index on a row-sharded table, and for its backward's
        # index_put on batch-sharded rows, fail on some releases.  Each
        # rank reads its own tokens' rows of the gathered table, whose
        # gradient is then partial over the batch axes.
        b = self.axes.bspec
        rows = SH.to_region(table, P(), partial=self.axes.batch)[
            SH.to_region(tokens, P(b))]
        e = SH.from_region(rows, table.device_mesh, P(b, None, None))
        return sc(e.to(self.cfg.compute_dtype), self.axes, "batch", None,
                  None)

    def _unembed_table(self):
        return self.get("unembed", self["embed"])

    def _logits(self, h):
        """Last-position logits (B, V) in fp32."""
        h = L.rms_norm(h, self["ln_f"], self.cfg.norm_eps)
        logits = torch.einsum("bd,vd->bv", h.to(torch.float32),
                              self._unembed_table().to(torch.float32))
        return sc(logits, self.axes, "batch", "model")

    def _hidden_loss(self, h, labels):
        h = L.rms_norm(h, self["ln_f"], self.cfg.norm_eps)
        return chunked_ce_loss(h, self._unembed_table(), labels, self.cfg,
                               self.axes, mesh=self.mesh)

    def _pos(self, S: int):
        return SH.replicated(torch.tensor(S, dtype=torch.int32,
                                          device=self.device), self["embed"])

    def _angles_for(self, h):
        """RoPE angles of positions 0..S-1 for the (B, S, D) ``h``."""
        B, S = h.shape[:2]
        return SH.replicated(_angles(self.cfg, _positions(
            self.cfg, B, S, device=h.device)), h)

    def _decode_angles(self, B: int, pos):
        """RoPE angles of position ``pos`` (a 0-d tensor, replicated on a
        mesh) for a batch of ``B`` tokens."""
        like = pos
        if isinstance(pos, DTensor):
            pos = pos.to_local()
        return SH.replicated(_angles(self.cfg, _positions(
            self.cfg, B, 1, offset=pos, device=self.device)), like)

    # interface stubs
    def loss(self, batch):
        raise NotImplementedError

    def prefill(self, batch, pad_to: int | None = None):
        raise NotImplementedError

    def decode_step(self, state, tokens):
        raise NotImplementedError

    def decode_state_specs(self, batch: int, seq_len: int):
        raise NotImplementedError

    @staticmethod
    def _pad_kv(kv, pad_to: int | None):
        """Pad prefill KV caches along the sequence dim (dim 2 of the
        stacked (L, B, S, Hkv, Dh) caches) to ``pad_to`` so subsequent
        decode steps have write headroom."""
        if pad_to is None:
            return kv

        def pad(a):
            s = a.shape[2]
            return (F.pad(a, [0, 0] * (a.dim() - 3) + [0, pad_to - s])
                    if pad_to > s else a)
        return {k: pad(v) for k, v in kv.items()}

    def kv_cache_specs(self, stack: int, batch: int, seq_len: int):
        cfg = self.cfg
        shp = (stack, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.empty(shp, dtype=cfg.compute_dtype,
                                 device="meta"),
                "v": torch.empty(shp, dtype=cfg.compute_dtype,
                                 device="meta")}

    def _attn_layer_kv(self, x, lp, angles):
        """One dense layer of the prefill trunk, keeping its k/v."""
        cfg = self.cfg
        hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.project_qkv(hn, lp["attn"], cfg, self.axes, angles)
        o = L.full_attention(q, k, v, cfg, self.axes, causal=True)
        x = x + (o @ lp["attn"]["wo"].to(cfg.compute_dtype))
        return x, {"k": k.to(cfg.compute_dtype),
                   "v": v.to(cfg.compute_dtype)}

    def _decode_layers(self, body, h, xs, kv):
        """The decode loop over a stack of layers and their KV cache.
        ``body(x, xs_i, cache_i) -> (x, y)`` runs for each layer, with
        ``cache_i`` layer i's {"k","v"} view of one copy of the stacked
        cache, which it writes in place.  Returns (x, stacked ys, cache)."""
        ck, cv = kv["k"].clone(), kv["v"].clone()
        h, ys = L.xscan(
            self.cfg, lambda x, inp: body(x, inp[0], {"k": inp[1],
                                                      "v": inp[2]}),
            h, (xs, ck, cv))
        return h, ys, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# dense decoder LM (also VLM backbone: patch embeddings prepended)
# ---------------------------------------------------------------------------


class DenseLM(BaseLM):
    @staticmethod
    def init_tree(cfg: ModelConfig, gen) -> dict:
        p = BaseLM._embed_tree(cfg, gen)
        p["layers"] = L.block_params(gen, cfg, cfg.num_layers)
        return p

    def _trunk(self, h, angles, collect_kv: bool = False):
        cfg = self.cfg

        if collect_kv:
            def body(x, lp):
                x, kv = self._attn_layer_kv(x, lp, angles)
                hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
                return x + L.mlp_block(hn, lp["mlp"], cfg, self.axes), kv

            return L.xscan(cfg, body, h, self["layers"])

        def train_body(x, lp):
            return L.transformer_block(x, lp, cfg, self.axes, angles,
                                       causal=True), None

        return L.xscan(cfg, _remat(train_body, cfg), h, self["layers"])

    def _inputs_to_h(self, batch):
        """Embed tokens; VLM prepends stubbed patch embeddings."""
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        if cfg.family == "vlm" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(cfg.compute_dtype)
            h = torch.cat([sc(pe, self.axes, "batch", None, None), h], dim=1)
        return h

    def loss(self, batch):
        batch = self._inputs(batch, "train")
        cfg = self.cfg
        h = self._inputs_to_h(batch)
        B = h.shape[0]
        angles = self._angles_for(h)
        h, _ = self._trunk(h, angles)
        labels = batch["labels"]
        if h.shape[1] != labels.shape[1]:  # vlm: no loss on patch positions
            pad = torch.full((B, h.shape[1] - labels.shape[1]), -1,
                             dtype=labels.dtype, device=labels.device)
            if isinstance(labels, DTensor):   # placed as the labels are
                pad = DTensor.from_local(
                    pad[:labels.to_local().shape[0]], labels.device_mesh,
                    labels.placements, run_check=False)
            labels = torch.cat([pad, labels], dim=1)
        loss = self._hidden_loss(h, labels)
        return loss, {"ce": loss}

    def prefill(self, batch, pad_to: int | None = None):
        batch = self._inputs(batch, "prefill")
        cfg = self.cfg
        h = self._inputs_to_h(batch)
        S = h.shape[1]
        angles = self._angles_for(h)
        h, kv = self._trunk(h, angles, collect_kv=True)
        logits = self._logits(h[:, -1])
        return logits, {"kv": self._pad_kv(kv, pad_to), "pos": self._pos(S)}

    def decode_step(self, state, tokens):
        state, tokens = self._decode_inputs(state, tokens)
        cfg = self.cfg
        h = self._embed(tokens[:, None])
        pos = state["pos"]
        Smax = state["kv"]["k"].shape[2]
        write_pos = torch.clamp(pos, max=Smax - 1)
        angles = self._decode_angles(h.shape[0], pos)

        def body(x, lp, cache):
            x, _ = L.transformer_block_decode(x, lp, cfg, self.axes, angles,
                                              cache, write_pos)
            return x, None

        h, _, kv = self._decode_layers(body, h, self["layers"], state["kv"])
        return self._logits(h[:, 0]), {"kv": kv, "pos": pos + 1}

    def decode_state_specs(self, batch: int, seq_len: int):
        return {"kv": self.kv_cache_specs(self.cfg.num_layers, batch,
                                          seq_len),
                "pos": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# MoE decoder LM
# ---------------------------------------------------------------------------


class MoeLM(BaseLM):
    @staticmethod
    def init_tree(cfg: ModelConfig, gen) -> dict:
        p = BaseLM._embed_tree(cfg, gen)
        nl = cfg.num_layers
        p["layers"] = {
            "attn": L.attn_params(gen, cfg, nl),
            "moe": MOE.moe_params(gen, cfg, nl),
            "ln1": L.full(gen, (nl, cfg.d_model), 1.0, cfg.param_dtype),
            "ln2": L.full(gen, (nl, cfg.d_model), 1.0, cfg.param_dtype),
        }
        return p

    def _trunk(self, h, angles, collect_kv: bool = False):
        """Returns (h, mean aux (2,) [load_balance, router_z], kv)."""
        cfg = self.cfg

        def body(carry, lp):
            x, aux = carry
            x, kv = self._attn_layer_kv(x, lp, angles)
            hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            y, a = MOE.moe_ffn(hn, lp["moe"], cfg, self.axes, self.mesh)
            return (x + y, aux + a), (kv if collect_kv else None)

        aux0 = SH.replicated(torch.zeros(2, device=h.device), h)
        (h, aux), kv = L.xscan(cfg, body if collect_kv else _remat(body, cfg),
                               (h, aux0), self["layers"])
        return h, aux / cfg.num_layers, kv

    def loss(self, batch):
        batch = self._inputs(batch, "train")
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        angles = self._angles_for(h)
        h, aux, _ = self._trunk(h, angles)
        ce = self._hidden_loss(h, batch["labels"])
        loss = ce + 0.01 * aux[0] + 1e-3 * aux[1]
        return loss, {"ce": ce, "load_balance": aux[0], "router_z": aux[1]}

    def prefill(self, batch, pad_to: int | None = None):
        batch = self._inputs(batch, "prefill")
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        S = h.shape[1]
        angles = self._angles_for(h)
        h, _, kv = self._trunk(h, angles, collect_kv=True)
        return (self._logits(h[:, -1]),
                {"kv": self._pad_kv(kv, pad_to), "pos": self._pos(S)})

    def decode_step(self, state, tokens):
        state, tokens = self._decode_inputs(state, tokens)
        cfg = self.cfg
        h = self._embed(tokens[:, None])
        pos = state["pos"]
        Smax = state["kv"]["k"].shape[2]
        write_pos = torch.clamp(pos, max=Smax - 1)
        angles = self._decode_angles(h.shape[0], pos)

        def body(x, lp, cache):
            hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = L.project_qkv(hn, lp["attn"], cfg, self.axes, angles)
            ck = L.cache_write(cache["k"], k, write_pos)
            cv = L.cache_write(cache["v"], v, write_pos)
            o = L.decode_attention(q, ck, cv, write_pos + 1, cfg, self.axes)
            x = x + (o @ lp["attn"]["wo"].to(cfg.compute_dtype))
            hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            y, _ = MOE.moe_ffn(hn, lp["moe"], cfg, self.axes, self.mesh)
            return x + y, None

        h, _, kv = self._decode_layers(body, h, self["layers"], state["kv"])
        return self._logits(h[:, 0]), {"kv": kv, "pos": pos + 1}

    def decode_state_specs(self, batch: int, seq_len: int):
        return {"kv": self.kv_cache_specs(self.cfg.num_layers, batch,
                                          seq_len),
                "pos": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# Mamba2 LM (attention-free)
# ---------------------------------------------------------------------------


class MambaLM(BaseLM):
    @staticmethod
    def init_tree(cfg: ModelConfig, gen) -> dict:
        p = BaseLM._embed_tree(cfg, gen)
        p["layers"] = M.mamba_params(gen, cfg, cfg.num_layers)
        return p

    def _trunk(self, h, collect_state: bool = False):
        cfg = self.cfg

        def body(x, lp, layer):
            x, st = M.mamba_block(x, lp, cfg, self.axes, layer)
            return x, (st if collect_state else None)

        return L.xscan(cfg, body if collect_state else _remat(body, cfg), h,
                       self["layers"], index=True)

    def loss(self, batch):
        batch = self._inputs(batch, "train")
        h = self._embed(batch["tokens"])
        h, _ = self._trunk(h)
        ce = self._hidden_loss(h, batch["labels"])
        return ce, {"ce": ce}

    def prefill(self, batch, pad_to: int | None = None):
        batch = self._inputs(batch, "prefill")
        h = self._embed(batch["tokens"])
        S = h.shape[1]
        h, (ssm, conv) = self._trunk(h, collect_state=True)
        logits = self._logits(h[:, -1])
        return logits, {"ssm": ssm, "conv": conv, "pos": self._pos(S)}

    def decode_step(self, state, tokens):
        state, tokens = self._decode_inputs(state, tokens)
        cfg = self.cfg
        h = self._embed(tokens[:, None])

        def body(x, inp):
            lp, ssm, conv = inp
            return M.mamba_block_decode(x, lp, cfg, self.axes, (ssm, conv))

        h, (ssm, conv) = L.xscan(
            cfg, body, h, (self["layers"], state["ssm"], state["conv"]))
        logits = self._logits(h[:, 0])
        return logits, {"ssm": ssm, "conv": conv, "pos": state["pos"] + 1}

    def decode_state_specs(self, batch: int, seq_len: int):
        ssm, conv = M.mamba_state_specs(self.cfg, batch, self.cfg.num_layers)
        return {"ssm": ssm, "conv": conv,
                "pos": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# Hybrid (zamba2): Mamba2 trunk + weight-shared attention blocks
# ---------------------------------------------------------------------------


class HybridLM(BaseLM):
    """The hybrid family as the JAX reference simplifies it (a plain
    ``ModelConfig``, e.g. ``configs/zamba2_2_7b.py``): ``num_layers``
    Mamba2 blocks; after every ``attn_every`` of them the *same*
    (weight-shared) pre-norm transformer block runs on the residual stream,
    with no LoRA.  Params for the SSM trunk are stacked (n_super,
    attn_every, ...) for a two-level loop; the shared block's KV cache has
    one entry a super-block.  The released Zamba2 layout (a
    ``Zamba2Config``, e.g. ``configs/zamba2_7b.py``) is :class:`Zamba2LM`,
    which keeps this class's ``loss`` and ``prefill``."""

    @property
    def n_super(self) -> int:
        return self.cfg.num_layers // self.cfg.attn_every

    @staticmethod
    def init_tree(cfg: ModelConfig, gen) -> dict:
        if cfg.num_layers % cfg.attn_every:
            raise ValueError(f"num_layers {cfg.num_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        n_super = cfg.num_layers // cfg.attn_every
        p = BaseLM._embed_tree(cfg, gen)
        flat = M.mamba_params(gen, cfg, cfg.num_layers)
        p["ssm_layers"] = {
            k: a.reshape(n_super, cfg.attn_every, *a.shape[1:])
            for k, a in flat.items()}
        p["shared"] = L.block_params(gen, cfg)  # unstacked = weight-shared
        return p

    def _super_block(self, x, sp, angles, collect: bool):
        """attn_every mamba layers then the shared attention block;
        returns (x, ((ssm_states, conv_states), k, v)) when ``collect``,
        else (x, None)."""
        cfg = self.cfg
        shared = self["shared"]

        def inner(x, lp):
            x, st = M.mamba_block(x, lp, cfg, self.axes)
            return x, (st if collect else None)

        x, states = L.xscan(cfg, inner, x, sp)
        if not collect:
            return L.transformer_block(x, shared, cfg, self.axes, angles,
                                       causal=True), None
        x, kv = self._attn_layer_kv(x, shared, angles)
        hn = L.rms_norm(x, shared["ln2"], cfg.norm_eps)
        x = x + L.mlp_block(hn, shared["mlp"], cfg, self.axes)
        return x, (states, kv["k"], kv["v"])

    def _trunk(self, h, angles, collect: bool = False):
        body = partial(self._super_block, angles=angles, collect=collect)
        return L.xscan(self.cfg, body if collect else _remat(body, self.cfg),
                       h, self["ssm_layers"])

    def loss(self, batch):
        batch = self._inputs(batch, "train")
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        angles = self._angles_for(h)
        h, _ = self._trunk(h, angles)
        ce = self._hidden_loss(h, batch["labels"])
        return ce, {"ce": ce}

    def prefill(self, batch, pad_to: int | None = None):
        batch = self._inputs(batch, "prefill")
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        S = h.shape[1]
        angles = self._angles_for(h)
        h, (states, k, v) = self._trunk(h, angles, collect=True)
        ssm, conv = states
        logits = self._logits(h[:, -1])
        kv = self._pad_kv({"k": k, "v": v}, pad_to)
        return logits, {"ssm": ssm, "conv": conv, "kv": kv,
                        "pos": self._pos(S)}

    def decode_step(self, state, tokens):
        state, tokens = self._decode_inputs(state, tokens)
        cfg = self.cfg
        h = self._embed(tokens[:, None])
        pos = state["pos"]
        Smax = state["kv"]["k"].shape[2]
        write_pos = torch.clamp(pos, max=Smax - 1)
        angles = self._decode_angles(h.shape[0], pos)
        shared = self["shared"]

        def inner(x, lpst):
            lp, s1, s2 = lpst
            return M.mamba_block_decode(x, lp, cfg, self.axes, (s1, s2))

        def body(x, inp, cache):
            sp, ssm, conv = inp
            x, (ssm, conv) = L.xscan(cfg, inner, x, (sp, ssm, conv))
            x, _ = L.transformer_block_decode(x, shared, cfg, self.axes,
                                              angles, cache, write_pos)
            return x, (ssm, conv)

        h, (ssm, conv), kv = self._decode_layers(
            body, h, (self["ssm_layers"], state["ssm"], state["conv"]),
            state["kv"])
        logits = self._logits(h[:, 0])
        return logits, {"ssm": ssm, "conv": conv, "kv": kv, "pos": pos + 1}

    def decode_state_specs(self, batch: int, seq_len: int):
        cfg = self.cfg
        ssm, conv = M.mamba_state_specs(cfg, batch, cfg.num_layers)

        def re(s):
            return torch.empty((self.n_super, cfg.attn_every, *s.shape[1:]),
                               dtype=s.dtype, device="meta")
        return {"ssm": re(ssm), "conv": re(conv),
                "kv": self.kv_cache_specs(self.n_super, batch, seq_len),
                "pos": torch.empty((), dtype=torch.int32, device="meta")}


class Zamba2LM(HybridLM):
    """The released Zamba2 (transformers' ``modeling_zamba2.py``; arXiv:
    2405.16712 eq. 6) for a :class:`~repro_torch.configs.base.Zamba2Config`.
    With ``e`` the embedding output and application ``j`` before layer
    ``i`` of ``hybrid_layer_ids``::

        u = RMSNorm_2d([h ; e])          # block b = j % mem_blocks
        a = Attn_b(u)                    # q, k, v from 2d; attn_scale
        m = MLP_b(RMSNorm_d(a))          # GELU-gated, LoRA_j on gate/up
        t = m @ linear_j
        h = h + Mamba_i(RMSNorm(h + t))  # t enters the mixer only

    and ``h = h + Mamba_i(RMSNorm(h))`` at every other layer; the Mamba2
    layers' gated norm runs over ``ssm_groups`` groups and their conv has a
    bias.  Parameters: ``layers.*`` the Mamba2 layers stacked (L, ...),
    ``shared.*`` the blocks stacked (mem_blocks, ...), ``apps.*``
    (``lora_a``, ``lora_b``, ``linear``) stacked over the applications;
    a block's gradient sums over its applications.  Training runs each
    application and each Mamba2 layer in a remat region of its own.  The
    prefill state is the layers' ``ssm``/``conv`` and one KV entry an
    application.  Runs unsharded: an enabled ``MeshAxes`` raises."""

    def __init__(self, cfg: Zamba2Config, axes: MeshAxes | None = None,
                 mesh=None):
        if axes is not None and axes.enabled:
            raise NotImplementedError("the released Zamba2 layout runs "
                                      "unsharded")
        super().__init__(cfg, axes, mesh)

    @staticmethod
    def init_tree(cfg: Zamba2Config, gen) -> dict:
        ids, nl = cfg.hybrid_layer_ids, cfg.num_layers
        if list(ids) != sorted(set(ids)) or (ids and not 0 <= ids[0] <=
                                               ids[-1] < nl):
            raise ValueError(f"hybrid_layer_ids {ids} are not increasing "
                             f"layers of {nl}")
        d, f, r, nb = cfg.d_model, cfg.d_ff, cfg.adapter_rank, cfg.mem_blocks
        dt = cfg.param_dtype
        p = BaseLM._embed_tree(cfg, gen)
        p["layers"] = M.mamba_params(gen, cfg, nl)
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        p["layers"]["conv_bias"] = L.full(gen, (nl, conv_ch), 0.0, dt)
        p["shared"] = {
            "ln1": L.full(gen, (nb, 2 * d), 1.0, dt),
            "attn": {
                "wq": L.dense_init(gen, (nb, 2 * d, cfg.q_dim), dtype=dt),
                "wk": L.dense_init(gen, (nb, 2 * d, cfg.kv_dim), dtype=dt),
                "wv": L.dense_init(gen, (nb, 2 * d, cfg.kv_dim), dtype=dt),
                "wo": L.dense_init(gen, (nb, cfg.q_dim, d), dtype=dt)},
            "ln2": L.full(gen, (nb, d), 1.0, dt),
            "mlp": {"w_gate_up": L.dense_init(gen, (nb, d, 2 * f), dtype=dt),
                    "w_down": L.dense_init(gen, (nb, f, d), dtype=dt)},
        }
        na = len(ids)
        p["apps"] = {"lora_a": L.dense_init(gen, (na, d, r), dtype=dt),
                     "lora_b": L.dense_init(gen, (na, r, 2 * f), dtype=dt),
                     "linear": L.dense_init(gen, (na, d, d), dtype=dt)}
        return p

    @property
    def n_apps(self) -> int:
        return len(self.cfg.hybrid_layer_ids)

    def _shared_qkv(self, h, e, bp, angles):
        """An application's q, k, v: from ``RMSNorm([h ; e])``."""
        cfg = self.cfg
        u = L.rms_norm(torch.cat([h, e], dim=-1), bp["ln1"], cfg.norm_eps)
        return L.project_qkv(u, bp["attn"], cfg, self.axes, angles)

    def _shared_out(self, o, bp, ap):
        """An application's output ``t`` from its attention's ``o``: the
        out-projection, the block's MLP with the application's LoRA, the
        application's linear."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        a = o @ bp["attn"]["wo"].to(cd)
        m = L.gated_gelu_mlp(L.rms_norm(a, bp["ln2"], cfg.norm_eps),
                             bp["mlp"], cfg, ap)
        return m @ ap["linear"].to(cd)

    def _shared(self, h, e, bp, ap, angles, layer: int, block: int):
        """One application over a whole sequence: (t, k, v)."""
        with obs.span("hybrid.shared", layer=layer, block=block,
                      tokens=h.shape[0] * h.shape[1]):
            q, k, v = self._shared_qkv(h, e, bp, angles)
            o = L.full_attention(q, k, v, self.cfg, self.axes, causal=True,
                                 scale=self.cfg.attn_scale)
            return self._shared_out(o, bp, ap), k, v

    def _mamba(self, h, lp, t, layer: int):
        return M.mamba_block(h, lp, self.cfg, self.axes, layer, inject=t,
                             norm_groups=self.cfg.ssm_groups)

    def _trunk(self, h, angles, collect: bool = False):
        """(h, None), or with ``collect`` (h, ((ssm, conv), k, v)): the
        layers' states stacked (L, ...) and the applications' k/v (J, B,
        S, H, Dh)."""
        cfg = self.cfg
        at = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
        blocks = L.tree_unbind(self["shared"], cfg.mem_blocks)
        apps = L.tree_unbind(self["apps"], self.n_apps)
        shared = self._shared if collect else _remat(self._shared, cfg)
        mamba = self._mamba if collect else _remat(self._mamba, cfg)
        e, kvs = h, []

        def body(x, lp, i):
            t = None
            if i in at:
                j = at[i]
                b = j % cfg.mem_blocks
                t, k, v = shared(x, e, blocks[b], apps[j], angles, i, b)
                if collect:
                    kvs.append((k, v))
            x, st = mamba(x, lp, t, i)
            return x, (st if collect else None)

        h, states = L.xscan(cfg, body, h, self["layers"], index=True)
        if not collect:
            return h, None
        return h, (states, *(torch.stack(t) for t in zip(*kvs)))

    def decode_step(self, state, tokens):
        state, tokens = self._decode_inputs(state, tokens)
        cfg = self.cfg
        h = self._embed(tokens[:, None])
        e = h
        pos = state["pos"]
        write_pos = torch.clamp(pos, max=state["kv"]["k"].shape[2] - 1)
        angles = self._decode_angles(h.shape[0], pos)
        at = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
        blocks = L.tree_unbind(self["shared"], cfg.mem_blocks)
        apps = L.tree_unbind(self["apps"], self.n_apps)
        ck, cv = state["kv"]["k"].clone(), state["kv"]["v"].clone()

        def body(x, inp, i):
            lp, ssm, conv = inp
            t = None
            if i in at:
                j = at[i]
                b = j % cfg.mem_blocks
                with obs.span("hybrid.shared", layer=i, block=b,
                              tokens=x.shape[0]):
                    q, k, v = self._shared_qkv(x, e, blocks[b], angles)
                    kc = L.cache_write(ck[j], k, write_pos)
                    vc = L.cache_write(cv[j], v, write_pos)
                    o = L.decode_attention(q, kc, vc, write_pos + 1, cfg,
                                           self.axes, scale=cfg.attn_scale)
                    t = self._shared_out(o, blocks[b], apps[j])
            return M.mamba_block_decode(x, lp, cfg, self.axes, (ssm, conv),
                                        inject=t,
                                        norm_groups=self.cfg.ssm_groups)

        h, (ssm, conv) = L.xscan(
            cfg, body, h, (self["layers"], state["ssm"], state["conv"]),
            index=True)
        logits = self._logits(h[:, 0])
        return logits, {"ssm": ssm, "conv": conv, "kv": {"k": ck, "v": cv},
                        "pos": pos + 1}

    def decode_state_specs(self, batch: int, seq_len: int):
        ssm, conv = M.mamba_state_specs(self.cfg, batch, self.cfg.num_layers)
        return {"ssm": ssm, "conv": conv,
                "kv": self.kv_cache_specs(self.n_apps, batch, seq_len),
                "pos": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper): bidirectional encoder over stubbed audio frames,
# causal decoder with cross-attention.
# ---------------------------------------------------------------------------


class EncDecLM(BaseLM):
    @staticmethod
    def init_tree(cfg: ModelConfig, gen) -> dict:
        p = BaseLM._embed_tree(cfg, gen)
        p["enc_layers"] = L.block_params(gen, cfg, cfg.num_layers)
        nd = cfg.num_decoder_layers
        p["dec_layers"] = L.block_params(gen, cfg, nd)
        p["dec_layers"]["cross"] = L.attn_params(gen, cfg, nd)
        p["dec_layers"]["ln_x"] = L.full(gen, (nd, cfg.d_model), 1.0,
                                         cfg.param_dtype)
        p["ln_enc"] = L.full(gen, (cfg.d_model,), 1.0, cfg.param_dtype)
        return p

    def encode(self, audio_frames):
        cfg = self.cfg
        h = audio_frames.to(cfg.compute_dtype)
        h = sc(h, self.axes, "batch", None, None)
        angles = self._angles_for(h)

        def body(x, lp):
            return (L.transformer_block(x, lp, cfg, self.axes, angles,
                                        causal=False), None)

        h, _ = L.xscan(cfg, _remat(body, cfg), h, self["enc_layers"])
        return L.rms_norm(h, self["ln_enc"], cfg.norm_eps)

    def _decoder(self, h, enc_out, angles, collect_kv: bool = False):
        cfg = self.cfg

        def body(x, lp):
            hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = L.project_qkv(hn, lp["attn"], cfg, self.axes, angles)
            o = L.full_attention(q, k, v, cfg, self.axes, causal=True)
            x = x + (o @ lp["attn"]["wo"].to(cfg.compute_dtype))
            x = L.cross_attn_sublock(x, lp["cross"], lp["ln_x"], cfg,
                                     self.axes, enc_out)
            hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + L.mlp_block(hn, lp["mlp"], cfg, self.axes)
            out = ({"k": k.to(cfg.compute_dtype),
                    "v": v.to(cfg.compute_dtype)} if collect_kv else None)
            return x, out

        return L.xscan(cfg, body if collect_kv else _remat(body, cfg), h,
                       self["dec_layers"])

    def loss(self, batch):
        batch = self._inputs(batch, "train")
        cfg = self.cfg
        enc_out = self.encode(batch["audio_frames"])
        h = self._embed(batch["tokens"])
        angles = self._angles_for(h)
        h, _ = self._decoder(h, enc_out, angles)
        ce = self._hidden_loss(h, batch["labels"])
        return ce, {"ce": ce}

    def _cross_kv(self, enc_out):
        """Precompute per-decoder-layer cross-attention k/v from enc_out."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        B, S, _ = enc_out.shape

        def body(_, lp):
            k = (enc_out @ lp["wk"].to(cd)).reshape(
                B, S, cfg.num_kv_heads, cfg.head_dim)
            v = (enc_out @ lp["wv"].to(cd)).reshape(
                B, S, cfg.num_kv_heads, cfg.head_dim)
            return None, {"k": k, "v": v}

        _, enc_kv = L.xscan(cfg, body, None, self["dec_layers"]["cross"])
        return enc_kv

    def prefill(self, batch, pad_to: int | None = None):
        batch = self._inputs(batch, "prefill")
        cfg = self.cfg
        enc_out = self.encode(batch["audio_frames"])
        h = self._embed(batch["tokens"])
        S = h.shape[1]
        angles = self._angles_for(h)
        h, kv = self._decoder(h, enc_out, angles, collect_kv=True)
        logits = self._logits(h[:, -1])
        return logits, {"kv": self._pad_kv(kv, pad_to),
                        "enc_kv": self._cross_kv(enc_out),
                        "pos": self._pos(S)}

    def decode_step(self, state, tokens):
        state, tokens = self._decode_inputs(state, tokens)
        cfg = self.cfg
        cd = cfg.compute_dtype
        h = self._embed(tokens[:, None])
        pos = state["pos"]
        Smax = state["kv"]["k"].shape[2]
        write_pos = torch.clamp(pos, max=Smax - 1)
        angles = self._decode_angles(h.shape[0], pos)

        def body(x, inp, cache):
            lp, enc_kv = inp
            hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = L.project_qkv(hn, lp["attn"], cfg, self.axes, angles)
            ck = L.cache_write(cache["k"], k, write_pos)
            cv = L.cache_write(cache["v"], v, write_pos)
            o = L.decode_attention(q, ck, cv, write_pos + 1, cfg, self.axes)
            x = x + (o @ lp["attn"]["wo"].to(cd))
            x = L.cross_block_decode(
                x, {"ln1": lp["ln_x"], "attn": lp["cross"]}, cfg, self.axes,
                enc_kv)
            hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + L.mlp_block(hn, lp["mlp"], cfg, self.axes)
            return x, None

        dl = self["dec_layers"]
        lp_only = {k: dl[k] for k in ("attn", "mlp", "ln1", "ln2", "cross",
                                      "ln_x")}
        h, _, kv = self._decode_layers(body, h, (lp_only, state["enc_kv"]),
                                       state["kv"])
        logits = self._logits(h[:, 0])
        return logits, {"kv": kv, "enc_kv": state["enc_kv"], "pos": pos + 1}

    def decode_state_specs(self, batch: int, seq_len: int):
        cfg = self.cfg
        return {
            "kv": self.kv_cache_specs(cfg.num_decoder_layers, batch,
                                      seq_len),
            "enc_kv": self.kv_cache_specs(cfg.num_decoder_layers, batch,
                                          cfg.num_audio_frames),
            "pos": torch.empty((), dtype=torch.int32, device="meta"),
        }


FAMILIES = {
    "dense": DenseLM,
    "vlm": DenseLM,
    "moe": MoeLM,
    "ssm": MambaLM,
    "hybrid": HybridLM,
    "encdec": EncDecLM,
}


def model_class(cfg: ModelConfig):
    """The model class of ``cfg``: its family's, and for the hybrid family
    :class:`Zamba2LM` where ``cfg`` is the released layout's
    ``Zamba2Config``."""
    return Zamba2LM if isinstance(cfg, Zamba2Config) else FAMILIES[cfg.family]


def build_model(cfg: ModelConfig, axes: MeshAxes | None = None, mesh=None,
                *, device="cuda"):
    """The family's model with its parameters allocated, not drawn, on
    ``device`` (``"meta"``: shapes only); draw them with
    ``model.init(generator)`` or load them with ``models.carry``.  With an
    enabled ``axes`` the parameters are DTensors on ``mesh``, placed by
    ``model.param_pspecs`` (``device`` must be of the mesh's device
    type)."""
    model = model_class(cfg)(cfg, axes, mesh)
    if torch.device(device).type == "meta":
        return model
    if model.axes.enabled and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device} is not on the {mesh.device_type} "
                         "mesh")
    return model.to_empty(device=device).place()
