"""Decoder-only causal LM (RoPE/NeoX, learned-position GPT-Neo, ALiBi
BLOOM/MPT, llama/Qwen2 GQA families; tied or untied head).

Counterpart of ``vietnamese_qa_system_tpu/models/causal_lm.py``:
``CausalLM.hidden_states`` with and without a KV cache, ``forward`` (the
head is a plain f32 product of bf16-rounded inputs), ``loss_fn`` (the
chunked cross-entropy at real vocabularies), ``init_causal_lm``,
``_layer_kinds``, ``_window_mask`` and ``unstack_blocks``.  The port keeps
a plain list of layers: a scan-stacked JAX tree is unstacked once when it
is carried over (models/params.py), and the per-layer remat that the JAX
package applies to its scan body (``scan_layers`` with a ``remat_policy``
other than "none") wraps each layer of the list instead.

The cache-less forward with ``use_flash_attention=True`` runs every layer
through the causal flash kernels (K4 forward, K7 backward), local layers
in their sliding-window form, with ALiBi as the key-only bias.

``TPCausalLM`` is the reader split tensor-parallel over a mesh (the
counterpart of the JAX package's tp-sharded parameters under GSPMD): the
same forward over per-device parts, made by ``parallel.sharding.
shard_params``.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import (Block, Dense, LayerNorm, SplitVocab, _matmul, alibi_bias, causal_mask, clone_module, head_groups,
                     remat_wrap, rope_frequencies, tp_block)
from .quantize import quantize_dense_tree

IGNORE_INDEX = -100  # label positions excluded from the loss
# vocabularies at least this large take the chunked streaming loss
# (ops/xent.py), as in the JAX package (causal_lm.py:360)
CHUNKED_XENT_MIN_VOCAB = 16384


def unstack_blocks(params: dict, n_layers: int) -> dict:
    """Scan-stacked pytree (every block leaf (L, ...)) -> list of blocks.
    No-op on list-form params.  Leaves are numpy arrays or tensors."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        return params

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    out = dict(params)
    out["blocks"] = [take(blocks, i) for i in range(n_layers)]
    return out


def _layer_kinds(cfg: ModelConfig):
    """Per-layer attention kind: "global" | "local" (GPT-Neo alternates)."""
    if cfg.attention_layers is None:
        return ("global",) * cfg.n_layers
    if len(cfg.attention_layers) != cfg.n_layers:
        raise ValueError(f"attention_layers has {len(cfg.attention_layers)} entries for {cfg.n_layers} layers")
    return cfg.attention_layers


def _window_mask(q_slots, k_slots, window: int):
    """Sliding-window constraint in cache-SLOT space: a query sees keys at
    most ``window - 1`` slots behind it (exact for left-padded decode: query
    and key positions shift by the same per-row pad offset)."""
    return (q_slots[..., :, None] - k_slots[None, :]) < window


def make_cache(cfg: ModelConfig, b: int, total_len: int, device, kv_dtype: str = "bf16",
               n_layers: int | None = None, kv_heads: int | None = None) -> list[dict]:
    """One {"k", "v"} (B, total_len, kv heads, head_dim) buffer per layer
    (GQA stores only the kv heads; ``n_layers`` defaults to the model's,
    a seq2seq decoder passes its own), as generate.py:267 ``_make_cache``
    builds it: bf16, or with ``kv_dtype="int8"`` int8 codes plus f32
    scales "k_s", "v_s" (B, total_len, kv heads, 1) (layers.kv_quantize).
    ``kv_heads`` overrides the model's (a tensor-parallel device's share)."""
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
    shape = (b, total_len, kv_heads or cfg.kv_heads, cfg.head_dim)

    def layer():
        if kv_dtype == "int8":
            scales = shape[:-1] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_s": torch.zeros(scales, dtype=torch.float32, device=device),
                    "v_s": torch.zeros(scales, dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}

    return [layer() for _ in range(cfg.n_layers if n_layers is None else n_layers)]


def _block(cfg: ModelConfig, device) -> Block:
    return Block(cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.norm_eps, n_kv_heads=cfg.n_kv_heads, norm=cfg.norm,
                 gated_mlp=cfg.mlp_gated, use_bias=cfg.attention_bias, head_dim=cfg.head_dim, device=device)


class CausalLM(nn.Module):
    """Parameters named as the JAX causal pytree (``tok_embed``,
    ``blocks.0.attn.wq.w``, ``ln_f.scale``, ...)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.arch != "causal":
            raise ValueError(f"CausalLM needs arch='causal', got {cfg.arch!r}")
        self.cfg = cfg
        d = cfg.d_model
        rms = cfg.norm == "rmsnorm"
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, d, device=device))
        self.blocks = nn.ModuleList(_block(cfg, device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(d, cfg.norm_eps, bias=not rms, device=device)
        self.pos_embed = (nn.Parameter(torch.empty(cfg.max_seq_len, d, device=device))
                          if cfg.positional == "learned" else None)
        self.emb_ln = LayerNorm(d, cfg.norm_eps, device=device) if cfg.embed_layernorm else None
        self.lm_head = None if cfg.tie_embeddings else Dense(d, cfg.vocab_size, use_bias=False, device=device)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def embed(self, ids):
        """Token embeddings (B, T, D) in the table's dtype."""
        return self.tok_embed[ids]

    def make_cache(self, b: int, total: int, kv_dtype: str = "bf16") -> list[dict]:
        """This model's KV cache (:func:`make_cache`)."""
        return make_cache(self.cfg, b, total, self.device, kv_dtype)

    def layer_cache(self, cache, i: int):
        """Layer ``i``'s part of a cache from :meth:`make_cache`."""
        return cache[i]

    def hidden_states(self, ids, attn_mask=None, *, positions=None, cache=None, cache_index=None):
        """ids (B, T) -> final-norm hidden states (B, T, D) f32.

        With ``cache`` (:func:`make_cache`) the mask (B, T, L) bool covers
        the attended cache columns, and the new keys and values are written
        into the cache in place at slot ``cache_index``: an int, or a (B,)
        tensor of per-row cursors (causal_lm.py:270-311; the ALiBi bias
        and the local-window mask are then in cache-slot space per row)."""
        cfg = self.cfg
        b, t = ids.shape
        dev = ids.device
        if positions is None:
            positions = torch.arange(t, device=dev)[None, :].expand(b, t)
        # positions past the tables read their last row, as JAX's clamped
        # gathers do (a prompt + answer longer than max_seq_len)
        positions = positions.clamp(0, cfg.max_seq_len - 1)
        x = self.embed(ids)
        if cfg.scale_embedding:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=dev)
        rope = None
        if cfg.positional == "learned":
            x = x + self.pos_embed[positions]
        elif cfg.positional == "rope":
            rot = int(cfg.head_dim * cfg.rope_pct)
            rot -= rot % 2
            rope = rope_frequencies(rot, cfg.max_seq_len, cfg.rope_theta, device=dev)
        adt = torch.bfloat16 if cfg.activations_bf16 else None
        if self.emb_ln is not None:
            x = self.emb_ln(x, out_dtype=adt)
        elif adt is not None:
            x = x.to(adt)
        kinds = _layer_kinds(cfg)
        has_local = "local" in kinds
        alibi = cfg.positional == "alibi"

        flash = flash_local = None
        if cache is None:
            bias = alibi_bias(cfg.n_heads, t, cfg.alibi_mode, cfg.alibi_bias_max, dev) if alibi else None
            mask = causal_mask(t, dev)
            if attn_mask is not None:
                mask = mask & attn_mask[:, None, :].bool()
            if cfg.use_flash_attention:
                # right-padded batches: (causal & padding) is exactly
                # (kv_lens, causal=True) for the fused kernels
                lens = attn_mask.sum(dim=1).to(torch.int32) if attn_mask is not None else None
                flash = {"kv_lens": lens, "causal": True}
            local_mask = None
            if has_local:
                slots = torch.arange(t, device=dev)
                local_mask = mask & _window_mask(slots, slots, cfg.attention_window)
                if flash is not None:
                    # (causal & padding & window) is the kernels' sliding-window form
                    flash_local = dict(flash, window=cfg.attention_window)
        else:
            # decode: keys live in the cache; ALiBi uses cache-SLOT positions
            # (a per-row padding shift of every key is a softmax row constant)
            cache_len = attn_mask.shape[-1]
            bias = alibi_bias(cfg.n_heads, cache_len, cfg.alibi_mode, cfg.alibi_bias_max, dev) if alibi else None
            mask = attn_mask
            local_mask = None
            if has_local:
                steps = torch.arange(t, device=dev)
                q_slots = (cache_index[:, None] + steps if isinstance(cache_index, torch.Tensor)
                           else cache_index + steps)
                local_mask = mask & _window_mask(q_slots, torch.arange(cache_len, device=dev),
                                                 cfg.attention_window)
        remat = cache is None and cfg.scan_layers and cfg.remat_policy != "none"
        for i, (blk, kind) in enumerate(zip(self.blocks, kinds)):
            local = kind == "local"
            run = remat_wrap(blk, cfg.remat_policy) if remat else blk
            x = run(x, mask=local_mask if local else mask, rope=rope, positions=positions,
                    cache=None if cache is None else self.layer_cache(cache, i), cache_index=cache_index,
                    parallel_residual=cfg.parallel_residual, scale=cfg.attention_scale,
                    activation=cfg.activation, bias=bias, clip=cfg.clip_qkv, activation_dtype=adt,
                    flash=flash_local if local else flash)
        return self.ln_f(x)

    def head_weight(self):
        """(D, V) classifier: the embedding transpose for tied heads."""
        return self.tok_embed.T if self.cfg.tie_embeddings else self.lm_head.w

    def classifier_parts(self) -> list:
        """The classifier as (D, V_j) parts over consecutive vocabulary
        ranges, each on its device: one part here."""
        return [self.head_weight()]

    def head(self, x):
        """(…, D) hidden states -> (…, V) f32 logits (bf16 inputs)."""
        return _matmul(x, self.head_weight())

    def forward(self, ids, attn_mask=None, *, positions=None, cache=None, cache_index=None):
        """ids (B, T) -> logits (B, T, V) f32."""
        return self.head(self.hidden_states(ids, attn_mask, positions=positions, cache=cache,
                                            cache_index=cache_index))


def loss_fn(model: CausalLM, batch: dict):
    """Next-token cross-entropy with -100 masking -> (mean_loss, n_target).

    batch: {"input_ids" (B, T), "labels" (B, T)} (an "attention_mask" is
    ignored).  Vocabularies of at least CHUNKED_XENT_MIN_VOCAB stream the
    classifier in chunks (ops/xent.py).  The forward is unmasked, as in
    the JAX package (causal_lm.py:375-380): with right padding and causal
    attention no real query attends a padded key, and padded positions
    carry IGNORE_INDEX labels, so loss and gradients are the same."""
    from ..ops.xent import masked_mean_xent

    labels = batch["labels"][:, 1:]
    if model.cfg.vocab_size >= CHUNKED_XENT_MIN_VOCAB:
        h = model.hidden_states(batch["input_ids"], None)
        return masked_mean_xent(h[:, :-1], model.classifier_parts(), labels, IGNORE_INDEX)
    logits = model(batch["input_ids"], None)[:, :-1]
    valid = labels != IGNORE_INDEX
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
    n = valid.sum().clamp_min(1)
    return -torch.where(valid, token_ll, 0.0).sum() / n, n


def _init_dense_norms(module: nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, Dense):
                s = 1.0 / mod.w.shape[0] ** 0.5
                mod.w.uniform_(-s, s, generator=generator)
                if mod.b is not None:
                    mod.b.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                if mod.bias is not None:
                    mod.bias.zero_()


def init_causal_lm(cfg: ModelConfig, generator: torch.Generator, *, quantize: str | None = None) -> CausalLM:
    """Random weights with the JAX ``init_causal_lm`` distributions:
    embeddings N(0, 0.02^2), dense weights U(-1/sqrt(d_in), 1/sqrt(d_in)),
    zero biases, unit norm scales.  Drawn from ``generator`` on its own
    device, layer by layer; with ``quantize`` (a mode of models/quantize.py)
    each layer is quantized as soon as it is made, so a multi-billion-parameter
    reader never holds more than one float layer.  Every parameter comes
    back frozen (``requires_grad`` False); a trainer unfreezes what it
    trains."""
    device = generator.device
    model = CausalLM(cfg, device="meta")
    model.blocks = nn.ModuleList()
    model.to_empty(device=device)
    with torch.no_grad():
        model.tok_embed.normal_(0.0, 0.02, generator=generator)
        for _ in range(cfg.n_layers):
            blk = _block(cfg, device)
            _init_dense_norms(blk, generator)
            if quantize:
                quantize_dense_tree(blk, quantize)
            model.blocks.append(blk)
        _init_dense_norms(model.ln_f, generator)
        if model.pos_embed is not None:
            model.pos_embed.normal_(0.0, 0.02, generator=generator)
        if model.emb_ln is not None:
            _init_dense_norms(model.emb_ln, generator)
        if model.lm_head is not None:
            _init_dense_norms(model.lm_head, generator)
    return model.eval().requires_grad_(False)


class TPCausalLM(SplitVocab, CausalLM):
    """A :class:`CausalLM` split tensor-parallel over the ``model`` axis
    of a mesh, one controller driving every device (made by
    ``parallel.sharding.shard_params``).  The forward is the unsharded
    one (``hidden_states``) over these parts:

    - attention head-parallel (:class:`~.layers.TPAttention`) where the
      heads split over the devices, else whole on the lead device; the
      cache then holds one dict a (layer, device), layer-major, each
      device's buffers over its own kv heads (:meth:`make_cache`);
    - the MLP hidden split (:class:`~.layers.TPMLP`) where ``d_ff``
      divides;
    - the vocabulary as :class:`~.layers.SplitVocab` places it;
    - norms, positions and biases of the row-parallel sums replicated on
      the lead device, where the residual stream lives.

    As in the JAX package, the flash route is the cache-less forward's:
    a prefill attends through the cache."""

    def __init__(self, model: CausalLM, devices, *, split_attention: bool, split_mlp: bool, split_vocab: bool,
                 split_head: bool):
        nn.Module.__init__(self)
        cfg = self.cfg = model.cfg
        self.devices = list(devices)
        lead = self.lead = self.devices[0]
        self.groups = head_groups(cfg.n_heads, cfg.kv_heads, len(self.devices)) if split_attention else None
        self.place_vocab(model, split_vocab, split_head)
        self.pos_embed = None if model.pos_embed is None else nn.Parameter(model.pos_embed.detach().to(lead),
                                                                           requires_grad=False)
        self.emb_ln = None if model.emb_ln is None else clone_module(model.emb_ln, lead)
        self.ln_f = clone_module(model.ln_f, lead)
        self.blocks = nn.ModuleList(tp_block(blk, self.groups, cfg.head_dim, self.devices, lead, split_mlp=split_mlp)
                                    for blk in model.blocks)

    def head(self, x):
        return self.vocab_logits(x)

    def make_cache(self, b: int, total: int, kv_dtype: str = "bf16") -> list[dict]:
        """One dict a (layer, device), layer-major, each on its device over
        the kv heads its query heads read; a cache of the lead device's
        layers where attention runs whole."""
        if self.groups is None:
            return make_cache(self.cfg, b, total, self.lead, kv_dtype)
        return [make_cache(self.cfg, b, total, dev, kv_dtype, n_layers=1, kv_heads=k1 - k0)[0]
                for _ in range(self.cfg.n_layers) for (_, _, k0, k1), dev in zip(self.groups, self.devices)]

    def layer_cache(self, cache, i: int):
        if self.groups is None:
            return cache[i]
        n = len(self.devices)
        return cache[i * n:(i + 1) * n]
