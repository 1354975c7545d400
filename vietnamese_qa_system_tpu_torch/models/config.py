"""Model configuration (the encoder slice of the JAX package's configs).

A copy of ``vietnamese_qa_system_tpu/models/config.py``: the same frozen
``ModelConfig`` dataclass, so one config can drive both packages in the
parity tests, and the presets the retrieval path uses (``tiny_test``,
``minilm_class``, ``mpnet_class``).  The JAX module cannot be imported
without jax (``models/__init__.py`` imports every JAX model).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: Literal["encoder", "causal", "seq2seq"] = "causal"
    vocab_size: int = 512
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 1024
    max_seq_len: int = 1024
    # decoder stack for seq2seq (encoder uses n_layers)
    n_decoder_layers: int | None = None
    # "rope" for causal/seq2seq decoders, "learned" for the encoder family,
    # "alibi" for the BLOOM family (per-head linear score bias, no position
    # table — the architecture of the most common Vietnamese base models,
    # bloomz/vietcuna, loadable through the reference's AutoModelForCausalLM
    # path at reference src/models/trainer.py:536-551)
    positional: Literal["rope", "learned", "alibi"] = "rope"
    # ALiBi slope construction for non-power-of-two head counts: "bloom"
    # extends the closest LOWER power of two's sequence (HF
    # build_alibi_tensor); "mpt" builds the next HIGHER power of two's
    # sequence and interleaves (HF build_mpt_alibi_tensor — the MPT/PhoGPT
    # family, e.g. vinai/PhoGPT-4B with 24 heads).  Identical for
    # power-of-two head counts at alibi_bias_max=8.
    alibi_mode: str = "bloom"
    alibi_bias_max: float = 8.0
    # MPT attn_config.clip_qkv: clamp q/k/v projections to [-clip, clip]
    # before attention (None = off)
    clip_qkv: float | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dropout_rate: float = 0.0  # inference default; trainer may override
    # fused Pallas attention (ops/attention.py) on the non-cached causal
    # path — capability of the reference's --use_flash_attention_2 flag
    use_flash_attention: bool = False
    # GPT-NeoX-style (pythia) architecture knobs, enabling faithful import
    # of the reference's pythia-410m family (scripts/train_test.sh):
    # x + attn(ln1(x)) + mlp(ln2(x)) instead of sequential residuals
    parallel_residual: bool = False
    # fraction of head_dim that RoPE rotates (NeoX rotary_pct, e.g. 0.25)
    rope_pct: float = 1.0
    norm: str = "layernorm"  # "layernorm" | "rmsnorm" (llama family)
    # encoder-family knobs for faithful BERT import (MiniLM-class
    # sentence-transformers weights, models/convert_hf.py):
    norm_position: str = "pre"  # "pre" | "post" (BERT is post-LN)
    bert_embeddings: bool = False  # embedding LayerNorm + token-type table
    # MPNet-family knobs (paraphrase-mpnet-base-v2, the reference's second
    # encoder, heavy_ranker.py:83-88): embedding LayerNorm without a
    # token-type table, RoBERTa-style position indexing (padding_idx+1
    # offset), and a shared T5-style bucketed relative attention bias
    embed_layernorm: bool = False
    position_offset: int = 0  # first real token's position id (MPNet: 2)
    relative_attention_buckets: int = 0  # 0 = absolute positions only
    relative_attention_max_distance: int = 128
    # GPT-Neo / GPT-2 family knobs (EleutherAI/gpt-neo-125m is the
    # reference's canonical training model, reference scripts/train.sh:7;
    # the reference special-cases gpt2 at src/models/trainer.py:529):
    # - GPT-Neo attends WITHOUT the 1/sqrt(head_dim) scaling
    #   (attention_scale=1.0); None = standard scaling.
    # - attention_layers: per-layer "global" | "local"; GPT-Neo alternates,
    #   local layers see a sliding window of ``attention_window`` keys.
    # - activation "gelu_new" is the tanh approximation both families use.
    attention_scale: float | None = None
    attention_layers: tuple | None = None
    attention_window: int = 256
    activation: str = "gelu"  # "gelu" (erf, HF default) | "gelu_new" (tanh)
    # Llama-family knobs (beyond the reference's model zoo, included so the
    # causal stack covers the modern open-weights family): RMSNorm blocks,
    # SwiGLU gated MLPs, grouped-query attention, bias-free projections.
    n_kv_heads: int | None = None  # None = multi-head (no GQA)
    mlp_gated: bool = False
    # True = biases everywhere (GPT families), False = bias-free (llama),
    # "qkv" = biases on the q/k/v projections only (Qwen2 family — the
    # strongest multilingual open weights for Vietnamese today)
    attention_bias: bool | str = True
    # Seq2seq family selection for arch="seq2seq":
    # - "t5" selects models/t5.py (T5 RMS norms, per-stack shared relative
    #   bias, unscaled attention, gated-gelu FFN) — the reference's mt5
    #   path (src/test.py:106-147);
    # - "bart" selects models/bart.py (mBART pre-LN, learned +2-offset
    #   positions, embedding layernorm, tied head) — the reference's
    #   vinai-translate en→vi model (data_parser.py:75-93) is mBART;
    # - "native" keeps the framework's RoPE encoder-decoder
    #   (models/seq2seq.py).
    seq2seq_family: str = "native"
    # mBART multiplies token embeddings by sqrt(d_model) (HF
    # scale_embedding); only the bart family reads this.
    scale_embedding: bool = False
    # T5 decouples the attention inner dim from d_model: head_dim = d_kv
    # (mt5-small: 6 heads x 64 = 384 vs d_model 512).  None = d_model/heads.
    d_kv: int | None = None
    # Stack homogeneous decoder blocks into one leading-L pytree and run
    # them under lax.scan (T5X/MaxText-style scan-over-layers): ONE kernel
    # lowering + one layer compile regardless of depth — compile time is
    # O(1) in n_layers instead of O(n_layers), which dominates for deep
    # models with Pallas kernels.  Requires uniform layers (no GPT-Neo
    # local/global alternation).  The stacked pytree is the on-disk and
    # in-memory format when this is set (models/causal_lm.py::stack_blocks).
    scan_layers: bool = False
    # Remat granularity for the scan-over-layers path (layers.remat_wrap):
    # "full" = recompute the whole layer in bwd (min memory);
    # "dots" = save matmul outputs + the flash-attention out/lse, recompute
    # only elementwise glue — trades ~B*T*(4d+2ff) saved f32/layer for
    # skipping the fwd recompute (~25% of step FLOPs; measured numbers in
    # docs/BENCHMARKS.md);
    # "proj_bf16" = like "dots" but the saves are rounded to bf16 (half
    # the bytes that made dots OOM) and the fused-QLoRA dequant re-gather
    # is skipped too — the flagship training policy (layers.remat_wrap);
    # "none" = no remat (deep flash stacks OOM).  The capability knob
    # behind torch's gradient_checkpointing_enable (reference
    # src/models/trainer.py:527-533), with selectivity torch's flag lacks.
    remat_policy: str = "full"
    # bf16 residual/norm-output activations (norm math stays fp32):
    # standard inference mixed precision; halves inter-op HBM traffic.
    # On by default only for the retrieval encoders (their outputs are
    # mean-pooled unit vectors — tested to keep HF parity within 0.03).
    activations_bf16: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        if self.d_kv is not None:
            return self.d_kv
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def decoder_layers(self) -> int:
        return self.n_decoder_layers or self.n_layers

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        d = dict(d)
        if d.get("attention_layers") is not None:
            # JSON has no tuples; the config stays hashable
            d["attention_layers"] = tuple(d["attention_layers"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        return cls.from_dict(json.loads(s))


# Ready-made sizes of the retrieval encoders (MiniLM-L12 / mpnet-base class).
def tiny_test(arch="causal") -> ModelConfig:
    return ModelConfig(
        arch=arch, vocab_size=512, d_model=128, n_heads=4, n_layers=2,
        d_ff=512, max_seq_len=256,
        positional="learned" if arch == "encoder" else "rope",
    )


def minilm_class() -> ModelConfig:
    """~33M-param sentence encoder (MiniLM-L12 class, 384-d)."""
    return ModelConfig(
        arch="encoder", vocab_size=32000, d_model=384, n_heads=12,
        n_layers=12, d_ff=1536, max_seq_len=512, positional="learned",
        use_flash_attention=True, activations_bf16=True,
    )


def mpnet_class() -> ModelConfig:
    """~110M-param sentence encoder, faithful mpnet-base layout
    (paraphrase-mpnet-base-v2: post-LN, embedding LN, position offset 2,
    32-bucket shared relative attention bias) so real MPNet weights
    import via models/convert_hf.py::load_mpnet."""
    return ModelConfig(
        arch="encoder", vocab_size=30527, d_model=768, n_heads=12,
        n_layers=12, d_ff=3072, max_seq_len=514, positional="learned",
        norm_eps=1e-5, norm_position="post", embed_layernorm=True,
        position_offset=2, relative_attention_buckets=32,
        use_flash_attention=True, activations_bf16=True,
    )
