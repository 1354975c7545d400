from . import decode_engine
from .causal_lm import CausalLM, init_causal_lm, loss_fn, make_cache, unstack_blocks
from .config import (ModelConfig, bloom_560m_class, gpt_125m_class, gpt_neo_125m, llama_1b_class, minilm_class,
                     mpnet_class, phogpt_4b_class, pythia_410m_class, qwen2_05b_class, tiny_test)
from .encoder import SentenceEncoder, init_encoder, relative_attention_bias
from .generate import GenerationConfig, generate_with_config
from .lora import (LoraConfig, clear_lora, count_params, init_lora, load_adapter, merge_lora, select_adapters,
                   stack_adapters)
from .params import (adapter_from_jax, adapter_to_jax, causal_from_hf, causal_from_jax, causal_from_leaves,
                     causal_from_state_dict, encoder_from_hf, encoder_from_jax)
from .quantize import dequantize_tree, dequantize_weight, quantize_dense_tree, quantize_weight, tree_bytes

__all__ = [
    "CausalLM",
    "GenerationConfig",
    "LoraConfig",
    "ModelConfig",
    "SentenceEncoder",
    "adapter_from_jax",
    "adapter_to_jax",
    "bloom_560m_class",
    "causal_from_hf",
    "causal_from_jax",
    "causal_from_leaves",
    "causal_from_state_dict",
    "clear_lora",
    "count_params",
    "decode_engine",
    "dequantize_tree",
    "dequantize_weight",
    "encoder_from_hf",
    "encoder_from_jax",
    "generate_with_config",
    "gpt_125m_class",
    "gpt_neo_125m",
    "init_causal_lm",
    "init_encoder",
    "init_lora",
    "llama_1b_class",
    "load_adapter",
    "loss_fn",
    "make_cache",
    "merge_lora",
    "minilm_class",
    "mpnet_class",
    "phogpt_4b_class",
    "pythia_410m_class",
    "quantize_dense_tree",
    "quantize_weight",
    "qwen2_05b_class",
    "relative_attention_bias",
    "select_adapters",
    "stack_adapters",
    "tiny_test",
    "tree_bytes",
    "unstack_blocks",
]
