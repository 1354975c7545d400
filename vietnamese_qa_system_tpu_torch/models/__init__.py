from .config import ModelConfig, minilm_class, mpnet_class, tiny_test
from .encoder import SentenceEncoder, init_encoder, relative_attention_bias
from .params import encoder_from_jax

__all__ = [
    "ModelConfig",
    "SentenceEncoder",
    "encoder_from_jax",
    "init_encoder",
    "minilm_class",
    "mpnet_class",
    "relative_attention_bias",
    "tiny_test",
]
