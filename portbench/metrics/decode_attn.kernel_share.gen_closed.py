"""decode_attn.kernel_share.gen_closed: the share (%) of the closed
generation loop's cached-attention calls in the traced window that the
decode-attention kernel K9 took (``attention_routes.kernel_share``): every
decode step of a bf16 cache; the prefills at bucket width keep the einsum."""

from portbench import attention_routes


def read(rec):
    return attention_routes.kernel_share(rec)
