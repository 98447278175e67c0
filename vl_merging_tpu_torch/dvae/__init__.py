"""The MIM tokenizer: the DALL-E discrete VAE's encoder and decoder, and
the trainable Gumbel-softmax DiscreteVAE (port of
``vl_merging_tpu/dvae``).  Library convolutions (``F.conv2d``,
``F.conv_transpose2d``): no TPU kernel runs here."""

from .decoder import (  # noqa: F401
    decode_indices, decoder_output, load_decoder_params, unmap_pixels,
)
from .discrete import (  # noqa: F401
    DiscreteVAEConfig, get_codebook_probs, init_discrete_vae_params,
)
from .encoder import (  # noqa: F401
    VOCAB_SIZE, encoder_logits, get_codebook_indices, init_encoder_params,
    load_encoder_params, make_mim_label_fn,
)
