"""Inference: synthesis, streaming encode and decode, and the kernel
serving engine."""

from vqvae_tpu_torch.infer.enc_streaming import (  # noqa: F401
    StreamingEncoder,
)
from vqvae_tpu_torch.infer.fastgen import (  # noqa: F401
    decode_from_codes,
    generate_ids,
    synthesize,
    teacher_forced_scan_logits,
)
