from vqvae_tpu_torch.models.params import ParamTree  # noqa: F401
from vqvae_tpu_torch.models.vqvae import (  # noqa: F401
    encode,
    forward,
    init_model,
    init_vq_state,
)
