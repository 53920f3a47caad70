from vqvae_tpu_torch.configs.presets import (  # noqa: F401
    PRESETS,
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    arch,
    config_from_json,
    get_config,
    load_config,
)
from vqvae_tpu_torch.configs.wavenet_ae import (  # noqa: F401
    WaveNetAEConfig,
)
