"""Which widths the decode kernel takes (``kernels/decode_cuda.py``).

The kernel splits each batch row over a 16-block cluster, so R, S and
mu must be multiples of 16 (R, d <= 128, d even; S, mu <= 512; at least
2 layers).  The check runs on the host before any launch, so it is
tested here; the kernel itself only runs on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import pytest

from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.kernels import decode_cuda as dc


@pytest.mark.parametrize("preset", ["tiny", "vctk-multi", "stretch"])
def test_the_presets_widths_pass(preset):
    dc.check_widths(get_config(preset).model)


@pytest.mark.parametrize("change,needle", [
    ({"residual_channels": 40}, "R=40 is not a multiple of 16"),
    ({"skip_channels": 72}, "S=72 is not a multiple of 16"),
    ({"mu": 200}, "mu=200 is not a multiple of 16"),
    ({"residual_channels": 144}, "R, d <= 128"),
    ({"d": 7}, "d even"),
    ({"skip_channels": 528}, "S, mu <= 512"),
    ({"n_loop": 1, "n_layer": 1}, "at least 2 layers"),
])
def test_other_widths_raise_with_the_reason(change, needle):
    cfg = dataclasses.replace(get_config("tiny").model, **change)
    with pytest.raises(ValueError, match=needle):
        dc.check_widths(cfg)
