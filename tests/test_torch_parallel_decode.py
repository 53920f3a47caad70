"""The port's decode split by rows (vqvae_tpu_torch/infer/parallel.py,
``vqvae-torch-decode --mesh-data``): bit-equal to the one-call decode,
greedy and sampled, on every engine, as the JAX package's sharded decode
is (tests/test_infer_parallel.py), because each shard passes its first
row as ``row0`` to the noise (kernels/decode_cuda.py::gumbel_noise, the
decode kernel's counter).  The CPU stands in for N devices."""

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.audio.wav_io import load_wav
from vqvae_tpu_torch.cli import decode
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.infer.fastgen import decode_from_codes
from vqvae_tpu_torch.infer.parallel import decode_from_codes_sharded
from vqvae_tpu_torch.kernels import decode_cuda as dc
from vqvae_tpu_torch.models import init_model
from vqvae_tpu_torch.train.checkpoint import export_weights

torch.set_num_threads(1)
CFG = get_config("tiny").model


@pytest.fixture(scope="module")
def params():
    return init_model(CFG, torch.Generator().manual_seed(0))


def _codes(B, Tl=4, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, CFG.K, (B, Tl))),
            torch.from_numpy(rng.integers(0, CFG.n_speakers, (B,))))


@pytest.mark.parametrize("greedy,impl", [(True, "lax"), (False, "lowmem"),
                                         (False, "pallas"), (True, "lowmem")])
def test_sharded_decode_matches_one_call(params, greedy, impl):
    codes, spk = _codes(8)
    ref = decode_from_codes(params, CFG, codes, spk, 7, greedy=greedy,
                            impl=impl)
    got = decode_from_codes_sharded(params, CFG, codes, spk, 7, ["cpu"] * 4,
                                    greedy=greedy, impl=impl)
    assert torch.equal(got, ref)


def test_uneven_shards_and_row0(params):
    """Rows 3..4 of a sampled B=5 decode are a call on those rows with
    row0=3; without it they would draw rows 0..1's noise."""
    codes, spk = _codes(5, seed=1)
    ref = decode_from_codes(params, CFG, codes, spk, 3, impl="pallas")
    got = decode_from_codes_sharded(params, CFG, codes, spk, 3, ["cpu"] * 2,
                                    impl="pallas")
    assert torch.equal(got, ref)
    part = decode_from_codes(params, CFG, codes[3:], spk[3:], 3,
                             impl="pallas", row0=3)
    assert torch.equal(part, ref[3:])
    wrong = decode_from_codes(params, CFG, codes[3:], spk[3:], 3,
                              impl="pallas")
    assert not torch.equal(wrong, ref[3:])


def test_gumbel_noise_row0_is_a_slice_of_the_batch():
    full = dc.gumbel_noise(5, 40, 30, 9, 256)
    for r0, n in ((0, 9), (2, 3), (8, 1)):
        np.testing.assert_array_equal(
            dc.gumbel_noise(5, 40, 30, n, 256, row0=r0).numpy(),
            full[:, r0:r0 + n].numpy())
    with pytest.raises(ValueError, match="row0"):
        dc.generate_ids(None, CFG, torch.zeros(1, 1, CFG.d),
                        torch.zeros(1), row0=-1)


def test_decode_cli_mesh_data_equals_one_decode(params, tmp_path):
    w = str(tmp_path / "w.npz")
    export_weights(w, params)
    codes, _ = _codes(4, Tl=3, seed=2)
    np.save(tmp_path / "c.npy", codes.numpy())
    base = ["--preset", "tiny", "--device", "cpu", "-m", w, "-i",
            str(tmp_path / "c.npy"), "-s", "0", "1", "2", "3", "--seed", "4"]
    decode.main(base + ["-o", str(tmp_path / "one")])
    decode.main(base + ["-o", str(tmp_path / "two"), "--mesh-data", "2"])
    for i in range(4):
        a = load_wav(str(tmp_path / "one" / f"c_{i:03d}.wav"), 16000)
        b = load_wav(str(tmp_path / "two" / f"c_{i:03d}.wav"), 16000)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):
        decode.main(base + ["-o", str(tmp_path / "x"), "--mesh-data", "3"])
