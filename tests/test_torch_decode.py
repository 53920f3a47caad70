"""The decode kernel's plain PyTorch version (kernels/decode_cuda.py on
CPU tensors) against the JAX decode: teacher-forced logits, greedy ids,
bf16 at flagship width; inside the port, the step equals teacher
forcing and resumed pushes equal one-shot bit for bit; and the Philox
generator against the Random123 known answers.  The CUDA kernel itself
is compared with this plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.infer.fastgen import (
    teacher_forced_scan_logits as jax_scan_logits,
)
from vqvae_tpu.kernels.decode_pallas import (
    generate_ids_pallas_resume,
    init_decode_state as jax_init_state,
    teacher_logits_pallas,
)
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.models.wavenet import global_cond as jax_global_cond
from vqvae_tpu.models.wavenet import make_gen_params as jax_gen_params
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten, from_numpy_tree, xoh_to_x_last
from vqvae_tpu_torch.infer.fastgen import teacher_forced_scan_logits
from vqvae_tpu_torch.kernels import decode_cuda as dc
from vqvae_tpu_torch.models.wavenet import (
    apply_decoder,
    global_cond,
    make_gen_params,
)

torch.set_num_threads(1)


def _setup(jcfg, B, T, seed=0):
    """JAX params + the same params in the port, and numpy-made inputs."""
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    params = from_numpy_tree(flatten(jax.tree_util.tree_map(np.asarray,
                                                            jparams)))
    rng = np.random.default_rng(seed + 1)
    cond = rng.standard_normal((B, T, jcfg.d)).astype(np.float32)
    ids = rng.integers(0, jcfg.mu, (B, T)).astype(np.int32)
    spk = (np.arange(B) % jcfg.n_speakers).astype(np.int32)
    return jparams, params, cond, ids, spk


def _port(params, cfg, spk):
    dec = params.decoder
    return (make_gen_params(dec, cfg),
            global_cond(dec, cfg, torch.from_numpy(spk).long()))


def test_teacher_logits_match_jax_tiny():
    jcfg, cfg = jax_config("tiny").model, get_config("tiny").model
    jparams, params, cond, ids, spk = _setup(jcfg, 2, 300)
    jdec = jparams["decoder"]
    want_kernel = np.asarray(teacher_logits_pallas(
        jax_gen_params(jdec, jcfg), jcfg, jnp.asarray(ids),
        jnp.asarray(cond), jax_global_cond(jdec, jcfg, jnp.asarray(spk))))
    want_scan = np.asarray(jax_scan_logits(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(cond),
        jnp.asarray(spk)))
    gp, gcond = _port(params, cfg, spk)
    got = dc.teacher_logits(gp, cfg, torch.from_numpy(ids),
                            torch.from_numpy(cond), gcond).numpy()
    assert got.shape == (2, 300, cfg.mu) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_scan, rtol=1e-4, atol=1e-4)


def test_greedy_ids_match_jax_resume_kernel():
    jcfg, cfg = jax_config("tiny").model, get_config("tiny").model
    T = 384
    jparams, params, cond, _, spk = _setup(jcfg, 2, T, seed=3)
    jdec = jparams["decoder"]
    jgp = jax_gen_params(jdec, jcfg)
    jgc = jax_global_cond(jdec, jcfg, jnp.asarray(spk))
    state = jax_init_state(jcfg, 2, jgp.wff.dtype)
    pieces = []
    for i in range(0, T, 128):
        ids_j, state = generate_ids_pallas_resume(
            jgp, jcfg, jnp.asarray(cond[:, i:i + 128]), jgc, jnp.int32(0),
            jnp.float32(1.0), state, greedy=True)
        pieces.append(np.asarray(ids_j))
    want = np.concatenate(pieces, axis=1)
    # JAX's top-2 margin along its own greedy path
    x_in = np.concatenate([np.full((2, 1), jcfg.mu // 2, np.int32),
                           want[:, :-1]], axis=1)
    lg = np.asarray(jax_scan_logits(jparams, jcfg, jnp.asarray(x_in),
                                    jnp.asarray(cond), jnp.asarray(spk)))
    top = np.sort(lg, axis=-1)[..., -2:]
    tight = (top[..., 1] - top[..., 0]) < 1e-4
    gp, gcond = _port(params, cfg, spk)
    got = dc.generate_ids(gp, cfg, torch.from_numpy(cond), gcond,
                          greedy=True).numpy()
    for b in range(2):
        n = int(np.argmax(tight[b])) if tight[b].any() else T
        assert n >= 256, n
        np.testing.assert_array_equal(got[b, :n], want[b, :n])
    # the carried state agrees too (last id, as JAX's one-hot)
    np.testing.assert_array_equal(xoh_to_x_last(np.asarray(state.xoh)),
                                  got[:, -1])


def test_bf16_flagship_width_logits():
    """vctk-multi widths cut to 4 layers, bf16 compute: the plain
    version's cast points against the bf16 Pallas kernel."""
    jcfg = dataclasses.replace(jax_config("vctk-multi").model, n_loop=1,
                               n_layer=4)
    cfg = dataclasses.replace(get_config("vctk-multi").model, n_loop=1,
                              n_layer=4)
    jparams, params, cond, ids, spk = _setup(jcfg, 1, 128, seed=5)
    jdec = jparams["decoder"]
    want = np.asarray(teacher_logits_pallas(
        jax_gen_params(jdec, jcfg), jcfg, jnp.asarray(ids),
        jnp.asarray(cond), jax_global_cond(jdec, jcfg, jnp.asarray(spk))))
    gp, gcond = _port(params, cfg, spk)
    assert gp.wff.dtype == torch.bfloat16
    got = dc.teacher_logits(gp, cfg, torch.from_numpy(ids),
                            torch.from_numpy(cond), gcond).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 3e-2 * scale


@pytest.mark.parametrize("T", [256, 1100])   # 1100 wraps every buffer
def test_step_equals_teacher_forcing(T):
    cfg = get_config("tiny").model
    _, params, cond, ids, spk = _setup(jax_config("tiny").model, 2, T)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(cond),
            torch.from_numpy(spk).long())
    want = apply_decoder(params.decoder, cfg, *args)
    got = teacher_forced_scan_logits(params, cfg, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("greedy", [True, False])
def test_resume_any_split_equals_one_shot(dtype, greedy):
    cfg = dataclasses.replace(get_config("tiny").model, compute_dtype=dtype)
    T = 200
    _, params, cond, _, spk = _setup(jax_config("tiny").model, 2, T, 7)
    gp, gcond = _port(params, cfg, spk)
    cond = torch.from_numpy(cond)
    one, st1 = dc.generate_ids_resume(
        gp, cfg, cond, gcond, 11, 0.8,
        dc.init_decode_state(cfg, 2, gp.wff.dtype), greedy)
    assert torch.equal(one, dc.generate_ids(gp, cfg, cond, gcond, 11, 0.8,
                                            greedy))
    for split in ([1, 199], [64, 1, 135], [37, 0, 100, 63]):
        st = dc.init_decode_state(cfg, 2, gp.wff.dtype)
        pieces, i = [], 0
        for w in split:
            ids, st = dc.generate_ids_resume(gp, cfg, cond[:, i:i + w],
                                             gcond, 11, 0.8, st, greedy)
            pieces.append(ids)
            i += w
        assert torch.equal(torch.cat(pieces, 1), one), split
        assert st.t0 == st1.t0 == T
        for a, b in zip(st[1:], st1[1:]):
            assert torch.equal(a, b)
    if not greedy:   # the seed matters; the noise is a real sampler
        other = dc.generate_ids(gp, cfg, cond, gcond, 12, 0.8, False)
        assert not torch.equal(other, one)


def test_teacher_logits_from_a_resumed_state():
    """Teacher forcing from the state after a first push equals the tail
    of teacher forcing over the whole stream, on the sampled history."""
    cfg = get_config("tiny").model
    T, T1 = 150, 61
    _, params, cond, _, spk = _setup(jax_config("tiny").model, 2, T, 13)
    gp, gcond = _port(params, cfg, spk)
    cond = torch.from_numpy(cond)
    ids = dc.generate_ids(gp, cfg, cond, gcond, 5, 0.9)
    x_in = torch.cat([torch.full((2, 1), cfg.mu // 2, dtype=torch.int32),
                      ids[:, :-1]], 1)
    whole = dc.teacher_logits(gp, cfg, x_in, cond, gcond)
    _, st1 = dc.generate_ids_resume(
        gp, cfg, cond[:, :T1], gcond, 5, 0.9,
        dc.init_decode_state(cfg, 2, gp.wff.dtype))
    tail = dc.teacher_logits(gp, cfg, x_in[:, T1:], cond[:, T1:], gcond, st1)
    assert torch.equal(tail, whole[:, T1:])


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = dc.philox4x32_10(*c, *key)
    assert tuple(int(w) for w in got) == want


def test_gumbel_noise_is_absolute_step_indexed():
    a = dc.gumbel_noise(5, 0, 300, 2, 256)
    b = dc.gumbel_noise(5, 100, 150, 2, 256)
    assert torch.equal(a[100:250], b)
    u = torch.exp(-torch.exp(-a))   # back to U(0, 1)
    assert 0.45 < float(u.mean()) < 0.55
    assert torch.isfinite(a).all()


def test_cpu_tensors_never_launch():
    cfg = get_config("tiny").model
    _, params, cond, ids, spk = _setup(jax_config("tiny").model, 1, 20)
    gp, gcond = _port(params, cfg, spk)
    before = dc.launches
    dc.generate_ids(gp, cfg, torch.from_numpy(cond), gcond, 0, 1.0, False)
    dc.teacher_logits(gp, cfg, torch.from_numpy(ids),
                      torch.from_numpy(cond), gcond)
    assert dc.launches == before == 0
    with pytest.raises(ValueError, match="device"):
        dc.generate_ids(gp, cfg, torch.from_numpy(cond).to("meta"), gcond)


def test_synthesize_is_encode_then_decode():
    from vqvae_tpu_torch.audio.mu_law import mu_law_round_trip
    from vqvae_tpu_torch.infer.fastgen import (
        decode_from_codes,
        encode_to_codes,
        synthesize,
    )
    cfg = get_config("tiny").model
    _, params, _, _, _ = _setup(jax_config("tiny").model, 1, 1)
    rng = np.random.default_rng(9)
    wav = torch.from_numpy((rng.standard_normal((1, 3 * cfg.hop + 5))
                            * 0.3).astype(np.float32))
    out, codes = synthesize(params, cfg, wav, torch.tensor([2]), seed=4)
    want_codes = encode_to_codes(
        params, cfg, mu_law_round_trip(wav[:, :3 * cfg.hop]))
    assert torch.equal(codes, want_codes) and codes.shape == (1, 3)
    want = decode_from_codes(params, cfg, codes, torch.tensor([2]), seed=4)
    assert out.shape == (1, 3 * cfg.hop) and torch.equal(out, want)
    assert float(out.abs().max()) <= 1.0


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_streaming_synthesizer_any_split_equals_one_shot(greedy):
    """Pushes of any width (0 and 1 frame included), then ``flush``,
    give one-shot ``decode_from_codes``'s waveform bit for bit; so does
    the ``lowmem`` decode, at a chunk that does not divide the stream."""
    from vqvae_tpu_torch.infer.fastgen import decode_from_codes
    from vqvae_tpu_torch.infer.streaming import StreamingSynthesizer
    cfg = get_config("tiny").model
    _, params, _, _, _ = _setup(jax_config("tiny").model, 1, 1)
    codes = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.K, (2, 11)))
    spk = torch.tensor([1, 3])
    one = decode_from_codes(params, cfg, codes, spk, 6, 0.8, greedy)
    syn = StreamingSynthesizer(params, cfg, spk, 6, 0.8, greedy)
    pieces, i = [], 0
    for w in (3, 0, 1, 7):
        pieces.append(syn.push(codes[:, i:i + w]))
        i += w
    pieces.append(syn.flush())
    assert pieces[0].shape == (2, 3 * cfg.hop - cfg.hop // 2)
    assert torch.equal(torch.cat(pieces, 1), one)
    from vqvae_tpu_torch.infer.lowmem import decode_from_codes_lowmem
    low = decode_from_codes_lowmem(params, cfg, codes, spk, 6, 0.8, greedy,
                                   chunk_samples=4 * cfg.hop)
    assert torch.equal(low, one)
