"""The partitions of the VQ search kernel and of the dot probe's
``nrd,rde->ne`` kernel, in plain PyTorch (``vq_cuda.vq_argmin_split``,
``upsample_cuda.tap_adjoint_split``), against the plain versions and the
JAX package's functions on numpy-seeded inputs.  The kernels themselves
run on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.kernels.vq_pallas import vq_argmin_pallas
from vqvae_tpu_torch.kernels import upsample_cuda as uc
from vqvae_tpu_torch.kernels import vq_cuda

torch.set_num_threads(1)


def _margin_rows(z, cb, rel=1e-4):
    """Rows whose two best float64 scores differ by more than ``rel`` of
    the largest score magnitude (an id may flip below it)."""
    s = 2.0 * (z.astype(np.float64) @ cb.astype(np.float64).T) - (
        cb.astype(np.float64) ** 2).sum(-1)
    top = np.sort(s, -1)[:, -2:]
    return (top[:, 1] - top[:, 0]) > rel * np.abs(s).max()


# ---- the VQ search: 4 code slices, lanes, the warp's tree, rank order -----

@pytest.mark.parametrize("K,d", [(512, 64), (128, 16)])
@pytest.mark.parametrize("N", [1, 31, 700, 1920])
def test_vq_split_matches_plain_and_jax_pallas(N, K, d):
    """Ids equal to ``vq_argmin_plain``'s and to JAX's Pallas kernel (in
    interpret mode) on every row above the 1e-4 near-tie margin."""
    rng = np.random.default_rng(N + K)
    z = rng.standard_normal((N, d)).astype(np.float32)
    cb = rng.standard_normal((K, d)).astype(np.float32)
    got = vq_cuda.vq_argmin_split(torch.from_numpy(z), torch.from_numpy(cb))
    plain = vq_cuda.vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb))
    want = np.asarray(vq_argmin_pallas(jnp.asarray(z), jnp.asarray(cb),
                                       interpret=True))
    assert got.dtype == torch.int32 and got.shape == (N,)
    far = _margin_rows(z, cb)
    assert far.sum() >= 0.9 * N
    np.testing.assert_array_equal(got.numpy()[far], plain.numpy()[far])
    np.testing.assert_array_equal(got.numpy()[far], want[far])


@pytest.mark.parametrize("first,second", [
    (100, 300),   # two slices (ranks 0 and 2): the rank-order reduction
    (5, 37),      # one lane (5 and 37 are lane 5's): its visiting order
    (5, 6),       # two lanes of a warp: the shuffle tree
    (3, 127),     # lanes 3 and 31: a lane's first code, another's last
    (200, 511),   # ranks 1 and 3, the last code
])
def test_vq_split_ties_go_to_the_first_index(first, second):
    """A code duplicated at two ids: rows nearest to it take the lower
    id, wherever the two copies sit in the kernel's partition."""
    rng = np.random.default_rng(7)
    cb = rng.standard_normal((512, 64)).astype(np.float32)
    cb[second] = cb[first]
    z = (cb[first][None] * rng.uniform(0.8, 1.2, (16, 1))
         + 0.01 * rng.standard_normal((16, 64))).astype(np.float32)
    got = vq_cuda.vq_argmin_split(torch.from_numpy(z), torch.from_numpy(cb))
    plain = vq_cuda.vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb))
    assert (got.numpy() == first).all()
    assert (plain.numpy() == first).all()


@pytest.mark.parametrize("K", [1, 3, 130, 513, 1100])
def test_vq_split_ragged_slices(K):
    """K not a multiple of 4 (empty or short last slices) and slices
    longer than one pass of 128 codes: the plain version's ids above
    the margin."""
    rng = np.random.default_rng(K)
    z = rng.standard_normal((67, 24)).astype(np.float32)
    cb = rng.standard_normal((K, 24)).astype(np.float32)
    got = vq_cuda.vq_argmin_split(torch.from_numpy(z), torch.from_numpy(cb))
    plain = vq_cuda.vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb))
    far = _margin_rows(z, cb) if K > 1 else np.ones(67, bool)
    np.testing.assert_array_equal(got.numpy()[far], plain.numpy()[far])


@pytest.mark.parametrize("K,d,ok", [
    (512, 64, True), (128, 16, True), (3072, 64, True), (512, 256, True),
    (3200, 64, False), (4096, 64, False), (512, 257, False)])
def test_vq_kernel_limits(K, d, ok):
    """The kernel takes every preset's (K, d) and what a quarter of the
    codebook in shared memory allows; the wrapper raises with the limit,
    before it reaches the card, for the rest."""
    assert vq_cuda.kernel_takes(K, d) == ok
    z, cb = torch.zeros(4, d), torch.zeros(K, d)
    if ok:
        assert vq_cuda.kernel_smem(K, d) <= vq_cuda.VQ_SMEM
    else:
        with pytest.raises(ValueError, match="limit is 232448"):
            vq_cuda.vq_argmin_kernel(z, cb)


# ---- the dot probe's nrd,rde->ne: K over an 8-block cluster ---------------

@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,hop,d", [(32, 64, 64), (5, 6, 16), (33, 20, 24),
                                     (3, 130, 64)])
def test_tap_adjoint_split_matches_plain_and_jnp_einsum(N, hop, d, cdt):
    """The kernel's K split (ranks, stages, sub-ranges) and its
    rank-order sum within 1e-4 of max of ``tap_adjoint_plain`` and of
    ``jnp.einsum`` on the same rounded inputs."""
    rng = np.random.default_rng(N * hop + d)
    dp = torch.from_numpy(rng.standard_normal((N, hop, d))).float()
    W = (torch.from_numpy(rng.standard_normal((hop, d, d))) * 0.1).to(cdt)
    got = uc.tap_adjoint_split(dp, W)
    plain = uc.tap_adjoint_plain(dp, W)
    want = np.asarray(jnp.einsum(
        "nrd,rde->ne", jnp.asarray(dp.to(cdt).float().numpy()),
        jnp.asarray(W.float().numpy()), preferred_element_type=jnp.float32))
    assert got.shape == (N, d) and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert float((got - plain).abs().max()) <= 1e-4 * scale
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale


def test_tap_adjoint_split_covers_every_k_once():
    """Each value of K lands in one rank's range and one sub-range: with
    dp one-hot at k, the split's sum is W's row k, exactly."""
    N, hop, d = 1, 130, 16
    W = torch.arange(hop * d * d, dtype=torch.float32).reshape(hop, d, d)
    for k in (0, 15, 16, 511, 512, 1039, 1040, hop * d - 1):
        dp = torch.zeros(N, hop * d)
        dp[0, k] = 1.0
        got = uc.tap_adjoint_split(dp.reshape(N, hop, d), W)
        assert torch.equal(got[0], W.reshape(hop * d, d)[k])
