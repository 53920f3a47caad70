"""The upsampler kernels' frame product and partition, in plain PyTorch
(``vqvae_tpu_torch/kernels/upsample_cuda.py``: ``tap_slices``,
``cond_fwd_frames``, ``bwd_split``, ``cond_bwd_partitioned``), against
the plain versions that ``tests/test_torch_probes.py`` holds against the
JAX probe's Pallas bodies, on numpy-seeded inputs.  The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.kernels import upsample_cuda as uc


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _inputs(B, Tl, hop, d, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((2 * hop, d, d)) * 0.1).float()
    b = torch.from_numpy(rng.standard_normal(d) * 0.1).float()
    e = torch.from_numpy(rng.standard_normal((B, Tl, d))).float()
    dcond = torch.from_numpy(rng.standard_normal((B, Tl * hop, d))).float()
    return w, b, e, dcond


@pytest.mark.parametrize("hop,d", [(64, 64), (64, 16), (6, 32), (8, 48)])
def test_tap_slices_follow_the_flipped_taps(hop, d):
    """Slice s, row k, column j holds w[2·hop - 1 - r, k % d, c] for the
    tap r = (k // d)·hop + n // d and channel c = n % d of column
    n = s·128 + j, and 0 past hop·d: W's layout written from w, not from
    ``pack_upsampler``."""
    w, b, _, _ = _inputs(1, 1, hop, d)
    uwk, _ = uc.pack_upsampler(w, b)
    got = uc.tap_slices(uwk, hop)
    N = hop * d
    ns = -(-N // uc.US)
    assert got.shape == (ns, 2 * d, uc.US)
    want = torch.zeros(ns, 2 * d, uc.US)
    for s in range(ns):
        for j in range(uc.US):
            n = s * uc.US + j
            if n >= N:
                continue
            for k in range(2 * d):
                r = (k // d) * hop + n // d
                want[s, k, j] = w[2 * hop - 1 - r, k % d, n % d]
    assert torch.equal(got, want)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tl,hop,d", [(4, 16, 64, 64), (1, 1, 64, 16),
                                        (3, 17, 64, 16), (2, 5, 6, 32)])
def test_frame_product_forward_matches_plain(cdt, B, Tl, hop, d):
    """cond as one product over the B·(Tl+1) frame rows [e[u], e[u-1]],
    cropped at each batch row's ends, against ``cond_fwd_plain`` (float32
    1e-6 of max; bfloat16 within one rounding of the output, 1e-2)."""
    w, b, e, _ = _inputs(B, Tl, hop, d)
    uwk, ub = uc.pack_upsampler(w, b)
    e, uwk = e.to(cdt), uwk.to(cdt)
    got = uc.cond_fwd_frames(e, uwk, ub, hop)
    assert got.dtype == cdt
    tol = 1e-6 if cdt == torch.float32 else 1e-2
    assert _rel(got, uc.cond_fwd_plain(e, uwk, ub, hop)) <= tol


@pytest.mark.parametrize("sms", [132, 40, 8])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_partitioned_backward_matches_plain_at_probe_shapes(sms, cdt):
    """The backward's partition and its fixed order of partial sums
    (runs, cluster ranks, column groups; de from two frame rows) against
    ``cond_bwd_plain`` at the JAX script's shapes (hop 64, d 64, Tl 16,
    B 4), on cards of 132, 40 and 8 SMs (1 to 4 runs), to 1e-5 of max."""
    w, b, e, dcond = _inputs(4, 16, 64, 64)
    uwk, _ = uc.pack_upsampler(w, b)
    e, uwk = e.to(cdt), uwk.to(cdt)
    got = uc.cond_bwd_partitioned(dcond, e, uwk, 64, sms=sms)
    for a, r in zip(got, uc.cond_bwd_plain(dcond, e, uwk, 64)):
        assert a.shape == r.shape
        assert _rel(a, r) <= 1e-5


@pytest.mark.parametrize("B,Tl,hop,d", [(3, 17, 64, 16), (2, 5, 6, 32),
                                        (3, 120, 8, 48)])
def test_partitioned_backward_matches_plain_at_ragged_shapes(B, Tl, hop, d):
    """... and where the last slice or run is partial (float32, a card of
    40 SMs)."""
    w, b, e, dcond = _inputs(B, Tl, hop, d)
    uwk, _ = uc.pack_upsampler(w, b)
    got = uc.cond_bwd_partitioned(dcond, e, uwk, hop, sms=40)
    for a, r in zip(got, uc.cond_bwd_plain(dcond, e, uwk, hop)):
        assert _rel(a, r) <= 1e-5


@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("clusters", [16, 14, 1])
def test_backward_split_covers_every_row_once(B, clusters):
    """At vctk-multi width (T=7680) the runs tile the B·121 frame rows
    with 64-row multiples and no more clusters than the card holds; at
    the timed batches the partials stay under dcond's size (a run's dW
    slices do not shrink with B: at B=1 they outweigh dcond)."""
    cs, ngroups, nruns, rpr = uc.bwd_split(B, 120, 64, 64, 132, clusters)
    M = B * 121
    assert (cs, ngroups) == (4, 8) and rpr % uc.UR == 0
    assert (nruns - 1) * rpr < M <= nruns * rpr
    assert nruns * ngroups <= max(clusters, ngroups)
    if B >= 16:
        assert uc.bwd_scratch(B, 120, 64, 64) < B * 7680 * 64
