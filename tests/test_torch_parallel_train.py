"""The port's data, tensor, sequence and multi-slice parallel train step
(vqvae_tpu_torch/parallel/step.py through train/step.py) in a gloo world
of 4 CPU ranks, held to the one-device step with the JAX package's
sharding tolerances (tests/test_train.py::test_dp_matches_single_device,
tests/test_sharding.py).  One world runs every case
(tests/_torch_mesh_worker.py job ``train``); rank 0 also runs each on
one device."""

import numpy as np
import pytest

from _torch_mesh_worker import DP_CASES
from _torch_world import run_job


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_job(4, "train", tmp_path_factory.mktemp("train"))


def _close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("ema,restart,mult", DP_CASES)
def test_dp_step_matches_one_device(ranks, ema, restart, mult):
    """4-way DP over 3 steps == one device: the gradient mean, the EMA's
    summed per-code statistics, the restart's global candidate rows and
    the codebook-LR multiplier."""
    key = f"ema={ema},restart={restart},mult={mult}"
    m1, p1, v1 = ranks[0][f"{key}/one"]
    md, pd, vd = ranks[0][f"{key}/dp"]
    assert abs(m1["loss"] - md["loss"]) < 1e-5
    _close(p1["vq.codebook"], pd["vq.codebook"], 2e-5, 2e-6 * max(1, mult))
    _close(v1["count"], vd["count"], 2e-5, 2e-5)
    _close(v1["sum"], vd["sum"], 2e-5, 2e-5)


def test_ema_dp_tp_matches_dp(ranks):
    """EMA codebook and dead-code restart on the 2x2 (data x model)
    mesh: the K-sharded count and sum, the codebook gathered."""
    md, pd, vd = ranks[0]["ema_tp/dp"]
    mt, pt, vt = ranks[0]["ema_tp/dp_tp"]
    for k in ("loss", "loss1", "loss3"):
        assert abs(md[k] - mt[k]) < 1e-4, k
    _close(pd["vq.codebook"], pt["vq.codebook"], 2e-5, 2e-6)
    _close(vd["count"], vt["count"], 2e-5, 2e-5)
    _close(vd["sum"], vt["sum"], 2e-5, 2e-5)


def test_kernel_switches_dp_and_tp(ranks):
    """stretch's switches (saved-gates chunk kernels, fused head + CE,
    in-kernel embedding; their plain versions on the CPU): DP matches one
    device and DP x TP matches DP."""
    one, dp, tp = (ranks[0][f"kernels/{k}"][0] for k in ("one", "dp",
                                                          "dp_tp"))
    assert abs(one["loss"] - dp["loss"]) < 1e-4
    assert abs(dp["loss"] - tp["loss"]) < 1e-4


def test_slices_match_one_device(ranks):
    """('slice', 'data') 2x2: the batch over both axes."""
    m1, p1, _ = ranks[0]["slices/one"]
    ms, ps, _ = ranks[0]["slices/slices"]
    assert abs(m1["loss"] - ms["loss"]) < 1e-4
    _close(p1["vq.codebook"], ps["vq.codebook"], 2e-5, 2e-6)


def test_dp_sp_matches_dp(ranks):
    """('data', 'seq') 2x2 against pure DP: every parameter after one
    step (the update through the SP backward), and the losses and the
    codebook after a second step on those weights.  (After the second
    step a few weights whose gradient is near Adam's eps amplify float32
    summation-order noise past 3e-6; their gradients are held in
    test_mesh_gradients_match_one_device.)"""
    md, pd, _ = ranks[0]["sp1/dp"]
    ms, ps, _ = ranks[0]["sp1/dp_sp"]
    assert pd.keys() == ps.keys()
    for k in pd:
        _close(pd[k], ps[k], 3e-5, 3e-6, k)
    md, pd, _ = ranks[0]["sp2/dp"]
    ms, ps, _ = ranks[0]["sp2/dp_sp"]
    for k in ("loss", "loss1", "loss2", "loss3"):
        assert abs(md[k] - ms[k]) < 1e-4, (k, md[k], ms[k])
    _close(pd["vq.codebook"], ps["vq.codebook"], 2e-5, 2e-6)


@pytest.mark.parametrize("mesh", ["dp", "dp_tp", "dp_sp", "slices",
                                  "kernels_dp", "kernels_dp_tp"])
def test_mesh_gradients_match_one_device(ranks, mesh):
    """The gradient each rank's Adam sees (averaged, gathered whole)
    equals the one-device gradient: the scale is the global batch's,
    which Adam alone would hide.  ``kernels_*``: stretch's switches."""
    one = ranks[0]["grads/kernels_one" if mesh.startswith("kernels")
                   else "grads/one"]
    for r in ranks:
        got = r[f"grads/{mesh}"]
        assert got.keys() == one.keys()
        for k, g in got.items():
            scale = float(one[k].abs().max()) or 1.0
            np.testing.assert_allclose(g.numpy() / scale,
                                       one[k].numpy() / scale, atol=1e-5,
                                       err_msg=k)


def test_every_rank_holds_the_same_weights(ranks):
    for key, res in ranks[0].items():
        if key.startswith("grads") or key.endswith("/one"):
            continue
        _, params, vq = res
        for r in ranks[1:]:
            _, other, ovq = r[key]
            for k, v in params.items():
                assert bool((v == other[k]).all()), (key, k)
            assert bool((vq["sum"] == ovq["sum"]).all()), key
