"""No JAX in a run: each driver's CPU rehearsal runs in a subprocess and
reports the loaded modules whose top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or ``vqvae_tpu`` (so ``vqvae_tpu_torch``
does not match); the result line has the contract's keys."""

import pytest

from portbench import harness
from portbench.tests.conftest import rehearse

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell,trace,metrics", [
    ("tiny.train.t2", 1, {"train_mfu", "batch_wait_ms",
                          "device_idle_share.train"}),
    ("tiny-ema.train.t2", 0, {"train_audio_s_per_s", "setup_s"}),
    ("tiny.serve.t1", 0, {"decode_realtime_x", "push_p95_ms", "setup_s"})])
def test_rehearsal_loads_no_jax(tiny_root, cell, trace, metrics):
    res, forbidden, _ = rehearse(tiny_root, cell, 2 ** 31 + 101, 1.0, trace)
    assert forbidden == []
    assert [k for k in res if k != "breakdown"] == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == metrics
    assert res["device"]["platform"] == "cpu"


def test_whole_names_are_compared(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "vqvae_tpu_torch_extra",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vqvae_tpu.models",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["vqvae_tpu"]
