"""The timed path broken underneath a CPU rehearsal must come out as not
correct.  Each fault is planted by a ``sitecustomize`` module on the
subprocess's path, so it reaches the harness and the daemon alike."""

import pytest

from portbench.tests.conftest import rehearse

FAULTS = {
    # a step that returns its state unchanged
    "unchanged": """
import vqvae_tpu_torch.train.step as st
def train_step(state, wav, speaker, cfg, picks=None, impl="lax"):
    state.step += 1
    return st.eval_step(state.params, wav, speaker, cfg, impl)
st.train_step = train_step
""",
    # half of the batch left out, the mean taken over the rest
    "half_batch": """
import vqvae_tpu_torch.train.step as st
_orig = st.train_step
def train_step(state, wav, speaker, cfg, picks=None, impl="lax"):
    n = max(1, wav.shape[0] // 2)
    return _orig(state, wav[:n], speaker[:n], cfg, picks=picks, impl=impl)
st.train_step = train_step
""",
    # a token altered where it is produced
    "altered_token": """
from vqvae_tpu_torch.kernels import decode_cuda as dc
_orig = dc.generate_ids_resume
def generate_ids_resume(*a, **k):
    ids, state = _orig(*a, **k)
    if ids.shape[1] > 40:
        ids = ids.clone()
        ids[:, 40] = (ids[:, 40] + 128) % 256
    return ids, state
dc.generate_ids_resume = generate_ids_resume
""",
    # a decode step that returns its state unchanged
    "stale_state": """
from vqvae_tpu_torch.kernels import decode_cuda as dc
_orig = dc.generate_ids_resume
def generate_ids_resume(gp, cfg, cond, gcond, seed, temperature, state,
                        *a, **k):
    ids, _ = _orig(gp, cfg, cond, gcond, seed, temperature, state, *a, **k)
    return ids, state
dc.generate_ids_resume = generate_ids_resume
""",
}


@pytest.mark.parametrize("fault,cell", [
    ("unchanged", "tiny.train.t2"), ("half_batch", "tiny-ema.train.t2"),
    ("altered_token", "tiny.serve.t1"), ("stale_state", "tiny.serve.t1")])
def test_a_broken_path_is_not_correct(tiny_root, tmp_path, fault, cell):
    (tmp_path / "sitecustomize.py").write_text(FAULTS[fault])
    res, _, out = rehearse(tiny_root, cell, 2 ** 31 + 202, 1.0, 0,
                           extra_path=tmp_path)
    assert res["correct"] is False, out[-3000:]
    bad = [k for k, c in res["checks"].items()
           if c["value"] is None or c["value"] > c["limit"]]
    assert bad, res["checks"]


def test_the_same_run_unbroken_is_correct(tiny_root):
    for cell in ("tiny.train.t2", "tiny-ema.train.t2"):
        res, _, _ = rehearse(tiny_root, cell, 2 ** 31 + 202, 1.0, 0)
        assert res["correct"] is True, res["checks"]
