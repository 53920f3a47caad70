"""Traffic from the seed, and rates and tails over the whole window."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import corpus
from portbench.drivers import serve_session, train

PB = Path(__file__).resolve().parents[1]


def traffic(name):
    return json.loads((PB / "traffic" / f"{name}.json").read_text())


MODEL = json.loads((PB / "configs" / "vctk-multi.json").read_text())["model"]


def digest(root: Path) -> str:
    h = hashlib.sha256()
    for f in sorted(root.rglob("*.wav")):
        h.update(str(f.relative_to(root)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def test_corpus_is_a_function_of_the_seed(tmp_path):
    spec = {"speakers": 3, "utterances_per_speaker": 2,
            "seconds": [0.1, 0.2], "silence_s": 0.02}
    a = corpus.make_tree(str(tmp_path / "a"), 2 ** 31 + 5, spec)
    b = corpus.make_tree(str(tmp_path / "b"), 2 ** 31 + 5, spec)
    c = corpus.make_tree(str(tmp_path / "c"), 2 ** 31 + 6, spec)
    assert digest(Path(a)) == digest(Path(b)) != digest(Path(c))
    files = sorted(Path(a).rglob("*.wav"))
    assert [f.parent.name for f in files] == ["p225"] * 2 + ["p226"] * 2 + \
        ["p227"] * 2


@pytest.mark.parametrize("name", ["serve.s1", "serve.s4"])
def test_sessions_are_a_function_of_the_seed(name):
    tr = traffic(name)
    a = serve_session.plans(tr, MODEL, 16000, 3_000_000_017)
    b = serve_session.plans(tr, MODEL, 16000, 3_000_000_017)
    c = serve_session.plans(tr, MODEL, 16000, 3_000_000_018)
    assert len(a) == tr["clients"]

    def key(p):
        return [(s.frames, s.greedy, s.speaker, s.key, s.codes.tobytes())
                for cl in p for s in cl]
    assert key(a) == key(b) != key(c)
    # every seed: the same lengths in another order, the first session of
    # each client greedy, half of them greedy
    for cl_a, cl_c in zip(a, c):
        assert sorted(s.frames for s in cl_a) == \
            sorted(s.frames for s in cl_c)
        assert [s.frames for s in cl_a] != [s.frames for s in cl_c]
        assert cl_a[0].greedy and sum(s.greedy for s in cl_a) == \
            len(cl_a) // tr["greedy_every"]
        frames = [s.frames for s in cl_a]
        assert min(frames) == 500 and max(frames) == 2500
        for s in cl_a:
            assert s.codes.min() >= 0 and s.codes.max() < MODEL["K"]
            assert 0 <= s.speaker < MODEL["n_speakers"]


def test_restart_rows_are_a_function_of_the_seed():
    a, b = train.restart_rows(7), train.restart_rows(8)
    assert a(0, 100, 16).tolist() == train.restart_rows(7)(0, 100, 16).tolist()
    assert a(0, 100, 16).tolist() != a(1, 100, 16).tolist()
    assert a(0, 100, 16).tolist() != b(0, 100, 16).tolist()
    assert int(a(3, 100, 512).max()) < 100


def test_rate_and_tail_span_the_whole_window_with_a_stall():
    # 20 pushes of 1024 samples, each taking 10 ms, back to back from
    # t0 = 100 s; then two pushes stall for 1 s each; then a close of 32
    pushes = [(100.0 + 0.01 * i, 100.0 + 0.01 * (i + 1), 1024, 1024)
              for i in range(20)]
    pushes += [(100.2, 101.2, 1024, 1024), (101.2, 102.2, 1024, 1024)]
    closes = [(102.2, 102.21, 32)]
    rt, p95 = serve_session.window_rates(pushes, closes, 100.0, 16000)
    # 22 * 1024 + 32 samples over 2.21 s, the stall included
    assert rt == pytest.approx((22 * 1024 + 32) / 16000 / 2.21)
    lat = np.array([10.0] * 20 + [1000.0] * 2)
    assert p95 == pytest.approx(float(np.percentile(lat, 95)))
    assert p95 > 500.0            # the stall shows in the tail
    # a median of chunks would hide it
    assert float(np.median(lat)) == pytest.approx(10.0)


def test_training_rate_counts_every_step_over_the_window():
    # 100 steps of B=16 x 7680 in 4.2 s, a stall included
    assert train.audio_rate(100, 16, 7680, 16000, 4.2) == \
        pytest.approx(100 * 7.68 / 4.2)
