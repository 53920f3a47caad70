"""On the card, at each cell's own size: the control (the reference in
float8 in the program's place) and the planted faults fail the cell's
limits while the program passes them (the training control on one seed
in 36 does not: ``PERF.md`` §4).  Skips without a card;
run there with ``python -m pytest portbench/tests -q -m cuda``."""

import time

import pytest

from portbench import control, harness


def passes(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] is not None and numbers[k] <= v
               for k, v in limits.items() if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vctk-multi.train.b16",
                                  "stretch.train.b64"])
def test_training_control_and_half_batch_fail(card, cell):
    spec = harness.cell_spec(cell)
    out = control.train_seed(spec, 2 ** 31 + 404, True, "cuda")
    assert passes(out["program"], spec.limits), out
    assert not passes(out["control"], spec.limits), out
    assert not passes(out["half_batch"], spec.limits), out
    assert not passes(out["unchanged"], spec.limits), out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vctk-multi.serve.s1"])
def test_serving_control_and_altered_token_fail(card, cell):
    spec = harness.cell_spec(cell)
    out = control.serve_seed(spec, 2 ** 31 + 505, 5.0, "cuda",
                             time.monotonic())
    assert out["failed"] == 0
    assert passes(out["program"], spec.limits), out
    assert not passes(out["control"], spec.limits), out
    assert not passes(out["altered_token"], spec.limits), out
