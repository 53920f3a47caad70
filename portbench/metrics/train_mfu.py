"""train_mfu (%): the step's share of the card's bf16 peak, the frozen
``train_step_flops`` count over the step time of the traced run's window
(profiler off) times 989 TFLOP/s."""

from portbench.work import counts


def read(obs):
    if obs.get("kind") != "train" or not obs.get("step_s"):
        return None
    flops = counts.train_step_flops(obs["model"], obs["T"], obs["batch"])
    return 100.0 * flops / (obs["step_s"] * counts.PEAK_BF16)
