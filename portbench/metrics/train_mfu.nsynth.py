"""train_mfu.nsynth (%): the WaveNet autoencoder's step as a share of the
card's bf16 peak: the published model's operations a training step
(``work/wavenet_ae.py::train_step_flops``) over the step time of the
traced run's window (profiler off) times 989 TFLOP/s."""

from portbench.work import counts, wavenet_ae


def read(obs):
    if obs.get("kind") != "train" or obs.get("arch") != "wavenet_ae" \
            or not obs.get("step_s"):
        return None
    flops = wavenet_ae.train_step_flops(obs["model"], obs["T"], obs["batch"])
    return 100.0 * flops / (obs["step_s"] * counts.PEAK_BF16)
