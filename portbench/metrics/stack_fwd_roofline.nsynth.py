"""stack_fwd_roofline.nsynth (%): the least time of the WaveNet
autoencoder's filter-3 stack forward (``work/wavenet_ae.py::
stack_fwd_work``: its operations at 989 TFLOP/s or its bytes at
3.35 TB/s, the larger) over the device time a step of the kernels
launched inside the program's ``model.decoder_stack`` spans in the
driver's capture (``spans.py::span_kernel_s``)."""

from portbench.work import counts, wavenet_ae


def read(obs):
    cap = obs.get("capture") or {}
    t = cap.get("stack_fwd_s")
    if obs.get("kind") != "train" or obs.get("arch") != "wavenet_ae" \
            or not t:
        return None
    bound = counts.bound_s(*wavenet_ae.stack_fwd_work(
        obs["model"], obs["batch"], obs["T"]))
    return 100.0 * bound / (t / cap["steps"])
