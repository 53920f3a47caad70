"""decoder_stack_roofline (%): the least time of the decoder stack's own
forward and backward (``work/counts.py::stack_work``) over the device
time a step of the kernels of ``csrc/wavenet_train.cu`` in the capture."""

from portbench.work import counts


def read(obs):
    cap = obs.get("capture") or {}
    t = cap.get("by_file", {}).get("wavenet_train.cu")
    if obs.get("kind") != "train" or not t:
        return None
    bound = counts.bound_s(*counts.stack_work(obs["model"], obs["batch"],
                                              obs["T"]))
    return 100.0 * bound / (t / cap["steps"])
