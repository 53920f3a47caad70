"""head_ce_roofline (%): the least time of the head and its
cross-entropy (``work/counts.py::head_work``) over the device time a
step of the kernels of ``csrc/head_ce.cu`` in the capture."""

from portbench.work import counts


def read(obs):
    cap = obs.get("capture") or {}
    t = cap.get("by_file", {}).get("head_ce.cu")
    if obs.get("kind") != "train" or not t:
        return None
    bound = counts.bound_s(*counts.head_work(obs["model"], obs["batch"],
                                             obs["T"]))
    return 100.0 * bound / (t / cap["steps"])
