"""device_idle_share.serve (%): the share of the capture's window in which
no kernel runs on the device (the union of the kernels' intervals)."""


def read(obs):
    cap = obs.get("capture") or {}
    if obs.get("kind") != "serve" or not cap.get("window_s"):
        return None
    return 100.0 * (1.0 - cap["busy_s"] / cap["window_s"])
