"""decode_step_us (us): the device time of the kernels of
``csrc/decode.cu`` in the daemon's capture over the samples the requests
completed inside the capture returned."""


def read(obs):
    cap = obs.get("capture") or {}
    t = cap.get("by_file", {}).get("decode.cu")
    if obs.get("kind") != "serve" or not t or not cap.get("samples"):
        return None
    return 1e6 * t / cap["samples"]
