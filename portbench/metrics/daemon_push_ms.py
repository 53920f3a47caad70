"""daemon_push_ms (ms): the daemon's own median ``stream_push`` time, its
lock wait included, from its ``stats`` op over the window's pushes (the
op keeps percentiles of the last 512 pushes, not a mean)."""


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("daemon_push_ms"):
        return None
    return obs["daemon_push_ms"]
