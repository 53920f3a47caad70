"""batch_wait_ms (ms): the mean time a step of the traced run's window
(profiler off) blocks in ``next()`` on the loader."""


def read(obs):
    if obs.get("kind") != "train" or obs.get("batch_wait_s") is None:
        return None
    return 1e3 * obs["batch_wait_s"]
