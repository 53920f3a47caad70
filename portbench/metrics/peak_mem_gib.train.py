"""peak_mem_gib.train (GiB): ``torch.cuda.max_memory_allocated`` over
the window, after ``reset_peak_memory_stats`` at its start."""


def read(obs):
    if obs.get("kind") != "train" or not obs.get("peak_bytes"):
        return None
    return obs["peak_bytes"] / 2 ** 30
