"""peak_device_gib: ``torch.cuda.max_memory_allocated`` over the window
(reset at its start, so the resident database counts), in GiB."""


def read(obs):
    if not obs.peak_window_bytes:
        return None
    return obs.peak_window_bytes / 2 ** 30
