"""setup_s: process start to the window's start: imports, data, the
database's index and upload, the kernel library (built in a checkout's
first run) and the warm-up requests."""


def read(obs):
    return obs.setup_s
