"""The benchmark's entry point; run from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every cache the program builds goes under the checkout's ``build/``, at
fixed paths, so that only a cell's first run in a checkout compiles.
See ``perfbench/README.md``.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
# One process with one compute thread: torch's intra-op pool made the
# host path slower and its runs spread more on the card's 8-core host.
os.environ["OMP_NUM_THREADS"] = "1"
# Python's bytecode is cached under the checkout too.  Where the
# environment forbids writing it (PYTHONDONTWRITEBYTECODE) and the
# installed packages ship none, every run would compile torch's ~2,100
# modules afresh: some 6 s of set-up on the card's host.
sys.pycache_prefix = str(BUILD / "pycache")
sys.dont_write_bytecode = False
# The script's own folder leaves the path: its subfolders are not
# top-level modules.
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness.bench import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], t0=T0))
