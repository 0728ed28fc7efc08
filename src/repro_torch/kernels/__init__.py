"""Distance-threshold kernels: the torch oracle (``ref``), the CUDA kernel
wrappers with their plain twins (``distthresh``), the per-batch device
computation (``ops``) and the kernel build (``_build``, CUDA path only)."""
