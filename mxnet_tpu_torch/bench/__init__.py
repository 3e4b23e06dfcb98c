"""Card benchmarks of the port's kernels, and a host emulation of their CUDA
source (``host_emu``) for checks where there is no card."""
