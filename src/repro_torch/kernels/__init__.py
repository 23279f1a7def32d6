"""Hand-written Hopper kernels of the port (``csrc/``), each beside its
plain PyTorch version, plus the device-side sampler.  Kernel sources
build at first use (``_build``), never at import."""
