"""Hand-written CUDA kernels of the PyTorch port (counterpart of
``repro.kernels``). Kernels build on first use (``_build``); importing this
package builds nothing."""
