"""Hand-written CUDA kernels for Hopper (sources in vidi_tpu_torch/csrc/)."""
