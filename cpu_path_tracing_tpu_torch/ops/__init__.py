"""Ray, RNG, material and integrator operators (plain PyTorch) and the kernels."""
