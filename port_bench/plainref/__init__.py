"""The benchmark's plain reference of the path tracer.

Plain PyTorch, frozen with the benchmark: the Threefry-2x32 counter RNG,
the thin-lens camera, the anchor-point sphere intersection, the three
materials, the bounce loop with Russian roulette, the cell sums and the
image, and the inverse step's loss, gradients (by autograd) and Adam.  It
follows the upstream renderer (``src/main.cpp:104-158`` of
AlexandruIca/cpu-path-tracing) expression for expression as the port
states its estimator, so on one device and in float32 it rounds as the
port's kernels do.  It imports nothing of the port and builds every input
itself from a configuration file's data.
"""
