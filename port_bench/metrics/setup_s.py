"""Seconds from the process's start to the window's first call: imports,
the CUDA context, the kernels' library, the scene and inputs on the card,
the target where there is one, and the warm-up."""


def read(ctx):
    return ctx.setup_s
