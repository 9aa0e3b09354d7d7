"""Process start to the window's opening: kernels built (first run of a checkout),
weights and inputs made, program built and warmed up."""


def read(ctx):
    return ctx.setup_s
