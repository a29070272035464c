"""Seconds from the process's start to the window's: importing torch and
the program, loading (or, in a fresh checkout, building) the kernel
library, rendering the clips, the first frame's selection and the warm-up
that captures the chain or runs the first eager ticks."""


def read(ctx):
    return None if ctx.trace is not None else ctx.setup_s
