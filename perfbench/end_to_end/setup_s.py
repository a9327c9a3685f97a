"""Seconds from the start of the process to the window's opening: imports,
the problem's build, the kernels' libraries (built on a checkout's first
run), the warm call."""


def read(window, verdict, ctx):
    return ctx.setup_s
