"""setup_s (s): from the start of the process that prints the result to
the start of the measured window: imports, the card's context, the kernel
library's build or load, the runner, the warm-up sweep and chunk sizes."""


def read(ctx):
    return ctx.host["setup_s"]
