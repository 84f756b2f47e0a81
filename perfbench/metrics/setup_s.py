"""Set-up seconds: from the process's start to the window's first item
(imports, the card's start, the kernel library, the inputs made on the
card, the warm-up)."""


def read(ctx):
    return ctx.setup_s
