"""Fold-samples trained a second: each fold's rows, each epoch, summed
over the window's jobs, over the window's whole time."""


def read(ctx):
    return ctx.window.samples / ctx.window.elapsed_s
