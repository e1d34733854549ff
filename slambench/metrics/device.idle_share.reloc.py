"""The device's idle share of the traced window: 1 - the union of the
device operations' intervals inside it over its length."""


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
