"""The share of the traced decode window in which no operation ran on
the device."""


def read(facts, trace, ctx):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
