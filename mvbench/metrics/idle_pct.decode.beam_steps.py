"""The share of the traced window in which no operation ran on the
device while the enqueuing thread's innermost span was ``beam.step`` or
one under it."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.idle_pct(trace, "beam_steps")
