"""The share of the traced window in which no operation ran on the
device while the enqueuing thread was inside ``decode.forward`` but
outside the beam steps (encoders, the search's preparation and
backtrace, the regression head)."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.idle_pct(trace, "forward_rest")
