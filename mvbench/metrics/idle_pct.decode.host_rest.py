"""The share of the traced window in which no operation ran on the
device at any other moment: packing, upload, copy-out, the wait for the
resolver, or no span of the enqueuing thread open."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.idle_pct(trace, "host_rest")
