"""The main thread's wait for the resolver thread (the previous batch's
fetch and pickles): the program's ``decode.wait`` spans over the
window's batches, in ms."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.per_batch_ms(facts, trace, "decode.wait")
