"""Host time of one batch's regression head (encoder scan, greedy
decoder): the program's ``decode.reg`` spans over the window's batches,
in ms."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.per_batch_ms(facts, trace, "decode.reg")
