"""Host time of one batch's encoders (scene CNN, class-encoder scan):
the program's ``decode.encode`` spans over the window's batches, in
ms."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.per_batch_ms(facts, trace, "decode.encode")
