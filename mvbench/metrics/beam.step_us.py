"""Host time of one beam step: the program's ``beam.step`` spans (the
fused step's enqueue, selection and freezing) over the steps its
``beam.steps`` counter saw in the window, in us."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.per_step_us(trace, "beam.step")
