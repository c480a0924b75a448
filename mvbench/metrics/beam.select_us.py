"""Host time of one step's selection and freezing: the program's
``beam.select`` spans over the steps its ``beam.steps`` counter saw in
the window, in us."""

from mvbench import program_spans


def read(facts, trace, ctx):
    return program_spans.per_step_us(trace, "beam.select")
