"""Host packing and enqueue of one decode batch: the program's own
``timings["build_s"]`` over its batches, in ms."""


def read(facts, trace, ctx):
    if not facts.get("batches"):
        return None
    return facts["build_s"] / facts["batches"] * 1e3
