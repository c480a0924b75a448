"""The wait for one decode batch's outputs (the device work still
running, then the copy out): ``timings["fetch_s"]`` over its batches,
in ms."""


def read(facts, trace, ctx):
    if not facts.get("batches"):
        return None
    return facts["fetch_s"] / facts["batches"] * 1e3
