"""Share of the window's batches whose encoders and regression head ran
as replays of CUDA graphs: the program's ``decode.graph_replays``
counter (one a part a batch) over twice the batches, in %. None where
the program counted no replay (one without the graphs)."""

from mvbench import program_spans


def read(facts, trace, ctx):
    got = program_spans.in_window(trace)
    if got is None or not facts.get("batches"):
        return None
    replays = sum(v for n, v in got[1] if n == "decode.graph_replays")
    if not replays:
        return None
    return 100.0 * replays / (2 * facts["batches"])
