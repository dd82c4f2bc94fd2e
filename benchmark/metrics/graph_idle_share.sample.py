"""graph_idle_share.sample: the card's idle time inside the device extents of
the chain step's graph replays of the traced request, as a share of that
request's window; the same arithmetic as ``graph_idle_share.train``
(``harness/program_spans.py``). Read in card runs only."""

from benchmark.harness import program_spans

LAYER = "sampler chain"
UNIT = "%"
MOVES = "sample_images_per_s"


def read(ctx):
    return program_spans.graph_idle_share(ctx, "chain_step")
