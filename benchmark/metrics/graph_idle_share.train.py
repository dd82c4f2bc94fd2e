"""graph_idle_share.train: the card's idle time inside the device extents of
the train step's graph replays, as a share of the traced window (20 steps,
first after warm-up). A replay's extent runs from the first to the last
kernel that its ``cudaGraphLaunch`` ran, matched by correlation id to the
launch inside the program's ``graph.replay`` span
(``harness/program_spans.py``). This idle sits between the graph's nodes:
only fewer or fused kernels close it; the rest of
``device_idle_share.train`` is the host's. Read in card runs only."""

from benchmark.harness import program_spans

LAYER = "train step"
UNIT = "%"
MOVES = "train_images_per_s"


def read(ctx):
    return program_spans.graph_idle_share(ctx, "train_step")
