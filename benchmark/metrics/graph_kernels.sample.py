"""graph_kernels.sample: the kernel nodes of the chain step's captured CUDA
graph, which each of a request's steps runs, counted by the program once at
capture (``utils/graphs.py::Graph.kernels``). Read in card runs only."""

from benchmark.harness import program_spans

LAYER = "sampler chain"
UNIT = "kernels"
MOVES = "sample_images_per_s"


def read(ctx):
    return program_spans.graph_kernels(ctx, "chain_step")
