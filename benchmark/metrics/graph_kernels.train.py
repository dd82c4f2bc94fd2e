"""graph_kernels.train: the kernel nodes of the train step's captured CUDA
graph, which every replay runs (cuBLAS's and ATen's as well as the port's
own kernels; memset and memcpy nodes apart), counted by the program once at
capture (``utils/graphs.py::Graph.kernels``). Read in card runs only."""

from benchmark.harness import program_spans

LAYER = "train step"
UNIT = "kernels"
MOVES = "train_images_per_s"


def read(ctx):
    return program_spans.graph_kernels(ctx, "train_step")
