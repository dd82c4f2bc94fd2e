"""allocator_calls.sample: the caching allocator's ``cudaMalloc`` and
``cudaFree`` calls over the traced request's ``diffusion.chain`` and
``vae.decode`` spans, summed: the deltas of ``num_device_alloc`` and
``num_device_free`` that the program takes at the spans' boundaries while
the profiler records (``harness/program_spans.py``). Read in card runs
only."""

from benchmark.harness import program_spans

LAYER = "sampling request"
UNIT = "calls"
MOVES = "sample_images_per_s"


def read(ctx):
    return program_spans.counter_sum(ctx, ("diffusion.chain", "vae.decode"),
                                     "allocator_calls")
