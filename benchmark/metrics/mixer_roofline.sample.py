"""mixer_roofline.sample: the least time of one forward of the dual-mixer entry
point that the Spiral block calls (mamba_dual_mixer_fused, or
mamba2_dual_mixer_fused) without autograd, at the cell's batch, as a share
of its measured time.

The time is the median of 5 windows of CUDA events over back-to-back calls
on the first block's weights (``harness/trace.py::cuda_ms``), taken after
the window. The least time is ``work.mixer_bound_ms``: per call the larger
of the bytes over the HBM rate and the products at the TF32 dense peak plus
the rest at the fp32 rate. The work comes from the shapes, whatever kernel
computes it. Read in card runs only."""

from benchmark.harness import work

LAYER = "mixer kernels"
UNIT = "%"
MOVES = "sample_images_per_s"


def read(ctx):
    if not ctx.get("card") or not ctx.get("mixer_ms"):
        return None
    bound = work.mixer_bound_ms(ctx["config"], ctx["batch"], backward=False)
    return 100.0 * bound / ctx["mixer_ms"]
