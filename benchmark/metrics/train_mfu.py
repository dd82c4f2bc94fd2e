"""train_mfu: the training step's model FLOPs over the window's time, as a
share of the card's peak (TF32 dense for an fp32 configuration).

A step's FLOPs are ``work.denoiser_flops`` at the cell's batch, the forward
once and the backward twice; recomputation is not counted. Read in card
runs only."""

from benchmark.harness import work

LAYER = "train step"
UNIT = "%"
MOVES = "train_images_per_s"


def read(ctx):
    if not ctx.get("card") or not ctx.get("steps"):
        return None
    cfg = ctx["config"]
    flops = 3 * work.denoiser_flops(cfg, ctx["batch"]) * ctx["steps"]
    return 100.0 * flops / ctx["window_s"] / work.PRODUCT_PEAK[cfg["dtype"]]
