"""chain_ms: the DDPM chain of a request (``p_sample_loop`` through
``ChainGraph``), CUDA events around it, averaged over the window's
requests. Read in card runs only."""

LAYER = "sampler chain"
UNIT = "ms"
MOVES = "sample_images_per_s"


def read(ctx):
    times = ctx.get("chain_ms") or []
    if not ctx.get("card") or not times:
        return None
    return sum(times) / len(times)
