"""vae_decode_ms: a request's VAE decode (``models/vae.py``, eager), CUDA
events around it, averaged over the window's requests. Read in card runs
only."""

LAYER = "VAE decode"
UNIT = "ms"
MOVES = "sample_images_per_s"


def read(ctx):
    times = ctx.get("decode_ms") or []
    if not ctx.get("card") or not times:
        return None
    return sum(times) / len(times)
