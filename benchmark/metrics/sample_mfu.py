"""sample_mfu: the sampling requests' model FLOPs over the window's time, as
a share of the card's peak (TF32 dense for an fp32 configuration).

A request's FLOPs are the chain's denoiser forwards (``work.denoiser_flops``
at the request's batch, once a step) and the VAE decoder's
(``work.vae_decode_flops``). Read in card runs only."""

from benchmark.harness import work

LAYER = "sampling request"
UNIT = "%"
MOVES = "sample_images_per_s"


def read(ctx):
    if not ctx.get("card") or not ctx.get("requests"):
        return None
    cfg, batch = ctx["config"], ctx["batch"]
    per_request = (ctx["steps"] * work.denoiser_flops(cfg, batch)
                   + work.vae_decode_flops(batch, cfg["latent_size"], cfg["vae_ch"],
                                           tuple(cfg["vae_ch_mult"])))
    flops = per_request * ctx["requests"]
    return 100.0 * flops / ctx["window_s"] / work.PRODUCT_PEAK[cfg["dtype"]]
