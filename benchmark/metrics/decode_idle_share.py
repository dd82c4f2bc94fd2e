"""decode_idle_share: the share of the device extent of the traced request's
``vae.decode`` span (the program's, around ``AutoencoderKL.decode``) in which
no kernel ran on the card: the extent runs from the first to the last kernel
launched from inside the span (matched by correlation id), with
``DeviceTrace``'s kernel filter; 100 where the span launched none
(``harness/program_spans.py``). Read in card runs only."""

from benchmark.harness import program_spans

LAYER = "VAE decode"
UNIT = "%"
MOVES = "sample_images_per_s"


def read(ctx):
    return program_spans.extent_idle_share(ctx, "vae.decode")
