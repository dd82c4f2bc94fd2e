"""device_idle_share.sample: the share of one whole request (chain, decode,
host copy), the first after warm-up, in which no kernel ran on the card: 1 -
busy / window, busy the union of the kernel intervals of torch.profiler's
trace (``harness/trace.py::DeviceTrace``). Read in card runs only."""

LAYER = "device"
UNIT = "%"
MOVES = "sample_images_per_s"


def read(ctx):
    trace = ctx.get("trace")
    if not ctx.get("card") or trace is None:
        return None
    return 100.0 * trace.idle_share
