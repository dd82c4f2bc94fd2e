"""device_idle_share.train: the share of a sub-window of graphed training
steps, the first after warm-up, in which no kernel ran on the card: 1 - busy
/ window, busy the union of the kernel intervals of torch.profiler's trace
(``harness/trace.py::DeviceTrace``). Read in card runs only."""

LAYER = "device"
UNIT = "%"
MOVES = "train_images_per_s"


def read(ctx):
    trace = ctx.get("trace")
    if not ctx.get("card") or trace is None:
        return None
    return 100.0 * trace.idle_share
