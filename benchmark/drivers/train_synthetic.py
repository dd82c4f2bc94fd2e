"""Training on synthetic batches: the trainer's step as ``train/train.py``
composes it on the card.

The step is ``make_train_step(make_loss_fn(model, diffusion), adamw(...))``
wrapped in ``GraphedTrainStep`` (the hybrid loss, the backward, the
predicated AdamW, the EMA and the NaN skip in one CUDA graph). Each step's
batch comes from ``synthetic_batch`` on the card and its t and noise from
``loss_draws``; every ``log_every`` steps the steps' losses are read to the
host, the trainer's own sync points. A step is one request: a step whose
loss is not finite has failed.

Set-up builds the one train state, drives it through its first three
steps by the window's own call and feed (step 1 eager on the graph's
stream, step 2 captured, step 3 replayed), reads what the check compares,
warms up and hands the same state to the window. After the window the
state is freed and the reference follows those three steps from the same
weights and the same draws.

Traffic keys: ``batch``, ``log_every``, ``check_steps`` (3), ``warmup_steps``
(graph replays after the checked steps), ``trace_steps`` (the traced
sub-window's steps, first after warm-up).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import program, weights
from benchmark.harness.checks import checks_from, train_gaps
from benchmark.harness.trace import DeviceTrace, Spans, cuda_ms
from benchmark.reference import inputs
from benchmark.reference.products import Products, tf32_off
from benchmark.reference.train import leaf_norms, train_readings

LABELS = ("batch draw", "graph replay", "loss read")


def _feed(cell, diffusion, gen, spans):
    from diffma_tpu_torch.train.train import loss_draws, synthetic_batch

    cfg, batch = cell.config, cell.traffic["batch"]
    latent = cfg["latent_size"]
    tokens = (latent // cfg["patch_size"]) ** 2

    def feed():
        with spans("batch draw"):
            b = synthetic_batch(gen, batch, latent, tokens, dim=cfg["hidden_size"])
            b["t"], b["noise"] = loss_draws(diffusion, b["z"], gen)
        return b

    return feed


class Trainer:
    """The program's train state and step for a cell, fed from the seed."""

    def __init__(self, cell, seed: int, device):
        from diffma_tpu_torch.diffusion import create_diffusion
        from diffma_tpu_torch.train.state import (GraphedTrainStep, TrainState, adamw,
                                                  make_train_step)
        from diffma_tpu_torch.train.train import make_loss_fn

        cfg = cell.config
        self.cell, self.seed, self.device = cell, seed, device
        self.model, self.shapes = program.build_denoiser(cfg, device, seed)
        self.model.train()
        self.diffusion = create_diffusion("", device=device)
        self.optimizer = adamw(self.model.parameters(), cfg["lr"])
        self.state = TrainState(self.model, self.optimizer)
        step = make_train_step(make_loss_fn(self.model, self.diffusion), self.optimizer,
                               ema_decay=cfg["ema_decay"])
        self.step = GraphedTrainStep(step, device) if device.type == "cuda" else step
        self.gen = weights.generator(seed, "data", device)
        self.spans = Spans(device)
        self.feed = _feed(cell, self.diffusion, self.gen, lambda name: self.spans(name))

    def __call__(self):
        with self.spans("graph replay"):
            return self.step(self.state, self.feed(), self.gen)["loss"]

    def checked_steps(self) -> tuple:
        """The first steps, read for the check: (readings, the generator's
        state before each step's draws)."""
        states, losses, grad = [], [], None
        named = list(self.model.named_parameters())
        for k in range(self.cell.traffic["check_steps"]):
            states.append(self.gen.get_state())
            losses.append(self())
            if k == 0:
                st, beta1 = self.optimizer.state, self.optimizer.param_groups[0]["betas"][0]
                # no state: the step never reached the optimizer, a gradient of zero
                grad = leaf_norms({n: st[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)
                                   for n, p in named})
        p0 = weights.make(self.shapes, weights.denoiser_rule, self.seed, "denoiser", self.device)
        readings = {
            "loss": [float(v) for v in losses], "grad": grad,
            "change": leaf_norms({n: p.detach() - p0[n] for n, p in named}),
            "ema_change": leaf_norms({n: e - p0[n] for n, e in self.state.ema.named_parameters()}),
        }
        return readings, states


def reference(cell, seed: int, device, shapes, states, products, half: bool = False) -> dict:
    """The reference's readings over the checked steps, from the same
    weights (of ``shapes``) and draws; ``half`` (a planted fault) leaves out
    half of each batch and takes the mean over the rest."""
    cfg, batch = cell.config, cell.traffic["batch"]
    latent = cfg["latent_size"]
    tokens = (latent // cfg["patch_size"]) ** 2
    batches = []
    for st in states:
        gen = torch.Generator(device=device)
        gen.set_state(st)
        b = inputs.synthetic_batch(gen, batch, latent, tokens, cfg["hidden_size"])
        b["t"], b["noise"] = inputs.loss_draws(gen, b["z"], 1000)
        batches.append({k: v[: batch // 2] for k, v in b.items()} if half else b)
    w0 = weights.make(shapes, weights.denoiser_rule, seed, "denoiser", device)
    return train_readings(cfg, w0, batches, products, cfg["lr"], cfg["ema_decay"])


def run(cell, opts, t_start: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    device = program.resolve(opts.toy)
    cuda = device.type == "cuda"
    batch, log_every = traffic["batch"], traffic["log_every"]
    marks = [("imports", time.perf_counter())]
    trainer = Trainer(cell, opts.seed, device)
    marks.append(("model, weights, state", time.perf_counter()))
    readings, states = trainer.checked_steps()
    marks.append(("checked steps", time.perf_counter()))
    for _ in range(traffic["warmup_steps"]):
        trainer()
    marks.append(("warm-up", time.perf_counter()))
    failed = 0  # the traced sub-window's steps are read too; the window counts afresh

    def read(losses):
        nonlocal failed
        with trainer.spans("loss read"):
            values = torch.stack(losses).float().cpu().numpy()
        failed += int((~np.isfinite(values)).sum())

    trace = None
    if opts.trace and cuda:
        trainer.spans = Spans(device, labelled=True)
        with DeviceTrace(device, LABELS) as trace:
            losses = [trainer() for _ in range(traffic["trace_steps"])]
            read(losses)
        trainer.spans = Spans(device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    notes = [program.setup_note(t_start, marks),
             program.graph_note("train step", getattr(trainer.step, "graph", None), device)]

    steps, failed, running, ends, host_ends = 0, 0, [], [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < opts.seconds:
        running.append(trainer())
        steps += 1
        if cuda:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        else:
            host_ends.append(time.perf_counter())
        if steps % log_every == 0:
            read(running)
            running = []
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    if running:
        read(running)
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip([start] + ends[:-1], ends)]
        memory = torch.cuda.max_memory_reserved(device)
    else:
        step_ms = list(np.diff([t0] + host_ends) * 1e3)
        memory = 0
    layer = {"steps": steps, "window_s": window_s, "batch": batch, "trace": trace,
             "mixer_ms": None}
    if opts.trace and cuda:
        entry = program.mixer_entry(trainer.model, cfg, batch, device, opts.seed, backward=True)
        layer["mixer_ms"] = cuda_ms(entry, reps=20)
    shapes = trainer.shapes
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    tf32_off()
    t_ref = time.perf_counter()
    ref = reference(cell, opts.seed, device, shapes, states, Products())
    values = train_gaps(readings, ref)
    notes.append(f"reference: {time.perf_counter() - t_ref:.2f} s for the checked steps")
    out = {
        "attempted": steps, "failed": failed, "memory_peak_bytes": memory, "trace": trace,
        "end_to_end": {"setup_s": setup_s, "train_images_per_s": steps * batch / window_s,
                       "train_step_ms_p95": float(np.percentile(step_ms, 95))},
        "layer": layer, "checks": checks_from(values, cell.limits), "values": values,
        "notes": notes,
    }
    if opts.control:
        tf32 = reference(cell, opts.seed, device, shapes, states, Products(tf32=True))
        half = reference(cell, opts.seed, device, shapes, states, Products(), half=True)
        out["control"] = {"tf32": train_gaps(tf32, ref), "half_batch": train_gaps(half, ref)}
        out["readings"] = {"program": readings, "reference": ref, "tf32": tf32,
                           "half_batch": half}
    return out
