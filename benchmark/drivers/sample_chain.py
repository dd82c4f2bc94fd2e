"""Sampling requests: the sampler's per-batch path as ``train/sample.py::
sample_batches`` runs it on the card.

A request is one batch: ``synthetic_batch`` conditioning, the DDPM chain
``diffusion.p_sample_loop(fp32_output(model), ..., graph=ChainGraph)``
with ``clip_denoised=False``, ``vae.decode(samples / SD_VAE_SCALE)`` and a
copy of the images to the host. The PNG grids and the PSNR/SSIM report
are host work outside sampling and are left out. Requests run back to
back; the window ends when the last request started before ``--seconds``
completes. A request whose images are not all finite has failed.

The model's function records its input at each step into one buffer on
the card (an index copy inside the captured step), so that the check
follows every link of the chain from the program's own states: for a
sample of the window's requests drawn from the seed, the first state must
equal the start noise; for every step the reference takes the chain's
state before it and the step's noise, made again from the generator's
saved state, and computes the state after it, which the chain recorded as
the next step's input (the last step's is the chain's result); the
reference decodes the chain's result to compare the images. The steps are
independent given the program's states, so the reference runs
``check_batch`` of them in one batched forward.

Traffic keys: ``batch``, ``steps`` (the respaced chain's length),
``warmup_requests``, ``check_requests``, ``check_batch``.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from benchmark.harness import program, weights
from benchmark.harness.checks import checks_from, rel_gap
from benchmark.harness.trace import DeviceTrace, Spans, cuda_ms
from benchmark.reference import inputs
from benchmark.reference.diffusion import Diffusion
from benchmark.reference.model import Denoiser
from benchmark.reference.products import Products, tf32_off
from benchmark.reference.vae import decode

LABELS = ("conditioning draw", "chain", "decode", "host copy")


class Sampler:
    """The program's denoiser, diffusion, VAE and chain graph for a cell,
    with a recorder of each step's input state."""

    def __init__(self, cell, seed: int, device):
        from diffma_tpu_torch.diffusion import create_diffusion
        from diffma_tpu_torch.diffusion.gaussian import ChainGraph
        from diffma_tpu_torch.train.train import fp32_output

        cfg, traffic = cell.config, cell.traffic
        self.cell, self.device = cell, device
        self.model, self.shapes = program.build_denoiser(cfg, device, seed)
        self.model.eval()
        self.vae, self.vae_shapes = program.build_vae(cfg, device, seed)
        self.diffusion = create_diffusion(str(traffic["steps"]), device=device)
        self.chain = ChainGraph(device) if device.type == "cuda" else None
        self.gen = weights.generator(seed, "data", device)
        self.spans = Spans(device)
        T, B, latent = traffic["steps"], traffic["batch"], cfg["latent_size"]
        self.states = torch.zeros((T, B, 4, latent, latent), device=device)
        step_of = torch.zeros(self.diffusion.original_num_steps, dtype=torch.long, device=device)
        step_of[self.diffusion.timestep_map] = torch.arange(T, device=device)
        model_fn = fp32_output(self.model)

        def recorded(x, t, **kw):
            self.states.index_copy_(0, step_of[t[:1]], x[None])
            return model_fn(x, t, **kw)

        self.model_fn = recorded
        self.records = []

    def __call__(self, keep: bool) -> np.ndarray:
        """One request; with ``keep`` its record for the check."""
        from diffma_tpu_torch.models.vae import SD_VAE_SCALE
        from diffma_tpu_torch.train.train import synthetic_batch

        cfg, traffic = self.cell.config, self.cell.traffic
        B, latent = traffic["batch"], cfg["latent_size"]
        tokens = (latent // cfg["patch_size"]) ** 2
        state = self.gen.get_state()
        with torch.no_grad():
            with self.spans("conditioning draw"):
                z = torch.randn((B, 4, latent, latent), generator=self.gen, device=self.device)
                b = synthetic_batch(self.gen, B, latent, tokens, dim=cfg["hidden_size"])
            with self.spans("chain"):
                samples = self.diffusion.p_sample_loop(
                    self.model_fn, z.shape, self.gen, noise=z, clip_denoised=False,
                    model_kwargs={"y": b["y"], "y2": b["y2"], "w": b["w"]}, graph=self.chain)
            with self.spans("decode"):
                images = self.vae.decode(samples / SD_VAE_SCALE)
            with self.spans("host copy"):
                images = images.cpu().numpy()
        if keep:
            self.records.append({"state": state, "states": self.states.clone(),
                                 "last": samples.clone(), "images": images})
        return images


def _check(cell, seed: int, device, sampler_shapes, records, products, candidate=None) -> dict:
    """The sampling numbers over a seeded sample of ``records``, every step
    of each chain; the reference in ``products``' precision, ``check_batch``
    steps in one batched forward. ``candidate`` (the control: a ``Products``
    in a lower precision) computes the next states and the images from the
    same states in the program's place."""
    cfg, traffic = cell.config, cell.traffic
    T, B, latent = traffic["steps"], traffic["batch"], cfg["latent_size"]
    tokens = (latent // cfg["patch_size"]) ** 2
    den_shapes, vae_shapes = sampler_shapes
    wd = weights.make(den_shapes, weights.denoiser_rule, seed, "denoiser", device)
    wv = weights.make(vae_shapes, weights.vae_rule, seed, "vae", device)
    dif = Diffusion(T, 1000, device=device)
    rng = random.Random(seed)
    picks = sorted(rng.sample(range(len(records)), min(traffic["check_requests"], len(records))))

    def stepper(prods):
        den = Denoiser(cfg, wd, prods)
        return lambda x, t, cond, noise: dif.p_sample(
            lambda xx, tt, y, y2, w: den(xx, tt, y, y2, w), x, t, noise, cond)

    ref_step = stepper(products)
    cand_step = stepper(candidate) if candidate is not None else None
    gaps = {"start_gap": 0.0, "step_gap": 0.0, "decode_gap": 0.0}
    with torch.no_grad():
        for i in picks:
            rec = records[i]
            gen = torch.Generator(device=device)
            gen.set_state(rec["state"])
            z, cond, noises = inputs.chain_draws(gen, B, latent, tokens, cfg["hidden_size"], T)
            xs = rec["states"]  # the state before step t at t
            gaps["start_gap"] = max(gaps["start_gap"], rel_gap(xs[T - 1], z))
            nexts = torch.cat([rec["last"][None], xs[:-1]])  # the state after step t at t
            noises = torch.stack(noises)
            for t0 in range(0, T, traffic["check_batch"]):
                ts = torch.arange(t0, min(T, t0 + traffic["check_batch"]), device=device)
                k = len(ts)
                rows = {key: v.repeat(k, *([1] * (v.dim() - 1))) for key, v in cond.items()}
                x, noise = xs[ts].flatten(0, 1), noises[ts].flatten(0, 1)
                tt = ts.repeat_interleave(B)
                want = ref_step(x, tt, rows, noise).reshape(k, -1)
                got = (cand_step(x, tt, rows, noise) if cand_step is not None
                       else nexts[ts]).reshape(k, -1)
                if not bool(torch.isfinite(got).all()):
                    gaps["step_gap"] = float("inf")
                    continue
                per_step = (got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1e-30)
                gaps["step_gap"] = max(gaps["step_gap"], float(per_step.max()))
            scaled = rec["last"] / cfg["vae_scale"]
            want = decode(wv, scaled, products)
            got = (decode(wv, scaled, candidate) if candidate is not None
                   else torch.as_tensor(rec["images"], device=device))
            gaps["decode_gap"] = max(gaps["decode_gap"], rel_gap(got, want))
    return gaps


def run(cell, opts, t_start: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    device = program.resolve(opts.toy)
    cuda = device.type == "cuda"
    B = traffic["batch"]
    marks = [("imports", time.perf_counter())]
    sampler = Sampler(cell, opts.seed, device)
    marks.append(("models, weights", time.perf_counter()))
    for _ in range(traffic["warmup_requests"]):
        sampler(keep=False)
    marks.append(("warm-up", time.perf_counter()))
    trace = None
    if opts.trace and cuda:
        sampler.spans = Spans(device, labelled=True)
        with DeviceTrace(device, LABELS) as trace:
            sampler(keep=False)
    sampler.spans = Spans(device, timed=("chain", "decode") if opts.trace else ())
    setup_s = time.perf_counter() - t_start
    notes = [program.setup_note(t_start, marks),
             program.graph_note("chain step", sampler.chain and sampler.chain.graph, device)]

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    failed, n = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < opts.seconds:
        images = sampler(keep=True)
        failed += int(not np.isfinite(images).all())
        n += 1
    window_s = time.perf_counter() - t0
    memory = torch.cuda.max_memory_reserved(device) if cuda else 0
    layer = {"requests": n, "window_s": window_s, "batch": B, "steps": traffic["steps"],
             "trace": trace, "mixer_ms": None,
             "chain_ms": sampler.spans.ms("chain"), "decode_ms": sampler.spans.ms("decode")}
    if opts.trace and cuda:
        entry = program.mixer_entry(sampler.model, cfg, B, device, opts.seed, backward=False)
        layer["mixer_ms"] = cuda_ms(entry, reps=50)
    records, shapes = sampler.records, (sampler.shapes, sampler.vae_shapes)
    del sampler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    tf32_off()
    t_ref = time.perf_counter()
    values = _check(cell, opts.seed, device, shapes, records, Products())
    notes.append(f"reference: {time.perf_counter() - t_ref:.2f} s for the checked requests")
    out = {
        "attempted": n, "failed": failed, "memory_peak_bytes": memory, "trace": trace,
        "end_to_end": {"setup_s": setup_s, "sample_images_per_s": n * B / window_s},
        "layer": layer, "checks": checks_from(values, cell.limits), "values": values,
        "notes": notes,
    }
    if opts.control:
        out["control"] = {"tf32": _check(cell, opts.seed, device, shapes, records, Products(),
                                         candidate=Products(tf32=True))}
    return out
