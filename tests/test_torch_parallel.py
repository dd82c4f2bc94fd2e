"""The port's parallel layer against the JAX package's, on the CPU, over gloo.

Ranks are processes spawned by ``torch.multiprocessing``, each on one
intra-op thread, joined through a ``file://`` store in the test's temporary
directory (no port, so xdist workers never meet), each group under a
deadline that fails the test rather than hanging the suite. A spawned rank
re-imports this module, so it imports no JAX: the JAX side runs in the
test process, on the same seeded numpy inputs, and the ranks hand back
numpy arrays. Two groups, one of 2 ranks and one of 4, run every case of
their size once (module fixtures); the tests then hold each case to its
bar. The trainer's resume runs two more groups of 2: the second relaunches
from the first one's checkpoint.

Bars: the collectives against their closed forms (exact, but for the
order of fp32 sums: 1e-6); the sequence-parallel scans as
``tests/test_sequence_parallel.py`` holds JAX's (values 2e-5, gradients
1e-4, rtol = atol) against JAX's ``selective_scan_ref`` and ``ssd_ref`` on
the whole sequence; the mixers at tp 2, sp 2 and tp 2 × sp 2, output 1e-4 ·
max(1, max |ref|) and every gradient 2e-4 · max(1, max |ref|) (the
gradient bar), against the JAX mixer unsharded and against JAX's own tp × sp
``shard_map`` on the conftest's virtual devices; a DiffMa train step at dp 2
and at tp 2 as ``tests/test_parallel.py`` holds JAX's (loss rtol 2e-4,
parameters 5e-3 of each tensor's largest value) against JAX's unsharded
step; the trainer at dp 2 with a resume against one process fed both
ranks' rows at 1e-5, ``tools/run_multiprocess_smoke.py``'s bar.
"""

from __future__ import annotations

import datetime
import math
import os
import queue
import traceback
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 120
H1, H2, NS = 64, 128, 8  # Mamba-1 and Mamba-2 widths, d_state
SCAN_L, CHUNK = 40, 8  # shards of 20 and 10 steps: not multiples of the chunk
MIX_TOL, GRAD_TOL = 1e-4, 2e-4
# JAX's "ref" scan: the port's plain one; its Pallas scan compiles 4x slower in interpret mode
STEP_CFG = dict(input_size=8, patch_size=2, depth=2, block_type="spiral", d_state=16,
                scan_impl="ref")


# ---------------------------------------------------------------------------
# The ranks' side: torch only
# ---------------------------------------------------------------------------


def _start(world: int, job: str, args: dict, tmp) -> dict:
    """Start ``job(rank, world, **args)`` on ``world`` spawned ranks."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp), f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_worker, args=(r, world, store, job, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=DEADLINE_S)
    return dict(world=world, job=job, q=q, procs=procs, deadline=deadline)


def _collect(run: dict) -> list:
    """Each rank's result of a started job, in rank order. Fails the test on
    any rank's error or at the job's deadline, after killing its ranks."""
    out, errors = {}, []
    try:
        while len(out) + len(errors) < run["world"]:
            left = (run["deadline"] - datetime.datetime.now()).total_seconds()
            try:
                rank, err, res = run["q"].get(timeout=max(left, 0.1))
            except queue.Empty:
                pytest.fail(f"{run['job']} on {run['world']} ranks passed its {DEADLINE_S} s "
                            f"deadline")
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                out[rank] = res
    finally:
        for p in run["procs"]:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
    if errors:
        pytest.fail("\n".join(errors))
    return [out[r] for r in range(run["world"])]


def _worker(rank, world, store, job, args, q):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=100))
        res = globals()[job](rank, world, **args)
        q.put((rank, None, res))
    except BaseException:  # noqa: B902 -- the parent reports it
        q.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rng_arrays(seed, shapes: dict) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _np(t):
    return t.detach().cpu().numpy().copy()


def _collective(op: str, rank: int, world: int) -> dict:
    """x_r and c_r drawn per rank; the op's value and the gradient of
    sum(op(x_r) * c_r)."""
    from diffma_tpu_torch.parallel.collectives import all_gather, enter, psum_mid, psum_out

    group = dist.group.WORLD
    a = _rng_arrays(100 + rank, {"x": (3, 5), "c": (world, 3, 5) if op == "all_gather"
                                 else (3, 5)})
    x = torch.from_numpy(a["x"]).requires_grad_()
    fn = {"enter": lambda t: enter(t, group), "psum_out": lambda t: psum_out(t, group),
          "psum_mid": lambda t: psum_mid(t, group),
          "all_gather": lambda t: all_gather(t, rank, world, group)}[op]
    y = fn(x)
    (y * torch.from_numpy(a["c"])).sum().backward()
    return {"y": _np(y), "grad": _np(x.grad)}


def _scan_inputs(kind: str, gated: bool, seed: int = 7) -> dict:
    G, L = 2, SCAN_L
    if kind == "selective":
        d, n = 8, 4
        a = _rng_arrays(seed, {"u": (G, L, d), "delta": (G, L, d), "A": (d, n), "B": (G, L, n),
                               "C": (G, L, n), "D": (d,), "z": (G, L, d), "g": (G, L, d)})
        a["delta"] *= 0.5
        a["A"] = -np.exp(0.3 * a["A"])
        if not gated:
            del a["z"]
        return a
    H, P, N = 2, 4, 4
    a = _rng_arrays(seed, {"x": (G, L, H, P), "dt": (G, L, H), "A": (H,), "B": (G, L, N),
                           "C": (G, L, N), "D": (H,), "dt_bias": (H,), "g": (G, L, H, P)})
    a["dt"] *= 0.5
    a["A"] = -np.exp(0.5 * a["A"])
    a["dt_bias"] = 0.2 * a["dt_bias"] - 1.0
    return a


SCAN_ORDER = {"selective": ("u", "delta", "A", "B", "C", "D", "z"),
              "ssd": ("x", "dt", "A", "B", "C", "D", "dt_bias")}


def _scan_case(kind: str, gated, sp: int, dt_floor: float) -> dict:
    """The sequence-parallel scan over ``sp`` ranks: its value and the VJP
    of every input."""
    from diffma_tpu_torch.parallel.mesh import make_mesh
    from diffma_tpu_torch.parallel.sequence import (
        selective_scan_sequence_parallel,
        ssd_sequence_parallel,
    )

    mesh = make_mesh(dp=1, tp=1, sp=sp, device="cpu")
    a = _scan_inputs(kind, gated)
    names = [k for k in SCAN_ORDER[kind] if k in a]
    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in names}
    if kind == "selective":
        y = selective_scan_sequence_parallel(t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"],
                                             mesh, z=t.get("z"))
    else:
        y = ssd_sequence_parallel(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], mesh,
                                  dt_bias=t["dt_bias"], dt_limit=(dt_floor, math.inf),
                                  chunk_size=CHUNK)
    y.backward(torch.from_numpy(a["g"]))
    return {"y": _np(y), **{f"d{k}": _np(v.grad) for k, v in t.items()}}


def _mixer_tree(use_mamba2: bool, seed: int = 11) -> dict:
    """A JAX ``Mamba``/``Mamba2`` parameter tree of numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if not use_mamba2:
        h, d, n, r = H1, 2 * H1, NS, math.ceil(H1 / 16)
        return {"in_proj": {"kernel": f(h, 2 * d) / np.sqrt(h)},
                "conv1d_weight": 0.5 * f(d, 4), "conv1d_bias": 0.1 * f(d),
                "x_proj": {"kernel": f(d, r + 2 * n) / np.sqrt(d)},
                "dt_proj": {"kernel": f(r, d) / np.sqrt(r), "bias": 0.3 * f(d) - 1.0},
                "A_log": (np.log(np.arange(1, n + 1, dtype=np.float32))[None]
                          + 0.1 * f(d, n)).astype(np.float32),
                "D": 1.0 + 0.1 * f(d), "out_proj": {"kernel": f(d, h) / np.sqrt(d)}}
    h, d, n = H2, 2 * H2, NS
    H = d // 64
    return {"in_proj": {"kernel": f(h, 2 * d + 2 * n + H) / np.sqrt(h)},
            "conv1d_weight": 0.5 * f(d + 2 * n, 4), "conv1d_bias": 0.1 * f(d + 2 * n),
            "dt_bias": 0.3 * f(H) - 3.0,
            "A_log": np.log(np.linspace(1.0, 8.0, H)).astype(np.float32) + 0.05 * f(H),
            "D": 1.0 + 0.1 * f(H), "norm_weight": 1.0 + 0.1 * f(d),
            "out_proj": {"kernel": f(d, h) / np.sqrt(d)}}


def _mixer_io(use_mamba2: bool, seed: int = 12) -> dict:
    h = H2 if use_mamba2 else H1
    return _rng_arrays(seed, {"x": (2, 16, h), "g": (2, 16, h)})


MESHES = {"tp2": (2, 1), "sp2": (1, 2), "tp2sp2": (2, 2)}


def _port_mixer(use_mamba2: bool, family: str, mesh, tp: int, sp: int, scan_impl="auto"):
    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.models.mamba2 import Mamba2
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec
    from diffma_tpu_torch.utils.convert import _mamba1, _mamba2

    spec = build_scan_spec(family, 4, 0)
    kw = dict(mesh=mesh, tp_axis="tp" if tp > 1 else None, sp_axis="sp" if sp > 1 else None,
              scan_impl=scan_impl)
    if use_mamba2:
        mixer = Mamba2(H2, spec, d_state=NS, **kw)
    else:
        mixer = Mamba(H1, spec, d_state=NS, **kw)
    sd = {}
    (_mamba2 if use_mamba2 else _mamba1)(sd, "m", _mixer_tree(use_mamba2))
    mixer.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return mixer


def _mixer_case(use_mamba2: bool, family: str, tp: int, sp: int, scan_impl="auto") -> dict:
    """The mixer over a mesh of tp x sp ranks: its output and the gradients
    of x and of every parameter."""
    from diffma_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dist.get_world_size() // (tp * sp), tp=tp, sp=sp, device="cpu")
    mixer = _port_mixer(use_mamba2, family, mesh, tp, sp, scan_impl)
    io = _mixer_io(use_mamba2)
    x = torch.from_numpy(io["x"]).requires_grad_()
    y = mixer(x)
    y.backward(torch.from_numpy(io["g"]))
    return {"y": _np(y), "dx": _np(x.grad),
            **{f"d{k}": _np(p.grad) for k, p in mixer.named_parameters()}}


def _step_model(use_mamba2: bool, mesh=None, tp=1):
    from diffma_tpu_torch.models.diffma import DiffMa

    return DiffMa(hidden_size=H2 if use_mamba2 else H1, use_mamba2=use_mamba2,
                  mesh=mesh if tp > 1 else None, tp_axis="tp" if tp > 1 else None,
                  **STEP_CFG)


def _step_case(use_mamba2: bool, dp: int, tp: int, state_dict: dict, batch: dict) -> dict:
    """One train step of a DiffMa over a dp x tp mesh from the given weights
    on the global batch (with its t and noise): the loss and, on rank 0, the
    parameters after the step."""
    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from diffma_tpu_torch.train import train
    from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step

    mesh = make_mesh(dp=dp, tp=tp, sp=1, device="cpu")
    model = _step_model(use_mamba2, mesh, tp)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    opt = adamw(model.parameters(), 1e-3)
    state = TrainState(model, opt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), opt,
                           group=mesh.group("dp"))
    rows = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
    metrics = step(state, rows, None)
    out = {"loss": float(metrics["loss"]), "finite": bool(metrics["finite"])}
    if dist.get_rank() == 0:
        out["params"] = {k: _np(v) for k, v in model.state_dict().items()}
    return out


def _nan_case(rank: int) -> dict:
    """A step at dp 2 whose batch has a NaN on rank 1 only."""
    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.parallel.mesh import make_mesh, shard_params
    from diffma_tpu_torch.train import train
    from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step

    mesh = make_mesh(dp=2, device="cpu")
    model = build_model("DiffMa-S/2", input_size=8, hidden_size=32, d_state=4)
    model.init_weights(torch.Generator().manual_seed(rank))  # made equal by the broadcast
    shard_params(model.parameters(), mesh)
    opt = adamw(model.parameters(), 1e-3)
    state = TrainState(model, opt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), opt,
                           group=mesh.group("dp"))
    gen = torch.Generator().manual_seed(5 + rank)
    before = [p.detach().clone() for p in model.parameters()]
    batch = train.synthetic_batch(gen, 2, 8, 16, dim=32)
    if rank == 1:
        batch["z"][0, 0, 0, 0] = float("nan")
    metrics = step(state, batch, gen)
    return {"finite": bool(metrics["finite"]), "step": int(state.step),
            "unchanged": all(torch.equal(a, p) for a, p in zip(before, model.parameters())),
            "params": [_np(p) for p in model.parameters()],
            "ema": [_np(p) for p in state.ema.parameters()]}


class _Diffusion:
    num_timesteps = 10


def _loss_aware_case(rank: int) -> dict:
    from diffma_tpu_torch.diffusion.timestep_samplers import LossSecondMomentResampler

    sampler = LossSecondMomentResampler(_Diffusion(), history_per_term=2)
    for k in range(3):
        rng = np.random.default_rng(40 + 10 * k + rank)
        ts, losses = rng.integers(0, 10, 6), rng.random(6)
        sampler.update_with_local_losses(torch.from_numpy(ts), torch.from_numpy(losses))
    return {"history": sampler._loss_history.copy(), "counts": sampler._loss_counts.copy()}


def _sample_cfg(tmp):
    from diffma_tpu_torch.utils.config import Config

    return Config(model="DiffMa-S/2", image_size=32, hidden_size=32, sample_num_steps=3,
                  synthetic_data=True, sample_global_batch_size=1, sample_num_batches=2,
                  save_dir=os.path.join(str(tmp), "samples"), seed=3)


def _sample_case(tmp) -> dict:
    from diffma_tpu_torch.train import sample

    results = sample.main(_sample_cfg(tmp), device="cpu")
    dist.barrier()  # every rank's grids written
    return {"images": [r["images"] for r in results], "quality": [r["quality"] for r in results],
            "files": sorted(os.listdir(os.path.join(str(tmp), "samples")))}


def _trainer_cfg(tmp, **over):
    from diffma_tpu_torch.utils.config import Config

    cfg = Config(model="DiffMa-S/2", image_size=64, hidden_size=32, d_state=4,
                 global_batch_size=4, epochs=1, lr=1e-4, log_every=1, ckpt_every=2,
                 max_steps=2, synthetic_data=True, synthetic_dataset_size=32, global_seed=0,
                 results_dir=os.path.join(str(tmp), "runs"), return_loss_history=True)
    cfg.update(over)
    return cfg


def _trainer_result(state, history) -> dict:
    return {"params": [_np(p) for p in state.model.parameters()],
            "ema": [_np(p) for p in state.ema.parameters()], "step": int(state.step),
            "rng": _np(state.generator.get_state()), "loss": history["loss"]}


def _embedder_cfg(tmp):
    from diffma_tpu_torch.utils.config import Config

    return Config(image_size=32, embedder_results_dir=os.path.join(str(tmp), "emb"),
                  embedder_epoch=1, embedder_global_batch_size=4, max_steps=2, log_every=1,
                  embedder_ckpt_every=2, synthetic_data=True)


def _embedder_case(tmp) -> dict:
    from diffma_tpu_torch.train import train_embedder

    state = train_embedder.main(_embedder_cfg(tmp), device="cpu")
    return {"params": [_np(p) for p in state.model.parameters()],
            "ema": [_np(p) for p in state.ema.parameters()], "step": int(state.step)}


def _job_trainer(rank, world, tmp, **over):
    """The trainer's ``main`` on every rank: (f)."""
    from diffma_tpu_torch.train import train

    state, history = train.main(_trainer_cfg(tmp, **over), device="cpu")
    return _trainer_result(state, history)


def _job_world2(rank, world, tmp, steps: dict):
    out = {f"collective-{op}": _collective(op, rank, world)
           for op in ("enter", "psum_out", "psum_mid", "all_gather")}
    for gated in (True, False):
        out[f"selective-{gated}"] = _scan_case("selective", gated, 2, 0.0)
    for floor in (0.0, 0.1):
        out[f"ssd-{floor}"] = _scan_case("ssd", None, 2, floor)
    for use_mamba2 in (False, True):
        for family in ("spiral", "vim"):
            for name in ("tp2", "sp2"):
                out[f"mixer-{use_mamba2}-{family}-{name}"] = _mixer_case(
                    use_mamba2, family, *MESHES[name])
    out["quirk"] = _mixer_case(False, "spiral", 1, 2, scan_impl="fused")
    for key, (use_mamba2, sd, batch) in steps.items():
        for dp, tp in ((2, 1), (1, 2)):
            out[f"step-{key}-dp{dp}tp{tp}"] = _step_case(use_mamba2, dp, tp, sd, batch)
    out["nan"] = _nan_case(rank)
    out["loss_aware"] = _loss_aware_case(rank)
    out["sample"] = _sample_case(tmp)
    out["embedder"] = _embedder_case(tmp)
    from diffma_tpu_torch.train import train

    try:
        train.main(_trainer_cfg(os.path.join(str(tmp), "odd"), global_batch_size=3), device="cpu")
        out["odd_batch"] = None
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out


def _job_world4(rank, world):
    out = {f"collective-{op}": _collective(op, rank, world)
           for op in ("enter", "psum_out", "psum_mid", "all_gather")}
    for gated in (True, False):
        out[f"selective-{gated}"] = _scan_case("selective", gated, 4, 0.0)
    for floor in (0.0, 0.1):
        out[f"ssd-{floor}"] = _scan_case("ssd", None, 4, floor)
    for use_mamba2 in (False, True):
        for family in ("spiral", "vim"):
            out[f"mixer-{use_mamba2}-{family}-tp2sp2"] = _mixer_case(
                use_mamba2, family, *MESHES["tp2sp2"])
    return out


# ---------------------------------------------------------------------------
# The test process's side: the groups, JAX's references and the bars
# ---------------------------------------------------------------------------


def _jax_step_inputs(use_mamba2: bool):
    """A JAX DiffMa, its weights (every one nudged off its init, so that
    every gradient is non-trivial: adaLN and the final layer start at zero),
    a global batch of 4 and the draws of JAX's loss from its key."""
    import jax
    import jax.numpy as jnp

    from diffma_tpu.models.diffma import DiffMa
    from diffma_tpu_torch.utils.convert import diffma_params_from_jax

    h = H2 if use_mamba2 else H1
    model = DiffMa(hidden_size=h, use_mamba2=use_mamba2, **STEP_CFG)
    np_batch = _rng_arrays(20, {"z": (4, 4, 8, 8), "y": (4, h), "y2": (4, 16, h), "w": (4, 16, 1)})
    np_batch["w"] = 1.0 / (1.0 + np.exp(-np_batch["w"]))
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(1), batch["z"], jnp.zeros(4, jnp.int32),
                                 batch["y"], batch["y2"], batch["w"])["params"]
    rng = np.random.default_rng(21)
    params = jax.tree.map(lambda p: jnp.asarray(
        np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32)), params)
    key = jax.random.PRNGKey(3)
    t_rng, noise_rng = jax.random.split(key)
    np_batch["t"] = np.asarray(jax.random.randint(t_rng, (4,), 0, 1000)).astype(np.int64)
    np_batch["noise"] = np.asarray(jax.random.normal(noise_rng, (4, 4, 8, 8)), np.float32)
    sd = {k: v.numpy() for k, v in diffma_params_from_jax(
        jax.tree.map(np.asarray, params), depth=STEP_CFG["depth"], use_mamba2=use_mamba2).items()}
    return (model, params, batch, key), sd, np_batch


def _jax_step(use_mamba2: bool, inputs):
    """JAX's unsharded step (``tests/test_parallel.py``'s): its loss and
    parameters under the port's names."""
    import jax
    import optax

    from diffma_tpu.diffusion import create_diffusion
    from diffma_tpu.train.state import TrainState, make_train_step
    from diffma_tpu.train.train import make_loss_fn
    from diffma_tpu_torch.utils.convert import diffma_params_from_jax

    model, params, batch, rng = inputs
    opt = optax.adamw(1e-3, weight_decay=0.0)
    state, metrics = jax.jit(make_train_step(make_loss_fn(model, create_diffusion("")), opt))(
        TrainState.create(params, opt), batch, rng)
    new = diffma_params_from_jax(jax.tree.map(np.asarray, state.params),
                                 depth=STEP_CFG["depth"], use_mamba2=use_mamba2)
    return float(metrics["loss"]), {k: v.numpy() for k, v in new.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group started at once, JAX's references computed while they
    run, then their results: the world-2 and world-4 cases, the trainer's
    two launches (the second from the first one's checkpoint)."""
    import jax
    from jax.sharding import Mesh

    tmp = tmp_path_factory.mktemp("parallel")
    inputs = {fam: _jax_step_inputs(fam == "mamba2") for fam in ("mamba1", "mamba2")}
    steps = {fam: (fam == "mamba2", sd, batch) for fam, (_, sd, batch) in inputs.items()}
    w2 = _start(2, "_job_world2", {"tmp": str(tmp / "w2"), "steps": steps}, tmp)
    w4 = _start(4, "_job_world4", {}, tmp)
    trainer_tmp = str(tmp / "trainer")
    first = _start(2, "_job_trainer", {"tmp": trainer_tmp}, tmp)
    refs = {"steps": {fam: _jax_step(fam == "mamba2", inputs[fam][0]) for fam in inputs}}
    first = _collect(first)
    (ckpt,) = [os.path.join(trainer_tmp, "runs", d, "checkpoints")
               for d in os.listdir(os.path.join(trainer_tmp, "runs"))]
    second = _start(2, "_job_trainer", {"tmp": trainer_tmp, "resume_from": ckpt, "max_steps": 4,
                                        "ckpt_every": 10 ** 9}, tmp)
    refs["mixers"] = {(m2, fam): _jax_mixer(m2, fam) for m2 in (False, True)
                      for fam in ("spiral", "vim")}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2), ("dp", "tp", "sp"))
    refs["shard_map"] = {m2: _jax_mixer(m2, "spiral", mesh) for m2 in (False, True)}
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 1, 2), ("dp", "tp", "sp"))
    refs["quirk"] = _jax_mixer(False, "spiral", mesh, scan_impl="fused")
    refs["scans"] = {f"{kind}-{arg}": _jax_scan_vjp(kind, arg if kind == "selective" else None,
                                                    arg if kind == "ssd" else 0.0)
                     for kind, arg in (("selective", True), ("selective", False), ("ssd", 0.0),
                                       ("ssd", 0.1))}
    return {"world2": _collect(w2), "world4": _collect(w4), "refs": refs,
            "trainer": (first, _collect(second), ckpt)}


@pytest.fixture(scope="module")
def world2(runs):
    return runs["world2"]


@pytest.fixture(scope="module")
def world4(runs):
    return runs["world4"]


@pytest.fixture(scope="module")
def refs(runs):
    return runs["refs"]


def _groups(request, world):
    return request.getfixturevalue("world2" if world == 2 else "world4")


def _close(got, want, tol, what=""):
    assert np.shape(got) == np.shape(want), what
    if np.size(want) == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol:g} * {scale:.3g}"


# (a) the collectives ---------------------------------------------------------


@pytest.mark.parametrize("op", ["enter", "psum_out", "psum_mid", "all_gather"])
@pytest.mark.parametrize("world", [2, 4])
def test_collectives_forward_and_backward(request, world, op):
    """Each op's value and backward against its closed form: ``enter`` the
    identity and the gradient summed over the ranks; ``psum_out`` the sum
    and the gradient as it is; ``psum_mid`` the sum both ways;
    ``all_gather`` every rank's x at its slot, and the sum of every rank's
    gradient of this rank's slot."""
    res = _groups(request, world)
    draws = [_rng_arrays(100 + r, {"x": (3, 5), "c": (world, 3, 5) if op == "all_gather"
                                   else (3, 5)}) for r in range(world)]
    xs = np.stack([d["x"] for d in draws])
    cs = np.stack([d["c"] for d in draws])
    for r, out in enumerate(res):
        got = out[f"collective-{op}"]
        want_y = {"enter": lambda: xs[r], "psum_out": lambda: xs.sum(0),
                  "psum_mid": lambda: xs.sum(0), "all_gather": lambda: xs}[op]()
        want_g = {"enter": lambda: cs.sum(0), "psum_out": lambda: cs[r],
                  "psum_mid": lambda: cs.sum(0), "all_gather": lambda: cs[:, r].sum(0)}[op]()
        np.testing.assert_allclose(got["y"], want_y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["grad"], want_g, rtol=1e-6, atol=1e-6)


# (b) the sequence-parallel scans ------------------------------------------------


def _jax_scan_vjp(kind: str, gated, dt_floor: float):
    import jax
    import jax.numpy as jnp

    from diffma_tpu.ops.selective_scan import selective_scan_ref
    from diffma_tpu.ops.ssd import ssd_ref

    a = _scan_inputs(kind, gated)
    names = [k for k in SCAN_ORDER[kind] if k in a]
    args = [jnp.asarray(a[k]) for k in names]
    if kind == "selective":
        fn = lambda *t: selective_scan_ref(*t[:6], z=t[6] if len(t) > 6 else None)  # noqa: E731
    else:
        fn = lambda *t: ssd_ref(*t[:6], dt_bias=t[6], dt_limit=(dt_floor, math.inf))  # noqa: E731
    y, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(a["g"]))
    return {"y": np.asarray(y), **{f"d{k}": np.asarray(g) for k, g in zip(names, grads)}}


@pytest.mark.parametrize("case", ["selective-True", "selective-False", "ssd-0.0", "ssd-0.1"])
@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_scans_match_jax_ref(request, refs, world, case):
    """The scan with the sequence over sp = 2 or 4 ranks, shards of 20 or
    10 steps (the SSD's chunk is 8): its value and the VJP of every input on
    every rank, against JAX's ``selective_scan_ref`` (gated and not) and
    ``ssd_ref`` on the whole sequence. ``ssd-0.1``: a lower dt limit of 0.1,
    where JAX's own ``ssd_sequence_parallel`` leaves ``ssd_ref`` (its final
    state decayed by the pad), and the port does not."""
    want = refs["scans"][case]
    for out in _groups(request, world):
        got = out[case]
        assert set(got) == set(want)
        np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_jax_sequence_parallel_ssd_leaves_ref_at_a_lower_dt_limit():
    """The fault of the reference that the port does not copy: JAX's
    ``ssd_sequence_parallel`` at dt_limit (0.1, inf) with shards that pad
    their last chunk is off its own ``ssd_ref`` after the first shard."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from diffma_tpu.ops.ssd import ssd_ref
    from diffma_tpu.parallel.sequence import ssd_sequence_parallel

    a = {k: jnp.asarray(v) for k, v in _scan_inputs("ssd", None).items()}
    args = [a[k] for k in ("x", "dt", "A", "B", "C", "D", "dt_bias")]
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    for floor, off in ((0.0, False), (0.1, True)):
        ref = ssd_ref(*args[:6], dt_bias=args[6], dt_limit=(floor, math.inf))
        sp = jax.jit(lambda *t: ssd_sequence_parallel(
            *t[:6], mesh, dt_bias=t[6], dt_limit=(floor, math.inf), chunk_size=CHUNK))(*args)
        err = np.abs(np.asarray(sp) - np.asarray(ref))
        assert err[:, :SCAN_L // 2].max() < 2e-5
        assert (err[:, SCAN_L // 2:].max() > 1e-2) == off


# (c) the mixers ---------------------------------------------------------------


def _jax_mixer(use_mamba2: bool, family: str, mesh=None, scan_impl="auto"):
    """The JAX mixer's output and the gradients of x and every parameter,
    under the port's names; with ``mesh``, sharded over its tp and sp."""
    import jax
    import jax.numpy as jnp

    from diffma_tpu.models.mamba import Mamba
    from diffma_tpu.models.mamba2 import Mamba2
    from diffma_tpu.ops.scan_orders import build_scan_spec
    from diffma_tpu_torch.utils.convert import _mamba1, _mamba2

    kw = {} if mesh is None else dict(mesh=mesh, tp_axis="tp" if mesh.shape["tp"] > 1 else None,
                                      sp_axis="sp" if mesh.shape["sp"] > 1 else None)
    if use_mamba2:
        mixer = Mamba2(d_model=H2, d_state=NS, scan_impl=scan_impl, **kw)
    else:
        mixer = Mamba(d_model=H1, d_state=NS, scan_impl=scan_impl, **kw)
    spec = build_scan_spec(family, 4, 0)
    params = jax.tree.map(jnp.asarray, _mixer_tree(use_mamba2))
    io = _mixer_io(use_mamba2)
    fn = jax.jit(lambda p, x: mixer.apply({"params": p}, x, spec))
    y, vjp = jax.vjp(fn, params, jnp.asarray(io["x"]))
    gp, gx = vjp(jnp.asarray(io["g"]))
    sd = {}
    (_mamba2 if use_mamba2 else _mamba1)(sd, "m", jax.tree.map(np.asarray, gp))
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            **{f"d{k[2:]}": v.numpy() for k, v in sd.items()}}


def _check_mixer(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    _close(got["y"], want["y"], MIX_TOL, f"{what} y")
    for k in want:
        _close(got[k], want[k], GRAD_TOL, f"{what} {k}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("family", ["spiral", "vim"])
@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
def test_mixers_match_jax_unsharded(request, refs, mixer, family, mesh_name):
    """``Mamba`` (hidden 64) and ``Mamba2`` (hidden 128, 4 heads) with
    their weights replicated and their work sharded over tp 2, sp 2 or
    tp 2 x sp 2 ranks, on a spiral spec and on the vim spec (Mamba-1's
    merge quirk): on every rank the output and the gradients of x and of
    every parameter against the JAX mixer unsharded."""
    use_mamba2 = mixer == "mamba2"
    world = 4 if mesh_name == "tp2sp2" else 2
    for r, out in enumerate(_groups(request, world)):
        _check_mixer(out[f"mixer-{use_mamba2}-{family}-{mesh_name}"],
                     refs["mixers"][(use_mamba2, family)], f"rank {r}")


@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
def test_tp_sp_mixers_match_jax_shard_map(world4, refs, mixer):
    """The tp 2 x sp 2 mixer against JAX's own tp x sp ``shard_map`` on four
    of the conftest's virtual CPU devices, spiral spec."""
    use_mamba2 = mixer == "mamba2"
    want = refs["shard_map"][use_mamba2]
    for r, out in enumerate(world4):
        _check_mixer(out[f"mixer-{use_mamba2}-spiral-tp2sp2"], want, f"rank {r}")


# (d) the sp-only fused quirk ------------------------------------------------------


def test_sp_only_fused_mamba1_ignores_sp_as_jax_does(world2, refs):
    """JAX's ``Mamba`` with ``scan_impl="fused"`` and sp > 1 (no tp) runs
    ``mamba_inner_fused`` on the whole sequence before its sp branch
    (``diffma_tpu/models/mamba.py:265-268,299``): the port's mixer at sp 2
    matches JAX's so-built mixer (kernel H in interpret mode), output and
    every gradient, and equals in bits the port's unsharded route through
    kernel H's plain version."""
    from diffma_tpu_torch.ops.fused_mixer import MixerWeights, mixer_composable

    want = refs["quirk"]
    mixer = _port_mixer(False, "spiral", None, 1, 1)
    io = _mixer_io(False)
    x = torch.from_numpy(io["x"])
    inner = mixer_composable(mixer.spec, x, MixerWeights(*mixer.weights()), fused_inner=True)
    for r, out in enumerate(world2):
        _check_mixer(out["quirk"], want, f"rank {r}")
        assert np.array_equal(out["quirk"]["y"], inner.detach().numpy())


# (e) a DiffMa train step at dp 2 and tp 2 ---------------------------------------------


@pytest.mark.parametrize("mesh_name", ["dp2tp1", "dp1tp2"])
@pytest.mark.parametrize("family", ["mamba1", "mamba2"])
def test_train_step_matches_jax_unsharded(world2, refs, family, mesh_name):
    """One step of a depth-2 spiral DiffMa (hidden 64, or 128 on Mamba-2)
    at batch 4 over dp 2 (two rows a rank, the gradients averaged) or tp 2
    (the mixers sharded), from JAX's weights and draws: the global loss and
    the parameters against JAX's unsharded step, at
    ``tests/test_parallel.py``'s bars."""
    want_loss, want_params = refs["steps"][family]
    for out in world2:
        got = out[f"step-{family}-{mesh_name}"]
        assert got["finite"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=2e-4)
    params = world2[0][f"step-{family}-{mesh_name}"]["params"]
    assert set(params) == set(want_params)
    worst = max(float(np.abs(params[k] - v).max() / (np.abs(v).max() + 1e-9))
                for k, v in want_params.items())
    assert worst < 5e-3, worst


# (f) the trainer at dp 2, a checkpoint, a relaunch --------------------------------------


def _replica(tmp, steps: int):
    """One process fed both ranks' rows: every dp rank draws the same host
    batch from the same generator, so the global batch is it twice; the
    loss's draws cover the global batch."""
    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import train
    from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step

    cfg = _trainer_cfg(tmp)
    model = build_model("DiffMa-S/2", input_size=8, hidden_size=32, d_state=4)
    model.init_weights(torch.Generator().manual_seed(0))
    opt = adamw(model.parameters(), 1e-4)
    state = TrainState(model, opt)
    diffusion = create_diffusion("", device="cpu")
    step = make_train_step(train.make_loss_fn(model, diffusion), opt)
    gen = torch.Generator().manual_seed(int(cfg.global_seed))
    losses = []
    for _ in range(steps):
        host = train.synthetic_batch(gen, 2, 8, 16, dim=32)
        batch = {k: torch.cat([v, v]) for k, v in host.items()}
        batch["t"], batch["noise"] = train.loss_draws(diffusion, batch["z"], gen)
        losses.append(float(step(state, batch, gen)["loss"]))
    return state, np.asarray(losses, np.float32)


@pytest.mark.parametrize("phase", ["first", "resumed"])
def test_trainer_at_dp2_matches_one_process(runs, tmp_path, phase):
    """``tools/run_multiprocess_smoke.py``'s phases A and B: the trainer at
    dp 2 for 2 steps with a checkpoint at 2 (written by rank 0 alone), then
    new ranks resuming from it for 2 more; the parameters, the EMA and the
    global losses against one process fed both ranks' rows, 2 and 4 steps
    uninterrupted, at 1e-5. Both ranks end equal in bits, their generators
    in lockstep."""
    first, second, ckpt = runs["trainer"]
    runs, steps = (first, 2) if phase == "first" else (second, 4)
    assert os.listdir(ckpt) == ["0000002.pt"]
    want, losses = _replica(tmp_path, steps)
    a, b = runs
    for k in ("params", "ema"):
        assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
    assert np.array_equal(a["rng"], b["rng"])
    assert a["step"] == b["step"] == steps
    for k, mod in (("params", want.model), ("ema", want.ema)):
        for got, p in zip(a[k], mod.parameters()):
            _close(got, p.detach().numpy(), 1e-5, k)
    np.testing.assert_allclose(a["loss"], losses[-len(a["loss"]):], rtol=1e-5, atol=1e-5)


# (g)-(j) the NaN skip, the loss-aware sampler, the sampler, the refusals ----------------


def test_nan_on_one_rank_skips_on_every_rank(world2):
    """A NaN in rank 1's rows only: the global loss is NaN, so both ranks
    skip the step, and their parameters and EMA stay as they were, equal in
    bits."""
    a, b = (out["nan"] for out in world2)
    assert not a["finite"] and not b["finite"]
    assert a["step"] == b["step"] == 0
    assert a["unchanged"] and b["unchanged"]
    for k in ("params", "ema"):
        assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k


def test_loss_aware_sampler_gathers_every_rank(world2):
    """``LossSecondMomentResampler.update_with_local_losses`` at world 2:
    both ranks hold the history that JAX's sampler builds from both ranks'
    timesteps and losses, rank 0's first."""
    from diffma_tpu.diffusion.timestep_samplers import (
        LossSecondMomentResampler as JaxResampler,
    )

    ref = JaxResampler(_Diffusion(), history_per_term=2)
    for k in range(3):
        ts, losses = [], []
        for r in range(2):
            rng = np.random.default_rng(40 + 10 * k + r)
            ts += rng.integers(0, 10, 6).tolist()
            losses += rng.random(6).tolist()
        ref.update_with_all_losses(ts, losses)
    for out in world2:
        np.testing.assert_array_equal(out["loss_aware"]["counts"], ref._loss_counts)
        np.testing.assert_array_equal(out["loss_aware"]["history"], ref._loss_history)


def test_sampler_at_dp2_samples_each_rank_shard(world2, tmp_path):
    """The sampler's CLI path at dp 2: each rank's images and quality equal
    one process sampling that rank's shard (``process_index``), and each
    rank's grids are named apart."""
    from diffma_tpu_torch.train import sample

    cfg = _sample_cfg(tmp_path)
    model = sample.load_model(cfg, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' sums, in their order
    try:
        wants = [sample.sample_batches(model, cfg, "cpu", process_index=r, process_count=2)
                 for r in range(2)]
    finally:
        torch.set_num_threads(threads)
    for out, want in zip(world2, wants):
        got = out["sample"]
        for g, w in zip(got["images"], want):
            assert np.array_equal(g, w["images"])
        assert got["quality"] == [w["quality"] for w in want]
    assert world2[0]["sample"]["quality"] != world2[1]["sample"]["quality"]
    files = set(world2[0]["sample"]["files"])
    assert {f"rank{r}_{i}_sample_{k}.png" for r in (0, 1) for i in (1, 2)
            for k in ("gen", "ori", "ct")} == files


def test_refusals_of_the_layout():
    """An Ls not divisible by sp under tp x sp (both mixers, JAX's
    ``ValueError``), a sequence-parallel scan whose length is not divisible,
    and ``ngroups > 1`` under tp (JAX's assert)."""
    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.models.mamba2 import Mamba2
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec
    from diffma_tpu_torch.parallel.mesh import Mesh
    from diffma_tpu_torch.parallel.sequence import selective_scan_sequence_parallel

    mesh = Mesh(dp=1, tp=2, sp=2, rank=0, device=torch.device("cpu"))
    odd = build_scan_spec("spiral", 3, 0)  # streams of 9 steps
    for cls in (Mamba, Mamba2):
        with pytest.raises(ValueError, match="divisible by the sp axis size 2"):
            cls(64, odd, mesh=mesh, tp_axis="tp", sp_axis="sp")
    x = torch.zeros(1, 9, 4)
    with pytest.raises(ValueError, match="not divisible by the sp axis size 2"):
        selective_scan_sequence_parallel(x, x, torch.zeros(4, 2), x[..., :2], x[..., :2],
                                         torch.zeros(4), mesh)
    with pytest.raises(ValueError, match="ngroups=1"):
        Mamba2(64, build_scan_spec("spiral", 4, 0), ngroups=2, mesh=mesh, tp_axis="tp")


def test_trainer_refuses_a_global_batch_not_divisible_by_dp(world2):
    """``global_batch_size`` 3 over dp 2 raises on every rank, as
    ``diffma_tpu/train/train.py:368`` asserts."""
    for out in world2:
        assert out["odd_batch"] and "not divisible by dp 2" in out["odd_batch"]


def _embedder_replica(tmp):
    """One process that averages the two ranks' gradients: the mean of the
    InfoNCE losses of rank 0's and rank 1's batches, each encoded from the
    generator's state of that step, as every rank's generator is."""
    from diffma_tpu_torch.data.npy_dataset import SyntheticTriplets, make_loader
    from diffma_tpu_torch.models.ct_encoder import CTEncoder
    from diffma_tpu_torch.models.vae import AutoencoderKL
    from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step
    from diffma_tpu_torch.train.train_embedder import info_nce_loss_b

    model = CTEncoder(img_size=4, patch_size=2, in_channels=4, embed_dim=512,
                      contain_mask_token=True)
    model.init_weights(torch.Generator().manual_seed(0))
    vae = AutoencoderKL(with_encoder=True).init_weights(torch.Generator().manual_seed(1)).eval()
    opt = adamw(model.parameters(), 1e-4)
    state = TrainState(model, opt)

    def loss_fn(batch, generator):
        return sum(info_nce_loss_b(model(batch[r])[1]) for r in range(2)) / 2, {}

    step = make_train_step(loss_fn, opt, ema_decay=0.9999)
    gen = torch.Generator().manual_seed(0)
    dataset = SyntheticTriplets(n=64, size=32)
    loaders = [make_loader(dataset, 2, seed=0, epoch=0, process_index=r, process_count=2)
               for r in range(2)]
    for batches in zip(range(2), *loaders):
        lats, start = {}, gen.get_state()
        for r in range(2):
            gen.set_state(start)
            x3 = torch.from_numpy(batches[1 + r][0]).repeat(1, 3, 1, 1)
            with torch.no_grad():
                lats[r] = vae.encode_sample(x3, gen)
        step(state, lats, gen)
    return state


def test_embedder_at_dp2_averages_the_gradients(world2, tmp_path):
    """The embedder at dp 2 (2 steps, 2 rows a rank): both ranks hold the
    same model, equal to one process that averages both ranks' gradients
    (the port's decision; the JAX embedder sums no gradient over processes,
    so each of its processes trains a copy on its own shard)."""
    a, b = (out["embedder"] for out in world2)
    assert a["step"] == b["step"] == 2
    for k in ("params", "ema"):
        assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _embedder_replica(tmp_path)
    finally:
        torch.set_num_threads(threads)
    for k, mod in (("params", want.model), ("ema", want.ema)):
        for got, p in zip(a[k], mod.parameters()):
            _close(got, p.detach().numpy(), 1e-5, k)
