"""The port's bf16 model against the JAX package's, on the CPU.

The JAX package builds its model in bfloat16 under ``--autocast``
(``dtype=jnp.bfloat16``: fp32 parameters, bf16 activations, fp32 islands);
the port's ``dtype=torch.bfloat16`` is its counterpart. Inputs come from
numpy with fixed seeds and go through both. On the JAX side the fused mixer
runs kernels C and D (``_mixer_kernel``, ``_mixer_bwd_kernel``) in interpret
mode; on the port's side CPU tensors take the plain versions: kernel C's
bf16 arithmetic (``fused_mixer._mixer_fused_lowp``) and autograd over it.

Bars follow from bf16's 8-bit mantissa (one rounding is 2^-9 relative, an
ulp 2^-8) and from sums whose intermediates round in another order in
torch and XLA. "mean-rel" is mean |a - b| / mean |fp32 reference|:

* the fused mixer's forward against JAX's in bf16: 1e-2; against its own
  fp32 result: 5e-2 (``tests/test_fused_mixer.py::test_bf16_close_to_fp32``);
* each of its gradients against JAX's monolithic backward in bf16: 2e-2;
  against the fp32 gradients: 5e-2 (``test_monolithic_bwd_bf16_close_to_fp32``);
* a small DiffMa's forward against JAX's in bf16: 2e-2;
* one training step: the loss within 1e-2 relative of JAX's, every
  parameter fp32 and within 2 lr of JAX's (AdamW moves each parameter by
  about lr, whatever its gradient's size, so a gradient near zero may take
  the other sign).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.models.diffma import DiffMa as JaxDiffMa
from diffma_tpu.models.mamba import Mamba as JaxMamba
from diffma_tpu.ops import fused_mixer as jax_fused
from diffma_tpu.ops.conv import causal_conv1d as jax_conv
from diffma_tpu.ops.norm import layer_norm as jax_layer_norm
from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec
from diffma_tpu.ops.selective_scan import selective_scan_ref as jax_scan_ref
from diffma_tpu.train.state import TrainState as JaxTrainState
from diffma_tpu.train.state import make_train_step as jax_make_train_step
from diffma_tpu.train.train import make_loss_fn as jax_make_loss_fn
from diffma_tpu_torch.data.npy_dataset import write_triplet_folders
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.diffma import DiffMa, build_model
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.ops import fused_mixer
from diffma_tpu_torch.ops.conv import causal_conv1d
from diffma_tpu_torch.ops.norm import layer_norm
from diffma_tpu_torch.ops.scan_orders import build_scan_spec
from diffma_tpu_torch.ops.selective_scan import selective_scan
from diffma_tpu_torch.train import sample, train, train_embedder
from diffma_tpu_torch.train.state import TrainState, make_train_step
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.convert import _mamba1, diffma_params_from_jax
from test_torch_fused_mixer import JAX_ORDER, _torch_weights, _weights, _x
from test_torch_model import HIDDEN, INPUT, _inputs, randomize

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests are many small operators, each of
    which, beside the suite's other workers, would otherwise wait on a
    parallel region's threads for busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a) -> np.ndarray:
    return np.asarray(a.detach().float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32),
                      np.float32)


def mean_rel(a, b, ref=None) -> float:
    a, b = _np(a), _np(b)
    ref = b if ref is None else _np(ref)
    return float(np.abs(a - b).mean() / np.abs(ref).mean())


def _bf16(a: np.ndarray):
    """The array and its bf16 rounding, as the two packages' bf16 inputs."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


# ---------------------------------------------------------------------------
# fp32 islands: LayerNorm, the conv, the scan
# ---------------------------------------------------------------------------


def test_layer_norm_and_conv_compute_in_fp32_and_return_bf16():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w, b = (rng.standard_normal(24).astype(np.float32) for _ in range(2))
    cw, cb = rng.standard_normal((24, 4)).astype(np.float32), rng.standard_normal(24).astype(
        np.float32)
    xj, xt = _bf16(x)
    got = layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b), eps=1e-5)
    want = jax_layer_norm(xj, jnp.asarray(w), jnp.asarray(b), eps=1e-5)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want) < 1e-3
    got = causal_conv1d(xt, torch.from_numpy(cw), torch.from_numpy(cb))
    want = jax_conv(xj, jnp.asarray(cw), jnp.asarray(cb), activation="silu")
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want) < 1e-3


def test_plain_scan_backward_in_bf16_matches_jax():
    """The plain scan on bf16 u, B, C, z (fp32 delta, state and arithmetic)
    returns bf16, and its gradients, each in its input's dtype, follow JAX's
    VJP of ``selective_scan_ref`` on the same bf16 inputs."""
    rng = np.random.default_rng(1)
    G, L, d, n = 2, 13, 8, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    u, B, C, z, g = f(G, L, d), f(G, L, n), f(G, L, n), f(G, L, d), f(G, L, d)
    delta, A, D = 0.5 * f(G, L, d) - 1.0, -np.exp(0.5 * f(d, n)), f(d)
    low = [_bf16(a) for a in (u, B, C, z, g)]
    (uj, Bj, Cj, zj, gj), (ut, Bt, Ct, zt, gt) = zip(*low)
    out, vjp = jax.vjp(lambda u, delta, B, C, z: jax_scan_ref(u, delta, jnp.asarray(A), B, C,
                                                              jnp.asarray(D), z=z),
                       uj, jnp.asarray(delta), Bj, Cj, zj)
    want = vjp(gj.astype(out.dtype))
    leaves = [t.clone().requires_grad_() for t in (ut, torch.from_numpy(delta), Bt, Ct, zt)]
    got = selective_scan(leaves[0], leaves[1], torch.from_numpy(A), leaves[2], leaves[3],
                         torch.from_numpy(D), z=leaves[4], impl="ref")
    assert got.dtype == BF16 and out.dtype == jnp.bfloat16
    assert mean_rel(got, out) < 1e-2
    grads = torch.autograd.grad(got, leaves, gt)
    for name, a, b, leaf in zip(("u", "delta", "B", "C", "z"), grads, want, leaves):
        assert a.dtype == leaf.dtype, name
        assert mean_rel(a, b) < 2e-2, name


# ---------------------------------------------------------------------------
# The fused mixer (kernels C and D's plain versions) and Mamba
# ---------------------------------------------------------------------------

# (block type, grid, layer): the Spiral block's dual call, and one mixer on
# the vim quirk and on EfficientVMamba's partition.
MIXER_CASES = [("spiral", 4, 0), ("spiral", 5, 1), ("vim", 4, 0), ("efficientVMamba", 4, 0)]


def _jax_mixer(spec, xs, ws):
    if len(xs) == 2:
        stacked = [jnp.stack([w[k] for w in ws]) for k in JAX_ORDER]
        return list(jax_fused.mamba_dual_mixer_fused(spec, jnp.stack(xs), *stacked))
    return [jax_fused.mamba_mixer_fused(spec, xs[0], *(ws[0][k] for k in JAX_ORDER))]


def _mixer_case(block, grid_n, layer):
    M = 2 if block == "spiral" else 1
    L = grid_n * grid_n
    ws = [_weights(10 * layer + m) for m in range(M)]
    xs = [_x(L, 20 + layer + m) for m in range(M)]
    gs = [_x(L, 30 + layer + m) for m in range(M)]
    return jax_spec(block, grid_n, layer), build_scan_spec(block, grid_n, layer), ws, xs, gs


@pytest.mark.parametrize("block,grid_n,layer", MIXER_CASES)
def test_fused_mixer_forward_in_bf16_matches_jax(block, grid_n, layer):
    spec_j, spec_t, ws, xs, _ = _mixer_case(block, grid_n, layer)
    want = _jax_mixer(spec_j, [jnp.asarray(x, jnp.bfloat16) for x in xs], ws)
    xt = [torch.from_numpy(x) for x in xs]
    tw = [_torch_weights(w) for w in ws]
    if len(xs) == 2:
        got = fused_mixer.mamba_dual_mixer_fused(spec_t, xt[0].to(BF16), xt[1].to(BF16), *tw)
        fp32 = fused_mixer.mamba_dual_mixer_fused(spec_t, *xt, *tw)
    else:
        got = (fused_mixer.mamba_mixer_fused(spec_t, xt[0].to(BF16), tw[0]),)
        fp32 = (fused_mixer.mamba_mixer_fused(spec_t, xt[0], tw[0]),)
    for a, b, ref in zip(got, want, fp32):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
        assert mean_rel(a, b, ref) < 1e-2
        assert mean_rel(a, ref) < 5e-2


@pytest.mark.parametrize("block,grid_n,layer", [MIXER_CASES[0], MIXER_CASES[2], MIXER_CASES[3]])
def test_fused_mixer_gradients_in_bf16_match_jax(block, grid_n, layer):
    """Autograd over kernel C's bf16 plain version against JAX's monolithic
    backward in bf16 (one mixer: the Spiral case's first branch), and
    against the fp32 gradients; gx in bf16, every weight's gradient fp32."""
    spec_j, spec_t, ws, xs, gs = _mixer_case(block, grid_n, layer)
    w, x, g = ws[0], xs[0], gs[0]
    xj, xt = _bf16(x)
    gj, gt = _bf16(g)
    out = jax_fused._monolithic_bwd(spec_j, xj, gj, *(w[k] for k in JAX_ORDER))
    jw = dict(zip(JAX_ORDER, (np.asarray(o, np.float32) for o in out[1:])))
    jw["A_log"] = jw.pop("A") * w["A"]
    want = _torch_weights({**w, **jw})
    tw = _torch_weights(w)
    gx, gw = fused_mixer.mixer_bwd_ref(spec_t, xt, gt, tw)
    gx32, gw32 = fused_mixer.mixer_bwd_ref(spec_t, torch.from_numpy(x), torch.from_numpy(g), tw)
    assert gx.dtype == BF16 and out[0].dtype == jnp.bfloat16
    assert mean_rel(gx, out[0], gx32) < 2e-2
    assert mean_rel(gx, gx32) < 5e-2
    for name, a, b, ref in zip(fused_mixer.MixerWeights._fields, gw, want, gw32):
        assert a.dtype == torch.float32, name
        assert mean_rel(a, b, ref) < 2e-2, name
        assert mean_rel(a, ref) < 5e-2, name


@pytest.mark.parametrize("block,layer", [("spiral", 3), ("vim", 0)])
def test_composable_mamba_in_bf16_matches_jax(block, layer):
    """``Mamba(dtype=bf16)`` on the composable route (the plain scan on the
    CPU) against JAX's ``Mamba(dtype=bf16, scan_impl="auto")``."""
    h = 32
    spec_j, spec_t = jax_spec(block, 4, layer), build_scan_spec(block, 4, layer)
    x = np.random.default_rng(layer).standard_normal((2, 16, h)).astype(np.float32)
    jm = JaxMamba(d_model=h, scan_impl="auto", dtype=jnp.bfloat16)
    params = jax.jit(lambda k, x: jm.init(k, x, spec_j))(jax.random.PRNGKey(0), jnp.asarray(x))
    params = randomize(params["params"], 6)
    want = jax.jit(lambda p, x: jm.apply(p, x, spec_j))({"params": params}, x)
    sd = {}
    _mamba1(sd, "m", params)
    m = Mamba(h, spec_t, scan_impl="auto", dtype=BF16)
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        ref = Mamba(h, spec_t, scan_impl="auto").requires_grad_(False)
        ref.load_state_dict(m.state_dict())
        fp32 = ref(torch.from_numpy(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want, fp32) < 1e-2
    assert mean_rel(got, fp32) < 5e-2


# ---------------------------------------------------------------------------
# The model, one training step, the CLIs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model_params(block_type):
    """Random parameters of a depth-1 DiffMa of ``block_type`` (fp32, as
    Flax keeps them whatever the compute dtype), shared by its routes."""
    jmodel = JaxDiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=1,
                       block_type=block_type, scan_impl="ref")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *map(jnp.asarray, _inputs(1)))
    return randomize(params["params"], 1)


@pytest.mark.parametrize("block_type,scan_impl", [("spiral", "fused"), ("spiral", "auto"),
                                                  ("vim", "fused"), ("DiT", "auto")])
def test_model_forward_in_bf16_matches_jax(block_type, scan_impl):
    """Depth 1, 16 tokens, 64 wide. One block: with every parameter moved by
    ``randomize``, each further block amplifies bf16's rounding, and at
    depth 2 each package's bf16 Spiral model is already 2% off its own fp32
    output (JAX's a little more than the port's), so the two differ by as
    much; at depth 1 each lies within 1% of fp32."""
    kw = dict(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=1, block_type=block_type,
              scan_impl=scan_impl)
    jmodel = JaxDiffMa(**kw, dtype=jnp.bfloat16)
    inputs = _inputs()
    params = _model_params(block_type)
    model = DiffMa(**kw, dtype=BF16)
    model.load_state_dict(diffma_params_from_jax(params, depth=1), strict=True)
    fp32 = DiffMa(**kw)
    fp32.load_state_dict(model.state_dict())
    want = jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, inputs))
    targs = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a) for a in inputs]
    with torch.no_grad():
        got, ref = model(*targs), fp32(*targs)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert mean_rel(got, want, ref) < 2e-2


def test_train_step_in_bf16_matches_jax():
    """One predicated step (``make_train_step``) of a depth-1 bf16 DiffMa on
    the composable route against JAX's ``make_train_step`` at ``dtype =
    bfloat16``, from the same parameters and draws: the loss, and every
    parameter and EMA entry (fp32) after the step."""
    from test_torch_train import HIDDEN, INPUT, _batch, _jax_draws, _torch_batch  # 32 wide

    lr, DEPTH = 1e-3, 1
    jmodel = JaxDiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=DEPTH,
                       scan_impl="ref", dtype=jnp.bfloat16)
    b = _batch()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), b["z"], jnp.zeros((1,), jnp.int32),
                                  b["y"], b["y2"], b["w"])["params"]
    params = randomize(params, 1)
    opt = optax.adamw(lr, b1=0.9, b2=0.999, weight_decay=0.0)
    jstep = jax.jit(jax_make_train_step(jax_make_loss_fn(jmodel, jax_create_diffusion("")), opt))
    rng = jax.random.PRNGKey(20)
    jstate, jmetrics = jstep(JaxTrainState.create(params, opt), _batch(10), rng)

    model = DiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=DEPTH,
                   scan_impl="auto", dtype=BF16)
    model.load_state_dict(diffma_params_from_jax(params, depth=DEPTH), strict=True)
    topt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)
    state = TrainState(model, topt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), topt)
    batch = _batch(10)
    metrics = step(state, _torch_batch(batch, *_jax_draws(rng, batch["z"].shape)), None)
    assert bool(metrics["finite"]) and bool(jmetrics["finite"])
    assert metrics["loss"].dtype == torch.float32
    assert abs(metrics["loss"].item() - float(jmetrics["loss"])) <= 1e-2 * abs(
        float(jmetrics["loss"]))
    for tree, module in ((jstate.params, state.model), (jstate.ema_params, state.ema)):
        ref = diffma_params_from_jax(jax.tree.map(np.asarray, tree), depth=DEPTH)
        sd = module.state_dict()
        for name, v in ref.items():
            assert sd[name].dtype == torch.float32, name
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=0, atol=2 * lr,
                                       err_msg=name)
    assert all(t.dtype == torch.float32 for s in topt.state.values() for t in s.values())


def test_nan_skip_holds_when_a_bf16_forward_overflows():
    """A batch whose bf16 forward overflows to inf gives a non-finite loss,
    and the step leaves the parameters, the EMA and the step count as they
    were; the next finite batch steps."""
    model = DiffMa(input_size=8, patch_size=2, hidden_size=32, depth=2, dtype=BF16)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # adaLN and the final layer off zero, so that y reaches the output
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    state = TrainState(model, opt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), opt)
    gen = torch.Generator().manual_seed(1)
    batch = train.synthetic_batch(gen, 2, 8, 16, dim=32)
    huge = dict(batch, y=torch.full_like(batch["y"], 3e38))  # adaLN's sums overflow to inf
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = step(state, huge, gen)
    assert not bool(metrics["finite"]) and int(state.step) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert bool(step(state, batch, gen)["finite"]) and int(state.step) == 1


def test_trainer_and_sampler_clis_take_autocast(tmp_path):
    """``--autocast`` on the CPU at a toy size: the model computes in bf16,
    its parameters, EMA and checkpoint stay fp32, and the sampler's
    ``--autocast`` reads the checkpoint back into a bf16 model and gives
    finite images."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(
        "epochs: 1\nlr: 1e-3\nmodel: DiffMa-S/2\nimage_size: 32\nglobal_batch_size: 2\n"
        "synthetic_data: true\nsynthetic_dataset_size: 4\nhidden_size: 32\n"
        "sample_num_steps: 2\nsample_num_batches: 1\n"
        f"save_dir: \"{tmp_path / 'out'}\"\n"
    )
    state = train.cli(["--config", str(cfg_path), "--device", "cpu", "--max-steps", "2",
                       "--ckpt-every", "2", "--results-dir", str(tmp_path / "r"), "--autocast"])
    assert int(state.step) == 2 and state.model.dtype == BF16
    assert all(p.dtype == torch.float32 for m in (state.model, state.ema) for p in m.parameters())
    ckpt = tmp_path / "r" / "000-DiffMa-S-2" / "checkpoints" / "0000002.pt"
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert all(v.dtype == torch.float32 for k in ("model", "ema") for v in saved[k].values())
    results = sample.cli(["--config", str(cfg_path), "--ckpt", str(ckpt), "--autocast",
                          "--device", "cpu"])
    assert results[0]["images"].shape == (1, 3, 32, 32) and np.isfinite(results[0]["images"]).all()
    model = sample.load_model(Config(model="DiffMa-S/2", image_size=32, hidden_size=32,
                                     ckpt=str(ckpt), autocast=True), "cpu")
    assert model.dtype == BF16
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, saved["ema"][k]), k


def test_embedder_cli_accepts_autocast_and_trains_in_fp32(tmp_path):
    """As in the JAX package, ``--autocast`` reaches the embedder's config
    and nothing reads it: the same steps give the same CT encoder."""
    folders = write_triplet_folders(str(tmp_path / "data"), 4, "train")
    cfg = Config(image_size=32, embedder_epoch=1, embedder_global_batch_size=2,
                 embedder_global_seed=0, embedder_patch_size=2, embedder_embed_dim=512,
                 log_every=1, **folders)
    cfg_path = tmp_path / "embedder.yaml"
    cfg_path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    states = [train_embedder.cli(["--config", str(cfg_path), "--max-steps", "1", "--device",
                                  "cpu", "--results-dir", str(tmp_path / f"emb{i}"), *flag])
              for i, flag in enumerate(([], ["--autocast"]))]
    plain, autocast = (s.model.state_dict() for s in states)
    assert all(v.dtype == torch.float32 and torch.equal(v, autocast[k]) for k, v in plain.items())


@pytest.mark.parametrize("fuse_block", [False, True])
def test_bf16_mamba2_models_build_and_run(fuse_block):
    """A bf16 Mamba-2 model, on the dual route and with ``fuse_block``, builds
    and runs a forward on the CPU (the plain versions of kernels E and F, or
    E and G): a finite bf16 output, fp32 parameters."""
    model = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN, use_mamba2=True,
                        fuse_block=fuse_block, scan_impl="fused", dtype=BF16)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():  # adaLN and the final layer off zero
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        out = model(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
                      for a in _inputs()))
    assert out.dtype == BF16 and out.shape == (2, 8, INPUT, INPUT)
    assert bool(torch.isfinite(out).all())
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("kernel", ["H", "P"])
def test_kernels_without_bf16_variants_refuse_bf16(kernel):
    """Kernels H (the Mamba-1 inner part) and P (the split SSD probe's
    core) have no bf16 variant, and no registry model reaches them: their
    wrappers refuse bf16 tensors, naming the kernel, on any device."""
    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda
    from diffma_tpu_torch.ops.fused_ssd import Mamba2Weights, ssd_core_cuda

    with pytest.raises(ValueError, match=f"kernel {kernel} has no bf16 variant"):
        if kernel == "H":
            d, n, r = 8, 16, 2
            mamba_inner_fused_cuda(torch.zeros(1, 4, 2 * d, dtype=BF16), torch.zeros(d, 4),
                                   torch.zeros(d), torch.zeros(r + 2 * n, d), torch.zeros(d, r),
                                   torch.zeros(d), torch.zeros(d, n), torch.zeros(d))
        else:
            d, H = 64, 1
            w = Mamba2Weights(None, torch.zeros(d + 32, 1, 4), torch.zeros(d + 32),
                              torch.zeros(H), torch.zeros(H), torch.zeros(H), torch.zeros(d), None)
            ssd_core_cuda(torch.zeros(1, 4, 2 * d + 32 + H, dtype=BF16), (w,))
