"""The port's bf16 Mamba-2 mixers against the JAX package's, on the CPU.

The JAX package builds its Mamba-2 model in bfloat16 under ``--autocast``;
the port's ``dtype=torch.bfloat16`` is its counterpart. Inputs come from
numpy with fixed seeds and go through both. On the JAX side the fused SSD
mixer runs kernels E, F and G (``_ssd_kernel``, ``_ssd_bwd_kernel``,
``_spiral_epilogue_kernel``) in interpret mode, as ``tests/test_fused_ssd.py``
runs them; on the port's side CPU tensors take the plain versions: kernel
E's bf16 arithmetic (``fused_ssd._ssd_mixer_fused_lowp``) and autograd over
it, kernel G's (``spiral_epilogue_ref`` at bf16).

The TPU kernel runs a stream of up to 256 steps as one chunk; the port
chunks at 64 steps with an fp32 state, and rounds only the products inside
a chunk, so a stream longer than 64 steps differs from JAX's by where
bf16's rounding falls. Bars, "mean-rel" as in ``tests/test_torch_bf16.py``
(mean |a - b| / mean |fp32 reference|):

* E's forward against JAX's in bf16: 1e-2; against its own fp32 result: 5e-2;
* every gradient through F against JAX's custom VJP in bf16: 2e-2;
* G, and the whole ``fuse_block`` block forward: 1e-2; its gradients: 2e-2;
* ``Mamba2`` on the composable route: 1e-2; a depth-1 Mamba-2 DiffMa: 2e-2;
* one training step: the loss within 1e-2 relative of JAX's, every
  parameter fp32 and within 2 lr of JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.models.blocks import SpiralMambaBlock as JaxSpiralMambaBlock
from diffma_tpu.models.diffma import DiffMa as JaxDiffMa
from diffma_tpu.models.mamba2 import Mamba2 as JaxMamba2
from diffma_tpu.ops import fused_ssd as jax_fused
from diffma_tpu.ops.norm import rms_norm_gated as jax_rms_norm_gated
from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec
from diffma_tpu.ops.ssd import ssd_chunked as jax_ssd_chunked
from diffma_tpu.train.state import TrainState as JaxTrainState
from diffma_tpu.train.state import make_train_step as jax_make_train_step
from diffma_tpu.train.train import make_loss_fn as jax_make_loss_fn
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.blocks import SpiralMambaBlock
from diffma_tpu_torch.models.diffma import DiffMa
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops import fused_ssd
from diffma_tpu_torch.ops.norm import rms_norm_gated
from diffma_tpu_torch.ops.scan_orders import build_scan_spec
from diffma_tpu_torch.ops.ssd import ssd_chunked
from diffma_tpu_torch.train import train
from diffma_tpu_torch.train.state import TrainState, make_train_step
from diffma_tpu_torch.utils.convert import _mamba2, _spiral_block, diffma_params_from_jax
from test_torch_bf16 import BF16, _bf16, mean_rel
from test_torch_fused_ssd import JAX_ORDER, NO_LIMIT, _torch_weights, _weights, _x
from test_torch_model import HIDDEN, INPUT, _inputs, randomize


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in ``tests/test_torch_bf16.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# fp32 islands: the SSD and the gated norm
# ---------------------------------------------------------------------------


def test_ssd_and_gated_norm_compute_in_fp32_and_return_bf16():
    """``ssd_chunked`` and ``rms_norm_gated`` on bf16 inputs compute in fp32
    and return bf16, as JAX's do."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    G, L, H, P, N = 2, 40, 2, 8, 4
    x, B, C = f(G, L, H, P), f(G, L, N), f(G, L, N)
    dt, A, D = 0.5 * f(G, L, H), -np.exp(0.5 * f(H)), f(H)
    (xj, Bj, Cj), (xt, Bt, Ct) = zip(*(_bf16(a) for a in (x, B, C)))
    got = ssd_chunked(xt, _t(dt), _t(A), Bt, Ct, _t(D), chunk_size=16)
    want = jax_ssd_chunked(xj, jnp.asarray(dt), jnp.asarray(A), Bj, Cj, jnp.asarray(D),
                           chunk_size=16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want) < 1e-3
    y, z, w = f(G, L, 16), f(G, L, 16), 1 + 0.1 * f(16)
    (yj, zj), (yt, zt) = zip(*(_bf16(a) for a in (y, z)))
    got = rms_norm_gated(yt, _t(w), zt, group_size=16)
    want = jax_rms_norm_gated(yj, jnp.asarray(w), zj, group_size=16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want) < 1e-3


# ---------------------------------------------------------------------------
# Kernels E and F: the fused mixer, forward and gradients
# ---------------------------------------------------------------------------

# (family, grid, layer, mixers): the Spiral block's dual call at 16 tokens,
# one mixer on EfficientVMamba's partition (four streams of 9 steps), and
# one Spiral mixer at 144 tokens, whose streams are longer than the kernels'
# 64-step chunk.
CASES = [("spiral", 4, 0, 2), ("eff", 6, 0, 1), ("spiral", 12, 1, 1)]


def _case(family, grid_n, layer, M, h=32):
    L = grid_n * grid_n
    ws = [_weights(20 + 10 * layer + m) for m in range(M)]
    xs = [_x(L, 40 + layer + m, batch=1) for m in range(M)]
    gs = [_x(L, 50 + layer + m, batch=1) for m in range(M)]
    return jax_spec(family, grid_n, layer), build_scan_spec(family, grid_n, layer), ws, xs, gs


def _jax_mixers(spec, xs, ws):
    """JAX's fused mixer (kernel E in interpret mode) and its VJP."""
    if len(xs) == 2:
        stacked = [jnp.stack([w[k] for w in ws]) for k in JAX_ORDER]
        return jax.vjp(lambda x12, *s: jax_fused.mamba2_dual_mixer_fused(
            spec, x12, *s, NO_LIMIT, 1e-5, 256), jnp.stack(xs), *stacked)
    return jax.vjp(lambda x, *s: jax_fused.mamba2_mixer_fused(spec, x, *s, NO_LIMIT, 1e-5, 256),
                   xs[0], *(ws[0][k] for k in JAX_ORDER))


@pytest.mark.parametrize("family,grid_n,layer,M", CASES)
def test_fused_ssd_forward_in_bf16_matches_jax(family, grid_n, layer, M):
    spec_j, spec_t, ws, xs, _ = _case(family, grid_n, layer, M)
    want, _ = _jax_mixers(spec_j, [jnp.asarray(x, jnp.bfloat16) for x in xs], ws)
    want = list(want) if M == 2 else [want]
    tw = [_torch_weights(w) for w in ws]
    xt = [torch.from_numpy(x) for x in xs]
    if M == 2:
        got = fused_ssd.mamba2_dual_mixer_fused(spec_t, *(x.to(BF16) for x in xt), *tw)
        fp32 = fused_ssd.mamba2_dual_mixer_fused(spec_t, *xt, *tw)
    else:
        got = (fused_ssd.mamba2_mixer_fused(spec_t, xt[0].to(BF16), tw[0]),)
        fp32 = (fused_ssd.mamba2_mixer_fused(spec_t, xt[0], tw[0]),)
    for a, b, ref in zip(got, want, fp32):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
        assert mean_rel(a, b, ref) < 1e-2
        assert mean_rel(a, ref) < 5e-2


@pytest.mark.parametrize("family,grid_n,layer,M", CASES)
def test_fused_ssd_gradients_in_bf16_match_jax(family, grid_n, layer, M):
    """Autograd over kernel E's bf16 plain version (kernel F's) against the
    JAX fused mixer's custom VJP (``_ssd_bwd_kernel`` in interpret mode) in
    bf16: gx bf16, every weight's gradient fp32, each within 2e-2.

    Not dt_bias and A_log: the TPU kernel takes the cumsum's adjoint g_cs as
    ``<g_y, y_pre> - <xdt, g_xdt>`` per head, two inner products whose
    diagonal terms cancel in exact arithmetic but not when each side's
    products round other operands to bf16; the reverse cumsum and ``gA =
    sum dt g_dA`` magnify what is left by the stream's length. So JAX's bf16
    dt_bias and A_log gradients lie 2 to 6% from its fp32 ones at 16 tokens
    and 28% and 176% at 144, while kernel F leaves the diagonal out exactly
    (``csrc/fused_ssd_bwd.cu``) and its plain version differentiates the
    rounded forward. Those two are held to JAX's fp32 VJP on the same
    inputs instead, within 2e-2; it is also every bar's denominator."""
    spec_j, spec_t, ws, xs, gs = _case(family, grid_n, layer, M)
    low = [_bf16(x) for x in xs]
    glow = [_bf16(g) for g in gs]
    _, vjp = _jax_mixers(spec_j, [j for j, _ in low], ws)
    want = vjp(jnp.stack([j for j, _ in glow]) if M == 2 else glow[0][0])
    _, vjp32 = _jax_mixers(spec_j, [jnp.asarray(x) for x in xs], ws)
    want32 = vjp32(jnp.stack(gs) if M == 2 else jnp.asarray(gs[0]))

    def jax_grads(grads, m):
        gx = grads[0][m] if M == 2 else grads[0]
        gw = {k: np.asarray(v[m] if M == 2 else v, np.float32) for k, v in zip(JAX_ORDER, grads[1:])}
        return gx, _torch_weights(gw)

    for m in range(M):
        gx, gw = fused_ssd.ssd_mixer_bwd_ref(spec_t, low[m][1], glow[m][1], _torch_weights(ws[m]))
        (jgx, jw), (jgx32, jw32) = jax_grads(want, m), jax_grads(want32, m)
        assert gx.dtype == BF16 and jgx.dtype == jnp.bfloat16
        assert mean_rel(gx, jgx, jgx32) < 2e-2
        for name, a, b, ref in zip(fused_ssd.Mamba2Weights._fields, gw, jw, jw32):
            assert a.dtype == torch.float32, name
            err = mean_rel(a, ref) if name in ("dt_bias", "A_log") else mean_rel(a, b, ref)
            assert err < 2e-2, (name, err)


# ---------------------------------------------------------------------------
# Kernel G and the whole fuse_block block
# ---------------------------------------------------------------------------


def _jax_epilogue(o, x, mods, anw, anb, fc1w, fc1b, fc2w, fc2b):
    """JAX's ``_spiral_epilogue_kernel`` in interpret mode, launched as
    ``_spiral_block_fwd_impl`` launches it (L a multiple of 8)."""
    _, B_, L, h = o.shape
    full = lambda i: (0, 0)  # noqa: E731
    return pl.pallas_call(
        functools.partial(jax_fused._spiral_epilogue_kernel, h=h),
        grid=(B_,),
        in_specs=[pl.BlockSpec((2, 1, L, h), lambda i: (0, i, 0, 0)),
                  pl.BlockSpec((1, L, h), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, 8, h), lambda i: (i, 0, 0)),
                  pl.BlockSpec((2, h), full), pl.BlockSpec((2, h), full),
                  pl.BlockSpec((2 * h, h), full), pl.BlockSpec((1, h), full),
                  pl.BlockSpec((h, 1), full), pl.BlockSpec((1, 1), full)],
        out_specs=pl.BlockSpec((1, L, h), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B_, L, h), x.dtype),
        interpret=True,
    )(o, x, mods, anw.reshape(2, h), anb.reshape(2, h), fc1w, fc1b[None, :], fc2w, fc2b[None, :])


def test_spiral_epilogue_in_bf16_matches_jax():
    """Kernel G's bf16 plain version against the TPU kernel in bf16."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    B_, L, h = 2, 64, 32
    o0, o1, x, gate = f(B_, L, h), f(B_, L, h), f(B_, L, h), f(B_, h)
    an_w, an_b = 1 + 0.1 * f(2 * h), 0.1 * f(2 * h)
    fc1_w, fc1_b, fc2_w, fc2_b = 0.2 * f(2 * h, h), 0.1 * f(h), 0.2 * f(h, 1), 0.1 * f(1)
    (o0j, o1j, xj, gj), (o0t, o1t, xt, gt) = zip(*(_bf16(a) for a in (o0, o1, x, gate)))
    mods = jnp.zeros((B_, 8, h), jnp.float32).at[:, 2].set(gj.astype(jnp.float32))
    want = _jax_epilogue(jnp.stack([o0j, o1j]), xj, mods, an_w, an_b, fc1_w, fc1_b, fc2_w, fc2_b)
    tail = (_t(an_w), _t(an_b), _t(fc1_w.T), _t(fc1_b), _t(fc2_w.T), _t(fc2_b))
    got = fused_ssd.spiral_epilogue_ref(o0t, o1t, xt, gt, *tail)
    fp32 = fused_ssd.spiral_epilogue_ref(*(_t(a) for a in (o0, o1, x, gate)), *tail)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want, fp32) < 1e-2
    assert mean_rel(got, fp32) < 5e-2


def _block_case(grid_n, layer, seed):
    """A bf16 and an fp32 JAX Mamba-2 Spiral block on the ``fuse_block``
    route, their randomised params, inputs and cotangent."""
    spec_j = jax_spec("spiral", grid_n, layer)
    L = grid_n * grid_n
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, HIDDEN)).astype(np.float32)
    c = rng.standard_normal((2, 2 * HIDDEN)).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.standard_normal((2, L, 1))))).astype(np.float32)
    g = rng.standard_normal((2, L, HIDDEN)).astype(np.float32)
    kw = dict(hidden=HIDDEN, use_mamba2=True, scan_impl="fused", fuse_block=True)
    jb = JaxSpiralMambaBlock(**kw, dtype=jnp.bfloat16)
    params = jax.jit(lambda k, *a: jb.init(k, *a, spec_j))(jax.random.PRNGKey(layer), x, c, w)
    jb32 = JaxSpiralMambaBlock(**kw)
    return spec_j, (jb, jb32), randomize(params["params"], seed + 1), (x, c, w), g


def _port_block(params, grid_n, layer, dtype):
    sd = {}
    _spiral_block(sd, "b", params, use_mamba2=True)
    block = SpiralMambaBlock(HIDDEN, build_scan_spec("spiral", grid_n, layer), use_mamba2=True,
                             scan_impl="fused", fuse_block=True, dtype=dtype)
    block.load_state_dict({k.removeprefix("b."): v for k, v in sd.items()}, strict=True)
    return block


def test_fuse_block_in_bf16_matches_jax():
    """The bf16 ``fuse_block`` Spiral block at 64 tokens (a multiple of 8:
    JAX's route returns NaN off the TPU elsewhere), forward (kernel E in
    prologue mode and kernel G) and every gradient (the JAX block's custom
    VJP recomputes through ``_spiral_block_ref``) against JAX's; the mixers'
    dt_bias and A_log against the fp32 JAX block's, as in
    ``test_fused_ssd_gradients_in_bf16_match_jax``."""
    grid_n, layer = 8, 1
    spec_j, (jb, jb32), params, (x, c, w), g = _block_case(grid_n, layer, 80)

    def jax_block(module, dtype):
        """The JAX block's output and parameter gradients in ``dtype``, and
        its x gradient, with the parameters' gradients under the port's
        names."""
        xd, cd, wd, gd = (jnp.asarray(a, dtype) for a in (x, c, w, g))
        fwd = jax.jit(lambda p, x: module.apply({"params": p}, x, cd, wd, spec_j))
        out, vjp = jax.vjp(fwd, params, xd)
        gp, gx = vjp(gd)
        named = {}
        _spiral_block(named, "b", jax.tree.map(lambda a: np.asarray(a, np.float32), gp),
                      use_mamba2=True)
        return out, gx, named

    want, gx, jg = jax_block(jb, jnp.bfloat16)
    ref, _, jg32 = jax_block(jb32, jnp.float32)
    block = _port_block(params, grid_n, layer, BF16)
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    got = block(xt, *(torch.from_numpy(a).to(BF16) for a in (c, w)))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want, ref) < 1e-2
    got.backward(torch.from_numpy(g).to(BF16))
    assert xt.grad.dtype == BF16
    assert mean_rel(xt.grad, gx) < 2e-2
    for name, p in block.named_parameters():
        assert p.grad.dtype == torch.float32, name
        per_head = name.endswith(("dt_bias", "A_log"))
        err = mean_rel(p.grad, (jg32 if per_head else jg)[f"b.{name}"])
        assert err < 2e-2, (name, err)


# ---------------------------------------------------------------------------
# Mamba2, the model, one training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_impl", ["auto", "fused"])
def test_mamba2_module_in_bf16_matches_jax(scan_impl):
    """``Mamba2(dtype=bf16)``: the composable route (``ssd_mixer_ref`` in
    bf16) and the fused one (kernel E's plain version) against JAX's
    ``Mamba2(dtype=bf16)`` on the same route."""
    spec_j, spec_t = jax_spec("spiral", 4, 3), build_scan_spec("spiral", 4, 3)
    x = np.random.default_rng(3).standard_normal((2, 16, HIDDEN)).astype(np.float32)
    jm = JaxMamba2(d_model=HIDDEN, scan_impl=scan_impl, dtype=jnp.bfloat16)
    params = jax.jit(lambda k, x: jm.init(k, x, spec_j))(jax.random.PRNGKey(0), jnp.asarray(x))
    params = randomize(params["params"], 61)
    want = jax.jit(lambda p, x: jm.apply(p, x, spec_j))({"params": params}, x)
    sd = {}
    _mamba2(sd, "m", params)
    m = Mamba2(HIDDEN, spec_t, scan_impl=scan_impl, dtype=BF16)
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    ref = Mamba2(HIDDEN, spec_t, scan_impl=scan_impl)
    ref.load_state_dict(m.state_dict())
    with torch.no_grad():
        got, fp32 = m(torch.from_numpy(x)), ref(torch.from_numpy(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert mean_rel(got, want, fp32) < 1e-2
    assert mean_rel(got, fp32) < 5e-2


@functools.lru_cache(maxsize=None)
def _model_params():
    """Random parameters of a depth-1 Mamba-2 DiffMa (fp32)."""
    jmodel = JaxDiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=1,
                       use_mamba2=True, scan_impl="ref")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *map(jnp.asarray, _inputs(1)))
    return randomize(params["params"], 1)


@pytest.mark.parametrize("scan_impl", ["fused", "auto"])
def test_mamba2_model_forward_in_bf16_matches_jax(scan_impl):
    """A depth-1 Mamba-2 DiffMa in bf16 (16 tokens, 64 wide) on the fused
    route (kernel E's plain version) and the composable one against JAX's."""
    kw = dict(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=1, use_mamba2=True,
              scan_impl=scan_impl)
    params = _model_params()
    want = jax.jit(JaxDiffMa(**kw, dtype=jnp.bfloat16).apply)(
        {"params": params}, *map(jnp.asarray, _inputs()))
    model = DiffMa(**kw, dtype=BF16)
    model.load_state_dict(diffma_params_from_jax(params, depth=1, use_mamba2=True), strict=True)
    fp32 = DiffMa(**kw)
    fp32.load_state_dict(model.state_dict())
    targs = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
             for a in _inputs()]
    with torch.no_grad():
        got, ref = model(*targs), fp32(*targs)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert mean_rel(got, want, ref) < 2e-2


def test_mamba2_train_step_in_bf16_matches_jax():
    """One predicated step of a depth-1 bf16 Mamba-2 DiffMa on the fused
    route (JAX: kernels E and F in interpret mode; the port: their plain
    versions under autograd) from the same parameters and draws: the loss,
    and every parameter and EMA entry (fp32) after the step."""
    from test_torch_train import HIDDEN, INPUT, _batch, _jax_draws, _torch_batch  # 32 wide

    lr, depth = 1e-3, 1
    kw = dict(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=depth, use_mamba2=True,
              scan_impl="fused")
    jmodel = JaxDiffMa(**kw, dtype=jnp.bfloat16)
    b = _batch()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), b["z"], jnp.zeros((1,), jnp.int32),
                                  b["y"], b["y2"], b["w"])["params"]
    params = randomize(params, 1)
    opt = optax.adamw(lr, b1=0.9, b2=0.999, weight_decay=0.0)
    jstep = jax.jit(jax_make_train_step(jax_make_loss_fn(jmodel, jax_create_diffusion("")), opt))
    rng = jax.random.PRNGKey(20)
    jstate, jmetrics = jstep(JaxTrainState.create(params, opt), _batch(10), rng)

    model = DiffMa(**kw, dtype=BF16)
    model.load_state_dict(diffma_params_from_jax(params, depth=depth, use_mamba2=True),
                          strict=True)
    topt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)
    state = TrainState(model, topt)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")), topt)
    batch = _batch(10)
    metrics = step(state, _torch_batch(batch, *_jax_draws(rng, batch["z"].shape)), None)
    assert bool(metrics["finite"]) and bool(jmetrics["finite"])
    assert abs(metrics["loss"].item() - float(jmetrics["loss"])) <= 1e-2 * abs(
        float(jmetrics["loss"]))
    for tree, module in ((jstate.params, state.model), (jstate.ema_params, state.ema)):
        ref = diffma_params_from_jax(jax.tree.map(np.asarray, tree), depth=depth, use_mamba2=True)
        sd = module.state_dict()
        for name, v in ref.items():
            assert sd[name].dtype == torch.float32, name
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=0, atol=2 * lr,
                                       err_msg=name)
