"""The port's incremental decode, single-step ops and associative scan
against the JAX package's, on the CPU.

The same numpy inputs and parameter trees (JAX's layout, carried to the
port by ``utils/convert.py``'s mixer mappings) go through
``diffma_tpu/models/decode.py`` and ``diffma_tpu_torch/models/decode.py``,
``selective_scan_assoc`` on both sides, and the ``scan_impl: assoc`` mixers.
The trees are drawn with numpy in the shapes of ``jax.eval_shape`` of the
Flax init, so no Flax init runs. Bars: the single-step ops, the assoc
forward and the fp32 steps 1e-5; assoc gradients 1e-4 (JAX's own assoc
against its ref, ``tests/test_selective_scan.py``); iterated steps against
the full forward 2e-4 (``tests/test_decode.py``); the bf16 steps
``BF16_STEP`` and ``BF16_STATE`` (see there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models import decode as jdecode
from diffma_tpu.models.mamba import Mamba as JaxMamba
from diffma_tpu.models.mamba2 import Mamba2 as JaxMamba2
from diffma_tpu.ops import conv as jconv
from diffma_tpu.ops import selective_scan as jscan
from diffma_tpu.ops import ssd as jssd
from diffma_tpu.ops.scan_orders import ScanSpec as JaxScanSpec
from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec
from diffma_tpu_torch.models import decode
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.ops.conv import causal_conv1d_update
from diffma_tpu_torch.ops.scan_orders import ScanSpec, build_scan_spec
from diffma_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_assoc,
    selective_scan_ref,
    selective_state_update,
)
from diffma_tpu_torch.ops.ssd import ssd_state_update
from diffma_tpu_torch.utils.convert import _mamba1, _mamba2

TOL = 1e-5
TOL_GRAD = 1e-4
TOL_FULL = 2e-4
# bf16 steps against JAX's bf16 steps, rtol = atol: outputs and the conv
# window 1e-4, the fp32 SSM state 1e-6. Both sides round the projections'
# outputs and the conv window to bf16 at the same places; XLA and PyTorch may
# sum a bf16 product's terms in other orders, and a value near a rounding
# boundary then lands an ulp apart. Seen, as max |got - want| / (1 + |want|):
# outputs 3.0e-5 (Mamba-1) and 0 (Mamba-2), the window 0, the state 5.4e-9
# and 4.6e-9. With dt computed in bf16 (decode.py's fp32 dt undone) the
# state moves 1.2e-5; with the conv filter applied in bf16, the outputs
# 2.8e-3 and 1.5e-2 and the state 1.8e-4 and 2.0e-4: each fails its bar.
BF16_STEP = 1e-4
BF16_STATE = 1e-6

D_MODEL = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these are many small operators, each of which,
    beside the suite's other workers, would otherwise wait on a parallel
    region's threads for busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def identity_specs(L):
    ident = np.arange(L, dtype=np.int32)
    return (JaxScanSpec(fwd=ident[None], merge=ident[:, None], scale=1.0),
            ScanSpec(fwd=ident[None], merge=ident[:, None], scale=1.0))


def _leaf(name, shape, rng):
    """A random value for one mixer parameter, in the range its init gives."""
    if name == "A_log":
        if len(shape) == 2:  # Mamba-1: S4D-real, perturbed
            return np.log(np.arange(1, shape[1] + 1))[None] + 0.1 * rng.standard_normal(shape)
        return np.log(rng.uniform(1, 16, shape))
    if name in ("D", "norm_weight", "scale"):
        return 1 + 0.1 * rng.standard_normal(shape)
    if name in ("dt_bias", "bias") and len(shape) == 1:
        return rng.uniform(-4.0, -1.0, shape)  # softplus(bias) in dt's range
    fan_in = shape[0] if len(shape) == 2 else shape[-1]
    return rng.standard_normal(shape) / np.sqrt(fan_in)


def random_tree(module, x, spec, seed):
    """A numpy tree in the shapes of ``module``'s Flax params."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, spec))["params"]
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                _leaf(k, v.shape, rng).astype(np.float32) for k, v in tree.items()}

    return fill(shapes)


def port_mixer(cls, mapping, tree, *args, **kw):
    sd = {}
    mapping(sd, "m", tree)
    m = cls(*args, **kw)
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    return m.eval()


def mamba1_pair(L, seed, batch=2, scan_impl="ref"):
    """A numpy tree of JAX's ``Mamba``, the port's mixer carrying it on an
    identity spec, and an input (batch, L, D_MODEL)."""
    jspec, spec = identity_specs(L)
    x = np.random.default_rng(seed).standard_normal((batch, L, D_MODEL)).astype(np.float32)
    tree = random_tree(JaxMamba(d_model=D_MODEL), jnp.asarray(x), jspec, seed + 1)
    return tree, port_mixer(Mamba, _mamba1, tree, D_MODEL, spec, scan_impl=scan_impl), x


def mamba2_pair(L, seed, batch=2, headdim=16, chunk_size=8):
    """As ``mamba1_pair`` for ``Mamba2``."""
    jspec, spec = identity_specs(L)
    x = np.random.default_rng(seed).standard_normal((batch, L, D_MODEL)).astype(np.float32)
    jm = JaxMamba2(d_model=D_MODEL, headdim=headdim, chunk_size=chunk_size)
    tree = random_tree(jm, jnp.asarray(x), jspec, seed + 1)
    m = port_mixer(Mamba2, _mamba2, tree, D_MODEL, spec, headdim=headdim, chunk_size=chunk_size)
    return tree, m, x


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


# --- the single-step ops ---------------------------------------------------


@pytest.mark.parametrize("with_bias", [True, False])
def test_conv_update_matches_jax(with_bias):
    rng = np.random.default_rng(0)
    x, state = rng.standard_normal((3, 24)), rng.standard_normal((3, 4, 24))
    w, b = rng.standard_normal((24, 4)), rng.standard_normal(24) if with_bias else None
    want = jconv.causal_conv1d_update(*(jnp.asarray(a, jnp.float32) for a in (x, state, w)),
                                      None if b is None else jnp.asarray(b, jnp.float32))
    state_t = _t(state)
    got = causal_conv1d_update(_t(x), state_t, _t(w), None if b is None else _t(b))
    for g, j in zip(got, want):
        assert_close(g, j, TOL)
    assert torch.equal(state_t, _t(state))  # the window passed in is unchanged


@pytest.mark.parametrize("gated, with_bias", [(True, True), (False, True), (True, False),
                                              (False, False)])
def test_selective_state_update_matches_jax(gated, with_bias):
    rng = np.random.default_rng(1)
    G, d, n = 3, 16, 8
    args = [rng.standard_normal((G, d, n)), rng.standard_normal((G, d)),
            rng.standard_normal((G, d)) - 1.0, -np.exp(rng.standard_normal((d, n))),
            rng.standard_normal((G, n)), rng.standard_normal((G, n)), rng.standard_normal(d)]
    z = rng.standard_normal((G, d)) if gated else None
    bias = rng.uniform(-3, -1, d) if with_bias else None

    def opt(a, to):
        return None if a is None else to(a)

    def j32(a):
        return jnp.asarray(a, jnp.float32)

    want = jscan.selective_state_update(*map(j32, args), z=opt(z, j32), dt_bias=opt(bias, j32))
    got = selective_state_update(*map(_t, args), z=opt(z, _t), dt_bias=opt(bias, _t))
    for g, j in zip(got, want):
        assert_close(g, j, TOL)


@pytest.mark.parametrize("d_shape", ["H", "HP"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_ssd_state_update_matches_jax(d_shape, with_bias):
    rng = np.random.default_rng(2)
    G, H, P, N = 2, 4, 8, 16
    D = rng.standard_normal((H,) if d_shape == "H" else (H, P))
    args = [rng.standard_normal((G, H, P, N)), rng.standard_normal((G, H, P)),
            rng.standard_normal((G, H)) - 1.0, -np.exp(rng.standard_normal(H)),
            rng.standard_normal((G, N)), rng.standard_normal((G, N)), D]
    bias = rng.uniform(-3, -1, H) if with_bias else None
    want = jssd.ssd_state_update(*(jnp.asarray(a, jnp.float32) for a in args),
                                 dt_bias=None if bias is None else jnp.asarray(bias, jnp.float32))
    got = ssd_state_update(*map(_t, args), dt_bias=None if bias is None else _t(bias))
    for g, j in zip(got, want):
        assert_close(g, j, TOL)


# --- the associative scan --------------------------------------------------


def scan_inputs(G=2, L=28, d=64, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        u=rng.standard_normal((G, L, d)), delta=0.5 * rng.standard_normal((G, L, d)) - 1.0,
        A=-np.exp(np.log(np.arange(1, n + 1))[None] + 0.1 * rng.standard_normal((d, n))),
        B=rng.standard_normal((G, L, n)), C=rng.standard_normal((G, L, n)),
        D=rng.standard_normal(d), z=rng.standard_normal((G, L, d)),
    )


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("L", [28, 13])  # composite and prime lengths
def test_assoc_forward_matches_jax(gated, L):
    x = scan_inputs(L=L)
    if not gated:
        x["z"] = None
    want = jax.jit(jscan.selective_scan_assoc)(
        **{k: None if v is None else jnp.asarray(v, jnp.float32) for k, v in x.items()})
    got = selective_scan(**{k: None if v is None else _t(v) for k, v in x.items()},
                         impl="assoc")
    assert_close(got, want, TOL)


def test_assoc_grads_match_ref_and_jax():
    x = scan_inputs(G=1, L=14, d=8, n=4)
    names = list(x)

    def jloss(*args):
        return jnp.sum(jnp.tanh(jscan.selective_scan_assoc(*args)))

    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(
        *(jnp.asarray(x[k], jnp.float32) for k in names))
    grads = {}
    for fn in (selective_scan_assoc, selective_scan_ref):
        args = [_t(x[k]).requires_grad_() for k in names]
        torch.tanh(fn(*args)).sum().backward()
        grads[fn] = [a.grad for a in args]
    for name, a, r, j in zip(names, grads[selective_scan_assoc], grads[selective_scan_ref],
                             jgrads):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=f"d{name}: assoc against ref")
        assert_close(a, j, TOL_GRAD, f"d{name}: against jax.grad of JAX's assoc")


@pytest.mark.parametrize("L", [196, 1024])
def test_assoc_keeps_o_of_l_for_backward(L):
    """What autograd saves of one ``selective_scan_assoc`` call, in units of
    one (G, L, d, n) fp32 tensor, stays under 8.5 at any L, as
    ``lax.associative_scan``'s odd/even levels do (their lengths halve). A
    Hillis-Steele scan keeps two such tensors a round: 18 units at L = 196,
    22 at 1024."""
    x = {k: _t(v).requires_grad_() for k, v in scan_inputs(G=1, L=L, d=8, n=4).items()}
    storages = {}

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        selective_scan_assoc(**x)
    inputs = {t.untyped_storage().data_ptr() for t in x.values()}
    saved = sum(n for ptr, n in storages.items() if ptr not in inputs)
    assert saved / (L * 8 * 4 * 4) < 8.5


def test_mamba_assoc_matches_jax():
    """``scan_impl="assoc"``: the port's composable path with the parallel
    scan against JAX's mixer with its own, on the Spiral spec."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, D_MODEL)).astype(np.float32)
    jm, jspec = JaxMamba(d_model=D_MODEL, scan_impl="assoc"), jax_spec("spiral", 4, 3)
    tree = random_tree(jm, jnp.asarray(x), jspec, 6)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, jspec))(tree, jnp.asarray(x))
    m = port_mixer(Mamba, _mamba1, tree, D_MODEL, build_scan_spec("spiral", 4, 3),
                   scan_impl="assoc")
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert_close(got, want, TOL_FULL)


@pytest.mark.parametrize("use_mamba2", [False, True])
def test_assoc_model_runs_and_matches_ref(use_mamba2):
    """A DiffMa model builds with ``scan_impl="assoc"``, as in JAX, and its
    forward and gradients agree with ``"ref"``'s (Mamba-2 takes the
    composable path on both)."""
    torch.manual_seed(0)
    model = build_model("DiffMa-S/2", input_size=8, hidden_size=32, scan_impl="assoc",
                        use_mamba2=use_mamba2)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    gen = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 4, 8, 8, generator=gen), torch.tensor([3, 700]),
            torch.randn(2, 32, generator=gen), torch.randn(2, 16, 32, generator=gen),
            torch.rand(2, 16, 1, generator=gen))
    out = {}
    for impl in ("assoc", "ref"):
        model.set_scan_impl(impl)
        model.zero_grad()
        y = model(*args)
        y.square().mean().backward()
        out[impl] = (y.detach(), {k: p.grad.clone() for k, p in model.named_parameters()})
    assert torch.isfinite(out["assoc"][0]).all()
    np.testing.assert_allclose(out["assoc"][0].numpy(), out["ref"][0].numpy(), rtol=TOL_FULL,
                               atol=TOL_FULL)
    for k, g in out["assoc"][1].items():
        np.testing.assert_allclose(g.numpy(), out["ref"][1][k].numpy(), rtol=TOL_FULL,
                                   atol=TOL_FULL, err_msg=k)


# --- decode ----------------------------------------------------------------


def _steps(step, cache, x):
    ys = []
    for t in range(x.shape[1]):
        y, cache = step(x[:, t], cache)
        ys.append(y)
    return ys, cache


def _compare_steps(port, jax_, dtype):
    (ys, cache), (jys, jcache) = port, jax_
    assert all(y.dtype == dtype for y in ys) and cache.conv_state.dtype == dtype
    assert cache.ssm_state.dtype == torch.float32
    tol, state_tol = (TOL, TOL) if dtype == torch.float32 else (BF16_STEP, BF16_STATE)
    for t, (g, j) in enumerate(zip(ys, jys)):
        assert_close(g.float(), j, tol, f"output {t}")
    assert_close(cache.conv_state.float(), jcache.conv_state, tol, "conv window")
    assert_close(cache.ssm_state, jcache.ssm_state, state_tol, "SSM state")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_step_matches_jax(dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tree, m, x = mamba1_pair(12, seed=10)
    jtree = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(lambda xt, c: jdecode.mamba_step(jtree, xt, c))
    jcache = jdecode.allocate_mamba_cache(2, d_inner=2 * D_MODEL, dtype=jdtype)
    cache = decode.allocate_mamba_cache(2, d_inner=2 * D_MODEL, dtype=dtype, device="cpu")
    with torch.no_grad():
        port = _steps(lambda xt, c: decode.mamba_step(m, xt, c), cache, _t(x, dtype))
    _compare_steps(port, _steps(jstep, jcache, jnp.asarray(x, jdtype)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_step_matches_jax(dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tree, m, x = mamba2_pair(16, seed=20)
    jtree = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(lambda xt, c: jdecode.mamba2_step(jtree, xt, c, headdim=16))
    jcache = jdecode.allocate_mamba2_cache(2, d_inner=2 * D_MODEL, headdim=16, dtype=jdtype)
    cache = decode.allocate_mamba2_cache(2, d_inner=2 * D_MODEL, headdim=16, dtype=dtype,
                                         device="cpu")
    with torch.no_grad():  # the tuple form
        port = _steps(lambda xt, c: decode.mamba2_step(m.weights(), xt, c), cache, _t(x, dtype))
    _compare_steps(port, _steps(jstep, jcache, jnp.asarray(x, jdtype)), dtype)


@pytest.mark.parametrize("scan_impl", ["ref", "assoc"])
def test_mamba_steps_match_full_forward(scan_impl):
    """Iterating the step over 12 tokens gives the full forward on an
    identity spec (the counterpart of ``tests/test_decode.py``)."""
    _, m, x = mamba1_pair(12, seed=30, scan_impl=scan_impl)
    with torch.no_grad():
        full = m(torch.from_numpy(x))
        cache = decode.allocate_mamba_cache(2, d_inner=2 * D_MODEL, device="cpu")
        ys, _ = _steps(lambda xt, c: decode.mamba_step(m.weights(), xt, c), cache,
                       torch.from_numpy(x))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), full.numpy(), rtol=TOL_FULL,
                               atol=TOL_FULL)


def test_mamba2_steps_match_full_forward():
    """Mamba-2 at chunk_size 8 over 16 tokens: the steps cross a chunk."""
    _, m, x = mamba2_pair(16, seed=40, chunk_size=8)
    with torch.no_grad():
        full = m(torch.from_numpy(x))
        cache = decode.allocate_mamba2_cache(2, d_inner=2 * D_MODEL, headdim=16, device="cpu")
        ys, _ = _steps(lambda xt, c: decode.mamba2_step(m, xt, c), cache, torch.from_numpy(x))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), full.numpy(), rtol=TOL_FULL,
                               atol=TOL_FULL)


def test_step_leaves_its_cache_and_refuses_groups():
    _, m, x = mamba1_pair(2, seed=50)
    cache = decode.allocate_mamba_cache(2, d_inner=2 * D_MODEL, device="cpu")
    with torch.no_grad():
        cache = decode.mamba_step(m, torch.from_numpy(x[:, 0]), cache)[1]
        before = [t.clone() for t in cache]
        _, new = decode.mamba_step(m, torch.from_numpy(x[:, 1]), cache)
    assert all(torch.equal(a, b) for a, b in zip(cache, before))
    assert not torch.equal(new.ssm_state, cache.ssm_state)
    m2 = Mamba2(D_MODEL, identity_specs(2)[1], headdim=16, ngroups=2)
    cache2 = decode.allocate_mamba2_cache(2, d_inner=2 * D_MODEL, headdim=16, ngroups=2,
                                          device="cpu")
    with pytest.raises(ValueError, match="ngroups=2"):
        decode.mamba2_step(m2, torch.from_numpy(x[:, 0]), cache2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_caches_match_jax(dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pairs = [
        (decode.allocate_mamba_cache(3, 64, d_conv=4, d_state=8, dtype=dtype, device="cpu"),
         jdecode.allocate_mamba_cache(3, 64, d_conv=4, d_state=8, dtype=jdtype)),
        (decode.allocate_mamba2_cache(3, 128, d_state=16, headdim=32, dtype=dtype,
                                      device="cpu"),
         jdecode.allocate_mamba2_cache(3, 128, d_state=16, headdim=32, dtype=jdtype)),
    ]
    for cache, jcache in pairs:
        assert cache._fields == jcache._fields
        for t, j in zip(cache, jcache):
            assert tuple(t.shape) == j.shape and str(t.dtype).removeprefix("torch.") == str(
                j.dtype)
            assert not t.any()
