"""Kernels H and P at bf16, and the port's last repairs, against the JAX
package on the CPU.

Kernel H (the Mamba-1 mixer's inner part, ``ops/fused_mamba.py``) at a bf16
xz: its value against JAX's ``mamba_inner_fused`` (``_fused_kernel`` in
interpret mode) within 1e-4 mean-relative and 2^-7 of the largest |ref| an
element, its gradients against JAX's custom VJP (which recomputes through
``_fused_ref``) at the repo's bf16 gradient bar, 2e-2 mean-relative, and the
bf16 ``Mamba`` on a spec that kernel C cannot take (which reaches it) against
JAX's at 1e-2. Kernel P (the split SSD probe's core): ``ssd_core_ref`` at a
bf16 zx against the probe's ``_core_kernel`` at bf16 in interpret mode within
5e-4 mean-relative, and the port's probe at bf16, its split form against
kernel E's whole form at E bf16's bars (5e-3 mean-relative, 2e-2 *
max(1, max |ref|)). Mean-relative: mean |a - b| / mean |b|. Then the
embedder CLI's ``--wandb``, both packages' wandb shims against a ``wandb``
whose ``init`` raises, and ``make_mesh``'s default device.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models.mamba import Mamba as JaxMamba
from diffma_tpu.ops import fused_mamba as jax_inner
from diffma_tpu.ops.scan_orders import ScanSpec as JaxScanSpec
from diffma_tpu.ops.scan_orders import build_scan_spec as jax_spec
from diffma_tpu.utils import logging as jax_logging
from diffma_tpu_torch.models.mamba import Mamba
from diffma_tpu_torch.ops import fused_mamba
from diffma_tpu_torch.ops.fused_ssd import ssd_core_ref
from diffma_tpu_torch.ops.scan_orders import ScanSpec, build_scan_spec
from diffma_tpu_torch.parallel import mesh as mesh_mod
from diffma_tpu_torch.train import train_embedder
from diffma_tpu_torch.utils import logging as torch_logging
from diffma_tpu_torch.utils.convert import _mamba1
from test_torch_fused_mamba import INNER, _doubled_atrous, _inner_weights, _torch_inner
from test_torch_fused_mixer import _x
from test_torch_model import HIDDEN, randomize
from test_torch_probe_split_ssd import _load, core_inputs, jax_core

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's small operators on one intra-op thread: under the suite's
    parallel workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mean_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _bf16_xz(seed, G, L, d):
    """xz of bf16 values, as float32 numpy (JAX's side) and bf16 torch."""
    xz = np.random.default_rng(seed).standard_normal((G, L, 2 * d)).astype(np.float32)
    xz = torch.from_numpy(xz).to(BF16)
    return xz.float().numpy(), xz


@pytest.mark.parametrize("L", [37, 16])
def test_inner_bf16_value_matches_jax_kernel(L):
    """37 steps make the JAX kernel pad to 48; the port pads nothing."""
    w = _inner_weights(L, d=64, r=4, n=16)
    xz_np, xz = _bf16_xz(L, 2, L, 64)
    want = jax.jit(jax_inner.mamba_inner_fused)(jnp.asarray(xz_np, jnp.bfloat16),
                                                *(w[k] for k in INNER))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    before = fused_mamba.mamba_inner_fused_cuda.bf16.launches
    got = fused_mamba.mamba_inner_fused(xz, *_torch_inner(w))
    assert fused_mamba.mamba_inner_fused_cuda.bf16.launches == before  # CPU: the plain version
    assert got.dtype == BF16 and got.shape == (2, L, 64)
    got = got.float().numpy()
    assert _mean_rel(got, want) <= 1e-4
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


def test_inner_bf16_gradients_match_jax_vjp():
    """Every input's gradient: JAX's custom VJP recomputes through
    ``_fused_ref`` (conv out bf16, x_proj in bf16, delta fp32, the scan in
    bf16); the port's ``MambaInnerFn`` through ``mamba_inner_ref``."""
    w = _inner_weights(4, d=64, r=4, n=16)
    xz_np, xz = _bf16_xz(5, 2, 16, 64)
    g = np.random.default_rng(6).standard_normal((2, 16, 64)).astype(np.float32)

    def loss(xz, *ws):
        return jnp.sum(jax_inner.mamba_inner_fused(xz, *ws).astype(jnp.float32) * g)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(jnp.asarray(xz_np, jnp.bfloat16),
                                                             *(w[k] for k in INNER))
    leaves = [xz.requires_grad_()] + [t.requires_grad_() for t in _torch_inner(w)]
    out = fused_mamba.mamba_inner_fused(*leaves)
    assert out.grad_fn is not None and out.dtype == BF16
    (out.float() * torch.from_numpy(g)).sum().backward()
    for name, leaf, ref in zip(("xz", *INNER), leaves, want):
        ref = np.asarray(ref.astype(jnp.float32))
        ref = ref.T if name in ("xp_w", "dt_w") else ref
        assert leaf.grad.dtype == leaf.dtype, name
        assert _mean_rel(leaf.grad.float().numpy(), ref) <= 2e-2, name


def test_bf16_mamba_on_a_spec_kernel_c_cannot_take_matches_jax():
    """``Mamba(dtype=bfloat16, scan_impl="fused")`` on the doubled-atrous
    spec of grid 4: JAX runs ``mamba_inner_fused`` on bf16 xz (kernel H in
    interpret mode); the port ``mixer_composable(fused_inner=True)`` on CPU
    tensors, forward and backward."""
    spec_j = _doubled_atrous(4, JaxScanSpec, jax_spec("eff", 4, 0))
    spec_t = _doubled_atrous(4, ScanSpec, build_scan_spec("eff", 4, 0))
    x = _x(16, 7, h=HIDDEN)
    jm = JaxMamba(d_model=HIDDEN, scan_impl="fused", dtype=jnp.bfloat16)
    params = jax.jit(lambda k, x: jm.init(k, x, spec_j))(jax.random.PRNGKey(0), jnp.asarray(x))
    params = randomize(params["params"], 8)
    want = jax.jit(lambda p, x: jm.apply(p, x, spec_j))({"params": params}, x)
    assert want.dtype == jnp.bfloat16
    sd = {}
    _mamba1(sd, "m", params)
    m = Mamba(HIDDEN, spec_t, scan_impl="fused", dtype=BF16)
    m.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = m(xt)
    assert got.dtype == BF16
    assert _mean_rel(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32))) <= 1e-2
    got.float().sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in m.parameters())


@pytest.fixture(scope="module")
def probes():
    return _load("probe_split_ssd"), _load("probe_split_ssd_torch")


def test_ssd_core_ref_bf16_matches_jax_core_kernel(probes):
    """``ssd_core_ref`` on a bf16 zx against ``_core_kernel`` at bf16 (its
    head products on bf16-rounded operands, the rest fp32)."""
    jp, tp = probes
    w, zx = core_inputs(jp)
    zx = torch.from_numpy(zx).to(BF16)
    want = jax_core(jp, w, zx.float().numpy(), jnp.bfloat16)
    got = ssd_core_ref(zx, tp.mixer_weights(tuple(map(torch.from_numpy, w))))
    assert got.dtype == BF16 and got.shape == want.shape
    assert _mean_rel(got.float().numpy(), want) <= 5e-4


def test_probe_twin_at_bf16_on_cpu(probes):
    """The port's probe's bf16 comparison on its batch-1 inputs: the split
    form (P's plain version) against whole kernel E's bf16 plain version."""
    _, tp = probes
    out = tp._compare("bfloat16", *tp.inputs(1, 0, torch.device("cpu"), BF16))
    assert np.isfinite(out["max_abs_ref"]) and out["max_abs_ref"] > 0.1
    assert out["rel"] <= 5e-3
    assert out["max_abs_diff"] <= 2e-2 * max(1.0, out["max_abs_ref"])


def test_embedder_cli_accepts_wandb(monkeypatch):
    """``--wandb`` reaches the embedder's config, as in the JAX CLI
    (``diffma_tpu/train/train_embedder.py:156``); no step runs."""
    seen = {}
    monkeypatch.setattr(train_embedder, "main", lambda cfg, device: seen.update(cfg=cfg))
    train_embedder.cli(["--config", "configs/brain.yaml", "--wandb", "--device", "cpu"])
    assert seen["cfg"].get("wandb") is True
    train_embedder.cli(["--config", "configs/brain.yaml", "--device", "cpu"])
    assert not seen["cfg"].get("wandb")


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def test_wandb_shims_survive_a_failing_init(monkeypatch, capsys):
    """A ``wandb`` whose ``init`` raises: both packages' shims turn off and
    log nothing to it; the port's logs one line saying why, to its logger
    or, without one, to stdout."""
    def init(**kw):
        raise RuntimeError("no network")

    stub = types.ModuleType("wandb")
    stub.init = init
    monkeypatch.setitem(sys.modules, "wandb", stub)
    shims = [jax_logging.WandbShim(True, "p")]
    logger = _Lines()
    shims.append(torch_logging.WandbShim(True, "p", logger))
    for shim in shims:
        shim.log({"loss": 1.0}, step=1)
        shim.finish()
        assert shim._w is None
    assert logger.lines == ["wandb is off: RuntimeError: no network"]
    torch_logging.WandbShim(True, "p")
    assert capsys.readouterr().out.strip() == "wandb is off: RuntimeError: no network"
    torch_logging.WandbShim(False, "p", logger)
    assert len(logger.lines) == 1


def test_make_mesh_defaults_to_the_card(monkeypatch):
    """``make_mesh`` puts a one-rank mesh on ``cuda`` unless told otherwise,
    as ``init_distributed`` and the entry points default."""
    monkeypatch.setattr(mesh_mod, "world_size", lambda: 1)
    monkeypatch.setattr(mesh_mod, "world_rank", lambda: 0)
    assert mesh_mod.make_mesh().device == torch.device("cuda")
    assert mesh_mod.make_mesh(device="cpu").device == torch.device("cpu")
