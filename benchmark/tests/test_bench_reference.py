"""The plain reference against the port's plain path at toy size on the CPU,
and the import rules: nothing the benchmark runs loads JAX or the JAX
package, and the reference loads nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import weights  # noqa: E402
from benchmark.reference import inputs  # noqa: E402
from benchmark.reference.diffusion import Diffusion  # noqa: E402
from benchmark.reference.model import Denoiser  # noqa: E402
from benchmark.reference.products import Products, round_tf32  # noqa: E402
from benchmark.reference.scan_orders import spiral_spec  # noqa: E402
from benchmark.reference.vae import decode  # noqa: E402

TOY = dict(model="DiffMa-S/2", hidden_size=64, depth=4, latent_size=8, patch_size=2,
           in_channels=4, d_state=16, headdim=64)


def _port_model(mixer, seed):
    from diffma_tpu_torch.models.diffma import build_model

    model = build_model(TOY["model"], input_size=TOY["latent_size"], d_state=16,
                        scan_impl="fused", use_mamba2=mixer == "mamba2",
                        hidden_size=TOY["hidden_size"])
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    w = weights.make(shapes, weights.denoiser_rule, seed, "denoiser", "cpu")
    model.load_state_dict(w)
    return model, w


@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
def test_denoiser_matches_the_port_forward_and_gradients(mixer):
    model, w = _port_model(mixer, 11)
    gen = torch.Generator().manual_seed(5)
    b = inputs.synthetic_batch(gen, 2, 8, 16, 64)
    t = torch.tensor([3, 900])
    want = model(b["z"], t, b["y"], b["y2"], b["w"])
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref = Denoiser(dict(TOY, mixer=mixer), leaves, Products())
    got = ref(b["z"], t, b["y"], b["y2"], b["w"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g = torch.randn(got.shape, generator=gen)
    ref_grads = torch.autograd.grad(got, list(leaves.values()), g)
    port_grads = torch.autograd.grad(want, list(model.parameters()), g)
    for name, a, b_ in zip(leaves, ref_grads, port_grads):  # the SSD chunked in the port
        assert (a - b_).abs().max() <= 1e-4 * b_.abs().max(), name


def test_vae_decode_matches_the_port():
    from diffma_tpu_torch.models.vae import AutoencoderKL

    vae = AutoencoderKL(ch=32, ch_mult=(1, 1, 1, 1))
    shapes = {k: tuple(p.shape) for k, p in vae.named_parameters()}
    w = weights.make(shapes, weights.vae_rule, 3, "vae", "cpu")
    vae.load_state_dict(w)
    z = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(decode(w, z, Products()), vae.decode(z), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("respacing", ["250", ""])
def test_diffusion_tables_match_the_port(respacing):
    from diffma_tpu_torch.diffusion import create_diffusion

    port = create_diffusion(respacing, device="cpu")
    ref = Diffusion(int(respacing or 1000), 1000)
    pairs = [("sqrt_acp", "sqrt_alphas_cumprod"), ("coef1", "posterior_mean_coef1"),
             ("coef2", "posterior_mean_coef2"), ("log_betas", "log_betas"),
             ("post_logvar", "posterior_log_variance_clipped"),
             ("sqrt_recipm1_acp", "sqrt_recipm1_alphas_cumprod")]
    for mine, theirs in pairs:
        assert torch.equal(getattr(ref, mine), getattr(port, theirs)), mine
    if port.timestep_map is not None:
        assert torch.equal(ref.timestep_map, port.timestep_map)


@pytest.mark.parametrize("grid_n,layer", [(14, 0), (14, 5), (4, 3)])
def test_scan_orders_match_the_port(grid_n, layer):
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    spec = build_scan_spec("spiral", grid_n, layer)
    fwd, merge = spiral_spec(grid_n, layer)
    assert np.array_equal(fwd, spec.fwd) and np.array_equal(merge, spec.merge)


def test_input_draws_match_the_port():
    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.train.train import loss_draws, synthetic_batch

    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    port = synthetic_batch(a, 2, 8, 16, dim=64)
    t, noise = loss_draws(create_diffusion("", device="cpu"), port["z"], a)
    ref = inputs.synthetic_batch(b, 2, 8, 16, 64)
    t2, noise2 = inputs.loss_draws(b, ref["z"], 1000)
    for k in port:
        assert torch.equal(port[k], ref[k])
    assert torch.equal(t, t2) and torch.equal(noise, noise2)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


def _imports_in(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port_or_jax():
    files = glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py"))
    assert files
    for path in files:
        found = _imports_in(path) & {"jax", "jaxlib", "flax", "diffma_tpu", "diffma_tpu_torch"}
        assert not found, (path, found)
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.train, benchmark.reference.vae, "
            "benchmark.reference.inputs;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         check=True).stdout
    for name in ("diffma_tpu_torch", "diffma_tpu", "jax"):
        assert f"'{name}'" not in out


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    files = sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"), recursive=True))
    for path in files:
        found = _imports_in(path) & {"jax", "jaxlib", "flax", "diffma_tpu"}
        assert not found, (path, found)
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.run, benchmark.control, benchmark.drivers.train_synthetic,"
            " benchmark.drivers.sample_chain, benchmark.harness.program;"
            "import diffma_tpu_torch.train.train, diffma_tpu_torch.train.sample,"
            " diffma_tpu_torch.utils.graphs;"
            "from benchmark.harness.cell import load_benchmark, load_reader;"
            "[load_reader(m['name']) for m in load_benchmark()['per_layer']];"
            "from benchmark.harness.card import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
