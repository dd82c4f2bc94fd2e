"""The port's other five block families (ZigMa, ViM, VMamba, EMamba, DiT) against
the JAX package's, on the CPU, in fp32.

Every parameter is overwritten with seeded random values (adaLN and the final
layer start at zero and would hide the blocks), carried from the JAX tree to
the port through ``diffma_params_from_jax``. On the JAX side ``scan_impl=
"fused"`` runs the whole-mixer Pallas kernels in interpret mode; on the
port's side CPU tensors take the plain versions. Bars: the model-parity bars
of ``tests/test_torch_model.py`` (forward MAE < 1e-4, rtol = atol = 2e-4).
Their training is in ``tests/test_torch_zoo_train.py``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models.diffma import DiffMa_models as JAX_REGISTRY
from diffma_tpu.models.diffma import build_model as jax_build_model
from diffma_tpu.train.checkpoints import load_diffma_params
from diffma_tpu_torch.models.blocks import DiTBlock, _SingleMixerBlock
from diffma_tpu_torch.models.diffma import DiffMa, DiffMa_models, build_model
from diffma_tpu_torch.models.mamba2 import Mamba2
from diffma_tpu_torch.train import sample
from diffma_tpu_torch.train.checkpoints import load_diffma_checkpoint
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.convert import diffma_params_from_jax
from test_torch_model import randomize

HIDDEN = 32
INPUT = 8  # latent 8x8, patch 2 -> a 4x4 grid, 16 tokens


def _inputs(batch=2, seed=3, input_size=INPUT, patch=2):
    rng = np.random.default_rng(seed)
    tokens = (input_size // patch) ** 2
    x = rng.standard_normal((batch, 4, input_size, input_size)).astype(np.float32)
    t = np.array([37, 912][:batch], np.int32)
    y = rng.standard_normal((batch, HIDDEN)).astype(np.float32)
    y2 = rng.standard_normal((batch, tokens, HIDDEN)).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.standard_normal((batch, tokens, 1))))).astype(np.float32)
    return x, t, y, y2, w


def _pair(name, seed, scan_impl, use_mamba2=False):
    """The JAX registry model with random params, and the port's carrying them."""
    kw = dict(input_size=INPUT, hidden_size=HIDDEN, scan_impl=scan_impl, use_mamba2=use_mamba2)
    jmodel = jax_build_model(name, **kw)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), *map(jnp.asarray, _inputs(1)))
    params = randomize(params["params"], seed + 1)
    model = build_model(name, **kw)
    state = diffma_params_from_jax(params, depth=model.depth, use_mamba2=use_mamba2)
    model.load_state_dict(state, strict=True)
    return jmodel, params, model.eval()


def _check_forward(jmodel, params, model):
    x, t, y, y2, w = _inputs()
    want = np.asarray(
        jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, y, y2, w))))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t.astype(np.int64), y, y2, w))).numpy()
    assert got.shape == want.shape == (2, 8, INPUT, INPUT)
    mae = np.abs(got - want).mean()
    assert mae < 1e-4, f"forward MAE {mae}"
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("use_mamba2", [False, True], ids=["mamba1", "mamba2"])
@pytest.mark.parametrize("family", ["ZigMa", "ViM", "VMamba", "EMamba"])
def test_family_forward_matches_jax(family, use_mamba2):
    """Depth 4 on the fused route: the JAX side runs kernel C (with its vim
    quirk and its partition rows) or kernel E in interpret mode."""
    jmodel, params, model = _pair(f"{family}-S/2", seed=5, scan_impl="fused",
                                  use_mamba2=use_mamba2)
    assert all(isinstance(b, _SingleMixerBlock) for b in model.blocks)
    assert isinstance(model.blocks[0].mamba, Mamba2) == use_mamba2
    _check_forward(jmodel, params, model)


def test_dit_forward_matches_jax():
    jmodel, params, model = _pair("DiT-S/2", seed=6, scan_impl="auto")
    assert all(isinstance(b, DiTBlock) for b in model.blocks)
    assert not any("norm" in k for k in model.blocks[0].state_dict())  # no affine
    _check_forward(jmodel, params, model)


@pytest.mark.parametrize(
    "name",
    ["DiT-SB/2", "ZigMa-BL/2",
     pytest.param("ViM-BL/2", marks=pytest.mark.slow),
     pytest.param("VMamba-BL/2", marks=pytest.mark.slow),
     pytest.param("EMamba-BL/2", marks=pytest.mark.slow)],
)
def test_odd_depth_forward_matches_jax(name):
    """Depth 13 and depth 7: the U-skip's ``i > depth / 2`` is a true
    division, so at depth 13 layers 7-12 (not 6-12) add the mirrored output."""
    jmodel, params, model = _pair(name, seed=7, scan_impl="auto")
    assert model.depth == jmodel.depth == (7 if name.startswith("DiT") else 13)
    _check_forward(jmodel, params, model)


def test_uskip_layers_at_depth_13():
    """Which layers take a long skip, read off the port's forward: layer i's
    input differs from layer i-1's output exactly where i > 13 / 2."""
    model = build_model("ZigMa-BL/2", input_size=INPUT, hidden_size=HIDDEN)
    model.init_weights(torch.Generator().manual_seed(0))  # every block the identity
    seen = []
    for blk in model.blocks:
        blk.register_forward_pre_hook(lambda _m, args: seen.append(args[0]))
    x, t, y, y2, w = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        model(x, t.long(), y, y2, w)
    tokens = seen[0]
    # identity blocks: outputs[i] = input of layer i, so a skip doubles the norm
    ratios = [round((s.norm() / tokens.norm()).item()) for s in seen]
    assert ratios[:7] == [1] * 7 and ratios[7] == 2 and all(r > 1 for r in ratios[7:])


def _size_for(name):
    """An input size that gives a 4 x 4 token grid at the name's patch size."""
    return 4 * int(name.split("/")[1])


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_every_registry_name_builds_and_runs(name):
    """All 80 names, at hidden 32 on 16 tokens: the entry's depth, patch and
    block family are the JAX registry's, and one forward on the port's
    default CPU route gives finite values of the right shape."""
    size = _size_for(name)
    model = build_model(name, input_size=size, hidden_size=HIDDEN)
    jmodel = JAX_REGISTRY[name](input_size=size, hidden_size=HIDDEN)
    assert (model.depth, model.patch_size, model.block_type) == (
        jmodel.depth, jmodel.patch_size, jmodel.block_type)
    assert DiffMa_models[name] == (jmodel.depth, jmodel.patch_size, jmodel.block_type)
    gen = torch.Generator().manual_seed(1)
    model.init_weights(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
        x, t, y, y2, w = map(torch.from_numpy, _inputs(1, input_size=size, patch=model.patch_size))
        out = model.eval()(x, t.long(), y, y2, w)
    assert out.shape == (1, 8, size, size)
    assert torch.isfinite(out).all() and out.abs().max() > 0


def test_emamba_on_an_odd_grid_raises_as_jax_does():
    """``EMamba-*/4`` at a 28 x 28 latent (224 x 224 images) has a 7 x 7 grid,
    which the atrous streams cannot split: the same ``ValueError`` in both
    packages (the port raises when it builds the model, JAX when it traces)."""
    with pytest.raises(ValueError, match="even token grid"):
        build_model("EMamba-S/4", input_size=28, hidden_size=HIDDEN)
    jmodel = jax_build_model("EMamba-S/4", input_size=28, hidden_size=HIDDEN)
    args = _inputs(1, input_size=28, patch=4)
    with pytest.raises(ValueError, match="even token grid"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args))
    with pytest.raises(ValueError, match="unknown block_type"):
        DiffMa(block_type="swin")


@pytest.mark.parametrize("name,use_mamba2", [("ViM-S/2", False), ("EMamba-S/2", True),
                                             ("DiT-S/2", False)])
def test_checkpoint_round_trip_in_both_packages(tmp_path, name, use_mamba2):
    """A reference-layout checkpoint of a single-mixer model and of a DiT
    model, written from a JAX tree carried into the port: the JAX package's
    reader recovers the tree exactly (so the port keeps upstream's key
    names), and the port's loader and sampler read it back."""
    jmodel, params, model = _pair(name, seed=9, scan_impl="auto", use_mamba2=use_mamba2)
    sd = {f"module.{k}": v.clone() for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, -1, HIDDEN).clone()
    if name.startswith("DiT"):
        assert {"module.blocks.0.attn.qkv.bias", "module.blocks.3.mlp.fc2.weight"} <= set(sd)
    else:
        assert "module.blocks.2.mamba.in_proj.weight" in sd and "module.blocks.0.norm1.bias" in sd
    path = str(tmp_path / "ckpt.pt")
    torch.save({"model": sd, "ema": sd, "opt": {}, "args": argparse.Namespace(model=name)}, path)
    tree = load_diffma_params(path, jmodel, "ema")
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_got) == len(flat_want)
    for key, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]), np.asarray(want), err_msg=str(key))
    fresh = build_model(name, input_size=INPUT, hidden_size=HIDDEN, use_mamba2=use_mamba2)
    load_diffma_checkpoint(fresh, path)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    cfg = Config(model=name, image_size=8 * INPUT, hidden_size=HIDDEN, ckpt=path,
                 use_mamba2=use_mamba2, sample_num_steps=2, sample_global_batch_size=1,
                 sample_num_batches=1, synthetic_data=True, save_dir=str(tmp_path / "out"))
    results = sample.main(cfg, device="cpu")
    assert results[0]["images"].shape == (1, 3, 8 * INPUT, 8 * INPUT)
    assert np.isfinite(results[0]["images"]).all()


