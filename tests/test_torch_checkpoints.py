"""Reference checkpoints written and read by the port, on the CPU.

A checkpoint in upstream's format (``{"model", "ema", "opt", "args"}`` torch
pickle, ``module.``-prefixed keys, a ``pos_embed`` entry) is written from a
seeded JAX parameter tree carried into the port. The JAX package's own reader
must recover the tree exactly, which shows that the port keeps upstream's
layout; the port's reader must load it into a model that matches JAX.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.train.checkpoints import load_diffma_params
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.train import sample
from diffma_tpu_torch.train.checkpoints import find_model, load_diffma_checkpoint
from diffma_tpu_torch.utils.config import Config
from test_torch_model import HIDDEN, INPUT, _inputs, build_pair


def _reference_dict(model):
    """The port's weights as upstream's trainer saves them under DDP."""
    sd = {f"module.{k}": v.clone() for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, -1, model.pos_embed.shape[-1]).clone()
    return sd


def _save(path, ema, model=None):
    torch.save(
        {"model": model if model is not None else ema, "ema": ema, "opt": {},
         "args": argparse.Namespace(model="DiffMa-S/2")},
        path,
    )
    return str(path)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=3)


def test_jax_reader_recovers_the_tree(pair, tmp_path):
    jmodel, params, model = pair
    path = _save(tmp_path / "ckpt.pt", _reference_dict(model))
    tree = load_diffma_params(path, jmodel, "ema")
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_got) == len(flat_want)
    for key, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]), np.asarray(want), err_msg=str(key))


def test_port_reader_loads_and_matches_jax(pair, tmp_path):
    jmodel, params, model = pair
    path = _save(tmp_path / "ckpt.pt", _reference_dict(model))
    fresh = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN).eval()
    load_diffma_checkpoint(fresh, path)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    x, t, y, y2, w = _inputs()
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, *map(jnp.asarray, (x, t, y, y2, w))))
    with torch.no_grad():
        got = fresh(*map(torch.from_numpy, (x, t.astype(np.int64), y, y2, w))).numpy()
    assert np.abs(got - want).mean() < 1e-4
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_load_ckpt_type_picks_the_sub_dict(pair, tmp_path):
    _, _, model = pair
    ema = _reference_dict(model)
    raw = {k: v + 1.0 for k, v in ema.items()}
    path = _save(tmp_path / "ckpt.pt", ema, model=raw)
    assert torch.equal(find_model(path, "model")["module.final_layer.linear.bias"],
                       raw["module.final_layer.linear.bias"])
    assert torch.equal(find_model(path, "ema")["module.final_layer.linear.bias"],
                       ema["module.final_layer.linear.bias"])
    assert torch.equal(find_model(path, "absent")["module.final_layer.linear.bias"],
                       ema["module.final_layer.linear.bias"])  # falls to "ema"
    plain = tmp_path / "bare.pt"
    torch.save(ema, plain)
    assert find_model(str(plain)).keys() == ema.keys()


def test_missing_and_unexpected_keys_are_named(pair, tmp_path):
    _, _, model = pair
    sd = _reference_dict(model)
    del sd["module.blocks.2.mamba2.A_log"]
    sd["module.blocks.9.mamba1.D"] = torch.ones(3)
    path = _save(tmp_path / "ckpt.pt", sd)
    fresh = build_model("DiffMa-S/2", input_size=INPUT, hidden_size=HIDDEN)
    with pytest.raises(KeyError, match=r"blocks\.2\.mamba2\.A_log.*blocks\.9\.mamba1\.D"):
        load_diffma_checkpoint(fresh, path)


def test_orbax_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="Orbax"):
        find_model(str(tmp_path))


@pytest.mark.parametrize("scan_impl", ["auto", "fused"])
def test_sampler_loads_ckpt_on_cpu(tmp_path, scan_impl):
    model = build_model("DiffMa-S/2", input_size=4).init_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(6)))
    path = _save(tmp_path / "ckpt.pt", _reference_dict(model))
    cfg = Config(
        model="DiffMa-S/2", image_size=32, sample_num_steps=3, sample_global_batch_size=1,
        sample_num_batches=1, synthetic_data=True, save_dir=str(tmp_path / "out"), seed=0,
        ckpt=path, load_ckpt_type="ema", scan_impl=scan_impl,
    )
    loaded = sample.load_model(cfg, device="cpu")
    assert all(m.scan_impl == scan_impl for m in loaded.modules() if hasattr(m, "scan_impl"))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    results = sample.main(cfg, device="cpu")
    assert len(results) == 1 and results[0]["images"].shape == (1, 3, 32, 32)
    assert np.isfinite(results[0]["images"]).all()
