"""The port's sampling pipeline, config reader and import rules, on the CPU."""

import ast
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffma_tpu.data.npy_dataset import SyntheticTriplets as JaxSyntheticTriplets
from diffma_tpu.diffusion import create_diffusion as jax_create_diffusion
from diffma_tpu.utils import metrics as jax_metrics
from diffma_tpu_torch.data.npy_dataset import SyntheticTriplets
from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.models.diffma import build_model
from diffma_tpu_torch.train import sample
from diffma_tpu_torch.utils import metrics
from diffma_tpu_torch.utils.config import Config, load_config, parse_flat_yaml
from diffma_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


def _tiny_cfg(tmp_path, **kw):
    cfg = Config(
        model="DiffMa-S/2", image_size=32, sample_num_steps=3,
        sample_global_batch_size=2, sample_num_batches=2, synthetic_data=True,
        synthetic_dataset_size=3, save_dir=str(tmp_path), seed=0,
    )
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("use_ddim", [False, True])
def test_sample_main_on_cpu(tmp_path, use_ddim):
    results = sample.main(_tiny_cfg(tmp_path, use_ddim=use_ddim), device="cpu")
    assert [r["images"].shape for r in results] == [(2, 3, 32, 32), (1, 3, 32, 32)]
    for r in results:
        assert np.isfinite(r["images"]).all()
        assert set(r["quality"]) == {"psnr_db", "ssim"}
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"{i}_sample_{k}.png" for i in (1, 2) for k in ("gen", "ori", "ct"))
    again = sample.main(_tiny_cfg(tmp_path, use_ddim=use_ddim), device="cpu")
    np.testing.assert_array_equal(again[0]["images"], results[0]["images"])  # seeded


def test_sample_cli_parses_flags(tmp_path):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(
        "model: DiffMa-B/2\nimage_size: 32\nsample_num_steps: 2\nsynthetic_data: true\n"
        "sample_num_batches: 1\nsynthetic_dataset_size: 1\n"
        f"save_dir: \"{tmp_path / 'out'}\"\n"
    )
    results = sample.cli(["--config", str(cfg_path), "--model", "DiffMa-S/2", "--device", "cpu"])
    assert results[0]["images"].shape == (1, 3, 32, 32)
    mamba2 = sample.cli(["--config", str(cfg_path), "--model", "DiffMa-S/2", "--use-mamba2",
                         "--device", "cpu"])
    assert mamba2[0]["images"].shape == (1, 3, 32, 32) and np.isfinite(mamba2[0]["images"]).all()
    # bf16 samples (tests/test_torch_bf16.py), on the Mamba-2 mixers too: the
    # dual route through load_model, and fuse_block through sample_batches
    cfg = _tiny_cfg(tmp_path, autocast=True, use_mamba2=True, sample_num_batches=1,
                    hidden_size=32, scan_impl="fused")
    bf16 = sample.main(cfg, device="cpu")
    assert bf16[0]["images"].shape == (2, 3, 32, 32) and np.isfinite(bf16[0]["images"]).all()
    model = build_model("DiffMa-S/2", input_size=4, hidden_size=32, use_mamba2=True,
                        fuse_block=True, scan_impl="fused", dtype=torch.bfloat16)
    whole = sample.sample_batches(model.init_weights(torch.Generator().manual_seed(0)).eval(),
                                  cfg, "cpu")
    assert whole[0]["images"].shape == (2, 3, 32, 32) and np.isfinite(whole[0]["images"]).all()


def test_load_model_builds_mamba2(tmp_path):
    from diffma_tpu_torch.models.mamba2 import Mamba2

    model = sample.load_model(_tiny_cfg(tmp_path, use_mamba2=True, scan_impl="fused",
                                        hidden_size=64), device="cpu")
    assert all(isinstance(b.mamba1, Mamba2) and not b.fuse_block and b.scan_impl == "fused"
               for b in model.blocks)
    # the conditioning is drawn at the model's width, not at 512
    results = sample.main(_tiny_cfg(tmp_path, use_mamba2=True, scan_impl="fused", hidden_size=64,
                                    sample_num_batches=1), device="cpu")
    assert results[0]["images"].shape == (2, 3, 32, 32) and np.isfinite(results[0]["images"]).all()
    plain = sample.load_model(_tiny_cfg(tmp_path), device="cpu")
    assert not any(isinstance(m, Mamba2) for m in plain.modules())
    assert plain.blocks[0].scan_impl == "auto"


@pytest.mark.parametrize("hidden_size", [64, 32])
def test_sampler_draws_conditioning_at_the_models_width(tmp_path, hidden_size):
    """``hidden_size`` in the config: ``sample.main`` runs (it once drew y and
    y2 512 wide whatever the model's width), and a checkpoint that the trainer
    wrote with a ``hidden_size`` is sampled back."""
    from diffma_tpu_torch.train import train

    results = sample.main(_tiny_cfg(tmp_path, hidden_size=hidden_size, sample_num_batches=1),
                          device="cpu")
    assert results[0]["images"].shape == (2, 3, 32, 32) and np.isfinite(results[0]["images"]).all()
    state = train.main(Config(
        epochs=1, log_every=1, ckpt_every=2, lr=1e-3, results_dir=str(tmp_path / "results"),
        model="DiffMa-S/2", image_size=32, global_batch_size=2, global_seed=0,
        hidden_size=hidden_size, synthetic_data=True, synthetic_dataset_size=4, max_steps=2,
    ), device="cpu")
    (exp,) = (tmp_path / "results").iterdir()
    cfg = _tiny_cfg(tmp_path, hidden_size=hidden_size, sample_num_batches=1,
                    ckpt=str(exp / "checkpoints" / "0000002.pt"))
    loaded = sample.load_model(cfg, device="cpu")
    assert loaded.hidden_size == hidden_size
    for k, v in state.ema.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    sampled = sample.main(cfg, device="cpu")
    assert sampled[0]["images"].shape == (2, 3, 32, 32) and np.isfinite(sampled[0]["images"]).all()


@pytest.mark.parametrize("fuse_block", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_mamba2_sampling_chain_matches_jax(fuse_block):
    """A 3-step ``--use-mamba2`` DDPM chain: the JAX sampler's loop around the
    JAX model (fused SSD kernels in interpret mode) against the port's loop
    around the port's model with the same weights, start and per-step noise
    (JAX's: split once, then fold in the step index). Bar: latent MAE < 1e-3,
    the sampling parity bar of ``tests/test_torch_diffusion.py``."""
    from test_torch_model import _inputs, build_pair

    steps = 3
    jmodel, params, model = build_pair(seed=5, scan_impl="fused", use_mamba2=True,
                                       fuse_block=fuse_block)
    x, _, y, y2, w = _inputs(2)
    jdiff, diff = jax_create_diffusion(str(steps)), create_diffusion(str(steps), device="cpu")
    key = jax.random.PRNGKey(11)

    @jax.jit
    def jax_chain(z, y, y2, w):
        def model_fn(xx, tt, **kw):
            return jmodel.apply({"params": params}, xx, tt, **kw)

        return jdiff.p_sample_loop(model_fn, z.shape, key, noise=z, clip_denoised=False,
                                   model_kwargs={"y": y, "y2": y2, "w": w})

    want = np.asarray(jax_chain(*map(jnp.asarray, (x, y, y2, w))))
    step_key, _ = jax.random.split(key)
    step_noise = [
        torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(step_key, i), x.shape)))
        for i in range(steps)
    ]
    kw = {k: torch.from_numpy(v) for k, v in (("y", y), ("y2", y2), ("w", w))}
    got = diff.p_sample_loop(model, x.shape, noise=torch.from_numpy(x), clip_denoised=False,
                             model_kwargs=kw, step_noise=step_noise).numpy()
    assert np.isfinite(got).all() and np.abs(got - x).max() > 0.1  # the chain moved
    assert np.abs(got - want).mean() < 1e-3
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_sample_cli_ckpt_and_scan_impl_flags(tmp_path):
    """``--ckpt`` loads perturbed weights (so that the mixers matter), and the
    fused path's images match the composable path's on the CPU."""
    from diffma_tpu_torch.models.diffma import build_model

    model = build_model("DiffMa-S/2", input_size=4).init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"ema": {f"module.{k}": v for k, v in model.state_dict().items()}}, ckpt)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(
        "model: DiffMa-S/2\nimage_size: 32\nsample_num_steps: 3\nsynthetic_data: true\n"
        f"save_dir: \"{tmp_path / 'out'}\"\n"
    )
    images = {}
    for impl in ("fused", "ref"):
        results = sample.cli(["--config", str(cfg_path), "--ckpt", str(ckpt), "--scan-impl", impl,
                              "--num-batches", "1", "--device", "cpu"])
        assert len(results) == 1
        images[impl] = results[0]["images"]
    np.testing.assert_allclose(images["fused"], images["ref"], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown scan_impl"):
        sample.cli(["--config", str(cfg_path), "--scan-impl", "xla", "--device", "cpu"])


def test_entry_points_do_not_fall_back_to_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(_tiny_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_diffusion("10")
    assert resolve_device("cpu").type == "cpu"


def test_png_grid_is_a_valid_png(tmp_path):
    from PIL import Image

    imgs = np.random.default_rng(0).uniform(-1, 1, (5, 3, 9, 7)).astype(np.float32)
    path = tmp_path / "g.png"
    sample.save_image_grid(imgs, str(path), nrow=4)
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    assert arr.shape == (2 * (9 + 2) + 2, 4 * (7 + 2) + 2, 3)
    want = (np.clip((imgs[0] + 1) / 2, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    np.testing.assert_array_equal(arr[2:11, 2:9], want)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_pyyaml(path):
    assert dict(load_config(str(path))) == yaml.safe_load(path.read_text())


def test_yaml_reader_scalars_match_pyyaml():
    text = "\n".join([
        "a: 1e-4", "b: 1.0e-4", "c: 50_000", "d: null", "e: ~", "f: true", "g: off",
        "h: 'it''s'", 'i: "x # y"', "j: x # comment", "k: -3", "l: .5", "m: 0x1f",
        "n: 010", "o:", "p: .inf", "q: -.inf", "r: 3.", "s: +7", "t: 1_0.5",
    ])
    assert parse_flat_yaml(text) == yaml.safe_load(text)
    for bad in ("a:\n  b: 1", "a: [1, 2]", "- 1", "a: 'open"):
        with pytest.raises(ValueError):
            parse_flat_yaml(bad)


def test_synthetic_triplets_and_metrics_match_jax():
    ours, ref = SyntheticTriplets(n=2, size=16), JaxSyntheticTriplets(n=2, size=16)
    for i in range(2):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-1, 1, (2, 3, 16, 16)), rng.uniform(-1, 1, (2, 3, 16, 16))
    assert metrics.quality_report(a, b) == jax_metrics.quality_report(a, b)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "diffma_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "diffma_tpu", "yaml", "PIL"), (
                f"{path.relative_to(ROOT)} imports {mod}"
            )
