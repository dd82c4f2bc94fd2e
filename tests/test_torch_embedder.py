"""The port's embedder pretraining, its real-data trainer and sampler, and its
checkpoint readers, on the CPU.

``info_nce_loss_b`` is held against the JAX package's, value and gradient
(rtol = atol = 2e-4 on the gradient, 1e-5 on the value); the embedder's
checkpoint must be read by both packages and give equal CT-encoder outputs
(2e-4, the forward bar). The trainer and the sampler run on ``.npy`` folders
that the tests write, with the CT encoder from the embedder's checkpoint.
"""

import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.models.ct_encoder import CTEncoder as JaxCTEncoder
from diffma_tpu.train.train_embedder import info_nce_loss_b as jax_info_nce
from diffma_tpu.utils import torch_io as jax_torch_io
from diffma_tpu_torch.data.npy_dataset import write_triplet_folders
from diffma_tpu_torch.models.ct_encoder import CTEncoder
from diffma_tpu_torch.models.vae import AutoencoderKL
from diffma_tpu_torch.train import sample, train, train_embedder
from diffma_tpu_torch.train.checkpoints import find_model, load_diffma_checkpoint
from diffma_tpu_torch.utils import torch_io
from diffma_tpu_torch.utils.config import Config

TOL = 2e-4


@pytest.mark.parametrize("shape", [(4, 6, 8), (8, 16, 32), (3, 196, 2)])
def test_info_nce_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want, want_grad = jax.value_and_grad(jax_info_nce)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    got = train_embedder.info_nce_loss_b(t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=TOL, atol=TOL)
    same = torch.from_numpy(np.repeat(x[:1], shape[0], axis=0))  # no pair told apart
    np.testing.assert_allclose(float(train_embedder.info_nce_loss_b(same)), np.log(shape[0]),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Train and val ``.npy`` folders, 256 x 256 slices; the MRI of two train
    slices leaves [-1, 1]."""
    root = str(tmp_path_factory.mktemp("data"))
    out = write_triplet_folders(root, 6, "train", mri_outside=2)
    out.update(write_triplet_folders(root, 3, "test", seed=1))
    return out


def _embedder_cfg(tmp_path, folders, **kw):
    cfg = Config(image_size=32, embedder_results_dir=str(tmp_path / "emb"), embedder_epoch=3,
                 embedder_global_batch_size=4, embedder_global_seed=0, embedder_patch_size=2,
                 embedder_embed_dim=512, embedder_ckpt_every=2, max_steps=2, log_every=1,
                 **folders)
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def embedder_ckpt(tmp_path_factory, folders):
    """The embedder's CLI on the train folders: 2 steps, a checkpoint at 2."""
    tmp = tmp_path_factory.mktemp("embedder")
    cfg_path = tmp / "embedder.yaml"
    cfg_path.write_text("".join(f"{k}: {v}\n" for k, v in _embedder_cfg(tmp, folders).items()
                                if k not in ("embedder_results_dir", "embedder_ckpt_every")))
    state = train_embedder.cli(["--config", str(cfg_path), "--max-steps", "2",
                                "--ckpt-every", "2", "--results-dir", str(tmp / "emb"),
                                "--device", "cpu"])
    path = tmp / "emb" / "000-vision_encoder" / "checkpoints" / "0000002.pt"
    assert path.exists() and state.step == 2
    return str(path), state


def test_embedder_checkpoint_is_read_by_both_packages(embedder_ckpt):
    path, state = embedder_ckpt
    ckpt = jax_torch_io.load_torch_checkpoint(path)
    assert set(ckpt) == {"model", "ema", "opt", "args"} and ckpt["args"]["image_size"] == 32
    assert set(ckpt["ema"]) == {"vision_embedding.proj.weight", "vision_embedding.proj.bias",
                                "vision_embedding.mask_token", "fc.0.weight", "fc.0.bias",
                                "fc.2.weight", "fc.2.bias", "norm.weight", "norm.bias"}
    ours = CTEncoder(img_size=4, patch_size=2, in_channels=4, embed_dim=512)
    ours.load_state_dict(torch_io.load_weights("ct", path))
    for key, value in state.ema.state_dict().items():
        assert torch.equal(ours.state_dict()[key], value)
    x = np.random.default_rng(0).standard_normal((3, 4, 4, 4)).astype(np.float32)
    with torch.no_grad():
        w, y2 = ours(torch.from_numpy(x))
    # JAX's CTEncoder refuses a 0-wide token MLP (4 tokens): hold its
    # importer's tree against the checkpoint's tensors instead.
    tree = jax_torch_io.ct_encoder_params_from_torch(ckpt["ema"])["params"]
    np.testing.assert_array_equal(tree["fc2"]["bias"], ours.fc[2].bias.detach().numpy())
    assert w.shape == (3, 4, 1) and y2.shape == (3, 4, 512) and torch.isfinite(y2).all()


def test_embedder_trains_at_width_and_jax_reads_it(tmp_path, folders):
    """At image_size 64 (16 tokens) the embedder's EMA goes through JAX's
    importer and forward."""
    cfg = _embedder_cfg(tmp_path, folders, image_size=64, embedder_global_batch_size=3)
    state = train_embedder.main(cfg, device="cpu")
    path = tmp_path / "emb" / "000-vision_encoder" / "checkpoints" / "0000002.pt"
    ckpt = jax_torch_io.load_torch_checkpoint(str(path))
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, torch.from_numpy(np.asarray(ckpt["ema"][k])))]
    assert moved  # the EMA trails the model
    variables = jax.tree.map(jnp.asarray, jax_torch_io.ct_encoder_params_from_torch(ckpt["ema"]))
    x = np.random.default_rng(1).standard_normal((2, 4, 8, 8)).astype(np.float32)
    w_want, y_want = JaxCTEncoder(img_size=8, patch_size=2, in_channels=4,
                                  embed_dim=512).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        w_got, y_got = state.ema(torch.from_numpy(x))
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), rtol=TOL, atol=TOL)
    log = (tmp_path / "emb" / "000-vision_encoder" / "log_0.txt").read_text()
    assert "Dataset contains 6." in log and "(step=0000002) Train Loss" in log


def _watch_conditioning(monkeypatch):
    """Record every ``Conditioning`` made, its encodes, and the VAE that
    decodes."""
    seen = {"cond": [], "encodes": 0, "decoders": []}
    init, call, decode = (train.Conditioning.__init__, train.Conditioning.__call__,
                          AutoencoderKL.decode)

    def watched_init(self, *a, **kw):
        init(self, *a, **kw)
        seen["cond"].append(self)

    def watched_call(self, *a, **kw):
        seen["encodes"] += 1
        return call(self, *a, **kw)

    def watched_decode(self, z):
        seen["decoders"].append(self)
        return decode(self, z)

    monkeypatch.setattr(train.Conditioning, "__init__", watched_init)
    monkeypatch.setattr(train.Conditioning, "__call__", watched_call)
    monkeypatch.setattr(AutoencoderKL, "decode", watched_decode)
    return seen


def _train_cfg(tmp_path, folders, ct_ckpt, **kw):
    cfg = Config(model="DiffMa-S/2", image_size=32, global_batch_size=2, global_seed=0,
                 epochs=2, lr=1e-4, log_every=1, ckpt_every=2, max_steps=2,
                 results_dir=str(tmp_path / "results"), ct_ckpt=ct_ckpt, **folders)
    cfg.update(kw)
    return cfg


def test_trainer_and_sampler_on_npy_folders(tmp_path, folders, embedder_ckpt, monkeypatch):
    ct_path, embedder = embedder_ckpt
    seen = _watch_conditioning(monkeypatch)
    state = train.main(_train_cfg(tmp_path, folders, ct_path), device="cpu")
    assert state.step == 2 and seen["encodes"] == 2
    (cond,) = seen["cond"]
    for key, value in embedder.ema.state_dict().items():  # ct_ckpt's "ema"
        assert torch.equal(cond.ct.state_dict()[key], value)
    (exp,) = os.listdir(tmp_path / "results")
    log = (tmp_path / "results" / exp / "log_0.txt").read_text()
    assert "Dataset contains 6." in log and "ct-encoder: importing weights" in log
    encode_ms = [float(m) for m in re.findall(r"Encode ms/step: ([0-9.]+)", log)]
    assert len(encode_ms) == 2 and min(encode_ms) > 0

    ckpt = tmp_path / "results" / exp / "checkpoints" / "0000002.pt"
    out = tmp_path / "samples"
    results = sample.main(Config(model="DiffMa-S/2", image_size=32, sample_num_steps=3,
                                 sample_global_batch_size=2, seed=0, save_dir=str(out),
                                 ckpt=str(ckpt), ct_ckpt=ct_path, **folders), device="cpu")
    assert [r["images"].shape for r in results] == [(2, 3, 32, 32), (1, 3, 32, 32)]
    assert all(np.isfinite(r["images"]).all() for r in results)
    assert sorted(os.listdir(out)) == sorted(f"{i}_sample_{k}.png" for i in (1, 2)
                                             for k in ("ct", "gen", "ori"))
    sampler_cond = seen["cond"][1]
    assert seen["encodes"] == 4 and len(seen["decoders"]) == 2
    assert all(vae is sampler_cond.vae for vae in seen["decoders"])  # the stack's VAE decodes
    assert all(set(r["quality"]) == {"psnr_db", "ssim"} for r in results)


def test_trainer_cli_on_npy_folders_takes_mamba2(tmp_path, folders, embedder_ckpt):
    cfg_path = tmp_path / "train.yaml"
    cfg = _train_cfg(tmp_path, folders, embedder_ckpt[0], use_mamba2=True)
    cfg_path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items() if k != "use_mamba2"))
    state = train.cli(["--config", str(cfg_path), "--use-mamba2", "--max-steps", "1",
                       "--device", "cpu"])
    assert state.step == 1 and state.model.blocks[0].use_mamba2


def test_real_data_needs_the_stacks_width(tmp_path, folders):
    cfg = _train_cfg(tmp_path, folders, None, hidden_size=64)
    with pytest.raises(ValueError, match="hidden_size 512"):
        train.main(cfg, device="cpu")
    with pytest.raises(ValueError, match="hidden_size 512"):
        sample.main(Config(model="DiffMa-S/2", image_size=32, hidden_size=64,
                           save_dir=str(tmp_path), **folders), device="cpu")


def _ckpt_with_unimportable_args(path, sd):
    """A reference checkpoint whose ``args`` is an object of a class whose
    module is gone when the file is read (upstream's OmegaConf config where
    omegaconf is not installed)."""
    mod = types.ModuleType("_gone_config_module")

    class DictConfig:
        def __init__(self):
            self.content = {"model": "DiffMa-S/2", "seed": 0}

    DictConfig.__module__, DictConfig.__qualname__ = mod.__name__, "DictConfig"
    mod.DictConfig = DictConfig
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"model": sd, "ema": sd, "opt": {"step": torch.tensor(3.0)},
                    "args": DictConfig()}, path)
    finally:
        del sys.modules[mod.__name__]
    return str(path)


def test_find_model_reads_unimportable_args(tmp_path):
    model = train.build_model("DiffMa-S/2", input_size=4, hidden_size=32)
    model.init_weights(torch.Generator().manual_seed(0))
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    path = _ckpt_with_unimportable_args(tmp_path / "ref.pt", sd)
    with pytest.raises(Exception):  # what torch reads safely refuses it
        torch.load(path, weights_only=True)
    ema = find_model(path, "ema")
    assert ema.keys() == sd.keys() and all(torch.equal(ema[k], sd[k]) for k in sd)
    other = train.build_model("DiffMa-S/2", input_size=4, hidden_size=32)
    load_diffma_checkpoint(other, path)
    assert all(torch.equal(a, b) for a, b in zip(other.parameters(), model.parameters()))
    ours, ref = torch_io.load_torch_checkpoint(path), jax_torch_io.load_torch_checkpoint(path)
    assert ours["args"].__dict__["_state"] == ref["args"]._state == {
        "content": {"model": "DiffMa-S/2", "seed": 0}}
    assert float(ours["opt"]["step"]) == float(ref["opt"]["step"]) == 3.0
    for k in sd:
        np.testing.assert_array_equal(ours["ema"][k].numpy(), ref["ema"][k])


def test_unpickler_calls_nothing_a_file_names(tmp_path):
    class Boom:
        def __reduce__(self):
            return (os.remove, (str(tmp_path / "victim"),))

    (tmp_path / "victim").write_text("x")
    path = str(tmp_path / "evil.pt")
    torch.save({"ema": {}, "args": Boom()}, path)
    ckpt = torch_io.load_torch_checkpoint(path)
    assert (tmp_path / "victim").exists() and "stub" in repr(ckpt["args"])


def test_ct_ckpt_loader_reads_unimportable_args(tmp_path):
    m = CTEncoder(img_size=8, patch_size=2, in_channels=4, embed_dim=32)
    m.init_weights(torch.Generator().manual_seed(5))
    path = _ckpt_with_unimportable_args(tmp_path / "ct.pt", m.state_dict())
    back = torch_io.load_weights("ct", path)
    assert all(torch.equal(back[k], v) for k, v in m.state_dict().items())
    ref = jax_torch_io.load_torch_checkpoint(path)
    want = jax_torch_io.ct_encoder_params_from_torch(ref["ema"])
    np.testing.assert_array_equal(want["params"]["norm_scale"], back["norm.weight"].numpy())
