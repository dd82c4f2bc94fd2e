"""The port's conditioning stack and ``.npy`` data against the JAX package's,
on the CPU.

The same numpy inputs go through both packages; the JAX parameter trees are
carried across with ``diffma_tpu_torch/utils/convert.py`` or written to the
files the port's loaders read. Bars: forward rtol = atol = 2e-4 (the JAX
package's, ``tests/test_reference_model_parity.py``); the bilinear resize
2e-4 against PIL (``tests/test_native_loader.py``); the nearest resize, the
datasets' masks and MRIs and the loaders' batch order exactly.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffma_tpu.data import npy_dataset as jax_data
from diffma_tpu.models.clip_vit import VisionTransformer as JaxViT
from diffma_tpu.models.clip_vit import biomedclip_vit_b16 as jax_biomedclip
from diffma_tpu.models.ct_encoder import CTEncoder as JaxCTEncoder
from diffma_tpu.models.ct_encoder import VisionEmbedding as JaxVisionEmbedding
from diffma_tpu.models.vae import AutoencoderKL as JaxVAE
from diffma_tpu.train.train import Conditioning as JaxConditioning
from diffma_tpu.utils import torch_io as jax_torch_io
from diffma_tpu.utils.config import Config as JaxConfig
from diffma_tpu.utils.logging import create_logger as jax_create_logger
from diffma_tpu_torch.data import npy_dataset as data
from diffma_tpu_torch.models.clip_vit import VisionTransformer, biomedclip_vit_b16
from diffma_tpu_torch.models.ct_encoder import CTEncoder, VisionEmbedding
from diffma_tpu_torch.models.vae import AutoencoderKL
from diffma_tpu_torch.train.train import Conditioning, _renorm_to_unit
from diffma_tpu_torch.utils import convert, torch_io
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.logging import create_logger

TOL = 2e-4


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Resize, transforms, the dataset and the loader's order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("shape", [(256, 256), (180, 200), (224, 224), (300, 173)])
def test_resize_gives_pils_results(shape, nearest):
    x = rand(sum(shape), *shape)
    got = data._resize(x, (224, 224), nearest)
    want = jax_data._resize(x, (224, 224), nearest)
    assert got.shape == want.shape == (224, 224) and got.dtype == np.float32
    if nearest:
        np.testing.assert_array_equal(got, want)
    else:
        close(got, want)


@pytest.mark.parametrize("transform", ["transform_train", "transform_test"])
def test_transforms_match_jax(transform):
    ct, mask, mri = rand(1, 256, 256), np.sign(rand(2, 256, 256)), rand(3, 180, 200)
    got = getattr(data, transform)(ct, mask, mri)
    want = getattr(jax_data, transform)(ct, mask, mri)
    close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_npy_dataset_items_match_jax(tmp_path):
    folders = data.write_triplet_folders(str(tmp_path), 3, size=64, mri_outside=1)
    args = [folders[f"{k}_image_folder_train"] for k in ("ct", "mask", "mir")]
    ours = data.NpyDataset(*args, transform=data.transform_train)
    ref = jax_data.NpyDataset(*args, transform=jax_data.transform_train)
    assert ours.images == ref.images == [f"slice_{i:04d}.npy" for i in range(3)]
    for i in range(3):
        (ct, mask, mri), (rct, rmask, rmri) = ours[i], ref[i]
        close(ct, rct)
        np.testing.assert_array_equal(mask, rmask)
        np.testing.assert_array_equal(mri, rmri)
        assert set(np.unique(mask)) <= {0.0, 1.0}
    assert np.abs(ours[0][2]).max() > 1 >= np.abs(ours[1][2]).max()  # the renorm's case
    raw = data.NpyDataset(*args)[1]  # no transform: the mask remapped all the same
    assert raw[0].shape == (64, 64) and set(np.unique(raw[1])) <= {0.0, 1.0}


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((1, 2, 2), i, np.float32), np.zeros((1, 2, 2), np.float32),
                np.ones((1, 2, 2), np.float32))


@pytest.mark.parametrize("kw", [
    dict(seed=0, epoch=0, shuffle=True, drop_last=True, process_index=0, process_count=1),
    dict(seed=3, epoch=2, shuffle=True, drop_last=False, process_index=0, process_count=1),
    dict(seed=1, epoch=1, shuffle=False, drop_last=False, process_index=0, process_count=1),
    dict(seed=5, epoch=4, shuffle=True, drop_last=True, process_index=1, process_count=2),
    dict(seed=7, epoch=0, shuffle=False, drop_last=False, process_index=2, process_count=3),
])
def test_loader_order_matches_jax(kw):
    got = list(data.make_loader(_Indexed(11), 3, **kw))
    want = list(jax_data.make_loader(_Indexed(11), 3, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The modules, carried across from JAX trees
# ---------------------------------------------------------------------------


def _jit_init(module, *args):
    """``module.init`` compiled: Flax's eager init of the VAE takes seconds."""
    return jax.jit(module.init)(*args)


@pytest.fixture(scope="module")
def stack_files(tmp_path_factory):
    """Random JAX trees of the whole stack at image_size 64 for DiffMa-S/2 (at
    32 the CT encoder's token MLP would be 0 wide, which JAX's init refuses),
    written as the ``.npy`` files that both packages' ``*_ckpt`` keys read."""
    tmp = tmp_path_factory.mktemp("stack")
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    img, lat = jnp.zeros((1, 3, 64, 64)), jnp.zeros((1, 4, 8, 8))
    trees = {"vae": _jit_init(JaxVAE(), k[0], k[1], img),
             "clip": _jit_init(jax_biomedclip(), k[2], img),
             "ct": _jit_init(JaxCTEncoder(img_size=8, patch_size=2, in_channels=4,
                                          embed_dim=512), k[3], lat)}
    files = {}
    for name, variables in trees.items():
        files[f"{name}_ckpt"] = str(tmp / f"{name}.npy")
        np.save(files[f"{name}_ckpt"], jax.tree.map(np.asarray, variables), allow_pickle=True)
    return files


@pytest.fixture(scope="module")
def jax_cond(stack_files):
    """JAX's whole stack, reading ``stack_files``."""
    cfg = JaxConfig(image_size=64, model="DiffMa-S/2", **stack_files)
    return JaxConditioning(cfg, jax_create_logger(None), jax.random.PRNGKey(0))


def _port_vae(params, **kw):
    vae = AutoencoderKL(**kw, with_encoder=True)
    vae.load_state_dict(convert.vae_params_from_jax(params, kw.get("ch_mult", (1, 2, 4, 4))))
    return vae.eval()


def _vae_case(jvae, variables, vae, x, seed):
    """Moments, and ``encode_sample`` with JAX's draw handed over."""
    dist = jvae.apply(variables, jnp.asarray(x), method=JaxVAE.encode)
    with torch.no_grad():
        ours = vae.encode(torch.from_numpy(x))
    close(ours.mean, nchw(dist.mean))
    close(ours.logvar, nchw(dist.logvar))
    key = jax.random.PRNGKey(seed)
    want = jvae.apply(variables, key, jnp.asarray(x), method=JaxVAE.encode_sample)
    noise = nchw(jax.random.normal(key, dist.mean.shape))
    with torch.no_grad():
        got = vae.encode_sample(torch.from_numpy(x), noise=torch.from_numpy(noise))
    close(got, want)


def test_vae_encoder_narrow_matches_jax():
    jvae = JaxVAE(ch=32, ch_mult=(1, 2))
    x = rand(0, 2, 3, 16, 16)
    variables = _jit_init(jvae, jax.random.PRNGKey(0), jax.random.PRNGKey(1), jnp.asarray(x))
    vae = _port_vae(variables["params"], ch=32, ch_mult=(1, 2))
    _vae_case(jvae, variables, vae, x, seed=2)
    # the logvar clip: two logvar channels moved far out of [-30, 20]
    variables = jax.tree.map(lambda a: a, variables)
    variables["params"]["quant_conv"]["bias"] = jnp.array([0, 0, 0, 0, 40, -45, 0, 0], jnp.float32)
    vae = _port_vae(variables["params"], ch=32, ch_mult=(1, 2))
    with torch.no_grad():
        logvar = vae.encode(torch.from_numpy(x)).logvar
    assert logvar.min() == -30.0 and logvar.max() == 20.0
    _vae_case(jvae, variables, vae, x, seed=4)


def test_vae_encoder_full_width_matches_jax(jax_cond):
    vae = _port_vae(jax_cond.vae_vars["params"])
    _vae_case(jax_cond.vae, jax_cond.vae_vars, vae, rand(5, 2, 3, 32, 32), seed=6)
    z = rand(7, 2, 4, 4, 4)
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z))
    close(got, jax_cond.vae.apply(jax_cond.vae_vars, jnp.asarray(z), method=JaxVAE.decode))


@pytest.mark.parametrize("size,patch,dim", [(28, 2, 512), (8, 2, 32)])
def test_ct_encoder_matches_jax(size, patch, dim):
    jm = JaxCTEncoder(img_size=size, patch_size=patch, in_channels=4, embed_dim=dim)
    x = rand(size, 2, 4, size, size)
    variables = _jit_init(jm, jax.random.PRNGKey(size), jnp.asarray(x))
    # a mask token and biases that are not zero, so that the mapping shows
    params = jax.tree.map(lambda a: a + 0.1 * rand(a.size, *a.shape), variables["params"])
    m = CTEncoder(img_size=size, patch_size=patch, in_channels=4, embed_dim=dim)
    m.load_state_dict(convert.ct_encoder_params_from_jax(params))
    w_want, y_want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        w_got, y_got = m(torch.from_numpy(x))
    assert w_got.shape == (2, (size // patch) ** 2, 1) and y_got.shape == (2, w_got.shape[1], dim)
    close(w_got, w_want)
    close(y_got, y_want)


def test_vision_embedding_masked_position_matches_jax():
    jm = JaxVisionEmbedding(img_size=8, patch_size=2, in_chans=3, embed_dim=16,
                            contain_mask_token=True, prepend_cls_token=True)
    x = rand(1, 2, 3, 8, 8)
    masked = (np.random.default_rng(2).random((2, 16)) > 0.5).astype(np.float32)
    variables = _jit_init(jm, jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + rand(a.size, *a.shape), variables["params"])
    m = VisionEmbedding(img_size=8, patch_size=2, in_chans=3, embed_dim=16,
                        contain_mask_token=True, prepend_cls_token=True)
    sd = {}
    convert._patch_conv(sd, "proj", params["kernel"], params["bias"], channels=3)
    sd.update(mask_token=torch.from_numpy(np.asarray(params["mask_token"])),
              cls_token=torch.from_numpy(np.asarray(params["cls_token"])))
    m.load_state_dict(sd)
    want = jm.apply({"params": params}, jnp.asarray(x), masked_position=jnp.asarray(masked))
    with torch.no_grad():
        got = m(torch.from_numpy(x), masked_position=torch.from_numpy(masked)).numpy()
    assert got.shape == (2, 17, 16)
    close(got, want)
    tokens = got[:, 1:][masked > 0]
    np.testing.assert_array_equal(tokens, np.broadcast_to(sd["mask_token"][0], tokens.shape))


def test_clip_narrow_matches_jax():
    jm = JaxViT(img_size=32, patch_size=8, width=64, depth=2, heads=4, output_dim=16)
    x = rand(3, 2, 3, 32, 32)
    variables = _jit_init(jm, jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.05 * rand(a.size, *a.shape), variables["params"])
    m = VisionTransformer(img_size=32, patch_size=8, width=64, depth=2, heads=4, output_dim=16)
    m.load_state_dict(convert.clip_params_from_jax(params))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    close(got, jm.apply({"params": params}, jnp.asarray(x)))


def test_biomedclip_full_width_matches_jax(jax_cond):
    m = biomedclip_vit_b16(img_size=64)
    m.load_state_dict(convert.clip_params_from_jax(jax_cond.clip_vars["params"]))
    x = rand(8, 2, 3, 64, 64)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    assert got.shape == (2, 512)
    close(got, jax_biomedclip().apply(jax_cond.clip_vars, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# The key names, held against the JAX package's own importers
# ---------------------------------------------------------------------------


def _unimportable_args():
    """An object of a class whose module is gone when the file is read, as
    upstream's OmegaConf ``args`` is where omegaconf is not installed."""
    mod = types.ModuleType("_gone_omegaconf")

    class DictConfig:
        def __init__(self):
            self.content = {"model": "DiffMa-L/2"}

    DictConfig.__module__, DictConfig.__qualname__ = mod.__name__, "DictConfig"
    mod.DictConfig = DictConfig
    sys.modules[mod.__name__] = mod
    return DictConfig()


def _save_without_module(obj, path):
    torch.save(obj, path)
    del sys.modules["_gone_omegaconf"]


def test_vae_keys_read_by_jax(tmp_path):
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2), with_encoder=True)
    vae.init_weights(torch.Generator().manual_seed(0))
    legacy = {}
    for key, value in vae.state_dict().items():
        if ".attentions.0.to_" in key:  # legacy names, 1x1-conv weights
            key = (key.replace(".to_q.", ".query.").replace(".to_k.", ".key.")
                   .replace(".to_v.", ".value.").replace(".to_out.0.", ".proj_attn."))
            if key.endswith("weight"):
                value = value[:, :, None, None]
        legacy[f"module.{key}"] = value
    path = str(tmp_path / "vae.bin")
    _save_without_module({"state_dict": legacy, "args": _unimportable_args()}, path)
    variables = jax.tree.map(jnp.asarray, jax_torch_io.vae_params_from_torch(
        jax_torch_io.load_torch_checkpoint(path)["state_dict"], ch_mult=(1, 2)))
    x = rand(1, 2, 3, 16, 16)
    dist = JaxVAE(ch=32, ch_mult=(1, 2)).apply(variables, jnp.asarray(x), method=JaxVAE.encode)
    with torch.no_grad():
        ours = vae.eval().encode(torch.from_numpy(x))
    close(ours.mean, nchw(dist.mean))
    close(ours.logvar, nchw(dist.logvar))
    back = torch_io.load_weights("vae", path)
    assert back.keys() == vae.state_dict().keys()
    for key, value in vae.state_dict().items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)


def test_ct_encoder_keys_read_by_jax(tmp_path):
    m = CTEncoder(img_size=8, patch_size=2, in_channels=4, embed_dim=32)
    m.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():
        m.vision_embedding.mask_token.normal_()
    sd = m.state_dict()
    path = str(tmp_path / "ct.pt")
    _save_without_module({"model": {k: 0 * v for k, v in sd.items()}, "ema": sd, "opt": {},
                          "args": _unimportable_args()}, path)
    ckpt = jax_torch_io.load_torch_checkpoint(path)
    variables = jax.tree.map(jnp.asarray, jax_torch_io.ct_encoder_params_from_torch(ckpt["ema"]))
    x = rand(2, 2, 4, 8, 8)
    w_want, y_want = JaxCTEncoder(img_size=8, patch_size=2, in_channels=4,
                                  embed_dim=32).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        w_got, y_got = m(torch.from_numpy(x))
    close(w_got, w_want)
    close(y_got, y_want)
    for kind, want in (("ema", sd), ("model", {k: 0 * v for k, v in sd.items()})):
        back = torch_io.load_weights("ct", path, kind)
        assert back.keys() == want.keys()
        assert all(torch.equal(back[k], want[k]) for k in want)


@pytest.mark.parametrize("layout", ["open_clip", "trunk"])
def test_clip_keys_read_by_jax(tmp_path, layout):
    m = VisionTransformer(img_size=32, patch_size=8, width=64, depth=2, heads=4, output_dim=16)
    m.init_weights(torch.Generator().manual_seed(2))
    sd = m.state_dict()
    if layout == "open_clip":
        out = {f"visual.trunk.{k}": v for k, v in sd.items() if k != "head.weight"}
        out.update({"visual.head.proj.weight": sd["head.weight"], "logit_scale": torch.ones(()),
                    "text.proj.weight": torch.ones(2, 2)})
    else:
        out = {k.replace("head.", "head.proj."): v for k, v in sd.items()}
    path = str(tmp_path / "clip.pt")
    torch.save(out, path)
    variables = jax.tree.map(jnp.asarray, jax_torch_io.clip_vision_params_from_torch(
        jax_torch_io.load_torch_checkpoint(path), depth=2))
    x = rand(3, 2, 3, 32, 32)
    want = JaxViT(img_size=32, patch_size=8, width=64, depth=2, heads=4,
                  output_dim=16).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    close(got, want)
    back = torch_io.load_weights("clip", path)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


# ---------------------------------------------------------------------------
# The whole stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mri_scale", [0.9, 1.7])  # inside [-1, 1], and out of it
def test_conditioning_matches_jax(tmp_path, stack_files, jax_cond, mri_scale):
    cfg = Config(image_size=64, model="DiffMa-S/2", **stack_files)
    ours = Conditioning(cfg, create_logger(str(tmp_path)), "cpu")
    assert not any(p.requires_grad for m in (ours.vae, ours.clip, ours.ct)
                   for p in m.parameters())
    x = np.tanh(rand(10, 2, 1, 64, 64)).repeat(3, axis=1)
    z = (mri_scale * np.tanh(rand(11, 2, 1, 64, 64))).repeat(3, axis=1)
    rng = jax.random.PRNGKey(12)
    want = jax_cond(rng, x, z)
    k1, k2 = jax.random.split(rng)  # the split inside JAX's encode
    noise = tuple(torch.from_numpy(nchw(jax.random.normal(k, (2, 8, 8, 4)))) for k in (k1, k2))
    got = ours(torch.from_numpy(x), torch.from_numpy(z), noise=noise)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "z": (2, 4, 8, 8), "y": (2, 512), "y2": (2, 16, 512), "w": (2, 16, 1)}
    for key in ("z", "y", "y2", "w"):
        close(got[key], want[key])
    # the same again from the loader's one-channel arrays
    gen = torch.Generator().manual_seed(4)
    again = ours.encode_triplets(x[:, :1], z[:, :1], gen)
    direct = ours(torch.from_numpy(x), torch.from_numpy(z), torch.Generator().manual_seed(4))
    for key in ("z", "y", "y2", "w"):
        torch.testing.assert_close(again[key], direct[key], rtol=0, atol=0)


def test_renorm_to_unit_matches_jax():
    from diffma_tpu.train.train import _renorm_to_unit as jax_renorm

    for scale in (0.5, 1.0, 3.0):
        z = np.clip(scale * rand(int(scale * 10), 2, 3, 8, 8), -scale, scale)
        close(_renorm_to_unit(torch.from_numpy(z)), jax_renorm(jnp.asarray(z)), tol=1e-6)
    inside = np.tanh(rand(1, 2, 3, 8, 8))
    np.testing.assert_array_equal(_renorm_to_unit(torch.from_numpy(inside)), inside)


def test_conditioning_without_files_is_random_and_says_so(tmp_path, capsys):
    cfg = Config(image_size=16, model="DiffMa-S/2", ct_ckpt=str(tmp_path / "missing.pt"))
    cond = Conditioning(cfg, create_logger(str(tmp_path)), "cpu", seed=1)
    log = capsys.readouterr().out
    assert log.count("using random frozen init") == 3 and "missing.pt" in log
    assert all(float(m.weight.std()) > 0 for m in (
        cond.vae.encoder.conv_in, cond.clip.blocks[0].attn.qkv, cond.ct.vision_embedding.proj))
    assert os.path.exists(tmp_path / "log_0.txt")
