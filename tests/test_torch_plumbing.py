"""The port's data and tool plumbing against the JAX package's, on the CPU.

``data/split.py``, the native loader's binding (``data/native.py``, built
from ``native/npy_loader.cpp`` into ``diffma_tpu_torch/_build/``), the
loader's ``load_batch`` fast path, the trainer's choice of loader,
``utils/profiling.py::model_flops`` and the two offline tools
(``tools/compute_metrics_torch.py``, ``tools/compute_gflops_torch.py``).
Bars: the split, the loaders' batches and their order, ``model_flops`` and
the FLOP tool's fields exactly; the metrics tool's report within 1e-9.
"""

import importlib.util
import json
import logging
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from diffma_tpu.data import native as jax_native
from diffma_tpu.data import npy_dataset as jax_data
from diffma_tpu.data.split import split_dataset as jax_split_dataset
from diffma_tpu.train import train as _jax_train  # noqa: F401  (the JAX FLOP tool's import)
from diffma_tpu.utils.profiling import model_flops as jax_model_flops
from diffma_tpu_torch.data import native
from diffma_tpu_torch.data.npy_dataset import NpyDataset, make_loader, write_triplet_folders
from diffma_tpu_torch.data.split import split_dataset
from diffma_tpu_torch.train import train
from diffma_tpu_torch.train.sample import _png_bytes
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.profiling import model_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Five 256 x 256 train triplets and three val triplets, as
    ``write_triplet_folders`` lays them out."""
    root = str(tmp_path_factory.mktemp("triplets"))
    out = write_triplet_folders(root, 5, "train", mri_outside=1)
    out.update(write_triplet_folders(root, 3, "test", seed=1))
    return out


def _train_folders(folders):
    return [folders[f"{k}_image_folder_train"] for k in ("ct", "mask", "mir")]


# --- split ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11])
def test_split_dataset_moves_the_same_files_as_jax(tmp_path, seed):
    src = tmp_path / "jax"
    for name in ("A", "B", "C"):
        (src / name).mkdir(parents=True)
        for i in range(13):
            (src / name / f"slice_{i:03d}.npy").write_bytes(f"{name}{i}".encode())
    shutil.copytree(src, tmp_path / "port")
    listings = {}
    for which, fn in (("jax", jax_split_dataset), ("port", split_dataset)):
        r = tmp_path / which
        fn(*(str(r / n) for n in "ABC"),
           *(str(r / f"{n}_{s}") for n in "ABC" for s in ("train", "test")), seed=seed)
        listings[which] = {d: sorted(os.listdir(r / d)) for d in sorted(os.listdir(r))}
        for d in ("A_train", "B_train", "C_train"):
            for f in listings[which][d]:  # the triplet moved together
                assert (r / d / f).read_bytes() == f"{d[0]}{int(f[6:9])}".encode()
    assert listings["port"] == listings["jax"]
    assert len(listings["port"]["A_train"]) == 10 and not listings["port"]["A"]


# --- the native loader ------------------------------------------------------


@pytest.mark.parametrize("size", [32, 256])
def test_native_loader_matches_jax_in_bits(folders, size):
    ours = native.NativeTripletLoader(*_train_folders(folders), size=size)
    ref = jax_native.NativeTripletLoader(*_train_folders(folders), size=size)
    assert len(ours) == len(ref) == 5
    idx = [4, 0, 2]
    for a, b in zip(ours.load_batch(idx), ref.load_batch(idx)):
        assert a.shape == (3, 1, size, size) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert os.path.dirname(native.build()) == native.BUILD_DIR  # not into native/


def test_native_loader_raises_on_a_missing_file(tmp_path, folders):
    dirs = [shutil.copytree(f, tmp_path / os.path.basename(f)) for f in _train_folders(folders)]
    os.remove(dirs[1] / "slice_0002.npy")
    loader = native.NativeTripletLoader(*map(str, dirs), size=32)
    loader.load_batch([0, 1])
    with pytest.raises(IOError, match="1/2 files"):
        loader.load_batch([1, 2])


@pytest.mark.parametrize("drop_last", [True, False])
def test_make_loader_takes_load_batch_in_jax_order(folders, drop_last):
    ours = native.NativeTripletLoader(*_train_folders(folders), size=32)
    ref = jax_native.NativeTripletLoader(*_train_folders(folders), size=32)
    kw = dict(seed=3, epoch=1, drop_last=drop_last)
    got = list(make_loader(ours, 2, **kw))
    want = list(jax_data.make_loader(ref, 2, **kw))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_make_loader_hands_over_a_load_batch_error():
    class Failing:
        calls = 0

        def __len__(self):
            return 6

        def load_batch(self, idx):
            Failing.calls += 1
            if Failing.calls == 2:
                raise IOError("native loader failed on 1/2 files")
            return tuple(np.zeros((len(idx), 1, 4, 4), np.float32) for _ in range(3))

    it = make_loader(Failing(), 2, shuffle=False)
    assert next(it)[0].shape == (2, 1, 4, 4)
    with pytest.raises(IOError, match="1/2 files"):
        next(it)


def _logger(caplog):
    caplog.set_level(logging.INFO, logger="plumbing")
    return logging.getLogger("plumbing")


def test_make_dataset_takes_native_for_train_and_python_for_val(folders, caplog):
    cfg = Config(image_size=32, **folders)
    log = _logger(caplog)
    dataset = train.make_dataset(cfg, "train", 64, native=True, logger=log)
    assert isinstance(dataset, native.NativeTripletLoader) and dataset.size == 32
    assert caplog.messages == ["train data: native C++ triplet loader"]
    val = train.make_dataset(cfg, "val", 8, native=True, logger=log)
    assert isinstance(val, NpyDataset) and len(val) == 3
    assert isinstance(train.make_dataset(cfg, "train", 64), NpyDataset)  # the embedder's
    ct, mask, mri = dataset.load_batch([1])
    assert ct.shape == mask.shape == mri.shape == (1, 1, 32, 32)
    assert set(np.unique(mask)) == {0.0, 1.0}  # remapped to (m + 1) / 2


def test_make_dataset_falls_back_with_its_reason(folders, caplog, monkeypatch):
    def unavailable():
        raise RuntimeError("g++ not found: the native loader needs a C++ compiler")

    monkeypatch.setattr(native, "load_native_lib", unavailable)
    dataset = train.make_dataset(Config(image_size=32, **folders), "train", 64, native=True,
                                 logger=_logger(caplog))
    assert isinstance(dataset, NpyDataset)
    assert caplog.messages == ["train data: Python loader (the native loader is unavailable: "
                               "RuntimeError: g++ not found: the native loader needs a C++ "
                               "compiler)"]


# --- FLOPs and the tools ------------------------------------------------------


@pytest.mark.parametrize("depth", [8, 16, 28])  # B/2, L/2, XL/2
@pytest.mark.parametrize("tokens", [196, 256])
def test_model_flops_equal_jax(depth, tokens):
    for kw in ({}, {"streams": 1, "dual_branch": False}, {"d_state": 64, "hidden": 1024}):
        assert model_flops(depth, tokens=tokens, **kw) == jax_model_flops(depth, tokens=tokens,
                                                                          **kw)


@pytest.mark.parametrize("argv", [[], ["--model", "DiffMa-XXL/2", "--image-size", "256"],
                                  ["--model", "DiT-SB/2", "--use-mamba2", "--sample-steps", "50"]])
def test_compute_gflops_tool_matches_jax(argv, capsys):
    reports = []
    for name in ("compute_gflops", "compute_gflops_torch"):
        assert _tool(name).main(argv) == 0
        reports.append(json.loads(capsys.readouterr().out))
    assert reports[0] == reports[1]


def _png(img: np.ndarray, colour: int, filters) -> bytes:
    """A PNG of an (H, W, C) uint8 image, each row filtered with the given type."""
    h, w, c = img.shape
    raw = bytearray()
    prior = bytes(w * c)
    for y in range(h):
        line, kind = img[y].tobytes(), filters[y % len(filters)]
        out = bytearray([kind])
        for x in range(w * c):
            left = line[x - c] if x >= c else 0
            up, upleft = prior[x], (prior[x - c] if x >= c else 0)
            p = left + up - upleft
            paeth = min((abs(p - left), 0, left), (abs(p - up), 1, up),
                        (abs(p - upleft), 2, upleft))[2]
            pred = (0, left, up, (left + up) >> 1, paeth)[kind]
            out.append((line[x] - pred) & 0xFF)
        raw += out
        prior = line

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                                             0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour, channels", [(0, 1), (2, 3), (6, 4)])
def test_png_reader_matches_pil(tmp_path, colour, channels):
    rng = np.random.default_rng(colour)
    img = rng.integers(0, 256, (11, 9, channels), dtype=np.uint8)
    read_png = _tool("compute_metrics_torch").read_png
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        path = tmp_path / f"f{''.join(map(str, filters))}.png"
        path.write_bytes(_png(img, colour, filters))
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_png(str(path)), want, err_msg=str(filters))
    for header, what in (((9, 11, 16, 2, 0, 0, 0), "bit depth 16"),
                         ((9, 11, 8, 3, 0, 0, 0), "colour type 3"),
                         ((9, 11, 8, 2, 0, 0, 1), "interlace 1")):
        bad = bytearray(_png(img[..., :3] if channels >= 3 else img, 2 if channels >= 3 else 0,
                             [0]))
        ihdr = struct.pack(">IIBBBBB", *header)
        bad[16:29] = ihdr
        bad[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF)
        path = tmp_path / "bad.png"
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=what):
            read_png(str(path))


def test_compute_metrics_tool_matches_jax(tmp_path):
    """Both tools on the sampler's directory layout (PNGs from the port's
    writer) and on two directories of PIL-written PNGs (gray, RGB, RGBA)
    and ``.npy`` files."""
    rng = np.random.default_rng(7)
    one = tmp_path / "samples"
    one.mkdir()
    for i in (1, 2):
        ori = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
        gen = np.clip(ori + rng.integers(-30, 30, ori.shape), 0, 255).astype(np.uint8)
        (one / f"{i}_sample_ori.png").write_bytes(_png_bytes(ori))
        (one / f"{i}_sample_gen.png").write_bytes(_png_bytes(gen))
        (one / f"{i}_sample_ct.png").write_bytes(_png_bytes(ori))
    gen_dir, ref_dir = tmp_path / "gen", tmp_path / "ref"
    gen_dir.mkdir()
    ref_dir.mkdir()
    for mode, shape in (("L", (18, 16)), ("RGB", (18, 16, 3)), ("RGBA", (18, 16, 4))):
        ref = rng.integers(0, 256, shape, dtype=np.uint8)
        gen = np.clip(ref + rng.integers(-20, 20, shape), 0, 255).astype(np.uint8)
        Image.fromarray(ref, mode).save(ref_dir / f"{mode}.png")
        Image.fromarray(gen, mode).save(gen_dir / f"{mode}.png")
    ref = rng.uniform(-1, 1, (1, 16, 16)).astype(np.float32)
    np.save(ref_dir / "slice.npy", ref)
    np.save(gen_dir / "slice.npy", ref + 0.05 * rng.standard_normal(ref.shape))
    for args in ([str(one)], [str(gen_dir), str(ref_dir)],
                 [str(gen_dir), str(ref_dir), "--data-range", "100"]):
        reports = []
        for name in ("compute_metrics", "compute_metrics_torch"):
            out = tmp_path / f"{name}.json"
            assert _tool(name).main(args + ["--json", str(out)]) == 0
            reports.append(json.loads(out.read_text()))
        ours, want = reports[1], reports[0]
        assert ours["n"] == want["n"] == (2 if len(args) == 1 else 4)
        assert [r["item"] for r in ours["items"]] == [r["item"] for r in want["items"]]
        for a, b in zip([ours] + ours["items"], [want] + want["items"]):
            for key in ("psnr_db", "ssim", "psnr_db_mean", "ssim_mean"):
                if key in b:
                    assert abs(a[key] - b[key]) <= 1e-9, (key, a, b)
