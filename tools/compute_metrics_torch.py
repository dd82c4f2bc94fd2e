"""Offline SSIM/PSNR between generated and ground-truth images, for the port.

The twin of ``tools/compute_metrics.py`` on ``diffma_tpu_torch/utils/metrics.py``
(the functions the port's sampler reports per batch), with the same pairing
modes, flags and report:

* one directory (the sampler's ``save_dir``): pairs
  ``<item>_sample_gen.png`` with ``<item>_sample_ori.png``, the files
  ``diffma_tpu_torch/train/sample.py`` writes;
* two directories: pairs files by identical basename (``.png`` or ``.npy``).

It needs neither JAX nor PIL, which a GPU machine need not have: PNGs are
read with zlib, for 8-bit gray, RGB and RGBA images, not interlaced, with row
filters 0-4 (what ``train/sample.py::_png_bytes`` and PIL write). Gray is
spread to three channels and alpha dropped, as PIL's ``convert("RGB")``
does. Any other PNG raises, naming what it has.

Usage:
    python tools/compute_metrics_torch.py result_sample/smoke
    python tools/compute_metrics_torch.py GEN_DIR REF_DIR --data-range 255
    python tools/compute_metrics_torch.py GEN_DIR REF_DIR --json out.json
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffma_tpu_torch.utils.metrics import psnr, ssim  # noqa: E402

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel: gray, RGB, RGBA


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The image's bytes, (height, stride) uint8, from the filtered rows."""
    out = np.zeros((height + 1, stride), np.uint8)  # row 0: the zero row above the first
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, not {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    for y in range(height):
        kind, line, prior = rows[y, 0], rows[y, 1:], out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # Sub: a running sum per channel
            out[y + 1] = (line.reshape(-1, bpp).astype(np.int64).cumsum(0) % 256).reshape(-1)
        elif kind == 2:  # Up
            out[y + 1] = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte waits for its left neighbour
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
                else:
                    upleft = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(left, up[x], upleft)) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not 0-4")
    return out[1:]


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG as (H, W, 3) uint8, as PIL's
    ``Image.open(path).convert("RGB")`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"{path}: PNG of bit depth {depth} and colour type {colour}; "
                         "only 8-bit gray (0), RGB (2) and RGBA (6) are read")
    if compression or filtering or interlace:
        raise ValueError(f"{path}: PNG with compression {compression}, filter method "
                         f"{filtering}, interlace {interlace}; only 0, 0, 0 are read")
    channels = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    img = pixels.reshape(height, width, channels)
    return np.repeat(img, 3, axis=2) if channels == 1 else img[..., :3]


def _load(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float64)
    img = read_png(path).astype(np.float64)
    return np.moveaxis(img, -1, 0)  # (H, W, 3) -> (3, H, W) for the metrics


def _pairs_one_dir(d: str):
    for name in sorted(os.listdir(d)):
        if name.endswith("_sample_gen.png"):
            ref = os.path.join(d, name.replace("_sample_gen", "_sample_ori"))
            if os.path.exists(ref):
                yield name[: -len("_sample_gen.png")], os.path.join(d, name), ref


def _pairs_two_dirs(gen: str, ref: str):
    refs = set(os.listdir(ref))
    for name in sorted(os.listdir(gen)):
        if name in refs and name.endswith((".png", ".npy")):
            yield os.path.splitext(name)[0], os.path.join(gen, name), os.path.join(ref, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gen_dir", help="sampling save_dir, or a directory of images")
    ap.add_argument(
        "ref_dir", nargs="?", default=None,
        help="ground-truth directory (omit to pair *_sample_gen/_ori in gen_dir)",
    )
    ap.add_argument(
        "--data-range", type=float, default=None,
        help="dynamic range (default: 255 for PNG, 2.0 for npy in [-1, 1])",
    )
    ap.add_argument("--json", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    pairs = list(_pairs_two_dirs(args.gen_dir, args.ref_dir) if args.ref_dir
                 else _pairs_one_dir(args.gen_dir))
    if not pairs:
        print("no image pairs found", file=sys.stderr)
        return 1

    rows = []
    for item, gpath, rpath in pairs:
        a, b = _load(gpath), _load(rpath)
        if a.shape != b.shape:
            print(f"skip {item}: shape {a.shape} vs {b.shape}", file=sys.stderr)
            continue
        rng = args.data_range or (255.0 if gpath.endswith(".png") else 2.0)
        rows.append({"item": item, "psnr_db": round(psnr(a, b, rng), 4),
                     "ssim": round(ssim(a, b, rng), 6)})
        print(f"{item:40s}  PSNR {rows[-1]['psnr_db']:8.3f} dB   "
              f"SSIM {rows[-1]['ssim']:.4f}")

    if not rows:
        print("no comparable pairs", file=sys.stderr)
        return 1
    report = {
        "n": len(rows),
        "psnr_db_mean": round(float(np.mean([r["psnr_db"] for r in rows])), 4),
        "ssim_mean": round(float(np.mean([r["ssim"] for r in rows])), 6),
        "items": rows,
    }
    print(f"\nmean over {report['n']} pairs:  PSNR {report['psnr_db_mean']:.3f} dB"
          f"   SSIM {report['ssim_mean']:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
