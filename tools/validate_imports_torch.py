#!/usr/bin/env python
"""Validate real pretrained-weight files against the PyTorch port's modules.

The port's counterpart of ``tools/validate_imports.py``. The reference loads
three frozen encoders and its own DiffMa checkpoints (the SD-VAE, the
BiomedCLIP image tower, the CT encoder, the model/EMA checkpoints); the port
reads each through ``diffma_tpu_torch/utils/torch_io.py::load_weights`` (a
DiffMa checkpoint through ``train/checkpoints.py::find_model``). Point this
tool at downloaded files and, for each, it prints a structural report (the
file's and the module's tensors and elements, the keys that are missing,
unexpected or of a wrong shape), loads the weights strictly, runs a forward
smoke on ``--device`` at the JAX tool's input shapes (finite values of the
right shapes, CLIP's 512-d projection) and, where the upstream implementation
is importable, compares the forward with it. It imports neither JAX nor PIL.

Usage (any subset of the four files):

    python tools/validate_imports_torch.py \\
        --vae  /path/to/sd-vae-ft-ema/diffusion_pytorch_model.bin \\
        --clip /path/to/biomedclip/open_clip_pytorch_model.bin \\
        --ct   /path/to/pretrain_ct_vision_embedder/brain_patch_size_2.pt \\
        --diffma /path/to/results/.../checkpoints/0400000.pt \\
        --diffma-model DiffMa-B/2 [--use-mamba2] [--device cpu]

Oracles, each optional (one line says when one is missing, and the tool
goes on): ``--vae`` diffusers' ``AutoencoderKL`` in SD's configuration,
latent and decode MAE < 1e-4; ``--clip`` open_clip's BiomedCLIP, embedding
MAE < 1e-4 (loaded from the local Hugging Face cache only: the tool sets
``HF_HUB_OFFLINE=1`` unless the environment sets it); ``--ct`` the reference
repo's ``block.CT_encoder`` with ``--reference <repo>``, weight MAE < 1e-4
and tokens < 1e-3; ``--diffma`` none (upstream needs mamba_ssm's CUDA
kernels). Without an oracle the checks are the structure and the smoke.

Exit code 0 when every requested file passes; 1 otherwise, with one ``FAIL
<kind>: <why>`` line for each failure in the summary.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import Dict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from diffma_tpu_torch.models.clip_vit import biomedclip_vit_b16  # noqa: E402
from diffma_tpu_torch.models.ct_encoder import CTEncoder  # noqa: E402
from diffma_tpu_torch.models.diffma import build_model  # noqa: E402
from diffma_tpu_torch.models.vae import AutoencoderKL  # noqa: E402
from diffma_tpu_torch.train.checkpoints import find_model  # noqa: E402
from diffma_tpu_torch.utils.device import resolve_device  # noqa: E402
from diffma_tpu_torch.utils.torch_io import load_weights  # noqa: E402

KINDS = ("ct", "vae", "clip", "diffma")


class Failure(Exception):
    """A file that does not pass; ``kind`` names its flag."""

    def __init__(self, kind: str, why: str):
        super().__init__(f"{kind}: {why}")
        self.kind = kind


def _section(title: str) -> None:
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)), flush=True)


def _structure(kind: str, sd: Dict[str, torch.Tensor], module: torch.nn.Module) -> None:
    """Print both sides' tensors and elements and what does not fit; raise
    ``Failure`` on a missing or unexpected key or a wrong shape, else load
    ``sd`` into ``module`` strictly."""
    want = module.state_dict()
    print(f"  file tensors  : {len(sd)}  ({sum(v.numel() for v in sd.values()):,} elements)")
    print(f"  module tensors: {len(want)}  ({sum(v.numel() for v in want.values()):,} elements)")
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    shapes = sorted(f"{k} {tuple(sd[k].shape)} (module {tuple(want[k].shape)})"
                    for k in set(sd) & set(want) if sd[k].shape != want[k].shape)
    for name, keys in (("missing", missing), ("unexpected", unexpected), ("wrong shape", shapes)):
        print(f"  {name:<11}: {len(keys)}" + (f"  {keys[:8]}" if keys else ""))
    if missing or unexpected or shapes:
        raise Failure(kind, f"{len(missing)} missing, {len(unexpected)} unexpected and "
                            f"{len(shapes)} wrongly shaped tensors")
    module.load_state_dict(sd, strict=True)


def _finite(kind: str, name: str, t: torch.Tensor, shape) -> None:
    t = t.detach().float().cpu()
    ok = bool(torch.isfinite(t).all())
    print(f"  {name}: shape {tuple(t.shape)}, finite={ok}, mean {t.mean().item():+.4e}, "
          f"std {t.std().item():.4e}")
    if not ok:
        raise Failure(kind, f"non-finite values in {name}")
    if tuple(t.shape) != tuple(shape):
        raise Failure(kind, f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _parity(kind: str, name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    diff = (got.detach().float().cpu() - want.detach().float().cpu()).abs()
    mae = diff.mean().item()
    print(f"  parity[{name}]: MAE {mae:.3e} max {diff.max().item():.3e} (tol {tol:g}) "
          f"{'OK' if mae < tol else 'FAIL'}")
    if not mae < tol:
        raise Failure(kind, f"{name} parity MAE {mae:.3e} over {tol:g}")


def _normal(seed: int, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def validate_ct(path: str, device, reference_dir=None, load_ckpt_type: str = "ema") -> None:
    _section(f"CT encoder: {path}")
    sd = load_weights("ct", path, load_ckpt_type)
    m = CTEncoder(img_size=28, patch_size=2, in_channels=4, embed_dim=512,
                  contain_mask_token=any(k.split(".")[-1] == "mask_token" for k in sd))
    _structure("ct", sd, m)
    x = _normal(0, 2, 4, 28, 28)
    w, tok = m.to(device).eval()(x.to(device))
    _finite("ct", "weight", w, (2, 196, 1))
    _finite("ct", "tokens", tok, (2, 196, 512))
    if not reference_dir:
        return
    try:
        sys.path.insert(0, reference_dir)
        from block.CT_encoder import CT_Encoder as TorchCT
    except ImportError as e:
        print(f"  (no reference CT-encoder oracle: {e})")
        return
    tm = TorchCT(img_size=28, patch_size=2, in_channels=4, embed_dim=512, contain_mask_token=True)
    tm.load_state_dict(sd)
    tw, ttok = tm.eval()(x)
    _parity("ct", "weight", w, tw, 1e-4)
    _parity("ct", "tokens", tok, ttok, 1e-3)


@torch.no_grad()
def validate_vae(path: str, device) -> None:
    _section(f"SD-VAE: {path}")
    sd = load_weights("vae", path)
    m = AutoencoderKL(with_encoder=True)
    _structure("vae", sd, m)
    m = m.to(device).eval()
    x = _normal(1, 1, 3, 64, 64)
    z = m.encode(x.to(device)).mean
    _finite("vae", "latent (mode)", z, (1, 4, 8, 8))
    dec = m.decode(z)
    _finite("vae", "decode", dec, (1, 3, 64, 64))
    try:
        from diffusers import AutoencoderKL as DiffusersVAE
    except ImportError as e:
        print(f"  (no diffusers oracle: {e}; structure and smoke only)")
        return
    tm = DiffusersVAE(down_block_types=("DownEncoderBlock2D",) * 4,
                      up_block_types=("UpDecoderBlock2D",) * 4,
                      block_out_channels=(128, 256, 512, 512), layers_per_block=2,
                      latent_channels=4)
    tm.load_state_dict(sd)
    tm.eval()
    _parity("vae", "latent", z, tm.encode(x).latent_dist.mode(), 1e-4)
    _parity("vae", "decode", dec, tm.decode(z.float().cpu()).sample, 1e-4)


@torch.no_grad()
def validate_clip(path: str, device) -> None:
    _section(f"BiomedCLIP image tower: {path}")
    sd = load_weights("clip", path)
    m = biomedclip_vit_b16()
    _structure("clip", sd, m)
    x = _normal(2, 2, 3, 224, 224)
    emb = m.to(device).eval()(x.to(device))
    _finite("clip", "embedding", emb, (2, 512))
    try:
        import open_clip
    except ImportError as e:
        print(f"  (no open_clip oracle: {e}; structure and smoke only)")
        return
    os.environ.setdefault("HF_HUB_OFFLINE", "1")  # the local cache only: no download
    try:
        tm, _ = open_clip.create_model_from_pretrained(
            "hf-hub:microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224")
    except Exception as e:  # not in the local cache
        print(f"  (no open_clip oracle: {type(e).__name__}: {e}; structure and smoke only)")
        return
    _parity("clip", "embedding", emb, tm.eval().visual(x), 1e-4)


@torch.no_grad()
def validate_diffma(path: str, device, model_name: str = "DiffMa-B/2", use_mamba2: bool = False,
                    load_ckpt_type: str = "ema") -> None:
    _section(f"DiffMa checkpoint: {path} as {model_name}")
    sd = {k.removeprefix("module."): v for k, v in find_model(path, load_ckpt_type).items()}
    sd.pop("pos_embed", None)  # a fixed buffer, rebuilt by the model
    m = build_model(model_name, input_size=28, d_state=16, use_mamba2=use_mamba2)
    _structure("diffma", sd, m)
    N, T, D = 2, 196, 512
    args = (_normal(3, N, 4, 28, 28), torch.tensor([10, 500]), _normal(4, N, D),
            _normal(5, N, T, D), torch.sigmoid(_normal(6, N, T, 1)))
    out = m.to(device).eval()(*(a.to(device) for a in args))
    _finite("diffma", "denoiser output", out, (N, m.out_channels, 28, 28))
    print("  (no oracle for the whole model: upstream needs mamba_ssm's CUDA kernels; "
          "tests/test_torch_model.py holds the port to the JAX package on the CPU)")


def write_stand_ins(out_dir: str, seed: int = 0, diffma_model: str = "DiffMa-B/2",
                    use_mamba2: bool = False) -> Dict[str, str]:
    """Seeded stand-ins of the four files in the upstream layouts, at full
    width, for checking the tool itself: a diffusers VAE state dict, an
    open_clip checkpoint (``visual.trunk.*``, ``visual.head.proj.*`` and
    ``logit_scale``), a CT-encoder checkpoint (``model`` and ``ema``) and a
    DiffMa training checkpoint (``model``, ``ema``, ``opt``, ``args``; every
    parameter moved off its init). Returns kind -> path."""
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    ct = CTEncoder(img_size=28, patch_size=2, in_channels=4, embed_dim=512).init_weights(gen)
    vae = AutoencoderKL(with_encoder=True).init_weights(gen)
    clip = {("visual.head.proj." + k.removeprefix("head.")) if k.startswith("head.")
            else "visual.trunk." + k: v
            for k, v in biomedclip_vit_b16().init_weights(gen).state_dict().items()}
    clip["logit_scale"] = torch.tensor(4.6052)
    model = build_model(diffma_model, input_size=28, d_state=16, use_mamba2=use_mamba2)
    model.init_weights(gen)
    with torch.no_grad():  # off the init, whose zeroed output layers give a zero forward
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen), alpha=0.02)
    diffma = model.state_dict()
    files = {
        "ct": ("brain_patch_size_2.pt", {"model": ct.state_dict(), "ema": ct.state_dict()}),
        "vae": ("diffusion_pytorch_model.bin", vae.state_dict()),
        "clip": ("open_clip_pytorch_model.bin", clip),
        "diffma": ("0000001.pt", {"model": diffma, "ema": diffma, "opt": {},
                                  "args": argparse.Namespace(model=diffma_model)}),
    }
    paths = {}
    for kind, (name, tree) in files.items():
        paths[kind] = os.path.join(out_dir, name)
        torch.save(tree, paths[kind])
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vae", help="diffusers AutoencoderKL .bin/.pt state dict")
    ap.add_argument("--clip", help="BiomedCLIP/open_clip .bin/.pt state dict")
    ap.add_argument("--ct", help="CT-encoder checkpoint (.pt with model/ema)")
    ap.add_argument("--diffma", help="DiffMa training checkpoint (.pt)")
    ap.add_argument("--diffma-model", default="DiffMa-B/2")
    ap.add_argument("--use-mamba2", action="store_true")
    ap.add_argument("--load-ckpt-type", default="ema", choices=["ema", "model"])
    ap.add_argument("--reference", default=None,
                    help="path to the reference repo for the torch CT-encoder oracle")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not any(getattr(args, kind) for kind in KINDS):
        ap.error("nothing to validate: pass at least one of --vae/--clip/--ct/--diffma")
    device = resolve_device(args.device)

    runs = {
        "ct": lambda: validate_ct(args.ct, device, args.reference, args.load_ckpt_type),
        "vae": lambda: validate_vae(args.vae, device),
        "clip": lambda: validate_clip(args.clip, device),
        "diffma": lambda: validate_diffma(args.diffma, device, args.diffma_model,
                                          args.use_mamba2, args.load_ckpt_type),
    }
    failures = []
    for kind in KINDS:
        if not getattr(args, kind):
            continue
        try:
            runs[kind]()
        except Failure as e:
            failures.append(str(e))
        except Exception as e:
            traceback.print_exc()
            failures.append(f"{kind}: {type(e).__name__} during validation: {e}")

    _section("summary")
    for f in failures:
        print(f"  FAIL {f}")
    if failures:
        return 1
    print("  all requested imports validated")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
