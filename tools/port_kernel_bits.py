#!/usr/bin/env python3
"""Do two checkouts of the PyTorch port give the same bits from their CUDA kernels?

A change to a shared header (``csrc/*.cuh``) or to a kernel's launcher must
leave the kernel's earlier cases as they were. This tool runs the fused
kernels C, D, E, F and G of one checkout on fixed seeded inputs at DiffMa's
width and writes the outputs to a file; run it once per checkout (each in a
process of its own, since both packages have the same name) and compare:

    python tools/port_kernel_bits.py dump --root . --out new.pt
    python tools/port_kernel_bits.py dump --root path/to/other/checkout --out old.pt
    python tools/port_kernel_bits.py compare old.pt new.pt

``compare`` prints each tensor's largest difference and exits 1 unless every
tensor is equal bit for bit. It needs an NVIDIA GPU with nvcc and uses only
entry points that both checkouts have.
"""

from __future__ import annotations

import argparse
import math
import os
import sys


def _random_(module, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = 0.1 if p.dim() == 1 else 0.1 / math.sqrt(p.shape[-1])
            p.add_(std * torch.randn(p.shape, generator=gen))
    return module


def dump(root: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from diffma_tpu_torch.models.blocks import SpiralMambaBlock
    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.models.mamba2 import Mamba2
    from diffma_tpu_torch.ops import fused_mixer, fused_ssd
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    h = 512
    results = {}
    torch.manual_seed(0)  # the modules' default init draws from the global generator
    cases = [("spiral", 14, 0, 1), ("spiral", 14, 3, 8), ("spiral", 5, 1, 2), ("zig", 14, 2, 1),
             ("vmamba", 14, 0, 2)]
    for family, grid_n, layer, batch in cases:
        spec = build_scan_spec(family, grid_n, layer)
        L = grid_n * grid_n
        tag = f"{family}{grid_n}.{layer}.B{batch}"
        gen = torch.Generator().manual_seed(layer)
        xs = [torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)]
        gs = [torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)]
        m1 = [_random_(Mamba(h, spec), 10 + i).cuda() for i in range(2)]
        m2 = [_random_(Mamba2(h, spec), 20 + i).cuda() for i in range(2)]
        w1, w2 = [m.weights() for m in m1], [m.weights() for m in m2]
        with torch.no_grad():
            c = fused_mixer.mixer_fused_cuda(spec, xs, w1)
            c1 = fused_mixer.mixer_fused_cuda(spec, xs[1:], w1[1:])
            gxs, gws = fused_mixer.mixer_fused_bwd_cuda(spec, xs, gs, w1)
            e, zx = fused_ssd.ssd_mixer_fused_cuda(spec, xs, w2, want_res=True)
            e1 = fused_ssd.ssd_mixer_fused_cuda(spec, xs[1:], w2[1:], (0.01, 0.05))
            fxs, fws = fused_ssd.ssd_mixer_fused_bwd_cuda(spec, xs, gs, w2, zx)
        results.update({f"C.{tag}.{i}": t for i, t in enumerate((*c, *c1))})
        results.update({f"D.{tag}.gx{i}": t for i, t in enumerate(gxs)})
        results.update({f"D.{tag}.w{m}.{k}": t for m, g in enumerate(gws)
                        for k, t in zip(g._fields, g)})
        results.update({f"E.{tag}.{i}": t for i, t in enumerate((*e, *e1, zx))})
        results.update({f"F.{tag}.gx{i}": t for i, t in enumerate(fxs)})
        results.update({f"F.{tag}.w{m}.{k}": t for m, g in enumerate(fws)
                        for k, t in zip(g._fields, g)})
        if family == "spiral":
            block = _random_(SpiralMambaBlock(h, spec, use_mamba2=True, scan_impl="fused",
                                              fuse_block=True), 30).cuda().eval()
            cond = torch.randn(batch, 2 * h, generator=gen).cuda()
            mask = torch.sigmoid(torch.randn(batch, L, 1, generator=gen)).cuda()
            with torch.no_grad():
                results[f"EG.{tag}"] = block(xs[0], cond, mask)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in results.items()}, out)
    print(f"wrote {len(results)} tensors from {os.path.abspath(root)} to {out}")


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    if set(a) != set(b):
        print(f"the files hold other tensors: {sorted(set(a) ^ set(b))}")
        return 1
    differ = 0
    for key in sorted(a):
        equal = torch.equal(a[key], b[key])
        differ += not equal
        if not equal:
            print(f"  {key}: max |diff| {(a[key] - b[key]).abs().max().item():.3e}")
    by_kernel = {}
    for key in a:
        by_kernel[key.split(".")[0]] = by_kernel.get(key.split(".")[0], 0) + 1
    print(f"{len(a)} tensors ({by_kernel}): {len(a) - differ} equal bit for bit, {differ} differ")
    return 1 if differ else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--root", default=".")
    d.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = parser.parse_args()
    if args.command == "dump":
        dump(args.root, args.out)
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
