#!/usr/bin/env python3
"""Do two checkouts of the PyTorch port give the same bits from their CUDA kernels?

A change to a shared header (``csrc/*.cuh``) or to a kernel's launcher must
leave the kernel's earlier cases as they were. This tool runs kernels A to H
and P of one checkout on fixed seeded inputs at DiffMa's width (A in fp32
and, under the name Abf16, in bf16; G alone at batch 1 and 8, and inside the
block-fused Spiral block as EG) and writes the outputs to a file; run it
once per checkout
(each in a process of its own, since both packages have the same name) and
compare:

    python tools/port_kernel_bits.py dump --root . --out new.pt
    python tools/port_kernel_bits.py dump --root path/to/other/checkout --out old.pt
    python tools/port_kernel_bits.py compare old.pt new.pt

``compare`` prints each tensor's largest difference and exits 1 unless every
tensor is equal bit for bit. A change that redesigns some kernels names the
ones that must keep their bits, and holds the others to a bar instead:

    python tools/port_kernel_bits.py compare old.pt new.pt --exact A,Abf16,B,C,D,E,F,H \
        --bar G=1e-4 --bar EG=1e-4 --bar P=1e-4

(each tensor of G, EG and P within 1e-4 * max(1, max |old|)). It needs an
NVIDIA GPU with nvcc and uses only entry points that both checkouts have.
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
    from diffma_tpu_torch.ops import fused_mamba, fused_mixer, fused_ssd, selective_scan
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
    inner = _random_(Mamba(h, build_scan_spec("zig", 2, 0)), 40).cuda().weights()
    for G, L in ((8, 49), (3, 196)):
        xz = torch.randn(G, L, 4 * h, generator=torch.Generator().manual_seed(G)).cuda()
        with torch.no_grad():
            results[f"H.G{G}.L{L}"] = fused_mamba.mamba_inner_fused_cuda(
                xz, inner.conv_w[:, 0, :], inner.conv_b, inner.xp_w, inner.dt_w, inner.dt_b,
                -torch.exp(inner.A_log), inner.D)
    # Kernel G alone: a seeded block's tail on random rows, 196 tokens.
    for batch in (1, 8):
        block = _random_(SpiralMambaBlock(h, build_scan_spec("spiral", 14, 0), use_mamba2=True),
                         60 + batch).cuda().eval()
        gen = torch.Generator().manual_seed(70 + batch)
        o0, o1, x = (torch.randn(batch, 196, h, generator=gen).cuda() for _ in range(3))
        cond = torch.randn(batch, 2 * h, generator=gen).cuda()
        an, fc1, _, fc2 = block.attention_network
        with torch.no_grad():
            gate = block.adaLN_modulation(cond).chunk(3, dim=-1)[2]
            results[f"G.B{batch}.L196"] = fused_ssd.spiral_epilogue_cuda(
                o0, o1, x, gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    # Kernel P on the last case's two weight sets, zx (6, 196, 2d + 2n + H).
    zx = torch.randn(6, 196, 2096, generator=torch.Generator().manual_seed(50)).cuda()
    with torch.no_grad():
        results["P.G6.L196"] = fused_ssd.ssd_core_cuda(zx, w2)
    # Kernels A and B: the sampler's three streams and the training step's 24,
    # gated and not, fp32 and bf16.
    f32, bf16 = torch.float32, torch.bfloat16
    for G, L, dtype, delta_dtype, gated in ((3, 196, f32, f32, True), (3, 197, f32, f32, False),
                                            (24, 196, f32, f32, True), (3, 196, bf16, f32, True),
                                            (3, 13, bf16, bf16, False)):
        gen = torch.Generator().manual_seed(G + L)
        r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
        d = 2 * h
        u, z, g = (r(G, L, d).cuda().to(dtype) for _ in range(3))
        delta = (0.5 * r(G, L, d) - 1.0).cuda().to(delta_dtype)
        A, D = -torch.exp(0.5 * r(d, 16)).cuda(), r(d).cuda()
        B, C = (r(G, L, 16).cuda().to(dtype) for _ in range(2))
        z = z if gated else None
        tag = f"G{G}.L{L}.{str(dtype)[6:]}.{str(delta_dtype)[6:]}.{'gated' if gated else 'ungated'}"
        name = "A" if dtype == f32 else "Abf16"
        results[f"{name}.{tag}"] = selective_scan.selective_scan_cuda(u, delta, A, B, C, D, z)
        grads = selective_scan.selective_scan_bwd_cuda(u, delta, A, B, C, D, z, g)
        results.update({f"B.{tag}.{k}": t for k, t in zip(("du", "ddelta", "dA", "dB", "dC", "dD",
                                                            "dz"), grads) if t is not None})
    torch.cuda.synchronize()
    torch.save({k: v.detach().cpu() for k, v in results.items()}, out)
    print(f"wrote {len(results)} tensors from {os.path.abspath(root)} to {out}")


def compare(a_path: str, b_path: str, exact=None, bars=None) -> int:
    """Every tensor of a kernel in ``exact`` (every kernel, if None) equal bit
    for bit; each of a kernel in ``bars`` within its bar * max(1, max |a|)."""
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    if set(a) != set(b):
        print(f"the files hold other tensors: {sorted(set(a) ^ set(b))}")
        return 1
    bars = bars or {}
    failed, equal_count, by_kernel, worst = 0, 0, {}, {}
    for key in sorted(a):
        kernel = key.split(".")[0]
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        equal = torch.equal(a[key], b[key])
        equal_count += equal
        if equal:
            continue
        diff = (a[key] - b[key]).abs().max().item()
        if exact is None or kernel in exact:
            failed += 1
            print(f"  {key}: max |diff| {diff:.3e}, must be equal bit for bit")
        elif kernel in bars:
            rel = diff / max(1.0, a[key].abs().max().item())
            worst[kernel] = max(worst.get(kernel, 0.0), rel)
            if rel > bars[kernel]:
                failed += 1
                print(f"  {key}: max |diff| {diff:.3e} = {rel:.3e} of max(1, max |ref|), over "
                      f"the bar {bars[kernel]:.0e}")
        else:
            failed += 1
            print(f"  {key}: max |diff| {diff:.3e}, and neither --exact nor --bar names {kernel}")
    for kernel, rel in sorted(worst.items()):
        print(f"  {kernel}: largest difference {rel:.3e} of max(1, max |ref|) (bar {bars[kernel]:.0e})")
    print(f"{len(a)} tensors ({by_kernel}): {equal_count} equal bit for bit, {failed} fail")
    return 1 if failed else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--root", default=".")
    d.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--exact", help="comma-separated kernels that must match bit for bit "
                   "(default: all)")
    c.add_argument("--bar", action="append", default=[], metavar="KERNEL=TOL",
                   help="hold a kernel's tensors within TOL * max(1, max |a|) instead")
    args = parser.parse_args()
    if args.command == "dump":
        dump(args.root, args.out)
        return 0
    exact = None if args.exact is None else set(args.exact.split(","))
    bars = {k: float(v) for k, v in (item.split("=") for item in args.bar)}
    return compare(args.a, args.b, exact, bars)


if __name__ == "__main__":
    sys.exit(main())
