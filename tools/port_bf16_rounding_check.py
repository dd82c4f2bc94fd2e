#!/usr/bin/env python3
"""Do the bars of kernels H and P in bf16 catch a kernel that rounds in the wrong place?

Kernels H and P in bf16 round the operands of their products where the TPU
kernels cast them, and ``chip_smoke.py`` holds them to their bf16 plain
versions at ``TOL_HP_BF16`` (2^-6 * max(1, max |ref|)) and
``TOL_HP_BF16_MEAN`` (1e-5 mean-rel). This tool reads both kernels against
their plain versions at phases 24a's and 24c's inputs in this checkout, then
in one copy per mutation below, each skipping one of those rounds:

* ``h_xproj``: H's x_proj on fp32 operands (its stage not ``kBf16``);
* ``h_dtproj``: H's dt_proj on fp32 operands;
* ``p_mh``: P's masked decay M not rounded at the head product;
* ``p_xdt``: P's dt * x not rounded at the head product.

For each reading it prints max |err|, mean-rel, whether two calls gave equal
bits, and the verdict under H's and P's bars and under kernel C bf16's
(``TOL_C_BF16``, ``TOL_C_BF16_MEAN``). The copies are the checkout's files,
without git's data, run outputs or builds, under ``results/bf16_mutations/``
there, each building its own kernels. Run from the root of a checkout, on an NVIDIA
GPU with nvcc:

    python tools/port_bf16_rounding_check.py

``--check NAME`` reads the kernels in the current directory only, labelled
NAME (what each copy runs).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_XPROJ_LINE = "static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;"
_XPROJ_BAD = "static constexpr bool kAByRow = false, kBByRow = false, kBf16 = false;"
# What a copy leaves out: git's data, run outputs and builds.
_NOT_COPIED = (".git", "results", "result_sample", "chiprun_out", "_build", "__pycache__")
# name: (source under diffma_tpu_torch/csrc, text, replacement, which occurrence)
MUTATIONS = {
    "h_xproj": ("fused_mamba_fwd.cu", _XPROJ_LINE, _XPROJ_BAD, 1),  # XProj's stage
    "h_dtproj": ("fused_mamba_fwd.cu", _XPROJ_LINE, _XPROJ_BAD, 2),  # DtProj's stage
    "p_mh": ("ssd_core_fwd.cu", "(kBf16 ? round_bf16(m) : m * dts[u])",
             "(kBf16 ? m : m * dts[u])", 1),
    "p_xdt": ("ssd_core_fwd.cu",
              "      b = make_float4(round_bf16(b.x * s), round_bf16(b.y * s), "
              "round_bf16(b.z * s),\n                      round_bf16(b.w * s));",
              "      b = make_float4(b.x * s, b.y * s, b.z * s, b.w * s);", 1),
}


def check(name: str) -> None:
    """Kernels H and P in bf16 as built in the current directory against
    their bf16 plain versions at phase 24's inputs."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import torch

    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda, mamba_inner_plain
    from diffma_tpu_torch.ops.fused_ssd import ssd_core_cuda, ssd_core_ref

    print(cs.card_line())

    def report(tag, got, again, want):
        diff = (got.float() - want.float()).abs()
        err, rel = diff.max().item(), (diff.mean() / want.float().abs().mean()).item()
        top = max(1.0, want.float().abs().max().item())
        new = err <= cs.TOL_HP_BF16 * top and rel <= cs.TOL_HP_BF16_MEAN
        old = err <= cs.TOL_C_BF16 * top and rel <= cs.TOL_C_BF16_MEAN
        print(f"{name} {tag}: max|err| {err:.4e} (max|ref| {top:.3f}), mean-rel {rel:.4e}; "
              f"equal bits twice {torch.equal(got, again)}; H/P bars {'pass' if new else 'FAIL'}, "
              f"C bf16 bars {'pass' if old else 'FAIL'}", flush=True)

    with torch.no_grad():
        if name[0] in "hn":  # "none" reads both kernels
            for G, L in cs.INNER_BF16_SHAPES:
                args = cs.inner_bf16_args(G, L)
                got, again = (mamba_inner_fused_cuda(*args) for _ in range(2))
                report(f"H G={G} L={L}", got, again, mamba_inner_plain(*args))
        if name[0] in "pn":
            zxs, ws = cs.core_bf16_args()
            for zx in (zxs, zxs[:4, :25].contiguous()):
                got, again = (ssd_core_cuda(zx, ws) for _ in range(2))
                report(f"P zx {tuple(zx.shape)}", got, again, ssd_core_ref(zx, ws))


def mutated_copy(name: str) -> str:
    """The checkout's files under results/bf16_mutations/<name>, one
    mutation applied; returns the copy's root."""
    source, text, replacement, nth = MUTATIONS[name]
    dest = os.path.join(ROOT, "results", "bf16_mutations", name)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT, dest, ignore=shutil.ignore_patterns(*_NOT_COPIED))
    path = os.path.join(dest, "diffma_tpu_torch", "csrc", source)
    src = open(path).read()
    at = -1
    for _ in range(nth):
        at = src.index(text, at + 1)
    with open(path, "w") as f:
        f.write(src[:at] + replacement + src[at + len(text):])
    return dest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", metavar="NAME", help="read this directory's kernels only")
    args = parser.parse_args(argv)
    if args.check:
        check(args.check)
        return 0
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--check", "none"],
                        cwd=ROOT).returncode
    for name in MUTATIONS:
        dest = mutated_copy(name)
        tool = os.path.join(dest, "tools", os.path.basename(__file__))
        rc |= subprocess.run([sys.executable, tool, "--check", name], cwd=dest).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
