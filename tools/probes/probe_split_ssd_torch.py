#!/usr/bin/env python3
"""A/B on the card: the whole Mamba-2 dual mixer (kernel E) against its
'split' form, whose core alone is a kernel (kernel P).

    python tools/probes/probe_split_ssd_torch.py [--batch 8] [--seed 0]
    python tools/probes/probe_split_ssd_torch.py --device cpu --batch 1

The port's counterpart of ``tools/probes/probe_split_ssd.py``. The split form
does in_proj and out_proj as plain products over the whole (branch, batch)
grid, the stream gathers as ``index_select`` and the merge as a gather-sum,
and leaves only the SSD core (conv, dt, cumsum, the decay-masked products,
the gate and the norm) to ``ops/fused_ssd.py::ssd_core_cuda``; the whole form
is one call of ``mamba2_dual_mixer_fused``. Both run the Spiral spec of
grid 14, layer 3 (non-identity orders), DiffMa's width (hidden 512, d_inner
1024, 16 heads of 64, d_state 16), both branches, with weights drawn as the
JAX probe's ``make_weights`` draws them, from a ``torch.Generator`` seeded
with ``--seed``. It prints the two forms' largest difference and, on the
card, ms per dual-mixer call over ``CHAIN`` chained calls of each.

On the CPU (``--device cpu``) both forms take their plain versions, and no
time is printed.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Sequence, Tuple

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from diffma_tpu_torch.ops.fused_mixer import index_tables  # noqa: E402
from diffma_tpu_torch.ops.fused_ssd import (  # noqa: E402
    Mamba2Weights,
    mamba2_dual_mixer_fused,
    ssd_core_cuda,
    ssd_core_ref,
)
from diffma_tpu_torch.ops.scan_orders import build_scan_spec  # noqa: E402
from diffma_tpu_torch.utils.device import resolve_device  # noqa: E402

GRID, LAYER = 14, 3
H_MODEL, D_INNER, D_STATE, HEADS, CONV = 512, 1024, 16, 16, 4
CONV_DIM = D_INNER + 2 * D_STATE
DPROJ = 2 * D_INNER + 2 * D_STATE + HEADS
EPS = 1e-5
SPEC = build_scan_spec("spiral", GRID, LAYER)
CHAIN = 50  # chained calls per timing, as the JAX probe's N_CHAIN


def make_weights(seed: int, device) -> Tuple[torch.Tensor, ...]:
    """Both branches' weights stacked, in the JAX probe's layout and scales:
    in_w (2, h, dproj), conv_w (2, conv_dim, K), conv_b (2, conv_dim),
    dt_bias (2, H), A_log (2, H), D (2, H), norm_w (2, d), out_w (2, d, h)."""
    gen = torch.Generator().manual_seed(seed)

    def u(shape, scale):
        return torch.randn(shape, generator=gen) * scale

    weights = (
        u((2, H_MODEL, DPROJ), 0.03), u((2, CONV_DIM, CONV), 0.3), u((2, CONV_DIM), 0.1),
        u((2, HEADS), 0.1), u((2, HEADS), 0.5), torch.ones(2, HEADS), torch.ones(2, D_INNER),
        u((2, D_INNER, H_MODEL), 0.03),
    )
    return tuple(w.to(device) for w in weights)


def mixer_weights(weights) -> Tuple[Mamba2Weights, Mamba2Weights]:
    """The stacked probe weights as the two branches' torch-layout weights."""
    in_w, conv_w, conv_b, dt_bias, A_log, D, norm_w, out_w = weights
    return tuple(
        Mamba2Weights(in_w[m].T.contiguous(), conv_w[m][:, None, :].contiguous(), conv_b[m],
                      dt_bias[m], A_log[m], D[m], norm_w[m], out_w[m].T.contiguous())
        for m in range(2)
    )


def whole_dual(x12: torch.Tensor, ws: Sequence[Mamba2Weights]) -> torch.Tensor:
    """Both branches through one call of kernel E (its plain version on the
    CPU); (2, B, L, h)."""
    return torch.stack(mamba2_dual_mixer_fused(SPEC, x12[0], x12[1], ws[0], ws[1], eps=EPS))


def gathered_streams(x12: torch.Tensor, ws: Sequence[Mamba2Weights]) -> torch.Tensor:
    """in_proj over the (branch, batch) grid, then the stream gathers: the
    (branch, batch, stream) sequences ``(2 * B * S, L, dproj)`` that kernel P
    takes."""
    M, B, L, _ = x12.shape
    in_w = torch.stack([w.in_w for w in ws])
    zx = torch.matmul(x12, in_w.transpose(1, 2)[:, None])  # (M, B, L, dproj)
    fwd, _ = index_tables(SPEC, x12.device)
    return zx.index_select(2, fwd).reshape(M * B * SPEC.n_streams, L, DPROJ)


def split_dual(x12: torch.Tensor, ws: Sequence[Mamba2Weights]) -> torch.Tensor:
    """The split form: ``gathered_streams``, kernel P (its plain version on
    the CPU), the merge and out_proj; (2, B, L, h)."""
    M, B, L, _ = x12.shape
    S = SPEC.n_streams
    zxs = gathered_streams(x12, ws)
    core = ssd_core_cuda if zxs.device.type == "cuda" else ssd_core_ref
    yn = core(zxs, ws, eps=EPS).reshape(M, B, S * L, D_INNER)
    _, merge = index_tables(SPEC, x12.device)
    merged = yn.index_select(2, merge).reshape(M, B, L, S, D_INNER).sum(dim=3) * SPEC.scale
    out_w = torch.stack([w.out_w for w in ws])
    return torch.matmul(merged, out_w.transpose(1, 2)[:, None])


def inputs(batch: int, seed: int, device) -> Tuple[torch.Tensor, Tuple[Mamba2Weights, ...]]:
    """x12 (2, B, 196, h), normal times 0.5 as the JAX probe draws it, and
    both branches' weights."""
    gen = torch.Generator().manual_seed(seed + 1)
    x12 = (torch.randn(2, batch, GRID * GRID, H_MODEL, generator=gen) * 0.5).to(device)
    return x12, mixer_weights(make_weights(seed, device))


def chained_ms(fn, x12: torch.Tensor, calls: int) -> float:
    """ms per call over ``calls`` chained calls (each feeds the next), CUDA
    events around the chain."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    x = x12
    start.record()
    for _ in range(calls):
        x = fn(x) * 1e-3 + x
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    x12, ws = inputs(args.batch, args.seed, device)
    with torch.no_grad():
        cur = whole_dual(x12, ws)
        new = split_dual(x12, ws)
        diff = (cur - new).abs()
        out = {"max_abs_ref": cur.abs().max().item(), "max_abs_diff": diff.max().item(),
               "rel": (diff.mean() / cur.abs().mean()).item()}
        print(f"[fp32, B={args.batch}, {device}] mean|whole|={cur.abs().mean().item():.4f} "
              f"max|diff|={out['max_abs_diff']:.3e} rel={out['rel']:.2e}")
        if device.type == "cuda":
            for name, fn in (("whole_ms", lambda x: whole_dual(x, ws)),
                             ("split_ms", lambda x: split_dual(x, ws))):
                fn(x12)  # warm-up
                out[name] = chained_ms(fn, x12, CHAIN)
            print(f"  [{torch.cuda.get_device_name(0)}] chained dual-mixer: whole (kernel E) "
                  f"{out['whole_ms']:.4f} ms  split (in_proj, gathers, kernel P, merge, "
                  f"out_proj) {out['split_ms']:.4f} ms  ({out['whole_ms'] / out['split_ms']:.2f}x)")
    return out


if __name__ == "__main__":
    main()
