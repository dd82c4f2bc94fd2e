"""The yardstick's arithmetic: the card's peaks, the work of the mixer entry
points, the model FLOPs of a denoiser call and of a VAE decode.

``HBM_BYTES_PER_S``, ``FP32_FLOPS``, ``TF32_FLOPS``, ``BF16_FLOPS``,
``mixer_work``, ``mixer_bwd_work``, ``ssd_chunk_work``, ``ssd_mixer_work``,
``ssd_mixer_bwd_work`` and ``bound_from`` are frozen copies of
``chip_smoke.py`` at commit 8e06284 (its docstrings shortened), so that a
later change there does not move the benchmark. What is new here: a roofline
share counts products at the TF32 dense peak (``PRODUCT_PEAK``), not at the
3xTF32 rate of today's kernels, so that no later way of computing the same
work can read above 100%; ``denoiser_flops`` and ``vae_decode_flops`` count
a model's work from its shapes for the MFU metrics.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

#: The peak of an fp32 configuration's products (and of its MFU): TF32's.
PRODUCT_PEAK = {"float32": TF32_FLOPS, "bfloat16": BF16_FLOPS}


def bound_from(products, other, nbytes, product_flops=FP32_FLOPS) -> tuple[float, str]:
    """The larger of the bytes over the HBM rate and the operations over
    their rates (products at ``product_flops``, the rest at fp32), in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / product_flops + other / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def mixer_work(M, B, L, h, d, n, r, S, K, Ls=None, quirk=False,
               act_bytes=4) -> tuple[int, int, int]:
    """One fused Mamba-1 mixer call of M branches: (products, other
    operations, bytes). Products: in_proj, x_proj, dt_proj, out_proj; other:
    conv, scan (6n + 8 per channel and step), D skip, gate; bytes: the fp32
    weights, x and out, the index tables, once each."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    products = M * (
        2 * tokens * h * 2 * d  # in_proj
        + 2 * rows * d * (r + 2 * n)  # x_proj
        + 2 * rows * r * d  # dt_proj
        + 2 * tokens * d * h * (S if quirk else 1)  # out_proj
    )
    other = M * (rows * d * 2 * K + rows * d * (6 * n + 8))  # conv; scan, D skip, gate
    weights = 2 * d * h + d * K + d + (r + 2 * n) * d + d * r + d + d * n + d + h * d
    nbytes = M * (4 * weights + act_bytes * 2 * tokens * h) + 2 * S * Ls * 8
    return products, other, nbytes


def mixer_bwd_work(M, B, L, h, d, n, r, S, K, Ls=None, quirk=False,
                   act_bytes=4) -> tuple[int, int, int]:
    """One fused Mamba-1 mixer backward of M branches: the forward as far as
    the backward needs it (not out_proj), two products per projection, the
    conv's two adjoints and the scan's adjoint (17 per state and step, 12
    per channel and step); bytes: weights, x and g read, gx and the weight
    gradients written, once each."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    r2n = r + 2 * n
    products = M * (
        2 * tokens * h * 2 * d + 2 * rows * d * r2n + 2 * rows * r * d  # the forward's
        + 2 * 2 * tokens * d * h * (S if quirk else 1)  # g W_out, dW_out
        + 2 * 2 * rows * r * d  # d dt_r, dW_dt
        + 2 * 2 * rows * r2n * d  # dpre's product, dW_x
        + 2 * 2 * tokens * 2 * d * h  # gx, dW_in
    )
    other = M * (
        rows * d * 2 * K + rows * d * (6 * n + 8)  # the forward's conv and scan
        + rows * d * (17 * n + 12)  # the scan's adjoint
        + 2 * 2 * rows * d * K  # the conv's input and weight adjoints
    )
    weights = 2 * d * h + d * K + d + r2n * d + d * r + d + d * n + d + h * d
    nbytes = M * (4 * 2 * weights + act_bytes * 3 * tokens * h) + 2 * S * Ls * 8
    return products, other, nbytes


def ssd_chunk_work(seqs, Ls, n, H, hd, backward=False, Q=64) -> tuple[int, int]:
    """The SSD's operations in the chunked form (chunks of Q, the last one
    ragged) for ``seqs`` sequences of ``Ls`` steps: (products, other)."""
    sizes = [Q] * (Ls // Q) + ([Ls % Q] if Ls % Q else [])
    pairs = sum(q * (q + 1) // 2 for q in sizes)
    fed, read = Ls - sizes[0], Ls - sizes[-1]  # steps an earlier chunk feeds; a later reads
    state = 2 * n * hd
    products = pairs * 2 * n + H * (pairs * 2 * hd + (read + fed) * state)
    other = H * (3 * pairs + (len(sizes) - 1) * state)
    if backward:
        products += 2 * pairs * 2 * n + H * (2 * pairs * 2 * hd + 2 * (read + fed) * state)
        other += H * (5 * pairs + 2 * hd * (read + fed) + (len(sizes) - 1) * state)
    return seqs * products, seqs * other


def ssd_mixer_work(M, B, L, h, d, n, H, S, K, prologue=False, Ls=None) -> tuple[int, int, int]:
    """One fused Mamba-2 mixer call of M branches: products (in_proj,
    out_proj, the SSD's), other (conv, the SSD's decays and folds, about 8
    per channel and stream row for gate, norm and merge) and bytes."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    dproj, conv_dim, hd = 2 * d + 2 * n + H, d + 2 * n, d // H
    ssd_products, ssd_other = ssd_chunk_work(M * B * S, Ls, n, H, hd)
    products = M * (2 * tokens * h * dproj + 2 * tokens * d * h) + ssd_products
    other = M * (
        rows * conv_dim * 2 * K  # conv
        + rows * d * 8  # D skip, gate, norm, merge
    ) + ssd_other + (10 * tokens * h if prologue else 0)
    weights = dproj * h + conv_dim * K + conv_dim + 3 * H + d + h * d
    x_bytes = (tokens * h + tokens + 2 * h + 2 * B * h) if prologue else M * tokens * h
    nbytes = 4 * (M * weights + x_bytes + M * tokens * h) + S * L * 8
    return products, other, nbytes


def ssd_mixer_bwd_work(M, B, L, h, d, n, H, S, K, Ls=None) -> tuple[int, int, int]:
    """One fused Mamba-2 mixer backward of M branches: its four GEMMs over
    the token rows, the SSD's products forward and adjoint; the conv again
    and its two adjoints, the SSD's decays, about 30 per channel and stream
    row for gate, norm, D skip and their adjoints; x, g, the residual zx
    and the weights read, gx and the weight gradients written, once."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    dproj, conv_dim, hd = 2 * d + 2 * n + H, d + 2 * n, d // H
    ssd_products, ssd_other = ssd_chunk_work(M * B * S, Ls, n, H, hd, backward=True)
    products = M * (2 * 2 * tokens * d * h + 2 * 2 * tokens * dproj * h) + ssd_products
    other = M * (
        3 * rows * conv_dim * 2 * K  # the conv again and its two adjoints
        + rows * d * 30  # gate, norm, D skip, their adjoints
    ) + ssd_other
    weights = dproj * h + conv_dim * K + conv_dim + 3 * H + d + h * d
    nbytes = M * 4 * (2 * weights + 3 * tokens * h + tokens * dproj) + 2 * S * Ls * 8
    return products, other, nbytes


def mixer_dims(cfg: dict, batch: int) -> dict:
    """The dual-mixer call of one Spiral block at ``batch`` for a config."""
    h, n, K, S = cfg["hidden_size"], cfg["d_state"], 4, 3
    L = (cfg["latent_size"] // cfg["patch_size"]) ** 2
    d = 2 * h
    dims = dict(M=2, B=batch, L=L, h=h, d=d, n=n, S=S, K=K)
    if cfg["mixer"] == "mamba1":
        dims["r"] = -(-h // 16)
    else:
        dims["H"] = d // cfg["headdim"]
    return dims


def mixer_bound_ms(cfg: dict, batch: int, backward: bool) -> float:
    """Least ms of the Spiral block's dual-mixer forward (and, with
    ``backward``, its backward too) at ``batch``: each call's bound, products
    at ``PRODUCT_PEAK``, summed."""
    peak = PRODUCT_PEAK[cfg["dtype"]]
    dims = mixer_dims(cfg, batch)
    if cfg["mixer"] == "mamba1":
        calls = [mixer_work] + ([mixer_bwd_work] if backward else [])
    else:
        calls = [ssd_mixer_work] + ([ssd_mixer_bwd_work] if backward else [])
    return sum(bound_from(*fn(**dims), product_flops=peak)[0] for fn in calls)


def denoiser_flops(cfg: dict, batch: int) -> int:
    """Model FLOPs of one denoiser forward at ``batch``: every linear and
    conv product (2 a multiply-add) and the scans' elementwise work (the
    selective scan 6n + 8 per channel and step, the SSD's recurrence 5n + 8:
    3n for the state update, 2n for C . h, 8 for D skip, gate and norm)."""
    D, depth, p = cfg["hidden_size"], cfg["depth"], cfg["patch_size"]
    C = cfg["in_channels"]
    T = (cfg["latent_size"] // p) ** 2
    tok = batch * T
    d, n, K, S = 2 * D, cfg["d_state"], 4, 3
    rows = S * tok
    flops = 2 * tok * C * p * p * D  # patch embed
    flops += 2 * batch * (256 * D + D * D)  # timestep MLP
    block = 2 * batch * 2 * D * 3 * D  # adaLN
    block += 2 * tok * 2 * D * D + 2 * tok * D  # attention network fc1, fc2
    if cfg["mixer"] == "mamba1":
        r = -(-D // 16)
        mixer = (2 * tok * D * 2 * d + 2 * rows * d * (r + 2 * n) + 2 * rows * r * d
                 + 2 * tok * d * D + rows * d * 2 * K + rows * d * (6 * n + 8))
    else:
        H = d // cfg["headdim"]
        mixer = (2 * tok * D * (2 * d + 2 * n + H) + 2 * tok * d * D
                 + rows * (d + 2 * n) * 2 * K + rows * d * (5 * n + 8))
    flops += depth * (block + 2 * mixer)
    flops += 2 * batch * 2 * D * 2 * D + 2 * tok * D * p * p * 2 * C  # final layer
    return flops


def vae_decode_flops(batch: int, latent: int, ch: int = 128, ch_mult=(1, 2, 4, 4)) -> int:
    """Model FLOPs of the SD-VAE decoder at ``batch`` from a ``latent``² latent:
    every conv (2 per multiply-add) and the mid block's attention products."""
    def conv(cin, cout, k, hw):
        return 2 * hw * cin * cout * k * k

    def resnet(cin, cout, hw):
        return conv(cin, cout, 3, hw) + conv(cout, cout, 3, hw) + (
            conv(cin, cout, 1, hw) if cin != cout else 0)

    hw = latent * latent
    c = ch * ch_mult[-1]
    f = conv(4, 4, 1, hw) + conv(4, c, 3, hw)
    f += 2 * resnet(c, c, hw) + 4 * 2 * hw * c * c + 2 * 2 * hw * hw * c  # mid block
    levels = len(ch_mult)
    for k in range(levels):
        out = ch * ch_mult[levels - 1 - k]
        f += resnet(c, out, hw) + 2 * resnet(out, out, hw)
        c = out
        if k != levels - 1:
            hw *= 4
            f += conv(c, c, 3, hw)
    f += conv(c, 3, 3, hw)
    return batch * f
