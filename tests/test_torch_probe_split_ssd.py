"""The port's split-SSD probe against the JAX probe, ``tools/probes/``.

``tools/probes/probe_split_ssd.py`` holds the last TPU kernel of the repo,
``_core_kernel`` (the SSD core of the split form of the dual Mamba-2 mixer);
on the CPU it runs in interpret mode. Its port is kernel P,
``ops/fused_ssd.py::ssd_core_cuda``, whose plain version ``ssd_core_ref``
the CPU takes, and ``tools/probes/probe_split_ssd_torch.py`` is the probe's
port. Same numpy inputs and weights (the probe's scales) on both sides, full
width, fp32; tolerance 2e-5 * max(1, max |ref|), the fused mixers' CPU bar.
Both probes are loaded by path.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffma_tpu_torch.ops.fused_ssd import ssd_core_ref

PROBES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                      "probes")
TOL = 2e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(PROBES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def probes():
    return _load("probe_split_ssd"), _load("probe_split_ssd_torch")


def _weights(jp, seed):
    """The JAX probe's weights (its layout and scales) drawn with numpy."""
    rng = np.random.default_rng(seed)
    u = lambda s, sc: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return (u((2, jp.h, jp.dproj), 0.03), u((2, jp.conv_dim, jp.K), 0.3), u((2, jp.conv_dim), 0.1),
            u((2, jp.H), 0.1), u((2, jp.H), 0.5), np.ones((2, jp.H), np.float32),
            np.ones((2, jp.d), np.float32), u((2, jp.d, jp.h), 0.03))


def _bar(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def test_split_form_matches_jax_probe(probes):
    """The port's split form (plain P on the CPU) against the JAX probe's
    ``split_dual`` (``_core_kernel`` in interpret mode) at batch 1."""
    jp, tp = probes
    w = _weights(jp, 0)
    x12 = (np.random.default_rng(1).standard_normal((2, 1, jp.L0, jp.h)) * 0.5).astype(np.float32)
    want = np.asarray(jp.split_dual(jnp.asarray(x12), tuple(map(jnp.asarray, w))))
    ws = tp.mixer_weights(tuple(map(torch.from_numpy, w)))
    with torch.no_grad():
        got = tp.split_dual(torch.from_numpy(x12), ws).numpy()
        whole = tp.whole_dual(torch.from_numpy(x12), ws).numpy()
    assert got.shape == want.shape == (2, 1, jp.L0, jp.h)
    assert np.abs(got - want).max() <= _bar(want)
    assert np.abs(whole - want).max() <= _bar(want)  # the whole mixer agrees too


def core_inputs(jp, seed=2):
    """The probe's weights and 6 gathered streams (B = 1, both branches, 3
    streams) of zx, drawn with numpy."""
    zx = np.random.default_rng(seed + 1).standard_normal((6, jp.L0, jp.dproj)) * 0.3
    return _weights(jp, seed), zx.astype(np.float32)


def jax_core(jp, w, zx, dtype=jnp.float32):
    """The JAX kernel ``_core_kernel`` in interpret mode on zx in ``dtype``,
    its rows padded to 200 as the probe pads them (after each stream: the
    conv is causal); rows 0-195, as float32."""
    G, L = zx.shape[:2]
    Lp = 200
    padded = np.concatenate([zx, np.zeros((G, Lp - L, jp.dproj), np.float32)], axis=1)
    in_w, conv_w, conv_b, dt_bias, A_log, D, norm_w, _ = map(jnp.asarray, w)
    kern = functools.partial(jp._core_kernel, L=Lp, eps=1e-5, dt_lo=0.0, dt_hi=float("inf"),
                             per_branch=G // 2)
    full = lambda i: (0, 0, 0)  # noqa: E731
    wspecs = [pl.BlockSpec((2,) + s, full)
              for s in ((jp.K, jp.conv_dim), (1, jp.conv_dim), (1, jp.H), (1, jp.H), (1, jp.H),
                        (1, jp.d))]
    want = pl.pallas_call(
        kern, grid=(G,),
        in_specs=[pl.BlockSpec((1, Lp, jp.dproj), lambda i: (i, 0, 0)), *wspecs],
        out_specs=pl.BlockSpec((1, Lp, jp.d), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((G, Lp, jp.d), dtype),
        scratch_shapes=[jp.pltpu.VMEM((Lp, jp.conv_dim), jnp.float32),
                        jp.pltpu.VMEM((Lp, jp.H), jnp.float32),
                        jp.pltpu.VMEM((Lp, jp.d), jnp.float32)],
        interpret=True,
    )(jnp.asarray(padded).astype(dtype), jnp.swapaxes(conv_w, -1, -2), conv_b[:, None],
      dt_bias[:, None], -jnp.exp(A_log)[:, None], D[:, None], norm_w[:, None])
    return np.asarray(want.astype(jnp.float32))[:, :L]


def test_ssd_core_ref_matches_jax_core_kernel(probes):
    """``ssd_core_ref`` on 6 gathered streams (B = 1, both branches, 3
    streams) against the JAX kernel on the same rows padded to 200 as the
    probe pads them (after each stream: the conv is causal), rows 0-195."""
    jp, tp = probes
    w, zx = core_inputs(jp)
    want = jax_core(jp, w, zx)
    ws = tp.mixer_weights(tuple(map(torch.from_numpy, w)))
    got = ssd_core_ref(torch.from_numpy(zx), ws).numpy()
    assert got.shape == want.shape == (6, jp.L0, jp.d)
    assert np.abs(got - want).max() <= _bar(want)


def test_probe_tool_runs_on_cpu(probes):
    """The probe tool's entry point with ``--device cpu --batch 1``: bf16,
    then fp32, as the JAX probe; both forms take their plain versions, agree
    (fp32 here, bf16's bars in ``tests/test_torch_bf16_tail.py``), and no
    time is taken."""
    _, tp = probes
    res = tp.main(["--device", "cpu", "--batch", "1"])
    assert list(res) == ["bfloat16", "float32"]
    assert np.isfinite(res["bfloat16"]["max_abs_diff"]) and "whole_ms" not in res["bfloat16"]
    out = res["float32"]
    assert np.isfinite(out["max_abs_ref"]) and out["max_abs_ref"] > 0.1
    assert out["max_abs_diff"] <= TOL * max(1.0, out["max_abs_ref"])
    assert "whole_ms" not in out and "split_ms" not in out
