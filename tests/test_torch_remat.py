"""``remat``: recomputing each block in the backward changes memory, not math.

The port's counterpart of the JAX package's ``tests/test_remat.py``, held to
equal bits: the plain versions that a CPU tensor takes are deterministic, as
the card's kernels are, so the recomputed forward gives the bits of the
first and the gradients those without ``remat``. Four block kinds: the
Spiral block on Mamba-1 and on Mamba-2 (the composable route and the fused
one, whose autograd Functions run their forward again under the
checkpoint), a single-mixer family (zig) and DiT; then three trainer steps.
"""

import numpy as np
import pytest
import torch

from diffma_tpu_torch.models.diffma import DiffMa
from diffma_tpu_torch.train import train
from diffma_tpu_torch.utils.config import Config

HIDDEN, DEPTH, INPUT, BATCH = 32, 3, 8, 2  # depth 3: the last block reads a U-skip
TOKENS = (INPUT // 2) ** 2

KINDS = {
    "spiral-mamba1-auto": dict(block_type="spiral", scan_impl="auto"),
    "spiral-mamba1-fused": dict(block_type="spiral", scan_impl="fused"),
    "spiral-mamba2-auto": dict(block_type="spiral", scan_impl="auto", use_mamba2=True),
    "spiral-mamba2-fused": dict(block_type="spiral", scan_impl="fused", use_mamba2=True),
    "zig-fused": dict(block_type="zig", scan_impl="fused"),
    "dit": dict(block_type="DiT"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(kind):
    """The model without and with ``remat``, with the same weights: the
    init, with every tensor moved off it so that every block acts."""
    kw = dict(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=DEPTH, d_state=8,
              **KINDS[kind])
    plain = DiffMa(**kw).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in plain.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    remat = DiffMa(remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    return plain, remat


def _inputs():
    g = torch.Generator().manual_seed(2)
    return (torch.randn(BATCH, 4, INPUT, INPUT, generator=g), torch.tensor([3, 500]),
            torch.randn(BATCH, HIDDEN, generator=g), torch.randn(BATCH, TOKENS, HIDDEN, generator=g),
            torch.sigmoid(torch.randn(BATCH, TOKENS, 1, generator=g)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_remat_gives_the_same_forward_and_gradients(kind):
    plain, remat = _models(kind)
    args = _inputs()
    calls = {id(plain): 0, id(remat): 0}
    for model in (plain, remat):
        for block in model.blocks:
            block.register_forward_pre_hook(
                lambda *_, key=id(model): calls.__setitem__(key, calls[key] + 1))
    outs = []
    for model in (plain, remat):
        x = args[0].clone().requires_grad_(True)
        out = model(x, *args[1:])
        (out.square().sum()).backward()
        outs.append((out.detach(), x.grad, {n: p.grad for n, p in model.named_parameters()}))
    (out_a, gx_a, g_a), (out_b, gx_b, g_b) = outs
    assert (calls[id(plain)], calls[id(remat)]) == (DEPTH, 2 * DEPTH)  # recomputed in backward
    assert torch.equal(out_a, out_b)
    assert torch.equal(gx_a, gx_b)
    assert g_a.keys() == g_b.keys()
    for name, g in g_a.items():
        assert torch.equal(g, g_b[name]), name
    assert sum(int(g.abs().sum() > 0) for g in g_a.values()) > len(g_a) // 2
    with torch.no_grad():  # no graph to save: remat steps aside
        assert torch.equal(remat(*args), out_a)


def test_trainer_with_remat_gives_the_same_run(tmp_path):
    """Three steps of the trainer, ``remat`` on and off: the same losses and
    the same parameters, EMA and AdamW moments, in bits."""
    runs = []
    for remat in (False, True):
        cfg = Config(epochs=1, log_every=10, ckpt_every=100, lr=1e-3, model="DiffMa-S/2",
                     image_size=64, global_batch_size=BATCH, hidden_size=HIDDEN,
                     synthetic_data=True, synthetic_dataset_size=6, max_steps=3,
                     return_loss_history=True, remat=remat,
                     results_dir=str(tmp_path / f"r{int(remat)}"))
        runs.append(train.main(cfg, device="cpu"))
    (a, ha), (b, hb) = runs
    assert b.model.remat and not a.model.remat and int(a.step) == int(b.step) == 3
    np.testing.assert_array_equal(ha["loss"], hb["loss"])
    for ma, mb in ((a.model, b.model), (a.ema, b.ema)):
        for (name, pa), pb in zip(ma.state_dict().items(), mb.state_dict().values()):
            assert torch.equal(pa, pb), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[pa][k], b.optimizer.state[pb][k])
