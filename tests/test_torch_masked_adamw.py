"""The training step's masked AdamW + EMA update (``ops/masked_adamw.py``).

On the CPU: the plain version against ``torch.optim.AdamW`` and a foreach
EMA over three finite steps; a skipped update,
the first one too (when ``_predicated_update`` makes AdamW's state), leaves
every tensor and every step count as it was, bit for bit; the wrapper's
refusals. On the card (``-m cuda``, skipped elsewhere): the kernel against
the plain version at DiffMa-L/2's parameter shapes, within a few ulps and
1e-7 mean-rel, and a skip that writes nothing.

    python -m pytest --noconftest -m cuda tests/test_torch_masked_adamw.py -q

The file imports neither JAX nor ``diffma_tpu``.
"""

import pytest
import torch
from torch import nn

from diffma_tpu_torch.ops.masked_adamw import masked_adamw, masked_adamw_cuda, masked_adamw_plain
from diffma_tpu_torch.train import state as state_mod
from diffma_tpu_torch.train.state import TrainState, adamw

SHAPES = [(7,), (0,), (3, 5), (4, 4, 3), (1,), (33,)]
HYPER = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
MAX_ULPS = 4  # the kernel against its plain version on the card


def _tensors(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen) for s in shapes]


def _plain_state(params):
    """(grads, exp_avgs, exp_avg_sqs, steps, emas) as the step makes them."""
    return ([None] * len(params), [torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params],
            [torch.zeros((), dtype=torch.float32) for _ in params], [p.clone() for p in params])


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_plain_version_matches_torch_adamw_and_update_ema(weight_decay):
    """The (33,) tensor has no gradient: AdamW leaves it, the EMA takes it."""
    start = _tensors(SHAPES, 0)
    alone = SHAPES.index((33,))
    model = nn.ParameterList([nn.Parameter(p.clone()) for p in start])
    ema = nn.ParameterList([nn.Parameter(p.clone(), requires_grad=False) for p in start])
    opt = torch.optim.AdamW(model.parameters(), weight_decay=weight_decay, capturable=False,
                            **HYPER)
    params = [p.clone() for p in start]
    grads, m, v, steps, emas = _plain_state(params)
    m[alone] = v[alone] = steps[alone] = None
    keep = torch.tensor(True)
    for i in range(3):
        grads = _tensors(SHAPES, 10 + i)
        grads[alone] = None
        for p, g in zip(model.parameters(), grads):
            p.grad = None if g is None else g.clone()
        opt.step()
        with torch.no_grad():  # ema = 0.999 ema + 0.001 p, the sum fused as the update's
            torch._foreach_mul_(list(ema), 0.999)
            torch._foreach_add_(list(ema), list(model), alpha=1 - 0.999)
        masked_adamw_plain(keep, params, grads, m, v, steps, emas, weight_decay=weight_decay,
                           ema_decay=0.999, **HYPER)
    # torch's AdamW takes m by lerp, m + (1 - b1) (g - m), the update as
    # b1 m + (1 - b1) g: where the two terms cancel they part by an ulp of
    # the operands, so the bar is 1e-6 of each element and of the tensor's
    # largest.
    for i, p in enumerate(model.parameters()):
        st = opt.state[p]
        pairs = [(params[i], p), (emas[i], ema[i])]
        if i != alone:
            pairs += [(m[i], st["exp_avg"]), (v[i], st["exp_avg_sq"]), (steps[i], st["step"])]
        for got, want in pairs:
            want = want.detach()
            scale = float(want.abs().max()) if want.numel() else 0.0
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
    assert not opt.state[model[alone]] and torch.equal(params[alone], start[alone])
    assert all(float(s) == 3.0 for s in steps if s is not None)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("first", [True, False])
def test_skipped_update_leaves_every_tensor_as_it_was(first):
    """Through ``_predicated_update``: NaN gradients and ``keep`` false, on
    the first update (AdamW's state made there, zero) or after two."""
    model = nn.Sequential(nn.Linear(5, 3), nn.Linear(3, 1))
    opt = adamw(model.parameters(), 1e-3)
    state = TrainState(model, opt)
    params = list(model.parameters())

    def update(keep, fill=None):
        for i, p in enumerate(params):
            p.grad = (torch.full_like(p, fill) if fill is not None
                      else torch.randn(p.shape, generator=torch.Generator().manual_seed(i)))
        state_mod._predicated_update(state, opt, torch.tensor(keep), params, 0.999)

    if not first:
        update(True)
        update(True)
    before = ([p.detach().clone() for p in params] + [e.clone() for e in state.ema.parameters()]
              + [t.clone() for p in params for t in opt.state[p].values()])
    update(False, fill=float("nan"))
    after = ([p.detach() for p in params] + list(state.ema.parameters())
             + [t for p in params for t in opt.state[p].values()])
    assert len(after) == 5 * len(params) == len(before) + first * 3 * len(params)
    if first:  # made in the skipped update, as it would have been made in a kept one
        assert all(float(opt.state[p]["step"]) == 0 and not opt.state[p]["exp_avg"].any()
                   and not opt.state[p]["exp_avg_sq"].any() for p in params)
    for a, b in zip(after, before):
        assert torch.equal(_bits(a), _bits(b))


def _case(dtype=torch.float32, device="cpu"):
    params = [torch.zeros(6, dtype=dtype, device=device), torch.zeros(3, 4)]
    grads = [torch.zeros_like(p) for p in params]
    _, m, v, steps, emas = _plain_state(params)
    return [torch.tensor(True), params, grads, m, v, steps, emas]


@pytest.mark.parametrize("fault,match", [
    ("bf16", "float32"), ("noncontiguous", "contiguous"), ("device", "is on meta"),
    ("no state", "lacks AdamW's state")])
def test_masked_adamw_refuses(fault, match):
    args = _case()
    if fault == "bf16":
        args[1][0] = args[1][0].bfloat16()
    elif fault == "noncontiguous":
        args[1][1] = torch.zeros(4, 3).t()
        args[2][1] = torch.zeros(4, 3).t()
    elif fault == "device":
        args[1][0] = torch.zeros(6, device="meta")
    else:
        args[3][0] = None
    with pytest.raises(ValueError, match=match):
        masked_adamw(*args, **HYPER)


def test_masked_adamw_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(ValueError, match="CUDA tensors"):
        masked_adamw_cuda(*_case(), weight_decay=0.0, ema_decay=0.999, **HYPER)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ordered(t):
    """fp32 bits as integers in the order of the values."""
    i = t.view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


@pytest.mark.cuda
@pytest.mark.parametrize("use_mamba2", [False, True])
def test_kernel_matches_plain_at_l2_shapes(cuda, use_mamba2):
    """Every seventh tensor takes the EMA alone, and the largest lies 4
    bytes off 16-byte alignment (the element-by-element path)."""
    from diffma_tpu_torch.models.diffma import build_model

    shapes = [p.shape for p in build_model("DiffMa-L/2", input_size=28,
                                           use_mamba2=use_mamba2).parameters()]
    big = max(range(len(shapes)), key=lambda i: shapes[i].numel())
    gen = torch.Generator(device=cuda).manual_seed(5)

    def draw(scale=1.0):
        return [scale * torch.randn(s, generator=gen, device=cuda) for s in shapes]

    start, grads, m, ema = draw(), draw(), draw(0.1), draw()
    v = [x.square() for x in draw(0.1)]
    steps = [torch.full((), 3.0, device=cuda) for _ in shapes]
    for i in range(3, len(shapes), 7):
        grads[i] = m[i] = v[i] = steps[i] = None

    def place(x, i):
        if x is None or i != big:
            return None if x is None else x.clone()
        return torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x)

    sides = []
    for fn in (masked_adamw_cuda, masked_adamw_plain):
        args = [[place(x, i) for i, x in enumerate(xs)] for xs in (start, grads, m, v, steps, ema)]
        assert args[0][big].data_ptr() % 16 == 4
        before = [[x.clone() for x in xs if x is not None] for xs in args]
        fn(torch.tensor(False, device=cuda), *args, weight_decay=0.0, ema_decay=0.999, **HYPER)
        for xs, ys in zip(args, before):
            assert all(torch.equal(_bits(x), _bits(y))
                       for x, y in zip([x for x in xs if x is not None], ys))
        fn(torch.tensor(True, device=cuda), *args, weight_decay=0.0, ema_decay=0.999, **HYPER)
        sides.append([torch.cat([x.flatten() for x in xs if x is not None]) for xs in args])
    torch.cuda.synchronize()
    assert not torch.equal(sides[0][0], torch.cat([x.flatten() for x in start]))
    for got, want in zip(*sides):
        assert (_ordered(got) - _ordered(want)).abs().max() <= MAX_ULPS
        assert ((got - want).abs().mean() / want.abs().mean()) <= 1e-7
