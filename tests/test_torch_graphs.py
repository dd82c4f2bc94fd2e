"""The port's graphed sampling chain and training step, on the CPU.

A CUDA graph needs the card; ``utils/graphs.py`` raises elsewhere, and so
does everything built on it. What the CPU can hold is the logic around the
capture: here ``EagerGraph`` stands in for ``Graph``, recording the captured
call and running it again at each replay, so that the chain's and the
step's static buffers, their warm-up step and their replays are held, bit
for bit, against the eager loop and the eager step on the same seeds. On
the card ``chip_smoke.py`` phase 18 holds the real graphs against the eager
runs.
"""

import functools
import types

import numpy as np
import pytest
import torch

from diffma_tpu_torch.diffusion import create_diffusion
from diffma_tpu_torch.diffusion import gaussian
from diffma_tpu_torch.diffusion.gaussian import ChainGraph
from diffma_tpu_torch.models.diffma import DiffMa
from diffma_tpu_torch.train import sample, state as state_mod, train
from diffma_tpu_torch.train.state import GraphedTrainStep, TrainState, adamw, make_train_step
from diffma_tpu_torch.utils.config import Config
from diffma_tpu_torch.utils.graphs import Graph

HIDDEN, DEPTH, INPUT, BATCH = 32, 2, 8, 2
TOKENS = (INPUT // 2) ** 2


class EagerGraph:
    """``Graph`` on the CPU: ``capture`` records the call and runs nothing,
    ``replay`` runs it; a dict result is the static output that each replay
    refills."""

    captures = 0
    capture_seconds = pool_bytes = None

    def __init__(self, device, pool=None, name=None):
        self.graph = None
        self.pool = pool if pool is not None else object()

    def warm_up(self, fn, *args, **kw):
        return fn(*args, **kw)

    def capture(self, fn, *args, **kw):
        EagerGraph.captures += 1
        self.graph, self.out = functools.partial(fn, *args, **kw), {}
        return self.out

    def replay(self):
        out = self.graph()
        if isinstance(out, dict):
            self.out.clear()
            self.out.update(out)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tests: they are many small operators,
    each of which, beside the suite's other workers, would otherwise wait
    on a parallel region's threads for busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def eager_graphs(monkeypatch):
    monkeypatch.setattr(gaussian, "Graph", EagerGraph)
    monkeypatch.setattr(state_mod, "Graph", EagerGraph)
    EagerGraph.captures = 0
    return EagerGraph


def test_graphs_raise_on_the_cpu():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Graph("cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ChainGraph("cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphedTrainStep(lambda *a: None, torch.device("cpu"))


def _model(seed=0):
    model = DiffMa(input_size=INPUT, patch_size=2, hidden_size=HIDDEN, depth=DEPTH)
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # open the zero-initialised gates, so that every block acts
        g = torch.Generator().manual_seed(seed + 1)
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _kwargs(n, seed=5):
    g = torch.Generator().manual_seed(seed)
    return {"y": torch.randn(n, HIDDEN, generator=g),
            "y2": torch.randn(n, TOKENS, HIDDEN, generator=g),
            "w": torch.sigmoid(torch.randn(n, TOKENS, 1, generator=g))}


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_step_noise_in_the_eager_order_gives_the_eager_chain(loop):
    """The T step noises drawn before the chain, in the eager loop's order,
    give its bits."""
    model = _model().eval()
    diffusion = create_diffusion("6", device="cpu")
    shape, kw = (BATCH, 4, INPUT, INPUT), _kwargs(BATCH)
    run = getattr(diffusion, loop)
    want = run(model, shape, torch.Generator().manual_seed(3), model_kwargs=kw)
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(shape, generator=gen)
    steps = [torch.randn(shape, generator=gen) for _ in range(diffusion.num_timesteps)]
    got = run(model, shape, None, noise=noise, model_kwargs=kw, step_noise=steps)
    assert torch.equal(got, want)


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_chain_graph_replays_give_the_eager_chain(eager_graphs, loop):
    """One ChainGraph over two chains: the first warms up on step 0,
    captures once and replays the other steps; the second replays every
    step from new start noise and conditioning; both give the eager bits."""
    model = _model().eval()
    diffusion = create_diffusion("5", device="cpu")
    shape = (BATCH, 4, INPUT, INPUT)
    run = getattr(diffusion, loop)
    chain = ChainGraph("cpu")
    for seed in (3, 4):
        kw = _kwargs(BATCH, seed + 10)
        want = run(model, shape, torch.Generator().manual_seed(seed), model_kwargs=kw)
        got = run(model, shape, torch.Generator().manual_seed(seed), model_kwargs=kw, graph=chain)
        assert torch.equal(got, want)
    assert eager_graphs.captures == 1
    with pytest.raises(ValueError, match="this graph samples"):
        run(model, (1, 4, INPUT, INPUT), torch.Generator().manual_seed(0),
            model_kwargs=_kwargs(1), graph=chain)


def test_graphed_sampler_gives_the_eager_images(eager_graphs, tmp_path):
    """``sample_batches`` with its chains graphed: batches of 2, 2 and a
    short last one of 1, which takes its own capture in the first one's
    pool; the images equal the eager sampler's."""
    cfg = Config(model="DiffMa-S/2", image_size=32, hidden_size=HIDDEN, sample_num_steps=3,
                 sample_global_batch_size=2, synthetic_data=True, synthetic_dataset_size=5,
                 save_dir=str(tmp_path), seed=0)
    model = sample.load_model(cfg, "cpu")
    want = sample.sample_batches(model, cfg, "cpu")
    got = sample.sample_batches(model, cfg, "cpu", graphed=True)
    assert [r["images"].shape[0] for r in got] == [2, 2, 1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["images"], b["images"])
    assert eager_graphs.captures == 2
    assert [("capture_seconds" in r) for r in got] == [True, False, True]


def _batches(n, nan_at=None, seed=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        b = {"z": f(BATCH, 4, INPUT, INPUT), "y": f(BATCH, HIDDEN), "y2": f(BATCH, TOKENS, HIDDEN),
             "w": torch.sigmoid(f(BATCH, TOKENS, 1))}
        if i == nan_at:
            b["z"][0, 0, 0, 0] = float("nan")
        out.append(b)
    return out


def _trainer(graphed: bool):
    model = _model(7).train()
    optimizer = adamw(model.parameters(), 1e-3)
    state = TrainState(model, optimizer)
    diffusion = create_diffusion("", device="cpu")
    step = make_train_step(train.make_loss_fn(model, diffusion), optimizer)
    return state, (GraphedTrainStep(step, "cpu") if graphed else step), diffusion


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _tensors(state):
    opt = state.optimizer
    return ([p.detach().clone() for p in state.model.parameters()]
            + [p.clone() for p in state.ema.parameters()]
            + [v.clone() for p in state.model.parameters() for v in opt.state[p].values()]
            + [state.step.clone()])


def test_graphed_step_gives_the_eager_steps(eager_graphs):
    """Five steps with a NaN batch at the third, through GraphedTrainStep
    (warm-up, one capture, replays; t and noise drawn by ``loss_draws``)
    and through the eager step with the loss's own draws: the same bits in
    every parameter, EMA and optimizer tensor and the step count, and the
    same metrics."""
    (s_eager, eager, diffusion), (s_graph, graphed, _) = _trainer(False), _trainer(True)
    g_eager, g_graph = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    for i, b in enumerate(_batches(5, nan_at=2)):
        want = eager(s_eager, b, g_eager)
        b = dict(b)
        b["t"], b["noise"] = train.loss_draws(diffusion, b["z"], g_graph)
        got = graphed(s_graph, b, g_graph)
        assert set(got) == set(want) == {"loss", "finite", "mse", "vb"}
        for k in want:
            assert torch.equal(got[k], want[k]) or (i == 2 and k != "finite"), (i, k)
        assert bool(got["finite"]) == (i != 2)
        for a, b_ in zip(_tensors(s_graph), _tensors(s_eager)):
            assert torch.equal(_bits(a), _bits(b_))
    assert int(s_graph.step) == 4 and eager_graphs.captures == 1
    with pytest.raises(ValueError, match="carries its t and noise"):
        graphed(s_graph, _batches(1)[0], g_graph)
    other, _, _ = _trainer(False)
    b = _batches(1)[0]
    b["t"], b["noise"] = train.loss_draws(diffusion, b["z"], g_graph)
    with pytest.raises(ValueError, match="one TrainState"):
        graphed(other, b, g_graph)


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_nan_batch_leaves_every_tensor_as_it_was(accumulation_steps):
    """After a NaN batch the parameters, the EMA, every optimizer tensor,
    the sums of gradients and the step count are bit for bit what they were."""
    model = _model(9).train()
    optimizer = adamw(model.parameters(), 1e-3)
    state = TrainState(model, optimizer)
    step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")),
                           optimizer, accumulation_steps=accumulation_steps)
    gen = torch.Generator().manual_seed(2)
    good, bad = _batches(2, nan_at=1)
    assert bool(step(state, good, gen)["finite"])
    before = _tensors(state) + [a.clone() for a in state.accum_grads or []]
    metrics = step(state, bad, gen)
    assert metrics["finite"].dtype == torch.bool and not bool(metrics["finite"])
    after = _tensors(state) + list(state.accum_grads or [])
    assert len(after) == len(before) > 3 * len(list(model.parameters()))
    for a, b in zip(after, before):
        assert torch.equal(_bits(a), _bits(b))
    assert int(state.step) == 1


def test_first_step_skipped_leaves_a_fresh_optimizer():
    """A NaN first batch: AdamW's state, made in that step, is zeros, and
    the next step's update is the update of a first step."""
    results = []
    for batches in (_batches(2, nan_at=0), _batches(2)[1:]):
        model = _model(11).train()
        optimizer = adamw(model.parameters(), 1e-3)
        state = TrainState(model, optimizer)
        step = make_train_step(train.make_loss_fn(model, create_diffusion("", device="cpu")),
                               optimizer)
        good = _batches(2)[1]
        for b in batches:
            b = dict(b)
            b["t"], b["noise"] = torch.tensor([5, 700]), torch.ones_like(good["z"])
            step(state, b, None)
        results.append(_tensors(state))
    for a, b in zip(*results):
        assert torch.equal(_bits(a), _bits(b))


def test_loss_draws_are_the_losses_own():
    model = _model().train()
    diffusion = create_diffusion("", device="cpu")
    loss_fn = train.make_loss_fn(model, diffusion)
    b = _batches(1)[0]
    want, _ = loss_fn(b, torch.Generator().manual_seed(6))
    t, noise = train.loss_draws(diffusion, b["z"], torch.Generator().manual_seed(6))
    got, _ = loss_fn({**b, "t": t, "noise": noise}, None)
    assert torch.equal(got, want)


def test_cuda_optimizer_must_keep_its_state_on_the_device():
    optimizer = types.SimpleNamespace(
        param_groups=[{"params": [types.SimpleNamespace(is_cuda=True)], "capturable": False}])
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_step(lambda b, g: None, optimizer)
