"""Each cell driven end to end at toy size on the CPU (the harness's look
for a card skipped): its last line, its faults and its control; and on the
card, a short run of each cell."""

import argparse
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.harness.checks import Check  # noqa: E402

TOY = {"config": {"model": "DiffMa-S/2", "hidden_size": 64, "depth": 4, "latent_size": 8,
                  "image_size": 64, "vae_ch": 32, "vae_ch_mult": [1, 1, 1, 1]},
       "traffic": {"batch": 2, "warmup_steps": 1, "trace_steps": 2, "steps": 10,
                   "warmup_requests": 1}}
TRAIN = ["diffma-l2-m1.train-b8", "diffma-l2-m2.train-b8"]
SAMPLE = ["diffma-l2-m1.sample-ddpm250-b1"]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def toy(cell, seed=7, trace=0, control=False, seconds=0.5):
    opts = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace, toy=True,
                              control=control)
    return run.measure(opts, overrides=TOY)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", TRAIN + SAMPLE)
def test_toy_run_prints_the_contract_keys_and_is_correct(cell, trace):
    line = json.loads(json.dumps(toy(cell, trace=trace)["line"]))
    assert list(line) == KEYS  # checks last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace == 0:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    else:  # no device number from a CPU run
        assert line["metrics"] == {}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def _fails(result):
    return result["line"]["correct"] is False


def test_fault_step_returns_state_unchanged(monkeypatch):
    from diffma_tpu_torch.train import state

    monkeypatch.setattr(state, "_predicated_update", lambda *a, **k: None)
    result = toy(TRAIN[0])
    assert _fails(result) and result["outcome"]["values"]["change_gap"] == pytest.approx(1.0)


def test_fault_half_batch_left_out(monkeypatch):
    from diffma_tpu_torch.train import train

    make = train.make_loss_fn

    def half(model, diffusion):
        loss_fn = make(model, diffusion)
        return lambda batch, gen: loss_fn({k: v[: len(v) // 2] for k, v in batch.items()}, gen)

    monkeypatch.setattr(train, "make_loss_fn", half)
    assert _fails(toy(TRAIN[1]))


def test_fault_loss_altered_where_it_is_produced(monkeypatch):
    from diffma_tpu_torch.diffusion.gaussian import GaussianDiffusion

    losses = GaussianDiffusion.training_losses

    def altered(self, *a, **k):
        terms = losses(self, *a, **k)
        return dict(terms, loss=terms["loss"] * 1.01)

    monkeypatch.setattr(GaussianDiffusion, "training_losses", altered)
    assert _fails(toy(TRAIN[0]))


def test_fault_chain_step_returns_its_state_unchanged(monkeypatch):
    from diffma_tpu_torch.diffusion.gaussian import GaussianDiffusion

    step = GaussianDiffusion.p_sample

    def unchanged(self, model, x, t, *a, **k):
        out = step(self, model, x, t, *a, **k)
        return dict(out, sample=x + 0 * out["sample"])

    monkeypatch.setattr(GaussianDiffusion, "p_sample", unchanged)
    assert _fails(toy(SAMPLE[0]))


def test_fault_image_altered_where_it_is_produced(monkeypatch):
    from diffma_tpu_torch.models.vae import AutoencoderKL

    decode = AutoencoderKL.decode
    monkeypatch.setattr(AutoencoderKL, "decode",
                        lambda self, z: decode(self, z) * (1 + 1e-2))
    result = toy(SAMPLE[0])
    assert _fails(result) and result["outcome"]["values"]["decode_gap"] > 1e-3


@pytest.mark.parametrize("cell", TRAIN + SAMPLE)
def test_tf32_control_is_not_correct(cell):
    result = toy(cell, control=True)
    limits = result["cell"].limits
    control = result["outcome"]["control"]["tf32"]
    assert not all(Check(k, control[k], limits[k]).ok for k in limits), control
    assert result["line"]["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN + SAMPLE)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
