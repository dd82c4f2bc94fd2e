#!/usr/bin/env python3
"""Why does kernel F's card case at a clipping dt_limit fail now and then?

The case is ``tests/test_torch_cuda_kernels.py::test_fused_ssd_bwd_matches_plain``
with the parameters ("spiral", 14, 2, 1, (0.5, 0.9), False): spiral layer 2,
batch 1, 196 tokens, a dt_limit that clips some steps and not others. This
tool builds that case's inputs with the test's own helpers and tests the
three candidate causes of a result that changes from one process to the
next:

* an unwritten workspace: kernel E's residual and every buffer that E and F
  allocate are filled with NaN, then with a finite pattern, and F's outputs
  are compared bit for bit with an unpoisoned call;
* the plain version's order of sums: ``ssd_mixer_bwd_ref`` twice in a
  process, and its hash across processes; it is also held against an fp64
  run of itself;
* the clip edge: the steps whose softplus lies within one ulp of a limit,
  and those where the fp32 and fp64 softplus fall on different sides.

One process, ``calls`` calls of F, each held against the fp32 reference to
the test's bar (every gradient's max |err| beside its bar, and where it
lies when a call fails):

    python tools/port_f_fault.py once --calls 30 --out x.json

``procs`` fresh processes of ``once``, ``par`` at a time, and a summary:

    python tools/port_f_fault.py run --procs 30 --par 6 --calls 30 --out dir

The test builds its mixers with the modules' default init, which draws from
torch's global generator; torch seeds that anew in every process, so without
a seed every process draws other weights (the test's ``cuda`` fixture seeds
it with 0; ``--seeded`` does the same here). ``draws`` runs the case at
``count`` seeded draws, F once and the plain version in fp32 and fp64 per
draw, and counts the steps whose dt F's in_proj and the plain version's put
on different sides of a limit:

    python tools/port_f_fault.py draws --count 200 --out x.json

It needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = ("spiral", 14, 2, 1, (0.5, 0.9))


def _tests():
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(ROOT, "tests", "test_torch_cuda_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hash(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _poisoned(value: float):
    """Every ``torch.empty``/``torch.empty_like`` inside, filled with ``value``."""
    import torch

    empty, empty_like = torch.empty, torch.empty_like

    def fill(t):
        if t.is_floating_point():
            t.fill_(value)
        return t

    torch.empty = lambda *a, **k: fill(empty(*a, **k))
    torch.empty_like = lambda *a, **k: fill(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def once(calls: int, out: str, seeded: bool = False) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F

    from diffma_tpu_torch.ops.fused_ssd import (
        Mamba2Weights,
        ssd_mixer_bwd_ref,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    t = _tests()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family, grid_n, layer, batch, dt_limit = CASE
    spec = build_scan_spec(family, grid_n, layer)
    if seeded:
        torch.manual_seed(0)  # as the test's `cuda` fixture seeds it
    mixers = t._mixers2(dev, spec, seed=layer)
    ws = [m.weights() for m in mixers]
    L = grid_n * grid_n
    xs = [t._x(dev, L, 60 + i, batch) for i in range(2)]
    gs = [t._x(dev, L, 70 + i, batch) for i in range(2)]

    def grads_of(gxs, gws, ms):
        got = {}
        for m, gx, gw in zip(ms, gxs, gws):
            got[f"gx{m}"] = gx
            got.update({f"w{m}.{f}": v for f, v in zip(Mamba2Weights._fields, gw)})
        return got

    def ref(dtype):
        want = {}
        for m in range(2):
            cast = lambda v: v.to(dtype)  # noqa: E731
            gx, gw = ssd_mixer_bwd_ref(spec, cast(xs[m]), cast(gs[m]),
                                       Mamba2Weights(*(cast(v) for v in ws[m])), dt_limit)
            want.update(grads_of([gx], [gw], [m]))
        return want

    want = ref(torch.float32)
    want2 = ref(torch.float32)
    want64 = ref(torch.float64)
    names = sorted(want)
    rep = {
        "ref_hash": _hash(want[k] for k in names),
        "ref_equal_twice": all(torch.equal(want[k], want2[k]) for k in names),
        "ref32_vs_64": {k: (want[k].double() - want64[k]).abs().max().item() for k in names},
    }

    def run_f(M):
        with torch.no_grad():
            _, res = ssd_mixer_fused_cuda(spec, xs[2 - M:], ws[2 - M:], dt_limit, want_res=True)
        gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs[2 - M:], gs[2 - M:], ws[2 - M:], res, dt_limit)
        torch.cuda.synchronize()
        return grads_of(gxs, gws, range(2 - M, 2))

    def check(got, against):
        worst, fails = 0.0, []
        for k, a in got.items():
            w = against[k]
            tol = t.GRAD_TOL * max(1.0, w.abs().max().item())
            diff = (a.float() - w.float()).abs()
            err = diff.max().item() if torch.isfinite(a).all() else float("inf")
            worst = max(worst, err / tol)
            if not err <= tol:
                idx = [int(i) for i in torch.unravel_index(diff.argmax(), diff.shape)]
                fails.append({"grad": k, "err": err, "bar": tol, "at": idx,
                              "got": a.flatten()[diff.argmax()].item(),
                              "want": w.flatten()[diff.argmax()].item(),
                              "err64": (a.double() - want64[k]).abs().max().item()})
        return worst, fails

    runs = []
    for i in range(calls):
        for M in (2, 1):
            got = run_f(M)
            worst, fails = check(got, want)
            runs.append({"call": i, "M": M, "hash": _hash(got[k] for k in sorted(got)),
                         "worst_err_over_bar": worst, "fails": fails})
            for f in fails:
                print(f"FAIL call {i} M={M}: {f}", flush=True)
    rep["calls"] = runs
    rep["f_hashes"] = sorted({r["hash"] for r in runs})

    # the unwritten-workspace test: every buffer E and F allocate poisoned
    base = {M: run_f(M) for M in (2, 1)}
    poison = {}
    for label, value in (("nan", float("nan")), ("pattern", 1234.5)):
        for M in (2, 1):
            with _poisoned(value):
                got = run_f(M)
            poison[f"{label} M={M}"] = {
                "equal": all(torch.equal(got[k], base[M][k]) for k in got),
                "max_diff": max(((got[k] - base[M][k]).abs().max().item() for k in got),
                                default=0.0),
            }
    rep["poison"] = poison

    # the clip edge: steps whose softplus lies within one ulp of a limit
    edge = {}
    for m in range(2):
        pre = F.linear(xs[m], ws[m].in_w)[..., -ws[m].dt_bias.shape[0]:] + ws[m].dt_bias
        sp = F.softplus(pre)
        sp64 = F.softplus(pre.double())
        near, sides = 0, 0
        for lim in dt_limit:
            lim32 = torch.tensor(lim, dtype=torch.float32, device=dev)
            ulp = (torch.nextafter(lim32, lim32 + 1) - lim32).item()
            near += int(((sp - lim).abs() <= ulp).sum().item())
            sides += int(((sp >= lim32) != (sp64 >= lim)).sum().item())
        edge[f"mixer {m}"] = {"steps": sp.numel(), "within_one_ulp": near,
                              "fp32_fp64_disagree": sides,
                              "min_dist": min((sp - lim).abs().min().item() for lim in dt_limit)}
    rep["clip_edge"] = edge
    rep["fails"] = sum(len(r["fails"]) > 0 for r in runs)
    print(json.dumps({k: v for k, v in rep.items() if k != "calls"}), flush=True)
    with open(out, "w") as f:
        json.dump(rep, f)


def draws(count: int, out: str) -> None:
    """The case at ``count`` draws of the modules' default init (the global
    generator seeded 0, 1, ...): kernel F once and the plain version in fp32
    and in fp64 per draw, every gradient's max |err| over its bar against
    both."""
    sys.path.insert(0, ROOT)
    import torch

    from diffma_tpu_torch.ops.fused_ssd import (
        Mamba2Weights,
        ssd_mixer_bwd_ref,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    t = _tests()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family, grid_n, layer, batch, dt_limit = CASE
    spec = build_scan_spec(family, grid_n, layer)
    L = grid_n * grid_n
    xs = [t._x(dev, L, 60 + i, batch) for i in range(2)]
    gs = [t._x(dev, L, 70 + i, batch) for i in range(2)]
    rows = []
    for seed in range(count):
        torch.manual_seed(seed)
        ws = [m.weights() for m in t._mixers2(dev, spec, seed=layer)]
        with torch.no_grad():
            _, res = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, want_res=True)
        gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, res, dt_limit)
        got, want, want64 = {}, {}, {}
        for m in range(2):
            got[f"gx{m}"] = gxs[m]
            got.update({f"w{m}.{f}": v for f, v in zip(Mamba2Weights._fields, gws[m])})
            for dtype, dst in ((torch.float32, want), (torch.float64, want64)):
                gx, gw = ssd_mixer_bwd_ref(spec, xs[m].to(dtype), gs[m].to(dtype),
                                           Mamba2Weights(*(v.to(dtype) for v in ws[m])), dt_limit)
                dst[f"gx{m}"] = gx
                dst.update({f"w{m}.{f}": v for f, v in zip(Mamba2Weights._fields, gw)})
        row = {"seed": seed, "clip_side_differs": 0, "clip_min_dist": float("inf")}
        for m in range(2):  # steps where F's dt (from E's in_proj) and the plain's clip differently
            H = ws[m].dt_bias.shape[0]
            pre_f = res[m][:, -H:] + ws[m].dt_bias
            pre_p = torch.nn.functional.linear(xs[m], ws[m].in_w)[..., -H:].reshape(pre_f.shape)
            sp_f = torch.nn.functional.softplus(pre_f)
            sp_p = torch.nn.functional.softplus(pre_p + ws[m].dt_bias)
            inside = lambda v: (v >= dt_limit[0]) & (v <= dt_limit[1])  # noqa: E731
            row["clip_side_differs"] += int((inside(sp_f) != inside(sp_p)).sum().item())
            row["clip_min_dist"] = min(row["clip_min_dist"],
                                       min((sp_p - lim).abs().min().item() for lim in dt_limit))
        for label, ref in (("f_vs_ref32", want), ("f_vs_ref64", want64), ("ref32_vs_ref64", want64)):
            a_of = want if label == "ref32_vs_ref64" else got
            ratios = {}
            for k, w in ref.items():
                bar = t.GRAD_TOL * max(1.0, w.abs().max().item())
                ratios[k] = (a_of[k].double() - w.double()).abs().max().item() / bar
            worst = max(ratios, key=ratios.get)
            row[label] = [worst, ratios[worst]]
        rows.append(row)
        if row["f_vs_ref32"][1] > 1 or row["f_vs_ref64"][1] > 1:
            print(f"over the bar: {row}", flush=True)
    worst = sorted(rows, key=lambda r: -r["f_vs_ref32"][1])[:5]
    summary = {"draws": count, "over_bar_vs_ref32": sum(r["f_vs_ref32"][1] > 1 for r in rows),
               "over_bar_vs_ref64": sum(r["f_vs_ref64"][1] > 1 for r in rows),
               "ref32_over_bar_vs_ref64": sum(r["ref32_vs_ref64"][1] > 1 for r in rows),
               "clip_side_differs": sum(r["clip_side_differs"] > 0 for r in rows),
               "over_bar_with_clip_side_differing": sum(
                   r["f_vs_ref32"][1] > 1 and r["clip_side_differs"] > 0 for r in rows),
               "worst_five": worst}
    print(json.dumps(summary), flush=True)
    with open(out, "w") as f:
        json.dump({"summary": summary, "rows": rows}, f)


def run(procs: int, par: int, calls: int, out: str, seeded: bool = False) -> int:
    os.makedirs(out, exist_ok=True)
    reps, pending = [], list(range(procs))
    while pending:
        batch, pending = pending[:par], pending[par:]
        ps = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "once", "--calls",
                                str(calls), "--out", os.path.join(out, f"p{i}.json")]
                               + (["--seeded"] if seeded else []),
                               stdout=subprocess.DEVNULL) for i in batch]
        for i, p in zip(batch, ps):
            if p.wait() != 0:
                print(f"process {i} exited {p.returncode}")
                continue
            with open(os.path.join(out, f"p{i}.json")) as f:
                reps.append(json.load(f))
    summary = {
        "processes": len(reps),
        "f_calls": sum(len(r["calls"]) for r in reps),
        "failed_calls": sum(r["fails"] for r in reps),
        "worst_err_over_bar": max(c["worst_err_over_bar"] for r in reps for c in r["calls"]),
        "f_hashes": sorted({h for r in reps for h in r["f_hashes"]}),
        "ref_hashes": sorted({r["ref_hash"] for r in reps}),
        "ref_equal_twice": all(r["ref_equal_twice"] for r in reps),
        "poison_equal": all(v["equal"] for r in reps for v in r["poison"].values()),
        "clip_edge": reps[0]["clip_edge"] if reps else None,
        "ref32_vs_64": reps[0]["ref32_vs_64"] if reps else None,
    }
    print(json.dumps(summary))
    return 0 if len(reps) == procs else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    o = sub.add_parser("once", help="one process: F's calls, the poison and edge tests")
    o.add_argument("--calls", type=int, default=30)
    o.add_argument("--out", required=True)
    o.add_argument("--seeded", action="store_true",
                   help="seed the modules' default init as the test's fixture does")
    r = sub.add_parser("run", help="fresh processes of `once`, and a summary")
    r.add_argument("--procs", type=int, default=30)
    r.add_argument("--par", type=int, default=6)
    r.add_argument("--calls", type=int, default=30)
    r.add_argument("--out", required=True)
    r.add_argument("--seeded", action="store_true",
                   help="seed the modules' default init as the test's fixture does")
    w = sub.add_parser("draws", help="the case at many draws of the modules' default init")
    w.add_argument("--count", type=int, default=200)
    w.add_argument("--out", required=True)
    a = ap.parse_args()
    if a.cmd == "draws":
        draws(a.count, a.out)
        return 0
    if a.cmd == "once":
        once(a.calls, a.out, a.seeded)
        return 0
    return run(a.procs, a.par, a.calls, a.out, a.seeded)


if __name__ == "__main__":
    sys.exit(main())
