"""``tools/validate_imports_torch.py``, the port's twin of
``tools/validate_imports.py``, on seeded stand-in files on the CPU.

The stand-ins (``write_stand_ins``) are full-width files in the upstream
layouts: a diffusers SD-VAE state dict, an open_clip BiomedCLIP checkpoint,
a CT-encoder checkpoint and a DiffMa training checkpoint (DiffMa-S/2 here, to
keep the file small; the tool takes any registry name). The tool passes on
them, fails with a ``FAIL <kind>`` line and exit code 1 on a file with a key
removed or a tensor of a wrong shape, and imports neither JAX, the JAX
package nor PIL.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "validate_imports_torch.py")
MODEL = "DiffMa-S/2"


def _tool():
    spec = importlib.util.spec_from_file_location("validate_imports_torch", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under the suite's parallel workers the full-width
    forwards only contend with more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stand_ins(tmp_path_factory):
    """The tool and its stand-ins (about 800 MB, removed after the module)."""
    tool = _tool()
    out = tmp_path_factory.mktemp("stand_ins")
    yield tool, tool.write_stand_ins(str(out), seed=0, diffma_model=MODEL)
    shutil.rmtree(out)


def _run(tool, capsys, **files):
    argv = [a for kind, path in files.items() for a in (f"--{kind}", path)]
    rc = tool.main(argv + ["--device", "cpu", "--diffma-model", MODEL])
    return rc, capsys.readouterr().out


SMOKES = {
    "ct": "tokens: shape (2, 196, 512), finite=True",
    "vae": "decode: shape (1, 3, 64, 64), finite=True",
    "clip": "embedding: shape (2, 512), finite=True",
    "diffma": "denoiser output: shape (2, 8, 28, 28), finite=True",
}


@pytest.mark.parametrize("kind", list(SMOKES))
def test_tool_passes_on_stand_ins(stand_ins, capsys, kind):
    tool, paths = stand_ins
    rc, out = _run(tool, capsys, **{kind: paths[kind]})
    assert rc == 0, out
    assert "missing    : 0" in out and "unexpected : 0" in out and "wrong shape: 0" in out
    assert SMOKES[kind] in out
    assert "FAIL" not in out and "all requested imports validated" in out


def test_tool_fails_on_a_missing_key(stand_ins, tmp_path, capsys):
    tool, paths = stand_ins
    ckpt = torch.load(paths["ct"])
    for sd in ckpt.values():
        del sd["norm.weight"]
    broken = str(tmp_path / "ct.pt")
    torch.save(ckpt, broken)
    rc, out = _run(tool, capsys, ct=broken, vae=paths["vae"])
    assert rc == 1
    assert "missing    : 1  ['norm.weight']" in out
    assert [line.strip().split(":")[0] for line in out.splitlines()
            if line.strip().startswith("FAIL")] == ["FAIL ct"]


def test_tool_fails_on_a_wrong_shape(stand_ins, tmp_path, capsys):
    tool, paths = stand_ins
    ckpt = torch.load(paths["diffma"], weights_only=False)
    key = "final_layer.linear.weight"
    ckpt["ema"][key] = ckpt["ema"][key][:-1]
    broken = str(tmp_path / "0000002.pt")
    torch.save(ckpt, broken)
    rc, out = _run(tool, capsys, diffma=broken)
    assert rc == 1
    assert "wrong shape: 1" in out and key in out
    assert "FAIL diffma:" in out


def test_tool_imports_no_jax(stand_ins):
    """In a fresh process with ``jax``, ``diffma_tpu`` and ``PIL`` made
    unimportable, the tool validates the CT encoder and the DiffMa
    checkpoint, and none of the three was loaded."""
    _, paths = stand_ins
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "for name in ('jax', 'diffma_tpu', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['validate_imports_torch.py', '--ct', {paths['ct']!r}, '--diffma', "
        f"{paths['diffma']!r}, '--diffma-model', {MODEL!r}, '--device', 'cpu']\n"
        "import runpy\n"
        "try:\n"
        f"    runpy.run_path({TOOL!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'diffma_tpu', 'PIL')\n"
        "          and sys.modules[m] is not None]\n"
        "print('EXIT', code, 'LOADED', loaded)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "EXIT 0 LOADED []" in res.stdout, res.stdout + res.stderr
