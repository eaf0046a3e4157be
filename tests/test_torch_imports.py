"""Import hygiene of the PyTorch port: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the GPU test file may import ``jax`` or the
reference package ``repro`` (the port keeps its own copy of anything it
needs, and all three must run where only PyTorch is installed), and
importing the port must neither compile nor load a CUDA kernel."""
import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "pod_gossip_pretrain_torch.py",
    ROOT / "examples" / "serve_decode_torch.py",
    ROOT / "examples" / "train_cifar_dfl_torch.py",
    ROOT / "repeat_phase.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_neither_jax_nor_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("sub", ["checkpoint", "comm", "store", "optim",
                                 "launch"])
def test_the_scan_covers_the_checkpoint_comm_and_store_packages(sub):
    mods = {p.stem for p in FILES if p.parent == PORT / sub}
    want = {"__init__", *{"checkpoint": ["io"], "comm": ["plan"],
                          "store": ["faults", "layout", "store", "paging",
                                    "prefetch", "paged"],
                          "optim": ["sgd"],
                          "launch": ["steps", "serve", "train"]}[sub]}
    assert want <= mods, sorted(want - mods)


def test_every_port_module_imports_without_jax():
    """Import the whole port in a fresh interpreter with ``jax`` and
    ``repro`` made unimportable."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
        f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import build\n"
        "assert build._lib is None, 'a kernel was loaded at import'\n"
        "assert 'triton' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    """No CUDA here: the script must exit nonzero and print no result."""
    if importlib.import_module("torch").cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would really run")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
