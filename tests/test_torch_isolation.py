"""The PyTorch port stands alone: nothing in ``src/repro_torch`` or in
``chip_smoke.py`` imports JAX or the JAX package ``repro``, and the port's
entry modules import in an interpreter where both are unimportable."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:            # relative: stays inside its package
                continue
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield node.lineno, str(node.args[0].value)


def test_port_scan_covers_the_package():
    names = {p.name for p in _port_files()}
    assert {"paged.py", "serve.py", "spa_attention.py",
            "decode_attention.py", "chip_smoke.py", "train.py",
            "scheduler.py", "service.py", "transfer_cast.py", "grpo.py"
            } <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_modules_import_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.launch.serve, repro_torch.core.paged\n"
        "import repro_torch.convert, repro_torch.kernels.build\n"
        "import repro_torch.launch.train, repro_torch.core.scheduler\n"
        "import repro_torch.kernels.transfer_cast\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT), env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
