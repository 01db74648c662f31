"""The port stands alone: no module of paddle_tpu_torch and no line of
chip_smoke.py imports jax or the JAX package (paddle_tpu), and importing
the port pulls in neither."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "paddle_tpu")


def port_files():
    return sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def forbidden(module: str) -> bool:
    """Exact module-name prefix match: ``jax``, ``jax.numpy`` and
    ``paddle_tpu.serving`` are forbidden, ``paddle_tpu_torch`` is not."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_forbidden_matches_exact_module_names():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("paddle_tpu") and forbidden("paddle_tpu.serving")
    assert not forbidden("paddle_tpu_torch")
    assert not forbidden("paddle_tpu_torch.serving.engine")
    assert not forbidden("jaxlib_free")


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch, paddle_tpu_torch.models.llama, "
        "paddle_tpu_torch.serving, paddle_tpu_torch.ops.cuda, "
        "paddle_tpu_torch.ops.cuda.flash_attention, "
        "paddle_tpu_torch.nn.functional.attention, "
        "paddle_tpu_torch.nn.functional.loss, paddle_tpu_torch.nn.clip, "
        "paddle_tpu_torch.optimizer, paddle_tpu_torch.optimizer.lr, "
        "paddle_tpu_torch.regularizer, paddle_tpu_torch.quantize, "
        "paddle_tpu_torch.quantize.core, "
        "paddle_tpu_torch.quantize.calibration, "
        "paddle_tpu_torch.quantize.layers, "
        "paddle_tpu_torch.ops.cuda.quant_matmul, paddle_tpu_torch.amp, "
        "paddle_tpu_torch.amp.debugging, paddle_tpu_torch.autograd, "
        "paddle_tpu_torch.core.tensor, paddle_tpu_torch.utils.failpoint, "
        "paddle_tpu_torch.utils.retry, paddle_tpu_torch.tensor.extension\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.') "
        "or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "assert 'paddle_tpu_torch.serving.engine' in new\n"
        "assert 'paddle_tpu_torch.optimizer.optimizer' in new\n"
        "assert 'paddle_tpu_torch.quantize.layers' in new\n"
        "assert 'paddle_tpu_torch.utils.failpoint' in new\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
